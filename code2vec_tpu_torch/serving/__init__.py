"""The serving surface: a copy of serving/ of the JAX package.

`PredictionServer` (server.py) is the batched entry point: request
queue -> dynamic micro-batcher (batcher.py) -> bucketed device batches,
with an LRU prediction cache, bounded-queue admission control and a
persistent extractor worker pool (extractor.py). The interactive REPL
(interactive_predict.py) and the load generator
(tools/loadgen.py) are thin clients of it.

The external serving plane stacks on top: a `ReplicaPool`
(replicas.py) of N servers behind ONE generation-scoped cache with
least-outstanding dispatch and death/refill, a `ReloadManager`
(reload.py) hot-swapping verified committed checkpoints one replica at
a time, an `AutoScaler` (autoscale.py) sizing the pool off the SLO
alert rules, and a `ServingFrontend` (frontend.py) putting POST
/predict + /healthz + /metrics + /pool on a socket. All four are
stdlib-only at module scope: they import with torch blocked
(tests/test_torch_serving_fleet.py).
"""

from code2vec_tpu_torch.serving.autoscale import AutoScaler  # noqa: F401
from code2vec_tpu_torch.serving.batcher import (MicroBatcher,  # noqa: F401
                                                PredictRequest,
                                                ServerOverloaded)
from code2vec_tpu_torch.serving.extractor import (Extractor,  # noqa: F401
                                                  ExtractorError,
                                                  ExtractorPool)
from code2vec_tpu_torch.serving.frontend import ServingFrontend  # noqa: F401
from code2vec_tpu_torch.serving.reload import ReloadManager  # noqa: F401
from code2vec_tpu_torch.serving.replicas import (Replica,  # noqa: F401
                                                 ReplicaPool,
                                                 SharedCacheView)
from code2vec_tpu_torch.serving.server import (PredictionCache,  # noqa: F401
                                               PredictionServer,
                                               normalize_bag)

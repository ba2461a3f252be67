"""code2vec_tpu_torch.obs: the run's telemetry, a copy of the JAX
package's obs/ for what the port has.

One registry (`Telemetry`: counters, gauges, p50/p95/p99 timer
histograms), sinks (a per-run JSONL event log and manifest under
`--telemetry_dir`, a TensorBoard adapter over `ScalarWriter`, stdout),
host-vs-device span helpers, request- and step-scoped tracing
(`Tracer`), the stall watchdog (`Watchdog`) and the train-loop recorder
(`TrainStepRecorder`). Not here yet: the live metrics plane
(exposition, promtext, health, alerts), the phase profiler and the fleet
collector.
"""

from code2vec_tpu_torch.obs.loop import (TrainStepRecorder,  # noqa: F401
                                         infeed_produce_instrument)
from code2vec_tpu_torch.obs.sinks import (JsonlSink, ScalarSink,  # noqa: F401
                                          StdoutSink)
from code2vec_tpu_torch.obs.telemetry import (  # noqa: F401
    SUMMARY_PERCENTILES, Telemetry, TimerStat, device_sync,
    format_latency_line)
from code2vec_tpu_torch.obs.trace import (SpanChannel,  # noqa: F401
                                          SpanContext, Tracer, TraceSpan)
from code2vec_tpu_torch.obs.watchdog import (Heartbeat,  # noqa: F401
                                             StallError, Watchdog)

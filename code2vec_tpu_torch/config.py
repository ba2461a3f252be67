"""Configuration of the ported paths: serving and the sparse-row step.

The fields the port reads, under the names and defaults of `Config` in
the JAX package's config.py, so a setting means the same in both. No
command line yet.

Training is ported for one combination only, the sparse-row step:
`SPARSE_EMBEDDING_UPDATES=True`, `EMBEDDING_OPTIMIZER="adam"`,
`LR_SCHEDULE="constant"` and the `bag` encoder, the three of which
`verify` requires of a sparse run, as the JAX package's does. The
defaults are the JAX package's (dense Adafactor step, cosine LR), so a
caller sets the sparse fields explicitly; the trainer refuses the dense
step with `NotImplementedError`. The port has one head (`code2vec`) and
trains on one device, so it has no head or mesh fields yet.
"""

from __future__ import annotations

import dataclasses
import logging


@dataclasses.dataclass
class Config:
    # contexts kept per method (over-cap rows are downsampled at parse)
    MAX_CONTEXTS: int = 200
    TOP_K_WORDS_CONSIDERED_DURING_PREDICTION: int = 10
    # compute in bfloat16 (contexts, pool input, logits product)
    USE_BF16: bool = True
    # storage dtype of the vocab tables: "float32" | "bfloat16" | "int8"
    TABLES_DTYPE: str = "bfloat16"
    # max methods per coalesced device batch; a power of two, the
    # largest warmed bucket
    SERVE_BATCH_MAX: int = 64
    # coalescing window after the first queued request (0 = greedy)
    SERVE_BATCH_TIMEOUT_MS: float = 2.0
    # bounded request queue; fuller submissions are refused
    SERVE_QUEUE_DEPTH: int = 128
    # a request still queued past this is shed (0 = no deadline)
    SERVE_DEADLINE_MS: float = 2000.0
    # LRU prediction-cache entries (0 disables)
    SERVE_CACHE_SIZE: int = 1024
    # attach each method's code vector to its prediction result
    export_code_vectors: bool = False

    # ---- model ----
    DEFAULT_EMBEDDINGS_SIZE: int = 128
    ENCODER_TYPE: str = "bag"   # "bag" | "transformer" (not ported)

    # ---- training ----
    DROPOUT_KEEP_RATE: float = 0.75
    TRAIN_BATCH_SIZE: int = 1024
    NUM_BATCHES_TO_LOG_PROGRESS: int = 100
    LEARNING_RATE: float = 0.001
    # "cosine" | "linear" | "warmup_cosine" | "constant"; only "constant"
    # is ported
    LR_SCHEDULE: str = "cosine"
    SEED: int = 239
    USE_SAMPLED_SOFTMAX: bool = False
    NUM_SAMPLED_CLASSES: int = 4096
    # touched-rows-only (lazy) Adam for the vocab tables: dedup +
    # segment-sum + the live-row kernels (training/sparse_steps.py)
    SPARSE_EMBEDDING_UPDATES: bool = False
    # "adafactor" (not ported) | "adam"
    EMBEDDING_OPTIMIZER: str = "adafactor"

    def log(self, msg: str) -> None:
        logging.getLogger("code2vec_tpu_torch").info(msg)

    def verify(self) -> None:
        """The JAX package's `Config.verify` rules for the ported fields;
        raises ValueError on an invalid combination."""
        if self.MAX_CONTEXTS <= 0:
            raise ValueError("MAX_CONTEXTS must be positive.")
        if self.USE_SAMPLED_SOFTMAX and self.NUM_SAMPLED_CLASSES <= 0:
            raise ValueError("NUM_SAMPLED_CLASSES must be positive.")
        if self.TABLES_DTYPE not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"TABLES_DTYPE must be float32, bfloat16 or "
                             f"int8 (got {self.TABLES_DTYPE!r}).")
        if self.SPARSE_EMBEDDING_UPDATES and \
                self.EMBEDDING_OPTIMIZER != "adam":
            # the live-row update IS row-Adam; adafactor's factored
            # column stats are global over V
            raise ValueError(
                "SPARSE_EMBEDDING_UPDATES requires the adam embedding "
                "optimizer (the live-row kernel applies row-Adam; "
                "float32/bfloat16/int8 tables are all supported).")
        if self.SPARSE_EMBEDDING_UPDATES and self.LR_SCHEDULE != "constant":
            raise ValueError(
                "SPARSE_EMBEDDING_UPDATES supports constant LR only (the "
                "row update applies a fixed per-row learning rate).")
        if self.SPARSE_EMBEDDING_UPDATES and self.ENCODER_TYPE != "bag":
            raise ValueError(
                "SPARSE_EMBEDDING_UPDATES supports the bag encoder only "
                "(the sparse step trains no transformer params).")

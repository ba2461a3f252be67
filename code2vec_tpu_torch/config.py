"""Configuration of the ported paths: serving, the dense and the
sparse-row training steps, and evaluation.

The fields the port reads, under the names and defaults of `Config` in
the JAX package's config.py, so a setting means the same in both. No
command line yet.

The defaults are the JAX package's: the dense step with Adafactor on the
tables, Adam on TRANSFORM / ATTENTION, a cosine learning rate, bf16
tables and full softmax. `SPARSE_EMBEDDING_UPDATES=True` selects the
sparse-row step, which `verify` allows only with `EMBEDDING_OPTIMIZER=
"adam"`, `LR_SCHEDULE="constant"` and the `bag` encoder, as the JAX
package's does. `ENCODER_TYPE="transformer"` selects the transformer
path-encoder (`XF_LAYERS` pre-norm layers of `XF_HEADS` heads) for
serving, the dense step and evaluation. The port has one head
(`code2vec`) and trains on one device, so it has no head or mesh fields
yet, and no `RING_ATTENTION`, which needs a mesh.
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
    ENCODER_TYPE: str = "bag"   # "bag" | "transformer"
    # transformer layers and heads (the head width is 3E / XF_HEADS)
    XF_LAYERS: int = 2
    XF_HEADS: int = 3
    # recompute each transformer layer in the backward pass
    XF_REMAT: bool = False

    # ---- training ----
    DROPOUT_KEEP_RATE: float = 0.75
    TRAIN_BATCH_SIZE: int = 1024
    TEST_BATCH_SIZE: int = 1024
    # epochs of a `train` call; with the example count and the batch
    # size it sets a decaying schedule's horizon
    NUM_TRAIN_EPOCHS: int = 20
    NUM_BATCHES_TO_LOG_PROGRESS: int = 100
    LEARNING_RATE: float = 0.001
    # "cosine" | "linear" | "warmup_cosine" | "constant"
    LR_SCHEDULE: str = "cosine"
    # "warmup_cosine" warmup length; 0 = auto (5% of the horizon)
    LR_WARMUP_STEPS: int = 0
    # LAMB-style per-array trust-ratio rescale
    # (training/optimizers.make_optimizer)
    TRUST_RATIO: bool = False
    # "all": every optimizer branch; "dense": TRANSFORM / ATTENTION only
    TRUST_RATIO_SCOPE: str = "all"
    SEED: int = 239
    USE_SAMPLED_SOFTMAX: bool = False
    NUM_SAMPLED_CLASSES: int = 4096
    # touched-rows-only (lazy) Adam for the vocab tables: dedup +
    # segment-sum + the live-row kernels (training/sparse_steps.py)
    SPARSE_EMBEDDING_UPDATES: bool = False
    # "adafactor" (tables; Adam on TRANSFORM / ATTENTION) | "adam"
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
        if self.ENCODER_TYPE not in ("bag", "transformer"):
            raise ValueError(f"ENCODER_TYPE must be bag or transformer (got "
                             f"{self.ENCODER_TYPE!r}).")
        if self.ENCODER_TYPE == "transformer" and (
                self.XF_HEADS <= 0
                or (3 * self.DEFAULT_EMBEDDINGS_SIZE) % self.XF_HEADS):
            raise ValueError(
                f"XF_HEADS ({self.XF_HEADS}) must divide the context vector "
                f"size 3 * DEFAULT_EMBEDDINGS_SIZE "
                f"({3 * self.DEFAULT_EMBEDDINGS_SIZE}).")
        if self.TABLES_DTYPE == "int8":
            if self.ENCODER_TYPE != "bag":
                raise ValueError(
                    "TABLES_DTYPE int8 supports the bag encoder only "
                    "(the transformer gathers the tables directly).")
            if self.TRUST_RATIO:
                raise ValueError(
                    "TABLES_DTYPE int8 is incompatible with TRUST_RATIO "
                    "(the trust rescale needs ||param|| of the flat table "
                    "the quantized step never materializes).")
        if self.LR_WARMUP_STEPS < 0:
            raise ValueError("LR_WARMUP_STEPS must be >= 0.")
        if self.LR_WARMUP_STEPS > 0 and self.LR_SCHEDULE != "warmup_cosine":
            raise ValueError(
                "LR_WARMUP_STEPS applies only to LR_SCHEDULE "
                "warmup_cosine (other schedules have no warmup phase and "
                "would silently ignore it).")
        if (self.TRUST_RATIO and self.TRUST_RATIO_SCOPE == "dense"
                and self.EMBEDDING_OPTIMIZER != "adafactor"):
            raise ValueError(
                "TRUST_RATIO_SCOPE dense requires EMBEDDING_OPTIMIZER "
                "adafactor (adam runs one transform over all params; no "
                "table/dense split).")
        if self.TRUST_RATIO and self.SPARSE_EMBEDDING_UPDATES:
            raise ValueError(
                "TRUST_RATIO is not supported with SPARSE_EMBEDDING_UPDATES "
                "(the sparse row-update kernel bypasses the optimizer chain "
                "for the tables).")
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

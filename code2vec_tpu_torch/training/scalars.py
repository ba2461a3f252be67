"""Optional TensorBoard scalar streaming (`--tensorboard <dir>`).

A copy of training/scalars.py of the JAX package over
`torch.utils.tensorboard.SummaryWriter` in place of `tf.summary`. The
writer is imported only when a directory is given; where it cannot be
imported (it needs the `tensorboard` package) the writer is a warn-once
no-op, so a training image without it keeps the same command line (the
JSONL telemetry under `--telemetry_dir` stays the durable record).
"""

from __future__ import annotations

import logging
from typing import Mapping, Optional

# warn-once latch for the missing-package fallback (module-level: one
# warning per process, not one per writer)
_WARNED_MISSING_TB = False


class ScalarWriter:
    """No-op when constructed with dir=None, so call sites stay
    unconditional. Writes one scalar per (tag, step) otherwise."""

    def __init__(self, log_dir: Optional[str]):
        self._writer = None
        if log_dir:
            try:  # lazy: only with --tensorboard
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                global _WARNED_MISSING_TB
                if not _WARNED_MISSING_TB:
                    _WARNED_MISSING_TB = True
                    logging.getLogger("code2vec_tpu_torch").warning(
                        "--tensorboard %s requested but "
                        "torch.utils.tensorboard is not importable (%s; it "
                        "needs the tensorboard package); scalar streaming "
                        "disabled (use --telemetry_dir for the JSONL "
                        "record)", log_dir, e)
                return
            self._writer = SummaryWriter(log_dir)

    def write(self, step: int, scalars: Mapping[str, float]) -> None:
        if self._writer is None:
            return
        for tag, value in scalars.items():
            self._writer.add_scalar(tag, float(value), step)
        self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()

"""Device-memory streaming bandwidth: the counterpart of ops/membench.py
of the JAX package.

One copy step reads a float32 buffer of `gib` GiB and writes another
(`x * (1 + 1e-7 * (i % 2))`: one kernel, with a step-dependent scale as
the JAX package's loop has). A chain of `inner_loops` steps is timed
with CUDA events at two chain lengths and the times differenced, so the
fixed cost of a launch and a sync cancels out. Plain torch ops are the
right tool: this is a measurement of the card, not a kernel of the
port. The result is `Config.HBM_CEILING_GBPS`'s default, measured on
the card that config.py names.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from code2vec_tpu_torch.device import resolve_device


def measure_hbm_ceiling(gib: float = 1.0, inner_loops: int = 32,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> float:
    """Effective streaming bandwidth in bytes/s of a read + write copy
    over a `gib`-GiB float32 buffer on the CUDA card (`device=None`).
    Needs CUDA: the events time the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("measure_hbm_ceiling times the CUDA card")
    n = int(gib * 256 * 1024 * 1024)
    x = torch.zeros((n,), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)

    def chain(m: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        src, dst = x, y
        start.record()
        for i in range(m * inner_loops):
            # one kernel a step: read src, write dst
            torch.mul(src, 1.0 + 1e-7 * (i % 2), out=dst)
            src, dst = dst, src
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    chain(1)  # allocator and launch warm-up
    t1 = chain(2)
    t2 = chain(6)
    dt = (t2 - t1) / 4 / inner_loops
    return 2 * n * 4 / dt

"""Shared java-large constants and slope-timing helpers of the port's
profilers: a copy of tools/_bench_common.py of the JAX package.

The constants are the java-large capacities the JAX tools measure at;
`slope_time` runs a chain of calls at two lengths and takes the
difference, so the fixed cost of the final sync cancels. The sync that
ends a chain is a host read of ONE element (`.item()` waits for the
stream that produced it); reading a whole tensor back would put its copy
into the slope.

The JAX module's `load_bench_module` (an import of the repository's
`bench.py`) has no copy here: the port's profilers import nothing of
`bench.py`.
"""

from __future__ import annotations

import subprocess
import time

# java-large capacities (the JAX module's; SURVEY.md section 3)
TOKEN_VOCAB = 1_301_136
PATH_VOCAB = 911_417
TARGET_VOCAB = 261_245
BATCH = 1024
CTX = 200
NUM_SAMPLED = 4096


def card_line(device) -> str:
    """The card's `nvidia-smi` name and power limit (`name, power.limit`)
    on a CUDA `device`; "cpu" on the CPU. The profilers print it beside
    their numbers: a card set below its power maximum runs slower under
    load."""
    if device.type != "cuda":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    idx = device.index or 0
    return lines[idx] if r.returncode == 0 and len(lines) > idx \
        else "nvidia-smi: not read"


def backend_device(backend: str):
    """The device of `--backend` (`gpu`, the default: the CUDA card;
    `cpu`), or None after saying on stderr that `gpu` has no card (the
    tool then exits 2)."""
    from code2vec_tpu_torch.device import resolve_device
    from code2vec_tpu_torch.tools import loadgen
    if loadgen.gpu_missing(backend):
        return None
    return resolve_device(loadgen.backend_device(backend))


def scalar_sync(out) -> float:
    """The first element of `out` read on the host: waits for the work
    that produced it."""
    return float(out.reshape(-1)[0].item())


def slope_time(chain, state, steps: int, warmup: int = 5,
               base: int = 10):
    """Seconds a call: `chain(n, state) -> (seconds, state)` runs n calls
    and ends with a scalar sync; chains of `base` and `base + steps`
    calls are timed after a warm-up chain and differenced."""
    _, state = chain(warmup, state)
    t1, state = chain(base, state)
    t2, state = chain(base + steps, state)
    return (t2 - t1) / steps


def time_fn(fn, args, steps: int, sync=None):
    """Slope-time a stateless `fn(*args)`; `sync(out)` (default: a
    scalar read of the output's first element) ends each chain."""
    if sync is None:
        sync = scalar_sync

    def chain(n, _):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn(*args)
        sync(out)
        return time.perf_counter() - t0, None

    return slope_time(chain, None, steps)

"""Process-level helpers of multi-process runs: the counterpart of
`parallel/compat.py` in the JAX package, over `torch.distributed`.

- `free_port`: an OS-assigned free TCP port (a coordinator, the fleet
  endpoint, the servers the tools start).
- `cohort_world`: (rank, world) of the process group this process
  joined, (0, 1) without one: the one seam the mesh and the readers'
  host shards are derived from.
- `first_collective_barrier` and `PhaseDeadline`: hard deadlines for
  spawned cohort workers. On an oversubscribed machine the loopback
  transport can wedge every member at the rendezvous or at a later
  collective; a worker past its deadline `os._exit`s with
  `BARRIER_TIMEOUT_EXIT`, so the spawner's fresh-port retry
  (resilience/retry.transient_distributed) re-forms the cohort instead
  of burning its whole wall on a hang.
"""

from __future__ import annotations

import os
import socket
import threading

# the exit status of a worker whose bring-up or phase wedged
BARRIER_TIMEOUT_EXIT = 19


def free_port() -> int:
    """An OS-assigned free TCP port for a server about to bind: the one
    definition shared by the supervisor (a fresh coordinator port per
    attempt, the fleet endpoint), the multi-process spawners and the
    tools that start servers."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def cohort_world() -> "tuple[int, int]":
    """(rank, world size) of the initialized default process group, else
    (0, 1) without touching the distributed runtime."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank()), int(dist.get_world_size())
    return 0, 1


def first_collective_barrier(timeout_s: float = 90.0, *,
                             tag: str = "cohort-bringup",
                             setup_fn=None, barrier_fn=None,
                             on_timeout=None, log=None) -> None:
    """Bounded cohort bring-up: a watchdog deadline over `setup_fn` (the
    caller's `maybe_initialize`) and a probe collective (`barrier_fn`,
    default a one-element all-reduce when the world is above 1). Past
    `timeout_s` the watchdog calls `on_timeout`, by default
    `os._exit(BARRIER_TIMEOUT_EXIT)`: a wedged collective holds locks no
    finally block should touch. `setup_fn`, `barrier_fn` and
    `on_timeout` are injectable so the deadline is testable without a
    wedged cohort."""
    if on_timeout is None:
        def on_timeout():  # pragma: no cover - exercised via injection
            if log is not None:
                log(f"first-collective barrier '{tag}' timed out after "
                    f"{timeout_s}s: exiting for the spawner's fresh-port "
                    "retry")
            os._exit(BARRIER_TIMEOUT_EXIT)

    timer = threading.Timer(timeout_s, on_timeout)
    timer.daemon = True
    timer.start()
    try:
        if setup_fn is not None:
            setup_fn()
        if barrier_fn is not None:
            barrier_fn()
        elif cohort_world()[1] > 1:
            from code2vec_tpu_torch.parallel.distributed import \
                allreduce_sum_hosts
            allreduce_sum_hosts([1.0])
    finally:
        timer.cancel()
        timer.join()


class PhaseDeadline:
    """A re-armable per-phase deadline for spawned cohort workers, the
    companion of `first_collective_barrier` for everything after
    bring-up: `beat(phase)` re-arms it at each phase boundary, so a
    phase that wedges hard-exits the worker (`os._exit(
    BARRIER_TIMEOUT_EXIT)`, or the injected `on_timeout(phase)`) within
    `timeout_s` of its beat. `close()` disarms and reaps the timer. A
    last-resort killer for disposable test and tool workers, not the
    trainer's watchdog (obs/watchdog.py)."""

    def __init__(self, timeout_s: float = 120.0, *, on_timeout=None,
                 log=None):
        self.timeout_s = timeout_s
        self._on_timeout = on_timeout
        self._log = log
        self._lock = threading.Lock()
        self._timer = None

    def _expire(self, phase: str) -> None:
        if self._on_timeout is not None:
            self._on_timeout(phase)
            return
        if self._log is not None:  # pragma: no cover - via injection
            self._log(f"phase deadline: {phase!r} wedged for "
                      f"{self.timeout_s}s: exiting for the spawner's "
                      "fresh-port retry")
        os._exit(BARRIER_TIMEOUT_EXIT)

    def beat(self, phase: str = "work",
             timeout_s: "float | None" = None) -> None:
        """Enter `phase` (the previous one completed): re-arm, with
        `timeout_s` in place of the default for this phase."""
        new = threading.Timer(timeout_s or self.timeout_s, self._expire,
                              args=(phase,))
        new.daemon = True
        with self._lock:
            old, self._timer = self._timer, new
            new.start()
        if old is not None:
            old.cancel()
            old.join()

    def close(self) -> None:
        """Disarm and reap (the worker finished its work)."""
        with self._lock:
            old, self._timer = self._timer, None
        if old is not None:
            old.cancel()
            old.join()

"""The retry policy of checkpoint IO, the extractor pool's restart and
the serving plane's hot reload.

A copy of `RetryPolicy` from `resilience/retry.py` in the JAX package:
jittered exponential backoff, a per-call attempt budget (a policy is
shared, a budget is not), and a `giveup` predicate for errors that a
retry cannot fix (ENOSPC). Its telemetry is module-global and optional:
`set_telemetry()` points the counters (`resilience/retry`,
`resilience/retry_exhausted`, `resilience/retry_giveup`) and `retry`
events at a registry; without one, `stats()` still answers "did
anything retry" in-process. A call that succeeds first time records
nothing. The JAX package's distributed-runtime policy is not ported.
Sleep and randomness are injectable, so tests neither sleep nor depend
on chance.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple, Type

__all__ = ["RetryPolicy", "set_telemetry", "stats"]

_TELEMETRY = None
_STATS: Dict[str, Dict[str, int]] = {}
_STATS_LOCK = threading.Lock()


def set_telemetry(telemetry) -> None:
    """Point retry counters/events at a Telemetry registry (None to
    detach). The train loop wires its own."""
    global _TELEMETRY
    _TELEMETRY = telemetry


def stats() -> Dict[str, Dict[str, int]]:
    """Per-policy {retries, exhausted, giveup} counts (in-process,
    telemetry or not)."""
    with _STATS_LOCK:
        return {k: dict(v) for k, v in _STATS.items()}


def _record(policy: str, outcome: str, attempt: int, error: str,
            delay_s: float) -> None:
    with _STATS_LOCK:
        row = _STATS.setdefault(policy, {"retries": 0, "exhausted": 0,
                                         "giveup": 0})
        key = {"retry": "retries", "exhausted": "exhausted",
               "giveup": "giveup"}[outcome]
        row[key] += 1
    tele = _TELEMETRY
    if tele is not None and tele.enabled:
        tele.count("resilience/retry" if outcome == "retry"
                   else f"resilience/retry_{outcome}")
        tele.event("retry", policy=policy, outcome=outcome,
                   attempt=attempt, error=error[:200],
                   delay_s=round(delay_s, 4))


class RetryPolicy:
    """Jittered exponential backoff with a per-call attempt budget.

    delay(n) = min(max_delay_s, base_delay_s * multiplier^(n-1)), scaled
    by a uniform draw in [1 - jitter, 1] from the policy's own stream.
    `retry_on` bounds what retries; `giveup(exc) -> bool` vetoes
    retrying a matching error that backoff cannot fix. `max_elapsed_s`
    is the wall budget across one call's attempts; `log` gets one line a
    retry."""

    def __init__(self, name: str, *, max_attempts: int = 3,
                 base_delay_s: float = 0.1, max_delay_s: float = 30.0,
                 multiplier: float = 2.0, jitter: float = 0.5,
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                 giveup: Optional[Callable[[BaseException], bool]] = None,
                 max_elapsed_s: Optional[float] = None,
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 log: Optional[Callable[[str], None]] = None):
        if max_attempts < 1 or base_delay_s < 0 or not 0.0 <= jitter <= 1.0:
            raise ValueError("RetryPolicy needs max_attempts >= 1, "
                             "base_delay_s >= 0 and jitter in [0, 1]")
        self.name = name
        self.max_attempts = max_attempts
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.multiplier = multiplier
        self.jitter = jitter
        self.retry_on = retry_on
        self.giveup = giveup
        self.max_elapsed_s = max_elapsed_s
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self._sleep = sleep
        self._log = log or (lambda _m: None)

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry number `attempt` (1-based)."""
        d = min(self.max_delay_s,
                self.base_delay_s * self.multiplier ** (attempt - 1))
        with self._rng_lock:
            u = self._rng.random()
        return d * (1.0 - self.jitter * u)

    def call(self, fn: Callable, *args, **kwargs):
        """Run `fn(*args, **kwargs)` under this policy's budget. The last
        failure, or a giveup, is raised as it is."""
        t0 = time.monotonic()
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                if self.giveup is not None and self.giveup(e):
                    _record(self.name, "giveup", attempt, repr(e), 0.0)
                    raise
                out_of_time = (
                    self.max_elapsed_s is not None
                    and time.monotonic() - t0 >= self.max_elapsed_s)
                if attempt >= self.max_attempts or out_of_time:
                    _record(self.name, "exhausted", attempt, repr(e), 0.0)
                    raise
                d = self.delay_s(attempt)
                _record(self.name, "retry", attempt, repr(e), d)
                self._log(
                    f"retry[{self.name}]: attempt {attempt}/"
                    f"{self.max_attempts} failed "
                    f"({str(e).splitlines()[0][:120]}); retrying in "
                    f"{d:.2f}s")
                self._sleep(d)
        raise AssertionError("unreachable")  # the loop returns or raises

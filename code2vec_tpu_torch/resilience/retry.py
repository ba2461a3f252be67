"""The retry policy of checkpoint IO.

A copy of `RetryPolicy` from `resilience/retry.py` in the JAX package:
jittered exponential backoff, a per-call attempt budget (a policy is
shared, a budget is not), and a `giveup` predicate for errors that a
retry cannot fix (ENOSPC). The JAX package's telemetry hooks and its
distributed-runtime policy are not ported. Sleep and randomness are
injectable, so tests neither sleep nor depend on chance.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["RetryPolicy"]


class RetryPolicy:
    """Jittered exponential backoff with a per-call attempt budget.

    delay(n) = min(max_delay_s, base_delay_s * multiplier^(n-1)), scaled
    by a uniform draw in [1 - jitter, 1] from the policy's own stream.
    `retry_on` bounds what retries; `giveup(exc) -> bool` vetoes
    retrying a matching error that backoff cannot fix."""

    def __init__(self, name: str, *, max_attempts: int = 3,
                 base_delay_s: float = 0.1, max_delay_s: float = 30.0,
                 multiplier: float = 2.0, jitter: float = 0.5,
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                 giveup: Optional[Callable[[BaseException], bool]] = None,
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep):
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
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self._sleep = sleep

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
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                if (self.giveup is not None and self.giveup(e)) \
                        or attempt >= self.max_attempts:
                    raise
                self._sleep(self.delay_s(attempt))
        raise AssertionError("unreachable")  # the loop returns or raises

"""SLO autoscaler for the replica pool: a copy of serving/autoscale.py
of the JAX package.

A policy loop, not a new signal plane: the scaler owns a private
`AlertEngine` over the SAME serving registry the pool records into,
evaluating the burn-rate/SLO rules (`obs/alerts.serving_slo_rules`:
p99 latency and shed burn-rate at page severity) and turning their
edge-triggered state into pool-size decisions:

  - any PAGE-severity rule firing  -> `pool.grow()` (one replica per
    tick, the supervisor's one-at-a-time grow-back discipline; the
    pool's `[min,max]` bounds and replacement gate still apply);
  - every rule ok for `hold_s`     -> `pool.shrink()` (one replica per
    quiet window, never below min, never below one ready replica).

The asymmetry is deliberate: scale up on the first confirmed burn,
scale down only after a sustained quiet period, so a brief lull does
not shed the capacity the next burst needs. Ticket-severity rules
(`reload_refused`, `replica_dead`) inform but never scale: the pool
already self-heals those.

Everything is injectable (`clock`, `rules`, `every_s`) so tests drive
up/down transitions on synthetic series with a fake clock and zero
sleeps. `create()` follows the disabled-singleton discipline.
Stdlib-only at module scope.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence

from code2vec_tpu_torch.obs import Telemetry
from code2vec_tpu_torch.obs.alerts import (AlertEngine, AlertRule,
                                           serving_slo_rules)

__all__ = ["AutoScaler"]


class AutoScaler:
    """Grow/shrink a `ReplicaPool` off the serving SLO rules."""

    def __init__(self, pool, *, telemetry: Telemetry = None,
                 rules: Optional[Sequence[AlertRule]] = None,
                 slo_ms: float = 250.0, every_s: float = 5.0,
                 hold_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic,
                 log=None):
        self.enabled = True
        self.pool = pool
        tele = telemetry if telemetry is not None \
            else getattr(pool, "telemetry", None)
        self.telemetry = tele if tele is not None \
            else Telemetry.disabled()
        self.every_s = every_s
        self.hold_s = hold_s
        self._clock = clock
        self._log = log or (lambda *a, **k: None)
        self.engine = AlertEngine.create(
            self.telemetry, mode="warn",
            rules=list(rules) if rules is not None
            else serving_slo_rules(slo_ms),
            clock=clock)
        self._quiet_since: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @classmethod
    def create(cls, pool, *, enabled: bool = True,
               **kw) -> "AutoScaler":
        if not enabled or pool is None:
            return _NULL_AUTOSCALER
        return cls(pool, **kw)

    @classmethod
    def disabled(cls) -> "AutoScaler":
        return _NULL_AUTOSCALER

    # ---- one policy tick ----
    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """Evaluate the rules and apply at most ONE size change.
        Returns "up" / "down" / None (what happened, for tests and the
        chaos report)."""
        t = self._clock() if now is None else now
        self.engine.evaluate(t)
        page_firing = [r.name for r in self.engine.rules
                       if r.state == "firing"
                       and r.severity == "page"]
        decision = None
        if page_firing:
            self._quiet_since = None
            if self.pool.grow():
                decision = "up"
                self.telemetry.count("serve/scale_up")
                self.telemetry.event("autoscale", direction="up",
                                     target=self.pool.target,
                                     firing=page_firing)
                self._log(f"autoscale UP -> {self.pool.target} "
                          f"(firing: {', '.join(page_firing)})")
        elif any(r.state == "pending" and r.severity == "page"
                 for r in self.engine.rules):
            # a page rule inside its for_s hold: not quiet, not burning
            # enough to grow yet — freeze the shrink timer
            self._quiet_since = None
        else:
            if self._quiet_since is None:
                self._quiet_since = t
            elif t - self._quiet_since >= self.hold_s:
                if self.pool.shrink():
                    decision = "down"
                    self.telemetry.count("serve/scale_down")
                    self.telemetry.event("autoscale",
                                         direction="down",
                                         target=self.pool.target)
                    self._log(f"autoscale DOWN -> {self.pool.target}")
                # one shrink per quiet window either way: re-arm
                self._quiet_since = t
        self.telemetry.gauge("serve/autoscale_target",
                             self.pool.target, emit=False)
        return decision

    # ---- cadence thread ----
    def start(self) -> "AutoScaler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name="serve-autoscale",
                                            daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.every_s):
            try:
                self.tick()
            except Exception as e:
                # a failed tick (pool mid-close) must not kill the
                # policy loop for the rest of the process
                self._log(f"autoscale tick failed: {e!r}")
                self.telemetry.count("serve/autoscale_errors")

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30.0)

    def status(self) -> dict:
        return {"target": self.pool.target if self.pool else 0,
                "hold_s": self.hold_s, "every_s": self.every_s,
                "rules": self.engine.status_table()}


class _NullAutoScaler(AutoScaler):
    """Autoscale off: the shared no-op singleton."""

    def __init__(self):
        self.enabled = False
        self.pool = None
        self.telemetry = Telemetry.disabled()
        self.engine = AlertEngine.disabled()
        self.every_s = 0.0
        self.hold_s = 0.0
        self._thread = None

    def tick(self, now=None):
        return None

    def start(self):
        return self

    def stop(self) -> None:
        pass

    def status(self) -> dict:
        return {"target": 0, "hold_s": 0.0, "every_s": 0.0,
                "rules": []}


_NULL_AUTOSCALER = _NullAutoScaler()

"""Stall watchdog: liveness detection for the async pipeline, before a
hang becomes a dead process. A copy of obs/watchdog.py of the JAX
package (stdlib only).

The run is a web of cooperating threads — the train loop,
the persistent infeed producer, the async checkpoint writer, the
serving micro-batcher — and a wedged one manifests only as silence:
nothing crashes, throughput just stops. The watchdog turns silence
into a diagnosis:

  - components `register()` a `Heartbeat` and `beat()` it whenever they
    make progress (one attribute store — cheap enough for per-batch /
    per-step cadence). `busy()` / `idle()` bracket phases where a
    deadline applies at all: an idle checkpoint writer with no job is
    fine; one that went `busy()` and hasn't beaten within its deadline
    is a hang.
  - a monitor thread (or an explicit `check_now()` — the fake-clock
    test path) compares each ACTIVE component's last beat against its
    deadline. A miss emits a `stall` telemetry event and writes a
    diagnostic bundle to the run dir: live unfinished spans (from the
    tracer), every thread's current stack (`sys._current_frames`), and
    a registry snapshot (queue-depth/occupancy gauges included) —
    enough to tell a starved infeed from a wedged writer from a
    deadlocked batcher without attaching a debugger to a pod.
  - stalls are edge-triggered: one event per silence (re-armed by the
    component's next beat), so a long hang doesn't flood the log.
  - `mode="warn"` (default) logs and records; `mode="raise"` makes the
    stall sticky — it re-raises as `StallError` at the stalled
    component's next `beat()`, at `poll()`, and at `stop()` — for runs
    that prefer a loud death to a silent wedge.

Clock injection (`clock=`, default `time.monotonic` — the tracer's
timebase) keeps the tests sleep-free: a fake clock advances past the
deadline and `check_now()` fires synchronously.

Disabled path: `Watchdog.disabled()` is a shared
singleton; `register()` hands out the one shared no-op heartbeat, so
instrumented code paths cost one attribute store when off. Stdlib-only
at import time.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Heartbeat", "StallError", "Watchdog"]


class StallError(RuntimeError):
    """A monitored component missed its progress deadline under
    `mode="raise"`."""


class Heartbeat:
    """One monitored component's progress marker. `beat()` is the hot
    call: a clock read and an attribute store (no lock — the monitor
    tolerates a torn read of a float; a beat can never be mistaken for
    a stall, only observed one check late). Starts INACTIVE: the
    deadline applies only between `busy()`/first `beat()` and
    `idle()`."""

    __slots__ = ("name", "deadline_s", "_wd", "_last", "_active")

    def __init__(self, name: str, deadline_s: float, wd: "Watchdog"):
        self.name = name
        self.deadline_s = deadline_s
        self._wd = wd
        self._last = wd._clock()
        self._active = False

    def beat(self) -> None:
        self._last = self._wd._clock()
        self._active = True
        if self._wd._sticky is not None:  # raise-mode stall lands here
            self._wd.poll()

    def busy(self) -> None:
        """Deadline clock starts now (a writer picking up a job, a
        batcher starting a flush)."""
        self.beat()

    def idle(self) -> None:
        """No work in flight — exempt from the deadline until the next
        beat/busy."""
        self._active = False


class _NullHeartbeat:
    __slots__ = ()
    name = ""

    def beat(self) -> None:
        pass

    def busy(self) -> None:
        pass

    def idle(self) -> None:
        pass


_NULL_HEARTBEAT = _NullHeartbeat()


class Watchdog:
    """Registry of heartbeating components with per-component progress
    deadlines. Construct via `create()` (disabled singleton when the
    telemetry run has no sinks — a stall event nobody can read helps
    nobody) or `disabled()`."""

    def __init__(self, telemetry, *, stall_s: float,
                 mode: str = "warn", tracer=None,
                 clock: Callable[[], float] = time.monotonic,
                 log: Optional[Callable[[str], None]] = None,
                 check_interval_s: Optional[float] = None):
        assert stall_s > 0 and mode in ("warn", "raise")
        self.enabled = True
        self.telemetry = telemetry
        self.default_stall_s = stall_s
        self.mode = mode
        self.tracer = tracer
        self._clock = clock
        self._log = log or (lambda _m: None)
        # poll a few times per deadline, bounded so tests with tiny
        # deadlines don't spin and long deadlines still notice promptly
        self._interval = (check_interval_s if check_interval_s
                          else min(max(stall_s / 4.0, 0.05), 0.9))
        self._lock = threading.Lock()
        self._components: Dict[str, Heartbeat] = {}
        # edge-trigger memory: component -> the `_last` beat timestamp
        # its current stall episode was reported at. Keyed on the beat
        # (not a bare flag) so a beat BETWEEN two overdue checks still
        # re-arms the episode even if no check observed it healthy.
        self._stalled: Dict[str, float] = {}
        self._dump_seq = 0
        self._sticky: Optional[StallError] = None
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # attached via attach(): their state tables join the stall dump
        self._health = None
        self._alerts = None
        self._cohort = None

    # ---- construction ----
    @classmethod
    def create(cls, telemetry, *, stall_s: float, **kw) -> "Watchdog":
        if stall_s <= 0 or telemetry is None or not telemetry.enabled \
                or not telemetry.sinks:
            return _NULL_WATCHDOG
        return cls(telemetry, stall_s=stall_s, **kw)

    @classmethod
    def disabled(cls) -> "Watchdog":
        return _NULL_WATCHDOG

    # ---- components ----
    def register(self, name: str,
                 deadline_s: Optional[float] = None) -> Heartbeat:
        hb = Heartbeat(name, deadline_s or self.default_stall_s, self)
        with self._lock:
            self._components[name] = hb
        return hb

    def attach(self, health=None, alerts=None,
               cohort=None) -> "Watchdog":
        """Attach the health-monitor / alert engines so a
        stall dump carries their state tables: one bundle answers both
        "what is stuck" and "what was already unhealthy". `cohort`
        is a zero-arg callable returning the live cohort
        topology (the supervisor's `cohort_topology()` — live process
        set + target size), so a wedged-cohort dump also answers "who
        was in the mesh"."""
        if health is not None:
            self._health = health
        if alerts is not None:
            self._alerts = alerts
        if cohort is not None:
            self._cohort = cohort
        return self

    def status(self) -> Dict[str, Dict[str, Any]]:
        """Live per-component liveness, recomputed from the heartbeat
        table NOW (not the edge-trigger memory): what /healthz gates
        on. `stalled` = active and past its deadline at this instant.
        """
        now = self._clock()
        with self._lock:
            return {
                name: {"active": hb._active,
                       "deadline_s": hb.deadline_s,
                       "age_s": round(max(0.0, now - hb._last), 3),
                       "stalled": bool(hb._active
                                       and now - hb._last
                                       > hb.deadline_s)}
                for name, hb in self._components.items()}

    # ---- monitoring ----
    def start(self) -> "Watchdog":
        with self._lock:
            if self._thread is None:
                self._stop_event.clear()
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="stall-watchdog")
                self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the monitor thread. Deliberately does NOT re-raise a
        sticky stall (stop runs in `finally` teardown, where raising
        would mask the original error) — success paths call `poll()`
        after stopping."""
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop_event.set()
        if thread is not None:
            thread.join(timeout=5)

    def poll(self) -> None:
        """Re-raise a sticky stall (`mode="raise"`); no-op in warn
        mode. Call sites: a loop that wants to die loudly, the end of
        a successful run, and the stalled component's next `beat()`."""
        with self._lock:
            err, self._sticky = self._sticky, None
        if err is not None:
            raise err

    def _run(self) -> None:
        me = threading.current_thread()
        while not self._stop_event.wait(self._interval):
            if self._thread is not me:  # superseded by stop()+start()
                return
            self.check_now()

    def check_now(self) -> List[Dict[str, Any]]:
        """One synchronous deadline sweep (what the monitor thread runs
        each interval; tests drive it directly under a fake clock).
        Returns the NEW stalls found this sweep."""
        now = self._clock()
        stalls: List[Dict[str, Any]] = []
        with self._lock:
            for name, hb in self._components.items():
                last = hb._last
                if not hb._active:
                    self._stalled.pop(name, None)
                    continue
                age = now - last
                if age <= hb.deadline_s:
                    self._stalled.pop(name, None)
                    continue
                if self._stalled.get(name) == last:
                    continue  # edge-triggered: this silence episode
                    #            was already reported
                self._stalled[name] = last
                stalls.append({"component": name,
                               "age_s": round(age, 3),
                               "deadline_s": hb.deadline_s})
        if stalls:
            dump_path = self._dump(stalls)
            for s in stalls:
                self.telemetry.count("watchdog/stalls")
                self.telemetry.event("stall", dump=dump_path, **s)
                self._log(
                    f"watchdog: STALL {s['component']} — no progress "
                    f"for {s['age_s']:.1f}s (deadline "
                    f"{s['deadline_s']:.1f}s); diagnostics -> "
                    f"{dump_path}")
            if self.mode == "raise":
                with self._lock:
                    if self._sticky is None:
                        self._sticky = StallError(
                            "stalled components: " + ", ".join(
                                s["component"] for s in stalls)
                            + f" (diagnostics: {dump_path})")
        return stalls

    # ---- diagnostics ----
    def _thread_stacks(self) -> Dict[str, List[str]]:
        names = {t.ident: t.name for t in threading.enumerate()}
        out: Dict[str, List[str]] = {}
        for tid, frame in sys._current_frames().items():
            label = f"{names.get(tid, '?')}:{tid}"
            out[label] = [ln.rstrip("\n") for ln in
                          traceback.format_stack(frame)]
        return out

    def _dump(self, stalls: List[Dict[str, Any]]) -> Optional[str]:
        """The diagnostic bundle: live spans + thread stacks + registry
        snapshot, one JSON file per stall episode in the run dir."""
        run_dir = getattr(self.telemetry, "run_dir", None)
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
            components = {
                name: {"active": hb._active,
                       "deadline_s": hb.deadline_s,
                       "last_beat_age_s": round(
                           self._clock() - hb._last, 3)}
                for name, hb in self._components.items()}
        # stale gauges: a dead producer's gauge keeps its last VALUE;
        # age past the stall deadline marks it untrustworthy in the
        # same bundle that shows which component went quiet (ages ride
        # the registry's own monotonic timestamps, not the watchdog's
        # injectable clock)
        gauge_ages = self.telemetry.gauge_ages()
        bundle = {
            "ts": time.time(),
            "stalls": stalls,
            "components": components,
            "live_spans": (self.tracer.live_spans()
                           if self.tracer is not None else []),
            "threads": self._thread_stacks(),
            "telemetry": self.telemetry.summary(),
            "gauge_age_s": {k: round(v, 3)
                            for k, v in gauge_ages.items()},
            "stale_gauges": sorted(
                k for k, v in gauge_ages.items()
                if v > self.default_stall_s),
            # what was already unhealthy BEFORE the stall:
            # the health-monitor + alert-state tables, when attached
            "health": (self._health.status_table()
                       if self._health is not None
                       and self._health.enabled else []),
            "alerts": (self._alerts.status_table()
                       if self._alerts is not None
                       and self._alerts.enabled else []),
        }
        if self._cohort is not None:
            # cohort topology: best-effort — a dump must
            # never die on a provider racing a relaunch
            try:
                bundle["cohort"] = self._cohort()
            except Exception as e:
                bundle["cohort"] = {"error": str(e)}
        if run_dir is None:
            return None
        path = os.path.join(run_dir, f"stall_dump_{seq}.json")
        try:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(bundle, f, indent=1, default=str)
        except OSError:
            return None
        return path


class _NullWatchdog(Watchdog):
    """The watchdog-off path: `register()` hands out the shared no-op
    heartbeat; every other method is a no-op."""

    def __init__(self):
        self.enabled = False
        self.telemetry = None
        self.tracer = None
        self.mode = "warn"
        self._sticky = None
        self._health = None
        self._alerts = None
        self._cohort = None

    def register(self, name, deadline_s=None):
        return _NULL_HEARTBEAT

    def attach(self, health=None, alerts=None, cohort=None):
        return self

    def status(self):
        return {}

    def start(self):
        return self

    def stop(self) -> None:
        pass

    def poll(self) -> None:
        pass

    def check_now(self):
        return []


_NULL_WATCHDOG = _NullWatchdog()

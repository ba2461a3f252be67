"""Training-health monitors: a copy of obs/health.py of the JAX package.
Derived signals evaluated on a cadence OFF the hot path.

The raw registry answers "what happened" (counters, gauges, timer
histograms); nothing in it answers "is this run healthy right now" —
a NaN loss trains on, a throughput regression ships silently, an
infeed stall reads as a slightly larger wait histogram. Each monitor
here turns raw series into ONE derived gauge (`health/<name>`), cheap
enough to recompute every second on a daemon thread, precise enough
for the alert engine (obs/alerts.py) to threshold on:

  - `NonFiniteGauges` — any watched gauge (train/loss; a grad-norm
    gauge if one is published) going NaN/inf. The canary for a
    diverged run: loss keeps "improving" as NaN compares false.
  - `EwmaZScore` — loss-spike detection: EWMA mean/variance of a
    gauge, publishes the current z-score. Robust to slow drift (the
    mean tracks), loud on step changes.
  - `CounterRate` — per-second rate of a counter (throughput), plus
    the ratio of the current rate to a rolling-median baseline: a
    regression shows up as ratio << 1 without anyone choosing an
    absolute threshold per config.
  - `TimerShare` — share of wall time one timer's total contributes
    against a group (infeed starvation: wait / (wait + step)).
  - `CounterRatio` — windowed numerator/denominator counter deltas
    (serving cache-hit rate, shed rate).
  - `OptEfficiency` — analytic-floor attainment of the train step:
    a static `train/step_floor_ms` gauge over observed p50 step time.
    The port publishes no floor gauge yet (the JAX package's sparse
    traffic model is not ported), so it reports no data.
  - `PhaseRoofline` — per-phase roofline gauges and the split's
    coverage of the fused step, from the phase profiler's timers. The
    port has no phase profiler yet, so it reports no data too.

Monitors only READ the registry (snapshot-don't-lock: dict reads of
float values are atomic under the GIL; a torn multi-metric view skews
one evaluation by one tick, which the cadence tolerates) and WRITE
exactly one gauge each — so the hot path never sees them, and the
exposition endpoint serves their latest values for free.

`HealthEngine` owns the cadence: a daemon thread sweeps every monitor
each interval, then calls its listeners (the alert engine registers
itself) with the same `now`, so rules always evaluate the freshest
derived gauges. Fake-clock injectable (`clock=`) like the watchdog —
the tests advance time explicitly and call `check_now()`.

Disabled path: `HealthEngine.create(None)` (or a disabled telemetry)
returns a shared no-op singleton; instrumented call sites cost one
boolean check. Stdlib-only.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

# the phases that are device time inside the fused step (infeed wait is
# host time outside it): PhaseRoofline sums their p50s
from code2vec_tpu_torch.obs.phases import DEVICE_PHASES

__all__ = ["HealthEngine", "Monitor", "NonFiniteGauges", "EwmaZScore",
           "CounterRate", "TimerShare", "CounterRatio", "OptEfficiency",
           "PhaseRoofline", "default_train_monitors",
           "default_serving_monitors"]


def _is_finite(v: Any) -> bool:
    try:
        return math.isfinite(float(v))
    except (TypeError, ValueError):
        return False


class Monitor:
    """One derived signal. `evaluate(telemetry, now)` reads raw series,
    updates internal state, publishes `health/<name>` (emit=False — a
    gauge store, never a JSONL event per tick), and records its status
    row for the stall dump / /vars table."""

    def __init__(self, name: str):
        self.name = name
        self.value: float = float("nan")
        self.status: str = "unknown"  # "ok" | "bad" | "unknown"
        self.detail: str = ""

    def evaluate(self, telemetry, now: float) -> None:
        raise NotImplementedError

    def _publish(self, telemetry, value: float, status: str,
                 detail: str = "") -> None:
        self.value, self.status, self.detail = value, status, detail
        telemetry.gauge(f"health/{self.name}", value, emit=False)

    def row(self) -> Dict[str, Any]:
        return {"monitor": self.name, "value": self.value,
                "status": self.status, "detail": self.detail}


class NonFiniteGauges(Monitor):
    """1.0 while ANY watched gauge is non-finite, else 0.0. Watches
    gauges (not events): the recorder publishes `train/loss` every step
    for exactly this read."""

    def __init__(self, gauges: Sequence[str] = ("train/loss",),
                 name: str = "nonfinite"):
        super().__init__(name)
        self.watched = tuple(gauges)

    def evaluate(self, telemetry, now: float) -> None:
        seen = False
        bad: List[str] = []
        for g in self.watched:
            v = telemetry.gauges.get(g)
            if v is None:
                continue
            seen = True
            if not _is_finite(v):
                bad.append(g)
        if not seen:
            self._publish(telemetry, float("nan"), "unknown",
                          "no watched gauge published yet")
        elif bad:
            self._publish(telemetry, 1.0, "bad",
                          "non-finite: " + ", ".join(bad))
        else:
            self._publish(telemetry, 0.0, "ok")


class EwmaZScore(Monitor):
    """Spike detector: |z| of the newest gauge sample against an EWMA
    mean/variance of its history. Non-finite samples are skipped (the
    NonFiniteGauges monitor owns those); the variance floor keeps a
    perfectly flat warmup from dividing by zero on the first wiggle."""

    def __init__(self, gauge: str = "train/loss",
                 name: str = "loss_spike_z", alpha: float = 0.1,
                 warmup: int = 8, var_floor: float = 1e-12):
        super().__init__(name)
        self.gauge = gauge
        self.alpha = alpha
        self.warmup = warmup
        self.var_floor = var_floor
        self._mean: Optional[float] = None
        self._var = 0.0
        self._n = 0

    def evaluate(self, telemetry, now: float) -> None:
        v = telemetry.gauges.get(self.gauge)
        if v is None or not _is_finite(v):
            self._publish(telemetry, self.value,
                          self.status if v is None else "unknown",
                          "no finite sample")
            return
        v = float(v)
        if self._mean is None:
            self._mean = v
            self._n = 1
            self._publish(telemetry, 0.0, "ok", "warming up")
            return
        # z against the PRE-update stats: the spike itself must not
        # vanish into the mean it is being compared to
        sd = math.sqrt(max(self._var, self.var_floor))
        z = abs(v - self._mean) / sd if self._n >= self.warmup else 0.0
        d = v - self._mean
        self._mean += self.alpha * d
        self._var = (1 - self.alpha) * (self._var + self.alpha * d * d)
        self._n += 1
        self._publish(telemetry, z,
                      "ok" if self._n <= self.warmup else
                      ("bad" if z > 6.0 else "ok"))


class CounterRate(Monitor):
    """Per-second rate of a counter between sweeps, published as
    `health/<name>`; additionally publishes `health/<name>_ratio` —
    current rate over the rolling median of recent rates — so a
    throughput regression is a config-independent "ratio < 0.5", not
    an absolute examples/sec anyone has to tune per model size."""

    def __init__(self, counter: str = "train/examples",
                 name: str = "throughput", history: int = 30,
                 min_history: int = 5):
        super().__init__(name)
        self.counter = counter
        self._last: Optional[tuple] = None  # (now, count)
        self._rates: "collections.deque" = collections.deque(
            maxlen=history)
        self.min_history = min_history
        self.ratio: float = float("nan")

    def evaluate(self, telemetry, now: float) -> None:
        count = telemetry.counters.get(self.counter)
        if count is None:
            self._publish(telemetry, float("nan"), "unknown",
                          f"counter {self.counter} absent")
            return
        if self._last is None:
            self._last = (now, count)
            self._publish(telemetry, float("nan"), "unknown",
                          "first sample")
            return
        t0, c0 = self._last
        dt = now - t0
        if dt <= 0:
            return
        self._last = (now, count)
        rate = max(0.0, count - c0) / dt
        if rate == 0.0:
            # no progress at all this window: a legitimate pause
            # (epoch eval, checkpoint tail, first-step compile) or a
            # hang — either way NOT a throughput regression, and
            # liveness is the watchdog's domain (its busy()/idle()
            # exemption exists for exactly these gaps). Keep the last
            # verdict and don't poison the rolling baseline with 0s.
            self._publish(telemetry, self.value, self.status,
                          "no progress this window (liveness is the "
                          "watchdog's domain)")
            return
        baseline = (sorted(self._rates)[len(self._rates) // 2]
                    if len(self._rates) >= self.min_history else None)
        # the baseline excludes the current sample: a regression must
        # not drag down the very median it is judged against
        self._rates.append(rate)
        if baseline is None or baseline <= 0:
            self.ratio = float("nan")
            self._publish(telemetry, rate, "ok", "building baseline")
            return
        self.ratio = rate / baseline
        telemetry.gauge(f"health/{self.name}_ratio", self.ratio,
                        emit=False)
        self._publish(telemetry, rate,
                      "bad" if self.ratio < 0.5 else "ok",
                      f"ratio {self.ratio:.2f} vs rolling median")


class TimerShare(Monitor):
    """Share of one timer's total_ms against a group of timers, over
    the delta since the last sweep (infeed starvation: wait time as a
    fraction of wait + step — near 0 while the producer keeps up,
    toward 1 exactly when the input pipeline is the bottleneck)."""

    def __init__(self, numerator: str = "train/infeed_wait_ms",
                 denominators: Sequence[str] = ("train/infeed_wait_ms",
                                                "train/step_ms"),
                 name: str = "infeed_starvation"):
        super().__init__(name)
        self.numerator = numerator
        self.denominators = tuple(denominators)
        self._last_totals: Optional[Dict[str, float]] = None

    def evaluate(self, telemetry, now: float) -> None:
        totals = {}
        for t in set(self.denominators) | {self.numerator}:
            stat = telemetry.timers.get(t)
            totals[t] = stat.total_ms if stat is not None else 0.0
        if self._last_totals is None:
            self._last_totals = totals
            self._publish(telemetry, float("nan"), "unknown",
                          "first sample")
            return
        d_num = totals[self.numerator] - self._last_totals[self.numerator]
        d_den = sum(totals[t] - self._last_totals[t]
                    for t in self.denominators)
        self._last_totals = totals
        if d_den <= 0:
            # no step finished this tick — keep the last share instead
            # of a phantom 0/0 ("no work" is the watchdog's department)
            self._publish(telemetry, self.value, self.status, "no data")
            return
        share = min(1.0, max(0.0, d_num / d_den))
        self._publish(telemetry, share,
                      "bad" if share > 0.5 else "ok")


class CounterRatio(Monitor):
    """Windowed numerator/denominator counter-delta ratio: cache-hit
    rate (hits / (hits + misses)), shed rate (shed / submitted). The
    window is the sweep interval; ticks with no denominator traffic
    keep the previous value."""

    def __init__(self, numerator: str, denominators: Sequence[str],
                 name: str, bad_above: Optional[float] = None,
                 bad_below: Optional[float] = None,
                 min_events: int = 1):
        super().__init__(name)
        self.numerator = numerator
        self.denominators = tuple(denominators)
        self.bad_above = bad_above
        self.bad_below = bad_below
        self.min_events = min_events
        self._last: Optional[Dict[str, float]] = None

    def evaluate(self, telemetry, now: float) -> None:
        names = set(self.denominators) | {self.numerator}
        counts = {n: telemetry.counters.get(n, 0.0) for n in names}
        if self._last is None:
            self._last = counts
            self._publish(telemetry, float("nan"), "unknown",
                          "first sample")
            return
        d_num = counts[self.numerator] - self._last[self.numerator]
        d_den = sum(counts[n] - self._last[n]
                    for n in self.denominators)
        self._last = counts
        if d_den < self.min_events:
            self._publish(telemetry, self.value, self.status,
                          "no traffic this window")
            return
        ratio = d_num / d_den
        status = "ok"
        if self.bad_above is not None and ratio > self.bad_above:
            status = "bad"
        if self.bad_below is not None and ratio < self.bad_below:
            status = "bad"
        self._publish(telemetry, ratio, status)


class OptEfficiency(Monitor):
    """Analytic-floor attainment of the train step: a STATIC floor
    gauge (`train/step_floor_ms`, which a train loop publishes once from
    a traffic model of its step) divided by the observed p50 step time:
    near 1 means the step runs at its roofline, and ANY step-time
    regression — a new host sync, a slow kernel — pulls the gauge down
    mid-run. Publishes unknown while the floor gauge is absent (the
    train loop publishes it for the sparse-row step only)."""

    def __init__(self, floor_gauge: str = "train/step_floor_ms",
                 timer: str = "train/step_ms",
                 name: str = "opt_efficiency",
                 bad_below: float = 0.25):
        super().__init__(name)
        self.floor_gauge = floor_gauge
        self.timer = timer
        self.bad_below = bad_below

    def evaluate(self, telemetry, now: float) -> None:
        floor = telemetry.gauges.get(self.floor_gauge)
        stat = telemetry.timers.get(self.timer)
        if floor is None or not _is_finite(floor) or float(floor) <= 0:
            self._publish(telemetry, float("nan"), "unknown",
                          "no step-floor gauge published")
            return
        if stat is None or stat.count == 0:
            self._publish(telemetry, float("nan"), "unknown",
                          "no step samples yet")
            return
        p50 = stat.percentile(50)
        if p50 <= 0:
            self._publish(telemetry, self.value, self.status,
                          "zero p50")
            return
        eff = min(1.0, float(floor) / p50)
        self._publish(telemetry, eff,
                      "bad" if eff < self.bad_below else "ok")


class PhaseRoofline(Monitor):
    """Per-phase roofline gauges + split-coverage verdict.

    Reads the sampled phase-split timers (`train/phase/<p>_ms`, which a
    phase profiler writes every few steps) and the static analytic
    traffic gauges (`train/phase_bytes/<p>`) and publishes one
    `health/phase_<p>` gauge per phase: achieved GB/s (bytes over the
    observed p50) divided by the `train/phase_ceiling_gbps` streaming
    ceiling — each phase's live roofline attainment, the per-phase
    generalization of OptEfficiency above. The monitor's own value is
    the SPLIT COVERAGE: sum of device-phase p50s over the fused sampled
    dispatch's p50 — the live form of the "phases sum to within 15% of
    the fused step" acceptance; far from 1 means the split no longer
    describes the fused step (a new unattributed stage, or fusion wins
    the probes cannot see). Unknown until the first sampled step lands
    (phase profiling off = no timers, no verdict)."""

    _PREFIX = "train/phase/"

    def __init__(self, name: str = "phase_coverage",
                 bad_beyond: float = 0.25):
        super().__init__(name)
        self.bad_beyond = bad_beyond

    def evaluate(self, telemetry, now: float) -> None:
        fused = telemetry.timers.get(self._PREFIX + "fused_step_ms")
        if fused is None or fused.count == 0:
            self._publish(telemetry, float("nan"), "unknown",
                          "no sampled phase-split step yet")
            return
        ceiling = telemetry.gauges.get("train/phase_ceiling_gbps")
        total = 0.0
        for tname, stat in list(telemetry.timers.items()):
            if not tname.startswith(self._PREFIX) \
                    or not tname.endswith("_ms") or stat.count == 0:
                continue
            phase = tname[len(self._PREFIX):-3]
            p50 = stat.percentile(50)
            if phase in DEVICE_PHASES:
                total += p50
            nbytes = telemetry.gauges.get(f"train/phase_bytes/{phase}")
            if nbytes and _is_finite(nbytes) and ceiling \
                    and _is_finite(ceiling) and p50 > 0:
                util = (float(nbytes) / (p50 / 1e3)) \
                    / (float(ceiling) * 1e9)
                telemetry.gauge(f"health/phase_{phase}",
                                min(1.0, util), emit=False)
        fused_p50 = fused.percentile(50)
        if fused_p50 <= 0:
            self._publish(telemetry, self.value, self.status,
                          "zero fused p50")
            return
        cov = total / fused_p50
        self._publish(telemetry, cov,
                      "bad" if abs(cov - 1.0) > self.bad_beyond
                      else "ok",
                      f"split phases cover {cov:.2f} of fused p50")


def default_train_monitors() -> List[Monitor]:
    """The train-loop set: non-finite loss, loss spike, throughput
    regression, infeed starvation, analytic-floor attainment, phase
    coverage. Raw inputs are the gauges/timers the train loop publishes
    through TrainStepRecorder (the last two report no data in the
    port: no floor gauge, no phase timers)."""
    return [
        NonFiniteGauges(("train/loss",), name="loss_nonfinite"),
        EwmaZScore("train/loss", name="loss_spike_z"),
        CounterRate("train/examples", name="throughput"),
        TimerShare(name="infeed_starvation"),
        OptEfficiency(name="opt_efficiency"),
        PhaseRoofline(name="phase_coverage"),
    ]


def default_serving_monitors() -> List[Monitor]:
    """The serving set: cache-hit collapse and shed rate over the
    PredictionServer's counters."""
    return [
        CounterRatio("serve/cache_hit",
                     ("serve/cache_hit", "serve/cache_miss"),
                     name="cache_hit_rate", min_events=8),
        CounterRatio("serve/shed",
                     ("serve/requests", "serve/shed"),
                     name="shed_rate", bad_above=0.05, min_events=8),
    ]


class HealthEngine:
    """Cadenced evaluator: one daemon thread sweeps every monitor each
    `interval_s`, then notifies listeners (the alert engine) with the
    sweep timestamp. Construct via `create()` (shared no-op singleton
    when telemetry is off) — the monitor thread exists only when
    something can read its output."""

    def __init__(self, telemetry, *, interval_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 log: Optional[Callable[[str], None]] = None):
        assert interval_s > 0
        self.enabled = True
        self.telemetry = telemetry
        self.interval_s = interval_s
        self._clock = clock
        self._log = log or (lambda _m: None)
        self._lock = threading.Lock()
        self._monitors: List[Monitor] = []
        self._listeners: List[Callable[[float], None]] = []
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- construction ----
    @classmethod
    def create(cls, telemetry, **kw) -> "HealthEngine":
        if telemetry is None or not telemetry.enabled:
            return _NULL_HEALTH
        return cls(telemetry, **kw)

    @classmethod
    def disabled(cls) -> "HealthEngine":
        return _NULL_HEALTH

    # ---- composition ----
    def add(self, *monitors: Monitor) -> "HealthEngine":
        with self._lock:
            self._monitors.extend(monitors)
        return self

    def add_listener(self, fn: Callable[[float], None]) -> None:
        """Called after every sweep with the sweep's `now` (the alert
        engine registers its evaluate here, so rules always see the
        derived gauges this sweep just wrote)."""
        with self._lock:
            self._listeners.append(fn)

    # ---- evaluation ----
    def check_now(self) -> List[Dict[str, Any]]:
        """One synchronous sweep (what the thread runs each interval;
        tests drive it directly under a fake clock). Returns the
        status table."""
        now = self._clock()
        with self._lock:
            monitors = list(self._monitors)
            listeners = list(self._listeners)
        for m in monitors:
            try:
                m.evaluate(self.telemetry, now)
            except Exception as e:  # noqa: BLE001 — a broken monitor
                # must not kill the sweep thread (or the run)
                m.status, m.detail = "error", repr(e)
                self._log(f"health: monitor {m.name} failed: {e!r}")
        for fn in listeners:
            fn(now)
        return self.status_table()

    def status_table(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [m.row() for m in self._monitors]

    # ---- lifecycle ----
    def start(self) -> "HealthEngine":
        with self._lock:
            if self._thread is None:
                self._stop_event.clear()
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="health-monitor")
                self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop_event.set()
        if thread is not None:
            thread.join(timeout=5)

    def _run(self) -> None:
        me = threading.current_thread()
        while not self._stop_event.wait(self.interval_s):
            if self._thread is not me:  # superseded by stop()+start()
                return
            self.check_now()


class _NullHealthEngine(HealthEngine):
    """The off path: every method a no-op, shared singleton."""

    def __init__(self):
        self.enabled = False
        self.telemetry = None

    def add(self, *monitors):
        return self

    def add_listener(self, fn):
        pass

    def check_now(self):
        return []

    def status_table(self):
        return []

    def start(self):
        return self

    def stop(self) -> None:
        pass


_NULL_HEALTH = _NullHealthEngine()

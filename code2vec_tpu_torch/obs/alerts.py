"""SLO alert engine: a copy of obs/alerts.py of the JAX package.
Declarative rules over registry series, edge-triggered events,
warn|raise discipline.

The health monitors (obs/health.py) turn raw series into derived
gauges; this layer turns gauges into DECISIONS. Two rule kinds, both
the standard production shapes:

  - `threshold` — compare one series against a constant, with an
    optional `for_s` hold (the Prometheus `for:` clause): the
    condition must stay true that long before the rule fires, so one
    noisy sample can't page anyone. The series reference resolves a
    gauge first, then a counter, and `name:p99` reads a timer
    percentile — `serve/request_ms:p99 > 250 for 30s` is a latency
    SLO in one line.
  - `burn_rate` — multi-window error-budget burn (the Google SRE
    workbook shape): the ratio of a bad-events counter to a total
    counter, computed over BOTH a short and a long window, must
    exceed the threshold in each. The short window makes the alert
    fast on a real outage; the long window keeps a brief blip from
    firing it. The engine keeps its own (t, num, den) sample ring per
    rule — counters are cumulative, so windowed rates need history
    the registry doesn't store.

Rules are data: built-in defaults cover the health monitors
(non-finite loss, loss spike, throughput regression, infeed
starvation, cache-hit collapse, shed burn-rate) and `--alerts_rules
<file.json>` replaces them with a JSON list of objects whose keys are
`AlertRule`'s arguments (`load_rules`).

Alerts are edge-triggered state machines (ok -> pending -> firing ->
resolved): ONE `alert` JSONL event + stdout line per transition, so a
condition that stays bad for an hour produces two lines, not a flood.
`mode="raise"` reuses the watchdog's sticky-error discipline: the
firing rule arms a sticky `AlertError` that re-raises at the training
loop's next beat (`poll()`, wired through TrainStepRecorder.end_step)
and at the end-of-run poll — never from the monitor thread, whose
raise nobody would catch.

Disabled path: `AlertEngine.create(None)` or mode "off" returns a
shared no-op singleton; the per-step hot-path cost of an armed engine
is one attribute check (`_sticky is None`). Stdlib-only.
"""

from __future__ import annotations

import collections
import json
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["AlertError", "AlertRule", "AlertEngine", "load_rules",
           "default_train_rules", "default_serving_rules",
           "serving_slo_rules"]

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


class AlertError(RuntimeError):
    """A firing alert under `mode="raise"` — surfaced at the training
    loop's next beat, never from the monitor thread."""


class AlertRule:
    """One declarative rule. Threshold form:

        AlertRule("loss_nonfinite", metric="health/loss_nonfinite",
                  op=">=", value=1)

    Burn-rate form (`kind="burn_rate"`): `metric` is the bad-events
    counter, `denominator` the total-events counter — "+"-separated
    names are summed, which matters when no single counter covers all
    outcomes (`serve/requests` counts only successes, so the shed
    burn-rate divides by `serve/requests+serve/shed`; a denominator
    that stops moving during a total outage would silence the alert
    exactly when it matters). `windows` is the (short_s, long_s)
    pair, `value` the budget-burn ratio both windows must exceed.
    """

    def __init__(self, name: str, metric: str, *,
                 kind: str = "threshold", op: str = ">",
                 value: float = 0.0, for_s: float = 0.0,
                 denominator: str = "",
                 windows: Sequence[float] = (60.0, 300.0),
                 severity: str = "page"):
        if kind not in ("threshold", "burn_rate"):
            raise ValueError(f"rule {name!r}: kind must be threshold "
                             f"or burn_rate (got {kind!r})")
        if op not in _OPS:
            raise ValueError(f"rule {name!r}: op must be one of "
                             f"{sorted(_OPS)} (got {op!r})")
        if kind == "burn_rate":
            if not denominator:
                raise ValueError(f"rule {name!r}: burn_rate needs a "
                                 "denominator counter")
            if len(windows) != 2 or windows[0] >= windows[1]:
                raise ValueError(f"rule {name!r}: windows must be "
                                 "(short_s, long_s) with short < long")
        self.name = name
        self.metric = metric
        self.kind = kind
        self.op = op
        self.value = float(value)
        self.for_s = float(for_s)
        self.denominator = denominator
        self._den_names = tuple(n.strip()
                                for n in denominator.split("+") if n)
        self.windows = tuple(float(w) for w in windows)
        self.severity = severity
        # state machine: "ok" | "pending" | "firing"
        self.state = "ok"
        self.since: Optional[float] = None   # entered current state at
        self.last_value: float = float("nan")
        # burn-rate sample ring: (t, num, den), long-window deep
        self._samples: "collections.deque" = collections.deque()

    # ---- evaluation ----
    def _resolve(self, telemetry) -> Optional[float]:
        """Threshold series lookup: gauge, else counter, else
        `name:pNN` timer percentile. None = series not published yet
        (the rule stays quiet — absence is the watchdog's domain)."""
        name, _, pct = self.metric.partition(":")
        if pct:
            stat = telemetry.timers.get(name)
            if stat is None or stat.count == 0:
                return None
            return stat.percentile(float(pct.lstrip("pP")))
        v = telemetry.gauges.get(name)
        if v is None:
            v = telemetry.counters.get(name)
        return None if v is None else float(v)

    def _condition(self, telemetry, now: float):
        """(condition_met, observed_value) — or (None, nan) when the
        series isn't there yet."""
        if self.kind == "threshold":
            v = self._resolve(telemetry)
            if v is None or not math.isfinite(v):
                # a non-finite gauge can't be compared; the
                # nonfinite health monitor exists to turn it into a
                # finite 0/1 signal rules CAN threshold on
                return None, float("nan")
            return _OPS[self.op](v, self.value), v
        # burn_rate: sample the counters, trim to the long window,
        # require both windowed ratios over the threshold
        num = float(telemetry.counters.get(self.metric, 0.0))
        den = float(sum(telemetry.counters.get(d, 0.0)
                        for d in self._den_names))
        self._samples.append((now, num, den))
        short_s, long_s = self.windows
        # keep ONE sample at/past the long cutoff so the long window
        # always has a base to difference against
        while len(self._samples) >= 2 \
                and now - self._samples[1][0] >= long_s:
            self._samples.popleft()

        def ratio(window_s: float) -> Optional[float]:
            cutoff = now - window_s
            base = None
            for t, n, d in self._samples:
                if t <= cutoff:
                    base = (n, d)
                else:
                    break
            if base is None:
                # not enough history for this window yet: no verdict —
                # a burn-rate needs its full window before it can
                # claim the budget is burning (fail-quiet beats a
                # false page on the first bad minute)
                return None
            d_num, d_den = num - base[0], den - base[1]
            return d_num / d_den if d_den > 0 else None

        r_short, r_long = ratio(short_s), ratio(long_s)
        if r_short is None or r_long is None:
            return None, float("nan")
        met = (_OPS[self.op](r_short, self.value)
               and _OPS[self.op](r_long, self.value))
        return met, r_short

    def evaluate(self, telemetry, now: float) -> Optional[str]:
        """Advance the state machine one tick. Returns "firing" or
        "resolved" on a transition worth reporting, else None."""
        met, value = self._condition(telemetry, now)
        self.last_value = value
        if met is None:
            return None
        if met:
            if self.state == "ok":
                self.state, self.since = "pending", now
            if self.state == "pending" and now - self.since >= self.for_s:
                self.state, self.since = "firing", now
                return "firing"
            return None
        was_firing = self.state == "firing"
        self.state, self.since = "ok", now
        return "resolved" if was_firing else None

    def row(self) -> Dict[str, Any]:
        # key is "rule_kind", not "kind": these rows are splatted into
        # Telemetry.event("alert", **row), whose first field is kind
        out = {"rule": self.name, "rule_kind": self.kind,
               "state": self.state, "metric": self.metric,
               "op": self.op, "threshold": self.value,
               "value": self.last_value, "severity": self.severity}
        if self.for_s:
            out["for_s"] = self.for_s
        if self.kind == "burn_rate":
            out["denominator"] = self.denominator
            out["windows"] = list(self.windows)
        return out


def default_train_rules() -> List[AlertRule]:
    """Rules over the default train health monitors. The spike/
    regression thresholds are deliberately loose — page-worthy, not
    dashboard-worthy (the monitors' gauges stay visible on /metrics
    either way)."""
    return [
        AlertRule("loss_nonfinite", metric="health/loss_nonfinite",
                  op=">=", value=1.0),
        AlertRule("loss_spike", metric="health/loss_spike_z",
                  op=">", value=8.0, severity="ticket"),
        AlertRule("throughput_regression",
                  metric="health/throughput_ratio",
                  op="<", value=0.5, for_s=10.0, severity="ticket"),
        AlertRule("infeed_starvation",
                  metric="health/infeed_starvation",
                  op=">", value=0.5, for_s=10.0, severity="ticket"),
    ]


def default_serving_rules() -> List[AlertRule]:
    return [
        AlertRule("cache_hit_collapse",
                  metric="health/cache_hit_rate",
                  op="<", value=0.1, for_s=10.0, severity="ticket"),
        # denominator = ALL submissions: serve/requests counts only
        # completed requests, so dividing by it alone would zero out
        # (and silence the alert) during a 100%-shed outage
        AlertRule("shed_burn_rate", metric="serve/shed",
                  kind="burn_rate",
                  denominator="serve/requests+serve/shed",
                  op=">", value=0.05, windows=(60.0, 300.0)),
    ]


def serving_slo_rules(slo_ms: float = 250.0, *,
                      windows: Sequence[float] = (30.0, 120.0)
                      ) -> List[AlertRule]:
    """The external-serving SLO rule set: what a replica fleet's
    autoscaler scales on, and what a serving front-end reports (the JAX
    package has both; the port not yet). The p99 rule and the shed
    burn-rate are the two page-severity signals a pool grows on;
    `reload_refused` and `replica_dead` are ticket-severity —
    operator-visible facts that the system already self-healed
    (refused the corrupt step, refilled the dead replica), not
    pages."""
    return [
        AlertRule("serving_p99_slo", metric="serve/request_ms:p99",
                  op=">", value=float(slo_ms), for_s=5.0),
        # same denominator discipline as default_serving_rules: divide
        # by ALL submissions or a total-shed outage silences the alert
        AlertRule("serving_shed_burn", metric="serve/shed",
                  kind="burn_rate",
                  denominator="serve/requests+serve/shed",
                  op=">", value=0.05, windows=windows),
        AlertRule("reload_refused", metric="serve/reload_refused",
                  op=">=", value=1.0, severity="ticket"),
        AlertRule("replica_dead", metric="serve/replica_dead",
                  op=">=", value=1.0, severity="ticket"),
    ]


def load_rules(path: Optional[str]) -> Optional[List[AlertRule]]:
    """Parse a `--alerts_rules` JSON file: a list of rule objects whose
    keys mirror AlertRule's arguments. None path -> None (callers fall
    back to the built-in defaults)."""
    if not path:
        return None
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    if not isinstance(raw, list):
        raise ValueError(f"{path}: expected a JSON list of rule "
                         "objects")
    rules = []
    for i, obj in enumerate(raw):
        if not isinstance(obj, dict) or "name" not in obj \
                or "metric" not in obj:
            raise ValueError(f"{path}[{i}]: each rule needs at least "
                             "name and metric")
        kw = dict(obj)
        rules.append(AlertRule(kw.pop("name"), kw.pop("metric"), **kw))
    return rules


class AlertEngine:
    """Rule evaluator + sticky-raise plumbing. Evaluation runs as a
    HealthEngine listener (same sweep, same `now`) or directly via
    `check_now()`; transitions emit one `alert` event + stdout line
    each. Construct via `create()` — a disabled singleton when
    telemetry is off or mode is "off"."""

    def __init__(self, telemetry, rules: Sequence[AlertRule], *,
                 mode: str = "warn",
                 clock: Callable[[], float] = time.monotonic,
                 log: Optional[Callable[[str], None]] = None):
        assert mode in ("warn", "raise")
        self.enabled = True
        self.telemetry = telemetry
        self.mode = mode
        self.rules = list(rules)
        self._clock = clock
        self._log = log or (lambda _m: None)
        self._lock = threading.Lock()
        self._sticky: Optional[AlertError] = None

    # ---- construction ----
    @classmethod
    def create(cls, telemetry, *, mode: str = "off",
               rules: Optional[Sequence[AlertRule]] = None,
               **kw) -> "AlertEngine":
        if mode == "off" or telemetry is None or not telemetry.enabled:
            return _NULL_ALERTS
        return cls(telemetry, rules if rules is not None else [],
                   mode=mode, **kw)

    @classmethod
    def disabled(cls) -> "AlertEngine":
        return _NULL_ALERTS

    # ---- evaluation ----
    def evaluate(self, now: Optional[float] = None) -> List[Dict]:
        """One sweep over every rule (the HealthEngine listener form —
        pass its `now` so rules and monitors agree on time). Returns
        the transitions reported this sweep."""
        t = self._clock() if now is None else now
        transitions: List[Dict[str, Any]] = []
        with self._lock:
            rules = list(self.rules)
        for rule in rules:
            change = rule.evaluate(self.telemetry, t)
            if change is None:
                continue
            row = rule.row()
            row["transition"] = change
            transitions.append(row)
        for row in transitions:
            self.telemetry.count("alerts/transitions")
            self.telemetry.event("alert", **row)
            verb = ("ALERT firing" if row["transition"] == "firing"
                    else "alert resolved")
            self._log(
                f"alerts: {verb}: {row['rule']} "
                f"({row['metric']} {row['op']} {row['threshold']}, "
                f"observed {row['value']:.4g}, "
                f"severity {row['severity']})")
            if row["transition"] == "firing":
                self.telemetry.count("alerts/fired")
                if self.mode == "raise":
                    with self._lock:
                        if self._sticky is None:
                            self._sticky = AlertError(
                                f"alert {row['rule']} firing: "
                                f"{row['metric']} {row['op']} "
                                f"{row['threshold']} (observed "
                                f"{row['value']:.4g})")
        # live alert-state gauges: /metrics exposes firing rules
        # without parsing the event log
        firing = sum(1 for r in rules if r.state == "firing")
        self.telemetry.gauge("alerts/firing", firing, emit=False)
        return transitions

    def check_now(self) -> List[Dict]:
        return self.evaluate()

    # ---- sticky-raise (the watchdog discipline) ----
    def poll(self) -> None:
        """Re-raise a sticky firing alert (`mode="raise"`); no-op in
        warn mode. Call sites: TrainStepRecorder.end_step (the loop's
        next beat) and the end-of-run poll next to watchdog.poll()."""
        with self._lock:
            err, self._sticky = self._sticky, None
        if err is not None:
            raise err

    def status_table(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r.row() for r in self.rules]


class _NullAlertEngine(AlertEngine):
    """The alerts-off path: shared no-op singleton, `_sticky` pinned
    to None so the hot-path guard is one attribute read."""

    def __init__(self):
        self.enabled = False
        self.telemetry = None
        self.mode = "warn"
        self.rules = []
        self._sticky = None

    def evaluate(self, now=None):
        return []

    def check_now(self):
        return []

    def poll(self) -> None:
        pass

    def status_table(self):
        return []


_NULL_ALERTS = _NullAlertEngine()

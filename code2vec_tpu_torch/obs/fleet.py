"""Fleet plane: a copy of obs/fleet.py of the JAX package. Live cohort
aggregation: the signals no single process can compute.

`FleetCollector` is the pull tier over N member `/metrics` + `/vars`
endpoints (stdlib urllib, the shared obs/promtext parser) that derives,
each sweep:

  - **clock offsets**: at first contact (and again whenever a member's
    run_id changes: a supervisor relaunch is a NEW process) the
    collector runs the `/clock` handshake: K round trips, each bracketed
    by the collector's own wall clock; one offset sample is
    `member_wall - (c0 + c1) / 2` (the round-trip-corrected midpoint),
    and the member's offset is the median of K, robust to a tail of
    asymmetric round trips. The measurement is COMMITTED back
    (`/clock?commit=1&offset_s=...`) so the member persists it into its
    run manifest (Telemetry.update_manifest).
  - **straggler score**: per member, the p50 of each attributable
    series (`train/step_ms`, `train/infeed_wait_ms`, every
    `train/phase_*_ms` it exports) over the COHORT MEDIAN of that
    series; the member's score is its worst ratio, and the series that
    produced it names the attribution. One member has no score.
  - **divergence**: members publish a per-step loss gauge and a sampled
    params fingerprint (obs/loop.py), step-labeled; the collector keeps
    recent (step -> value) pairs per member and compares members at
    MATCHING steps. Replicated training replicates both, so any
    disagreement past tolerance sets `fleet/divergence` and the
    `cohort_divergence` ticket fires through the alert engine.
  - **cohort throughput**: summed examples/s and path-contexts/s,
    differenced between sweeps with the shared counter-reset semantics
    (promtext.CounterRates).

Aggregates publish as `fleet/*` gauges into the HOSTING process's
registry (the supervisor: training/supervisor.py wires the collector
and its alert rules ride the supervisor's engine), serve live on
`/fleet` (obs/exposition.py, JSON and Prometheus text), and persist as a
bounded JSONL ring for postmortems.

The port's trainer runs one process on one card, so a cohort is one
member today; the collector is the JAX package's, whole, for when
multi-GPU training makes it more. House rules: the disabled path is a
shared no-op singleton (no thread, one check per site); `clock`,
`wall` and `fetch` are injectable, so every policy test runs without
sleeps or sockets; stdlib only.
"""

from __future__ import annotations

import collections
import json
import statistics
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Sequence

from code2vec_tpu_torch.obs import promtext

__all__ = ["FleetCollector", "fleet_alert_rules"]

# per-host step history kept for cross-host divergence matching: deep
# enough that two hosts scraped a few steps apart still intersect
_STEP_HISTORY = 64


def fleet_alert_rules():
    """Cohort tickets over the collector's gauges — evaluated by the
    HOSTING process's alert engine (the supervisor's). Quiet until the
    fleet plane publishes (threshold rules on absent series never
    fire), so they are safe to install unconditionally."""
    from code2vec_tpu_torch.obs.alerts import AlertRule
    return [
        # one host's p50 at 1.5x the cohort median on any attributable
        # series: capacity is degraded NOW, but training still moves —
        # ticket, not page
        AlertRule("cohort_straggler", metric="fleet/straggler_score",
                  op=">", value=1.5, severity="ticket"),
        # replicated loss / params fingerprints disagreeing at the
        # SAME step: the SPMD contract is broken at runtime
        AlertRule("cohort_divergence", metric="fleet/divergence",
                  op=">=", value=1.0, severity="ticket"),
    ]


class _Member:
    """One endpoint's collector-side state: rate window, measured
    clock offset, identity, and the recent step-labeled values the
    divergence check matches across hosts."""

    def __init__(self, endpoint: str):
        self.endpoint = endpoint
        self.url = (endpoint if "://" in endpoint
                    else f"http://{endpoint}").rstrip("/")
        self.rates = promtext.CounterRates()
        self.offset_s: Optional[float] = None
        self.committed = False
        self.run_id: Optional[str] = None
        self.identity: Dict[str, Any] = {}
        self.error: Optional[str] = None
        self.loss_by_step: "collections.OrderedDict" = \
            collections.OrderedDict()
        self.digest_by_step: "collections.OrderedDict" = \
            collections.OrderedDict()

    def remember(self, table: "collections.OrderedDict",
                 step: Optional[float], value: Optional[float]) -> None:
        if step is None or value is None:
            return
        table[int(step)] = value
        while len(table) > _STEP_HISTORY:
            table.popitem(last=False)


class FleetCollector:
    """Pull-based cohort aggregator. Construct via `create()` (the
    shared disabled singleton when there are no members to scrape);
    `start()` sweeps on a daemon thread, `sample()` sweeps once
    synchronously (the fake-clock test path — and safe to call from
    other threads: sweeps serialize on one lock)."""

    def __init__(self, telemetry, *, members: Sequence[str] = (),
                 interval_s: float = 2.0, handshake_samples: int = 5,
                 history: int = 256,
                 history_path: Optional[str] = None,
                 alerts=None, divergence_rtol: float = 1e-4,
                 timeout_s: float = 3.0,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 fetch: Optional[Callable[[str], str]] = None,
                 log: Optional[Callable[[str], None]] = None):
        self.enabled = True
        self.telemetry = telemetry
        self.interval_s = interval_s
        self.handshake_samples = max(1, handshake_samples)
        self.divergence_rtol = divergence_rtol
        self.timeout_s = timeout_s
        self._clock = clock
        self._wall = wall
        self._fetch = fetch if fetch is not None else self._http_fetch
        self._log = log or (lambda _m: None)
        self._alerts = alerts
        self._lock = threading.RLock()
        self._members: List[_Member] = [_Member(e) for e in members]
        self.history: "collections.deque" = \
            collections.deque(maxlen=max(1, history))
        self._history_path = history_path
        self._history_file = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- construction ----
    @classmethod
    def create(cls, telemetry, *, members: Sequence[str] = (),
               **kw) -> "FleetCollector":
        """The wired-everywhere entry: disabled singleton unless there
        are members to scrape and a live registry to publish into."""
        if not members or telemetry is None or not telemetry.enabled:
            return _NULL_FLEET
        return cls(telemetry, members=members, **kw)

    @classmethod
    def disabled(cls) -> "FleetCollector":
        return _NULL_FLEET

    def attach(self, alerts=None) -> "FleetCollector":
        """Ride the HOSTING process's alert engine: each sweep ends
        with a `check_now()` so straggler/divergence transitions
        escalate in the same tick that observed them."""
        if alerts is not None and getattr(alerts, "enabled", False):
            self._alerts = alerts
        return self

    def set_members(self, endpoints: Sequence[str]) -> None:
        """Re-point the collector at a (re)launched cohort — the
        supervisor calls this per attempt, so an elastic resize
        shrinks the scrape set with the mesh. Existing state is kept
        for endpoints that stay (the run_id check re-handshakes the
        relaunched ones)."""
        with self._lock:
            old = {m.endpoint: m for m in self._members}
            self._members = [old.get(e, _Member(e)) for e in endpoints]

    # ---- transport ----
    def _http_fetch(self, url: str) -> str:
        with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
            return r.read().decode("utf-8")

    # ---- clock handshake ----
    def _handshake(self, member: _Member) -> None:
        """Estimate this member's wall-clock offset (median of K
        round-trip-corrected samples) and commit it back so the member
        persists the measurement into its run manifest."""
        samples = []
        last: Dict[str, Any] = {}
        for _ in range(self.handshake_samples):
            c0 = self._wall()
            last = json.loads(self._fetch(member.url + "/clock"))
            c1 = self._wall()
            samples.append(float(last["wall"]) - (c0 + c1) / 2.0)
        member.offset_s = statistics.median(samples)
        member.identity = dict(last.get("identity") or {})
        member.run_id = member.identity.get("run_id")
        commit = json.loads(self._fetch(
            f"{member.url}/clock?commit=1"
            f"&offset_s={member.offset_s:.9f}"
            f"&samples={len(samples)}"))
        member.committed = bool(commit.get("committed"))
        self._log(f"fleet: {member.endpoint} offset "
                  f"{member.offset_s * 1e3:+.3f} ms over "
                  f"{len(samples)} samples"
                  f"{' (committed to manifest)' if member.committed else ''}")

    # ---- one member, one sweep ----
    def _poll_member(self, member: _Member, t: float
                     ) -> Dict[str, Any]:
        try:
            vars_body = json.loads(self._fetch(member.url + "/vars"))
            identity = dict(vars_body.get("identity") or {})
            if member.run_id is None \
                    or identity.get("run_id") != member.run_id:
                if member.run_id is not None:
                    # relaunched process: its counters restarted from
                    # zero and its clock is a fresh measurement
                    member.rates.reset()
                self._handshake(member)
            metrics = promtext.parse_prometheus(
                self._fetch(member.url + "/metrics"))
            member.error = None
        except (urllib.error.URLError, OSError, ValueError,
                KeyError) as e:
            member.error = str(getattr(e, "reason", e))
            return {"endpoint": member.endpoint, "up": False,
                    "error": member.error}
        rate = member.rates.advance(t, metrics)
        ex_rate = rate("train_examples")
        max_ctx = promtext.scalar(metrics, "train_max_contexts")
        phases = {}
        for fam in metrics:
            if fam.startswith("train_phase_") and fam.endswith("_ms"):
                v = promtext.labeled(metrics, fam, quantile="0.5")
                if v is not None:
                    phases[fam[len("train_phase_"):-3]] = v
        row = {
            "endpoint": member.endpoint,
            "up": True,
            "run_id": member.run_id,
            "process_index": member.identity.get("process_index"),
            "clock_offset_s": member.offset_s,
            "clock_committed": member.committed,
            "steps": promtext.scalar(metrics, "train_steps"),
            "steps_s": rate("train_steps"),
            "ex_s": ex_rate,
            "pc_s": (ex_rate * max_ctx
                     if ex_rate is not None and max_ctx else None),
            "step_p50": promtext.labeled(metrics, "train_step_ms",
                                         quantile="0.5"),
            "infeed_p50": promtext.labeled(
                metrics, "train_infeed_wait_ms", quantile="0.5"),
            "loss": promtext.scalar(metrics, "train_loss"),
            "phases": phases,
            "restarted": list(member.rates.restarted),
        }
        member.remember(member.loss_by_step,
                        promtext.scalar(metrics, "train_loss_step"),
                        row["loss"])
        member.remember(member.digest_by_step,
                        promtext.scalar(metrics,
                                        "train_params_digest_step"),
                        promtext.scalar(metrics, "train_params_digest"))
        return row

    # ---- cohort derivations ----
    @staticmethod
    def _straggle(rows: List[Dict[str, Any]]) -> None:
        """Per-host skew vs cohort median, per attributable series;
        each host's straggler score is its worst ratio, labeled with
        the series that produced it (the per-phase entries are what
        attribute a slow host's cost to `allreduce_exposed` on
        everyone else)."""
        series: Dict[str, List[float]] = {}
        for r in rows:
            if r.get("step_p50") is not None:
                series.setdefault("step_ms", []).append(r["step_p50"])
            if r.get("infeed_p50") is not None:
                series.setdefault("infeed_wait_ms",
                                  []).append(r["infeed_p50"])
            for p, v in (r.get("phases") or {}).items():
                series.setdefault(f"phase_{p}", []).append(v)
        medians = {s: statistics.median(vals)
                   for s, vals in series.items()
                   if len(vals) >= 2 and statistics.median(vals) > 0}
        for r in rows:
            score, worst = None, None
            host_vals = {"step_ms": r.get("step_p50"),
                         "infeed_wait_ms": r.get("infeed_p50")}
            for p, v in (r.get("phases") or {}).items():
                host_vals[f"phase_{p}"] = v
            for s, med in medians.items():
                v = host_vals.get(s)
                if v is None:
                    continue
                ratio = v / med
                if score is None or ratio > score:
                    score, worst = ratio, s
            r["straggler_score"] = score
            r["straggler_series"] = worst

    def _diverge(self) -> Dict[str, Any]:
        """Cross-host disagreement at MATCHING steps, over the recent
        step-labeled history each member accumulated. Returns the
        worst relative spread seen per signal plus the 0/1 verdict."""
        out: Dict[str, Any] = {"divergence": 0}
        for key, attr in (("loss", "loss_by_step"),
                          ("params_digest", "digest_by_step")):
            tables = [getattr(m, attr) for m in self._members
                      if getattr(m, attr)]
            worst_rel, worst_step = 0.0, None
            if len(tables) >= 2:
                common = set(tables[0])
                for t in tables[1:]:
                    common &= set(t)
                for step in common:
                    vals = [t[step] for t in tables]
                    spread = max(vals) - min(vals)
                    scale = max(abs(statistics.median(vals)), 1e-12)
                    rel = spread / scale
                    if rel > worst_rel:
                        worst_rel, worst_step = rel, step
            out[f"{key}_divergence_rel"] = worst_rel
            out[f"{key}_divergence_step"] = worst_step
            if worst_rel > self.divergence_rtol:
                out["divergence"] = 1
        return out

    # ---- the sweep ----
    def sample(self) -> Dict[str, Any]:
        """One synchronous sweep: poll every member, derive cohort
        signals, publish `fleet/*` gauges, append history + JSONL,
        escalate through the attached alert engine. Returns the
        aggregate (what `/fleet` serves)."""
        with self._lock:
            t = self._clock()
            rows = [self._poll_member(m, t) for m in self._members]
            ok = [r for r in rows if r.get("up")]
            self._straggle(ok)

            def _sum(key: str) -> Optional[float]:
                vals = [r[key] for r in ok if r.get(key) is not None]
                return sum(vals) if vals else None

            scores = [(r["straggler_score"], r) for r in ok
                      if r.get("straggler_score") is not None]
            worst = max(scores, key=lambda s: s[0]) if scores else None
            p50s = [r["step_p50"] for r in ok
                    if r.get("step_p50") is not None]
            skew = (max(p50s) / statistics.median(p50s)
                    if len(p50s) >= 2 and statistics.median(p50s) > 0
                    else None)
            offsets = [r["clock_offset_s"] for r in ok
                       if r.get("clock_offset_s") is not None]
            div = self._diverge()
            cohort: Dict[str, Any] = {
                "hosts_up": len(ok),
                "hosts_total": len(rows),
                "ex_per_sec": _sum("ex_s"),
                "pc_per_sec": _sum("pc_s"),
                "steps_per_sec": _sum("steps_s"),
                "straggler_score": worst[0] if worst else None,
                "straggler_host": worst[1]["endpoint"] if worst
                else None,
                "straggler_series": worst[1]["straggler_series"]
                if worst else None,
                "step_p50_skew": skew,
                "clock_spread_s": (max(offsets) - min(offsets)
                                   if len(offsets) >= 2 else None),
                **div,
            }
            agg = {"ts": self._wall(), "cohort": cohort, "hosts": rows}
            self._publish(cohort)
            self.history.append(agg)
            self._persist(agg)
        alerts = self._alerts
        if alerts is not None and alerts.enabled:
            alerts.check_now()
        return agg

    def _publish(self, cohort: Dict[str, Any]) -> None:
        """Cohort signals -> the hosting registry (emit=False: gauge
        stores feeding /metrics and the alert rules, never JSONL —
        the aggregate history IS the durable record)."""
        tele = self.telemetry
        gauges = (("fleet/hosts_up", cohort["hosts_up"]),
                  ("fleet/hosts_total", cohort["hosts_total"]),
                  ("fleet/pc_per_sec", cohort["pc_per_sec"]),
                  ("fleet/ex_per_sec", cohort["ex_per_sec"]),
                  ("fleet/straggler_score", cohort["straggler_score"]),
                  ("fleet/step_p50_skew", cohort["step_p50_skew"]),
                  ("fleet/clock_spread_s", cohort["clock_spread_s"]),
                  ("fleet/divergence", cohort["divergence"]),
                  ("fleet/loss_divergence_rel",
                   cohort["loss_divergence_rel"]))
        for name, value in gauges:
            if value is not None:
                tele.gauge(name, float(value), emit=False)

    def _persist(self, agg: Dict[str, Any]) -> None:
        path = self._history_path
        if path is None and self.telemetry.run_dir:
            import os
            path = os.path.join(self.telemetry.run_dir, "fleet.jsonl")
        if path is None:
            return
        try:
            if self._history_file is None:
                self._history_file = open(path, "a", encoding="utf-8")
            self._history_file.write(
                json.dumps(agg, default=str) + "\n")
            self._history_file.flush()
        except OSError as e:
            # a full postmortem disk must not take the collector (or
            # the run it observes) down; the in-memory ring still holds
            self._log(f"fleet: history write failed: {e}")

    # ---- reads ----
    def aggregate(self) -> Dict[str, Any]:
        """The latest sweep's aggregate (what `/fleet` serves); {}
        before the first sweep."""
        with self._lock:
            return self.history[-1] if self.history else {}

    def brief(self) -> Dict[str, Any]:
        """The stall-dump attachment (training/supervisor wires this
        next to cohort_topology): the latest cohort block plus per-host
        one-liners — enough to answer "who was slow" from a dump."""
        agg = self.aggregate()
        if not agg:
            return {"sweeps": 0}
        return {"ts": agg["ts"], "cohort": agg["cohort"],
                "hosts": [{k: r.get(k) for k in
                           ("endpoint", "up", "error", "step_p50",
                            "straggler_score", "straggler_series")}
                          for r in agg["hosts"]],
                "sweeps": len(self.history)}

    def render_prometheus(self) -> str:
        """The `/fleet?format=prom` payload: cohort totals unlabeled,
        per-host series labeled by endpoint."""
        agg = self.aggregate()
        lines: List[str] = []
        cohort = agg.get("cohort") or {}
        for key in ("hosts_up", "hosts_total", "pc_per_sec",
                    "ex_per_sec", "straggler_score", "step_p50_skew",
                    "clock_spread_s", "divergence",
                    "loss_divergence_rel"):
            v = cohort.get(key)
            if v is not None:
                lines.append(f"# TYPE fleet_{key} gauge")
                lines.append(f"fleet_{key} {float(v)}")
        per_host = (("step_p50", "fleet_host_step_p50_ms"),
                    ("infeed_p50", "fleet_host_infeed_p50_ms"),
                    ("pc_s", "fleet_host_pc_per_sec"),
                    ("straggler_score", "fleet_host_straggler_score"),
                    ("clock_offset_s", "fleet_host_clock_offset_s"))
        for key, fam in per_host:
            rows = [(r["endpoint"], r[key])
                    for r in agg.get("hosts", ())
                    if r.get(key) is not None]
            if rows:
                lines.append(f"# TYPE {fam} gauge")
                for host, v in rows:
                    lines.append(f'{fam}{{host="{host}"}} {float(v)}')
        return "\n".join(lines) + "\n"

    # ---- lifecycle ----
    def start(self) -> "FleetCollector":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fleet-collector")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample()
            except Exception as e:  # noqa: BLE001 — the collector
                # observes the run; it must never take it down (the
                # error IS surfaced: logged, and the member rows carry
                # their own per-endpoint errors)
                self._log(f"fleet: sweep failed: {e!r}")
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=max(5.0, self.timeout_s * 2))
        f, self._history_file = self._history_file, None
        if f is not None:
            f.close()


class _NullFleetCollector(FleetCollector):
    """The fleet-plane-off path: shared no-op singleton — no thread,
    no per-step work, `enabled` gates every site with one check."""

    def __init__(self):
        self.enabled = False
        self.telemetry = None
        self.history = collections.deque(maxlen=1)

    def attach(self, alerts=None):
        return self

    def set_members(self, endpoints):
        pass

    def sample(self):
        return {}

    def aggregate(self):
        return {}

    def brief(self):
        return {}

    def render_prometheus(self):
        return "\n"

    def start(self):
        return self

    def stop(self) -> None:
        pass


_NULL_FLEET = _NullFleetCollector()

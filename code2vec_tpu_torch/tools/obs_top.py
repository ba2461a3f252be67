"""obs_top: a live terminal view over N `/metrics` endpoints, a copy of
tools/obs_top.py of the JAX package over the port's obs/promtext.py.

Polls each host's `--metrics_port` exposition endpoint (a trainer, a
`PredictionServer`, or the serving fleet's front end) on an interval and
renders ONE table: global throughput summed across hosts, per-host rows
keeping the skew visible (a straggler is a slow row, not a hidden
average).

  python3 -m code2vec_tpu_torch.tools.obs_top host1:9100 host2:9100
  python3 -m code2vec_tpu_torch.tools.obs_top localhost:9100 --once

Rates (steps/s, examples/s, requests/s) are differenced between
consecutive polls of each endpoint's cumulative counters; a counter that
went BACKWARD means the process restarted (a supervisor relaunch zeroes
its counters), so the row is annotated RESTARTED and rates clamp to the
new process's progress instead of rendering negative steps/s.
path-contexts/s = examples-rate x the `train_max_contexts` gauge the
train loop publishes. Health verdicts, firing alerts, stalled
components and stale gauges (age > --stale_s) come straight off the
same scrape; hosts running --phase_profile get a per-phase p50 column
set. Pure stdlib (urllib and the port's promtext, itself re-only).

`--fleet <url>` switches the source to the supervisor-side fleet
collector's `/fleet` aggregate: per-host rows plus the cohort signals
only the collector can compute (straggler score with phase attribution,
loss/params divergence, measured clock offsets).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

# ONE exposition parser and counter-reset discipline for every scrape
# consumer: the fleet collector imports the same module
from code2vec_tpu_torch.obs.promtext import (CounterRates, labeled,
                                             parse_prometheus, scalar)

__all__ = ["EndpointState", "labeled", "main", "parse_prometheus",
           "render", "render_fleet", "render_phases", "scalar",
           "scrape"]

# phase-column order: the JAX tool's (its obs/phases.py PHASE_ORDER
# plus the trailing fused_step timer); unknown phases append
# alphabetically
_PHASE_ORDER = ("infeed_wait", "embed_gather", "concat_dense",
                "forward_pool", "backward", "table_apply",
                "backward_apply", "allreduce", "allreduce_exposed",
                "fused_step")


def scrape(endpoint: str, timeout_s: float = 3.0) -> Dict:
    url = endpoint if "://" in endpoint else f"http://{endpoint}"
    with urllib.request.urlopen(f"{url.rstrip('/')}/metrics",
                                timeout=timeout_s) as resp:
        return parse_prometheus(resp.read().decode("utf-8"))


class EndpointState:
    """One endpoint's scrape history: the previous counter sample, so
    each poll yields rates."""

    def __init__(self, endpoint: str):
        self.endpoint = endpoint
        # the shared counter-reset discipline (obs/promtext): a counter
        # going BACKWARD annotates the row RESTARTED and rates clamp to
        # the new process's progress instead of negative steps/s
        self.rates = CounterRates()
        self.error: Optional[str] = None

    def poll(self, stale_s: float) -> Optional[Dict[str, Any]]:
        """Scrape once; returns a row dict (None until two samples
        exist for the rate fields — other fields fill in on the first
        poll)."""
        t = time.monotonic()
        try:
            metrics = scrape(self.endpoint)
            self.error = None
        except (urllib.error.URLError, OSError, ValueError) as e:
            self.error = str(getattr(e, "reason", e))
            return {"endpoint": self.endpoint, "error": self.error}
        rate = self.rates.advance(t, metrics)
        ex_rate = rate("train_examples")
        max_ctx = scalar(metrics, "train_max_contexts")
        stalled = [labels.get("component", "?")
                   for labels, v in metrics.get("component_stalled", ())
                   if v]
        firing = [labels.get("rule", "?")
                  for labels, v in metrics.get("alert_active", ())
                  if v]
        unhealthy = [labels.get("monitor", "?")
                     for labels, v in metrics.get("health_status", ())
                     if v]
        stale = [labels.get("gauge", "?")
                 for labels, v in metrics.get("gauge_age_seconds", ())
                 if v > stale_s]
        # sampled per-phase p50s (--phase_profile): one
        # column per train_phase_<name>_ms summary the host exports
        phases = {}
        for fam in metrics:
            if fam.startswith("train_phase_") and fam.endswith("_ms"):
                v = labeled(metrics, fam, quantile="0.5")
                if v is not None:
                    phases[fam[len("train_phase_"):-3]] = v
        return {
            "endpoint": self.endpoint,
            "steps": scalar(metrics, "train_steps"),
            "steps_s": rate("train_steps"),
            "ex_s": ex_rate,
            "pc_s": (ex_rate * max_ctx
                     if ex_rate is not None and max_ctx else None),
            "step_p50": labeled(metrics, "train_step_ms",
                                quantile="0.5"),
            # analytic-floor attainment (health/opt_efficiency: the
            # sparse path's static [U, E]-aware floor over observed
            # p50 step time) — an optimizer-efficiency regression is
            # a dropping number here, mid-run
            "opt_eff": scalar(metrics, "health_opt_efficiency"),
            "infeed_p95": labeled(metrics, "train_infeed_wait_ms",
                                  quantile="0.95"),
            "req_s": rate("serve_requests"),
            "queue_depth": scalar(metrics, "serve_queue_depth"),
            "loss": scalar(metrics, "train_loss"),
            "stalled": stalled,
            "alerts": firing,
            "unhealthy": unhealthy,
            "stale_gauges": stale,
            "restarted": self.rates.restarted,
            "phases": phases,
            "phase_coverage": scalar(metrics, "health_phase_coverage"),
        }


def _f(v, nd: int = 1) -> str:
    if v is None:
        return "—"
    if isinstance(v, float) and v != v:
        return "NaN"
    return f"{v:,.{nd}f}"


def render(rows: List[Dict[str, Any]]) -> str:
    """One frame: the summed headline + per-host skew rows (the
    telemetry_report --merge table shape, live)."""
    lines: List[str] = []
    ok_rows = [r for r in rows if "error" not in r]
    total_pc = sum(r["pc_s"] for r in ok_rows
                   if r.get("pc_s") is not None) or None
    total_req = sum(r["req_s"] for r in ok_rows
                    if r.get("req_s") is not None) or None
    n_bad = sum(bool(r.get("stalled") or r.get("alerts"))
                for r in ok_rows)
    lines.append(
        f"obs_top — {len(ok_rows)}/{len(rows)} hosts up | "
        f"pc/s (sum) {_f(total_pc)} | req/s (sum) {_f(total_req)} | "
        f"{n_bad} host(s) unhealthy | "
        f"{time.strftime('%H:%M:%S')}")
    lines.append(
        "| Host | steps | ex/s | pc/s | step p50 ms | opt eff "
        "| infeed p95 ms | req/s | q | loss | status |")
    lines.append("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        if "error" in r:
            lines.append(f"| {r['endpoint']} | DOWN: {r['error']} "
                         "| | | | | | | | | |")
            continue
        bits = []
        if r["stalled"]:
            bits.append("STALLED:" + ",".join(r["stalled"]))
        if r.get("restarted"):
            # counter reset this window (supervisor restart / elastic
            # resize): rates shown are the NEW process's, not deltas
            bits.append("RESTARTED")
        if r["alerts"]:
            bits.append("ALERT:" + ",".join(r["alerts"]))
        if r["unhealthy"]:
            bits.append("bad:" + ",".join(r["unhealthy"]))
        if r["stale_gauges"]:
            bits.append(f"{len(r['stale_gauges'])} stale gauge(s)")
        lines.append(
            f"| {r['endpoint']} | {_f(r['steps'], 0)} "
            f"| {_f(r['ex_s'])} | {_f(r['pc_s'])} "
            f"| {_f(r['step_p50'], 2)} | {_f(r.get('opt_eff'), 3)} "
            f"| {_f(r['infeed_p95'], 2)} "
            f"| {_f(r['req_s'])} | {_f(r['queue_depth'], 0)} "
            f"| {_f(r['loss'], 4)} "
            f"| {' '.join(bits) if bits else 'ok'} |")
    phase_lines = render_phases(rows)
    if phase_lines:
        lines.append("")
        lines.extend(phase_lines)
    return "\n".join(lines)


def render_phases(rows: List[Dict[str, Any]]) -> List[str]:
    """The per-phase column set (--phase_profile hosts): p50 device ms
    per sampled phase, one row per host, columns in canonical phase
    order: "where did the millisecond go", live.
    Empty when no host exports train_phase_* summaries."""
    with_phases = [r for r in rows if r.get("phases")]
    if not with_phases:
        return []
    seen = {p for r in with_phases for p in r["phases"]}
    cols = [p for p in _PHASE_ORDER if p in seen]
    cols += sorted(seen - set(cols))
    lines = ["| Host (phase p50 ms) | " + " | ".join(cols)
             + " | coverage |",
             "|---" * (len(cols) + 2) + "|"]
    for r in with_phases:
        vals = " | ".join(_f(r["phases"].get(c), 3) for c in cols)
        lines.append(f"| {r['endpoint']} | {vals} "
                     f"| {_f(r.get('phase_coverage'), 2)} |")
    return lines


def fetch_fleet(url: str, timeout_s: float = 3.0) -> Dict[str, Any]:
    """One `/fleet` aggregate off the supervisor-side collector."""
    base = url if "://" in url else f"http://{url}"
    base = base.rstrip("/")
    if not base.endswith("/fleet"):
        base += "/fleet"
    with urllib.request.urlopen(base, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8"))


def render_fleet(agg: Dict[str, Any]) -> str:
    """One frame off the fleet aggregate: cohort headline (summed
    throughput, straggler verdict with its attributed series,
    divergence), then per-host rows with measured clock offsets —
    the collector already did the differencing and the cross-host
    math, so this renders, it does not derive."""
    cohort = agg.get("cohort") or {}
    hosts = agg.get("hosts") or []
    lines: List[str] = []
    strag = cohort.get("straggler_score")
    strag_bit = "—"
    if strag is not None:
        strag_bit = f"{strag:.2f}x"
        if cohort.get("straggler_host"):
            strag_bit += (f" ({cohort['straggler_host']} via "
                          f"{cohort.get('straggler_series')})")
    div = "DIVERGED" if cohort.get("divergence") else "converged"
    lines.append(
        f"obs_top --fleet — {cohort.get('hosts_up', 0)}"
        f"/{cohort.get('hosts_total', 0)} hosts up | "
        f"pc/s (sum) {_f(cohort.get('pc_per_sec'))} | "
        f"straggler {strag_bit} | {div} | "
        f"clock spread {_f((cohort.get('clock_spread_s') or 0) * 1e3, 3)} ms | "
        f"{time.strftime('%H:%M:%S')}")
    lines.append("| Host | steps | ex/s | pc/s | step p50 ms "
                 "| infeed p50 ms | loss | straggler | clock off ms "
                 "| status |")
    lines.append("|---" * 10 + "|")
    for r in hosts:
        if not r.get("up"):
            lines.append(f"| {r['endpoint']} | DOWN: "
                         f"{r.get('error')} | | | | | | | | |")
            continue
        bits = []
        if r.get("restarted"):
            bits.append("RESTARTED")
        score = r.get("straggler_score")
        score_bit = "—"
        if score is not None:
            score_bit = f"{score:.2f}x {r.get('straggler_series')}"
        off = r.get("clock_offset_s")
        lines.append(
            f"| {r['endpoint']} | {_f(r.get('steps'), 0)} "
            f"| {_f(r.get('ex_s'))} | {_f(r.get('pc_s'))} "
            f"| {_f(r.get('step_p50'), 2)} "
            f"| {_f(r.get('infeed_p50'), 2)} "
            f"| {_f(r.get('loss'), 4)} | {score_bit} "
            f"| {_f(off * 1e3 if off is not None else None, 3)} "
            f"| {' '.join(bits) if bits else 'ok'} |")
    phase_lines = render_phases(hosts)
    if phase_lines:
        lines.append("")
        lines.extend(phase_lines)
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m code2vec_tpu_torch.tools.obs_top",
        description="live multi-host view over /metrics endpoints")
    ap.add_argument("endpoints", nargs="*",
                    help="host:port (or full URL) of each "
                         "--metrics_port exposition server")
    ap.add_argument("--fleet", default=None, metavar="URL",
                    help="poll the supervisor-side fleet collector's "
                         "/fleet aggregate instead of raw endpoints")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="poll interval in seconds")
    ap.add_argument("--once", action="store_true",
                    help="two quick polls (rates need a delta), one "
                         "printed frame, exit — the scripting mode")
    ap.add_argument("--count", type=int, default=0,
                    help="stop after N frames (0 = run until ^C)")
    ap.add_argument("--stale_s", type=float, default=60.0,
                    help="mark gauges older than this as stale")
    args = ap.parse_args(argv)
    if args.fleet is None and not args.endpoints:
        ap.error("give /metrics endpoints, or --fleet <url>")

    if args.fleet is not None:
        # aggregate mode: the collector differenced and derived; poll
        # and render its latest sweep (no warm-up frame needed)
        n = 0
        try:
            while True:
                try:
                    out = render_fleet(fetch_fleet(args.fleet))
                except (urllib.error.URLError, OSError,
                        ValueError) as e:
                    out = (f"obs_top --fleet — {args.fleet} DOWN: "
                           f"{getattr(e, 'reason', e)}")
                if not args.once and n:
                    sys.stdout.write("\x1b[2J\x1b[H")
                print(out)
                n += 1
                if args.once or (args.count and n >= args.count):
                    return 0
                time.sleep(max(args.interval, 0.05))
        except KeyboardInterrupt:
            return 0

    states = [EndpointState(e) for e in args.endpoints]

    def frame() -> List[Dict[str, Any]]:
        return [s.poll(args.stale_s) for s in states]

    if args.once:
        frame()  # prime the counter baselines
        time.sleep(max(args.interval, 0.05))
        print(render(frame()))
        return 0
    n = 0
    try:
        while True:
            rows = frame()
            if n:  # first frame has no rates yet; start painting at 2
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
                print(render(rows))
            n += 1
            if args.count and n > args.count:
                return 0
            time.sleep(max(args.interval, 0.05))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Render a traced telemetry run of the port (`--trace`,
code2vec_tpu_torch/obs/trace.py) as Chrome trace-event JSON and
critical-path breakdowns.

A copy of the JAX package's tools/trace_report.py for the run record the
port writes (the same span events), over the port's copy of
telemetry_report.py for run discovery; it imports nothing of the JAX
package or of the repository's root tools.

Usage:
  python3 -m code2vec_tpu_torch.tools.trace_report \
      <telemetry_dir | run_dir> [run_dir...] [--chrome trace.json]
      [--limit N]
  python3 -m code2vec_tpu_torch.tools.trace_report --merge <run_dir>... \
      --chrome out.json
      # one Chrome/Perfetto trace for a multi-process cohort
      # (per-run process_name/pid metadata; aligned on the fleet
      # handshake's MEASURED clock offsets when every manifest has a
      # `clock` block, else the created_unix fallback + clock_note
      # caveat) — telemetry_report.py --merge applied to traces

Reads the run's `events.jsonl` (the `kind="span"` records the tracer
emits) and produces:

  - `--chrome <out.json>`: Chrome trace-event format, viewable in
    Perfetto (ui.perfetto.dev) or chrome://tracing. One row per real
    thread (named) plus virtual tracks (e.g. the serving queue); spans
    are complete ("X") events carrying their trace/span ids in args;
    cross-trace links (a batcher flush serving several requests, a
    step consuming a producer-thread infeed batch) become flow events
    ("s"/"f" pairs) so a request can be followed THROUGH the flush
    that served it.
  - per-request critical-path table: one row per `serve/request` trace
    with queue_wait / parse / encode / device / decode ms (encode and
    device come from the batch flush that served the request — by
    trace id for the flush's primary request, by link for coalesced
    ones) plus aggregate p50/p95/p99 per phase.
  - per-step table: infeed_wait / step / save_blocked (+ the writer's
    save_write wall) from the `train/step_cycle` traces.

Pure stdlib; reads only manifest + events files, so it works on a
machine without torch over a copied run dir.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from code2vec_tpu_torch.tools.telemetry_report import find_runs, load_run

PCTS = (50, 95, 99)

# phase order of the serving critical path (the table's columns)
REQUEST_PHASES = ("queue_wait", "parse", "encode", "device", "decode")
_REQ_SPAN = {"serve/queue_wait": "queue_wait", "serve/parse": "parse",
             "serve/encode": "encode", "serve/device": "device",
             "serve/decode": "decode", "serve/extract": "extract"}
STEP_PHASES = ("infeed_wait", "step")


def load_spans(run_dirs: Sequence[str]
               ) -> List[Tuple[Dict[str, Any], List[Dict[str, Any]]]]:
    """[(manifest, span_events)] per run, span events only."""
    out = []
    for d in run_dirs:
        manifest, events = load_run(d)
        out.append((manifest,
                    [e for e in events if e.get("kind") == "span"]))
    return out


# ---------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------

def chrome_trace_events(loaded: Sequence[Tuple[Dict[str, Any],
                                               List[Dict[str, Any]]]],
                        merge: bool = False) -> List[Dict[str, Any]]:
    """Spans -> Chrome trace events. ts/dur are microseconds relative
    to the earliest span across all runs (the tracer's monotonic `t0`
    is only meaningful within a process; cross-run alignment uses each
    run's own base — good enough for same-process run sets, which is
    what a traced run directory holds).

    `merge` (`--merge <run_dir>...`, the telemetry_report
    --merge shape applied to traces) renders a multi-PROCESS cohort as
    ONE trace: each run keeps its manifest process_index as the Chrome
    pid (collisions fall back to a fresh id), gets a `process_name`
    metadata row (run_id + component), and its timeline is offset onto
    a shared wall clock.

    Alignment comes in two qualities. When EVERY run's manifest
    carries the `clock` block the fleet handshake commits (the
    paired monotonic+wall readings plus the collector-MEASURED
    wall-clock offset, obs/fleet.py), span timelines convert from the
    tracer's monotonic timebase to the collector's wall clock exactly:
    `t0 - clock.mono` re-bases the span onto the paired reading, `+
    clock.wall - clock.wall_offset_s` lands it on the collector's
    clock — cross-process gaps are then real to handshake precision
    (sub-ms on a LAN) and the old caveat is retired. Without measured
    clocks the pre-17 fallback applies: offset by the manifests'
    `created_unix`, only as good as host wall sync + manifest-to-
    first-span latency, and each process carries a `clock_note`
    instant event saying exactly that, so nobody reads a 2 ms
    cross-host gap as truth."""
    events: List[Dict[str, Any]] = []
    flow_id = 0
    used_pids: Dict[int, int] = {}
    # measured path: every run with spans must carry a handshake clock
    # block — a half-measured cohort would interleave exact and sloppy
    # timelines as if they were comparable
    clocks = [m.get("clock") for m, s in loaded if s]
    measured = bool(clocks) and all(
        isinstance(c, dict)
        and all(k in c for k in ("mono", "wall", "wall_offset_s"))
        for c in clocks)
    if merge and measured:
        corrected = []
        for manifest, spans in loaded:
            if not spans:
                continue
            c = manifest["clock"]
            base = min(float(s["t0"]) for s in spans)
            corrected.append(base - float(c["mono"]) + float(c["wall"])
                             - float(c["wall_offset_s"]))
        wall0 = min(corrected, default=None)
    else:
        wall = [m.get("created_unix") for m, s in loaded if s]
        wall0 = min((w for w in wall if w is not None), default=None)
    for run_idx, (manifest, spans) in enumerate(loaded):
        if not spans:
            continue
        pid = int(manifest.get("process_index", run_idx))
        base = min(float(s["t0"]) for s in spans)
        offset_us = 0.0
        if merge and measured and wall0 is not None:
            c = manifest["clock"]
            offset_us = (base - float(c["mono"]) + float(c["wall"])
                         - float(c["wall_offset_s"]) - wall0) * 1e6
        elif merge and wall0 is not None \
                and manifest.get("created_unix") is not None:
            offset_us = (float(manifest["created_unix"]) - wall0) * 1e6
        if merge:
            while pid in used_pids:  # two runs claiming one index
                pid += 1000
            used_pids[pid] = run_idx
            name_args: Dict[str, Any] = {
                "name": f"p{manifest.get('process_index', '?')}"
                        f" {manifest.get('run_id', '?')}"
                        f" ({manifest.get('component', '?')})"}
            if measured:
                name_args["clock_offset_s"] = float(
                    manifest["clock"]["wall_offset_s"])
            events.append({"name": "process_name", "ph": "M",
                           "pid": pid, "args": name_args})
        if merge and not measured:
            events.append({
                "name": "clock_note", "cat": "meta", "ph": "I",
                "s": "p", "pid": pid, "tid": 0,
                "ts": round(offset_us, 3),
                "args": {"note": "timeline offset from manifest "
                                 "created_unix (monotonic clocks are "
                                 "per-process): cross-process skew = "
                                 "host wall-clock sync + manifest-to-"
                                 "first-span latency; run under the "
                                 "fleet plane (obs/fleet.py) to commit "
                                 "MEASURED offsets instead"}})
        by_id: Dict[str, Dict[str, Any]] = {s["span"]: s for s in spans}
        seen_threads: Dict[int, str] = {}
        for s in spans:
            tid = int(s.get("tid", 0))
            tname = str(s.get("tname", ""))
            if tid not in seen_threads:
                seen_threads[tid] = tname
                events.append({"name": "thread_name", "ph": "M",
                               "pid": pid, "tid": tid,
                               "args": {"name": tname}})
            ts = (float(s["t0"]) - base) * 1e6 + offset_us
            dur = max(float(s.get("dur_ms", 0.0)) * 1e3, 1.0)
            args = {"trace": s.get("trace"), "span": s.get("span")}
            if s.get("parent"):
                args["parent"] = s["parent"]
            args.update(s.get("attrs") or {})
            events.append({"name": s["name"], "cat": "span", "ph": "X",
                           "pid": pid, "tid": tid,
                           "ts": round(ts, 3), "dur": round(dur, 3),
                           "args": args})
            # cross-trace links -> flow events (s on the SOURCE span's
            # row, f at this span's start): the request -> flush edges
            for link in s.get("links") or ():
                src = by_id.get(link[1])
                if src is None:
                    continue
                flow_id += 1
                src_ts = (float(src["t0"]) - base) * 1e6 + offset_us
                src_dur = max(float(src.get("dur_ms", 0.0)) * 1e3, 1.0)
                # bind inside the source slice: at the flow target's
                # start when that falls within it, else at the edge
                bind = min(max(ts, src_ts), src_ts + src_dur)
                events.append({"name": "handoff", "cat": "flow",
                               "ph": "s", "id": flow_id, "pid": pid,
                               "tid": int(src.get("tid", 0)),
                               "ts": round(bind, 3)})
                events.append({"name": "handoff", "cat": "flow",
                               "ph": "f", "bp": "e", "id": flow_id,
                               "pid": pid, "tid": tid,
                               "ts": round(ts, 3)})
    return events


def write_chrome_trace(run_dirs: Sequence[str], out_path: str,
                       merge: bool = False) -> int:
    """Write the Chrome trace JSON for the given run dirs; returns the
    number of trace events written. `merge` = one cohort trace (see
    chrome_trace_events)."""
    events = chrome_trace_events(load_spans(run_dirs), merge=merge)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return len(events)


# ---------------------------------------------------------------------
# critical-path breakdowns
# ---------------------------------------------------------------------

def request_breakdowns(spans: Sequence[Dict[str, Any]]
                       ) -> List[Dict[str, Any]]:
    """One row per `serve/request` trace: total plus per-phase ms.

    The flush's encode/device spans live in the flush's OWN trace (the
    first coalesced request's); other requests reach them through the
    flush's links. Both paths attribute the same flush to the request,
    so coalesced requests each see the shared device cost — a critical
    -path view (what this request waited on), not a cost accounting."""
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for s in spans:
        by_trace.setdefault(s["trace"], []).append(s)
    # flush span -> its child phase durations
    flush_children: Dict[str, Dict[str, float]] = {}
    flushes: List[Dict[str, Any]] = []
    for s in spans:
        if s["name"] == "serve/batch_flush":
            flushes.append(s)
            flush_children[s["span"]] = {}
    for s in spans:
        parent = s.get("parent")
        phase = _REQ_SPAN.get(s["name"])
        if parent in flush_children and phase:
            d = flush_children[parent]
            d[phase] = d.get(phase, 0.0) + float(s["dur_ms"])
    # request root span id -> flushes that served it (via trace OR link)
    serving_flush: Dict[str, List[Dict[str, Any]]] = {}
    for f in flushes:
        serving_flush.setdefault(f["trace"], []).append(f)
    linked_flush: Dict[str, List[Dict[str, Any]]] = {}
    for f in flushes:
        for link in f.get("links") or ():
            linked_flush.setdefault(link[0], []).append(f)
    rows = []
    for trace_id, group in sorted(by_trace.items()):
        root = next((s for s in group
                     if s["name"] == "serve/request"), None)
        if root is None:
            continue
        row: Dict[str, Any] = {"trace": trace_id,
                               "total_ms": float(root["dur_ms"]),
                               "n_methods": (root.get("attrs") or {}
                                             ).get("n_methods")}
        for s in group:
            phase = _REQ_SPAN.get(s["name"])
            # flush children (encode/device) share the PRIMARY
            # request's trace — they're attributed via flush_children
            # below, so counting them here would double the primary's
            # figures vs its coalesced siblings'
            if phase and s.get("parent") not in flush_children:
                row[phase] = row.get(phase, 0.0) + float(s["dur_ms"])
        for f in (serving_flush.get(trace_id, ())
                  or linked_flush.get(trace_id, ())):
            for phase, ms in flush_children.get(f["span"], {}).items():
                row[phase] = row.get(phase, 0.0) + ms
        rows.append(row)
    return rows


def step_breakdowns(spans: Sequence[Dict[str, Any]]
                    ) -> List[Dict[str, Any]]:
    """One row per `train/step_cycle` trace: infeed_wait / step ms (+
    step number); `train/save_blocked` and the writer's
    `train/save_write` report as their own rows keyed by step."""
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for s in spans:
        by_trace.setdefault(s["trace"], []).append(s)
    rows = []
    for trace_id, group in sorted(by_trace.items()):
        root = next((s for s in group
                     if s["name"] == "train/step_cycle"), None)
        if root is None:
            continue
        row = {"trace": trace_id,
               "step": (root.get("attrs") or {}).get("step"),
               "total_ms": float(root["dur_ms"])}
        for s in group:
            if s["name"] == "train/infeed_wait":
                row["infeed_wait"] = float(s["dur_ms"])
            elif s["name"] == "train/step":
                row["step_ms"] = float(s["dur_ms"])
        rows.append(row)
    return rows


def save_breakdowns(spans: Sequence[Dict[str, Any]]
                    ) -> List[Dict[str, Any]]:
    rows = []
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for s in spans:
        by_trace.setdefault(s["trace"], []).append(s)
    for trace_id, group in sorted(by_trace.items()):
        root = next((s for s in group
                     if s["name"] == "train/save_blocked"), None)
        if root is None:
            continue
        write = next((s for s in group
                      if s["name"] == "train/save_write"), None)
        rows.append({
            "step": (root.get("attrs") or {}).get("step"),
            "save_blocked_ms": float(root["dur_ms"]),
            "save_write_ms": (float(write["dur_ms"])
                              if write is not None else None),
        })
    return rows


# ---------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------

def _pct(values: List[float], p: float) -> float:
    if not values:
        return float("nan")
    s = sorted(values)
    k = int(round(p / 100.0 * (len(s) - 1)))
    return s[max(0, min(len(s) - 1, k))]


def _fmt(v, nd: int = 2) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        if v != v:
            return "—"
        return f"{v:,.{nd}f}"
    return str(v)


def render(loaded, limit: int = 10) -> str:
    lines: List[str] = []
    for manifest, spans in loaded:
        rid = manifest.get("run_id", "?")
        lines.append(f"## run {rid} "
                     f"({manifest.get('component', '?')}, "
                     f"{len(spans)} spans)")
        req_rows = request_breakdowns(spans)
        if req_rows:
            lines.append("")
            lines.append("| Request (trace) | methods | "
                         + " | ".join(REQUEST_PHASES)
                         + " | total ms |")
            lines.append("|---" * (len(REQUEST_PHASES) + 3) + "|")
            for r in req_rows[:limit]:
                lines.append(
                    f"| {r['trace']} | {_fmt(r.get('n_methods'))} | "
                    + " | ".join(_fmt(r.get(p)) for p in REQUEST_PHASES)
                    + f" | {_fmt(r['total_ms'])} |")
            if len(req_rows) > limit:
                lines.append(f"| … {len(req_rows) - limit} more "
                             f"requests elided (--limit) |"
                             + " |" * (len(REQUEST_PHASES) + 2))
            lines.append("")
            lines.append("| Phase (all requests) | p50 ms | p95 ms "
                         "| p99 ms |")
            lines.append("|---|---|---|---|")
            for phase in REQUEST_PHASES + ("total_ms",):
                vals = [r[phase] for r in req_rows if phase in r]
                if not vals:
                    continue
                lines.append(f"| {phase} | "
                             + " | ".join(_fmt(_pct(vals, p))
                                          for p in PCTS) + " |")
        step_rows = step_breakdowns(spans)
        if step_rows:
            lines.append("")
            lines.append("| Step phase | n | p50 ms | p95 ms "
                         "| p99 ms |")
            lines.append("|---|---|---|---|---|")
            for key in ("infeed_wait", "step_ms", "total_ms"):
                vals = [r[key] for r in step_rows if key in r]
                if vals:
                    lines.append(f"| {key} | {len(vals)} | "
                                 + " | ".join(_fmt(_pct(vals, p))
                                              for p in PCTS) + " |")
        save_rows = save_breakdowns(spans)
        if save_rows:
            lines.append("")
            lines.append("| Save (step) | blocked ms | writer ms |")
            lines.append("|---|---|---|")
            for r in save_rows:
                lines.append(f"| {_fmt(r['step'])} "
                             f"| {_fmt(r['save_blocked_ms'])} "
                             f"| {_fmt(r['save_write_ms'])} |")
        if not (req_rows or step_rows or save_rows):
            lines.append("")
            lines.append("(no request or step traces — was the run "
                         "started with --trace?)")
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="render traced telemetry runs (Chrome trace JSON "
                    "+ critical-path breakdowns)")
    ap.add_argument("paths", nargs="+",
                    help="telemetry root dir(s) or run dir(s)")
    ap.add_argument("--chrome", default=None,
                    help="also write Chrome trace-event JSON here "
                         "(Perfetto / chrome://tracing)")
    ap.add_argument("--merge", action="store_true",
                    help="treat the given run dirs as ONE multi-"
                         "process cohort and write a single Chrome "
                         "trace: per-run process_name/pid metadata, "
                         "timelines aligned on the fleet handshake's "
                         "measured clock offsets when every manifest "
                         "carries one (obs/fleet.py), else on "
                         "created_unix with a clock_note caveat "
                         "event. Requires --chrome.")
    ap.add_argument("--limit", type=int, default=10,
                    help="per-request rows to print before eliding")
    args = ap.parse_args(argv)
    if args.merge and not args.chrome:
        print("error: --merge produces a merged Chrome trace; pass "
              "--chrome <out.json>", file=sys.stderr)
        return 2
    run_dirs: List[str] = []
    for p in args.paths:
        found = find_runs(p)
        if not found:
            print(f"error: no telemetry runs under {p}",
                  file=sys.stderr)
            return 2
        run_dirs.extend(found)
    loaded = load_spans(run_dirs)
    if args.chrome:
        n = write_chrome_trace(run_dirs, args.chrome,
                               merge=args.merge)
        print(f"chrome trace: {n} events -> {args.chrome}"
              + (f" (merged cohort of {len(run_dirs)} runs)"
                 if args.merge else ""))
    sys.stdout.write(render(loaded, limit=args.limit))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Summarize the port's telemetry runs (code2vec_tpu_torch/obs JSONL:
`--telemetry_dir`, the loadgen's runs) into tables.

A copy of the JAX package's tools/telemetry_report.py for the run
record the port writes (the same manifest and event format), importing
nothing of the JAX package or of the repository's root tools.

Usage:
  python3 -m code2vec_tpu_torch.tools.telemetry_report \
      <telemetry_dir | run_dir> [run_dir...] [--merge]

Given `--telemetry_dir`'s root (or one run directory), prints

  - one headline table — a row per run with step events: config label,
    ms/step (p50), pc/s/chip (examples/sec x MAX_CONTEXTS over the
    instrumented wall: step + infeed wait), infeed-wait p95, and the
    run_id as the Source column. The JAX tool's "vs V100" column (its
    path-contexts/s over bench.py's V100 figure) is dropped here, and so
    is the ratio in its `bench` line: that figure is another card's,
    never the H100's;
  - per-run detail tables: every timer histogram (count / mean /
    p50 / p95 / p99 / max), a phase-attribution table when the run
    sampled phases (--phase_profile: per-phase device ms joined with
    the analytic bytes gauges into GB/s and vs-ceiling utilization),
    serving request percentiles, final loss, gauges, an epoch-boundary
    table (save_blocked_ms / save_total_ms / eval_ms / save overlap
    ratio, from the save / save_committed / eval events), and any
    bench/profile events the run carried.

`--merge` treats per-process run dirs (a `--dist_*` cohort's, one run a
rank) as one run: pc/s summed, step percentiles pooled, a row a
process below.

Pure stdlib; reads only the manifest + events files, so it works on a
machine without torch over a copied run dir.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

PCTS = (50, 95, 99)


def find_runs(path: str) -> List[str]:
    """`path` is one run dir (has manifest.json) or a telemetry root
    (run dirs one level down), newest first."""
    if os.path.exists(os.path.join(path, "manifest.json")):
        return [path]
    runs = [os.path.join(path, d)
            for d in sorted(os.listdir(path), reverse=True)
            if os.path.exists(os.path.join(path, d, "manifest.json"))]
    return runs


def load_run(run_dir: str):
    with open(os.path.join(run_dir, "manifest.json"),
              encoding="utf-8") as f:
        manifest = json.load(f)
    events: List[Dict[str, Any]] = []
    ev_path = os.path.join(run_dir, "events.jsonl")
    if os.path.exists(ev_path):
        with open(ev_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    events.append(json.loads(line))
    return manifest, events


def _pct(values: List[float], p: float) -> float:
    if not values:
        return float("nan")
    s = sorted(values)
    k = int(round(p / 100.0 * (len(s) - 1)))
    return s[max(0, min(len(s) - 1, k))]


def _config_label(manifest: Dict[str, Any]) -> str:
    cfg = manifest.get("config") or {}
    bits = [manifest.get("component", "run")]
    if cfg:
        bits.append(cfg.get("ENCODER_TYPE", "?"))
        bits.append(str(cfg.get("TABLES_DTYPE", "?")))
        bits.append(f"B={cfg.get('TRAIN_BATCH_SIZE', '?')}")
        bits.append(f"C={cfg.get('MAX_CONTEXTS', '?')}")
    mesh = manifest.get("mesh")
    if mesh:
        bits.append("mesh=" + "x".join(str(v) for v in mesh.values()))
    return " ".join(bits)


def summarize_steps(manifest: Dict[str, Any],
                    events: List[Dict[str, Any]]
                    ) -> Optional[Dict[str, Any]]:
    steps = [e for e in events if e.get("kind") == "step"]
    if not steps:
        return None
    step_ms = [float(e["step_ms"]) for e in steps if "step_ms" in e]
    wait_ms = [float(e.get("infeed_wait_ms", 0.0)) for e in steps]
    examples = sum(int(e.get("examples", 0)) for e in steps)
    total_s = (sum(step_ms) + sum(wait_ms)) / 1e3
    cfg = manifest.get("config") or {}
    max_contexts = int(cfg.get("MAX_CONTEXTS", 0) or 0)
    ex_s = examples / total_s if total_s > 0 else float("nan")
    pc_s = ex_s * max_contexts if max_contexts else float("nan")
    return {
        "n_steps": len(steps),
        "ms_per_step_p50": _pct(step_ms, 50),
        "step_ms": step_ms,
        "infeed_wait_ms": wait_ms,
        "examples": examples,
        "ex_per_sec": ex_s,
        "pc_per_sec": pc_s,
        "final_loss": next((e.get("loss") for e in reversed(steps)
                            if "loss" in e), None),
    }


def _timer_rows(events: List[Dict[str, Any]]) -> Dict[str, Dict]:
    """Timer summaries: the close()-time `summary` event when present
    (it has every registry timer), else recomputed from raw events."""
    for e in reversed(events):
        if e.get("kind") == "summary" and e.get("timers"):
            return dict(e["timers"])
    # fallback: rebuild from per-event samples
    samples: Dict[str, List[float]] = {}
    for e in events:
        if e.get("kind") == "step":
            samples.setdefault("train/step_ms", []).append(
                float(e.get("step_ms", 0.0)))
            samples.setdefault("train/infeed_wait_ms", []).append(
                float(e.get("infeed_wait_ms", 0.0)))
        elif e.get("kind") == "request":
            samples.setdefault("serve/request_ms", []).append(
                float(e.get("request_ms", 0.0)))
        elif e.get("kind") == "profile" and "ms" in e:
            samples.setdefault(f"profile/{e.get('phase')}_ms",
                               []).append(float(e["ms"]))
    out = {}
    for name, vals in sorted(samples.items()):
        row = {"count": len(vals),
               "mean_ms": sum(vals) / len(vals),
               "max_ms": max(vals)}
        for p in PCTS:
            row[f"p{p}_ms"] = _pct(vals, p)
        out[name] = row
    return out


# canonical phase order: obs/phases.PHASE_ORDER plus the trailing
# fused_step timer (kept literal — this tool must stay runnable
# without the repo's deps; a test pins the copy equal)
_PHASE_ORDER = ("infeed_wait", "embed_gather", "concat_dense",
                "forward_pool", "backward", "table_apply",
                "backward_apply", "allreduce", "allreduce_exposed",
                "fused_step")


def phase_rows(events: List[Dict[str, Any]],
               gauges: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-phase attribution rows from the sampled `phase` events
    (--phase_profile): device-ms percentiles per phase,
    joined with the static analytic-bytes gauges into achieved GB/s
    and utilization vs the `train/phase_ceiling_gbps` ceiling — the
    BENCH phase table shape, rebuilt from a live run's telemetry."""
    samples: Dict[str, List[float]] = {}
    for e in events:
        if e.get("kind") != "phase":
            continue
        for k, v in e.items():
            if not k.endswith("_ms") or not isinstance(v, (int, float)):
                continue
            name = "fused_step" if k == "fused_ms" else k[:-3]
            if name in ("split_sum", "residual"):
                continue
            samples.setdefault(name, []).append(float(v))
    ceiling = gauges.get("train/phase_ceiling_gbps")
    ordered = [p for p in _PHASE_ORDER if p in samples]
    ordered += sorted(set(samples) - set(ordered))
    rows = []
    for name in ordered:
        vals = samples[name]
        p50 = _pct(vals, 50)
        row: Dict[str, Any] = {"phase": name, "n": len(vals),
                               "p50_ms": p50,
                               "p95_ms": _pct(vals, 95)}
        nb = gauges.get(f"train/phase_bytes/{name}")
        if isinstance(nb, (int, float)) and nb and p50 > 0:
            row["bytes"] = int(nb)
            row["gbps"] = nb / (p50 / 1e3) / 1e9
            if isinstance(ceiling, (int, float)) and ceiling:
                row["vs_ceiling"] = row["gbps"] / float(ceiling)
        rows.append(row)
    return rows


def boundary_rows(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Epoch-boundary rows from the checkpoint/eval events: one row per
    `save` event (kind="save": loop-side blocked_ms), joined with its
    `save_committed` (writer-side total_ms) by step and the epoch's
    `eval` event (eval_ms). `overlap` is the fraction of the save wall
    HIDDEN from the train loop: 1 - blocked/total (a synchronous save
    scores 0, a fully-backgrounded one approaches 1)."""
    commits: Dict[int, Dict[str, Any]] = {}
    for e in events:
        if e.get("kind") == "save_committed" and "step" in e:
            commits[int(e["step"])] = e
    evals: Dict[int, Dict[str, Any]] = {}
    for e in events:
        if e.get("kind") == "eval" and "step" in e:
            evals[int(e["step"])] = e
    rows = []
    for e in events:
        if e.get("kind") != "save" or "step" not in e:
            continue
        step = int(e["step"])
        blocked = float(e.get("blocked_ms", float("nan")))
        commit = commits.get(step)
        total = (float(commit["total_ms"])
                 if commit and "total_ms" in commit else float("nan"))
        ev = evals.get(step)
        eval_ms = (float(ev["eval_ms"])
                   if ev and "eval_ms" in ev else None)
        overlap = (1.0 - blocked / total
                   if total == total and total > 0 else float("nan"))
        rows.append({"step": step, "blocked_ms": blocked,
                     "total_ms": total, "eval_ms": eval_ms,
                     "overlap": overlap,
                     "is_async": bool(e.get("is_async", False))})
    return rows


def _fmt(v, nd: int = 2) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        if v != v:  # nan
            return "—"
        return f"{v:,.{nd}f}"
    return str(v)


def render(run_dirs: List[str]) -> str:
    loaded = [(d, *load_run(d)) for d in run_dirs]
    lines: List[str] = []

    # ---- headline: a row per run with step events ----
    head = [(d, m, ev, summarize_steps(m, ev)) for d, m, ev in loaded]
    train_rows = [(d, m, ev, s) for d, m, ev, s in head if s]
    if train_rows:
        lines.append("| Config | ms/step | pc/s/chip "
                     "| infeed wait p95 (ms) | steps | Source |")
        lines.append("|---|---|---|---|---|---|")
        for _d, m, _ev, s in train_rows:
            lines.append(
                f"| {_config_label(m)} "
                f"| {_fmt(s['ms_per_step_p50'])} "
                f"| {_fmt(s['pc_per_sec'], 1)} "
                f"| {_fmt(_pct(s['infeed_wait_ms'], 95))} "
                f"| {s['n_steps']} "
                f"| {m.get('run_id', '?')} |")
        lines.append("")

    # ---- per-run detail ----
    for _d, manifest, events, step_summary in head:
        rid = manifest.get("run_id", "?")
        dev = manifest.get("devices") or {}
        lines.append(f"## run {rid} ({manifest.get('component', '?')}, "
                     f"{dev.get('platform', '?')} x"
                     f"{dev.get('count', '?')}, "
                     f"process {manifest.get('process_index', 0)}"
                     f"/{manifest.get('process_count', 1)})")
        if step_summary:
            lines.append(f"- steps: {step_summary['n_steps']}, "
                         f"examples: {step_summary['examples']}, "
                         f"final loss: "
                         f"{_fmt(step_summary['final_loss'], 4)}, "
                         f"{_fmt(step_summary['ex_per_sec'], 1)} ex/s")
        timers = _timer_rows(events)
        if timers:
            lines.append("")
            lines.append("| Timer | count | mean ms | p50 | p95 | p99 "
                         "| max |")
            lines.append("|---|---|---|---|---|---|---|")
            for name, t in sorted(timers.items()):
                lines.append(
                    f"| {name} | {t.get('count', 0)} "
                    f"| {_fmt(t.get('mean_ms'))} "
                    f"| {_fmt(t.get('p50_ms'))} "
                    f"| {_fmt(t.get('p95_ms'))} "
                    f"| {_fmt(t.get('p99_ms'))} "
                    f"| {_fmt(t.get('max_ms'))} |")
        gauges = {}
        for e in events:
            if e.get("kind") == "gauge":
                gauges[e.get("name")] = e.get("value")
            elif e.get("kind") == "summary" and e.get("gauges"):
                gauges.update(e["gauges"])
        # ---- sampled phase attribution (--phase_profile) ----
        p_rows = phase_rows(events, gauges)
        if p_rows:
            lines.append("")
            lines.append("| Phase | samples | p50 ms | p95 ms | bytes "
                         "| GB/s | vs ceiling |")
            lines.append("|---|---|---|---|---|---|---|")
            for r in p_rows:
                lines.append(
                    f"| {r['phase']} | {r['n']} "
                    f"| {_fmt(r['p50_ms'], 3)} "
                    f"| {_fmt(r['p95_ms'], 3)} "
                    f"| {_fmt(r.get('bytes'), 0)} "
                    f"| {_fmt(r.get('gbps'), 1)} "
                    f"| {_fmt(r.get('vs_ceiling'), 3)} |")
        if gauges:
            lines.append("")
            lines.append("gauges: " + ", ".join(
                f"{k}={_fmt(v, 1)}" for k, v in sorted(gauges.items())))
        # ---- epoch boundaries: save blocked vs total, eval, overlap ----
        b_rows = boundary_rows(events)
        if b_rows:
            lines.append("")
            lines.append("| Epoch boundary (step) | mode "
                         "| save_blocked_ms | save_total_ms | eval_ms "
                         "| save overlap |")
            lines.append("|---|---|---|---|---|---|")
            for r in b_rows:
                lines.append(
                    f"| {r['step']} "
                    f"| {'async' if r['is_async'] else 'sync'} "
                    f"| {_fmt(r['blocked_ms'])} "
                    f"| {_fmt(r['total_ms'])} "
                    f"| {_fmt(r['eval_ms'])} "
                    f"| {_fmt(r['overlap'], 3)} |")
        # ---- alerts (obs/alerts.py): one row per edge-triggered
        # transition — the run's incident log in table form ----
        alert_events = [e for e in events if e.get("kind") == "alert"]
        if alert_events:
            t0 = manifest.get("created_unix")
            lines.append("")
            lines.append("| Alert | transition | rule kind | metric "
                         "| observed | threshold | severity | t+ s |")
            lines.append("|---|---|---|---|---|---|---|---|")
            for e in alert_events:
                offs = (_fmt(float(e["ts"]) - float(t0), 1)
                        if t0 is not None and "ts" in e else "—")
                lines.append(
                    f"| {e.get('rule', '?')} "
                    f"| {e.get('transition', '?')} "
                    f"| {e.get('rule_kind', '?')} "
                    f"| {e.get('metric', '?')} {e.get('op', '')} "
                    f"| {_fmt(e.get('value'), 4)} "
                    f"| {_fmt(e.get('threshold'), 4)} "
                    f"| {e.get('severity', '?')} | {offs} |")
        bench_events = [e for e in events if e.get("kind") == "bench"]
        for b in bench_events:
            lines.append("")
            lines.append(
                f"bench: {_fmt(b.get('value'), 1)} {b.get('metric')} "
                f"({_fmt(b.get('ms_per_step'))} ms/step)")
        # ---- serving throughput (the loadgen's runs) ----
        load_events = [e for e in events if e.get("kind") == "loadgen"]
        if load_events:
            lines.append("")
            lines.append("| Serving mode | conc | req | ok | shed "
                         "| req/s | p50 ms | p99 ms | new compiles |")
            lines.append("|---|---|---|---|---|---|---|---|---|")
            for e in load_events:
                lat = e.get("latency") or {}
                lines.append(
                    f"| {e.get('mode', '?')} "
                    f"| {e.get('concurrency', 1)} "
                    f"| {e.get('requests', 0)} | {e.get('ok', 0)} "
                    f"| {e.get('shed', 0)} "
                    f"| {_fmt(e.get('throughput_rps'))} "
                    f"| {_fmt(lat.get('p50_ms'))} "
                    f"| {_fmt(lat.get('p99_ms'))} "
                    f"| {_fmt(e.get('new_compilations_under_load'))} |")
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"


def render_merged(run_dirs: List[str]) -> str:
    """`--merge`: treat the given run dirs as ONE logical multi-process
    run (one per process, the manifests carrying process_index /
    process_count) and
    aggregate them into a single headline row: global throughput is the
    SUM of per-process pc/s (each host feeds its own shard), step
    latency percentiles pool every process's step samples, and the
    per-process rows below keep the skew visible (a straggler host
    shows up as a slow row, not a hidden average)."""
    loaded = [(d, *load_run(d)) for d in run_dirs]
    rows = []
    for d, m, ev in loaded:
        s = summarize_steps(m, ev)
        if s is None:
            print(f"warning: {d} has no step events; skipped from "
                  "merge", file=sys.stderr)
            continue
        rows.append((m, s))
    if not rows:
        return "(no runs with step events to merge)\n"
    counts = {m.get("process_count", 1) for m, _ in rows}
    lines: List[str] = []
    if len(counts) > 1 or len(rows) != max(counts):
        lines.append(f"warning: merging {len(rows)} run(s) whose "
                     f"manifests declare process_count {sorted(counts)}"
                     " — partial or mixed run set")
        lines.append("")
    rows.sort(key=lambda r: r[0].get("process_index", 0))
    all_step_ms = [ms for _, s in rows for ms in s["step_ms"]]
    all_wait_ms = [ms for _, s in rows for ms in s["infeed_wait_ms"]]
    total_pc = sum(s["pc_per_sec"] for _, s in rows
                   if s["pc_per_sec"] == s["pc_per_sec"])
    lines.append("| Config | procs | ms/step | pc/s (sum) "
                 "| infeed wait p95 (ms) | steps | Source |")
    lines.append("|---|---|---|---|---|---|---|")
    m0 = rows[0][0]
    lines.append(
        f"| {_config_label(m0)} | {len(rows)} "
        f"| {_fmt(_pct(all_step_ms, 50))} "
        f"| {_fmt(total_pc, 1)} "
        f"| {_fmt(_pct(all_wait_ms, 95))} "
        f"| {max(s['n_steps'] for _, s in rows)} "
        f"| merged({len(rows)} runs) |")
    lines.append("")
    lines.append("| Process | steps | examples | ex/s | pc/s "
                 "| ms/step p50 | infeed p95 | run |")
    lines.append("|---|---|---|---|---|---|---|---|")
    for m, s in rows:
        lines.append(
            f"| {m.get('process_index', 0)}"
            f"/{m.get('process_count', 1)} "
            f"| {s['n_steps']} | {s['examples']} "
            f"| {_fmt(s['ex_per_sec'], 1)} "
            f"| {_fmt(s['pc_per_sec'], 1)} "
            f"| {_fmt(s['ms_per_step_p50'])} "
            f"| {_fmt(_pct(s['infeed_wait_ms'], 95))} "
            f"| {m.get('run_id', '?')} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="summarize code2vec_tpu_torch telemetry JSONL runs")
    ap.add_argument("paths", nargs="+",
                    help="telemetry root dir(s) or run dir(s)")
    ap.add_argument("--merge", action="store_true",
                    help="aggregate the given per-process run dirs "
                         "into ONE multi-host table (pc/s summed, "
                         "step percentiles pooled, per-process skew "
                         "rows below)")
    args = ap.parse_args(argv)
    run_dirs: List[str] = []
    for p in args.paths:
        found = find_runs(p)
        if not found:
            print(f"error: no telemetry runs under {p}",
                  file=sys.stderr)
            return 2
        run_dirs.extend(found)
    if args.merge:
        sys.stdout.write(render_merged(run_dirs))
        return 0
    sys.stdout.write(render(run_dirs))
    return 0


if __name__ == "__main__":
    sys.exit(main())

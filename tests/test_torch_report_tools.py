"""The port's run-record report tools (code2vec_tpu_torch/tools/
telemetry_report.py and trace_report.py, copies of the JAX package's
root tools) and the port loadgen's `--trace_out`, on the CPU.

- One `cli.main --telemetry_dir --trace` run of the port (an epoch of
  training with its save and evaluation) is rendered by the port's
  copies and by the JAX package's tools: the
  same text, the JAX tool's "vs V100" column aside (the copy drops it),
  and the same Chrome trace events.
- The same for `--merge` over a two-rank gloo run of the command line
  (`--mesh_data 2`, one run directory a rank).
- The loadgen's `--trace --trace_out <path>` writes a Chrome trace whose
  event count is the `trace_events` it reports, and the copy reads the
  run directory it names.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from code2vec_tpu_torch.tools import telemetry_report, trace_report
from tools import telemetry_report as jax_telemetry_report
from tools import trace_report as jax_trace_report

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
V100 = "vs V100 (1.94M)"


def drop_column(text: str, header: str) -> str:
    """`text` with the markdown tables' column named `header` removed."""
    out, drop = [], None
    for line in text.splitlines():
        if line.startswith("|"):
            cells = line.split("|")
            if drop is None and any(c.strip() == header for c in cells):
                drop = next(i for i, c in enumerate(cells)
                            if c.strip() == header)
            if drop is not None and len(cells) > drop:
                line = "|".join(cells[:drop] + cells[drop + 1:])
        else:
            drop = None
        out.append(line)
    return "\n".join(out) + ("\n" if text.endswith("\n") else "")


def _main_out(tool, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tool.main(argv)
    return rc, buf.getvalue()


def _chrome(tool, run_dirs, path, merge=False):
    n = tool.write_chrome_trace(run_dirs, path, merge=merge)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert n == len(events)
    # the clock note names where the measured offsets come from in each
    # package's own words
    for e in events:
        if e.get("name") == "clock_note":
            e["args"].pop("note", None)
    return events


def assert_same_reports(run_dirs, tmp_path, merge=False):
    """The port's copies and the JAX tools on the same run dirs: the
    same text (the V100 column aside) and the same Chrome events."""
    flags = ["--merge"] if merge else []
    rc, got = _main_out(telemetry_report, [*run_dirs, *flags])
    jrc, want = _main_out(jax_telemetry_report, [*run_dirs, *flags])
    assert rc == jrc == 0
    assert V100 not in got and V100 in want
    assert got == drop_column(want, V100)
    assert "| Config |" in got
    got_tr = _main_out(trace_report, [*run_dirs])
    want_tr = _main_out(jax_trace_report, [*run_dirs])
    assert got_tr == want_tr and got_tr[0] == 0
    assert _chrome(trace_report, run_dirs, str(tmp_path / "port.json"),
                   merge) == _chrome(jax_trace_report, run_dirs,
                                     str(tmp_path / "jax.json"), merge)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from helpers import build_tiny_dataset
    d = tmp_path_factory.mktemp("report_tools")
    return str(d), build_tiny_dataset(str(d), n_train=48, n_val=8,
                                      n_test=8, max_contexts=16)


def _cli_argv(prefix, tele, save):
    return ["--backend", "cpu", "--data", prefix, "--test",
            prefix + ".val.c2v", "--save", save, "--max_contexts", "16",
            "--batch_size", "8", "--epochs", "1", "--async_checkpoint",
            "off", "--telemetry_dir", tele, "--trace"]


def test_a_port_run_renders_as_the_jax_tools_render_it(dataset, tmp_path):
    """`cli.main --telemetry_dir --trace` (training, its epoch-end save
    and evaluation): the run directory rendered by both pairs of tools."""
    from code2vec_tpu_torch import cli
    _d, prefix = dataset
    tele = str(tmp_path / "tele")
    assert cli.main(_cli_argv(prefix, tele, str(tmp_path / "ckpt"))) == 0
    runs = telemetry_report.find_runs(tele)
    assert runs == jax_telemetry_report.find_runs(tele) and runs
    assert_same_reports(runs, tmp_path)


def test_a_two_rank_run_merges_as_the_jax_tools_merge_it(dataset,
                                                        tmp_path):
    """Two `python3 -m code2vec_tpu_torch --mesh_data 2 --dist_*` ranks
    over gloo, each with its run directory: `--merge` of both by the
    port's copies and by the JAX tools."""
    from code2vec_tpu_torch.parallel.compat import free_port
    from code2vec_tpu_torch.resilience import retry
    _d, prefix = dataset
    tele = str(tmp_path / "tele")

    def once():
        port = str(free_port())
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "code2vec_tpu_torch",
             *_cli_argv(prefix, tele, str(tmp_path / f"ckpt{r}")),
             "--mesh_data", "2", "--dist_coordinator", f"127.0.0.1:{port}",
             "--dist_num_processes", "2", "--dist_process_id", str(r)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=120)[0] for p in procs]
        except subprocess.TimeoutExpired:
            outs = ["rank timed out"] * 2
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if not all(p.returncode == 0 for p in procs):
            raise RuntimeError("rank failed:\n" + "\n".join(
                o[-2000:] for o in outs))

    retry.transient_distributed("report-tools-cli", max_attempts=2,
                                base_delay_s=0.1).call(once)
    runs = telemetry_report.find_runs(tele)
    train = [r for r in runs if telemetry_report.load_run(r)[0].get(
        "component") == "train"]
    assert len(train) == 2
    assert sorted(telemetry_report.load_run(r)[0]["process_index"]
                  for r in train) == [0, 1]
    assert_same_reports(train, tmp_path, merge=True)


def test_loadgen_trace_out_writes_the_chrome_trace(tmp_path):
    """`loadgen --trace --trace_out <path>` on the CPU: the file holds
    `trace_events` Chrome events (spans of the serve requests among
    them), `trace_json` names it, and the copy's critical-path table
    reads `trace_run_dir`."""
    from code2vec_tpu_torch.tools import loadgen
    path = str(tmp_path / "trace.json")
    rc, out = _main_out(loadgen, [
        "--backend", "cpu", "--mode", "closed", "--requests", "8",
        "--concurrency", "2", "--telemetry_dir", str(tmp_path / "tele"),
        "--trace", "--trace_out", path])
    assert rc == 0
    rep = json.loads(out[out.index("{"):])
    assert rep["trace_json"] == path
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert rep["trace_events"] == len(events) > 0
    assert any(e.get("name") == "serve/request" for e in events)
    rc, table = _main_out(trace_report, [rep["trace_run_dir"]])
    assert rc == 0 and "queue_wait" in table

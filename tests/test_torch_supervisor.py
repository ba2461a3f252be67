"""The port's restart supervisor (code2vec_tpu_torch/training/
supervisor.py) and its command line (tools/train_supervisor.py), held
against the JAX package's `Supervisor`.

The policy cases of tests/test_resilience.py (restart until success, the
budget's page, a dead peer reaped and the cohort relaunched, shrink to
N-1, the min_procs floor, grow-back, a systemic failure and a timeout
kept at full size) drive the JAX and the port `Supervisor` with one
scripted fake spawn each; their decisions (exit or exception, restarts,
resizes, full relaunches, the cohort size of every spawn, the gauges and
the alert states) are held equal, and to the JAX tests' expectations.
The fake processes are in-memory (`poll`/`kill`/`wait`), so the cases
start no subprocess. Then the port alone: the quarantine before launch
on a checkpoint of its own, the watchdog's cohort topology, and the
tool's exit codes (2 for `--procs 2` and `--resize_policy shrink`, 0
with `--auto_resume` appended to a `--save` child, 3 on an exhausted
budget; each child is a `python -c` under the tool's
`--attempt_timeout_s` of 60 s). Tolerance: none (decisions and
counts).
"""

import json
import os
import sys
import time

import pytest

from code2vec_tpu.obs import Telemetry as JTelemetry
from code2vec_tpu.resilience.retry import RetryPolicy as JRetryPolicy
from code2vec_tpu.training import supervisor as jsup
from code2vec_tpu_torch.obs import Telemetry
from code2vec_tpu_torch.resilience.retry import RetryPolicy
from code2vec_tpu_torch.tools import train_supervisor as tool
from code2vec_tpu_torch.training import supervisor as tsup


class FakeProc:
    """A child that exits with `rc` at once, or (rc None) runs until
    killed."""
    _next_pid = 1000

    def __init__(self, rc):
        self.rc = rc
        FakeProc._next_pid += 1
        self.pid = FakeProc._next_pid

    def poll(self):
        return self.rc

    def kill(self):
        if self.rc is None:
            self.rc = -9

    def wait(self):
        return self.rc


RUN = None  # a child that runs until the supervisor kills it


def _script_success_on_third(attempt, proc_id):
    return 0 if attempt >= 2 else 1


def _script_always_fail(attempt, proc_id):
    return 1


def _script_dead_peer(attempt, proc_id):
    if attempt == 0:
        return 9 if proc_id == 1 else RUN
    return 0


def _script_grow_back(attempt, proc_id):
    if attempt == 0:
        return 1 if proc_id == 1 else RUN
    if attempt == 1:
        return 1
    return 0


def _script_systemic(attempt, proc_id):
    return 2 if attempt == 0 else 0


def _script_hang(attempt, proc_id):
    return RUN if attempt == 0 else 0


# name -> (script, Supervisor kwargs, replacements, expected)
CASES = {
    "restarts_until_success": (
        _script_success_on_third, dict(max_restarts=3), None,
        dict(rc=0, restarts=2, fired=1)),
    "budget_exhaustion_pages": (
        _script_always_fail, dict(max_restarts=1), None,
        dict(rc="RestartBudgetExceeded", restarts=2)),
    "dead_peer_relaunches_cohort": (
        _script_dead_peer, dict(num_procs=2, max_restarts=2), None,
        dict(rc=0, restarts=1, resizes=[])),
    "shrink_reforms_at_n_minus_1": (
        _script_dead_peer,
        dict(num_procs=2, max_restarts=2, resize_policy="shrink"), None,
        dict(rc=0, restarts=1, resizes=[(2, 1)], full_relaunches=0,
             spawns=[(0, 0, 2), (0, 1, 2), (1, 0, 1)])),
    "shrink_floors_at_min_procs": (
        _script_dead_peer,
        dict(num_procs=2, max_restarts=2, resize_policy="shrink",
             min_procs=2), None,
        dict(rc=0, resizes=[], full_relaunches=1)),
    "grows_back_with_replacement": (
        _script_grow_back,
        dict(num_procs=2, max_restarts=3, resize_policy="shrink"),
        [False, True],
        dict(rc=0, resizes=[(2, 1), (1, 2)], sizes=[2, 2, 1, 2, 2])),
    "systemic_failure_keeps_size": (
        _script_systemic,
        dict(num_procs=2, max_restarts=2, resize_policy="shrink"), None,
        dict(rc=0, resizes=[], full_relaunches=1)),
    "timeout_relaunches_full_size": (
        _script_hang,
        dict(num_procs=2, max_restarts=2, resize_policy="shrink",
             attempt_timeout_s=0.3), None,
        dict(rc=0, resizes=[], full_relaunches=1)),
}


def _drive(pkg, script, kwargs, replacements):
    """One supervised run of `script` under the package's Supervisor:
    its decisions as one comparable dict."""
    mod, tele_cls, policy = ((jsup, JTelemetry, JRetryPolicy)
                             if pkg == "jax"
                             else (tsup, Telemetry, RetryPolicy))
    spawns = []

    def spawn(attempt, proc_id, port, cohort_size=None):
        spawns.append((attempt, proc_id, cohort_size))
        return FakeProc(script(attempt, proc_id))

    left = list(replacements) if replacements is not None else None
    kw = dict(kwargs)
    if left is not None:
        kw["replacement_fn"] = lambda: left.pop(0) if left else False
    sup = mod.Supervisor(
        spawn, telemetry=tele_cls.memory("supervisor"), poll_s=0.005,
        peer_grace_s=0.05, log=lambda _m: None,
        backoff=policy("s", max_attempts=1, base_delay_s=0.001, seed=0),
        sleep=lambda s: time.sleep(min(s, 0.005)), **kw)
    try:
        rc = sup.run()
    except mod.RestartBudgetExceeded:
        rc = "RestartBudgetExceeded"
    tele = sup.telemetry
    return {
        "rc": rc, "restarts": sup.restarts,
        "resizes": [tuple(r) for r in sup.resizes],
        "full_relaunches": sup.full_relaunches, "cur_procs": sup.cur_procs,
        "spawns": spawns, "sizes": [n for _a, _p, n in spawns],
        "fired": tele.counters.get("alerts/fired", 0),
        "gauges": {k: v for k, v in tele.gauges.items()
                   if k.startswith(("supervisor/", "resilience/"))},
        "counters": {k: v for k, v in tele.counters.items()
                     if k.startswith(("supervisor/", "resilience/"))},
        "alerts": {r["rule"]: r["state"] for r in sup.alerts.status_table()},
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_supervisor_decisions_match_jax(case):
    script, kwargs, replacements, expected = CASES[case]
    port = _drive("port", script, kwargs, replacements)
    ref = _drive("jax", script, kwargs, replacements)
    assert port == ref
    for key, value in expected.items():
        assert port[key] == value, (key, port[key])
    if case == "budget_exhaustion_pages":
        assert port["gauges"]["supervisor/budget_exhausted"] == 1
        assert port["alerts"]["restart_budget_exhausted"] == "firing"
    if case == "shrink_reforms_at_n_minus_1":
        assert port["counters"]["resilience/resize"] == 1
        assert port["gauges"]["supervisor/cohort_size"] == 1
        assert port["gauges"]["supervisor/cohort_target"] == 2
        assert port["alerts"]["cohort_resized"] == "firing"


def test_alert_rules_match_jax():
    """The supervisor's rules (its four and the fleet's two) are the JAX
    package's: names, metrics, thresholds and severities."""
    def rows(rules):
        return [(r.name, r.metric, r.op, r.value, r.severity)
                for r in rules]
    assert rows(tsup.supervisor_alert_rules()) == \
        rows(jsup.supervisor_alert_rules())


def _tiny_checkpoint(tmp_path):
    """Two committed steps of a small model (1 and 2) and the dir."""
    import torch

    from code2vec_tpu_torch.models.encoder import ModelDims, init_params
    from code2vec_tpu_torch.training import checkpoint as ckpt
    from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
    from helpers import build_tiny_dataset
    (tmp_path / "ds").mkdir()
    prefix = build_tiny_dataset(str(tmp_path / "ds"), n_train=8, n_val=4,
                                n_test=4, max_contexts=4)
    vocabs = Code2VecVocabs.load_from_dict_file(prefix + ".dict.c2v", 100,
                                                100, 100)
    dims = ModelDims(vocabs.token_vocab.size, vocabs.path_vocab.size,
                     vocabs.target_vocab.size, embeddings_size=4,
                     max_contexts=4)
    d = str(tmp_path / "ckpt")
    for step in (1, 2):
        params = init_params(torch.Generator().manual_seed(step), dims)
        ckpt.save_checkpoint(d, {"params": params, "opt_state": {},
                                 "step": step}, step, vocabs, dims)
    return d


def test_supervisor_quarantines_before_launch(tmp_path):
    """A flipped byte in the latest step is found BEFORE launch,
    quarantined, the child resumes from step 1, and one
    `checkpoint_quarantined` firing event and one `ckpt_quarantine`
    event are written."""
    from code2vec_tpu_torch.tools.chaos import flip_byte_in_largest_file
    d = _tiny_checkpoint(tmp_path)
    flip_byte_in_largest_file(os.path.join(d, "step_2"))
    tele = Telemetry.create(str(tmp_path / "tele"), component="supervisor")
    sup = tsup.Supervisor(lambda *a: FakeProc(0), max_restarts=0,
                          ckpt_dir=d, telemetry=tele, poll_s=0.005,
                          log=lambda _m: None)
    assert sup.run() == 0
    tele.close()
    assert sup.resumed_from_step == 1 and len(sup.quarantined) == 1
    assert os.path.isdir(os.path.join(d, "quarantine", "step_2"))
    assert tele.gauges["resilience/ckpt_quarantined"] == 1
    with open(os.path.join(tele.run_dir, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    alerts = [e for e in events if e["kind"] == "alert"
              and e["rule"] == "checkpoint_quarantined"]
    assert [a["transition"] for a in alerts] == ["firing"]
    assert [e["fallback_step"] for e in events
            if e["kind"] == "ckpt_quarantine"] == [1]


def test_cohort_topology_joins_the_watchdog(tmp_path):
    """`watchdog=` attaches the live cohort topology to stall dumps and
    registers the supervise loop's heartbeat, idle after a finished
    run; a stall's dump carries the topology."""
    from code2vec_tpu_torch.obs.watchdog import Watchdog
    clk = {"t": 0.0}
    tele = Telemetry.create(str(tmp_path / "tele"), component="sup")
    wd = Watchdog(tele, stall_s=1.0, clock=lambda: clk["t"])
    sup = tsup.Supervisor(lambda *a: FakeProc(0), num_procs=2,
                          resize_policy="shrink", watchdog=wd,
                          poll_s=0.005, log=lambda _m: None,
                          telemetry=Telemetry.memory("s"))
    assert "supervisor_loop" in wd.status()
    topo = sup.cohort_topology()
    assert (topo["target_procs"], topo["cohort_size"],
            topo["resize_policy"]) == (2, 2, "shrink")
    assert sup.run() == 0
    assert wd.status()["supervisor_loop"]["active"] is False
    hb = wd.register("cohort")
    hb.busy()
    clk["t"] = 5.0
    assert len(wd.check_now()) == 1
    tele.close()
    dumps = list((tmp_path / "tele").glob("*/stall_dump_*.json"))
    assert dumps
    bundle = json.loads(dumps[0].read_text())
    assert bundle["cohort"]["target_procs"] == 2
    assert "live_pids" in bundle["cohort"]


def test_build_cli_spawn_refuses_a_cohort():
    with pytest.raises(ValueError, match="multi-GPU"):
        tsup.build_cli_spawn(["true"], num_procs=2)
    spawn = tsup.build_cli_spawn(["true"])
    with pytest.raises(ValueError, match="multi-GPU"):
        spawn(0, 0, 0, 2)


@pytest.mark.parametrize("flags", [["--procs", "2"],
                                   ["--resize_policy", "shrink"]])
def test_tool_refuses_a_cohort_with_exit_2(flags, capsys):
    with pytest.raises(SystemExit) as e:
        tool.main(flags + ["--", sys.executable, "-c", "pass"])
    assert e.value.code == 2
    assert "multi-GPU" in capsys.readouterr().err


def test_tool_appends_auto_resume_and_exits_0(tmp_path, capsys):
    marker = tmp_path / "ran"
    rc = tool.main([
        "--max_restarts", "0", "--backoff_base_s", "0.01",
        "--attempt_timeout_s", "60", "--out_dir", str(tmp_path / "logs"),
        "--", sys.executable, "-c",
        f"import sys, pathlib; pathlib.Path(r'{marker}').write_text("
        f"' '.join(sys.argv)); sys.exit(0)",
        "--save", str(tmp_path / "ckpt")])
    assert rc == 0
    assert "--auto_resume" in marker.read_text()
    assert "appending it" in capsys.readouterr().out


def test_tool_exhausted_budget_exits_3_with_one_page(tmp_path):
    """A child that always fails under `--max_restarts 1`: exit 3, and
    the supervisor's events hold exactly one page-severity firing."""
    tele = str(tmp_path / "tele")
    rc = tool.main([
        "--max_restarts", "1", "--backoff_base_s", "0.01",
        "--attempt_timeout_s", "60", "--telemetry_dir", tele,
        "--out_dir", str(tmp_path / "logs"),
        "--", sys.executable, "-c", "import sys; sys.exit(1)"])
    assert rc == 3
    (run,) = os.listdir(tele)
    with open(os.path.join(tele, run, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    pages = [e for e in events if e["kind"] == "alert"
             and e["severity"] == "page" and e["transition"] == "firing"]
    assert [p["rule"] for p in pages] == ["restart_budget_exhausted"]

"""The supervised training cohort of the port: the `--dist_*` argv of
`training/supervisor.build_cli_spawn` against the JAX package's, the
supervisor tool over a two-member cohort, and the checkpoint rules of a
load above one process (training/checkpoint.load_checkpoint against
code2vec_tpu/training/checkpoint.py:635-660).

- The argv of a cohort's spawn (N = 2 at attempt k, a cohort re-formed
  at one process, with and without `metrics_ports`) equals the JAX
  package's for the same child command: `subprocess.Popen` is captured
  in both packages, the JAX spawn gets no `cpu_devices`. Tolerance:
  exact (the child command is the same list on both sides).
- The tool runs a cohort of two trivial children under `--procs 2
  --resize_policy shrink --min_procs 1`; each checks its own `--dist_*`
  flags and exits 0. Tolerance: none (exit codes).
- Two gloo ranks (tests/test_torch_multiprocess.py's spawn helper) load
  a tree whose latest step is corrupt: both raise `CheckpointCorrupt`
  with the JAX wording and no quarantine directory appears; one process
  then quarantines the step and falls back to the one before it.
  Tolerance: none.
- A step whose topology.json names another number of processes than the
  world logs the JAX package's resharding line, and loads the same
  state. Tolerance: none (bits).
"""

import json
import os
import sys

import pytest
import torch

from code2vec_tpu_torch.tools import train_supervisor as tool
from code2vec_tpu_torch.training import checkpoint as ckpt
from code2vec_tpu_torch.training import supervisor as tsup


def _capture_argv(monkeypatch, spawn_calls, build):
    """The argv each spawn call passes to `subprocess.Popen`."""
    import subprocess
    seen = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, **_kw: seen.append(list(cmd)))
    spawn = build()
    for args in spawn_calls:
        spawn(*args)
    return seen


# (build kwargs, spawn calls (attempt, proc_id, port, cohort_size))
ARGV_CASES = {
    "cohort_of_2_attempt_3": (dict(num_procs=2),
                              [(3, 0, 41001, 2), (3, 1, 41001, 2)]),
    "reformed_at_1": (dict(num_procs=2), [(1, 0, 0, 1)]),
    "metrics_ports": (dict(num_procs=2, metrics_ports=[9300, 9301]),
                      [(0, 0, 41002, 2), (0, 1, 41002, 2), (1, 0, 0, 1)]),
    "cohort_size_default": (dict(num_procs=3), [(0, 2, 41003, None)]),
}


@pytest.mark.parametrize("case", list(ARGV_CASES))
def test_build_cli_spawn_argv_matches_jax(case, monkeypatch, tmp_path):
    from code2vec_tpu.training import supervisor as jsup
    kwargs, calls = ARGV_CASES[case]
    child = [sys.executable, "-m", "code2vec_tpu_torch", "--data", "d",
             "--save", "ckpt", "--auto_resume"]
    got = _capture_argv(monkeypatch, calls, lambda: tsup.build_cli_spawn(
        child, out_dir=str(tmp_path / "port"), **kwargs))
    want = _capture_argv(monkeypatch, calls, lambda: jsup.build_cli_spawn(
        child, out_dir=str(tmp_path / "jax"), **kwargs))
    assert got == want and len(got) == len(calls)
    for (_a, _i, _p, n), argv in zip(calls, got):
        assert ("--dist_coordinator" in argv) == \
            ((n or kwargs["num_procs"]) > 1)


def test_tool_runs_a_shrinkable_cohort_of_two(tmp_path):
    script = ("import sys; a = sys.argv; "
              "i = int(a[a.index('--dist_process_id') + 1]); "
              "ok = (a[a.index('--dist_num_processes') + 1] == '2' "
              "and a[a.index('--dist_coordinator') + 1].startswith("
              "'127.0.0.1:')); "
              "open(a[1] + str(i), 'w').close(); sys.exit(0 if ok else 5)")
    marker = str(tmp_path / "member")
    tele = str(tmp_path / "tele")
    rc = tool.main([
        "--procs", "2", "--resize_policy", "shrink", "--min_procs", "1",
        "--max_restarts", "0", "--backoff_base_s", "0.01",
        "--attempt_timeout_s", "60", "--telemetry_dir", tele,
        "--out_dir", str(tmp_path / "logs"),
        "--", sys.executable, "-c", script, marker])
    assert rc == 0
    assert sorted(p.name for p in tmp_path.glob("member*")) == [
        "member0", "member1"]
    (run,) = os.listdir(tele)
    with open(os.path.join(tele, run, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    (launch,) = [e for e in events if e["kind"] == "supervisor_launch"]
    assert launch["num_procs"] == 2 and launch["cohort_target"] == 2


# ---- the checkpoint rules above one process ----

def _tiny_checkpoint(ckpt_dir, steps=(1, 2), num_processes=1):
    """A checkpoint dir of `steps`, saved as by `num_processes`
    processes, with a small model's vocabs and dims."""
    from code2vec_tpu_torch.models.encoder import ModelDims
    from code2vec_tpu_torch.vocab.vocabularies import (Code2VecVocabs,
                                                       Vocab, VocabType)
    vocabs = Code2VecVocabs(Vocab(VocabType.Token, ["a", "b"]),
                            Vocab(VocabType.Path, ["p"]),
                            Vocab(VocabType.Target, ["t|x"]))
    dims = ModelDims(token_vocab_size=vocabs.token_vocab.size,
                     path_vocab_size=vocabs.path_vocab.size,
                     target_vocab_size=vocabs.target_vocab.size,
                     embeddings_size=4, max_contexts=2)
    for s in steps:
        gen = torch.Generator().manual_seed(s)
        state = {"params": {"w": torch.randn(8, 4, generator=gen)},
                 "step": s}
        ckpt.save_checkpoint(ckpt_dir, state, s, vocabs, dims,
                             topology={"num_processes": num_processes})
    return vocabs, dims


def corrupt_load_worker(rank, world, out_dir, deadline):
    """One rank of the corrupt-latest-step load (run by
    tests/test_torch_multiprocess.py's worker after the bring-up)."""
    deadline.beat("corrupt_load")
    try:
        ckpt.load_checkpoint(os.path.join(out_dir, "ckpt"))
        return {"raised": None}
    except Exception as e:  # the type and message are the result
        return {"raised": type(e).__name__, "message": str(e)}


def test_a_cohort_load_of_a_corrupt_latest_step_raises_on_every_rank(
        tmp_path):
    from code2vec_tpu_torch.tools.chaos import flip_byte_in_largest_file
    from test_torch_multiprocess import _spawn
    d = str(tmp_path / "ckpt")
    _tiny_checkpoint(d)
    flip_byte_in_largest_file(os.path.join(d, "step_2"))
    ranks = _spawn(2, str(tmp_path),
                   "test_torch_cohort:corrupt_load_worker")
    for r in ranks:
        assert r["raised"] == "CheckpointCorrupt", r
        assert r["message"].endswith(
            "(multi-process load: quarantine via the supervisor, not "
            "unilaterally)"), r
    # no rank moved the step: the supervisor quarantines before relaunch
    assert not os.path.exists(os.path.join(d, ckpt.QUARANTINE_DIRNAME))
    assert ckpt.latest_step(d) == 2
    # one process quarantines it itself and falls back
    lines = []
    state = ckpt.load_checkpoint(d, log=lines.append)
    assert state["step"] == 1
    assert os.path.isdir(os.path.join(d, ckpt.QUARANTINE_DIRNAME, "step_2"))
    assert any("quarantined" in ln for ln in lines)


@pytest.mark.parametrize("saved_by", [1, 2])
def test_a_step_saved_by_another_world_logs_the_resharding_line(
        tmp_path, saved_by):
    d = str(tmp_path / "ckpt")
    _tiny_checkpoint(d, steps=(3,), num_processes=saved_by)
    assert ckpt.load_step_topology(d, 3)["num_processes"] == saved_by
    lines = []
    state = ckpt.load_checkpoint(d, log=lines.append)
    want = ("checkpoint step 3: saved by 2 process(es), restoring onto 1 "
            "— resharding onto the new mesh")
    assert (want in lines) == (saved_by == 2), lines
    again = ckpt.load_checkpoint(d)
    assert torch.equal(state["params"]["w"], again["params"]["w"])

"""The port's two cohort chaos legs (code2vec_tpu_torch/tools/chaos.py)
end to end on the CPU (`--backend cpu`, gloo): real `python3 -m
code2vec_tpu_torch` ranks under the real supervisor, on the legs' tiny
synthetic data (96 training methods, a batch of 32 a rank, 3 epochs:
2 steps an epoch at two ranks, 3 at one), held to the `ok` conditions
of the JAX package's legs (tools/chaos.py:290-522), word for word:

- kill_resume_2proc: the kill fired (process 1, at its step 4), the
  supervisor exited 0 after at least one restart, the final step is the
  uninterrupted two-process run's and no param differs. Tolerance: none
  (bits).
- kill_resize: one restart, `resizes == [[2, 1]]`, no full relaunch,
  the final step equal to an uninterrupted one-process run resumed from
  a copy of the same committed step, and no param differs; the
  re-formed child joined no process group, logged the resharding line,
  and its saves record 1 process. Tolerance: none (bits).

Each test has its own limit: every training process of a leg runs under
it (the uninterrupted runs' `subprocess.run` timeout and each supervised
attempt's). A leg takes ~15-17 s alone on the CPU.
"""

import json
import os

from code2vec_tpu_torch.tools import chaos

KILL_RESUME_2PROC_TIMEOUT_S = 120.0
KILL_RESIZE_TIMEOUT_S = 120.0


def _run(scenario, tmp_path, timeout_s, monkeypatch):
    # two ranks share the CPU: one thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = str(tmp_path / scenario)
    os.makedirs(out, exist_ok=True)
    result = chaos.SCENARIOS[scenario](out, backend="cpu",
                                       timeout_s=timeout_s)
    assert result["ok"], json.dumps(result, indent=1, default=str)
    return result


def test_chaos_kill_resume_2proc_parity(tmp_path, monkeypatch):
    result = _run("kill_resume_2proc", tmp_path,
                  KILL_RESUME_2PROC_TIMEOUT_S, monkeypatch)
    assert result["kill_fired"] and result["supervisor_rc"] == 0
    assert result["restarts"] >= 1
    assert result["resumed_from_step"] == 2
    assert result["oracle_step"] == result["chaos_step"] == 6
    assert result["param_diffs"] == []


def test_chaos_kill_resize_elastic_parity(tmp_path, monkeypatch):
    result = _run("kill_resize", tmp_path, KILL_RESIZE_TIMEOUT_S,
                  monkeypatch)
    assert result["kill_fired"] and result["restarts"] == 1
    assert result["resizes"] == [[2, 1]]
    assert result["full_relaunches"] == 0
    assert result["cohort_size_final"] == 1
    assert result["resumed_from_step"] == 2
    assert result["recovery_steps_lost"] == 2
    assert result["recovery_seconds"] is not None \
        and result["recovery_seconds"] > 0
    # after the resize: two epochs of 3 one-process steps past step 2
    assert result["oracle_step"] == result["chaos_step"] == 8
    assert result["param_diffs"] == []
    assert not result["reformed_joined_group"]
    assert result["resharding_logged"]
    assert result["topology_after_resize"] == {5: 1, 8: 1}

"""The port's chaos legs (code2vec_tpu_torch/tools/chaos.py) end to end
on the CPU (`--backend cpu`): real `python3 -m code2vec_tpu_torch`
training processes under the real supervisor, holding the JAX legs'
contracts (tests/test_chaos.py):

- kill_resume: a SIGKILL mid-epoch (`train/kill` at step 5 with a
  once-latch marker), one restart with --auto_resume, and a final
  checkpoint BIT-IDENTICAL to an uninterrupted run's (tolerance: none);
- corrupt_checkpoint: a flipped byte in the latest committed step is
  quarantined before launch, exactly one `checkpoint_quarantined`
  firing event is written, and training resumes from the prior step
  and finishes past it.

Each training process runs under a 180 s limit (the legs' `timeout_s`:
the uninterrupted run's `subprocess.run` timeout and each supervised
attempt's); a leg takes 6-12 s on the CPU.
"""

import json
import os

import pytest

from code2vec_tpu_torch.tools import chaos

LEG_TIMEOUT_S = 180.0


def _run(scenario, tmp_path):
    out = str(tmp_path / scenario)
    os.makedirs(out, exist_ok=True)
    result = chaos.SCENARIOS[scenario](out, backend="cpu",
                                       timeout_s=LEG_TIMEOUT_S)
    assert result["ok"], json.dumps(result, indent=1, default=str)
    return result


def test_chaos_kill_resume_parity(tmp_path):
    result = _run("kill_resume", tmp_path)
    assert result["kill_fired"]
    assert result["restarts"] == 1
    assert result["resumed_from_step"] == 3
    assert result["param_diffs"] == []
    assert result["oracle_step"] == result["chaos_step"] == 6


def test_chaos_corrupt_checkpoint_quarantine_and_alert(tmp_path):
    result = _run("corrupt_checkpoint", tmp_path)
    assert result["quarantine_dir_exists"]
    assert result["alert_events"] == 1
    assert result["resumed_from_step"] == 3
    assert result["restarts"] == 0
    assert result["final_step"] == 9


def test_chaos_cli_lists_the_legs_and_the_unported(capsys):
    """`--list` names all five legs of the JAX package as ported (the
    serving fleet's `serve_swap_kill` among them, tests/
    test_torch_serving_tools.py runs it; the two cohort legs,
    tests/test_torch_cohort_chaos.py), and none as not ported.
    Tolerance: none."""
    assert chaos.main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in ("kill_resume", "kill_resume_2proc", "corrupt_checkpoint",
                 "serve_swap_kill", "kill_resize"):
        assert f"\n{name}: " in "\n" + out
    assert "not ported" not in out
    assert len(out.strip().splitlines()) == 5


def test_chaos_states_differ_names_the_tensor():
    """The comparison a leg's verdict rests on: equal trees give [], a
    one-bit change names its tensor, another structure is refused.
    Tolerance: none (bits)."""
    import torch
    a = {"params": {"t": torch.ones(3), "u": torch.zeros(2)},
         "opt_state": (torch.ones(1),)}
    b = {"params": {"t": torch.ones(3), "u": torch.zeros(2)},
         "opt_state": (torch.ones(1),)}
    assert chaos.states_differ(a, b) == []
    b["params"]["u"][1] = -0.0  # equal as values, not as bits
    assert chaos.states_differ(a, b) == ["/params/u"]
    b["params"]["t"][0] = torch.nextafter(torch.tensor(1.0),
                                          torch.tensor(2.0))
    assert chaos.states_differ(a, b) == ["/params/t", "/params/u"]
    assert chaos.states_differ(a, {"params": {}}) == ["<structure mismatch>"]

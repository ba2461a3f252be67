"""The elastic shrink of a sharded cohort on the CPU: the port's
supervisor steps a shrink by one group of k = dcn * model * ctx
processes (one card a process: the smallest loss that still fills the
child's mesh), where the JAX supervisor steps by one host of several
devices.

- the decision: the port's `_next_cohort_size` at (N, k, min_procs,
  reason, replacements) equals the JAX `Supervisor._next_cohort_size`
  on N/k hosts with the floor ceil(min_procs / k), times k;
- the mesh: at every size a cohort of 8 shrinks to, the port's
  `make_mesh(data=0, ...)` over that world has the shape of the JAX
  `make_mesh(data=0, ..., devices=jax.devices()[:n])` over the 8 forced
  CPU devices, for (data, model 2), (data, ctx 2) and (dcn 2, data);
- the kill_resize leg at (data 2, model 2): four gloo ranks under the
  real supervisor (`--backend cpu`), process 3 SIGKILLed at its step 4,
  the cohort re-formed at 2 ranks (data 1, model 2), held to the `ok`
  conditions of the JAX leg (tools/chaos.py:472-522) with [[4, 2]] for
  its resize, and to an uninterrupted 2-rank cohort resumed from a copy
  of the same committed step: the final step and every param's bits.
  Tolerance: none. Its own limit, as tests/test_torch_cohort_chaos.py
  has: every training process of the leg runs under it;
- the tool's refusal of a child that fixes `--mesh_data` under shrink;
- the saved topology: a step saved by (data 2, model 2) records 4
  processes and 2 batch shards, and a resume at (data 1, model 2)
  counts its epochs by the batch shards;
- `copy_committed_step` hard-links a committed step's files (the same
  bytes, no data written) and copies its sidecars, which a save
  rewrites in place.
"""

from __future__ import annotations

import json
import math
import os

import jax
import pytest

from code2vec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from code2vec_tpu.training import supervisor as jsup
from code2vec_tpu_torch.parallel.mesh import make_mesh
from code2vec_tpu_torch.tools import chaos
from code2vec_tpu_torch.training import supervisor as tsup

KILL_RESIZE_4_TIMEOUT_S = 150.0


def _replacements(n: int):
    left = [n]

    def fn() -> bool:
        left[0] -= 1
        return left[0] >= 0
    return fn


# (N target, k, min_procs, current size, reason, replacements available)
DECISIONS = [
    (4, 2, 1, 4, "peer_death", 0),      # (data 2, model 2) -> 2
    (2, 2, 1, 2, "peer_death", 0),      # no smaller cohort: relaunch
    (8, 2, 3, 8, "peer_death", 0),      # floor 3 procs = 2 hosts
    (8, 2, 3, 4, "peer_death", 0),      # at the floor: relaunch
    (8, 4, 4, 8, "peer_death", 0),
    (8, 2, 1, 4, "peer_death", 1),      # the replacement refills it
    (8, 2, 1, 4, "peer_death", 3),      # grows back to the target
    (8, 2, 1, 4, "timeout", 0),
    (8, 2, 1, 8, "cohort_failure", 2),
    (6, 1, 2, 6, "peer_death", 0),      # k = 1: the JAX decision
    (6, 1, 6, 6, "peer_death", 0),
]


@pytest.mark.parametrize("n,k,min_procs,cur,reason,repl", DECISIONS)
def test_shrink_decision_is_the_jax_one_on_hosts_of_k(n, k, min_procs, cur,
                                                      reason, repl):
    port = tsup.Supervisor(lambda *a: None, num_procs=n,
                           resize_policy="shrink", min_procs=min_procs,
                           group=k, replacement_fn=_replacements(repl),
                           max_restarts=0)
    port.cur_procs = cur
    jax_sup = jsup.Supervisor(lambda *a: None, num_procs=n // k,
                              resize_policy="shrink",
                              min_procs=math.ceil(min_procs / k),
                              replacement_fn=_replacements(repl),
                              max_restarts=0)
    jax_sup.cur_procs = cur // k
    assert port._next_cohort_size(reason) == \
        jax_sup._next_cohort_size(reason) * k


@pytest.mark.parametrize("axis,size", [("model", 2), ("context", 2),
                                       ("dcn", 2)])
def test_reformed_mesh_is_the_jax_mesh_over_the_devices_left(axis, size):
    sup = tsup.Supervisor(lambda *a: None, num_procs=8,
                          resize_policy="shrink", min_procs=1, group=size)
    sizes = [8, *sup.shrink_sizes()]
    assert sizes == [8, 6, 4, 2]
    devices = jax.devices()
    assert len(devices) == 8
    for n in sizes:
        port = make_mesh(data=0, rank=0, world=n, device="cpu",
                         **{axis: size})
        ref = jax_make_mesh(data=0, devices=devices[:n], **{axis: size})
        assert port.shape == dict(ref.shape), (n, port.shape, ref.shape)


def test_kill_resize_of_a_data_2_model_2_cohort(tmp_path, monkeypatch):
    # four ranks share the CPU: one thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = str(tmp_path / "kill_resize_4")
    os.makedirs(out)
    result = chaos.scenario_kill_resize(
        out, backend="cpu", procs=4, mesh=["--mesh_model", "2"],
        timeout_s=KILL_RESIZE_4_TIMEOUT_S)
    assert result["ok"], json.dumps(result, indent=1, default=str)
    assert result["kill_fired"] and result["restarts"] == 1
    assert result["resizes"] == [[4, 2]]
    assert result["full_relaunches"] == 0
    assert result["cohort_size_final"] == 2
    # epoch 1 at 2 batch shards: 2 steps; the kill at step 4 (epoch 2)
    assert result["resumed_from_step"] == 2
    assert result["recovery_steps_lost"] == 2
    assert result["recovery_seconds"] is not None \
        and result["recovery_seconds"] > 0
    # after the resize: two epochs of 3 steps at 1 batch shard
    assert result["oracle_step"] == result["chaos_step"] == 8
    assert result["param_diffs"] == []
    assert result["oracle_restarts"] == 0
    assert result["reformed_joined_group"] and result["resharding_logged"]
    assert result["topology_resumed"]["num_processes"] == 4
    assert result["topology_resumed"]["batch_shards"] == 2
    assert result["topology_after_resize"] == {5: 2, 8: 2}


def test_tool_refuses_a_fixed_data_axis_under_shrink(capsys):
    from code2vec_tpu_torch.tools import train_supervisor
    with pytest.raises(SystemExit) as e:
        train_supervisor.main(["--procs", "4", "--resize_policy", "shrink",
                               "--", "python3", "-m", "code2vec_tpu_torch",
                               "--mesh_model", "2", "--mesh_data", "2"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--mesh_data 2" in err and "cannot hold its mesh" in err


def test_saved_topology_counts_batch_shards(tmp_path):
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.setup import resume_epoch_offset
    from code2vec_tpu_torch.training import checkpoint as ckpt
    d = str(tmp_path / "ckpt")
    os.makedirs(os.path.join(d, "step_4"))
    # what rank 0 of a (data 2, model 2) cohort records (the trainer's
    # save: batch shards where fewer than the processes), less the epoch
    # so the count goes through the batch shards
    ckpt.write_step_topology(d, 4, {"num_processes": 4, "batch_shards": 2})
    assert ckpt.load_step_topology(d, 4) == {
        "step": 4, "num_processes": 4, "batch_shards": 2}
    cfg = Config(TRAIN_BATCH_SIZE=32, NUM_TRAIN_EPOCHS=3, AUTO_RESUME=True)
    cfg.load_path = d
    reformed = make_mesh(model=2, rank=0, world=2, device="cpu")
    # 96 examples at 2 batch shards: 2 steps an epoch, so step 4 ends
    # epoch 2 (at 4 shards, 1 step an epoch, it would be all 3)
    assert resume_epoch_offset(cfg, 4, lambda: 96, lambda m: None,
                               mesh=reformed) == 2


def test_copy_committed_step_links_the_step_and_copies_sidecars(tmp_path):
    src = tmp_path / "src"
    (src / "step_2" / "state").mkdir(parents=True)
    (src / "step_2" / "state" / "state.pt").write_bytes(b"\x01\x02")
    for name in ("manifest.json", "vocab.pkl"):
        (src / name).write_text(name)
    dest = tmp_path / "dest"
    chaos.copy_committed_step(str(src), str(dest), 2)
    for rel, linked in (("step_2/state/state.pt", True),
                        ("manifest.json", False), ("vocab.pkl", False)):
        a, b = src / rel, dest / rel
        assert a.read_bytes() == b.read_bytes()
        assert (os.stat(a).st_ino == os.stat(b).st_ino) == linked

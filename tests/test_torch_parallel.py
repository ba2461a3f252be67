"""The port's data axis in one process, against the JAX package where it
has a counterpart: the mesh record and its refusals, the `--dist_*` /
`--mesh_data` flags and the JAX `verify` rules in JAX's wording, the
all-three-or-none error and `_looks_multihost`, the `dist/init`
failpoint retried into a gloo group of one, the readers' host shards
against the JAX readers', the draws' row slices, `allreduce_sum_hosts`
above 2^24, the replica digest, the bring-up deadlines, and the LR
horizon over the ranks. The collectives across processes are in
tests/test_torch_multiprocess.py."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from code2vec_tpu.config import Config as JConfig
from code2vec_tpu.data.reader import open_reader as j_open_reader
from code2vec_tpu.parallel import distributed as jdist
from code2vec_tpu.training import optimizers as jopt
from code2vec_tpu.vocab.vocabularies import Code2VecVocabs as JVocabs
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data.reader import open_reader
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.parallel import compat, distributed, sharding
from code2vec_tpu_torch.parallel.mesh import AXES, make_mesh
from code2vec_tpu_torch.resilience import faults, retry
from code2vec_tpu_torch.training import optimizers as topt
from code2vec_tpu_torch.training.draws import make_draws
from code2vec_tpu_torch.training.sparse_update import (adam_lr_t,
                                                       mesh_sparse_apply,
                                                       sparse_row_adam)
from code2vec_tpu_torch.training.sparse_adam import init_row_adam
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs

CPU = torch.device("cpu")


# ---- the mesh ----

def test_mesh_spans_the_world_on_the_data_axis():
    m = make_mesh(rank=1, world=4, device="cpu")
    assert (m.dcn, m.data, m.ctx, m.model) == (1, 4, 1, 1)
    assert m.shape == dict(zip(AXES, (1, 4, 1, 1)))
    assert (m.rank, m.world, m.batch_shards, m.device) == (1, 4, 4, CPU)
    assert make_mesh(2, rank=0, world=2, device="cpu").data == 2
    assert sharding.batch_rows(m, 8) == (8, 16)
    assert make_mesh(device="cpu").world == 1  # no group: a world of one


@pytest.mark.parametrize("kw", [dict(model=2), dict(context=2), dict(dcn=2)])
def test_mesh_refuses_the_axes_not_ported(kw):
    """The model, context and dcn axes are ported (the name stays from
    when the model axis was refused): at a world of 4 the mesh takes
    data = 4 / 2 and lays the ranks out row-major over (dcn, data, ctx,
    model), as the JAX mesh reshapes its devices, so model peers are
    adjacent ranks; a world the axes do not divide is refused in the JAX
    package's words."""
    meshes = [make_mesh(rank=r, world=4, device="cpu", **kw)
              for r in range(4)]
    assert all(m.data == 2 and m.shape == dict(
        zip(AXES, (kw.get("dcn", 1), 2, kw.get("context", 1),
                   kw.get("model", 1))))
        for m in meshes)
    if "model" in kw:
        assert [(m.batch_shard, m.model_index) for m in meshes] == [
            (0, 0), (0, 1), (1, 0), (1, 1)]
        assert meshes[3].model_ranks() == (2, 3)
        assert [sharding.batch_rows(m, 8) for m in meshes] == [
            (0, 8), (0, 8), (8, 16), (8, 16)]
        assert [sharding.row_window(m, 6) for m in meshes] == [
            (0, 3), (3, 6), (0, 3), (3, 6)]
    elif "context" in kw:
        assert [(m.batch_shard, m.ctx_index) for m in meshes] == [
            (0, 0), (0, 1), (1, 0), (1, 1)]
        assert meshes[3].ctx_ranks() == (2, 3)
        assert [sharding.batch_rows(m, 8) for m in meshes] == [
            (0, 8), (0, 8), (8, 16), (8, 16)]
        assert [sharding.context_cols(m, 16) for m in meshes] == [
            (0, 8), (8, 16), (0, 8), (8, 16)]
    else:
        assert [(m.batch_shard, m.batch_shards) for m in meshes] == [
            (0, 4), (1, 4), (2, 4), (3, 4)]
        assert [m.coords[:2] for m in meshes] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]
    with pytest.raises(ValueError, match="3 devices not divisible by "
                                         "dcn\\*model\\*ctx=2"):
        make_mesh(rank=0, world=3, device="cpu", **kw)


def test_mesh_data_axis_must_be_the_world():
    with pytest.raises(ValueError, match="--mesh_data 3: the data axis needs 3"):
        make_mesh(3, rank=0, world=2, device="cpu")


def test_every_leaf_replicates():
    """Every leaf replicates but the three vocab tables, whose rows shard
    over 'model' (the JAX package's `P(MODEL_AXIS, None)`; the name stays
    from when every leaf replicated)."""
    specs = sharding.param_pspecs()
    assert {k for k, v in specs.items() if v == sharding.ROW_SHARDED} == {
        "token_emb", "path_emb", "target_emb"}
    assert {v for k, v in specs.items() if not k.endswith("_emb")} == {
        sharding.REPLICATED}


# ---- the flags and the verify rules ----

def test_dist_and_mesh_data_flags_parse():
    cfg = Config.load_from_args([
        "--data", "x", "--backend", "cpu", "--dist_coordinator",
        "127.0.0.1:1234", "--dist_num_processes", "2",
        "--dist_process_id", "1", "--mesh_data", "2"])
    assert (cfg.DIST_COORDINATOR, cfg.DIST_NUM_PROCESSES,
            cfg.DIST_PROCESS_ID, cfg.MESH_DATA_AXIS) == \
        ("127.0.0.1:1234", 2, 1, 2)
    plain = Config.load_from_args(["--data", "x", "--backend", "cpu"])
    assert (plain.DIST_COORDINATOR, plain.MESH_DATA_AXIS) == (None, 0)


@pytest.mark.parametrize("flag", [["--mesh_model", "2"],
                                  ["--mesh_context", "2"],
                                  ["--mesh_dcn", "2"], ["--ring_attention"]])
def test_later_mesh_flags_are_refused_with_the_roadmap_item(flag):
    """The model, context and dcn axes and the ring are ported: their
    flags set the JAX package's fields, as its parser does (the name
    stays from when `--mesh_model` was refused)."""
    argv = ["--data", "x", "--backend", "cpu", *flag]
    cfg = Config.load_from_args(argv)
    j = JConfig.load_from_args(["--data", "x", *flag])
    fields = ("MESH_MODEL_AXIS", "MESH_CONTEXT_AXIS", "MESH_DCN_AXIS",
              "RING_ATTENTION")
    for field in fields:
        assert getattr(cfg, field) == getattr(j, field), field
    assert tuple(getattr(cfg, f) for f in fields) != (1, 1, 1, False)


@pytest.mark.parametrize("kw", [
    dict(TABLES_DTYPE="int8", MESH_MODEL_AXIS=2),
    dict(TABLES_DTYPE="int8", MESH_CONTEXT_AXIS=2),
    dict(HEAD="varmisuse", MESH_CONTEXT_AXIS=2)])
def test_verify_rules_speak_the_jax_packages_words(kw):
    j = JConfig(**kw)
    j.train_data_path = "x"
    with pytest.raises(ValueError) as want:
        j.verify()
    with pytest.raises(ValueError) as got:
        Config(**kw).verify()
    assert str(got.value) == str(want.value)


def test_one_process_surfaces_refuse_a_world_above_one():
    """`--predict` and `--attack` at DIST_NUM_PROCESSES=2: the port's
    `Config.verify` passes both, as the JAX one does (the cohort runs
    them, rank 0 leading: serving/cohort.py)."""
    for cls in (Config, JConfig):
        for kw in (dict(), dict(ATTACK="untargeted")):
            cfg = cls(DIST_NUM_PROCESSES=2, **kw)
            cfg.is_predict = not kw
            cfg.load_path = "x"
            cfg.verify()
    Config(HEAD="varmisuse", DIST_NUM_PROCESSES=2).verify()


def test_sparse_varmisuse_step_refuses_a_mesh_as_jax_does():
    from code2vec_tpu_torch.training.optimizers import AdamF32Moments
    from code2vec_tpu_torch.training.vm_steps import make_vm_train_step
    with pytest.raises(ValueError, match="single-device only"):
        make_vm_train_step(_dims(), AdamF32Moments(0.1),
                           sparse_updates=True,
                           mesh=make_mesh(rank=0, world=2, device="cpu"))


@pytest.mark.parametrize("flags", [("h:1", None, None), (None, 2, None),
                                   (None, None, 0), ("h:1", 2, None)])
def test_all_three_or_none_in_the_jax_packages_words(flags):
    with pytest.raises(ValueError) as want:
        jdist.maybe_initialize(*flags)
    with pytest.raises(ValueError) as got:
        distributed.maybe_initialize(*flags, device_type="cpu")
    assert str(got.value) == str(want.value)


_ENV_KEYS = ("CODE2VEC_DIST_DISABLE", "JAX_COORDINATOR_ADDRESS",
             "COORDINATOR_ADDRESS", "MEGASCALE_COORDINATOR_ADDRESS",
             "TPU_WORKER_HOSTNAMES", "SLURM_STEP_NUM_TASKS", "SLURM_NTASKS",
             "SLURM_PROCID", "SLURM_STEP_NODELIST")


@pytest.mark.parametrize("env", [
    {}, {"JAX_COORDINATOR_ADDRESS": "h:1"},
    {"JAX_COORDINATOR_ADDRESS": "h:1", "CODE2VEC_DIST_DISABLE": "1"},
    {"TPU_WORKER_HOSTNAMES": "a"}, {"TPU_WORKER_HOSTNAMES": "a,b"},
    {"SLURM_NTASKS": "4"},
    {"SLURM_NTASKS": "4", "SLURM_PROCID": "1", "SLURM_STEP_NODELIST": "n"},
    {"SLURM_STEP_NUM_TASKS": "1", "SLURM_NTASKS": "4", "SLURM_PROCID": "0",
     "SLURM_STEP_NODELIST": "n"}])
def test_looks_multihost_matches_jax(env, monkeypatch):
    for k in _ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert distributed._looks_multihost() == jdist._looks_multihost()


def test_single_process_run_detects_nothing(monkeypatch):
    for k in _ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert distributed.maybe_initialize(device_type="cpu") is False
    assert distributed.backend() is None
    assert distributed.allreduce_sum_hosts([1.5, 2.0]).tolist() == [1.5, 2.0]
    assert compat.cohort_world() == (0, 1)


@pytest.mark.parametrize("device_type,local,count,want", [
    ("cpu", 2, 0, ("gloo", "cpu")),
    ("cuda", 1, 1, ("nccl", "cuda:0")),
    ("cuda", 4, 4, ("nccl", "cuda:3")),
    ("cuda", 2, 1, ("gloo", "cuda:0"))])
def test_backend_rule(device_type, local, count, want):
    name, dev, _why = distributed.choose_backend(device_type, local - 1,
                                                 local, count)
    assert (name, str(dev)) == want


def test_backend_rule_refuses_a_missing_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.choose_backend("cuda", 0, 1, 0)


def test_dist_init_failpoint_is_retried_into_a_gloo_group_of_one():
    """`dist/init` raising twice: two retries of the transient policy,
    then a world-1 gloo group whose collectives work: float64 sums exact
    above 2^24, the replica check, and mesh_sparse_apply bit-identical
    to the one-process compact apply."""
    faults.install({"sites": {"dist/init": {"action": "raise",
                                            "times": 2}}})
    before = retry.stats().get("distributed-init", {}).get("retries", 0)
    try:
        assert distributed.maybe_initialize(
            f"127.0.0.1:{compat.free_port()}", 1, 0,
            device_type="cpu") is True
    finally:
        faults.clear()
    try:
        assert retry.stats()["distributed-init"]["retries"] == before + 2
        assert distributed.backend() == "gloo"
        assert compat.cohort_world() == (0, 1)
        big = [2.0 ** 24 + 1, 2.0 ** 53 - 1, 3.0]
        assert distributed.allreduce_sum_hosts(big).tolist() == big
        mesh = make_mesh(1, device="cpu")
        params = {"w": torch.arange(6, dtype=torch.float32)}
        sharding.check_replicas(params, mesh)
        np.testing.assert_array_equal(
            distributed.fetch_global(torch.arange(4)), np.arange(4))
        gen = torch.Generator().manual_seed(0)
        table = torch.randn((20, 4), generator=gen)
        ids = torch.randint(0, 20, (12,), generator=gen, dtype=torch.int32)
        grads = torch.randn((12, 4), generator=gen)
        ref_t, ref_s = table.clone(), init_row_adam(table)
        got_t, got_s = table.clone(), init_row_adam(table)
        count = torch.ones((), dtype=torch.int32)
        sparse_row_adam(ref_t, ref_s, ids, grads, count=count, lr=0.1)
        mesh_sparse_apply(mesh, got_t, got_s,
                          [(ids[:5], grads[:5], True),
                           (ids[5:], grads[5:], False)],
                          lr_t=adam_lr_t(count, 0.1, 0.9, 0.999))
        assert torch.equal(got_t, ref_t) and torch.equal(got_s.m, ref_s.m)
    finally:
        distributed.shutdown()
    assert distributed.backend() is None


# ---- the readers' host shards ----

def _unique_target_dataset(tmpdir, n):
    """n examples with n distinct targets (the JAX multihost test's)."""
    from code2vec_tpu.data import binarize as jbin
    from code2vec_tpu.data import preprocess as jpre
    raw = os.path.join(tmpdir, "raw.txt")
    with open(raw, "w") as f:
        for i in range(n):
            f.write(f"m|{i} tok{i % 5},{1000 + i % 7},tok{i % 3}\n")
    prefix = os.path.join(tmpdir, "uniq")
    sizes = ["--word_vocab_size", "1000", "--path_vocab_size", "1000",
             "--target_vocab_size", "1000"]
    jpre.main(["--train_data", raw, "--val_data", raw, "--test_data", raw,
               "--max_contexts", "4", *sizes, "--output_name", prefix])
    jbin.main(["--data", prefix, "--max_contexts", "4", *sizes])
    return prefix


@pytest.mark.parametrize("n,shards,batch", [(64, 3, 8), (17, 2, 8)])
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "text"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_host_shards_match_the_jax_readers(tmp_path, n, shards, batch,
                                           binary, shuffle):
    """Per shard: the JAX reader's batches, example for example (the
    same targets, valid counts and padding); the shards disjoint, their
    union every example, and every shard the same number of batches."""
    prefix = _unique_target_dataset(str(tmp_path), n)
    tv = Code2VecVocabs.load_from_dict_file(prefix + ".dict.c2v", 1000, 1000,
                                            1000)
    jv = JVocabs.load_from_dict_file(prefix + ".dict.c2v", 1000, 1000, 1000)
    seen, counts = set(), set()
    for shard in range(shards):
        kw = dict(shuffle=shuffle, seed=3, keep_strings=not binary,
                  host_shard=shard, num_host_shards=shards)
        got = list(open_reader(prefix + ".train.c2v", tv, 4, batch, **kw))
        want = list(j_open_reader(prefix + ".train.c2v", jv, 4, batch, **kw))
        assert len(got) == len(want)
        counts.add(len(got))
        for g, w in zip(got, want):
            assert g.num_valid_examples == w.num_valid_examples
            np.testing.assert_array_equal(g.target_index, w.target_index)
            np.testing.assert_array_equal(g.path_indices, w.path_indices)
            np.testing.assert_array_equal(g.context_valid_mask,
                                          w.context_valid_mask)
            names = (g.target_strings[:g.num_valid_examples]
                     if g.target_strings
                     else [tv.target_vocab.lookup_word(int(i)) for i in
                           g.target_index[:g.num_valid_examples]])
            assert not seen & set(names)
            seen |= set(names)
    assert len(seen) == n and len(counts) == 1


# ---- the draws' row slices ----

def _dims(keep_rate=0.75):
    return tenc.ModelDims(token_vocab_size=30, path_vocab_size=20,
                          target_vocab_size=25, embeddings_size=4,
                          max_contexts=5, dropout_keep_rate=keep_rate)


class _StepCfg:
    use_sampled_softmax = True
    num_sampled = 6
    augment = None


def test_draws_are_the_rows_of_the_global_batchs_draws():
    dims = _dims()
    params = {"token_emb": torch.zeros(1), "path_emb": torch.zeros(1)}
    whole = make_draws(dims, _StepCfg, params, 8, 7, 3, CPU)
    for rank in range(2):
        mesh = make_mesh(rank=rank, world=2, device="cpu")
        part = make_draws(dims, _StepCfg, params, 4, 7, 3, CPU, mesh=mesh)
        assert torch.equal(part.keep, whole.keep[4 * rank:4 * rank + 4])
        assert torch.equal(part.sampled, whole.sampled)
        assert part.salts == whole.salts


@pytest.mark.parametrize("mode", ["uniform", "batch"])
def test_rename_draws_are_sliced_and_the_batch_mode_refused(mode):
    from code2vec_tpu_torch.attacks.defense import make_rename_augment
    dims = _dims(1.0)
    legal = np.zeros(dims.token_vocab_size, bool)
    legal[5:20] = True

    class Cfg(_StepCfg):
        use_sampled_softmax = False
        augment = make_rename_augment(legal, 0.5, mode=mode, device="cpu")

    params = {"token_emb": torch.zeros(1), "path_emb": torch.zeros(1)}
    whole = make_draws(dims, Cfg, params, 6, 1, 2, CPU).rename
    mesh = make_mesh(rank=1, world=2, device="cpu")
    # the batch mode is no longer refused above one rank: its donor roll
    # is the global draw's, and the rank's rows ride along for the
    # all-gathered roll (attacks/defense.py)
    part = make_draws(dims, Cfg, params, 3, 1, 2, CPU, mesh=mesh).rename
    for f in ("gumbel", "index", "apply_u"):
        assert torch.equal(getattr(part, f), getattr(whole, f)[3:6]), f
    assert part.shift == whole.shift and part.rows == (3, 6)
    assert (whole.shift > 0) == (mode == "batch") and whole.rows is None


# ---- digests, deadlines, the horizon ----

def test_replica_digest_sees_one_flipped_bit():
    a = {"t": torch.randn(50, 3), "q": {"q": torch.zeros((4, 2),
                                                         dtype=torch.int8),
                                        "s": torch.ones((4, 1))}}
    da = sharding.replica_digests(a)
    b = {"t": a["t"].clone(), "q": {"q": a["q"]["q"].clone(),
                                    "s": a["q"]["s"].clone()}}
    b["t"].view(torch.int32)[17, 1] ^= 1
    db = sharding.replica_digests(b)
    assert set(da) == {"t", "q/q", "q/s"}
    assert not torch.equal(da["t"], db["t"])
    assert torch.equal(da["q/q"], db["q/q"])


def test_bring_up_barrier_and_phase_deadline_fire_on_a_wedge():
    fired = []
    compat.first_collective_barrier(
        0.05, setup_fn=lambda: __import__("time").sleep(0.3),
        barrier_fn=lambda: None, on_timeout=lambda: fired.append("bringup"))
    assert fired == ["bringup"]
    compat.first_collective_barrier(5.0, barrier_fn=lambda: None,
                                    on_timeout=lambda: fired.append("x"))
    dl = compat.PhaseDeadline(0.05, on_timeout=fired.append)
    dl.beat("step")
    __import__("time").sleep(0.3)
    dl.beat("eval", timeout_s=5.0)
    dl.close()
    assert fired == ["bringup", "step"]


@pytest.mark.parametrize("n,b,e,hosts", [(17, 8, 2, 2), (100, 7, 3, 3),
                                         (64, 8, 1, 1)])
def test_lr_horizon_counts_the_ranks_as_jax_does(n, b, e, hosts):
    assert topt.schedule_total_steps(n, b, e, num_hosts=hosts,
                                     restored_step=5) == \
        jopt.schedule_total_steps(n, b, e, num_hosts=hosts, restored_step=5)

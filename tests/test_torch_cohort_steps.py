"""Two collectives of the port's data axis that the supervised cohort
trains through, across real gloo ranks on the CPU (tests/
test_torch_multiprocess.py's spawn helper runs `cohort_step_worker`
after its bring-up), and the phase derivation they feed:

- the gradient all-reduce probe (training/phase_probes._make_allreduce,
  the JAX package's phase_probes.py:67-93): at two ranks fed the same
  rows its tree is 2 x the backward probe's gradients, bit for bit (a
  sum of two equal float32 values is exact), and the probe leaves those
  gradients as they were; the dense kit under the mesh carries the
  all-reduce and the isolated apply, the sparse kit neither (the JAX
  kits' shapes); a profiled step at two ranks publishes `allreduce` and
  `allreduce_exposed`, within the clamp [0, allreduce];
- `allreduce_exposed` = clamp(allreduce + fused - chain - apply, 0,
  allreduce) on fixed phase times (a fake clock), exactly;
- `--adv_rename_mode batch` at 2 and 4 ranks: each rank augments its
  rows with its rows of the global draws, and the ranks' rows together
  are the one-process augment of the concatenated batch with the global
  draws, bit for bit (the donors roll across the ranks; a roll within
  each rank would differ); at two ranks the defended dense step's loss
  and params match the one-process defended step over the concatenated
  batch within the JAX bounds of tests/test_torch_multiprocess.py (loss
  rtol 1e-5, params atol 1e-5: the gradients are summed in another
  order). The one-process augment is held against the JAX augment in
  tests/test_torch_defense.py.

The workers take ~10 s in all (two spawns).
"""

import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

LR = 0.01
B, C, E = 6, 8, 16          # rows a rank, contexts, embedding width
VT, VP, VY = 48, 40, 30
SEED, STEP = 7, 3
PROB = 0.5


def _dims(keep=1.0):
    from code2vec_tpu_torch.models.encoder import ModelDims
    return ModelDims(token_vocab_size=VT, path_vocab_size=VP,
                     target_vocab_size=VY, embeddings_size=E,
                     max_contexts=C, vocab_pad_multiple=4,
                     dropout_keep_rate=keep)


def _global_batch(world):
    """The global batch of `world` ranks' rows, from a numpy seed; the
    last row padded (weight 0)."""
    r = np.random.default_rng(SEED)
    G = world * B
    mask = (r.random((G, C)) > 0.25).astype(np.float32)
    weights = np.ones((G,), np.float32)
    weights[-1] = 0.0
    return (r.integers(0, VY, G).astype(np.int32),
            r.integers(0, VT, (G, C)).astype(np.int32),
            r.integers(0, VP, (G, C)).astype(np.int32),
            r.integers(0, VT, (G, C)).astype(np.int32), mask, weights)


def _legal():
    legal = np.zeros(_dims().padded(VT), bool)
    legal[4:VT:2] = True  # every other real token renders as a name
    return legal


class _StepCfg:
    use_sampled_softmax = False
    num_sampled = 4


def _augment_cfg():
    from code2vec_tpu_torch.attacks.defense import make_rename_augment

    class Cfg(_StepCfg):
        augment = make_rename_augment(_legal(), PROB, mode="batch",
                                      device="cpu")
    return Cfg


def _params(dims):
    from code2vec_tpu_torch.models.encoder import init_params
    return init_params(torch.Generator().manual_seed(SEED), dims)


def _rows(batch, lo, hi):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[lo:hi]))
                 for a in batch)


def _defended_step(dims, cfg, mesh, seen):
    """The dense float32 step with the batch-mode augment, recording the
    augmented batch it trained on."""
    from code2vec_tpu_torch.training import optimizers as topt
    from code2vec_tpu_torch.training.steps import \
        make_train_step as make_port_step

    def augment_fn(batch, rename):
        out = cfg.augment(batch, rename)
        seen.append(out)
        return out
    opt = topt.make_optimizer(topt.make_lr(LR, "constant"), "adam")
    return make_port_step(dims, opt, augment_fn=augment_fn, mesh=mesh), opt


# ---- the workers' side ----

def _rename_on_rank(mesh):
    from code2vec_tpu_torch.ops.quant import opt_param_view
    from code2vec_tpu_torch.parallel.sharding import batch_rows
    from code2vec_tpu_torch.training.draws import make_draws
    dims, cfg = _dims(), _augment_cfg()
    params = _params(dims)
    draws = make_draws(dims, cfg, params, B, SEED, STEP, "cpu", mesh=mesh)
    local = _rows(_global_batch(mesh.world), *batch_rows(mesh, B))
    aug = cfg.augment(local, draws.rename)
    out = {"src": aug[1].numpy(), "dst": aug[3].numpy()}
    if mesh.world == 2:
        seen = []
        step, opt = _defended_step(dims, cfg, mesh, seen)
        state = opt.init(opt_param_view(params))
        loss = step(params, state, local, draws)
        out["step"] = {"loss": float(loss),
                       "src": seen[0][1].numpy(), "dst": seen[0][3].numpy(),
                       "params": {k: v.numpy() for k, v in params.items()}}
    return out


def _allreduce_probe_on_rank(mesh):
    """The dense kit under the mesh on the same rows on every rank: its
    all-reduce tree and the gradients before and after it; whether the
    kits carry an all-reduce and an apply probe."""
    from code2vec_tpu_torch.training import optimizers as topt
    from code2vec_tpu_torch.training.draws import StepDraws
    from code2vec_tpu_torch.training.phase_probes import make_code2vec_probes
    dims = _dims()
    params = _params(dims)
    opt = topt.make_optimizer(topt.make_lr(LR, "constant"), "adam")
    kit = make_code2vec_probes(dims, opt, use_kernel=False, mesh=mesh)
    batch = _rows(_global_batch(1), 0, B)  # the same rows on every rank
    draws = StepDraws(keep=None, sampled=None, salts={})
    out = None
    for _name, fn in kit.chain:
        out = fn(params, batch, draws)
    before = {k: g.clone() for k, g in out[1].items()}
    summed = kit.allreduce_fn(out)
    sparse = make_code2vec_probes(dims, topt.AdamF32Moments(LR),
                                  use_kernel=False, sparse_updates=True,
                                  mesh=mesh)
    return {"grads": {k: g.numpy() for k, g in before.items()},
            "after": {k: g.numpy() for k, g in out[1].items()},
            "summed": {k: g.numpy() for k, g in summed.items()},
            "dense_kit": (kit.apply_fn is not None, kit.derive_remainder),
            "sparse_kit": (sparse.allreduce_fn is not None,
                           sparse.apply_fn is not None)}


def _profiled_step_on_rank(mesh):
    """Two sampled steps of the dense step under the mesh: the second's
    `phase` event."""
    from code2vec_tpu_torch.obs import Telemetry
    from code2vec_tpu_torch.obs.phases import PhaseProfiler
    from code2vec_tpu_torch.ops.quant import opt_param_view
    from code2vec_tpu_torch.parallel.sharding import batch_rows
    from code2vec_tpu_torch.training import optimizers as topt
    from code2vec_tpu_torch.training.draws import make_draws
    from code2vec_tpu_torch.training.phase_probes import make_code2vec_probes
    from code2vec_tpu_torch.training.steps import \
        make_train_step as make_port_step
    dims = _dims()
    params = _params(dims)
    opt = topt.make_optimizer(topt.make_lr(LR, "constant"), "adam")
    step = make_port_step(dims, opt, use_kernel=False, mesh=mesh)
    state = opt.init(opt_param_view(params))
    events = []
    tele = Telemetry.memory("train")
    tele.sinks = [SimpleNamespace(write=events.append)]
    prof = PhaseProfiler.create(
        tele, fused_step=step, enabled=True, sample_every=1,
        probes_factory=lambda: make_code2vec_probes(
            dims, opt, use_kernel=False, mesh=mesh))
    local = _rows(_global_batch(mesh.world), *batch_rows(mesh, B))
    for s in (1, 2):
        draws = make_draws(dims, step.cfg, params, B, SEED, s, "cpu",
                           mesh=mesh)
        prof.run_split(params, state, local, draws, step=s)
    return [e for e in events if e.get("kind") == "phase"][-1]


def cohort_step_worker(rank, world, out_dir, deadline):
    from code2vec_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(world, device="cpu")
    deadline.beat("rename")
    out = {"rename": _rename_on_rank(mesh)}
    if world == 2:
        deadline.beat("allreduce_probe")
        out["probe"] = _allreduce_probe_on_rank(mesh)
        deadline.beat("profiled_step")
        out["phase_event"] = _profiled_step_on_rank(mesh)
    return out


# ---- the parent side ----

def _spawn_ranks(world, tmp_path_factory):
    from test_torch_multiprocess import _spawn
    return _spawn(world, str(tmp_path_factory.mktemp(f"cohort{world}")),
                  "test_torch_cohort_steps:cohort_step_worker")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {w: _spawn_ranks(w, tmp_path_factory) for w in (2, 4)}


def _one_process_augment(world):
    from code2vec_tpu_torch.training.draws import make_draws
    dims, cfg = _dims(), _augment_cfg()
    draws = make_draws(dims, cfg, _params(dims), world * B, SEED, STEP,
                       "cpu")
    batch = _rows(_global_batch(world), 0, world * B)
    return cfg, batch, draws, cfg.augment(batch, draws.rename)


@pytest.mark.parametrize("world", [2, 4])
def test_batch_rename_across_ranks_is_one_process_over_the_batch(
        ranks, world):
    _cfg, batch, draws, want = _one_process_augment(world)
    got_src = np.concatenate([r["rename"]["src"] for r in ranks[world]])
    got_dst = np.concatenate([r["rename"]["dst"] for r in ranks[world]])
    assert np.array_equal(got_src, want[1].numpy())
    assert np.array_equal(got_dst, want[3].numpy())
    # the test has teeth: renames happened, and a roll kept within each
    # rank's rows would give other bits
    assert not np.array_equal(got_src, batch[1].numpy())
    import dataclasses
    local = []
    for r in range(world):
        lo, hi = r * B, (r + 1) * B
        rows = tuple(t[lo:hi] for t in batch)
        d = dataclasses.replace(
            draws.rename, gumbel=draws.rename.gumbel[lo:hi],
            index=draws.rename.index[lo:hi],
            apply_u=draws.rename.apply_u[lo:hi],
            shift=1 + draws.rename.shift % (B - 1))
        local.append(_cfg.augment(rows, d)[1].numpy())
    assert not np.array_equal(np.concatenate(local), got_src)


def test_defended_step_at_two_ranks_matches_one_process(ranks):
    from code2vec_tpu_torch.ops.quant import opt_param_view
    cfg, batch, draws, want = _one_process_augment(2)
    dims = _dims()
    params = _params(dims)
    seen = []
    step, opt = _defended_step(dims, cfg, None, seen)
    loss = step(params, opt.init(opt_param_view(params)), batch, draws)
    got = [r["rename"]["step"] for r in ranks[2]]
    assert got[0]["loss"] == got[1]["loss"]
    np.testing.assert_allclose(got[0]["loss"], float(loss), rtol=1e-5)
    # the step trained on the one-process augment's rows
    assert np.array_equal(np.concatenate([g["src"] for g in got]),
                          seen[0][1].numpy())
    assert np.array_equal(np.concatenate([g["dst"] for g in got]),
                          seen[0][3].numpy())
    for k, v in params.items():
        assert np.array_equal(got[0]["params"][k], got[1]["params"][k]), k
        np.testing.assert_allclose(got[0]["params"][k], v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_allreduce_probe_is_world_times_the_grads(ranks):
    for r in ranks[2]:
        p = r["probe"]
        assert p["dense_kit"] == (True, False)
        assert p["sparse_kit"] == (False, False)
        assert p["grads"].keys() == p["summed"].keys()
        for k, g in p["grads"].items():
            assert np.array_equal(p["summed"][k], 2 * g), k
            assert np.array_equal(p["after"][k], g), k
    a, b = (r["probe"]["grads"] for r in ranks[2])
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_profiled_step_at_two_ranks_reports_the_allreduce_pair(ranks):
    for r in ranks[2]:
        ev = r["phase_event"]
        for phase in ("embed_gather", "concat_dense", "forward_pool",
                      "backward", "table_apply", "allreduce",
                      "allreduce_exposed"):
            assert f"{phase}_ms" in ev, (phase, ev)
        assert 0.0 <= ev["allreduce_exposed_ms"] <= ev["allreduce_ms"]
        assert ev["allreduce_ms"] > 0


def test_allreduce_single_rank_kit_has_no_allreduce():
    """At a world of one (a mesh of one rank, or none) the dense kit is
    the one-device kit: no all-reduce, the apply as the remainder."""
    from code2vec_tpu_torch.parallel.mesh import make_mesh
    from code2vec_tpu_torch.training import optimizers as topt
    from code2vec_tpu_torch.training.phase_probes import make_code2vec_probes
    opt = topt.make_optimizer(topt.make_lr(LR, "constant"), "adam")
    for mesh in (None, make_mesh(1, rank=0, world=1, device="cpu")):
        kit = make_code2vec_probes(_dims(), opt, use_kernel=False,
                                   mesh=mesh)
        assert kit.allreduce_fn is None and kit.apply_fn is None
        assert kit.derive_remainder


# (cumulative chain ms, apply ms, allreduce ms, fused ms) -> exposed ms
EXPOSED_CASES = {
    "partly_hidden": ((1.0, 3.0, 6.0, 10.0), 2.0, 4.0, 14.0, 4.0),
    "half_exposed": ((1.0, 3.0, 6.0, 10.0), 2.0, 4.0, 10.0, 2.0),
    "fully_hidden": ((1.0, 3.0, 6.0, 10.0), 2.0, 4.0, 7.0, 0.0),
}


@pytest.mark.parametrize("case", list(EXPOSED_CASES))
def test_allreduce_exposed_is_the_clamped_formula(case, monkeypatch):
    """clamp(allreduce + fused - chain - apply, 0, allreduce) on fixed
    phase times: each probe advances a fake clock by its time.
    Tolerance: exact (the times are binary fractions)."""
    from code2vec_tpu_torch.obs import Telemetry
    from code2vec_tpu_torch.obs import phases as phases_mod
    cum, apply_ms, ar_ms, fused_ms, want = EXPOSED_CASES[case]
    now = [0.0]

    def advance(ms):
        now[0] += ms / 1e3
        return torch.zeros(())

    clock = SimpleNamespace(perf_counter=lambda: now[0],
                            monotonic=lambda: now[0])
    monkeypatch.setattr(phases_mod, "time", clock)
    names = ("embed_gather", "concat_dense", "forward_pool", "backward")
    chain = [(n, (lambda t: lambda *_a: advance(t))(t))
             for n, t in zip(names, cum)]
    kit = phases_mod.ProbeKit(
        chain, apply_fn=lambda *_a: advance(apply_ms),
        allreduce_fn=lambda *_a: advance(ar_ms), derive_remainder=False)
    events = []
    tele = Telemetry.memory("train")
    tele.sinks = [SimpleNamespace(write=events.append)]
    prof = phases_mod.PhaseProfiler(
        tele, fused_step=lambda *_a: advance(fused_ms),
        probes_factory=lambda: kit, sample_every=1)
    prof.run_split(None, None, None, None, step=1)
    (ev,) = [e for e in events if e["kind"] == "phase"]
    assert ev["allreduce_ms"] == ar_ms and ev["table_apply_ms"] == apply_ms
    assert ev["allreduce_exposed_ms"] == want
    formula = min(ar_ms, max(0.0, ar_ms + fused_ms - cum[-1] - apply_ms))
    assert want == formula

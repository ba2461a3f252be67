"""The port's context and dcn mesh axes across real processes, against
the JAX package's one-device step.

Gloo workers spawned by this file's fixtures (tests/
test_torch_multiprocess.py's `_spawn`, one spawn a world size) hold the
rows of their batch shard and the contexts of their ctx index of one
global batch, with the matching slice of the global dropout keep mask
(drawn on the JAX side as its step draws it), and run the port's dense
step under the mesh:

- (data 1, ctx 2) at two ranks and (data 2, ctx 2) at four: the
  transformer with the ring (`--ring_attention`), the transformer with q,
  k, v all-gathered into `fused_mha`, and the bag encoder (its contexts
  all-gathered into the pool); (dcn 2, data 1, ctx 1) at two ranks: the
  bag encoder. Each is held to the JAX package's one-device
  `make_train_step` over the same params (carried with convert.py) and
  the same global batch: the loss to `rtol 1e-5` and every leaf's raw
  gradient (the port's world-summed one against `jax.value_and_grad` of
  the step's loss) to `atol 2e-5`, the JAX package's bounds for its own
  context-parallel step (tests/test_transformer.py), and every param
  after one step to `atol 2e-5` of the JAX step's, except where Adam's
  first step is ill-conditioned. That step moves a param by lr * g /
  (|g| + eps), eps = 1e-8: where the JAX gradient is below 100 eps, a
  difference in the last bits of a sum that nearly cancels moves the
  update by up to lr (the tables take Adafactor, whose factored
  statistics do not amplify so; the one-process port and the JAX step already
  differ by 1.3e-4 on one element of `xf/layers/1/mlp_up` of the ring
  case's inputs, a gradient of 4.9e-8 against 4.3e-8, and the ring's
  reordered sums by 8.5e-5). Those elements (a nonzero gradient below
  100 eps), at most 0.1 % of a leaf, are held within lr + 2e-5 instead. The batch has a row whose second
  half of contexts is padding (a whole shard at ctx 2) and a row with no
  live context.
- the trainer: an evaluation at (data 2, ctx 2) whose merged results and
  example count equal one process's; two steps at `--mesh_dcn 2`; a
  two-rank `cli.main` run with `--mesh_context 2 --ring_attention` and
  the `--dist_*` flags (train, evaluate, save), whose merged evaluation
  counts the one-process `num_examples` and equals a one-process `--load`
  of its checkpoint.

The config rules, the sparse step's refusal in the JAX package's words
and the supervisor's shrink of a context cohort by its mesh run here in the
parent.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import pytest

LR = 0.01
G, C, E = 8, 8, 16          # global rows, contexts, embedding width
VT, VP, VY = 48, 40, 30
KEEP = 0.75
# name: (encoder, ring attention)
CASES = {"xf_ring": ("transformer", True),
         "xf_gather": ("transformer", False),
         "bag": ("bag", False)}
# world -> [(layout, mesh axes, cases)]
LAYOUTS = {2: [("ctx2", dict(data=1, context=2, dcn=1), list(CASES)),
               ("dcn2", dict(data=1, context=1, dcn=2), ["bag"])],
           4: [("data2_ctx2", dict(data=2, context=2, dcn=1), list(CASES))]}
STEP_CASES = [(layout, case) for w in LAYOUTS for layout, _a, cases
              in LAYOUTS[w] for case in cases]
WORLD_OF = {layout: w for w in LAYOUTS for layout, _a, _c in LAYOUTS[w]}


def _dims(module, case):
    encoder, ring = CASES[case]
    return module.ModelDims(token_vocab_size=VT, path_vocab_size=VP,
                            target_vocab_size=VY, embeddings_size=E,
                            max_contexts=C, vocab_pad_multiple=4,
                            dropout_keep_rate=KEEP, encoder_type=encoder,
                            xf_layers=2, xf_heads=2, ring_attention=ring)


def _trainer_config(prefix, **kw):
    from test_torch_multiprocess import _trainer_config as base
    cfg = base(prefix)
    for k, v in {"ENCODER_TYPE": "transformer", "XF_LAYERS": 1,
                 "XF_HEADS": 2, **kw}.items():
        setattr(cfg, k, v)
    return cfg


# ---- the workers (run by tests/test_torch_multiprocess.py's worker) ----

def _port_case(inp, case, mesh):
    """(loss, world-summed raw grads, step loss, params after the step) of
    this rank's share of one dense step."""
    import torch

    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.models import encoder as tenc
    from code2vec_tpu_torch.ops.quant import opt_param_view
    from code2vec_tpu_torch.parallel.sharding import (batch_rows,
                                                      check_replicas,
                                                      context_cols,
                                                      local_contexts)
    from code2vec_tpu_torch.training import optimizers as topt
    from code2vec_tpu_torch.training.draws import StepDraws
    from code2vec_tpu_torch.training.sparse_steps import reduce_step_grads
    from code2vec_tpu_torch.training.steps import (dense_loss_and_grads,
                                                   make_train_loss_fn)
    from code2vec_tpu_torch.training.steps import \
        make_train_step as port_train_step
    dims = _dims(tenc, case)
    rows = slice(*batch_rows(mesh, G // mesh.batch_shards))
    cols = slice(*context_cols(mesh, C))
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                  local_contexts(mesh, tuple(a[rows] for a in inp["batch"])))
    draws = StepDraws(keep=torch.from_numpy(np.ascontiguousarray(
        inp["keep"][rows, cols])), sampled=None, salts={})

    def params():
        return convert.params_from_numpy(
            pickle.loads(pickle.dumps(inp["params"])), "cpu")

    p = params()
    loss, grads, _view = dense_loss_and_grads(
        p, batch, draws, make_train_loss_fn(dims, mesh=mesh))
    loss = reduce_step_grads(loss, grads, mesh)
    p = params()
    opt = topt.make_optimizer(topt.make_lr(LR, "cosine", 10))
    step = port_train_step(dims, opt, mesh=mesh)
    step_loss = step(p, opt.init(opt_param_view(p)), batch, draws)
    check_replicas(p, mesh)
    return {"loss": float(loss), "step_loss": float(step_loss),
            "grads": {k: g.numpy() for k, g in grads.items()},
            "params": convert.params_to_numpy(p)}


def _rename_draws(seed=7):
    """A global batch-mode rename's draws (numpy): the slot choice's
    Gumbel noise [G, 2C], the fallback index [G], the apply uniforms
    [G] and the donor roll; the legal token mask (ids 0 and 1 not)."""
    r = np.random.default_rng(seed)
    legal = np.ones((VT,), bool)
    legal[:2] = False
    return {"gumbel": -np.log(-np.log(r.uniform(1e-6, 1.0, (G, 2 * C))))
            .astype(np.float32),
            "index": r.integers(0, VT - 2, G), "apply_u":
            r.random(G).astype(np.float32), "shift": 3, "legal": legal}


def _rename(inp, mesh):
    """This rank's batch through the dense step's rename (`steps.
    augmented`, batch mode) with its rows of the global draws: the
    augmented src and dst of its rows and contexts."""
    import torch

    from code2vec_tpu_torch.attacks.defense import (RenameDraws,
                                                    make_rename_augment)
    from code2vec_tpu_torch.parallel.sharding import (batch_rows,
                                                      local_contexts)
    from code2vec_tpu_torch.training.steps import augmented
    d = inp["rename"]
    rows = batch_rows(mesh, G // mesh.batch_shards)
    sl = slice(*rows)
    draws = RenameDraws(
        gumbel=torch.from_numpy(d["gumbel"][sl]),
        index=torch.from_numpy(d["index"][sl]),
        apply_u=torch.from_numpy(d["apply_u"][sl]), shift=d["shift"],
        rows=rows, ctx=mesh.ctx)
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                  local_contexts(mesh, tuple(a[sl] for a in
                                             inp["bag"]["batch"])))
    aug = make_rename_augment(d["legal"], 0.5, mode="batch", device="cpu")
    got = augmented(aug, batch, draws, mesh)
    return got[1].numpy(), got[3].numpy()


def _profiled(inp, mesh):
    """One sampled step of the bag's dense step under the ctx mesh
    through the phase profiler (its probes run the ctx collectives on
    every rank in the same order): the `phase` event, and whether the
    params are the bits of the same step unprofiled."""
    from types import SimpleNamespace

    import torch

    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.models import encoder as tenc
    from code2vec_tpu_torch.obs import Telemetry
    from code2vec_tpu_torch.obs.phases import PhaseProfiler
    from code2vec_tpu_torch.ops.quant import opt_param_view
    from code2vec_tpu_torch.parallel.sharding import context_cols
    from code2vec_tpu_torch.training import optimizers as topt
    from code2vec_tpu_torch.training.draws import StepDraws
    from code2vec_tpu_torch.training.phase_probes import make_code2vec_probes
    from code2vec_tpu_torch.training.steps import \
        make_train_step as port_train_step
    dims = _dims(tenc, "bag")
    cols = slice(*context_cols(mesh, C))
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a[:, cols]
                                                        if a.ndim == 2
                                                        else a))
                  for a in inp["batch"])
    draws = StepDraws(keep=torch.from_numpy(np.ascontiguousarray(
        inp["keep"][:, cols])), sampled=None, salts={})
    opt = topt.make_optimizer(topt.make_lr(LR, "cosine", 10))
    step = port_train_step(dims, opt, mesh=mesh)
    runs = []
    for profiled in (True, False):
        params = convert.params_from_numpy(
            pickle.loads(pickle.dumps(inp["params"])), "cpu")
        state = opt.init(opt_param_view(params))
        events = []
        if profiled:
            tele = Telemetry.memory("train")
            tele.sinks = [SimpleNamespace(write=events.append)]
            PhaseProfiler.create(
                tele, fused_step=step, enabled=True, sample_every=1,
                probes_factory=lambda: make_code2vec_probes(
                    dims, opt, mesh=mesh)).run_split(params, state, batch,
                                                     draws, step=1)
        else:
            step(params, state, batch, draws)
        runs.append((events, dict(_flat(convert.params_to_numpy(params)))))
    (events, a), (_e, b) = runs
    return {"event": [e for e in events if e.get("kind") == "phase"][-1],
            "same_bits": all(np.array_equal(a[k], b[k]) for k in a)}


def _counting_results(setattr_fn=setattr):
    """Patch `MetricAccumulator.results` (through `setattr_fn`: a test's
    `monkeypatch.setattr`, plain `setattr` in a worker) to record each
    evaluation's example count and results -> the list they go to."""
    from code2vec_tpu_torch.models import model_base
    seen = []
    real = model_base.MetricAccumulator.results

    def results(self):
        out = real(self)
        seen.append((self.num_examples, out))
        return out

    setattr_fn(model_base.MetricAccumulator, "results", results)
    return seen


def ctx_worker(rank, world, out_dir, deadline):
    """Every layout of `world`: its step cases, then the trainer phases;
    at two ranks the command-line run last (cli.main leaves the group)."""
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.parallel.mesh import make_mesh
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    prefix = inputs["prefix"]
    seen = _counting_results()
    out = {}
    for layout, axes, cases in LAYOUTS[world]:
        mesh = make_mesh(axes["data"], context=axes["context"],
                         dcn=axes["dcn"], device="cpu")
        for case in cases:
            deadline.beat(f"{layout}/{case}")
            out[(layout, case)] = _port_case(inputs[case], case, mesh)
        out[(layout, "rename")] = _rename(inputs, mesh)
        if layout == "ctx2":
            deadline.beat("profiled")
            out["profiled"] = _profiled(inputs["bag"], mesh)
    if world == 4:
        deadline.beat("evaluate")
        trainer = Code2VecTrainer.from_config(
            _trainer_config(prefix, MESH_DATA_AXIS=2, MESH_CONTEXT_AXIS=2,
                            RING_ATTENTION=True), device="cpu")
        trainer.evaluate()
        out["evaluate"] = seen[-1]
        out["host_shard"] = trainer.host_shard()
        if rank == 0:
            # the writing rank exports alone, without the ctx collectives
            deadline.beat("export")
            trainer.export_code_vectors_file(
                prefix + ".val.c2v", os.path.join(out_dir, "vectors"))
        return out
    deadline.beat("dcn trainer")
    trainer = Code2VecTrainer.from_config(
        _trainer_config(prefix, ENCODER_TYPE="bag", MESH_DCN_AXIS=2),
        device="cpu")
    out["dcn_losses"] = trainer.train(prefix + ".train.c2v", max_steps=2)
    out["dcn_shard"] = trainer.host_shard()
    deadline.beat("cli", timeout_s=120.0)
    from code2vec_tpu_torch import cli
    port = sys.argv[3]  # this worker's coordinator port
    rc = cli.main([
        "--backend", "cpu", "--data", prefix, "--test",
        prefix + ".val.c2v", "--save", os.path.join(out_dir, "cli_ckpt"),
        "--max_contexts", "16", "--batch_size", "8", "--epochs", "1",
        "--async_checkpoint", "off", "--no_bf16", "--encoder",
        "transformer", "--xf_layers", "1", "--mesh_context", "2",
        "--ring_attention", "--dist_coordinator", f"127.0.0.1:{port}",
        "--dist_num_processes", str(world), "--dist_process_id",
        str(rank)])
    out["cli"] = {"rc": rc, "eval": seen[-1]}
    return out


# ---- the parent side ----

def _jax_case(case, seed):
    """The JAX params, the global batch, the keep mask of the JAX step's
    draws, its loss, raw grads and params after one step."""
    import jax
    import jax.numpy as jnp

    from code2vec_tpu.models import encoder as jenc
    from code2vec_tpu.ops.quant import opt_param_view
    from code2vec_tpu.training import optimizers as jopt
    from code2vec_tpu.training.steps import make_train_loss_fn
    from code2vec_tpu.training.steps import make_train_step as jax_train_step
    jd = _dims(jenc, case)
    r = np.random.default_rng(seed + 1)
    weights = np.ones((G,), np.float32)
    weights[-1] = 0.0
    mask = (r.random((G, C)) > 0.3).astype(np.float32)
    mask[1, C // 2:] = 0.0    # a shard of padding at ctx 2
    mask[2, :] = 0.0          # no live context
    batch = (r.integers(0, VY, G).astype(np.int32),
             r.integers(0, VT, (G, C)).astype(np.int32),
             r.integers(0, VP, (G, C)).astype(np.int32),
             r.integers(0, VT, (G, C)).astype(np.int32), mask, weights)
    params = jenc.init_params(jax.random.PRNGKey(seed), jd)
    rng = jax.random.PRNGKey(100 + seed)
    drop_rng, _sample_rng = jax.random.split(rng)
    keep = np.array(jax.random.bernoulli(drop_rng, KEEP, (G, C, 3 * E)))
    jb = tuple(jnp.asarray(a) for a in batch)
    # jitted, as the step differentiates it (and eager op-by-op is slow)
    loss_and_grads = jax.jit(jax.value_and_grad(make_train_loss_fn(jd)))
    loss, grads = loss_and_grads(params, jb, rng)
    tx = jopt.make_optimizer(jopt.make_lr(LR, "cosine", 10))
    host = jax.tree_util.tree_map(np.asarray, params)
    after, _s, step_loss = jax_train_step(jd, tx)(
        params, tx.init(opt_param_view(params)), jb, rng)
    return {"params": host, "batch": batch, "keep": keep,
            "loss": float(loss), "step_loss": float(step_loss),
            "grads": jax.tree_util.tree_map(np.asarray, grads),
            "after": jax.tree_util.tree_map(np.asarray, after)}


@pytest.fixture(scope="module")
def ctx_ranks(tmp_path_factory):
    from helpers import build_tiny_dataset
    from test_torch_multiprocess import _spawn
    base = tmp_path_factory.mktemp("torch_ctx")
    jax_side = {case: _jax_case(case, i) for i, case in enumerate(CASES)}
    prefix = build_tiny_dataset(str(base), n_train=40, n_val=13, n_test=8,
                                max_contexts=16)
    ranks = {}
    for world in LAYOUTS:
        out_dir = str(base / f"w{world}")
        os.makedirs(out_dir)
        host = {case: {k: v[k] for k in ("params", "batch", "keep")}
                for case, v in jax_side.items()}
        host["prefix"] = prefix
        host["rename"] = _rename_draws()
        with open(os.path.join(out_dir, "inputs.pkl"), "wb") as f:
            pickle.dump(host, f)
        ranks[world] = _spawn(world, out_dir,
                              "test_torch_context_parallel:ctx_worker")
    return jax_side, ranks, prefix, str(base)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _close(got, want, atol=2e-5):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_allclose(g[k].astype(np.float64),
                                   w[k].astype(np.float64), rtol=0,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("layout,case", STEP_CASES)
def test_ctx_step_loss_and_raw_gradients_match_one_jax_device(
        ctx_ranks, layout, case):
    """The world's loss and world-summed raw gradients on every rank:
    the JAX one-device loss to rtol 1e-5, each leaf's gradient to 2e-5
    (a factor of ctx in a gradient would show here even where Adam's
    update hides it)."""
    jax_side, ranks, _p, _b = ctx_ranks
    want = jax_side[case]
    for r in ranks[WORLD_OF[layout]]:
        got = r[(layout, case)]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        _close(got["grads"], want["grads"])


ADAM_EPS = 1e-8


def _close_after_step(got, want, grads):
    """Params after one step: within 2e-5, or within lr + 2e-5 where Adam
    updates a leaf whose JAX gradient is nonzero and below 100 eps (the
    module docstring), on at most 0.1 % of the leaf."""
    g, w, d = dict(_flat(got)), dict(_flat(want)), dict(_flat(grads))
    assert g.keys() == w.keys()
    for k in w:
        # Adafactor updates the tables, Adam the rest; a zero gradient
        # (an unused leaf) moves nothing
        ill = (np.abs(d[k]) < 100 * ADAM_EPS) & (d[k] != 0) & (
            k not in ("token_emb", "path_emb", "target_emb"))
        assert ill.mean() <= 1e-3, k
        diff = np.abs(g[k].astype(np.float64) - w[k].astype(np.float64))
        assert diff[~ill].max(initial=0.0) <= 2e-5, k
        assert diff[ill].max(initial=0.0) <= LR + 2e-5, k


@pytest.mark.parametrize("layout,case", STEP_CASES)
def test_ctx_step_params_match_one_jax_device(ctx_ranks, layout, case):
    """One step through the port's `make_train_step` under the mesh: the
    loss to rtol 1e-5 and every param to 2e-5 of the JAX step's (Adam's
    ill-conditioned elements as the module docstring says); the ranks'
    params the same bits."""
    jax_side, ranks, _p, _b = ctx_ranks
    want = jax_side[case]
    got = [r[(layout, case)] for r in ranks[WORLD_OF[layout]]]
    for g in got:
        np.testing.assert_allclose(g["step_loss"], want["step_loss"],
                                   rtol=1e-5)
        _close_after_step(g["params"], want["after"], want["grads"])
    first = dict(_flat(got[0]["params"]))
    for g in got[1:]:
        assert all(np.array_equal(first[k], v)
                   for k, v in _flat(g["params"]))


def test_export_on_the_writing_rank_alone_keeps_every_context(ctx_ranks,
                                                              tmp_path):
    """`--export_code_vectors` under (data 2, ctx 2): rank 0 alone writes
    the vectors, encoding every context without the ctx group (the other
    ranks are not there to answer), the text equal to one process's."""
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    _j, _r, prefix, base = ctx_ranks
    trainer = Code2VecTrainer.from_config(_trainer_config(prefix),
                                          device="cpu")
    dest = str(tmp_path / "vectors")
    trainer.export_code_vectors_file(prefix + ".val.c2v", dest)
    with open(dest) as f, open(os.path.join(base, "w4", "vectors")) as g:
        want, got = f.read(), g.read()
    assert got == want and len(want.splitlines()) == 13


@pytest.mark.parametrize("layout", [n for w in LAYOUTS
                                    for n, _a, _c in LAYOUTS[w]])
def test_batch_rename_under_the_mesh_is_one_process_augment(ctx_ranks,
                                                           layout):
    """The rename defense in batch mode under the mesh: each rank's
    augmented rows and contexts are the one-process augment's of the
    global batch with the global draws, bit for bit (the augment runs on
    the rows' whole contexts, gathered over the ctx group, and the donor
    roll over one copy of each batch shard's rows)."""
    import torch

    from code2vec_tpu_torch.attacks.defense import (RenameDraws,
                                                    make_rename_augment)
    from code2vec_tpu_torch.parallel.mesh import make_mesh
    from code2vec_tpu_torch.parallel.sharding import (batch_rows,
                                                      context_cols)
    jax_side, ranks, _p, _b = ctx_ranks
    d = _rename_draws()
    batch = tuple(torch.from_numpy(a) for a in jax_side["bag"]["batch"])
    aug = make_rename_augment(d["legal"], 0.5, mode="batch", device="cpu")
    want = aug(batch, RenameDraws(
        gumbel=torch.from_numpy(d["gumbel"]),
        index=torch.from_numpy(d["index"]),
        apply_u=torch.from_numpy(d["apply_u"]), shift=d["shift"]))
    src, dst = want[1].numpy(), want[3].numpy()
    assert (src != batch[1].numpy()).any() or (dst != batch[3].numpy()).any()
    world = WORLD_OF[layout]
    axes = next(a for n, a, _c in LAYOUTS[world] if n == layout)
    for rank, r in enumerate(ranks[world]):
        mesh = make_mesh(axes["data"], context=axes["context"],
                         dcn=axes["dcn"], rank=rank, world=world,
                         device="cpu")
        rows = slice(*batch_rows(mesh, G // mesh.batch_shards))
        cols = slice(*context_cols(mesh, C))
        got_src, got_dst = r[(layout, "rename")]
        assert np.array_equal(got_src, src[rows, cols])
        assert np.array_equal(got_dst, dst[rows, cols])


def test_phase_profiler_runs_its_probes_under_a_ctx_mesh(ctx_ranks):
    """`--phase_profile` under (data 1, ctx 2): the sampled step's probes
    (embed_gather, concat_dense on the rank's contexts, forward_pool and
    backward through the ctx collectives, the all-reduce and the apply)
    run on both ranks, and the state update is the fused step's: the
    params the bits of the unprofiled step."""
    _j, ranks, _p, _b = ctx_ranks
    for r in ranks[2]:
        ev = r["profiled"]["event"]
        for phase in ("embed_gather", "concat_dense", "forward_pool",
                      "backward", "table_apply", "allreduce",
                      "allreduce_exposed"):
            assert f"{phase}_ms" in ev, (phase, ev)
        assert r["profiled"]["same_bits"]


def _one_process_eval(cfg, monkeypatch):
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    seen = _counting_results(monkeypatch.setattr)
    Code2VecTrainer.from_config(cfg, device="cpu").evaluate()
    return seen[-1]


def _same_eval(got, want):
    (n_got, r_got), (n_want, r_want) = got, want
    assert n_got == n_want
    assert r_got.topk_acc == pytest.approx(r_want.topk_acc, abs=1e-6)
    assert r_got.subtoken_f1 == pytest.approx(r_want.subtoken_f1, abs=1e-6)
    assert r_got.loss == pytest.approx(r_want.loss, rel=1e-5)


def test_ctx_evaluation_counts_each_example_once(ctx_ranks, monkeypatch):
    """(data 2, ctx 2): the batch shards read halves of the file, the
    ctx peers the same half; the merged results and example count equal
    one process's evaluation of the same seeded params."""
    _j, ranks, prefix, _b = ctx_ranks
    one = _one_process_eval(_trainer_config(prefix), monkeypatch)
    assert one[0] == 13
    assert [r["host_shard"] for r in ranks[4]] == [(0, 2), (0, 2), (1, 2),
                                                   (1, 2)]
    for r in ranks[4]:
        _same_eval(r["evaluate"], one)


def test_dcn_axis_trains_on_two_ranks(ctx_ranks):
    """`--mesh_dcn 2` (MESH_DCN_AXIS): two batch shards, the same losses
    on both ranks."""
    _j, ranks, _p, _b = ctx_ranks
    a, b = ranks[2]
    assert (a["dcn_shard"], b["dcn_shard"]) == ((0, 2), (1, 2))
    assert len(a["dcn_losses"]) == 2 and a["dcn_losses"] == b["dcn_losses"]
    assert np.all(np.isfinite(a["dcn_losses"]))


def test_cli_ring_run_on_two_ranks_then_one_process_load(ctx_ranks,
                                                        monkeypatch):
    """`cli.main` with `--mesh_context 2 --ring_attention --dist_*` on two
    ranks trains an epoch, evaluates (13 examples, counted once) and
    saves from rank 0; `--load` of that checkpoint in one process (the
    ring flag ignored there) evaluates to the same results."""
    from code2vec_tpu_torch import cli
    import json
    _j, ranks, prefix, base = ctx_ranks
    a, b = ranks[2]
    assert a["cli"]["rc"] == 0 and b["cli"]["rc"] == 0
    ckpt = os.path.join(base, "w2", "cli_ckpt")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        assert json.load(f)["ring_attention"] is True
    seen = _counting_results(monkeypatch.setattr)
    assert cli.main(["--backend", "cpu", "--load", ckpt, "--test",
                     prefix + ".val.c2v", "--no_bf16"]) == 0
    assert seen[-1][0] == 13
    for r in (a, b):
        _same_eval(r["cli"]["eval"], seen[-1])


# ---- the rules, in one process ----

def test_mesh_context_must_divide_max_contexts():
    from code2vec_tpu_torch.config import Config
    with pytest.raises(ValueError, match="--mesh_context 3 does not "
                                         "divide MAX_CONTEXTS \\(200"):
        Config(MESH_CONTEXT_AXIS=3).verify()
    Config(MESH_CONTEXT_AXIS=4).verify()


def test_mesh_model_is_refused_naming_item_5b():
    """The model axis is ported (the name stays from when it was
    refused); int8 tables under it are refused in the JAX package's
    words."""
    from code2vec_tpu.config import Config as JaxConfig
    from code2vec_tpu_torch.config import Config
    Config(MESH_MODEL_AXIS=2).verify()
    argv = ["--data", "x", "--tables_dtype", "int8", "--mesh_model", "2"]
    with pytest.raises(ValueError) as want:
        JaxConfig.load_from_args(argv)
    with pytest.raises(ValueError) as got:
        Config.load_from_args(argv)
    assert "int8" in str(want.value)
    assert str(got.value) == str(want.value)


def test_sparse_step_refuses_a_ctx_mesh_in_the_jax_words():
    """The JAX package's mesh sparse apply refuses ctx != 1; the port's
    sparse step says the same when it is built, before any step."""
    import jax.numpy as jnp

    from code2vec_tpu.parallel.mesh import make_mesh as jax_mesh
    from code2vec_tpu.training.sparse_update import mesh_sparse_apply
    from code2vec_tpu_torch.models import encoder as tenc
    from code2vec_tpu_torch.parallel.mesh import Mesh
    from code2vec_tpu_torch.training.optimizers import AdamF32Moments
    from code2vec_tpu_torch.training.steps import \
        make_train_step as port_train_step
    import torch
    with pytest.raises(ValueError) as want:
        mesh_sparse_apply(jax_mesh(4, 1, 2), jnp.zeros((4, 2)), None, [],
                          count=jnp.zeros((), jnp.int32), lr=0.1)
    mesh = Mesh(dcn=1, data=4, ctx=2, model=1, rank=0, world=8,
                device=torch.device("cpu"))
    with pytest.raises(ValueError) as got:
        port_train_step(_dims(tenc, "bag"), AdamF32Moments(0.1),
                        sparse_updates=True, mesh=mesh)
    assert str(got.value) == str(want.value)


def test_a_ctx_collective_without_its_group_raises():
    """A ctx mesh made without a process group has no ctx peers: the
    encoder raises instead of running the one-process step."""
    import torch

    from code2vec_tpu_torch.models import encoder as tenc
    from code2vec_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(context=2, rank=0, world=2, device="cpu")
    dims = _dims(tenc, "bag")
    params = tenc.init_params(torch.Generator().manual_seed(0), dims)
    ids = torch.zeros((2, C // 2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no process group of ctx peers"):
        tenc.encode(params, ids, ids, ids, torch.ones((2, C // 2)),
                    mesh=mesh)


def test_supervisor_shrinks_a_ctx_cohort_by_its_mesh(capsys,
                                                     monkeypatch):
    """`--resize_policy shrink` over a `--mesh_context 2` child: the tool steps
    by the child's dcn * model * ctx = 2 processes, so a cohort of 2 has
    no smaller size (a death relaunches it whole, as the start-up line
    says) and a cohort of 4 re-forms at 2."""
    from torch_helpers import supervisor_tool_plan
    child = ["--", "python3", "-m", "code2vec_tpu_torch", "--mesh_context", "2"]
    rc, sup, out = supervisor_tool_plan(
        monkeypatch, capsys,
        ["--procs", "2", "--resize_policy", "shrink", *child])
    assert rc == 0 and sup.group == 2 and sup.shrink_sizes() == []
    assert sup._next_cohort_size("peer_death") == 2
    assert ("shrink in steps of 2 process(es) (the child's dcn * model * "
            "ctx), floor 1: no smaller cohort than 2 holds the child's "
            "mesh, so a death relaunches the whole cohort") in out
    rc, sup, out = supervisor_tool_plan(
        monkeypatch, capsys,
        ["--procs", "4", "--resize_policy", "shrink", *child])
    assert rc == 0 and sup._next_cohort_size("peer_death") == 2
    assert "a dead member re-forms the cohort at 2 process(es)" in out

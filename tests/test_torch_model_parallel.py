"""The port's model mesh axis across real processes, against the JAX
package's one-device step.

Gloo workers spawned by this file's fixture (tests/
test_torch_multiprocess.py's `_spawn`, one spawn a world size) hold the
rows of their batch shard, the contexts of their ctx index and the
window of rows of every table that their model index owns (the whole
params drawn on the JAX side, padded to a multiple of 2 as the JAX
package pads them for a model axis of 2, then cut by
`parallel/sharding.shard_params`), with the matching slice of the global
dropout keep mask and the global sampled ids (drawn on the JAX side as
its step draws them), and run the port's steps under the mesh:

- (data 1, model 2) at two ranks: the bag's dense step with Adafactor
  and the full softmax, the same with sampled softmax, the bag's
  sparse-row step (sampled softmax, row Adam on each table's window
  through kernel 5's plain rows) and the transformer's dense step;
  (data 2, model 2) at four ranks: the bag's dense step (a gradient
  summed over the world would come out twice); (ctx 2, model 2) at four:
  the transformer with `--ring_attention`. Each is held to the JAX
  package's one-device step over the same params (carried with
  convert.py) and the same global batch: the loss to `rtol 1e-5`, every
  leaf's raw gradient to `atol 2e-5` (a table's window by window, the
  port's summed over the shard-replica group only), and every param
  after one step to `atol 2e-5`, with tests/
  test_torch_context_parallel.py's exception for Adam's first step on
  a gradient below 100 eps. The gathered contexts are one device's
  bits (`torch.equal`).
- Adafactor's factored statistics across two shards (a [30, 8] leaf,
  and a [6, 12] leaf whose [3, 12] shard would not factor on its own)
  against optax on the whole leaf;
- the merged top-k: the padded target row never enters it, ties go
  lowest global id first across the shards, and an evaluation at model
  2 counts and scores as one process does; a step under the phase
  profiler runs its probes over the windows and ends with the fused
  step's bits;
- the trainer: a two-rank `cli.main --mesh_model 2 --dist_*` run (train,
  evaluate, save), whose whole-table checkpoint a one-process `--load`
  evaluates to the same results; a one-process checkpoint resumed on a
  model-2 mesh, its windows the checkpoint's rows bit for bit.

The rules run here in the parent: the VarMisuse head and the exports
accepted under the model axis (tests/test_torch_vm_model_axis.py and
tests/test_torch_model_exports.py run them), int8 tables refused in the
JAX package's words, the supervisor's shrink of a model cohort, a model
collective without its group, and a checkpoint's rows padded onto a
model axis they do not divide.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import pytest

LR = 0.01
G, C, E = 8, 8, 16          # global rows, contexts, embedding width
VT, VP, VY = 47, 39, 29     # odd: padded to 48, 40, 30 for the model axis
S = 8
KEEP = 0.75
ADAM_EPS = 1e-8
TABLES = ("token_emb", "path_emb", "target_emb")
# name: (encoder, ring attention, sampled softmax, sparse-row step)
CASES = {"bag": ("bag", False, False, False),
         "bag_sampled": ("bag", False, True, False),
         "bag_sparse": ("bag", False, True, True),
         "xf": ("transformer", False, False, False),
         "xf_ring": ("transformer", True, False, False)}
# world -> [(layout, mesh axes, cases)]
LAYOUTS = {2: [("model2", dict(data=1, context=1, model=2),
                ["bag", "bag_sampled", "bag_sparse", "xf"])],
           4: [("data2_model2", dict(data=2, context=1, model=2), ["bag"]),
               ("ctx2_model2", dict(data=1, context=2, model=2),
                ["xf_ring"])]}
STEP_CASES = [(layout, case) for w in LAYOUTS for layout, _a, cases
              in LAYOUTS[w] for case in cases]
WORLD_OF = {layout: w for w in LAYOUTS for layout, _a, _c in LAYOUTS[w]}
AXES_OF = {layout: a for w in LAYOUTS for layout, a, _c in LAYOUTS[w]}
# Adafactor across shards: whole leaf shapes (rows over the model axis)
FACTORED_SHAPES = ((30, 8), (6, 12))


def _dims(module, case):
    encoder, ring, _sampled, _sparse = CASES[case]
    return module.ModelDims(token_vocab_size=VT, path_vocab_size=VP,
                            target_vocab_size=VY, embeddings_size=E,
                            max_contexts=C, vocab_pad_multiple=2,
                            dropout_keep_rate=KEEP, encoder_type=encoder,
                            xf_layers=2, xf_heads=2, ring_attention=ring)


def _trainer_config(prefix, **kw):
    from test_torch_multiprocess import _trainer_config as base
    cfg = base(prefix)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _mesh(layout, rank=None, world=None):
    from code2vec_tpu_torch.parallel.mesh import make_mesh
    a = AXES_OF[layout]
    return make_mesh(a["data"], a["model"], a["context"], rank=rank,
                     world=world, device="cpu")


# ---- the workers (run by tests/test_torch_multiprocess.py's worker) ----

def _local_inputs(inp, mesh):
    """This rank's batch (its rows and contexts) and draws (its keep mask
    slice, the global sampled ids)."""
    import torch

    from code2vec_tpu_torch.parallel.sharding import (batch_rows,
                                                      context_cols,
                                                      local_contexts)
    from code2vec_tpu_torch.training.draws import StepDraws
    rows = slice(*batch_rows(mesh, G // mesh.batch_shards))
    cols = slice(*context_cols(mesh, C))
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                  local_contexts(mesh, tuple(a[rows] for a in inp["batch"])))
    draws = StepDraws(
        keep=torch.from_numpy(np.ascontiguousarray(inp["keep"][rows, cols])),
        sampled=None if inp["sampled"] is None
        else torch.from_numpy(inp["sampled"]), salts={})
    return batch, draws


def _whole_params(inp):
    from code2vec_tpu_torch import convert
    return convert.params_from_numpy(
        pickle.loads(pickle.dumps(inp["params"])), "cpu")


def _dense_case(inp, case, mesh):
    """(loss, raw grads summed over the shard-replica group, step loss,
    params after the step, whether the gathered contexts are one
    device's bits) of this rank's share of one dense step."""
    import torch

    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.models import encoder as tenc
    from code2vec_tpu_torch.ops.quant import opt_param_view
    from code2vec_tpu_torch.parallel.sharding import (check_replicas,
                                                      shard_params,
                                                      table_shapes)
    from code2vec_tpu_torch.training import optimizers as topt
    from code2vec_tpu_torch.training.sparse_steps import reduce_step_grads
    from code2vec_tpu_torch.training.steps import (dense_loss_and_grads,
                                                   make_train_loss_fn)
    from code2vec_tpu_torch.training.steps import \
        make_train_step as port_train_step
    dims = _dims(tenc, case)
    sampled = CASES[case][2]
    batch, draws = _local_inputs(inp, mesh)
    whole = _whole_params(inp)
    p = shard_params(whole, mesh)
    _l, src, pth, dst, _m, _w = batch
    same_contexts = torch.equal(
        tenc.gather_contexts(p, src, pth, dst, mesh=mesh),
        tenc.gather_contexts(whole, src, pth, dst))
    loss_fn = make_train_loss_fn(dims, use_sampled_softmax=sampled,
                                 num_sampled=S, mesh=mesh)
    loss, grads, _view = dense_loss_and_grads(p, batch, draws, loss_fn)
    loss = reduce_step_grads(loss, grads, mesh)
    shards = topt.RowShards(table_shapes(whole), mesh)
    opt = topt.make_optimizer(topt.make_lr(LR, "cosine", 10), shards=shards)
    step = port_train_step(dims, opt, use_sampled_softmax=sampled,
                           num_sampled=S, mesh=mesh)
    p = shard_params(_whole_params(inp), mesh)
    step_loss = step(p, opt.init(opt_param_view(p)), batch, draws)
    check_replicas(p, mesh)
    return {"loss": float(loss), "step_loss": float(step_loss),
            "grads": {k: g.numpy() for k, g in grads.items()},
            "params": convert.params_to_numpy(p),
            "same_contexts": same_contexts}


def _sparse_case(inp, case, mesh):
    """The sparse-row step's share of this rank: the loss, the dense
    gradients and each table's live-row gradient scattered into its
    window (both summed over the shard-replica group), then one step
    (row Adam on the windows)."""
    import torch

    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.models import encoder as tenc
    from code2vec_tpu_torch.parallel.sharding import (check_replicas,
                                                      shard_params)
    from code2vec_tpu_torch.training import optimizers as topt
    from code2vec_tpu_torch.training.sparse_steps import (
        SparseStepConfig, init_sparse_opt_state, loss_and_grads,
        prepare_step_inputs, reduce_step_grads, row_segments)
    from code2vec_tpu_torch.training.sparse_update import window_ids
    from code2vec_tpu_torch.training.steps import \
        make_train_step as port_train_step
    dims = _dims(tenc, case)
    batch, draws = _local_inputs(inp, mesh)
    p = shard_params(_whole_params(inp), mesh)
    cfg = SparseStepConfig(learning_rate=LR, use_sampled_softmax=True,
                           num_sampled=S)
    dense, gathered, ctx = prepare_step_inputs(
        p, batch, draws, use_sampled_softmax=True, num_sampled=S,
        target_vocab=VY, mesh=mesh)
    loss, g_dense, g_rows = loss_and_grads(dims, cfg, dense, gathered, ctx)
    summed = dict(g_dense, samp_w=g_rows["samp_w"])
    loss = reduce_step_grads(loss, summed, mesh)
    g_rows["samp_w"] = summed.pop("samp_w")
    grads = {k: g.numpy() for k, g in summed.items()}
    for key, (uids, seg) in row_segments(dims, batch, ctx, g_rows).items():
        local = window_ids(uids, mesh, p[key]).to(torch.int64)
        rows = p[key].shape[0]
        live = local < rows
        window = torch.zeros((rows, seg.shape[1]), dtype=torch.float32)
        window[local[live]] = seg[live]
        grads[key] = window.numpy()
    opt = topt.AdamF32Moments(LR)
    step = port_train_step(dims, opt, use_sampled_softmax=True,
                           num_sampled=S, sparse_updates=True, mesh=mesh)
    p = shard_params(_whole_params(inp), mesh)
    step_loss = step(p, init_sparse_opt_state(p, opt, True), batch, draws)
    check_replicas(p, mesh)
    return {"loss": float(loss), "step_loss": float(step_loss),
            "grads": grads, "params": convert.params_to_numpy(p)}


def _factored_updates(mesh, seed=3):
    """Two updates of Adafactor with the trust ratio (the JAX package's
    `trust_ratio_scope all` table chain, factored above 4) over this
    rank's rows of each FACTORED_SHAPES leaf -> {shape: [update windows]}
    (numpy), the leaves and gradients from `seed`."""
    import torch

    from code2vec_tpu_torch.parallel.sharding import row_window
    from code2vec_tpu_torch.training import optimizers as topt
    out = {}
    for shape in FACTORED_SHAPES:
        key = f"t{shape[0]}x{shape[1]}"
        r = np.random.default_rng(seed + shape[0])
        param = r.standard_normal(shape).astype(np.float32)
        grads = [r.standard_normal(shape).astype(np.float32)
                 for _ in range(2)]
        lo, hi = row_window(mesh, shape[0])
        shards = topt.RowShards({key: shape}, mesh)
        tx = topt.chain(topt.scale_by_factored_rms(
            min_dim_size_to_factor=4, shards=shards),
            topt.clip_by_block_rms(1.0, shards),
            topt.scale_by_trust_ratio(shards),
            topt.scale_by_learning_rate(LR))
        params = {key: torch.from_numpy(param[lo:hi].copy())}
        state = tx.init(params)
        out[shape] = [tx.update({key: torch.from_numpy(g[lo:hi].copy())},
                                state, params)[key].numpy() for g in grads]
    return out


def _topk_checks(inp, mesh):
    """The merged top-k at model 2 against one process's on the whole
    logits: (ids, values) of the probabilities of a random code vector
    and of a zero one (every real logit 0: ties across the shards), and
    the rank's logits at the padded global column."""
    import torch

    from code2vec_tpu_torch.models import encoder as tenc
    from code2vec_tpu_torch.parallel.sharding import shard_params
    from code2vec_tpu_torch.training.steps import topk_merged
    p = shard_params(_whole_params(inp), mesh)
    gen = torch.Generator().manual_seed(9)
    out = {}
    for name, code in (("random", torch.randn((3, 3 * E), generator=gen)),
                       ("ties", torch.zeros((3, 3 * E)))):
        logits = tenc.full_logits(p, code, VY, mesh)
        vals, ids = topk_merged(tenc.softmax(logits, mesh), 20, mesh)
        out[name] = (ids.numpy(), vals.numpy(), logits.numpy())
    return out


def _profiled(inp, mesh):
    """One full-softmax step of the bag's dense step under the model mesh
    through the phase profiler (its probes gather the windows and sum
    over the shard-replica group on every rank in the same order): the
    `phase` event, and whether the params are the bits of the same step
    unprofiled."""
    from types import SimpleNamespace

    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.models import encoder as tenc
    from code2vec_tpu_torch.obs import Telemetry
    from code2vec_tpu_torch.obs.phases import PhaseProfiler
    from code2vec_tpu_torch.ops.quant import opt_param_view
    from code2vec_tpu_torch.parallel.sharding import (shard_params,
                                                      table_shapes)
    from code2vec_tpu_torch.training import optimizers as topt
    from code2vec_tpu_torch.training.phase_probes import make_code2vec_probes
    from code2vec_tpu_torch.training.steps import \
        make_train_step as port_train_step
    dims = _dims(tenc, "bag")
    batch, draws = _local_inputs(inp, mesh)
    opt = topt.make_optimizer(
        topt.make_lr(LR, "cosine", 10),
        shards=topt.RowShards(table_shapes(_whole_params(inp)), mesh))
    step = port_train_step(dims, opt, mesh=mesh)
    runs = []
    for profiled in (True, False):
        params = shard_params(_whole_params(inp), mesh)
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


def model_worker(rank, world, out_dir, deadline):
    """Every layout of `world`: its step cases; at two ranks also the
    optimizer, top-k, evaluation and resume checks, and the command-line
    run last (cli.main leaves the group)."""
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from test_torch_context_parallel import _counting_results
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    out = {}
    for layout, _axes, cases in LAYOUTS[world]:
        mesh = _mesh(layout)
        for case in cases:
            deadline.beat(f"{layout}/{case}")
            run = _sparse_case if CASES[case][3] else _dense_case
            out[(layout, case)] = run(inputs[case], case, mesh)
    if world == 4:
        return out
    mesh = _mesh("model2")
    deadline.beat("factored")
    out["factored"] = _factored_updates(mesh)
    out["topk"] = _topk_checks(inputs["bag"], mesh)
    deadline.beat("profiled")
    out["profiled"] = _profiled(inputs["bag"], mesh)
    prefix = inputs["prefix"]
    seen = _counting_results()
    deadline.beat("evaluate")
    trainer = Code2VecTrainer.from_config(
        _trainer_config(prefix, MESH_MODEL_AXIS=2), device="cpu")
    trainer.evaluate()
    out["evaluate"] = seen[-1]
    out["host_shard"] = trainer.host_shard()
    deadline.beat("resume")
    resumed = Code2VecTrainer.from_config(
        _trainer_config(prefix, MESH_MODEL_AXIS=2,
                        load_path=inputs["one_ckpt"]), device="cpu")
    out["resume"] = {
        "dims": resumed.dims, "step": resumed.step_num,
        "windows": {k: v.clone() for k, v in _flat_tensors(
            {"params": resumed.params, "opt_state": resumed.opt_state})},
        "shapes": resumed.whole_table_shapes()}
    out["resume"]["losses"] = resumed.train(prefix + ".train.c2v",
                                            max_steps=1)
    deadline.beat("cli", timeout_s=120.0)
    from code2vec_tpu_torch import cli
    port = sys.argv[3]  # this worker's coordinator port
    rc = cli.main([
        "--backend", "cpu", "--data", prefix, "--test",
        prefix + ".val.c2v", "--save", os.path.join(out_dir, "cli_ckpt"),
        "--max_contexts", "16", "--batch_size", "8", "--epochs", "1",
        "--async_checkpoint", "off", "--no_bf16", "--mesh_model", "2",
        "--dist_coordinator", f"127.0.0.1:{port}",
        "--dist_num_processes", str(world), "--dist_process_id",
        str(rank)])
    out["cli"] = {"rc": rc, "eval": seen[-1]}
    return out


def _flat_tensors(tree, prefix=""):
    """(path, tensor) of every tensor of a state tree."""
    import torch
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_tensors(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_tensors(v, f"{prefix}/{i}")


# ---- the parent side ----

def _jax_case(case, seed):
    """The JAX params, the global batch, the draws of the JAX step (keep
    mask, sampled ids), its loss, raw grads and params after one step."""
    import jax
    import jax.numpy as jnp

    from code2vec_tpu.models import encoder as jenc
    from code2vec_tpu.ops import sampled_softmax as jss
    from code2vec_tpu.ops.quant import opt_param_view
    from code2vec_tpu.training import optimizers as jopt
    from code2vec_tpu.training.steps import make_train_loss_fn
    from code2vec_tpu.training.steps import make_train_step as jax_train_step
    _enc, _ring, sampled, sparse = CASES[case]
    jd = _dims(jenc, case)
    r = np.random.default_rng(seed + 1)
    weights = np.ones((G,), np.float32)
    weights[-1] = 0.0
    mask = (r.random((G, C)) > 0.3).astype(np.float32)
    mask[1, C // 2:] = 0.0    # a shard of padding at ctx 2
    mask[2, :] = 0.0          # no live context
    labels = r.integers(0, VY, G).astype(np.int32)
    labels[0] = VY - 1        # the last shard's last real row
    batch = (labels, r.integers(0, VT, (G, C)).astype(np.int32),
             r.integers(0, VP, (G, C)).astype(np.int32),
             r.integers(0, VT, (G, C)).astype(np.int32), mask, weights)
    params = jenc.init_params(jax.random.PRNGKey(seed), jd)
    rng = jax.random.PRNGKey(100 + seed)
    drop_rng, sample_rng = jax.random.split(rng)
    keep = np.array(jax.random.bernoulli(drop_rng, KEEP, (G, C, 3 * E)))
    ids = (np.array(jss.log_uniform_sample(sample_rng, S, VY))
           if sampled else None)
    jb = tuple(jnp.asarray(a) for a in batch)
    loss_and_grads = jax.jit(jax.value_and_grad(make_train_loss_fn(
        jd, use_sampled_softmax=sampled, num_sampled=S)))
    loss, grads = loss_and_grads(params, jb, rng)
    host = jax.tree_util.tree_map(np.asarray, params)
    if sparse:
        from code2vec_tpu.training.sparse_steps import (
            init_sparse_opt_state, make_sparse_train_step)
        dense_opt = jopt.make_optimizer(LR, "adam")
        step = make_sparse_train_step(
            jd, learning_rate=LR, dense_optimizer=dense_opt,
            use_sampled_softmax=True, num_sampled=S,
            compute_dtype=jnp.float32, sparse_update_fused=False)
        state = init_sparse_opt_state(params, dense_opt, True)
    else:
        tx = jopt.make_optimizer(jopt.make_lr(LR, "cosine", 10))
        step = jax_train_step(jd, tx, use_sampled_softmax=sampled,
                              num_sampled=S)
        state = tx.init(opt_param_view(params))
    after, _s, step_loss = step(params, state, jb, rng)
    return {"params": host, "batch": batch, "keep": keep, "sampled": ids,
            "loss": float(loss), "step_loss": float(step_loss),
            "grads": jax.tree_util.tree_map(np.asarray, grads),
            "after": jax.tree_util.tree_map(np.asarray, after)}


@pytest.fixture(scope="module")
def model_ranks(tmp_path_factory):
    from helpers import build_tiny_dataset
    from test_torch_multiprocess import _spawn

    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    base = tmp_path_factory.mktemp("torch_model")
    jax_side = {case: _jax_case(case, i) for i, case in enumerate(CASES)}
    prefix = build_tiny_dataset(str(base), n_train=40, n_val=13, n_test=8,
                                max_contexts=16)
    # a one-process checkpoint after one step, for the model-2 resume
    one_ckpt = str(base / "one_ckpt")
    one = Code2VecTrainer.from_config(_trainer_config(prefix),
                                      device="cpu")
    one.train(prefix + ".train.c2v", max_steps=1)
    one.save(one_ckpt)
    ranks = {}
    for world in LAYOUTS:
        out_dir = str(base / f"w{world}")
        os.makedirs(out_dir)
        host = {case: {k: v[k] for k in ("params", "batch", "keep",
                                         "sampled")}
                for case, v in jax_side.items()}
        host.update(prefix=prefix, one_ckpt=one_ckpt)
        with open(os.path.join(out_dir, "inputs.pkl"), "wb") as f:
            pickle.dump(host, f)
        ranks[world] = _spawn(world, out_dir,
                              "test_torch_model_parallel:model_worker")
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


def _window(want, rank, layout):
    """The JAX tree with each table cut to `rank`'s window of rows."""
    from code2vec_tpu_torch.parallel.sharding import row_window
    mesh = _mesh(layout, rank=rank, world=WORLD_OF[layout])
    out = dict(want)
    for k in TABLES:
        lo, hi = row_window(mesh, want[k].shape[0])
        out[k] = want[k][lo:hi]
    return out


def _close(got, want, atol=2e-5):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_allclose(g[k].astype(np.float64),
                                   w[k].astype(np.float64), rtol=0,
                                   atol=atol, err_msg=k)


def _close_after_step(got, want, grads, adam_tables: bool):
    """Params after one step: within 2e-5, except where Adam updates an
    element whose JAX gradient is nonzero and below 100 eps, which is
    held within lr + 2e-5 (tests/test_torch_context_parallel.py's
    exception); the elements that take the exception are at most 0.1 %
    of a leaf (none in a leaf under 1,000 elements). The tables take
    Adafactor in the dense step, whose factored statistics do not
    amplify so, and row Adam in the sparse-row step."""
    g, w, d = dict(_flat(got)), dict(_flat(want)), dict(_flat(grads))
    assert g.keys() == w.keys()
    for k in w:
        ill = (np.abs(d[k]) < 100 * ADAM_EPS) & (d[k] != 0) & (
            adam_tables or k not in TABLES)
        diff = np.abs(g[k].astype(np.float64) - w[k].astype(np.float64))
        excepted = ill & (diff > 2e-5)
        assert excepted.mean() <= 1e-3, k
        assert diff[~ill].max(initial=0.0) <= 2e-5, k
        assert diff[ill].max(initial=0.0) <= LR + 2e-5, k


@pytest.mark.parametrize("layout,case", STEP_CASES)
def test_model_step_loss_and_raw_gradients_match_one_jax_device(
        model_ranks, layout, case):
    """The loss on every rank to rtol 1e-5, and each leaf's raw gradient
    (a table's over the rank's window) to 2e-5 of the JAX one-device
    gradient: a gradient summed over the model peers too would be twice
    the JAX one on TRANSFORM, ATTENTION and the xf leaves."""
    jax_side, ranks, _p, _b = model_ranks
    want = jax_side[case]
    for rank, r in enumerate(ranks[WORLD_OF[layout]]):
        got = r[(layout, case)]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        _close(got["grads"], _window(want["grads"], rank, layout))
        if "same_contexts" in got:
            assert got["same_contexts"]


@pytest.mark.parametrize("layout,case", STEP_CASES)
def test_model_step_params_match_one_jax_device(model_ranks, layout, case):
    """One step through the port's `make_train_step` under the mesh: the
    loss to rtol 1e-5 and every param (a table's window) to 2e-5 of the
    JAX step's (Adam's ill-conditioned elements as `_close_after_step`
    says); the shard replicas hold the same bits (the step's
    check_replicas)."""
    jax_side, ranks, _p, _b = model_ranks
    want = jax_side[case]
    for rank, r in enumerate(ranks[WORLD_OF[layout]]):
        got = r[(layout, case)]
        np.testing.assert_allclose(got["step_loss"], want["step_loss"],
                                   rtol=1e-5)
        _close_after_step(got["params"], _window(want["after"], rank, layout),
                          _window(want["grads"], rank, layout),
                          adam_tables=CASES[case][3])


def test_adafactor_across_shards_matches_optax_on_the_whole_leaf(
        model_ranks):
    """Adafactor (factored above 4) with the block-rms clip and the trust
    ratio over two shards: each rank's two updates are its rows of
    optax's on the whole leaf, including a [6, 12] leaf whose [3, 12]
    shard alone would not factor."""
    import jax.numpy as jnp
    import optax
    _j, ranks, _p, _b = model_ranks
    for shape in FACTORED_SHAPES:
        r = np.random.default_rng(3 + shape[0])
        param = jnp.asarray(r.standard_normal(shape).astype(np.float32))
        grads = [jnp.asarray(r.standard_normal(shape).astype(np.float32))
                 for _ in range(2)]
        tx = optax.chain(optax.scale_by_factored_rms(
            min_dim_size_to_factor=4), optax.clip_by_block_rms(1.0),
            optax.scale_by_trust_ratio(), optax.scale_by_learning_rate(LR))
        state = tx.init(param)
        want = []
        for g in grads:
            u, state = tx.update(g, state, param)
            want.append(np.asarray(u))
        half = shape[0] // 2
        for rank, rr in enumerate(ranks[2]):
            for got, w in zip(rr["factored"][shape], want):
                np.testing.assert_allclose(
                    got, w[rank * half:(rank + 1) * half], rtol=1e-5,
                    atol=1e-7, err_msg=str(shape))


def test_merged_topk_skips_padding_and_keeps_the_tie_order(model_ranks):
    """`topk_merged` at model 2: equal to one process's `topk_stable`
    over the whole softmax (ids exactly, values to 1e-6); with every real
    logit 0 the 20 ids are 0..19, lowest id first across the two
    15-row shards; the padded row 29 sits at -1e9 on the last shard and
    never enters the top-k."""
    import torch

    from code2vec_tpu_torch.models import encoder as tenc
    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.training.steps import topk_stable
    jax_side, ranks, _p, _b = model_ranks
    params = convert.params_from_numpy(jax_side["bag"]["params"], "cpu")
    gen = torch.Generator().manual_seed(9)
    codes = {"random": torch.randn((3, 3 * E), generator=gen),
             "ties": torch.zeros((3, 3 * E))}
    for name, code in codes.items():
        logits = tenc.full_logits(params, code, VY)
        vals, ids = topk_stable(torch.softmax(logits, dim=-1), 20)
        for rank, r in enumerate(ranks[2]):
            got_ids, got_vals, got_logits = r["topk"][name]
            assert np.array_equal(got_ids, ids.numpy()), name
            np.testing.assert_allclose(got_vals, vals.numpy(), rtol=0,
                                       atol=1e-6)
            assert (got_ids < VY).all()
            if rank == 1:
                assert (got_logits[:, -1] < -1e8).all()
    ties = ranks[2][0]["topk"]["ties"][0]
    assert (ties == np.arange(20)[None, :]).all()


def test_phase_profiler_runs_its_probes_under_a_model_mesh(model_ranks):
    """`--phase_profile` under (data 1, model 2): the sampled step's
    probes (embed_gather and concat_dense over the rank's windows,
    forward_pool and backward through the model pair, the shard-replica
    all-reduce and the apply) run on both ranks, and the state update is
    the fused step's: the params the bits of the unprofiled step."""
    _j, ranks, _p, _b = model_ranks
    for r in ranks[2]:
        ev = r["profiled"]["event"]
        for phase in ("embed_gather", "concat_dense", "forward_pool",
                      "backward", "table_apply", "allreduce"):
            assert f"{phase}_ms" in ev, (phase, ev)
        assert r["profiled"]["same_bits"]


def _one_process_eval(cfg, monkeypatch, **trainer_kw):
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from test_torch_context_parallel import _counting_results as counting
    seen = counting(monkeypatch.setattr)
    if trainer_kw:
        Code2VecTrainer(cfg, **trainer_kw).evaluate()
    else:
        Code2VecTrainer.from_config(cfg, device="cpu").evaluate()
    return seen[-1]


def test_model_evaluation_counts_each_example_once(model_ranks,
                                                   monkeypatch):
    """An evaluation at (data 1, model 2): both ranks read the whole file
    (one batch shard), one of them counted; the merged results and the
    example count equal one process's evaluation of the same seeded
    params (the tables drawn at the model axis's padding)."""
    import dataclasses

    from code2vec_tpu_torch.models.torch_model import dims_from_config
    from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
    from test_torch_context_parallel import _same_eval
    _j, ranks, prefix, _b = model_ranks
    cfg = _trainer_config(prefix)
    vocabs = Code2VecVocabs.load_from_dict_file(
        cfg.word_freq_dict_path, cfg.MAX_TOKEN_VOCAB_SIZE,
        cfg.MAX_PATH_VOCAB_SIZE, cfg.MAX_TARGET_VOCAB_SIZE)
    dims = dataclasses.replace(dims_from_config(cfg, vocabs),
                               vocab_pad_multiple=2)
    one = _one_process_eval(cfg, monkeypatch, vocabs=vocabs, dims=dims,
                            device="cpu")
    assert one[0] == 13
    assert [r["host_shard"] for r in ranks[2]] == [(0, 1), (0, 1)]
    for r in ranks[2]:
        _same_eval(r["evaluate"], one)


def test_cli_model_run_on_two_ranks_then_one_process_load(model_ranks,
                                                         monkeypatch):
    """`cli.main --mesh_model 2 --dist_*` on two ranks trains an epoch,
    evaluates (13 examples, counted once) and saves from rank 0 the
    one-process format: whole tables padded to 2 (the manifest's
    vocab_pad_multiple), the state's structure and shapes a one-process
    trainer's at those dims; `--load` in one process evaluates it to the
    same results."""
    import json

    import torch

    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.training import checkpoint as ckpt
    _j, ranks, prefix, base = model_ranks
    a, b = ranks[2]
    assert a["cli"]["rc"] == 0 and b["cli"]["rc"] == 0
    path = os.path.join(base, "w2", "cli_ckpt")
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["vocab_pad_multiple"] == 2
    step = ckpt.latest_step(path)
    assert ckpt.load_step_topology(path, step)["num_processes"] == 2
    state = ckpt.load_checkpoint(path)
    cfg = _trainer_config(prefix)
    cfg.load_path = path
    one = Code2VecTrainer.from_config(cfg, device="cpu")
    assert one.dims.vocab_pad_multiple == 2
    sig = {k: (tuple(t.shape), t.dtype) for k, t in _flat_tensors(
        {"params": one.params, "opt_state": one.opt_state})}
    assert sig == {k: (tuple(t.shape), t.dtype) for k, t in _flat_tensors(
        {"params": state["params"], "opt_state": state["opt_state"]})}
    assert all(torch.equal(one.params[k], state["params"][k])
               for k in ("token_emb", "path_emb", "target_emb"))
    from test_torch_context_parallel import _counting_results, _same_eval
    seen = _counting_results(monkeypatch.setattr)
    assert cli.main(["--backend", "cpu", "--load", path, "--test",
                     prefix + ".val.c2v", "--no_bf16"]) == 0
    assert seen[-1][0] == 13
    for r in (a, b):
        _same_eval(r["cli"]["eval"], seen[-1])


def test_one_process_checkpoint_resumes_on_a_model_mesh(model_ranks):
    """A one-process checkpoint loaded by a model-2 trainer: each rank's
    params and optimizer slots are the checkpoint's rows of its window
    bit for bit (the replicated leaves whole), the step carried over, and
    a step trains on."""
    import torch

    from code2vec_tpu_torch.parallel.sharding import shard_state
    from code2vec_tpu_torch.training import checkpoint as ckpt
    _j, ranks, _p, base = model_ranks
    state = ckpt.load_checkpoint(os.path.join(base, "one_ckpt"))
    for rank, r in enumerate(ranks[2]):
        res = r["resume"]
        assert res["step"] == 1 and res["dims"].vocab_pad_multiple == 2
        want = shard_state({"params": state["params"],
                            "opt_state": state["opt_state"]},
                           _mesh("model2", rank=rank, world=2),
                           {k: tuple(state["params"][k].shape)
                            for k in TABLES})
        flat = dict(_flat_tensors(want))
        assert flat.keys() == res["windows"].keys()
        for k, t in flat.items():
            assert torch.equal(res["windows"][k], t), k
        assert res["windows"]["/params/token_emb"].shape[0] * 2 == \
            state["params"]["token_emb"].shape[0]
        assert len(res["losses"]) == 1 and np.isfinite(res["losses"][0])


# ---- the rules, in one process ----

def test_repad_rows_pads_a_checkpoint_onto_a_model_axis():
    """An unpadded state (odd rows) padded with zero rows to a model
    axis of 2 (`torch_model.repad_rows`), then cut into windows: the
    tables and every slot that leads with the vocab dim (Adam's moments,
    Adafactor's unfactored second moment) grow; the replicated leaves,
    the counts and the [1] placeholders do not."""
    import torch

    from code2vec_tpu_torch.models.torch_model import repad_rows
    from code2vec_tpu_torch.ops.quant import opt_param_view
    from code2vec_tpu_torch.parallel.sharding import shard_state
    from code2vec_tpu_torch.training import optimizers as topt
    gen = torch.Generator().manual_seed(0)
    params = {"token_emb": torch.randn((5, 4), generator=gen),
              "path_emb": torch.randn((3, 4), generator=gen),
              "target_emb": torch.randn((7, 12), generator=gen),
              "transform": torch.randn((12, 12), generator=gen),
              "attention": torch.randn((12,), generator=gen)}
    opt = topt.make_optimizer(LR)
    state = {"params": params, "opt_state": opt.init(opt_param_view(params)),
             "step": 3}
    padded = repad_rows(state, {"token_emb": 6, "path_emb": 4,
                                "target_emb": 8})
    for k, rows in (("token_emb", 6), ("path_emb", 4), ("target_emb", 8)):
        t = padded["params"][k]
        assert t.shape[0] == rows
        assert torch.equal(t[:params[k].shape[0]], params[k])
        assert not t[params[k].shape[0]:].any()
    fac = padded["opt_state"]["table"][0]
    assert fac.v["token_emb"].shape == (6, 4)
    assert fac.v_row["token_emb"].shape == (1,)
    small = padded["opt_state"]["small"][0]
    assert small.mu["transform"].shape == (12, 12)
    assert padded["step"] == 3
    for rank in range(2):
        mine = shard_state(padded, _mesh("model2", rank=rank, world=2),
                           {"token_emb": (6, 4), "path_emb": (4, 4),
                            "target_emb": (8, 12)})
        assert mine["params"]["token_emb"].shape == (3, 4)
        assert torch.equal(mine["params"]["token_emb"],
                           padded["params"]["token_emb"][3 * rank:
                                                         3 * rank + 3])
        assert mine["opt_state"]["table"][0].v["target_emb"].shape == (4, 12)
        assert mine["params"]["transform"] is padded["params"]["transform"]


def test_model_mesh_config_rules():
    """`Config(MESH_MODEL_AXIS=2)` passes `verify`, the command line sets
    it as the JAX parser does, and the trainer's dims pad the tables to
    it; the VarMisuse head and the writing rank's exports pass under it,
    as in the JAX package, and int8 tables stay refused in its words."""
    from code2vec_tpu.config import Config as JaxConfig
    from code2vec_tpu_torch.config import Config
    Config(MESH_MODEL_AXIS=2).verify()
    argv = ["--data", "x", "--mesh_model", "2"]
    assert Config.load_from_args(argv).MESH_MODEL_AXIS == \
        JaxConfig.load_from_args(argv).MESH_MODEL_AXIS == 2
    Config(MESH_MODEL_AXIS=2, HEAD="varmisuse").verify()
    for flags in (["--save_w2v", "y"], ["--save_t2v", "y"], ["--release"],
                  ["--test", "t", "--export_code_vectors"]):
        argv = ["--load", "x", *flags, "--mesh_model", "2"]
        assert Config.load_from_args(argv).MESH_MODEL_AXIS == \
            JaxConfig.load_from_args(argv).MESH_MODEL_AXIS == 2
    with pytest.raises(ValueError, match="int8 supports data-parallel"):
        Config(MESH_MODEL_AXIS=2, TABLES_DTYPE="int8").verify()


def test_a_model_collective_without_its_group_raises():
    """A model mesh made without a process group has no model peers: the
    gather raises instead of reading its window as the whole table."""
    import torch

    from code2vec_tpu_torch.models import encoder as tenc
    from code2vec_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(model=2, rank=0, world=2, device="cpu")
    params = tenc.init_params(torch.Generator().manual_seed(0),
                              _dims(tenc, "bag"))
    ids = torch.zeros((2, C), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no process group of model "
                                           "peers"):
        tenc.gather_contexts(params, ids, ids, ids, mesh=mesh)
    from code2vec_tpu_torch.parallel.collectives import replica_group
    with pytest.raises(RuntimeError, match="no process group of shard "
                                           "replicas"):
        replica_group(mesh)


def test_supervisor_shrinks_a_model_cohort_by_its_mesh(capsys, monkeypatch):
    """`--resize_policy shrink` over a `--mesh_model 2` child: the tool steps
    by the child's dcn * model * ctx = 2 processes, so a cohort of 2 has
    no smaller size (a death relaunches it whole, as the start-up line
    says) and a cohort of 4 re-forms at 2."""
    from torch_helpers import supervisor_tool_plan
    child = ["--", "python3", "-m", "code2vec_tpu_torch", "--mesh_model", "2"]
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

"""The port's VarMisuse head under the model mesh axis across real
processes, against the JAX package's one-device step.

Gloo workers spawned by this file's fixture (tests/
test_torch_multiprocess.py's `_spawn`, one spawn a world size) hold the
rows of their batch shard and the window of rows of every table that
their model index owns (the whole VarMisuse params drawn on the JAX
side, padded to the model axis as the JAX package pads them, then cut by
`parallel/sharding.shard_params`), with the matching rows of the JAX
step's dropout keep mask, and run the port's dense VarMisuse step under
the mesh at (data 1, model 2), (data 2, model 2) and (data 1, model 4).
Each is held to the JAX package's one-device `make_vm_train_step` over
the same params (carried with convert.py) and the same global batch: the
loss to `rtol 1e-5` (the JAX test's own bound), every leaf's raw
gradient to `atol 2e-5` (a table's window by window, `vm_pointer`
summed over the shard-replica group only: a world sum would be m times
the JAX one), and every param after one step to `atol 2e-5`, with
tests/test_torch_model_parallel.py's exception for Adam's first step on
a gradient below 100 eps (`_close_after_step`).

The trainer (models/vm_model.py) at model 2, its params drawn from the
seed: the merged evaluation counts each example once, its accuracy equal
and its loss within 1e-6 relative of one process's over the same seeded
params (also at (data 2, model 2), where the batch shards read halves of
the file); `predict_batch` gives one process's ids; a step under
`--phase_profile` runs the probes over the windows and ends in the bits
of the unprofiled step; a one-process checkpoint resumed at model 2
holds the checkpoint's rows bit for bit; a two-rank `cli.main --head
varmisuse --mesh_model 2` run saves a whole-table checkpoint that a
one-process `--load` evaluates to the ranks' results. The rules kept and
lifted run in the parent.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import pytest

LR = 0.01
G, C, E, K = 8, 8, 16, 4    # global rows, contexts, width, candidates
VT, VP, VY = 47, 39, 29     # odd: padded to the model axis
KEEP = 0.75
TABLES = ("token_emb", "path_emb", "target_emb")
# world -> [(layout, (data, model))]
LAYOUTS = {2: [("model2", (1, 2))],
           4: [("data2_model2", (2, 2)), ("model4", (1, 4))]}
STEP_LAYOUTS = [layout for w in LAYOUTS for layout, _a in LAYOUTS[w]]
WORLD_OF = {layout: w for w in LAYOUTS for layout, _a in LAYOUTS[w]}
AXES_OF = {layout: a for w in LAYOUTS for layout, a in LAYOUTS[w]}
# the trainer's tiny run: words, paths and rows of the `.vm.c2v` files
N_TRAIN, N_VAL, N_TEST = 40, 13, 8
SETTINGS = dict(MAX_CONTEXTS=C, MAX_TOKEN_VOCAB_SIZE=1000,
                MAX_PATH_VOCAB_SIZE=1000, MAX_TARGET_VOCAB_SIZE=10,
                DEFAULT_EMBEDDINGS_SIZE=E, TRAIN_BATCH_SIZE=8,
                TEST_BATCH_SIZE=8, NUM_TRAIN_EPOCHS=1, LEARNING_RATE=0.02,
                USE_BF16=False, HEAD="varmisuse", MAX_CANDIDATES=K,
                ASYNC_CHECKPOINT=False, SEED=5)


def _dims(module, pad):
    return module.ModelDims(token_vocab_size=VT, path_vocab_size=VP,
                            target_vocab_size=VY, embeddings_size=E,
                            max_contexts=C, vocab_pad_multiple=pad,
                            dropout_keep_rate=KEEP)


def _mesh(layout, rank=None, world=None):
    from code2vec_tpu_torch.parallel.mesh import make_mesh
    data, model = AXES_OF[layout]
    return make_mesh(data, model, rank=rank, world=world, device="cpu")


def _vm_rows(r, n):
    """`.vm.c2v` rows: 2 to 6 candidates (a label past K cut in some), 0
    to 12 contexts (some over C, some empty or pathless)."""
    words = [f"w{i}" for i in range(30)]
    rows = []
    for _ in range(n):
        cands = list(r.choice(words, int(r.integers(2, 7)), replace=False))
        ctxs = []
        for _ in range(int(r.integers(0, 13))):
            if r.random() < 0.1:
                ctxs.append(",,")
            else:
                ctxs.append(f"{r.choice(words)},p{int(r.integers(0, 20))},"
                            f"{r.choice(words)}")
        rows.append(" ".join([str(int(r.integers(0, len(cands)))),
                              ",".join(cands), *ctxs]))
    return rows


def write_vm_files(prefix: str) -> None:
    """`<prefix>.{train,val,test}.vm.c2v` of N_TRAIN, N_VAL, N_TEST rows."""
    for split, n, seed in (("train", N_TRAIN, 1), ("val", N_VAL, 2),
                           ("test", N_TEST, 3)):
        with open(f"{prefix}.{split}.vm.c2v", "w") as f:
            f.write("\n".join(_vm_rows(np.random.default_rng(seed), n))
                    + "\n")


def vm_config(prefix, **kw):
    from code2vec_tpu_torch.config import Config
    cfg = Config(**SETTINGS)
    cfg.train_data_path = prefix
    cfg.test_data_path = prefix + ".val.vm.c2v"
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _vocabs(prefix):
    from code2vec_tpu_torch.data.vm_reader import build_vm_vocabs
    return build_vm_vocabs(prefix + ".train.vm.c2v", 1000, 1000)


def _recording_evaluate(setattr_fn=setattr):
    """Patch `VarMisuseModel.evaluate` to record each result -> the list
    they go to."""
    from code2vec_tpu_torch.models.vm_model import VarMisuseModel
    seen = []
    real = VarMisuseModel.evaluate

    def evaluate(self, test_path=None):
        out = real(self, test_path)
        seen.append(out)
        return out

    setattr_fn(VarMisuseModel, "evaluate", evaluate)
    return seen


# ---- the workers (run by tests/test_torch_multiprocess.py's worker) ----

def _step_case(inp, mesh):
    """(loss, raw grads summed over the shard-replica group, step loss,
    params after the step) of this rank's share of one dense step."""
    import torch

    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.models import encoder as tenc
    from code2vec_tpu_torch.ops.quant import opt_param_view
    from code2vec_tpu_torch.parallel.sharding import (batch_rows,
                                                      check_replicas,
                                                      shard_params,
                                                      table_shapes)
    from code2vec_tpu_torch.training import optimizers as topt
    from code2vec_tpu_torch.training.draws import StepDraws
    from code2vec_tpu_torch.training.sparse_steps import reduce_step_grads
    from code2vec_tpu_torch.training.steps import dense_loss_and_grads
    from code2vec_tpu_torch.training.vm_steps import make_vm_loss_fn
    from code2vec_tpu_torch.training.vm_steps import \
        make_vm_train_step as port_vm_step
    dims = _dims(tenc, mesh.model)
    rows = slice(*batch_rows(mesh, G // mesh.batch_shards))
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a[rows]))
                  for a in inp["batch"])
    draws = StepDraws(keep=torch.from_numpy(inp["keep"][rows].copy()),
                      sampled=None, salts={})

    def whole():
        return convert.params_from_numpy(
            pickle.loads(pickle.dumps(inp["params"])), "cpu")

    p = shard_params(whole(), mesh)
    loss, grads, _view = dense_loss_and_grads(
        p, batch, draws, make_vm_loss_fn(dims, mesh=mesh))
    loss = reduce_step_grads(loss, grads, mesh)
    opt = topt.make_optimizer(topt.make_lr(LR, "cosine", 10),
                              shards=topt.RowShards(table_shapes(whole()),
                                                    mesh))
    step = port_vm_step(dims, opt, mesh=mesh)
    p = shard_params(whole(), mesh)
    step_loss = step(p, opt.init(opt_param_view(p)), batch, draws)
    check_replicas(p, mesh)
    return {"loss": float(loss), "step_loss": float(step_loss),
            "grads": {k: g.numpy() for k, g in grads.items()},
            "params": convert.params_to_numpy(p)}


def _flat_params(params):
    return {k: v.detach().clone() for k, v in params.items()}


def _profiled(prefix, out_dir):
    """One step of a model-2 trainer through its phase profiler (the vm
    probes over the windows) and one of another trainer unprofiled from
    the same seed, batch and draws: the `phase` event, whether the
    params are the same bits."""
    from types import SimpleNamespace

    import torch

    from code2vec_tpu_torch.data.vm_reader import VMTextReader
    from code2vec_tpu_torch.models.vm_model import VarMisuseModel
    from code2vec_tpu_torch.obs import Telemetry
    vocabs = _vocabs(prefix)
    runs = []
    for profiled in (True, False):
        # a live registry's directory, as `verify` asks of a profiled
        # run; the profiler records into the telemetry given below
        cfg = vm_config(prefix, MESH_MODEL_AXIS=2,
                        PHASE_PROFILE="on" if profiled else "off",
                        TELEMETRY_DIR=os.path.join(out_dir, "tele"))
        trainer = VarMisuseModel(cfg, vocabs, device="cpu")
        b = next(iter(VMTextReader(prefix + ".train.vm.c2v", vocabs, C, K,
                                   8)))
        batch = trainer.device_batch(b)
        draws = trainer.draws_for(8, trainer.step_num)
        events = []
        if profiled:
            tele = Telemetry.memory("train")
            tele.sinks = [SimpleNamespace(write=events.append)]
            prof = trainer.phase_profiler(tele)
            assert prof.enabled
            prof.run_split(trainer.params, trainer.opt_state, batch, draws,
                           step=trainer.step_num)
        else:
            trainer.train_step(batch, draws)
        runs.append((events, _flat_params(trainer.params)))
    (events, a), (_e, b) = runs
    return {"event": [e for e in events if e.get("kind") == "phase"][-1],
            "same_bits": a.keys() == b.keys() and all(
                torch.equal(a[k], b[k]) for k in a)}


def vm_worker(rank, world, out_dir, deadline):
    """Every layout of `world`: its step case and the trainer's merged
    evaluation ((data 2, model 2) at four ranks); at two ranks also
    `predict_batch`, the profiled step, the resume and the command-line
    run last (cli.main leaves the group)."""
    from code2vec_tpu_torch.models.vm_model import VarMisuseModel
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    prefix = inputs["prefix"]
    vocabs = _vocabs(prefix)
    out = {}
    for layout, (data, model) in LAYOUTS[world]:
        mesh = _mesh(layout)
        deadline.beat(layout)
        out[layout] = _step_case(inputs[model], mesh)
        if data * model == world and model == 2:
            deadline.beat(f"{layout}/evaluate")
            trainer = VarMisuseModel(
                vm_config(prefix, MESH_DATA_AXIS=data, MESH_MODEL_AXIS=2),
                vocabs, device="cpu")
            out[(layout, "evaluate")] = tuple(trainer.evaluate())
            out[(layout, "host_shard")] = trainer.host_shard()
    if world == 4:
        return out
    deadline.beat("predict")
    trainer = VarMisuseModel(vm_config(prefix, MESH_MODEL_AXIS=2), vocabs,
                             device="cpu")
    with open(prefix + ".val.vm.c2v") as f:
        out["predict"] = trainer.predict_batch(f.read().splitlines()[:5])
    deadline.beat("profiled")
    out["profiled"] = _profiled(prefix, out_dir)
    deadline.beat("resume")
    resumed = VarMisuseModel.from_config(
        vm_config(prefix, MESH_MODEL_AXIS=2,
                  load_path=inputs["one_ckpt"]), device="cpu")
    from test_torch_model_parallel import _flat_tensors
    out["resume"] = {
        "dims": resumed.dims, "step": resumed.step_num,
        "windows": {k: v.clone() for k, v in _flat_tensors(
            {"params": resumed.params, "opt_state": resumed.opt_state})},
        "losses": None}
    out["resume"]["losses"] = resumed.train(prefix + ".train.vm.c2v",
                                            max_steps=1)
    deadline.beat("cli", timeout_s=120.0)
    import sys

    from code2vec_tpu_torch import cli
    seen = _recording_evaluate()
    rc = cli.main([
        "--backend", "cpu", "--head", "varmisuse", "--data", prefix,
        "--test", prefix + ".val.vm.c2v", "--save",
        os.path.join(out_dir, "cli_ckpt"), "--max_contexts", str(C),
        "--max_candidates", str(K), "--batch_size", "8", "--epochs", "1",
        "--async_checkpoint", "off", "--no_bf16", "--mesh_model", "2",
        "--dist_coordinator", f"127.0.0.1:{sys.argv[3]}",
        "--dist_num_processes", str(world), "--dist_process_id",
        str(rank)])
    out["cli"] = {"rc": rc, "eval": tuple(seen[-1]) if seen else None}
    return out


# ---- the parent side ----

def _jax_case(pad, seed):
    """The JAX VarMisuse params at `pad`, the global batch, the keep mask
    of the JAX step's dropout, its loss, raw grads and params after one
    step of the JAX package's default chain."""
    import jax
    import jax.numpy as jnp

    from code2vec_tpu.models import encoder as jenc
    from code2vec_tpu.models.varmisuse import init_vm_params, vm_loss
    from code2vec_tpu.training import optimizers as jopt
    from code2vec_tpu.training.vm_steps import make_vm_train_step
    jd = _dims(jenc, pad)
    r = np.random.default_rng(seed + 1)
    weights = np.ones((G,), np.float32)
    weights[-1] = 0.0
    mask = (r.random((G, C)) > 0.3).astype(np.float32)
    mask[2, :] = 0.0          # no live context
    cand_mask = np.ones((G, K), np.float32)
    cand_mask[::3, -1] = 0.0
    cand = r.integers(2, VT, (G, K)).astype(np.int32)
    cand[0, 0] = VT - 1       # the last real row, in the last window
    batch = (r.integers(0, K - 1, G).astype(np.int32),
             r.integers(0, VT, (G, C)).astype(np.int32),
             r.integers(0, VP, (G, C)).astype(np.int32),
             r.integers(0, VT, (G, C)).astype(np.int32), mask, cand,
             cand_mask, weights)
    params = init_vm_params(jax.random.PRNGKey(seed), jd)
    rng = jax.random.PRNGKey(100 + seed)
    keep = np.array(jax.random.bernoulli(rng, KEEP, (G, C, 3 * E)))
    jb = tuple(jnp.asarray(a) for a in batch)

    def loss_fn(p, b, key):
        return vm_loss(p, b, dropout_rng=key, dropout_keep_rate=KEEP)

    loss_and_grads = jax.jit(jax.value_and_grad(loss_fn))
    loss, grads = loss_and_grads(params, jb, rng)
    host = jax.tree_util.tree_map(np.asarray, params)
    tx = jopt.make_optimizer(jopt.make_lr(LR, "cosine", 10))
    step = make_vm_train_step(jd, tx)
    after, _s, step_loss = step(params, tx.init(params), jb, rng)
    return {"params": host, "batch": batch, "keep": keep,
            "loss": float(loss), "step_loss": float(step_loss),
            "grads": jax.tree_util.tree_map(np.asarray, grads),
            "after": jax.tree_util.tree_map(np.asarray, after)}


@pytest.fixture(scope="module")
def vm_ranks(tmp_path_factory):
    from test_torch_multiprocess import _spawn

    from code2vec_tpu_torch.models.vm_model import VarMisuseModel
    base = tmp_path_factory.mktemp("torch_vm_model")
    jax_side = {pad: _jax_case(pad, pad) for pad in (2, 4)}
    prefix = str(base / "vm")
    write_vm_files(prefix)
    # a one-process checkpoint after one step, for the model-2 resume
    one_ckpt = str(base / "one_ckpt")
    one = VarMisuseModel.from_config(vm_config(prefix), device="cpu")
    one.train(prefix + ".train.vm.c2v", max_steps=1)
    one.save(one_ckpt)
    ranks = {}
    for world in LAYOUTS:
        out_dir = str(base / f"w{world}")
        os.makedirs(out_dir)
        host = {pad: {k: v[k] for k in ("params", "batch", "keep")}
                for pad, v in jax_side.items()}
        host.update(prefix=prefix, one_ckpt=one_ckpt)
        with open(os.path.join(out_dir, "inputs.pkl"), "wb") as f:
            pickle.dump(host, f)
        ranks[world] = _spawn(world, out_dir,
                              "test_torch_vm_model_axis:vm_worker")
    return jax_side, ranks, prefix, str(base)


def _window(want, rank, layout):
    """The JAX tree with each table cut to `rank`'s window of rows."""
    from code2vec_tpu_torch.parallel.sharding import row_window
    mesh = _mesh(layout, rank=rank, world=WORLD_OF[layout])
    out = dict(want)
    for k in TABLES:
        lo, hi = row_window(mesh, want[k].shape[0])
        out[k] = want[k][lo:hi]
    return out


@pytest.mark.parametrize("layout", STEP_LAYOUTS)
def test_vm_model_step_loss_and_raw_gradients_match_one_jax_device(
        vm_ranks, layout):
    """The loss on every rank to rtol 1e-5 of the JAX one-device loss, and
    each leaf's raw gradient (a table's over the rank's window,
    `vm_pointer` whole) to 2e-5 of the JAX one; the candidate rows' part
    of `token_emb`'s gradient lands in the window that owns each row."""
    from test_torch_model_parallel import _close
    jax_side, ranks, _p, _b = vm_ranks
    want = jax_side[AXES_OF[layout][1]]
    for rank, r in enumerate(ranks[WORLD_OF[layout]]):
        got = r[layout]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert "vm_pointer" in got["grads"]
        _close(got["grads"], _window(want["grads"], rank, layout))


@pytest.mark.parametrize("layout", STEP_LAYOUTS)
def test_vm_model_step_params_match_one_jax_device(vm_ranks, layout):
    """One step through the port's `make_vm_train_step` under the mesh:
    the loss to rtol 1e-5 and every param (a table's window) to 2e-5 of
    the JAX step's (Adam's ill-conditioned elements on `vm_pointer`,
    TRANSFORM and ATTENTION as `_close_after_step` says); the shard
    replicas hold the same bits (the step's check_replicas)."""
    from test_torch_model_parallel import _close_after_step
    jax_side, ranks, _p, _b = vm_ranks
    want = jax_side[AXES_OF[layout][1]]
    for rank, r in enumerate(ranks[WORLD_OF[layout]]):
        got = r[layout]
        np.testing.assert_allclose(got["step_loss"], want["step_loss"],
                                   rtol=1e-5)
        _close_after_step(got["params"], _window(want["after"], rank, layout),
                          _window(want["grads"], rank, layout),
                          adam_tables=False)


def _one_process(prefix, pad=2):
    """A one-process VarMisuseModel over the seeded params at the model
    axis's padding."""
    import dataclasses

    from code2vec_tpu_torch.models.torch_model import dims_from_config
    from code2vec_tpu_torch.models.vm_model import VarMisuseModel
    cfg = vm_config(prefix)
    vocabs = _vocabs(prefix)
    dims = dataclasses.replace(dims_from_config(cfg, vocabs),
                               vocab_pad_multiple=pad)
    return VarMisuseModel(cfg, vocabs, device="cpu", dims=dims)


@pytest.mark.parametrize("layout", ["model2", "data2_model2"])
def test_vm_model_evaluation_counts_each_example_once(vm_ranks, layout):
    """The merged evaluation at model 2 (both model peers read their batch
    shard's rows, one of them counted): on every rank the example count
    and the accuracy equal one process's over the same seeded params, the
    loss within 1e-6 relative (float64 sums of the partials)."""
    _j, ranks, prefix, _b = vm_ranks
    one = tuple(_one_process(prefix).evaluate())
    data = AXES_OF[layout][0]
    assert one[2] > 0
    for rank, r in enumerate(ranks[WORLD_OF[layout]]):
        loss, acc, n = r[(layout, "evaluate")]
        assert r[(layout, "host_shard")] == (rank // 2, data)
        assert n == one[2] and acc == one[1]
        assert loss == pytest.approx(one[0], rel=1e-6)


def test_vm_predict_batch_under_the_model_axis(vm_ranks):
    """`predict_batch` at model 2 on both ranks: one process's ids over
    the same seeded params."""
    _j, ranks, prefix, _b = vm_ranks
    with open(prefix + ".val.vm.c2v") as f:
        rows = f.read().splitlines()[:5]
    want = _one_process(prefix).predict_batch(rows)
    for r in ranks[2]:
        assert np.array_equal(r["predict"], want)


def test_vm_phase_profile_under_a_model_mesh(vm_ranks):
    """`--phase_profile` on a model-2 VarMisuseModel: its probes (the four
    gathers over the windows, the loss, the backward, the shard-replica
    all-reduce and the isolated apply) run on both ranks, and the state
    update is the fused step's: the params the bits of the unprofiled
    step."""
    _j, ranks, _p, _b = vm_ranks
    for r in ranks[2]:
        ev = r["profiled"]["event"]
        for phase in ("embed_gather", "forward_pool", "backward",
                      "table_apply", "allreduce"):
            assert f"{phase}_ms" in ev, (phase, ev)
        assert r["profiled"]["same_bits"]


def test_one_process_vm_checkpoint_resumes_on_a_model_mesh(vm_ranks):
    """A one-process VarMisuse checkpoint (unpadded) loaded at model 2:
    each rank's params and optimizer slots are the checkpoint's rows of
    its window (padded with zero rows to 2) bit for bit, `vm_pointer`
    and the other replicated leaves whole, the step carried over, and a
    step trains on."""
    import torch

    from code2vec_tpu_torch.models.torch_model import repad_rows
    from code2vec_tpu_torch.parallel.sharding import shard_state
    from code2vec_tpu_torch.training import checkpoint as ckpt
    from test_torch_model_parallel import _flat_tensors
    _j, ranks, _p, base = vm_ranks
    state = ckpt.load_checkpoint(os.path.join(base, "one_ckpt"))
    rows = {k: -(-state["params"][k].shape[0] // 2) * 2 for k in TABLES}
    padded = repad_rows({"params": state["params"],
                         "opt_state": state["opt_state"], "step": 0}, rows)
    for rank, r in enumerate(ranks[2]):
        res = r["resume"]
        assert res["step"] == 1 and res["dims"].vocab_pad_multiple == 2
        want = shard_state({"params": padded["params"],
                            "opt_state": padded["opt_state"]},
                           _mesh("model2", rank=rank, world=2),
                           {k: (rows[k], state["params"][k].shape[1])
                            for k in TABLES})
        flat = dict(_flat_tensors(want))
        assert flat.keys() == res["windows"].keys()
        assert "/params/vm_pointer" in flat
        for k, t in flat.items():
            assert torch.equal(res["windows"][k], t), k
        assert len(res["losses"]) == 1 and np.isfinite(res["losses"][0])


def test_cli_vm_model_run_on_two_ranks_then_one_process_load(vm_ranks,
                                                            monkeypatch):
    """`cli.main --head varmisuse --mesh_model 2 --dist_*` on two ranks
    trains an epoch, evaluates (each example counted once) and saves from
    rank 0 the one-process format: whole tables padded to 2, the manifest
    keeping the head and `max_candidates`; `--load` in one process
    evaluates it to the ranks' results (accuracy and count equal, loss
    within 1e-6 relative)."""
    import json

    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.training import checkpoint as ckpt
    _j, ranks, prefix, base = vm_ranks
    a, b = ranks[2]
    assert a["cli"]["rc"] == 0 and b["cli"]["rc"] == 0
    path = os.path.join(base, "w2", "cli_ckpt")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert (manifest["head"], manifest["max_candidates"],
            manifest["vocab_pad_multiple"]) == ("varmisuse", K, 2)
    step = ckpt.latest_step(path)
    assert ckpt.load_step_topology(path, step)["num_processes"] == 2
    state = ckpt.load_checkpoint(path)
    assert state["params"]["token_emb"].shape[0] % 2 == 0
    seen = _recording_evaluate(monkeypatch.setattr)
    assert cli.main(["--backend", "cpu", "--load", path, "--test",
                     prefix + ".val.vm.c2v", "--no_bf16"]) == 0
    loss, acc, n = seen[-1]
    for r in (a, b):
        assert r["cli"]["eval"][1:] == (acc, n)
        assert r["cli"]["eval"][0] == pytest.approx(loss, rel=1e-6)


# ---- the rules, in one process ----

def test_vm_model_axis_rules_kept_and_lifted():
    """The VarMisuse head passes `verify` under `--mesh_model 2`, as in
    the JAX package; what the JAX package refuses stays refused in its
    words: int8 tables under a model axis, the head under a ctx axis or
    the transformer, the head's exports and `--predict`, and the
    sparse-row VarMisuse step under a mesh; `--predict` above one
    process on a code2vec checkpoint passes both, as the cohort runs
    it."""
    from code2vec_tpu.config import Config as JaxConfig
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models import encoder as tenc
    from code2vec_tpu_torch.training.optimizers import AdamF32Moments
    from code2vec_tpu_torch.training.vm_steps import make_vm_train_step
    def made(cls, **fields):
        cfg = cls(**fields)
        cfg.train_data_path = "x"  # a training run
        return cfg

    for cls in (Config, JaxConfig):
        made(cls, HEAD="varmisuse", MESH_MODEL_AXIS=2).verify()
    for fields in (dict(TABLES_DTYPE="int8", MESH_MODEL_AXIS=2),
                   dict(HEAD="varmisuse", MESH_CONTEXT_AXIS=2),
                   dict(HEAD="varmisuse", ENCODER_TYPE="transformer",
                        MESH_MODEL_AXIS=2)):
        errors = []
        for cls in (Config, JaxConfig):
            with pytest.raises(ValueError) as e:
                made(cls, **fields).verify()
            errors.append(str(e.value))
        assert errors[0] == errors[1], fields
    for flags in (["--save_w2v", "y"], ["--save_t2v", "y"], ["--release"],
                  ["--predict"], ["--test", "t", "--export_code_vectors"]):
        argv = ["--load", "x", "--head", "varmisuse", "--mesh_model", "2",
                *flags]
        errors = []
        for cls in (Config, JaxConfig):
            with pytest.raises(ValueError) as e:
                cls.load_from_args(argv)
            errors.append(str(e.value))
        assert errors[0] == errors[1] == (
            "--predict/--release/--save_w2v/--save_t2v/"
            "--export_code_vectors apply to the code2vec head only."), flags
    mesh = _mesh("model2", rank=0, world=2)
    with pytest.raises(ValueError, match="--sparse_embeddings on the "
                       "varmisuse head is single-device only"):
        make_vm_train_step(_dims(tenc, 2), AdamF32Moments(LR),
                           sparse_updates=True, mesh=mesh)
    argv = ["--load", "x", "--predict", "--dist_coordinator", "h:1",
            "--dist_num_processes", "2", "--dist_process_id", "0"]
    assert Config.load_from_args(argv).DIST_NUM_PROCESSES == \
        JaxConfig.load_from_args(argv).DIST_NUM_PROCESSES == 2

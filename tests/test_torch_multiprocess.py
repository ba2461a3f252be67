"""The port's data axis across real processes: gloo workers on the CPU.

One module fixture spawns two workers of this file (its `__main__`
part), joined by `parallel/distributed.maybe_initialize` under the
bounded bring-up barrier, each phase under a `PhaseDeadline`, with a
fresh-port `transient_distributed` retry around the spawn and a
`communicate` timeout, as the JAX package's tests/test_multihost.py
fixture has. Each worker takes its rows of one global batch and the
matching rows of the global draws (made on the JAX side, dropout on) and
runs the port's steps under the mesh:

- dense float32 and sparse-row (sampled softmax) steps of the code2vec
  head, held to the port's one-process step over the concatenated batch
  and to the JAX package's one-process step over the same batch with
  the same draws, in JAX's bounds: loss `rtol 1e-5`
  (tests/test_multihost.py:170-173), params `atol 1e-5`
  (tests/test_parallel.py:70-73);
- int8 dense and int8 sparse-row steps, against the port's one-process
  step: each q within 1 of it on at most 1% of the elements (a gradient
  summed in another order may cross a rounding edge); the dequantized
  rows, whose update runs through the bf16 carrier, and the bf16
  `target_emb` within the dense-step tests' bf16 bound (2 * lr + 1 bf16
  ulp of the largest value, 95% of the elements within the ulp); the
  float32 params within 1e-4 of their largest value;
- a transformer dense step (float32: the JAX bounds);
- every rank's params bit-identical after every step (the digest check
  in the worker, and the parent comparing the ranks' arrays), and the
  dense float32 step run twice from the same state: the same bits;
- `mesh_sparse_apply` bit-identical to the one-process compact apply of
  the same global parts, float and int8;
- a dense step of the VarMisuse head (against the port's one-process
  step, the JAX bounds);
- a trainer under the mesh: two steps through its loop (host-sharded
  reader, sliced draws), a host-sharded `evaluate` equal to one
  process's evaluation of the saved checkpoint, and the save written by
  rank 0 only, its topology.json recording 2 processes.

A second fixture runs four workers for `mesh_sparse_apply` and the
replica check only.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))

LR = 0.01
B, C, E = 4, 8, 16          # rows per rank, contexts, embedding width
VT, VP, VY = 48, 40, 30
S = 8
KEEP = 0.75
BF16_ULP = 2.0 ** -7
CASES = {
    # name: (tables, encoder, sparse, sampled)
    "dense_f32": ("float32", "bag", False, False),
    "sparse_f32": ("float32", "bag", True, True),
    "dense_int8": ("int8", "bag", False, True),
    "sparse_int8": ("int8", "bag", True, False),
    "dense_xf": ("float32", "transformer", False, False),
    "vm_dense": ("float32", "bag", False, False),   # the VarMisuse head
}
K = 4  # VarMisuse candidates


def _dims(module, tables, encoder):
    return module.ModelDims(token_vocab_size=VT, path_vocab_size=VP,
                            target_vocab_size=VY, embeddings_size=E,
                            max_contexts=C, vocab_pad_multiple=4,
                            dropout_keep_rate=KEEP, tables_dtype=tables,
                            encoder_type=encoder, xf_layers=1, xf_heads=2)


def _trainer_config(prefix):
    from code2vec_tpu_torch.config import Config
    cfg = Config(MAX_CONTEXTS=16, MAX_TOKEN_VOCAB_SIZE=1000,
                 MAX_PATH_VOCAB_SIZE=1000, MAX_TARGET_VOCAB_SIZE=1000,
                 DEFAULT_EMBEDDINGS_SIZE=16, TRAIN_BATCH_SIZE=8,
                 TEST_BATCH_SIZE=8, USE_BF16=False, LR_SCHEDULE="constant",
                 ASYNC_CHECKPOINT=False, NUM_TRAIN_EPOCHS=1, SEED=5)
    cfg.train_data_path = prefix
    cfg.test_data_path = prefix + ".val.c2v"
    return cfg


# ---- the workers (run as `python test_torch_multiprocess.py ...`) ----

def _port_step(case, dims, mesh):
    """(step, opt_state factory) of `case` on the port."""
    from code2vec_tpu_torch.ops.quant import opt_param_view
    from code2vec_tpu_torch.training import optimizers as topt
    from code2vec_tpu_torch.training.sparse_steps import \
        init_sparse_opt_state
    from code2vec_tpu_torch.training.steps import make_train_step
    _tables, _enc, sparse, sampled = CASES[case]
    if case.startswith("vm_"):
        from code2vec_tpu_torch.training.vm_steps import make_vm_train_step
        opt = topt.make_optimizer(topt.make_lr(LR, "cosine", 10))
        step = make_vm_train_step(dims, opt, mesh=mesh)
        return step, lambda p: opt.init(opt_param_view(p))
    if sparse:
        opt = topt.AdamF32Moments(LR)
        step = make_train_step(dims, opt, use_sampled_softmax=sampled,
                               num_sampled=S, sparse_updates=True,
                               mesh=mesh)
        return step, lambda p: init_sparse_opt_state(p, opt, sampled)
    opt = topt.make_optimizer(topt.make_lr(LR, "cosine", 10))
    step = make_train_step(dims, opt, use_sampled_softmax=sampled,
                           num_sampled=S, mesh=mesh)
    return step, lambda p: opt.init(opt_param_view(p))


def run_port_case(case, inputs, rows, mesh):
    """One step of `case` from its inputs on `rows` of the global batch
    -> (loss, params as numpy)."""
    import torch

    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.models import encoder as tenc
    from code2vec_tpu_torch.training.draws import StepDraws
    tables, encoder, _sparse, _sampled = CASES[case]
    inp = inputs[case]
    dims = _dims(tenc, tables, encoder)
    # a copy: the step updates the params in place, and from_numpy
    # tensors share the inputs' memory
    params = convert.params_from_numpy(
        pickle.loads(pickle.dumps(inp["params"])), "cpu")
    step, init_state = _port_step(case, dims, mesh)
    state = init_state(params)
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a[rows]))
                  for a in inp["batch"])
    draws = StepDraws(
        keep=torch.from_numpy(np.ascontiguousarray(inp["keep"][rows])),
        sampled=None if inp["sampled"] is None
        else torch.from_numpy(inp["sampled"]), salts=inp["salts"])
    loss = step(params, state, batch, draws)
    if mesh is not None:
        from code2vec_tpu_torch.parallel.sharding import check_replicas
        check_replicas(params, mesh)
    return float(loss), convert.params_to_numpy(params)


def _sparse_parts(seed, world, table_rows, width):
    """The global parts of a mesh_sparse_apply check: two sharded parts
    of 6 ids a rank and a replicated one."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    n = 6 * world
    return [
        (torch.randint(0, table_rows, (n,), generator=gen,
                       dtype=torch.int32),
         torch.randn((n, width), generator=gen), True),
        (torch.randint(0, table_rows, (n,), generator=gen,
                       dtype=torch.int32),
         torch.randn((n, width), generator=gen), True),
        (torch.randint(0, table_rows, (5,), generator=gen,
                       dtype=torch.int32),
         torch.randn((5, width), generator=gen), False)]


def check_mesh_sparse_apply(mesh) -> bool:
    """mesh_sparse_apply over this rank's slices of the global parts ==
    the one-process compact apply of the global parts, bit for bit,
    float32 and int8 tables; every rank's table the same."""
    import torch

    from code2vec_tpu_torch.ops.quant import quantize_table
    from code2vec_tpu_torch.parallel.sharding import check_replicas
    from code2vec_tpu_torch.training.sparse_adam import init_row_adam
    from code2vec_tpu_torch.training.sparse_update import (
        adam_lr_t, apply_rows, dedup_segment_sum, mesh_sparse_apply)
    count = torch.full((), 3, dtype=torch.int32)
    lr_t = adam_lr_t(count, 0.05, 0.9, 0.999)
    ok = True
    for quant in (False, True):
        gen = torch.Generator().manual_seed(11)
        base = torch.randn((40, 8), generator=gen)
        parts = _sparse_parts(12, mesh.world, 40, 8)
        salt = 0x9E3779B9 if quant else None
        tables = [quantize_table(base) if quant else base.clone()
                  for _ in range(2)]
        states = [init_row_adam(t) for t in tables]
        ids = torch.cat([i for i, _g, _s in parts])
        grads = torch.cat([g for _i, g, _s in parts])
        apply_rows(tables[0], states[0], *dedup_segment_sum(ids, grads),
                   lr_t=lr_t, b1=0.9, b2=0.999, eps=1e-8, salt=salt)
        lo, hi = mesh.rank * 6, mesh.rank * 6 + 6
        mine = [(i[lo:hi], g[lo:hi], s) if s else (i, g, s)
                for i, g, s in parts]
        mesh_sparse_apply(mesh, tables[1], states[1], mine, lr_t=lr_t,
                          salt=salt)
        a, b = tables
        pairs = [(a["q"], b["q"]), (a["s"], b["s"])] if quant else [(a, b)]
        pairs += [(states[0].m, states[1].m), (states[0].v, states[1].v)]
        ok = ok and all(torch.equal(x, y) for x, y in pairs)
        check_replicas({"t": b, "m": states[1].m}, mesh)
    return ok


def check_collectives_on_the_card(rank: int, world: int) -> dict:
    """Every collective the port uses, on CUDA tensors of this rank's
    device: sums in float32, bf16, float64 and int64, int64 max / min,
    the rank-order all-gather of int32 / float32 / bf16 rows, a
    broadcast. -> {name: passed}."""
    import torch
    import torch.distributed as dist

    from code2vec_tpu_torch.parallel import distributed
    dev = distributed.rank_device()
    out = {"device_is_cuda": dev.type == "cuda"}
    for dt in (torch.float32, torch.bfloat16, torch.float64, torch.int64):
        t = torch.full((5,), rank + 1, dtype=dt, device=dev)
        distributed.all_reduce_sum_(t)
        out[f"sum_{dt}"] = bool((t.cpu() == world * (world + 1) // 2).all())
    for op, want in ((dist.ReduceOp.MAX, world - 1), (dist.ReduceOp.MIN, 0)):
        t = torch.full((3,), rank, dtype=torch.int64, device=dev)
        dist.all_reduce(t, op=op)
        out[f"int64_{op}"] = bool((t.cpu() == want).all())
    for dt in (torch.int32, torch.float32, torch.bfloat16):
        t = torch.full((2, 3), rank, dtype=dt, device=dev)
        g = distributed.all_gather_rows(t).cpu()
        want = torch.arange(world).repeat_interleave(2)[:, None].expand(
            -1, 3).to(dt)
        out[f"gather_{dt}"] = g.shape == (2 * world, 3) and torch.equal(
            g, want)
    t = torch.full((4,), float(rank), device=dev)
    dist.broadcast(t, src=0)
    out["broadcast"] = bool((t.cpu() == 0).all())
    exact = distributed.allreduce_sum_hosts([2.0 ** 52 + rank])
    out["hosts_f64"] = exact.tolist() == [world * 2.0 ** 52
                                          + world * (world - 1) // 2]
    return out


def worker(rank: int, world: int, port: str, out_dir: str,
           mode: str) -> None:
    sys.path.insert(0, REPO)
    from code2vec_tpu_torch.parallel import compat, distributed
    from code2vec_tpu_torch.parallel.mesh import make_mesh

    def log(m):
        print(f"[rank {rank}] {m}", flush=True)

    device_type = "cuda" if mode == "cuda" else "cpu"
    compat.first_collective_barrier(
        timeout_s=60.0, log=log,
        setup_fn=lambda: distributed.maybe_initialize(
            f"127.0.0.1:{port}", world, rank, log=log,
            device_type=device_type))
    deadline = compat.PhaseDeadline(timeout_s=60.0, log=log)
    out = {}
    if mode == "cuda":
        deadline.beat("collectives")
        out = check_collectives_on_the_card(rank, world)
        out["backend"] = distributed.backend()
        deadline.close()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        distributed.shutdown()
        return
    mesh = make_mesh(world, device="cpu")
    deadline.beat("mesh_sparse_apply")
    out["mesh_sparse_apply_exact"] = check_mesh_sparse_apply(mesh)
    if mode == "full":
        with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        rows = slice(rank * B, (rank + 1) * B)
        for case in CASES:
            deadline.beat(case)
            out[case] = run_port_case(case, inputs, rows, mesh)
        deadline.beat("twice")
        again = run_port_case("dense_f32", inputs, rows, mesh)
        out["twice_equal"] = again[0] == out["dense_f32"][0] and all(
            np.array_equal(again[1][k], out["dense_f32"][1][k])
            for k in again[1])
        deadline.beat("allreduce")
        big = distributed.allreduce_sum_hosts(
            [2.0 ** 52 + rank, 2.0 ** 24 + 1.0])
        out["allreduce"] = big.tolist()
        deadline.beat("trainer")
        out["trainer"] = run_trainer(inputs["prefix"], out_dir, rank)
    deadline.close()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    distributed.shutdown()


def run_trainer(prefix, out_dir, rank):
    """Two steps of the trainer's loop under the mesh, its sharded
    evaluation, a save to a directory of this rank's own."""
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    trainer = Code2VecTrainer.from_config(_trainer_config(prefix),
                                          device="cpu")
    losses = trainer.train(prefix + ".train.c2v", max_steps=2)
    res = trainer.evaluate()
    path = os.path.join(out_dir, f"ckpt_rank{rank}")
    trainer.save(path)
    trainer.close_session()
    return {"losses": losses, "eval": res, "ckpt": path,
            "identity": trainer.identity(),
            "host_shard": trainer.host_shard()}


if __name__ == "__main__":
    r_, w_, p_, d_, m_ = sys.argv[1:6]
    worker(int(r_), int(w_), p_, d_, m_)
    sys.exit(0)


# ---- the parent side ----

def _spawn(world, out_dir, mode):
    from code2vec_tpu_torch.parallel.compat import free_port
    from code2vec_tpu_torch.resilience import retry

    def once():
        port = str(free_port())
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, HERE, str(r), str(world), port, out_dir, mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        try:
            outs = [p.communicate(timeout=150)[0] for p in procs]
        except subprocess.TimeoutExpired:
            outs = ["worker timed out"] * world
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if not all(p.returncode == 0 for p in procs):
            raise RuntimeError("worker failed:\n" + "\n".join(
                f"rank {i} rc={p.returncode}:\n{o[-3000:]}"
                for i, (p, o) in enumerate(zip(procs, outs))))
        res = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
        return res

    return retry.transient_distributed(
        "torch-mp-fixture", max_attempts=3, base_delay_s=0.1,
        max_elapsed_s=200).call(once)


def _jax_inputs(case, rng_seed):
    """The JAX init params, the global batch (the last row padded) and
    the JAX step's draws at the global batch 2B."""
    import jax
    import jax.numpy as jnp

    from code2vec_tpu.models import encoder as jenc
    from code2vec_tpu.ops import sampled_softmax as jss
    from code2vec_tpu.ops.quant import is_quantized
    tables, encoder, sparse, sampled = CASES[case]
    jd = _dims(jenc, tables, encoder)
    r = np.random.default_rng(rng_seed + 1)
    G = 2 * B
    weights = np.ones((G,), np.float32)
    weights[-1] = 0.0
    ctx = (r.integers(0, VT, (G, C)).astype(np.int32),
           r.integers(0, VP, (G, C)).astype(np.int32),
           r.integers(0, VT, (G, C)).astype(np.int32),
           (r.random((G, C)) > 0.3).astype(np.float32))
    if case.startswith("vm_"):
        from code2vec_tpu.models.varmisuse import init_vm_params
        params = init_vm_params(jax.random.PRNGKey(rng_seed), jd)
        cand_mask = np.ones((G, K), np.float32)
        cand_mask[::3, -1] = 0.0
        batch = (r.integers(0, K - 1, G).astype(np.int32), *ctx,
                 r.integers(2, VT, (G, K)).astype(np.int32), cand_mask,
                 weights)
    else:
        params = jenc.init_params(jax.random.PRNGKey(rng_seed), jd)
        batch = (r.integers(0, VY, G).astype(np.int32), *ctx, weights)
    rng = jax.random.PRNGKey(100 + rng_seed)
    qkeys = sorted(k for k in ("token_emb", "path_emb")
                   if is_quantized(params[k]))
    salts = {}
    if sparse:
        drop_rng, sample_rng, *qrngs = jax.random.split(rng,
                                                        2 + len(qkeys))
    else:
        step_rng = rng
        qrngs = []
        if qkeys:
            step_rng, loss_rng, *qrngs = jax.random.split(rng,
                                                          2 + len(qkeys))
            step_rng = loss_rng
        drop_rng, sample_rng = jax.random.split(step_rng)
    salts = {k: int(np.asarray(jax.random.bits(q, dtype=jnp.uint32)))
             for k, q in zip(qkeys, qrngs)}
    keep = np.array(jax.random.bernoulli(drop_rng, KEEP, (G, C, 3 * E)))
    ids = (np.array(jss.log_uniform_sample(sample_rng, S, VY))
           if sampled else None)
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "batch": batch, "keep": keep, "sampled": ids, "salts": salts,
            "rng": rng}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    from helpers import build_tiny_dataset
    out_dir = str(tmp_path_factory.mktemp("torch_mp"))
    inputs = {case: _jax_inputs(case, i) for i, case in enumerate(CASES)}
    prefix = build_tiny_dataset(out_dir, n_train=40, n_val=13, n_test=8,
                                max_contexts=16)
    host = {case: {k: v for k, v in inp.items() if k != "rng"}
            for case, inp in inputs.items()}
    host["prefix"] = prefix
    with open(os.path.join(out_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(host, f)
    ranks = _spawn(2, out_dir, "full")
    return inputs, host, ranks, prefix


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _spawn(4, str(tmp_path_factory.mktemp("torch_mp4")), "apply")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _assert_bf16_close(a, b, k):
    """The dense-step tests' bf16 bound: within 2 * lr + 1 bf16 ulp of
    the largest value, 95% within the ulp (a gradient near 0 summed in
    another order may flip Adam's first step, ~lr)."""
    fa, fb = a.astype(np.float32), b.astype(np.float32)
    top, d = np.abs(fb).max(), np.abs(fa - fb)
    assert d.max() <= 2 * LR + BF16_ULP * top, k
    assert np.mean(d <= BF16_ULP * top) >= 0.95, k


def _assert_close(got, want, atol, q_tol=None):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        a, b = g[k], w[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if q_tol is not None and k.endswith("/q"):
            # an int8 table: q within 1 on at most q_tol of the elements,
            # the dequantized rows (its update went through the bf16
            # carrier) within the bf16 bound
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1 and np.mean(d > 0) <= q_tol, k
            s_key = k[:-2] + "/s"
            _assert_bf16_close(a * g[s_key], b * w[s_key], k)
            continue
        if q_tol is not None and k.endswith("/s"):
            continue  # with its q
        if b.dtype.name == "bfloat16":
            _assert_bf16_close(a, b, k)
            continue
        scale = np.abs(b.astype(np.float64)).max() if q_tol else 1.0
        np.testing.assert_allclose(a.astype(np.float64),
                                   b.astype(np.float64), rtol=0,
                                   atol=atol * max(scale, 1e-30), err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_end_each_step_with_the_same_bits(two_ranks, case):
    _inputs, _host, ranks, _ = two_ranks
    (l0, p0), (l1, p1) = ranks[0][case], ranks[1][case]
    assert l0 == l1 and np.isfinite(l0)
    a, b = dict(_leaves(p0)), dict(_leaves(p1))
    assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_one_process_over_the_concatenated_batch(
        two_ranks, case):
    _inputs, host, ranks, _ = two_ranks
    loss, params = run_port_case(case, host, slice(0, 2 * B), None)
    got_loss, got = ranks[0][case]
    np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
    int8 = CASES[case][0] == "int8"
    _assert_close(got, params, 1e-4 if int8 else 1e-5,
                  q_tol=1e-2 if int8 else None)


@pytest.mark.parametrize("case", ["dense_f32", "sparse_f32"])
def test_two_ranks_match_the_jax_packages_one_process_step(two_ranks,
                                                           case):
    import jax
    import jax.numpy as jnp

    from code2vec_tpu.models import encoder as jenc
    from code2vec_tpu.training import optimizers as jopt
    from code2vec_tpu.training.sparse_steps import (init_sparse_opt_state,
                                                    make_sparse_train_step)
    from code2vec_tpu.training.steps import make_train_step
    inputs, _host, ranks, _ = two_ranks
    inp = inputs[case]
    tables, encoder, sparse, sampled = CASES[case]
    jd = _dims(jenc, tables, encoder)
    params = jax.tree_util.tree_map(jnp.asarray, inp["params"])
    if sparse:
        dense_opt = jopt.make_optimizer(LR, "adam")
        state = init_sparse_opt_state(params, dense_opt, sampled)
        step = make_sparse_train_step(
            jd, learning_rate=LR, dense_optimizer=dense_opt,
            use_sampled_softmax=sampled, num_sampled=S,
            compute_dtype=jnp.float32, sparse_update_fused=False)
    else:
        from code2vec_tpu.ops.quant import opt_param_view
        tx = jopt.make_optimizer(jopt.make_lr(LR, "cosine", 10))
        state = tx.init(opt_param_view(params))
        step = make_train_step(jd, tx, use_sampled_softmax=sampled,
                               num_sampled=S, compute_dtype=jnp.float32)
    params, _state, loss = step(
        params, state, tuple(jnp.asarray(a) for a in inp["batch"]),
        inp["rng"])
    got_loss, got = ranks[0][case]
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    _assert_close(got, jax.tree_util.tree_map(np.asarray, params), 1e-5)


def test_the_same_two_rank_step_twice_gives_the_same_bits(two_ranks):
    assert all(r["twice_equal"] for r in two_ranks[2])


def test_mesh_sparse_apply_is_bit_identical_at_two_and_four_ranks(
        two_ranks, four_ranks):
    assert all(r["mesh_sparse_apply_exact"] for r in two_ranks[2])
    assert len(four_ranks) == 4
    assert all(r["mesh_sparse_apply_exact"] for r in four_ranks)


def test_allreduce_sum_hosts_is_exact_above_2_24(two_ranks):
    want = [2.0 ** 53 + 1.0, 2.0 ** 25 + 2.0]
    assert all(r["allreduce"] == want for r in two_ranks[2])


def test_trainer_under_the_mesh(two_ranks):
    """The trainer's two steps read disjoint host shards and end equal on
    both ranks; its sharded evaluation equals one process's evaluation of
    the saved checkpoint; rank 0 alone wrote the checkpoint, whose
    topology.json says 2 processes; the telemetry identity names the
    rank, the world and the backend."""
    import json

    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    _inputs, _host, ranks, prefix = two_ranks
    t0, t1 = ranks[0]["trainer"], ranks[1]["trainer"]
    assert len(t0["losses"]) == 2 and t0["losses"] == t1["losses"]
    assert (t0["host_shard"], t1["host_shard"]) == ((0, 2), (1, 2))
    assert t0["identity"] == {"process_index": 0, "process_count": 2,
                              "backend": "gloo"}
    assert t1["identity"]["process_index"] == 1
    assert t0["eval"] == t1["eval"]
    assert os.path.isdir(t0["ckpt"]) and not os.path.exists(t1["ckpt"])
    steps = [d for d in os.listdir(t0["ckpt"]) if d.startswith("step_")]
    assert steps == ["step_2"]
    with open(os.path.join(t0["ckpt"], "step_2", "topology.json")) as f:
        assert json.load(f)["num_processes"] == 2
    cfg = _trainer_config(prefix)
    cfg.load_path = t0["ckpt"]
    one = Code2VecTrainer.from_config(cfg, device="cpu").evaluate()
    got = t0["eval"]
    assert got.topk_acc == pytest.approx(one.topk_acc, abs=1e-6)
    assert got.subtoken_f1 == pytest.approx(one.subtoken_f1, abs=1e-6)
    assert got.loss == pytest.approx(one.loss, rel=1e-5)


@pytest.mark.cuda
def test_collectives_on_cuda_tensors_gloo_two_ranks_on_one_card(tmp_path):
    """Two ranks sharing the card take the gloo backend (the backend
    rule), and every collective the port uses accepts their CUDA
    tensors."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() != 1:
        pytest.skip("the shared-card arm needs exactly one card")
    for r in _spawn(2, str(tmp_path), "cuda"):
        assert r.pop("backend") == "gloo"
        assert all(r.values()), r


@pytest.mark.cuda
def test_collectives_on_the_card_nccl_world_one():
    """One rank on its own card takes nccl, and every collective the
    port uses runs on it."""
    import torch

    from code2vec_tpu_torch.parallel import compat, distributed
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert distributed.maybe_initialize(
        f"127.0.0.1:{compat.free_port()}", 1, 0, device_type="cuda")
    try:
        assert distributed.backend() == "nccl"
        got = check_collectives_on_the_card(0, 1)
        assert all(got.values()), got
    finally:
        distributed.shutdown()


def test_two_command_line_ranks_on_the_cpu(tmp_path):
    """`python3 -m code2vec_tpu_torch --backend cpu` twice with the
    `--dist_*` flags: both ranks exit 0 and train one epoch on their
    host shards; rank 0 alone writes the checkpoint, whose
    topology.json says 2 processes."""
    import json

    from code2vec_tpu_torch.parallel.compat import free_port
    from code2vec_tpu_torch.resilience import retry
    from helpers import build_tiny_dataset
    prefix = build_tiny_dataset(str(tmp_path), n_train=40, n_val=8,
                                n_test=8, max_contexts=16)
    ckpt = str(tmp_path / "ckpt")

    def once():
        port = free_port()
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "code2vec_tpu_torch", "--backend", "cpu",
             "--data", prefix, "--test", prefix + ".val.c2v", "--save",
             ckpt, "--max_contexts", "16", "--batch_size", "8",
             "--epochs", "1", "--async_checkpoint", "off",
             "--dist_coordinator", f"127.0.0.1:{port}",
             "--dist_num_processes", "2", "--dist_process_id", str(r),
             "--mesh_data", "2"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=120)[0] for p in procs]
        except subprocess.TimeoutExpired:
            outs = ["rank timed out"] * 2
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if not all(p.returncode == 0 for p in procs):
            raise RuntimeError("rank failed:\n" + "\n".join(
                o[-2000:] for o in outs))

    retry.transient_distributed("torch-mp-cli", max_attempts=2,
                                base_delay_s=0.1).call(once)
    steps = [d for d in os.listdir(ckpt) if d.startswith("step_")]
    assert steps == ["step_3"]  # ceil(ceil(40 / 2) / 8) steps a rank
    with open(os.path.join(ckpt, "step_3", "topology.json")) as f:
        topo = json.load(f)
    assert topo["num_processes"] == 2 and topo["epoch"] == 1

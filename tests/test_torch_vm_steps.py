"""The port's VarMisuse head (models/varmisuse.py, training/vm_steps.py,
training/sparse_update.rows_from_dense) against the JAX package's.

Both sides start from the same params (JAX `init_vm_params`, carried over
by `convert.params_from_numpy`) and optimizer state (the JAX optimizer's
`init`, carried over by convert.py), and take the same numpy batches at
E = 32, C = 64, K = 6, B = 32. The dropout keep mask is the JAX step's
own (`jax.random.bernoulli(rng, keep_rate, [B, C, 3E])` on the step's
key), handed to the port as `StepDraws`. The JAX side runs with
`use_pallas=False`, as its vm model does off a TPU; the port's pool on
CPU tensors is the plain version. Each batch has a padded candidate
slot in every row, a row of weight 0 and a row whose live candidates
are all one token (tied scores).

Tolerances, each test repeating its own:
- `vm_scores` / `vm_loss`, float32 tables and compute: within 8 float32
  ulp of the largest |score| (the pointer products sum E and D terms in
  another order than XLA) and the loss within 8 ulp; bf16 tables and
  compute: scores within 1e-2 of the largest |score| (the code vector is
  rounded to bf16 on both sides, and a value on a rounding edge moves a
  score by a bf16 step of the code) and the loss within 1e-3 relative;
- the dense step (Adafactor on the tables, Adam on the rest, cosine LR),
  float32: loss within 1e-5 relative; params within 2 * lr * steps of
  their largest value everywhere and within 1e-5 of it on 99% of the
  elements (Adam divides each gradient element by its own magnitude, so
  one whose gradient is within rounding of 0 moves by up to lr either
  way); optimizer state within 1e-4 of its largest value everywhere and
  1e-5 on 99%. bf16: the token table's three gradients (src, dst, cand)
  are bf16 [V, E] tensors summed in an order neither package fixes, so:
  loss within 1e-3 relative, each param within 2 * lr * steps + 1 bf16
  ulp of its largest value and 95% of the elements within 1 bf16 ulp,
  moments within 5e-2 of their largest value;
- the sparse-row step (constant LR, Adam, `fused=False` on the JAX side:
  its own Pallas path is not bit-exact to its XLA path): float32 tables
  under the float32 dense bounds above, the row moments too;
- `rows_from_dense` alone: tables and moments within 4 float32 ulp of
  their largest value (the row Adam's `pow` and division in two
  libraries), bf16 tables within 1 bf16 ulp; untouched rows identical;
- the eval step: loss_sum within 8 float32 ulp, correct_sum and pred
  identical (the tied row included: the lowest index wins on both).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from code2vec_tpu.models import encoder as jenc
from code2vec_tpu.models import varmisuse as jvm
from code2vec_tpu.training import optimizers as jopt
from code2vec_tpu.training import sparse_update as jsu
from code2vec_tpu.training import vm_steps as jsteps
from code2vec_tpu.training.sparse_adam import RowAdamState as JRowAdamState
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.models import varmisuse as tvm
from code2vec_tpu_torch.ops.sparse_update import RowAdamState
from code2vec_tpu_torch.training import optimizers as topt
from code2vec_tpu_torch.training import vm_steps as tsteps
from code2vec_tpu_torch.training.draws import StepDraws
from code2vec_tpu_torch.training.sparse_update import rows_from_dense
# the port's step updates in place and donates nothing
from code2vec_tpu_torch.training.vm_steps import \
    make_vm_train_step as make_port_vm_step
from torch_helpers import assert_close_f32_ulp, max_ulp_diff

LR = 0.01
B, C, E, K = 32, 64, 32, 6
VT, VP, VY = 90, 70, 10
HORIZON = 10
BF16_ULP = 2.0 ** -7
CPU = torch.device("cpu")
to_np = functools.partial(jax.tree_util.tree_map, np.asarray)


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _dims(module, tables_dtype):
    return module.ModelDims(token_vocab_size=VT, path_vocab_size=VP,
                            target_vocab_size=VY, embeddings_size=E,
                            max_contexts=C, tables_dtype=tables_dtype)


def _batch(r):
    """(labels, src, pth, dst, mask, cand_ids, cand_mask, weights): 5 live
    candidates a row (slot 5 padded), the label among them; row 0's live
    candidates all one token (five tied scores); the last row of weight
    0."""
    cand = np.stack([r.choice(VT, K, replace=False) for _ in range(B)])
    cand = cand.astype(np.int32)
    cand[0, :K - 1] = cand[0, 0]
    cand_mask = np.ones((B, K), np.float32)
    cand_mask[:, K - 1] = 0.0
    cand[:, K - 1] = 0
    labels = r.integers(0, K - 1, B).astype(np.int32)
    labels[0] = 1  # a tied candidate after the first: a miss
    weights = np.ones((B,), np.float32)
    weights[-1] = 0.0
    return (labels, r.integers(0, VT, (B, C)).astype(np.int32),
            r.integers(0, VP, (B, C)).astype(np.int32),
            r.integers(0, VT, (B, C)).astype(np.int32),
            (r.random((B, C)) > 0.3).astype(np.float32), cand, cand_mask,
            weights)


def _draws(rng, dims):
    keep = np.array(jax.random.bernoulli(rng, dims.dropout_keep_rate,
                                         (B, C, 3 * E)))
    return StepDraws(keep=torch.from_numpy(keep), sampled=None, salts={})


def _params(tables_dtype, seed=0):
    jd, td = _dims(jenc, tables_dtype), _dims(tenc, tables_dtype)
    jp = jvm.init_vm_params(jax.random.PRNGKey(seed), jd)
    return jd, td, jp, convert.params_from_numpy(to_np(jp), CPU)


def _tb(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def _jb(batch):
    return tuple(jnp.asarray(a) for a in batch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vm_scores_and_loss_match_jax(dtype):
    """Scores (eval forward) and the dropout loss from the same params and
    keep mask: float32 within 8 ulp of the largest score and of the loss;
    bf16 tables and compute within 1e-2 of the largest score and the loss
    within 1e-3 relative."""
    jd, td, jp, tp = _params(dtype)
    batch = _batch(np.random.default_rng(1))
    rng = jax.random.PRNGKey(7)
    cd_j, cd_t = getattr(jnp, dtype), getattr(torch, dtype)
    _l, src, pth, dst, mask, cand, cm, _w = batch
    js, _ = jvm.vm_scores(jp, *_jb((src, pth, dst, mask, cand, cm)),
                          compute_dtype=cd_j)
    ts, _ = tvm.vm_scores(tp, *_tb((src, pth, dst, mask, cand, cm)),
                          compute_dtype=cd_t)
    jl = jvm.vm_loss(jp, _jb(batch), dropout_rng=rng,
                     dropout_keep_rate=jd.dropout_keep_rate,
                     compute_dtype=cd_j)
    tl = tvm.vm_loss(tp, _tb(batch), keep=_draws(rng, jd).keep,
                     dropout_keep_rate=td.dropout_keep_rate,
                     compute_dtype=cd_t)
    js, ts = np.asarray(js), ts.numpy()
    assert ts.dtype == np.float32 and ts.shape == (B, K)
    np.testing.assert_array_equal(ts <= -1e8, js <= -1e8)
    live = js > -1e8
    if dtype == "float32":
        assert_close_f32_ulp(ts[live], js[live], 8)
        assert max_ulp_diff(tl.numpy(), np.asarray(jl)) <= 8
    else:
        top = np.abs(js[live]).max()
        assert np.abs(ts[live] - js[live]).max() <= 1e-2 * top
        assert abs(float(tl) - float(jl)) <= 1e-3 * abs(float(jl))


def _run_dense(dtype, steps, seed=0):
    jd, td, jp, tp = _params(dtype, seed)
    j_tx = jopt.make_optimizer(jopt.make_lr(LR, "cosine", HORIZON))
    js = j_tx.init(jp)
    ts = convert.dense_opt_state_from_numpy(to_np(js), CPU)
    cd = dtype
    jstep = jsteps.make_vm_train_step(jd, j_tx, compute_dtype=getattr(jnp, cd))
    tstep = make_port_vm_step(
        td, topt.make_optimizer(topt.make_lr(LR, "cosine", HORIZON)),
        compute_dtype=getattr(torch, cd))
    r = np.random.default_rng(seed + 1)
    losses = []
    for i in range(steps):
        batch = _batch(r)
        rng = jax.random.PRNGKey(100 + i)
        jp, js, jl = jstep(jp, js, _jb(batch), rng)
        tl = tstep(tp, ts, _tb(batch), _draws(rng, jd))
        losses.append((float(tl), float(jl)))
    return (convert.params_to_numpy(tp), to_np(jp),
            convert.dense_opt_state_to_numpy(ts), to_np(js), losses)


def _state_pairs(ts, js):
    got = jax.tree_util.tree_leaves(ts)
    ref = jax.tree_util.tree_leaves_with_path(js)
    assert len(got) == len(ref)
    for a, (path, b) in zip(got, ref):
        yield "state" + jax.tree_util.keystr(path), a, b


def _check_f32(name, a, b, steps):
    a, b = _f32(a), _f32(b)
    assert a.shape == b.shape, name
    top = np.abs(b).max()
    d = np.abs(a - b)
    if name.startswith("state"):
        assert d.max() <= 1e-4 * top, name
    else:
        assert d.max() <= 2 * LR * steps + 1e-5 * top, name
    assert np.mean(d <= 1e-5 * top) >= 0.99, name


def _check_bf16(name, a, b, steps):
    a, b = _f32(a), _f32(b)
    assert a.shape == b.shape, name
    top = np.abs(b).max()
    d = np.abs(a - b)
    if name.startswith("state"):
        assert d.max() <= 5e-2 * top, name
        return
    assert d.max() <= 2 * LR * steps + BF16_ULP * top, name
    assert np.mean(d <= BF16_ULP * top) >= 0.95, name


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_vm_step_matches_jax(dtype, steps):
    """The dense vm step (Adafactor tables, Adam on transform, attention
    and vm_pointer, cosine LR) against make_vm_train_step, 1 and 3 steps:
    float32 loss within 1e-5 relative, params within 2 * lr * steps of
    their largest value and within 1e-5 of it on 99% of the elements,
    state within 1e-4 (1e-5 on 99%); bf16 loss within 1e-3, params within
    2 * lr * steps + 1 bf16 ulp (95% within 1 ulp), moments within 5e-2.
    The state counts are equal, and `target_emb`, which the loss never
    reads, moves on neither side."""
    tp, jp, ts, js, losses = _run_dense(dtype, steps)
    rtol = 1e-5 if dtype == "float32" else 1e-3
    for tl, jl in losses:
        assert abs(tl - jl) <= rtol * abs(jl), losses
    check = _check_f32 if dtype == "float32" else _check_bf16
    for k in jp:
        check(k, tp[k], jp[k], steps)
    for name, a, b in _state_pairs(ts, js):
        if name.endswith(".count"):
            assert int(a) == int(b) == steps, name
        else:
            check(name, a, b, steps)
    _, _, jp0, _ = _params(dtype)
    np.testing.assert_array_equal(_f32(tp["target_emb"]),
                                  _f32(jp0["target_emb"]))


def _run_sparse(dtype, steps, seed=0):
    jd, td, jp, tp = _params(dtype, seed)
    j_tx = jopt.make_optimizer(LR, "adam")
    js = jsteps.init_vm_sparse_opt_state(jp, j_tx)
    ts = convert.sparse_opt_state_from_numpy(to_np(js), CPU)
    jstep = jsteps.make_vm_train_step(jd, j_tx, sparse_updates=True,
                                      learning_rate=LR,
                                      sparse_update_fused=False)
    tstep = make_port_vm_step(td, topt.AdamF32Moments(LR),
                                      sparse_updates=True)
    r = np.random.default_rng(seed + 1)
    losses = []
    for i in range(steps):
        batch = _batch(r)
        rng = jax.random.PRNGKey(200 + i)
        jp, js, jl = jstep(jp, js, _jb(batch), rng)
        tl = tstep(tp, ts, _tb(batch), _draws(rng, jd))
        losses.append((float(tl), float(jl)))
    return (convert.params_to_numpy(tp), to_np(jp),
            convert.sparse_opt_state_to_numpy(ts), to_np(js), losses)


@pytest.mark.parametrize("steps", [1, 3])
def test_sparse_vm_step_matches_jax(steps):
    """The sparse-row vm step (float32 tables, Adam, constant LR) against
    make_vm_train_step(sparse_updates=True, sparse_update_fused=False):
    loss within 1e-5 relative; params, the row moments and the dense
    Adam state under the float32 dense bounds; the step counts equal."""
    tp, jp, ts, js, losses = _run_sparse("float32", steps)
    for tl, jl in losses:
        assert abs(tl - jl) <= 1e-5 * abs(jl), losses
    for k in jp:
        _check_f32(k, tp[k], jp[k], steps)
    assert int(ts["count"]) == int(js["count"]) == steps
    for k, st in js["rows"].items():
        _check_f32(f"state.rows.{k}.m", ts["rows"][k]["m"], st.m, steps)
        _check_f32(f"state.rows.{k}.v", ts["rows"][k]["v"], st.v, steps)
    adam = js["dense"][0]
    assert int(ts["dense"]["count"]) == int(adam.count) == steps
    assert set(ts["dense"]["mu"]) == set(adam.mu) == {
        "target_emb", "transform", "attention", "vm_pointer"}
    for k in adam.mu:
        _check_f32(f"state.mu.{k}", ts["dense"]["mu"][k], adam.mu[k], steps)
        _check_f32(f"state.nu.{k}", ts["dense"]["nu"][k], adam.nu[k], steps)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_from_dense_matches_jax(dtype, use_kernel):
    """rows_from_dense on a [V, E] table, its moments (nonzero) and a
    dense gradient, over ids with repeats, at step count 3: float32
    tables and the moments within 4 float32 ulp of their largest value,
    bf16 tables within 1 bf16 ulp; the rows not in the ids identical.
    `use_kernel=True` on CPU tensors is the kernel wrapper's plain
    version."""
    r = np.random.default_rng(5)
    V = 300
    table = r.normal(size=(V, E)).astype(np.float32) * 0.1
    m = r.normal(size=(V, E)).astype(np.float32) * 1e-3
    v = np.abs(r.normal(size=(V, E))).astype(np.float32) * 1e-5
    grad = r.normal(size=(V, E)).astype(np.float32) * 1e-2
    ids = r.integers(0, V // 2, 500).astype(np.int32)
    jt = jnp.asarray(table, getattr(jnp, dtype))
    jt2, jst = jsu.rows_from_dense(
        jt, JRowAdamState(m=jnp.asarray(m), v=jnp.asarray(v)),
        jnp.asarray(grad, getattr(jnp, dtype)), jnp.asarray(ids),
        count=jnp.asarray(3, jnp.int32), lr=LR, fused=False)
    tt = convert.params_from_numpy({"t": np.asarray(jt)}, CPU)["t"]
    st = RowAdamState(m=torch.from_numpy(m.copy()),
                      v=torch.from_numpy(v.copy()))
    tg = convert.params_from_numpy(
        {"g": np.asarray(jnp.asarray(grad, getattr(jnp, dtype)))}, CPU)["g"]
    u = rows_from_dense(tt, st, tg, torch.from_numpy(ids),
                        count=torch.tensor(3, dtype=torch.int32), lr=LR,
                        use_kernel=use_kernel)
    assert u == len(np.unique(ids))
    got, ref = _f32(convert.params_to_numpy({"t": tt})["t"]), _f32(jt2)
    untouched = np.setdiff1d(np.arange(V), ids)
    np.testing.assert_array_equal(got[untouched], _f32(table.astype(
        np.asarray(jt).dtype))[untouched])
    if dtype == "float32":
        assert_close_f32_ulp(got, ref, 4)
    else:
        assert np.abs(got - ref).max() <= BF16_ULP * np.abs(ref).max()
    assert_close_f32_ulp(st.m.numpy(), np.asarray(jst.m), 4)
    assert_close_f32_ulp(st.v.numpy(), np.asarray(jst.v), 4)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_vm_eval_step_matches_jax(use_kernel):
    """(loss_sum, correct_sum, pred) of the eval step, float32, after one
    dense training step (so the pointer has learnt something): loss_sum
    within 8 float32 ulp, correct_sum and every pred identical; in the
    tied row both take candidate 0, and its label (1) counts as a miss.
    `use_kernel=True` on CPU tensors is the pool kernel's plain float32
    version."""
    tp, jp, _ts, _js, _l = _run_dense("float32", 1, seed=3)
    tp = convert.params_from_numpy(tp, CPU)
    jd = _dims(jenc, "float32")
    batch = _batch(np.random.default_rng(11))
    jls, jcs, jpred = jsteps.make_vm_eval_step(jd)(
        {k: jnp.asarray(v) for k, v in jp.items()}, _jb(batch))
    tls, tcs, tpred = tsteps.vm_eval_step(tp, _tb(batch),
                                          use_kernel=use_kernel)
    assert max_ulp_diff(tls.numpy(), np.asarray(jls)) <= 8
    assert float(tcs) == float(jcs)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    assert int(tpred[0]) == 0


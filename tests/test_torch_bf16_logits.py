"""The port's float32 logits from bf16 operands against the JAX
package's jitted functions.

Under `jax.jit`, XLA folds `(code @ table.T).astype(float32)` into one
product with a float32 output: the logits are never rounded to bf16
(eager JAX rounds them; every JAX step, evaluation and attack is
jitted). The port's `ops/logits.rows_product_f32` computes the same
product; a plain `(a @ b).to(float32)` rounds it to bf16 and misses
these bounds by a bf16 ulp of the logits (~1e-1 at D = 384).

- `logits_vs_table`: each logit within 4 float32 ulp of the sum of
  |a_d * b_d| over its D terms (the two sides add the same exact
  products in different orders), padded rows at -1e9.
- `sampled_softmax_from_gathered` under `jax.jit(jax.value_and_grad)`:
  the loss within 1e-6 relative; the sampled logits follow the jitted
  product, the true logits stay rounded to bf16 once (XLA keeps the
  jitted elementwise products and their sum in float32 and rounds the
  sum), so the bf16 code vectors' gradient agrees within 1 bf16 ulp of
  its largest entry and float32 rows' gradients within 1e-5 of theirs.
- one bf16-compute dense step of the code2vec head with full softmax
  against the jitted `make_train_step` (draws injected): the loss within
  1e-6 relative (the bf16-rounded logits miss it by 2e-5; the dense-step
  tests allow 1e-3 for bf16); each param within the dense-step tests'
  bf16 bound.
The card's `mm.dtype` branch is held against the CPU branch in
tests/test_torch_logits_card.py (`cuda`) and chip_smoke.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.models import encoder as jenc
from code2vec_tpu.ops import sampled_softmax as jss
from code2vec_tpu.training import optimizers as jopt
from code2vec_tpu.training.steps import make_train_step as j_make_train_step
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.ops import sampled_softmax as tss
from code2vec_tpu_torch.training import optimizers as topt
from code2vec_tpu_torch.training.draws import StepDraws
from code2vec_tpu_torch.training.steps import \
    make_train_step as t_make_train_step

B, D, V, V_PAD = 8, 384, 1000, 1024
ULP32 = 2.0 ** -23
BF16_ULP = 2.0 ** -7
CPU = torch.device("cpu")


def _bf16(r, shape, scale=1.0):
    """bf16 values (as float32 numpy) from a seeded normal."""
    x = jnp.asarray(r.normal(size=shape) * scale, jnp.bfloat16)
    return np.array(x.astype(jnp.float32))


def _t_bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _f32_product_bound(a, b_rows, n=4):
    """n float32 ulp of sum_d |a[i, d] * b[j, d]| per logit."""
    return n * ULP32 * (np.abs(a).astype(np.float64)
                        @ np.abs(b_rows).astype(np.float64).T)


def test_logits_vs_table_matches_jitted_jax():
    r = np.random.default_rng(0)
    a = _bf16(r, (B, D))
    table = _bf16(r, (V_PAD, D), 0.1)
    jitted = jax.jit(jenc.logits_vs_table, static_argnums=2)
    want = np.asarray(jitted(jnp.asarray(table, jnp.bfloat16),
                             jnp.asarray(a, jnp.bfloat16), V))
    got = tenc.logits_vs_table(_t_bf16(table), _t_bf16(a), V)
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(got[:, V:], -1e9)
    np.testing.assert_array_equal(want[:, V:], -1e9)
    tol = _f32_product_bound(a, table)[:, :V]
    assert np.all(np.abs(got[:, :V] - want[:, :V]) <= tol)
    # the bound is a float32 one: the bf16-rounded product is far off it
    rounded = (_t_bf16(a) @ _t_bf16(table)[:V].T).float().numpy()
    assert np.abs(rounded - want[:, :V]).max() > 1e3 * tol.max()


@pytest.mark.parametrize("rows_dtype", ["bfloat16", "float32"])
def test_sampled_softmax_value_and_grads_match_jitted_jax(rows_dtype):
    r = np.random.default_rng(1)
    S, Dc = 64, 128
    code = _bf16(r, (B, Dc))
    true_w = _bf16(r, (B, Dc), 0.3)
    samp_w = _bf16(r, (S, Dc), 0.3)
    if rows_dtype == "float32":
        true_w = true_w + r.normal(size=true_w.shape).astype(np.float32) \
            * 1e-3
        samp_w = samp_w + r.normal(size=samp_w.shape).astype(np.float32) \
            * 1e-3
    labels = r.integers(0, 300, B).astype(np.int32)
    sampled = r.integers(0, 300, S).astype(np.int32)
    sampled[:2] = labels[:2]  # two accidental hits
    true_corr = r.normal(size=B).astype(np.float32)
    samp_corr = r.normal(size=S).astype(np.float32)
    weights = np.ones(B, np.float32)
    weights[-1] = 0.0
    acc = sampled[None, :] == labels[:, None]
    jdt = getattr(jnp, rows_dtype)

    def jloss(c, tw, sw):
        return jss.sampled_softmax_from_gathered(
            c, tw, sw, jnp.asarray(true_corr), jnp.asarray(samp_corr),
            jnp.asarray(acc), jnp.asarray(weights))

    jitted = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))
    jv, jg = jitted(jnp.asarray(code, jnp.bfloat16),
                    jnp.asarray(true_w, jdt), jnp.asarray(samp_w, jdt))
    tdt = getattr(torch, rows_dtype)
    leaves = [_t_bf16(code), torch.from_numpy(true_w).to(tdt),
              torch.from_numpy(samp_w).to(tdt)]
    for t in leaves:
        t.requires_grad_(True)
    tv = tss.sampled_softmax_from_gathered(
        *leaves, torch.from_numpy(true_corr), torch.from_numpy(samp_corr),
        torch.from_numpy(acc), torch.from_numpy(weights))
    tg = torch.autograd.grad(tv, leaves)
    assert abs(tv.item() - float(jv)) <= 1e-6 * abs(float(jv))
    for name, g, want in zip(("code", "true_w", "samp_w"), tg, jg):
        assert g.dtype == leaves[["code", "true_w", "samp_w"].index(
            name)].dtype, name
        g = g.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        top = np.abs(want).max()
        tol = (BF16_ULP if name == "code" or rows_dtype == "bfloat16"
               else 1e-5) * top
        np.testing.assert_allclose(g, want, rtol=0, atol=tol, err_msg=name)


def _dense_dims(module):
    return module.ModelDims(token_vocab_size=40, path_vocab_size=30,
                            target_vocab_size=50, embeddings_size=16,
                            max_contexts=8, vocab_pad_multiple=4,
                            tables_dtype="bfloat16")


def test_bf16_dense_step_full_softmax_matches_jitted_jax():
    LR = 0.01
    jd, td = _dense_dims(jenc), _dense_dims(tenc)
    jp = jenc.init_params(jax.random.PRNGKey(3), jd)
    j_tx = jopt.make_optimizer(jopt.make_lr(LR, "cosine", 10))
    from code2vec_tpu.ops.quant import opt_param_view as j_view
    js = j_tx.init(j_view(jp))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   CPU)
    ts = convert.dense_opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), CPU)
    jstep = j_make_train_step(jd, j_tx, compute_dtype=jnp.bfloat16)
    tstep = t_make_train_step(
        td, topt.make_optimizer(topt.make_lr(LR, "cosine", 10)),
        compute_dtype=torch.bfloat16)
    r = np.random.default_rng(4)
    Bs, C, E = 6, 8, 16
    weights = np.ones(Bs, np.float32)
    weights[-1] = 0.0
    batch = (r.integers(0, 50, Bs).astype(np.int32),
             r.integers(0, 40, (Bs, C)).astype(np.int32),
             r.integers(0, 30, (Bs, C)).astype(np.int32),
             r.integers(0, 40, (Bs, C)).astype(np.int32),
             (r.random((Bs, C)) > 0.3).astype(np.float32), weights)
    rng = jax.random.PRNGKey(9)
    drop_rng, _ = jax.random.split(rng)
    keep = np.array(jax.random.bernoulli(drop_rng, jd.dropout_keep_rate,
                                         (Bs, C, 3 * E)))
    draws = StepDraws(keep=torch.from_numpy(keep), sampled=None, salts={})
    jp, js, jl = jstep(jp, js, tuple(jnp.asarray(a) for a in batch), rng)
    tl = tstep(tp, ts, tuple(torch.from_numpy(a) for a in batch), draws)
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    got = convert.params_to_numpy(tp)
    for k, ref in jp.items():
        a = np.asarray(got[k]).astype(np.float32)
        b = np.asarray(ref).astype(np.float32)
        top = np.abs(b).max()
        d = np.abs(a - b)
        assert d.max() <= 2 * LR + BF16_ULP * top, k
        assert np.mean(d <= BF16_ULP * top) >= 0.95, k

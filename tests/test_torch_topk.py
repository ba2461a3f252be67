"""The port's top-k order against `jax.lax.top_k` on exact ties.

`jax.lax.top_k`, which the JAX package's eval and predict steps call,
puts the lowest id first among equal values; `torch.topk` gives no such
order. The port's `training/steps.topk_stable` must give the reference's
ids id for id and in order, also where several ids tie with the k-th
value and where a whole row is one value. Each test hands one float32
probability array to both functions, so the comparison is exact: no
tolerance. Ties through the steps come from duplicated `target_emb`
rows (equal rows give equal logits) and from a method with no context
(a zero code vector gives every class the same logit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.models import encoder as jenc
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.training.steps import (eval_step, predict_head,
                                               topk_stable)

TOP_K = 10


def _lax_top_k(probs: np.ndarray, k: int):
    values, ids = jax.lax.top_k(jnp.asarray(probs, jnp.float32), k)
    return np.asarray(values), np.asarray(ids)


def _ties_in_topk(values: np.ndarray) -> int:
    """Adjacent equal values inside the top-k, over all rows."""
    return int((values[:, 1:] == values[:, :-1]).sum())


def _probs(case: str, r) -> np.ndarray:
    if case == "few_values":  # every row drawn from five values
        return (r.integers(0, 5, (6, 300)) / 8.0).astype(np.float32)
    if case == "kth_boundary":  # 14 ids share the 10th value
        p = np.full((3, 64), 0.01, np.float32)
        for i in range(3):
            p[i, r.permutation(64)[:14]] = 0.25
            p[i, r.permutation(64)[:3]] = [0.9, 0.8, 0.7]
        return p
    if case == "whole_row":  # one value everywhere, and all zeros
        return np.stack([np.full(40, 0.025, np.float32),
                         np.zeros(40, np.float32)])
    if case == "zeros_at_boundary":  # fewer nonzero values than k
        p = np.zeros((4, 50), np.float32)
        for i in range(4):
            p[i, r.permutation(50)[:6]] = r.random(6).astype(np.float32)
        return p
    raise ValueError(case)


@pytest.mark.parametrize("case", ["few_values", "kth_boundary", "whole_row",
                                  "zeros_at_boundary"])
def test_topk_stable_matches_lax_top_k(case):
    """topk_stable gives jax.lax.top_k's values and ids exactly, ties
    included, on arrays built to tie inside the top-k and at its edge."""
    probs = _probs(case, np.random.default_rng(0))
    want_v, want_i = _lax_top_k(probs, TOP_K)
    got_v, got_i = topk_stable(torch.from_numpy(probs), TOP_K)
    assert got_i.dtype == torch.int64 and got_v.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert _ties_in_topk(want_v) > 0  # the case does tie


def _head(tables_dtype: str):
    """dims and params with target rows 5..18 copies of rows 0..4, and a
    batch whose method 0 has no context."""
    kw = dict(token_vocab_size=41, path_vocab_size=23, target_vocab_size=19,
              embeddings_size=8, max_contexts=16, vocab_pad_multiple=4,
              tables_dtype=tables_dtype)
    jdims, tdims = jenc.ModelDims(**kw), tenc.ModelDims(**kw)
    ref = jax.tree_util.tree_map(
        np.asarray, jenc.init_params(jax.random.PRNGKey(4), jdims))
    tgt = ref["target_emb"].astype(np.float32) * 10
    for j in range(5, 19):
        tgt[j] = tgt[j % 5]
    ref["target_emb"] = tgt.astype(ref["target_emb"].dtype)
    r = np.random.default_rng(4)
    B, C = 9, 16
    batch = (r.integers(0, 19, B).astype(np.int32),
             r.integers(0, 41, (B, C)).astype(np.int32),
             r.integers(0, 23, (B, C)).astype(np.int32),
             r.integers(0, 41, (B, C)).astype(np.int32),
             (r.random((B, C)) > 0.4).astype(np.float32),
             np.ones((B,), np.float32))
    batch[4][0] = 0.0
    params = convert.params_from_numpy(ref, device="cpu")
    return tdims, params, tuple(torch.from_numpy(a) for a in batch)


def _port_probs(params, code, dims) -> np.ndarray:
    """The full-softmax probabilities the port's steps rank."""
    logits = tenc.full_logits(params, code, dims.target_vocab_size)
    return torch.softmax(logits, dim=-1).numpy()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("tables_dtype", ["float32", "bfloat16"])
def test_eval_step_tie_order_matches_lax_top_k(tables_dtype, compute):
    """eval_step's top-k ids and probabilities are jax.lax.top_k's over
    the same float32 probabilities, id for id, with duplicated target
    rows tying in every row and method 0 a whole row of one value."""
    dims, params, batch = _head(tables_dtype)
    dtype = getattr(torch, compute)
    with torch.inference_mode():
        _loss, ids, probs = eval_step(params, batch, dims=dims, top_k=TOP_K,
                                      compute_dtype=dtype)
        code, _ = tenc.get_encode_fn(dims)(params, *batch[1:5],
                                           compute_dtype=dtype)
        full = _port_probs(params, code, dims)
    want_v, want_i = _lax_top_k(full, TOP_K)
    np.testing.assert_array_equal(ids.numpy(), want_i)
    np.testing.assert_array_equal(probs.numpy(), want_v)
    np.testing.assert_array_equal(want_i[0], np.arange(TOP_K))
    assert _ties_in_topk(want_v) >= batch[0].shape[0]


@pytest.mark.parametrize("tables_dtype", ["float32", "bfloat16"])
def test_predict_head_tie_order_matches_lax_top_k(tables_dtype):
    """predict_head (the predict step's and the server's head) gives
    jax.lax.top_k's ids and probabilities over the same probabilities,
    on code vectors that tie through duplicated target rows and a zero
    code vector (a whole row of one value)."""
    dims, params, _batch = _head(tables_dtype)
    r = np.random.default_rng(5)
    code = r.normal(size=(6, dims.code_vector_size)).astype(np.float32)
    code[0] = 0.0
    code = torch.from_numpy(code)
    with torch.inference_mode():
        ids, probs = predict_head(params, code, dims, TOP_K)
        full = _port_probs(params, code, dims)
    want_v, want_i = _lax_top_k(full, TOP_K)
    np.testing.assert_array_equal(ids.numpy(), want_i)
    np.testing.assert_array_equal(probs.numpy(), want_v)
    np.testing.assert_array_equal(want_i[0], np.arange(TOP_K))
    assert _ties_in_topk(want_v) >= code.shape[0]

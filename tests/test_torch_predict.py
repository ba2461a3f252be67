"""The port's predict step against the JAX package's `make_predict_step`.

Weights come from JAX `init_params` and are carried over bit for bit;
the batch is numpy from a seed. Both kernel settings are covered: the
port's kernel wrapper (plain float32 version on CPU tensors) against the
Pallas kernel in interpret mode, and the plain pool against the XLA
pool.

Tolerances: float32 compute agrees to 1e-5 on probabilities, attention
and code. bf16 compute agrees to 3e-2 relative on probabilities: the
logits are rounded to bf16 (8 bits) at a few units here, so a logit may
move by ~1e-2 in each framework. Attention agrees to 1e-2 and the code
vector to 2e-2, since bf16 keeps 8 bits and the frameworks round
intermediates at different places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.models import encoder as jenc
from code2vec_tpu.training.steps import make_predict_step
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.training.steps import encode_step, predict_step
from torch_helpers import assert_topk_agree

TOP_K = 10


def _setup(tables_dtype, seed=0, B=11, C=16):
    kw = dict(token_vocab_size=41, path_vocab_size=23, target_vocab_size=19,
              embeddings_size=8, max_contexts=C, vocab_pad_multiple=4,
              tables_dtype=tables_dtype)
    jdims, tdims = jenc.ModelDims(**kw), tenc.ModelDims(**kw)
    ref = jax.tree_util.tree_map(
        np.asarray, jenc.init_params(jax.random.PRNGKey(seed), jdims))
    # sharpen the head so the top-k order is well separated
    ref["target_emb"] = (ref["target_emb"].astype(np.float32) * 10).astype(
        ref["target_emb"].dtype)
    r = np.random.default_rng(seed)
    batch = (np.zeros((B,), np.int32),
             r.integers(0, 41, (B, C)).astype(np.int32),
             r.integers(0, 23, (B, C)).astype(np.int32),
             r.integers(0, 41, (B, C)).astype(np.int32),
             (r.random((B, C)) > 0.4).astype(np.float32),
             np.ones((B,), np.float32))
    batch[4][0] = 0.0  # a method with no context
    return jdims, tdims, ref, batch


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("tables_dtype", ["float32", "bfloat16"])
def test_predict_step_matches_jax(tables_dtype, compute, use_kernel):
    jdims, tdims, ref, batch = _setup(tables_dtype)
    step = make_predict_step(jdims, top_k=TOP_K,
                             compute_dtype=getattr(jnp, compute),
                             use_pallas=use_kernel)
    ids_j, probs_j, attn_j, code_j = (np.asarray(x) for x in step(ref, batch))
    params = convert.params_from_numpy(ref, device="cpu")
    tbatch = tuple(torch.from_numpy(a) for a in batch)
    with torch.inference_mode():
        ids_t, probs_t, attn_t, code_t = predict_step(
            params, tbatch, dims=tdims, top_k=TOP_K,
            compute_dtype=getattr(torch, compute), use_kernel=use_kernel)
    assert code_t.dtype == torch.float32 and attn_t.dtype == torch.float32
    f32 = compute == "float32"
    checked = assert_topk_agree(ids_t.numpy(), probs_t.numpy(), ids_j,
                                probs_j, 1e-5 if f32 else 0.0,
                                rtol=0.0 if f32 else 3e-2)
    assert checked >= batch[0].shape[0]  # at least the top-1 of each row
    attn_tol = 1e-5 if (f32 or use_kernel) else 1e-2
    code_tol = 1e-5 if f32 else (8e-3 if use_kernel else 2e-2)
    np.testing.assert_allclose(attn_t.numpy(), attn_j, atol=attn_tol)
    np.testing.assert_allclose(code_t.numpy(), code_j, atol=code_tol)
    assert np.all(attn_t.numpy()[0] == 0) and np.all(code_t.numpy()[0] == 0)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_encode_step_is_the_predict_code_vector(compute):
    _, tdims, ref, batch = _setup("bfloat16", seed=3)
    params = convert.params_from_numpy(ref, device="cpu")
    tbatch = tuple(torch.from_numpy(a) for a in batch)
    dt = getattr(torch, compute)
    with torch.inference_mode():
        code = encode_step(params, tbatch, dims=tdims, compute_dtype=dt,
                           use_kernel=True)
        *_, code_p = predict_step(params, tbatch, dims=tdims, top_k=TOP_K,
                                  compute_dtype=dt, use_kernel=True)
    assert code.dtype == torch.float32 and torch.equal(code, code_p)

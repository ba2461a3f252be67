"""The port's encoder against the JAX package's, on carried-over weights.

JAX `init_params` makes the weights (float32, bf16 and int8 tables);
`convert.params_from_numpy` carries them to the port bit for bit. The same
numpy ids and mask then go through both `encode` / `full_logits`.

Tolerances: float32 compute agrees to 1e-5 absolute (same arithmetic,
another summation order); bf16 compute to 2e-2 on the code vector and
1e-2 on the attention weights (bf16 keeps 8 bits and the frameworks round
intermediates at different places), and logits to 1e-2 (a bf16 product
of [D] x [D] at |x| < 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.models import encoder as jenc
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.models import encoder as tenc

TABLES = ["float32", "bfloat16", "int8"]


def _dims(module, tables_dtype, pad_multiple=8):
    return module.ModelDims(token_vocab_size=37, path_vocab_size=29,
                            target_vocab_size=19, embeddings_size=8,
                            max_contexts=12, vocab_pad_multiple=pad_multiple,
                            tables_dtype=tables_dtype)


def _jax_params(tables_dtype, seed=0):
    p = jenc.init_params(jax.random.PRNGKey(seed), _dims(jenc, tables_dtype))
    return jax.tree_util.tree_map(np.asarray, p)


def _bits_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bits_equal(a[k], b[k]) for k in a)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def _batch(seed, dims, B=6):
    r = np.random.default_rng(seed)
    C = dims.max_contexts
    src = r.integers(0, dims.token_vocab_size, (B, C)).astype(np.int32)
    pth = r.integers(0, dims.path_vocab_size, (B, C)).astype(np.int32)
    dst = r.integers(0, dims.token_vocab_size, (B, C)).astype(np.int32)
    mask = (r.random((B, C)) > 0.3).astype(np.float32)
    mask[0] = 0.0
    mask[1] = 1.0
    return src, pth, dst, mask


@pytest.mark.parametrize("tables_dtype", TABLES)
def test_params_round_trip_is_bit_equal(tables_dtype):
    ref = _jax_params(tables_dtype)
    params = convert.params_from_numpy(ref, device="cpu")
    if tables_dtype == "int8":
        assert params["token_emb"]["q"].dtype == torch.int8
        assert params["target_emb"].dtype == torch.bfloat16
    else:
        assert params["token_emb"].dtype == getattr(torch, tables_dtype)
    assert params["transform"].dtype == torch.float32
    assert _bits_equal(convert.params_to_numpy(params), ref)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("tables_dtype", TABLES)
def test_encode_matches_jax(tables_dtype, compute, use_kernel):
    ref = _jax_params(tables_dtype, seed=1)
    params = convert.params_from_numpy(ref, device="cpu")
    dims = _dims(jenc, tables_dtype)
    src, pth, dst, mask = _batch(2, dims)
    jdt, tdt = getattr(jnp, compute), getattr(torch, compute)
    code_j, attn_j = jenc.encode(
        ref, jnp.asarray(src), jnp.asarray(pth), jnp.asarray(dst),
        jnp.asarray(mask), compute_dtype=jdt, use_pallas=use_kernel)
    code_t, attn_t = tenc.encode(
        params, torch.from_numpy(src), torch.from_numpy(pth),
        torch.from_numpy(dst), torch.from_numpy(mask), compute_dtype=tdt,
        use_kernel=use_kernel)
    assert code_t.dtype == tdt and attn_t.dtype == torch.float32
    # the kernel path pools in float32 and casts once, like the Pallas
    # kernel; the plain path pools in the compute dtype
    f32_pool = compute == "float32" or use_kernel
    code_tol, attn_tol = (1e-5, 1e-5) if f32_pool else (2e-2, 1e-2)
    if compute == "bfloat16" and use_kernel:
        code_tol = 8e-3  # one bf16 rounding of the same float32 value
    np.testing.assert_allclose(code_t.float().numpy(),
                               np.asarray(code_j, np.float32), atol=code_tol)
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_j),
                               atol=attn_tol)
    assert np.all(attn_t.numpy()[0] == 0) and np.all(
        code_t.float().numpy()[0] == 0)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("tables_dtype", TABLES)
def test_full_logits_matches_jax_and_masks_padding(tables_dtype, compute):
    ref = _jax_params(tables_dtype, seed=3)
    params = convert.params_from_numpy(ref, device="cpu")
    dims = _dims(jenc, tables_dtype)
    D = dims.context_vector_size
    code = np.random.default_rng(4).uniform(-1, 1, (5, D)).astype(np.float32)
    jdt, tdt = getattr(jnp, compute), getattr(torch, compute)
    logits_j = np.asarray(jenc.full_logits(ref, jnp.asarray(code, jdt),
                                           dims.target_vocab_size))
    logits_t = tenc.full_logits(params, torch.from_numpy(code).to(tdt),
                                dims.target_vocab_size).numpy()
    assert logits_t.dtype == np.float32
    V = dims.target_vocab_size
    assert logits_t.shape == (5, dims.padded(V)) and dims.padded(V) > V
    assert np.all(logits_t[:, V:] == -1e9)
    tol = 1e-5 if compute == "float32" else 1e-2
    np.testing.assert_allclose(logits_t, logits_j, atol=tol)


def test_take_rows_int8_dequantizes_to_bf16():
    ref = _jax_params("int8", seed=5)
    params = convert.params_from_numpy(ref, device="cpu")
    ids = np.array([[0, 3, 36], [5, 5, 1]], np.int32)
    rows_j = jenc.take_rows(ref, "token_emb", jnp.asarray(ids))
    rows_t = tenc.take_rows(params, "token_emb", torch.from_numpy(ids))
    assert rows_t.dtype == torch.bfloat16 and rows_t.shape == (2, 3, 8)
    assert np.array_equal(rows_t.float().numpy(),
                          np.asarray(rows_j, np.float32))


@pytest.mark.parametrize("tables_dtype", TABLES)
def test_torch_init_params_shapes_dtypes_and_scale(tables_dtype):
    dims = _dims(tenc, tables_dtype)
    g = torch.Generator(device="cpu").manual_seed(0)
    p = tenc.init_params(g, dims)
    ref = _jax_params(tables_dtype)

    def spec(x):
        if isinstance(x, dict):
            return {k: spec(v) for k, v in x.items()}
        return (tuple(x.shape), str(x.dtype).replace("torch.", ""))
    assert spec(p) == spec(ref)
    # the same variance-scaling limit: sqrt(3 / fan_avg)
    D = dims.context_vector_size
    limit = np.sqrt(3.0 / D)
    assert p["transform"].abs().max().item() <= limit
    assert p["transform"].abs().max().item() > 0.9 * limit
    again = tenc.init_params(torch.Generator().manual_seed(0), dims)
    assert torch.equal(again["transform"], p["transform"])

"""The port's attention pool against the JAX package's, on the CPU.

The same numpy inputs (made from a seed) go through
`code2vec_tpu.ops.attention.attention_pool` and the port's plain
`attention_pool`, and through the Pallas kernel in interpret mode and the
port's kernel wrapper, which on CPU tensors takes its plain version.

Tolerances: float32 paths agree to 1e-5 absolute (the same float32
arithmetic summed in another order over D <= 384); bf16 paths to 2e-2 on
the code vector (bf16 keeps 8 bits, ~4e-3 relative, and the two
frameworks round the matmul and tanh outputs at different places) and
1e-2 on the attention weights (float32 softmax over bf16 scores).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.ops.attention import attention_pool as jax_attention_pool
from code2vec_tpu.ops.pallas_attention import attention_pool_pallas
from code2vec_tpu_torch.ops.attention import attention_pool
from code2vec_tpu_torch.ops.attention_kernel import (attention_pool_fused,
                                                     attention_pool_plain)


def _inputs(seed, B, C, D):
    rng = np.random.default_rng(seed)
    contexts = rng.normal(size=(B, C, D)).astype(np.float32)
    transform = (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32)
    attention = rng.normal(size=(D,)).astype(np.float32)
    mask = (rng.random((B, C)) > 0.3).astype(np.float32)
    mask[0] = 0.0              # all padding
    if B > 1:
        mask[1] = 0.0
        mask[1, C // 2] = 1.0  # one valid context
    if B > 2:
        mask[2] = 1.0          # full row
    return contexts, transform, attention, mask


def _torch(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dtype) if dtype is not None else t


def _check_special_rows(code, attn, C):
    code, attn = np.asarray(code, np.float32), np.asarray(attn, np.float32)
    assert np.all(code[0] == 0.0) and np.all(attn[0] == 0.0)
    assert attn[1, C // 2] == pytest.approx(1.0, abs=1e-6)
    assert np.count_nonzero(attn[1]) == 1


# B = 5 and 13 are not multiples of the Pallas kernel's 8-row block
@pytest.mark.parametrize("B,C,D", [(5, 12, 24), (13, 200, 24), (3, 200, 96)])
def test_plain_pool_matches_jax_f32(B, C, D):
    ctx, tr, at, mask = _inputs(B * 1000 + C + D, B, C, D)
    code_j, attn_j = jax_attention_pool(jnp.asarray(ctx), jnp.asarray(tr),
                                        jnp.asarray(at), jnp.asarray(mask))
    code_t, attn_t = attention_pool(_torch(ctx), _torch(tr), _torch(at),
                                    _torch(mask))
    np.testing.assert_allclose(code_t.numpy(), np.asarray(code_j), atol=1e-5)
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_j), atol=1e-5)
    _check_special_rows(code_t, attn_t, C)


@pytest.mark.parametrize("B,C,D", [(5, 12, 24), (13, 200, 24)])
def test_plain_pool_matches_jax_bf16(B, C, D):
    ctx, tr, at, mask = _inputs(7 + B, B, C, D)
    bf = jnp.bfloat16
    code_j, attn_j = jax_attention_pool(
        jnp.asarray(ctx, bf), jnp.asarray(tr), jnp.asarray(at),
        jnp.asarray(mask))
    code_t, attn_t = attention_pool(_torch(ctx, torch.bfloat16), _torch(tr),
                                    _torch(at), _torch(mask))
    assert code_t.dtype == torch.bfloat16 and attn_t.dtype == torch.float32
    np.testing.assert_allclose(code_t.float().numpy(),
                               np.asarray(code_j, np.float32), atol=2e-2)
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_j), atol=1e-2)
    _check_special_rows(code_t.float(), attn_t, C)


@pytest.mark.parametrize("ctx_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,D", [(5, 12, 24), (9, 200, 32)])
def test_kernel_wrapper_on_cpu_matches_pallas(ctx_dtype, B, C, D):
    """The wrapper on CPU tensors runs the plain version (float32 inside,
    as the Pallas kernel casts); it launches nothing."""
    ctx, tr, at, mask = _inputs(31 + B, B, C, D)
    jdt = jnp.bfloat16 if ctx_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if ctx_dtype == "bfloat16" else torch.float32
    code_p, attn_p = attention_pool_pallas(
        jnp.asarray(ctx, jdt), jnp.asarray(tr), jnp.asarray(at),
        jnp.asarray(mask), interpret=True)
    before = attention_pool_fused.launches
    code_t, attn_t = attention_pool_fused(_torch(ctx, tdt), _torch(tr),
                                          _torch(at), _torch(mask))
    assert attention_pool_fused.launches == before
    assert code_t.dtype == torch.float32 and attn_t.dtype == torch.float32
    np.testing.assert_allclose(code_t.numpy(), np.asarray(code_p), atol=1e-5)
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_p), atol=1e-5)
    _check_special_rows(code_t, attn_t, C)
    # and the wrapper is exactly its plain version on the CPU
    code_r, attn_r = attention_pool_plain(_torch(ctx, tdt), _torch(tr),
                                          _torch(at), _torch(mask))
    assert torch.equal(code_r, code_t) and torch.equal(attn_r, attn_t)


def test_kernel_wrapper_refuses_unsupported_device():
    ctx, tr, at, mask = _inputs(3, 4, 8, 32)
    with pytest.raises(ValueError, match="no attention-pool kernel"):
        attention_pool_fused(_torch(ctx).to("meta"), _torch(tr).to("meta"),
                             _torch(at).to("meta"), _torch(mask).to("meta"))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version at the serving shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    torch.backends.cuda.matmul.allow_tf32 = False
    for B in (1, 7, 64):
        ctx, tr, at, mask = _inputs(B, B, 200, 384)
        args = [_torch(x).cuda() for x in (ctx, tr, at, mask)]
        args[0] = args[0].to(torch.bfloat16)
        before = attention_pool_fused.launches
        code_k, attn_k = attention_pool_fused(*args)
        assert attention_pool_fused.launches == before + 1
        code_p, attn_p = attention_pool_plain(*args)
        torch.cuda.synchronize()
        assert (code_k - code_p).abs().max().item() <= 1e-4
        assert (attn_k - attn_p).abs().max().item() <= 1e-5
        assert torch.all(code_k[0] == 0) and torch.all(attn_k[0] == 0)

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

The bf16 kernel's tensor-core arithmetic (T split into bf16 terms, a
fresh float32 sum per 16-wide k-step, tiles of 112 contexts combined) is
emulated in plain PyTorch and held against the Pallas kernel at
chip_smoke.py's CODE_TOL / ATTN_TOL, the tolerances the kernel meets
against its plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.ops.attention import attention_pool as jax_attention_pool
from code2vec_tpu.ops.pallas_attention import attention_pool_pallas
from code2vec_tpu_torch.ops.attention import attention_pool
from code2vec_tpu_torch.ops.attention_kernel import (attention_pool_fused,
                                                     attention_pool_plain,
                                                     tc_terms)


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


# chip_smoke.py's tolerances for the kernel against its plain version on
# the card: float32 sums over D = 384 in another order, ~D * 2^-24 of the
# |x| <= 1 values
CODE_TOL, ATTN_TOL = 1e-4, 1e-5
# the bf16 terms of T in the tensor-core kernel (the card test holds the
# built kernel to it), and the contexts of one of its tiles at D <= 384
TC_TERMS = 3
TC_ROWS = 112


def _split(x, terms=TC_TERMS):
    """x as `terms` bf16 terms, each the bf16 of what the terms before it
    left -> (the terms, the largest |x - their sum| over |x|, for
    |x| >= 2^-100)."""
    parts, rest = [], x
    for _ in range(terms):
        part = rest.to(torch.bfloat16).float()
        parts.append(part)
        rest = rest - part
    seen = x.abs() >= 2.0 ** -100
    residual = (rest.abs()[seen] / x.abs()[seen]).max().item()
    return parts, residual


def _tc_pool_emulated(ctx, tr, at, mask, terms=TC_TERMS, tile_rows=TC_ROWS):
    """Kernel 1's bf16 tensor-core arithmetic (attention_pool_tc_kernel
    and pool_combine_kernel) in plain PyTorch, on float32 tensors (`ctx`
    holding bf16 values): T split into `terms` bf16 terms; each 16-wide
    k-step's bf16 x bf16 products (exact in float32) summed smallest term
    first into a fresh float32 sum, added to the running one; tanh; the
    scores against a, masked to -1e9; per tile of `tile_rows` contexts its
    max m_t, l_t = sum exp(s - m_t) and code_t = sum exp(s - m_t) h; the
    tiles combined: M = max m_t, L = sum l_t exp(m_t - M), code = sum
    code_t exp(m_t - M) / L, attn = exp(s - M) / L, zero on rows with no
    valid context. -> (code, attn, the largest term residual of T)."""
    B, C, D = ctx.shape
    parts, residual = _split(tr, terms)
    h = 0
    for k0 in range(0, D, 16):
        ks = slice(k0, k0 + 16)
        step = 0
        for part in reversed(parts):
            step = step + torch.matmul(ctx[..., ks], part[ks, :])
        h = h + step
    h = torch.tanh(h)
    scores = torch.matmul(h, at)
    scores = torch.where(mask > 0, scores, torch.full_like(scores, -1e9))
    stats, codes = [], []
    for r0 in range(0, C, tile_rows):
        s = scores[:, r0:r0 + tile_rows]
        m_t = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m_t)
        stats.append((m_t, e.sum(dim=-1, keepdim=True)))
        codes.append(torch.einsum("bc,bcd->bd", e, h[:, r0:r0 + tile_rows]))
    big = torch.stack([m_t for m_t, _ in stats]).amax(dim=0)
    weights = [torch.exp(m_t - big) for m_t, _ in stats]
    total = sum(l_t * w for (_, l_t), w in zip(stats, weights))
    code = sum(c * w for c, w in zip(codes, weights)) / total
    attn = torch.exp(scores - big) / total
    any_valid = mask.sum(dim=-1, keepdim=True) > 0
    code = torch.where(any_valid, code, torch.zeros_like(code))
    attn = torch.where(any_valid, attn, torch.zeros_like(attn))
    return code, attn, residual


def _bf16_inputs(seed, B, C, D):
    """`_inputs` with the contexts rounded to bf16 (the kernel's operand)
    and held in float32."""
    ctx, tr, at, mask = _inputs(seed, B, C, D)
    ctx = _torch(ctx, torch.bfloat16).float().numpy()
    return ctx, tr, at, mask


# the java-large width (2 tiles, the second of 88 contexts), a ragged C in
# one tile, and a C whose last tile holds 2 contexts
@pytest.mark.parametrize("B,C,D", [(4, 200, 384), (3, 37, 96), (5, 114, 64)])
def test_tensor_core_pool_keeps_pallas_semantics(B, C, D):
    """The bf16 kernel 1's arithmetic (T as TC_TERMS bf16 terms, a fresh
    float32 sum per k16 step, tiles of TC_ROWS contexts combined), emulated on
    the CPU, against `attention_pool_pallas` in interpret mode: within
    CODE_TOL / ATTN_TOL, the tolerances chip_smoke.py holds the kernel to
    on the card; all-padding rows exactly 0. The three terms leave at most
    2^-24 of each element of T (of 2^-100 or more). One term (T rounded
    to bf16) misses both tolerances at these shapes."""
    ctx, tr, at, mask = _bf16_inputs(41 + C, B, C, D)
    want_code, want_attn = attention_pool_pallas(
        jnp.asarray(ctx, jnp.bfloat16), jnp.asarray(tr), jnp.asarray(at),
        jnp.asarray(mask), interpret=True)
    code, attn, residual = _tc_pool_emulated(
        *(torch.from_numpy(x) for x in (ctx, tr, at, mask)))
    assert residual <= 2.0 ** -24
    assert np.abs(code.numpy() - np.asarray(want_code)).max() <= CODE_TOL
    assert np.abs(attn.numpy() - np.asarray(want_attn)).max() <= ATTN_TOL
    _check_special_rows(code, attn, C)
    one_code, one_attn, _ = _tc_pool_emulated(
        *(torch.from_numpy(x) for x in (ctx, tr, at, mask)), terms=1)
    assert np.abs(one_code.numpy() - np.asarray(want_code)).max() > CODE_TOL
    assert np.abs(one_attn.numpy() - np.asarray(want_attn)).max() > ATTN_TOL


@pytest.mark.parametrize("tile_rows", [16, 64, TC_ROWS])
def test_tensor_core_pool_tiles_combine_to_the_whole_method(tile_rows):
    """The C split: the tiles' (m_t, l_t, code_t) combined give the result
    of one tile over the whole method, within 2^-20 of the largest code
    value and 2^-20 of each weight (each tile rescales its exps by
    exp(m_t - M), one float32 rounding more). Row 3 has its valid contexts
    in the last tile only, so the other tiles' maxima are -1e9 and their
    weights exactly 0."""
    B, C, D = 6, 200, 64
    ctx, tr, at, mask = _bf16_inputs(5, B, C, D)
    mask[3] = 0.0
    mask[3, 190:] = 1.0
    args = [torch.from_numpy(x) for x in (ctx, tr, at, mask)]
    code, attn, _ = _tc_pool_emulated(*args, tile_rows=tile_rows)
    whole_code, whole_attn, _ = _tc_pool_emulated(*args, tile_rows=C)
    top = whole_code.abs().max().item()
    assert (code - whole_code).abs().max().item() <= 2.0 ** -20 * top
    assert ((attn - whole_attn).abs() <= 2.0 ** -20 * whole_attn).all()
    assert torch.equal(attn[3, :190], torch.zeros(190))
    _check_special_rows(code, attn, C)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernels against their plain version at the serving shapes
    and the training batch (B = 1024), bf16 (the tensor cores) and float32
    (the CUDA cores): within CODE_TOL / ATTN_TOL, all-padding rows exactly
    0, the same bits on a second launch, and T split into the TC_TERMS
    terms that test_tensor_core_pool_keeps_pallas_semantics emulates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    torch.backends.cuda.matmul.allow_tf32 = False
    assert tc_terms() == TC_TERMS
    for B, dtype in ((1, torch.bfloat16), (7, torch.bfloat16),
                     (64, torch.bfloat16), (1024, torch.bfloat16),
                     (7, torch.float32), (64, torch.float32)):
        ctx, tr, at, mask = _inputs(B, B, 200, 384)
        args = [_torch(x).cuda() for x in (ctx, tr, at, mask)]
        args[0] = args[0].to(dtype)
        before = attention_pool_fused.launches
        code_k, attn_k = attention_pool_fused(*args)
        assert attention_pool_fused.launches == before + 1
        code_p, attn_p = attention_pool_plain(*args)
        again = attention_pool_fused(*args)
        torch.cuda.synchronize()
        assert (code_k - code_p).abs().max().item() <= CODE_TOL
        assert (attn_k - attn_p).abs().max().item() <= ATTN_TOL
        assert torch.all(code_k[0] == 0) and torch.all(attn_k[0] == 0)
        assert torch.equal(again[0], code_k) and torch.equal(again[1], attn_k)

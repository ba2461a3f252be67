"""The port's fused multi-head attention (ops/xf_attention.py) against the
JAX package's (ops/xf_attention.py): the Pallas kernels in interpret mode
and the XLA reference.

On CPU tensors the port's kernel wrappers run the kernels' plain
versions, so these tests hold the plain versions (and the autograd
wiring around them) to the Pallas kernels' semantics. The `cuda`-marked
test holds the CUDA kernels to the plain versions on a card.

Shapes are the JAX tests': (B, H, C, hd) = (3, 2, 24, 16); B = 16, where
the Pallas kernels group G = 8 batch rows a program; and C = 200,
hd = 96. Tolerances, as tight as the JAX package's own tests: float32
forward 1e-5 (1e-4 at C = 200, hd = 96, where 200-term float32 sums
are taken in another order), float32 gradients 1e-4 (5e-4 at G = 8,
where the grouped unroll changes the Pallas kernel's summation order),
bf16 3e-2 (the outputs are rounded to bf16, 2^-8 relative, and the
logits' float32 sums differ by order before the rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.ops import xf_attention as jxa
from code2vec_tpu_torch.ops import xf_attention as txa
from code2vec_tpu_torch.ops.xf_attention_kernel import (bwd_tc_rows,
                                                        check_inputs,
                                                        smem_bytes, tc_terms)

SHAPES = {"small": (3, 2, 24, 16), "grouped": (16, 2, 24, 16),
          "java": (2, 2, 200, 96)}
FWD_TOL = {"small": 1e-5, "grouped": 1e-5, "java": 1e-4}
GRAD_TOL = {"small": 1e-4, "grouped": 5e-4, "java": 1e-4}
BF16_TOL = 3e-2


def _inputs(shape, dtype="float32", seed=0, live=None):
    """q, k, v ~ N(0, 1) and a log mask with key 0 always live (or only
    the first `live` keys live), as numpy float32 arrays."""
    B, H, C, hd = shape
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=shape).astype(np.float32) for _ in range(3))
    mask = (r.random((B, C)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    if live is not None:
        mask[:] = 0.0
        mask[:, :live] = 1.0
    log_mask = np.log(np.maximum(mask, 1e-30)).astype(np.float32)
    if dtype == "bfloat16":
        # the same bf16 values on both sides
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (q, k, v))
    return q, k, v, log_mask


def _jax(arrays, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SHAPES))
def test_forward_matches_pallas_and_reference(case, dtype):
    """The port's fused_mha forward (kernel 2's plain version on CPU
    tensors) against the JAX fused_mha (Pallas, interpret mode) and the
    JAX XLA reference: float32 within 1e-5 (1e-4 at C = 200), bf16
    within 3e-2; the output keeps q's dtype."""
    q, k, v, lm = _inputs(SHAPES[case], dtype)
    jq, jk, jv = _jax((q, k, v), dtype)
    ref_pallas = _f32(jxa.fused_mha(jq, jk, jv, jnp.asarray(lm)))
    ref_xla = _f32(jxa.mha_reference(jq, jk, jv, jnp.asarray(lm)))
    tq, tk, tv = _torch((q, k, v), dtype)
    before = txa.mha_forward_fused.launches
    out = txa.fused_mha(tq, tk, tv, torch.from_numpy(lm))
    assert txa.mha_forward_fused.launches == before  # CPU: no kernel
    assert out.dtype == tq.dtype and out.shape == tq.shape
    tol = FWD_TOL[case] if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(out), ref_pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(out), ref_xla, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SHAPES))
def test_gradients_match_pallas(case, dtype):
    """Gradients of sum(o^2) with respect to q, k and v through the port's
    fused_mha (kernel 3's plain version) against jax.grad of the JAX
    fused_mha (the Pallas backward kernel, interpret mode): float32
    within 1e-4 (5e-4 at G = 8), bf16 within 3e-2 of the largest
    gradient; log_mask gets a zero gradient."""
    q, k, v, lm = _inputs(SHAPES[case], dtype, seed=3)
    jlm = jnp.asarray(lm)

    def loss(q, k, v):
        return jnp.sum(jnp.square(jxa.fused_mha(q, k, v, jlm)))
    ref = jax.grad(loss, argnums=(0, 1, 2))(*_jax((q, k, v), dtype))
    tq, tk, tv = (t.requires_grad_(True) for t in _torch((q, k, v), dtype))
    tlm = torch.from_numpy(lm).requires_grad_(True)
    out = txa.fused_mha(tq, tk, tv, tlm)
    (out * out).sum().backward()
    assert torch.equal(tlm.grad, torch.zeros_like(tlm))
    for got, want, name in zip((tq.grad, tk.grad, tv.grad), ref, "qkv"):
        assert got.dtype == tq.dtype
        want = _f32(want)
        if dtype == "float32":
            tol = GRAD_TOL[case]
            np.testing.assert_allclose(_f32(got), want, atol=tol, rtol=tol,
                                       err_msg=f"d{name}")
        else:
            np.testing.assert_allclose(
                _f32(got), want, atol=BF16_TOL * np.abs(want).max(),
                err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_only_live_key_is_broadcast(dtype):
    """With every key but key 0 masked (log 1e-30, not -inf), each output
    row is v[:, :, 0], as in the JAX package's test: within 1e-5 in
    float32, exactly in bf16 (the weight of key 0 rounds to 1)."""
    q, k, v, lm = _inputs((3, 2, 8, 16), dtype, live=1)
    tq, tk, tv = _torch((q, k, v), dtype)
    out = txa.fused_mha(tq, tk, tv, torch.from_numpy(lm))
    want = np.broadcast_to(_f32(tv)[:, :, :1], v.shape)
    np.testing.assert_allclose(_f32(out), want,
                               atol=1e-5 if dtype == "float32" else 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_jax_reference(dtype):
    """The port's mha_reference (the XLA path) against the JAX package's,
    with its bf16 rounding places: within 1e-5 in float32 and 3e-2 in
    bf16 (each side rounds the logits and the weights to bf16)."""
    q, k, v, lm = _inputs((3, 2, 24, 16), dtype, seed=5)
    want = _f32(jxa.mha_reference(*_jax((q, k, v), dtype), jnp.asarray(lm)))
    got = txa.mha_reference(*_torch((q, k, v), dtype), torch.from_numpy(lm))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(got), want, atol=tol, rtol=tol)


def test_wrappers_are_the_plain_versions_on_cpu_and_check_inputs():
    """On CPU tensors the wrappers return their plain versions' values
    exactly and launch nothing; the kernel launchers refuse other devices,
    a C over 256, an hd that is not a multiple of 16 up to 128, float32
    over the shared memory, float16, and a mismatched mask, and take bf16
    at C = 256."""
    q, k, v, lm = _torch(_inputs((2, 2, 12, 16)), "float32")
    do = torch.ones_like(q)
    assert torch.equal(txa.mha_forward_fused(q, k, v, lm),
                       txa.mha_forward_plain(q, k, v, lm))
    for a, b in zip(txa.mha_backward_fused(q, k, v, lm, do),
                    txa.mha_backward_plain(q, k, v, lm, do)):
        assert torch.equal(a, b)
    meta = [t.to("meta") for t in (q, k, v, lm)]
    with pytest.raises(ValueError, match="no fused-MHA kernel"):
        check_inputs(*meta)
    for shape in ((1, 1, 257, 16), (1, 1, 8, 24), (1, 1, 8, 144),
                  (1, 1, 256, 128)):  # the last: float32 over 227 KB
        t = torch.empty(shape, device="meta")
        with pytest.raises(ValueError, match="the fused-MHA kernels take|"
                           "shared memory"):
            check_inputs(t, t, t, torch.empty(shape[0], shape[2],
                                              device="meta"))
    # bf16 runs the tensor-core kernels, which take every C <= 256: kernel
    # 3's block is all of C = 200 (13 warps, 223 KB of shared memory), two
    # tiles of 128 rows at C = 256
    t = torch.empty((1, 1, 256, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no fused-MHA kernel"):
        check_inputs(t, t, t, torch.empty(1, 256, device="meta"))
    assert (bwd_tc_rows(200, 128), bwd_tc_rows(256, 128)) == (208, 128)
    assert smem_bytes(200, 128, 2) == 228800
    t = torch.empty((1, 1, 8, 16), dtype=torch.float16, device="meta")
    with pytest.raises(TypeError):
        check_inputs(t, t, t, torch.empty(1, 8, device="meta"))
    with pytest.raises(ValueError, match="log_mask"):
        check_inputs(*meta[:3], torch.empty(2, 11, device="meta"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_mha_is_fused_mha_through_the_plain_versions(dtype):
    """plain_mha, the encoder's path with use_kernel=False, gives exactly
    fused_mha's output and q, k, v gradients on CPU tensors (both run the
    plain versions there), a zero log_mask gradient, and counts no
    kernel launch."""
    arrays = _inputs((3, 2, 24, 16), dtype, seed=7)
    grads = {}
    outs = {}
    n2, n3 = txa.mha_forward_fused.launches, txa.mha_backward_fused.launches
    for fn in (txa.fused_mha, txa.plain_mha):
        q, k, v = (t.requires_grad_(True) for t in _torch(arrays[:3], dtype))
        lm = torch.from_numpy(arrays[3]).requires_grad_(True)
        out = fn(q, k, v, lm)
        (out.float() ** 2).sum().backward()
        outs[fn], grads[fn] = out.detach(), (q.grad, k.grad, v.grad, lm.grad)
    assert torch.equal(outs[txa.plain_mha], outs[txa.fused_mha])
    for a, b in zip(grads[txa.plain_mha], grads[txa.fused_mha]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not grads[txa.plain_mha][3].any()
    assert (txa.mha_forward_fused.launches,
            txa.mha_backward_fused.launches) == (n2, n3)


# chip_smoke.py's XF_TOL["bfloat16"]: the kernel against the plain version
# on the card, over the largest |output|
XF_TOL_BF16 = 2.0 ** -7
# the bf16 terms of each float32 operand of the tensor-core kernels'
# products (the card test holds the built kernel to it)
TC_TERMS = 3


def _split(x, terms=TC_TERMS):
    """x as `terms` bf16 terms, each the bf16 of what the terms before it
    left -> (the terms, the largest |x - their sum| over |x|, for
    |x| >= 2^-100: below that a third term can be subnormal, and such a
    value moves no output)."""
    parts, rest = [], x
    for _ in range(terms):
        part = rest.to(torch.bfloat16).float()
        parts.append(part)
        rest = rest - part
    seen = x.abs() >= 2.0 ** -100
    residual = (rest.abs()[seen] / x.abs()[seen]).max().item()
    return parts, residual


def _tc_dots(a, b):
    """a b^T over the last axis as float32 sums of 16-column partial
    products (the bf16 x bf16 products are exact in float32)."""
    out = 0
    for c0 in range(0, a.shape[-1], 16):
        cols = slice(c0, c0 + 16)
        out = out + torch.matmul(a[..., cols], b[..., cols].transpose(-1, -2))
    return out


def _tc_sum(parts, b):
    """sum_j x_ij b_j with x as its bf16 terms: over 16-row chunks of b,
    each chunk's products taken smallest term first, the chunks summed in
    float32."""
    out = 0
    for j0 in range(0, b.shape[-2], 16):
        rows = slice(j0, j0 + 16)
        chunk = 0
        for part in reversed(parts):
            chunk = chunk + torch.matmul(part[..., rows], b[..., rows, :])
        out = out + chunk
    return out


def _tc_forward_emulated(q, k, v, log_mask, terms=TC_TERMS):
    """Kernel 2's bf16 tensor-core arithmetic (mha_fwd_tc_kernel) in plain
    PyTorch on float32 tensors holding bf16 values: q k^T as _tc_dots, the
    scale and the mask rounded apart, the exact row max, e = exp(L - m)
    and its row sum l, e split into `terms` bf16 terms, o = _tc_sum of
    them with v, divided by l once per row, rounded to bf16. -> (o, the
    largest term residual of e)."""
    hd = q.shape[-1]
    scale = torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32)
    logits = _tc_dots(q, k) * scale + log_mask[:, None, None, :]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    parts, residual = _split(e, terms)
    o = _tc_sum(parts, v)
    return (o / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16), residual


@pytest.mark.parametrize("shape", [(1, 3, 200, 128), (2, 4, 200, 96),
                                   (2, 3, 37, 128)])
def test_tensor_core_split_keeps_pallas_semantics(shape):
    """The bf16 kernel 2's arithmetic (the float32 weights as three bf16
    terms, emulated on the CPU) against `_mha_fwd_pallas` in interpret
    mode, with every key but key 0 masked in batch row 1 (where B > 1):
    within XF_TOL["bfloat16"] = 2^-7 of the largest |output|, the
    tolerance chip_smoke.py holds the kernel to on the card (each output
    is rounded to bf16 once on both sides, and a float32 difference can
    move it one bf16 step), and equal to its bits on all but 0.1 % of the
    outputs. The three terms leave at most 2^-24 of each weight (of
    2^-100 or more). Two
    terms leave 2^-16 and already change 0.1-0.2 % of the outputs' bits
    (more on the card), too many for the transformer's end-to-end checks
    there; the weights rounded to bf16 once, as SDPA does, change 19-41 %
    at these shapes."""
    q, k, v, lm = _inputs(shape, "bfloat16", seed=11)
    if shape[0] > 1:
        lm[1, 1:] = np.log(np.float32(1e-30))
    jq, jk, jv = _jax((q, k, v), "bfloat16")
    want = _f32(jxa._mha_fwd_pallas(jq, jk, jv, jnp.asarray(lm),
                                    interpret=True))
    got, residual = _tc_forward_emulated(
        *(torch.from_numpy(a) for a in (q, k, v, lm)))
    assert residual <= 2.0 ** -24
    err = np.abs(_f32(got) - want).max()
    assert err <= XF_TOL_BF16 * np.abs(want).max()
    assert (_f32(got) != want).mean() <= 1e-3


def _tc_backward_emulated(q, k, v, log_mask, do, terms=TC_TERMS):
    """Kernel 3's bf16 tensor-core arithmetic (mha_bwd_dq_tc_kernel and
    mha_bwd_dkv_tc_kernel) in plain PyTorch on float32 tensors holding
    bf16 values: q k^T and do v^T as _tc_dots, the scale and the mask
    rounded apart, the exact row max, e = exp(L - m) and l = rowsum(e),
    delta = rowsum(dA * A) from the float32 weights as rowsum(e dA) / l,
    A = e times the float32 reciprocal of l, dL = A (dA - delta); A and dL
    split into `terms` bf16 terms for A^T do, dL k and dL^T q (_tc_sum),
    dq and dk times the scale, each rounded to bf16.
    -> ((dq, dk, dv), the largest term residual of A and dL)."""
    hd = q.shape[-1]
    scale = torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32)
    logits = _tc_dots(q, k) * scale + log_mask[:, None, None, :]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1, keepdim=True)
    da = _tc_dots(do, v)
    delta = (e * da).sum(dim=-1, keepdim=True) / l
    attn = e * (1.0 / l)
    dl = attn * (da - delta)
    a_t, res_a = _split(attn.transpose(-1, -2), terms)
    dl_parts, res_dl = _split(dl, terms)
    dl_t = [p.transpose(-1, -2) for p in dl_parts]
    dv = _tc_sum(a_t, do)
    dq = _tc_sum(dl_parts, k) * scale
    dk = _tc_sum(dl_t, q) * scale
    grads = tuple(g.to(torch.bfloat16) for g in (dq, dk, dv))
    return grads, max(res_a, res_dl)


@pytest.mark.parametrize("shape", [(1, 3, 200, 128), (2, 4, 200, 96),
                                   (2, 3, 37, 128)])
def test_tensor_core_backward_keeps_pallas_semantics(shape):
    """The bf16 kernel 3's arithmetic (the float32 weights A and dL as
    three bf16 terms, emulated on the CPU) against `_mha_bwd_pallas` in
    interpret mode, with every key but key 0 masked in batch row 1 (where
    B > 1): dq, dk and dv within XF_TOL["bfloat16"] = 2^-7 of each one's
    largest |value|, the tolerance chip_smoke.py holds the kernel to on
    the card (each gradient is rounded to bf16 once on both sides, and a
    float32 difference can move it one bf16 step), and equal to its bits
    on all but 0.1 % of the values (0.02-0.06 % differ at these shapes).
    The three terms leave at most 2^-24 of each weight and each dL (of
    2^-100 or more). Two terms leave about 2^-17 and change 0.17-0.27 %
    of the gradients' bits here, as they did the forward's where two terms
    failed end to end on the card."""
    q, k, v, lm = _inputs(shape, "bfloat16", seed=13)
    if shape[0] > 1:
        lm[1, 1:] = np.log(np.float32(1e-30))
    do = np.asarray(jnp.asarray(
        np.random.default_rng(14).normal(size=shape), jnp.bfloat16),
        np.float32)
    jq, jk, jv, jdo = _jax((q, k, v, do), "bfloat16")
    want = [_f32(g) for g in jxa._mha_bwd_pallas(
        jq, jk, jv, jnp.asarray(lm), jdo, interpret=True)]
    got, residual = _tc_backward_emulated(
        *(torch.from_numpy(a) for a in (q, k, v, lm, do)))
    assert residual <= 2.0 ** -24
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        err = np.abs(_f32(g) - w).max()
        assert err <= XF_TOL_BF16 * np.abs(w).max(), name
        assert (_f32(g) != w).mean() <= 1e-3, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(dtype):
    """Kernels 2 and 3 against their plain versions on the card, at the
    small shapes, the java-large head shape (7, 3, 200, 128), H = 4's
    hd = 96, a ragged C = 37 and C = 256 (bf16 kernel 3 in two tiles of
    query and key rows): float32 within 2e-5 of the largest output
    (200-term float32 sums in another order), bf16 within 2^-7 of it (one
    bf16 rounding apart); kernels 2 and 3 give the same bits twice, and
    split each float32 operand into the TC_TERMS terms that
    test_tensor_core_split_keeps_pallas_semantics and
    test_tensor_core_backward_keeps_pallas_semantics emulate."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    torch.backends.cuda.matmul.allow_tf32 = False
    assert tc_terms() == TC_TERMS
    shapes = [(3, 2, 24, 16), (16, 2, 24, 16), (7, 3, 200, 128),
              (4, 4, 200, 96), (5, 3, 37, 128)]
    if dtype == "bfloat16":
        shapes.append((2, 3, 256, 128))
    for shape in shapes:
        q, k, v, lm = (t.cuda() for t in _torch(_inputs(shape), "float32"))
        q, k, v = (t.to(getattr(torch, dtype)) for t in (q, k, v))
        do = torch.randn_like(q.float()).to(q.dtype)
        n2, n3 = txa.mha_forward_fused.launches, txa.mha_backward_fused.launches
        got = [txa.mha_forward_fused(q, k, v, lm),
               *txa.mha_backward_fused(q, k, v, lm, do)]
        assert txa.mha_forward_fused.launches == n2 + 1
        assert txa.mha_backward_fused.launches == n3 + 1
        want = [txa.mha_forward_plain(q, k, v, lm),
                *txa.mha_backward_plain(q, k, v, lm, do)]
        torch.cuda.synchronize()
        rel = 2e-5 if dtype == "float32" else 2.0 ** -7
        for a, b in zip(got, want):
            top = b.float().abs().max().item()
            assert (a.float() - b.float()).abs().max().item() <= rel * top
        assert torch.equal(txa.mha_forward_fused(q, k, v, lm), got[0])
        for a, b in zip(txa.mha_backward_fused(q, k, v, lm, do), got[1:]):
            assert torch.equal(a, b)


def test_round_to_bf16_rounds_once_to_nearest_even():
    """The oracle's rounding: float64 straight to bf16, ties to even
    (1 + 2^-8 -> 1, 1 + 3 * 2^-8 -> 1 + 2^-6), bound 0 against numpy's
    exact rational midpoint test over 100,000 random values."""
    x = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
                      -(1.0 + 2.0 ** -8 + 2.0 ** -40), 0.0],
                     dtype=torch.float64)
    got = txa.round_to_bf16(x).double().tolist()
    assert got == [1.0, 1.0 + 2.0 ** -6, -(1.0 + 2.0 ** -7), 0.0]
    r = torch.from_numpy(np.random.default_rng(0).normal(size=100_000) * 7)
    b = txa.round_to_bf16(r).double()
    # the nearest bf16 value: no other bf16 neighbour is closer
    step = torch.ldexp(torch.ones_like(b), torch.frexp(b)[1] - 8)
    assert ((b - r).abs() <= step / 2).all()


def test_plain_forward_lies_within_one_ulp_of_the_oracle():
    """Kernel 2's plain version on bf16 inputs against the float64
    oracle rounded once to bf16 (CPU, (4, 3, 200, 128), key mask, N(0, 3)
    activations): at most 1 bf16 ulp apart on every element a float32
    evaluation resolves (|o| >= 2^-7 of sum_j a_j |v_j|), under 1 % of
    the elements apart at all; the rest (o near 0 from cancelling terms)
    is where a float32 sum itself lies ulps away, and is only read."""
    q, k, v, lm = _torch(_inputs((4, 3, 200, 128), "bfloat16"), "float32")
    q, k, v = (t.to(torch.bfloat16) * 3 for t in (q, k, v))
    r = txa.bf16_ulp_readings(txa.mha_forward_plain(q, k, v, lm),
                              *txa.mha_forward_oracle(q, k, v, lm))
    assert r["max_ulp"] <= 1 and r["share"] < 0.01, r
    assert 0 < r["rest_share"] < 0.05, r


@pytest.mark.cuda
def test_kernel2_lies_within_one_ulp_of_the_oracle_on_card():
    """Kernel 2 on bf16 inputs at the training shape's head layout
    (64, 3, 200, 128) and activations a trained layer gives (N(0, 3)):
    within 1 bf16 ulp of the float64 oracle on every element a float32
    evaluation resolves, and differing from it on at most twice the
    plain version's share of the elements (chip_smoke.py [12] reads the
    same at a trained state of (e))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    q, k, v, lm = (t.cuda() for t in _torch(
        _inputs((64, 3, 200, 128), "bfloat16"), "float32"))
    q, k, v = (t.to(torch.bfloat16) * 3 for t in (q, k, v))
    oracle = txa.mha_forward_oracle(q, k, v, lm)
    kern = txa.bf16_ulp_readings(txa.mha_forward_fused(q, k, v, lm), *oracle)
    plain = txa.bf16_ulp_readings(txa.mha_forward_plain(q, k, v, lm),
                                  *oracle)
    assert kern["max_ulp"] <= 1 and kern["share"] <= 2 * plain["share"], \
        (kern, plain)

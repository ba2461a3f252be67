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
from code2vec_tpu_torch.ops.xf_attention_kernel import check_inputs

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
    a C over 256, an hd that is not a multiple of 16 up to 128, float16,
    and a mismatched mask."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(dtype):
    """Kernels 2 and 3 against their plain versions on the card, at the
    small shapes and at the java-large head shape (7, 3, 200, 128):
    float32 within 2e-5 of the largest output (200-term float32 sums in
    another order), bf16 within 2^-7 of it (one bf16 rounding apart)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in ((3, 2, 24, 16), (16, 2, 24, 16), (7, 3, 200, 128)):
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

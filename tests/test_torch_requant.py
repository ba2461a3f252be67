"""The port's int8 dense requantize (kernel 4's plain version), its
straight-through gather and its build against the JAX package's.

The same numpy tables and updates and the same dither salt (the
`jax.random.bits` of the JAX call's key) go through
`code2vec_tpu.ops.quant.requantize_reference`, the Pallas kernel
`code2vec_tpu.ops.pallas_requant.requantize_fused` (interpret mode, as
the JAX package's own tests run it on the CPU) and the port's
`requantize_reference` / `requantize` (the wrapper takes the plain
version for CPU tensors).

Tolerances, each test repeating its own:
- q exact and s within 2 float32 ulp: the JAX package's own bar between
  its kernel and its reference (the same float32 operations in the same
  order, the same uint32 dither);
- `dequantize_table` and the gather's forward exact, its dense carrier
  gradient exact (the same bf16 scatter-adds in the same order).
The `cuda`-marked tests hold kernel 4 against its plain version on the
card bit for bit, on its vector kernel (E = 128, 64) and its scalar one
(a ragged E, an unaligned q), and `quantize_table` on the card against
the CPU.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.ops import quant as jquant
from code2vec_tpu.ops.pallas_requant import requantize_fused as j_fused
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.ops import quant as tquant
from code2vec_tpu_torch.ops.requant_kernel import (kernel_name,
                                                   requantize_fused)
from torch_helpers import max_ulp_diff

CPU = torch.device("cpu")


def _t(a):
    return convert._tensor_from_numpy(np.asarray(a), CPU)


def _n(t):
    return convert._tensor_to_numpy(t)


def _case(V, E, upd_dtype, seed=0):
    r = np.random.default_rng(V * 1000 + E + seed)
    t = jnp.asarray(r.normal(size=(V, E)) * 0.3, jnp.float32)
    qt = jquant.quantize_table(t)
    upd = jnp.asarray(r.normal(size=(V, E)) * 0.005, upd_dtype)
    return qt, upd


def _salt(rng) -> int:
    return int(np.asarray(jax.random.bits(rng, dtype=jnp.uint32)))


@pytest.mark.parametrize("E", [8, 128])
@pytest.mark.parametrize("V", [1, 7, 257])
@pytest.mark.parametrize("upd_dtype", ["float32", "bfloat16"])
def test_plain_requantize_matches_jax(V, E, upd_dtype):
    """requantize_reference against the JAX reference and the Pallas
    kernel in interpret mode (V = 257 is not a multiple of its block of
    256), same salt: q exact, s within 2 ulp; `requantize` (the
    wrapper on CPU tensors) updates the table in place to the same."""
    qt, upd = _case(V, E, getattr(jnp, upd_dtype))
    rng = jax.random.PRNGKey(V + E)
    ref = jquant.requantize_reference(qt, upd, rng)
    ker = j_fused(qt, upd, rng)
    tqt = {"q": _t(qt["q"]), "s": _t(qt["s"])}
    got = tquant.requantize_reference(tqt, _t(upd), _salt(rng))
    assert got["q"].dtype == torch.int8 and got["s"].shape == (V, 1)
    for other in (ref, ker):
        np.testing.assert_array_equal(_n(got["q"]), np.asarray(other["q"]))
        assert max_ulp_diff(_n(got["s"]), np.asarray(other["s"])) <= 2
    launches = requantize_fused.launches
    tquant.requantize(tqt, _t(upd), _salt(rng))
    assert requantize_fused.launches == launches
    assert torch.equal(tqt["q"], got["q"]) and torch.equal(tqt["s"], got["s"])


def test_untouched_rows_stay_stable():
    """Rows whose update is 0 requantize to themselves (a freshly
    quantized row's absmax element is +-127, so the recomputed scale is
    the old one within an ulp): at most one element of the 63 untouched
    rows flips, by at most 1; the touched row moves toward the update."""
    r = np.random.default_rng(2)
    t = torch.from_numpy((r.normal(size=(64, 8)) * 0.5).astype(np.float32))
    qt = tquant.quantize_table(t)
    upd = torch.zeros(64, 8)
    upd[3] = 0.01
    out = tquant.requantize_reference(qt, upd, 12345)
    untouched = [i for i in range(64) if i != 3]
    d = (out["q"][untouched].int() - qt["q"][untouched].int()).abs()
    assert int((d > 0).sum()) <= 1 and int(d.max()) <= 1
    row = tquant.dequantize_table(out)[3]
    target = tquant.dequantize_table(qt)[3] + upd[3]
    assert float((row - target).abs().max()) <= float(out["s"][3, 0])


def test_dequantize_and_quantized_take_match_jax():
    """dequantize_table exact; quantized_take's bf16 rows exact and its
    dense carrier gradient (bf16 scatter-add of the cotangent, ids
    repeated) exact against the JAX custom-VJP gather."""
    r = np.random.default_rng(1)
    t = jnp.asarray(r.normal(size=(32, 8)) * 0.2, jnp.float32)
    qt = jquant.quantize_table(t)
    tqt = {"q": _t(qt["q"]), "s": _t(qt["s"])}
    for dtype in (jnp.float32, jnp.bfloat16):
        np.testing.assert_array_equal(
            _n(tquant.dequantize_table(
                tqt, getattr(torch, jnp.dtype(dtype).name))).astype(
                    np.float32),
            np.asarray(jquant.dequantize_table(qt, dtype)).astype(np.float32))
    ids = np.concatenate([r.integers(0, 32, (4, 6)), [[5] * 6]]).astype(
        np.int32)
    w = r.normal(size=(5, 6, 8)).astype(np.float32)

    def j_loss(carrier):
        rows = jquant.quantized_take(carrier, qt, jnp.asarray(ids))
        return jnp.sum(rows.astype(jnp.float32) * w)

    carrier = jnp.zeros((32, 8), jnp.bfloat16)
    j_rows = jquant.quantized_take(carrier, qt, jnp.asarray(ids))
    j_grad = jax.grad(j_loss)(carrier)
    t_carrier = torch.zeros(32, 8, dtype=torch.bfloat16, requires_grad=True)
    t_rows = tquant.quantized_take(t_carrier, tqt, torch.from_numpy(ids))
    assert t_rows.dtype == torch.bfloat16 and t_rows.shape == (5, 6, 8)
    np.testing.assert_array_equal(_n(t_rows.detach()).astype(np.float32),
                                  np.asarray(j_rows).astype(np.float32))
    (t_rows.float() * torch.from_numpy(w)).sum().backward()
    assert t_carrier.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(_n(t_carrier.grad).astype(np.float32),
                                  np.asarray(j_grad).astype(np.float32))


def test_requantize_refuses_other_devices():
    qt = tquant.quantize_table(torch.ones(4, 8))
    meta = {"q": qt["q"].to("meta"), "s": qt["s"].to("meta")}
    with pytest.raises(ValueError, match="no requantize kernel"):
        requantize_fused(meta, torch.zeros(4, 8, device="meta"), 1)


def test_library_path_hashes_the_included_headers(tmp_path, monkeypatch):
    """An edit to csrc/quant_common.cuh renames the libraries of both
    sources that include it (kernels 4 and 6) and no other; an unchanged
    tree keeps every name."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", str(src))
    names = ("requant", "sparse_row_update", "attention_pool")
    assert [os.path.basename(p) for p in _build.source_files("requant")] == \
        ["requant.cu", "quant_common.cuh"]
    before = {n: _build.library_path(n) for n in names}
    assert before == {n: _build.library_path(n) for n in names}
    with open(src / "quant_common.cuh", "a") as f:
        f.write("\n// an edit\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["requant"] != before["requant"]
    assert after["sparse_row_update"] != before["sparse_row_update"]
    assert after["attention_pool"] == before["attention_pool"]


# (V, E, the kernel that takes it): E = 128, 64 (16 L, L a power of two) on
# the 16-byte vector kernel, V = 4099 past several blocks with a ragged
# last row group; E = 100 (ragged) and 48 (L = 3) on the scalar kernel
CARD_CASES = [(1, 128, "requant_vec_kernel"), (1000, 128, "requant_vec_kernel"),
              (4099, 128, "requant_vec_kernel"), (65, 64, "requant_vec_kernel"),
              (257, 100, "requant_kernel"), (40, 48, "requant_kernel")]


@pytest.mark.cuda
@pytest.mark.parametrize("V,E,kernel", CARD_CASES)
@pytest.mark.parametrize("upd_dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_version_on_the_card(V, E, kernel, upd_dtype):
    """Kernel 4 against its plain version on the card, one launch of the
    kernel the table's width takes: q and s bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(V + E)
    base = torch.randn((V, E), generator=gen, device="cuda") * 0.3
    upd = (torch.randn((V, E), generator=gen, device="cuda")
           * 0.005).to(upd_dtype)
    upd[::3] = 0
    k = tquant.quantize_table(base)
    assert kernel_name(k, upd) == kernel
    p = tquant.requantize_reference(k, upd, 0x9E3779B9)
    launches = requantize_fused.launches
    tquant.requantize(k, upd, 0x9E3779B9)
    torch.cuda.synchronize()
    assert requantize_fused.launches == launches + 1
    assert torch.equal(k["q"], p["q"]) and torch.equal(k["s"], p["s"])


@pytest.mark.cuda
def test_unaligned_table_takes_the_scalar_kernel_on_the_card():
    """A q one byte off 16-byte alignment (a view into a larger buffer)
    goes to the scalar kernel, with the same bits as the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    V, E = 300, 128
    gen = torch.Generator(device="cuda").manual_seed(3)
    k = tquant.quantize_table(
        torch.randn((V, E), generator=gen, device="cuda") * 0.3)
    buf = torch.empty(V * E + 1, dtype=torch.int8, device="cuda")
    q = buf[1:].view(V, E)
    q.copy_(k["q"])
    k["q"] = q
    upd = (torch.randn((V, E), generator=gen, device="cuda")
           * 0.005).to(torch.bfloat16)
    assert kernel_name(k, upd) == "requant_kernel"
    p = tquant.requantize_reference(k, upd, 77)
    tquant.requantize(k, upd, 77)
    torch.cuda.synchronize()
    assert torch.equal(k["q"], p["q"]) and torch.equal(k["s"], p["s"])


@pytest.mark.cuda
def test_quantize_table_on_the_card_matches_the_cpu():
    """quantize_table on the card divides by 127 as the CPU does (a true
    division): q and s bit-identical to the CPU result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = np.random.default_rng(0)
    t = torch.from_numpy((r.normal(size=(4099, 128)) * 0.3).astype(
        np.float32))
    cpu = tquant.quantize_table(t)
    card = tquant.quantize_table(t.cuda())
    assert torch.equal(card["q"].cpu(), cpu["q"])
    assert torch.equal(card["s"].cpu(), cpu["s"])

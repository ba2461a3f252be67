"""The port's sparse-row update against the JAX package's.

The same numpy inputs (tables, moments, ids, cotangents, step count and
dither salt) go through `code2vec_tpu.training.sparse_update` (under
jit, `fused=False`: the XLA reference; the Pallas path is not bit-exact
against it on this tree) and `code2vec_tpu_torch.training.sparse_update`
with `code2vec_tpu_torch.ops.sparse_update` (the plain versions of
kernels 5 and 6, as the wrappers run them on CPU tensors).

Tolerances, each test repeating its own:
- `dither_from_index`, `quantize_table` and `dedup_segment_sum` are
  exact: the same uint32 and float32 operations in the same order;
- the Adam row math agrees within 4 float32 ulp of the array's largest
  value: XLA under jit contracts `b1 * m + (1 - b1) * g` into a fused
  multiply-add, which the port (like its CUDA kernel) rounds as two
  products and a sum, and `b^t` comes from two `pow` implementations;
- bf16 tables agree within 1 bf16 ulp (the same float32 value rounded
  once, a few float32 ulp apart before the rounding);
- int8 `q` differs by at most 1 on at most 1e-4 of the updated elements
  (a value a float32 ulp from a rounding edge), `s` within 2 ulp;
- rows no id names are bit-identical to the input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.ops import quant as jquant
from code2vec_tpu.training import sparse_update as jsu
from code2vec_tpu.training.sparse_adam import RowAdamState as JState
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.ops import quant as tquant
from code2vec_tpu_torch.ops import sparse_update as tops
from code2vec_tpu_torch.ops import sparse_update_kernel as kern
from code2vec_tpu_torch.training import sparse_update as tsu
from code2vec_tpu_torch.ops.sparse_update import RowAdamState as TState
from code2vec_tpu_torch.training.sparse_adam import row_adam_update
from torch_helpers import assert_close_f32_ulp, max_ulp_diff

CPU = torch.device("cpu")
LR, B1, B2, EPS = 0.01, 0.9, 0.999, 1e-8
ROW_ULP = 4


def _t(a):
    return convert._tensor_from_numpy(np.asarray(a), CPU)


def _n(t):
    return convert._tensor_to_numpy(t)


def _ids_cases(V, N, seed=0):
    r = np.random.default_rng(seed)
    return {
        "heavy_dup": r.integers(0, max(V // 4, 1), N).astype(np.int32),
        "uniform": r.integers(0, V, N).astype(np.int32),
        "all_same": np.full(N, V - 1, np.int32),
        "all_unique": r.permutation(V)[:min(N, V)].astype(np.int32),
    }


def _moments(r, V, E):
    m = (r.normal(size=(V, E)) * 0.1).astype(np.float32)
    v = (np.abs(r.normal(size=(V, E))) * 0.01).astype(np.float32)
    return m, v


def _bf16_ulp_diff(a, b) -> float:
    """Largest |a - b| in units of the bf16 spacing at |b|."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    spacing = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    return float(np.max(np.abs(a - b) / spacing)) if a.size else 0.0


@pytest.mark.parametrize("salt", [0, 1, 0x9E3779B9, 0xFFFFFFFF])
def test_dither_from_index_is_bitwise_jax(salt):
    """Exact: the same uint32 hash and the same float32 conversion, over
    random indices and indices within 100 of 2^32."""
    r = np.random.default_rng(salt % 1000)
    idx = np.concatenate([
        r.integers(0, 2 ** 32, 4096, dtype=np.uint64),
        np.arange(2 ** 32 - 100, 2 ** 32, dtype=np.uint64),
        np.arange(0, 100, dtype=np.uint64)]).astype(np.uint32)
    ref = np.asarray(jquant.dither_from_index(jnp.asarray(idx),
                                              jnp.uint32(salt)))
    got = tquant.dither_from_index(torch.from_numpy(idx.astype(np.int64)),
                                   salt).numpy()
    assert got.dtype == np.float32
    assert got.tobytes() == ref.tobytes()
    assert got.min() >= -0.5 and got.max() < 0.5
    # a salt given as a tensor draws the same stream
    got_t = tquant.dither_from_index(
        torch.from_numpy(idx.astype(np.int64)), torch.tensor(salt))
    assert got_t.numpy().tobytes() == ref.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_table_matches_jax(dtype):
    """Exact: q equal, s bitwise (an all-zero row included)."""
    r = np.random.default_rng(1)
    table = r.normal(size=(37, 16)).astype(np.float32)
    table[3] = 0.0
    jt = jnp.asarray(table).astype(dtype)
    ref = jquant.quantize_table(jt)
    got = tquant.quantize_table(_t(np.asarray(jt)))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    assert np.array_equal(got["q"].numpy(), np.asarray(ref["q"]))
    assert got["s"].numpy().tobytes() == np.asarray(ref["s"]).tobytes()
    assert tquant.is_quantized(got) and not tquant.is_quantized(got["q"])


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["heavy_dup", "uniform", "all_same",
                                  "all_unique"])
def test_dedup_segment_sum_matches_jax_bitwise(case, grad_dtype):
    """Exact: the same unique ids, and float32 sums taken in the same
    per-row order (the port has no sentinel padding: it is compared with
    the first U rows of the JAX output)."""
    V, E, N = 64, 8, 256
    ids = _ids_cases(V, N)[case]
    g = jnp.asarray(np.random.default_rng(2).normal(size=(ids.shape[0], E)),
                    grad_dtype)
    dedup = jax.jit(lambda i, x: jsu.dedup_segment_sum(i, x, V,
                                                       block_rows=32))
    uids_j, seg_j = dedup(jnp.asarray(ids), g)
    uids_t, seg_t = tsu.dedup_segment_sum(torch.from_numpy(ids),
                                          _t(np.asarray(g)))
    U = len(set(ids.tolist()))
    assert tuple(uids_t.shape) == (U,) and seg_t.dtype == torch.float32
    assert np.array_equal(uids_t.numpy(), np.asarray(uids_j)[:U])
    assert seg_t.numpy().tobytes() == np.asarray(seg_j)[:U].tobytes()


@pytest.mark.parametrize("count", [1, 2, 7, 1000])
def test_row_adam_math_matches_jax(count):
    """Within 4 float32 ulp of the largest value on p, m and v (XLA's
    fused multiply-add and `pow` against the port's separately rounded
    operations)."""
    r = np.random.default_rng(count)
    R, E = 50, 16
    p = r.normal(size=(R, E)).astype(np.float32)
    m, v = _moments(r, R, E)
    g = r.normal(size=(R, E)).astype(np.float32)
    math = jax.jit(lambda *a: jsu.row_adam_math(
        *a, jnp.int32(count), LR, B1, B2, EPS))
    ref = math(p, m, v, g)
    lr_t = tsu.adam_lr_t(torch.tensor(count, dtype=torch.int32), LR, B1, B2)
    assert lr_t.dtype == torch.float32 and lr_t.dim() == 0
    got = tops.row_adam_math(*(torch.from_numpy(x) for x in (p, m, v, g)),
                             lr_t, B1, B2, EPS)
    for a, b in zip(got, ref):
        assert_close_f32_ulp(a.numpy(), np.asarray(b), ROW_ULP)


def test_requant_row_math_matches_jax():
    """q within 1 on at most 1e-4 of the elements, s within 2 ulp, m and
    v within 4 ulp of their largest value, on rows near 2^32 / E too (the
    dither index wraps)."""
    r = np.random.default_rng(3)
    R, E = 64, 128
    qt = jquant.quantize_table(jnp.asarray(r.normal(size=(R, E)),
                                           jnp.float32))
    q, s = np.asarray(qt["q"]), np.asarray(qt["s"])
    m, v = _moments(r, R, E)
    g = r.normal(size=(R, E)).astype(np.float32)
    rows = np.concatenate([r.integers(0, 1 << 20, R // 2),
                           (2 ** 32) // E - np.arange(R // 2)])
    rows = rows.astype(np.int64)
    salt = 0xDEADBEEF
    math = jax.jit(lambda *a: jsu.requant_row_math(
        *a, jnp.uint32(salt), jnp.int32(3), LR, B1, B2, EPS))
    ref = math(q, s, m, v, g,
               jnp.asarray(rows.astype(np.uint32).view(np.int32)))
    lr_t = tsu.adam_lr_t(torch.tensor(3, dtype=torch.int32), LR, B1, B2)
    got = tops.requant_row_math(
        *(torch.from_numpy(np.array(x)) for x in (q, s, m, v, g)),
        torch.from_numpy(rows), salt, lr_t, B1, B2, EPS)
    dq = np.abs(got[0].numpy().astype(np.int32) - np.asarray(ref[0]))
    assert dq.max() <= 1 and (dq > 0).mean() <= 1e-4
    assert max_ulp_diff(got[1].numpy(), np.asarray(ref[1])) <= 2
    for a, b in zip(got[2:], ref[2:]):
        assert_close_f32_ulp(a.numpy(), np.asarray(b), ROW_ULP)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V,E,N", [(64, 8, 100), (40, 16, 37),
                                   (300, 128, 513), (5, 8, 160)])
def test_sparse_row_adam_matches_jax_reference(V, E, N, dtype):
    """f32 tables and moments within 4 float32 ulp of their largest value,
    bf16 tables within 1 bf16 ulp; untouched rows bit-identical. The port's
    wrapper on CPU tensors is the plain version."""
    r = np.random.default_rng(V + E + N)
    ids = r.integers(0, V, N).astype(np.int32)
    g = r.normal(size=(N, E)).astype(np.float32)
    table = jnp.asarray(r.normal(size=(V, E)), jnp.float32).astype(dtype)
    m, v = _moments(r, V, E)
    update = jax.jit(lambda t, m, v, i, x: jsu.sparse_row_adam(
        t, JState(m, v), i, x, count=jnp.int32(4), lr=LR, fused=False,
        block_rows=32))
    new_t, new_s = update(table, m, v, jnp.asarray(ids), jnp.asarray(g))
    t_t = _t(np.asarray(table))
    st = TState(torch.from_numpy(m.copy()), torch.from_numpy(v.copy()))
    U = tsu.sparse_row_adam(t_t, st, torch.from_numpy(ids),
                            torch.from_numpy(g),
                            count=torch.tensor(4, dtype=torch.int32), lr=LR)
    live = np.unique(ids)
    assert U == live.size
    got, ref = _n(t_t), np.asarray(new_t)
    assert got.dtype == ref.dtype
    if dtype == "float32":
        assert_close_f32_ulp(got, ref, ROW_ULP)
    else:
        assert _bf16_ulp_diff(got, ref) <= 1.0
    assert_close_f32_ulp(st.m.numpy(), np.asarray(new_s.m), ROW_ULP)
    assert_close_f32_ulp(st.v.numpy(), np.asarray(new_s.v), ROW_ULP)
    dead = np.setdiff1d(np.arange(V), live)
    assert got[dead].tobytes() == np.asarray(table)[dead].tobytes()
    assert st.m.numpy()[dead].tobytes() == m[dead].tobytes()


@pytest.mark.parametrize("V,E,N", [(64, 8, 300), (200, 128, 513),
                                   (3, 16, 40)])
def test_sparse_requant_adam_matches_jax_reference(V, E, N):
    """Salt injected (the JAX facade's draw from the same key): q within 1
    on at most 1e-4 of the updated elements, s within 2 ulp, moments
    within 4 ulp of their largest value; untouched rows bit-identical."""
    r = np.random.default_rng(V * N)
    ids = r.integers(0, V, N).astype(np.int32)
    g = r.normal(size=(N, E)).astype(np.float32)
    qt = jquant.quantize_table(jnp.asarray(r.normal(size=(V, E)),
                                           jnp.float32))
    m, v = _moments(r, V, E)
    key = jax.random.PRNGKey(V + E)
    salt = int(np.asarray(jax.random.bits(key, dtype=jnp.uint32)))
    update = jax.jit(lambda q, s, m, v, i, x: jsu.sparse_requant_adam(
        {"q": q, "s": s}, JState(m, v), i, x, key, count=jnp.int32(2),
        lr=0.05, fused=False, block_rows=32))
    new_q, new_s = update(qt["q"], qt["s"], m, v, jnp.asarray(ids),
                          jnp.asarray(g))
    tq = {"q": _t(qt["q"]), "s": _t(qt["s"])}
    st = TState(torch.from_numpy(m.copy()), torch.from_numpy(v.copy()))
    tsu.sparse_requant_adam(tq, st, torch.from_numpy(ids),
                            torch.from_numpy(g), salt,
                            count=torch.tensor(2, dtype=torch.int32), lr=0.05)
    live = np.unique(ids)
    dq = np.abs(tq["q"].numpy().astype(np.int32)
                - np.asarray(new_q["q"]).astype(np.int32))
    assert dq.max() <= 1 and (dq[live] > 0).mean() <= 1e-4
    assert max_ulp_diff(tq["s"].numpy(), np.asarray(new_q["s"])) <= 2
    assert_close_f32_ulp(st.m.numpy(), np.asarray(new_s.m), ROW_ULP)
    assert_close_f32_ulp(st.v.numpy(), np.asarray(new_s.v), ROW_ULP)
    dead = np.setdiff1d(np.arange(V), live)
    for part in ("q", "s"):
        assert (tq[part].numpy()[dead].tobytes()
                == np.asarray(qt[part])[dead].tobytes())


@pytest.mark.parametrize("case", ["heavy_dup", "uniform", "all_same"])
def test_row_adam_update_oracle_matches_compact_path(case):
    """The port's dense-carrier oracle and its compact path agree bit for
    bit on a float32 table: the same sums in the same order, the same
    row math."""
    V, E, N = 48, 8, 200
    r = np.random.default_rng(4)
    ids = torch.from_numpy(_ids_cases(V, N)[case])
    g = torch.from_numpy(r.normal(size=(ids.shape[0], E)).astype(np.float32))
    table = torch.from_numpy(r.normal(size=(V, E)).astype(np.float32))
    m, v = (torch.from_numpy(x) for x in _moments(r, V, E))
    count = torch.tensor(5, dtype=torch.int32)
    o_t, o_s = row_adam_update(table, TState(m, v), ids, g, count=count,
                               lr=LR)
    c_t, c_s = table.clone(), TState(m.clone(), v.clone())
    tsu.sparse_row_adam(c_t, c_s, ids, g, count=count, lr=LR,
                        use_kernel=False)
    assert torch.equal(o_t, c_t)
    assert torch.equal(o_s.m, c_s.m) and torch.equal(o_s.v, c_s.v)


def test_wrappers_take_the_plain_version_for_cpu_tensors_only():
    """On CPU tensors the wrappers run the plain version and launch
    nothing; on any other device they raise rather than fall back."""
    r = np.random.default_rng(5)
    V, E = 16, 8
    uids = torch.tensor([1, 4, 9], dtype=torch.int32)
    seg = torch.from_numpy(r.normal(size=(3, E)).astype(np.float32))
    lr_t = tsu.adam_lr_t(torch.tensor(1, dtype=torch.int32), LR, B1, B2)
    table = torch.from_numpy(r.normal(size=(V, E)).astype(np.float32))
    st = TState(torch.zeros(V, E), torch.zeros(V, E))
    ref_t, ref_s = table.clone(), TState(st.m.clone(), st.v.clone())
    before = (kern.sparse_row_adam_fused.launches,
              kern.sparse_requant_adam_fused.launches)
    kern.sparse_row_adam_fused(table, st, uids, seg, lr_t, b1=B1, b2=B2,
                               eps=EPS)
    tops.apply_rows_plain(ref_t, ref_s, uids, seg, lr_t, B1, B2, EPS)
    assert torch.equal(table, ref_t) and torch.equal(st.m, ref_s.m)
    qt = tquant.quantize_table(table)
    kern.sparse_requant_adam_fused(qt, TState(torch.zeros(V, E),
                                              torch.zeros(V, E)),
                                   uids, seg, 7, lr_t, b1=B1, b2=B2, eps=EPS)
    assert (kern.sparse_row_adam_fused.launches,
            kern.sparse_requant_adam_fused.launches) == before
    meta = table.to("meta")
    with pytest.raises(ValueError, match="no live-row Adam kernel"):
        kern.sparse_row_adam_fused(
            meta, TState(meta, meta), uids.to("meta"), seg.to("meta"),
            lr_t.to("meta"), b1=B1, b2=B2, eps=EPS)
    with pytest.raises(ValueError, match="no live-row Adam kernel"):
        kern.sparse_requant_adam_fused(
            {"q": qt["q"].to("meta"), "s": qt["s"].to("meta")},
            TState(meta, meta), uids.to("meta"), seg.to("meta"), 7,
            lr_t.to("meta"), b1=B1, b2=B2, eps=EPS)


@pytest.mark.cuda
def test_kernels_raise_when_the_library_cannot_be_built(monkeypatch):
    """On the card, a kernel whose library does not build raises; the
    wrapper never swaps in the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from code2vec_tpu_torch.ops import _build

    def no_library(name):
        raise _build.KernelBuildError(f"no library for {name}")
    monkeypatch.setattr(_build, "load", no_library)
    dev = torch.device("cuda")
    table = torch.zeros(8, 32, device=dev)
    st = TState(torch.zeros_like(table), torch.zeros_like(table))
    uids = torch.tensor([2], dtype=torch.int32, device=dev)
    seg = torch.ones(1, 32, device=dev)
    lr_t = torch.full((), 1e-3, device=dev)
    with pytest.raises(_build.KernelBuildError):
        kern.sparse_row_adam_fused(table, st, uids, seg, lr_t, b1=B1, b2=B2,
                                   eps=EPS)
    qt = tquant.quantize_table(table + 1)
    with pytest.raises(_build.KernelBuildError):
        kern.sparse_requant_adam_fused(qt, st, uids, seg, 3, lr_t, b1=B1,
                                       b2=B2, eps=EPS)
    assert torch.equal(table, torch.zeros_like(table))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_kernels_match_plain_versions_on_the_card(kind):
    """Kernels 5 and 6 against their plain versions on CUDA tensors:
    bit-identical tables, scales and moments."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    V, E, N = 1000, 128, 5000
    ids = torch.randint(0, V, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    uids, seg = tsu.dedup_segment_sum(
        ids, torch.randn(N, E, generator=gen, device=dev))
    base = torch.randn(V, E, generator=gen, device=dev)
    m0 = torch.randn(V, E, generator=gen, device=dev) * 0.1
    v0 = torch.rand(V, E, generator=gen, device=dev) * 0.01
    lr_t = tsu.adam_lr_t(torch.tensor(3, dtype=torch.int32, device=dev), LR,
                         B1, B2)

    def fresh():
        t = (tquant.quantize_table(base) if kind == "int8"
             else base.to(getattr(torch, kind)))
        if kind == "int8":
            t = {k: x.clone() for k, x in t.items()}
        return t, TState(m0.clone(), v0.clone())
    k_t, k_s = fresh()
    p_t, p_s = fresh()
    tsu.apply_rows(k_t, k_s, uids, seg, lr_t=lr_t, b1=B1, b2=B2, eps=EPS,
                   salt=99, use_kernel=True)
    tsu.apply_rows(p_t, p_s, uids, seg, lr_t=lr_t, b1=B1, b2=B2, eps=EPS,
                   salt=99, use_kernel=False)
    torch.cuda.synchronize()
    if kind == "int8":
        assert torch.equal(k_t["q"], p_t["q"]) and torch.equal(k_t["s"],
                                                               p_t["s"])
    else:
        assert torch.equal(k_t, p_t)
    assert torch.equal(k_s.m, p_s.m) and torch.equal(k_s.v, p_s.v)

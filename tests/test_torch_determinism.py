"""The deterministic row scatter (ops/scatter.py) and one training step's
bits on the card.

On the CPU:
- `scatter_rows`, `scatter_rows_bf16` and `segment_sum_rows` are
  `index_add_` there, bit for bit (bound 0), for float32 and bf16 rows
  and many repeated ids;
- their card order (`pairwise_segment_sum` and `pairwise_scatter`:
  plain torch ops, run here on CPU tensors) equals a recursive balanced
  pairwise sum of each id's rows bit for bit, lies within (L + 1) u of
  the sum of |row| at each element of the float64 sum (a binary tree of
  depth L = ceil(log2(longest run)), every add rounded: u = 2^-24 in
  float32, 2^-8 in bf16; a float32 sum rounded once more to bf16: plus
  2^-8 of the value), and gives the same bits on a second call;
- `take_rows_det`'s gradient is `index_select`'s, bit for bit;
- the card's orders in place of the CPU's keep the dense and sparse-row
  steps of test_torch_dense_step.py and test_torch_train_step.py within
  those files' bounds against the JAX package, unchanged.

On the card (`cuda`, skipped here): the same scatter bounds and the
same bits twice at a java-large batch's shape, and
`tools/determinism.py`: one step of each of (a)-(e) twice from one
state with the same draws (the same bits), no op that adds with
atomics, and under `torch.use_deterministic_algorithms` the same bits
again.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import code2vec_tpu_torch.ops.quant as quant_mod
import code2vec_tpu_torch.ops.scatter as scatter_mod
import code2vec_tpu_torch.training.sparse_update as sparse_update_mod
import test_torch_dense_step as tds
import test_torch_train_step as tts
from code2vec_tpu_torch.ops.scatter import (pairwise_scatter,
                                            pairwise_segment_sum,
                                            scatter_rows, scatter_rows_bf16,
                                            segment_sum_rows, take_rows_det)

V, E = 300, 8
CASES = ["heavy_dup", "zipf", "all_same", "unique"]


def _ids(case, n, seed=0):
    r = np.random.default_rng(seed)
    if case == "heavy_dup":   # one id holds most rows, as PAD does
        ids = np.where(r.random(n) < 0.7, 0, r.integers(0, V, n))
    elif case == "zipf":
        p = 1.0 / np.arange(1, V + 1) ** 1.1
        ids = r.choice(V, size=n, p=p / p.sum())
    elif case == "all_same":
        ids = np.full(n, 7)
    else:
        ids = r.permutation(V)[:min(n, V)]
    return torch.from_numpy(ids.astype(np.int64))


def _rows(n, dtype, seed=1):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.normal(size=(n, E)).astype(np.float32)).to(
        dtype)


def _exact(ids, rows):
    """(the float64 sums, the float64 sums of |row|), dense [V, E]."""
    z = torch.zeros((V, E), dtype=torch.float64, device=rows.device)
    return (z.clone().index_add_(0, ids, rows.double()),
            z.index_add_(0, ids, rows.double().abs()))


def _pairwise(x):
    """A recursive balanced pairwise sum of the rows of `x`, the left
    half a power of two, each add of two partial sums rounded to x's
    dtype (a float32 add rounded once)."""
    if x.shape[0] == 1:
        return x[0]
    half = 1 << (x.shape[0] - 1).bit_length() - 1
    return (_pairwise(x[:half]).float() + _pairwise(x[half:]).float()).to(
        x.dtype)


def _check_scatters(ids, rows):
    """The card order: bit for bit the recursive pairwise sum (on the
    CPU, for 20 ids), within its bound of the exact sums, the same bits
    on a second call, on `ids`' and `rows`' device."""
    exact, mag = _exact(ids, rows)
    longest = int(torch.unique(ids, return_counts=True)[1].max())
    depth = math.ceil(math.log2(max(longest, 2)))
    for acc, u in ((torch.float32, 2.0 ** -24), (torch.bfloat16, 2.0 ** -8)):
        uids, sums = pairwise_segment_sum(ids, rows, acc)
        again = pairwise_segment_sum(ids, rows, acc)
        assert torch.equal(uids, torch.unique(ids)) and sums.dtype == acc
        assert torch.equal(uids, again[0]) and torch.equal(sums, again[1])
        err = (sums.double() - exact[uids]).abs()
        assert (err <= (depth + 1) * u * mag[uids]).all(), acc
        if ids.device.type == "cpu":
            for k in range(min(20, uids.shape[0])):
                run = rows[ids == uids[k]].to(acc)
                assert torch.equal(_pairwise(run), sums[k]), (acc, k)
        for dtype in (torch.float32, torch.bfloat16):
            dense = pairwise_scatter(ids, rows, V, dtype, acc)
            assert dense.dtype == dtype and dense.shape == (V, E)
            assert torch.equal(dense[uids], sums.to(dtype))
            rest = torch.ones(V, dtype=torch.bool, device=ids.device)
            rest[uids] = False
            assert not dense[rest].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_cpu_path_is_index_add(case, dtype):
    """Bound 0: on CPU tensors `scatter_rows` (and in bf16
    `scatter_rows_bf16`) is `zeros.index_add_` and `segment_sum_rows`
    its float32 form over the unique ids."""
    ids = _ids(case, 2000)
    rows = _rows(ids.shape[0], dtype)
    want = torch.zeros((V, E), dtype=dtype).index_add_(0, ids, rows)
    assert torch.equal(scatter_rows(ids, rows, V, dtype), want)
    if dtype == torch.bfloat16:
        assert torch.equal(scatter_rows_bf16(ids, rows, V), want)
    uids, sums = segment_sum_rows(ids, rows)
    ref = torch.zeros((V, E)).index_add_(0, ids, rows.float())
    assert torch.equal(uids, torch.unique(ids)) and sums.dtype == torch.float32
    assert torch.equal(sums, ref[uids])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_card_orders_are_within_their_rounding(case, dtype):
    """The card order on CPU tensors, 5,000 rows: the recursive pairwise
    sum bit for bit, the bounds of the module's docstring, the same bits
    twice."""
    ids = _ids(case, 5000)
    _check_scatters(ids, _rows(ids.shape[0], dtype))


def test_take_rows_det_gradient_is_index_selects():
    """Bound 0 on the CPU: the same forward rows and the same dense
    gradient as torch.index_select's autograd, float32 and bf16 tables,
    ids of any shape."""
    for dtype in (torch.float32, torch.bfloat16):
        table = _rows(V, dtype, seed=3)
        ids = _ids("zipf", 600).reshape(20, 30)
        g = _rows(600, dtype, seed=4).reshape(20, 30, E)
        a = table.clone().requires_grad_(True)
        b = table.clone().requires_grad_(True)
        ra = take_rows_det(a, ids)
        rb = torch.index_select(b, 0, ids.reshape(-1)).reshape(20, 30, E)
        assert torch.equal(ra, rb)
        (ra * g).sum().backward()
        (rb * g).sum().backward()
        assert a.grad.dtype == dtype and torch.equal(a.grad, b.grad)


def _card_orders(monkeypatch):
    """Every scatter site takes the card's order on CPU tensors."""
    monkeypatch.setattr(
        scatter_mod, "scatter_rows",
        lambda i, r, n, dt: pairwise_scatter(i, r, n, dt, torch.float32))
    monkeypatch.setattr(
        quant_mod, "scatter_rows_bf16",
        lambda i, r, n: pairwise_scatter(i, r, n, torch.bfloat16,
                                         torch.bfloat16))
    monkeypatch.setattr(
        sparse_update_mod, "segment_sum_rows",
        lambda i, r: pairwise_segment_sum(i, r, torch.float32))


@pytest.mark.parametrize("case", [
    ("float32", True, 3), ("bfloat16", False, 1), ("bfloat16", True, 3),
    ("int8", "bfloat16", False), ("int8", "float32", False),
    ("int8", "float32", True)],
    ids=["f32-sampled-3", "bf16-full-1", "bf16-sampled-3", "int8-bf16-full",
         "int8-f32-full", "int8-f32-sampled"])
def test_the_card_orders_keep_the_dense_steps_within_bounds(case,
                                                             monkeypatch):
    """The gathers' backward in the card's order (float32 pairwise sums
    rounded once to the table's dtype; bf16 pairwise adds for the int8
    tables' carrier) in place of the CPU's `index_add_`: the dense steps of
    test_torch_dense_step.py stay within that file's bounds against the
    JAX package (each test's docstring states them; the int8 cases
    against the XLA requantize)."""
    _card_orders(monkeypatch)
    if case[0] == "int8":
        _, compute, sampled = case
        tds.test_int8_dense_step_matches_jax(sampled, compute, False)
    elif case[0] == "float32":
        tds.test_float32_dense_step_matches_jax(case[1], case[2])
    else:
        tds.test_bf16_dense_step_matches_jax(case[1], case[2])


@pytest.mark.parametrize("tables", ["float32", "bfloat16", "int8"])
def test_the_card_order_keeps_the_sparse_step_within_bounds(tables,
                                                             monkeypatch):
    """The sparse-row step's segment sum in the card's order (float32
    pairwise sums) in place of the CPU's `index_add_`: the
    sampled-softmax sparse-row steps of test_torch_train_step.py stay
    within that file's bounds against the JAX package."""
    _card_orders(monkeypatch)
    if tables == "float32":
        tts.test_float32_step_matches_jax(True, 3)
    elif tables == "bfloat16":
        tts.test_bf16_step_matches_jax(True, 3)
    else:
        tts.test_int8_step_matches_jax(True, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatters_on_the_card(dtype):
    """At a java-large batch's shape (409,600 rows, 70 % one id) on the
    card: the bounds of the module's docstring, the same bits twice, and
    the public functions take the card order on CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    ids = _ids("heavy_dup", 409_600).cuda()
    rows = _rows(ids.shape[0], dtype).cuda()
    _check_scatters(ids, rows)
    assert torch.equal(scatter_rows(ids, rows, V, dtype),
                       pairwise_scatter(ids, rows, V, dtype, torch.float32))
    assert torch.equal(scatter_rows_bf16(ids, rows, V),
                       pairwise_scatter(ids, rows, V, torch.bfloat16,
                                        torch.bfloat16))
    for got, want in zip(segment_sum_rows(ids, rows),
                         pairwise_segment_sum(ids, rows, torch.float32)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_one_step_of_each_configuration_repeats_its_bits(tmp_path):
    """tools/determinism.py in a subprocess (it sets
    CUBLAS_WORKSPACE_CONFIG before CUDA starts) at B = 64 over a 5,000-row
    Zipf vocabulary: in each of (a)-(e) one step twice from one state
    gives the same bits, no op adds with atomics, and the step under
    torch.use_deterministic_algorithms gives the same bits without a
    warning."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    out = tmp_path / "det.json"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "code2vec_tpu_torch.tools.determinism",
         "--vocab", "5000", "--batch", "64", "--out", str(out)],
        cwd=repo, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    rows = json.loads(out.read_text())
    assert [row["config"] for row in rows] == list("abcde")
    for row in rows:
        assert row["twice_same_bits"], row["twice_differ"]
        assert row["atomic_ops"] == {}, row["atomic_ops"]
        assert row["strict_same_bits"] and not row["strict_warnings"], row

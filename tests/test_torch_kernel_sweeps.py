"""The port's kernel sweeps (code2vec_tpu_torch/tools/requant_sweep.py
for kernel 4, sparse_update_sweep.py for kernels 5 and 6) against the
JAX root tools of the same names (tests/test_requant_sweep.py,
tests/test_sparse_update_sweep.py), on the CPU at a tiny size (V 64,
E 8). Off the card the wrappers run the kernels' plain versions, so
these are tier-1 tests; the card's numbers come from the tools on the
card.

Tolerances: none. The rows carry the JAX tool's keys; `sweep_bytes`,
`update_bytes` and `unique_rows` equal the JAX functions' on the same
numpy inputs exactly; kernel 4's reported block is the one csrc/
requant.cu's launch covers.
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.ops import quant as jquant
from code2vec_tpu.ops.pallas_requant import \
    requant_traffic_bytes as jax_requant_traffic_bytes
from code2vec_tpu.training import sparse_update as jsu
from code2vec_tpu_torch.ops import requant_kernel
from code2vec_tpu_torch.ops.quant import quantize_table
from code2vec_tpu_torch.tools import requant_sweep, sparse_update_sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

REQUANT_KEYS = ("vocab", "block_rows", "fused_ms", "reference_ms",
                "sweep_bytes", "fused_gbps", "mode")
SPARSE_KEYS = ("vocab", "n_ids", "block_rows", "dtype", "unique_rows",
               "fused_ms", "reference_ms", "update_bytes", "fused_gbps",
               "mode")


def _rows(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.strip().startswith("{")]


# ---- kernel 4 ----

def test_requant_sweep_tiny_grid(capsys, tmp_path):
    """The JAX test's grid at the kernel's block: one row with the JAX
    keys, `sweep_bytes` the JAX `requant_traffic_bytes` of the same
    numpy table and update, the row appended to `--out`."""
    out = str(tmp_path / "sweep.jsonl")
    assert requant_sweep.main(["--backend", "cpu", "--vocabs", "64",
                               "--blocks", "8", "--emb", "8", "--steps",
                               "2", "--out", out]) == 0
    (row,) = _rows(capsys)
    for key in REQUANT_KEYS:
        assert key in row, key
    assert row["vocab"] == 64 and row["block_rows"] == 8
    assert row["mode"] == "plain"
    r = np.random.default_rng(64)
    qt = jquant.quantize_table(jnp.asarray(r.normal(size=(64, 8)) * 0.3,
                                           jnp.float32))
    upd = jnp.asarray(r.normal(size=(64, 8)) * 1e-4, jnp.bfloat16)
    assert row["sweep_bytes"] == jax_requant_traffic_bytes(qt, upd)
    with open(out, encoding="utf-8") as f:
        assert json.loads(f.readline())["sweep_bytes"] == row["sweep_bytes"]


@pytest.mark.parametrize("V,E,update_dtype", [
    (64, 8, "bfloat16"), (1000, 128, "float32"), (37, 100, "bfloat16")])
def test_requant_traffic_bytes_equal_the_jax_function(V, E, update_dtype):
    r = np.random.default_rng(V)
    table = (r.normal(size=(V, E)) * 0.3).astype(np.float32)
    upd = (r.normal(size=(V, E)) * 1e-4).astype(np.float32)
    jqt = jquant.quantize_table(jnp.asarray(table))
    tqt = quantize_table(torch.from_numpy(table))
    tupd = torch.from_numpy(upd).to(getattr(torch, update_dtype))
    assert requant_kernel.requant_traffic_bytes(tqt, tupd) \
        == jax_requant_traffic_bytes(jqt, jnp.asarray(upd, update_dtype))


def test_block_rows_reads_the_kernels_launch_geometry():
    """The rows a CTA of csrc/requant.cu covers: (kThreads / 32) * (32 /
    lanes) on the vector kernel's shapes (E = kPiece * lanes, lanes a
    power of two up to 32), kThreads / 32 on the scalar kernel's."""
    src = open(os.path.join(REPO, "code2vec_tpu_torch", "csrc",
                            "requant.cu")).read()
    common = open(os.path.join(REPO, "code2vec_tpu_torch", "csrc",
                               "quant_common.cuh")).read()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    piece = int(re.search(r"constexpr int kPiece = (\d+);",
                          src + common)[1])
    assert (threads, piece) == (requant_kernel._THREADS,
                                requant_kernel._PIECE)
    for lanes in (1, 2, 4, 8, 16, 32):
        assert requant_kernel.block_rows(piece * lanes) \
            == threads // 32 * (32 // lanes)
    for emb in (8, 100, piece * 3, piece * 64):
        assert requant_kernel.block_rows(emb) == threads // 32
    assert requant_kernel.block_rows(128) == 32


def test_requant_sweep_refuses_another_block(capsys):
    """The CUDA grid is fixed: a block size other than the kernel's
    exits 2 and says so."""
    assert requant_sweep.main(["--backend", "cpu", "--vocabs", "64",
                               "--blocks", "32", "--emb", "8"]) == 2
    err = capsys.readouterr().err
    assert "8 rows" in err and "--blocks 32" in err


# ---- kernels 5 and 6 ----

def _jax_cell(V, E, n_ids, dtype):
    """The JAX tool's cell from numpy seed V: its table and unique-row
    count, and the cotangent itemsize."""
    r = np.random.default_rng(V)
    base = jnp.asarray(r.normal(size=(V, E)) * 0.3, jnp.float32)
    quantized = dtype == "int8"
    table = jquant.quantize_table(base) if quantized \
        else base.astype(jnp.bfloat16 if dtype == "bfloat16"
                         else jnp.float32)
    ids = jnp.asarray(r.integers(0, V, n_ids), jnp.int32)
    grads = jnp.asarray(r.normal(size=(n_ids, E)) * 1e-3,
                        jnp.bfloat16 if dtype == "bfloat16"
                        else jnp.float32)
    return table, int(np.unique(np.asarray(ids)).size), grads.dtype.itemsize


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_sparse_update_sweep_tiny_grid(capsys, tmp_path, dtype):
    """The JAX test's grid: one row with the JAX keys; `unique_rows` and
    `update_bytes` equal the JAX tool's for the same numpy inputs."""
    out = str(tmp_path / "sweep.jsonl")
    assert sparse_update_sweep.main(
        ["--backend", "cpu", "--vocabs", "64", "--blocks", "32", "--emb",
         "8", "--ids", "128", "--dtype", dtype, "--steps", "2", "--out",
         out]) == 0
    (row,) = _rows(capsys)
    for key in SPARSE_KEYS:
        assert key in row, key
    assert row["vocab"] == 64 and row["block_rows"] == 32
    assert row["dtype"] == dtype and row["mode"] == "plain"
    table, unique, itemsize = _jax_cell(64, 8, 128, dtype)
    assert row["unique_rows"] == unique
    assert 0 < row["unique_rows"] <= 64
    assert row["update_bytes"] == jsu.sparse_update_traffic_bytes(
        table, 128, unique, grad_itemsize=itemsize, block_rows=32)
    with open(out, encoding="utf-8") as f:
        assert json.loads(f.readline())["update_bytes"] \
            == row["update_bytes"]


def test_sparse_update_sweep_blocks_size_the_segment_buffer(capsys):
    """Each block gives the JAX `update_bytes` of its `_num_slots`
    segment buffer; the timed apply is the same for every block."""
    assert sparse_update_sweep.main(
        ["--backend", "cpu", "--vocabs", "64,100", "--blocks", "32,100,512",
         "--emb", "8", "--ids", "130", "--dtype", "float32", "--steps",
         "2"]) == 0
    rows = _rows(capsys)
    assert [(r["vocab"], r["block_rows"]) for r in rows] == [
        (v, b) for v in (64, 100) for b in (32, 100, 512)]
    for r in rows:
        table, unique, itemsize = _jax_cell(r["vocab"], 8, 130, "float32")
        assert r["update_bytes"] == jsu.sparse_update_traffic_bytes(
            table, 130, unique, grad_itemsize=itemsize,
            block_rows=r["block_rows"])
    for v in (64, 100):
        same = [r for r in rows if r["vocab"] == v]
        assert len({(r["fused_ms"], r["reference_ms"]) for r in same}) == 1
        assert len({r["update_bytes"] for r in same}) == 3


# ---- the command lines ----

@pytest.mark.parametrize("tool", [requant_sweep, sparse_update_sweep],
                         ids=["requant_sweep", "sparse_update_sweep"])
def test_the_sweeps_exit_2_without_a_card(tool, capsys):
    assert tool.main([]) == 2
    assert "--backend gpu" in capsys.readouterr().err

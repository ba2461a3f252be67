"""Id-count x vocab microbench of the live-row sparse update through
kernels 5 and 6 (training/sparse_update.py over ops/sparse_update_kernel
.py, csrc/sparse_row_update.cu) against their plain versions: a copy of
tools/sparse_update_sweep.py of the JAX package over the port.

Emits one JSON line per (vocab, n_ids, block_rows) cell with the JAX
tool's keys: fused ms, reference ms, the analytic [U, E]-aware bytes of
one apply (training/sparse_update.sparse_update_traffic_bytes at the
cell's measured unique-row count) and the achieved GB/s, all
slope-timed (tools/_bench_common.slope_time, each chain ended by a
scalar read). The timed call is the facade's composition the sparse
train step runs: dedup + segment-sum + live-row apply
(`sparse_row_adam`, or `sparse_requant_adam` for `--dtype int8`), in
place on the table and its moments, with `use_kernel=True` (kernels 5
and 6 on the card) against `use_kernel=False` (their plain versions).

The block axis: the JAX tool times its Pallas kernel at each row-block
size. In the port a block size is real only in the traffic model, whose
segment buffer holds `_num_slots(n_ids, block_rows)` rows (the JAX
kernel's unique-id capacity), so each `--blocks` value gives its own
`update_bytes` and `fused_gbps`, while the kernels' grid covers exactly
the U live rows whatever the block: `fused_ms` and `reference_ms` are
timed once a vocab and shared by its blocks. `mode` reads `gpu` (the
kernels on the card) or `plain` (`--backend cpu`: the wrappers run the
plain versions on CPU tensors, so off the card the numbers exercise the
sweep, not the kernels; the default grid shrinks to a smoke scale
there, as the JAX tool's does off a TPU).

    python3 -m code2vec_tpu_torch.tools.sparse_update_sweep \\
        [--vocabs 65536,262144,1048576] [--blocks 128,256,512,1024] \\
        [--ids 409600] [--emb 128] [--dtype bfloat16|float32|int8] \\
        [--steps 20] [--out sweep.jsonl] [--backend gpu|cpu]

`--backend gpu` (the default) exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List

import numpy as np
import torch

from code2vec_tpu_torch import tree
from code2vec_tpu_torch.ops.quant import is_quantized, quantize_table
from code2vec_tpu_torch.tools._bench_common import (BATCH, CTX,
                                                    backend_device, card_line,
                                                    scalar_sync, slope_time)
from code2vec_tpu_torch.training import sparse_update as su
from code2vec_tpu_torch.training.sparse_adam import init_row_adam

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int8": None}


def cell_arrays(vocab: int, emb: int, n_ids: int):
    """A cell's numpy draws, as the JAX tool makes them from seed
    `vocab`: N(0, 0.3^2) float32 table rows, uniform ids, N(0, 1e-6)
    cotangents. The same for every dtype."""
    r = np.random.default_rng(vocab)
    base = (r.normal(size=(vocab, emb)) * 0.3).astype(np.float32)
    ids = r.integers(0, vocab, n_ids).astype(np.int32)
    grads = (r.normal(size=(n_ids, emb)) * 1e-3).astype(np.float32)
    return base, ids, grads


def cell_tensors(arrays, dtype: str, device):
    """`cell_arrays` as the table (quantized for int8, cast for bf16),
    the ids and the cotangents (bf16 for a bf16 table, else float32) on
    `device`."""
    base, ids, grads = (torch.from_numpy(a).to(device) for a in arrays)
    table = quantize_table(base) if dtype == "int8" \
        else base.to(DTYPES[dtype])
    if dtype == "bfloat16":
        grads = grads.to(torch.bfloat16)
    return table, ids, grads


def apply_once(table, state, ids, grads, count, salt, use_kernel: bool
               ) -> int:
    """One dedup + segment-sum + live-row apply, in place; U."""
    if is_quantized(table):
        return su.sparse_requant_adam(table, state, ids, grads, salt,
                                      count=count, lr=1e-3,
                                      use_kernel=use_kernel)
    return su.sparse_row_adam(table, state, ids, grads, count=count,
                              lr=1e-3, use_kernel=use_kernel)


def sweep(vocabs: List[int], blocks: List[int], n_ids: int, emb: int,
          dtype: str, steps: int, device) -> List[dict]:
    """One row a (vocab, block_rows) cell."""
    on_card = device.type == "cuda"
    warmup, base = (5, 10) if on_card else (1, 2)

    def timed_ms(table, ids, grads, use_kernel):
        """Slope-time the apply on a fresh copy of the table and zero
        moments, the step count (and the int8 salt) advancing a call."""
        t = tree.map_leaves(torch.clone, table)
        state = init_row_adam(t)
        sync_t = t["s"] if is_quantized(t) else t
        count = torch.ones((), dtype=torch.int32, device=device)

        def chain(n, k):
            t0 = time.perf_counter()
            for i in range(n):
                apply_once(t, state, ids, grads, count, k + i, use_kernel)
                count.add_(1)
            scalar_sync(sync_t)
            return time.perf_counter() - t0, k + n
        return max(slope_time(chain, 1, steps, warmup=warmup, base=base),
                   1e-9) * 1e3

    rows = []
    for V in vocabs:
        table, ids, grads = cell_tensors(cell_arrays(V, emb, n_ids), dtype,
                                         device)
        unique_rows = int(np.unique(ids.cpu().numpy()).size)
        ref_ms = timed_ms(table, ids, grads, False)
        fused_ms = timed_ms(table, ids, grads, True)
        for br in blocks:
            nbytes = su.sparse_update_traffic_bytes(
                table, n_ids, unique_rows,
                grad_itemsize=grads.element_size(), block_rows=br)
            row = {"vocab": V, "emb": emb, "n_ids": n_ids, "dtype": dtype,
                   "block_rows": br, "mode": "gpu" if on_card else "plain",
                   "unique_rows": unique_rows,
                   "fused_ms": round(fused_ms, 3),
                   "reference_ms": round(ref_ms, 3),
                   "update_bytes": int(nbytes),
                   "fused_gbps": round(nbytes / (fused_ms / 1e3) / 1e9, 2)}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del table, ids, grads
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m code2vec_tpu_torch.tools.sparse_update_sweep",
        description=__doc__.split("\n")[0])
    ap.add_argument("--vocabs", default=None,
                    help="comma-separated table row counts")
    ap.add_argument("--blocks", default=None,
                    help="comma-separated row-block sizes of the traffic "
                         "model's segment buffer")
    ap.add_argument("--ids", type=int, default=None,
                    help="gathered ids per apply (default: 2*B*C on the "
                         "card, the token table's workload, else a smoke "
                         "count)")
    ap.add_argument("--emb", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16", choices=list(DTYPES),
                    help="table storage dtype (int8 sweeps the "
                         "requantize-aware row update, kernel 6)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also append JSONL here")
    ap.add_argument("--backend", choices=("gpu", "cpu"), default="gpu",
                    help="gpu (default): kernels 5 and 6 on the CUDA card; "
                         "cpu: their plain versions")
    a = ap.parse_args(argv)
    device = backend_device(a.backend)
    if device is None:
        return 2
    on_card = device.type == "cuda"
    vocabs = [int(x) for x in (a.vocabs or (
        "65536,262144,1048576" if on_card else "2048")).split(",")]
    blocks = [int(x) for x in (a.blocks or (
        "128,256,512,1024" if on_card else "128,256")).split(",")]
    n_ids = a.ids if a.ids is not None else \
        (2 * BATCH * CTX if on_card else 4096)
    print(f"card: {card_line(device)}", flush=True)
    rows = sweep(vocabs, blocks, n_ids, a.emb, a.dtype, a.steps, device)
    if a.out:
        with open(a.out, "a", encoding="utf-8") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

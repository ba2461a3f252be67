"""Vocab-size microbench of kernel 4, the fused dense int8 requantize
(ops/requant_kernel.py, csrc/requant.cu), against its plain version
(ops/quant.requantize_reference): a copy of tools/requant_sweep.py of
the JAX package over the port.

Emits one JSON line per (vocab, block_rows) cell with the JAX tool's
keys: fused ms, reference ms, the analytic bytes of one fused sweep
(ops/requant_kernel.requant_traffic_bytes) and the achieved GB/s, all
slope-timed (tools/_bench_common.slope_time, each chain ended by a
scalar read).

One departure from the JAX tool: its Pallas kernel takes a row-block
size, and the sweep times each. The CUDA kernel's geometry is fixed by
its source (`kThreads` in csrc/requant.cu), so `block_rows` reports the
rows one CTA covers at the table's width (ops/requant_kernel.block_rows:
32 at E = 128) and `--blocks` naming any other size exits 2, saying so.
`mode` reads `gpu` (the kernel on the card) or `plain` (`--backend cpu`:
the kernel's wrapper runs the plain version on CPU tensors, so off the
card the numbers exercise the sweep, not the kernel; the default grid
shrinks to a smoke-scale vocab there, as the JAX tool's does off a TPU).

    python3 -m code2vec_tpu_torch.tools.requant_sweep \\
        [--vocabs 65536,262144,1048576] [--blocks 32] [--emb 128] \\
        [--steps 20] [--out sweep.jsonl] [--backend gpu|cpu]

`--backend gpu` (the default) exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from code2vec_tpu_torch.ops.quant import quantize_table, requantize_reference
from code2vec_tpu_torch.ops.requant_kernel import (block_rows,
                                                   requant_traffic_bytes,
                                                   requantize_fused)
from code2vec_tpu_torch.tools._bench_common import (backend_device, card_line,
                                                    scalar_sync, slope_time)


def cell_inputs(vocab: int, emb: int, device):
    """A cell's table and update, as the JAX tool makes them from numpy
    seed `vocab`: an int8 table quantized from N(0, 0.3^2) float32 rows
    and a bf16 N(0, 1e-8) update."""
    r = np.random.default_rng(vocab)
    qt = quantize_table(torch.from_numpy(
        (r.normal(size=(vocab, emb)) * 0.3).astype(np.float32)).to(device))
    upd = torch.from_numpy((r.normal(size=(vocab, emb)) * 1e-4).astype(
        np.float32)).to(device).to(torch.bfloat16)
    return qt, upd


def blocks_refused(blocks: Optional[List[int]], emb: int) -> Optional[str]:
    """Why `--blocks` cannot be swept at width `emb` (it names a size
    other than the kernel's own), or None."""
    block = block_rows(emb)
    if blocks is None or set(blocks) == {block}:
        return None
    return (f"kernel 4's CUDA grid is fixed: one CTA covers {block} rows at "
            f"E = {emb} (csrc/requant.cu); --blocks "
            f"{','.join(map(str, blocks))} names another size")


def sweep(vocabs: List[int], emb: int, steps: int, device) -> List[dict]:
    """One row a vocab, at the kernel's own block."""
    on_card = device.type == "cuda"
    block = block_rows(emb)
    warmup, base = (5, 10) if on_card else (1, 2)

    def timed_ms(fn, qt):
        """Slope-time `fn(salt) -> table` with a fresh uint32 salt a call,
        each chain ended by a scalar read of the scales."""
        def chain(n, salt):
            t0 = time.perf_counter()
            out = None
            for i in range(n):
                out = fn(salt + i)
            scalar_sync((out or qt)["s"])
            return time.perf_counter() - t0, salt + n
        return max(slope_time(chain, 1, steps, warmup=warmup, base=base),
                   1e-9) * 1e3

    rows = []
    for V in vocabs:
        qt, upd = cell_inputs(V, emb, device)
        nbytes = requant_traffic_bytes(qt, upd)
        ref_ms = timed_ms(lambda salt: requantize_reference(qt, upd, salt),
                          qt)
        # the kernel updates in place: it sweeps a copy
        mine = {"q": qt["q"].clone(), "s": qt["s"].clone()}
        fused_ms = timed_ms(lambda salt: requantize_fused(mine, upd, salt),
                            mine)
        row = {"vocab": V, "emb": emb, "block_rows": block,
               "mode": "gpu" if on_card else "plain",
               "fused_ms": round(fused_ms, 3),
               "reference_ms": round(ref_ms, 3),
               "sweep_bytes": int(nbytes),
               "fused_gbps": round(nbytes / (fused_ms / 1e3) / 1e9, 2)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del qt, upd, mine
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m code2vec_tpu_torch.tools.requant_sweep",
        description=__doc__.split("\n")[0])
    ap.add_argument("--vocabs", default=None,
                    help="comma-separated table row counts")
    ap.add_argument("--blocks", default=None,
                    help="comma-separated row-block sizes: only the "
                         "kernel's own (ops/requant_kernel.block_rows)")
    ap.add_argument("--emb", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also append JSONL here")
    ap.add_argument("--backend", choices=("gpu", "cpu"), default="gpu",
                    help="gpu (default): kernel 4 on the CUDA card; cpu: "
                         "its plain version")
    a = ap.parse_args(argv)
    device = backend_device(a.backend)
    if device is None:
        return 2
    vocabs = [int(x) for x in (a.vocabs or (
        "65536,262144,1048576" if device.type == "cuda" else "2048")
    ).split(",")]
    blocks = [int(x) for x in a.blocks.split(",")] if a.blocks else None
    refused = blocks_refused(blocks, a.emb)
    if refused:
        print(f"error: {refused}", file=sys.stderr)
        return 2
    print(f"card: {card_line(device)}", flush=True)
    rows = sweep(vocabs, a.emb, a.steps, device)
    if a.out:
        with open(a.out, "a", encoding="utf-8") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

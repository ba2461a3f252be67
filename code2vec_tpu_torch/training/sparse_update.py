"""Sparse table update: dedup + segment-sum + live-row Adam.

Counterpart of the single-device half of `training/sparse_update.py` in
the JAX package. A step's per-occurrence row cotangents are deduplicated
and summed into a compact [U, E] float32 gradient (`dedup_segment_sum`),
and Adam updates only those U rows of the table and its moments, in
place: row-Adam for float32 / bfloat16 tables (kernel 5), row-Adam with
a per-row requantize for int8 {q, s} tables (kernel 6). The row math and
the plain versions of both kernels are in ops/sparse_update.py.

`sparse_row_adam` / `sparse_requant_adam` are the entry points. With
`use_kernel=True` (the default) they go through the wrappers of
ops/sparse_update_kernel.py, which launch the hand-written CUDA kernels
for CUDA tensors and run the plain versions for CPU tensors;
`use_kernel=False` runs the plain version on any device.

Differences from the JAX package, none of which changes a value:
- the compact gradient has exactly U rows (no sentinel padding to a
  kernel block), since the CUDA grid covers U rows;
- the segment sum (ops/scatter.py) waits for the device, because the
  number of unique ids sizes its output, and it adds in a fixed order
  (a tree over each id's rows) where the JAX package's scatter-add
  adds in the ids' order;
- the Adam step size `lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)` is one
  float32 tensor computed once per call (`adam_lr_t`), which the plain
  version and the kernel both read, so the two cannot differ by a `pow`;
- the int8 salt is passed in (a uint32 Python int) rather than drawn
  from a key inside the call.
"""

from __future__ import annotations

from typing import Tuple

import torch

from code2vec_tpu_torch.ops.quant import QuantTable, is_quantized
from code2vec_tpu_torch.ops.scatter import segment_sum_rows
from code2vec_tpu_torch.ops.sparse_update import (RowAdamState,
                                                  apply_quant_rows_plain,
                                                  apply_rows_plain)
from code2vec_tpu_torch.ops.sparse_update_kernel import (
    sparse_requant_adam_fused, sparse_row_adam_fused)


def dedup_segment_sum(ids: torch.Tensor, grads: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N] ids + [N, E] cotangents -> (sorted unique ids [U] in the ids'
    dtype, [U, E] float32 per-unique-row sums). Accumulates in float32
    whatever the cotangent dtype, in a fixed order
    (ops/scatter.segment_sum_rows: the same bits on every call)."""
    return segment_sum_rows(ids, grads)


def adam_lr_t(count: torch.Tensor, lr: float, b1: float, b2: float
              ) -> torch.Tensor:
    """The bias-corrected step size for the (already incremented) global
    step `count`, a 0-d float32 tensor on count's device."""
    c = count.to(torch.float32)
    return lr * torch.sqrt(1.0 - b2 ** c) / (1.0 - b1 ** c)


# ---- dispatch ----

def apply_rows(table, state: RowAdamState, uids: torch.Tensor,
               seg: torch.Tensor, *, lr_t: torch.Tensor, b1: float,
               b2: float, eps: float, salt=None,
               use_kernel: bool = True) -> None:
    """Live-row Adam over deduped `uids` and their summed `seg`, in place,
    for a float table or an int8 {q, s} table (which needs `salt`)."""
    if is_quantized(table):
        if salt is None:
            raise ValueError("an int8 table's update needs the dither salt")
        if use_kernel:
            sparse_requant_adam_fused(table, state, uids, seg, salt, lr_t,
                                      b1=b1, b2=b2, eps=eps)
        else:
            apply_quant_rows_plain(table, state, uids, seg, salt, lr_t,
                                   b1, b2, eps)
    elif use_kernel:
        sparse_row_adam_fused(table, state, uids, seg, lr_t, b1=b1, b2=b2,
                              eps=eps)
    else:
        apply_rows_plain(table, state, uids, seg, lr_t, b1, b2, eps)


def sparse_row_adam(table: torch.Tensor, state: RowAdamState,
                    ids: torch.Tensor, grads: torch.Tensor, *,
                    count: torch.Tensor, lr: float, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8,
                    use_kernel: bool = True) -> int:
    """Dedup + segment-sum + live-row Adam for a float32/bf16 table, in
    place. `ids` [N] (any shape, flattened) with per-occurrence
    cotangents `grads` [N, E]; `count` is the already incremented step.
    Returns the number of unique rows U."""
    uids, seg = dedup_segment_sum(ids, grads)
    apply_rows(table, state, uids, seg, lr_t=adam_lr_t(count, lr, b1, b2),
               b1=b1, b2=b2, eps=eps, use_kernel=use_kernel)
    return int(uids.shape[0])


def sparse_requant_adam(qt: QuantTable, state: RowAdamState,
                        ids: torch.Tensor, grads: torch.Tensor, salt: int,
                        *, count: torch.Tensor, lr: float, b1: float = 0.9,
                        b2: float = 0.999, eps: float = 1e-8,
                        use_kernel: bool = True) -> int:
    """Dedup + segment-sum + live-row requantize-aware Adam for an int8
    {q, s} table, in place, under the uint32 dither `salt`. Returns the
    number of unique rows U."""
    uids, seg = dedup_segment_sum(ids, grads)
    apply_rows(qt, state, uids, seg, lr_t=adam_lr_t(count, lr, b1, b2),
               b1=b1, b2=b2, eps=eps, salt=salt, use_kernel=use_kernel)
    return int(uids.shape[0])

"""Deterministic row scatter-add: the backward of the embedding gathers
and the sparse-row step's segment sum.

`torch.index_add_`, and the backward of `torch.index_select` (which is
an `index_add_`), add the rows of a CUDA tensor with atomics: the order
of the adds, and with it the rounding, changes from run to run, so two
training runs from one state and one data order drift apart. (So does
PyTorch's embedding backward, which takes an atomic path for some
shapes unless `torch.use_deterministic_algorithms` is on.) Here every
site adds in a fixed order instead:

- on a CPU tensor, the ids' order: `index_add_`, whose CPU loop adds
  row after row (the JAX package's scatter-add order, which the CPU
  tests hold bit for bit);
- on a CUDA tensor, `pairwise_segment_sum`: the ids sorted stably, and
  each id's rows summed by a balanced binary tree aligned to its first
  row, every add of two partial sums rounded to the accumulation dtype
  of the site: float32 for `segment_sum_rows` (the sparse-row step's
  segment sum) and `scatter_rows` (the gathers of float32 and bf16
  tables; a bf16 gradient is the float32 sum rounded once, where the
  atomics rounded every add), bf16 for `scatter_rows_bf16` (the int8
  tables' straight-through gather, ops/quant.py, which keeps the bf16
  adds its test against the JAX package asks for). No op on the way
  adds with atomics.

Either way the same inputs give the same bits on every call.
`take_rows_det(table, ids)` is `torch.index_select(table, 0, ids)`
whose backward is `scatter_rows` in the table's dtype: the embedding
gathers of the encoder and of the sampled softmax go through it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pairwise_segment_sum(ids: torch.Tensor, rows: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N] ids (any shape, flattened) + rows [N, E] -> (the unique ids
    [U] in ascending order, [U, E] per-id sums in `dtype`), each id's
    rows (in the ids' stable-sorted order) summed by a balanced binary
    tree aligned to its first row, every add of two partial sums rounded
    to `dtype`. Each run is laid out at an offset that is a multiple of
    its length rounded up to a power of two (runs placed longest first),
    zeros after it; halving the whole buffer level by level (a pair's
    sum in float32, rounded once) then builds every run's tree at once,
    and a run of padded length 2^k has its sum at level k (an added zero
    changes no value). It waits for the device twice (the number of
    runs; the buffer's length and depth)."""
    ids = ids.reshape(-1)
    rows = rows.reshape(ids.shape[0], rows.shape[-1])
    dev, E = rows.device, rows.shape[1]
    sorted_ids, perm = torch.sort(ids, stable=True)
    uids, counts = torch.unique_consecutive(sorted_ids, return_counts=True)
    mant, exp = torch.frexp(counts.to(torch.float64))
    level = torch.where(mant == 0.5, exp - 1, exp).to(torch.int64)
    size = torch.ones_like(counts) << level           # counts rounded up
    order = torch.sort(-size, stable=True).indices    # longest first
    offset = torch.empty_like(size)
    offset[order] = torch.cumsum(size[order], 0) - size[order]
    total, depth = (int(x) for x in
                    torch.stack([size.sum(), level.max()]).tolist())
    # a multiple of the longest padded run: every level halves evenly
    length = -(-total // (1 << depth)) << depth
    run_start = torch.cumsum(counts, 0) - counts
    run_of_row = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts,
        output_size=ids.shape[0])
    at = offset[run_of_row] + torch.arange(ids.shape[0], device=dev) \
        - run_start[run_of_row]
    # level k holds length >> k rows from bases[k] on
    flat = torch.empty((2 * length, E), dtype=dtype, device=dev)
    flat[:length].zero_()
    flat[at] = torch.index_select(rows, 0, perm).to(dtype)
    bases, base, width = [0], 0, length
    for _ in range(depth):
        torch.sum(flat[base:base + width].view(width // 2, 2, E), dim=1,
                  out=flat[base + width:base + width + width // 2])
        base, width = base + width, width // 2
        bases.append(base)
    start = torch.tensor(bases, dtype=torch.int64, device=dev)
    return uids, flat[start[level] + (offset >> level)]


def pairwise_scatter(ids: torch.Tensor, rows: torch.Tensor, num_rows: int,
                     dtype: torch.dtype, acc_dtype: torch.dtype
                     ) -> torch.Tensor:
    """`pairwise_segment_sum` in `acc_dtype`, rounded to `dtype` and
    written to the ids' rows of a dense zero [num_rows, E] tensor (the
    card's order of `scatter_rows` and `scatter_rows_bf16`; plain torch
    ops, so the tests run it on CPU tensors too)."""
    uids, sums = pairwise_segment_sum(ids, rows, acc_dtype)
    out = torch.zeros((num_rows, sums.shape[1]), dtype=dtype,
                      device=sums.device)
    out[uids] = sums.to(dtype)
    return out


def segment_sum_rows(ids: torch.Tensor, rows: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N] ids (any shape, flattened) + rows [N, E] (any float dtype;
    any leading shape that flattens to N) -> (the unique ids [U] in
    ascending order and the ids' dtype, [U, E] float32 per-id sums). A
    fixed order of adds, no atomics: the ids' order on a CPU tensor,
    `pairwise_segment_sum`'s in float32 on a CUDA tensor; the same
    inputs give the same bits on every call."""
    if rows.device.type != "cpu":
        return pairwise_segment_sum(ids, rows, torch.float32)
    ids = ids.reshape(-1)
    rows = rows.reshape(ids.shape[0], rows.shape[-1])
    uids, inv = torch.unique(ids, sorted=True, return_inverse=True)
    sums = torch.zeros((uids.shape[0], rows.shape[1]), dtype=torch.float32)
    return uids, sums.index_add_(0, inv, rows.to(torch.float32))


def scatter_rows(ids: torch.Tensor, rows: torch.Tensor, num_rows: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """`torch.zeros((num_rows, E), dtype).index_add_(0, ids, rows)` (ids
    any shape, flattened) in a fixed order: as written on a CPU tensor,
    `pairwise_scatter` with float32 adds on a CUDA tensor."""
    if rows.device.type != "cpu":
        return pairwise_scatter(ids, rows, num_rows, dtype, torch.float32)
    ids = ids.reshape(-1)
    rows = rows.reshape(ids.shape[0], rows.shape[-1]).to(dtype)
    return torch.zeros((num_rows, rows.shape[1]), dtype=dtype).index_add_(
        0, ids, rows)


def scatter_rows_bf16(ids: torch.Tensor, rows: torch.Tensor,
                      num_rows: int) -> torch.Tensor:
    """`scatter_rows` into a bf16 gradient whose every add is rounded to
    bf16: `index_add_` on a CPU tensor, `pairwise_scatter` with bf16
    adds on a CUDA tensor."""
    if rows.device.type != "cpu":
        return pairwise_scatter(ids, rows, num_rows, torch.bfloat16,
                                torch.bfloat16)
    ids = ids.reshape(-1)
    rows = rows.reshape(ids.shape[0], rows.shape[-1]).to(torch.bfloat16)
    return torch.zeros((num_rows, rows.shape[1]),
                       dtype=torch.bfloat16).index_add_(0, ids, rows)


class _TakeRows(torch.autograd.Function):
    """index_select along dim 0 whose backward is `scatter_rows` in the
    table's dtype."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_meta = (table.shape[0], table.dtype)
        return torch.index_select(table, 0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        num_rows, dtype = ctx.table_meta
        return scatter_rows(ids, g, num_rows, dtype), None


def take_rows_det(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows `ids` (any shape) of a [V, E] float32 or bf16 table ->
    [*ids.shape, E]; the table's gradient, where one is needed, is the
    deterministic `scatter_rows` of the rows' cotangents."""
    flat = ids.reshape(-1)
    rows = _TakeRows.apply(table, flat)
    return rows.reshape(*ids.shape, rows.shape[-1])

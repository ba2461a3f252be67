"""Live-row Adam: the plain PyTorch versions of the live-row kernels.

Counterparts of the row math and the reference applies of
`training/sparse_update.py` in the JAX package (`row_adam_math`,
`requant_row_math`, `_apply_rows_reference`,
`_apply_quant_rows_reference`). Each apply gathers the U deduplicated
rows of a table and its float32 moments, runs the row math and scatters
the rows back, in place:

- float32 / bfloat16 tables: `row_adam_math` (`apply_rows_plain`, the
  plain version of kernel 5);
- int8 {q, s} tables: dequantize, the same Adam, then the row tail of
  ops/quant.py (`requant_rows`: per-row absmax rescale, counter-hash
  dither over the absolute element index `row * E + col`, round half to
  even, clip to +-127) shared with the dense requantize
  (`requant_row_math`, `apply_quant_rows_plain`: the plain version of
  kernel 6).

The kernels and their wrappers are in sparse_update_kernel.py; the
dedup, segment-sum and dispatch of the training step are in
training/sparse_update.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from code2vec_tpu_torch.ops.quant import QuantTable, requant_rows


class RowAdamState(NamedTuple):
    m: torch.Tensor  # [V, E] first moment (same rows as the table)
    v: torch.Tensor  # [V, E] second moment


def row_adam_math(p, m, v, g, lr_t, b1: float, b2: float, eps: float):
    """One Adam step for a block of float32 rows; each operation rounds
    on its own (the kernel's order)."""
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * (g * g)
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
    return p_new, m_new, v_new


def requant_row_math(q, s, m, v, g, row_ids, salt, lr_t, b1: float,
                     b2: float, eps: float):
    """Row-Adam + requantize for a block of int8 rows: dequantize, Adam
    in float32, per-row absmax rescale, counter-hash dither over the
    absolute element index `row_ids * E + col`, round half to even,
    clip to +-127."""
    f = q.to(torch.float32) * s
    p_new, m_new, v_new = row_adam_math(f, m, v, g, lr_t, b1, b2, eps)
    q_new, s_new = requant_rows(p_new, row_ids, salt)
    return q_new, s_new, m_new, v_new


def apply_rows_plain(table: torch.Tensor, state: RowAdamState,
                     uids: torch.Tensor, seg: torch.Tensor,
                     lr_t: torch.Tensor, b1: float, b2: float,
                     eps: float) -> None:
    """Kernel 5's plain version: gather, row math, scatter, in place. An
    id outside [0, V) is dropped, as the kernel drops it (a model-axis
    window's sentinel)."""
    idx = uids.to(torch.int64)
    live = (idx >= 0) & (idx < table.shape[0])
    if not bool(live.all()):
        idx, seg = idx[live], seg[live]
    p = table.index_select(0, idx).to(torch.float32)
    m = state.m.index_select(0, idx)
    v = state.v.index_select(0, idx)
    p_new, m_new, v_new = row_adam_math(p, m, v, seg, lr_t, b1, b2, eps)
    table.index_copy_(0, idx, p_new.to(table.dtype))
    state.m.index_copy_(0, idx, m_new)
    state.v.index_copy_(0, idx, v_new)


def apply_quant_rows_plain(qt: QuantTable, state: RowAdamState,
                           uids: torch.Tensor, seg: torch.Tensor,
                           salt: int, lr_t: torch.Tensor, b1: float,
                           b2: float, eps: float) -> None:
    """Kernel 6's plain version: gather, row math, scatter, in place."""
    idx = uids.to(torch.int64)
    q = qt["q"].index_select(0, idx)
    s = qt["s"].index_select(0, idx)
    m = state.m.index_select(0, idx)
    v = state.v.index_select(0, idx)
    q_new, s_new, m_new, v_new = requant_row_math(
        q, s, m, v, seg, idx, salt, lr_t, b1, b2, eps)
    qt["q"].index_copy_(0, idx, q_new)
    qt["s"].index_copy_(0, idx, s_new)
    state.m.index_copy_(0, idx, m_new)
    state.v.index_copy_(0, idx, v_new)

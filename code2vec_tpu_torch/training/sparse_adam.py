"""Sparse-row (lazy) Adam state and the dense-carrier oracle update.

Counterpart of `training/sparse_adam.py` in the JAX package. The
moments of a vocab table are float32 whatever the table's storage dtype
(an int8 {q, s} table gets moments shaped like q), and only the rows a
step touches are read or written (LazyAdam: untouched rows keep stale
moments, as in the JAX package).

`row_adam_update` is the original dense-carrier form: scatter-add the
per-occurrence cotangents into a dense [V, E] buffer, gather the sums
back at the ids, update, scatter-set. It is the oracle that the compact
path (training/sparse_update.py) is tested against, and is not on the
training path.
"""

from __future__ import annotations

import torch

from code2vec_tpu_torch.ops.sparse_update import RowAdamState


def init_row_adam(table) -> RowAdamState:
    """Zero float32 moments for a table (a tensor or an int8 {q, s}
    dict), on the table's device."""
    t = table["q"] if isinstance(table, dict) else table
    return RowAdamState(m=torch.zeros(t.shape, dtype=torch.float32,
                                      device=t.device),
                        v=torch.zeros(t.shape, dtype=torch.float32,
                                      device=t.device))


def row_adam_update(table: torch.Tensor, state: RowAdamState,
                    ids: torch.Tensor, grads: torch.Tensor, *,
                    count: torch.Tensor, lr: float, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8):
    """One lazy-Adam step on the rows named by `ids` through a dense
    [V, E] gradient-sum buffer. Returns (new_table, new_state); the
    inputs are not modified. `count` is the (already incremented)
    global step."""
    ids = ids.reshape(-1).to(torch.int64)
    g_rows = grads.reshape(ids.shape[0], -1).to(table.dtype)
    g_sum_dense = torch.zeros_like(table).index_add_(0, ids, g_rows)
    g = g_sum_dense[ids]

    m_rows = state.m[ids]
    v_rows = state.v[ids]
    p_rows = table[ids]

    m_new = b1 * m_rows + (1.0 - b1) * g
    v_new = b2 * v_rows + (1.0 - b2) * (g * g)
    c = count.to(torch.float32)
    lr_t = lr * torch.sqrt(1.0 - b2 ** c) / (1.0 - b1 ** c)
    p_new = p_rows - lr_t * m_new / (torch.sqrt(v_new) + eps)

    # duplicates of a row write identical values, so the sets are
    # idempotent
    table = table.clone()
    table[ids] = p_new.to(table.dtype)
    m = state.m.clone()
    m[ids] = m_new
    v = state.v.clone()
    v[ids] = v_new
    return table, RowAdamState(m=m, v=v)

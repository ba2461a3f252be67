"""Sparse table update: dedup + segment-sum + live-row Adam.

Counterpart of `training/sparse_update.py` in
the JAX package. A step's per-occurrence row cotangents are deduplicated
and summed into a compact [U, E] float32 gradient (`dedup_segment_sum`),
and Adam updates only those U rows of the table and its moments, in
place: row-Adam for float32 / bfloat16 tables (kernel 5), row-Adam with
a per-row requantize for int8 {q, s} tables (kernel 6). The row math and
the plain versions of both kernels are in ops/sparse_update.py.

`sparse_row_adam` / `sparse_requant_adam` are the entry points, and
`mesh_sparse_apply` under a data-parallel mesh (the JAX package's
function of that name: an all-gather of the ranks' occurrences, then
the one-process dedup and apply on every rank). With
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

The analytic traffic model at the end (`sparse_update_traffic_bytes`,
`sparse_step_floor_bytes`, `phase_traffic_bytes`, ...) is the JAX
package's, integer for integer: it feeds the train loop's floor gauges
(`train/step_floor_ms`, read by the health engine's OptEfficiency) and
the phase profiler's per-phase bytes (PhaseRoofline). It is a floor on
the work, not a description of this implementation: it keeps the JAX
package's segment buffer of `_num_slots` rows (the ids rounded up to a
512-row kernel block) although the port's segment sum is
ops/scatter.py's pairwise tree over exactly U rows, so one yardstick
reads the same work whichever package runs it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from code2vec_tpu_torch import tree

from code2vec_tpu_torch.ops.quant import QuantTable, is_quantized
from code2vec_tpu_torch.ops.scatter import segment_sum_rows
from code2vec_tpu_torch.ops.sparse_update import (RowAdamState,
                                                  apply_quant_rows_plain,
                                                  apply_rows_plain)
from code2vec_tpu_torch.ops.sparse_update_kernel import (
    sparse_requant_adam_fused, sparse_row_adam_fused)

# the JAX kernel's unique-row slots per program; the traffic model's
# segment buffer is sized in whole blocks of it
_BLOCK_ROWS = 512


def _num_slots(n_ids: int, block_rows: int) -> int:
    """n_ids rounded up to a whole number of `block_rows` blocks: the
    JAX package's static unique-id capacity."""
    return -(-n_ids // block_rows) * block_rows


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


def gather_parts(parts, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global occurrence list of a table's `parts`, a sequence of
    `(ids, grads, sharded)`: ids [N] (any shape, flattened to int32) and
    their [N, E] cotangents. Each sharded part (a per-example gather of
    this rank's rows) is all-gathered in rank order over the mesh; a
    replicated part (the step's shared sample, whose cotangent the
    caller has already summed over the ranks) passes as it is. The
    parts are concatenated in order: the one-process step's order over
    the ranks' batches concatenated."""
    ids_l, grads_l = [], []
    for ids, grads, sharded in parts:
        ids = ids.reshape(-1).to(torch.int32)
        grads = grads.reshape(ids.shape[0], -1)
        if sharded and mesh is not None:
            from code2vec_tpu_torch.parallel.distributed import \
                all_gather_rows
            ids, grads = all_gather_rows(ids), all_gather_rows(grads)
        ids_l.append(ids)
        grads_l.append(grads)
    return torch.cat(ids_l), torch.cat(grads_l)


def mesh_sparse_apply(mesh, table, state: RowAdamState, parts, *,
                      lr_t: torch.Tensor, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8, salt=None,
                      use_kernel: bool = True) -> int:
    """The sparse update under a data-parallel mesh, in place: the
    parts' global occurrence list (`gather_parts`), then the same
    `dedup_segment_sum` one process runs and kernel 5 (float) or 6
    (int8) on the whole table, on every rank. The same input order means
    the same float32 additions in the same order, so the result is
    bit-identical to the one-process compact apply of the same global
    parts, and every rank ends with the same table. Returns U."""
    ids, grads = gather_parts(parts, mesh)
    uids, seg = dedup_segment_sum(ids, grads)
    apply_rows(table, state, uids, seg, lr_t=lr_t, b1=b1, b2=b2, eps=eps,
               salt=salt, use_kernel=use_kernel)
    return int(uids.shape[0])


def rows_from_dense(table: torch.Tensor, state: RowAdamState,
                    dense_grad: torch.Tensor, ids: torch.Tensor, *,
                    count: torch.Tensor, lr: float, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8,
                    use_kernel: bool = True) -> int:
    """Live-row Adam fed by a DENSE [V, E] gradient, in place on a
    float32/bf16 table (the VarMisuse head: its loss gathers inside the
    differentiated function, so backward already gives the dense
    scatter-added gradient). The dense rows at the sorted unique `ids`
    ARE the per-row sums, so they are gathered as float32 and applied
    with no second segment sum (summing per occurrence again would
    multiply each row by its count). Returns the number of unique rows
    U."""
    uids = torch.unique(ids.reshape(-1).to(torch.int32))
    seg = torch.index_select(dense_grad, 0, uids).to(torch.float32)
    apply_rows(table, state, uids, seg, lr_t=adam_lr_t(count, lr, b1, b2),
               b1=b1, b2=b2, eps=eps, use_kernel=use_kernel)
    return int(uids.shape[0])


# ---- the analytic traffic model (the train loop's floor gauges and the
# phase profiler's per-phase bytes) ----

def sparse_update_traffic_bytes(table, n_ids: int, unique_rows: int,
                                *, grad_itemsize: int = 4,
                                block_rows: int = _BLOCK_ROWS) -> int:
    """Analytic HBM bytes of ONE sparse apply at U live rows: ids read
    once, per-occurrence cotangents read once, the compact segment
    buffer (`_num_slots` rows) written and read once, and per LIVE row:
    table rows read + written (int8: q AND s) plus both float32 moment
    rows read + written."""
    n_slots = _num_slots(n_ids, block_rows)
    emb = (table["q"] if is_quantized(table) else table).shape[-1]
    total = n_ids * 4                       # ids read
    total += n_ids * emb * grad_itemsize    # cotangent rows read
    total += n_slots * emb * 4 * 2          # segment buffer w + r
    if is_quantized(table):
        total += unique_rows * emb * 1 * 2  # q rows r + w
        total += unique_rows * 4 * 2        # s rows r + w
    else:
        total += unique_rows * emb * table.element_size() * 2  # rows r + w
    total += unique_rows * emb * 4 * 2 * 2          # m and v rows r + w
    return int(total)


def table_id_counts(batch_size: int, max_contexts: int,
                    num_sampled: int = 0) -> dict:
    """Per-table gathered-id counts of one sparse train step: token rows
    for src AND dst, target rows (sampled softmax) for the labels plus
    the shared sample."""
    counts = {"token_emb": 2 * batch_size * max_contexts,
              "path_emb": batch_size * max_contexts}
    if num_sampled:
        counts["target_emb"] = batch_size + num_sampled
    return counts


def _table_rows(table) -> Tuple[int, int, int, int]:
    """(rows, emb, bytes a gathered row reads, cotangent itemsize): an
    int8 table reads a q row and its float32 scale and takes a bf16
    cotangent; a float table its row at its own dtype."""
    if is_quantized(table):
        rows, emb = table["q"].shape
        return rows, emb, emb * 1 + 4, 2
    rows, emb = table.shape
    return rows, emb, emb * table.element_size(), table.element_size()


def sparse_update_phase_bytes(params, batch_size: int,
                              max_contexts: int, *,
                              num_sampled: int = 0,
                              block_rows: int = _BLOCK_ROWS,
                              processes: int = 1) -> int:
    """Analytic per-device HBM bytes of the dedup / segment-sum / apply
    phase alone for one step over the three tables, at the uniform-ids
    E[U] of each table (the loop's `train/sparse_update_bytes` gauge).
    `processes` scales the per-process `batch_size` to the global
    occurrence count, as the JAX package's mesh model does."""
    total = 0
    for key, n in table_id_counts(batch_size, max_contexts,
                                  num_sampled).items():
        table = params.get(key)
        if table is None:
            continue
        n_global = n * processes
        num_rows, _emb, _row, grad_itemsize = _table_rows(table)
        total += sparse_update_traffic_bytes(
            table, n_global, expected_unique_rows(n_global, num_rows),
            grad_itemsize=grad_itemsize, block_rows=block_rows)
    return int(total)


def sparse_step_floor_bytes(params, batch_size: int, max_contexts: int,
                            *, num_sampled: int = 0,
                            block_rows: int = _BLOCK_ROWS,
                            data_shards: int = 1,
                            processes: int = 1) -> int:
    """Analytic per-device per-step HBM bytes of the FULL sparse-row
    step: forward row gathers (per occurrence), backward cotangent
    writes, and the dedup / segment-sum / live-row apply traffic at the
    uniform-ids E[U] (real corpora are Zipfian, so this over-counts and
    the derived floor stays conservative). Dense params add their
    grad / param / moment sweeps. The loop's `train/step_floor_ms`
    gauge is these bytes over `Config.HBM_CEILING_GBPS`.
    `processes` / `data_shards` describe a topology as in the JAX
    package (forward and backward over the device's batch shard, the
    apply over the global list); the defaults (1, 1) are one device."""
    counts = table_id_counts(batch_size, max_contexts, num_sampled)
    total = 0
    for key, n in counts.items():
        table = params.get(key)
        if table is None:
            continue
        n_global = n * processes
        n_local = n_global / data_shards
        num_rows, emb, row_bytes, grad_itemsize = _table_rows(table)
        u = expected_unique_rows(n_global, num_rows)
        total += int(n_local * row_bytes)  # forward row gathers
        total += int(n_local * emb * grad_itemsize)  # bwd cotangents
        total += sparse_update_traffic_bytes(
            table, n_global, u, grad_itemsize=grad_itemsize,
            block_rows=block_rows)
    for key, p in params.items():
        if key in counts or is_quantized(p):
            continue  # row-gathered tables: counted above
        for leaf in tree.flatten({key: p}).values():
            b = leaf.numel() * leaf.element_size()
            total += b * 4 + b * 4  # grad w+r, param r+w, m/v r+w
    return int(total)


def phase_traffic_bytes(params, batch_size: int, max_contexts: int, *,
                        num_sampled: int = 0, sparse: bool = False,
                        compute_itemsize: int = 2,
                        block_rows: int = _BLOCK_ROWS,
                        data_shards: int = 1,
                        processes: int = 1) -> dict:
    """Analytic per-device HBM bytes of each step phase, keyed by the
    phase names obs/phases.py publishes (the per-phase form of
    `sparse_step_floor_bytes`): streaming lower bounds, so derived
    utilizations are conservative.

      embed_gather — forward row gathers per occurrence (row read +
        gathered-activation write at the compute dtype), the sampled
        softmax's target gathers included on both paths.
      concat_dense — concat write + read of the [B, C, 3E] contexts,
        the TRANSFORM weights, the transformed-tensor write.
      forward_pool — transformed read, the weighted reduction, the code
        write, the sampled logits.
      backward — activation re-read + context-cotangent write, plus the
        per-occurrence table cotangents (`sparse`) or those and the
        dense [V, E] carrier's write + read (dense).
      table_apply — `sparse`: `sparse_update_phase_bytes`; dense: grad
        read + param read/write + two float32 moment sweeps per leaf.
    """
    counts = table_id_counts(batch_size, max_contexts, num_sampled)
    gather = 0
    cot = 0
    carrier = 0
    emb_any = 0
    for key, n in counts.items():
        table = params.get(key)
        if table is None:
            continue
        n_local = n * processes / data_shards
        _rows, emb, row_bytes, grad_itemsize = _table_rows(table)
        table_elems = (table["q"] if is_quantized(table) else table).numel()
        emb_any = emb
        gather += int(n_local * (row_bytes + emb * compute_itemsize))
        cot += int(n_local * emb * grad_itemsize)
        carrier += table_elems * grad_itemsize * 2  # dense w + r
    transform = params.get("transform")
    D = int(transform.shape[0]) if transform is not None else 3 * emb_any
    B_local = batch_size * processes / max(1, data_shards)
    ctx_bytes = int(B_local * max_contexts * D * compute_itemsize)
    out = {"embed_gather": gather}
    out["concat_dense"] = int(
        ctx_bytes * 3 + (D * D * 4 if transform is not None else 0))
    out["forward_pool"] = int(
        ctx_bytes + B_local * D * compute_itemsize
        + B_local * (1 + num_sampled) * 4)
    out["backward"] = int(ctx_bytes * 2
                          + (cot if sparse else cot + carrier))
    if sparse:
        out["table_apply"] = sparse_update_phase_bytes(
            params, batch_size, max_contexts, num_sampled=num_sampled,
            block_rows=block_rows, processes=processes)
    else:
        apply = 0
        for key, p in params.items():
            if is_quantized(p):
                n = p["q"].numel()
                apply += n * 2          # carrier grad read
                apply += n * 2          # q r + w
                apply += p["s"].numel() * 4 * 2  # s r + w
                apply += n * 4 * 2 * 2  # Adam-shaped moments
                continue
            for leaf in tree.flatten({key: p}).values():
                b = leaf.numel() * leaf.element_size()
                apply += b * 3                      # grad r, param r + w
                apply += leaf.numel() * 4 * 2 * 2   # two f32 moments r+w
        out["table_apply"] = int(apply)
    return {k: int(v) for k, v in out.items()}


def expected_unique_rows(n_ids: int, num_rows: int) -> int:
    """E[U] for n uniform draws over V rows: V * (1 - (1 - 1/V)^n).
    Real corpora are Zipfian (fewer uniques), so a floor derived from it
    over-counts live-row traffic and stays conservative."""
    if num_rows <= 0 or n_ids <= 0:
        return 0
    return int(num_rows * (1.0 - math.exp(
        n_ids * math.log1p(-1.0 / num_rows))))

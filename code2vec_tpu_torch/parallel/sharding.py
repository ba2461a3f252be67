"""What "the batch over ('dcn', 'data')" means for one rank: the
counterpart of `parallel/sharding.py` in the JAX package.

- `param_pspecs`: each leaf's layout. The three vocab tables are
  row-sharded over 'model' (`P(MODEL_AXIS, None)` in the JAX package):
  model index i of m holds rows `row_window(mesh, V)` = [i * V/m,
  (i + 1) * V/m) of each; every other leaf replicates (TRANSFORM,
  ATTENTION, the VarMisuse pointer and the transformer's "xf" subtree,
  tiny beside the tables). At model 1 each rank holds whole tables.
- `shard_params` / `shard_state`: a whole params or optimizer-state tree
  (every rank draws the whole init from the seed, as the JAX
  `init_params` does before `device_put` shards it; a checkpoint holds
  whole tables) cut to this rank's windows: each table and each slot
  that leads with a table's vocab dim (Adafactor's per-row statistic
  and its unfactored second moment, Adam's and row-Adam's moments);
  `unshard_params` / `unshard_state` all-gather them back to whole
  leaves in model order (the whole-table checkpoint).
- `take_window`: the rows of a row-sharded table at global ids, each
  rank's window gathered and the rest zeroed, then summed over the
  model group (`collectives.reduce_from_model`): one rank contributes
  the nonzero of each element, so the result is the rows' bits.
- `batch_rows`: this rank's row window in the global batch, the
  counterpart of `shard_batch(process_local=True)`: each batch shard
  feeds a disjoint local batch of B rows, and the global batch of the
  step is the shards' batches concatenated in shard order (shard s's
  rows are [s * B, (s + 1) * B)). The ranks of one ctx group share a
  shard, so they read the same rows.
- `fetch_batch_shards`: a per-shard output gathered back to the global
  batch on every rank (the predict step's, `fetch_global(...)[:n]` of
  the JAX model's `predict_device`).
- `context_cols` / `local_contexts`: this rank's window of the context
  dim, the counterpart of `context_batch_pspec` (contexts
  [c * C/s, (c + 1) * C/s) for ctx index c of s).
- `replica_digests` / `check_replicas`: a per-leaf digest of the params,
  all-reduced as a max and a min; equal on every rank iff every rank
  holds the same bits (with the odds of a 64-bit digest collision); a
  table shard over its shard-replica group, the other leaves over the
  world.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from code2vec_tpu_torch import tree
from code2vec_tpu_torch.ops.quant import is_quantized
from code2vec_tpu_torch.ops.scatter import take_rows_det
from code2vec_tpu_torch.parallel.collectives import (model_gather,
                                                     reduce_from_model,
                                                     replica_group)
from code2vec_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, row_sharded

REPLICATED = None  # a leaf's spec: every rank holds the whole leaf
ROW_SHARDED = MODEL_AXIS  # rows over 'model', the rest of the leaf whole
TABLE_KEYS = ("token_emb", "path_emb", "target_emb")


def param_pspecs() -> Dict[str, object]:
    """Each top-level param's layout over the mesh: the vocab tables
    row-sharded over 'model', the rest replicated."""
    specs = {k: REPLICATED for k in (
        "transform", "attention", "vm_pointer", "xf")}
    specs.update({k: ROW_SHARDED for k in TABLE_KEYS})
    return specs


def row_window(mesh: Mesh, rows: int) -> Tuple[int, int]:
    """[start, stop) of this rank's rows of a table of `rows` (padded)
    rows; the whole table at model 1."""
    m = mesh.model
    if rows % m:
        raise ValueError(f"table rows {rows} not divisible by model axis "
                         f"{m} (ModelDims.vocab_pad_multiple)")
    width = rows // m
    start = mesh.model_index * width
    return start, start + width


def window_rows(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh
                ) -> torch.Tensor:
    """This rank's part of the rows of a row-sharded `table` (its window)
    at global `ids`: the window's rows, zeros elsewhere (differentiable:
    the gradient scatter-adds into the window only)."""
    n = table.shape[0]
    lo = mesh.model_index * n
    local = ids.to(torch.int64) - lo
    live = (local >= 0) & (local < n)
    rows = take_rows_det(table, torch.where(live, local,
                                            torch.zeros_like(local)))
    return torch.where(live.unsqueeze(-1), rows, torch.zeros_like(rows))


def take_window(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh
                ) -> torch.Tensor:
    """The rows of `table` at global `ids`: a plain gather without a
    row-sharded mesh, else the model group's `window_rows` summed
    (`collectives.reduce_from_model`)."""
    if not row_sharded(mesh):
        return take_rows_det(table, ids)
    return reduce_from_model(window_rows(table, ids, mesh), mesh)


def map_row_slots(state, fn: Callable,
                  shapes: Dict[str, Tuple[int, int]],
                  key: Optional[str] = None):
    """`state` with `fn(t, key)` in place of every tensor that leads with
    the vocab dim of a table in `shapes` ({key: its whole (rows, width)}):
    the table itself in a params tree; in an optimizer state the slots
    keyed by the table (Adam's mu and nu, row-Adam's m and v) except
    Adafactor's, which lead with the vocab dim only where its factored
    choice over the whole shape keeps that axis."""
    from code2vec_tpu_torch.training.optimizers import (FactoredState,
                                                        _factored_dims)
    if isinstance(state, torch.Tensor):
        return state if key is None else fn(state, key)
    if isinstance(state, FactoredState):
        fields = {}
        for name in ("v_row", "v_col", "v"):
            out = {}
            for k, t in getattr(state, name).items():
                if k in shapes:
                    if tuple(state.v[k].shape) == (1,):   # factored
                        d1, d0 = _factored_dims(shapes[k], True, 0)
                        rows = {"v_row": d0, "v_col": d1}.get(name) == 1
                    else:
                        rows = name == "v"
                    t = fn(t, k) if rows else t
                out[k] = t
            fields[name] = out
        return FactoredState(state.count, **fields)
    if isinstance(state, dict):
        return {k: map_row_slots(v, fn, shapes, k if k in shapes else key)
                for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(map_row_slots(v, fn, shapes, key)
                             for v in state))
    if isinstance(state, (list, tuple)):
        return type(state)(map_row_slots(v, fn, shapes, None) for v in state)
    return state


def table_shapes(params) -> Dict[str, Tuple[int, int]]:
    """{table: (rows, width)} of a whole params tree's float tables."""
    return {k: tuple(params[k].shape) for k in TABLE_KEYS
            if k in params and isinstance(params[k], torch.Tensor)}


def shard_state(state, mesh: Optional[Mesh],
                shapes: Dict[str, Tuple[int, int]]):
    """A whole params or optimizer-state tree with every row-sharded
    tensor cut to this rank's window (a copy, so the whole tensor can be
    freed); the tree as it is without a row-sharded mesh."""
    if not row_sharded(mesh):
        return state

    def keep(t, _k):
        lo, hi = row_window(mesh, t.shape[0])
        return t[lo:hi].clone()

    return map_row_slots(state, keep, shapes)


def unshard_state(state, mesh: Optional[Mesh],
                  shapes: Dict[str, Tuple[int, int]]):
    """The inverse of `shard_state`: every row-sharded tensor all-gathered
    over the model group in model order (collective: every rank calls
    it); the tree as it is without a row-sharded mesh."""
    if not row_sharded(mesh):
        return state
    return map_row_slots(state, lambda t, _k: model_gather(t, 0, mesh),
                         shapes)


def shard_params(params, mesh: Optional[Mesh]):
    """Whole params -> this rank's: each table's window, the rest as it
    is."""
    return shard_state(params, mesh, table_shapes(params))


def unshard_params(params, mesh: Optional[Mesh]):
    """This rank's params -> whole params (collective)."""
    if not row_sharded(mesh):
        return params
    shapes = {k: (params[k].shape[0] * mesh.model, params[k].shape[1])
              for k in table_shapes(params)}
    return unshard_state(params, mesh, shapes)


def batch_rows(mesh: Mesh, local_batch: int) -> Tuple[int, int]:
    """[start, stop) of this rank's rows in the global batch (its batch
    shard's)."""
    start = mesh.batch_shard * local_batch
    return start, start + local_batch


def fetch_batch_shards(x: torch.Tensor, mesh: Mesh):
    """The global batch of a per-shard output, as numpy on every rank:
    each rank's `x` (its batch shard's rows) all-gathered over the world
    in rank order, one rank of each shard kept (the ranks of a ctx or
    model group hold the same rows), in shard order."""
    from code2vec_tpu_torch.parallel.distributed import fetch_global
    every = fetch_global(x)
    per_rank = every.reshape((mesh.world, -1) + every.shape[1:])
    return per_rank[::mesh.ctx * mesh.model].reshape(
        (-1,) + every.shape[1:])


def context_cols(mesh: Mesh, max_contexts: int) -> Tuple[int, int]:
    """[start, stop) of this rank's contexts: [c * C/s, (c + 1) * C/s)
    for ctx index c of s (the whole C at ctx = 1)."""
    if max_contexts % mesh.ctx:
        raise ValueError(f"MAX_CONTEXTS {max_contexts} is not divisible by "
                         f"--mesh_context {mesh.ctx}")
    width = max_contexts // mesh.ctx
    start = mesh.ctx_index * width
    return start, start + width


def local_contexts(mesh: Mesh, batch):
    """A batch tuple (labels, src, pth, dst, mask, weights) with its four
    [B, C] members cut to this rank's contexts (the same tuple at ctx =
    1); numpy arrays or tensors, views."""
    if mesh is None or mesh.ctx == 1:
        return batch
    C = batch[1].shape[1]
    lo, hi = context_cols(mesh, C)
    return tuple(a[:, lo:hi] if i in (1, 2, 3, 4) else a
                 for i, a in enumerate(batch))


def _leaf_digest(t: torch.Tensor) -> torch.Tensor:
    """An int64 digest of a tensor's bits: the sum of its 32-bit words
    (or 16/8-bit elements) and their position-weighted sum, wrapping."""
    flat = t.detach().contiguous().reshape(-1)
    if flat.element_size() == 4:
        words = flat.view(torch.int32)
    elif flat.element_size() == 2:
        words = flat.view(torch.int16)
    else:
        words = flat.view(torch.int8)
    w = words.to(torch.int64)
    pos = torch.arange(1, w.numel() + 1, device=w.device,
                       dtype=torch.int64) % 65521 + 1
    return torch.stack([w.sum(), (w * pos).sum()])


def replica_digests(params) -> Dict[str, torch.Tensor]:
    """{leaf path: int64 [2] digest}; an int8 table's q and s each."""
    leaves = tree.flatten(params, is_leaf=is_quantized)
    out = {}
    for k, v in leaves.items():
        if is_quantized(v):
            out[k + "/q"] = _leaf_digest(v["q"])
            out[k + "/s"] = _leaf_digest(v["s"])
        else:
            out[k] = _leaf_digest(v)
    return out


def check_replicas(params, mesh: Mesh) -> None:
    """RuntimeError naming the leaves whose bits differ across the ranks
    that should hold them (a max and a min all-reduce of each leaf's
    digest): a table shard over its shard-replica group, every other
    leaf over the world."""
    import torch.distributed as dist
    from code2vec_tpu_torch.parallel.distributed import rank_device

    digests = replica_digests(params)
    dev = rank_device() if dist.get_backend() == "nccl" \
        else torch.device("cpu")
    sharded = set(table_shapes(params)) if row_sharded(mesh) else set()
    bad = []
    for group, keys in ((None, sorted(k for k in digests
                                      if k not in sharded)),
                        (replica_group(mesh), sorted(sharded))):
        if not keys:
            continue
        local = torch.stack([digests[k] for k in keys]).to(dev)
        hi, lo = local.clone(), local.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        bad += [k for k, h, l in zip(keys, hi.cpu(), lo.cpu())
                if not torch.equal(h, l)]
    if bad:
        raise RuntimeError(f"replicas disagree on rank {mesh.rank}: the "
                           f"params {bad} differ across the ranks")

"""What "the batch over ('dcn', 'data')" means for one rank: the
counterpart of `parallel/sharding.py` in the JAX package.

- `param_pspecs`: which leaves replicate. Under the data, ctx and dcn
  axes (the ones the port has) every leaf does: each rank holds whole
  tables on its device. The JAX package's row-sharded tables over
  'model' are ROADMAP.md Queue 1 item 5b.
- `batch_rows`: this rank's row window in the global batch, the
  counterpart of `shard_batch(process_local=True)`: each batch shard
  feeds a disjoint local batch of B rows, and the global batch of the
  step is the shards' batches concatenated in shard order (shard s's
  rows are [s * B, (s + 1) * B)). The ranks of one ctx group share a
  shard, so they read the same rows.
- `context_cols` / `local_contexts`: this rank's window of the context
  dim, the counterpart of `context_batch_pspec` (contexts
  [c * C/s, (c + 1) * C/s) for ctx index c of s).
- `replica_digests` / `check_replicas`: a per-leaf digest of the params,
  all-reduced as a max and a min; equal on every rank iff every rank
  holds the same bits (with the odds of a 64-bit digest collision).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from code2vec_tpu_torch import tree
from code2vec_tpu_torch.ops.quant import is_quantized
from code2vec_tpu_torch.parallel.mesh import Mesh

REPLICATED = None  # a leaf's spec: every rank holds the whole leaf


def param_pspecs() -> Dict[str, object]:
    """Each top-level param's layout over the mesh: all replicated."""
    return {k: REPLICATED for k in (
        "token_emb", "path_emb", "target_emb", "transform", "attention",
        "vm_pointer", "xf")}


def batch_rows(mesh: Mesh, local_batch: int) -> Tuple[int, int]:
    """[start, stop) of this rank's rows in the global batch (its batch
    shard's)."""
    start = mesh.batch_shard * local_batch
    return start, start + local_batch


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
    (a max and a min all-reduce of each leaf's digest)."""
    import torch.distributed as dist
    from code2vec_tpu_torch.parallel.distributed import rank_device

    digests = replica_digests(params)
    keys = sorted(digests)
    dev = rank_device() if dist.get_backend() == "nccl" \
        else torch.device("cpu")
    local = torch.stack([digests[k] for k in keys]).to(dev)
    hi, lo = local.clone(), local.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    bad = [k for k, h, l in zip(keys, hi.cpu(), lo.cpu())
           if not torch.equal(h, l)]
    if bad:
        raise RuntimeError(f"replicas disagree on rank {mesh.rank}: the "
                           f"params {bad} differ across the ranks")

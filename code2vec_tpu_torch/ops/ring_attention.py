"""Ring attention over the mesh's context axis: the counterpart of
`ops/ring_attention.py` in the JAX package.

With the context dim of [B, H, C, hd] sharded over the 'ctx' axis, each
rank keeps its C/s keys and values and passes them around the ring of
its ctx peers (parallel/collectives.ppermute), accumulating the softmax
in the flash form (a running max m, normaliser l and weighted sum acc,
all float32), so a rank never holds more than two C/s blocks of keys and
values. The bag of contexts needs no causal mask: only the key-side
padding log-mask, which rotates with its shard.

The order is the JAX package's: the local block first, then s - 1 hops
of "rotate, then accumulate" (no dead last rotation), the result `acc /
l` cast to q's dtype. The gradient comes from autograd through
`ppermute`, whose backward rotates the cotangents the other way, as
JAX's comes through `ppermute` and `scan`.

Both products run in float32 from the operands as they are (q k^T, and
the weights cast to v's dtype times v): a bf16 x bf16 product is exact in
float32, so this is the value XLA gives when it folds the jitted
`einsum(...).astype(float32)` into the product, up to the order of the
sums; a sharded block is small, so the float32 product costs little
beside the ring's transfers.
"""

from __future__ import annotations

import torch

from code2vec_tpu_torch.parallel.collectives import ppermute

F32 = torch.float32


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_mask: torch.Tensor, mesh) -> torch.Tensor:
    """Masked multi-head attention of this rank's queries over every key
    of its ctx group. q, k, v: the local [B, H, C/s, hd] shards; log_mask:
    the local [B, C/s] additive key mask. Returns [B, H, C/s, hd] in q's
    dtype."""
    hd = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=F32,
                                          device=q.device))
    qf = q.to(F32)

    def accumulate(m, l, acc, k, v, mask):
        logits = torch.matmul(qf, k.to(F32).transpose(-1, -2)) * scale \
            + mask.to(F32)[:, None, None, :]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p.to(v.dtype).to(F32),
                                                   v.to(F32))
        return m_new, l, acc

    B, H, Cq, _ = q.shape
    m = torch.full((B, H, Cq), float("-inf"), dtype=F32, device=q.device)
    l = torch.zeros((B, H, Cq), dtype=F32, device=q.device)
    acc = torch.zeros((B, H, Cq, hd), dtype=F32, device=q.device)
    m, l, acc = accumulate(m, l, acc, k, v, log_mask)   # the local block
    for _hop in range(mesh.ctx - 1):
        k, v = ppermute(k, mesh), ppermute(v, mesh)
        log_mask = ppermute(log_mask, mesh)
        m, l, acc = accumulate(m, l, acc, k, v, log_mask)
    return (acc / l[..., None]).to(q.dtype)

"""Transformer path-encoder.

Counterpart of `models/transformer_encoder.py` in the JAX package: a set
transformer over the path-contexts of a method, in place of the bag
encoder's single-query attention pool. The contexts are an unordered
bag, so there is no positional encoding: L pre-norm layers of masked
multi-head self-attention and a GELU MLP, a final RMS norm, then a
learned-query attention pool that gives the code vector and the
per-context weights.

Params sit under one "xf" subtree with the JAX package's names:
`{"in_proj" [D, D], "pool_query" [D], "ln_f_scale" [D], "layers":
[{"ln1_scale", "ln2_scale" [D], "qkv" [D, 3D], "out" [D, D], "mlp_up"
[D, rD], "mlp_down" [rD, D]}, ...]}`, float32, cast to the compute
dtype at use.

The attention core is `fused_mha` (kernels 2 and 3 on the card, their
plain versions on the CPU) with `use_kernel`, else `plain_mha` (the
plain versions on any device), as the bag encoder's `use_kernel` picks
kernel 1 or its plain version. `dims.xf_remat` recomputes each layer in the backward pass
(`torch.utils.checkpoint`, the counterpart of `jax.checkpoint`), so
kernel 2 runs twice per layer in a training step.

Under a `mesh` whose ctx axis s is above 1 (parallel/mesh.py) each rank
holds C/s contexts of its rows, and the encoder computes what one device
computes over the whole C, as the JAX package's does on its mesh:
- the attention core: with `dims.ring_attention`, `ring_attention`
  (ops/ring_attention.py: keys and values pass around the ctx group;
  the kernel is not used, as in the JAX package, where the ring wins
  over the Pallas call); without it, q, k, v and the key mask are
  all-gathered over the group, `fused_mha` (kernels 2 and 3 on the card)
  runs on the whole [B, H, C, hd], and the rank keeps its query rows;
- the learned-query pool: the [B, C/s] pool logits are all-gathered, the
  softmax runs over all C, each rank forms its contexts' share of the
  weighted sum in float32, and the shares are summed over the group
  (parallel/collectives.all_sum) and rounded once to the compute dtype;
- a method with no live context is judged on its whole mask (all-
  gathered), so a rank whose shard is all padding behaves as one device.
The returned attention is the rank's [B, C/s] slice. Without a ctx axis
`dims.ring_attention` is ignored, as in the JAX package. Under a model
axis every table read is `gather_contexts` over the rank's windows, and
the "xf" leaves stay replicated (the JAX package's `P()`).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from code2vec_tpu_torch.models.encoder import (ModelDims, Params,
                                               _variance_scaling,
                                               apply_dropout, gather_contexts)
from code2vec_tpu_torch.ops.ring_attention import ring_attention
from code2vec_tpu_torch.ops.xf_attention import fused_mha, plain_mha
from code2vec_tpu_torch.parallel.collectives import (all_gather, all_sum,
                                                     gather_along)

F32 = torch.float32


def init_xf_params(generator: torch.Generator, dims: ModelDims) -> Dict:
    """The "xf" subtree, variance-scaled (fan_avg, uniform) as the JAX
    package's, on `generator`'s device. The numbers differ from the JAX
    package's for the same seed; carry weights with convert.py."""
    D = dims.context_vector_size
    H = dims.xf_heads
    if D % H:
        raise ValueError(f"context_vector_size {D} is not a multiple of "
                         f"xf_heads {H}")
    mlp = dims.xf_mlp_ratio * D
    g = generator

    def ones():
        return torch.ones((D,), dtype=F32, device=g.device)
    xf = {"ln_f_scale": ones(),
          "pool_query": _variance_scaling(g, (D, 1), F32)[:, 0].contiguous(),
          "in_proj": _variance_scaling(g, (D, D), F32)}
    xf["layers"] = [{"ln1_scale": ones(), "ln2_scale": ones(),
                     "qkv": _variance_scaling(g, (D, 3 * D), F32),
                     "out": _variance_scaling(g, (D, D), F32),
                     "mlp_up": _variance_scaling(g, (D, mlp), F32),
                     "mlp_down": _variance_scaling(g, (mlp, D), F32)}
                    for _ in range(dims.xf_layers)]
    return xf


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x / rms(x) in float32, cast to x's dtype, times the scale in it."""
    x32 = x.to(F32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale.to(x.dtype)


def _mha(x: torch.Tensor, qkv: torch.Tensor, out: torch.Tensor,
         log_mask: torch.Tensor, heads: int, use_kernel: bool,
         mesh=None, ring: bool = False,
         full_log_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention of one layer: [B, C, D] -> [B, C, D] in x's dtype,
    the heads split to the JAX layout [B, H, C, hd]. Under a ctx `mesh`
    x holds the rank's contexts, `log_mask` their key mask and
    `full_log_mask` the row's whole one (the module docstring)."""
    B, C, D = x.shape
    hd = D // heads
    proj = x @ qkv.to(x.dtype)                          # [B, C, 3D]

    def split_heads(t):
        return t.reshape(B, C, heads, hd).permute(0, 2, 1, 3)

    q, k, v = (split_heads(t) for t in proj.split(D, dim=-1))
    attend = fused_mha if use_kernel else plain_mha
    if mesh is None:
        ctx = attend(q, k, v, log_mask)
    elif ring:
        ctx = ring_attention(q, k, v, log_mask, mesh)
    else:
        q, k, v = (all_gather(t, 2, mesh) for t in (q, k, v))
        ctx = attend(q, k, v, full_log_mask).narrow(
            2, mesh.ctx_index * C, C)
    ctx = ctx.permute(0, 2, 1, 3).reshape(B, C, D)
    return ctx @ out.to(x.dtype)


def _layer(x: torch.Tensor, layer: Dict[str, torch.Tensor],
           log_mask: torch.Tensor, heads: int, use_kernel: bool,
           mesh=None, ring: bool = False,
           full_log_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One pre-norm layer: attention, then the MLP (GELU with the tanh
    approximation, `jax.nn.gelu`'s default), each added to x."""
    h = _rms_norm(x, layer["ln1_scale"])
    x = x + _mha(h, layer["qkv"], layer["out"], log_mask, heads, use_kernel,
                 mesh, ring, full_log_mask)
    h = _rms_norm(x, layer["ln2_scale"])
    h = F.gelu(h @ layer["mlp_up"].to(x.dtype), approximate="tanh")
    return x + h @ layer["mlp_down"].to(x.dtype)


def encode_transformer(params: Params, source_ids: torch.Tensor,
                       path_ids: torch.Tensor, target_ids: torch.Tensor,
                       mask: torch.Tensor, *, dims: ModelDims,
                       compute_dtype=F32, use_kernel: bool = True,
                       train: bool = False,
                       keep: Optional[torch.Tensor] = None,
                       dropout_keep_rate: float = 1.0, mesh=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The contract of `encoder.encode`: (code vectors [B, D] in the
    compute dtype, pool attention [B, C] float32). `train=True` drops out
    the gathered contexts where `keep` [B, C, D] is False (when
    `dropout_keep_rate` < 1). A method with no live context keeps all its
    keys live, so its softmaxes stay finite. Under a `mesh` with a ctx
    axis above 1 the [B, C] inputs, `keep` and the returned attention are
    the rank's contexts (the module docstring)."""
    xf = params["xf"]
    # the tables' windows under a model axis (the rank's rows summed over
    # the model group, models/encoder.py); "xf" is replicated
    emb = gather_contexts(params, source_ids, path_ids, target_ids,
                          compute_dtype, mesh)              # [B, C, D]
    if mesh is not None and mesh.ctx == 1:
        mesh = None
    if train and dropout_keep_rate < 1.0:
        emb = apply_dropout(emb, keep, dropout_keep_rate)
    full_mask = mask if mesh is None else gather_along(mask, 1, mesh)
    has_live = full_mask.sum(dim=-1, keepdim=True) > 0
    safe_mask = torch.where(has_live, full_mask, torch.ones_like(full_mask))
    full_log_mask = torch.log(torch.clamp(safe_mask, min=1e-30)).to(F32)
    Cl = mask.shape[1]
    lo = 0 if mesh is None else mesh.ctx_index * Cl
    log_mask = full_log_mask.narrow(1, lo, Cl)

    layer_fn = functools.partial(_layer, log_mask=log_mask,
                                 heads=dims.xf_heads, use_kernel=use_kernel,
                                 mesh=mesh, ring=dims.ring_attention,
                                 full_log_mask=full_log_mask)
    x = emb @ xf["in_proj"].to(compute_dtype)
    for layer in xf["layers"]:
        if dims.xf_remat and torch.is_grad_enabled():
            x = checkpoint(layer_fn, x, layer, use_reentrant=False)
        else:
            x = layer_fn(x, layer)

    x = _rms_norm(x, xf["ln_f_scale"])
    # the learned-query pool over the transformed contexts
    pool_logits = x.to(F32) @ xf["pool_query"].to(F32) + log_mask
    if mesh is None:
        attn = torch.softmax(pool_logits, dim=-1)           # [B, C]
        code = torch.einsum("bc,bcd->bd", attn.to(compute_dtype), x)
        return code, attn
    attn = torch.softmax(all_gather(pool_logits, 1, mesh),
                         dim=-1).narrow(1, lo, Cl)           # [B, C/s]
    share = torch.einsum("bc,bcd->bd", attn.to(compute_dtype).to(F32),
                         x.to(F32))
    return all_sum(share, mesh).to(compute_dtype), attn

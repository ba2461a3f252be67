"""Multi-head self-attention of the transformer path-encoder.

Counterpart of `ops/xf_attention.py` in the JAX package. The layout is
the JAX package's: q, k, v [B, H, C, hd], the additive key mask
`log_mask` [B, C] float32 (0 on a live key, log(1e-30) on a masked one),
the output like q.

- `mha_reference`: the XLA path of the JAX encoder's `_mha` (its
  `mha_reference`), with its rounding places: q k^T in the input dtype,
  widened to float32, divided by sqrt(hd), softmax in float32, the
  weights cast back to the input dtype before the product with v;
- `mha_forward_plain` and `mha_backward_plain`: the plain versions of
  kernels 2 and 3 (csrc/xf_attention.cu), with the Pallas kernels'
  semantics: q, k, v (and do) widened to float32, the logits multiplied
  by 1 / sqrt(hd) rounded to float32, a max-subtracted softmax, every
  product in float32, each output cast to q's dtype;
- `mha_forward_fused` and `mha_backward_fused`: the kernels' wrappers. A
  CPU tensor goes to the plain version; a CUDA tensor to the kernel
  (ops/xf_attention_kernel.py), or the call raises. Each counts its
  kernel launches in `.launches` (kernel 3's two launches, 3a and 3b,
  count as one);
- `fused_mha`: the differentiable attention, a `torch.autograd.Function`
  whose forward is `mha_forward_fused` and whose backward is
  `mha_backward_fused`; `log_mask` gets a zero gradient, as in the JAX
  package's custom VJP. `plain_mha` is the same through the plain
  versions on any device. `mha_reference` is not on any path of the
  port: it is the JAX XLA path, for the tests that hold it to JAX's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from code2vec_tpu_torch.ops.xf_attention_kernel import (mha_backward_cuda,
                                                        mha_forward_cuda)

F32 = torch.float32


def _scale(hd: int, device) -> torch.Tensor:
    """1 / sqrt(hd) rounded to float32, as JAX rounds the Python scalar."""
    return torch.tensor(1.0 / (hd ** 0.5), dtype=F32, device=device)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_mask: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + log_mask) v, the XLA path's casts."""
    hd = q.shape[-1]
    logits = torch.matmul(q, k.transpose(-1, -2)).to(F32)
    logits = logits / torch.sqrt(torch.tensor(float(hd), dtype=F32,
                                              device=q.device)) \
        + log_mask.to(F32)[:, None, None, :]
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(attn, v)


def _attention_f32(qf, kf, log_mask, scale) -> torch.Tensor:
    """The Pallas kernels' float32 softmax weights [B, H, C, C]."""
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale \
        + log_mask.to(F32)[:, None, None, :]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def mha_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_mask: torch.Tensor) -> torch.Tensor:
    """Kernel 2's plain version (`_fwd_kernel`): o like q."""
    scale = _scale(q.shape[-1], q.device)
    attn = _attention_f32(q.to(F32), k.to(F32), log_mask, scale)
    return torch.matmul(attn, v.to(F32)).to(q.dtype)


def mha_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       log_mask: torch.Tensor, do: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 3's plain version (`_bwd_kernel`): the softmax recomputed in
    float32, dV = A^T dO, dA = dO V^T, dL = A (dA - rowsum(dA A)),
    dQ = dL K s, dK = dL^T Q s; each cast to q's dtype."""
    scale = _scale(q.shape[-1], q.device)
    qf, kf, vf, dof = q.to(F32), k.to(F32), v.to(F32), do.to(F32)
    attn = _attention_f32(qf, kf, log_mask, scale)
    dv = torch.matmul(attn.transpose(-1, -2), dof)
    da = torch.matmul(dof, vf.transpose(-1, -2))
    dl = attn * (da - (da * attn).sum(dim=-1, keepdim=True))
    dq = torch.matmul(dl, kf) * scale
    dk = torch.matmul(dl.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def mha_forward_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_mask: torch.Tensor) -> torch.Tensor:
    """Kernel 2 on CUDA tensors, its plain version on CPU tensors."""
    if q.device.type == "cpu":
        return mha_forward_plain(q, k, v, log_mask)
    o = mha_forward_cuda(q, k, v, log_mask)
    mha_forward_fused.launches += 1
    return o


mha_forward_fused.launches = 0


def mha_backward_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       log_mask: torch.Tensor, do: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 3 on CUDA tensors, its plain version on CPU tensors."""
    if q.device.type == "cpu":
        return mha_backward_plain(q, k, v, log_mask, do)
    grads = mha_backward_cuda(q, k, v, log_mask, do)
    mha_backward_fused.launches += 1
    return grads


mha_backward_fused.launches = 0


class _MHA(torch.autograd.Function):
    """Forward and backward from the saved q, k, v and log_mask (no
    [B, H, C, C] tensor is kept between the two): kernels 2 and 3 through
    their wrappers with `fused`, else their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, log_mask, fused):
        ctx.fused = fused
        ctx.save_for_backward(q, k, v, log_mask)
        forward = mha_forward_fused if fused else mha_forward_plain
        return forward(q, k, v, log_mask)

    @staticmethod
    def backward(ctx, do):
        q, k, v, log_mask = ctx.saved_tensors
        backward = mha_backward_fused if ctx.fused else mha_backward_plain
        dq, dk, dv = backward(q, k, v, log_mask, do)
        d_mask = torch.zeros_like(log_mask) if ctx.needs_input_grad[3] \
            else None
        return dq, dk, dv, d_mask, None


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_mask: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + log_mask) v through kernels 2 and 3
    (their plain versions on CPU tensors)."""
    return _MHA.apply(q, k, v, log_mask, True)


def plain_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_mask: torch.Tensor) -> torch.Tensor:
    """`fused_mha` through the plain versions of kernels 2 and 3 on any
    device (the plain path a kernel path is held against)."""
    return _MHA.apply(q, k, v, log_mask, False)

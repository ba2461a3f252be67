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
- `mha_forward_oracle`: kernel 2's function in float64, rounded once to
  bf16, and `bf16_ulp_readings`: how far a bf16 output lies from it, in
  ulps, over the elements a float32 evaluation can resolve and over the
  rest;
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


def round_to_bf16(x: torch.Tensor) -> torch.Tensor:
    """float64 `x` rounded once to bf16, to nearest with ties to even
    (a cast through float32 would round twice). bf16's subnormals are
    not handled: every |x| here is far above 2^-126 or 0."""
    mant, exp = torch.frexp(x)                  # x = mant * 2^exp
    r = torch.round(torch.ldexp(mant, torch.full_like(exp, 8)))
    return torch.ldexp(r, exp - 8).to(torch.bfloat16)


# an element of o is resolvable by a float32 evaluation where |o| is at
# least this share of sum_j a_j |v_j|: a float32 sum's error, a few
# hundred 2^-24 of that magnitude, then stays under half a bf16 ulp of o
# (2^-9 |o|); below it (o near 0 from cancelling terms) a float32
# evaluation itself lies several bf16 ulps from the exact value
RESOLVABLE_SHARE = 2.0 ** -7


def mha_forward_oracle(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       log_mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2's function in float64 (q, k, v, log_mask widened; the
    scale is the kernels' 1 / sqrt(hd) rounded to float32) -> (o rounded
    once to bf16: the yardstick kernel 2's and its plain version's bf16
    outputs are read against, in units in the last place; the float64
    magnitude sum_j a_j |v_j| of each element's terms)."""
    d = torch.float64
    scale = _scale(q.shape[-1], q.device).to(d)
    logits = torch.matmul(q.to(d), k.to(d).transpose(-1, -2)) * scale \
        + log_mask.to(d)[:, None, None, :]
    attn = torch.softmax(logits, dim=-1)
    vd = v.to(d)
    return (round_to_bf16(torch.matmul(attn, vd)),
            torch.matmul(attn, vd.abs()))


def bf16_ulp_readings(o: torch.Tensor, oracle: torch.Tensor,
                      magnitude: torch.Tensor) -> dict:
    """A bf16 output against `mha_forward_oracle`'s (o, magnitude):
    `max_ulp`, the largest distance in bf16 units in the last place over
    the elements a float32 evaluation resolves (|o| >= RESOLVABLE_SHARE
    of the magnitude); `share`, the share of all elements that differ;
    `max_ulp_rest` and `rest_share`, the largest distance over the other
    elements and their share."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    dist = (ordered(o) - ordered(oracle)).abs()
    ok = oracle.to(torch.float64).abs() >= RESOLVABLE_SHARE * magnitude
    rest = dist[~ok]
    return {"max_ulp": int(dist[ok].max().item()) if ok.any() else 0,
            "share": float((dist > 0).float().mean().item()),
            "max_ulp_rest": int(rest.max().item()) if rest.numel() else 0,
            "rest_share": float((~ok).float().mean().item())}


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

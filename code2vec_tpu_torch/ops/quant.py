"""int8 embedding tables with per-row scales, the dither stream, and the
dense requantize.

A copy of `ops/quant.py` in the JAX package, under the same names. A
quantized table is a dict `{"q": int8 [V, E], "s": float32 [V, 1]}`
whose row value is `q * s`, `s` being the row's absmax over 127.

`dither_from_index` is the counter-hash dither of the requantize passes:
a pure uint32 function of the element index `row * E + col` and a
per-call uint32 salt. It is reproduced bit for bit, so the port's
requantize draws exactly the JAX package's dither for the same index
and salt. torch has only partial uint32 arithmetic on the CPU, so it
computes in int64 and masks to 32 bits after every multiply and xor;
each 32 x 32-bit multiply is split into 16-bit halves so that no
intermediate leaves the int64 range.

The dense training step trains int8 tables through a straight-through
gather (`quantized_take`): rows are gathered from q and s and
dequantized to bf16, and the backward pass scatter-adds the bf16
cotangent into a dense bf16 [V, E] gradient for a "carrier" input the
forward never reads. The optimizer turns that gradient into a dense
[V, E] update, and `requantize` applies it: dequantize, add, per-row
absmax rescale, dither over the absolute element index, round half to
even, clip to +-127. `requantize_reference` is the plain version of
kernel 4 (ops/requant_kernel.py); `requantize` runs the kernel's
wrapper, which takes the plain version for CPU tensors.

Differences from the JAX package, none of which changes a value: the
salt is a uint32 passed in, not drawn from a key inside the call, and
`requantize` updates the table in place.
"""

from __future__ import annotations

from typing import Dict

import torch

QuantTable = Dict[str, torch.Tensor]  # {"q": int8 [V, E], "s": f32 [V, 1]}

# keys that may be stored quantized under tables_dtype == "int8"
QUANTIZED_TABLE_KEYS = ("token_emb", "path_emb")

_SCALE_FLOOR = 1e-12  # all-zero rows quantize against this, not 1/0

_MASK32 = 0xFFFFFFFF
_HASH_MUL1 = 2654435761
_HASH_MUL2 = 2246822519


def is_quantized(leaf) -> bool:
    """True for a {"q", "s"} quantized-table dict."""
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def row_scale(absmax: torch.Tensor) -> torch.Tensor:
    """Per-row scale max(absmax, 1e-12) / 127 as a true float32 division:
    a Python divisor would turn into a multiply by its reciprocal on CUDA
    tensors, one ulp away from the JAX package's division."""
    return torch.clamp(absmax, min=_SCALE_FLOOR) / torch.full(
        (), 127.0, dtype=torch.float32, device=absmax.device)


def quantize_table(table: torch.Tensor) -> QuantTable:
    """float [V, E] -> {"q" int8 [V, E], "s" float32 [V, 1]}, per-row
    absmax scales."""
    t = table.to(torch.float32)
    s = row_scale(t.abs().amax(dim=1, keepdim=True))
    q = torch.round(t / s).to(torch.int8)
    return {"q": q, "s": s}


def dequantize_table(qt: QuantTable, dtype=torch.float32) -> torch.Tensor:
    """The full float table (serving and export paths; the training step
    dequantizes at gather granularity)."""
    return (qt["q"].to(torch.float32) * qt["s"]).to(dtype)


def dequantized_rows(qt: QuantTable, ids: torch.Tensor) -> torch.Tensor:
    """Rows `ids` (any shape) of an int8 table, dequantized after the
    gather to bf16: q * s carries at most 8 significant bits, so bf16
    loses nothing the quantization kept."""
    flat = ids.reshape(-1)
    rows = (torch.index_select(qt["q"], 0, flat).to(torch.float32)
            * torch.index_select(qt["s"], 0, flat)).to(torch.bfloat16)
    return rows.reshape(*ids.shape, rows.shape[-1])


class _QuantizedTake(torch.autograd.Function):
    """Straight-through gather of an int8 table: forward dequantizes the
    gathered rows to bf16, backward scatter-adds the cotangent, cast to
    the carrier's dtype, into a dense zero gradient for the carrier."""

    @staticmethod
    def forward(ctx, carrier, q, s, ids):
        ctx.save_for_backward(ids.reshape(-1))
        ctx.carrier_meta = (carrier.shape, carrier.dtype, carrier.device)
        return dequantized_rows({"q": q, "s": s}, ids)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        shape, dtype, device = ctx.carrier_meta
        dc = torch.zeros(shape, dtype=dtype, device=device).index_add_(
            0, flat, g.reshape(flat.shape[0], -1).to(dtype))
        return dc, None, None, None


def quantized_take(carrier: torch.Tensor, qt: QuantTable,
                   ids: torch.Tensor) -> torch.Tensor:
    """Gather + dequantize rows `ids` of a quantized table to bf16;
    gradients flow (dense, scatter-added) to `carrier` only."""
    return _QuantizedTake.apply(carrier, qt["q"], qt["s"], ids)


def opt_param_view(params):
    """The optimizer's view of a params dict: each quantized table as a
    flat [V, E] bf16 stand-in matching the carrier gradient the
    quantized step feeds it (a broadcast zero: its values are never
    read), everything else as is."""
    return {k: (torch.zeros((), dtype=torch.bfloat16,
                            device=v["q"].device).expand(v["q"].shape)
                if is_quantized(v) else v)
            for k, v in params.items()}


def _mul32(h: torch.Tensor, k: int) -> torch.Tensor:
    """(h * k) mod 2^32 for int64 `h` in [0, 2^32) and a uint32 constant:
    the low and high 16 bits of `k` are multiplied apart (each product
    stays below 2^48)."""
    lo = h * (k & 0xFFFF)
    hi = ((h * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def dither_from_index(idx: torch.Tensor, salt) -> torch.Tensor:
    """Uniform(-0.5, 0.5) float32 dither for uint32 element indices `idx`
    under a uint32 `salt` (a Python int or an integer tensor that
    broadcasts against `idx`). Indices are taken mod 2^32; the result
    equals the JAX package's `dither_from_index` bit for bit."""
    h = idx.to(torch.int64) & _MASK32
    if isinstance(salt, torch.Tensor):
        salt = salt.to(device=h.device, dtype=torch.int64) & _MASK32
    else:
        salt = int(salt) & _MASK32
    h = _mul32(h ^ salt, _HASH_MUL1)
    h = h ^ (h >> 16)
    h = _mul32(h, _HASH_MUL2)
    h = h ^ (h >> 13)
    # the top 24 bits are exact in float32's mantissa, so the result
    # stays in [-0.5, 0.5)
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0) - 0.5


def requant_rows(f: torch.Tensor, row_ids: torch.Tensor, salt):
    """The row tail of every requantize: float32 rows `f` [N, E] of
    absolute table rows `row_ids` [N] -> (q int8 [N, E], s float32
    [N, 1]): per-row absmax rescale, counter-hash dither over the
    element index `row * E + col`, round half to even, clip to +-127."""
    s_new = row_scale(f.abs().amax(dim=1, keepdim=True))
    emb = f.shape[-1]
    cols = torch.arange(emb, dtype=torch.int64, device=f.device)
    idx = row_ids.to(torch.int64)[:, None] * emb + cols
    q_new = torch.clamp(torch.round(f / s_new + dither_from_index(idx, salt)),
                        -127, 127).to(torch.int8)
    return q_new, s_new


def requantize_reference(qt: QuantTable, update: torch.Tensor,
                         salt: int) -> QuantTable:
    """Kernel 4's plain version: a dense [V, E] additive update (bf16 or
    float32) applied to an int8 table with stochastic rounding under the
    uint32 dither `salt`; per-row scales track the new absmax. Returns a
    new table."""
    f = qt["q"].to(torch.float32) * qt["s"] + update.to(torch.float32)
    rows = torch.arange(f.shape[0], dtype=torch.int64, device=f.device)
    q_new, s_new = requant_rows(f, rows, salt)
    return {"q": q_new, "s": s_new}


def requantize(qt: QuantTable, update: torch.Tensor, salt: int, *,
               use_kernel: bool = True) -> None:
    """The table update of the quantized training step, in place on `qt`.
    `use_kernel` (the default) goes through kernel 4's wrapper, which
    launches the CUDA kernel for CUDA tensors and runs the plain version
    for CPU tensors; `use_kernel=False` runs the plain version on any
    device."""
    if use_kernel:
        # imported here: the wrapper module imports this one
        from code2vec_tpu_torch.ops.requant_kernel import requantize_fused
        requantize_fused(qt, update, salt)
        return
    new = requantize_reference(qt, update, salt)
    qt["q"].copy_(new["q"])
    qt["s"].copy_(new["s"])

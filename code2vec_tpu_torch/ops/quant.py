"""int8 embedding tables with per-row scales, and the dither stream.

A copy of the parts of `ops/quant.py` in the JAX package that the
sparse-row training step needs, under the same names. A quantized table
is a dict `{"q": int8 [V, E], "s": float32 [V, 1]}` whose row value is
`q * s`, `s` being the row's absmax over 127.

`dither_from_index` is the counter-hash dither of the requantize passes:
a pure uint32 function of the element index `row * E + col` and a
per-call uint32 salt. It is reproduced bit for bit, so the port's
requantize draws exactly the JAX package's dither for the same index
and salt. torch has only partial uint32 arithmetic on the CPU, so it
computes in int64 and masks to 32 bits after every multiply and xor;
each 32 x 32-bit multiply is split into 16-bit halves so that no
intermediate leaves the int64 range.
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


def quantize_table(table: torch.Tensor) -> QuantTable:
    """float [V, E] -> {"q" int8 [V, E], "s" float32 [V, 1]}, per-row
    absmax scales."""
    t = table.to(torch.float32)
    absmax = t.abs().amax(dim=1, keepdim=True)
    s = torch.clamp(absmax, min=_SCALE_FLOOR) / 127.0
    q = torch.round(t / s).to(torch.int8)
    return {"q": q, "s": s}


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

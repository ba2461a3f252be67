"""Fused multi-head attention: the ctypes launchers of kernels 2 and 3.

`csrc/xf_attention.cu` (built with `nvcc` for sm_90a on first use,
ops/_build.py) holds kernel 2, the forward (counterpart of `_fwd_kernel`
in the JAX package's ops/xf_attention.py), and kernel 3, the backward
(`_bwd_kernel`) as two launches: 3a (dq and the row statistics) and 3b
(dk and dv). The launchers here check their inputs, allocate the outputs
and the [B, H, C, 3] float32 statistics scratch, and launch on PyTorch's
current stream; they raise on anything the kernels do not take and on a
launch error. Dispatch by device, the plain versions and the launch
counts are in ops/xf_attention.py.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from code2vec_tpu_torch.ops import _build

KERNEL = "xf_attention"
MAX_C = 256          # a lane owns at most 8 keys (see the .cu)
MAX_HD = 128         # a lane owns at most 2 output column pairs
MAX_SMEM = 227 * 1024


def smem_bytes(C: int, hd: int, element_size: int) -> int:
    """Shared memory of one block: two staged [C, hd] blocks at a row
    stride of hd + 2 elements, and kernel 3b's three float32 statistics
    per query."""
    return 2 * C * (hd + 2) * element_size + 3 * C * 4


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.xf_attention_forward.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.xf_attention_forward.argtypes = [p, p, p, p, p, i, i, i, i, i, f,
                                             i, p]
        lib.xf_attention_forward.restype = i
        lib.xf_attention_backward.argtypes = [p, p, p, p, p, p, p, p, p, i, i,
                                              i, i, i, f, i, p]
        lib.xf_attention_backward.restype = i
        lib.xf_attention_error_string.argtypes = [i]
        lib.xf_attention_error_string.restype = ctypes.c_char_p
    return lib


def _operand(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels read pairs)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_inputs(q, k, v, log_mask, *more) -> None:
    """Raise on what kernels 2 and 3 do not take."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, C, hd], got {tuple(q.shape)}")
    B, H, C, hd = q.shape
    for name, t in (("k", k), ("v", v), *(("do", t) for t in more)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} unlike q "
                             f"{tuple(q.shape)} {q.dtype}")
    if tuple(log_mask.shape) != (B, C):
        raise ValueError(f"log_mask must be [B, C] = {(B, C)}, got "
                         f"{tuple(log_mask.shape)}")
    for t in (k, v, log_mask, *more):
        if t.device != q.device:
            raise ValueError(f"inputs on {t.device} and {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")
    if not 0 < C <= MAX_C:
        raise ValueError(f"the fused-MHA kernels take C <= {MAX_C}, got {C}")
    if hd % 16 or not 16 <= hd <= MAX_HD:
        raise ValueError(f"the fused-MHA kernels take hd a multiple of 16 up "
                         f"to {MAX_HD}, got {hd}")
    need = smem_bytes(C, hd, q.element_size())
    if need > MAX_SMEM:
        raise ValueError(f"C={C}, hd={hd} in {q.dtype} needs {need} bytes of "
                         f"shared memory a block, over {MAX_SMEM}")
    if q.device.type != "cuda":
        raise ValueError(f"no fused-MHA kernel for device {q.device}")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.xf_attention_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err})")


def _scale(hd: int) -> float:
    """1 / sqrt(hd), rounded to float32 by ctypes as JAX rounds the
    Pallas kernel's Python scalar."""
    return 1.0 / (hd ** 0.5)


def mha_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_mask: torch.Tensor) -> torch.Tensor:
    """Kernel 2: o [B, H, C, hd] in q's dtype."""
    check_inputs(q, k, v, log_mask)
    B, H, C, hd = q.shape
    q, k, v = _operand(q), _operand(k), _operand(v)
    lm = _operand(log_mask.to(torch.float32))
    o = torch.empty_like(q)
    dev = q.device
    lib = _library()
    err = lib.xf_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lm.data_ptr(), o.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, C, hd, _scale(hd), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "fused-MHA forward kernel")
    return o


def mha_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_mask: torch.Tensor, do: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 3 (3a then 3b): (dq, dk, dv), each like q."""
    check_inputs(q, k, v, log_mask, do)
    B, H, C, hd = q.shape
    q, k, v, do = _operand(q), _operand(k), _operand(v), _operand(do)
    lm = _operand(log_mask.to(torch.float32))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty((B, H, C, 3), dtype=torch.float32, device=q.device)
    dev = q.device
    lib = _library()
    err = lib.xf_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lm.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, C, hd, _scale(hd), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "fused-MHA backward kernel")
    return dq, dk, dv

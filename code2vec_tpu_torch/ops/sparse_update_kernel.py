"""Live-row Adam: the hand-written CUDA kernels and their wrappers.

Counterparts of `ops/pallas_sparse_update.py` in the JAX package: kernel
5 (`_row_adam_impl`, float32/bf16 tables) and kernel 6
(`_requant_adam_impl`, int8 {q, s} tables). The kernels are
`csrc/sparse_row_update.cu`, built with `nvcc` for sm_90a on first use
(ops/_build.py) and called through ctypes. They update the table, its
scales and its float32 moments in place at the U deduplicated rows, one
warp per row.

Each wrapper dispatches on where its tensors lie: CPU tensors go to the
plain version in sparse_update.py (`apply_rows_plain`,
`apply_quant_rows_plain`), CUDA tensors to the kernel, or the call
raises. Each counts its kernel launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.ops.quant import QuantTable
from code2vec_tpu_torch.ops.sparse_update import (RowAdamState,
                                                  apply_quant_rows_plain,
                                                  apply_rows_plain)

KERNEL = "sparse_row_update"


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.sparse_row_adam_launch.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.sparse_row_adam_launch.argtypes = [
            p, i, p, p, p, p, p, ll, ll, i, f, f, f, f, f, i, p]
        lib.sparse_row_adam_launch.restype = i
        lib.sparse_requant_adam_launch.argtypes = [
            p, p, p, p, p, p, p, ctypes.c_uint, ll, ll, i, f, f, f, f, f, i, p]
        lib.sparse_requant_adam_launch.restype = i
        lib.sparse_row_update_error_string.argtypes = [i]
        lib.sparse_row_update_error_string.restype = ctypes.c_char_p
    return lib


def _check_rows(name: str, rows: torch.Tensor, state: RowAdamState,
                uids: torch.Tensor, seg: torch.Tensor,
                lr_t: torch.Tensor) -> None:
    """Validates what both kernels take."""
    if rows.dim() != 2:
        raise ValueError(f"{name} must be [V, E], got {tuple(rows.shape)}")
    V, E = rows.shape
    U = uids.shape[0]
    dev = rows.device
    for what, t in (("m", state.m), ("v", state.v)):
        if tuple(t.shape) != (V, E) or t.dtype != torch.float32:
            raise ValueError(f"moment {what} must be float32 [{V}, {E}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if uids.dim() != 1 or uids.dtype != torch.int32:
        raise ValueError(f"uids must be int32 [U], got {uids.dtype} "
                         f"{tuple(uids.shape)}")
    if tuple(seg.shape) != (U, E) or seg.dtype != torch.float32:
        raise ValueError(f"seg must be float32 [{U}, {E}], got {seg.dtype} "
                         f"{tuple(seg.shape)}")
    if lr_t.numel() != 1 or lr_t.dtype != torch.float32:
        raise ValueError("lr_t must be one float32 value")
    for what, t in (("m", state.m), ("v", state.v), ("uids", uids),
                    ("seg", seg), ("lr_t", lr_t)):
        if t.device != dev:
            raise ValueError(f"{what} on {t.device}, {name} on {dev}")
    for what, t in (("m", state.m), ("v", state.v), ("uids", uids),
                    ("seg", seg)):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def _hp(b1: float, b2: float, eps: float):
    # (1 - b) is rounded to float32 from the double, as the plain version's
    # Python scalar is
    return (b1, 1.0 - b1, b2, 1.0 - b2, eps)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.sparse_row_update_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} "
                           f"(cudaError {err})")


def sparse_row_adam_fused(table: torch.Tensor, state: RowAdamState,
                          uids: torch.Tensor, seg: torch.Tensor,
                          lr_t: torch.Tensor, *, b1: float, b2: float,
                          eps: float) -> None:
    """Kernel 5: live-row Adam over unique int32 `uids` [U] with summed
    `seg` [U, E], in place on a float32/bf16 `table` [V, E] (V < 2^31)
    and its moments."""
    if table.device.type == "cpu":
        apply_rows_plain(table, state, uids, seg, lr_t, b1, b2, eps)
        return
    if table.device.type != "cuda":
        raise ValueError(f"no live-row Adam kernel for device {table.device}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table must be float32 or bfloat16, got "
                        f"{table.dtype}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    _check_rows("table", table, state, uids, seg, lr_t)
    V, E = table.shape
    dev = table.device
    lib = _library()
    err = lib.sparse_row_adam_launch(
        table.data_ptr(), int(table.dtype == torch.bfloat16),
        state.m.data_ptr(), state.v.data_ptr(), uids.data_ptr(),
        seg.data_ptr(), lr_t.data_ptr(), uids.shape[0], V, E,
        *_hp(b1, b2, eps),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "sparse_row_adam")
    sparse_row_adam_fused.launches += 1


def sparse_requant_adam_fused(qt: QuantTable, state: RowAdamState,
                              uids: torch.Tensor, seg: torch.Tensor,
                              salt: int, lr_t: torch.Tensor, *, b1: float,
                              b2: float, eps: float) -> None:
    """Kernel 6: live-row requantize-aware Adam over unique `uids` with
    summed `seg`, in place on an int8 {q [V, E], s [V, 1]} table and its
    moments, under the uint32 dither `salt`."""
    q, s = qt["q"], qt["s"]
    if q.device.type == "cpu":
        apply_quant_rows_plain(qt, state, uids, seg, salt, lr_t, b1, b2,
                               eps)
        return
    if q.device.type != "cuda":
        raise ValueError(f"no live-row Adam kernel for device {q.device}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"int8 table must be q int8 and s float32, got "
                        f"{q.dtype} and {s.dtype}")
    _check_rows("q", q, state, uids, seg, lr_t)
    V, E = q.shape
    if tuple(s.shape) != (V, 1) or s.device != q.device:
        raise ValueError(f"s must be [{V}, 1] on {q.device}, got "
                         f"{tuple(s.shape)} on {s.device}")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError("q and s must be contiguous")
    dev = q.device
    lib = _library()
    err = lib.sparse_requant_adam_launch(
        q.data_ptr(), s.data_ptr(), state.m.data_ptr(), state.v.data_ptr(),
        uids.data_ptr(), seg.data_ptr(), lr_t.data_ptr(),
        int(salt) & 0xFFFFFFFF, uids.shape[0], V, E, *_hp(b1, b2, eps),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "sparse_requant_adam")
    sparse_requant_adam_fused.launches += 1


sparse_row_adam_fused.launches = 0
sparse_requant_adam_fused.launches = 0

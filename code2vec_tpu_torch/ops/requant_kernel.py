"""Dense int8 requantize: the hand-written CUDA kernel and its wrapper.

Counterpart of `ops/pallas_requant.py` in the JAX package (kernel 4,
`_requantize_fused_impl`). The kernel is `csrc/requant.cu`, built with
`nvcc` for sm_90a on first use (ops/_build.py) and called through ctypes.
It applies a dense [V, E] update (bf16 or float32) to an int8 {q, s}
table in place: dequantize, add, per-row absmax rescale, counter-hash
dither, round half to even, clip to +-127. Rows of E = 16 L (L a power
of two up to 32, java-large's E = 128) at 16-byte aligned pointers take
`requant_vec_kernel` (16 elements a lane in 16-byte loads and stores,
the row's values kept in registers); every other table the scalar
`requant_kernel` (one warp per row). Both give the same bits
(`kernel_name` says which one a table takes).

`requantize_fused` dispatches on where its tensors lie: CPU tensors go to
the plain version in quant.py (`requantize_reference`, through
`requantize(..., use_kernel=False)`), CUDA tensors to
the kernel, or the call raises. It counts its kernel launches in
`requantize_fused.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.ops.quant import QuantTable, requantize

KERNEL = "requant"


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.requant_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.requant_launch.argtypes = [p, p, p, i, ctypes.c_uint,
                                       ctypes.c_longlong, i, i, p]
        lib.requant_launch.restype = i
        lib.requant_vec_lanes.argtypes = [p, p, i]
        lib.requant_vec_lanes.restype = i
        lib.requant_error_string.argtypes = [i]
        lib.requant_error_string.restype = ctypes.c_char_p
    return lib


def kernel_name(qt: QuantTable, update: torch.Tensor) -> str:
    """The CUDA kernel `requantize_fused` launches for this table and
    update (the profiler's name for it)."""
    lanes = _library().requant_vec_lanes(qt["q"].data_ptr(),
                                         update.data_ptr(), qt["q"].shape[1])
    return "requant_vec_kernel" if lanes else "requant_kernel"


def requantize_fused(qt: QuantTable, update: torch.Tensor, salt: int
                     ) -> None:
    """Kernel 4: `update` [V, E] (bf16 or float32) applied in place to an
    int8 {q [V, E], s [V, 1]} table under the uint32 dither `salt`."""
    q, s = qt["q"], qt["s"]
    if q.device.type == "cpu":
        requantize(qt, update, salt, use_kernel=False)
        return
    if q.device.type != "cuda":
        raise ValueError(f"no requantize kernel for device {q.device}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"int8 table must be q int8 and s float32, got "
                        f"{q.dtype} and {s.dtype}")
    if q.dim() != 2:
        raise ValueError(f"q must be [V, E], got {tuple(q.shape)}")
    V, E = q.shape
    if tuple(s.shape) != (V, 1) or tuple(update.shape) != (V, E):
        raise ValueError(f"s must be [{V}, 1] and update [{V}, {E}], got "
                         f"{tuple(s.shape)} and {tuple(update.shape)}")
    if update.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"update must be float32 or bfloat16, got "
                        f"{update.dtype}")
    for what, t in (("s", s), ("update", update)):
        if t.device != q.device:
            raise ValueError(f"{what} on {t.device}, q on {q.device}")
    for what, t in (("q", q), ("s", s), ("update", update)):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    dev = q.device
    lib = _library()
    err = lib.requant_launch(
        q.data_ptr(), s.data_ptr(), update.data_ptr(),
        int(update.dtype == torch.bfloat16), int(salt) & 0xFFFFFFFF, V, E,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.requant_error_string(err).decode()
        raise RuntimeError(f"requantize kernel launch failed: {msg} "
                           f"(cudaError {err})")
    requantize_fused.launches += 1


requantize_fused.launches = 0


# the launch geometry of csrc/requant.cu (kThreads, kPiece)
_THREADS = 256
_PIECE = 16


def block_rows(emb: int) -> int:
    """The table rows one CTA of kernel 4 covers at width `emb` (16-byte
    aligned tables, as torch allocates them): the vector kernel's
    (kThreads / 32) * (32 / lanes) at emb = 16 lanes with lanes a power
    of two up to 32, else the scalar kernel's one row a warp. The grid
    is fixed by the source: this is the only block size there is."""
    lanes = emb // _PIECE
    if emb % _PIECE == 0 and 0 < lanes <= 32 and lanes & (lanes - 1) == 0:
        return (_THREADS // 32) * (32 // lanes)
    return _THREADS // 32


def requant_traffic_bytes(qt: QuantTable, update: torch.Tensor) -> int:
    """Analytic memory bytes of ONE fused sweep: q and s read and
    written once, the update rows read once (the JAX package's
    `requant_traffic_bytes`, ops/pallas_requant.py)."""
    q, s = qt["q"], qt["s"]
    return (q.numel() * q.element_size() * 2
            + s.numel() * s.element_size() * 2
            + update.numel() * update.element_size())

"""Fused masked attention pool: the hand-written CUDA kernels and their
wrapper.

Counterpart of `ops/pallas_attention.py::attention_pool_pallas` in the JAX
package (the Pallas TPU kernel `_attention_kernel`). The kernels are
`csrc/attention_pool.cu`, built with `nvcc` for sm_90a on first use
(ops/_build.py) and called through ctypes. Their semantics are the Pallas
kernel's: T and the attention vector are float32, bf16 contexts are exact
in float32, outputs are float32 `code [B, D]` and `attn [B, C]`, and the
[B, C, D] transformed intermediate never reaches device memory. bf16
contexts (every launch of the main paths) run on the tensor cores, T split
into `tc_terms()` bf16 terms, in three launches (split T, one block per
tile of up to 112 contexts, combine the tiles) that count as one; float32
contexts run on the CUDA cores in float32 FMA. The choice is by dtype.

`attention_pool_fused` dispatches on where its tensors lie: a CPU tensor
goes to the plain version `attention_pool_plain`; a CUDA tensor goes to
the kernel, or the call raises. It counts its kernel launches in
`attention_pool_fused.launches`.

`attention_pool_train` is the differentiable pool of the training step,
the counterpart of the JAX package's custom-VJP `attention_pool_fused`:
on CUDA tensors its forward is the kernel and its backward recomputes
the plain pool in the contexts' dtype under autograd (`_fused_bwd` in
ops/pallas_attention.py, which rematerialises the pool rather than
keeping a backward kernel). The JAX package's sparse-row step pools
with the plain XLA version instead; the port uses the kernel on the
card, as the JAX dense step does, so the plain pool is not on the main
path when a card is present. On CPU tensors it is the plain pool, as in
the JAX sparse step.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.ops.attention import attention_pool

KERNEL = "attention_pool"
_MAX_D = 512  # one thread per column (float32), 32 columns a warp (bf16)


def attention_pool_plain(contexts: torch.Tensor, transform: torch.Tensor,
                         attention: torch.Tensor, mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: the pool computed in float32."""
    f32 = torch.float32
    return attention_pool(contexts.to(f32), transform.to(f32),
                          attention.to(f32), mask.to(f32))


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.attention_pool_forward.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.attention_pool_forward.argtypes = [p, i, p, p, p, p, p, p,
                                               i, i, i, i, p]
        lib.attention_pool_forward.restype = i
        lib.attention_pool_tc_scratch_bytes.argtypes = [i, i, i]
        lib.attention_pool_tc_scratch_bytes.restype = ctypes.c_longlong
        lib.attention_pool_tc_terms.argtypes = []
        lib.attention_pool_tc_terms.restype = i
        lib.attention_pool_error_string.argtypes = [i]
        lib.attention_pool_error_string.restype = ctypes.c_char_p
    return lib


def tc_terms() -> int:
    """The bf16 terms the tensor-core kernel splits the float32 T into
    (one product per term), as the built kernel has it."""
    return int(_library().attention_pool_tc_terms())


def _operand(t: torch.Tensor, dtype=None) -> torch.Tensor:
    """Contiguous, in `dtype` if given, and 16-byte aligned (the kernels
    read 16-byte pieces and pairs)."""
    t = (t if dtype is None else t.to(dtype)).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(contexts, transform, attention, mask):
    if contexts.dim() != 3:
        raise ValueError(f"contexts must be [B, C, D], got "
                         f"{tuple(contexts.shape)}")
    B, C, D = contexts.shape
    if tuple(transform.shape) != (D, D) or tuple(attention.shape) != (D,) \
            or tuple(mask.shape) != (B, C):
        raise ValueError(
            f"shape mismatch: contexts {tuple(contexts.shape)}, transform "
            f"{tuple(transform.shape)}, attention {tuple(attention.shape)}, "
            f"mask {tuple(mask.shape)}")
    dev = contexts.device
    for name, t in (("transform", transform), ("attention", attention),
                    ("mask", mask)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, contexts on {dev}")
    if contexts.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"contexts must be float32 or bfloat16, got "
                        f"{contexts.dtype}")
    if D % 32 or D > _MAX_D:
        raise ValueError(f"the CUDA kernel takes D a multiple of 32 and at "
                         f"most {_MAX_D}, got D={D}")


def attention_pool_fused(contexts: torch.Tensor, transform: torch.Tensor,
                         attention: torch.Tensor, mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same signature as `attention_pool`; float32 outputs."""
    if contexts.device.type == "cpu":
        return attention_pool_plain(contexts, transform, attention, mask)
    if contexts.device.type != "cuda":
        raise ValueError(f"no attention-pool kernel for device "
                         f"{contexts.device}")
    _check(contexts, transform, attention, mask)
    B, C, D = contexts.shape
    dev = contexts.device
    code = torch.empty((B, D), dtype=torch.float32, device=dev)
    attn = torch.empty((B, C), dtype=torch.float32, device=dev)
    ctx = _operand(contexts)
    tr, at, m = (_operand(t, torch.float32) for t in (transform, attention,
                                                        mask))
    lib = _library()
    bf16 = ctx.dtype == torch.bfloat16
    scratch = None
    if bf16:  # T's terms and the tiles' partial results
        scratch = torch.empty(lib.attention_pool_tc_scratch_bytes(B, C, D),
                              dtype=torch.uint8, device=dev)
    err = lib.attention_pool_forward(
        ctx.data_ptr(), int(bf16), tr.data_ptr(), at.data_ptr(),
        m.data_ptr(), code.data_ptr(), attn.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        B, C, D, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.attention_pool_error_string(err).decode()
        raise RuntimeError(f"attention_pool kernel launch failed: "
                           f"{msg} (cudaError {err})")
    attention_pool_fused.launches += 1
    return code, attn


attention_pool_fused.launches = 0


class _KernelPoolRecomputeBackward(torch.autograd.Function):
    """Forward: the CUDA kernel (float32 code, attention weights not
    differentiated). Backward: the VJP of the plain pool recomputed in
    the contexts' dtype, with the code widened to float32."""

    @staticmethod
    def forward(ctx, contexts, transform, attention, mask):
        code, attn = attention_pool_fused(contexts, transform, attention,
                                          mask)
        ctx.save_for_backward(contexts, transform, attention, mask)
        ctx.mark_non_differentiable(attn)
        return code, attn

    @staticmethod
    def backward(ctx, d_code, _d_attn):
        contexts, transform, attention, mask = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        leaves = [x.detach().requires_grad_(need)
                  for x, need in zip((contexts, transform, attention), needs)]
        with torch.enable_grad():
            code, _attn = attention_pool(leaves[0], leaves[1], leaves[2],
                                         mask)
            wanted = [x for x, need in zip(leaves, needs) if need]
            grads = iter(torch.autograd.grad(code.to(torch.float32), wanted,
                                             d_code))
        return (*(next(grads) if need else None for need in needs), None)


def attention_pool_train(contexts: torch.Tensor, transform: torch.Tensor,
                         attention: torch.Tensor, mask: torch.Tensor, *,
                         use_kernel: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable pool of the training step -> (code [B, D] in
    the contexts' dtype, attn [B, C] float32). CUDA tensors with
    `use_kernel` go through the kernel; otherwise the plain pool runs."""
    if use_kernel and contexts.device.type != "cpu":
        code, attn = _KernelPoolRecomputeBackward.apply(
            contexts, transform, attention, mask)
        return code.to(contexts.dtype), attn
    return attention_pool(contexts, transform, attention, mask)

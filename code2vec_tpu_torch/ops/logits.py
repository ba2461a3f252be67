"""Float32 logits from low-precision operands: `rows_product_f32`.

The JAX package writes its logits as `(code @ table.astype(dtype).T)
.astype(float32)`. Under `jax.jit`, which runs every step, evaluation,
prediction and attack there, XLA folds the cast into the product: a
bf16 x bf16 product comes out in float32, never rounded to bf16. A
plain `(a @ b).to(float32)` in PyTorch rounds the [B, V] product to
bf16 first (a bf16 ulp of the logits, 0.18 at B = 8, D = 384,
V = 1000), so the port computes the product with a float32 output:

- on the card, `torch.mm(a, b, out_dtype=torch.float32)`: a plain large
  product that the JAX package also computes outside any Pallas kernel;
- on the CPU, `a.float() @ b.float()`: the bf16 products are exact in
  float32, and PyTorch has no CPU kernel for `aten::mm.dtype`.

`aten::mm.dtype` has no autograd formula, so the product is an
`autograd.Function` whose backward is the VJP of `dot -> convert(f32)`
as the jitted JAX step computes it: the float32 cotangent rounded to the
operands' dtype, then the two products. The code vectors' gradient is
rounded to their dtype, as JAX's is. The rows' gradient comes out in the
rows' own dtype (the table's, before the cast to the compute dtype):
float32 rows get the product unrounded, because XLA folds their
`convert` into the product too, and bf16 rows get it rounded.

`gathered_logits_f32` is the sampled softmax's pair of logits over
gathered target rows, the same way: the true logits' elementwise
products and their sum in float32, the sum rounded once to the compute
dtype (the jitted `sum(a * w).astype(float32)`), and the sampled logits'
product in float32, never rounded. Its backward sums the code vectors'
two cotangents in float32 and rounds once, as XLA fuses the two into one
float32 add.

A float32 `a` takes the plain float32 product: nothing rounds there.
"""

from __future__ import annotations

import torch


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] in float32 from operands of one low-precision
    dtype, rounded once."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _RowsProductF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, rows):
        low = rows.to(a.dtype)
        ctx.save_for_backward(a, low)
        ctx.rows_dtype = rows.dtype
        return _mm_f32(a, low.T)

    @staticmethod
    def backward(ctx, g):
        a, low = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gr = None
        if ctx.needs_input_grad[0]:
            ga = g @ low
        if ctx.needs_input_grad[1]:
            if ctx.rows_dtype == a.dtype:
                gr = g.T @ a
            else:
                gr = _mm_f32(g.T.contiguous(), a).to(ctx.rows_dtype)
        return ga, gr


def rows_product_f32(a: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """`a [M, D] @ rows [N, D].T` -> float32 [M, N], `rows` cast to a's
    dtype first, the product never rounded to a's dtype (see the module
    docstring)."""
    if a.dtype == torch.float32:
        return a @ rows.to(torch.float32).T
    return _RowsProductF32.apply(a, rows)


class _GatheredLogitsF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, code, true_w, samp_w):
        dt = code.dtype
        tw, sw = true_w.to(dt), samp_w.to(dt)
        ctx.save_for_backward(code, tw, sw)
        ctx.dtypes = (true_w.dtype, samp_w.dtype)
        true_logits = (code.float() * tw.float()).sum(dim=-1).to(dt).float()
        return true_logits, _mm_f32(code, sw.T)

    @staticmethod
    def backward(ctx, g_true, g_samp):
        code, tw, sw = ctx.saved_tensors
        dt = code.dtype
        gt = g_true.to(dt)
        gs = g_samp.to(dt)
        g_code = (gt.float()[:, None] * tw.float()
                  + _mm_f32(gs, sw)).to(dt)
        g_tw = (gt.float()[:, None] * code.float()).to(ctx.dtypes[0])
        g_sw = _mm_f32(gs.T.contiguous(), code).to(ctx.dtypes[1])
        return g_code, g_tw, g_sw


def gathered_logits_f32(code: torch.Tensor, true_w: torch.Tensor,
                        samp_w: torch.Tensor
                        ) -> "tuple[torch.Tensor, torch.Tensor]":
    """(true logits [B], sampled logits [B, S]), float32, from code
    [B, D], true_w [B, D] and samp_w [S, D] (rows cast to code's dtype;
    see the module docstring)."""
    if code.dtype == torch.float32:
        return ((code * true_w.to(torch.float32)).sum(dim=-1),
                code @ samp_w.to(torch.float32).T)
    return _GatheredLogitsF32.apply(code, true_w, samp_w)

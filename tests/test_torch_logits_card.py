"""The two branches of `ops/logits.rows_product_f32` on the card: the
card's `torch.mm(a, b, out_dtype=float32)` against the CPU branch's
`a.float() @ b.float()` on the same bf16 operands, forward and both
gradients (`cuda`: skipped without a card; chip_smoke.py runs the same
check at the main paths' shapes). The JAX side of the fix is in
tests/test_torch_bf16_logits.py; this file imports no JAX."""

from __future__ import annotations

import pytest
import torch

from code2vec_tpu_torch.ops import logits as tlogits

B, D, V = 8, 384, 1000
ULPS = 4           # float32 ulps of sum_d |a_d * b_d| a logit
BF16_ULP = 2.0 ** -7


def _bound(a, b_rows):
    return ULPS * 2.0 ** -23 * (a.double().abs() @ b_rows.double().abs().T)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_dtype", [torch.bfloat16, torch.float32])
def test_card_branch_matches_cpu_branch(rows_dtype):
    """Forward within 4 float32 ulp of sum |a*b| per entry; the
    gradients, rounded to bf16 on both branches, within the same bound
    of their own products plus 1 bf16 ulp of their largest entry; the
    rows' gradient in the rows' dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(5)
    a = torch.randn((B, D), generator=gen).to(torch.bfloat16)
    rows = (torch.randn((V, D), generator=gen) * 0.1).to(rows_dtype)
    g = torch.randn((B, V), generator=gen)
    outs = {}
    for dev in ("cpu", "cuda"):
        ta = a.to(dev).requires_grad_(True)
        tr = rows.to(dev).requires_grad_(True)
        y = tlogits.rows_product_f32(ta, tr)
        ga, gr = torch.autograd.grad(y, [ta, tr], g.to(dev))
        assert y.dtype == torch.float32 and gr.dtype == rows_dtype
        outs[dev] = [t.detach().double().cpu() for t in (y, ga, gr)]
    low = rows.to(torch.bfloat16)
    gb = g.to(torch.bfloat16)
    bounds = [_bound(a, low), _bound(gb, low.T), _bound(gb.T, a.T)]
    for i, (x, y, tol) in enumerate(zip(outs["cuda"], outs["cpu"], bounds)):
        if i:
            tol = tol + BF16_ULP * y.abs().max()
        assert bool(((x - y).abs() <= tol).all()), i

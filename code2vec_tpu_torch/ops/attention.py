"""Masked attention pooling over a bag of context vectors (plain PyTorch).

Counterpart of `ops/attention.py::attention_pool` in the JAX package:
transformed contexts `tanh(ctx @ TRANSFORM)`, attention logits
`transformed @ ATTENTION` with padding positions at -1e9, a softmax over
the MAX_CONTEXTS axis in float32, and the attention-weighted sum of the
transformed contexts as the code vector. Computation runs in the
caller's dtype (bf16 on the serving path), the softmax in float32.

This is also the plain version that the hand-written CUDA kernel
(ops/attention_kernel.py) is held against, called there in float32.
"""

from __future__ import annotations

from typing import Tuple

import torch


def attention_pool(contexts: torch.Tensor, transform: torch.Tensor,
                   attention: torch.Tensor, mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Args:
      contexts:  [B, C, D] context vectors.
      transform: [D, D] the TRANSFORM matrix.
      attention: [D] the ATTENTION vector.
      mask:      [B, C] 1.0 for real contexts, 0.0 for padding.

    Returns:
      code_vectors: [B, D] in the contexts' dtype.
      attn_weights: [B, C] float32 softmax weights (0 at padded
        positions, and on rows with no valid context).
    """
    transformed = torch.tanh(contexts @ transform.to(contexts.dtype))
    scores = (transformed @ attention.to(contexts.dtype)).float()  # [B, C]
    scores = torch.where(mask > 0, scores, torch.full_like(scores, -1e9))
    attn = torch.softmax(scores, dim=-1)
    # guard the all-padding row (a softmax over all -1e9 is uniform)
    any_valid = mask.sum(dim=-1, keepdim=True) > 0
    attn = torch.where(any_valid, attn, torch.zeros_like(attn))
    code = torch.einsum("bc,bcd->bd", attn.to(contexts.dtype), transformed)
    return code, attn

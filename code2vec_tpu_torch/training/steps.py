"""The train, predict and encode steps as plain functions on device
tensors.

`make_train_step` is the sparse-row branch of the JAX package's
step-construction entry point (training/sparse_steps.py); the dense
step is not ported, and the trainer refuses a configuration that needs
it.

The predict and encode steps are the counterparts of `make_predict_step`
and `make_encode_step` in the JAX package's training/steps.py, with that
path's casts: the contexts are
gathered in the compute dtype, the pool's code vector is cast to the
compute dtype before the logits product against `target_emb`, and the
returned code vector is that value widened to float32. The
[B, D] x [D, V] logits product stays a `torch.matmul`, as XLA computes it
outside any Pallas kernel in the JAX package.

`batch` is the JAX step's tuple `(labels, src, pth, dst, mask, weights)`
of tensors on the params' device.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from code2vec_tpu_torch.models.encoder import (ModelDims, Params, encode,
                                               full_logits)
from code2vec_tpu_torch.training.optimizers import AdamF32Moments
from code2vec_tpu_torch.training.sparse_steps import (SparseStepConfig,
                                                      sparse_train_step)


def make_train_step(dims: ModelDims, optimizer: AdamF32Moments, *,
                    use_sampled_softmax: bool = False,
                    num_sampled: int = 4096,
                    compute_dtype=torch.float32,
                    use_kernel: bool = True) -> Callable:
    """Returns the sparse-row `step(params, opt_state, batch, draws) ->
    loss`, which updates params and opt_state in place. `optimizer` is the
    dense optimizer the opt state was built with (sparse_steps.
    init_sparse_opt_state); its learning rate is the tables' row-Adam LR
    too, as in the JAX package."""
    cfg = SparseStepConfig(learning_rate=optimizer.learning_rate,
                           use_sampled_softmax=use_sampled_softmax,
                           num_sampled=num_sampled,
                           compute_dtype=compute_dtype)

    def step(params, opt_state, batch, draws):
        return sparse_train_step(params, opt_state, batch, draws, dims=dims,
                                 cfg=cfg, dense_opt=optimizer,
                                 use_kernel=use_kernel)

    step.cfg = cfg
    return step


def encode_step(params: Params, batch, *, compute_dtype=torch.float32,
                use_kernel: bool = True) -> torch.Tensor:
    """-> code_vectors [B, D] float32 (encoder only, no logits)."""
    _labels, src, pth, dst, mask, _weights = batch
    code, _attn = encode(params, src, pth, dst, mask,
                         compute_dtype=compute_dtype, use_kernel=use_kernel)
    return code.to(torch.float32)


def predict_head(params: Params, code: torch.Tensor, dims: ModelDims,
                 top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Code vectors (compute dtype) -> (topk_ids [B, k], topk_probs [B, k])
    under a full softmax over the target vocab."""
    logits = full_logits(params, code, dims.target_vocab_size)
    probs = torch.softmax(logits, dim=-1)
    topk_probs, topk_ids = torch.topk(probs, top_k, dim=-1)
    return topk_ids, topk_probs


def predict_step(params: Params, batch, *, dims: ModelDims, top_k: int = 10,
                 compute_dtype=torch.float32, use_kernel: bool = True):
    """-> (topk_ids [B, k], topk_probs [B, k], attention [B, C] float32,
    code_vectors [B, D] float32). `use_kernel=False` pools with the plain
    version in the compute dtype (the JAX step's `use_pallas=False`)."""
    _labels, src, pth, dst, mask, _weights = batch
    code, attn = encode(params, src, pth, dst, mask,
                        compute_dtype=compute_dtype, use_kernel=use_kernel)
    topk_ids, topk_probs = predict_head(params, code, dims, top_k)
    return topk_ids, topk_probs, attn, code.to(torch.float32)

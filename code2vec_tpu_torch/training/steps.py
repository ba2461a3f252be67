"""The train, eval, predict and encode steps as plain functions on device
tensors.

Counterpart of `training/steps.py` in the JAX package.

Every step encodes through `get_encode_fn(dims)`: the bag encoder or the
transformer path-encoder, as `dims.encoder_type` says.

`make_train_step` is the one step-construction entry point:
- the dense step (the default: `make_train_step`'s dense branch and
  `_make_quantized_train_step` in the JAX package): the loss
  (`make_train_loss_fn`) is differentiated with respect to every param
  leaf (the transformer's nested "xf" leaves included; a leaf the
  encoder does not use, `encoder.unused_param_keys`, gets a zero
  gradient, as `jax.grad` gives it, and any other leaf the loss does
  not reach raises),
  so each vocab table gets a dense [V, E] gradient (the gathers' dense
  scatter-adds, `token_emb`'s two summed), the optimizer
  (training/optimizers.make_optimizer: Adafactor on the tables, Adam on
  TRANSFORM / ATTENTION and the "xf" leaves, or Adam everywhere) turns
  the gradients into updates, and the updates are added to the params.
  The optimizer sees the params as a flat dict keyed by path
  (ops/quant.opt_param_view, tree.py). With int8
  token/path tables the gradients reach a bf16 "carrier" through the
  straight-through gather (ops/quant.quantized_take), the optimizer sees
  a flat [V, E] bf16 stand-in for each (ops/quant.opt_param_view), and
  the update is applied by `requantize` (kernel 4 on the card) under the
  table's dither salt;
- `sparse_updates=True`: the sparse-row step (training/sparse_steps.py).

The dense step takes an `augment_fn(batch, rename_draws) -> batch`, the
rename defense (attacks/defense.py, `--adv_rename_prob`), applied to the
batch before the forward with the step's `draws.rename`, as the JAX
step applies it inside the jit; the sparse-row step has no such hook,
as in the JAX package.

Unlike the JAX functions, which donate their buffers and return new
ones, the port's steps update the params and the optimizer state IN
PLACE and return only the loss, a 0-d device tensor. A step's
randomness comes in as a `StepDraws` (training/draws.py). The phases of
the dense step, which a caller may time or compare apart, are
`dense_loss_and_grads` (forward + backward), the optimizer's `update`
and `apply_dense_updates` (the adds and requantizes).

The eval, predict and encode steps keep the predict path's casts: the
contexts are gathered in the compute dtype, the pool's code vector is
cast to the compute dtype before the logits product against
`target_emb`, and a returned code vector is that value widened to
float32. The [B, D] x [D, V] logits product stays a `torch.matmul`, as
XLA computes it outside any Pallas kernel in the JAX package. Their
top-k goes through `topk_stable`, which orders equal probabilities as
`jax.lax.top_k` does (the lowest id first); `torch.topk` does not.

`batch` is the JAX step's tuple `(labels, src, pth, dst, mask, weights)`
of tensors on the params' device.

`make_train_step(..., mesh=...)` builds a data-parallel step
(parallel/mesh.py): each rank steps on its own rows of the global batch
with its rows of the global draws (training/draws.py). The loss is
divided by the global `max(sum(weights), 1)` (a scalar all-reduce before
the backward; padded rows weigh 0), every gradient is summed over the
ranks in its own dtype (the int8 carrier's bf16 too) before the
optimizer, and the optimizer, the adds and kernel 4's requantize (under
the step's shared salts) then run the same on every rank, which ends
with the same params. The returned loss is the global one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from code2vec_tpu_torch import tree
from code2vec_tpu_torch.models.encoder import (ModelDims, Params, full_logits,
                                               get_encode_fn,
                                               unused_param_keys)
from code2vec_tpu_torch.ops.quant import (is_quantized, opt_param_view,
                                          requantize)
from code2vec_tpu_torch.ops.sampled_softmax import sampled_softmax_loss
from code2vec_tpu_torch.training.draws import StepDraws, quantized_keys
from code2vec_tpu_torch.training.optimizers import (AdamF32Moments,
                                                    GradientTransformation)
from code2vec_tpu_torch.training.sparse_steps import (SparseStepConfig,
                                                      loss_denominator,
                                                      reduce_step_grads,
                                                      sparse_train_step,
                                                      weighted_mean)


@dataclasses.dataclass(frozen=True)
class DenseStepConfig:
    """What the dense step needs besides dims and the optimizer."""
    use_sampled_softmax: bool = False
    num_sampled: int = 4096
    compute_dtype: torch.dtype = torch.float32
    # the rename defense's augment (attacks/defense.RenameAugment), whose
    # draws training/draws.make_draws makes; None without the defense
    augment: Optional[Any] = None


def make_train_loss_fn(dims: ModelDims, *, use_sampled_softmax: bool = False,
                       num_sampled: int = 4096, compute_dtype=torch.float32,
                       use_kernel: bool = True, mesh=None) -> Callable:
    """The training-time loss `loss_fn(params, batch, draws)`: dropout
    with the draws' keep mask, the training pool, sampled softmax over
    the draws' ids or full softmax, weighted by the example weights
    (over the global batch's weight sum under a `mesh`).
    `loss_fn.unused_keys` names the top-level params it never reads."""
    V = dims.target_vocab_size
    encode = get_encode_fn(dims)

    def loss_fn(params, batch, draws: StepDraws) -> torch.Tensor:
        labels, src, pth, dst, mask, weights = batch
        code, _attn = encode(params, src, pth, dst, mask,
                             compute_dtype=compute_dtype,
                             use_kernel=use_kernel, train=True,
                             keep=draws.keep,
                             dropout_keep_rate=dims.dropout_keep_rate)
        denom = loss_denominator(weights, mesh) if mesh is not None \
            else None
        if use_sampled_softmax:
            return sampled_softmax_loss(
                params["target_emb"], code, labels, draws.sampled,
                num_sampled, example_weights=weights, vocab_size=V,
                denom=denom)
        logits = full_logits(params, code, V)
        ce = F.cross_entropy(logits, labels.to(torch.int64),
                             reduction="none")
        return weighted_mean(ce, weights, denom)

    loss_fn.unused_keys = unused_param_keys(dims)
    return loss_fn


def dense_loss_and_grads(params: Params, batch, draws: StepDraws,
                         loss_fn: Callable
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
    """Forward + backward of the dense step -> (loss, grads, the
    optimizer's params view), the grads and the view flat dicts keyed by
    path. Float leaves are differentiated as they are; a leaf under one
    of `loss_fn.unused_keys` gets zeros, and any other leaf the loss
    does not reach raises; an int8 table's gradient is its carrier's, a
    dense bf16 [V, E], and the view holds the carrier in the table's
    place."""
    qkeys = quantized_keys(params)
    view = opt_param_view(params)
    leaves = {k: t.detach().requires_grad_(True) for k, t in view.items()}
    virt = tree.unflatten({k: t for k, t in leaves.items()
                           if k not in qkeys})
    for k in qkeys:
        virt[k] = dict(params[k], g=leaves[k])
    keys = list(leaves)
    with torch.enable_grad():
        loss = loss_fn(virt, batch, draws)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys],
                                    allow_unused=True)
    unused = set(loss_fn.unused_keys)
    out = {}
    for k, g in zip(keys, grads):
        if g is None:
            if k.split("/")[0] not in unused:
                raise RuntimeError(f"param {k!r} gets no gradient from the "
                                   "loss")
            g = torch.zeros_like(leaves[k])
        out[k] = g
    return loss.detach(), out, view


@torch.no_grad()
def apply_dense_updates(params: Params, updates: Dict[str, torch.Tensor],
                        salts: Dict[str, int], *,
                        use_kernel: bool = True) -> None:
    """The optimizer's updates (keyed by path) added to the params in
    place: an int8 table through `requantize` under its salt (kernel 4
    with `use_kernel` on the card), any other leaf as `(p + u)` cast to
    its dtype (`optax.apply_updates`)."""
    qkeys = quantized_keys(params)
    leaves = tree.flatten(params, is_leaf=is_quantized)
    for k, u in updates.items():
        if k in qkeys:
            requantize(params[k], u, salts[k], use_kernel=use_kernel)
        else:
            p = leaves[k]
            p.copy_((p + u).to(p.dtype))


def dense_train_step(params: Params, opt_state, batch, draws: StepDraws, *,
                     loss_fn: Callable, optimizer: GradientTransformation,
                     use_kernel: bool = True,
                     augment_fn: Optional[Callable] = None,
                     mesh=None) -> torch.Tensor:
    """One dense training step, in place on `params` and `opt_state`
    (from `optimizer.init(opt_param_view(params))`). `use_kernel` picks
    the requantize of int8 tables (kernel 4 or its plain version); the
    pool is `loss_fn`'s. `augment_fn` rewrites the batch first, with
    `draws.rename`. Under a `mesh` (with `loss_fn` built over it), the
    gradients and the loss are summed over the ranks before the
    optimizer. Returns the loss."""
    if augment_fn is not None:
        batch = augment_fn(batch, draws.rename)
    loss, grads, view = dense_loss_and_grads(params, batch, draws, loss_fn)
    if mesh is not None:
        loss = reduce_step_grads(loss, grads, mesh)
    updates = optimizer.update(grads, opt_state, view)
    apply_dense_updates(params, updates, draws.salts, use_kernel=use_kernel)
    return loss


def make_train_step(dims: ModelDims, optimizer, *,
                    use_sampled_softmax: bool = False,
                    num_sampled: int = 4096,
                    compute_dtype=torch.float32,
                    use_kernel: bool = True,
                    requant_kernel: Optional[bool] = None,
                    row_kernel: Optional[bool] = None,
                    sparse_updates: bool = False,
                    augment_fn: Optional[Callable] = None,
                    mesh=None) -> Callable:
    """Returns `step(params, opt_state, batch, draws) -> loss`, which
    updates params and opt_state in place.

    The dense step takes the optimizer of `make_optimizer`; its state is
    `optimizer.init(opt_param_view(params))`. `sparse_updates=True`
    builds the sparse-row step instead: `optimizer` is then the dense
    params' `AdamF32Moments`, whose learning rate is the tables' row-Adam
    LR too, and the state comes from sparse_steps.init_sparse_opt_state.
    `use_kernel=False` runs the plain pool (or MHA) on any device, and
    the plain requantize and row apply too unless `requant_kernel` /
    `row_kernel` (default: `use_kernel`) say otherwise: the command
    line's --no_pallas, --requant_pallas and --sparse_update_pallas.
    `augment_fn` is the dense step's rename defense (see the module
    docstring); the sparse-row step refuses one. `mesh` builds this
    rank's data-parallel step (the module docstring)."""
    if sparse_updates:
        if augment_fn is not None:
            raise ValueError("the sparse-row step has no augmentation hook "
                             "(Config.verify refuses --adv_rename_prob "
                             "with it)")
        if not isinstance(optimizer, AdamF32Moments):
            raise TypeError("the sparse-row step takes AdamF32Moments, got "
                            f"{type(optimizer).__name__}")
        cfg = SparseStepConfig(learning_rate=optimizer.learning_rate,
                               use_sampled_softmax=use_sampled_softmax,
                               num_sampled=num_sampled,
                               compute_dtype=compute_dtype)

        def step(params, opt_state, batch, draws):
            return sparse_train_step(params, opt_state, batch, draws,
                                     dims=dims, cfg=cfg, dense_opt=optimizer,
                                     use_kernel=use_kernel,
                                     row_kernel=row_kernel, mesh=mesh)
    else:
        cfg = DenseStepConfig(use_sampled_softmax=use_sampled_softmax,
                              num_sampled=num_sampled,
                              compute_dtype=compute_dtype,
                              augment=augment_fn)
        loss_fn = make_train_loss_fn(
            dims, use_sampled_softmax=use_sampled_softmax,
            num_sampled=num_sampled, compute_dtype=compute_dtype,
            use_kernel=use_kernel, mesh=mesh)

        def step(params, opt_state, batch, draws):
            return dense_train_step(params, opt_state, batch, draws,
                                    loss_fn=loss_fn, optimizer=optimizer,
                                    use_kernel=use_kernel
                                    if requant_kernel is None
                                    else requant_kernel,
                                    augment_fn=augment_fn, mesh=mesh)

    step.cfg = cfg
    return step


def topk_stable(probs: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis of float32 values (no NaN; the
    probabilities of the eval and predict steps, the attack's first-order
    scores with +-inf): -> (values [..., k], ids [..., k] int64), by
    descending value and, among equal values, the lowest id first, at the
    k-th value's boundary too. `torch.topk` runs over one int64 key per
    element, the float32 bits ordered as the values are (a negative
    value's bits flipped below the sign; -0 below +0) above
    2^32 - 1 - id, so the keys are distinct and their order is the
    reference's. The key is a [..., V] int64 tensor: 2.1 GB at
    [1024, 261,247]."""
    probs = probs.to(torch.float32).contiguous()
    V = probs.shape[-1]
    low = 0xFFFFFFFF - torch.arange(V, dtype=torch.int64, device=probs.device)
    bits = probs.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    key.bitwise_left_shift_(32).bitwise_or_(low)
    ids = torch.topk(key, k, dim=-1).indices
    return torch.gather(probs, -1, ids), ids


def eval_step(params: Params, batch, *, dims: ModelDims, top_k: int = 10,
              compute_dtype=torch.float32, use_kernel: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (loss_sum 0-d, topk_ids [B, k], topk_probs [B, k]): no dropout,
    full softmax; the per-example cross entropy is clamped at 0 (a
    logsumexp minus a logit can round a hair below it) and weighted by
    the example weights."""
    labels, src, pth, dst, mask, weights = batch
    code, _attn = get_encode_fn(dims)(params, src, pth, dst, mask,
                                      compute_dtype=compute_dtype,
                                      use_kernel=use_kernel)
    logits = full_logits(params, code, dims.target_vocab_size)
    ce = torch.clamp(F.cross_entropy(logits, labels.to(torch.int64),
                                     reduction="none"), min=0.0)
    loss_sum = (ce * weights).sum()
    topk_probs, topk_ids = topk_stable(torch.softmax(logits, dim=-1), top_k)
    return loss_sum, topk_ids, topk_probs


def encode_step(params: Params, batch, *, dims: ModelDims,
                compute_dtype=torch.float32,
                use_kernel: bool = True) -> torch.Tensor:
    """-> code_vectors [B, D] float32 (encoder only, no logits)."""
    _labels, src, pth, dst, mask, _weights = batch
    code, _attn = get_encode_fn(dims)(params, src, pth, dst, mask,
                                      compute_dtype=compute_dtype,
                                      use_kernel=use_kernel)
    return code.to(torch.float32)


def predict_head(params: Params, code: torch.Tensor, dims: ModelDims,
                 top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Code vectors (compute dtype) -> (topk_ids [B, k], topk_probs [B, k])
    under a full softmax over the target vocab (`topk_stable`'s order)."""
    logits = full_logits(params, code, dims.target_vocab_size)
    topk_probs, topk_ids = topk_stable(torch.softmax(logits, dim=-1), top_k)
    return topk_ids, topk_probs


def predict_step(params: Params, batch, *, dims: ModelDims, top_k: int = 10,
                 compute_dtype=torch.float32, use_kernel: bool = True):
    """-> (topk_ids [B, k], topk_probs [B, k], attention [B, C] float32,
    code_vectors [B, D] float32). `use_kernel=False` runs the kernels'
    plain versions: the bag's pool in the compute dtype (the JAX step's
    `use_pallas=False`), the transformer's attention as `plain_mha`."""
    _labels, src, pth, dst, mask, _weights = batch
    code, attn = get_encode_fn(dims)(params, src, pth, dst, mask,
                                     compute_dtype=compute_dtype,
                                     use_kernel=use_kernel)
    topk_ids, topk_probs = predict_head(params, code, dims, top_k)
    return topk_ids, topk_probs, attn, code.to(torch.float32)

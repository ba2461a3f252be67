"""The train and eval steps of the VarMisuse head (models/varmisuse.py).

Counterpart of `training/vm_steps.py` in the JAX package. As the port's
code2vec steps do (training/steps.py), the train steps update the params
and the optimizer state IN PLACE and return the loss, a 0-d device
tensor, and take the step's randomness as a `StepDraws` (its dropout
keep mask; the head draws no sampled ids and has no int8 tables).

- The dense step (the default): `steps.dense_loss_and_grads` over the vm
  loss gives every param a gradient (`target_emb`, which the loss never
  reads, a zero one, as `jax.grad` gives it, so Adafactor's factored
  state decays as optax's does), then the optimizer of
  `optimizers.make_optimizer` (Adafactor on the tables, Adam on
  TRANSFORM, ATTENTION and `vm_pointer`, which routes to the "small"
  group by its key) and the adds of `steps.apply_dense_updates`.
- `sparse_updates=True` (SPARSE_EMBEDDING_UPDATES): the same backward,
  then dense Adam with float32 moments (`AdamF32Moments`) on every param
  but the two vocab tables, and live-row Adam on `token_emb` (ids
  `cat(src, dst, cand)`) and `path_emb` (ids `pth`) through
  `sparse_update.rows_from_dense`: kernel 5 on the card. The vm loss
  gathers inside the differentiated function, so backward still gives
  the dense [V, E] gradients; the rows at the unique ids are their sums.
  The state is `init_vm_sparse_opt_state`'s `{dense, rows, count}`, the
  code2vec sparse step's layout. It refuses a mesh, as the JAX step
  does.

Under a data-parallel `mesh` the dense step is training/steps.py's: the
loss over the global batch's weight sum, the gradients summed over the
ranks before the optimizer.

The eval step returns (loss_sum, correct_sum, pred), `pred` the argmax
over the candidates: `torch.argmax` takes the lowest index among equal
scores, as `jnp.argmax` does.

`batch` is the 8-tuple (labels [B], src, pth, dst [B, C], mask [B, C],
cand_ids [B, K], cand_mask [B, K], weights [B]) on the params' device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from code2vec_tpu_torch.models.encoder import ModelDims
from code2vec_tpu_torch.models.varmisuse import (candidate_ce, vm_loss,
                                                 vm_scores)
from code2vec_tpu_torch.training.draws import StepDraws
from code2vec_tpu_torch.training.optimizers import AdamF32Moments
from code2vec_tpu_torch.training.sparse_adam import init_row_adam
from code2vec_tpu_torch.training.sparse_steps import (apply_dense_updates,
                                                      loss_denominator)
from code2vec_tpu_torch.training.sparse_update import rows_from_dense
from code2vec_tpu_torch.training.steps import (DenseStepConfig,
                                               dense_loss_and_grads,
                                               dense_train_step)

VM_TABLE_KEYS = ("token_emb", "path_emb")


def make_vm_loss_fn(dims: ModelDims, *, compute_dtype=torch.float32,
                    use_kernel: bool = True, mesh=None) -> Callable:
    """`loss_fn(params, batch, draws)`: the vm loss with the draws' keep
    mask (over the global batch's weight sum under a `mesh`).
    `loss_fn.unused_keys` names the param it never reads."""

    def loss_fn(params, batch, draws: StepDraws) -> torch.Tensor:
        return vm_loss(params, batch, keep=draws.keep,
                       dropout_keep_rate=dims.dropout_keep_rate,
                       compute_dtype=compute_dtype, use_kernel=use_kernel,
                       denom=loss_denominator(batch[-1], mesh)
                       if mesh is not None else None)

    loss_fn.unused_keys = ("target_emb",)
    return loss_fn


def init_vm_sparse_opt_state(params, dense_opt: AdamF32Moments) -> dict:
    """{"dense": Adam state of every param but the vocab tables, "rows":
    {table: RowAdamState}, "count": int32 0-d}, on the params' device."""
    dense = {k: v for k, v in params.items() if k not in VM_TABLE_KEYS}
    return {"dense": dense_opt.init(dense),
            "rows": {k: init_row_adam(params[k]) for k in VM_TABLE_KEYS},
            "count": torch.zeros((), dtype=torch.int32,
                                 device=params["transform"].device)}


def vm_table_ids(batch) -> Dict[str, torch.Tensor]:
    """The rows each vocab table gave the loss: token rows at src, dst
    and the candidates, path rows at pth."""
    _labels, src, pth, dst, _mask, cand_ids, _cm, _w = batch
    return {"token_emb": torch.cat([src.reshape(-1), dst.reshape(-1),
                                    cand_ids.reshape(-1)]),
            "path_emb": pth.reshape(-1)}


def apply_vm_row_updates(params, opt_state, grads, batch, lr: float, *,
                         use_kernel: bool = True) -> Dict[str, int]:
    """Live-row Adam on both vocab tables from their dense gradients at
    the (already advanced) step count, in place. Returns U per table."""
    ids = vm_table_ids(batch)
    return {k: rows_from_dense(params[k], opt_state["rows"][k], grads[k],
                               ids[k], count=opt_state["count"], lr=lr,
                               use_kernel=use_kernel)
            for k in VM_TABLE_KEYS}


def vm_sparse_train_step(params, opt_state, batch, draws: StepDraws, *,
                         loss_fn: Callable, dense_opt: AdamF32Moments,
                         row_kernel: bool = True) -> torch.Tensor:
    """One sparse-row vm step, in place on `params` and `opt_state` (from
    init_vm_sparse_opt_state with the same `dense_opt`, whose learning
    rate is the tables' too). Returns the loss."""
    loss, grads, _view = dense_loss_and_grads(params, batch, draws, loss_fn)
    apply_dense_updates(params, opt_state, dense_opt,
                        {k: g for k, g in grads.items()
                         if k not in VM_TABLE_KEYS})
    apply_vm_row_updates(params, opt_state, grads, batch,
                         dense_opt.learning_rate, use_kernel=row_kernel)
    return loss


def make_vm_train_step(dims: ModelDims, optimizer, *,
                       compute_dtype=torch.float32, use_kernel: bool = True,
                       row_kernel: Optional[bool] = None,
                       sparse_updates: bool = False,
                       mesh=None) -> Callable:
    """Returns `step(params, opt_state, batch, draws) -> loss`, which
    updates params and opt_state in place; `step.cfg` is a
    DenseStepConfig without sampled softmax (what the draws read). The
    dense step takes `make_optimizer`'s optimizer (its
    state `optimizer.init(params)`); `sparse_updates=True` takes an
    `AdamF32Moments` and init_vm_sparse_opt_state's state.
    `use_kernel=False` runs the plain pool on any device; `row_kernel`
    (default: `use_kernel`) picks kernel 5 or its plain version. `mesh`
    builds this rank's data-parallel dense step; the sparse-row step
    refuses one, as the JAX package's does."""
    loss_fn = make_vm_loss_fn(dims, compute_dtype=compute_dtype,
                              use_kernel=use_kernel, mesh=mesh)
    if sparse_updates:
        if mesh is not None:
            raise ValueError(
                "--sparse_embeddings on the varmisuse head is "
                "single-device only; drop the flag for mesh runs")
        if not isinstance(optimizer, AdamF32Moments):
            raise TypeError("the sparse-row vm step takes AdamF32Moments, "
                            f"got {type(optimizer).__name__}")
        rows = use_kernel if row_kernel is None else row_kernel

        def step(params, opt_state, batch, draws):
            return vm_sparse_train_step(params, opt_state, batch, draws,
                                        loss_fn=loss_fn, dense_opt=optimizer,
                                        row_kernel=rows)
    else:
        def step(params, opt_state, batch, draws):
            return dense_train_step(params, opt_state, batch, draws,
                                    loss_fn=loss_fn, optimizer=optimizer,
                                    mesh=mesh)

    step.cfg = DenseStepConfig(compute_dtype=compute_dtype)
    return step


def vm_eval_step(params, batch, *, compute_dtype=torch.float32,
                 use_kernel: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (loss_sum 0-d, correct_sum 0-d, pred [B] int64): no dropout;
    the cross entropy and the hits weighted by the row weights."""
    labels, src, pth, dst, mask, cand_ids, cand_mask, weights = batch
    scores, _ = vm_scores(params, src, pth, dst, mask, cand_ids, cand_mask,
                          compute_dtype=compute_dtype, use_kernel=use_kernel)
    pred = torch.argmax(scores, dim=-1)
    correct = (pred == labels.to(torch.int64)).to(torch.float32)
    return ((candidate_ce(scores, labels) * weights).sum(),
            (correct * weights).sum(), pred)

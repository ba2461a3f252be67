"""The training step with sparse-row embedding updates.

Counterpart of `training/sparse_steps.py` in the JAX package. The three
vocab tables are differentiated at the gathered-row level: the rows are
gathered outside autograd and enter the loss as leaves, so backward
gives cotangents for the gathered [rows, E] blocks and never a dense
[V, E] table gradient. Those cotangents are deduplicated and summed into
a compact [U, E] gradient per table and applied by live-row Adam
(training/sparse_update.py: the hand-written CUDA kernels 5 and 6 on the
card). TRANSFORM and ATTENTION, and `target_emb` under full softmax
(whose logits touch every row anyway), take dense Adam with float32
moments (training/optimizers.py).

The step is split into the phases a caller may time or compare apart:
`prepare_step_inputs` (gathers), `loss_and_grads` (forward + backward),
`row_segments` (dedup + segment-sum), `apply_dense_updates` (dense Adam)
and `apply_row_updates` (the live-row apply); `sparse_train_step` runs
them in order. Unlike the JAX function, which donates its buffers and
returns new ones, the port updates the tables, dense params and moments
IN PLACE (java-large tables are not copied per step) and returns only
the loss, a 0-d device tensor; the step reads no value back to the host
apart from the unique counts `torch.unique` needs.

Orders that decide the segment sums are the JAX package's: token ids are
`src` then `dst`, target ids `labels` then `sampled`. Dropout is
concatenate -> cast to the compute dtype -> `where(keep, x / keep_rate,
0)`, the division in the compute dtype.

Randomness is drawn per step into a `StepDraws` (training/draws.py): the
[B, C, 3E] dropout keep mask, the [S] sampled ids and one uint32 salt
per int8 table. Tests pass draws made by the JAX side; without them the
step draws from a `torch.Generator` seeded from (seed, step).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from code2vec_tpu_torch.models.encoder import (ModelDims, apply_dropout,
                                               logits_vs_table, take_rows)
from code2vec_tpu_torch.ops.attention_kernel import attention_pool_train
from code2vec_tpu_torch.ops.sampled_softmax import (
    _log_expected_count, sampled_softmax_from_gathered)
from code2vec_tpu_torch.training.draws import StepDraws
from code2vec_tpu_torch.training.optimizers import AdamF32Moments
from code2vec_tpu_torch.training.sparse_adam import init_row_adam
from code2vec_tpu_torch.training.sparse_update import (adam_lr_t,
                                                       apply_rows,
                                                       dedup_segment_sum)


@dataclasses.dataclass(frozen=True)
class SparseStepConfig:
    """What the step needs besides dims: the JAX step's arguments."""
    learning_rate: float
    use_sampled_softmax: bool = False
    num_sampled: int = 4096
    compute_dtype: torch.dtype = torch.float32
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


def dense_keys(use_sampled_softmax: bool):
    keys = ["transform", "attention"]
    if not use_sampled_softmax:
        keys.append("target_emb")
    return keys


def init_sparse_opt_state(params, dense_opt: AdamF32Moments,
                          use_sampled_softmax: bool) -> dict:
    """{"dense": dense Adam state, "rows": {table: RowAdamState},
    "count": int32 0-d}, on the params' device."""
    dense = {k: params[k] for k in dense_keys(use_sampled_softmax)}
    rows = {"token_emb": init_row_adam(params["token_emb"]),
            "path_emb": init_row_adam(params["path_emb"])}
    if use_sampled_softmax:
        rows["target_emb"] = init_row_adam(params["target_emb"])
    return {"dense": dense_opt.init(dense), "rows": rows,
            "count": torch.zeros((), dtype=torch.int32,
                                 device=params["transform"].device)}


def prepare_step_inputs(params, batch, draws: StepDraws, *,
                        use_sampled_softmax: bool, num_sampled: int,
                        target_vocab: int):
    """The step's non-differentiated preliminaries and gathers ->
    (dense, gathered, ctx): the dense params and the gathered rows as
    autograd leaves (views of / copies from the tables, detached), and
    what the loss and the apply need."""
    labels, src, pth, dst, mask, weights = batch
    ctx = {"keep": draws.keep, "labels": labels, "mask": mask,
           "weights": weights}
    if use_sampled_softmax:
        S, V = num_sampled, target_vocab
        sampled = draws.sampled
        ctx["sampled"] = sampled
        ctx["true_corr"] = _log_expected_count(labels, S, V)       # [B]
        ctx["samp_corr"] = _log_expected_count(sampled, S, V)      # [S]
        ctx["accidental"] = sampled[None, :] == labels[:, None]    # [B, S]

    with torch.no_grad():
        gathered = {"src_e": take_rows(params, "token_emb", src),
                    "pth_e": take_rows(params, "path_emb", pth),
                    "dst_e": take_rows(params, "token_emb", dst)}
        if use_sampled_softmax:
            gathered["true_w"] = take_rows(params, "target_emb", labels)
            gathered["samp_w"] = take_rows(params, "target_emb",
                                           ctx["sampled"])
    for t in gathered.values():
        t.requires_grad_(True)
    dense = {k: params[k].detach().requires_grad_(True)
             for k in dense_keys(use_sampled_softmax)}
    return dense, gathered, ctx


def weighted_mean(values: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """sum(values * weights) / max(sum(weights), 1)."""
    denom = torch.clamp(weights.sum(), min=1.0)
    return (values * weights).sum() / denom


def make_gathered_loss(dims: ModelDims, ctx, *, use_sampled_softmax: bool,
                       compute_dtype, use_kernel: bool = True):
    """`loss_fn(dense, gathered)` over prepare_step_inputs' outputs: the
    function the step differentiates."""
    V = dims.target_vocab_size
    mask, weights = ctx["mask"], ctx["weights"]

    def loss_fn(dense, gathered):
        contexts = torch.cat(
            [gathered["src_e"], gathered["pth_e"], gathered["dst_e"]],
            dim=-1).to(compute_dtype)
        if dims.dropout_keep_rate < 1.0:
            contexts = apply_dropout(contexts, ctx["keep"],
                                     dims.dropout_keep_rate)
        code, _ = attention_pool_train(contexts, dense["transform"],
                                       dense["attention"], mask,
                                       use_kernel=use_kernel)
        if use_sampled_softmax:
            return sampled_softmax_from_gathered(
                code, gathered["true_w"], gathered["samp_w"],
                ctx["true_corr"], ctx["samp_corr"], ctx["accidental"],
                weights)
        logits = logits_vs_table(dense["target_emb"], code, V)
        per_ex = F.cross_entropy(logits, ctx["labels"].to(torch.int64),
                                 reduction="none")
        return weighted_mean(per_ex, weights)

    return loss_fn


def loss_and_grads(dims: ModelDims, cfg: SparseStepConfig, dense, gathered,
                   ctx, *, use_kernel: bool = True):
    """Forward + backward -> (loss 0-d, dense grads, gathered-row grads)."""
    loss_fn = make_gathered_loss(dims, ctx,
                                 use_sampled_softmax=cfg.use_sampled_softmax,
                                 compute_dtype=cfg.compute_dtype,
                                 use_kernel=use_kernel)
    with torch.enable_grad():
        loss = loss_fn(dense, gathered)
        keys_d, keys_g = list(dense), list(gathered)
        grads = torch.autograd.grad(
            loss, [dense[k] for k in keys_d] + [gathered[k] for k in keys_g])
    g_dense = dict(zip(keys_d, grads[:len(keys_d)]))
    g_rows = dict(zip(keys_g, grads[len(keys_d):]))
    return loss.detach(), g_dense, g_rows


def row_segments(dims: ModelDims, batch, ctx, g_rows
                 ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Dedup + segment-sum of each table's row cotangents ->
    {table: (uids [U], seg float32 [U, E])}, with the JAX package's
    concatenation orders."""
    labels, src, pth, dst, _mask, _weights = batch
    E = dims.embeddings_size
    parts = {
        "token_emb": [(src, g_rows["src_e"].reshape(-1, E)),
                      (dst, g_rows["dst_e"].reshape(-1, E))],
        "path_emb": [(pth, g_rows["pth_e"].reshape(-1, E))],
    }
    if "true_w" in g_rows:
        D = dims.code_vector_size
        parts["target_emb"] = [(labels, g_rows["true_w"].reshape(-1, D)),
                               (ctx["sampled"],
                                g_rows["samp_w"].reshape(-1, D))]
    out = {}
    for key, pairs in parts.items():
        ids = torch.cat([i.reshape(-1).to(torch.int32) for i, _g in pairs])
        grads = torch.cat([g for _i, g in pairs])
        out[key] = dedup_segment_sum(ids, grads)
    return out


def apply_dense_updates(params, opt_state, dense_opt: AdamF32Moments,
                        g_dense) -> None:
    """Advances the step count and applies dense Adam to the dense
    params, in place."""
    opt_state["count"].add_(1)
    dense_opt.step({k: params[k] for k in g_dense}, g_dense,
                   opt_state["dense"])


def apply_row_updates(params, opt_state, cfg: SparseStepConfig, segments,
                      salts: Dict[str, int], *, use_kernel: bool = True
                      ) -> None:
    """Live-row Adam on each table at the (already advanced) step count,
    in place: kernel 5 on float tables, kernel 6 on int8 tables."""
    lr_t = adam_lr_t(opt_state["count"], cfg.learning_rate, cfg.b1, cfg.b2)
    for key, (uids, seg) in segments.items():
        apply_rows(params[key], opt_state["rows"][key], uids, seg, lr_t=lr_t,
                   b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, salt=salts.get(key),
                   use_kernel=use_kernel)


def sparse_train_step(params, opt_state, batch, draws: StepDraws, *,
                      dims: ModelDims, cfg: SparseStepConfig,
                      dense_opt: AdamF32Moments,
                      use_kernel: bool = True) -> torch.Tensor:
    """One training step, in place on `params` and `opt_state` (from
    init_sparse_opt_state with the same `dense_opt`). `batch` is the
    tuple (labels [B], src/pth/dst [B, C], mask [B, C], weights [B]) on
    the params' device. `use_kernel=False` runs the plain pool and row
    apply on any device. Returns the loss (0-d float32 on the device)."""
    S = min(cfg.num_sampled, dims.target_vocab_size)
    dense, gathered, ctx = prepare_step_inputs(
        params, batch, draws, use_sampled_softmax=cfg.use_sampled_softmax,
        num_sampled=S, target_vocab=dims.target_vocab_size)
    loss, g_dense, g_rows = loss_and_grads(dims, cfg, dense, gathered, ctx,
                                           use_kernel=use_kernel)
    segments = row_segments(dims, batch, ctx, g_rows)
    apply_dense_updates(params, opt_state, dense_opt, g_dense)
    apply_row_updates(params, opt_state, cfg, segments, draws.salts,
                      use_kernel=use_kernel)
    return loss

"""The VarMisuse head: pointer-style variable-misuse repair.

Counterpart of `models/varmisuse.py` in the JAX package. A method with
one variable use replaced by the `slotvar` hole marker is extracted to
path-contexts as usual; its candidate variables (at most K, padded) are
embedded with the encoder's own token table, and the code vector of the
contexts queries a bilinear pointer:

    score_k = (code W) . token_emb[cand_k]    (-1e9 on a padded slot)

with a softmax over the K candidates and the cross entropy on the true
one. The head adds one float32 matrix, `vm_pointer` [D, E], to the
encoder's params; `target_emb` stays in the params (the checkpoint
layout is the JAX package's) and the loss never reads it.

The code vector comes from the bag encoder's `encode`: the attention
pool is the CUDA kernel (kernel 1) on the card and its plain version on
the CPU. The candidate rows go through `take_rows` (ops/scatter.py's
fixed-order backward), so their gradient lands in `token_emb`'s dense
gradient beside the source and target rows'. Dropout takes the step's
keep mask (training/draws.StepDraws), as the code2vec head's does.

Under a `mesh` whose model axis is above 1 each rank holds a window of
rows of the tables (parallel/sharding.py): `encode` gathers the contexts
from the windows, and the candidate rows go through `take_rows(...,
mesh)` (`sharding.take_window`: each rank's window rows summed over the
model group, with an identity backward), so every model peer scores the
same candidates and the gradient of a candidate row lands in the window
that owns it. `vm_pointer` replicates like `transform`: its gradient is
summed over the shard-replica group only (training/steps.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from code2vec_tpu_torch.models.encoder import (ModelDims, Params,
                                               _variance_scaling, encode,
                                               init_params, take_rows)
from code2vec_tpu_torch.training.sparse_steps import weighted_mean

# the hole marker; normal token normalization keeps it as it is
SLOT_TOKEN = "slotvar"


def init_vm_params(generator: torch.Generator, dims: ModelDims) -> Params:
    """The encoder's params plus the pointer matrix `vm_pointer` [D, E],
    float32, uniform with the fan-avg variance scaling of the JAX
    package's init (drawn after the encoder's params on `generator`)."""
    params = init_params(generator, dims)
    params["vm_pointer"] = _variance_scaling(
        generator, (dims.context_vector_size, dims.embeddings_size),
        torch.float32)
    return params


def vm_scores(params: Params, source_ids: torch.Tensor,
              path_ids: torch.Tensor, target_ids: torch.Tensor,
              mask: torch.Tensor, cand_ids: torch.Tensor,
              cand_mask: torch.Tensor, *, compute_dtype=torch.float32,
              use_kernel: bool = True, train: bool = False,
              keep: Optional[torch.Tensor] = None,
              dropout_keep_rate: float = 1.0, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate scores -> (scores [B, K] float32, -1e9 on padded
    candidates; attention [B, C] float32). `train=True` is the
    differentiable forward (the training pool, dropout with `keep` when
    `dropout_keep_rate` < 1). Under a row-sharded `mesh` the tables are
    the rank's windows (the module docstring)."""
    code, attn = encode(params, source_ids, path_ids, target_ids, mask,
                        compute_dtype=compute_dtype, use_kernel=use_kernel,
                        train=train, keep=keep,
                        dropout_keep_rate=dropout_keep_rate, mesh=mesh)
    cand = take_rows(params, "token_emb", cand_ids, mesh)    # [B, K, E]
    q = code.to(torch.float32) @ params["vm_pointer"]        # [B, E]
    scores = torch.einsum("be,bke->bk", q, cand.to(torch.float32))
    scores = torch.where(cand_mask > 0, scores,
                         torch.full((), -1e9, dtype=scores.dtype,
                                    device=scores.device))
    return scores, attn


def candidate_ce(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross entropy of the softmax over the candidates at the
    true candidate's index -> [B] float32."""
    logp = torch.log_softmax(scores, dim=-1)
    return -torch.gather(logp, 1, labels.to(torch.int64)[:, None])[:, 0]


def vm_loss(params: Params, batch, *, keep: Optional[torch.Tensor] = None,
            dropout_keep_rate: float = 1.0, compute_dtype=torch.float32,
            use_kernel: bool = True,
            denom: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Weighted-mean cross entropy over the candidates, differentiable:
    sum(ce * w) / max(sum(w), 1), or over `denom` (a data-parallel
    step's global one), the tables the rank's windows under a
    row-sharded `mesh`. `batch` = (labels [B], src, pth, dst [B, C],
    mask [B, C], cand_ids [B, K], cand_mask [B, K], weights [B]).
    Dropout applies when `keep` is given and the rate is below 1, as the
    JAX loss applies it when given a key."""
    labels, src, pth, dst, mask, cand_ids, cand_mask, weights = batch
    scores, _ = vm_scores(params, src, pth, dst, mask, cand_ids, cand_mask,
                          compute_dtype=compute_dtype, use_kernel=use_kernel,
                          train=True, keep=keep,
                          dropout_keep_rate=dropout_keep_rate
                          if keep is not None else 1.0, mesh=mesh)
    return weighted_mean(candidate_ce(scores, labels), weights, denom)

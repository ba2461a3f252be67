"""The random inputs of a training step, shared by the dense and the
sparse-row steps.

The JAX package draws a step's randomness from the step's key inside the
jitted step: the dropout keep mask, the sampled-softmax candidate ids,
one uint32 dither salt per int8 table and, under the rename defense
(`--adv_rename_prob`, attacks/defense.py), the augment's draws. JAX
threefry and torch's generators never agree, so the port takes these
as a `StepDraws`: tests
pass draws made on the JAX side exactly as its step makes them, and the
trainer draws them from generators seeded from (seed, step).

Under a mesh of R batch shards with local batch B, every rank draws at
the global batch R * B from the same generators and keeps its own rows
(parallel/sharding.batch_rows) of the keep mask and of the rename
draws, and under a ctx axis its own contexts of the keep mask
(parallel/sharding.context_cols); the rename draws are per row, so the
ranks of a ctx group share them. The ranks of a model group hold the
same rows and contexts, so they draw the same keep mask and rename
draws (their batch shard's and ctx window's). The sampled ids, the
salts and the rename's donor roll are the same on every rank. So a mesh
step sees the draws of the one-process step over the shards' batches
concatenated, dropout and the rename defense included
(`--adv_rename_mode batch` rolls its donors over the global batch:
attacks/defense.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from code2vec_tpu_torch.models.encoder import ModelDims
from code2vec_tpu_torch.ops.quant import QUANTIZED_TABLE_KEYS, is_quantized
from code2vec_tpu_torch.ops.sampled_softmax import log_uniform_sample


@dataclasses.dataclass
class StepDraws:
    """The random inputs of one step."""
    keep: Optional[torch.Tensor]    # bool [B, C, 3E]; None without dropout
    sampled: Optional[torch.Tensor]  # int32 [S]; None under full softmax
    salts: Dict[str, int]           # uint32 dither salt per int8 table
    # the rename defense's attacks.defense.RenameDraws; None without it
    rename: Optional[Any] = None


def quantized_keys(params) -> list:
    """The int8 tables, sorted (the order the salts are drawn in)."""
    return sorted(k for k in QUANTIZED_TABLE_KEYS if is_quantized(params[k]))


def make_draws(dims: ModelDims, cfg, params, batch_size: int, seed: int,
               step: int, device, mesh=None) -> StepDraws:
    """A step's draws from generators seeded from (seed, step): the keep
    mask and the sampled ids on `device`, the salts on the host, and the
    rename draws of the step's augment on `device` from a generator of
    their own (the other draws are those of a step without it). `cfg`
    is the step's config (its `use_sampled_softmax`, `num_sampled` and,
    for the dense step, `augment`). Under a `mesh`, the rows of this
    rank of the global batch's draws (see the module docstring)."""
    rows = cols = None
    if mesh is not None:
        from code2vec_tpu_torch.parallel.sharding import (batch_rows,
                                                          context_cols)
        rows = slice(*batch_rows(mesh, batch_size))
        cols = slice(*context_cols(mesh, dims.max_contexts))
        batch_size = batch_size * mesh.batch_shards
    ss = np.random.SeedSequence((seed, step))
    torch_seed, salt_seed, rename_seed = (
        int(x) for x in ss.generate_state(3, np.uint64))
    gen = torch.Generator(device=device).manual_seed(torch_seed >> 1)
    keep = None
    if dims.dropout_keep_rate < 1.0:
        shape = (batch_size, dims.max_contexts, dims.context_vector_size)
        keep = torch.rand(shape, generator=gen, device=device) \
            < dims.dropout_keep_rate
        if rows is not None:
            keep = keep[rows, cols].contiguous()
    sampled = None
    if cfg.use_sampled_softmax:
        S = min(cfg.num_sampled, dims.target_vocab_size)
        sampled = log_uniform_sample(gen, S, dims.target_vocab_size)
    qkeys = quantized_keys(params)
    salts = np.random.default_rng(salt_seed).integers(
        0, 2 ** 32, size=len(qkeys), dtype=np.uint64)
    rename = None
    augment = getattr(cfg, "augment", None)
    if augment is not None:
        rgen = torch.Generator(device=device).manual_seed(rename_seed >> 1)
        rename = augment.draw(rgen, batch_size, dims.max_contexts)
        if rows is not None:
            rename = dataclasses.replace(
                rename, gumbel=rename.gumbel[rows].contiguous(),
                index=rename.index[rows].contiguous(),
                apply_u=rename.apply_u[rows].contiguous(),
                rows=(rows.start, rows.stop), ctx=mesh.ctx)
    return StepDraws(keep=keep, sampled=sampled,
                     salts={k: int(s) for k, s in zip(qkeys, salts)},
                     rename=rename)

"""The path-context encoder as plain functions over a params dict.

Counterpart of `models/encoder.py` in the JAX package, with the same
param names: `token_emb` [Vt, E], `path_emb` [Vp, E], `target_emb`
[Vy, D], `transform` [D, D], `attention` [D], D = 3E. Forward: three
embedding gathers -> concat to [B, C, D] -> attention pool (the CUDA
kernel, or the plain version) -> code vector -> logits against
`target_emb`. The vocab tables are stored in `ModelDims.tables_dtype`;
`transform` and `attention` stay float32. `encode(train=True)` is the
training forward: dropout with a keep mask drawn by the caller
(training/draws.py) and the differentiable pool (kernel forward,
plain-recompute backward on the card).

`ModelDims.encoder_type` picks the encoder: "bag" (`encode`) or
"transformer" (models/transformer_encoder.py, whose params sit under
`params["xf"]` beside the tables); `get_encode_fn` returns the one to
call, with `encode`'s signature.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from code2vec_tpu_torch.ops.attention import attention_pool
from code2vec_tpu_torch.ops.attention_kernel import (attention_pool_fused,
                                                     attention_pool_train)
from code2vec_tpu_torch.ops.logits import rows_product_f32
from code2vec_tpu_torch.ops.quant import (QUANTIZED_TABLE_KEYS,
                                          dequantized_rows, quantize_table,
                                          quantized_take)
from code2vec_tpu_torch.ops.scatter import take_rows_det

Table = Union[torch.Tensor, Dict[str, torch.Tensor]]
Params = Dict[str, Table]

_TABLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """Static model dimensions (the JAX package's fields and defaults)."""
    token_vocab_size: int
    path_vocab_size: int
    target_vocab_size: int
    embeddings_size: int = 128
    max_contexts: int = 200
    dropout_keep_rate: float = 0.75
    # row padding of the vocab tables to a multiple of this
    vocab_pad_multiple: int = 1
    # storage dtype of the three vocab tables ("float32" | "bfloat16" |
    # "int8"); with "int8" the token/path tables are int8 rows plus
    # per-row float32 scales and target_emb is bf16
    tables_dtype: str = "float32"
    # "bag" (the attention pool) or "transformer" (a set transformer over
    # the contexts, models/transformer_encoder.py)
    encoder_type: str = "bag"
    xf_layers: int = 2
    xf_heads: int = 3
    xf_mlp_ratio: int = 4
    # recompute each transformer layer in the backward pass
    xf_remat: bool = False
    # needs a mesh with a context axis, which the port has not: ignored
    ring_attention: bool = False

    @property
    def context_vector_size(self) -> int:
        return 3 * self.embeddings_size

    @property
    def code_vector_size(self) -> int:
        return self.context_vector_size

    def padded(self, n: int) -> int:
        m = self.vocab_pad_multiple
        return ((n + m - 1) // m) * m


def _variance_scaling(generator: torch.Generator, shape, dtype
                      ) -> torch.Tensor:
    """Uniform in [-l, l], l = sqrt(3 / fan_avg) (scale 1, "fan_avg"),
    with fan_in, fan_out = shape[-2], shape[-1], drawn in float32."""
    fan_avg = (shape[-2] + shape[-1]) / 2.0
    limit = math.sqrt(3.0 / fan_avg)
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    t.uniform_(-limit, limit, generator=generator)
    return t.to(dtype)


def init_params(generator: torch.Generator, dims: ModelDims,
                dtype=torch.float32) -> Params:
    """Variance-scaled init on `generator`'s device. The vocab tables are
    stored in dims.tables_dtype; `transform` and `attention` in `dtype`;
    the transformer's "xf" subtree (float32) is added for that encoder.
    The numbers differ from the JAX package's for the same seed (another
    generator); carry weights across with convert.py instead."""
    if dims.encoder_type not in ("bag", "transformer"):
        raise ValueError(f"unknown encoder {dims.encoder_type!r}")
    E = dims.embeddings_size
    D = dims.context_vector_size
    quantized = dims.tables_dtype == "int8"
    t_dtype = torch.bfloat16 if quantized else _TABLE_DTYPES[dims.tables_dtype]
    g = generator
    params: Params = {
        "token_emb": _variance_scaling(
            g, (dims.padded(dims.token_vocab_size), E), t_dtype),
        "path_emb": _variance_scaling(
            g, (dims.padded(dims.path_vocab_size), E), t_dtype),
        "target_emb": _variance_scaling(
            g, (dims.padded(dims.target_vocab_size), D), t_dtype),
        "transform": _variance_scaling(g, (D, D), dtype),
        "attention": _variance_scaling(g, (D, 1), dtype)[:, 0].contiguous(),
    }
    if quantized:
        for k in QUANTIZED_TABLE_KEYS:
            params[k] = quantize_table(params[k])
    if dims.encoder_type == "transformer":
        # imported here: transformer_encoder imports this module
        from code2vec_tpu_torch.models.transformer_encoder import \
            init_xf_params
        params["xf"] = init_xf_params(g, dims)
    return params


def take_rows(params: Params, name: str, ids: torch.Tensor) -> torch.Tensor:
    """Embedding-row gather that understands the three table storages: a
    float table (differentiable: its gradient is a dense scatter-add in
    a fixed order, ops/scatter.py), an
    int8 {"q", "s"} table (a no-grad dequantizing gather, bf16 output:
    int8 rows carry at most 8 significant bits), and an int8 table with a
    gradient carrier "g" attached by the quantized training step (the
    straight-through gather of ops/quant.py)."""
    t = params[name]
    if isinstance(t, dict):
        if "g" in t:
            return quantized_take(t["g"], t, ids)
        return dequantized_rows(t, ids)
    return take_rows_det(t, ids)


def gather_contexts(params: Params, source_ids: torch.Tensor,
                    path_ids: torch.Tensor, target_ids: torch.Tensor,
                    compute_dtype=torch.float32) -> torch.Tensor:
    """[B, C] ids -> [B, C, D] context vectors in the compute dtype."""
    src = take_rows(params, "token_emb", source_ids)
    pth = take_rows(params, "path_emb", path_ids)
    dst = take_rows(params, "token_emb", target_ids)
    return torch.cat([src, pth, dst], dim=-1).to(compute_dtype)


def apply_dropout(contexts: torch.Tensor, keep: torch.Tensor,
                  keep_rate: float) -> torch.Tensor:
    """where(keep, x / keep_rate, 0), the division in the contexts' dtype
    (the rate rounded to it first, as JAX does with a Python scalar)."""
    rate = torch.full((), keep_rate, dtype=contexts.dtype,
                      device=contexts.device)
    return torch.where(keep, contexts / rate, torch.zeros_like(rate))


def encode(params: Params, source_ids: torch.Tensor, path_ids: torch.Tensor,
           target_ids: torch.Tensor, mask: torch.Tensor, *,
           compute_dtype=torch.float32, use_kernel: bool = True,
           train: bool = False, keep: Optional[torch.Tensor] = None,
           dropout_keep_rate: float = 1.0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward to the code vector.

    Args: [B, C] int ids for source token / path / target token, [B, C]
    float32 mask. Returns (code_vectors [B, D] in the compute dtype,
    attention [B, C] float32). `use_kernel` pools with the fused kernel
    (float32 inside, as the Pallas kernel it replaces), else with the
    plain version in the compute dtype. `train=True` drops out the
    contexts where the bool mask `keep` [B, C, D] is False (when
    `dropout_keep_rate` < 1) and pools with the differentiable training
    pool (`attention_pool_train`: the kernel forward on the card, the
    plain pool on the CPU).
    """
    contexts = gather_contexts(params, source_ids, path_ids, target_ids,
                               compute_dtype)
    if train:
        if dropout_keep_rate < 1.0:
            contexts = apply_dropout(contexts, keep, dropout_keep_rate)
        return attention_pool_train(contexts, params["transform"],
                                    params["attention"], mask,
                                    use_kernel=use_kernel)
    if use_kernel:
        code, attn = attention_pool_fused(
            contexts, params["transform"], params["attention"], mask)
        return code.to(compute_dtype), attn
    return attention_pool(contexts, params["transform"],
                          params["attention"], mask)


def get_encode_fn(dims: ModelDims) -> Callable:
    """The encode function of dims.encoder_type, with `encode`'s
    signature: `encode` itself for the bag, `encode_transformer` bound to
    `dims` for the transformer."""
    if dims.encoder_type == "transformer":
        from code2vec_tpu_torch.models.transformer_encoder import \
            encode_transformer
        return functools.partial(encode_transformer, dims=dims)
    return encode


def unused_param_keys(dims: ModelDims) -> Tuple[str, ...]:
    """The top-level params the encoder of dims.encoder_type never reads:
    the bag pool's `transform` and `attention` under the transformer
    (`init_params` makes them for either encoder, as the JAX package's
    does). The dense step gives these zero gradients, as `jax.grad` does,
    and every other leaf must get one from the loss."""
    if dims.encoder_type == "transformer":
        return ("transform", "attention")
    return ()


def logits_vs_table(table: torch.Tensor, code_vectors: torch.Tensor,
                    true_target_vocab_size: Optional[int] = None
                    ) -> torch.Tensor:
    """[B, V] float32 logits against a (possibly row-padded) target table,
    the product never rounded to the compute dtype (the jitted JAX
    function's, ops/logits.py). Padding rows are set to -1e9 so they
    never win top-k."""
    logits = rows_product_f32(code_vectors, table)
    if (true_target_vocab_size is not None
            and true_target_vocab_size < table.shape[0]):
        col = torch.arange(table.shape[0], device=logits.device)
        logits = torch.where(col[None, :] < true_target_vocab_size, logits,
                             -1e9)
    return logits


def full_logits(params: Params, code_vectors: torch.Tensor,
                true_target_vocab_size: Optional[int] = None) -> torch.Tensor:
    return logits_vs_table(params["target_emb"], code_vectors,
                           true_target_vocab_size)

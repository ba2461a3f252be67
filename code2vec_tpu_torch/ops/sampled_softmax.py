"""Sampled softmax over a large target vocabulary: the candidate sampler,
the log-expected-count correction and the loss.

A copy of `ops/sampled_softmax.py` in the JAX package, under the same
names and with `tf.nn.sampled_softmax_loss`'s semantics:

- candidates are log-uniform over [0, V): P(k) = log((k+2)/(k+1)) /
  log(V+1), drawn UNIQUE (TF's unique=True) by the Gumbel-top-k trick,
  one shared candidate set per step;
- the correction subtracts log(expected count) from each candidate's
  and the true class's logit, with the deterministic effective draw
  count `_effective_num_tries` solved once on the host per (S, V).

- sampled negatives equal to an example's label are masked to -1e9
  (TF's remove_accidental_hits=True).

The Gumbel noise comes from a `torch.Generator`, so the ids differ from
the JAX package's for the same seed; tests hand both sides the same ids,
and `sampled_softmax_loss` takes the step's sampled ids instead of a key.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from code2vec_tpu_torch.ops.logits import gathered_logits_f32
from code2vec_tpu_torch.parallel.sharding import take_window


def _log_uniform_log_probs(vocab_size: int, device=None) -> torch.Tensor:
    """Per-class log-pmf of the log-uniform distribution, float32 [V]."""
    k = torch.arange(vocab_size, dtype=torch.float32, device=device)
    log_v = torch.log(torch.tensor(float(vocab_size + 1), dtype=torch.float32,
                                   device=device))
    return torch.log(torch.log1p(1.0 / (k + 1.0)) / log_v)


def log_uniform_sample(generator: torch.Generator, num_sampled: int,
                       vocab_size: int) -> torch.Tensor:
    """`num_sampled` UNIQUE class ids from the log-uniform distribution
    over [0, vocab_size), int32 [S] on the generator's device, by
    Gumbel-top-k (exact sampling without replacement)."""
    dev = generator.device
    if num_sampled >= vocab_size:
        return torch.arange(vocab_size, dtype=torch.int32, device=dev)
    u = torch.rand((vocab_size,), generator=generator, dtype=torch.float32,
                   device=dev).clamp_min_(torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    scores = _log_uniform_log_probs(vocab_size, dev) + gumbel
    return torch.topk(scores, num_sampled).indices.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _effective_num_tries(num_sampled: int, vocab_size: int) -> float:
    """Deterministic stand-in for TF's stochastic num_tries: the T such
    that the expected number of distinct classes in T with-replacement
    log-uniform draws equals num_sampled. Newton's method on the host;
    cached per static (S, V)."""
    k = np.arange(vocab_size, dtype=np.float64)
    log1m_p = np.log1p(-(np.log1p(1.0 / (k + 1.0)) /
                         np.log(float(vocab_size + 1))))
    T = float(num_sampled)
    for _ in range(100):
        f = np.sum(-np.expm1(T * log1m_p)) - num_sampled
        df = np.sum(-log1m_p * np.exp(T * log1m_p))
        step = f / df
        T -= step
        if abs(step) < 1e-9:
            break
    return T


def _log_expected_count(ids: torch.Tensor, num_sampled: int,
                        vocab_size: int) -> torch.Tensor:
    """float32 log(expected count) of each class id in `ids`."""
    k = ids.to(torch.float32)
    log_v = torch.log(torch.tensor(float(vocab_size + 1), dtype=torch.float32,
                                   device=ids.device))
    p = torch.log1p(1.0 / (k + 1.0)) / log_v
    if num_sampled >= vocab_size:
        # exhaustive candidate set: every class appears exactly once
        return torch.zeros_like(p)
    T = _effective_num_tries(num_sampled, vocab_size)
    return torch.log(-torch.expm1(T * torch.log1p(-p)))


def sampled_softmax_from_gathered(
        code_vectors: torch.Tensor, true_w: torch.Tensor,
        samp_w: torch.Tensor, true_corr: torch.Tensor,
        samp_corr: torch.Tensor, accidental: torch.Tensor,
        example_weights: Optional[torch.Tensor] = None,
        denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The loss core over pre-gathered target rows: code [B, D], true_w
    [B, D], samp_w [S, D], corrections [B] / [S], accidental [B, S]
    collisions, optional [B] example weights -> the scalar mean loss
    (over `denom` in place of max(sum(weights), 1) when given: a
    data-parallel step's global denominator)."""
    # the jitted JAX step's rounding (ops/logits.py): the true logits
    # rounded once to the compute dtype, the sampled ones never
    true_logits, sampled_logits = gathered_logits_f32(code_vectors, true_w,
                                                      samp_w)
    true_logits = true_logits - true_corr
    sampled_logits = sampled_logits - samp_corr[None, :]
    sampled_logits = torch.where(accidental, -1e9, sampled_logits)
    logits = torch.cat([true_logits[:, None], sampled_logits], dim=1)
    per_example = -torch.log_softmax(logits, dim=-1)[:, 0]
    if example_weights is not None:
        if denom is None:
            denom = torch.clamp(example_weights.sum(), min=1.0)
        return (per_example * example_weights).sum() / denom
    return per_example.mean()


def sampled_softmax_loss(target_table: torch.Tensor,
                         code_vectors: torch.Tensor, labels: torch.Tensor,
                         sampled: torch.Tensor, num_sampled: int,
                         example_weights: Optional[torch.Tensor] = None,
                         vocab_size: Optional[int] = None,
                         denom: Optional[torch.Tensor] = None,
                         mesh=None) -> torch.Tensor:
    """The sampled-softmax loss against a [V_padded, D] target table,
    with the step's sampled ids [S] drawn from [0, vocab_size). The two
    row gathers are differentiable: the table's gradient is the sum of
    their dense scatter-adds, each in a fixed order (ops/scatter.py).
    Under a row-sharded `mesh` the table is the rank's window and the
    true and sampled rows come through `sharding.take_window` (the
    window's rows summed over the model group); the sampled ids are the
    same on every rank."""
    if vocab_size is None:
        vocab_size = target_table.shape[0]
    num_sampled = min(num_sampled, vocab_size)
    return sampled_softmax_from_gathered(
        code_vectors,
        true_w=take_window(target_table, labels, mesh),
        samp_w=take_window(target_table, sampled, mesh),
        true_corr=_log_expected_count(labels, num_sampled, vocab_size),
        samp_corr=_log_expected_count(sampled, num_sampled, vocab_size),
        accidental=sampled[None, :] == labels[:, None],
        example_weights=example_weights, denom=denom)

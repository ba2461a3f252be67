"""Sampled softmax over a large target vocabulary: the candidate sampler
and the log-expected-count correction.

A copy of the parts of `ops/sampled_softmax.py` in the JAX package that
the sparse-row training step needs, under the same names and with
`tf.nn.sampled_softmax_loss`'s semantics:

- candidates are log-uniform over [0, V): P(k) = log((k+2)/(k+1)) /
  log(V+1), drawn UNIQUE (TF's unique=True) by the Gumbel-top-k trick,
  one shared candidate set per step;
- the correction subtracts log(expected count) from each candidate's
  and the true class's logit, with the deterministic effective draw
  count `_effective_num_tries` solved once on the host per (S, V).

The Gumbel noise comes from a `torch.Generator`, so the ids differ from
the JAX package's for the same seed; tests hand both sides the same ids.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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

"""Adversarial-input detection via attention-weighted token rarity.

Counterpart of `attacks/detect.py` in the JAX package (the detection
defense of "Adversarial Examples for Models of Code", Yefet, Alon &
Yahav 2020): adversarially-chosen names are *outliers* — the gradient
search draws them from the whole vocabulary, so they are mostly rare in
training data, while the attack works by making the model ATTEND to
them. Both signals are in the predict path:

    score(method) = sum_j  attn_j * rarity_j
    rarity_j      = max(-log p(src_j), -log p(dst_j))   (add-one
                    smoothed over the training token histogram; OOV is
                    maximally rare)

A clean method concentrates attention on common, task-bearing tokens
(low score); an attacked one attends to a rare renamed token (high
score). Calibrate the threshold on clean data at a chosen false-positive
rate. The attention is the encoder's: kernel 1's `attn` output on the
card (the plain pool's on CPU tensors, or with `use_kernel=False`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from code2vec_tpu_torch.device import resolve_device
from code2vec_tpu_torch.models.encoder import ModelDims, get_encode_fn
from code2vec_tpu_torch.vocab.vocabularies import Vocab, read_token_counts


def load_token_counts(dict_path: str) -> Dict[str, int]:
    """Token histogram from the dataset's `.dict.c2v` (only the token
    dict is read; the path and target dicts are skipped)."""
    return read_token_counts(dict_path)


class RarityDetector:
    @classmethod
    def from_model(cls, model, dict_path: str) -> "RarityDetector":
        """Build for a predict-side model (`Code2VecModel`) from its
        dataset's `.dict.c2v`, on the model's device and kernels."""
        return cls(model.dims, model.vocabs.token_vocab,
                   load_token_counts(dict_path),
                   compute_dtype=model.compute_dtype, device=model.device,
                   use_kernel=model.use_kernel)

    def __init__(self, dims: ModelDims, token_vocab: Vocab,
                 token_counts: Dict[str, int], *,
                 compute_dtype=torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 use_kernel: bool = True):
        rows = dims.padded(dims.token_vocab_size)
        total = sum(token_counts.values()) + rows  # add-one smoothing
        rarity = np.full((rows,), -np.log(1.0 / total), np.float32)
        counts = np.zeros((rows,), np.int64)
        for idx, word in enumerate(token_vocab.to_word_list()):
            c = token_counts.get(word, 0)
            rarity[idx] = -np.log((c + 1.0) / total)
            counts[idx] = c
        rarity[token_vocab.pad_index] = 0.0  # masked out anyway
        self.rarity = rarity
        # per-row train counts, kept for the replacement-frequency
        # mechanism report (evaluate_robustness: is the attack choosing
        # rare-but-strong or common-but-weak replacements?)
        self.counts = counts
        self.token_vocab = token_vocab
        self.device = resolve_device(device)
        self._encode = get_encode_fn(dims)
        self._compute_dtype = compute_dtype
        self._use_kernel = use_kernel

    _CHUNK = 64  # the sweep's batch of methods

    @torch.no_grad()
    def _attn(self, params, src, pth, dst, mask) -> np.ndarray:
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        _, attn = self._encode(params, dev(src), dev(pth), dev(dst),
                               dev(mask), compute_dtype=self._compute_dtype,
                               use_kernel=self._use_kernel)
        return attn.cpu().numpy()

    def score_batch(self, params, methods) -> np.ndarray:
        """Attention-weighted rarity of M tensorized methods, [M], in
        chunks of 64 methods (a short last chunk padded with its last
        method; a single method runs alone — the serving path must not
        pay 64x encode work per prediction)."""
        chunk = 1 if len(methods) == 1 else self._CHUNK
        out = []
        for lo in range(0, len(methods), chunk):
            part = list(methods[lo:lo + chunk])
            pad = chunk - len(part)
            part += [part[-1]] * pad
            src = np.stack([np.asarray(m[0]) for m in part])
            pth = np.stack([np.asarray(m[1]) for m in part])
            dst = np.stack([np.asarray(m[2]) for m in part])
            mask = np.stack([np.asarray(m[3]) for m in part])
            attn = self._attn(params, src, pth, dst, mask)
            rar = np.maximum(self.rarity[src], self.rarity[dst])
            scores = np.sum(attn * rar * (mask > 0), axis=1)
            out.extend(scores[:chunk - pad])
        return np.asarray(out)

    def score(self, params, method: Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]
              ) -> float:
        """Attention-weighted rarity of one tensorized method."""
        return float(self.score_batch(params, [method])[0])

    @staticmethod
    def calibrate(clean_scores: np.ndarray, fpr: float = 0.05) -> float:
        """Threshold flagging the top `fpr` fraction of CLEAN scores."""
        return float(np.quantile(np.asarray(clean_scores), 1.0 - fpr))


def auc(clean_scores: np.ndarray, attack_scores: np.ndarray) -> float:
    """Rank AUC (tie-corrected Mann-Whitney): P(attack > clean).
    O(n log n) via average ranks — no pairwise matrix."""
    c = np.asarray(clean_scores, np.float64)
    a = np.asarray(attack_scores, np.float64)
    if len(c) == 0 or len(a) == 0:
        return float("nan")
    scores = np.concatenate([c, a])
    _, inv, cnt = np.unique(scores, return_inverse=True,
                            return_counts=True)
    avg_rank = np.cumsum(cnt) - (cnt - 1) / 2.0  # 1-based, tie-averaged
    ranks = avg_rank[inv]
    u = ranks[len(c):].sum() - len(a) * (len(a) + 1) / 2.0
    return float(u / (len(a) * len(c)))

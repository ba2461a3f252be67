"""Host-side parsing: `.c2v` path-context rows -> int32 index arrays + mask.

A copy of `parse_c2v_rows` and `_pad_batch` from `data/reader.py` in the
JAX package. The over-cap downsample draws from the same
`np.random.default_rng((seed, crc32(sorted bag)))` stream, so both
packages keep the same contexts of a method with more than
MAX_CONTEXTS of them.
"""

from __future__ import annotations

import zlib
from typing import List

import numpy as np

from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs


def parse_c2v_rows(lines: List[str], vocabs: Code2VecVocabs,
                   max_contexts: int, keep_strings: bool = False,
                   sample_seed: int = 0):
    """Parse `.c2v` rows into index arrays.

    A context field is `left,path,right`; empty ('' or ',,') fields are
    padding (PAD index, mask 0). OOV words map to the OOV index. Rows with
    more than `max_contexts` contexts (raw extractor output on the predict
    path) are downsampled uniformly without replacement, seeded for
    reproducible predictions.

    Returns (labels [N], src [N, C], pth [N, C], dst [N, C] int32,
    mask [N, C] float32, target_strings, context_strings).
    """
    n = len(lines)
    tok_v, path_v, tgt_v = (vocabs.token_vocab, vocabs.path_vocab,
                            vocabs.target_vocab)
    labels = np.zeros((n,), dtype=np.int32)
    src = np.full((n, max_contexts), tok_v.pad_index, dtype=np.int32)
    pth = np.full((n, max_contexts), path_v.pad_index, dtype=np.int32)
    dst = np.full((n, max_contexts), tok_v.pad_index, dtype=np.int32)
    mask = np.zeros((n, max_contexts), dtype=np.float32)
    target_strings: List[str] = []
    context_strings: List[List[str]] = []
    for i, line in enumerate(lines):
        parts = line.rstrip("\n").split(" ")
        target = parts[0]
        labels[i] = tgt_v.lookup_index(target)
        ctxs = parts[1:]
        if len(ctxs) > max_contexts:
            # only REAL contexts compete for the max_contexts slots
            real = [c for c in ctxs if c and c != ",,"]
            if len(real) > max_contexts:
                # sample from the row's SORTED bag with a seed derived from
                # that bag, so a method keeps the same contexts wherever
                # and in whatever order it appears (the serving cache is
                # keyed by exactly this bag); the bag encoder is
                # order-invariant, so emitting in sorted order loses nothing
                canon = sorted(real)
                rng = np.random.default_rng(
                    (sample_seed,
                     zlib.crc32(" ".join(canon).encode("utf-8"))))
                pick = np.sort(rng.choice(len(canon), size=max_contexts,
                                          replace=False))
                real = [canon[k] for k in pick]
            ctxs = real
        if keep_strings:
            target_strings.append(target)
            context_strings.append(ctxs)
        for j, ctx in enumerate(ctxs):
            if not ctx or ctx == ",,":
                continue
            fields = ctx.split(",")
            if len(fields) != 3 or not fields[1]:
                continue
            src[i, j] = tok_v.lookup_index(fields[0])
            pth[i, j] = path_v.lookup_index(fields[1])
            dst[i, j] = tok_v.lookup_index(fields[2])
            mask[i, j] = 1.0
    return labels, src, pth, dst, mask, target_strings, context_strings


def _pad_batch(arrs, batch_size: int):
    """Pad along axis 0 to `batch_size` with zero / PAD rows."""
    out = []
    for a in arrs:
        pad = batch_size - a.shape[0]
        if pad > 0:
            a = np.concatenate(
                [a, np.zeros((pad,) + a.shape[1:], dtype=a.dtype)], axis=0)
        out.append(a)
    return out

"""Host-side parsing: `.c2v` path-context rows -> int32 index arrays + mask.

A copy of `BatchTensors`, `parse_c2v_rows`, `_pad_batch`,
`count_examples` (text files only) and `C2VTextReader` from
`data/reader.py` in the JAX package. The over-cap
downsample draws from the same `np.random.default_rng((seed,
crc32(sorted bag)))` stream, so both packages keep the same contexts of
a method with more than MAX_CONTEXTS of them, and the reader's shuffle
is the same `(seed + epoch)` permutation, so both packages see the same
batches. Host shards are not ported.
"""

from __future__ import annotations

import zlib
from typing import Iterator, List, NamedTuple, Optional

import numpy as np

from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs


class BatchTensors(NamedTuple):
    """One host batch. Shapes are static: [B] / [B, C]."""
    target_index: np.ndarray            # int32 [B]
    path_source_token_indices: np.ndarray  # int32 [B, C]
    path_indices: np.ndarray            # int32 [B, C]
    path_target_token_indices: np.ndarray  # int32 [B, C]
    context_valid_mask: np.ndarray      # float32 [B, C]; 1.0 = real context
    num_valid_examples: int             # <= B; B unless final padded batch
    target_strings: Optional[List[str]] = None
    context_strings: Optional[List[List[str]]] = None

    def host_arrays(self):
        """The step's 6-tuple (labels, src, pth, dst, mask, weights);
        example weights are 1 for the valid rows, 0 for the padding."""
        weights = np.zeros((self.target_index.shape[0],), dtype=np.float32)
        weights[:self.num_valid_examples] = 1.0
        return (self.target_index, self.path_source_token_indices,
                self.path_indices, self.path_target_token_indices,
                self.context_valid_mask, weights)


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


def count_examples(path: str) -> int:
    """Number of examples (non-empty lines) in a `.c2v` file: what sizes
    a learning-rate schedule."""
    with open(path, "rb") as f:
        return sum(1 for raw in f if raw.strip())


class C2VTextReader:
    """Reader over a `.c2v` text file: byte-offset streaming (the file is
    never held in memory), a `(seed + epoch)` shuffle, padded batches."""

    def __init__(self, path: str, vocabs: Code2VecVocabs, max_contexts: int,
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 keep_strings: bool = False, epoch_offset: int = 0):
        self.path = path
        self.vocabs = vocabs
        self.max_contexts = max_contexts
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.keep_strings = keep_strings
        self._epoch = epoch_offset
        self._offsets: Optional[np.ndarray] = None

    def _line_offsets(self) -> np.ndarray:
        """Byte offsets of non-empty lines (built once)."""
        if self._offsets is None:
            offsets = []
            with open(self.path, "rb") as f:
                pos = 0
                for raw in f:
                    if raw.strip():
                        offsets.append(pos)
                    pos += len(raw)
            self._offsets = np.asarray(offsets, dtype=np.int64)
        return self._offsets

    def __iter__(self) -> Iterator[BatchTensors]:
        offsets = self._line_offsets()
        order = np.arange(len(offsets))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
            self._epoch += 1
        with open(self.path, "r", encoding="utf-8", errors="replace") as f:
            for start in range(0, len(order), self.batch_size):
                idx = order[start:start + self.batch_size]
                batch_lines = []
                for off in offsets[idx]:
                    f.seek(off)
                    batch_lines.append(f.readline())
                yield self._parse_batch(batch_lines)

    def _parse_batch(self, batch_lines: List[str]) -> BatchTensors:
        labels, src, pth, dst, mask, tstr, cstr = parse_c2v_rows(
            batch_lines, self.vocabs, self.max_contexts, self.keep_strings)
        nv = len(batch_lines)
        labels, src, pth, dst, mask = _pad_batch(
            (labels, src, pth, dst, mask), self.batch_size)
        return BatchTensors(labels, src, pth, dst, mask, nv,
                            tstr if self.keep_strings else None,
                            cstr if self.keep_strings else None)

"""Host-side input: `.c2v` text or binary shards -> int32 index arrays + mask.

A copy of `data/reader.py` in the JAX package: `BatchTensors`,
`parse_c2v_rows`, the text reader `C2VTextReader`, the binary-shard
reader `BinaryShardReader` over data/binarize.py's memmapped int32
rows, `open_reader` (the binary shard when a `.bin` sibling exists),
`count_examples` and `steps_per_epoch`. The over-cap downsample draws
from the same `np.random.default_rng((seed, crc32(sorted bag)))` stream,
so both packages keep the same contexts of a method with more than
MAX_CONTEXTS of them; each epoch's shuffle is the same `(seed + epoch)`
permutation, and the binary reader sorts the rows inside each batch as
the JAX package's does, so both packages see the same batches in the
same row order (and so draw dropout for the same rows). `epoch_offset`
starts the shuffle stream at a later epoch (an auto-resumed run replays
the data order of the run it continues).

The port feeds one device from one process: the readers take
`host_shard` / `num_host_shards` as the JAX package's do, but only
`0 / 1`.
"""

from __future__ import annotations

import json
import os
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


def _aligned_num_batches(global_examples: int, num_host_shards: int,
                         batch_size: int) -> int:
    """Batches every host emits an epoch: ceil(ceil(N / H) / B)."""
    largest_shard = -(-global_examples // num_host_shards)
    return -(-largest_shard // batch_size)


def steps_per_epoch(num_examples: int, batch_size: int,
                    num_host_shards: int = 1) -> int:
    """Train steps one epoch takes (the last batch padded): a resume
    divides a restored step count by this to recover its epochs."""
    return _aligned_num_batches(num_examples, num_host_shards, batch_size)


def _one_host(host_shard: int, num_host_shards: int) -> None:
    if (host_shard, num_host_shards) != (0, 1):
        raise ValueError(
            f"host shard {host_shard} of {num_host_shards}: the port reads "
            "on one host (host_shard 0 of 1)")


class C2VTextReader:
    """Reader over a `.c2v` text file: byte-offset streaming (the file is
    never held in memory), a `(seed + epoch)` shuffle, padded batches."""

    def __init__(self, path: str, vocabs: Code2VecVocabs, max_contexts: int,
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 keep_strings: bool = False, host_shard: int = 0,
                 num_host_shards: int = 1, epoch_offset: int = 0):
        _one_host(host_shard, num_host_shards)
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


class BinaryShardReader:
    """Reader over the pre-tokenized int32 shard data/binarize.py writes:
    a memmapped [N, 1 + 3*C] int32 matrix (label, src*C, path*C, tgt*C)
    and its JSON manifest."""

    def __init__(self, prefix: str, batch_size: int, shuffle: bool = False,
                 seed: int = 0, host_shard: int = 0,
                 num_host_shards: int = 1,
                 expected_max_contexts: Optional[int] = None,
                 keep_strings: bool = False, epoch_offset: int = 0):
        _one_host(host_shard, num_host_shards)
        with open(prefix + ".bin.json", "r") as f:
            self.manifest = json.load(f)
        self.target_strings: Optional[List[str]] = None
        if keep_strings:
            # the original target names, for the subtoken metrics (an
            # out-of-vocab target collapses to OOV in the index)
            with open(prefix + ".bin.targets", encoding="utf-8") as f:
                self.target_strings = [ln.rstrip("\n") for ln in f]
        self.max_contexts = int(self.manifest["max_contexts"])
        if (expected_max_contexts is not None
                and expected_max_contexts != self.max_contexts):
            raise ValueError(
                f"binary shard {prefix}.bin was built with max_contexts="
                f"{self.max_contexts} but the run requests "
                f"{expected_max_contexts}; re-binarize or match the flag")
        self.num_examples = int(self.manifest["num_examples"])
        row_width = 1 + 3 * self.max_contexts
        self.data = np.memmap(prefix + ".bin", dtype=np.int32, mode="r",
                              shape=(self.num_examples, row_width))
        self.pad_index = int(self.manifest["pad_index"])
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = epoch_offset

    def __iter__(self) -> Iterator[BatchTensors]:
        C = self.max_contexts
        order = np.arange(self.num_examples)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
            self._epoch += 1
        for start in range(0, len(order), self.batch_size):
            # ascending rows inside a batch: a forward-only read of the
            # memmap; the batch's members are the shuffled ones
            sorted_idx = np.sort(order[start:start + self.batch_size])
            rows = np.asarray(self.data[sorted_idx])
            labels = rows[:, 0].astype(np.int32)
            src = rows[:, 1:1 + C]
            pth = rows[:, 1 + C:1 + 2 * C]
            dst = rows[:, 1 + 2 * C:1 + 3 * C]
            mask = (pth != self.pad_index).astype(np.float32)
            nv = rows.shape[0]
            tstr = None
            if self.target_strings is not None:
                tstr = [self.target_strings[i] for i in sorted_idx]
            labels, src, pth, dst, mask = _pad_batch(
                (labels, src, pth, dst, mask), self.batch_size)
            yield BatchTensors(labels, np.ascontiguousarray(src),
                               np.ascontiguousarray(pth),
                               np.ascontiguousarray(dst), mask, nv, tstr)


def _prefix(path_or_prefix: str) -> str:
    if path_or_prefix.endswith(".c2v"):
        return path_or_prefix[:-len(".c2v")]
    return path_or_prefix


def count_examples(path_or_prefix: str) -> int:
    """Examples in a split: from the binary manifest when there is one,
    else the non-empty lines of the `.c2v` file. It sizes a learning-rate
    schedule."""
    prefix = _prefix(path_or_prefix)
    if os.path.exists(prefix + ".bin.json"):
        with open(prefix + ".bin.json") as f:
            return int(json.load(f)["num_examples"])
    with open(path_or_prefix, "rb") as f:
        return sum(1 for raw in f if raw.strip())


def open_reader(path_or_prefix: str, vocabs: Code2VecVocabs,
                max_contexts: int, batch_size: int, shuffle: bool = False,
                seed: int = 0, keep_strings: bool = False,
                host_shard: int = 0, num_host_shards: int = 1,
                epoch_offset: int = 0):
    """The binary reader when a `.bin` sibling exists (and, for
    `keep_strings`, its `.bin.targets`), else the text reader.
    `epoch_offset` starts the shuffle stream at that epoch."""
    prefix = _prefix(path_or_prefix)
    have_bin = os.path.exists(prefix + ".bin.json")
    have_targets = os.path.exists(prefix + ".bin.targets")
    if have_bin and (not keep_strings or have_targets):
        return BinaryShardReader(prefix, batch_size, shuffle=shuffle,
                                 seed=seed, host_shard=host_shard,
                                 num_host_shards=num_host_shards,
                                 expected_max_contexts=max_contexts,
                                 keep_strings=keep_strings,
                                 epoch_offset=epoch_offset)
    return C2VTextReader(path_or_prefix, vocabs, max_contexts, batch_size,
                         shuffle=shuffle, seed=seed,
                         keep_strings=keep_strings, host_shard=host_shard,
                         num_host_shards=num_host_shards,
                         epoch_offset=epoch_offset)

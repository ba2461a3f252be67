"""Reader of `.vm.c2v` VarMisuse rows (data/varmisuse_gen.py's format):

    <label_idx> <cand_1,...,cand_K> <ctx> <ctx> ...

A copy of `data/vm_reader.py` in the JAX package. `VMTextReader` streams
the file through data/reader.C2VTextReader's byte offsets and its
`(seed + epoch)` shuffle and overrides its batch hook. Padding rules:
a padded row keeps candidate 0 live, so its softmax stays finite, and
has weight 0; a row whose true candidate fell beyond `max_candidates`
gets `row_valid = 0`, so it is left out of the loss and the metrics
instead of training toward a wrong candidate. `build_vm_vocabs` makes
the token and path vocabularies from the training rows themselves (the
candidates are tokens); the target vocabulary is a stub, since the
pointer's targets are the candidates.
"""

from __future__ import annotations

from collections import Counter
from typing import List, NamedTuple

import numpy as np

from code2vec_tpu_torch.data.reader import C2VTextReader
from code2vec_tpu_torch.vocab.vocabularies import (Code2VecVocabs, Vocab,
                                                   VocabType)


class VMBatch(NamedTuple):
    """One host batch. Shapes are static: [B], [B, C], [B, K]."""
    label: np.ndarray                      # int32 [B], index into the candidates
    path_source_token_indices: np.ndarray  # int32 [B, C]
    path_indices: np.ndarray               # int32 [B, C]
    path_target_token_indices: np.ndarray  # int32 [B, C]
    context_valid_mask: np.ndarray         # float32 [B, C]
    cand_ids: np.ndarray                   # int32 [B, K] token-vocab ids
    cand_mask: np.ndarray                  # float32 [B, K]
    row_valid: np.ndarray                  # float32 [B]; 0 = out of the loss
    num_valid_examples: int
    cand_strings: List[List[str]]

    def host_arrays(self):
        """The vm step's 8-tuple (labels, src, pth, dst, mask, cand_ids,
        cand_mask, weights); a weight is 1 for a valid row whose label
        survived the candidate cap, else 0."""
        weights = np.zeros((self.label.shape[0],), np.float32)
        weights[:self.num_valid_examples] = 1.0
        weights *= self.row_valid
        return (self.label, self.path_source_token_indices,
                self.path_indices, self.path_target_token_indices,
                self.context_valid_mask, self.cand_ids, self.cand_mask,
                weights)


def parse_vm_rows(lines: List[str], vocabs: Code2VecVocabs,
                  max_contexts: int, max_candidates: int):
    """Rows -> (labels [N], src, pth, dst [N, C], mask [N, C], cand [N, K],
    cand_mask [N, K], row_valid [N], candidate strings)."""
    n = len(lines)
    tok_v, path_v = vocabs.token_vocab, vocabs.path_vocab
    labels = np.zeros((n,), np.int32)
    src = np.full((n, max_contexts), tok_v.pad_index, np.int32)
    pth = np.full((n, max_contexts), path_v.pad_index, np.int32)
    dst = np.full((n, max_contexts), tok_v.pad_index, np.int32)
    mask = np.zeros((n, max_contexts), np.float32)
    cand = np.full((n, max_candidates), tok_v.pad_index, np.int32)
    cand_mask = np.zeros((n, max_candidates), np.float32)
    row_valid = np.ones((n,), np.float32)
    cand_strings: List[List[str]] = []
    for i, line in enumerate(lines):
        parts = line.rstrip("\n").split(" ")
        labels[i] = int(parts[0])
        cands = [c for c in parts[1].split(",") if c][:max_candidates]
        cand_strings.append(cands)
        for k, c in enumerate(cands):
            cand[i, k] = tok_v.lookup_index(c)
            cand_mask[i, k] = 1.0
        if labels[i] >= len(cands):
            # the true candidate was cut: an in-range label, no weight
            labels[i] = 0
            row_valid[i] = 0.0
        for j, ctx in enumerate(parts[2:2 + max_contexts]):
            fields = ctx.split(",")
            if len(fields) != 3 or not fields[1]:
                continue
            src[i, j] = tok_v.lookup_index(fields[0])
            pth[i, j] = path_v.lookup_index(fields[1])
            dst[i, j] = tok_v.lookup_index(fields[2])
            mask[i, j] = 1.0
    return (labels, src, pth, dst, mask, cand, cand_mask, row_valid,
            cand_strings)


class VMTextReader(C2VTextReader):
    """Offset-streaming reader over a `.vm.c2v` file."""

    def __init__(self, path: str, vocabs: Code2VecVocabs,
                 max_contexts: int, max_candidates: int, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 host_shard: int = 0, num_host_shards: int = 1,
                 epoch_offset: int = 0):
        super().__init__(path, vocabs, max_contexts, batch_size,
                         shuffle=shuffle, seed=seed, host_shard=host_shard,
                         num_host_shards=num_host_shards,
                         epoch_offset=epoch_offset)
        self.max_candidates = max_candidates

    def _parse_batch(self, batch_lines: List[str]) -> VMBatch:
        (labels, src, pth, dst, mask, cand, cand_mask, row_valid,
         cand_strings) = parse_vm_rows(batch_lines, self.vocabs,
                                       self.max_contexts,
                                       self.max_candidates)
        nv = len(batch_lines)
        pad = self.batch_size - nv
        if pad:
            tokp = self.vocabs.token_vocab.pad_index
            pthp = self.vocabs.path_vocab.pad_index
            labels = np.pad(labels, (0, pad))
            src = np.pad(src, ((0, pad), (0, 0)), constant_values=tokp)
            pth = np.pad(pth, ((0, pad), (0, 0)), constant_values=pthp)
            dst = np.pad(dst, ((0, pad), (0, 0)), constant_values=tokp)
            mask = np.pad(mask, ((0, pad), (0, 0)))
            cand = np.pad(cand, ((0, pad), (0, 0)), constant_values=tokp)
            cand_mask = np.pad(cand_mask, ((0, pad), (0, 0)))
            row_valid = np.pad(row_valid, (0, pad))
            # one live candidate keeps a padded row's softmax finite
            cand_mask[nv:, 0] = 1.0
        return VMBatch(labels, src, pth, dst, mask, cand, cand_mask,
                       row_valid, nv, cand_strings)


def build_vm_vocabs(train_path: str, max_token_vocab: int,
                    max_path_vocab: int) -> Code2VecVocabs:
    """Token vocabulary (the contexts' words and the candidates) and path
    vocabulary from the training rows, each cut to its cap; a stub
    target vocabulary."""
    tok_counts: Counter = Counter()
    path_counts: Counter = Counter()
    with open(train_path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 3:
                continue
            for c in parts[1].split(","):
                if c:
                    tok_counts[c] += 1
            for ctx in parts[2:]:
                fields = ctx.split(",")
                if len(fields) != 3 or not fields[1]:
                    continue
                tok_counts[fields[0]] += 1
                tok_counts[fields[2]] += 1
                path_counts[fields[1]] += 1
    return Code2VecVocabs(
        Vocab.create_from_freq_dict(VocabType.Token, tok_counts,
                                    max_token_vocab),
        Vocab.create_from_freq_dict(VocabType.Path, path_counts,
                                    max_path_vocab),
        Vocab.create_from_freq_dict(VocabType.Target, {"method": 1}, 10))

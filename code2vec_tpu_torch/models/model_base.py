"""Host-side evaluation metrics and the embedding exports.

Counterpart of models/model_base.py in the JAX package:
`MetricAccumulator` (exact-match top-k accuracy over the legal
predictions, and subtoken TP/FP/FN of the first legal prediction against
the true name; the port evaluates on one device, so it has no cross-host
merge) and `Code2VecModelBase.save_word2vec_format` (a `<V> <dim>`
header, then one `word v1 ... vdim` line per index, each value as
`%.6f`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from code2vec_tpu_torch.common import (EvaluationResults, SubtokenStatistics,
                                       filter_impossible_names)
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs, VocabType


class MetricAccumulator:
    """Accumulates top-k exact-match accuracy, subtoken statistics and the
    summed loss over an evaluation run."""

    def __init__(self, top_k: int):
        self.top_k = top_k
        self.num_examples = 0
        self.topk_correct = np.zeros((top_k,), dtype=np.int64)
        self.subtoken_stats = SubtokenStatistics()
        self.loss_sum = 0.0

    def update_batch(self, original_names: Sequence[str],
                     predicted_words: Sequence[Sequence[str]],
                     loss_sum: float = 0.0) -> None:
        self.loss_sum += float(loss_sum)
        for original, topk in zip(original_names, predicted_words):
            self.num_examples += 1
            legal = filter_impossible_names(list(topk))
            # the original found at rank r of the legal list counts for
            # every k > r
            if original in legal:
                rank = legal.index(original)
                if rank < self.top_k:
                    self.topk_correct[rank:] += 1
            top_prediction = legal[0] if legal else ""
            self.subtoken_stats.update(original, top_prediction)

    def merge_across_hosts(self) -> None:
        """Sum this accumulator's partials with every other rank's (a
        no-op in one process): a multi-process evaluation shards the eval
        file per rank, so each accumulator holds one rank's examples."""
        from code2vec_tpu_torch.parallel.distributed import \
            allreduce_sum_hosts
        vec = np.concatenate([
            [self.num_examples, self.loss_sum,
             self.subtoken_stats.true_positive,
             self.subtoken_stats.false_positive,
             self.subtoken_stats.false_negative],
            self.topk_correct]).astype(np.float64)
        total = allreduce_sum_hosts(vec)
        self.num_examples = int(total[0])
        self.loss_sum = float(total[1])
        self.subtoken_stats.true_positive = int(total[2])
        self.subtoken_stats.false_positive = int(total[3])
        self.subtoken_stats.false_negative = int(total[4])
        self.topk_correct = total[5:].astype(np.int64)

    def results(self) -> EvaluationResults:
        n = max(self.num_examples, 1)
        return EvaluationResults(
            topk_acc=(self.topk_correct / n).tolist(),
            subtoken_precision=self.subtoken_stats.precision,
            subtoken_recall=self.subtoken_stats.recall,
            subtoken_f1=self.subtoken_stats.f1,
            loss=self.loss_sum / n)


def vector_line(row: np.ndarray) -> str:
    """A vector as the exports write it: each value "%.6f", " "-separated
    (the JAX package's `" ".join(f"{x:.6f}" for x in row)`, the same
    characters, in one format call)."""
    return " ".join(["%.6f"] * len(row)) % tuple(row.tolist())


class Code2VecModelBase:
    """What both models share: `vocabs` and the word2vec export of a
    table (`get_embedding_table` gives it as float32 [V, dim])."""

    vocabs: Code2VecVocabs

    def get_embedding_table(self, vocab_type: VocabType) -> np.ndarray:
        raise NotImplementedError

    def save_word2vec_format(self, dest_path: str,
                             vocab_type: VocabType) -> None:
        vocab = self.vocabs.get(vocab_type)
        table = self.get_embedding_table(vocab_type)
        n, dim = vocab.size, table.shape[1]
        with open(dest_path, "w", encoding="utf-8") as f:
            f.write(f"{n} {dim}\n")
            for idx in range(n):
                f.write(f"{vocab.lookup_word(idx)} "
                        f"{vector_line(table[idx])}\n")

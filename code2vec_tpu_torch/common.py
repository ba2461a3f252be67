"""Special vocabulary words, the subtoken helpers, the evaluation
metrics' containers and the prediction-result containers.

A copy of `common.py` in the JAX package, under the same names, so both
packages print and compare the same results. Method names and leaf
tokens are stored as lowercase subtokens joined by `|` (e.g.
`set|name`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterable, List, Sequence, Tuple


class SpecialVocabWords:
    PAD = "<PAD>"   # a.k.a. NoSuchWord in older code2vec versions
    OOV = "<OOV>"


_NON_ALPHA_RE = re.compile(r"[^a-zA-Z]")
_CAMEL_SPLIT_RE = re.compile(
    r"(?<=[a-z])(?=[A-Z])|_|[0-9]|(?<=[A-Z])(?=[A-Z][a-z])|\s+")


def normalize_word(word: str) -> str:
    """Lowercase; strip non-letters unless that would empty the word."""
    stripped = _NON_ALPHA_RE.sub("", word)
    if not stripped:
        return word.lower()
    return stripped.lower()


def split_to_subtokens(word: str) -> List[str]:
    """Split a raw identifier on camelCase / underscores / digits into
    normalized, non-empty subtokens: `setFooBar_2x` -> [set, foo, bar, x]."""
    return [normalize_word(s) for s in _CAMEL_SPLIT_RE.split(word.strip())
            if s]


def get_subtokens(name: str) -> List[str]:
    """Subtokens of a stored (already normalized) name: split on `|`."""
    return [s for s in name.split("|") if s]


def internal_name_from_subtokens(subtokens: Iterable[str]) -> str:
    return "|".join(subtokens)


def legal_method_names_checker(name: str) -> bool:
    """A predicted name counts toward metrics only if it is a real name:
    not OOV/PAD/empty, and contains at least one letter subtoken."""
    if not name or name in (SpecialVocabWords.OOV, SpecialVocabWords.PAD):
        return False
    return bool(re.search(r"[a-zA-Z]", name))


def filter_impossible_names(names: Sequence[str]) -> List[str]:
    return [n for n in names if legal_method_names_checker(n)]


def calculate_subtoken_tp_fp_fn(
        original_name: str, predicted_name: str) -> Tuple[int, int, int]:
    """Per-example subtoken true/false positives and false negatives:
    predicted subtokens present in the true set are TPs, extra
    predictions are FPs, missed true subtokens are FNs."""
    true_subtokens = get_subtokens(original_name)
    pred_subtokens = get_subtokens(predicted_name)
    tp = sum(1 for s in pred_subtokens if s in true_subtokens)
    fp = sum(1 for s in pred_subtokens if s not in true_subtokens)
    fn = sum(1 for s in true_subtokens if s not in pred_subtokens)
    return tp, fp, fn


@dataclass
class SubtokenStatistics:
    """Accumulates TP/FP/FN over an evaluation run."""
    true_positive: int = 0
    false_positive: int = 0
    false_negative: int = 0

    def update(self, original_name: str, predicted_name: str) -> None:
        tp, fp, fn = calculate_subtoken_tp_fp_fn(original_name, predicted_name)
        self.true_positive += tp
        self.false_positive += fp
        self.false_negative += fn

    @property
    def precision(self) -> float:
        denom = self.true_positive + self.false_positive
        return self.true_positive / denom if denom else 0.0

    @property
    def recall(self) -> float:
        denom = self.true_positive + self.false_negative
        return self.true_positive / denom if denom else 0.0

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) else 0.0


@dataclass
class EvaluationResults:
    """What `evaluate()` returns."""
    topk_acc: Sequence[float]
    subtoken_precision: float
    subtoken_recall: float
    subtoken_f1: float
    loss: float = float("nan")

    def __str__(self) -> str:
        topk = ", ".join(f"top{k + 1}: {acc:.5f}"
                         for k, acc in enumerate(self.topk_acc))
        return (f"loss: {self.loss:.5f}, {topk}, "
                f"precision: {self.subtoken_precision:.5f}, "
                f"recall: {self.subtoken_recall:.5f}, "
                f"F1: {self.subtoken_f1:.5f}")


@dataclass
class AttentionedPathContext:
    """One path-context with its attention score (interpretability
    output of predict)."""
    source_token: str
    path: str
    target_token: str
    attention_score: float


@dataclass
class MethodPredictionResults:
    """Top-k name predictions + attention-ranked paths for one method."""
    original_name: str
    predictions: List[dict] = field(default_factory=list)
    attention_paths: List[AttentionedPathContext] = field(default_factory=list)
    code_vector: object = None

    def append_prediction(self, name: str, probability: float) -> None:
        self.predictions.append({"name": get_subtokens(name),
                                 "probability": probability})

    def append_attention_path(self, score: float, source: str, path: str,
                              target: str) -> None:
        self.attention_paths.append(AttentionedPathContext(
            source_token=source, path=path, target_token=target,
            attention_score=score))

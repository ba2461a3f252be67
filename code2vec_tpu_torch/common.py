"""Special vocabulary words, the subtoken helper decode uses, and the
prediction-result containers.

A copy of the parts of `common.py` in the JAX package that the serving
path needs, under the same names, so both packages print and compare
the same results. Method names and leaf tokens are stored as lowercase
subtokens joined by `|` (e.g. `set|name`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


class SpecialVocabWords:
    PAD = "<PAD>"   # a.k.a. NoSuchWord in older code2vec versions
    OOV = "<OOV>"


def get_subtokens(name: str) -> List[str]:
    """Subtokens of a stored (already normalized) name: split on `|`."""
    return [s for s in name.split("|") if s]


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

"""Vocabulary runtime: word <-> index maps for tokens, paths and targets.

A copy of `vocab/vocabularies.py` in the JAX package. `Code2VecVocabs.
load_from_dict_file` builds the vocabularies from the `.dict.c2v`
histograms preprocessing writes (data/preprocess.py), each cut to its
MAX_*_VOCAB_SIZE cap by descending count, ties in insertion order, so
both packages give every word the same index. `save` / `load` keep the
same pickle layout (a dict of three word lists, specials first, plus
`num_training_examples`), so a vocab sidecar written by either package
loads in the other as is. Lookups run on the host; the device only sees
int32 index tensors.
"""

from __future__ import annotations

import enum
import pickle
from typing import Dict, Iterable, List, Optional, Tuple

from code2vec_tpu_torch.common import SpecialVocabWords


class VocabType(enum.Enum):
    Token = 1
    Target = 2
    Path = 3


class Vocab:
    """A word<->index bijection with PAD=0 and OOV=1 reserved."""

    SPECIAL_WORDS: Tuple[str, ...] = (SpecialVocabWords.PAD,
                                      SpecialVocabWords.OOV)

    def __init__(self, vocab_type: VocabType, words: Iterable[str]):
        self.vocab_type = vocab_type
        self.word_to_index: Dict[str, int] = {}
        self.index_to_word: Dict[int, str] = {}
        for word in self.SPECIAL_WORDS:
            self._add(word)
        for word in words:
            if word not in self.word_to_index:
                self._add(word)

    def _add(self, word: str) -> None:
        idx = len(self.word_to_index)
        self.word_to_index[word] = idx
        self.index_to_word[idx] = word

    @property
    def size(self) -> int:
        return len(self.word_to_index)

    @property
    def pad_index(self) -> int:
        return self.word_to_index[SpecialVocabWords.PAD]

    @property
    def oov_index(self) -> int:
        return self.word_to_index[SpecialVocabWords.OOV]

    def lookup_index(self, word: str) -> int:
        return self.word_to_index.get(word, self.oov_index)

    def lookup_word(self, index: int) -> str:
        return self.index_to_word.get(index, SpecialVocabWords.OOV)

    @classmethod
    def create_from_freq_dict(cls, vocab_type: VocabType,
                              freq_dict: Dict[str, int],
                              max_size: int) -> "Vocab":
        """Keep the `max_size` most frequent words (ties broken by
        insertion order, as `Counter.most_common` breaks them)."""
        words = [w for w, _ in sorted(freq_dict.items(),
                                      key=lambda kv: (-kv[1],))][:max_size]
        return cls(vocab_type, words)

    # ---- (de)serialization: list of words in index order, specials first ----
    def to_word_list(self) -> List[str]:
        return [self.index_to_word[i] for i in range(self.size)]

    @classmethod
    def from_word_list(cls, vocab_type: VocabType,
                       words: List[str]) -> "Vocab":
        if tuple(words[:len(cls.SPECIAL_WORDS)]) != cls.SPECIAL_WORDS:
            raise ValueError("corrupt vocab: special words missing from head")
        return cls(vocab_type, words[len(cls.SPECIAL_WORDS):])


class Code2VecVocabs:
    """The three vocabularies (token / path / target) used by the model."""

    def __init__(self, token_vocab: Vocab, path_vocab: Vocab,
                 target_vocab: Vocab,
                 num_training_examples: Optional[int] = None):
        self.token_vocab = token_vocab
        self.path_vocab = path_vocab
        self.target_vocab = target_vocab
        self.num_training_examples = num_training_examples

    def get(self, vocab_type: VocabType) -> Vocab:
        return {VocabType.Token: self.token_vocab,
                VocabType.Path: self.path_vocab,
                VocabType.Target: self.target_vocab}[vocab_type]

    @classmethod
    def load_from_dict_file(cls, dict_path: str, max_token_vocab_size: int,
                            max_path_vocab_size: int,
                            max_target_vocab_size: int) -> "Code2VecVocabs":
        """The vocabularies of the `.dict.c2v` histograms preprocessing
        wrote, each cut to its cap."""
        (token_counts, path_counts, target_counts,
         num_examples) = read_count_dicts(dict_path)
        return cls(
            Vocab.create_from_freq_dict(VocabType.Token, token_counts,
                                        max_token_vocab_size),
            Vocab.create_from_freq_dict(VocabType.Path, path_counts,
                                        max_path_vocab_size),
            Vocab.create_from_freq_dict(VocabType.Target, target_counts,
                                        max_target_vocab_size),
            num_training_examples=num_examples,
        )

    # ---- checkpoint sidecar: the vocab is saved next to the model so
    # loading needs no dataset ----
    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({
                "token": self.token_vocab.to_word_list(),
                "path": self.path_vocab.to_word_list(),
                "target": self.target_vocab.to_word_list(),
                "num_training_examples": self.num_training_examples,
            }, f)

    @classmethod
    def load(cls, path: str) -> "Code2VecVocabs":
        """Load a sidecar this program (or the JAX package) wrote;
        unpickling runs code, so never point this at untrusted bytes."""
        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(
            Vocab.from_word_list(VocabType.Token, d["token"]),
            Vocab.from_word_list(VocabType.Path, d["path"]),
            Vocab.from_word_list(VocabType.Target, d["target"]),
            num_training_examples=d.get("num_training_examples"),
        )


def read_count_dicts(dict_path: str):
    """The `.dict.c2v` sequential-pickle layout: the token, path and
    target count dicts, then the number of training examples (absent in
    older files: None). Unpickling runs code: read only files that
    preprocessing wrote."""
    with open(dict_path, "rb") as f:
        token_counts = pickle.load(f)
        path_counts = pickle.load(f)
        target_counts = pickle.load(f)
        try:
            num_examples = pickle.load(f)
        except EOFError:
            num_examples = None
    return token_counts, path_counts, target_counts, num_examples


def read_token_counts(dict_path: str) -> Dict[str, int]:
    """Just the token histogram, the file's first object (the path and
    target dicts are not read)."""
    with open(dict_path, "rb") as f:
        return pickle.load(f)

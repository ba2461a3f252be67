"""The port's data pipeline against the JAX package's: `.dict.c2v`
vocabularies, preprocess, binarize, the binary-shard reader,
`open_reader`, `count_examples` and `steps_per_epoch`
(code2vec_tpu_torch/vocab/vocabularies.py, data/preprocess.py,
data/binarize.py, data/reader.py).

Every check runs the JAX function and the port's on the same input,
made from a numpy seed, and asks for equality: the same words at the
same indices, the same bytes in every file, the same arrays in every
batch. There is no tolerance: nothing here computes in floating point
beyond the mask, which both packages make from the same integers.
"""

import filecmp
import os
import pickle

import numpy as np
import pytest

from code2vec_tpu.data import binarize as jax_binarize
from code2vec_tpu.data import preprocess as jax_preprocess
from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.vocab import vocabularies as jax_vocab
from code2vec_tpu_torch.data import binarize as torch_binarize
from code2vec_tpu_torch.data import preprocess as torch_preprocess
from code2vec_tpu_torch.data import reader as torch_reader
from code2vec_tpu_torch.vocab import vocabularies as torch_vocab

C = 12
CAPS = ("--word_vocab_size", "30", "--path_vocab_size", "20",
        "--target_vocab_size", "15")


def _raw_lines(n: int, seed: int):
    """Extractor-format lines over small word sets (many count ties), 1
    to 2C contexts (over the cap too), a malformed context now and then
    and a blank line."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        ctxs = []
        for _ in range(int(rng.integers(1, 2 * C + 1))):
            a, b = rng.integers(0, 40, 2)
            p = int(rng.integers(0, 25))
            ctxs.append(f"t{a},p{p},t{b}" if rng.random() > 0.03
                        else f"t{a},p{p}")
        lines.append(f"m{rng.integers(0, 20)}|x{i % 3} " + " ".join(ctxs))
        if i == n // 2:
            lines.append("")
    return lines


def _preprocess(module, out_dir: str, raw: dict, seed: int) -> str:
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, "ds")
    module.main(["--train_data", raw["train"], "--val_data", raw["val"],
                 "--test_data", raw["test"], "--max_contexts", str(C),
                 *CAPS, "--output_name", prefix, "--seed", str(seed)])
    return prefix


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same raw splits preprocessed and binarized by each package."""
    root = tmp_path_factory.mktemp("pipeline")
    raw = {}
    for split, n, seed in (("train", 70, 1), ("val", 20, 2),
                           ("test", 33, 3)):
        raw[split] = str(root / f"raw.{split}.txt")
        with open(raw[split], "w") as f:
            f.write("\n".join(_raw_lines(n, seed)) + "\n")
    out = {}
    for name, pre, binz in (("jax", jax_preprocess, jax_binarize),
                            ("torch", torch_preprocess, torch_binarize)):
        prefix = _preprocess(pre, str(root / name), raw, seed=5)
        binz.main(["--data", prefix, "--max_contexts", str(C), *CAPS])
        out[name] = prefix
    out["raw"] = raw
    out["root"] = str(root)
    return out


def _dict_file(path: str, seed: int) -> None:
    """Count dicts with many ties, in a seeded insertion order."""
    rng = np.random.default_rng(seed)
    dicts = []
    for n, top in ((60, 9), (40, 5), (25, 4)):
        words = [f"w{i}" for i in rng.permutation(n)]
        dicts.append({w: int(c) for w, c in
                      zip(words, rng.integers(1, top, n))})
    with open(path, "wb") as f:
        for d in dicts:
            pickle.dump(d, f)
        pickle.dump(123, f)


@pytest.mark.parametrize("caps", [(1000, 1000, 1000), (30, 20, 7),
                                  (1, 1, 1)])
def test_vocabs_from_dict_file_equal_index_for_index(tmp_path, caps):
    """`Code2VecVocabs.load_from_dict_file` at several caps (all words,
    cut inside a tie, one word): the three vocabularies' word lists and
    the example count are the JAX package's; `read_count_dicts` and
    `read_token_counts` read the same objects."""
    path = str(tmp_path / "x.dict.c2v")
    _dict_file(path, seed=sum(caps))
    jv = jax_vocab.Code2VecVocabs.load_from_dict_file(path, *caps)
    tv = torch_vocab.Code2VecVocabs.load_from_dict_file(path, *caps)
    for kind in ("token_vocab", "path_vocab", "target_vocab"):
        assert getattr(tv, kind).to_word_list() == \
            getattr(jv, kind).to_word_list()
    assert tv.num_training_examples == jv.num_training_examples == 123
    assert torch_vocab.read_count_dicts(path) == \
        jax_vocab.read_count_dicts(path)
    assert torch_vocab.read_token_counts(path) == \
        jax_vocab.read_token_counts(path)


@pytest.mark.parametrize("suffix", [".train.c2v", ".val.c2v", ".test.c2v",
                                    ".dict.c2v"])
def test_preprocess_writes_the_same_bytes(datasets, suffix):
    """The same raw splits and seed: each `.c2v` split (over-cap rows
    sampled from one `random.Random(seed)` stream across the splits)
    and the `.dict.c2v` pickles are byte-identical."""
    assert filecmp.cmp(datasets["jax"] + suffix, datasets["torch"] + suffix,
                       shallow=False)


def test_preprocess_seed_changes_the_sample(datasets, tmp_path):
    """Another seed samples other contexts in both packages alike (the
    byte check above is not vacuous)."""
    a = _preprocess(jax_preprocess, str(tmp_path / "j"), datasets["raw"], 6)
    b = _preprocess(torch_preprocess, str(tmp_path / "t"), datasets["raw"],
                    6)
    assert filecmp.cmp(a + ".train.c2v", b + ".train.c2v", shallow=False)
    assert not filecmp.cmp(a + ".train.c2v",
                           datasets["jax"] + ".train.c2v", shallow=False)


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("suffix", [".bin", ".bin.json", ".bin.targets"])
def test_binarize_writes_the_same_bytes(datasets, split, suffix):
    a = f"{datasets['jax']}.{split}{suffix}"
    b = f"{datasets['torch']}.{split}{suffix}"
    assert os.path.getsize(a) > 0
    assert filecmp.cmp(a, b, shallow=False)


def _batches(reader, epochs: int):
    out = []
    for _ in range(epochs):
        out.extend(list(reader))
    return out


def _assert_same_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for f in ("target_index", "path_source_token_indices",
                  "path_indices", "path_target_token_indices",
                  "context_valid_mask"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
            assert getattr(x, f).dtype == getattr(y, f).dtype
        assert x.num_valid_examples == y.num_valid_examples
        assert x.target_strings == y.target_strings


@pytest.mark.parametrize("seed,epoch_offset,batch,keep", [
    (0, 0, 16, False), (7, 0, 9, True), (239, 3, 16, False),
    (239, 1, 70, True), (3, 5, 32, True)])
def test_binary_reader_batches_equal(datasets, seed, epoch_offset, batch,
                                     keep):
    """`BinaryShardReader` over the same shard: three shuffled epochs from
    `epoch_offset` (the within-batch ascending row order, the padded
    last batch, `target_strings` with `keep_strings`), and an
    unshuffled pass, equal array for array."""
    prefix = datasets["torch"] + ".train"
    kw = dict(shuffle=True, seed=seed, keep_strings=keep,
              epoch_offset=epoch_offset, expected_max_contexts=C)
    jr = jax_reader.BinaryShardReader(prefix, batch, **kw)
    tr = torch_reader.BinaryShardReader(prefix, batch, **kw)
    tb = _batches(tr, 3)
    _assert_same_batches(_batches(jr, 3), tb)
    b0 = tb[0]
    nv = b0.num_valid_examples
    assert nv == min(batch, 70)
    if keep:
        assert len(b0.target_strings) == nv
    plain = dict(shuffle=False, keep_strings=keep)
    _assert_same_batches(
        _batches(jax_reader.BinaryShardReader(prefix, batch, **plain), 1),
        _batches(torch_reader.BinaryShardReader(prefix, batch, **plain), 1))


def test_binary_reader_refuses_other_widths_and_hosts(datasets):
    """Another width is refused; a host shard outside [0, shards) is
    refused; host shard 1 of 2 reads the JAX reader's batches (the
    multi-process readers, tests/test_torch_parallel.py)."""
    prefix = datasets["torch"] + ".train"
    with pytest.raises(ValueError, match="max_contexts"):
        torch_reader.BinaryShardReader(prefix, 8, expected_max_contexts=C + 1)
    with pytest.raises(ValueError, match="host"):
        torch_reader.BinaryShardReader(prefix, 8, host_shard=2,
                                       num_host_shards=2)
    shard = dict(host_shard=1, num_host_shards=2)
    _assert_same_batches(
        _batches(jax_reader.BinaryShardReader(prefix, 8, **shard), 1),
        _batches(torch_reader.BinaryShardReader(prefix, 8, **shard), 1))


@pytest.mark.parametrize("case", ["binary", "binary_keep", "no_targets_keep",
                                  "no_targets", "text_only"])
def test_open_reader_picks_the_same_reader(datasets, tmp_path, case):
    """`open_reader` takes the binary reader when a `.bin` sibling exists
    (for `keep_strings` only with its `.bin.targets`), else the text
    reader, in both packages; their batches are equal."""
    src = datasets["torch"] + ".val"
    prefix = str(tmp_path / "v")
    for suffix in (".c2v", ".bin", ".bin.json", ".bin.targets"):
        if case == "text_only" and suffix != ".c2v":
            continue
        if case.startswith("no_targets") and suffix == ".bin.targets":
            continue
        with open(src + suffix, "rb") as fi, open(prefix + suffix,
                                                  "wb") as fo:
            fo.write(fi.read())
    keep = case.endswith("keep")
    jv = jax_vocab.Code2VecVocabs.load_from_dict_file(
        datasets["jax"] + ".dict.c2v", 30, 20, 15)
    tv = torch_vocab.Code2VecVocabs.load_from_dict_file(
        datasets["torch"] + ".dict.c2v", 30, 20, 15)
    kw = dict(shuffle=True, seed=11, keep_strings=keep, epoch_offset=2)
    jr = jax_reader.open_reader(prefix + ".c2v", jv, C, 8, **kw)
    tr = torch_reader.open_reader(prefix + ".c2v", tv, C, 8, **kw)
    assert type(jr).__name__ == type(tr).__name__ == (
        "BinaryShardReader" if case in ("binary", "binary_keep",
                                        "no_targets") else "C2VTextReader")
    _assert_same_batches(_batches(jr, 2), _batches(tr, 2))


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_count_examples_and_steps_per_epoch_equal(datasets, tmp_path, split):
    """From the binary manifest, and from the text file alone."""
    prefix = f"{datasets['torch']}.{split}"
    text_only = str(tmp_path / f"{split}.c2v")
    with open(prefix + ".c2v", "rb") as fi, open(text_only, "wb") as fo:
        fo.write(fi.read())
    for path in (prefix + ".c2v", prefix, text_only):
        n = torch_reader.count_examples(path)
        assert n == jax_reader.count_examples(path)
        for b in (1, 7, 16, 1000):
            assert torch_reader.steps_per_epoch(n, b) == \
                jax_reader.steps_per_epoch(n, b)
    assert torch_reader.count_examples(prefix) == \
        {"train": 70, "val": 20, "test": 33}[split]

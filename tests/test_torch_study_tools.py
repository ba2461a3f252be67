"""The port's four study tools (code2vec_tpu_torch/tools/
gen_java_corpus.py, extractor_coverage.py, quality_study.py,
sampled_decay_study.py) against the JAX package's root tools, on the
CPU.

- the corpus: the same flags and seed write the same bytes (and print
  the same counts) as tools/gen_java_corpus.py, for the default stream,
  `--tail_names`, `--redundant_cues` and `--deep_tail_fresh`;
- the coverage: the port tool over the port's `c2v_extract` prints the
  JSON the JAX tool prints over the JAX extractor's sources, built here
  with the host's C++ compiler into the test's directory (both skip
  with the reason where there is no `c++`);
- the quality study: each variant's `Config` sets the fields the JAX
  `run_variant` sets, to the same values, and its row has the JAX row's
  keys; a one-epoch CPU run of two variants on a tiny corpus gives the
  JAX run's keys, `steps` and `target_vocab_size`;
- the decay probe: on the JAX tool's model after one epoch (its params
  and Adam state carried over with convert.py), the port's probe gives
  the JAX probe's per-decile numbers: top-1 exactly; the row norms and
  the bf16 thresholds exactly (both from the same float32 rows through
  numpy, rounded as the JAX tool rounds them); nu and the update
  magnitudes, which take a mean over E = 128 columns on each side's
  device (XLA's reduction and torch's add in other orders) and then a
  numpy mean over a decile's n rows, within a relative (E + n) * 2^-24,
  the bound of a float32 sum of that many terms reordered.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import random
import subprocess
import sys
import types

import numpy as np
import pytest

from code2vec_tpu_torch.tools import (extractor_coverage, gen_java_corpus,
                                      quality_study, sampled_decay_study)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_GEN = os.path.join(REPO, "tools", "gen_java_corpus.py")

CORPUS_FLAGS = {
    "default": [],
    "tail_names": ["--tail_names", "100"],
    "redundant_cues": ["--redundant_cues", "2"],
    "deep_tail_fresh": ["--redundant_cues", "2", "--deep_tail_fresh", "2",
                        "--deep_tail_head", "50"],
}


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("mode", sorted(CORPUS_FLAGS))
def test_corpus_bytes_equal_the_jax_generator(mode, tmp_path):
    flags = ["--names", "50", "--methods", "200", "--seed", "3",
             *CORPUS_FLAGS[mode]]
    want = subprocess.run(
        [sys.executable, JAX_GEN, "--out", str(tmp_path / "jax"), *flags],
        check=True, capture_output=True, text=True, timeout=120).stdout
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        assert gen_java_corpus.main(
            ["--out", str(tmp_path / "port"), *flags]) == 0
    assert said.getvalue() == want
    jax_files, port_files = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert len(port_files) > 3 and port_files == jax_files


def _cxx():
    from code2vec_tpu_torch.ops import _build
    try:
        return _build.cxx_path()
    except Exception as e:  # no compiler on this host
        pytest.skip(f"no host C++ compiler to build the extractors ({e})")


def test_coverage_json_equals_the_jax_tool(tmp_path, monkeypatch, capsys):
    cxx = _cxx()
    from tools import extractor_coverage as jax_coverage
    # the JAX extractor's command line from its own sources, with its
    # CMakeLists.txt's settings (C++17; the binary links pthreads)
    src = os.path.join(REPO, "code2vec_tpu", "extractor")
    jax_bin = str(tmp_path / "c2v_extract")
    subprocess.run([cxx, "-std=c++17", "-O2", "-pthread", "-o", jax_bin,
                    *(os.path.join(src, s) for s in
                      ("main.cc", "lexer.cc", "parser.cc", "paths.cc"))],
                   check=True, capture_output=True, timeout=300)
    monkeypatch.setattr(jax_coverage, "EXTRACTOR", jax_bin)
    monkeypatch.setattr(sys, "argv", ["extractor_coverage.py",
                                      "--methods", "400"])
    jax_coverage.main()
    want = json.loads(capsys.readouterr().out)
    assert extractor_coverage.main(["--methods", "400"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == want and got["methods_expected"] == 400
    assert got["coverage"] >= 0.999


class _RecordedModel:
    """Stands in for a trainer: records the config it was built with and
    returns fixed evaluation results, so a variant's row is built without
    training."""

    made = []

    def __init__(self, cfg, *_a, **_kw):
        self.config = cfg
        self.step_num = 7
        self.vocabs = types.SimpleNamespace(
            target_vocab=types.SimpleNamespace(size=11))
        _RecordedModel.made.append(self)

    @classmethod
    def from_config(cls, cfg, device=None):
        return cls(cfg)

    def train(self):
        return []

    def evaluate(self):
        return types.SimpleNamespace(
            loss=1.0, topk_acc=[0.5] * 10, subtoken_precision=0.25,
            subtoken_recall=0.25, subtoken_f1=0.25)


def _set_fields(cfg, default) -> set:
    """The fields of `cfg` that differ from the default config's."""
    return {f.name for f in dataclasses.fields(cfg)
            if getattr(cfg, f.name) != getattr(default, f.name)}


@pytest.mark.parametrize("variant", list(quality_study.VARIANTS))
def test_quality_variant_config_and_row_keys_equal_jax(variant, monkeypatch,
                                                       capsys):
    from code2vec_tpu.config import Config as JConfig
    from code2vec_tpu.models import jax_model
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models import torch_model
    from tools import quality_study as jax_quality
    assert list(jax_quality.VARIANTS.items()) == \
        list(quality_study.VARIANTS.items())
    monkeypatch.setattr(jax_model, "Code2VecModel", _RecordedModel)
    monkeypatch.setattr(torch_model, "Code2VecTrainer", _RecordedModel)
    _RecordedModel.made = []
    args = (variant, "/d/qs", 6, 256, 512, 239)
    kw = dict(lr=2e-3, lr_schedule="cosine", max_contexts=100)
    j_row = jax_quality.run_variant(*args, **kw)
    t_row = quality_study.run_variant(*args, **kw)
    j_cfg, t_cfg = (m.config for m in _RecordedModel.made)
    # the fields the JAX run_variant names, and any other either side
    # moved off its default
    named = {"MAX_CONTEXTS", "MAX_TOKEN_VOCAB_SIZE", "MAX_PATH_VOCAB_SIZE",
             "MAX_TARGET_VOCAB_SIZE", "TRAIN_BATCH_SIZE", "TEST_BATCH_SIZE",
             "NUM_TRAIN_EPOCHS", "SAVE_EVERY_EPOCHS",
             "NUM_BATCHES_TO_LOG_PROGRESS", "LEARNING_RATE", "LR_SCHEDULE",
             "LR_WARMUP_STEPS", "TRUST_RATIO", "TRUST_RATIO_SCOPE", "SEED",
             "USE_SAMPLED_SOFTMAX", "NUM_SAMPLED_CLASSES", "TABLES_DTYPE",
             "EMBEDDING_OPTIMIZER", "ENCODER_TYPE", "train_data_path",
             "test_data_path"}
    changed = _set_fields(j_cfg, JConfig()) | _set_fields(t_cfg, Config())
    for name in changed | named:
        assert getattr(t_cfg, name) == getattr(j_cfg, name), name
    assert list(t_row) == list(j_row) and t_row == j_row
    out = capsys.readouterr().out.splitlines()
    assert [json.loads(ln) for ln in out] == [j_row, t_row]


def _write_corpus(tmp, n_targets: int = 40, max_contexts: int = 8):
    """A synthetic extractor-format corpus of `n_targets` Zipf-weighted
    names whose contexts lean on the name, preprocessed by the JAX
    package (the port reads its output as its own)."""
    from code2vec_tpu.data import preprocess
    rng = random.Random(5)
    names = [f"get|item{i}" for i in range(n_targets)]
    weights = [1.0 / (r + 2) for r in range(n_targets)]

    def lines(n):
        out = []
        for t in rng.choices(range(n_targets), weights=weights, k=n):
            ctxs = [f"tok{(t + rng.randrange(3)) % 50},"
                    f"{1000 + (t * 7 + rng.randrange(2)) % 60},"
                    f"tok{(t * 3) % 50}"
                    for _ in range(rng.randint(2, max_contexts))]
            out.append(names[t] + " " + " ".join(ctxs))
        return out

    raw = {}
    for split, n in (("train", 320), ("val", 96), ("test", 16)):
        raw[split] = os.path.join(tmp, f"raw.{split}.txt")
        with open(raw[split], "w") as f:
            f.write("\n".join(lines(n)) + "\n")
    prefix = os.path.join(tmp, "qs")
    preprocess.main(["--train_data", raw["train"], "--val_data", raw["val"],
                     "--test_data", raw["test"], "--max_contexts",
                     str(max_contexts), "--word_vocab_size", "1000",
                     "--path_vocab_size", "1000", "--target_vocab_size",
                     "1000", "--output_name", prefix])
    return prefix


def test_quality_cpu_run_matches_jax_rows(tmp_path):
    from tools import quality_study as jax_quality
    prefix = _write_corpus(str(tmp_path))
    for variant in ("full-f32-adam", "sampled-bf16-adafactor"):
        args = (variant, prefix, 1, 64, 16, 239)
        j_row = jax_quality.run_variant(*args, max_contexts=8)
        t_row = quality_study.run_variant(*args, max_contexts=8,
                                          device="cpu")
        assert list(t_row) == list(j_row)
        assert t_row["steps"] == j_row["steps"] == math.ceil(320 / 64)
        assert t_row["target_vocab_size"] == j_row["target_vocab_size"] > 2
        for key in ("val_f1", "val_top1"):
            assert 0.0 <= t_row[key] <= 1.0


def test_decay_probe_equals_the_jax_probe(tmp_path, monkeypatch, capsys):
    import jax

    from code2vec_tpu.models import jax_model
    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from tools import sampled_decay_study as jax_decay
    # the JAX tool's width is fixed at 200 contexts
    prefix = _write_corpus(str(tmp_path), max_contexts=200)
    made = []

    class Recorded(jax_model.Code2VecModel):
        def __init__(self, cfg, *a, **kw):
            super().__init__(cfg, *a, **kw)
            made.append(self)

    monkeypatch.setattr(jax_model, "Code2VecModel", Recorded)
    monkeypatch.setattr(sys, "argv", [
        "sampled_decay_study.py", "--data", prefix, "--epochs", "1",
        "--probe_epochs", "1", "--batch", "64", "--num_sampled", "16"])
    jax_decay.main()
    want = json.loads(next(ln for ln in capsys.readouterr().out.splitlines()
                           if ln.startswith("{")))
    (jm,) = made
    j_cfg = jm.config
    cfg = Config(MAX_CONTEXTS=200, MAX_TOKEN_VOCAB_SIZE=150_000,
                 MAX_PATH_VOCAB_SIZE=150_000, MAX_TARGET_VOCAB_SIZE=60_000,
                 TRAIN_BATCH_SIZE=64, TEST_BATCH_SIZE=64, SEED=239,
                 USE_SAMPLED_SOFTMAX=True, NUM_SAMPLED_CLASSES=16,
                 TABLES_DTYPE="float32", EMBEDDING_OPTIMIZER="adam")
    cfg.train_data_path = prefix
    cfg.test_data_path = j_cfg.test_data_path
    model = Code2VecTrainer.from_config(cfg, device="cpu")
    model.params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    model.opt_state = convert.dense_opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.opt_state), "cpu")
    deciles = sampled_decay_study.target_freq_deciles(model.vocabs, prefix)
    assert [d.tolist() for d in deciles] == [
        d.tolist() for d in jax_decay.target_freq_deciles(jm.vocabs, prefix)]
    got = sampled_decay_study.probe(model, deciles, 1, 1e-3, "float32")
    assert list(got) == list(want)
    for key in ("epoch", "tables_dtype", "lr", "top1_by_decile",
                "row_norm_by_decile", "bf16_round_threshold_by_decile"):
        assert got[key] == want[key], key
    assert any(t > 0 for t in got["top1_by_decile"])
    E = model.params["target_emb"].shape[1]
    rtol = (E + max(len(d) for d in deciles)) * 2.0 ** -24
    for key in ("nu_by_decile", "lr_x_update_by_decile"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=0)
        assert all(v > 0 for v in got[key]), key


def test_device_tools_exit_2_without_a_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert quality_study.main(["--data", "x"]) == 2
    assert sampled_decay_study.main(["--data", "x"]) == 2
    assert capsys.readouterr().err.count("needs a CUDA card") == 2


def test_quality_main_prints_a_row_a_variant_and_the_table(tmp_path, capsys):
    prefix = _write_corpus(str(tmp_path))
    out = tmp_path / "rows.jsonl"
    assert quality_study.main([
        "--data", prefix, "--epochs", "1", "--batch", "64",
        "--num_sampled", "16", "--max_contexts", "8", "--variants",
        "sampled-f32-adam,sampled-bf16-adafactor", "--out", str(out),
        "--backend", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [r["variant"] for r in rows] == ["sampled-f32-adam",
                                            "sampled-bf16-adafactor"]
    assert [json.loads(ln) for ln in out.read_text().splitlines()] == rows
    head = next(i for i, ln in enumerate(lines) if ln.startswith("variant "))
    assert [ln.split()[0] for ln in lines[head + 1:head + 3]] == \
        ["sampled-f32-adam", "sampled-bf16-adafactor"]

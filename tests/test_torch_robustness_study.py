"""The port's robustness study (code2vec_tpu_torch/tools/
robustness_study.py) on the CPU: a tiny corpus, both arms, one epoch, a
few attacks with the rarity detector; one JSON row per arm with the
JAX study's keys, then the summary table; the exits 2 of the card
default and of an `--infeed_chunk` the JAX rules refuse."""

from __future__ import annotations

import json

import torch

from code2vec_tpu_torch.tools import robustness_study
from helpers import build_tiny_dataset

ROW_KEYS = {"arm", "tag", "word_vocab_size", "adv_rename_prob",
            "adv_rename_mode", "epochs", "clean_subtoken_f1", "clean_top1",
            "attack_success_rate", "robustness", "attacked_top1_acc",
            "n_attacks", "train_seconds", "detection_auc",
            "detection_tpr_at_5fpr"}


def test_study_prints_a_row_per_arm_and_the_table(tmp_path, capsys):
    prefix = build_tiny_dataset(str(tmp_path), n_train=96, n_val=16,
                                n_test=8, max_contexts=8)
    out = tmp_path / "rows.jsonl"
    rc = robustness_study.main([
        "--data", prefix, "--epochs", "1", "--batch", "32",
        "--n_attacks", "4", "--max_contexts", "8", "--detect",
        "--word_vocab_size", "1000", "--path_vocab_size", "1000",
        "--target_vocab_size", "1000", "--adv_prob", "0.5",
        "--tag", "k1", "--out", str(out), "--backend", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [r["arm"] for r in rows] == ["baseline", "defended"]
    for r in rows:
        assert ROW_KEYS <= set(r), ROW_KEYS - set(r)
        assert r["tag"] == "k1" and r["epochs"] == 1
        assert 0 < r["n_attacks"] <= 4
        assert 0.0 <= r["attack_success_rate"] <= 1.0
    assert rows[0]["adv_rename_prob"] == 0.0
    assert rows[0]["adv_rename_mode"] == "-"
    assert rows[1]["adv_rename_prob"] == 0.5
    assert rows[1]["adv_rename_mode"] == "uniform"
    assert [json.loads(ln) for ln in out.read_text().splitlines()] == rows
    head = next(i for i, ln in enumerate(lines) if ln.startswith("arm "))
    assert lines[head].split() == ["arm", "p", "cleanF1", "top1",
                                   "atk-success", "atk-top1"]
    assert [ln.split()[0] for ln in lines[head + 1:head + 3]] == \
        ["baseline", "defended"]


def test_study_exits_2_without_a_card_or_with_a_chunked_infeed(
        tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert robustness_study.main(["--data", str(tmp_path / "x")]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
    assert robustness_study.main(["--data", str(tmp_path / "x"),
                                  "--infeed_chunk", "0",
                                  "--backend", "cpu"]) == 2
    assert "--infeed_chunk must be >= 1." in capsys.readouterr().err

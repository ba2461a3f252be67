#!/usr/bin/env python3
"""Attack-vs-defense study: does --adv_rename_prob buy robustness?

Counterpart of `tools/robustness_study.py` in the JAX package, over the
port: trains two matched models on a dataset, the baseline (plain
training) and the defended one (`--adv_rename_prob`, the randomized
rename augmentation of attacks/defense.py), then attacks both with the
untargeted gradient rename attack (attacks/robustness.py) and reports
clean quality next to the attack's success rate. With `--detect` it
also scores the rarity-outlier detector (attacks/detect.py) on the
attacked methods.

Usage (the dataset is any preprocessed prefix with .train/.val .c2v):
  python -m code2vec_tpu_torch.tools.robustness_study --data <prefix> \\
      --epochs 6 --n_attacks 300 --adv_prob 0.3
Prints one JSON line per arm and a summary table. `--backend gpu` (the
default) runs on the CUDA card and exits 2 without one; `cpu` runs on
the CPU. `--infeed_chunk G` groups G host batches into one copy to the
device (data/prefetch.ChunkedDevicePrefetcher); a value the JAX rules
refuse (G < 1) exits 2 with their message.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def run_arm(name: str, data: str, epochs: int, batch: int,
            adv_prob: float, n_attacks: int, max_renames: int,
            seed: int, max_contexts: int, detect: bool = False,
            adv_mode: str = "uniform", tag: str = "",
            word_vocab_size: int = 150_000,
            path_vocab_size: int = 150_000,
            target_vocab_size: int = 60_000,
            infeed_chunk: int = 1, device=None) -> dict:
    from code2vec_tpu_torch.attacks.robustness import evaluate_robustness
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer

    # the java-large-style configuration of the JAX study (sampled
    # softmax, bf16, Adafactor)
    cfg = Config(
        MAX_CONTEXTS=max_contexts,
        MAX_TOKEN_VOCAB_SIZE=word_vocab_size,
        MAX_PATH_VOCAB_SIZE=path_vocab_size,
        MAX_TARGET_VOCAB_SIZE=target_vocab_size,
        INFEED_CHUNK=infeed_chunk,
        TRAIN_BATCH_SIZE=batch,
        TEST_BATCH_SIZE=batch,
        NUM_TRAIN_EPOCHS=epochs,
        SAVE_EVERY_EPOCHS=1000,
        NUM_BATCHES_TO_LOG_PROGRESS=200,
        LEARNING_RATE=1e-3,
        SEED=seed,
        USE_SAMPLED_SOFTMAX=True,
        NUM_SAMPLED_CLASSES=4096,
        ADV_RENAME_PROB=adv_prob,
        ADV_RENAME_MODE=adv_mode,
    )
    cfg.train_data_path = data
    cfg.test_data_path = data + ".val.c2v"
    model = Code2VecTrainer.from_config(cfg, device=device)
    t0 = time.time()
    model.train()
    train_s = time.time() - t0
    clean = model.evaluate()
    detector = None
    if detect:
        from code2vec_tpu_torch.attacks.detect import RarityDetector
        detector = RarityDetector.from_model(model, data + ".dict.c2v")
    rob = evaluate_robustness(model, data + ".val.c2v",
                              n_methods=n_attacks,
                              max_renames=max_renames,
                              detector=detector, log=cfg.log)
    row = {
        "arm": name,
        "tag": tag,
        "word_vocab_size": model.vocabs.token_vocab.size,
        "adv_rename_prob": adv_prob,
        "adv_rename_mode": adv_mode if adv_prob > 0 else "-",
        "epochs": epochs,
        "clean_subtoken_f1": round(clean.subtoken_f1, 4),
        "clean_top1": round(clean.topk_acc[0], 4),
        "attack_success_rate": rob["attack_success_rate"],
        "robustness": rob["robustness"],
        "attacked_top1_acc": rob["attacked_top1_acc"],
        "n_attacks": rob["n_methods"],
        "train_seconds": round(train_s, 1),
    }
    for key in ("detection_auc", "detection_tpr_at_5fpr",
                "replacement_token_freq", "original_token_freq"):
        if key in rob:
            row[key] = rob[key]
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m code2vec_tpu_torch.tools.robustness_study")
    ap.add_argument("--data", required=True,
                    help="dataset prefix (expects .train/.val .c2v)")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--adv_prob", type=float, default=0.3)
    ap.add_argument("--adv_mode", default="uniform",
                    choices=["uniform", "batch"],
                    help="defended arm's replacement distribution "
                         "(attacks/defense.py)")
    ap.add_argument("--n_attacks", type=int, default=300)
    ap.add_argument("--max_renames", type=int, default=1)
    ap.add_argument("--max_contexts", type=int, default=200)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--arms", default="baseline,defended",
                    help="comma list: baseline | defended")
    ap.add_argument("--detect", action="store_true",
                    help="also measure rarity-outlier detection "
                         "(attacks/detect.py) on the attacked methods")
    ap.add_argument("--word_vocab_size", type=int, default=150_000,
                    help="token vocab cap (a deep-tail corpus needs "
                         "~800K so the singleton tail stays in vocab)")
    ap.add_argument("--path_vocab_size", type=int, default=150_000)
    ap.add_argument("--target_vocab_size", type=int, default=60_000)
    ap.add_argument("--infeed_chunk", type=int, default=1,
                    help="host batches grouped into one copy to the "
                         "device (data/prefetch.py)")
    ap.add_argument("--tag", default="",
                    help="free-form row label (e.g. the corpus's cue "
                         "redundancy k in the defense grid)")
    ap.add_argument("--out", default=None,
                    help="append JSON rows here too")
    ap.add_argument("--backend", choices=("gpu", "cpu"), default="gpu",
                    help="gpu (default): the CUDA card, exit 2 without "
                         "one; cpu")
    a = ap.parse_args(argv)

    from code2vec_tpu_torch.config import Config, check_infeed_chunk
    from code2vec_tpu_torch.tools import loadgen
    try:
        check_infeed_chunk(a.infeed_chunk, Config.INFEED_PREFETCH)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    arms = [s.strip() for s in a.arms.split(",")]
    bad = [s for s in arms if s not in ("baseline", "defended")]
    if bad:
        ap.error(f"unknown arm(s) {bad}; valid: baseline, defended")
    if loadgen.gpu_missing(a.backend):
        return 2
    device = loadgen.backend_device(a.backend)
    rows = []
    for arm in arms:
        prob = 0.0 if arm == "baseline" else a.adv_prob
        row = run_arm(arm, a.data, a.epochs, a.batch, prob,
                      a.n_attacks, a.max_renames, a.seed,
                      a.max_contexts, detect=a.detect,
                      adv_mode=a.adv_mode, tag=a.tag,
                      word_vocab_size=a.word_vocab_size,
                      path_vocab_size=a.path_vocab_size,
                      target_vocab_size=a.target_vocab_size,
                      infeed_chunk=a.infeed_chunk, device=device)
        rows.append(row)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    print(f"\n{'arm':<10} {'p':>4} {'cleanF1':>8} {'top1':>6} "
          f"{'atk-success':>11} {'atk-top1':>8}")
    for r in rows:
        print(f"{r['arm']:<10} {r['adv_rename_prob']:>4} "
              f"{r['clean_subtoken_f1']:>8} {r['clean_top1']:>6} "
              f"{r['attack_success_rate']:>11} "
              f"{r['attacked_top1_acc']:>8}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

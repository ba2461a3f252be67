"""Adversarial-robustness evaluation: untargeted rename attacks over a
test split, reported as model robustness metrics.

Counterpart of `attacks/robustness.py` in the JAX package (the
evaluation protocol of "Adversarial Examples for Models of Code",
Yefet, Alon & Yahav 2020): attack every method in a held-out set with
the untargeted one-variable rename attack and report the attack success
rate (= 1 - model robustness).

Module CLI, over a checkpoint of the port (loaded as the command line
loads it, `Code2VecTrainer.from_config`):

  python -m code2vec_tpu_torch.attacks.robustness \\
      --load <ckpt> --test <file.c2v> [--n 200] [--max_renames 1] \\
      [--iters 4] [--topk 32] [--dict <data>.dict.c2v] \\
      [--out robustness.json] [--backend gpu|cpu]

Prints one JSON line: attack success rate, mean iterations/renames on
successes, the clean-vs-attacked top-1-vs-ground-truth breakdown and,
with `--dict`, the rarity detector's AUC. `--backend gpu` (the default)
exits 2 without a CUDA card.
"""

from __future__ import annotations

import itertools
import json
import sys
import time
from typing import Optional

import numpy as np

from code2vec_tpu_torch.attacks.gradient_attack import GradientRenameAttack
from code2vec_tpu_torch.data.reader import parse_c2v_rows


def _freq_stats(words, counts, token_vocab) -> dict:
    """Training-frequency stats of `words` under the detector vocab's
    per-row `counts`. Words the vocab maps to its OOV index would
    silently contribute the OOV row's train count (typically 0) —
    skewing frac_singleton and the rank percentile upward — so they
    are EXCLUDED and reported as n_oov_excluded instead."""
    oov = token_vocab.oov_index
    idxs = [token_vocab.lookup_index(w) for w in words]
    kept = [i for i in idxs if i != oov]
    n_excluded = len(idxs) - len(kept)
    c = np.asarray([int(counts[i]) for i in kept], np.int64)
    if not len(c):
        return {"n": 0, "n_oov_excluded": n_excluded}
    counts = np.asarray(counts)
    nz = np.sort(counts[counts > 0])
    # fraction of in-vocab tokens strictly more common than each chosen
    # token: 0.0 = the most common token, ~1.0 = a deep-tail singleton
    rank_pct = 1.0 - np.searchsorted(nz, c, side="right") / len(nz)
    return {
        "n": len(c),
        "n_oov_excluded": n_excluded,
        "median_train_count": float(np.median(c)),
        "p90_train_count": float(np.quantile(c, 0.9)),
        "frac_singleton": round(float(np.mean(c <= 2)), 4),
        "median_rank_pct": round(float(np.median(rank_pct)), 4),
    }


def evaluate_robustness(model, test_path: str, *, n_methods: int = 200,
                        max_renames: int = 1, max_iters: int = 4,
                        top_k_candidates: int = 32,
                        detector=None, log=print) -> dict:
    """Attacks up to `n_methods` methods of `test_path` (untargeted,
    greedy rename of up to `max_renames` variables) and aggregates.
    `model` is a predict-side model (`Code2VecModel`): its params,
    device and kernel choice are the attack's.

    With a `detector` (attacks/detect.py RarityDetector), also scores
    every clean method and every successful adversarial variant and
    reports detection AUC + TPR at a 5% FPR threshold (threshold
    calibrated on this sweep's own clean scores)."""
    attack = GradientRenameAttack(
        model.dims, model.vocabs.token_vocab, model.vocabs.target_vocab,
        top_k_candidates=top_k_candidates, max_iters=max_iters,
        compute_dtype=model.compute_dtype, device=model.device,
        use_kernel=model.use_kernel)
    tv = model.vocabs.target_vocab

    with open(test_path, encoding="utf-8") as f:
        # islice: production splits are GBs; read only what is attacked
        lines = list(itertools.islice(
            (ln for ln in f if ln.strip()), n_methods))
    labels, src, pth, dst, mask, tstr, _ = parse_c2v_rows(
        lines, model.vocabs, model.dims.max_contexts, keep_strings=True)

    eligible = [i for i in range(len(lines))
                if mask[i].sum() > 0
                and attack.attackable_tokens(src[i], dst[i], mask[i])]
    t0 = time.time()

    def attacked():
        """Yields (row_index, AttackResult). Single-rename sweeps run
        the lockstep batch path, 64 methods a pass; multi-rename falls
        back to the serial driver."""
        if max_renames == 1:
            chunk = 64
            for lo in range(0, len(eligible), chunk):
                idxs = eligible[lo:lo + chunk]
                # pad a short tail chunk to the fixed size (repeat the
                # last method, drop its results), as the JAX sweep does
                padded = idxs + [idxs[-1]] * (chunk - len(idxs))
                methods = [(src[i], pth[i], dst[i], mask[i])
                           for i in padded]
                results = attack.attack_batch(model.params, methods)
                yield from zip(idxs, results[:len(idxs)])
        else:
            for i in eligible:
                yield i, attack.attack_method(
                    model.params, (src[i], pth[i], dst[i], mask[i]),
                    targeted=False, max_renames=max_renames)

    n = flipped = clean_correct = attacked_correct = 0
    iters_on_success, renames_on_success = [], []
    clean_methods, adv_methods = [], []
    replacement_words, original_words = [], []
    for i, res in attacked():
        if detector is not None:
            clean_methods.append((src[i], pth[i], dst[i], mask[i]))
            if res.success:
                adv_methods.append(res.final_method)
                for frm, to in res.renames:
                    original_words.append(frm)
                    replacement_words.append(to)
        n += 1
        truth = tv.lookup_word(int(labels[i])) if not tstr else tstr[i]
        clean_correct += res.original_prediction == truth
        attacked_correct += res.final_prediction == truth
        if res.success:
            flipped += 1
            iters_on_success.append(res.iterations)
            renames_on_success.append(len(res.renames))
        if n % 32 == 0:
            log(f"robustness: {n} methods, "
                f"{flipped / n:.3f} attack success rate so far")
    dt = time.time() - t0
    report = {
        "metric": "untargeted_rename_attack_success_rate",
        "n_methods": n,
        "attack_success_rate": round(flipped / max(n, 1), 4),
        "robustness": round(1.0 - flipped / max(n, 1), 4),
        "clean_top1_acc": round(clean_correct / max(n, 1), 4),
        "attacked_top1_acc": round(attacked_correct / max(n, 1), 4),
        "mean_iterations_on_success": round(
            float(np.mean(iters_on_success)), 2) if iters_on_success
        else None,
        "mean_renames_on_success": round(
            float(np.mean(renames_on_success)), 2) if renames_on_success
        else None,
        "max_renames": max_renames,
        "max_iters": max_iters,
        "top_k_candidates": top_k_candidates,
        "seconds": round(dt, 1),
    }
    if detector is not None and adv_methods:
        from code2vec_tpu_torch.attacks.detect import auc
        clean_scores = detector.score_batch(model.params, clean_methods)
        attack_scores = detector.score_batch(model.params, adv_methods)
        thr = detector.calibrate(clean_scores, fpr=0.05)
        report["detection_auc"] = round(auc(clean_scores,
                                            attack_scores), 4)
        report["detection_tpr_at_5fpr"] = round(
            float(np.mean(attack_scores > thr)), 4)
        report["detection_threshold"] = round(thr, 3)
        # Replacement-frequency mechanism report: the paper's detector
        # presupposes the attack is forced into RARE replacement names.
        # Every successful rename's replacement (and, as the baseline,
        # the original attacked token) is looked up in the training
        # histogram through the DETECTOR's vocab, with OOV-mapped words
        # excluded rather than miscounted.
        report["replacement_token_freq"] = _freq_stats(
            replacement_words, detector.counts, detector.token_vocab)
        report["original_token_freq"] = _freq_stats(
            original_words, detector.counts, detector.token_vocab)
    return report


def load_predictor(load_path: str, backend: str):
    """(config, the predict-side model) of a code2vec checkpoint, on
    the card (`backend` "gpu") or the CPU, loaded as the command line
    loads it."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    cfg = Config(BACKEND=backend)
    cfg.load_path = load_path
    trainer = Code2VecTrainer.from_config(
        cfg, device="cpu" if backend == "cpu" else None)
    return cfg, trainer.predictor()


def main(argv: Optional[list] = None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--load", required=True, help="checkpoint directory")
    p.add_argument("--test", required=True, help=".c2v file to attack")
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--max_renames", type=int, default=1)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--topk", type=int, default=32)
    p.add_argument("--out", default=None, help="also write JSON here")
    p.add_argument("--dict", dest="dict_path", default=None,
                   help="dataset .dict.c2v — enables rarity-outlier "
                        "detection metrics (attacks/detect.py)")
    p.add_argument("--backend", default="gpu", choices=["gpu", "cpu"],
                   help="gpu (default): the CUDA card; cpu")
    a = p.parse_args(argv)
    if a.backend == "gpu" and not torch.cuda.is_available():
        print("error: --backend gpu (the default) needs a CUDA card and "
              "none is available; pass --backend cpu to run on the CPU",
              file=sys.stderr)
        return 2

    cfg, model = load_predictor(a.load, a.backend)
    detector = None
    if a.dict_path:
        from code2vec_tpu_torch.attacks.detect import RarityDetector
        detector = RarityDetector.from_model(model, a.dict_path)
    report = evaluate_robustness(
        model, a.test, n_methods=a.n, max_renames=a.max_renames,
        max_iters=a.iters, top_k_candidates=a.topk, detector=detector,
        log=cfg.log)
    line = json.dumps(report)
    print(line)
    if a.out:
        with open(a.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

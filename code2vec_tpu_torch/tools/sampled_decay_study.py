#!/usr/bin/env python3
"""Root-cause instrumentation for the sampled-softmax float32 top-1
decay, over the port: the counterpart of tools/sampled_decay_study.py of
the JAX package, with its flags, its target-frequency deciles and its
probe, training `Code2VecTrainer` (the dense step, kernel 1).

The JAX package's quality study found sampled softmax with float32
tables plateauing ~2.6 F1 points below full softmax on the 50K-name
corpus, its top-1 decaying late in training, while bf16 tables damp the
instability. This tool trains the sampled configuration and captures,
every `--probe_epochs` epochs:

  - val top-1 split by target-frequency decile (head = most frequent);
  - the mean L2 norm of the target-embedding rows per decile;
  - the mean Adam second moment (nu) per decile of the target table;
  - the mean bias-corrected update magnitude per decile (what bf16
    storage would round away once it drops below ~1/256 of the row's
    scale, the hypothesised damping).

Mechanism hypotheses it separates:
  H1 head-negative pressure: the log-uniform sampler draws head classes
     as negatives almost every step; head top-1 falls while tail
     deciles hold, and head row norms keep moving late in training.
  H2 effective-LR spike: Adam's nu for converged head rows decays, so
     the effective LR rises late and the rows oscillate: nu(head)
     falling while the update magnitude holds or grows.
  H3 bf16 damping: with bf16 tables the late tiny updates round to zero
     (|update| < row_scale/256): float32 update magnitudes late in
     training below the bf16 rounding threshold for head rows.

The probe reads the port's Adam state where the JAX one reads
`opt_state[0].nu`: the dense step's `chain(scale_by_adam_f32_moments,
scale_by_learning_rate)` keeps `ScaleByAdamState(count, mu, nu)` first,
its moments keyed by param. Adam stays pinned, as the JAX tool pins it
(the default Adafactor's state is factored).

Usage (the corpus of code2vec_tpu_torch/tools/quality_study.py):
  python -m code2vec_tpu_torch.tools.sampled_decay_study \\
      --data /tmp/qs/ds/qs --epochs 12 --tables_dtype float32 \\
      [--lr 1e-3] [--out out.jsonl]
Run once with float32 and once with bfloat16; diff the trajectories.
`--backend gpu` (the default) trains on the CUDA card and exits 2
without one; `cpu` trains on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def target_freq_deciles(vocabs, train_prefix: str, n_deciles: int = 10):
    """Decile boundaries over target ids ranked by training frequency.
    Vocab ids are already frequency-ordered (the vocabularies sort by
    count), so deciles are contiguous id ranges past the specials."""
    V = vocabs.target_vocab.size
    first_real = 2  # PAD, OOV
    ids = np.arange(first_real, V)
    return np.array_split(ids, n_deciles)


def probe(model, deciles, epoch_end: int, lr: float,
          tables_dtype: str) -> dict:
    """The JAX tool's probe of `model` (a `Code2VecTrainer` training
    with Adam), returned as its JSON row: per-decile val top-1 over
    `model.config.test_data_path`, target-row norms, nu and update
    magnitudes, and the bf16 rounding threshold."""
    import torch

    from code2vec_tpu_torch.data.reader import open_reader
    from code2vec_tpu_torch.training.steps import eval_step
    cfg = model.config
    # --- per-decile top-1 over the val set ---
    reader = open_reader(cfg.test_data_path, model.vocabs, cfg.MAX_CONTEXTS,
                         cfg.TEST_BATCH_SIZE, shuffle=False)
    correct = np.zeros(len(deciles))
    count = np.zeros(len(deciles))
    dec_of = np.zeros(model.vocabs.target_vocab.size, np.int32) - 1
    for d, ids in enumerate(deciles):
        dec_of[ids] = d
    for batch in reader:
        with torch.inference_mode():
            _, topk_ids, _ = eval_step(
                model.params, model.device_batch(batch), dims=model.dims,
                top_k=cfg.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION,
                compute_dtype=model.compute_dtype,
                use_kernel=model.use_kernel, mesh=model.mesh)
        nv = batch.num_valid_examples
        top1 = topk_ids[:nv, 0].cpu().numpy()
        true = batch.target_index[:nv]
        for t, p in zip(true, top1):
            d = dec_of[t]
            if d >= 0:
                count[d] += 1
                correct[d] += float(t == p)
    top1_by_decile = (correct / np.maximum(count, 1)).round(4)

    # --- table / optimizer-state statistics per decile ---
    emb = model.params["target_emb"].detach().to(torch.float32).cpu().numpy()
    row_norm = np.linalg.norm(emb, axis=1)
    # chain(scale_by_adam_f32_moments, scale_by_learning_rate) -> [0]
    adam = model.opt_state[0]
    nu = adam.nu["target_emb"]
    mu = adam.mu["target_emb"]
    nu_row = torch.mean(nu, dim=1).to(torch.float32).cpu().numpy()
    count_t = int(adam.count)
    bc1 = 1.0 - 0.9 ** max(count_t, 1)
    bc2 = 1.0 - 0.999 ** max(count_t, 1)
    upd = torch.mean(torch.abs((mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)),
                     dim=1).to(torch.float32).cpu().numpy()
    return {"epoch": epoch_end, "tables_dtype": tables_dtype, "lr": lr,
            "top1_by_decile": top1_by_decile.tolist(),
            "row_norm_by_decile":
                [round(float(row_norm[ids].mean()), 4) for ids in deciles],
            "nu_by_decile": [float(nu_row[ids].mean()) for ids in deciles],
            "lr_x_update_by_decile":
                [float(lr * upd[ids].mean()) for ids in deciles],
            # bf16 rounding threshold for a row of this scale: updates
            # below norm/sqrt(D)/256 round to nothing
            "bf16_round_threshold_by_decile":
                [round(float(row_norm[ids].mean())
                       / np.sqrt(emb.shape[1]) / 256, 8)
                 for ids in deciles]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m code2vec_tpu_torch.tools.sampled_decay_study")
    ap.add_argument("--data", required=True)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--probe_epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--num_sampled", type=int, default=4096)
    ap.add_argument("--tables_dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=239)
    ap.add_argument("--out", default=None)
    ap.add_argument("--backend", choices=("gpu", "cpu"), default="gpu",
                    help="gpu (default): the CUDA card, exit 2 without "
                         "one; cpu")
    args = ap.parse_args(argv)

    from code2vec_tpu_torch.tools import loadgen
    if loadgen.gpu_missing(args.backend):
        return 2
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer

    cfg = Config(
        MAX_CONTEXTS=200, MAX_TOKEN_VOCAB_SIZE=150_000,
        MAX_PATH_VOCAB_SIZE=150_000, MAX_TARGET_VOCAB_SIZE=60_000,
        TRAIN_BATCH_SIZE=args.batch, TEST_BATCH_SIZE=args.batch,
        NUM_TRAIN_EPOCHS=args.probe_epochs, SAVE_EVERY_EPOCHS=1000,
        NUM_BATCHES_TO_LOG_PROGRESS=100000, LEARNING_RATE=args.lr,
        SEED=args.seed, USE_SAMPLED_SOFTMAX=True,
        NUM_SAMPLED_CLASSES=args.num_sampled,
        TABLES_DTYPE=args.tables_dtype,
        # the probes read Adam's mu/nu state: pin adam (the default is
        # adafactor, whose state is factored)
        EMBEDDING_OPTIMIZER="adam",
    )
    cfg.train_data_path = args.data
    cfg.test_data_path = args.data + ".val.c2v"
    model = Code2VecTrainer.from_config(
        cfg, device=loadgen.backend_device(args.backend))
    deciles = target_freq_deciles(model.vocabs, args.data)

    done = 0
    while done < args.epochs:
        t0 = time.time()
        model.train()  # runs cfg.NUM_TRAIN_EPOCHS (= probe_epochs)
        done += cfg.NUM_TRAIN_EPOCHS
        print(f"epochs {done}/{args.epochs} "
              f"({time.time() - t0:.0f}s)", file=sys.stderr)
        out = probe(model, deciles, done, args.lr, args.tables_dtype)
        print(json.dumps(out), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

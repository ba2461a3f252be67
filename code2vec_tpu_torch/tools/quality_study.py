#!/usr/bin/env python3
"""Quality ablation: sampled softmax and low precision against the exact
configuration, over the port: the counterpart of tools/quality_study.py
of the JAX package, with its six VARIANTS, its flags and its row keys,
training `Code2VecTrainer` (the dense step: the bag through kernel 1,
the transformer through kernels 2 and 3, int8 tables through kernel 4).

It shows on a >= 50K-name corpus that
  - sampled softmax matches full softmax F1 (the java-large config), and
  - bf16 tables / the Adafactor table optimizer (the fast configs) match
    f32 / Adam F1
at matched steps, seeds and data order.

The port's recipe (the JAX package's, with the port's own tools):
  python -m code2vec_tpu_torch.tools.gen_java_corpus --out /tmp/qs/raw \\
      --names 50000 --methods 250000 --seed 7
  X=$(python -c 'from code2vec_tpu_torch.extractor import native; \\
      print(native.binary_path())')     # c2v_extract, built at first use
  for s in train val test; do $X --dir /tmp/qs/raw/$s --max_path_length 8 \\
      --max_path_width 2 --num_threads 8 > /tmp/qs/qs.$s.raw.txt; done
  shuf /tmp/qs/qs.train.raw.txt -o /tmp/qs/qs.train.raw.txt
  python -m code2vec_tpu_torch.data.preprocess \\
      --train_data /tmp/qs/qs.train.raw.txt \\
      --val_data /tmp/qs/qs.val.raw.txt \\
      --test_data /tmp/qs/qs.test.raw.txt --max_contexts 200 \\
      --word_vocab_size 1301136 --path_vocab_size 911417 \\
      --target_vocab_size 261245 --output_name /tmp/qs/ds/qs
  python -m code2vec_tpu_torch.data.binarize --data /tmp/qs/ds/qs \\
      --max_contexts 200
  python -m code2vec_tpu_torch.tools.quality_study --data /tmp/qs/ds/qs \\
      --epochs 6 [--variants full-f32-adam,sampled-f32-adam,...]
Prints one JSON line per variant and a summary table. `--backend gpu`
(the default) trains on the CUDA card and exits 2 without one; `cpu`
trains on the CPU. `train_seconds` is the training loop's wall time,
which ends with the loop's read of its losses from the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

VARIANTS = {
    # name: (use_sampled, tables_dtype, embedding_optimizer, encoder)
    "full-f32-adam": (False, "float32", "adam", "bag"),
    "sampled-f32-adam": (True, "float32", "adam", "bag"),
    "sampled-bf16-adam": (True, "bfloat16", "adam", "bag"),
    "sampled-bf16-adafactor": (True, "bfloat16", "adafactor", "bag"),
    "sampled-int8-adafactor": (True, "int8", "adafactor", "bag"),
    "sampled-bf16-xf2": (True, "bfloat16", "adam", "transformer"),
}


def run_variant(name: str, data: str, epochs: int, batch: int,
                num_sampled: int, seed: int, lr: float = 1e-3,
                lr_schedule: str = "constant",
                max_contexts: int = 200,
                save_path: str = None,
                warmup_steps: int = 0,
                trust_ratio: bool = False,
                trust_ratio_scope: str = "all", device=None) -> dict:
    """Train and evaluate variant `name` (the `Config` fields the JAX
    `run_variant` sets) on `device` (None: the card); its row, printed
    as one JSON line."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer

    use_sampled, tdtype, eopt, encoder = VARIANTS[name]
    cfg = Config(
        MAX_CONTEXTS=max_contexts,
        MAX_TOKEN_VOCAB_SIZE=150_000,
        MAX_PATH_VOCAB_SIZE=150_000,
        MAX_TARGET_VOCAB_SIZE=60_000,
        TRAIN_BATCH_SIZE=batch,
        TEST_BATCH_SIZE=batch,
        NUM_TRAIN_EPOCHS=epochs,
        SAVE_EVERY_EPOCHS=1000,
        NUM_BATCHES_TO_LOG_PROGRESS=100,
        LEARNING_RATE=lr,
        LR_SCHEDULE=lr_schedule,
        LR_WARMUP_STEPS=warmup_steps,
        TRUST_RATIO=trust_ratio,
        TRUST_RATIO_SCOPE=trust_ratio_scope,
        SEED=seed,
        USE_SAMPLED_SOFTMAX=use_sampled,
        NUM_SAMPLED_CLASSES=num_sampled,
        TABLES_DTYPE=tdtype,
        EMBEDDING_OPTIMIZER=eopt,
        ENCODER_TYPE=encoder,
    )
    cfg.train_data_path = data
    cfg.test_data_path = data + ".val.c2v"
    cfg.verify()  # a combination the rules refuse raises here
    model = Code2VecTrainer.from_config(cfg, device=device)
    t0 = time.time()
    model.train()
    train_s = time.time() - t0
    if save_path:
        # outside the timed window, as the JAX study saves
        model.save(save_path)
    res = model.evaluate()
    out = {
        "variant": name,
        "use_sampled_softmax": use_sampled,
        "tables_dtype": tdtype,
        "embedding_optimizer": eopt,
        "encoder": encoder,
        "epochs": epochs,
        "batch": batch,
        "lr": lr,
        "lr_schedule": lr_schedule,
        "warmup_steps": warmup_steps,
        "trust_ratio": trust_ratio,
        "trust_ratio_scope": trust_ratio_scope,
        "max_contexts": max_contexts,
        "steps": model.step_num,
        "train_seconds": round(train_s, 1),
        "val_loss": round(float(res.loss), 4),
        "val_top1": round(res.topk_acc[0], 4),
        "val_top5": round(res.topk_acc[4], 4),
        "val_precision": round(res.subtoken_precision, 4),
        "val_recall": round(res.subtoken_recall, 4),
        "val_f1": round(res.subtoken_f1, 4),
        "target_vocab_size": model.vocabs.target_vocab.size,
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m code2vec_tpu_torch.tools.quality_study")
    ap.add_argument("--data", required=True)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=1024,
                    help="batch size; with matched --epochs, different "
                         "batch sizes see the same token budget")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr_schedule", default="constant",
                    choices=["constant", "cosine", "linear",
                             "warmup_cosine"])
    ap.add_argument("--warmup_steps", type=int, default=0,
                    help="warmup_cosine warmup length (0 = auto 5%%)")
    ap.add_argument("--trust_ratio", action="store_true",
                    help="LAMB-style per-array trust ratio")
    ap.add_argument("--trust_ratio_scope", default="all",
                    choices=["all", "dense"],
                    help="'dense' = trust-scale non-table params only")
    ap.add_argument("--num_sampled", type=int, default=1024)
    ap.add_argument("--max_contexts", type=int, default=200,
                    help="match the dataset's binarized width (200 for "
                         "the production corpus; smaller for smokes)")
    ap.add_argument("--seed", type=int, default=239)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--save", default=None,
                    help="checkpoint dir prefix (enables the decay "
                         "study's per-epoch analysis)")
    ap.add_argument("--out", default=None,
                    help="append JSON lines here too")
    ap.add_argument("--backend", choices=("gpu", "cpu"), default="gpu",
                    help="gpu (default): the CUDA card, exit 2 without "
                         "one; cpu")
    args = ap.parse_args(argv)

    from code2vec_tpu_torch.tools import loadgen
    if loadgen.gpu_missing(args.backend):
        return 2
    device = loadgen.backend_device(args.backend)
    results = []
    for name in args.variants.split(","):
        r = run_variant(name.strip(), args.data, args.epochs, args.batch,
                        args.num_sampled, args.seed, lr=args.lr,
                        lr_schedule=args.lr_schedule,
                        max_contexts=args.max_contexts,
                        save_path=(args.save + "." + name.strip()
                                   if args.save else None),
                        warmup_steps=args.warmup_steps,
                        trust_ratio=args.trust_ratio,
                        trust_ratio_scope=args.trust_ratio_scope,
                        device=device)
        results.append(r)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")

    print("\nvariant                    B     lr      sched     F1      "
          "top1    loss")
    for r in results:
        print(f"{r['variant']:26s} {r['batch']:<5d} {r['lr']:<7g} "
              f"{r['lr_schedule']:9s} {r['val_f1']:.4f}  "
              f"{r['val_top1']:.4f}  {r['val_loss']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""VarMisuse-head robustness sweep: untargeted rename attacks over a
`.vm.c2v` split.

Counterpart of `attacks/vm_robustness.py` in the JAX package (the VM
counterpart of attacks/robustness.py — the same protocol from
"Adversarial Examples for Models of Code", which attacked its VarMisuse
model the same way).

CLI, over a varmisuse checkpoint of the port (loaded as the command
line loads it, `VarMisuseModel.from_config`):

  python -m code2vec_tpu_torch.attacks.vm_robustness --load <vm_ckpt> \\
      --test <file.vm.c2v> [--n 200] [--max_renames 1] [--iters 4] \\
      [--topk 32] [--out report.json] [--backend gpu|cpu]

Prints one JSON line: mislocalization (attack success) rate, clean and
under-attack localization accuracy. The sweep is serial (one
attack_method per row), as in the JAX package. `--backend gpu` (the
default) exits 2 without a CUDA card.
"""

from __future__ import annotations

import itertools
import json
import sys
import time
from typing import Optional

import numpy as np

from code2vec_tpu_torch.attacks.vm_attack import VMGradientRenameAttack
from code2vec_tpu_torch.data.vm_reader import parse_vm_rows


def evaluate_vm_robustness(model, test_path: str, *,
                           n_methods: int = 200, max_renames: int = 1,
                           max_iters: int = 4,
                           top_k_candidates: int = 32,
                           log=print) -> dict:
    """Attacks up to `n_methods` valid rows of `test_path` with the
    untargeted VM rename attack and aggregates. `model` is a
    `VarMisuseModel`: its params, device and kernel choice are the
    attack's."""
    attack = VMGradientRenameAttack(
        model.dims, model.vocabs.token_vocab,
        top_k_candidates=top_k_candidates, max_iters=max_iters,
        compute_dtype=model.compute_dtype, device=model.device,
        use_kernel=model.use_kernel)
    cfg = model.config
    with open(test_path, encoding="utf-8") as f:
        lines = list(itertools.islice(
            (ln for ln in f if ln.strip()), n_methods))
    labels, src, pth, dst, mask, cand, cmask, valid, _ = parse_vm_rows(
        lines, model.vocabs, cfg.MAX_CONTEXTS, cfg.MAX_CANDIDATES)

    n = moved = clean_correct = attacked_correct = 0
    iters_on_success = []
    t0 = time.time()
    for i in range(len(lines)):
        if valid[i] == 0 or mask[i].sum() == 0:
            continue
        # protocol parity with robustness.py: rows with no attackable
        # candidate are excluded, not counted as robust
        if not attack.attackable_slots(cand[i], cmask[i]):
            continue
        row = (src[i], pth[i], dst[i], mask[i], cand[i], cmask[i])
        res = attack.attack_method(model.params, row, targeted=False,
                                   max_renames=max_renames)
        n += 1
        clean_correct += res.original_slot == int(labels[i])
        attacked_correct += res.final_slot == int(labels[i])
        if res.success:
            moved += 1
            iters_on_success.append(res.iterations)
        if n % 25 == 0:
            log(f"vm robustness: {n} rows, "
                f"{moved / n:.3f} mislocalization rate so far")
    dt = time.time() - t0
    return {
        "metric": "vm_untargeted_rename_mislocalization_rate",
        "n_methods": n,
        "attack_success_rate": round(moved / max(n, 1), 4),
        "robustness": round(1.0 - moved / max(n, 1), 4),
        "clean_localization_acc": round(clean_correct / max(n, 1), 4),
        "attacked_localization_acc": round(
            attacked_correct / max(n, 1), 4),
        "mean_iterations_on_success": round(
            float(np.mean(iters_on_success)), 2) if iters_on_success
        else None,
        "max_renames": max_renames,
        "max_iters": max_iters,
        "seconds": round(dt, 1),
    }


def main(argv: Optional[list] = None) -> int:
    import argparse

    import torch

    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.vm_model import VarMisuseModel

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--load", required=True, help="varmisuse checkpoint")
    p.add_argument("--test", required=True, help=".vm.c2v file")
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--max_renames", type=int, default=1)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--topk", type=int, default=32)
    p.add_argument("--out", default=None, help="also write JSON here")
    p.add_argument("--backend", default="gpu", choices=["gpu", "cpu"],
                   help="gpu (default): the CUDA card; cpu")
    a = p.parse_args(argv)
    if a.backend == "gpu" and not torch.cuda.is_available():
        print("error: --backend gpu (the default) needs a CUDA card and "
              "none is available; pass --backend cpu to run on the CPU",
              file=sys.stderr)
        return 2

    cfg = Config(HEAD="varmisuse", BACKEND=a.backend)
    cfg.load_path = a.load
    model = VarMisuseModel.from_config(
        cfg, device="cpu" if a.backend == "cpu" else None)
    report = evaluate_vm_robustness(
        model, a.test, n_methods=a.n, max_renames=a.max_renames,
        max_iters=a.iters, top_k_candidates=a.topk, log=cfg.log)
    line = json.dumps(report)
    print(line)
    if a.out:
        with open(a.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Is one training step deterministic? Five configurations, one step each.

    CUBLAS_WORKSPACE_CONFIG=:4096:8 \\
        python3 -m code2vec_tpu_torch.tools.determinism [--configs abcde]
        [--vocab N] [--batch B] [--device cuda|cpu] [--out FILE]

The configurations are those of `chip_smoke.py`'s training phases, at
E = 128, C = 200 and bf16 compute, over a synthetic batch whose ids are
drawn Zipf (s = 1.1) over a vocabulary of `--vocab` rows (so many ids
repeat, as they do at java-large): (a) sparse-row, bf16 tables, sampled
softmax; (b) sparse-row, int8 token/path tables, full softmax; (c) the
dense defaults (Adafactor, cosine LR, bf16 tables, full softmax); (d)
dense, int8 tables, sampled softmax; (e) the transformer (L = 2, H = 3),
sampled softmax, constant LR.

For each, from one cloned state and one set of draws:

- `twice`: the step run twice; every param and optimizer tensor and the
  loss must be the same bits;
- `ops`: the aten ops of one step (a `TorchDispatchMode` log), and among
  them those that add with atomics on a CUDA tensor (PyTorch's
  nondeterministic list: `index_add`, `index_put` with
  `accumulate=True`, `scatter_add`, `scatter_reduce`, `put_`,
  `index_copy`, the embedding-bag backward, and the backward of
  `index_select`, which is an `index_add`; the embedding backward, which
  sorts and sums without atomics, is not among them);
- `strict`: the step under `torch.use_deterministic_algorithms(True,
  warn_only=True)`: the warnings PyTorch gives for ops it has no
  deterministic version of, and whether the state equals the `twice`
  run's bits (an op PyTorch swaps for a deterministic version silently
  changes them). cuBLAS needs `CUBLAS_WORKSPACE_CONFIG` set before its
  first call in that mode; the tool sets it at start where unset.

It prints one JSON line per configuration and, on the card, the card's
name and power limit; `--out` writes the lines as a JSON list. Exit
status 0 whatever it finds: it reports.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import warnings
from typing import Dict, List

# before torch initialises cuBLAS (the `strict` mode needs it)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

# aten ops that add with atomics on a CUDA tensor (by their overload
# packet's name); index_put counts only with accumulate=True
ATOMIC_OPS = ("index_add", "index_add_", "index_put", "index_put_",
              "_index_put_impl_", "scatter_add", "scatter_add_",
              "scatter_reduce", "scatter_reduce_", "put_", "index_copy",
              "index_copy_", "index_select_backward",
              "_embedding_bag_backward", "_embedding_bag_dense_backward")

C, E = 200, 128


class _OpLog(TorchDispatchMode):
    """Counts every aten op dispatched (by overload packet name); the
    index_put family counts only when it accumulates."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in ("index_put", "index_put_", "_index_put_impl_"):
            acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
            name += "(accumulate)" if acc else ""
        self.ops[name] = self.ops.get(name, 0) + 1
        return func(*args, **kwargs)


def _config(label: str, vocab: int, batch: int):
    from code2vec_tpu_torch.config import Config
    base = dict(MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E,
                TRAIN_BATCH_SIZE=batch, USE_BF16=True, SEED=0,
                NUM_SAMPLED_CLASSES=min(4096, vocab))
    sparse = dict(SPARSE_EMBEDDING_UPDATES=True, EMBEDDING_OPTIMIZER="adam",
                  LR_SCHEDULE="constant")
    return Config(**base, **{
        "a": dict(TABLES_DTYPE="bfloat16", USE_SAMPLED_SOFTMAX=True, **sparse),
        "b": dict(TABLES_DTYPE="int8", **sparse),
        "c": dict(),
        "d": dict(TABLES_DTYPE="int8", USE_SAMPLED_SOFTMAX=True),
        "e": dict(ENCODER_TYPE="transformer", XF_LAYERS=2, XF_HEADS=3,
                  LEARNING_RATE=1e-3, LR_SCHEDULE="constant",
                  USE_SAMPLED_SOFTMAX=True),
    }[label])


def _vocabs(n: int):
    from code2vec_tpu_torch.vocab.vocabularies import (Code2VecVocabs,
                                                       Vocab, VocabType)
    return Code2VecVocabs(
        Vocab(VocabType.Token, (f"tok{i}" for i in range(n))),
        Vocab(VocabType.Path, (f"p{i}" for i in range(n))),
        Vocab(VocabType.Target, (f"m|n{i}" for i in range(n))))


def synthetic_batch(dims, batch: int, device, seed: int = 0):
    """(labels, src, pth, dst, mask, weights) on `device`: 20-200 live
    contexts a method, ids Zipf (s = 1.1) over each vocabulary, the rest
    of the row id 0 and masked."""
    r = np.random.default_rng(seed)

    def zipf(n, shape):
        p = 1.0 / np.arange(1, n + 1) ** 1.1
        return r.choice(n, size=shape, p=p / p.sum()).astype(np.int32)
    live = r.integers(20, C + 1, size=batch)
    mask = (np.arange(C)[None, :] < live[:, None]).astype(np.float32)
    src, dst = (zipf(dims.token_vocab_size, (batch, C)) * (mask > 0)
                for _ in range(2))
    pth = zipf(dims.path_vocab_size, (batch, C)) * (mask > 0)
    labels = zipf(dims.target_vocab_size, (batch,))
    arrays = (labels, src.astype(np.int32), pth.astype(np.int32),
              dst.astype(np.int32), mask, np.ones(batch, np.float32))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _state(trainer):
    return {"params": trainer.params, "opt_state": trainer.opt_state}


def _restore(trainer, start) -> None:
    from code2vec_tpu_torch.training.checkpoint import state_tensors
    for dst, src in zip(state_tensors(_state(trainer)), state_tensors(start)):
        dst.copy_(src)


def _differing(a, b) -> List[str]:
    """Paths of the tensors of two state trees that are not the same
    bits."""
    names: List[str] = []

    def walk(x, y, path):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                names.append(path)
        elif isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            fields = getattr(x, "_fields", range(len(x)))
            for k, u, v in zip(fields, x, y):
                walk(u, v, f"{path}/{k}")
    walk(a, b, "")
    return names


def check_config(label: str, vocab: int, batch: int, device) -> dict:
    """The three readings of one configuration (see the module's
    docstring)."""
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.training.checkpoint import (map_state,
                                                        state_tensors)
    cfg = _config(label, vocab, batch)
    trainer = Code2VecTrainer(cfg, _vocabs(vocab), device=device)
    data = synthetic_batch(trainer.dims, batch, trainer.device)
    draws = trainer.draws_for(batch, 0)
    start = map_state(lambda t: t.detach().clone(), _state(trainer))

    def step():
        _restore(trainer, start)
        loss = trainer._train_step(trainer.params, trainer.opt_state, data,
                                   draws)
        return loss.detach().clone(), map_state(
            lambda t: t.detach().clone(), _state(trainer))

    loss1, state1 = step()
    loss2, state2 = step()
    log = _OpLog()
    with log:
        step()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            loss3, state3 = step()
        finally:
            torch.use_deterministic_algorithms(False)
    twice = _differing(state1, state2)
    strict = _differing(state1, state3)
    return {
        "config": label, "device": str(trainer.device), "vocab": vocab,
        "batch": batch, "tensors": len(state_tensors(state1)),
        "twice_same_bits": not twice and torch.equal(loss1, loss2),
        "twice_differ": twice, "loss": float(loss1),
        "atomic_ops": {k: v for k, v in log.ops.items()
                       if k.split("(")[0] in ATOMIC_OPS
                       and (not k.startswith(("index_put", "_index_put"))
                            or k.endswith("(accumulate)"))},
        "ops": dict(sorted(log.ops.items())),
        "strict_warnings": sorted({str(w.message).split("\n")[0]
                                   for w in caught}),
        "strict_same_bits": not strict and torch.equal(loss1, loss3),
        "strict_differ": strict}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs", default="abcde")
    ap.add_argument("--vocab", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("determinism: CUDA is not available", file=sys.stderr)
        return 2
    rows = []
    for label in args.configs:
        row = check_config(label, args.vocab, args.batch, args.device)
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "ops"}),
              flush=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

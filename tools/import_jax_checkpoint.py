#!/usr/bin/env python3
"""Import a checkpoint of the JAX package into the PyTorch port's format.

The port (`code2vec_tpu_torch/`) writes its state with `torch.save` and
imports nothing of JAX; the JAX package writes an orbax tree, and
reading one loads `jax`. This tool runs where the JAX package is
installed:

  python tools/import_jax_checkpoint.py --jax_checkpoint <dir> \
      --save <out_dir> [--jax_platform cpu]

1. The JAX package's model of the manifest's `head` (`Code2VecModel`,
   or `VarMisuseModel` for a `--head varmisuse` checkpoint) restores the
   checkpoint's latest step (`code2vec_tpu.training.checkpoint.
   load_checkpoint`, verified against its checksums): params, optimizer
   state and step, or params alone from a released checkpoint.
2. `code2vec_tpu_torch/convert.py` carries them across bit for bit
   (`params_from_numpy`, and `dense_opt_state_from_numpy` or
   `sparse_opt_state_from_numpy` by the manifest's
   `sparse_embedding_updates`).
3. The port's step-dir format is written at the same step: `step_<N>/
   state/state.pt` with its checksums and topology (the saved epoch
   kept), and the source's `manifest.json` and `vocab.pkl` as they are.

Then: `python3 -m code2vec_tpu_torch --load <out_dir> --test <file>`
(or `--data ... --save <out_dir> --auto_resume` to train on); the port
reads the head from the manifest.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def import_checkpoint(src: str, dest: str) -> int:
    """Convert the JAX checkpoint dir `src` into the port's dir `dest`;
    returns the step written."""
    import jax
    import numpy as np

    from code2vec_tpu.config import Config as JaxConfig
    from code2vec_tpu.training import checkpoint as jax_ckpt
    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.training import checkpoint as torch_ckpt
    from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs

    manifest = jax_ckpt.load_manifest(src)
    cfg = JaxConfig()
    cfg.load_path = src
    # restores params, opt_state and step
    if manifest.get("head", "code2vec") == "varmisuse":
        from code2vec_tpu.models.vm_model import VarMisuseModel
        cfg.HEAD = "varmisuse"
        model = VarMisuseModel(cfg)
    else:
        from code2vec_tpu.models.jax_model import Code2VecModel
        model = Code2VecModel(cfg)

    def host(tree):
        return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))

    params = convert.params_from_numpy(host(model.params), "cpu")
    if manifest.get("released"):
        torch_ckpt.release_checkpoint(src, dest, params)
        return int(manifest.get("step", 0))
    if manifest.get("sparse_embedding_updates"):
        opt_state = convert.sparse_opt_state_from_numpy(
            host(model.opt_state), "cpu")
    else:
        opt_state = convert.dense_opt_state_from_numpy(
            host(model.opt_state), "cpu")
    step = int(model.step_num)
    topology = jax_ckpt.load_step_topology(src, step) or {}
    torch_ckpt.save_checkpoint(
        dest, {"params": params, "opt_state": opt_state, "step": step},
        step, Code2VecVocabs.load(os.path.join(src, "vocab.pkl")),
        torch_ckpt.load_dims(src), extra_manifest=manifest,
        topology={"epoch": topology.get("epoch")})
    for name in ("manifest.json", "vocab.pkl"):
        shutil.copy(os.path.join(src, name), os.path.join(dest, name))
    return step


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--jax_checkpoint", required=True,
                   help="a checkpoint dir the JAX package wrote")
    p.add_argument("--save", required=True,
                   help="the port's checkpoint dir to write")
    p.add_argument("--jax_platform", default=None,
                   help="JAX platform to restore on (e.g. cpu)")
    args = p.parse_args(argv)
    if args.jax_platform:
        import jax
        jax.config.update("jax_platforms", args.jax_platform)
    step = import_checkpoint(args.jax_checkpoint, args.save)
    print(f"import_jax_checkpoint: step {step} of {args.jax_checkpoint} "
          f"-> {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The command line: `python3 -m code2vec_tpu_torch ...`.

A copy of `main` of the JAX package's `code2vec.py`, in its dispatch
order, for the ported flags (config.Config.arguments_parser):

  python3 -m code2vec_tpu_torch --data <prefix> --test <file> \\
      --save/--load <ckpt> [--auto_resume] [--predict] [--release] \\
      [--export_code_vectors] [--save_w2v <p>] [--save_t2v <p>] \\
      [--telemetry_dir <d> [--trace] [--watchdog_stall_s <s>]] \\
      [--profile <d>] [--tensorboard <d>] [--faults <json>] \\
      [--head code2vec|varmisuse [--max_candidates K]] \\
      [--attack targeted|untargeted [--attack_target <name>] \\
       [--attack_input <file>] [--attack_deadcode] ...] \\
      [--adv_rename_prob <p> [--adv_rename_mode uniform|batch]] \\
      [--dist_coordinator <host:port> --dist_num_processes <N> \
       --dist_process_id <i> [--mesh_data <N>]] \
      [--backend gpu|cpu] [--framework ...]

0. `--faults`: the failpoint registry is armed before anything is built
   (a bad spec exits 2); then the process group is joined when the
   `--dist_*` flags (or the environment) ask for it
   (parallel/distributed.maybe_initialize, where the JAX package's
   `code2vec.py` calls it): one process a rank, over the backend rule's
   nccl or gloo, each rank training on its host shard; only rank 0
   writes checkpoints and exports;
1. `--auto_resume` with `--save` and `--data`: a checkpoint already in
   `--save` is loaded (before `--load`, a fine-tune's starting point)
   and its run continued;
2. with `--load`: the checkpoint's `head` and `tables_dtype` are
   adopted (an explicit `--head` that differs exits 2), then the
   configuration is verified a second time; `--head varmisuse` builds
   the VarMisuse model (models/vm_model.py), else the code2vec trainer;
3. `--release`: an inference-only copy of the loaded checkpoint, and
   nothing else; `--attack`: the source-level rename (or, with
   `--attack_deadcode`, dead-code) attack on `--attack_input`
   (attacks/source_attack.py), its outcome printed as the model predicts
   the rewritten, re-extracted source, `<attack_input>.adversarial`
   written only on a verified success, and nothing else;
4. `--data`: train (with `--save`, a checkpoint every SAVE_EVERY_EPOCHS
   epochs; with `--test`, an evaluation after each); the varmisuse head
   reads `<data>.train.vm.c2v`;
5. `--save_w2v` / `--save_t2v`: the token / target tables in word2vec
   text format;
6. `--predict`: the REPL over Input.java in the working directory
   (serving/interactive_predict.py), through the extractor pool and the
   prediction server;
7. else `--test` without `--data`: evaluate and print the results; with
   `--export_code_vectors`, also `<test>.vectors`.

`--backend gpu` (the default) runs on the CUDA card and exits 2 where
there is none; it never falls back to the CPU. `--backend cpu` runs on
the CPU. Errors of the command line exit 2.
"""

from __future__ import annotations

import json
import os
import sys
from typing import List, Optional

import torch

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.vocab.vocabularies import VocabType


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def main(argv: Optional[List[str]] = None) -> int:
    try:
        config = Config.load_from_args(argv)
    except ValueError as e:
        return _error(str(e))
    if not config.FAULTS:
        return _run(config)
    # armed before anything is built (the sites fetch their handles at
    # setup time), and disarmed when this run ends: main may be called
    # again in the same process
    from code2vec_tpu_torch.resilience import faults
    try:
        faults.install(config.FAULTS, log=config.log)
    except ValueError as e:
        return _error(f"--faults: {e}")
    try:
        return _run(config)
    finally:
        faults.clear()


def _attack(config: Config, predictor) -> int:
    """`--attack`: the printed outcome is the model's prediction on the
    REWRITTEN source, re-extracted; only a verified success earns the
    `.adversarial` file (scripts treat its existence as the signal)."""
    from code2vec_tpu_torch.attacks.source_attack import (
        SourceAttack, normalize_target_name)
    attack = SourceAttack(config, predictor,
                          top_k_candidates=config.ATTACK_TOPK,
                          max_iters=config.ATTACK_ITERS)
    try:
        result = attack.attack_file(
            config.ATTACK_INPUT, method_index=config.ATTACK_METHOD_INDEX,
            targeted=config.ATTACK == "targeted",
            target_name=normalize_target_name(config.ATTACK_TARGET),
            max_renames=config.ATTACK_MAX_RENAMES,
            deadcode=config.ATTACK_DEADCODE)
    except ValueError as e:
        return _error(str(e))
    print(str(result))
    if result.adversarial_source is not None and result.verified_success:
        dest = config.ATTACK_INPUT + ".adversarial"
        with open(dest, "w", encoding="utf-8") as f:
            f.write(result.adversarial_source)
        config.log(f"adversarial source -> {dest}")
    return 0


def _run(config: Config) -> int:
    if config.BACKEND == "gpu" and not torch.cuda.is_available():
        return _error("--backend gpu (the default) needs a CUDA card and "
                      "none is available; pass --backend cpu to run on the "
                      "CPU")
    from code2vec_tpu_torch.parallel import distributed
    try:
        joined = distributed.maybe_initialize(
            config.DIST_COORDINATOR, config.DIST_NUM_PROCESSES,
            config.DIST_PROCESS_ID, log=config.log,
            device_type="cpu" if config.BACKEND == "cpu" else "cuda")
    except ValueError as e:
        return _error(str(e))
    try:
        return _run_joined(config, distributed.rank_device()
                           if joined else None)
    finally:
        if joined:
            distributed.shutdown()


def _run_joined(config: Config, rank_device) -> int:
    device = "cpu" if config.BACKEND == "cpu" else rank_device
    from code2vec_tpu_torch.parallel.compat import cohort_world
    writer = cohort_world()[0] == 0  # the rank that writes files
    from code2vec_tpu_torch.training.checkpoint import latest_step
    if config.AUTO_RESUME and config.is_saving and config.is_training:
        step = latest_step(config.save_path)
        if step is not None:
            if config.is_loading and config.load_path != config.save_path:
                config.log(f"--auto_resume: --save has checkpoint step "
                           f"{step}; resuming from it instead of --load "
                           f"{config.load_path}")
            else:
                config.log(f"--auto_resume: found checkpoint step {step} in "
                           f"{config.save_path}; resuming")
            config.load_path = config.save_path
    if config.is_loading:
        mpath = os.path.join(config.load_path, "manifest.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                manifest = json.load(f)
            # the checkpoint knows its head: adopted, or cross-checked
            # against an explicit --head
            head = manifest.get("head", "code2vec")
            if config.HEAD_EXPLICIT and head != config.HEAD:
                return _error(f"checkpoint was trained with --head {head}, "
                              f"but --head {config.HEAD} was given")
            config.HEAD = head
            config.TABLES_DTYPE = manifest.get("tables_dtype",
                                               config.TABLES_DTYPE)
    # verified again now that the checkpoint's values are in
    try:
        config.verify_command_line()
    except ValueError as e:
        return _error(str(e))

    if config.HEAD == "varmisuse":
        from code2vec_tpu_torch.models.vm_model import \
            VarMisuseModel as model_cls
    else:
        from code2vec_tpu_torch.models.torch_model import \
            Code2VecTrainer as model_cls
    try:
        model = model_cls.from_config(config, device=device)
    except ValueError as e:
        return _error(str(e))
    config.log(f"model loaded: framework=pytorch backend={config.BACKEND} "
               f"device={model.device}")
    if config.release:
        if writer:
            model.release()
        return 0
    if config.ATTACK:
        return _attack(config, model.predictor())
    if config.is_training:
        model.train()
    if config.save_w2v and writer:
        model.save_word2vec_format(config.save_w2v, VocabType.Token)
        config.log(f"token embeddings (w2v format) -> {config.save_w2v}")
    if config.save_t2v and writer:
        model.save_word2vec_format(config.save_t2v, VocabType.Target)
        config.log(f"target embeddings (w2v format) -> {config.save_t2v}")
    if config.is_predict:
        from code2vec_tpu_torch.serving.interactive_predict import (
            InteractivePredictor)
        InteractivePredictor(config, model.predictor()).predict()
    elif config.is_testing and not config.is_training:
        results = model.evaluate()
        print(str(results))
        if config.export_code_vectors and writer:
            dest = config.test_data_path + ".vectors"
            model.export_code_vectors_file(config.test_data_path, dest)
            config.log(f"code vectors -> {dest}")
    model.close_session()
    return 0

"""Model-construction helpers of the training loop.

A copy of `build_mesh`, `infeed_split`, `resume_epoch_offset` and the
learning-rate horizon of `build_optimizer` from `models/setup.py` in the
JAX package. The mesh is the port's record of the data axis
(parallel/mesh.py): one process a rank, each reading its host shard of
the global per-epoch permutation, so the horizon and the steps per epoch
count the ranks.
"""

from __future__ import annotations

from typing import Callable, Optional

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data.reader import steps_per_epoch
from code2vec_tpu_torch.parallel.compat import cohort_world
from code2vec_tpu_torch.parallel.mesh import Mesh, make_mesh
from code2vec_tpu_torch.training.optimizers import (schedule_total_steps,
                                                    warmup_length)


def infeed_split() -> "tuple[int, int]":
    """(host_shard, num_host_shards) of the train reader: this rank and
    the world of the live process group, (0, 1) without one."""
    return cohort_world()


def build_mesh(cfg: Config, device=None) -> Optional[Mesh]:
    """The run's mesh, or None for a plain single-process run: a mesh
    whenever the process group is up (a world of 1 too, so its step
    runs the collectives) or an axis asks for more than one process,
    over the config's axes (parallel/mesh.make_mesh raises for model,
    ctx or dcn above 1, and for a data axis the world cannot fill)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) and max(
            cfg.MESH_DATA_AXIS, cfg.MESH_MODEL_AXIS, cfg.MESH_CONTEXT_AXIS,
            cfg.MESH_DCN_AXIS) <= 1:
        return None
    return make_mesh(cfg.MESH_DATA_AXIS, cfg.MESH_MODEL_AXIS,
                     cfg.MESH_CONTEXT_AXIS, dcn=cfg.MESH_DCN_AXIS,
                     device=device)


def lr_horizon(cfg: Config, count_examples_fn: Callable[[], int],
               restored_step: int = 0, epochs: Optional[int] = None) -> int:
    """The decay horizon of a non-constant schedule for a training run
    of `epochs` (default NUM_TRAIN_EPOCHS): this run's steps, plus the
    restored step for a plain `--load` fine-tune (it trains a full epoch
    budget more) but not for `--auto_resume` (the restored steps count
    toward NUM_TRAIN_EPOCHS, so the resumed schedule is the original
    run's at every step). A `warmup_cosine` auto warmup (0) is resolved
    to its length here, so the manifest records it and a resume keeps
    it. Returns 0 for the constant schedule, which needs none."""
    if cfg.LR_SCHEDULE == "constant":
        return 0
    total = schedule_total_steps(
        count_examples_fn(), cfg.TRAIN_BATCH_SIZE,
        cfg.NUM_TRAIN_EPOCHS if epochs is None else epochs,
        num_hosts=cohort_world()[1],
        restored_step=0 if cfg.AUTO_RESUME else restored_step)
    if cfg.LR_SCHEDULE == "warmup_cosine":
        cfg.LR_WARMUP_STEPS = warmup_length(total, cfg.LR_WARMUP_STEPS)
    return total


def resume_epoch_offset(cfg: Config, step_num: int,
                        count_examples_fn: Callable[[], int],
                        log: Callable[[str], None]) -> int:
    """Completed epochs to skip on `--auto_resume`: a resumed run trains
    only the remaining epochs, its reader's shuffle stream advanced to
    match; with the step-keyed draws the resumed run replays the
    uninterrupted one. A plain `--load` with `--data` keeps fine-tune
    semantics (a full NUM_TRAIN_EPOCHS more): 0.

    The restored step's `topology.json` `epoch` is the answer when it is
    there (saves happen at epoch boundaries); else the step count over
    the steps per epoch."""
    if not (cfg.AUTO_RESUME and step_num > 0):
        return 0
    topo = None
    if cfg.is_loading:
        from code2vec_tpu_torch.training import checkpoint as ckpt_mod
        topo = ckpt_mod.load_step_topology(cfg.load_path, step_num)
    if topo is not None and topo.get("epoch") is not None:
        completed = min(cfg.NUM_TRAIN_EPOCHS, int(topo["epoch"]))
        if completed:
            log(f"auto-resume: restored step {step_num} = epoch "
                f"{completed} (save-time record); training epochs "
                f"{completed + 1}..{cfg.NUM_TRAIN_EPOCHS}")
        return completed
    save_procs = (int(topo["num_processes"])
                  if topo is not None and topo.get("num_processes")
                  else cohort_world()[1])
    spe = steps_per_epoch(count_examples_fn(), cfg.TRAIN_BATCH_SIZE,
                          save_procs)
    completed = min(cfg.NUM_TRAIN_EPOCHS, step_num // spe)
    if completed:
        log(f"auto-resume: restored step {step_num} = {completed} "
            f"completed epoch(s) x {spe} steps (at {save_procs} "
            f"process(es)); training epochs "
            f"{completed + 1}..{cfg.NUM_TRAIN_EPOCHS}")
    return completed

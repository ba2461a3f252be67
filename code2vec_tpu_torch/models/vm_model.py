"""The VarMisuse model's trainer on PyTorch (`--head varmisuse`).

Counterpart of `VarMisuseModel` in the JAX package's models/vm_model.py:
train, evaluate, predict, save, load and resume for the pointer head of
models/varmisuse.py over `.vm.c2v` data (data/varmisuse_gen.py's
format). The loop, the step plumbing and the saves are
torch_model.TrainerBase's, shared with the code2vec trainer: the infeed
kept warm across epochs (pinned host buffers on the card), the step-keyed
draws, the telemetry, trace, watchdog, live metrics plane, failpoints,
profiler window and `--phase_profile` (over training/phase_probes.
make_vm_probes, with no analytic bytes: the vm head's id counts are not
the traffic model's, so the roofline gauges stay absent rather than
wrong), and async checkpoints whose manifest carries the head's keys.
Under a mesh each rank trains the dense step on its batch shard; under a
model axis it holds a window of rows of every table (the saves gather
whole tables, so a checkpoint loads in one process or on another model
axis), and the evaluation counts one rank of each model group.

The steps are training/vm_steps.py's: the dense step (Adafactor on the
tables, Adam on the rest, `vm_pointer` included) or, with
SPARSE_EMBEDDING_UPDATES, live-row Adam on the two vocab tables (kernel 5
on the card). Every step, evaluation batch and `predict_batch` encodes
through the attention pool (kernel 1 on the card; `--no_pallas` takes its
plain version). On load the checkpoint's configuration wins
(torch_model.adopt_manifest: dims, MAX_CANDIDATES, the optimizer, the
sparse flag, the schedule and warmup).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, NamedTuple, Optional

import numpy as np
import torch

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data.prefetch import prefetch_to_device
from code2vec_tpu_torch.data.vm_reader import (VMTextReader, build_vm_vocabs,
                                               parse_vm_rows)
from code2vec_tpu_torch.models.torch_model import TrainerBase
from code2vec_tpu_torch.models.varmisuse import init_vm_params
from code2vec_tpu_torch.obs import Telemetry
from code2vec_tpu_torch.obs.phases import PhaseProfiler
from code2vec_tpu_torch.parallel.distributed import allreduce_sum_hosts
from code2vec_tpu_torch.training.phase_probes import make_vm_probes
from code2vec_tpu_torch.training.scalars import ScalarWriter
from code2vec_tpu_torch.training.vm_steps import (init_vm_sparse_opt_state,
                                                  make_vm_train_step,
                                                  vm_eval_step)
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs


class VMEvalResults(NamedTuple):
    loss: float
    accuracy: float
    num_examples: int

    def __str__(self) -> str:
        return (f"vm loss: {self.loss:.5f}, pointer accuracy: "
                f"{self.accuracy:.5f} over {self.num_examples} examples")


def vm_data_path(config: Config, split: str) -> str:
    """`<data>.<split>.vm.c2v`."""
    if not config.train_data_path:
        raise ValueError("varmisuse needs --data or --load")
    return f"{config.train_data_path}.{split}.vm.c2v"


class VarMisuseModel(TrainerBase):
    """Trains, evaluates and checkpoints the VarMisuse head on one device,
    or on each rank of a mesh (data and model axes) with the dense step
    (TrainerBase's loop). `device=None` runs on the CUDA card and raises
    when there is none; tests pass `device="cpu"`."""

    HEAD = "varmisuse"

    @classmethod
    def _vocabs_from_data(cls, config: Config) -> Code2VecVocabs:
        """Token and path vocabularies from `<data>.train.vm.c2v`."""
        return build_vm_vocabs(vm_data_path(config, "train"),
                               config.MAX_TOKEN_VOCAB_SIZE,
                               config.MAX_PATH_VOCAB_SIZE)

    def _init_params(self, generator: torch.Generator):
        return init_vm_params(generator, self.dims)

    def _init_sparse_opt_state(self) -> dict:
        return init_vm_sparse_opt_state(self.params, self.optimizer)

    def _build_step(self) -> None:
        self._train_step = make_vm_train_step(
            self.dims, self.optimizer, compute_dtype=self.compute_dtype,
            use_kernel=self.use_kernel, row_kernel=self.row_kernel,
            sparse_updates=self.config.SPARSE_EMBEDDING_UPDATES,
            mesh=self.mesh)
        self.step_config = self._train_step.cfg

    def _train_data_path(self) -> str:
        return vm_data_path(self.config, "train")

    def _train_reader(self, data_path: str, epoch_offset: int):
        cfg = self.config
        shard, shards = self.host_shard()
        return VMTextReader(data_path, self.vocabs, cfg.MAX_CONTEXTS,
                            cfg.MAX_CANDIDATES, cfg.TRAIN_BATCH_SIZE,
                            shuffle=True, seed=cfg.SEED,
                            epoch_offset=epoch_offset, host_shard=shard,
                            num_host_shards=shards)

    def phase_profiler(self, telemetry: Telemetry) -> PhaseProfiler:
        """The sampled phase profiler over make_vm_probes (no analytic
        bytes) when PHASE_PROFILE is on and `telemetry` is live, else the
        shared no-op."""
        cfg = self.config
        if cfg.PHASE_PROFILE != "on" or not telemetry.enabled:
            return PhaseProfiler.disabled()

        def probes():
            return make_vm_probes(
                self.dims, compute_dtype=self.compute_dtype,
                use_kernel=self.use_kernel,
                optimizer=None if cfg.SPARSE_EMBEDDING_UPDATES
                else self.optimizer, mesh=self.mesh)

        def fused_step(_params, _opt_state, batch, draws):
            return self.train_step(batch, draws)  # in place, step_num + 1

        return PhaseProfiler.create(
            telemetry, fused_step=fused_step, probes_factory=probes,
            enabled=True, sample_every=cfg.PHASE_SAMPLE_EVERY, log=cfg.log)

    def evaluate(self, test_path: Optional[str] = None) -> VMEvalResults:
        """The weighted mean loss and pointer accuracy over a `.vm.c2v`
        file (default `test_data_path`), in TEST_BATCH_SIZE batches (no
        dropout); rows whose label was cut count nowhere. Under a mesh
        each batch shard reads its host shard (the ranks of a model group
        together, each scoring from its windows) and the sums are merged
        over the ranks, one rank of each model group counted: every rank
        returns the whole file's results."""
        cfg = self.config
        path = test_path or cfg.test_data_path
        if not path:
            raise ValueError("evaluate needs a test file (--test)")
        shard, shards = self.host_shard()
        reader = VMTextReader(path, self.vocabs, cfg.MAX_CONTEXTS,
                              cfg.MAX_CANDIDATES, cfg.TEST_BATCH_SIZE,
                              host_shard=shard, num_host_shards=shards)
        loss_sum = correct = total = 0.0
        put, ready = self._put_fns(cfg.INFEED_PREFETCH)
        for dev_batch, b in prefetch_to_device(reader, put,
                                               cfg.INFEED_PREFETCH, ready):
            with torch.inference_mode():
                ls, cs, _pred = vm_eval_step(
                    self.params, dev_batch, compute_dtype=self.compute_dtype,
                    use_kernel=self.use_kernel, mesh=self.mesh)
            loss_sum += ls.item()
            correct += cs.item()
            total += b.num_valid_examples
        if self.mesh is not None:
            # one rank of each model group counts its batch shard: its
            # peers hold the same rows
            counted = float(self.mesh.model_index == 0)
            loss_sum, correct, total = allreduce_sum_hosts(
                [loss_sum * counted, correct * counted,
                 total * counted]).tolist()
        total = max(total, 1.0)
        return VMEvalResults(loss_sum / total, correct / total, int(total))

    def _record_eval(self, epoch: int, results: VMEvalResults,
                     eval_ms: float, telemetry: Telemetry,
                     scalars: ScalarWriter) -> None:
        self.config.log(f"vm epoch {epoch}: {results}")
        scalars.write(self.step_num, {"eval/loss": results.loss,
                                      "eval/accuracy": results.accuracy})
        telemetry.event("eval", epoch=epoch, step=self.step_num,
                        loss=results.loss, accuracy=results.accuracy,
                        eval_ms=round(eval_ms, 3))

    def predict_batch(self, rows: Iterable[str]) -> np.ndarray:
        """Pointer predictions (candidate indices, int64 [N]) for
        `.vm.c2v` rows, in one device batch. Under a model axis every rank
        of the model group calls it with the same rows (collective)."""
        cfg = self.config
        (labels, src, pth, dst, mask, cand, cand_mask, row_valid,
         _strings) = parse_vm_rows(list(rows), self.vocabs,
                                   cfg.MAX_CONTEXTS, cfg.MAX_CANDIDATES)
        batch = tuple(torch.from_numpy(a).to(self.device) for a in
                      (labels, src, pth, dst, mask, cand, cand_mask,
                       row_valid))
        with torch.inference_mode():
            _ls, _cs, pred = vm_eval_step(self.params, batch,
                                          compute_dtype=self.compute_dtype,
                                          use_kernel=self.use_kernel,
                                          mesh=self.mesh)
        return pred.cpu().numpy()

    def _manifest_extra(self) -> Dict[str, Any]:
        cfg = self.config
        return {"head": "varmisuse",
                "max_candidates": cfg.MAX_CANDIDATES,
                "embedding_optimizer": cfg.EMBEDDING_OPTIMIZER,
                "sparse_embedding_updates": cfg.SPARSE_EMBEDDING_UPDATES,
                "trust_ratio": cfg.TRUST_RATIO,
                "lr_schedule": cfg.LR_SCHEDULE,
                "lr_warmup_steps": cfg.LR_WARMUP_STEPS}

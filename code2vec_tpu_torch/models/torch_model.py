"""The code2vec model on PyTorch: the predict side and the trainer.

`Code2VecModel` is the counterpart of the predict methods of
`Code2VecModel` in the JAX package's models/jax_model.py: raw extractor
lines are parsed on the host (`prepare_predict_rows`), padded to a
power-of-two bucket and run through the predict step on the device
(`predict_device`), and decoded into names and attention-ranked paths on
the host (`decode_predictions`). The serving layer (serving/server.py)
calls the three phases on different threads.

`Code2VecTrainer` is the train and evaluate subset of the same class: it
builds the optimizer, its state and the step (the dense step by default,
the sparse-row step under SPARSE_EMBEDDING_UPDATES), runs
`train(data_path, max_steps)` over a `.c2v` file and `evaluate(test_path)`
over another. There is no checkpoint or telemetry yet.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from code2vec_tpu_torch.common import (EvaluationResults,
                                       MethodPredictionResults,
                                       SpecialVocabWords)
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data.reader import (BatchTensors, C2VTextReader,
                                            _pad_batch, count_examples,
                                            parse_c2v_rows)
from code2vec_tpu_torch.device import resolve_device
from code2vec_tpu_torch.models.encoder import ModelDims, Params, init_params
from code2vec_tpu_torch.models.model_base import MetricAccumulator
from code2vec_tpu_torch.ops.quant import opt_param_view
from code2vec_tpu_torch.training.draws import StepDraws, make_draws
from code2vec_tpu_torch.training.optimizers import (AdamF32Moments, make_lr,
                                                    make_optimizer,
                                                    schedule_total_steps)
from code2vec_tpu_torch.training.sparse_steps import init_sparse_opt_state
from code2vec_tpu_torch.training.steps import (eval_step, make_train_step,
                                               predict_step)
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs


@dataclasses.dataclass
class PreparedRows:
    """Pre-parsed predict rows (the host half of `predict`): one row per
    method, un-padded leading dim. The serving micro-batcher coalesces
    several requests' rows with `concat` and runs ONE bucketed device
    call (`predict_prepared`)."""

    labels: np.ndarray
    src: np.ndarray
    pth: np.ndarray
    dst: np.ndarray
    mask: np.ndarray
    target_strings: List[str]
    context_strings: List[List[str]]

    @property
    def n(self) -> int:
        return int(self.labels.shape[0])

    def slice(self, start: int, stop: int) -> "PreparedRows":
        """Row slice [start, stop) as numpy views."""
        if start == 0 and stop >= self.n:
            return self
        return PreparedRows(
            self.labels[start:stop], self.src[start:stop],
            self.pth[start:stop], self.dst[start:stop],
            self.mask[start:stop], self.target_strings[start:stop],
            self.context_strings[start:stop])

    @staticmethod
    def concat(items: Sequence["PreparedRows"]) -> "PreparedRows":
        if not items:
            raise ValueError("concat of no rows")
        if len(items) == 1:
            return items[0]
        return PreparedRows(
            labels=np.concatenate([p.labels for p in items]),
            src=np.concatenate([p.src for p in items]),
            pth=np.concatenate([p.pth for p in items]),
            dst=np.concatenate([p.dst for p in items]),
            mask=np.concatenate([p.mask for p in items]),
            target_strings=[s for p in items for s in p.target_strings],
            context_strings=[c for p in items for c in p.context_strings])


def _move(table, device: torch.device):
    if isinstance(table, dict):
        return {k: v.to(device) for k, v in table.items()}
    return table.to(device)


class Code2VecModel:
    """Predict-side model over a params dict (see models/encoder.py).

    `device=None` runs on the CUDA card and raises when there is none;
    tests pass `device="cpu"`."""

    def __init__(self, config: Config, dims: ModelDims,
                 vocabs: Code2VecVocabs, params: Params,
                 device: Optional[Union[str, torch.device]] = None):
        self.config = config
        self.dims = dims
        self.vocabs = vocabs
        self.device = resolve_device(device)
        self.params = {k: _move(v, self.device) for k, v in params.items()}
        self.compute_dtype = (torch.bfloat16 if config.USE_BF16
                              else torch.float32)
        self.top_k = config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION

    # ---- predict raw extractor lines ----
    def prepare_predict_rows(self, predict_data_lines: Iterable[str]
                             ) -> PreparedRows:
        """Host half of `predict`: raw extractor lines -> un-padded
        per-method index rows."""
        lines = [ln for ln in predict_data_lines if ln.strip()]
        labels, src, pth, dst, mask, tstr, cstr = parse_c2v_rows(
            lines, self.vocabs, self.config.MAX_CONTEXTS, keep_strings=True)
        return PreparedRows(labels, src, pth, dst, mask, tstr, cstr)

    def predict_bucket_size(self, n: int) -> int:
        """Padded leading dim for an `n`-method batch: the next power of
        two, so the device sees O(log n) distinct shapes."""
        return max(1, 1 << (n - 1).bit_length())

    def device_batch(self, labels, src, pth, dst, mask, weights):
        dev = self.device
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (labels, src, pth, dst, mask, weights))

    def _run_step(self, batch):
        with torch.inference_mode():
            return predict_step(self.params, batch, dims=self.dims,
                                top_k=self.top_k,
                                compute_dtype=self.compute_dtype)

    def warmup_predict(self, max_batch: int) -> List[int]:
        """Run each shape bucket up to `max_batch`'s once (kernel build,
        allocator and library set-up happen here, not under load).
        Returns the bucket sizes."""
        buckets = sorted({self.predict_bucket_size(n)
                          for n in [1 << i for i in range(
                              max(1, max_batch).bit_length())]
                          + [max(1, max_batch)]})
        C = self.dims.max_contexts
        for b in buckets:
            batch = self.device_batch(
                np.zeros((b,), np.int32), np.zeros((b, C), np.int32),
                np.zeros((b, C), np.int32), np.zeros((b, C), np.int32),
                np.zeros((b, C), np.float32), np.zeros((b,), np.float32))
            out = self._run_step(batch)
            out[0].cpu()  # waits for the device
        return buckets

    def predict_device(self, prepared: PreparedRows):
        """Device phase of `predict`: pad the rows to their power-of-two
        bucket, run the predict step once, fetch. Returns host arrays
        `(topk_ids, topk_probs, attention, code)` trimmed to
        `prepared.n` rows."""
        n = prepared.n
        padded_n = self.predict_bucket_size(n)
        weights = np.zeros((padded_n,), dtype=np.float32)
        weights[:n] = 1.0
        labels, src, pth, dst, mask = _pad_batch(
            (prepared.labels, prepared.src, prepared.pth, prepared.dst,
             prepared.mask), padded_n)
        batch = self.device_batch(labels, src, pth, dst, mask, weights)
        topk_ids, topk_probs, attn, code = self._run_step(batch)
        return (topk_ids[:n].cpu().numpy(), topk_probs[:n].cpu().numpy(),
                attn[:n].cpu().numpy(), code[:n].cpu().numpy())

    def decode_predictions(self, prepared: PreparedRows, device_out
                           ) -> List[MethodPredictionResults]:
        """Host decode of `predict_device` output rows (row i of
        `device_out` is row i of `prepared`): vocab lookups + the
        attention-ranked path-contexts."""
        topk_ids, topk_probs, attn, code = device_out
        results = []
        for i, original in enumerate(prepared.target_strings):
            res = MethodPredictionResults(original_name=original)
            for j in range(topk_ids.shape[1]):
                word = self.vocabs.target_vocab.lookup_word(
                    int(topk_ids[i, j]))
                if word == SpecialVocabWords.PAD:
                    continue
                res.append_prediction(word, float(topk_probs[i, j]))
            ctx_fields = prepared.context_strings[i]
            for j in np.argsort(-attn[i]):
                if j >= len(ctx_fields) or prepared.mask[i, j] == 0:
                    continue
                parts = ctx_fields[j].split(",")
                if len(parts) != 3:
                    continue
                res.append_attention_path(float(attn[i, j]), parts[0],
                                          parts[1], parts[2])
            if self.config.export_code_vectors:
                res.code_vector = code[i]
            results.append(res)
        return results

    def predict_prepared(self, prepared: PreparedRows
                         ) -> List[MethodPredictionResults]:
        """Device phase + decode in one call."""
        if prepared.n == 0:
            return []
        return self.decode_predictions(prepared,
                                       self.predict_device(prepared))

    def predict(self, predict_data_lines: Iterable[str]
                ) -> List[MethodPredictionResults]:
        return self.predict_prepared(
            self.prepare_predict_rows(predict_data_lines))


def dims_from_config(config: Config, vocabs: Code2VecVocabs) -> ModelDims:
    return ModelDims(
        token_vocab_size=vocabs.token_vocab.size,
        path_vocab_size=vocabs.path_vocab.size,
        target_vocab_size=vocabs.target_vocab.size,
        embeddings_size=config.DEFAULT_EMBEDDINGS_SIZE,
        max_contexts=config.MAX_CONTEXTS,
        dropout_keep_rate=config.DROPOUT_KEEP_RATE,
        tables_dtype=config.TABLES_DTYPE,
        encoder_type=config.ENCODER_TYPE)


class Code2VecTrainer:
    """Trains and evaluates the bag model on one device.

    The dense step (the default) or the sparse-row step
    (SPARSE_EMBEDDING_UPDATES) updates tables, dense params and the
    optimizer state in place. `params=None` initialises them from
    `config.SEED`. `device=None` runs on the CUDA card and raises when
    there is none; tests pass `device="cpu"`.

    A decaying learning rate needs the run's horizon,
    `schedule_total_steps(examples in the file, TRAIN_BATCH_SIZE,
    epochs)`: the first `train` call fixes it from its file and epochs
    (the optimizer state's structure does not depend on it, so the state
    is built at construction with a horizon of 1, as the JAX package
    builds it for an evaluation-only model)."""

    def __init__(self, config: Config, vocabs: Code2VecVocabs,
                 params: Optional[Params] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.config = config
        self.vocabs = vocabs
        self.device = resolve_device(device)
        config.verify()  # the JAX package's rules, ValueError
        if config.ENCODER_TYPE != "bag":
            raise NotImplementedError(
                f"encoder {config.ENCODER_TYPE!r} is not ported; only "
                "'bag' is")
        self.dims = dims_from_config(config, vocabs)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.SEED)
            params = init_params(gen, self.dims)
        self.params = {k: _move(v, self.device) for k, v in params.items()}
        self.compute_dtype = (torch.bfloat16 if config.USE_BF16
                              else torch.float32)
        self.total_steps: Optional[int] = None
        if config.SPARSE_EMBEDDING_UPDATES:
            self.optimizer = AdamF32Moments(config.LEARNING_RATE)
            self.opt_state = init_sparse_opt_state(
                self.params, self.optimizer, config.USE_SAMPLED_SOFTMAX)
            self._build_step()
        else:
            self._build_dense_optimizer(1)
            self.opt_state = self.optimizer.init(opt_param_view(self.params))
        self.step_num = 0

    def _build_dense_optimizer(self, total_steps: int) -> None:
        cfg = self.config
        self.optimizer = make_optimizer(
            make_lr(cfg.LEARNING_RATE, cfg.LR_SCHEDULE, total_steps,
                    cfg.LR_WARMUP_STEPS),
            cfg.EMBEDDING_OPTIMIZER, cfg.TRUST_RATIO, cfg.TRUST_RATIO_SCOPE)
        self._build_step()

    def _build_step(self) -> None:
        cfg = self.config
        self._train_step = make_train_step(
            self.dims, self.optimizer,
            use_sampled_softmax=cfg.USE_SAMPLED_SOFTMAX,
            num_sampled=cfg.NUM_SAMPLED_CLASSES,
            compute_dtype=self.compute_dtype,
            sparse_updates=cfg.SPARSE_EMBEDDING_UPDATES)
        self.step_config = self._train_step.cfg

    def device_batch(self, b: BatchTensors):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in b.host_arrays())

    def draws_for(self, batch_size: int, step: int) -> StepDraws:
        """The draws the trainer makes for `step` (seeded from SEED)."""
        return make_draws(self.dims, self.step_config, self.params,
                          batch_size, self.config.SEED, step, self.device)

    def train_step(self, batch, draws: Optional[StepDraws] = None
                   ) -> torch.Tensor:
        """One step on a device batch tuple; returns the loss tensor."""
        if draws is None:
            draws = self.draws_for(batch[0].shape[0], self.step_num)
        loss = self._train_step(self.params, self.opt_state, batch, draws)
        self.step_num += 1
        return loss

    def train(self, data_path: str, max_steps: Optional[int] = None,
              epochs: Optional[int] = None) -> List[float]:
        """Up to `epochs` (default NUM_TRAIN_EPOCHS) shuffled passes over
        a `.c2v` file, stopping after `max_steps` steps. Logs the loss
        every NUM_BATCHES_TO_LOG_PROGRESS steps; returns every step's
        loss."""
        cfg = self.config
        if epochs is None:
            epochs = cfg.NUM_TRAIN_EPOCHS
        if (self.total_steps is None and not cfg.SPARSE_EMBEDDING_UPDATES
                and cfg.LR_SCHEDULE != "constant"):
            self.total_steps = schedule_total_steps(
                count_examples(data_path), cfg.TRAIN_BATCH_SIZE, epochs)
            self._build_dense_optimizer(self.total_steps)
            cfg.log(f"lr schedule {cfg.LR_SCHEDULE} over "
                    f"{self.total_steps} steps")
        reader = C2VTextReader(data_path, self.vocabs, cfg.MAX_CONTEXTS,
                               cfg.TRAIN_BATCH_SIZE, shuffle=True,
                               seed=cfg.SEED)
        losses: List[torch.Tensor] = []
        for _epoch in range(epochs):
            left = None if max_steps is None else max_steps - len(losses)
            if left == 0:
                break
            # stops before the reader parses a batch past the last step
            for b in itertools.islice(reader, left):
                losses.append(self.train_step(self.device_batch(b)))
                if len(losses) % cfg.NUM_BATCHES_TO_LOG_PROGRESS == 0:
                    cfg.log(f"step {self.step_num}: loss "
                            f"{losses[-1].item():.5f}")
        values = torch.stack(losses).cpu().tolist() if losses else []
        if values:
            cfg.log(f"trained {len(values)} steps to step {self.step_num}: "
                    f"loss {values[0]:.5f} -> {values[-1]:.5f}")
        return values

    def evaluate(self, test_path: str) -> EvaluationResults:
        """Top-k accuracy, subtoken precision / recall / F1 and the mean
        loss over a `.c2v` file, in TEST_BATCH_SIZE batches (no dropout,
        full softmax)."""
        cfg = self.config
        top_k = cfg.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION
        reader = C2VTextReader(test_path, self.vocabs, cfg.MAX_CONTEXTS,
                               cfg.TEST_BATCH_SIZE, shuffle=False,
                               keep_strings=True)
        acc = MetricAccumulator(top_k)
        target_vocab = self.vocabs.target_vocab
        for b in reader:
            with torch.inference_mode():
                loss_sum, topk_ids, _probs = eval_step(
                    self.params, self.device_batch(b), dims=self.dims,
                    top_k=top_k, compute_dtype=self.compute_dtype)
            nv = b.num_valid_examples
            words = [[target_vocab.lookup_word(int(i)) for i in row]
                     for row in topk_ids[:nv].cpu().numpy()]
            acc.update_batch(b.target_strings[:nv], words, loss_sum.item())
        return acc.results()

"""The code2vec model on PyTorch: the predict side and the trainer.

`Code2VecModel` is the counterpart of the predict methods of
`Code2VecModel` in the JAX package's models/jax_model.py: raw extractor
lines are parsed on the host (`prepare_predict_rows`), padded to a
power-of-two bucket and run through the predict step on the device
(`predict_device`), and decoded into names and attention-ranked paths on
the host (`decode_predictions`). The serving layer (serving/server.py)
calls the three phases on different threads.

Both run the encoder of `ENCODER_TYPE`: the bag encoder or the
transformer path-encoder (models/transformer_encoder.py).

`Code2VecTrainer` is the train, evaluate, checkpoint and export part of
the same class: it builds the optimizer, its state and the step (the
dense step by default, the sparse-row step under
SPARSE_EMBEDDING_UPDATES), with the kernels the kernel-selection flags
choose. What does not depend on the head is `TrainerBase`, which the
VarMisuse head's trainer (models/vm_model.py) shares: the optimizer and
step plumbing, the draws, the saves and `train()`, the JAX package's
training loop with its
telemetry, tracing, stall watchdog, live metrics plane, profiler window,
sampled phase profiler, step-floor gauges and failpoints: the
auto-resume epoch offset (models/setup.py), the reader of the train
split (binary shards when binarized, data/reader.open_reader), the
prefetching infeed kept warm across epochs (data/prefetch.py; pinned
host buffers and a side stream on the card), step-keyed draws, and at
every SAVE_EVERY_EPOCHS epoch boundary an async checkpoint save
(training/checkpoint.py) then an evaluation. `from_config` builds the command line's model (cli.py):
vocabularies from the `.dict.c2v` histograms, or with `--load` dims,
vocabularies, params, optimizer state and step from a checkpoint.
`release`, `save_word2vec_format` and `export_code_vectors_file` are the
command line's exports; `predictor()` is the predict-side model over the
trainer's params, which `--predict` serves.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from code2vec_tpu_torch import tree
from code2vec_tpu_torch.common import (EvaluationResults,
                                       MethodPredictionResults,
                                       SpecialVocabWords)
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data.prefetch import (PinnedRingPut,
                                              build_train_infeed,
                                              persistent_epochs,
                                              prefetch_to_device)
from code2vec_tpu_torch.data.reader import (BatchTensors, _pad_batch,
                                            count_examples, open_reader,
                                            parse_c2v_rows)
from code2vec_tpu_torch.device import resolve_device
from code2vec_tpu_torch.models.encoder import ModelDims, Params, init_params
from code2vec_tpu_torch.models.model_base import (Code2VecModelBase,
                                                  MetricAccumulator,
                                                  vector_line)
from code2vec_tpu_torch.models.setup import (build_mesh, infeed_split,
                                             lr_horizon,
                                             resume_epoch_offset)
from code2vec_tpu_torch.obs import (SpanChannel, Telemetry, Tracer,
                                    TrainStepRecorder, Watchdog,
                                    build_live_plane,
                                    infeed_produce_instrument)
from code2vec_tpu_torch.obs.alerts import default_train_rules
from code2vec_tpu_torch.obs.health import default_train_monitors
from code2vec_tpu_torch.obs.phases import PhaseProfiler
from code2vec_tpu_torch.ops.quant import (dequantize_table, is_quantized,
                                          kernel_choice, opt_param_view)
from code2vec_tpu_torch.parallel import distributed
from code2vec_tpu_torch.parallel.sharding import check_replicas
from code2vec_tpu_torch.resilience import faults, retry
from code2vec_tpu_torch.training import checkpoint as ckpt
from code2vec_tpu_torch.training.draws import StepDraws, make_draws
from code2vec_tpu_torch.training.profiler import StepProfiler
from code2vec_tpu_torch.training.scalars import ScalarWriter
from code2vec_tpu_torch.training.optimizers import (
    AdamF32Moments, make_lr, make_optimizer, resolve_checkpoint_schedule,
    resolve_checkpoint_warmup)
from code2vec_tpu_torch.training.phase_probes import make_code2vec_probes
from code2vec_tpu_torch.training.sparse_steps import init_sparse_opt_state
from code2vec_tpu_torch.training.sparse_update import (
    phase_traffic_bytes, sparse_step_floor_bytes, sparse_update_phase_bytes)
from code2vec_tpu_torch.training.steps import (encode_step, eval_step,
                                               make_train_step, predict_step)
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs, VocabType


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


def kernel_selection(device: torch.device, pool: bool, requant: bool,
                     rows: bool) -> str:
    """The log line naming what each kernel-selection flag chose."""
    def word(on: bool) -> str:
        if not on:
            return "plain version"
        return "kernel" if device.type == "cuda" else "plain version (cpu)"
    return (f"kernels on {device}: attention pool / MHA (1-3) "
            f"{word(pool)}; int8 requantize (4) {word(requant)}; live-row "
            f"update (5, 6) {word(rows)}")


def _move(params: Params, device: torch.device) -> Params:
    """The params tree (int8 tables, the transformer's nested "xf"
    subtree) with every tensor on `device`."""
    return tree.map_leaves(lambda t: t.to(device), params)


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
        self.params = _move(params, self.device)
        self.compute_dtype = (torch.bfloat16 if config.USE_BF16
                              else torch.float32)
        self.top_k = config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION
        # --no_pallas: the plain pool (or MHA) in place of kernels 1-3
        self.use_kernel = config.USE_PALLAS
        # the serving layer installs its registry and tracer here (the
        # serve/parse_ms, encode_ms and predict_ms spans, the encode and
        # device trace spans); off by default
        self.telemetry = Telemetry.disabled()
        self.tracer = Tracer.disabled()
        # the input signatures (padded shape, dtype) the predict step has
        # run: eager PyTorch keeps no compile cache, and one jit compile
        # of the JAX package is one such signature
        self._step_signatures: set = set()

    # ---- predict raw extractor lines ----
    def prepare_predict_rows(self, predict_data_lines: Iterable[str]
                             ) -> PreparedRows:
        """Host half of `predict`: raw extractor lines -> un-padded
        per-method index rows, timed as `serve/parse_ms`."""
        parse_span = self.telemetry.span("serve/parse_ms")
        try:
            lines = [ln for ln in predict_data_lines if ln.strip()]
            labels, src, pth, dst, mask, tstr, cstr = parse_c2v_rows(
                lines, self.vocabs, self.config.MAX_CONTEXTS,
                keep_strings=True)
        except BaseException:
            # a malformed row must not leak the span, and a dead parse
            # must not land in the parse_ms histogram
            parse_span.cancel()
            raise
        parse_span.stop()
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
        self._step_signatures.add(
            (self.compute_dtype,)
            + tuple((tuple(t.shape), t.dtype) for t in batch))
        with torch.inference_mode():
            return predict_step(self.params, batch, dims=self.dims,
                                top_k=self.top_k,
                                compute_dtype=self.compute_dtype,
                                use_kernel=self.use_kernel)

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

    def predict_compile_count(self) -> int:
        """The number of distinct input signatures (padded batch,
        dtypes) the predict step has run: the JAX package's compiled
        predict-step variants. The kernel libraries load at their first
        launch, inside `warmup_predict`, so serving asserts that this
        stays flat after warm-up (`ReplicaPool.compile_delta`)."""
        return len(self._step_signatures)

    def predict_device(self, prepared: PreparedRows):
        """Device phase of `predict`: pad the rows to their power-of-two
        bucket, run the predict step once, fetch. Returns host arrays
        `(topk_ids, topk_probs, attention, code)` trimmed to
        `prepared.n` rows."""
        n = prepared.n
        # host phase: rows -> padded device batch (serve/encode_ms); the
        # trace spans parent to the batcher's serve/batch_flush span
        # (the thread's current one)
        tracing = self.tracer.enabled
        encode_span = self.telemetry.span("serve/encode_ms")
        t_encode = self.tracer.start_span("serve/encode", n=n) \
            if tracing else None
        try:
            padded_n = self.predict_bucket_size(n)
            weights = np.zeros((padded_n,), dtype=np.float32)
            weights[:n] = 1.0
            labels, src, pth, dst, mask = _pad_batch(
                (prepared.labels, prepared.src, prepared.pth, prepared.dst,
                 prepared.mask), padded_n)
            batch = self.device_batch(labels, src, pth, dst, mask, weights)
        except BaseException:
            encode_span.cancel()
            raise
        finally:
            if t_encode is not None:
                t_encode.end()
        encode_span.stop()
        # device phase: the step and the copies to the host, which wait
        # for it (serve/predict_ms)
        predict_span = self.telemetry.span("serve/predict_ms")
        t_device = self.tracer.start_span("serve/device",
                                          padded_n=padded_n) \
            if tracing else None
        try:
            topk_ids, topk_probs, attn, code = self._run_step(batch)
            out = (topk_ids[:n].cpu().numpy(), topk_probs[:n].cpu().numpy(),
                   attn[:n].cpu().numpy(), code[:n].cpu().numpy())
        except BaseException:
            predict_span.cancel()
            raise
        finally:
            if t_device is not None:
                t_device.end()
        predict_span.stop()
        return out

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
        encoder_type=config.ENCODER_TYPE,
        xf_layers=config.XF_LAYERS,
        xf_heads=config.XF_HEADS,
        xf_remat=config.XF_REMAT)


def adopt_manifest(cfg: Config, manifest: Dict[str, Any],
                   dims: ModelDims, head: str = "code2vec") -> None:
    """A loaded checkpoint's dims and optimizer configuration into `cfg`
    (they fix the state's structure, whatever the flags asked), as the
    JAX package's models adopt them; the schedule and warmup are the
    checkpoint's, a conflicting request logged. ValueError on a
    checkpoint of another head than `head` and on what the port does not
    have."""
    trained = manifest.get("head", "code2vec")
    if trained != head:
        raise ValueError(f"checkpoint was trained with --head {trained}, "
                         f"not --head {head}")
    cfg.HEAD = head
    if head == "varmisuse":
        cfg.MAX_CANDIDATES = manifest.get("max_candidates",
                                          cfg.MAX_CANDIDATES)
    if dims.ring_attention:
        raise ValueError("checkpoint was trained with --ring_attention, "
                         "which needs a mesh the port does not have")
    cfg.MAX_CONTEXTS = dims.max_contexts
    cfg.DEFAULT_EMBEDDINGS_SIZE = dims.embeddings_size
    cfg.DROPOUT_KEEP_RATE = dims.dropout_keep_rate
    cfg.TABLES_DTYPE = dims.tables_dtype
    cfg.ENCODER_TYPE = dims.encoder_type
    cfg.XF_LAYERS = dims.xf_layers
    cfg.XF_HEADS = dims.xf_heads
    cfg.XF_REMAT = dims.xf_remat
    cfg.USE_SAMPLED_SOFTMAX = manifest.get("use_sampled_softmax",
                                           cfg.USE_SAMPLED_SOFTMAX)
    cfg.NUM_SAMPLED_CLASSES = manifest.get("num_sampled",
                                           cfg.NUM_SAMPLED_CLASSES)
    cfg.SPARSE_EMBEDDING_UPDATES = manifest.get(
        "sparse_embedding_updates", cfg.SPARSE_EMBEDDING_UPDATES)
    # checkpoints older than the key were trained with Adam
    cfg.EMBEDDING_OPTIMIZER = manifest.get("embedding_optimizer", "adam")
    cfg.TRUST_RATIO = manifest.get("trust_ratio", False)
    cfg.TRUST_RATIO_SCOPE = manifest.get("trust_ratio_scope", "all")
    cfg.LR_SCHEDULE = resolve_checkpoint_schedule(cfg.LR_SCHEDULE, manifest,
                                                  cfg.log)
    cfg.LR_WARMUP_STEPS = resolve_checkpoint_warmup(
        cfg.LR_SCHEDULE, cfg.LR_WARMUP_STEPS, manifest, cfg.log)


def _like(loaded, template, what: str, device: torch.device):
    """`loaded` (a restored state tree) on `device`, after checking that
    it has the structure, shapes and dtypes of `template`."""
    def sig(x):
        return ckpt.map_state(lambda t: (tuple(t.shape), t.dtype), x)
    if sig(loaded) != sig(template):
        raise ValueError(f"the checkpoint's {what} do not match this "
                         "model's (another optimizer, table dtype or dims)")
    return ckpt.map_state(lambda t: t.to(device), loaded)


class _StepBudget:
    """A re-iterable reader that stops after `steps` batches in all, over
    however many passes: `train(max_steps=n)` reads n batches, also with
    a producer thread running ahead."""

    def __init__(self, reader, steps: int):
        self._reader = reader
        self._left = steps

    def __iter__(self):
        for b in itertools.islice(self._reader, self._left):
            self._left -= 1
            yield b


class TrainerBase:
    """What the heads' trainers share, on one device: the params, the
    optimizer and its state, the step, the training loop (`train`), the
    step-keyed draws and the checkpoint saves. When the process group is
    up (parallel/distributed.py) it is one rank of a data-parallel mesh
    (`self.mesh`): it draws the same params from the seed as every rank
    (checked), reads its host shard of the data, steps on its rows of
    the global batch, evaluates its shard and merges the metrics, and
    only rank 0 writes checkpoints, whose topology.json records the
    world. A head (`Code2VecTrainer`
    here, `VarMisuseModel` in models/vm_model.py) supplies its params'
    init, its steps, its reader, its evaluation and its manifest keys
    through the hooks below.

    The dense step (the default) or the sparse-row step
    (SPARSE_EMBEDDING_UPDATES) updates tables, dense params and the
    optimizer state in place. `params=None` initialises them from
    `config.SEED`. `device=None` runs on the CUDA card and raises when
    there is none; tests pass `device="cpu"`. `dims` (default: from the
    config and the vocabularies) is a checkpoint's when loading.

    A decaying learning rate needs the run's horizon
    (models/setup.lr_horizon): the first `train` call fixes it from its
    file and epochs (the optimizer state's structure does not depend on
    it, so the state is built at construction with a horizon of 1, as
    the JAX package builds it for an evaluation-only model)."""

    HEAD: str  # the head's name, as the manifest records it

    def __init__(self, config: Config, vocabs: Code2VecVocabs,
                 params: Optional[Params] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 dims: Optional[ModelDims] = None):
        self.config = config
        self.vocabs = vocabs
        self.device = resolve_device(device)
        if config.HEAD != self.HEAD:
            raise ValueError(f"config.HEAD is {config.HEAD!r}; "
                             f"{type(self).__name__} trains {self.HEAD!r}")
        config.verify()  # the JAX package's rules, ValueError
        self.dims = dims_from_config(config, vocabs) if dims is None else dims
        # the data-parallel mesh when the process group is up (a world
        # of 1 too), else None (models/setup.build_mesh)
        self.mesh = build_mesh(config, self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.SEED)
            params = self._init_params(gen)
        self.params = _move(params, self.device)
        self.compute_dtype = (torch.bfloat16 if config.USE_BF16
                              else torch.float32)
        # the kernel-selection flags, fixed for the trainer's life: the
        # pool / MHA (--no_pallas), the int8 requantize
        # (--requant_pallas) and the live-row update
        # (--sparse_update_pallas); "fused" on the CPU raises here
        self.use_kernel = config.USE_PALLAS
        self.requant_kernel = kernel_choice(
            config.REQUANT_PALLAS, "--requant_pallas", self.device)
        self.row_kernel = kernel_choice(
            config.SPARSE_UPDATE_PALLAS, "--sparse_update_pallas",
            self.device)
        config.log(kernel_selection(self.device, self.use_kernel,
                                    self.requant_kernel, self.row_kernel))
        self.total_steps: Optional[int] = None
        if config.SPARSE_EMBEDDING_UPDATES:
            self.optimizer = AdamF32Moments(config.LEARNING_RATE)
            self.opt_state = self._init_sparse_opt_state()
            self._build_step()
        else:
            self._build_dense_optimizer(1)
            self.opt_state = self.optimizer.init(opt_param_view(self.params))
        self.step_num = 0
        if self.mesh is not None:
            # every rank drew the same params from the seed
            check_replicas(self.params, self.mesh)
        # the background checkpoint writer, started at the first async save
        self._ckpt_writer: Optional[ckpt.AsyncCheckpointWriter] = None
        # the epoch an epoch-boundary save records in topology.json
        self._save_epoch: Optional[int] = None
        # the train loop's time blocked by its last save (ms)
        self.save_blocked_ms: Optional[float] = None
        # the run's telemetry, trace and checkpoint-writer heartbeat:
        # `train` installs them (off until then)
        self.telemetry = Telemetry.disabled()
        self.tracer = Tracer.disabled()
        self._trace_recorder: Optional[TrainStepRecorder] = None
        self._ckpt_heartbeat = None

    @classmethod
    def from_config(cls, config: Config,
                    device: Optional[Union[str, torch.device]] = None,
                    vocabs: Optional[Code2VecVocabs] = None):
        """The command line's model. With `load_path`: dims, vocabularies
        (unless given), params, optimizer state and step from the
        checkpoint (params only from a released one), its configuration
        adopted into `config` (a checkpoint of another head raises
        ValueError); else the head's vocabularies from the `--data`
        prefix (`_vocabs_from_data`)."""
        if not config.is_loading:
            if vocabs is None:
                vocabs = cls._vocabs_from_data(config)
            return cls(config, vocabs, device=device)
        manifest = ckpt.load_manifest(config.load_path)
        dims = ckpt.load_dims(config.load_path)
        adopt_manifest(config, manifest, dims, head=cls.HEAD)
        if vocabs is None:
            vocabs = ckpt.load_vocabs(config.load_path)
        sizes = (vocabs.token_vocab.size, vocabs.path_vocab.size,
                 vocabs.target_vocab.size)
        if sizes != (dims.token_vocab_size, dims.path_vocab_size,
                     dims.target_vocab_size):
            raise ValueError(f"vocab sizes {sizes} do not match the "
                             f"checkpoint's dims {dims}")
        trainer = cls(config, vocabs, device=device, dims=dims)
        state = ckpt.load_checkpoint(config.load_path, log=config.log)
        trainer.params = _like(state["params"], trainer.params, "params",
                               trainer.device)
        if manifest.get("released"):
            # no optimizer state: the fresh one matches the step
            trainer.step_num = int(manifest.get("step", 0))
        else:
            trainer.opt_state = _like(state["opt_state"], trainer.opt_state,
                                      "optimizer state", trainer.device)
            trainer.step_num = int(state["step"])
        config.log(f"loaded {config.load_path} at step {trainer.step_num}")
        return trainer

    # ---- what a head supplies ----
    @classmethod
    def _vocabs_from_data(cls, config: Config) -> Code2VecVocabs:
        """The head's vocabularies for a run from the `--data` prefix."""
        raise NotImplementedError

    def _init_params(self, generator: torch.Generator) -> Params:
        """The head's params, drawn from `generator`."""
        raise NotImplementedError

    def _init_sparse_opt_state(self) -> dict:
        """The sparse-row step's state for `self.params`."""
        raise NotImplementedError

    def _build_step(self) -> None:
        """Sets `_train_step` (over `self.optimizer`) and `step_config`."""
        raise NotImplementedError

    def _train_data_path(self) -> str:
        """The `--data` prefix's training file."""
        raise NotImplementedError

    def _train_reader(self, data_path: str, epoch_offset: int):
        """The shuffled training reader over `data_path`."""
        raise NotImplementedError

    def phase_profiler(self, telemetry: Telemetry) -> PhaseProfiler:
        """The run's sampled phase profiler (or the shared no-op)."""
        raise NotImplementedError

    def _publish_static_gauges(self, telemetry: Telemetry) -> None:
        """Set-once gauges of the run, before its first step."""

    def evaluate(self, test_path: Optional[str] = None):
        raise NotImplementedError

    def _record_eval(self, epoch: int, results, eval_ms: float,
                     telemetry: Telemetry, scalars: ScalarWriter) -> None:
        """An epoch-boundary evaluation's log line, scalars and event."""
        raise NotImplementedError

    def _manifest_extra(self) -> Dict[str, Any]:
        """The head's keys of the checkpoint manifest."""
        raise NotImplementedError

    def _build_dense_optimizer(self, total_steps: int) -> None:
        cfg = self.config
        self.optimizer = make_optimizer(
            make_lr(cfg.LEARNING_RATE, cfg.LR_SCHEDULE, total_steps,
                    cfg.LR_WARMUP_STEPS),
            cfg.EMBEDDING_OPTIMIZER, cfg.TRUST_RATIO, cfg.TRUST_RATIO_SCOPE)
        self._build_step()

    def draws_for(self, batch_size: int, step: int) -> StepDraws:
        """The draws the trainer makes for `step` (seeded from SEED)."""
        return make_draws(self.dims, self.step_config, self.params,
                          batch_size, self.config.SEED, step, self.device,
                          mesh=self.mesh)

    @property
    def is_writer(self) -> bool:
        """True on the rank that writes checkpoints (rank 0, or the one
        process)."""
        return self.mesh is None or self.mesh.rank == 0

    def host_shard(self) -> "tuple[int, int]":
        """(host_shard, num_host_shards) of this rank's readers."""
        return infeed_split() if self.mesh is not None else (0, 1)

    def device_batch(self, b: BatchTensors):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in b.host_arrays())

    def _put_fns(self, depth: int):
        """(put, ready) of an infeed `depth` ahead: a pinned ring on the
        card (`ready` on the consumer's thread), else `device_batch`."""
        if self.device.type == "cuda" and depth > 0:
            ring = PinnedRingPut(self.device, depth + 1)
            return (lambda b: ring(b.host_arrays())), ring.ready
        return self.device_batch, None

    def train_step(self, batch, draws: Optional[StepDraws] = None
                   ) -> torch.Tensor:
        """One step on a device batch tuple; returns the loss tensor."""
        if draws is None:
            draws = self.draws_for(batch[0].shape[0], self.step_num)
        loss = self._train_step(self.params, self.opt_state, batch, draws)
        self.step_num += 1
        return loss

    def train(self, data_path: Optional[str] = None,
              max_steps: Optional[int] = None,
              epochs: Optional[int] = None) -> List[float]:
        """The training loop over `data_path` (default: the `--data`
        prefix's train split), up to `epochs` (default NUM_TRAIN_EPOCHS)
        shuffled passes, stopping after `max_steps` steps (and then
        without the boundary work of the epoch it stops in). With
        AUTO_RESUME a restored run trains only its remaining epochs. At
        each SAVE_EVERY_EPOCHS boundary: an async save to `save_path`
        (its writer overlaps the evaluation), then an evaluation of
        `test_data_path`; the last save is committed before it returns.
        Logs the loss every NUM_BATCHES_TO_LOG_PROGRESS steps; returns
        every step's loss.

        Observed as the JAX package's loop is: the `--profile` window
        (training/profiler.py), `--tensorboard` scalars
        (training/scalars.py), the run's telemetry under
        `--telemetry_dir` (obs/: a step event a step, which reads the
        loss to the host and so waits for the card every step), the
        `--trace` span trees, the `--watchdog_stall_s` heartbeats of
        the loop, the checkpoint writer and the infeed producer, and the
        live metrics plane: `--metrics_port` (`/metrics`, `/healthz`,
        `/vars`, `/clock`; an in-memory registry without
        `--telemetry_dir`) and `--alerts_mode` (the health monitors and
        alert rules; under raise a firing alert is an `AlertError` at
        the next step). The `train/nan_loss` and `train/kill`
        failpoints act after each step. The head's set-once gauges
        (`_publish_static_gauges`) are published before the first step;
        `--phase_profile on` splits every
        PHASE_SAMPLE_EVERY-th step into synced probe dispatches
        (`phase_profiler`), whose state update is the fused step."""
        cfg = self.config
        from_cli = data_path is None
        if from_cli:
            data_path = self._train_data_path()
        if epochs is None:
            epochs = cfg.NUM_TRAIN_EPOCHS

        def n_examples() -> int:
            # the dict pickle carries the train split's count
            return ((self.vocabs.num_training_examples if from_cli else None)
                    or count_examples(data_path))

        if (self.total_steps is None and not cfg.SPARSE_EMBEDDING_UPDATES
                and cfg.LR_SCHEDULE != "constant"):
            self.total_steps = lr_horizon(cfg, n_examples,
                                          restored_step=self.step_num,
                                          epochs=epochs)
            self._build_dense_optimizer(self.total_steps)
            cfg.log(f"lr schedule {cfg.LR_SCHEDULE} over "
                    f"{self.total_steps} steps")
        completed = resume_epoch_offset(cfg, self.step_num, n_examples,
                                        cfg.log)
        reader = self._train_reader(data_path, completed)
        if max_steps is not None:
            reader = _StepBudget(reader, max_steps)
        profiler = StepProfiler(cfg.PROFILE_DIR, cfg.PROFILE_START_STEP,
                                cfg.PROFILE_STEPS, cfg.log)
        scalars = ScalarWriter(cfg.TENSORBOARD_DIR)
        # off (no --telemetry_dir), every hook below is a shared no-op:
        # one boolean check a step
        telemetry = Telemetry.create(cfg.TELEMETRY_DIR, config=cfg,
                                     component="train",
                                     scalar_writer=scalars, log=cfg.log)
        if cfg.METRICS_PORT > 0 and not telemetry.enabled:
            # --metrics_port without --telemetry_dir: a scrapeable run
            # over an in-memory registry (no event log; the per-step
            # loss read, and its wait for the card, apply either way)
            telemetry = Telemetry.memory("train")
        self.telemetry = telemetry
        live_plane = cfg.METRICS_PORT > 0 or cfg.ALERTS_MODE != "off"
        if (cfg.ASYNC_CHECKPOINT or cfg.TRACE or cfg.WATCHDOG_STALL_S > 0
                or live_plane):
            # the checkpoint writer, the infeed producer (trace spans),
            # the watchdog, the health monitors and the exposition
            # handler record into it or read it from other threads
            telemetry.make_threadsafe()
        tracer = Tracer.create(telemetry) if cfg.TRACE \
            else Tracer.disabled()
        self.tracer = tracer
        watchdog = Watchdog.create(
            telemetry, stall_s=cfg.WATCHDOG_STALL_S, mode=cfg.WATCHDOG_MODE,
            tracer=tracer, log=cfg.log)
        loop_hb = watchdog.register("train_loop")
        self._ckpt_heartbeat = watchdog.register("checkpoint_writer")
        # the live metrics plane: health monitors and alert rules swept
        # on a cadence thread off the hot path, and the /metrics,
        # /healthz, /vars, /clock server (obs/exposition.py); shared
        # no-op singletons with the flags off
        plane = build_live_plane(
            telemetry, metrics_port=cfg.METRICS_PORT,
            alerts_mode=cfg.ALERTS_MODE, alerts_rules=cfg.ALERTS_RULES,
            health_every_s=cfg.HEALTH_EVERY_S, watchdog=watchdog,
            monitors=default_train_monitors(),
            default_rules=default_train_rules,
            identity=self.identity(), log=cfg.log)
        alerts = plane.alerts
        infeed_channel = SpanChannel() if tracer.enabled else None
        recorder = TrainStepRecorder(
            telemetry, gauge_every=cfg.NUM_BATCHES_TO_LOG_PROGRESS,
            tracer=tracer, infeed_channel=infeed_channel,
            heartbeat=loop_hb if watchdog.enabled else None,
            alerts=alerts if alerts.enabled else None)
        self._trace_recorder = recorder
        watchdog.start()
        plane.start()
        # a set-once config echo (static: never reads as stale)
        telemetry.gauge("train/max_contexts", cfg.MAX_CONTEXTS, emit=False,
                        static=True)
        self._publish_static_gauges(telemetry)
        phases = self.phase_profiler(telemetry)
        # the first deadline also covers the first step's kernel builds
        loop_hb.busy()
        infeed_hb = watchdog.register("infeed_producer")
        put, ready = self._put_fns(cfg.INFEED_PREFETCH)
        infeed = build_train_infeed(
            reader, put, cfg.INFEED_PREFETCH, ready,
            instrument=infeed_produce_instrument(tracer, infeed_channel),
            heartbeat=infeed_hb if watchdog.enabled else None)
        if telemetry.enabled:
            retry.set_telemetry(telemetry)
        # disarmed (no --faults), each is one attribute read a step
        nan_fp, kill_fp = faults.train_step_points()
        losses: List[torch.Tensor] = []
        steps_into_training = 0
        window_examples, window_start = 0, time.perf_counter()
        try:
            with contextlib.closing(persistent_epochs(
                    infeed, epochs, first_epoch=completed + 1)) as passes:
                for epoch, batches in passes:
                    for dev_batch, batch in recorder.wrap(batches):
                        profiler.tick(steps_into_training, self.params)
                        if phases.enabled and phases.should_sample(
                                steps_into_training):
                            # probes first (measurement only), then the
                            # fused step, all on the step's one draws
                            loss = phases.run_split(
                                self.params, self.opt_state, dev_batch,
                                self.draws_for(dev_batch[0].shape[0],
                                               self.step_num),
                                step=self.step_num,
                                infeed_wait_ms=recorder.infeed_wait_ms
                                if recorder.enabled else None,
                                recorder=recorder
                                if recorder.enabled else None)
                        else:
                            loss = self.train_step(dev_batch)
                        if nan_fp.armed and nan_fp.hit():
                            loss = loss * float("nan")  # poison the loss
                        if kill_fp.armed:
                            kill_fp.fire(step=self.step_num)
                        losses.append(loss)
                        steps_into_training += 1
                        window_examples += batch.num_valid_examples
                        loss_f = (recorder.end_step(
                            self.step_num, loss, batch.num_valid_examples,
                            params=self.params)
                            if recorder.enabled else None)
                        if self.step_num % cfg.NUM_BATCHES_TO_LOG_PROGRESS \
                                == 0:
                            if loss_f is None:
                                loss_f = loss.item()
                            ex_s = window_examples / max(
                                time.perf_counter() - window_start, 1e-9)
                            cfg.log(f"epoch {epoch} step {self.step_num}: "
                                    f"loss {loss_f:.5f}, {ex_s:.1f} ex/s")
                            scalars.write(self.step_num, {
                                "train/loss": loss_f,
                                "train/examples_per_sec": ex_s,
                                "train/path_contexts_per_sec":
                                    ex_s * cfg.MAX_CONTEXTS})
                            window_examples = 0
                            window_start = time.perf_counter()
                    if max_steps is not None and len(losses) >= max_steps:
                        break
                    if self._epoch_end(epoch, telemetry, scalars):
                        # boundary work is progress: re-arm the loop's
                        # deadline (size --watchdog_stall_s above the
                        # evaluation's time) and restart the throughput
                        # window
                        loop_hb.beat()
                        window_examples = 0
                        window_start = time.perf_counter()
            if self._ckpt_writer is not None:
                self._ckpt_writer.wait()  # the last save is committed
            watchdog.poll()  # raise mode: a stalled run dies loudly here
            alerts.poll()    # raise mode: so does a firing alert
        finally:
            loop_hb.idle()
            watchdog.stop()  # no raise: must not mask the loop's error
            plane.stop()
            if self._ckpt_writer is not None:
                # an exception's teardown: the error in flight is raised,
                # a writer error stays pending for the next wait
                self._ckpt_writer.drain_quiet()
            if telemetry.enabled:
                retry.set_telemetry(None)
        profiler.finish(self.params)
        telemetry.close()
        scalars.close()
        values = torch.stack(losses).cpu().tolist() if losses else []
        if values:
            cfg.log(f"trained {len(values)} steps to step {self.step_num}: "
                    f"loss {values[0]:.5f} -> {values[-1]:.5f}")
        return values

    def identity(self) -> Dict[str, Any]:
        """The run's telemetry identity: this rank, the world and the
        distributed backend (None for a plain single-process run)."""
        rank, world = infeed_split()
        return {"process_index": rank, "process_count": world,
                "backend": distributed.backend()}

    def _epoch_end(self, epoch: int, telemetry: Telemetry,
                   scalars: ScalarWriter) -> bool:
        """The boundary's save (async: the evaluation runs while the
        writer drains) and evaluation (the `train/eval_ms` span and an
        `eval` event). True when there was boundary work."""
        cfg = self.config
        if epoch % cfg.SAVE_EVERY_EPOCHS:
            return False
        if cfg.is_saving:
            self._save_epoch = epoch  # -> the step's topology.json
            self.save(cfg.save_path, block=False)
        if cfg.is_testing:
            eval_span = telemetry.span("train/eval_ms")
            try:
                results = self.evaluate()
            except BaseException:
                eval_span.cancel()  # a dead evaluation: dropped
                raise
            self._record_eval(epoch, results, eval_span.stop(), telemetry,
                              scalars)
        return cfg.is_saving or cfg.is_testing

    def _checkpoint_writer(self) -> ckpt.AsyncCheckpointWriter:
        if self._ckpt_writer is None:
            self._ckpt_writer = ckpt.AsyncCheckpointWriter(
                log=self.config.log, heartbeat=self._ckpt_heartbeat)
        return self._ckpt_writer

    def save(self, path: Optional[str] = None, block: bool = True) -> None:
        """Save the state as step `step_num` of `path` (default
        `save_path`). With ASYNC_CHECKPOINT the background writer takes
        a snapshot and `block=False` returns once it is queued; else the
        save runs here. `save_blocked_ms` is the time this call took."""
        cfg = self.config
        path = path or cfg.save_path
        if not path:
            raise ValueError("save needs a checkpoint dir (--save)")
        if self.mesh is not None:
            # the replicas agree before the one copy is written
            check_replicas(self.params, self.mesh)
            if not self.is_writer:
                self._save_epoch = None
                return
        t0 = time.perf_counter()
        state = {"params": self.params, "opt_state": self.opt_state,
                 "step": self.step_num}
        extra = self._manifest_extra()
        # the epoch of a boundary save, consumed here: a later manual
        # save must not record it
        topology = {"epoch": self._save_epoch,
                    "num_processes": infeed_split()[1]}
        self._save_epoch = None
        # trace: the save's blocked window links the step that triggered
        # it, and the writer thread parents its train/save_write span to
        # this one
        trace_span = None
        if self.tracer.enabled:
            last = self._trace_recorder.last_step_context \
                if self._trace_recorder is not None else None
            trace_span = self.tracer.start_trace(
                "train/save_blocked", step=int(self.step_num),
                is_async=bool(cfg.ASYNC_CHECKPOINT))
            if last is not None:
                trace_span.links.append(last)
        blocked_span = self.telemetry.span("train/save_blocked_ms")
        try:
            if cfg.ASYNC_CHECKPOINT:
                writer = self._checkpoint_writer()
                writer.submit(path, state, self.step_num, self.vocabs,
                              self.dims, extra_manifest=extra,
                              max_to_keep=cfg.MAX_TO_KEEP, topology=topology,
                              telemetry=self.telemetry,
                              tracer=self.tracer
                              if trace_span is not None else None,
                              trace_ctx=trace_span.context()
                              if trace_span is not None else None)
                if block:
                    writer.wait()
            else:
                ckpt.save_checkpoint(path, state, self.step_num, self.vocabs,
                                     self.dims, extra_manifest=extra,
                                     max_to_keep=cfg.MAX_TO_KEEP,
                                     topology=topology)
        except BaseException:
            # a failed submit or save (a sticky writer error, a dead
            # disk) leaks neither the span nor the open trace
            blocked_span.cancel()
            if trace_span is not None:
                trace_span.end(outcome="error")
            raise
        self.save_blocked_ms = (time.perf_counter() - t0) * 1e3
        blocked_span.stop()
        if not cfg.ASYNC_CHECKPOINT:
            # the synchronous save is its own writer: total == blocked
            self.telemetry.record_ms("train/save_total_ms",
                                     self.save_blocked_ms)
            self.telemetry.event("save_committed", step=self.step_num,
                                 total_ms=round(self.save_blocked_ms, 3))
        if trace_span is not None:
            trace_span.end(blocked_ms=round(self.save_blocked_ms, 3))
        self.telemetry.event("save", step=self.step_num,
                             blocked_ms=round(self.save_blocked_ms, 3),
                             is_async=bool(cfg.ASYNC_CHECKPOINT))
        cfg.log(f"{'queued' if cfg.ASYNC_CHECKPOINT and not block else 'saved'}"
                f" checkpoint step {self.step_num} -> {path} (loop blocked "
                f"{self.save_blocked_ms:.1f} ms)")

    def close_session(self) -> None:
        """The commit barrier of the last save, and the writer's end."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.close()


class Code2VecTrainer(TrainerBase, Code2VecModelBase):
    """Trains, evaluates, checkpoints and exports the code2vec model (bag
    or transformer encoder) on one device, or on each rank of a
    data-parallel mesh (TrainerBase's loop). The sparse-row step's state
    is sparse_steps.init_sparse_opt_state's."""

    HEAD = "code2vec"

    @classmethod
    def _vocabs_from_data(cls, config: Config) -> Code2VecVocabs:
        """The vocabularies of the `.dict.c2v` histograms of
        `train_data_path`, capped at MAX_*_VOCAB_SIZE."""
        if config.word_freq_dict_path is None:
            raise ValueError("need --data (for its .dict.c2v) or --load")
        return Code2VecVocabs.load_from_dict_file(
            config.word_freq_dict_path, config.MAX_TOKEN_VOCAB_SIZE,
            config.MAX_PATH_VOCAB_SIZE, config.MAX_TARGET_VOCAB_SIZE)

    def _init_params(self, generator: torch.Generator) -> Params:
        return init_params(generator, self.dims)

    def _init_sparse_opt_state(self) -> dict:
        return init_sparse_opt_state(self.params, self.optimizer,
                                     self.config.USE_SAMPLED_SOFTMAX)

    def _build_step(self) -> None:
        cfg = self.config
        self._train_step = make_train_step(
            self.dims, self.optimizer,
            use_sampled_softmax=cfg.USE_SAMPLED_SOFTMAX,
            num_sampled=cfg.NUM_SAMPLED_CLASSES,
            compute_dtype=self.compute_dtype, use_kernel=self.use_kernel,
            requant_kernel=self.requant_kernel, row_kernel=self.row_kernel,
            sparse_updates=cfg.SPARSE_EMBEDDING_UPDATES,
            augment_fn=self._rename_augment(), mesh=self.mesh)
        self.step_config = self._train_step.cfg

    def _rename_augment(self):
        """The rename defense's augment under ADV_RENAME_PROB > 0 (built
        once: the legal mask walks the whole token vocabulary), else
        None."""
        cfg = self.config
        if cfg.ADV_RENAME_PROB <= 0:
            return None
        if getattr(self, "_augment", None) is None:
            from code2vec_tpu_torch.attacks.defense import (
                legal_token_mask, make_rename_augment)
            self._augment = make_rename_augment(
                legal_token_mask(self.vocabs.token_vocab, self.dims),
                cfg.ADV_RENAME_PROB, mode=cfg.ADV_RENAME_MODE,
                device=self.device)
        return self._augment

    def _train_data_path(self) -> str:
        return self.config.data_path("train")

    def _train_reader(self, data_path: str, epoch_offset: int):
        cfg = self.config
        shard, shards = self.host_shard()
        return open_reader(data_path, self.vocabs, cfg.MAX_CONTEXTS,
                           cfg.TRAIN_BATCH_SIZE, shuffle=True, seed=cfg.SEED,
                           epoch_offset=epoch_offset, host_shard=shard,
                           num_host_shards=shards)

    def predictor(self) -> Code2VecModel:
        """The predict-side model (the serving path, `--predict`) over
        this trainer's params, shared, not copied."""
        return Code2VecModel(self.config, self.dims, self.vocabs,
                             self.params, device=self.device)

    def _publish_static_gauges(self, telemetry: Telemetry) -> None:
        """With SPARSE_EMBEDDING_UPDATES, the sparse-row step's analytic
        floor (training/sparse_update.py's traffic model over
        HBM_CEILING_GBPS), set once (static: facts, not heartbeats): the
        health engine's OptEfficiency divides `train/step_floor_ms` by
        the observed p50 step time every sweep, so a step-time
        regression shows on /metrics mid-run."""
        cfg = self.config
        if not cfg.SPARSE_EMBEDDING_UPDATES:
            return
        ns = cfg.NUM_SAMPLED_CLASSES if cfg.USE_SAMPLED_SOFTMAX else 0
        step_bytes = sparse_step_floor_bytes(
            self.params, cfg.TRAIN_BATCH_SIZE, cfg.MAX_CONTEXTS,
            num_sampled=ns)
        upd_bytes = sparse_update_phase_bytes(
            self.params, cfg.TRAIN_BATCH_SIZE, cfg.MAX_CONTEXTS,
            num_sampled=ns)
        ceiling = cfg.HBM_CEILING_GBPS * 1e9
        telemetry.gauge("train/step_floor_ms", step_bytes / ceiling * 1e3,
                        emit=False, static=True)
        telemetry.gauge("train/sparse_update_bytes", upd_bytes, emit=False,
                        static=True)
        telemetry.gauge("train/sparse_update_floor_ms",
                        upd_bytes / ceiling * 1e3, emit=False, static=True)

    def phase_profiler(self, telemetry: Telemetry) -> PhaseProfiler:
        """The run's sampled phase profiler (obs/phases.py) over this
        trainer's step and probes (training/phase_probes.py), with the
        analytic per-phase bytes and the card's ceiling: the shared
        no-op unless PHASE_PROFILE is on and `telemetry` is live. The
        probes are built at its first sample."""
        cfg = self.config
        if cfg.PHASE_PROFILE != "on" or not telemetry.enabled:
            return PhaseProfiler.disabled()
        ns = cfg.NUM_SAMPLED_CLASSES if cfg.USE_SAMPLED_SOFTMAX else 0
        phase_bytes = phase_traffic_bytes(
            self.params, cfg.TRAIN_BATCH_SIZE, cfg.MAX_CONTEXTS,
            num_sampled=ns, sparse=cfg.SPARSE_EMBEDDING_UPDATES)

        def probes():
            return make_code2vec_probes(
                self.dims, self.optimizer,
                use_sampled_softmax=cfg.USE_SAMPLED_SOFTMAX,
                num_sampled=cfg.NUM_SAMPLED_CLASSES,
                compute_dtype=self.compute_dtype, use_kernel=self.use_kernel,
                sparse_updates=cfg.SPARSE_EMBEDDING_UPDATES)

        def fused_step(_params, _opt_state, batch, draws):
            return self.train_step(batch, draws)  # in place, step_num + 1

        return PhaseProfiler.create(
            telemetry, fused_step=fused_step, probes_factory=probes,
            enabled=True,
            sample_every=cfg.PHASE_SAMPLE_EVERY, phase_bytes=phase_bytes,
            ceiling_gbps=cfg.HBM_CEILING_GBPS, log=cfg.log)

    def evaluate(self, test_path: Optional[str] = None) -> EvaluationResults:
        """Top-k accuracy, subtoken precision / recall / F1 and the mean
        loss over a `.c2v` file (default: `test_data_path`; its binary
        shard when binarized), in TEST_BATCH_SIZE batches (no dropout,
        full softmax). Under a mesh each rank evaluates its host shard of
        the file and the metric partials are summed over the ranks
        (`MetricAccumulator.merge_across_hosts`): every rank returns the
        whole file's results."""
        cfg = self.config
        test_path = test_path or cfg.test_data_path
        if not test_path:
            raise ValueError("evaluate needs a test file (--test)")
        top_k = cfg.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION
        shard, shards = self.host_shard()
        reader = open_reader(test_path, self.vocabs, cfg.MAX_CONTEXTS,
                             cfg.TEST_BATCH_SIZE, shuffle=False,
                             keep_strings=True, host_shard=shard,
                             num_host_shards=shards)
        acc = MetricAccumulator(top_k)
        target_vocab = self.vocabs.target_vocab
        put, ready = self._put_fns(cfg.INFEED_PREFETCH)
        for dev_batch, b in prefetch_to_device(reader, put,
                                               cfg.INFEED_PREFETCH, ready):
            with torch.inference_mode():
                loss_sum, topk_ids, _probs = eval_step(
                    self.params, dev_batch, dims=self.dims, top_k=top_k,
                    compute_dtype=self.compute_dtype,
                    use_kernel=self.use_kernel)
            nv = b.num_valid_examples
            names = (b.target_strings[:nv] if b.target_strings else
                     [target_vocab.lookup_word(int(i))
                      for i in b.target_index[:nv]])
            words = [[target_vocab.lookup_word(int(i)) for i in row]
                     for row in topk_ids[:nv].cpu().numpy()]
            acc.update_batch(names, words, loss_sum.item())
        if self.mesh is not None:
            acc.merge_across_hosts()
        return acc.results()

    def _record_eval(self, epoch: int, results: EvaluationResults,
                     eval_ms: float, telemetry: Telemetry,
                     scalars: ScalarWriter) -> None:
        self.config.log(f"epoch {epoch} evaluation: {results}")
        scalars.write(self.step_num, {
            "eval/loss": results.loss,
            "eval/top1": results.topk_acc[0],
            "eval/subtoken_f1": results.subtoken_f1,
            "eval/subtoken_precision": results.subtoken_precision,
            "eval/subtoken_recall": results.subtoken_recall})
        telemetry.event("eval", epoch=epoch, step=self.step_num,
                        loss=results.loss, subtoken_f1=results.subtoken_f1,
                        eval_ms=round(eval_ms, 3))

    def _manifest_extra(self) -> Dict[str, Any]:
        cfg = self.config
        return {"use_sampled_softmax": cfg.USE_SAMPLED_SOFTMAX,
                "num_sampled": cfg.NUM_SAMPLED_CLASSES,
                "sparse_embedding_updates": cfg.SPARSE_EMBEDDING_UPDATES,
                "embedding_optimizer": cfg.EMBEDDING_OPTIMIZER,
                "trust_ratio": cfg.TRUST_RATIO,
                "trust_ratio_scope": cfg.TRUST_RATIO_SCOPE,
                "lr_schedule": cfg.LR_SCHEDULE,
                "lr_warmup_steps": cfg.LR_WARMUP_STEPS,
                # provenance only (no structural effect on restore)
                "adv_rename_prob": cfg.ADV_RENAME_PROB,
                "adv_rename_mode": cfg.ADV_RENAME_MODE}

    def release(self) -> None:
        """`--release`: the loaded checkpoint's params, without optimizer
        state, to `save_path` (default `<load_path>.release`)."""
        cfg = self.config
        if not cfg.load_path:
            raise ValueError("--release requires --load")
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()
        dest = cfg.save_path or (cfg.load_path.rstrip("/") + ".release")
        ckpt.release_checkpoint(cfg.load_path, dest, self.params)
        cfg.log(f"released inference checkpoint -> {dest}")

    def get_embedding_table(self, vocab_type: VocabType) -> np.ndarray:
        """A vocab table as float32 [vocab size, dim] on the host (an int8
        table dequantized)."""
        key = {VocabType.Token: "token_emb", VocabType.Path: "path_emb",
               VocabType.Target: "target_emb"}[vocab_type]
        table = self.params[key]
        if is_quantized(table):
            table = dequantize_table(table)
        table = table.to(torch.float32).cpu().numpy()
        return table[:self.vocabs.get(vocab_type).size]

    def export_code_vectors_file(self, test_path: str,
                                 dest_path: str) -> None:
        """`--export_code_vectors`: one code vector a test example, in the
        file's order, each value as %.6f."""
        cfg = self.config
        reader = open_reader(test_path, self.vocabs, cfg.MAX_CONTEXTS,
                             cfg.TEST_BATCH_SIZE, shuffle=False,
                             keep_strings=True)
        put, ready = self._put_fns(cfg.INFEED_PREFETCH)
        with open(dest_path, "w", encoding="utf-8") as f:
            for dev_batch, b in prefetch_to_device(
                    reader, put, cfg.INFEED_PREFETCH, ready):
                with torch.inference_mode():
                    code = encode_step(self.params, dev_batch,
                                       dims=self.dims,
                                       compute_dtype=self.compute_dtype,
                                       use_kernel=self.use_kernel)
                for row in code[:b.num_valid_examples].cpu().numpy():
                    f.write(vector_line(row) + "\n")

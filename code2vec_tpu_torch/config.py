"""Configuration of the port: the fields it reads and its command line.

The fields under the names and defaults of `Config` in the JAX package's
config.py, so a setting means the same in both, and the JAX package's
flag spelling for each (`arguments_parser`, `load_from_args`): a JAX
command line of the ported flags runs unchanged through
`python3 -m code2vec_tpu_torch` (cli.py). Every flag of the JAX parser
is ported; a flag neither parser knows is an error that names it, never
ignored. The adversarial attack flags (`--attack*`) and the rename
defense's (`--adv_rename_prob`, `--adv_rename_mode`) are the
JAX package's, verified by its rules with its messages. The seven serving
fleet flags (`--serve_port`, `--serve_replicas`, ...) are parsed and
verified as the JAX package's are; as there, the command line opens no
socket (the fleet runs through tools/serving_bench.py and the chaos
leg). `--backend` is `gpu` (the CUDA card, the default) or `cpu`; `--framework` accepts the JAX package's values as aliases of this
implementation.

The defaults are the JAX package's: the dense step with Adafactor on the
tables, Adam on TRANSFORM / ATTENTION, a cosine learning rate, bf16
tables and full softmax. `SPARSE_EMBEDDING_UPDATES=True` selects the
sparse-row step, which `verify` allows only with `EMBEDDING_OPTIMIZER=
"adam"`, `LR_SCHEDULE="constant"` and the `bag` encoder, as the JAX
package's does. `ENCODER_TYPE="transformer"` selects the transformer
path-encoder (`XF_LAYERS` pre-norm layers of `XF_HEADS` heads).
`HEAD="varmisuse"` (`--head varmisuse`) selects the VarMisuse pointer
head (models/vm_model.py) over `.vm.c2v` data with `MAX_CANDIDATES`
candidate slots; `verify` refuses it with the code2vec head's surfaces,
int8 tables and the transformer, as the JAX package's does. The port
runs one process per rank: `--dist_coordinator`, `--dist_num_processes`
and `--dist_process_id` join a process group (parallel/distributed.py);
`--mesh_data`, `--mesh_context`, `--mesh_dcn` and `--mesh_model` size
the data, context, dcn and model axes (parallel/mesh.py; the model axis
row-shards the vocab tables, parallel/sharding.py), and
`--ring_attention` runs the transformer's attention as a ring over the
context axis (ops/ring_attention.py), with the JAX package's rules (int8
tables refuse a context or model axis, the VarMisuse head a context
axis) and the port's: `--mesh_context` must divide MAX_CONTEXTS. Under
`--mesh_model` the VarMisuse head trains on row-sharded tables, and the
writing rank's exports (`--save_w2v`, `--save_t2v`,
`--export_code_vectors`, `--release`) read whole tables gathered over its
model group (cli.py); `--predict`, the REPL and `--attack` run on a
cohort of any world, rank 0 leading (serving/cohort.py).
`--infeed_chunk G` groups G batches into one host-to-device copy a field
(data/prefetch.ChunkedDevicePrefetcher), with the JAX package's rules:
G >= 1, and G > 1 needs `--infeed_prefetch` >= 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
from typing import List, Optional


@dataclasses.dataclass
class Config:
    # contexts kept per method (over-cap rows are downsampled at parse)
    MAX_CONTEXTS: int = 200
    # vocabulary caps of `.dict.c2v` loading (the java-large sizes)
    MAX_TOKEN_VOCAB_SIZE: int = 1301136
    MAX_TARGET_VOCAB_SIZE: int = 261245
    MAX_PATH_VOCAB_SIZE: int = 911417
    TOP_K_WORDS_CONSIDERED_DURING_PREDICTION: int = 10
    # compute in bfloat16 (contexts, pool input, logits product)
    USE_BF16: bool = True
    # storage dtype of the vocab tables: "float32" | "bfloat16" | "int8"
    TABLES_DTYPE: str = "bfloat16"
    # max methods per coalesced device batch; a power of two, the
    # largest warmed bucket
    SERVE_BATCH_MAX: int = 64
    # coalescing window after the first queued request (0 = greedy)
    SERVE_BATCH_TIMEOUT_MS: float = 2.0
    # bounded request queue; fuller submissions are refused
    SERVE_QUEUE_DEPTH: int = 128
    # a request still queued past this is shed (0 = no deadline)
    SERVE_DEADLINE_MS: float = 2000.0
    # LRU prediction-cache entries (0 disables)
    SERVE_CACHE_SIZE: int = 1024
    # persistent extractor worker pool size (serving/extractor.py)
    SERVE_EXTRACT_WORKERS: int = 2
    # ---- the serving fleet (serving/frontend.py, replicas.py,
    # reload.py, autoscale.py): an HTTP front end over a replica pool
    # with hot weight reload and SLO autoscaling ----
    # HTTP front-end port (POST /predict, GET /healthz /metrics /pool);
    # 0 = no socket (the in-process surface still works)
    SERVE_PORT: int = 0
    # initial replica count: N PredictionServers (one model each) behind
    # one shared prediction cache
    SERVE_REPLICAS: int = 1
    # autoscaler bounds: the pool never shrinks below min or grows past
    # max, whatever the SLO rules say
    SERVE_MIN_REPLICAS: int = 1
    SERVE_MAX_REPLICAS: int = 4
    # p99 latency SLO in ms: the autoscaler's serving_p99_slo rule
    # threshold (serve/request_ms:p99 > slo -> grow the pool)
    SERVE_SLO_MS: float = 250.0
    # checkpoint-dir poll cadence for hot weight reload (committed steps
    # are sha256-verified, then rolled one replica at a time); 0 = off
    SERVE_RELOAD_POLL_S: float = 0.0
    # run the SLO autoscaling policy loop (off = a fixed-size pool;
    # death and refill apply either way)
    SERVE_AUTOSCALE: bool = False
    # attach each method's code vector to its prediction result
    export_code_vectors: bool = False

    # ---- model ----
    DEFAULT_EMBEDDINGS_SIZE: int = 128
    ENCODER_TYPE: str = "bag"   # "bag" | "transformer"
    # transformer layers and heads (the head width is 3E / XF_HEADS)
    XF_LAYERS: int = 2
    XF_HEADS: int = 3
    # recompute each transformer layer in the backward pass
    XF_REMAT: bool = False
    # the transformer's attention as a ring over the ctx mesh axis
    # (ops/ring_attention.py); only with --mesh_context > 1
    RING_ATTENTION: bool = False
    # "code2vec" (method names) or "varmisuse" (the pointer head of
    # models/varmisuse.py over `.vm.c2v` data)
    HEAD: str = "code2vec"
    HEAD_EXPLICIT: bool = False  # True when --head was given
    MAX_CANDIDATES: int = 8      # the varmisuse head's candidate slots

    # ---- training ----
    DROPOUT_KEEP_RATE: float = 0.75
    TRAIN_BATCH_SIZE: int = 1024
    TEST_BATCH_SIZE: int = 1024
    # epochs of a `train` call; with the example count and the batch
    # size it sets a decaying schedule's horizon
    NUM_TRAIN_EPOCHS: int = 20
    NUM_BATCHES_TO_LOG_PROGRESS: int = 100
    LEARNING_RATE: float = 0.001
    # "cosine" | "linear" | "warmup_cosine" | "constant"
    LR_SCHEDULE: str = "cosine"
    # "warmup_cosine" warmup length; 0 = auto (5% of the horizon)
    LR_WARMUP_STEPS: int = 0
    # LAMB-style per-array trust-ratio rescale
    # (training/optimizers.make_optimizer)
    TRUST_RATIO: bool = False
    # "all": every optimizer branch; "dense": TRANSFORM / ATTENTION only
    TRUST_RATIO_SCOPE: str = "all"
    SEED: int = 239
    USE_SAMPLED_SOFTMAX: bool = False
    NUM_SAMPLED_CLASSES: int = 4096
    # touched-rows-only (lazy) Adam for the vocab tables: dedup +
    # segment-sum + the live-row kernels (training/sparse_steps.py)
    SPARSE_EMBEDDING_UPDATES: bool = False
    # "adafactor" (tables; Adam on TRANSFORM / ATTENTION) | "adam"
    EMBEDDING_OPTIMIZER: str = "adafactor"

    # ---- the training loop (Code2VecTrainer.train) ----
    # save (with --save) and evaluate (with --test) every this many epochs
    SAVE_EVERY_EPOCHS: int = 1
    # committed step dirs kept in --save
    MAX_TO_KEEP: int = 10
    # epoch saves through the background writer
    # (training/checkpoint.AsyncCheckpointWriter); False saves in the loop
    ASYNC_CHECKPOINT: bool = True
    # batches the infeed thread prepares ahead of the step
    # (data/prefetch.py); 0 copies each batch in the loop
    INFEED_PREFETCH: int = 2
    # --infeed_chunk: host batches grouped into one host-to-device copy
    # a field (data/prefetch.ChunkedDevicePrefetcher); 1 = per batch.
    # One process without a mesh only (a mesh falls back, logged)
    INFEED_CHUNK: int = 1
    # the card's streaming ceiling in GB/s (ops/membench.py: a read +
    # write copy over 1 GiB of float32), measured by chip_smoke.py [18]
    # on an NVIDIA H100 80GB HBM3 at 700.00 W (nvidia-smi's name and
    # power limit). It divides the analytic traffic model's bytes into
    # the live floor gauges (train/step_floor_ms, train/phase_floor_ms/*)
    # and the phase roofline; running the 1 GiB copy mid-train would
    # perturb the run
    HBM_CEILING_GBPS: float = 3034.9
    # --phase_profile on: every PHASE_SAMPLE_EVERY steps one step is
    # split into synced probe dispatches (obs/phases.py,
    # training/phase_probes.py) whose times publish as
    # train/phase/<p>_ms; the state update stays the fused step, so the
    # run's bits do not change. Needs a live registry (--telemetry_dir
    # or --metrics_port); off, one boolean check a step
    PHASE_PROFILE: str = "off"   # "off" | "on"
    PHASE_SAMPLE_EVERY: int = 64

    # ---- the mesh and the process group (the JAX package's names) ----
    MESH_DATA_AXIS: int = 0      # 0 -> the whole world on the data axis
    MESH_MODEL_AXIS: int = 1     # model-parallel degree (tables' rows)
    MESH_CONTEXT_AXIS: int = 1   # context-parallel degree (C over 'ctx')
    MESH_DCN_AXIS: int = 1       # the batch shards over ('dcn', 'data')
    DIST_COORDINATOR: Optional[str] = None   # host:port of process 0
    DIST_NUM_PROCESSES: Optional[int] = None
    DIST_PROCESS_ID: Optional[int] = None

    # ---- the command line (the JAX package's flag names) ----
    BACKEND: str = "gpu"            # --backend: "gpu" (CUDA) | "cpu"
    DL_FRAMEWORK: str = "pytorch"   # --framework (JAX values are aliases)
    train_data_path: Optional[str] = None   # --data <prefix>
    test_data_path: Optional[str] = None    # --test <file>
    save_path: Optional[str] = None         # --save <ckpt>
    load_path: Optional[str] = None         # --load <ckpt>
    release: bool = False                   # --release
    # --auto_resume: an existing checkpoint in --save is loaded and its
    # run continued (the same command line resumes after a restart)
    AUTO_RESUME: bool = False
    save_w2v: Optional[str] = None          # --save_w2v <path>
    save_t2v: Optional[str] = None          # --save_t2v <path>
    is_predict: bool = False                # --predict: the REPL

    # ---- the run's record and its recovery seams ----
    # --profile <dir>: a torch.profiler window over PROFILE_STEPS
    # training steps from PROFILE_START_STEP, its Chrome trace in <dir>
    PROFILE_DIR: Optional[str] = None
    PROFILE_STEPS: int = 10
    PROFILE_START_STEP: int = 5  # past the first steps' kernel builds
    # --tensorboard <dir>: train and eval scalars (a warn-once no-op
    # where torch.utils.tensorboard cannot be imported)
    TENSORBOARD_DIR: Optional[str] = None
    # --telemetry_dir <dir>: a per-run manifest and JSONL event log (a
    # step event a step, which waits for the card every step; device
    # memory gauges; serving latency). Unset: one boolean check a step
    TELEMETRY_DIR: Optional[str] = None
    # --trace: span trees of serving requests and train steps in the
    # event log (needs --telemetry_dir)
    TRACE: bool = False
    # --watchdog_stall_s: progress deadline of the train loop, infeed
    # producer, checkpoint writer and serving batcher (0 = off; needs
    # --telemetry_dir); --watchdog_mode: warn records, raise also makes
    # the stall a StallError at the component's next beat
    WATCHDOG_STALL_S: float = 0.0
    WATCHDOG_MODE: str = "warn"
    # --faults <file-or-inline-json>: the seeded failpoints
    # (resilience/faults.py); unset, every site is one None check
    FAULTS: Optional[str] = None

    # ---- adversarial attacks (attacks/): --attack {targeted,
    # untargeted} runs the gradient-guided rename attack on
    # --attack_input's source and reports the re-extracted,
    # re-predicted outcome ----
    ATTACK: Optional[str] = None          # "targeted" | "untargeted"
    ATTACK_TARGET: Optional[str] = None   # target method name (targeted)
    ATTACK_INPUT: str = "Input.java"      # source file to attack
    ATTACK_METHOD_INDEX: int = 0          # which method in the file
    ATTACK_MAX_RENAMES: int = 1           # variables to rename (greedy)
    ATTACK_DEADCODE: bool = False         # insert `int <adv>;` instead
    ATTACK_TOPK: int = 32                 # exact-rescore shortlist size
    ATTACK_ITERS: int = 4                 # rename iterations / variable
    # the rename defense (attacks/defense.py): with this probability each
    # training example of the dense step has one variable renamed to
    # another legal token (occurrences replaced consistently); 0 = off
    ADV_RENAME_PROB: float = 0.0
    # the defense's replacement: "uniform" (a random legal token) or
    # "batch" (another example's variable in the batch)
    ADV_RENAME_MODE: str = "uniform"

    # ---- the live metrics plane (obs/exposition.py, health.py,
    # alerts.py) ----
    # --metrics_port: serve /metrics (Prometheus text), /healthz
    # (watchdog liveness and page alerts), /vars (a JSON snapshot) and
    # /clock from a daemon-thread HTTP server on this port; 0 = off.
    # Without --telemetry_dir the registry lives in memory only
    METRICS_PORT: int = 0
    # --alerts_mode: "off" | "warn" | "raise". warn/raise run the health
    # monitors and alert rules off the hot path, with an `alert` event a
    # transition; raise also makes a firing alert an AlertError at the
    # train loop's next step
    ALERTS_MODE: str = "off"
    # --alerts_rules: a JSON file of rules replacing the built-in ones
    ALERTS_RULES: Optional[str] = None
    # the monitors' and rules' cadence in seconds (no flag: tests set it)
    HEALTH_EVERY_S: float = 1.0

    # ---- kernel selection (the JAX package's Pallas switches) ----
    # --no_pallas: the plain attention pool (kernel 1) and the plain MHA
    # (kernels 2, 3) in place of the kernels, on any device
    USE_PALLAS: bool = True
    # --requant_pallas (int8 tables, kernel 4) and --sparse_update_pallas
    # (--sparse_embeddings, kernels 5 and 6): "auto" = the kernel on a
    # CUDA tensor, the plain version on a CPU one; "fused" = the kernel
    # (a CPU run refuses it); "reference" = the plain version
    REQUANT_PALLAS: str = "auto"
    SPARSE_UPDATE_PALLAS: str = "auto"

    # ---- logging ----
    # -v / --verbose: 1 logs at INFO, 0 at WARNING
    VERBOSE_MODE: int = 1
    # --logs-path: also append the log to this file
    LOG_PATH: Optional[str] = None

    @property
    def is_training(self) -> bool:
        return bool(self.train_data_path)

    @property
    def is_testing(self) -> bool:
        return bool(self.test_data_path)

    @property
    def is_loading(self) -> bool:
        return bool(self.load_path)

    @property
    def is_saving(self) -> bool:
        return bool(self.save_path)

    def data_path(self, split: str) -> str:
        """Path of one split's `.c2v` file: `<prefix>.<split>.c2v`."""
        if self.train_data_path is None:
            raise ValueError("no --data prefix")
        return f"{self.train_data_path}.{split}.c2v"

    @property
    def word_freq_dict_path(self) -> Optional[str]:
        """The `.dict.c2v` histograms preprocessing wrote."""
        if not self.train_data_path:
            return None
        return f"{self.train_data_path}.dict.c2v"

    def get_logger(self) -> logging.Logger:
        """The package's logger at VERBOSE_MODE's level, with a file
        handler on LOG_PATH (added once per path); its records also go
        to the root logger's handlers (`python3 -m code2vec_tpu_torch`
        logs to standard output)."""
        logger = logging.getLogger("code2vec_tpu_torch")
        logger.setLevel(logging.INFO if self.VERBOSE_MODE >= 1
                        else logging.WARNING)
        if self.LOG_PATH:
            path = os.path.abspath(self.LOG_PATH)
            if not any(getattr(h, "baseFilename", None) == path
                       for h in logger.handlers):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                fh = logging.FileHandler(path)
                fh.setFormatter(logging.Formatter(
                    "%(asctime)s %(levelname)s %(message)s"))
                logger.addHandler(fh)
        return logger

    def log(self, msg: str) -> None:
        self.get_logger().info(msg)

    def verify(self) -> None:
        """The JAX package's `Config.verify` rules for the ported fields;
        raises ValueError on an invalid combination."""
        if self.MAX_CONTEXTS <= 0:
            raise ValueError("MAX_CONTEXTS must be positive.")
        if self.USE_SAMPLED_SOFTMAX and self.NUM_SAMPLED_CLASSES <= 0:
            raise ValueError("NUM_SAMPLED_CLASSES must be positive.")
        if self.TABLES_DTYPE not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"TABLES_DTYPE must be float32, bfloat16 or "
                             f"int8 (got {self.TABLES_DTYPE!r}).")
        if self.ENCODER_TYPE not in ("bag", "transformer"):
            raise ValueError(f"ENCODER_TYPE must be bag or transformer (got "
                             f"{self.ENCODER_TYPE!r}).")
        if self.ENCODER_TYPE == "transformer" and (
                self.XF_HEADS <= 0
                or (3 * self.DEFAULT_EMBEDDINGS_SIZE) % self.XF_HEADS):
            raise ValueError(
                f"XF_HEADS ({self.XF_HEADS}) must divide the context vector "
                f"size 3 * DEFAULT_EMBEDDINGS_SIZE "
                f"({3 * self.DEFAULT_EMBEDDINGS_SIZE}).")
        if self.TABLES_DTYPE == "int8":
            if self.ENCODER_TYPE != "bag":
                raise ValueError(
                    "TABLES_DTYPE int8 supports the bag encoder only "
                    "(the transformer gathers the tables directly).")
            if self.MESH_MODEL_AXIS > 1 or self.MESH_CONTEXT_AXIS > 1:
                raise ValueError(
                    "--tables_dtype int8 supports data-parallel meshes "
                    "only (model/ctx sharding of {q, s} subtrees is "
                    "untested; tables replicate under DP).")
            if self.TRUST_RATIO:
                raise ValueError(
                    "TABLES_DTYPE int8 is incompatible with TRUST_RATIO "
                    "(the trust rescale needs ||param|| of the flat table "
                    "the quantized step never materializes).")
            if self.ATTACK:
                raise ValueError(
                    "--attack needs float/bf16 tables (the gradient "
                    "attack's candidate matvec reads the table as one "
                    "array); rerun with a bf16 checkpoint.")
        if self.HEAD not in ("code2vec", "varmisuse"):
            raise ValueError(f"HEAD must be code2vec or varmisuse (got "
                             f"{self.HEAD!r}).")
        if self.HEAD == "varmisuse" and (self.is_predict or self.release
                                         or self.save_w2v
                                         or self.save_t2v
                                         or self.export_code_vectors):
            raise ValueError(
                "--predict/--release/--save_w2v/--save_t2v/"
                "--export_code_vectors apply to the code2vec head only.")
        if self.TABLES_DTYPE == "int8" and self.HEAD != "code2vec":
            raise ValueError(
                "--tables_dtype int8 supports the code2vec head only.")
        if not 0.0 <= self.ADV_RENAME_PROB <= 1.0:
            raise ValueError("--adv_rename_prob must be in [0, 1].")
        if self.ADV_RENAME_PROB > 0 and self.SPARSE_EMBEDDING_UPDATES:
            raise ValueError(
                "--adv_rename_prob is not supported with "
                "SPARSE_EMBEDDING_UPDATES (the sparse step has no "
                "augmentation hook).")
        if self.ADV_RENAME_PROB > 0 and self.HEAD == "varmisuse":
            raise ValueError(
                "--adv_rename_prob applies to the code2vec head only "
                "(the varmisuse train step has no augmentation hook).")
        if self.ATTACK and not self.is_loading:
            raise ValueError("--attack requires --load.")
        if self.ATTACK == "targeted" and not self.ATTACK_TARGET:
            raise ValueError(
                "--attack targeted requires --attack_target <name>.")
        if self.ATTACK and self.HEAD == "varmisuse":
            raise ValueError(
                "--attack applies to the code2vec head only.")
        if self.HEAD == "varmisuse" and (self.ENCODER_TYPE != "bag"
                                         or self.MESH_CONTEXT_AXIS > 1):
            # vm_scores calls the bag encode(); a transformer here would
            # train another architecture than asked
            raise ValueError(
                "--head varmisuse supports the bag encoder only "
                "(no --encoder transformer / --mesh_context > 1).")
        if self.MESH_CONTEXT_AXIS > 1 and (
                self.MAX_CONTEXTS % self.MESH_CONTEXT_AXIS):
            raise ValueError(
                f"--mesh_context {self.MESH_CONTEXT_AXIS} does not divide "
                f"MAX_CONTEXTS ({self.MAX_CONTEXTS}, --max_contexts): each "
                "rank of a ctx group holds MAX_CONTEXTS / --mesh_context "
                "contexts")
        if self.LR_WARMUP_STEPS < 0:
            raise ValueError("LR_WARMUP_STEPS must be >= 0.")
        if self.LR_WARMUP_STEPS > 0 and self.LR_SCHEDULE != "warmup_cosine":
            raise ValueError(
                "LR_WARMUP_STEPS applies only to LR_SCHEDULE "
                "warmup_cosine (other schedules have no warmup phase and "
                "would silently ignore it).")
        if (self.TRUST_RATIO and self.TRUST_RATIO_SCOPE == "dense"
                and self.EMBEDDING_OPTIMIZER != "adafactor"):
            raise ValueError(
                "TRUST_RATIO_SCOPE dense requires EMBEDDING_OPTIMIZER "
                "adafactor (adam runs one transform over all params; no "
                "table/dense split).")
        if self.TRUST_RATIO and self.SPARSE_EMBEDDING_UPDATES:
            raise ValueError(
                "TRUST_RATIO is not supported with SPARSE_EMBEDDING_UPDATES "
                "(the sparse row-update kernel bypasses the optimizer chain "
                "for the tables).")
        if self.SPARSE_EMBEDDING_UPDATES and \
                self.EMBEDDING_OPTIMIZER != "adam":
            # the live-row update IS row-Adam; adafactor's factored
            # column stats are global over V
            raise ValueError(
                "SPARSE_EMBEDDING_UPDATES requires the adam embedding "
                "optimizer (the live-row kernel applies row-Adam; "
                "float32/bfloat16/int8 tables are all supported).")
        if self.SPARSE_EMBEDDING_UPDATES and self.LR_SCHEDULE != "constant":
            raise ValueError(
                "SPARSE_EMBEDDING_UPDATES supports constant LR only (the "
                "row update applies a fixed per-row learning rate).")
        if self.SPARSE_EMBEDDING_UPDATES and self.ENCODER_TYPE != "bag":
            raise ValueError(
                "SPARSE_EMBEDDING_UPDATES supports the bag encoder only "
                "(the sparse step trains no transformer params).")
        if self.SERVE_BATCH_MAX < 1 or (
                self.SERVE_BATCH_MAX & (self.SERVE_BATCH_MAX - 1)):
            # the flush cap is the largest warmed bucket
            raise ValueError("--serve_batch_max must be a power of two "
                             f"(got {self.SERVE_BATCH_MAX}).")
        if self.SERVE_BATCH_TIMEOUT_MS < 0:
            raise ValueError("--serve_batch_timeout_ms must be >= 0.")
        if self.SERVE_QUEUE_DEPTH < 1:
            raise ValueError("--serve_queue_depth must be >= 1.")
        if self.SERVE_DEADLINE_MS < 0:
            raise ValueError("--serve_deadline_ms must be >= 0.")
        if self.SERVE_CACHE_SIZE < 0:
            raise ValueError("--serve_cache_size must be >= 0.")
        if self.SERVE_EXTRACT_WORKERS < 1:
            raise ValueError("--serve_extract_workers must be >= 1.")
        if not 0 <= self.SERVE_PORT <= 65535:
            raise ValueError("--serve_port must be in [0, 65535].")
        if self.SERVE_MIN_REPLICAS < 1:
            raise ValueError("--serve_min_replicas must be >= 1.")
        if self.SERVE_MAX_REPLICAS < self.SERVE_MIN_REPLICAS:
            raise ValueError(
                "--serve_max_replicas must be >= --serve_min_replicas "
                f"(got {self.SERVE_MAX_REPLICAS} < "
                f"{self.SERVE_MIN_REPLICAS}).")
        if not (self.SERVE_MIN_REPLICAS <= self.SERVE_REPLICAS
                <= self.SERVE_MAX_REPLICAS):
            raise ValueError(
                "--serve_replicas must sit inside "
                "[--serve_min_replicas, --serve_max_replicas] "
                f"(got {self.SERVE_REPLICAS} outside "
                f"[{self.SERVE_MIN_REPLICAS}, "
                f"{self.SERVE_MAX_REPLICAS}]).")
        if self.SERVE_SLO_MS <= 0:
            raise ValueError("--serve_slo_ms must be > 0.")
        if self.SERVE_RELOAD_POLL_S < 0:
            raise ValueError("--serve_reload_poll_s must be >= 0.")
        if self.TRACE and not self.TELEMETRY_DIR:
            raise ValueError(
                "--trace requires --telemetry_dir (spans are recorded "
                "through the run's JSONL event log).")
        if self.WATCHDOG_STALL_S < 0:
            raise ValueError("--watchdog_stall_s must be >= 0.")
        if self.WATCHDOG_STALL_S > 0 and not self.TELEMETRY_DIR:
            raise ValueError(
                "--watchdog_stall_s requires --telemetry_dir (stall "
                "events and diagnostic dumps live in the run dir).")
        if self.WATCHDOG_MODE not in ("warn", "raise"):
            raise ValueError("--watchdog_mode must be warn or raise "
                             f"(got {self.WATCHDOG_MODE!r}).")
        if not 0 <= self.METRICS_PORT <= 65535:
            raise ValueError(
                f"--metrics_port must be in [0, 65535] "
                f"(got {self.METRICS_PORT}).")
        if self.ALERTS_MODE not in ("off", "warn", "raise"):
            raise ValueError(
                "--alerts_mode must be off, warn or raise "
                f"(got {self.ALERTS_MODE!r}).")
        if self.ALERTS_MODE != "off" and not self.TELEMETRY_DIR:
            raise ValueError(
                "--alerts_mode warn/raise requires --telemetry_dir "
                "(alert events are recorded through the run's JSONL "
                "event log; --metrics_port alone works without it).")
        if self.ALERTS_RULES and self.ALERTS_MODE == "off":
            raise ValueError(
                "--alerts_rules without --alerts_mode warn|raise "
                "would be silently ignored.")
        if self.HEALTH_EVERY_S <= 0:
            raise ValueError("HEALTH_EVERY_S must be positive.")
        if self.PHASE_PROFILE not in ("off", "on"):
            raise ValueError(
                "--phase_profile must be off or on "
                f"(got {self.PHASE_PROFILE!r}).")
        if self.PHASE_SAMPLE_EVERY < 1:
            raise ValueError("--phase_sample_every must be >= 1.")
        if self.PHASE_PROFILE == "on" and not self.TELEMETRY_DIR \
                and self.METRICS_PORT <= 0:
            raise ValueError(
                "--phase_profile on needs a live registry: pass "
                "--telemetry_dir (persisted phase events) or "
                "--metrics_port (in-memory, scrape-only).")
        if self.REQUANT_PALLAS not in ("auto", "fused", "reference"):
            raise ValueError(
                "--requant_pallas must be auto, fused or reference "
                f"(got {self.REQUANT_PALLAS!r}).")
        if self.SPARSE_UPDATE_PALLAS not in ("auto", "fused",
                                             "reference"):
            raise ValueError(
                "--sparse_update_pallas must be auto, fused or "
                f"reference (got {self.SPARSE_UPDATE_PALLAS!r}).")
        if self.PROFILE_STEPS < 1:
            raise ValueError("--profile_steps must be >= 1.")
        if self.INFEED_PREFETCH < 0:
            raise ValueError("--infeed_prefetch must be >= 0.")
        check_infeed_chunk(self.INFEED_CHUNK, self.INFEED_PREFETCH)
        if self.SAVE_EVERY_EPOCHS < 1:
            raise ValueError("SAVE_EVERY_EPOCHS must be >= 1.")
        if self.MAX_TO_KEEP < 1:
            raise ValueError("MAX_TO_KEEP must be >= 1.")
        if self.BACKEND not in ("gpu", "cpu"):
            raise ValueError(
                f"--backend {self.BACKEND}: this implementation runs on a "
                "CUDA card (gpu) or the cpu")
        if self.DL_FRAMEWORK not in _FRAMEWORKS:
            raise ValueError(f"--framework {self.DL_FRAMEWORK!r} unknown "
                             f"(expected one of {', '.join(_FRAMEWORKS)}).")

    def verify_command_line(self) -> None:
        """`verify` and the rules of the command line's surface."""
        self.verify()
        if self.DL_FRAMEWORK != "pytorch":
            self.log(f"--framework {self.DL_FRAMEWORK}: running the PyTorch "
                     "implementation (this package's only one; the flag is "
                     "accepted as an alias for reference compatibility)")
        if not (self.is_training or self.is_loading):
            raise ValueError(
                "Must train (--data) or load a trained model (--load).")
        if self.is_predict and not self.is_loading:
            raise ValueError("--predict requires --load.")
        if self.release and not self.is_loading:
            raise ValueError("--release requires --load.")

    # ---- the command line ----
    @classmethod
    def arguments_parser(cls) -> argparse.ArgumentParser:
        """The JAX package's flags (names and `dest`s) of the ported
        fields."""
        p = argparse.ArgumentParser(
            prog="python3 -m code2vec_tpu_torch",
            description="code2vec on PyTorch", allow_abbrev=False)
        p.add_argument("--data", dest="data_path", default=None,
                       help="path prefix of {train,val,test}.c2v data")
        p.add_argument("--test", dest="test_path", default=None,
                       help="path to a .c2v test file")
        p.add_argument("--save", dest="save_path", default=None)
        p.add_argument("--load", dest="load_path", default=None)
        p.add_argument("--predict", action="store_true")
        p.add_argument("--release", action="store_true")
        p.add_argument("--auto_resume", action="store_true",
                       help="resume from --save's latest checkpoint "
                            "when one exists")
        p.add_argument("--export_code_vectors", action="store_true")
        p.add_argument("--save_w2v", dest="save_w2v", default=None)
        p.add_argument("--save_t2v", dest="save_t2v", default=None)
        p.add_argument("--framework", dest="dl_framework", default=None,
                       choices=list(_FRAMEWORKS),
                       help="accepted for compatibility; always runs the "
                            "PyTorch implementation")
        p.add_argument("--backend", dest="backend", default=None,
                       choices=["gpu", "cpu", "tpu"],
                       help="gpu (default): the CUDA card; cpu")
        p.add_argument("--max_contexts", dest="max_contexts", type=int,
                       default=None)
        p.add_argument("--batch_size", dest="batch_size", type=int,
                       default=None)
        p.add_argument("--epochs", dest="epochs", type=int, default=None)
        p.add_argument("--lr", dest="lr", type=float, default=None)
        p.add_argument("--lr_schedule", dest="lr_schedule", default=None,
                       choices=["constant", "cosine", "linear",
                                "warmup_cosine"])
        p.add_argument("--warmup_steps", dest="warmup_steps", type=int,
                       default=None)
        p.add_argument("--trust_ratio_scope", dest="trust_ratio_scope",
                       default=None, choices=["all", "dense"])
        p.add_argument("--trust_ratio", dest="trust_ratio",
                       action="store_true")
        p.add_argument("--infeed_prefetch", dest="infeed_prefetch",
                       type=int, default=None,
                       help="batches the infeed prepares ahead of the "
                            "step (0 = synchronous)")
        p.add_argument("--infeed_chunk", dest="infeed_chunk", type=int,
                       default=None,
                       help="host batches a host-to-device copy (1 = "
                            "per batch; > 1 needs --infeed_prefetch >= 1)")
        p.add_argument("--async_checkpoint", dest="async_checkpoint",
                       default=None, choices=["on", "off"])
        p.add_argument("--sampled_softmax", dest="sampled_softmax",
                       action="store_true")
        p.add_argument("--num_sampled", dest="num_sampled", type=int,
                       default=None)
        p.add_argument("--encoder", dest="encoder", default=None,
                       choices=["bag", "transformer"])
        p.add_argument("--xf_layers", dest="xf_layers", type=int,
                       default=None)
        p.add_argument("--xf_heads", dest="xf_heads", type=int,
                       default=None)
        p.add_argument("--xf_remat", dest="xf_remat", action="store_true")
        p.add_argument("--ring_attention", dest="ring_attention",
                       action="store_true")
        p.add_argument("--head", dest="head", default=None,
                       choices=["code2vec", "varmisuse"])
        p.add_argument("--max_candidates", dest="max_candidates",
                       type=int, default=None)
        p.add_argument("--tables_dtype", dest="tables_dtype", default=None,
                       choices=["float32", "bfloat16", "int8"])
        p.add_argument("--no_bf16", dest="no_bf16", action="store_true")
        p.add_argument("--no_pallas", dest="no_pallas",
                       action="store_true",
                       help="the plain attention pool and MHA in place of "
                            "kernels 1, 2 and 3 (the A/B control)")
        p.add_argument("--requant_pallas", dest="requant_pallas",
                       default=None,
                       choices=["auto", "fused", "reference"],
                       help="int8 requantize: kernel 4 (fused; auto on "
                            "the card) or its plain version (reference)")
        p.add_argument("--sparse_update_pallas",
                       dest="sparse_update_pallas", default=None,
                       choices=["auto", "fused", "reference"],
                       help="the live-row update under "
                            "--sparse_embeddings: kernels 5 and 6 "
                            "(fused; auto on the card) or their plain "
                            "versions (reference)")
        p.add_argument("--sparse_embeddings", dest="sparse_embeddings",
                       action="store_true")
        p.add_argument("--embedding_optimizer", dest="embedding_optimizer",
                       default=None, choices=["adam", "adafactor"])
        p.add_argument("--seed", dest="seed", type=int, default=None)
        p.add_argument("--mesh_data", dest="mesh_data", type=int,
                       default=None,
                       help="data-parallel ranks (0: the world over the "
                            "other axes)")
        p.add_argument("--mesh_model", dest="mesh_model", type=int,
                       default=None,
                       help="ranks the vocab tables' rows are split over")
        p.add_argument("--mesh_context", dest="mesh_context", type=int,
                       default=None,
                       help="ranks the context dim is split over")
        p.add_argument("--mesh_dcn", dest="mesh_dcn", type=int,
                       default=None,
                       help="a second factor of the batch shards")
        p.add_argument("--dist_coordinator", dest="dist_coordinator",
                       default=None,
                       help="host:port of process 0 for multi-process runs")
        p.add_argument("--dist_num_processes", dest="dist_num_processes",
                       type=int, default=None)
        p.add_argument("--dist_process_id", dest="dist_process_id",
                       type=int, default=None)
        p.add_argument("--logs-path", dest="logs_path", default=None)
        p.add_argument("--profile", dest="profile_dir", default=None,
                       help="write a torch.profiler Chrome trace of a few "
                            "training steps to this directory")
        p.add_argument("--profile_steps", dest="profile_steps", type=int,
                       default=None)
        p.add_argument("--tensorboard", dest="tensorboard_dir",
                       default=None,
                       help="write loss/throughput/eval scalars as "
                            "TensorBoard summaries to this directory")
        p.add_argument("--telemetry_dir", dest="telemetry_dir",
                       default=None,
                       help="run telemetry: per-run manifest + JSONL "
                            "event log (per-step step_ms / infeed_wait_ms "
                            "/ loss, device-memory gauges, serving "
                            "latency)")
        p.add_argument("--trace", dest="trace", action="store_true",
                       help="span trees for serving requests and train "
                            "steps in the telemetry event log (requires "
                            "--telemetry_dir)")
        p.add_argument("--watchdog_stall_s", dest="watchdog_stall_s",
                       type=float, default=None,
                       help="stall watchdog progress deadline in seconds "
                            "(0 = off; requires --telemetry_dir)")
        p.add_argument("--watchdog_mode", dest="watchdog_mode",
                       default=None, choices=["warn", "raise"])
        p.add_argument("--metrics_port", dest="metrics_port",
                       type=int, default=None,
                       help="serve /metrics (Prometheus text), "
                            "/healthz (watchdog liveness) and /vars "
                            "(JSON snapshot) on this port from a "
                            "daemon-thread HTTP server (0 = off; "
                            "works with or without --telemetry_dir)")
        p.add_argument("--alerts_mode", dest="alerts_mode",
                       default=None, choices=["off", "warn", "raise"],
                       help="training-health monitors + SLO alert "
                            "rules evaluated off the hot path: warn "
                            "records edge-triggered alert events, "
                            "raise additionally surfaces a sticky "
                            "AlertError at the train loop's next beat "
                            "(requires --telemetry_dir)")
        p.add_argument("--alerts_rules", dest="alerts_rules",
                       default=None,
                       help="JSON rule file replacing the built-in "
                            "alert rules (threshold + multi-window "
                            "burn-rate)")
        p.add_argument("--phase_profile", dest="phase_profile",
                       default=None, choices=["off", "on"],
                       help="sampled per-phase device timing: every "
                            "--phase_sample_every steps one step runs "
                            "phase-split (synced per-phase dispatches; "
                            "the state update stays the fused step) "
                            "and publishes train/phase/* timers + "
                            "health_phase_* roofline gauges (needs "
                            "--telemetry_dir or --metrics_port)")
        p.add_argument("--phase_sample_every",
                       dest="phase_sample_every", type=int,
                       default=None,
                       help="steps between phase-split samples "
                            "(default 64; the non-sampled hot path is "
                            "untouched)")
        p.add_argument("--serve_batch_max", dest="serve_batch_max",
                       type=int, default=None,
                       help="max methods per coalesced serving batch "
                            "(power of two)")
        p.add_argument("--serve_batch_timeout_ms",
                       dest="serve_batch_timeout_ms", type=float,
                       default=None)
        p.add_argument("--serve_queue_depth", dest="serve_queue_depth",
                       type=int, default=None)
        p.add_argument("--serve_deadline_ms", dest="serve_deadline_ms",
                       type=float, default=None)
        p.add_argument("--serve_cache_size", dest="serve_cache_size",
                       type=int, default=None)
        p.add_argument("--serve_extract_workers",
                       dest="serve_extract_workers", type=int,
                       default=None)
        p.add_argument("--serve_port", dest="serve_port", type=int,
                       default=None,
                       help="HTTP front-end port (POST /predict, GET "
                            "/healthz /metrics /pool); 0 = no socket")
        p.add_argument("--serve_replicas", dest="serve_replicas",
                       type=int, default=None,
                       help="initial replica count behind the serving "
                            "front-end (one model per replica, one "
                            "shared prediction cache)")
        p.add_argument("--serve_min_replicas",
                       dest="serve_min_replicas", type=int,
                       default=None,
                       help="autoscaler floor: the pool never shrinks "
                            "below this")
        p.add_argument("--serve_max_replicas",
                       dest="serve_max_replicas", type=int,
                       default=None,
                       help="autoscaler ceiling: the pool never grows "
                            "past this")
        p.add_argument("--serve_slo_ms", dest="serve_slo_ms",
                       type=float, default=None,
                       help="p99 latency SLO in ms (the autoscaler's "
                            "serving_p99_slo rule threshold)")
        p.add_argument("--serve_reload_poll_s",
                       dest="serve_reload_poll_s", type=float,
                       default=None,
                       help="checkpoint-dir poll cadence for hot "
                            "weight reload (sha256-verified, one "
                            "replica at a time); 0 = off")
        p.add_argument("--serve_autoscale", dest="serve_autoscale",
                       action="store_true",
                       help="run the SLO autoscaling policy loop "
                            "(grow on burn-rate/p99 pages, shrink "
                            "after a sustained quiet window)")
        p.add_argument("--faults", dest="faults", default=None,
                       help="fault injection: a JSON file (or inline JSON) "
                            "arming named failpoints")
        p.add_argument("--attack", dest="attack", default=None,
                       choices=["targeted", "untargeted"],
                       help="gradient-guided variable-rename attack on "
                            "--attack_input (needs --load)")
        p.add_argument("--attack_target", dest="attack_target",
                       default=None,
                       help="target method name for --attack targeted "
                            "(camelCase or subtoken|form)")
        p.add_argument("--attack_input", dest="attack_input",
                       default=None, help="source file (default "
                                          "Input.java)")
        p.add_argument("--attack_method_index", dest="attack_method_index",
                       type=int, default=None)
        p.add_argument("--attack_max_renames", dest="attack_max_renames",
                       type=int, default=None)
        p.add_argument("--attack_deadcode", dest="attack_deadcode",
                       action="store_true",
                       help="insert a dead `int <adv>;` declaration and "
                            "adversarially choose its name instead of "
                            "renaming an existing variable")
        p.add_argument("--attack_topk", dest="attack_topk", type=int,
                       default=None)
        p.add_argument("--attack_iters", dest="attack_iters", type=int,
                       default=None)
        p.add_argument("--adv_rename_prob", dest="adv_rename_prob",
                       type=float, default=None,
                       help="adversarial-training defense: probability "
                            "of randomly renaming one variable per "
                            "training example")
        p.add_argument("--adv_rename_mode", dest="adv_rename_mode",
                       default=None, choices=["uniform", "batch"],
                       help="defense replacement distribution: uniform "
                            "legal token, or another batch example's "
                            "variable (wrong-class cue training)")
        p.add_argument("-v", "--verbose", dest="verbose_mode", type=int,
                       default=None)
        return p

    @classmethod
    def load_from_args(cls, args: Optional[List[str]] = None) -> "Config":
        """Parse a command line (default: sys.argv) into a verified
        Config. ValueError on a flag that is not ported and on an
        invalid combination."""
        ns, unknown = cls.arguments_parser().parse_known_args(
            args if args is not None else sys.argv[1:])
        flags = sorted({a.split("=", 1)[0] for a in unknown
                        if a.startswith("-")})
        if unknown:
            raise ValueError(
                "not ported to code2vec_tpu_torch yet: "
                + " ".join(flags or unknown))
        cfg = cls()
        cfg.train_data_path = ns.data_path
        cfg.test_data_path = ns.test_path
        cfg.save_path = ns.save_path
        cfg.load_path = ns.load_path
        cfg.release = ns.release
        cfg.is_predict = ns.predict
        cfg.AUTO_RESUME = ns.auto_resume
        cfg.export_code_vectors = ns.export_code_vectors
        cfg.save_w2v = ns.save_w2v
        cfg.save_t2v = ns.save_t2v
        for dest, field in (
                ("dl_framework", "DL_FRAMEWORK"), ("backend", "BACKEND"),
                ("max_contexts", "MAX_CONTEXTS"),
                ("batch_size", "TRAIN_BATCH_SIZE"),
                ("epochs", "NUM_TRAIN_EPOCHS"), ("lr", "LEARNING_RATE"),
                ("lr_schedule", "LR_SCHEDULE"),
                ("warmup_steps", "LR_WARMUP_STEPS"),
                ("trust_ratio_scope", "TRUST_RATIO_SCOPE"),
                ("infeed_prefetch", "INFEED_PREFETCH"),
                ("infeed_chunk", "INFEED_CHUNK"),
                ("num_sampled", "NUM_SAMPLED_CLASSES"),
                ("encoder", "ENCODER_TYPE"), ("xf_layers", "XF_LAYERS"),
                ("xf_heads", "XF_HEADS"), ("head", "HEAD"),
                ("max_candidates", "MAX_CANDIDATES"),
                ("tables_dtype", "TABLES_DTYPE"),
                ("embedding_optimizer", "EMBEDDING_OPTIMIZER"),
                ("seed", "SEED"), ("profile_dir", "PROFILE_DIR"),
                ("profile_steps", "PROFILE_STEPS"),
                ("tensorboard_dir", "TENSORBOARD_DIR"),
                ("telemetry_dir", "TELEMETRY_DIR"),
                ("watchdog_stall_s", "WATCHDOG_STALL_S"),
                ("watchdog_mode", "WATCHDOG_MODE"),
                ("serve_batch_max", "SERVE_BATCH_MAX"),
                ("serve_batch_timeout_ms", "SERVE_BATCH_TIMEOUT_MS"),
                ("serve_queue_depth", "SERVE_QUEUE_DEPTH"),
                ("serve_deadline_ms", "SERVE_DEADLINE_MS"),
                ("serve_cache_size", "SERVE_CACHE_SIZE"),
                ("serve_extract_workers", "SERVE_EXTRACT_WORKERS"),
                ("serve_port", "SERVE_PORT"),
                ("serve_replicas", "SERVE_REPLICAS"),
                ("serve_min_replicas", "SERVE_MIN_REPLICAS"),
                ("serve_max_replicas", "SERVE_MAX_REPLICAS"),
                ("serve_slo_ms", "SERVE_SLO_MS"),
                ("serve_reload_poll_s", "SERVE_RELOAD_POLL_S"),
                ("faults", "FAULTS"), ("metrics_port", "METRICS_PORT"),
                ("alerts_mode", "ALERTS_MODE"),
                ("alerts_rules", "ALERTS_RULES"),
                ("phase_profile", "PHASE_PROFILE"),
                ("phase_sample_every", "PHASE_SAMPLE_EVERY"),
                ("requant_pallas", "REQUANT_PALLAS"),
                ("sparse_update_pallas", "SPARSE_UPDATE_PALLAS"),
                ("logs_path", "LOG_PATH"), ("attack", "ATTACK"),
                ("attack_target", "ATTACK_TARGET"),
                ("attack_input", "ATTACK_INPUT"),
                ("attack_method_index", "ATTACK_METHOD_INDEX"),
                ("attack_max_renames", "ATTACK_MAX_RENAMES"),
                ("attack_topk", "ATTACK_TOPK"),
                ("attack_iters", "ATTACK_ITERS"),
                ("adv_rename_prob", "ADV_RENAME_PROB"),
                ("adv_rename_mode", "ADV_RENAME_MODE"),
                ("verbose_mode", "VERBOSE_MODE")):
            value = getattr(ns, dest)
            if value is not None:
                setattr(cfg, field, value)
        for dest, field, value in (
                ("trust_ratio", "TRUST_RATIO", True),
                ("sampled_softmax", "USE_SAMPLED_SOFTMAX", True),
                ("xf_remat", "XF_REMAT", True),
                ("ring_attention", "RING_ATTENTION", True),
                ("no_bf16", "USE_BF16", False), ("trace", "TRACE", True),
                ("no_pallas", "USE_PALLAS", False),
                ("attack_deadcode", "ATTACK_DEADCODE", True),
                ("serve_autoscale", "SERVE_AUTOSCALE", True),
                ("sparse_embeddings", "SPARSE_EMBEDDING_UPDATES", True)):
            if getattr(ns, dest):
                setattr(cfg, field, value)
        for dest, field in (("mesh_data", "MESH_DATA_AXIS"),
                            ("mesh_model", "MESH_MODEL_AXIS"),
                            ("mesh_context", "MESH_CONTEXT_AXIS"),
                            ("mesh_dcn", "MESH_DCN_AXIS")):
            if getattr(ns, dest) is not None:
                setattr(cfg, field, getattr(ns, dest))
        cfg.DIST_COORDINATOR = ns.dist_coordinator
        cfg.DIST_NUM_PROCESSES = ns.dist_num_processes
        cfg.DIST_PROCESS_ID = ns.dist_process_id
        cfg.HEAD_EXPLICIT = ns.head is not None
        if ns.async_checkpoint is not None:
            cfg.ASYNC_CHECKPOINT = ns.async_checkpoint == "on"
        cfg.verify_command_line()
        return cfg


_FRAMEWORKS = ("pytorch", "jax", "tensorflow", "keras")


def check_infeed_chunk(chunk: int, prefetch: int) -> None:
    """The JAX package's rules of `--infeed_chunk` (its `Config.verify`,
    in its words): ValueError unless chunk >= 1, and a chunk above 1 with
    `--infeed_prefetch 0` (the chunked infeed always runs the producer
    thread, which would confound the synchronous control)."""
    if chunk < 1:
        raise ValueError("--infeed_chunk must be >= 1.")
    if chunk > 1 and prefetch == 0:
        raise ValueError(
            "--infeed_chunk > 1 requires --infeed_prefetch >= 1 "
            "(chunked infeed always uses the producer thread).")

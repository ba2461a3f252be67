#!/usr/bin/env python3
"""Run the PyTorch port's serving, training, evaluation and command-line
paths on one CUDA card and check them.

    python3 chip_smoke.py [--out FILE]

Phases (any failure raises, and the script exits non-zero):

1. the card (`nvidia-smi` name and power limit), torch and CUDA versions;
   TF32 is switched off for float32 products and convolutions;
2. build every kernel of the ported paths from `code2vec_tpu_torch/csrc`,
   one `nvcc` per source, all started together, and beside them [15]'s
   native extractor with the host's c++; print each entry point's
   registers and spills;
3. the attention-pool kernel (kernel 1; bf16 contexts on the tensor
   cores: `pool_split_kernel`, `attention_pool_tc_kernel`,
   `pool_combine_kernel`; float32 on the CUDA cores:
   `attention_pool_kernel`) against its plain PyTorch version on the
   card, at the serving shapes (B = 1, 7, 64; bf16 and float32
   contexts) and the training shape (B = 1024, bf16), twice on the same
   inputs (the same bits), with its time beside the plain version's,
   float32 and bf16 `torch.matmul` yardsticks' and the card's bound;
4. the serving path at java-large width (vocab sizes 1,301,136 tokens,
   911,417 paths, 261,245 targets; E = 128, C = 200, bf16 tables, bf16
   compute; random weights from seed 0, a synthetic vocab): the port's
   `PredictionServer` answers 32 concurrent requests of raw extractor
   lines. Every kernel's launch counter is set to 0 just before and read
   just after; each must have launched. One batch is then held against
   the plain path on the card; the tie-stable top-k (`topk_stable`) over
   its [64, 261,247] probabilities against a stable sort (the same ids)
   and timed beside `torch.topk`;
5. the sparse-row training path at the same width (`TRAIN_BATCH_SIZE`
   1024, bf16 compute) over a synthetic `.c2v` file whose words are drawn
   Zipf (s = 1.1) over the vocab, through the trainer entry point, in two
   configurations: (a) bf16 tables, sampled softmax over 4096 classes
   (kernel 5 on token, path and target); (b) int8 token/path and bf16
   target tables, full softmax (kernel 6 on token and path, dense Adam on
   target). For each: a few steps with the counters at 0 just before and
   read just after (launches must match the tables updated per step);
   one step with the kernels against one with the plain versions from
   the same state, draws and row gradients; one step run twice from one
   cloned state with the same draws (every param and optimizer tensor
   and the loss the same bits); the loss falling over 5 steps of a
   repeated batch; the step time and its split by phase;
6. the live-row Adam kernels (5 and 6) against their plain versions on
   the card, at U = 1, 1000 and the U of a java-large step, for E = 128
   bf16, E = 128 float32, E = 384 bf16 (kernel 5) and E = 128 int8
   (kernel 6), with their times beside the plain versions' and the bound;
7. the dense int8 requantize kernel (kernel 4) against its plain version
   on the card, at (V, E) = (1, 128), (1000, 128), (257, 100) and the two
   java-large int8 tables (1,301,138 and 911,419 rows of 128), bf16
   updates and one float32 case (E = 128 on the 16-byte
   `requant_vec_kernel`, E = 100 on the scalar `requant_kernel`): q and
   s bit-identical, its time beside the plain version's and the byte
   bound;
8. the dense training path (the default step) at the same width through
   the trainer, over the same file, in two configurations: (c) the JAX
   package's defaults: bf16 tables, full softmax, Adafactor on the
   tables, Adam on TRANSFORM / ATTENTION, cosine LR; (d) int8 token/path
   and bf16 target tables, sampled softmax over 4096, Adafactor, cosine
   LR (kernel 4 on token and path every step). For each: counted steps
   (kernel 4 twice a step in (d), never in (c), kernel 1 once a step);
   one step with the kernels against one with the plain versions from the
   same state and draws (loss within 1e-3; the same optimizer update
   applied by both gives bit-identical tables, q and s); one step twice
   from one cloned state (the same bits); in (c) the gathers' backward
   scatters (ops/scatter.py's fixed order) timed beside `index_add_`;
   the loss falling over 5 steps of a repeated batch; the step time,
   its split by phase and the device busy share;
9. evaluation: `Code2VecTrainer.evaluate` over a synthetic 4096-method
   test file at TEST_BATCH_SIZE 1024 (counted: kernel 1 once a batch),
   its results and methods/s; the kernel path held against the plain
   path batch by batch (loss within 1e-3, top-1 equal on 99% of the
   methods); the tie-stable top-k at [1024, 261,247], as in 4;
10. the fused multi-head attention kernels (2: forward, on bf16 the
   tensor-core `mha_fwd_tc_kernel`; 3: backward as launches 3a and 3b, on
   bf16 the tensor-core `mha_bwd_dq_tc_kernel` and
   `mha_bwd_dkv_tc_kernel`) against their plain versions on the card, at
   (B, H, C, hd) = (1, 3, 200, 128), (7, ...), (64, ...), (1024, ...),
   (4, 4, 200, 96) and a ragged (16, 3, 37, 128) in bf16 and
   (4, 4, 200, 96), (16, 2, 24, 16) in float32; kernels 2 and 3 twice on
   the same inputs give the same bits; their times (CUDA events and
   profiler device time, 3a and 3b apart, by the kernels' names) beside
   the plain versions', the SDPA yardstick's and the bound;
11. the transformer path-encoder (bench.py's configuration: L = 2,
   H = 3, bf16) behind the `PredictionServer`, 32 concurrent requests:
   kernel 2 launches L times a device batch and kernel 1 never; one
   batch held against the plain path (the plain versions of kernels 2
   and 3 in the kernels' place);
12. (e) the transformer dense training path through the trainer
   (Adafactor tables, Adam on the rest at a constant 1e-3, sampled
   softmax over 4096): counted steps (kernels 2 and 3 L times a step),
   one kernel step against one plain step from the same state and draws
   (loss, the "xf" gradients), an XF_REMAT step (kernel 2 2L times, the
   same loss), one step twice from one cloned state (the same bits), the
   loss falling over 5 steps of a repeated batch, the step time, its
   split by phase, the device busy share and peak memory; then a trained
   state (XF_TRAINED_EPOCHS more epochs through `train`, 32 steps): the
   xf gradients of the kernel path against the plain path's printed,
   and each layer's q, k, v and log_mask captured where they reach
   `fused_mha`: kernel 2's o within 1 bf16 ulp of a float64 oracle
   rounded once to bf16 where a float32 evaluation resolves it, and
   differing from it on at most twice the plain version's share of the
   elements;
13. evaluation of a transformer model over the 4096-method test file
   (kernel 2 L times a batch), against the plain path batch by batch;
14. the command line (`cli.main([...])` in this process, as
   `python3 -m code2vec_tpu_torch` runs it) at the same width, bf16:
   a `.dict.c2v` of the synthetic vocab and the port's binarize of the
   training and test files; 2 epochs of 4 steps with `--save`, `--test`
   and `--infeed_prefetch 2` (counted: kernel 1 once a step and once an
   evaluation batch); the latest step reloaded bit-identical to the
   trainer's state at save time, its checksums verified; that step set
   aside and the same command rerun with `--auto_resume` (the restored
   step, epoch offset and steps; the final state and the losses
   bit-identical to the set-aside run's), beside a second uninterrupted
   run (bit-identical too) and a resume whose reader replays the first
   epoch's order (the control, which must differ); a flipped
   byte in the latest state quarantined and the load fallen back to the
   step before; `--release`, then `--load <released> --test` (the
   evaluation equal to the one before the release) and, in a process of
   its own that runs beside [15]-[18] and is checked at [18]'s end, the
   same command with the w2v, t2v and code-vector exports (rows, widths,
   finite values); one-epoch save and
   `--load` round trips with `--sparse_embeddings` (kernel 5) and
   `--tables_dtype int8` (kernel 4), bit-identical; then the loop's
   steps/s and methods/s past its first epoch (binary shards or text,
   the infeed 2 ahead or synchronous, in alternating pairs), its device
   busy share and kernel 1's launches by name in a profiled run, an
   async save's blocked time against a synchronous
   one's, the writer's time, the state's bytes, the sha256 time and the
   load-and-verify time; then (c) for 2 epochs (8 steps) through the
   trainer's loop at `--infeed_chunk 4` (the pinned chunk ring, one
   host-to-device copy a field a chunk, counted) against
   `--infeed_chunk 1`: the same param digests, the steps/s of each
   (counted: kernel 1 once a step);
15. the `--predict` REPL: the native extractor built from the port's
   C++ sources (both targets, in [2] beside the kernels) and checked against
   `tests/golden/*.expected`; `python3 -m code2vec_tpu_torch --load
   <[14]'s released model> --predict` as a subprocess in a directory
   holding a copy of Input.java, fed three Enters then `q` (exit 0; for
   every method its name, k predictions, at most SHOW_TOP_CONTEXTS
   attention lines and the latency line; the first request's time and
   the cached p50); the REPL in this process under torch.profiler
   (counted: kernel 1 once a device batch), its top-1 names held against
   a `PredictionServer.predict_lines` run with the plain versions in the
   kernels' place; a `.py` file through the Python frontend and the
   server; a `serve/extract` crash (the request fails with
   ExtractorError, the pool restarts, the next request answers);
16. the trainer observed and faulted, on (c)'s configuration and [14]'s
   data: `cli.main` with `--telemetry_dir --trace --watchdog_stall_s
   --profile --profile_steps 2` for 2 epochs with `--save` and `--test`
   (counted: kernel 1 once a step and once an evaluation batch; a step
   event a step, nonzero device-memory gauges, the eval events, the
   summary's percentiles, `train/step` spans linked to `infeed/produce`,
   no stall, a Chrome trace naming kernel 1); `ckpt/write` EIO retried
   and committed, with `train/nan_loss` at step 3 recorded; `ckpt/write`
   ENOSPC with the torn marker (the run gives up, `state.tmp/` stays, a
   load falls back); the telemetry's cost on the loop's steps/s for (c)
   and (a), on and off in one pair each (the arm run first alternates
   by label and by a coin per call); its `train/kill` leg (at step 6 in
   a subprocess, then `--auto_resume`, bit-identical to [14]'s
   uninterrupted run) runs beside [19];
17. the live metrics plane on (c)'s configuration and [14]'s data:
   `cli.main` with `--telemetry_dir --metrics_port --alerts_mode raise
   --watchdog_stall_s` scraped by a thread while it runs (`/metrics`
   parses with the port's promtext and holds `train_loss`, the
   `train_step_ms` summary, `health_*` and `alert_active`; `/healthz`
   200; `/vars` names the card; counted: kernel 1 once a step and an
   evaluation batch); an `infeed/produce` sleep past a 1 s deadline
   flips `/healthz` 200 -> 503 -> 200; `train/nan_loss` under
   `--alerts_mode raise` ends the run with an `AlertError` and one
   `alert` event; `--no_pallas` launches kernel 1 zero times with losses
   within LOSS_RTOL of the default run's; the plane's cost on the loop
   (on against off with the telemetry and trace on in both; the metrics
   port alone against nothing), ordered as [16]'s;
18. the sampled phase profiler on (c) and (a) through `cli.main` over
   [14]'s binary data: each run twice over the same steps, with
   `--phase_profile on --phase_sample_every 2 --telemetry_dir
   --metrics_port` and without; the final params and optimizer state the
   same bits; every phase of the kit timed at each sample, the device
   phases plus `residual_ms` equal to the fused ms (where no chain
   difference clamped); a mid-run `/metrics` scrape with
   `health_phase_*` (and, for (a), `health_opt_efficiency`); kernel 1's
   and kernel 5's launches with and without (counted: the probes add
   kernel 1, never kernel 5); the sampled steps' `train/step_ms` beside
   the unsampled median; the per-phase ms, bytes and GB/s; (a)'s
   `train/step_floor_ms` beside its step; a sampled step's peak
   allocation beside a fused one's; (c)'s isolated apply probe beside
   its remainder; the card's streaming ceiling (ops/membench.py);
19. the restart supervisor (`python3 -m
   code2vec_tpu_torch.tools.train_supervisor`) over (c) on [14]'s data,
   as a subprocess: `train/kill` at step 5 with a once-latch marker,
   one restart, the final state bit-identical to [14]'s uninterrupted
   run, `/fleet` scraped during it (one member, a measured clock offset
   committed into the relaunched child's manifest, cohort throughput
   above 0, no straggler); beside it, a child that always fails under
   `--max_restarts 1`: exit 3, one page (the corrupt-step leg is not
   run, for the clock: [14] holds the quarantine on the card, the CPU
   tests the supervisor's);
   [16]'s `train/kill` leg runs beside it, on a thread, and is checked
   at its end; the two run on a thread of their own beside [23] (whose
   parent only waits on its children: no profiler, no time check);
20. the serving fleet at [4]'s java-large width on the card, over HTTP:
   a `ReplicaPool` of 2 bag replicas (each built by a factory that seeds a
   fresh generator) behind a `ServingFrontend`, a `ReloadManager` polling
   every 0.1 s, and the port loadgen's open loop through serving_bench's
   `HttpPredictClient` in a client process (the JAX `serve_swap_kill`
   leg's parameters: Poisson arrivals at 120 qps, 16 workers, a quarter
   re-asking 8 hot keys; 2,400 one-method requests, about 20 s, so that a
   0.77 GB step is written, hashed and loaded under the load); the
   serving process's start-up heap is frozen out of the collector
   (`gc.freeze`) before the pool starts. `serve/kill` raises at the 40th
   `predict_lines`; 0.5 s in, a writer process (the trainer) commits
   step 1 (seed 1's weights) through `save_checkpoint`; once it is
   swapped in, step 2 with a flipped byte. The JAX leg's contract (no error,
   requests = ok + shed, p99 within the 250 ms SLO, one death and one
   refill, step 1 swapped under load at generation 1, step 2 refused
   with `reload_refused` firing, `compile_delta() == 0`, the pool back
   to 2 ready); kernel 1 launched under the load (counted); every hot
   key's answer equal to a single `PredictionServer`'s on step 0's
   weights before the swap, on step 1's after it, one of the two during
   it; the refilled replica's weights and answers its peers'; `/healthz`
   200 throughout, polled every 0.05 s; one autoscaler "up" (2 -> 3, the
   replica's build time) and one "down" after the hold on an injected
   clock; `/pool`, `/metrics` (the port's promtext) and one `obs_top`
   frame; memory allocated with 2 replicas, after the swap and with 3;
21. the VarMisuse head (`--head varmisuse`) at [4]'s token and path
   width (a stub target vocab, `vm_pointer` [384, 128], K = 8, bf16
   compute) over a synthetic `.vm.c2v` file (8 Zipf candidates, 20..200
   Zipf contexts a row): (f) the JAX package's defaults (dense step,
   Adafactor tables, Adam on the rest, cosine LR) and (g) Adam, constant
   LR, `--sparse_embeddings`. For each: counted steps (kernel 1 once a
   step; kernel 5 twice a step in (g), never in (f)); one step with the
   kernels against one with the plain versions from the same state and
   draws ((f): loss within 1e-3, the same update bit-identical; (g): the
   tables and moments as [5] holds them); one step twice from one cloned
   state (the same bits); the loss falling over 5 steps of a repeated
   batch; the step time, its split by phase, the busy share and peak
   memory. Then (f)'s model evaluated over 4096 rows (counted: kernel 1
   once a batch; methods/s) and held against the plain path batch by
   batch, and `predict_batch` on 25 rows (counted) giving the plain
   path's ids. Then the command line: `write_vm_dataset` (1200 / 150 /
   100 rows, seed 11) through the port's native extractor and `cli.main`
   with `--head varmisuse` at the JAX test's flags (8 epochs): accuracy
   at least 0.7, `--load --test` printing the same, `--load --head
   code2vec` and `--tables_dtype int8` exiting 2, `--auto_resume` from
   the step before the end bit-identical, and a `--phase_profile on`
   run ending in the same bits;
22. the adversarial attacks and the rename defense (attacks/): (h) at
   [4]'s java-large width and bag model over a token vocab of letter
   words at [4]'s ids (the synthetic `tok<i>` words have digits, which no
   rename may use): `attack_method` on 8 methods of [5]'s test file,
   untargeted and targeted (counted: kernel 1 2 + 2 x iterations times,
   as the trajectories imply; the split between the synchronised step
   functions and the host's shortlist, copy and loop); one step of the
   kernel path against the plain path (the first-order scores, the exact
   losses, the accepted rename where the best two losses are apart), the
   score the same bits twice; `attack_batch` at M = 64 against
   `attack_method` on the same methods (every difference a tie); kernel
   1 at B = M x K = 2048 bf16 against its plain version; the sweep
   (`evaluate_robustness` over 256 methods with a `RarityDetector` over a
   Zipf `.dict.c2v`): its report, methods/s, peak memory, host share;
   (i) `attack_method` on 4 methods of bench.py's transformer (counted:
   kernel 2 L times a forward, kernel 3 L times a score) against the
   plain versions; (j) (c) with `--adv_rename_prob` 0.3 in `batch` mode
   and (d) in `uniform` mode through the trainer: counted steps (kernel 1
   once a step, kernel 4 twice a step in (d)), the augmented batch the
   CPU augment's id for id, one kernel step against one plain step from
   the same state and draws, one step twice (the same bits), the step
   time beside [8]'s undefended one; (k) `cli.main` training on a corpus
   of Input.java's methods and synthetic ones, again with
   `--adv_rename_prob 0.3` (its manifest records it), then `--attack`
   untargeted, targeted, dead-code and 3 renames on a copy of Input.java
   (exit 0, the re-extracted outcome printed, the `.adversarial` file
   exactly on a verified success), `--attack` with int8 tables or without
   `--load` exiting 2, and the REPL answering `attack` (counted: kernel
   1); (l) `attacks.vm_robustness`'s `main` on [21]'s checkpoint and test
   split (its report line; counted: kernel 1); (m) the robustness study
   (`code2vec_tpu_torch.tools.robustness_study`'s `main`) on a tiny
   corpus: both arms, one epoch, 8 attacks, `--detect` (a JSON row an
   arm and the table);
23. data-parallel training across processes: two children of the
   command line (`cli.main`, as `python3 -m code2vec_tpu_torch` runs it)
   with `--dist_coordinator 127.0.0.1:<port> --dist_num_processes 2
   --dist_process_id i --mesh_data 2` on cuda:0 (gloo: the two ranks
   share the card), (c)'s configuration then (a)'s on [14]'s binary
   shards, one epoch of (c) and two of (a) (2 steps a rank an epoch),
   `--test` and `--save`: both exit 0, their final params bit-identical
   (sha256 a leaf), kernel 1 (and kernel 5 in (a)) launched in each (the
   children print their counts), the merged evaluation equal to one
   process's evaluation of the saved checkpoint, rank 0 alone writing it
   with `topology.json` saying 2.
   Then, in the same two children, one step of (c) and one of (a) at
   java-large width against one process over the ranks' batches
   concatenated with the same draws (the largest differences beside the
   bounds), the two-rank step twice from one state (the same bits),
   `mesh_sparse_apply` against the one-process compact apply (the same
   bits), and the step ms of one rank alone and of two, and the gradient
   all-reduce's (gloo through the host on one card: not a scaling
   number); two sampled (c) steps through the trainer's phase profiler
   under the mesh, whose `allreduce` and `allreduce_exposed` phases
   print beside the measured all-reduce; one (c) step with
   `--adv_rename_prob 0.5 --adv_rename_mode batch` over [22]'s
   letter-word vocab: the ranks' augmented rows, gathered, bit-identical
   to one process's augment of the concatenated batch (the donor roll
   crosses the ranks), the step against one process's within the
   harness's bounds. Last, one rank over NCCL through the same flags
   (`--dist_num_processes 1`): one (c) step and a collective,
   bit-identical to the plain step;
24. the supervised training cohort: `python3 -m
   code2vec_tpu_torch.tools.train_supervisor --procs 2` over [23]'s (a)
   command (members `chip_smoke.cohort_child`, two ranks sharing the
   card over gloo, each printing its kernel 1 and kernel 5 launches),
   `train/kill` on process 1 at its step 3 (past epoch 1's save):
   (i) kill_resume_2proc: the whole cohort relaunched on a fresh port,
   resumed from step 2, the final params bit-identical (sha256 a leaf)
   to [23]'s uninterrupted run; (ii) kill_resize under `--resize_policy
   shrink --min_procs 1`: resizes [[2, 1]], no full relaunch, one
   restart, the re-formed member without `--dist_*` flags logging the
   resharding line, its saves' `topology.json` saying 1, the final params
   (printed by the member, and in its last save) bit-identical to one
   process resumed from a copy of step 2;
   recovery_steps_lost and recovery_seconds; (iii) `/fleet` during (ii):
   both members up before the kill, one after the resize; (iv), started
   first and running beside (ii) and (i), the elastic shrink of a
   sharded cohort: `--procs 4
   --resize_policy shrink --min_procs 1` over (a) with `--mesh_model 2`
   (data 2, model 2), `train/kill` on process 3 at its step 3: resizes
   [[4, 2]] (a shrink drops one group of dcn * model * ctx = 2
   processes), no full relaunch, both re-formed members (data 1, model
   2) logging the resharding line, step 2's `topology.json` saying 4
   processes at 2 batch shards and the later saves 2 processes, the
   final params bit-identical to two ranks at model 2 resumed from a
   copy of step 2 under the tool (started once the re-formed cohort
   has stepped);
   recovery_steps_lost and recovery_seconds;
25. the context axis, in [23]'s two children after their harness (ctx =
   2, data = 1: each rank holds 100 of every row's 200 contexts; gloo
   through the host): ring attention at (B, H, C, hd) = (1024, 3, 200,
   128) bf16 against the one-rank `plain_mha` (output and dq, dk, dv)
   and kernel 2 (output), and the all-gathered q, k, v through kernels 2
   and 3, with each path's peak memory a rank and the ring's bytes a
   step; the transformer's dense step (e) with `--ring_attention` and
   without it (q, k, v all-gathered into kernels 2 and 3), and (c)'s
   bag step (the contexts all-gathered into kernel 1), each at
   java-large width against one rank's step over the same global batch
   (the loss and every leaf's raw gradient), one step timed, its peak
   memory; the counters at 0 before the counted steps (kernel 1 once a
   step in (c), kernels 2 and 3 L times a step without the ring, none
   with it); then `cli.main --encoder transformer --mesh_context 2
   --ring_attention --dist_*` on both ranks over [14]'s binary shards
   (an epoch, an evaluation of 4096 methods counted once, rank 0's
   save, `topology.json` with 2 processes and 1 batch shard), and in
   this process a one-process `--load` of that checkpoint evaluating
   the test file;
26. the model axis, in [23]'s two children after [25] (data = 1, model =
   2: each rank holds half the rows of every java-large table; gloo
   through the host): (c)'s dense step and (e)'s (L = 2, H = 3), each
   against one rank's step over the same global batch on the whole
   tables (the gathered contexts the same bits, the loss, every leaf's
   raw gradient, a table's over the rank's window), one step timed, the
   forward + backward's peak memory a rank beside one rank's, the bytes
   of the model pair's all-sums; (a)'s sparse-row step with kernel 5 on
   each window, the plain rows' bits from the same state; an evaluation
   of the 4096 test methods through the merged top-k against one rank's
   (the top-1 equal wherever the first two probabilities are more than
   1e-6 of the first apart, on tables stretched as [4]'s), the merge's
   bytes; the counters at 0 before the counted
   steps (kernel 1 once a step in (c) and (a), kernels 2 and 3 L times in
   (e), kernel 5 three times in (a)); then `cli.main --mesh_model 2
   --dist_*` on both ranks over [14]'s binary shards (an epoch, an
   evaluation counted once, rank 0's save of whole tables, `topology.json`
   with 2 processes), and in this process a one-process `--load` of that
   checkpoint evaluating the test file to the same top-1 and loss;
27. the VarMisuse head and the writer's exports under the model axis:
   in [23]'s two children after [26] (model = 2), (f) at [21]'s
   java-large token and path width, its dense step against one rank's
   over the same batch on the whole tables (the gathered contexts the
   same bits, the loss within LOSS_RTOL, every leaf's raw gradient within
   MODEL_GRAD_RTOL of its largest; counted: kernel 1 once), the forward
   + backward's peak a rank beside one rank's and the all-sums' bytes;
   the merged VarMisuse evaluation of [21]'s 4096 test rows (counted:
   kernel 1 once a batch) against one rank's over the whole tables (the
   same count, the file's rows, accuracy and loss); a model-2 trainer
   loaded from [26]'s checkpoint, each table gathered by
   `get_embedding_table` bit-identical to the checkpoint's rows (no
   text at this width). Beside [24], two processes run `cli.main
   --mesh_model 2 --dist_*` on [14]'s released model: `--test
   --export_code_vectors --save_w2v --save_t2v`, then `--release`; the
   three files byte-identical (sha256, each taken by the process that
   wrote it) to [14]'s one-process exports of the same model, the
   release's tensors bit-identical to it;
28. `--predict`, the REPL and `--attack` above one rank: in [23]'s two
   children after [27] (model = 2), the predict-side model over the
   windows (`Code2VecModel(mesh=...)`) on [4]'s request lines in
   batches of 1, 7 and 64 (counted: kernel 1 once a batch) and [11]'s
   transformer on a batch of 64 (counted: kernel 2 L times), each
   against one rank's whole-table predictor on the same params: the
   attention and code vectors the same bits, the probabilities within
   COHORT_PROB_RTOL, the top-k ids equal wherever two adjacent
   probabilities lie more than MODEL_TOP1_GAP of the first apart; one
   serial `attack_method` on a [22] method over the windows (counted:
   kernel 1 2 + 2 x iterations) against one rank's whole-table attack:
   the first-order scores within COHORT_SCORE_RTOL of their largest, the
   same shortlist wherever its boundary lies apart, the same renames and
   prediction. Beside [24]'s (i), two `cli.main --mesh_model 2 --dist_*`
   pairs: `--predict` on [14]'s released model (rank 0's stdin three
   Enters, `attack`, `q`; its output [15]'s one-process output, latency
   lines aside; rank 1 prints no answer) and `--attack untargeted` on
   [22](k)'s checkpoint (rank 0's outcome and `.adversarial` bytes
   (k)'s, unless one rank's closest decision lies within ATK_TIE_RTOL;
   rank 1 writes no file); all four exit 0;
29. the studies, in a process of their own started beside [23] and
   waited for here, each through its tool's `main` on the card:
   `gen_java_corpus --names 500 --methods 2000 --seed 7`, the port's
   `c2v_extract --dir` on each split, `extractor_coverage` over the
   corpus (coverage at least 0.999), `data.preprocess` at 200 contexts,
   `quality_study` over its six variants one epoch each (one row a
   variant with the JAX study's keys, `steps` the reader's batches,
   F1 and top-1 in [0, 1]), `sampled_decay_study` for one probe (ten
   finite deciles); its launches of kernels 1, 2, 3 and 4, counted from
   0 in that process, join the `kernels` line;
30. the profilers, in a process of their own started after [24] and
   told to go once no other process uses the card (their slopes
   difference two calls), each through its tool's `main` on the card at
   java-large width with `--steps 2`: `profile_step` (the
   streaming ceiling, forward, forward + backward, the Adam and
   Adafactor steps; kernel 1; its `--telemetry_dir` events),
   `xf_profile` (the matmul peak, the phases, the plain and kernel
   variants; kernels 2 and 3), `requant_sweep` (one cell, V =
   1,048,576; kernel 4) and `sparse_update_sweep` (V = 1,048,576,
   409,600 ids, bf16, float32 and int8; kernels 5 and 6): every key of
   the JAX tools' output, every time finite and above 0; kernel 4's q
   and s and kernels 5 and 6's rows and moments the plain versions'
   bits on the cells' inputs; its launches of kernels 1-6, counted from
   0 in that process just before the tools run and read before those
   comparisons, join the `kernels` line;
31. a `{"kernels": [...]}` line, the card line, and last
   `{"ok": true, "device": {...}}`.

[4], (c) in [8] and (e) in [12] also hold the float32-output logits of
bf16 operands (`ops/logits.rows_product_f32`: `torch.mm(...,
out_dtype=float32)` on the card) against their CPU branch on the same
tensors, and time them beside the product rounded to bf16 first.

Without a CUDA card it exits with code 2 and prints no result. It imports
nothing of JAX. `--out FILE` also writes every measurement as JSON.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

SEED = 0
DEV = "cuda"  # where the kernel-4 and transformer phases make tensors
C, E = 200, 128
D = 3 * E
JAVA_LARGE = {"token": 1301136, "path": 911417, "target": 261245}
BUCKET_SHAPES = (1, 7, 64)      # kernel check: the smallest, a ragged, the largest
N_REQUESTS, N_CLIENTS = 32, 8
TOP_K = 10
# kernel vs plain float32 version (TF32 off): float32 FMA over D = 384 in
# another order than cuBLAS, ~D * 2^-24 relative on |x| <= 1 values
CODE_TOL, ATTN_TOL = 1e-4, 1e-5
# kernel path vs plain path end to end: both cast the float32 code to bf16
# before the logits, so a value near a rounding edge may differ by one
# bf16 step (2^-8 at |x| < 1) in the code; a few such steps against target
# weights |w| <= 0.3 move a logit, and so a probability, by ~1e-3 each
E2E_CODE_TOL, E2E_PROB_RTOL = 2.0 ** -8, 1e-2

# training: batch, sampled classes, steps of the counted run, steps of the
# repeated-batch run, steps timed
TRAIN_B, TRAIN_S = 1024, 4096
TRAIN_STEPS, FALL_STEPS, TIMED_STEPS = 3, 5, 5
ZIPF_S = 1.1
# kernel path vs plain path over one training step: the loss pools with
# the float32 kernel on one side and the bf16 plain pool on the other;
# both apply the same row gradients, so tables and moments agree to the
# bit (bounds: 1 ulp tables, 1e-5 of the largest moment)
LOSS_RTOL, MOMENT_RTOL = 1e-3, 1e-5
# int8: a q one apart (a value on a rounding edge) on at most this share
# of the updated elements; s within 2 ulp
Q_SHARE, S_ULP = 1e-5, 2
# kernel 4 (dense requantize): the test cases, (V, E, update dtype)
REQUANT_CASES = ((1, E, "bfloat16"), (1000, E, "bfloat16"),
                 (257, 100, "bfloat16"), (1000, E, "float32"),
                 (JAVA_LARGE["token"] + 2, E, "bfloat16"),
                 (JAVA_LARGE["path"] + 2, E, "bfloat16"))
# float32 operations per element of one requantize: pass 1 multiply, add,
# abs, max; pass 2 multiply, add, divide, add, round, 2 clamps; the hash
# 2 multiplies, 3 xors, 3 shifts, a convert, a multiply, a subtract
REQUANT_OPS = 21
# evaluation: methods in the test file; the kernel path's top-1 must equal
# the plain path's on this share of them
EVAL_METHODS, EVAL_TOP1_SHARE = 4096, 0.99

# the transformer path-encoder (bench.py's configuration): layers, heads
XF_L, XF_H = 2, 3
# kernels 2 and 3 against their plain versions: (B, H, C, hd), dtype; the
# java-large head shape at a serving bucket of 1, 7 and 64 and the
# training batch, H = 4's hd = 96 and a ragged C in bf16, then hd = 96 and
# the test shape in float32
XF_CASES = (((1, XF_H, C, D // XF_H), "bfloat16"),
            ((7, XF_H, C, D // XF_H), "bfloat16"),
            ((64, XF_H, C, D // XF_H), "bfloat16"),
            ((TRAIN_B, XF_H, C, D // XF_H), "bfloat16"),
            ((4, 4, C, 96), "bfloat16"), ((16, XF_H, 37, D // XF_H), "bfloat16"),
            ((4, 4, C, 96), "float32"), ((16, 2, 24, 16), "float32"))
# kernel 2's kernel and kernel 3's two (3a, 3b) by input dtype, as the
# profiler names them (each name is in no other's)
XF_FWD_KERNEL = {"bfloat16": "mha_fwd_tc_kernel", "float32": "mha_fwd_kernel"}
XF_BWD_KERNELS = {"bfloat16": ("mha_bwd_dq_tc_kernel", "mha_bwd_dkv_tc_kernel"),
                  "float32": ("mha_bwd_dq_kernel", "mha_bwd_dkv_kernel")}
# max |kernel - plain| over the largest |plain| value of each output.
# float32: the kernels sum the 200- and 128-term products in another
# order than cuBLAS and take expf where PyTorch takes its own exp, a few
# float32 ulp of the terms (2^-24 = 6e-8) per sum, a few sums deep.
# bf16: each output is rounded to bf16 once on both sides, and a float32
# difference can put it on the other side of a rounding edge: one bf16
# step, at most 2^-7 of the value and so of the largest.
XF_TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
# kernel path vs plain path through the transformer (bf16 activations):
# a one-step difference in a bf16 attention output travels through the
# out projection, the MLP and the next layer; the code vector is held
# within 4 bf16 steps of its largest value; each pool weight, the exp of
# a float32 logit over those activations, within 4 bf16 steps (2^-5) of
# its method's largest weight; a code difference of a few bf16 steps
# over D = 384 moves a logit against the stretched target table by up
# to ~0.1, so a top-k probability within 10 % of itself
XF_E2E_CODE_RTOL, XF_E2E_ATTN_RTOL, XF_E2E_PROB_RTOL = 2.0 ** -5, 2.0 ** -5, 0.1
# the xf gradients of one training step, kernels vs plain versions, over
# each leaf's largest value: dq, dk and dv are rounded to bf16 on both
# sides, and a one-step difference (2^-8 to 2^-7 of a value) travels
# through the layer's weight products; readings on an H100 80GB HBM3 at
# 700 W were 5.2e-3 and 5.6e-3, and the bound is under twice that
XF_GRAD_RTOL = 1e-2
# Step B's trained state of (e): epochs of the 4-batch training file
# trained past the measurements (32 steps; earlier readings of the gap
# at such states were 0.0208-0.0294)
XF_TRAINED_EPOCHS = 8

# profiled runs of one measurement before its device times are reported
# as not measured; host seconds of idle at each end of a profiled window,
# so that device activity the trace places a little off the host's
# window (a few microseconds of kernels in a short one) is kept
PROFILE_TRIES, PROFILE_PAD_S = 3, 0.05

# published dense peaks: float32 outside the tensor cores, bf16 tensor
# cores, HBM bytes/s (NVIDIA data sheets)
PEAKS = {"H100 SXM": (67e12, 989e12, 3.35e12),
         "H100 PCIe": (51e12, 756e12, 2.0e12),
         "H100 NVL": (60e12, 835e12, 3.9e12)}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return f"H100 {key}", PEAKS[f"H100 {key}"]
    return "H100 SXM", PEAKS["H100 SXM"]


def time_ms(torch, fn, reps: int = 30, warm: int = 3) -> float:
    """Median device time of `fn()` over `reps` runs (CUDA events)."""
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    ts.sort()
    return ts[len(ts) // 2]


def profile_calls(torch, fn, n: int):
    """`fn()` n times under torch.profiler (CPU and CUDA activity) ->
    wall ms per call (host clock, profiler on), device-busy ms per call
    (the union of the CUDA kernels' intervals), and device ms per call
    of each kernel by name, largest first. A profiled run that records no
    CUDA activity at all (the CUPTI trace now and then comes back empty)
    is profiled again, up to PROFILE_TRIES times; then None: the device
    times are not measured, which fails no check."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(PROFILE_PAD_S)
        cuda = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if cuda:
            break
    else:
        print(f"  the profiler saw no CUDA activity in {PROFILE_TRIES} runs: "
              f"device times not measured", flush=True)
        return None
    busy, end = 0.0, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in cuda):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    by_name, count = {}, {}
    for e in cuda:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        count[e.name] = count.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall_ms / n, "busy_ms": busy / 1e3 / n,
            "kernel_ms": {k: us / 1e3 / n for k, us in top},
            "kernel_launches": count}


def kernel_device_ms(torch, fn, name_parts, n: int = 10):
    """Device time of one call of `fn`, from the profiler (no host time
    in it): the kernel whose name holds `name_parts` (a string), or the
    sum over several such kernels (a tuple of strings, one launch each);
    None where the profiler saw no CUDA activity."""
    prof = profile_calls(torch, fn, n)
    if prof is None:
        return None
    total = 0.0
    for part in ((name_parts,) if isinstance(name_parts, str) else name_parts):
        hits = [ms for k, ms in prof["kernel_ms"].items() if part in k]
        check(len(hits) == 1, f"profiler kernels matching {part}: {hits}; "
              f"the trace's {len(prof['kernel_ms'])} kernels by device ms: "
              + ", ".join(f"{k[:60]} {ms:.4f} x{prof['kernel_launches'][k]}"
                          for k, ms in list(prof["kernel_ms"].items())[:8])
              + f"; busy {prof['busy_ms']:.4f} ms, wall "
              f"{prof['wall_ms']:.4f} ms a call")
        total += hits[0]
    return total


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def profile_step(torch, label: str, fn, step_ms: float, top: int = 6,
                 name_part: str = ""):
    """Profile TIMED_STEPS runs of the step `fn` and print where the
    device time goes -> (profile or None, device busy share of the
    unprofiled step or None, device ms per step of the kernels whose name
    holds `name_part` or None)."""
    prof = profile_calls(torch, fn, TIMED_STEPS)
    if prof is None:
        print(f"  ({label}) device busy share and kernel times not measured",
              flush=True)
        return None, None, None
    busy_share = prof["busy_ms"] / step_ms
    part_ms = sum(ms for k, ms in prof["kernel_ms"].items() if name_part in k)
    part = (f"kernels matching {name_part!r} {part_ms:.3f} ms per step; "
            if name_part else "")
    print(f"  ({label}) profiler, {TIMED_STEPS} steps: device busy "
          f"{prof['busy_ms']:.3f} ms per step = {busy_share:.3f} of the "
          f"unprofiled step ({prof['busy_ms'] / prof['wall_ms']:.3f} of the "
          f"profiled {prof['wall_ms']:.2f} ms); {part}largest kernels (ms per "
          f"step): " + ", ".join(f"{short_name(k)} {ms:.3f}"
                                 for k, ms in list(prof["kernel_ms"].items())[:top]),
          flush=True)
    return prof, busy_share, (part_ms if name_part else None)


def short_name(kernel: str, width: int = 48) -> str:
    name = kernel.replace("void ", "").replace("at::native::", "")
    return name if len(name) <= width else name[:width - 3] + "..."


def pool_inputs(torch, B: int, dtype, gen):
    """Contexts ~ N(0, 1), a variance-scaled TRANSFORM / ATTENTION, and a
    mask cycling through: random, all padding, one valid, full."""
    dev = "cuda"
    ctx = torch.randn((B, C, D), generator=gen, device=dev).to(dtype)
    lim = (3.0 / D) ** 0.5
    tr = (torch.rand((D, D), generator=gen, device=dev) * 2 - 1) * lim
    at = (torch.rand((D,), generator=gen, device=dev) * 2 - 1) * (6 / (D + 1)) ** 0.5
    mask = (torch.rand((B, C), generator=gen, device=dev) > 0.3).float()
    for r in range(B):
        kind = r % 4
        if kind == 1:
            mask[r] = 0
        elif kind == 2:
            mask[r] = 0
            mask[r, (r * 37) % C] = 1
        elif kind == 3:
            mask[r] = 1
    return ctx, tr.contiguous(), at.contiguous(), mask


# kernel 1's launches by context dtype, as the profiler names them (each
# name is in no other's): bf16 on the tensor cores (split T, the tiles,
# combine), float32 on the CUDA cores
POOL_KERNELS = {"bfloat16": ("pool_split_kernel", "attention_pool_tc_kernel",
                             "pool_combine_kernel"),
                "float32": ("attention_pool_kernel",)}


def pool_bound(B: int, ctx_bytes: int, peaks, terms: int):
    """Least time for one pool call: each input read once, each output
    written once, over the HBM rate; the [B C, D] x [D, D] product at the
    peak of its operand types: on bf16 contexts, `terms` products (one per
    bf16 term of the float32 T) at the bf16 tensor-core peak, on float32
    contexts one at the float32 peak; the epilogue's 4 B C D operations
    (tanh, the dot with a, the weighted sum) at the float32 peak.
    `bound_ms_float32` prices the product at the float32 peak whatever
    the dtype (the CUDA-core design's arithmetic)."""
    f32_peak, bf16_peak, hbm = peaks
    nbytes = B * C * D * ctx_bytes + D * D * 4 + D * 4 + B * C * 4 \
        + B * D * 4 + B * C * 4
    product = 2 * B * C * D * D
    epilogue = 4 * B * C * D
    ms_bytes = nbytes / hbm * 1e3
    ms_f32 = (product + epilogue) / f32_peak * 1e3
    ms_tc = (terms * product / bf16_peak + epilogue / f32_peak) * 1e3
    ms_ops = ms_tc if ctx_bytes == 2 else ms_f32
    return {"bytes": nbytes, "flops": (terms if ctx_bytes == 2 else 1)
            * product + epilogue, "bytes_ms": ms_bytes,
            "f32_ops_ms": ms_f32, "tensor_core_ops_ms": ms_tc,
            "bound_ms": max(ms_bytes, ms_ops),
            "bound_by": "operations" if ms_ops >= ms_bytes else "bytes",
            "bound_ms_float32": max(ms_bytes, ms_f32)}


def phase_kernels(torch, peaks, report):
    from code2vec_tpu_torch.ops.attention_kernel import tc_terms
    terms = tc_terms()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    both = (torch.bfloat16, torch.float32)
    cases = [(B, dt) for B in BUCKET_SHAPES for dt in both]
    cases.append((TRAIN_B, torch.bfloat16))  # the training step's pool
    rows = [pool_case(torch, B, dtype, gen, peaks, terms)
            for B, dtype in cases]
    report["attention_pool"] = rows
    return rows


def pool_case(torch, B: int, dtype, gen, peaks, terms: int) -> dict:
    """Kernel 1 against its plain version at one (B, dtype): the errors,
    the same bits on a second launch, the times and the bound."""
    from code2vec_tpu_torch.ops.attention_kernel import (attention_pool_fused,
                                                         attention_pool_plain)
    dname = str(dtype).replace("torch.", "")
    ctx, tr, at, mask = pool_inputs(torch, B, dtype, gen)
    code_k, attn_k = attention_pool_fused(ctx, tr, at, mask)
    code_p, attn_p = attention_pool_plain(ctx, tr, at, mask)
    code_2, attn_2 = attention_pool_fused(ctx, tr, at, mask)
    torch.cuda.synchronize()
    err_c = (code_k - code_p).abs().max().item()
    err_a = (attn_k - attn_p).abs().max().item()
    empty = mask.sum(-1) == 0
    check(torch.isfinite(code_k).all() and torch.isfinite(attn_k).all(),
          f"non-finite kernel output B={B} {dtype}")
    check(err_c <= CODE_TOL, f"code max|d| {err_c} > {CODE_TOL} "
          f"(B={B}, {dtype})")
    check(err_a <= ATTN_TOL, f"attn max|d| {err_a} > {ATTN_TOL} "
          f"(B={B}, {dtype})")
    check(bool((code_k[empty] == 0).all() and (attn_k[empty] == 0).all()),
          f"all-padding rows not exactly 0 (B={B}, {dtype})")
    check(torch.equal(code_2, code_k) and torch.equal(attn_2, attn_k),
          f"kernel 1 gave other bits on a second launch (B={B}, {dtype})")
    flat = ctx.float().reshape(B * C, D)
    flat_bf16 = ctx.to(torch.bfloat16).reshape(B * C, D)
    tr_bf16 = tr.to(torch.bfloat16)
    k_ms = time_ms(torch, lambda: attention_pool_fused(ctx, tr, at, mask))
    p_ms = time_ms(torch, lambda: attention_pool_plain(ctx, tr, at, mask))
    lib_ms = time_ms(torch, lambda: torch.matmul(flat, tr))
    lib_bf16_ms = time_ms(torch, lambda: torch.matmul(flat_bf16, tr_bf16))
    dev_ms = kernel_device_ms(
        torch, lambda: attention_pool_fused(ctx, tr, at, mask),
        POOL_KERNELS[dname])
    bound = pool_bound(B, ctx.element_size(), peaks, terms)
    row = {"B": B, "ctx_dtype": dname, "kernel": "+".join(POOL_KERNELS[dname]),
           "tc_terms": terms if dtype == torch.bfloat16 else None,
           "max_abs_err_code": err_c, "max_abs_err_attn": err_a,
           "ms": k_ms, "kernel_device_ms": dev_ms, "plain_ms": p_ms,
           "library_ms": lib_ms, "library_bf16_ms": lib_bf16_ms, **bound}
    print(f"  attention_pool B={B:4d} {dname:8s} "
          f"err code {err_c:.3g} attn {err_a:.3g} (bits equal twice) | "
          f"kernel {k_ms:.4f} ms (device {fmt_ms(dev_ms)})"
          f" plain {p_ms:.4f} ms matmul f32 {lib_ms:.4f} bf16 "
          f"{lib_bf16_ms:.4f} ms | bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}; float32 product "
          f"{bound['bound_ms_float32']:.4f} ms)", flush=True)
    del ctx, tr, at, mask, flat, flat_bf16
    torch.cuda.empty_cache()
    return row


@functools.lru_cache(maxsize=1)
@functools.lru_cache(maxsize=1)
def synthetic_vocabs():
    """A java-large-sized vocab with words generated by rule (built once
    a process; its users only read it)."""
    from code2vec_tpu_torch.vocab.vocabularies import (Code2VecVocabs, Vocab,
                                                       VocabType)
    return Code2VecVocabs(
        Vocab(VocabType.Token, (f"tok{i}" for i in range(JAVA_LARGE["token"]))),
        Vocab(VocabType.Path, (str(1000003 * i) for i in range(JAVA_LARGE["path"]))),
        Vocab(VocabType.Target,
              (f"m{i % 4099}|n{i}" for i in range(JAVA_LARGE["target"]))))


def make_requests(np, rng):
    """N_REQUESTS requests of 1..8 methods, 20..400 contexts each (over the
    200 cap for some), with ~2% out-of-vocab words."""
    def word(kind, n):
        return f"unk{rng.integers(1 << 30)}" if rng.random() < 0.02 else \
            (f"tok{rng.integers(n)}" if kind == "tok"
             else str(1000003 * int(rng.integers(n))))
    reqs = []
    for _ in range(N_REQUESTS):
        lines = []
        for _ in range(int(rng.integers(1, 9))):
            n_ctx = int(rng.integers(20, 401))
            ctxs = [f"{word('tok', JAVA_LARGE['token'])},"
                    f"{word('path', JAVA_LARGE['path'])},"
                    f"{word('tok', JAVA_LARGE['token'])}" for _ in range(n_ctx)]
            target = f"m{rng.integers(4099)}|n{rng.integers(JAVA_LARGE['target'])}"
            lines.append(target + " " + " ".join(ctxs))
        reqs.append(lines)
    return reqs


def time_topk(torch, probs, label: str, report) -> None:
    """The tie-stable top-k (`topk_stable`, the eval and predict steps'
    top-k) over one batch's probabilities [B, V] on the card: its ids must
    equal a stable sort's cut to TOP_K (the reference's order, the lowest
    id first among equal values); its time beside `torch.topk`'s and the
    stable sort's, and the rows where `torch.topk`'s ids differ."""
    from code2vec_tpu_torch.training.steps import topk_stable
    ids = topk_stable(probs, TOP_K)[1]
    sort_ids = torch.sort(probs, dim=-1, descending=True,
                          stable=True).indices[:, :TOP_K]
    check(torch.equal(ids, sort_ids), f"topk_stable vs a stable sort, {label}")
    differ = int((torch.topk(probs, TOP_K, dim=-1).indices != ids)
                 .any(dim=-1).sum().item())
    ms = time_ms(torch, lambda: topk_stable(probs, TOP_K), reps=10)
    topk_ms = time_ms(torch, lambda: torch.topk(probs, TOP_K, dim=-1), reps=10)
    sort_ms = time_ms(torch, lambda: torch.sort(
        probs, dim=-1, descending=True, stable=True), reps=10)
    B, V = probs.shape
    print(f"  top-k over [{B}, {V}]: topk_stable {ms:.4f} ms (ids equal a "
          f"stable sort's), torch.topk {topk_ms:.4f} ms (its ids differ on "
          f"{differ} of {B} rows), stable sort {sort_ms:.4f} ms", flush=True)
    report[f"topk_{label}"] = {
        "shape": [B, V], "topk_stable_ms": ms, "torch_topk_ms": topk_ms,
        "stable_sort_ms": sort_ms, "torch_topk_rows_differ": differ}


def phase_serving(torch, np, vocabs, report):
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.encoder import (ModelDims, full_logits,
                                                   gather_contexts, init_params)
    from code2vec_tpu_torch.models.torch_model import Code2VecModel
    from code2vec_tpu_torch.ops.attention_kernel import (attention_pool_fused,
                                                         attention_pool_plain)
    from code2vec_tpu_torch.serving.server import PredictionServer
    from code2vec_tpu_torch.training.steps import predict_head, predict_step

    t0 = time.perf_counter()
    dims = ModelDims(token_vocab_size=vocabs.token_vocab.size,
                     path_vocab_size=vocabs.path_vocab.size,
                     target_vocab_size=vocabs.target_vocab.size,
                     embeddings_size=E, max_contexts=C, tables_dtype="bfloat16")
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED), dims)
    # init_params' variance scaling over a million rows leaves every
    # embedding near 0, which makes attention and names flat and the
    # end-to-end comparison below vacuous. Stretch the same draws to the
    # spread of a trained table: leaf embeddings uniform in [-1, 1], the
    # target table in [-0.3, 0.3].
    for key, reach in (("token_emb", 1.0), ("path_emb", 1.0),
                       ("target_emb", 0.3)):
        t = params[key]
        t.mul_(reach / t.float().abs().max().item())
    config = Config(MAX_CONTEXTS=C, SERVE_BATCH_MAX=64, USE_BF16=True,
                    TABLES_DTYPE="bfloat16", SERVE_DEADLINE_MS=30000.0)
    model = Code2VecModel(config, dims, vocabs, params)  # device=None: the card
    logits_branches(torch, "serving", random_code(torch, 64, SEED + 4),
                    params["target_emb"], report)
    check(model.device.type == "cuda", f"model on {model.device}")
    table_gb = sum(t.numel() * t.element_size() for k, t in params.items()
                   if k.endswith("_emb")) / 1e9
    print(f"  model: vocab {dims.token_vocab_size}/{dims.path_vocab_size}/"
          f"{dims.target_vocab_size}, tables {table_gb:.3f} GB bf16, set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(SEED)
    requests = make_requests(np, rng)

    server = PredictionServer(config, model)
    try:
        server.start(warmup=True)
        print(f"  warmup buckets {server.warmup_buckets} in "
              f"{server.warmup_ms:.1f} ms", flush=True)
        results = [None] * len(requests)
        latency_ms = [None] * len(requests)
        errors = []

        def client(k):
            try:
                for i in range(k, len(requests), N_CLIENTS):
                    t = time.perf_counter()
                    results[i] = server.predict_lines(requests[i])
                    latency_ms[i] = (time.perf_counter() - t) * 1e3
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        # ---- the main path: counts at 0 just before, read just after ----
        attention_pool_fused.launches = 0
        batches0 = server.batches
        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(N_CLIENTS)]
        t_run = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall_s = time.perf_counter() - t_run
        launches = {"attention_pool": attention_pool_fused.launches}
        device_batches = server.batches - batches0
        check(not any(t.is_alive() for t in threads), "a client thread hung")
        if errors:
            raise errors[0]

        n_methods = 0
        for lines, res in zip(requests, results):
            check(res is not None and len(res) == len(lines),
                  "a request got the wrong number of results")
            for line, r in zip(lines, res):
                n_methods += 1
                # decode drops a PAD id from the top-k, so 9 is possible
                check(len(r.predictions) in (TOP_K - 1, TOP_K),
                      f"{len(r.predictions)} predictions")
                check(all(np.isfinite(p["probability"]) and
                          0 <= p["probability"] <= 1 for p in r.predictions),
                      "bad probability")
                n_ctx = min(len(line.split(" ")) - 1, C)
                check(len(r.attention_paths) == n_ctx,
                      f"{len(r.attention_paths)} attention paths, "
                      f"expected {n_ctx}")
                total = sum(a.attention_score for a in r.attention_paths)
                check(abs(total - 1.0) < 1e-3, f"attention sums to {total}")
        check(device_batches >= 1, "no device batch ran")
        for name, n in launches.items():
            check(n >= 1, f"kernel {name} never launched on the main path")
        check(launches["attention_pool"] == device_batches,
              f"attention_pool launched {launches['attention_pool']} times "
              f"for {device_batches} device batches")
        lat = np.array(latency_ms)
        print(f"  served {len(requests)} requests / {n_methods} methods from "
              f"{N_CLIENTS} threads in {wall_s:.3f} s: {device_batches} device "
              f"batches, attention_pool launches {launches['attention_pool']}; "
              f"request p50 {np.percentile(lat, 50):.2f} ms p99 "
              f"{np.percentile(lat, 99):.2f} ms", flush=True)

        # ---- predict_device time per bucket (outside the counted run) ----
        flat_lines = [ln for req in requests for ln in req]
        bucket_ms = {}
        for b in server.warmup_buckets:
            prepared = model.prepare_predict_rows(flat_lines[:b])
            ts = []
            for _ in range(7):
                t = time.perf_counter()
                model.predict_device(prepared)  # ends in a device -> host copy
                ts.append((time.perf_counter() - t) * 1e3)
            bucket_ms[b] = sorted(ts)[len(ts) // 2]
        print("  predict_device ms by bucket: " + ", ".join(
            f"{b}: {ms:.3f}" for b, ms in bucket_ms.items()), flush=True)

        # ---- host phases of one 64-method batch ----
        t = time.perf_counter()
        prepared = model.prepare_predict_rows(flat_lines[:64])
        parse_ms = (time.perf_counter() - t) * 1e3
        out = model.predict_device(prepared)
        t = time.perf_counter()
        model.decode_predictions(prepared, out)
        decode_ms = (time.perf_counter() - t) * 1e3
        print(f"  host, 64 methods: parse {parse_ms:.2f} ms, decode "
              f"{decode_ms:.2f} ms (device phase {bucket_ms[64]:.3f} ms)",
              flush=True)

        # ---- one batch: kernel path vs plain path on the card ----
        batch = model.device_batch(
            prepared.labels, prepared.src, prepared.pth, prepared.dst,
            prepared.mask, np.ones(prepared.n, np.float32))
        with torch.inference_mode():
            ids_k, probs_k, attn_k, code_k = predict_step(
                model.params, batch, dims=dims, top_k=TOP_K,
                compute_dtype=torch.bfloat16)
            ctx = gather_contexts(model.params, batch[1], batch[2], batch[3],
                                  torch.bfloat16)
            code_p32, attn_p = attention_pool_plain(
                ctx, model.params["transform"], model.params["attention"],
                batch[4])
            code_p = code_p32.to(torch.bfloat16)
            ids_p, probs_p = predict_head(model.params, code_p, dims, TOP_K)
        code_err = (code_k - code_p.float()).abs().max().item()
        attn_err = (attn_k - attn_p).abs().max().item()
        probs_k, probs_p = probs_k.cpu().numpy(), probs_p.cpu().numpy()
        ids_k, ids_p = ids_k.cpu().numpy(), ids_p.cpu().numpy()
        prob_rel = float(np.max(np.abs(probs_k - probs_p) / probs_p))
        check(code_err <= E2E_CODE_TOL, f"end-to-end code max|d| {code_err}")
        check(attn_err <= ATTN_TOL, f"end-to-end attn max|d| {attn_err}")
        check(prob_rel <= E2E_PROB_RTOL, f"top-k prob rel diff {prob_rel}")
        checked = 0
        for i in range(ids_p.shape[0]):
            for j in range(TOP_K - 1):
                gap_lo = probs_p[i, j] - probs_p[i, j + 1]
                gap_hi = probs_p[i, j - 1] - probs_p[i, j] if j else np.inf
                if min(gap_lo, gap_hi) > 2 * E2E_PROB_RTOL * probs_p[i, j]:
                    check(ids_k[i, j] == ids_p[i, j], f"top-k id {i},{j}")
                    checked += 1
        # an empty comparison would check nothing: at least half the rows'
        # top-1 ids must be far enough apart to be held equal
        check(checked >= prepared.n // 2,
              f"only {checked} separated top-k ids to compare over "
              f"{prepared.n} methods")
        print(f"  kernel path vs plain path, {prepared.n} methods: code "
              f"max|d| {code_err:.3g}, attn max|d| {attn_err:.3g}, top-k prob "
              f"max rel d {prob_rel:.3g}, {checked} separated top-k ids equal",
              flush=True)
        with torch.inference_mode():
            probs = torch.softmax(full_logits(model.params, code_p,
                                              dims.target_vocab_size), dim=-1)
            time_topk(torch, probs, "serving", report)
        del probs
    finally:
        server.close()
    report["serving"] = {
        "requests": len(requests), "methods": n_methods, "clients": N_CLIENTS,
        "device_batches": device_batches, "launches": launches,
        "wall_s": wall_s, "request_ms_p50": float(np.percentile(lat, 50)),
        "request_ms_p99": float(np.percentile(lat, 99)),
        "predict_device_ms": bucket_ms, "warmup_ms": server.warmup_ms,
        "parse_ms_64": parse_ms, "decode_ms_64": decode_ms,
        "e2e_code_err": code_err, "e2e_attn_err": attn_err,
        "e2e_prob_rel": prob_rel, "e2e_ids_checked": checked}
    return launches


def ptxas_report(log: str):
    """(entry function, registers, spill stores, spill loads) per entry
    point of an `nvcc -Xptxas -v` log."""
    out, name, spills = [], None, ("?", "?")
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln:
            parts = ln.replace(",", "").split()
            spills = (parts[parts.index("spill") - 2],
                      parts[parts.index("loads") - 3])
        elif "Used" in ln and "registers" in ln and name:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out.append((name, int(regs), spills[0], spills[1]))
            name = None
    return out


def phase_build(report):
    """One `nvcc` per source, all started together; beside them the
    native extractor's two targets ([15]'s) with the host's c++."""
    from code2vec_tpu_torch.extractor import native
    from code2vec_tpu_torch.ops import _build
    from code2vec_tpu_torch.ops.attention_kernel import KERNEL as POOL
    from code2vec_tpu_torch.ops.requant_kernel import KERNEL as REQUANT
    from code2vec_tpu_torch.ops.sparse_update_kernel import KERNEL as ROWS
    from code2vec_tpu_torch.ops.xf_attention_kernel import KERNEL as XF
    names = (POOL, ROWS, REQUANT, XF)

    def timed(build):
        t = time.perf_counter()
        build()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names) + 2) as ex:
        futures = {name: ex.submit(_build.build, name) for name in names}
        host = {"c2v_extract": ex.submit(timed, native.binary_path),
                "libc2v.so": ex.submit(timed, native.library_path)}
        nvcc_s = {name: f.result() for name, f in futures.items()}
        report["extractor_build_s"] = {k: f.result() for k, f in host.items()}
    report["build_s"] = time.perf_counter() - t0
    report["nvcc_s"] = nvcc_s
    report["ptxas"] = {}
    for name in names:
        entries = ptxas_report(_build.build_log(name))
        report["ptxas"][name] = entries
        print(f"[2] built {name}: nvcc {nvcc_s[name]:.2f} s", flush=True)
        for fn, regs, st, ld in entries:
            print(f"      {fn}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B", flush=True)
    print("[2] built the native extractor beside them: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in report["extractor_build_s"].items()),
        flush=True)
    print(f"    build phase {report['build_s']:.2f} s", flush=True)


def zipf_cdf(np, n: int):
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** ZIPF_S
    c = np.cumsum(w)
    return c / c[-1]


def write_training_file(np, path: str, n_methods: int, rng) -> None:
    """A `.c2v` file of `n_methods` methods with 20..C contexts each;
    tokens, paths and names are drawn Zipf (s = ZIPF_S) over the
    synthetic vocab's words, so the unique rows of a batch look like real
    data's (a few very frequent rows, a long tail)."""
    tok, pth, tgt = (zipf_cdf(np, JAVA_LARGE[k]) for k in
                     ("token", "path", "target"))
    n_ctx = rng.integers(min(20, C), C + 1, n_methods)
    total = int(n_ctx.sum())
    src = np.searchsorted(tok, rng.random(total))
    dst = np.searchsorted(tok, rng.random(total))
    paths = np.searchsorted(pth, rng.random(total)) * 1000003
    names = np.searchsorted(tgt, rng.random(n_methods))
    ctx = [f"tok{a},{p},tok{b}" for a, p, b in
           zip(src.tolist(), paths.tolist(), dst.tolist())]
    with open(path, "w") as f:
        start = 0
        for i, n in enumerate(n_ctx.tolist()):
            t = int(names[i])
            f.write(f"m{t % 4099}|n{t} " + " ".join(ctx[start:start + n])
                    + "\n")
            start += n


def clone_state(torch, x):
    """Deep copy of a params / opt-state tree of tensors."""
    from code2vec_tpu_torch.ops.sparse_update import RowAdamState
    if isinstance(x, dict):
        return {k: clone_state(torch, v) for k, v in x.items()}
    if isinstance(x, RowAdamState):
        return RowAdamState(m=x.m.clone(), v=x.v.clone())
    return x.clone()


def ulp_diff(torch, a, b) -> int:
    """Largest distance in units in the last place of a's dtype (float32
    or bf16) between two tensors of that dtype."""
    if a.dtype == torch.bfloat16:
        ia, ib = a.view(torch.int16).long(), b.view(torch.int16).long()
        sign = 0x7FFF
    else:
        ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
        sign = 0x7FFFFFFF

    def ordered(x):
        return torch.where(x < 0, -(x & sign), x)
    if a.numel() == 0:
        return 0
    return int((ordered(ia) - ordered(ib)).abs().max().item())


def compare_tables(torch, name, a, b, n_updated: int):
    """Kernel-path table against plain-path table: float within 1 ulp,
    int8 q within 1 on at most Q_SHARE of the updated elements and s
    within S_ULP ulp. Returns (max abs err, description)."""
    if isinstance(a, dict):
        dq = (a["q"].int() - b["q"].int()).abs()
        n_q = int((dq > 0).sum().item())
        q_max = int(dq.max().item())
        s_ulp = ulp_diff(torch, a["s"], b["s"])
        check(q_max <= 1 and n_q <= Q_SHARE * max(n_updated, 1),
              f"{name}: q differs by up to {q_max} on {n_q} of {n_updated} "
              f"updated elements")
        check(s_ulp <= S_ULP, f"{name}: s differs by {s_ulp} ulp")
        err = max(float(q_max), (a["s"] - b["s"]).abs().max().item())
        return err, f"q |d| <= {q_max} on {n_q}/{n_updated}, s {s_ulp} ulp"
    ulps = ulp_diff(torch, a, b)
    check(ulps <= 1, f"{name}: {ulps} ulp apart")
    return ((a.float() - b.float()).abs().max().item(),
            "bit-identical" if ulps == 0 else f"{ulps} ulp")


def compare_moments(torch, name, a, b) -> float:
    err = (a - b).abs().max().item()
    top = b.abs().max().item()
    check(err <= MOMENT_RTOL * max(top, 1e-30),
          f"{name}: moments max|d| {err} over max {top}")
    return err


def same_bits_twice(torch, trainer, batch, label, report) -> None:
    """One step of `trainer` run twice from one cloned state with one set
    of draws: every param and optimizer tensor and the loss must be the
    same bits (the gathers' backward and the segment sum add in a fixed
    order, ops/scatter.py). The state is left as the second step made
    it."""
    from code2vec_tpu_torch.training.checkpoint import (map_state,
                                                        state_tensors)
    draws = trainer.draws_for(batch[0].shape[0], trainer.step_num)
    live = {"params": trainer.params, "opt_state": trainer.opt_state}
    start = map_state(lambda t: t.detach().clone(), live)
    runs = []
    for _ in range(2):
        for dst, src in zip(state_tensors(live), state_tensors(start)):
            dst.copy_(src)
        loss = trainer._train_step(trainer.params, trainer.opt_state, batch,
                                   draws)
        runs.append((loss.detach().clone(),
                     map_state(lambda t: t.detach().clone(), live)))
    torch.cuda.synchronize()
    trainer.step_num += 1
    diff = state_diff(torch, runs[0][1], runs[1][1])
    same_loss = torch.equal(runs[0][0], runs[1][0])
    check(diff["differ"] == 0 and same_loss,
          f"({label}) one step twice from one state: {diff['differ']} of "
          f"{diff['tensors']} tensors differ (worst l2 {diff['l2']:.3g} at "
          f"{diff['l2_at']}), the same loss: {same_loss}")
    report[f"same_bits_{label}"] = {"tensors": diff["tensors"],
                                    "loss": runs[0][0].item()}
    print(f"  ({label}) one step twice from one cloned state and draws: all "
          f"{diff['tensors']} param and optimizer tensors and the loss "
          f"({runs[0][0].item():.6f}) the same bits", flush=True)
    del start, runs
    torch.cuda.empty_cache()


def time_scatters(torch, trainer, batch) -> dict:
    """The dense step's three gather backwards as (c) runs them (token
    rows at src and at dst, path rows at pth; bf16 rows, zero where the
    context is masked, as the step's cotangents are): `scatter_rows`
    (ops/scatter.py: float32 sums in a fixed order, no atomics) against
    `index_add_` (the atomics it replaced) on the same inputs,
    CUDA-event ms for the three (median of 10)."""
    from code2vec_tpu_torch.ops.scatter import scatter_rows
    _labels, src, pth, dst, mask, _w = batch
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    cases = []
    for key, ids in (("token_emb", src), ("token_emb", dst),
                     ("path_emb", pth)):
        V = trainer.params[key].shape[0]
        rows = torch.randn((ids.numel(), E), generator=gen, device=DEV,
                           dtype=torch.float32)
        rows = (rows * mask.reshape(-1, 1)).to(torch.bfloat16)
        cases.append((ids.reshape(-1), rows, V))
    fixed_ms = time_ms(torch, lambda: [scatter_rows(i, r, V, torch.bfloat16)
                                       for i, r, V in cases], reps=10)
    atomic_ms = time_ms(torch, lambda: [
        torch.zeros((V, E), dtype=torch.bfloat16, device=DEV).index_add_(
            0, i, r) for i, r, V in cases], reps=10)
    longest = max(int(torch.unique(i, return_counts=True)[1].max().item())
                  for i, _r, _V in cases)
    print(f"  (c) the gathers' backward, three scatters of "
          f"{cases[0][0].numel()} rows (the longest run of one id "
          f"{longest}): fixed-order scatter_rows {fixed_ms:.3f} ms, index_add_ "
          f"{atomic_ms:.3f} ms (CUDA events, median of 10)", flush=True)
    return {"scatter_rows_ms": fixed_ms, "index_add_ms": atomic_ms,
            "rows": cases[0][0].numel(), "longest_run": longest}


def train_config(label: str, tables: str, sampled: bool):
    from code2vec_tpu_torch.config import Config
    return label, Config(
        MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E, TRAIN_BATCH_SIZE=TRAIN_B,
        USE_BF16=True, TABLES_DTYPE=tables, USE_SAMPLED_SOFTMAX=sampled,
        NUM_SAMPLED_CLASSES=TRAIN_S, SPARSE_EMBEDDING_UPDATES=True,
        EMBEDDING_OPTIMIZER="adam", LR_SCHEDULE="constant", SEED=SEED)


def phase_train_config(torch, np, vocabs, data_path, label, cfg, report):
    """One training configuration at java-large width; returns the
    counted run's launches and the java-large U per table."""
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.ops.sparse_update_kernel import (
        sparse_requant_adam_fused, sparse_row_adam_fused)
    from code2vec_tpu_torch.data.reader import C2VTextReader
    from code2vec_tpu_torch.training.sparse_steps import (
        apply_dense_updates, apply_row_updates, loss_and_grads,
        prepare_step_inputs, row_segments)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    trainer = Code2VecTrainer(cfg, vocabs)  # device=None: the card
    check(trainer.device.type == "cuda", f"trainer on {trainer.device}")
    dims, step_cfg = trainer.dims, trainer.step_config
    rows_updated = list(trainer.opt_state["rows"])
    int8_tables = [k for k in rows_updated
                   if isinstance(trainer.params[k], dict)]
    float_tables = [k for k in rows_updated if k not in int8_tables]
    head = (f"sampled softmax S={TRAIN_S}" if cfg.USE_SAMPLED_SOFTMAX
            else "full softmax")
    print(f"  ({label}) tables {cfg.TABLES_DTYPE}, {head}; row-updated "
          f"tables {rows_updated}; set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- the main path: counts at 0 just before, read just after ----
    attention_pool_fused.launches = 0
    sparse_row_adam_fused.launches = 0
    sparse_requant_adam_fused.launches = 0
    t_run = time.perf_counter()
    losses = trainer.train(data_path, max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = {"attention_pool": attention_pool_fused.launches,
                "sparse_row_adam": sparse_row_adam_fused.launches,
                "sparse_requant_adam": sparse_requant_adam_fused.launches}
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"({label}) losses {losses}")
    want = {"attention_pool": TRAIN_STEPS,
            "sparse_row_adam": TRAIN_STEPS * len(float_tables),
            "sparse_requant_adam": TRAIN_STEPS * len(int8_tables)}
    check(launches == want, f"({label}) launches {launches}, expected "
          f"{want} for {TRAIN_STEPS} steps")
    print(f"  ({label}) trainer.train: {TRAIN_STEPS} steps in {run_s:.2f} s "
          f"(host parse included), losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}; launches {launches}",
          flush=True)

    # ---- one step: kernels vs plain versions from the same state ----
    reader = C2VTextReader(data_path, vocabs, C, TRAIN_B)
    batch = trainer.device_batch(next(iter(reader)))
    draws = trainer.draws_for(TRAIN_B, trainer.step_num)
    params, state = trainer.params, trainer.opt_state
    twin_p, twin_s = clone_state(torch, params), clone_state(torch, state)
    S = min(step_cfg.num_sampled, dims.target_vocab_size)
    dense, gathered, ctx = prepare_step_inputs(
        params, batch, draws, use_sampled_softmax=step_cfg.use_sampled_softmax,
        num_sampled=S, target_vocab=dims.target_vocab_size)
    loss_k, g_dense, g_rows = loss_and_grads(dims, step_cfg, dense, gathered,
                                             ctx, use_kernel=True)
    loss_p, _, _ = loss_and_grads(dims, step_cfg, dense, gathered, ctx,
                                  use_kernel=False)
    segments = row_segments(dims, batch, ctx, g_rows)  # once, for both
    apply_dense_updates(params, state, trainer.optimizer, g_dense)
    apply_row_updates(params, state, step_cfg, segments, draws.salts,
                      use_kernel=True)
    apply_dense_updates(twin_p, twin_s, trainer.optimizer, g_dense)
    apply_row_updates(twin_p, twin_s, step_cfg, segments, draws.salts,
                      use_kernel=False)
    torch.cuda.synchronize()
    lk, lp = loss_k.item(), loss_p.item()
    loss_rel = abs(lk - lp) / abs(lp)
    check(loss_rel <= LOSS_RTOL, f"({label}) loss kernel {lk} plain {lp}")
    U = {k: int(u.shape[0]) for k, (u, _s) in segments.items()}
    errs, notes = {}, []
    for k in params:
        n_upd = U.get(k, 0) * dims.embeddings_size
        errs[k], note = compare_tables(torch, f"({label}) {k}", params[k],
                                       twin_p[k], n_upd)
        notes.append(f"{k} {note}")
    for k, st in state["rows"].items():
        errs[f"rows.{k}"] = max(
            compare_moments(torch, f"({label}) {k}.m", st.m, twin_s["rows"][k].m),
            compare_moments(torch, f"({label}) {k}.v", st.v, twin_s["rows"][k].v))
    for k in state["dense"]["mu"]:
        errs[f"dense.{k}"] = max(
            compare_moments(torch, f"({label}) mu.{k}", state["dense"]["mu"][k],
                            twin_s["dense"]["mu"][k]),
            compare_moments(torch, f"({label}) nu.{k}", state["dense"]["nu"][k],
                            twin_s["dense"]["nu"][k]))
    trainer.step_num += 1
    del twin_p, twin_s, dense, gathered, ctx, g_dense, g_rows, segments
    print(f"  ({label}) kernel step vs plain step: loss {lk:.6f} vs {lp:.6f} "
          f"(rel {loss_rel:.2e}); {'; '.join(notes)}; moments max|d| "
          f"{max(v for k, v in errs.items() if '.' in k):.3g}; U {U}",
          flush=True)

    # ---- the same bits twice (Step A's reading) ----
    same_bits_twice(torch, trainer, batch, label, report)

    # ---- the loss falls over a repeated batch (and the same draws, so
    # that only training moves it) ----
    fixed = trainer.draws_for(TRAIN_B, trainer.step_num)
    fall = [trainer.train_step(batch, fixed).item() for _ in range(FALL_STEPS)]
    check(all(np.isfinite(fall)) and fall[-1] < fall[0],
          f"({label}) loss over a repeated batch: {fall}")
    print(f"  ({label}) repeated batch, {FALL_STEPS} steps: "
          f"{', '.join(f'{x:.5f}' for x in fall)}", flush=True)

    # ---- step time and its split by phase ----
    step_ms = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    names = ["draws", "gathers", "forward+backward", "dedup+segment-sum",
             "dense Adam", "row apply"]
    split = {n: [] for n in names}
    for _ in range(TIMED_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        d = trainer.draws_for(TRAIN_B, trainer.step_num)
        ev[1].record()
        dense, gathered, ctx = prepare_step_inputs(
            params, batch, d, use_sampled_softmax=step_cfg.use_sampled_softmax,
            num_sampled=S, target_vocab=dims.target_vocab_size)
        ev[2].record()
        _loss, g_dense, g_rows = loss_and_grads(dims, step_cfg, dense,
                                                gathered, ctx)
        ev[3].record()
        segments = row_segments(dims, batch, ctx, g_rows)
        ev[4].record()
        apply_dense_updates(params, state, trainer.optimizer, g_dense)
        ev[5].record()
        apply_row_updates(params, state, step_cfg, segments, d.salts)
        ev[6].record()
        ev[6].synchronize()
        trainer.step_num += 1
        for i, n in enumerate(names):
            split[n].append(ev[i].elapsed_time(ev[i + 1]))
    med = {n: sorted(v)[len(v) // 2] for n, v in split.items()}
    step_med = sorted(step_ms)[len(step_ms) // 2]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  ({label}) step {step_med:.2f} ms (median of {TIMED_STEPS}, host "
          f"clock, synchronised); by phase (CUDA events, median): " +
          ", ".join(f"{n} {ms:.3f}" for n, ms in med.items()) +
          f"; peak device memory {peak_gb:.2f} GB", flush=True)
    # ---- where the device time goes, and how busy the device is ----
    prof, busy_share, _ = profile_step(
        torch, label, lambda: trainer.train_step(batch), step_med)
    report[f"train_{label}"] = {
        "tables": cfg.TABLES_DTYPE, "sampled": cfg.USE_SAMPLED_SOFTMAX,
        "launches": launches, "steps": TRAIN_STEPS, "losses": losses,
        "run_s": run_s, "loss_kernel": lk, "loss_plain": lp,
        "loss_rel": loss_rel, "errors": errs, "unique_rows": U,
        "repeated_batch_losses": fall, "step_ms": step_ms,
        "step_ms_median": step_med, "phase_ms_median": med,
        "peak_memory_gb": peak_gb, "profile": prof,
        "device_busy_share": busy_share}
    del trainer, params, state
    torch.cuda.empty_cache()
    return launches, U


def row_bound(kind: str, U: int, E: int, peaks):
    """Least time of one live-row apply: per row, the table row read and
    written, both f32 moments read and written, the f32 gradient read,
    the id read (int8 adds the scale read and written), over the HBM
    rate; ~12 float32 operations per element over the f32 peak."""
    f32_peak, _bf16_peak, hbm = peaks
    if kind == "int8":
        nbytes = U * (22 * E + 12)
    else:
        b = 2 if kind == "bfloat16" else 4
        nbytes = U * E * (2 * b + 20) + 4 * U
    flops = 12 * U * E
    ms_bytes, ms_ops = nbytes / hbm * 1e3, flops / f32_peak * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": ms_bytes,
            "f32_ops_ms": ms_ops, "bound_ms": max(ms_bytes, ms_ops),
            "bound_by": "bytes" if ms_bytes >= ms_ops else "operations"}


def phase_row_kernels(torch, peaks, java_u, report):
    """Kernels 5 and 6 against their plain versions on the card."""
    from code2vec_tpu_torch.ops import quant
    from code2vec_tpu_torch.training import sparse_update as su
    from code2vec_tpu_torch.ops.sparse_update import RowAdamState
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr_t = su.adam_lr_t(torch.tensor(3, dtype=torch.int32, device=dev), 1e-3,
                        b1, b2)
    rows = []
    cases = [("bfloat16", E, "token_emb"), ("float32", E, "token_emb"),
             ("bfloat16", D, "target_emb"), ("int8", E, "token_emb")]
    for kind, width, table in cases:
        V = JAVA_LARGE["token" if width == E else "target"] + 2
        base = torch.randn((V, width), generator=gen, device=dev) * 0.05
        m0 = torch.randn((V, width), generator=gen, device=dev) * 1e-3
        v0 = torch.rand((V, width), generator=gen, device=dev) * 1e-5
        for U in (1, 1000, java_u[kind][table]):
            uids = torch.randperm(V, generator=gen, device=dev)[:U].sort() \
                .values.to(torch.int32)
            seg = torch.randn((U, width), generator=gen, device=dev) * 1e-2

            def fresh():
                if kind == "int8":
                    t = quant.quantize_table(base)
                else:
                    t = base.to(getattr(torch, kind))
                return t, RowAdamState(m0.clone(), v0.clone())
            k_t, k_s = fresh()
            p_t, p_s = fresh()
            ref_t, _ = fresh()
            su.apply_rows(k_t, k_s, uids, seg, lr_t=lr_t, b1=b1, b2=b2,
                          eps=eps, salt=0x2545F491, use_kernel=True)
            su.apply_rows(p_t, p_s, uids, seg, lr_t=lr_t, b1=b1, b2=b2,
                          eps=eps, salt=0x2545F491, use_kernel=False)
            torch.cuda.synchronize()
            err, note = compare_tables(torch, f"{kind} E={width} U={U}", k_t,
                                       p_t, U * width)
            m_ulp = ulp_diff(torch, k_s.m, p_s.m)
            v_ulp = ulp_diff(torch, k_s.v, p_s.v)
            check(m_ulp <= 1 and v_ulp <= 1,
                  f"{kind} E={width} U={U}: moments {m_ulp} / {v_ulp} ulp")
            err = max(err, (k_s.m - p_s.m).abs().max().item(),
                      (k_s.v - p_s.v).abs().max().item())
            untouched = torch.ones(V, dtype=torch.bool, device=dev)
            untouched[uids.long()] = False
            for a, b in ((k_t, ref_t), (k_s.m, m0), (k_s.v, v0)):
                pairs = ([(a["q"], b["q"]), (a["s"], b["s"])]
                         if isinstance(a, dict) else [(a, b)])
                for x, y in pairs:
                    check(torch.equal(x[untouched], y[untouched]),
                          f"{kind} E={width} U={U}: an untouched row changed")

            def run_kernel():
                su.apply_rows(k_t, k_s, uids, seg, lr_t=lr_t, b1=b1, b2=b2,
                              eps=eps, salt=7, use_kernel=True)

            def run_plain():
                su.apply_rows(p_t, p_s, uids, seg, lr_t=lr_t, b1=b1, b2=b2,
                              eps=eps, salt=7, use_kernel=False)
            k_ms = time_ms(torch, run_kernel)
            p_ms = time_ms(torch, run_plain)
            dev_ms = kernel_device_ms(
                torch, run_kernel,
                "requant_adam_kernel" if kind == "int8" else "row_adam_kernel")
            bound = row_bound(kind, U, width, peaks)
            row = {"kind": kind, "E": width, "U": U, "V": V,
                   "max_abs_err": err, "agreement": note,
                   "moment_ulp": max(m_ulp, v_ulp), "ms": k_ms,
                   "kernel_device_ms": dev_ms, "plain_ms": p_ms,
                   "library_ms": None, **bound}
            rows.append(row)
            name = "sparse_requant_adam" if kind == "int8" else "sparse_row_adam"
            print(f"  {name} {kind:8s} E={width} U={U:6d}: {note}, moments "
                  f"{row['moment_ulp']} ulp | kernel {k_ms:.4f} ms (device "
                  f"{fmt_ms(dev_ms)}) plain {p_ms:.4f} ms | bound "
                  f"{bound['bound_ms']:.4f} ms "
                  f"({bound['bound_by']}, {bound['bytes'] / 1e6:.2f} MB)",
                  flush=True)
            del k_t, k_s, p_t, p_s, ref_t
        del base, m0, v0
    torch.cuda.empty_cache()
    report["row_kernels"] = rows
    return rows


def requant_bound(V: int, E: int, upd_bytes: int, peaks):
    """Least time of one dense requantize: q read and written, s read and
    written, the update read, over the HBM rate; REQUANT_OPS float32
    operations per element over the float32 peak."""
    f32_peak, _bf16_peak, hbm = peaks
    nbytes = V * E * (2 + upd_bytes) + 8 * V
    flops = REQUANT_OPS * V * E
    ms_bytes, ms_ops = nbytes / hbm * 1e3, flops / f32_peak * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": ms_bytes,
            "f32_ops_ms": ms_ops, "bound_ms": max(ms_bytes, ms_ops),
            "bound_by": "bytes" if ms_bytes >= ms_ops else "operations"}


def phase_requant_kernel(torch, peaks, report):
    """Kernel 4 against its plain version on the card: q and s
    bit-identical in every case (every third row takes a zero update)."""
    from code2vec_tpu_torch.ops import quant
    from code2vec_tpu_torch.ops.requant_kernel import kernel_name
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    rows = []
    for V, width, upd_name in REQUANT_CASES:
        upd_dtype = getattr(torch, upd_name)
        base = torch.randn((V, width), generator=gen, device=DEV) * 0.3
        upd = torch.randn((V, width), generator=gen, device=DEV) * 0.005
        upd[::3] = 0  # rows the step leaves alone
        upd = upd.to(upd_dtype)
        k_t = quant.quantize_table(base)
        q0 = k_t["q"].clone()
        del base
        p_t = quant.requantize_reference(k_t, upd, 0x2545F491)
        quant.requantize(k_t, upd, 0x2545F491)  # the kernel, in place
        torch.cuda.synchronize()
        check(torch.equal(k_t["q"], p_t["q"]), f"requantize V={V} E={width} "
              f"{upd_name}: q differs from the plain version")
        check(torch.equal(k_t["s"], p_t["s"]), f"requantize V={V} E={width} "
              f"{upd_name}: s differs from the plain version")
        # a zero-update row requantizes to itself up to the dither tail
        flips = int((k_t["q"][::3] != q0[::3]).sum().item())
        check(flips <= max(1, q0[::3].numel() // 10000),
              f"requantize V={V}: {flips} elements of zero-update rows moved")
        del p_t, q0
        torch.cuda.empty_cache()
        reps = 30 if V < 100000 else 10

        def run_kernel():
            quant.requantize(k_t, upd, 7)

        def run_plain():
            quant.requantize(k_t, upd, 7, use_kernel=False)
        k_ms = time_ms(torch, run_kernel, reps=reps)
        p_ms = time_ms(torch, run_plain, reps=reps)
        name = kernel_name(k_t, upd)
        dev_ms = kernel_device_ms(torch, run_kernel, name)
        bound = requant_bound(V, width, upd.element_size(), peaks)
        row = {"V": V, "E": width, "update": upd_name, "kernel": name,
               "max_abs_err": 0.0,
               "zero_update_flips": flips, "ms": k_ms,
               "kernel_device_ms": dev_ms, "plain_ms": p_ms,
               "library_ms": None, **bound}
        rows.append(row)
        print(f"  requantize V={V:8d} E={width} {upd_name:8s} ({name}): q, s "
              f"bit-identical ({flips} zero-update flips) | kernel "
              f"{k_ms:.4f} ms (device {fmt_ms(dev_ms)}) plain {p_ms:.4f} ms | "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
              f"{bound['bytes'] / 1e6:.1f} MB)", flush=True)
        del k_t, upd
        torch.cuda.empty_cache()
    report["requant_kernel"] = rows
    return rows


def dense_config(label: str, tables: str, sampled: bool):
    """The JAX package's defaults (dense step, Adafactor, cosine LR) at
    java-large width, with the given tables and softmax."""
    from code2vec_tpu_torch.config import Config
    cfg = Config(MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E,
                 TRAIN_BATCH_SIZE=TRAIN_B, TABLES_DTYPE=tables,
                 USE_SAMPLED_SOFTMAX=sampled, NUM_SAMPLED_CLASSES=TRAIN_S,
                 SEED=SEED)
    check((cfg.SPARSE_EMBEDDING_UPDATES, cfg.EMBEDDING_OPTIMIZER,
           cfg.LR_SCHEDULE, cfg.USE_BF16) ==
          (False, "adafactor", "cosine", True), f"({label}) not the defaults")
    return label, cfg


def phase_dense_config(torch, np, vocabs, data_path, label, cfg, report):
    """One dense training configuration at java-large width; returns the
    counted run's launches."""
    from code2vec_tpu_torch.data.reader import C2VTextReader
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.ops.requant_kernel import requantize_fused
    from code2vec_tpu_torch.ops.sparse_update_kernel import (
        sparse_requant_adam_fused, sparse_row_adam_fused)
    from code2vec_tpu_torch.training.draws import quantized_keys
    from code2vec_tpu_torch.training.steps import (apply_dense_updates,
                                                   dense_loss_and_grads,
                                                   make_train_loss_fn)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    trainer = Code2VecTrainer(cfg, vocabs)  # device=None: the card
    check(trainer.device.type == "cuda", f"trainer on {trainer.device}")
    dims, step_cfg = trainer.dims, trainer.step_config
    qkeys = quantized_keys(trainer.params)
    head = (f"sampled softmax S={TRAIN_S}" if cfg.USE_SAMPLED_SOFTMAX
            else "full softmax")
    print(f"  ({label}) tables {cfg.TABLES_DTYPE}, {head}, Adafactor + Adam, "
          f"cosine LR; int8 tables {qkeys}; set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if label == "c":
        logits_branches(torch, label, random_code(torch, TRAIN_B, SEED + 8),
                        trainer.params["target_emb"], report)

    # ---- the main path: counts at 0 just before, read just after ----
    attention_pool_fused.launches = 0
    requantize_fused.launches = 0
    sparse_row_adam_fused.launches = 0
    sparse_requant_adam_fused.launches = 0
    t_run = time.perf_counter()
    losses = trainer.train(data_path, max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = {"attention_pool": attention_pool_fused.launches,
                "requantize": requantize_fused.launches,
                "sparse_row_adam": sparse_row_adam_fused.launches,
                "sparse_requant_adam": sparse_requant_adam_fused.launches}
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"({label}) losses {losses}")
    want = {"attention_pool": TRAIN_STEPS,
            "requantize": TRAIN_STEPS * len(qkeys),
            "sparse_row_adam": 0, "sparse_requant_adam": 0}
    check(launches == want, f"({label}) launches {launches}, expected "
          f"{want} for {TRAIN_STEPS} steps")
    print(f"  ({label}) trainer.train: {TRAIN_STEPS} steps in {run_s:.2f} s "
          f"(host parse included; LR horizon {trainer.total_steps} steps), "
          f"losses {', '.join(f'{x:.5f}' for x in losses)}; launches "
          f"{launches}", flush=True)

    # ---- one step: kernels vs plain versions from the same state ----
    reader = C2VTextReader(data_path, vocabs, C, TRAIN_B)
    batch = trainer.device_batch(next(iter(reader)))
    draws = trainer.draws_for(TRAIN_B, trainer.step_num)
    params, state, opt = trainer.params, trainer.opt_state, trainer.optimizer
    kw = dict(use_sampled_softmax=step_cfg.use_sampled_softmax,
              num_sampled=step_cfg.num_sampled,
              compute_dtype=step_cfg.compute_dtype)
    loss_fn_k = make_train_loss_fn(dims, use_kernel=True, **kw)
    loss_fn_p = make_train_loss_fn(dims, use_kernel=False, **kw)
    loss_k, grads, view = dense_loss_and_grads(params, batch, draws,
                                               loss_fn_k)
    loss_p, _, _ = dense_loss_and_grads(params, batch, draws, loss_fn_p)
    updates = opt.update(grads, state, view)
    twin = clone_state(torch, params)
    apply_dense_updates(params, updates, draws.salts, use_kernel=True)
    apply_dense_updates(twin, updates, draws.salts, use_kernel=False)
    torch.cuda.synchronize()
    lk, lp = loss_k.item(), loss_p.item()
    loss_rel = abs(lk - lp) / abs(lp)
    check(loss_rel <= LOSS_RTOL, f"({label}) loss kernel {lk} plain {lp}")
    for k in params:
        pairs = ([(f"{k}.q", params[k]["q"], twin[k]["q"]),
                  (f"{k}.s", params[k]["s"], twin[k]["s"])]
                 if isinstance(params[k], dict) else [(k, params[k], twin[k])])
        for name, a, b in pairs:
            check(torch.equal(a, b), f"({label}) {name}: kernel step and "
                  f"plain step differ given the same update")
    trainer.step_num += 1
    del twin, grads, view, updates
    torch.cuda.empty_cache()
    print(f"  ({label}) kernel step vs plain step: loss {lk:.6f} vs {lp:.6f} "
          f"(rel {loss_rel:.2e}); the same update gives bit-identical "
          f"params{' (q, s of ' + ', '.join(qkeys) + ')' if qkeys else ''}",
          flush=True)

    # ---- the same bits twice (Step A's reading) ----
    same_bits_twice(torch, trainer, batch, label, report)
    if label == "c":
        report["scatter_c"] = time_scatters(torch, trainer, batch)

    # ---- the loss falls over a repeated batch (and the same draws) ----
    fixed = trainer.draws_for(TRAIN_B, trainer.step_num)
    fall = [trainer.train_step(batch, fixed).item() for _ in range(FALL_STEPS)]
    check(all(np.isfinite(fall)) and fall[-1] < fall[0],
          f"({label}) loss over a repeated batch: {fall}")
    print(f"  ({label}) repeated batch, {FALL_STEPS} steps: "
          f"{', '.join(f'{x:.5f}' for x in fall)}", flush=True)

    # ---- step time and its split by phase ----
    step_ms = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    names = ["draws", "forward+backward", "optimizer", "apply/requantize"]
    split = {n: [] for n in names}
    for _ in range(TIMED_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        d = trainer.draws_for(TRAIN_B, trainer.step_num)
        ev[1].record()
        _loss, grads, view = dense_loss_and_grads(params, batch, d, loss_fn_k)
        ev[2].record()
        updates = opt.update(grads, state, view)
        ev[3].record()
        apply_dense_updates(params, updates, d.salts)
        ev[4].record()
        ev[4].synchronize()
        trainer.step_num += 1
        for i, n in enumerate(names):
            split[n].append(ev[i].elapsed_time(ev[i + 1]))
    del grads, view, updates
    med = {n: sorted(v)[len(v) // 2] for n, v in split.items()}
    step_med = sorted(step_ms)[len(step_ms) // 2]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  ({label}) step {step_med:.2f} ms (median of {TIMED_STEPS}, host "
          f"clock, synchronised); by phase (CUDA events, median): " +
          ", ".join(f"{n} {ms:.3f}" for n, ms in med.items()) +
          f"; peak device memory {peak_gb:.2f} GB", flush=True)
    prof, busy_share, _ = profile_step(
        torch, label, lambda: trainer.train_step(batch), step_med)
    report[f"train_{label}"] = {
        "tables": cfg.TABLES_DTYPE, "sampled": cfg.USE_SAMPLED_SOFTMAX,
        "optimizer": "adafactor", "lr_schedule": cfg.LR_SCHEDULE,
        "lr_horizon": trainer.total_steps, "launches": launches,
        "steps": TRAIN_STEPS, "losses": losses, "run_s": run_s,
        "loss_kernel": lk, "loss_plain": lp, "loss_rel": loss_rel,
        "repeated_batch_losses": fall, "step_ms": step_ms,
        "step_ms_median": step_med, "phase_ms_median": med,
        "peak_memory_gb": peak_gb, "profile": prof,
        "device_busy_share": busy_share}
    del trainer, params, state, opt
    torch.cuda.empty_cache()
    return launches


def eval_plain(torch, params, batch, dims, top_k: int):
    """The evaluation step with the attention pool's plain float32
    version where the kernel runs (the code cast to bf16 after, as the
    kernel path casts it): (loss_sum, top-k ids)."""
    import torch.nn.functional as F
    from code2vec_tpu_torch.models.encoder import full_logits, gather_contexts
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_plain
    from code2vec_tpu_torch.training.steps import topk_stable
    labels, src, pth, dst, mask, weights = batch
    ctx = gather_contexts(params, src, pth, dst, torch.bfloat16)
    code, _ = attention_pool_plain(ctx, params["transform"],
                                   params["attention"], mask)
    logits = full_logits(params, code.to(torch.bfloat16),
                         dims.target_vocab_size)
    ce = torch.clamp(F.cross_entropy(logits, labels.long(), reduction="none"),
                     min=0.0)
    return (ce * weights).sum(), topk_stable(torch.softmax(logits, dim=-1),
                                             top_k)[1]


def phase_eval(torch, np, vocabs, test_path, report):
    """`evaluate` over the test file (counted), then the kernel path
    against the plain path batch by batch."""
    from code2vec_tpu_torch.data.reader import C2VTextReader
    from code2vec_tpu_torch.models.encoder import full_logits, get_encode_fn
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.training.steps import eval_step
    _, cfg = dense_config("eval", "bfloat16", False)
    trainer = Code2VecTrainer(cfg, vocabs)  # device=None: the card
    # the same stretch as the serving phase: initial tables near 0 make
    # every logit the same and the top-1 comparison vacuous
    for key, reach in (("token_emb", 1.0), ("path_emb", 1.0),
                       ("target_emb", 0.3)):
        t = trainer.params[key]
        t.mul_(reach / t.float().abs().max().item())
    top_k = cfg.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION
    n_batches = -(-EVAL_METHODS // cfg.TEST_BATCH_SIZE)
    trainer.evaluate(test_path)  # warm: allocator, library set-up

    # ---- the main path: counts at 0 just before, read just after ----
    attention_pool_fused.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    results = trainer.evaluate(test_path)
    eval_s = time.perf_counter() - t
    launches = {"attention_pool": attention_pool_fused.launches}
    check(launches["attention_pool"] == n_batches,
          f"eval: attention_pool launched {launches['attention_pool']} times "
          f"for {n_batches} batches")
    check(np.isfinite(results.loss) and len(results.topk_acc) == top_k and
          all(0 <= a <= 1 for a in results.topk_acc) and
          0 <= results.subtoken_f1 <= 1, f"eval results {results}")
    rate = EVAL_METHODS / eval_s
    print(f"  evaluate: {EVAL_METHODS} methods in {n_batches} batches of "
          f"{cfg.TEST_BATCH_SIZE}, {eval_s:.3f} s ({rate:.0f} methods/s, "
          f"host parse and decode included); {results}; launches "
          f"{launches}", flush=True)

    # ---- the kernel path vs the plain path, batch by batch ----
    reader = C2VTextReader(test_path, vocabs, C, cfg.TEST_BATCH_SIZE)
    loss_k = loss_p = 0.0
    same = total = 0
    with torch.inference_mode():
        for b in reader:
            batch = trainer.device_batch(b)
            lk, ids_k, _ = eval_step(trainer.params, batch, dims=trainer.dims,
                                     top_k=top_k,
                                     compute_dtype=torch.bfloat16)
            lp, ids_p = eval_plain(torch, trainer.params, batch, trainer.dims,
                                   top_k)
            nv = b.num_valid_examples
            loss_k += lk.item()
            loss_p += lp.item()
            same += int((ids_k[:nv, 0] == ids_p[:nv, 0]).sum().item())
            total += nv
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    share = same / total
    check(loss_rel <= LOSS_RTOL, f"eval loss kernel {loss_k} plain {loss_p}")
    check(share >= EVAL_TOP1_SHARE, f"eval top-1 equal on {same}/{total}")
    print(f"  eval kernel path vs plain path: loss sum {loss_k:.4f} vs "
          f"{loss_p:.4f} (rel {loss_rel:.2e}); top-1 equal on {same}/{total}",
          flush=True)
    with torch.inference_mode():
        _labels, src, pth, dst, mask, _w = batch
        code, _ = get_encode_fn(trainer.dims)(trainer.params, src, pth, dst,
                                              mask, compute_dtype=torch.bfloat16)
        probs = torch.softmax(full_logits(trainer.params, code,
                                          trainer.dims.target_vocab_size),
                              dim=-1)
        time_topk(torch, probs, "eval", report)
    del probs, code
    report["eval"] = {
        "methods": EVAL_METHODS, "batch": cfg.TEST_BATCH_SIZE,
        "seconds": eval_s, "methods_per_s": rate, "launches": launches,
        "loss": results.loss, "topk_acc": results.topk_acc,
        "subtoken_f1": results.subtoken_f1, "loss_rel_kernel_plain": loss_rel,
        "top1_equal_share": share}
    del trainer
    torch.cuda.empty_cache()
    return launches


# ---- the transformer path-encoder (kernels 2 and 3) ----

def xf_inputs(torch, shape, dtype, gen):
    """q, k, v ~ N(0, 1) in `dtype`, a log mask (log 1e-30 on a masked
    key) cycling through: random, all padding but key 0, full."""
    B, _H, Cq, _hd = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    mask = (torch.rand((B, Cq), generator=gen, device="cuda") > 0.3).float()
    mask[:, 0] = 1
    mask[1::3] = 0
    mask[1::3, 0] = 1
    mask[2::3] = 1
    return q, k, v, torch.log(torch.clamp(mask, min=1e-30))


def xf_bound(shape, elem: int, peaks, pair: int, wide: int, tensors: int):
    """Least time of one attention call over (b, h) blocks: `tensors`
    [B, H, C, hd] arrays read or written once and the mask read, over the
    HBM rate; [C, C, hd] products (2 C^2 hd operations each) at the peak
    of their operand types: `pair` products of two bf16 operands (q k^T,
    dO v^T, and the bf16 kernel 2's e_t v, one per term) at the bf16
    tensor-core peak when the inputs are bf16 (a bf16 product is exact in
    a float32 sum), `wide` products with a float32 operand (the softmax
    weights A, or dL) at the float32 peak, as every product of float32
    inputs."""
    f32_peak, bf16_peak, hbm = peaks
    B, H, Cq, hd = shape
    nbytes = tensors * B * H * Cq * hd * elem + 4 * B * Cq
    per_product = 2 * Cq * Cq * hd * B * H
    pair_peak = bf16_peak if elem == 2 else f32_peak
    ms_bytes = nbytes / hbm * 1e3
    ms_ops = (pair * per_product / pair_peak
              + wide * per_product / f32_peak) * 1e3
    flops = (pair + wide) * per_product
    return {"bytes": nbytes, "flops": flops, "bytes_ms": ms_bytes,
            "ops_ms": ms_ops, "tensor_core_ops_ms": flops / bf16_peak * 1e3,
            "bound_ms": max(ms_bytes, ms_ops),
            "bound_by": "operations" if ms_ops >= ms_bytes else "bytes"}


def phase_xf_kernels(torch, peaks, report):
    """Kernels 2 and 3 against their plain versions on the card."""
    import torch.nn.functional as F
    from code2vec_tpu_torch.ops import xf_attention as xa
    from code2vec_tpu_torch.ops.xf_attention_kernel import tc_terms
    terms = tc_terms()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {"forward": [], "backward": []}
    for shape, dname in XF_CASES:
        dtype = getattr(torch, dname)
        q, k, v, lm = xf_inputs(torch, shape, dtype, gen)
        do = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        tol = XF_TOL[dname]
        got = [xa.mha_forward_fused(q, k, v, lm),
               *xa.mha_backward_fused(q, k, v, lm, do)]
        want = [xa.mha_forward_plain(q, k, v, lm),
                *xa.mha_backward_plain(q, k, v, lm, do)]
        again = [xa.mha_forward_fused(q, k, v, lm),
                 *xa.mha_backward_fused(q, k, v, lm, do)]
        torch.cuda.synchronize()
        check(torch.equal(again[0], got[0]), f"xf {shape} {dtype}: kernel 2 "
              f"gave other bits on a second launch")
        check(all(torch.equal(a, b) for a, b in zip(again[1:], got[1:])),
              f"xf {shape} {dtype}: kernel 3 gave other bits on a second "
              f"launch")
        errs, rels = [], []
        for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
            check(bool(torch.isfinite(a).all()), f"xf {shape} {dtype}: "
                  f"non-finite {name}")
            err = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            check(err <= tol * top, f"xf {shape} {dtype}: {name} max|d| "
                  f"{err} over {tol} x {top}")
            errs.append(err)
            rels.append(err / top)
        elem = q.element_size()
        k2_ms = time_ms(torch, lambda: xa.mha_forward_fused(q, k, v, lm))
        k3_ms = time_ms(torch, lambda: xa.mha_backward_fused(q, k, v, lm, do))
        p2_ms = time_ms(torch, lambda: xa.mha_forward_plain(q, k, v, lm))
        p3_ms = time_ms(torch, lambda: xa.mha_backward_plain(q, k, v, lm, do))
        k2_dev = kernel_device_ms(
            torch, lambda: xa.mha_forward_fused(q, k, v, lm),
            XF_FWD_KERNEL[dname])
        k3a_name, k3b_name = XF_BWD_KERNELS[dname]
        k3a_dev = kernel_device_ms(
            torch, lambda: xa.mha_backward_fused(q, k, v, lm, do), k3a_name)
        k3b_dev = kernel_device_ms(
            torch, lambda: xa.mha_backward_fused(q, k, v, lm, do), k3b_name)
        # the library yardstick (never called by the port): SDPA with the
        # additive mask, forward, and its backward through autograd
        sq, sk, sv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        am = lm.to(dtype)[:, None, None, :]
        l2_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=am))
        so = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=am)
        l3_ms = time_ms(torch, lambda: torch.autograd.grad(
            so, (sq, sk, sv), do, retain_graph=True))
        del sq, sk, sv, so
        # kernel 2 on bf16 (the tensor cores): q k^T and e_t v for each of
        # the `terms` bf16 terms of the weights (its second pass
        # recomputes q k^T: one more); on float32, and as the CUDA-core
        # design priced bf16: q k^T and A v with float32 A.
        # Kernel 3 as the Pallas kernel counts it: q k^T, dO v^T, A^T dO,
        # dL k, dL^T q; on bf16 (the tensor cores) the last three as
        # `terms` products each, on float32, and as the CUDA-core design
        # priced bf16, with float32 A and dL. What the split runs: on bf16
        # 3a takes q k^T three times and dO v^T twice, 3b K Q^T twice and
        # V dO^T once, and the three term products; the CUDA-core pair
        # q k^T and dO v^T twice each
        b2_f32_weights = xf_bound(shape, elem, peaks, 1, 1, 4)
        b2 = xf_bound(shape, elem, peaks, 1 + terms, 0, 4) \
            if elem == 2 else b2_f32_weights
        b2_two_pass = xf_bound(shape, elem, peaks, 2 + terms, 0, 4)
        b3_f32_weights = xf_bound(shape, elem, peaks, 2, 3, 7)
        b3 = xf_bound(shape, elem, peaks, 2 + 3 * terms, 0, 7) \
            if elem == 2 else b3_f32_weights
        b3_split = xf_bound(shape, elem, peaks, 8 + 3 * terms, 0, 7) \
            if elem == 2 else xf_bound(shape, elem, peaks, 4, 3, 7)
        common = {"shape": list(shape), "dtype": dname}
        rows["forward"].append({
            **common, "kernel": XF_FWD_KERNEL[dname], "max_abs_err": errs[0],
            "rel_err": rels[0], "bits_differ_share": (
                got[0] != want[0]).float().mean().item(),
            "ms": k2_ms, "kernel_device_ms": k2_dev, "plain_ms": p2_ms,
            "library_ms": l2_ms, **b2,
            "bound_ms_float32_weights": b2_f32_weights["bound_ms"],
            "two_pass_ops_ms": b2_two_pass["ops_ms"]})
        rows["backward"].append({
            **common, "kernel": "+".join(XF_BWD_KERNELS[dname]),
            "max_abs_err": max(errs[1:]), "rel_err": max(rels[1:]),
            "bits_differ_share": max(
                (a != b).float().mean().item()
                for a, b in zip(got[1:], want[1:])),
            "ms": k3_ms, "kernel_device_ms": (
                None if None in (k3a_dev, k3b_dev) else k3a_dev + k3b_dev),
            "kernel_3a_device_ms": k3a_dev, "kernel_3b_device_ms": k3b_dev,
            "plain_ms": p3_ms, "library_ms": l3_ms, **b3,
            "bound_ms_float32_weights": b3_f32_weights["bound_ms"],
            "split_ops_ms": b3_split["ops_ms"]})
        print(f"  mha {tuple(shape)} {dname:8s} rel err o {rels[0]:.2g} "
              f"dq/dk/dv {max(rels[1:]):.2g} | kernel 2 "
              f"({XF_FWD_KERNEL[dname]}, bits equal twice) {k2_ms:.4f} ms "
              f"(device {fmt_ms(k2_dev)}) plain {p2_ms:.4f} sdpa {l2_ms:.4f} "
              f"bound {b2['bound_ms']:.4f} ({b2['bound_by']}; float32 A v "
              f"{b2_f32_weights['bound_ms']:.4f}) | kernel 3 "
              f"({k3a_name} + {k3b_name}, bits equal twice) {k3_ms:.4f} ms "
              f"(device 3a {fmt_ms(k3a_dev)} + 3b {fmt_ms(k3b_dev)}) "
              f"plain {p3_ms:.4f} sdpa bwd {l3_ms:.4f} bound "
              f"{b3['bound_ms']:.4f} ({b3['bound_by']}; float32 A, dL "
              f"{b3_f32_weights['bound_ms']:.4f}; the split's products "
              f"{b3_split['ops_ms']:.4f})", flush=True)
        del q, k, v, lm, do, got, want, again
        torch.cuda.empty_cache()
    report["xf_kernels"] = rows
    return rows


def xf_counts():
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.ops.xf_attention import (mha_backward_fused,
                                                     mha_forward_fused)
    return {"attention_pool": attention_pool_fused.launches,
            "xf_attention_forward": mha_forward_fused.launches,
            "xf_attention_backward": mha_backward_fused.launches}


def zero_xf_counts():
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.ops.xf_attention import (mha_backward_fused,
                                                     mha_forward_fused)
    attention_pool_fused.launches = 0
    mha_forward_fused.launches = 0
    mha_backward_fused.launches = 0


def stretch_tables(params) -> None:
    """The serving phase's stretch: leaf embeddings uniform in [-1, 1],
    the target table in [-0.3, 0.3] (initial tables near 0 make every
    logit the same and a top-k comparison vacuous)."""
    for key, reach in (("token_emb", 1.0), ("path_emb", 1.0),
                      ("target_emb", 0.3)):
        t = params[key]
        t.mul_(reach / t.float().abs().max().item())


def xf_config(**kw):
    """bench.py's transformer configuration at java-large width: L = 2,
    H = 3 (hd = 128), bf16 tables and compute, B = 1024, Adafactor tables
    and Adam elsewhere at a constant 1e-3, sampled softmax over 4096."""
    from code2vec_tpu_torch.config import Config
    base = dict(MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E,
                TRAIN_BATCH_SIZE=TRAIN_B, TABLES_DTYPE="bfloat16",
                USE_BF16=True, ENCODER_TYPE="transformer", XF_LAYERS=XF_L,
                XF_HEADS=XF_H, LEARNING_RATE=1e-3, LR_SCHEDULE="constant",
                USE_SAMPLED_SOFTMAX=True, NUM_SAMPLED_CLASSES=TRAIN_S,
                SEED=SEED)
    base.update(kw)
    return Config(**base)


def phase_xf_serving(torch, np, vocabs, report):
    """The transformer model behind the port's PredictionServer."""
    from code2vec_tpu_torch.models.encoder import init_params
    from code2vec_tpu_torch.models.torch_model import (Code2VecModel,
                                                       dims_from_config)
    from code2vec_tpu_torch.serving.server import PredictionServer
    from code2vec_tpu_torch.training.steps import predict_step

    config = xf_config(SERVE_BATCH_MAX=64, SERVE_DEADLINE_MS=30000.0)
    dims = dims_from_config(config, vocabs)
    params = init_params(torch.Generator(device=DEV).manual_seed(SEED), dims)
    stretch_tables(params)
    model = Code2VecModel(config, dims, vocabs, params)  # the card
    check(model.device.type == "cuda", f"model on {model.device}")
    requests = make_requests(np, np.random.default_rng(SEED + 2))
    server = PredictionServer(config, model)
    try:
        server.start(warmup=True)
        results = [None] * len(requests)
        latency_ms = [None] * len(requests)
        errors = []

        def client(i0):
            try:
                for i in range(i0, len(requests), N_CLIENTS):
                    t = time.perf_counter()
                    results[i] = server.predict_lines(requests[i])
                    latency_ms[i] = (time.perf_counter() - t) * 1e3
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        # ---- the main path: counts at 0 just before, read just after ----
        zero_xf_counts()
        batches0 = server.batches
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(N_CLIENTS)]
        t_run = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall_s = time.perf_counter() - t_run
        launches = xf_counts()
        device_batches = server.batches - batches0
        check(not any(t.is_alive() for t in threads), "a client thread hung")
        if errors:
            raise errors[0]
        n_methods = 0
        for lines, res in zip(requests, results):
            check(res is not None and len(res) == len(lines),
                  "a request got the wrong number of results")
            for r in res:
                n_methods += 1
                check(len(r.predictions) in (TOP_K - 1, TOP_K),
                      f"{len(r.predictions)} predictions")
                check(all(np.isfinite(p["probability"]) for p in
                          r.predictions), "bad probability")
        want = {"attention_pool": 0,
                "xf_attention_forward": XF_L * device_batches,
                "xf_attention_backward": 0}
        check(device_batches >= 1 and launches == want,
              f"xf serving launches {launches}, expected {want}")
        lat = np.array(latency_ms)
        print(f"  served {len(requests)} requests / {n_methods} methods from "
              f"{N_CLIENTS} threads in {wall_s:.3f} s: {device_batches} device "
              f"batches, launches {launches}; request p50 "
              f"{np.percentile(lat, 50):.2f} ms p99 "
              f"{np.percentile(lat, 99):.2f} ms", flush=True)

        flat_lines = [ln for req in requests for ln in req]
        prepared = model.prepare_predict_rows(flat_lines[:64])
        ts = []
        for _ in range(7):
            t = time.perf_counter()
            model.predict_device(prepared)
            ts.append((time.perf_counter() - t) * 1e3)
        bucket64_ms = sorted(ts)[len(ts) // 2]

        # ---- one batch: kernel path vs plain path on the card ----
        batch = model.device_batch(
            prepared.labels, prepared.src, prepared.pth, prepared.dst,
            prepared.mask, np.ones(prepared.n, np.float32))
        with torch.inference_mode():
            kw = dict(dims=dims, top_k=TOP_K, compute_dtype=torch.bfloat16)
            ids_k, probs_k, attn_k, code_k = predict_step(model.params, batch,
                                                          **kw)
            ids_p, probs_p, attn_p, code_p = predict_step(
                model.params, batch, use_kernel=False, **kw)
        code_err = (code_k - code_p).abs().max().item()
        code_top = code_p.abs().max().item()
        attn_err = (attn_k - attn_p).abs().max().item()
        attn_rel = ((attn_k - attn_p).abs().amax(dim=-1)
                    / attn_p.amax(dim=-1)).max().item()
        prob_err = ((probs_k - probs_p).abs() / probs_p).max().item()
        check(code_err <= XF_E2E_CODE_RTOL * code_top,
              f"xf serving code max|d| {code_err} of {code_top}")
        check(attn_rel <= XF_E2E_ATTN_RTOL, f"xf serving attn max|d| "
              f"{attn_rel} of a method's largest weight")
        check(prob_err <= XF_E2E_PROB_RTOL,
              f"xf serving prob max rel d {prob_err}")
        # top-k ids equal wherever the plain path's probabilities are more
        # than twice the tolerance apart (closer ones may swap)
        ids_k, ids_p = ids_k.cpu().numpy(), ids_p.cpu().numpy()
        pp = probs_p.float().cpu().numpy()
        checked = 0
        for i in range(ids_p.shape[0]):
            for j in range(TOP_K - 1):
                gap = min(pp[i, j] - pp[i, j + 1],
                          pp[i, j - 1] - pp[i, j] if j else np.inf)
                if gap > 2 * XF_E2E_PROB_RTOL * pp[i, j]:
                    check(ids_k[i, j] == ids_p[i, j], f"xf top-k id {i},{j}")
                    checked += 1
        check(checked >= prepared.n // 2, f"only {checked} separated top-k "
              f"ids over {prepared.n} methods")
        print(f"  predict_device 64 methods {bucket64_ms:.3f} ms; kernel path "
              f"vs plain path, {prepared.n} methods: code max|d| "
              f"{code_err:.3g} (of {code_top:.3g}), attn {attn_err:.3g} "
              f"({attn_rel:.3g} of a method's largest), "
              f"top-k prob max rel d {prob_err:.3g}, {checked} separated "
              f"top-k ids equal", flush=True)
    finally:
        server.close()
    report["xf_serving"] = {
        "requests": len(requests), "methods": n_methods,
        "device_batches": device_batches, "launches": launches,
        "wall_s": wall_s, "request_ms_p50": float(np.percentile(lat, 50)),
        "request_ms_p99": float(np.percentile(lat, 99)),
        "predict_device_ms_64": bucket64_ms, "e2e_code_err": code_err,
        "e2e_attn_err": attn_err, "e2e_attn_rel": attn_rel,
        "e2e_prob_rel": prob_err,
        "e2e_ids_checked": checked}
    del model, params
    torch.cuda.empty_cache()
    return launches


def phase_xf_train(torch, np, vocabs, data_path, report):
    """Configuration (e): the transformer dense step through the trainer."""
    import dataclasses
    from code2vec_tpu_torch.data.reader import C2VTextReader
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.training.steps import (apply_dense_updates,
                                                   dense_loss_and_grads,
                                                   make_train_loss_fn)
    label = "e"
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = xf_config()
    trainer = Code2VecTrainer(cfg, vocabs)  # device=None: the card
    check(trainer.device.type == "cuda", f"trainer on {trainer.device}")
    dims, step_cfg = trainer.dims, trainer.step_config
    xf_n = sum(t.numel() for t in trainer.opt_state["small"][0].mu.values())
    print(f"  ({label}) transformer L={XF_L} H={XF_H} (hd {D // XF_H}), "
          f"{xf_n} Adam params, tables bf16, sampled softmax S={TRAIN_S}, "
          f"Adafactor + Adam at a constant {cfg.LEARNING_RATE}; set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # the sampled logits: the code against the step's gathered rows
    logits_branches(torch, label, random_code(torch, TRAIN_B, SEED + 12),
                    trainer.params["target_emb"][:TRAIN_S], report)

    # ---- the main path: counts at 0 just before, read just after ----
    zero_xf_counts()
    t_run = time.perf_counter()
    losses = trainer.train(data_path, max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = xf_counts()
    want = {"attention_pool": 0, "xf_attention_forward": XF_L * TRAIN_STEPS,
            "xf_attention_backward": XF_L * TRAIN_STEPS}
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"({label}) losses {losses}")
    check(launches == want, f"({label}) launches {launches}, expected {want}")
    print(f"  ({label}) trainer.train: {TRAIN_STEPS} steps in {run_s:.2f} s "
          f"(host parse included), losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}; launches {launches}",
          flush=True)

    # ---- one step: kernels vs plain versions from the same state ----
    reader = C2VTextReader(data_path, vocabs, C, TRAIN_B)
    batch = trainer.device_batch(next(iter(reader)))
    draws = trainer.draws_for(TRAIN_B, trainer.step_num)
    params, state, opt = trainer.params, trainer.opt_state, trainer.optimizer
    kw = dict(use_sampled_softmax=step_cfg.use_sampled_softmax,
              num_sampled=step_cfg.num_sampled,
              compute_dtype=step_cfg.compute_dtype)
    loss_fn = make_train_loss_fn(dims, **kw)
    loss_k, grads_k, _view = dense_loss_and_grads(params, batch, draws,
                                                  loss_fn)
    loss_p, grads_p, _ = dense_loss_and_grads(
        params, batch, draws, make_train_loss_fn(dims, use_kernel=False, **kw))
    torch.cuda.synchronize()
    lk, lp = loss_k.item(), loss_p.item()
    loss_rel = abs(lk - lp) / abs(lp)
    check(loss_rel <= LOSS_RTOL, f"({label}) loss kernel {lk} plain {lp}")
    grad_rel = 0.0
    for key, g in grads_p.items():
        if key.startswith("xf/"):
            top = g.float().abs().max().item()
            err = (grads_k[key].float() - g.float()).abs().max().item()
            grad_rel = max(grad_rel, err / max(top, 1e-30))
    check(grad_rel <= XF_GRAD_RTOL, f"({label}) xf grads kernel vs plain "
          f"{grad_rel} of the largest")
    del grads_p, _view
    # the XF_REMAT step from the same state and draws: kernel 2 runs twice
    # per layer, and the loss and grads are the same bit for bit (the same
    # operations on the same inputs)
    remat_fn = make_train_loss_fn(dataclasses.replace(dims, xf_remat=True),
                                  **kw)
    zero_xf_counts()
    loss_r, grads_r, _ = dense_loss_and_grads(params, batch, draws, remat_fn)
    torch.cuda.synchronize()
    remat_launches = xf_counts()
    lr_ = loss_r.item()
    check(remat_launches == {"attention_pool": 0,
                             "xf_attention_forward": 2 * XF_L,
                             "xf_attention_backward": XF_L},
          f"({label}) remat launches {remat_launches}")
    check(lr_ == lk, f"({label}) remat loss {lr_} vs {lk}")
    remat_grad_rel = max(
        (grads_r[k].float() - g.float()).abs().max().item()
        / max(g.float().abs().max().item(), 1e-30)
        for k, g in grads_k.items() if k.startswith("xf/"))
    check(remat_grad_rel == 0.0,
          f"({label}) remat xf grads differ by {remat_grad_rel}")
    del grads_r, grads_k
    torch.cuda.empty_cache()
    print(f"  ({label}) kernel step vs plain step: loss {lk:.6f} vs {lp:.6f} "
          f"(rel {loss_rel:.2e}), xf grads max|d| {grad_rel:.3g} of the "
          f"largest; XF_REMAT step: loss {lr_:.6f}, grads max|d| "
          f"{remat_grad_rel:.3g}, launches {remat_launches}", flush=True)

    # ---- the same bits twice (Step A's reading) ----
    same_bits_twice(torch, trainer, batch, label, report)

    # ---- the loss falls over a repeated batch (and the same draws) ----
    fixed = trainer.draws_for(TRAIN_B, trainer.step_num)
    fall = [trainer.train_step(batch, fixed).item() for _ in range(FALL_STEPS)]
    check(all(np.isfinite(fall)) and fall[-1] < fall[0],
          f"({label}) loss over a repeated batch: {fall}")
    print(f"  ({label}) repeated batch, {FALL_STEPS} steps: "
          f"{', '.join(f'{x:.5f}' for x in fall)}", flush=True)

    # ---- step time and its split by phase ----
    step_ms = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    names = ["draws", "forward+backward", "optimizer", "apply"]
    split = {n: [] for n in names}
    for _ in range(TIMED_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        d = trainer.draws_for(TRAIN_B, trainer.step_num)
        ev[1].record()
        _loss, grads, view = dense_loss_and_grads(params, batch, d, loss_fn)
        ev[2].record()
        updates = opt.update(grads, state, view)
        ev[3].record()
        apply_dense_updates(params, updates, d.salts)
        ev[4].record()
        ev[4].synchronize()
        trainer.step_num += 1
        for i, n in enumerate(names):
            split[n].append(ev[i].elapsed_time(ev[i + 1]))
    del grads, view, updates
    med = {n: sorted(v)[len(v) // 2] for n, v in split.items()}
    step_med = sorted(step_ms)[len(step_ms) // 2]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  ({label}) step {step_med:.2f} ms (median of {TIMED_STEPS}, host "
          f"clock, synchronised); by phase (CUDA events, median): " +
          ", ".join(f"{n} {ms:.3f}" for n, ms in med.items()) +
          f"; peak device memory {peak_gb:.2f} GB", flush=True)
    # kernels 2 and 3 on bf16 are mha_fwd_tc_kernel, mha_bwd_dq_tc_kernel and
    # mha_bwd_dkv_tc_kernel
    prof, busy_share, xf_ms = profile_step(
        torch, label, lambda: trainer.train_step(batch), step_med, top=8,
        name_part="mha_")
    xf_trained_readings(torch, np, trainer, data_path, batch, report)
    report[f"train_{label}"] = {
        "config": "bench.py transformer", "layers": XF_L, "heads": XF_H,
        "launches": launches, "steps": TRAIN_STEPS, "losses": losses,
        "run_s": run_s, "loss_kernel": lk, "loss_plain": lp,
        "loss_rel": loss_rel, "xf_grad_rel": grad_rel, "remat_loss": lr_,
        "remat_launches": remat_launches, "remat_grad_rel": remat_grad_rel,
        "repeated_batch_losses": fall, "step_ms": step_ms,
        "step_ms_median": step_med, "phase_ms_median": med,
        "peak_memory_gb": peak_gb, "profile": prof,
        "device_busy_share": busy_share, "xf_kernels_ms_per_step": xf_ms}
    del trainer, params, state, opt
    torch.cuda.empty_cache()
    return launches


def xf_trained_readings(torch, np, trainer, data_path, batch, report):
    """Step B: kernel 2 at a trained state of (e). The trainer trains
    XF_TRAINED_EPOCHS more epochs through `Code2VecTrainer.train`; the xf
    gradients of the kernel path against the plain path's from that
    state are printed (not bounded: the near-init check holds them to
    XF_GRAD_RTOL); each layer's q, k, v and log_mask as they reach
    `fused_mha` in one forward of `batch` are captured, and kernel 2, its
    plain version and the float64 oracle (rounded once to bf16) run on
    them. Kernel 2's o must lie within 1 bf16 ulp of the oracle on every
    element a float32 evaluation resolves (ops/xf_attention.py's
    RESOLVABLE_SHARE: on o near 0 from cancelling terms a float32 sum,
    the plain version's too, lies several ulps off; those are read, not
    bounded), and differ from it on at most twice the plain version's
    share of all the elements."""
    import code2vec_tpu_torch.models.transformer_encoder as xfe
    from code2vec_tpu_torch.ops.xf_attention import (bf16_ulp_readings,
                                                     mha_forward_fused,
                                                     mha_forward_oracle,
                                                     mha_forward_plain)
    from code2vec_tpu_torch.training.steps import (dense_loss_and_grads,
                                                   make_train_loss_fn)
    label = "e"
    step0 = trainer.step_num
    t = time.perf_counter()
    losses = trainer.train(data_path, epochs=XF_TRAINED_EPOCHS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    check(len(losses) >= 32 and all(np.isfinite(losses)),
          f"({label}) trained {len(losses)} steps: {losses[-3:]}")
    cfg = trainer.step_config
    kw = dict(use_sampled_softmax=cfg.use_sampled_softmax,
              num_sampled=cfg.num_sampled, compute_dtype=cfg.compute_dtype)
    draws = trainer.draws_for(TRAIN_B, trainer.step_num)
    _lk, grads_k, _ = dense_loss_and_grads(
        trainer.params, batch, draws, make_train_loss_fn(trainer.dims, **kw))
    _lp, grads_p, _ = dense_loss_and_grads(
        trainer.params, batch, draws,
        make_train_loss_fn(trainer.dims, use_kernel=False, **kw))
    gap = max((grads_k[k].float() - g.float()).abs().max().item()
              / max(g.float().abs().max().item(), 1e-30)
              for k, g in grads_p.items() if k.startswith("xf/"))
    del grads_k, grads_p
    print(f"  ({label}) trained {len(losses)} more steps (to step "
          f"{trainer.step_num}, from {step0}) in {train_s:.1f} s, loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; the xf gradients of the "
          f"kernel path vs the plain path from there: max|d| {gap:.4g} of "
          f"the largest (printed; near init it is held to {XF_GRAD_RTOL})",
          flush=True)
    captured = []
    real = xfe.fused_mha

    def capture(q, k, v, log_mask):
        captured.append((q.detach().clone(), k.detach().clone(),
                         v.detach().clone(), log_mask.detach().clone()))
        return real(q, k, v, log_mask)

    xfe.fused_mha = capture
    try:
        with torch.no_grad():
            make_train_loss_fn(trainer.dims, **kw)(trainer.params, batch,
                                                  draws)
    finally:
        xfe.fused_mha = real
    check(len(captured) == XF_L, f"({label}) captured {len(captured)} layers")
    layers = []
    for i, (q, k, v, m) in enumerate(captured):
        oracle = mha_forward_oracle(q, k, v, m)
        kern = bf16_ulp_readings(mha_forward_fused(q, k, v, m), *oracle)
        plain = bf16_ulp_readings(mha_forward_plain(q, k, v, m), *oracle)
        del oracle
        layers.append({"kernel": kern, "plain": plain})
        print(f"  ({label}) layer {i}, q/k/v {tuple(q.shape)} bf16: o against "
              f"the float64 oracle rounded once to bf16: kernel 2 at most "
              f"{kern['max_ulp']} ulp where float32 resolves it, "
              f"{kern['share'] * 100:.4f} % of the elements differ; the "
              f"plain version {plain['max_ulp']} ulp, "
              f"{plain['share'] * 100:.4f} %; on the "
              f"{kern['rest_share'] * 100:.3f} % of elements near 0 (|o| < "
              f"2^-7 of sum a|v|) kernel 2 {kern['max_ulp_rest']} ulp, "
              f"the plain version {plain['max_ulp_rest']}", flush=True)
        check(kern["max_ulp"] <= 1 and kern["share"] <= 2 * plain["share"],
              f"({label}) layer {i}: kernel 2 {kern} against the plain "
              f"version's {plain}")
    del captured
    torch.cuda.empty_cache()
    report["xf_trained"] = {"steps": len(losses), "train_s": train_s,
                            "grad_gap": gap, "layers": layers}


def phase_xf_eval(torch, np, vocabs, test_path, report):
    """`evaluate` of a transformer model over the test file (counted),
    then the kernel path against the plain path batch by batch."""
    from code2vec_tpu_torch.data.reader import C2VTextReader
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.training.steps import eval_step
    cfg = xf_config()
    trainer = Code2VecTrainer(cfg, vocabs)  # device=None: the card
    stretch_tables(trainer.params)
    top_k = cfg.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION
    n_batches = -(-EVAL_METHODS // cfg.TEST_BATCH_SIZE)
    trainer.evaluate(test_path)  # warm: allocator, library set-up

    # ---- the main path: counts at 0 just before, read just after ----
    zero_xf_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    results = trainer.evaluate(test_path)
    eval_s = time.perf_counter() - t
    launches = xf_counts()
    want = {"attention_pool": 0, "xf_attention_forward": XF_L * n_batches,
            "xf_attention_backward": 0}
    check(launches == want, f"xf eval launches {launches}, expected {want}")
    check(np.isfinite(results.loss) and len(results.topk_acc) == top_k,
          f"xf eval results {results}")
    rate = EVAL_METHODS / eval_s
    print(f"  evaluate: {EVAL_METHODS} methods in {n_batches} batches of "
          f"{cfg.TEST_BATCH_SIZE}, {eval_s:.3f} s ({rate:.0f} methods/s, "
          f"host parse and decode included); {results}; launches "
          f"{launches}", flush=True)

    reader = C2VTextReader(test_path, vocabs, C, cfg.TEST_BATCH_SIZE)
    loss_k = loss_p = 0.0
    same = total = 0
    with torch.inference_mode():
        for b in reader:
            batch = trainer.device_batch(b)
            kw = dict(dims=trainer.dims, top_k=top_k,
                      compute_dtype=torch.bfloat16)
            lk, ids_k, _ = eval_step(trainer.params, batch, **kw)
            lp, ids_p, _ = eval_step(trainer.params, batch, use_kernel=False,
                                     **kw)
            nv = b.num_valid_examples
            loss_k += lk.item()
            loss_p += lp.item()
            same += int((ids_k[:nv, 0] == ids_p[:nv, 0]).sum().item())
            total += nv
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    share = same / total
    check(loss_rel <= LOSS_RTOL, f"xf eval loss kernel {loss_k} plain {loss_p}")
    check(share >= EVAL_TOP1_SHARE, f"xf eval top-1 equal on {same}/{total}")
    print(f"  eval kernel path vs plain path: loss sum {loss_k:.4f} vs "
          f"{loss_p:.4f} (rel {loss_rel:.2e}); top-1 equal on {same}/{total}",
          flush=True)
    report["xf_eval"] = {
        "methods": EVAL_METHODS, "batch": cfg.TEST_BATCH_SIZE,
        "seconds": eval_s, "methods_per_s": rate, "launches": launches,
        "loss": results.loss, "topk_acc": results.topk_acc,
        "subtoken_f1": results.subtoken_f1, "loss_rel_kernel_plain": loss_rel,
        "top1_equal_share": share}
    del trainer
    torch.cuda.empty_cache()
    return launches


# ---- the command line (cli.py): train, checkpoint, resume, release ----

# epochs of the command line's main run (4 steps an epoch at TRAIN_B over
# the training file), and of the sparse and int8 round trips
CLI_EPOCHS, CLI_ROUNDTRIP_EPOCHS = 2, 1
# the loop's throughput: runs of LOOP_EPOCHS epochs timed past the first,
# infeed 2 and 0 in LOOP_PAIRS alternating pairs (text: one pair of
# TEXT_LOOP_EPOCHS, its parse ten times the step); the profiled run (cut
# from 11, 3 and 6 to make room for [25]: one pair, the order 2 then 0)
LOOP_EPOCHS, LOOP_PAIRS, TEXT_LOOP_EPOCHS, PROFILE_EPOCHS = 6, 1, 3, 2
# the resumed run against the uninterrupted one on the card: every op
# of the steps adds in a fixed order (the gathers' backward and the
# segment sum through ops/scatter.py, with no atomics;
# code2vec_tpu_torch/tools/determinism.py finds no op left that adds
# with atomics, and one step twice gives the same bits in (a)-(e)), so
# a resume is held to the JAX package's contract: every tensor of the
# final state bit-identical to the uninterrupted run's, and the last
# epoch's losses equal. A second uninterrupted run (the floor) must be
# bit-identical too; a resume whose reader replays epoch 1's order in
# epoch 2 (the control) must not be. Before the fixed order (on an H100
# 80GB HBM3 at 700 W) the floor read 0.018-0.029 in the worst tensor's
# |a - b|_2 / |b|_2 and the control 0.18, and the bounds were 0.1 and
# 1e-5 (losses).


def write_dict_file(path: str, n_examples: int, token_word=None,
                    token_count=None) -> None:
    """`.dict.c2v` histograms of the synthetic vocab: every word counted
    once, so the capped vocabularies keep every word in the order
    `synthetic_vocabs` gives them (ties keep insertion order). The token
    words and counts may be given as functions of the word's index."""
    import pickle
    word = token_word or (lambda i: f"tok{i}")
    count = token_count or (lambda i: 1)
    with open(path, "wb") as f:
        pickle.dump({word(i): count(i) for i in range(JAVA_LARGE["token"])},
                    f)
        pickle.dump({str(1000003 * i): 1 for i in range(JAVA_LARGE["path"])},
                    f)
        pickle.dump({f"m{i % 4099}|n{i}": 1
                     for i in range(JAVA_LARGE["target"])}, f)
        pickle.dump(n_examples, f)


class Recorder:
    """Wraps `Code2VecTrainer` methods for the length of a `with`: every
    trainer `from_config` makes (and its step then), each step's loss
    tensor, each evaluation's results, and a clone on the device of the
    state each `save` is called with (only the last kept)."""

    def __init__(self, torch):
        self.torch = torch
        self.made, self.steps_at_load = [], []
        self.losses, self.evals = [], []
        self.saved = None

    def __enter__(self):
        from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
        self.cls = Code2VecTrainer
        self.real = {k: getattr(Code2VecTrainer, k) for k in
                     ("from_config", "train_step", "evaluate", "save")}
        rec, real, torch = self, self.real, self.torch
        real_from = real["from_config"].__func__

        def from_config(cls, *a, **k):
            t = real_from(cls, *a, **k)
            rec.made.append(t)
            rec.steps_at_load.append(t.step_num)
            return t

        def train_step(self, batch, draws=None):
            loss = real["train_step"](self, batch, draws)
            rec.losses.append(loss)
            return loss

        def evaluate(self, *a, **k):
            res = real["evaluate"](self, *a, **k)
            rec.evals.append((self.step_num, res))
            return res

        def save(self, *a, **k):
            from code2vec_tpu_torch.training.checkpoint import map_state
            rec.saved = None
            rec.saved = (self.step_num, map_state(
                lambda t: t.detach().clone(),
                {"params": self.params, "opt_state": self.opt_state}))
            return real["save"](self, *a, **k)
        Code2VecTrainer.from_config = classmethod(from_config)
        Code2VecTrainer.train_step = train_step
        Code2VecTrainer.evaluate = evaluate
        Code2VecTrainer.save = save
        return self

    def __exit__(self, *exc):
        for k, v in self.real.items():
            setattr(self.cls, k, v)
        return False

    def loss_values(self):
        return [x.item() for x in self.losses]


def named_tensors(x, path=""):
    """[(path, tensor)] of a state tree, depth first (NamedTuple fields by
    name)."""
    if hasattr(x, "shape"):
        return [(path, x)]
    if isinstance(x, dict):
        items = x.items()
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        items = zip(x._fields, x)
    elif isinstance(x, (list, tuple)):
        items = enumerate(x)
    else:
        return []
    return [nt for k, v in items for nt in named_tensors(v, f"{path}/{k}")]


def state_diff(torch, a, b) -> dict:
    """Two state trees, tensor by tensor: how many, how many not
    bit-identical, and the worst tensor by |a - b|_2 / |b|_2 ("l2") and
    by max |a - b| / max |b| ("max"), each with its path."""
    ta, tb = named_tensors(a), named_tensors(b)
    check([p for p, _ in ta] == [p for p, _ in tb] and len(ta) > 0,
          f"state trees differ: {len(ta)} vs {len(tb)} tensors")
    out = {"tensors": len(ta), "differ": 0, "l2": 0.0, "l2_at": None,
           "max": 0.0, "max_at": None}
    for (name, x), (_, y) in zip(ta, tb):
        x = x.to(y.device)
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"{name}: {tuple(x.shape)} {x.dtype} vs {tuple(y.shape)} "
              f"{y.dtype}")
        if torch.equal(x, y):
            continue
        out["differ"] += 1
        d, y = x.float() - y.float(), y.float()
        for key, rel in (
                ("l2", d.norm().item() / max(y.norm().item(), 1e-30)),
                ("max", d.abs().max().item() / max(y.abs().max().item(),
                                                    1e-30))):
            if rel >= out[key]:
                out[key], out[f"{key}_at"] = rel, name
    return out


def loss_rel(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def count_lines(path: str) -> int:
    n = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            n += block.count(b"\n")
    return n


def check_vectors_file(np, path: str, rows: int, width: int, label: str):
    """Row count, width and finite values (of the first and last 2000
    rows) of a w2v file (with its header) or a `.vectors` file."""
    n = count_lines(path)
    check(n == rows, f"{label}: {n} lines, expected {rows}")
    with open(path) as f:
        lines = f.read().splitlines()
    body = lines[1:] if len(lines[0].split(" ")) == 2 else lines
    for ln in body[:2000] + body[-2000:]:
        vals = ln.split(" ")[-width:]
        check(len(ln.split(" ")) in (width, width + 1),
              f"{label}: a line of {len(ln.split(' '))} fields")
        check(np.isfinite(np.array(vals, dtype=np.float64)).all(),
              f"{label}: a value not finite")
    return n


def loop_window(torch, trainer, path: str, epochs: int, steps: int,
                to_last_step: bool = False):
    """steps/s of `trainer.train(path, epochs=epochs)` past its first
    epoch: the clock starts, after a synchronize, at the first step of
    epoch 2 (past the reader's open, the producer's start and the first
    batches) and stops, after a synchronize, when the call returns (its
    end: the producer's join and the losses' copy to the host), or with
    `to_last_step` when the last step's work is done (the call's
    teardown, such as stopping a metrics server, left out)."""
    real, calls, t0, t1 = trainer.train_step, [0], [], []

    def step(batch, draws=None):
        if calls[0] == steps:
            torch.cuda.synchronize()
            t0.append(time.perf_counter())
        calls[0] += 1
        loss = real(batch, draws)
        if to_last_step and calls[0] == epochs * steps:
            torch.cuda.synchronize()
            t1.append(time.perf_counter())
        return loss

    trainer.train_step = step
    try:
        trainer.train(path, epochs=epochs)
        torch.cuda.synchronize()
        if not to_last_step:
            t1.append(time.perf_counter())
    finally:
        del trainer.train_step
    check(calls[0] == epochs * steps and t0 and t1,
          f"(loop) {calls[0]} steps")
    return (epochs - 1) * steps / (t1[0] - t0[0])


# [14]'s chunked infeed: (c)'s epochs through the trainer's loop and
# the chunk (`--infeed_chunk`)
CHUNK_EPOCHS, CHUNK_G = 2, 4


def chunked_infeed_check(torch, vocabs, data_prefix, report) -> dict:
    """[14]: (c) through the trainer's loop for CHUNK_EPOCHS epochs of
    [14]'s binary shards (8 steps) at `--infeed_chunk` CHUNK_G (the
    pinned chunk ring, `PinnedChunkPut`) and at 1, each from the seed:
    the same param digests; the steps/s past the first epoch of each; the
    host-to-device copies counted (one a field a chunk). Returns the
    chunked run's kernel-1 launches (counted: once a step)."""
    from code2vec_tpu_torch.models.torch_model import (Code2VecTrainer,
                                                       TrainerBase)
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    path = data_prefix + ".train.c2v"
    spe = -(-count_lines(path) // TRAIN_B)
    puts, real = [], TrainerBase._chunk_put

    def chunk_put(self):
        puts.append(real(self))
        return puts[-1]

    runs = {}
    TrainerBase._chunk_put = chunk_put
    try:
        for g in (CHUNK_G, 1):
            _, cfg = dense_config("c", "bfloat16", False)
            cfg.INFEED_CHUNK = g
            trainer = Code2VecTrainer(cfg, vocabs)
            attention_pool_fused.launches = 0
            rate = loop_window(torch, trainer, path, CHUNK_EPOCHS, spe)
            runs[g] = {"steps_per_s": rate, "steps": trainer.step_num,
                       "launches": attention_pool_fused.launches,
                       "digests": leaf_digests(torch, trainer.params)}
            del trainer
            torch.cuda.empty_cache()
    finally:
        TrainerBase._chunk_put = real
    chunked, plain = runs[CHUNK_G], runs[1]
    copies = puts[0].copies if puts and puts[0] is not None else None
    want_copies = 6 * CHUNK_EPOCHS * -(-spe // CHUNK_G)
    check(chunked["digests"] == plain["digests"]
          and chunked["steps"] == plain["steps"] == CHUNK_EPOCHS * spe
          and chunked["launches"] == CHUNK_EPOCHS * spe
          and copies == want_copies and puts[1:] == [None],
          f"(chunked) --infeed_chunk {CHUNK_G} vs 1: digests equal "
          f"{chunked['digests'] == plain['digests']}, steps "
          f"{chunked['steps']} / {plain['steps']}, launches "
          f"{chunked['launches']}, copies {copies} (want {want_copies})")
    print(f"  (chunked) (c) {CHUNK_EPOCHS * spe} steps through the loop at "
          f"--infeed_chunk {CHUNK_G} (the pinned chunk ring): final params "
          f"bit-identical to --infeed_chunk 1 ({len(plain['digests'])} "
          f"leaves, sha256); {copies} host-to-device copies (6 fields x "
          f"{copies // 6} chunks; {6 * CHUNK_EPOCHS * spe} at 1); steps/s "
          f"past the first epoch {chunked['steps_per_s']:.2f} chunked vs "
          f"{plain['steps_per_s']:.2f} per batch; kernel 1 "
          f"{chunked['launches']} launches", flush=True)
    report["cli"]["chunked"] = {
        "chunk": CHUNK_G, "copies": copies,
        **{f"g{g}": {k: v for k, v in r.items() if k != "digests"}
           for g, r in runs.items()}}
    return {"attention_pool": chunked["launches"]}


EXPORT_CHILD = "import chip_smoke; chip_smoke.export_child()"
EXPORT_TIMEOUT_S = 600


def file_digest(path: str) -> str:
    """sha256 of a file's bytes, read in 8 MB blocks."""
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(8 << 20):
            h.update(block)
    return h.hexdigest()


def export_paths(argv) -> dict:
    """{"w2v", "t2v", "vectors"}: the files an exports command line
    writes (`--save_w2v`, `--save_t2v`, `<--test>.vectors`)."""
    argv = [str(a) for a in argv]
    return {"w2v": argv[argv.index("--save_w2v") + 1],
            "t2v": argv[argv.index("--save_t2v") + 1],
            "vectors": argv[argv.index("--test") + 1] + ".vectors"}


def export_child() -> None:
    """[14]'s exports (`python3 -c 'import chip_smoke;
    chip_smoke.export_child()' <cli argv>`): `cli.main(argv)`, then the
    sha256 of each file it wrote, so that [27] can hold its model-2
    exports to these bytes after the files are gone. Prints `EXPORT_S`
    and `EXPORT_DIGESTS <json>`; exits with cli.main's code."""
    from code2vec_tpu_torch import cli
    t = time.perf_counter()
    rc = cli.main(sys.argv[1:])
    print(f"EXPORT_S {time.perf_counter() - t}", flush=True)
    if rc == 0:
        print("EXPORT_DIGESTS " + json.dumps(
            {k: file_digest(v) for k, v in export_paths(sys.argv[1:]).items()}),
            flush=True)
    sys.exit(rc)


def start_exports(tmp, rel, test_path) -> dict:
    """[14]'s exports of the released model: `cli.main --load <rel> --test
    --export_code_vectors --save_w2v --save_t2v` in a process of its own
    (its output in a file), killed at exit if still running."""
    import atexit
    here = os.path.dirname(os.path.abspath(__file__))
    ex = {"w2v": os.path.join(tmp, "tok.w2v"),
          "t2v": os.path.join(tmp, "tgt.w2v"),
          "vectors": test_path + ".vectors",
          "log": os.path.join(tmp, "exports.log")}
    with open(ex["log"], "w") as log:
        ex["proc"] = subprocess.Popen(
            [sys.executable, "-c", EXPORT_CHILD, "--load", rel, "--test",
             test_path, "--export_code_vectors", "--save_w2v", ex["w2v"],
             "--save_t2v", ex["t2v"]], cwd=here,
            env=dict(os.environ, PYTHONPATH=here), stdout=log,
            stderr=subprocess.STDOUT)
    atexit.register(lambda p=ex["proc"]: p.poll() is None and p.kill())
    return ex


def finish_exports(np, vocabs, kept, report) -> None:
    """[14]'s exports, waited for: exit 0, then the rows, widths and
    finite values of the w2v, t2v and code-vector files, whose sha256s
    (the child's) [27]'s model-2 exports are held to."""
    ex = kept["exports"]
    t = time.perf_counter()
    rc = ex["proc"].wait(timeout=EXPORT_TIMEOUT_S)
    waited = time.perf_counter() - t
    with open(ex["log"]) as f:
        log = f.read()
    line = next((ln for ln in log.splitlines()
                 if ln.startswith("EXPORT_S ")), None)
    digests = next((ln for ln in log.splitlines()
                    if ln.startswith("EXPORT_DIGESTS ")), None)
    check(rc == 0 and line is not None and digests is not None,
          f"(exports) exit {rc}: {log[-3000:]}")
    ex["digests"] = json.loads(digests[len("EXPORT_DIGESTS "):])
    check_vectors_file(np, ex["w2v"], vocabs.token_vocab.size + 1, E, "w2v")
    check_vectors_file(np, ex["t2v"], vocabs.target_vocab.size + 1, D, "t2v")
    check_vectors_file(np, ex["vectors"], kept["n_test"], D, "vectors")
    export_s = float(line.split()[1])
    print(f"  (exports, [14]'s released model) w2v {vocabs.token_vocab.size}"
          f" x {E}, t2v {vocabs.target_vocab.size} x {D}, {kept['n_test']} "
          f"code vectors x {D}, finite; the command line took {export_s:.1f}"
          f" s beside [15]-[18] (waited {waited:.1f} s for it)", flush=True)
    report["cli"].update(export_s=export_s, export_waited_s=waited)
    for key in ("w2v", "t2v", "vectors"):
        os.remove(ex[key])


def phase_cli(torch, np, vocabs, tmp, data_prefix, test_path, report):
    """The command line through `cli.main([...])` in this process at
    java-large width; returns the launches of its counted runs."""
    import shutil

    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data import binarize
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.ops.requant_kernel import requantize_fused
    from code2vec_tpu_torch.ops.sparse_update_kernel import (
        sparse_requant_adam_fused, sparse_row_adam_fused)
    from code2vec_tpu_torch.training import checkpoint as ckpt

    def counters_zero():
        for k in (attention_pool_fused, requantize_fused,
                  sparse_row_adam_fused, sparse_requant_adam_fused):
            k.launches = 0

    def counters():
        return {"attention_pool": attention_pool_fused.launches,
                "requantize": requantize_fused.launches,
                "sparse_row_adam": sparse_row_adam_fused.launches,
                "sparse_requant_adam": sparse_requant_adam_fused.launches}

    def cli_run(label, *argv):
        t = time.perf_counter()
        rc = cli.main([str(a) for a in argv])
        torch.cuda.synchronize()
        check(rc == 0, f"({label}) cli.main exited {rc}")
        return time.perf_counter() - t

    out = {}
    n_train = count_lines(data_prefix + ".train.c2v")
    n_test = count_lines(test_path)
    steps = -(-n_train // TRAIN_B)
    check(steps >= 4, f"{steps} steps an epoch")
    # ---- 1. the .dict.c2v and the binary shards ----
    t = time.perf_counter()
    write_dict_file(data_prefix + ".dict.c2v", n_train)
    dict_s = time.perf_counter() - t
    t = time.perf_counter()
    binarize.main(["--data", data_prefix, "--max_contexts", str(C)])
    bin_s = time.perf_counter() - t
    print(f"  .dict.c2v written in {dict_s:.1f} s; binarize (the port's) "
          f"{bin_s:.1f} s; {n_train} training, {n_test} test methods",
          flush=True)
    base = ["--data", data_prefix, "--test", test_path, "--batch_size",
            TRAIN_B, "--max_contexts", C, "--epochs", CLI_EPOCHS,
            "--infeed_prefetch", 2]
    ck = os.path.join(tmp, "ckpt")

    # ---- 2. train with --save and --test (the main path) ----
    with Recorder(torch) as rec:
        counters_zero()
        run_s = cli_run("train", *base, "--save", ck)
        launches = counters()
    trained = rec.made[-1]
    first_losses = rec.loss_values()
    want_steps = CLI_EPOCHS * steps
    check(len(first_losses) == want_steps and all(np.isfinite(first_losses))
          and trained.step_num == want_steps, f"(train) {len(first_losses)} "
          f"steps to step {trained.step_num}: {first_losses}")
    want = {"attention_pool": want_steps + CLI_EPOCHS * -(-n_test // TRAIN_B),
            "requantize": 0, "sparse_row_adam": 0, "sparse_requant_adam": 0}
    check(launches == want, f"(train) launches {launches}, expected {want}")
    check([s for s, _ in ckpt._step_dirs(ck)]
          == [steps * (e + 1) for e in range(CLI_EPOCHS)],
          f"(train) step dirs {ckpt._step_dirs(ck)}")
    evals = {step: res for step, res in rec.evals}
    for step, res in rec.evals:
        check(np.isfinite(res.loss) and 0 <= res.subtoken_f1 <= 1,
              f"(train) evaluation at step {step}: {res}")
    print(f"  (train) cli.main {CLI_EPOCHS} epochs x {steps} steps in "
          f"{run_s:.1f} s; losses {', '.join(f'{x:.4f}' for x in first_losses)}"
          f"; launches {launches}", flush=True)
    for step, res in rec.evals:
        print(f"  (train) evaluation at step {step}: {res}", flush=True)

    # ---- 3. the reloaded latest step is the state at save time ----
    last = ckpt.latest_step(ck)
    check(rec.saved is not None and rec.saved[0] == last,
          f"(train) last save {rec.saved and rec.saved[0]} vs {last}")
    for s_, _d in ckpt._step_dirs(ck):
        check(ckpt.verify_step(ck, s_) is True, f"checksums of step {s_}")
    t = time.perf_counter()
    loaded = ckpt.load_checkpoint(ck)
    load_s = time.perf_counter() - t
    diff = state_diff(torch, {"params": loaded["params"],
                              "opt_state": loaded["opt_state"]}, rec.saved[1])
    n_t = diff["tensors"]
    check(diff["differ"] == 0 and loaded["step"] == last,
          f"(reload) {diff['differ']} of {n_t} tensors differ from the state "
          f"at save")
    state_bytes = os.path.getsize(os.path.join(
        ck, f"step_{last}", "state", ckpt.STATE_FILE))
    print(f"  (reload) step {last}: {n_t} tensors bit-identical to the "
          f"trainer's at save time; checksums verify; {state_bytes / 1e9:.3f}"
          f" GB, loaded and verified in {load_s:.2f} s", flush=True)
    del loaded, rec, trained

    # ---- 4. resume: the last step set aside, the same command rerun ----
    # beside it, the noise floor (the uninterrupted command again) and the
    # control (the resume with its reader's epoch offset forced to 0)
    import code2vec_tpu_torch.models.torch_model as torch_model
    aside = os.path.join(tmp, "aside")
    os.makedirs(aside)
    shutil.move(os.path.join(ck, f"step_{last}"), aside)
    ck_wrong, ck_floor = os.path.join(tmp, "ckpt_wrong"), os.path.join(
        tmp, "ckpt_floor")
    shutil.copytree(ck, ck_wrong)
    topo = ckpt.load_step_topology(ck, ckpt.latest_step(ck))
    with Recorder(torch) as rec:
        resume_s = cli_run("resume", *base, "--save", ck, "--auto_resume")
    resumed_from = rec.steps_at_load[-1]
    resumed_losses = rec.loss_values()
    check(resumed_from == last - steps and topo["epoch"] == CLI_EPOCHS - 1,
          f"(resume) restored step {resumed_from}, topology {topo}")
    check(len(resumed_losses) == steps and rec.made[-1].step_num == last,
          f"(resume) {len(resumed_losses)} steps to {rec.made[-1].step_num}")
    del rec
    real_open = torch_model.open_reader
    torch_model.open_reader = lambda *a, **k: real_open(
        *a, **dict(k, epoch_offset=0) if "epoch_offset" in k else k)
    try:
        with Recorder(torch) as rec:
            cli_run("control", *base, "--save", ck_wrong, "--auto_resume")
    finally:
        torch_model.open_reader = real_open
    wrong_losses = rec.loss_values()
    check(len(wrong_losses) == steps and rec.made[-1].step_num == last,
          f"(control) {len(wrong_losses)} steps to {rec.made[-1].step_num}")
    del rec
    with Recorder(torch) as rec:
        cli_run("floor", *base, "--save", ck_floor)
    floor_losses = rec.loss_values()
    del rec
    b = ckpt.load_checkpoint(aside)
    resume = {}
    for name, d, losses in (("resume", ck, resumed_losses),
                            ("floor", ck_floor, floor_losses[-steps:]),
                            ("control", ck_wrong, wrong_losses)):
        a = ckpt.load_checkpoint(d)
        check(a["step"] == b["step"] == last, f"({name}) step {a['step']}")
        resume[name] = {**state_diff(torch, a, b),
                        "loss_rel": loss_rel(losses, first_losses[-steps:])}
        del a
        r = resume[name]
        print(f"  ({name}) final state: {r['differ']} of {r['tensors']} "
              f"tensors not bit-identical; the worst |a - b|_2 / |b|_2 "
              f"{r['l2']:.3g} ({r['l2_at']}), max |a - b| / max |b| "
              f"{r['max']:.3g} ({r['max_at']}); the last {steps} losses "
              f"within {r['loss_rel']:.2e} of the uninterrupted run's",
              flush=True)
    del b
    print(f"  (resume) --auto_resume in {resume_s:.1f} s: restored step "
          f"{resumed_from} (epoch offset {topo['epoch']}), {steps} steps to "
          f"step {last}; held to the same bits", flush=True)
    for name in ("resume", "floor"):
        check(resume[name]["differ"] == 0 and resume[name]["loss_rel"] == 0,
              f"({name}) not bit-identical to the uninterrupted run: "
              f"{resume[name]}")
    check(resume["control"]["differ"] > 0
          and resume["control"]["loss_rel"] > 0,
          f"(control) a resume in the wrong epoch order is bit-identical: "
          f"{resume['control']}")
    # the uninterrupted run's last step (`aside`) stays for [16]
    for d in (ck_wrong, ck_floor):
        shutil.rmtree(d)

    # ---- 5. a flipped byte: quarantine, and the step before ----
    path = os.path.join(ck, f"step_{last}", "state", ckpt.STATE_FILE)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x01]))
    logs = []
    t = time.perf_counter()
    fallback = ckpt.load_checkpoint(ck, log=logs.append)
    quarantine_s = time.perf_counter() - t
    check(fallback["step"] == last - steps and ckpt.latest_step(ck)
          == last - steps and os.path.isdir(os.path.join(
              ck, "quarantine", f"step_{last}")),
          f"(corrupt) loaded step {fallback['step']}, latest "
          f"{ckpt.latest_step(ck)}: {logs}")
    print(f"  (corrupt) one byte of step {last} flipped: quarantined, the "
          f"load fell back to step {fallback['step']} in {quarantine_s:.2f} s",
          flush=True)
    del fallback
    shutil.rmtree(os.path.join(ck, "quarantine"))

    # ---- 6. release, then --load <released> --test and the exports ----
    rel = os.path.join(tmp, "released")
    release_s = cli_run("release", "--load", ck, "--release", "--save", rel)
    check(ckpt.load_manifest(rel)["released"] is True and
          ckpt.latest_step(rel) == last - steps, "(release) manifest / step")
    # the exports' %.6f text of the java-large tables takes about two
    # minutes of one host core: the command line writes them in a
    # process of its own while [15]-[18] run, and `finish_exports` waits
    # for it and checks the files
    exports = start_exports(tmp, rel, test_path)
    with Recorder(torch) as rec:
        eval_s = cli_run("released", "--load", rel, "--test", test_path)
    pre = evals[last - steps]
    post = rec.evals[-1][1]
    check((post.topk_acc, post.subtoken_precision, post.subtoken_recall,
           post.subtoken_f1, post.loss) ==
          (pre.topk_acc, pre.subtoken_precision, pre.subtoken_recall,
           pre.subtoken_f1, pre.loss),
          f"(release) evaluation {post} vs before the release {pre}")
    print(f"  (release) in {release_s:.1f} s; --load <released> --test: "
          f"the same evaluation as before the release ({post}) in "
          f"{eval_s:.1f} s; the exports run beside the next phases",
          flush=True)
    del rec

    # ---- 7. one-epoch round trips: --sparse_embeddings, --tables_dtype int8
    trips = {}
    for label, flags, counter, per_step in (
            ("sparse", ["--sparse_embeddings", "--embedding_optimizer", "adam",
                        "--lr_schedule", "constant"], "sparse_row_adam", 2),
            ("int8", ["--tables_dtype", "int8"], "requantize", 2)):
        d = os.path.join(tmp, f"ckpt_{label}")
        with Recorder(torch) as rec:
            counters_zero()
            trip_s = cli_run(label, "--data", data_prefix, "--batch_size",
                             TRAIN_B, "--max_contexts", C, "--epochs",
                             CLI_ROUNDTRIP_EPOCHS, "--save", d, *flags)
            trip_launches = counters()
        check(trip_launches[counter] == per_step * steps
              * CLI_ROUNDTRIP_EPOCHS, f"({label}) launches {trip_launches}")
        saved = rec.saved[1]
        del rec
        t = time.perf_counter()
        cfg = Config.load_from_args(["--load", d])
        back = Code2VecTrainer.from_config(cfg, vocabs=vocabs)
        reload_s = time.perf_counter() - t
        diff = state_diff(
            torch, {"params": back.params, "opt_state": back.opt_state}, saved)
        n_t = diff["tensors"]
        check(diff["differ"] == 0, f"({label}) {diff['differ']} of {n_t} "
              f"tensors differ after the reload")
        size = os.path.getsize(os.path.join(
            d, f"step_{back.step_num}", "state", ckpt.STATE_FILE))
        print(f"  ({label}) {CLI_ROUNDTRIP_EPOCHS} epoch in {trip_s:.1f} s, "
              f"launches {trip_launches}; --load: {n_t} tensors bit-identical"
              f" ({size / 1e9:.3f} GB state, loaded in {reload_s:.1f} s)",
              flush=True)
        trips[label] = {"launches": trip_launches, "seconds": trip_s,
                        "state_bytes": size, "reload_s": reload_s,
                        "tensors": n_t}
        del back, saved
        torch.cuda.empty_cache()
        shutil.rmtree(d)
    shutil.rmtree(ck)

    # ---- 8. the loop's numbers on the default configuration ----
    cfg = Config(MAX_CONTEXTS=C, TRAIN_BATCH_SIZE=TRAIN_B, SEED=SEED,
                 NUM_TRAIN_EPOCHS=1)
    trainer = Code2VecTrainer(cfg, vocabs)
    text_dir = os.path.join(tmp, "text")
    os.makedirs(text_dir)
    text_path = os.path.join(text_dir, "java.train.c2v")
    shutil.copy(data_prefix + ".train.c2v", text_path)
    bin_path = data_prefix + ".train.c2v"
    trainer.train(bin_path, epochs=1)  # warm: allocator, libraries
    _, cfg_a = train_config("a", "bfloat16", True)
    trainer_a = Code2VecTrainer(cfg_a, vocabs)
    trainer_a.train(bin_path, epochs=1)
    loop = {}
    for name, tr, path, epochs, pairs in (
            ("c_binary", trainer, bin_path, LOOP_EPOCHS, LOOP_PAIRS),
            ("a_binary", trainer_a, bin_path, LOOP_EPOCHS, LOOP_PAIRS),
            ("c_text", trainer, text_path, TEXT_LOOP_EPOCHS, 1)):
        runs = {2: [], 0: []}
        for pair in range(pairs):  # 2 0, 0 2, 2 0, ...
            for depth in ((2, 0) if pair % 2 == 0 else (0, 2)):
                tr.config.INFEED_PREFETCH = depth
                runs[depth].append(loop_window(torch, tr, path, epochs,
                                               steps))
        loop[name] = {"window_steps": (epochs - 1) * steps, **{
            f"prefetch{d}": {"steps_per_s": v, "methods_per_s": [
                x * n_train / steps for x in v]} for d, v in runs.items()}}
        print(f"  (loop) {name}, epochs 2..{epochs} ({(epochs - 1) * steps} "
              f"steps) of each run, steps/s over {pairs} alternating "
              f"pair(s): " + "; ".join(
                  f"prefetch {d}: " + ", ".join(f"{x:.2f}" for x in v)
                  + f" (median {sorted(v)[len(v) // 2] * n_train / steps:.0f}"
                  f" methods/s)" for d, v in runs.items()), flush=True)
    cfg.INFEED_PREFETCH = cfg_a.INFEED_PREFETCH = 2
    del trainer_a
    torch.cuda.empty_cache()
    prof = profile_calls(
        torch, lambda: trainer.train(bin_path, epochs=PROFILE_EPOCHS), 1)
    pool_names = POOL_KERNELS["bfloat16"]
    if prof is None:
        busy = pool_prof = None
    else:
        busy = prof["busy_ms"] / prof["wall_ms"]
        # printed, not checked: the wrapper's counter is the exact count,
        # and a trace that drops an event also understates the busy share
        pool_prof = {k: sum(c for n, c in prof["kernel_launches"].items()
                            if k in n) for k in pool_names}
    print(f"  (loop) profiled run ({PROFILE_EPOCHS} epochs, "
          f"{PROFILE_EPOCHS * steps} steps, binary, prefetch 2, reader and "
          f"thread set-up included): device busy "
          f"{fmt_ms(prof and prof['busy_ms'])} of {fmt_ms(prof and prof['wall_ms'])}"
          f" ms = {'not measured' if busy is None else f'{busy:.3f}'}; "
          f"kernel 1's launches in the trace by name {pool_prof} (the "
          f"wrapper counted {PROFILE_EPOCHS * steps})", flush=True)
    saves = {}
    for mode in ("async", "sync"):
        cfg.ASYNC_CHECKPOINT = mode == "async"
        d = os.path.join(tmp, f"save_{mode}")
        trainer.save(d, block=False)
        blocked = trainer.save_blocked_ms
        t = time.perf_counter()
        if trainer._ckpt_writer is not None:
            trainer._ckpt_writer.wait()
        drain = (time.perf_counter() - t) * 1e3
        total = (trainer._ckpt_writer.last_total_ms if mode == "async"
                 else blocked)
        t = time.perf_counter()
        ckpt.write_step_checksums(d, trainer.step_num)
        sha_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        back = ckpt.load_checkpoint(d)
        load_ms = (time.perf_counter() - t) * 1e3
        size = os.path.getsize(os.path.join(
            d, f"step_{trainer.step_num}", "state", ckpt.STATE_FILE))
        saves[mode] = {"blocked_ms": blocked, "writer_total_ms": total,
                       "wait_ms": drain, "state_bytes": size,
                       "sha256_ms": sha_ms, "load_verify_ms": load_ms}
        del back
        shutil.rmtree(d)
    print("  (save) " + "; ".join(
        f"{k}: loop blocked {v['blocked_ms']:.1f} ms, writer {v['writer_total_ms']:.0f}"
        f" ms, {v['state_bytes'] / 1e9:.3f} GB, sha256 {v['sha256_ms']:.0f} ms, "
        f"load + verify {v['load_verify_ms']:.0f} ms" for k, v in saves.items()),
        flush=True)
    trainer.close_session()
    del trainer
    torch.cuda.empty_cache()
    out.update({"steps_per_epoch": steps, "dict_s": dict_s,
                "binarize_s": bin_s, "train_s": run_s, "launches": launches,
                "losses": first_losses,
                "evals": {str(k): v.__dict__ if hasattr(v, "__dict__")
                          else str(v) for k, v in evals.items()},
                "state_bytes": state_bytes, "load_s": load_s,
                "resume_s": resume_s, "resume": resume,
                "quarantine_s": quarantine_s, "release_s": release_s,
                "released_eval_s": eval_s, "round_trips": trips,
                "loop": loop,
                "device_busy_share": busy, "pool_launches_profiled": pool_prof,
                "saves": saves})
    report["cli"] = out
    # the released model for [15]; the uninterrupted run's final state
    # and losses for [16]
    kept = {"released": rel, "uninterrupted": aside,
            "losses": first_losses, "steps": steps, "base": base,
            "exports": exports, "n_test": n_test, "test_path": test_path}
    return {"train": launches,
            **{k: v["launches"] for k, v in trips.items()}}, kept


# ---- [15] the REPL, [16] the trainer observed and faulted ----

# [15]: Enters fed to the REPL before `q`; kernel 1's bound on a
# probability, the end-to-end tolerance of the kernel path against the
# plain path where two top-1 names differ
REPL_ENTERS, REPL_PROB_TOL = 3, 1e-4
# [16]: the loop timed with the telemetry, the trace and the watchdog on
# against all off, runs of TELE_LOOP_EPOCHS epochs timed past the first, in
# TELE_LOOP_PAIRS pairs (one since [30] needed the time; ten until [25], as
# a 5 % difference is within one call's spread of (a)'s host-bound loop),
# the order within a pair alternating by pair, by label and by call
# (ORDER_FLIP); the watchdog's deadline
TELE_LOOP_EPOCHS, TELE_LOOP_PAIRS, WATCHDOG_S = 6, 1, 120
# one coin for the call: with one pair a label, which arm of [16]'s and
# [17]'s on/off pairs runs first, so the order's effect averages out
# over calls (printed beside each pair)
ORDER_FLIP = os.urandom(1)[0] & 1


def repl_blocks(lines):
    """The REPL's printed methods: [(name, [(probability, predicted)],
    attention lines, latency line)] in order."""
    out, cur = [], None
    for ln in lines:
        if ln.startswith("Original name:"):
            cur = [ln.split("\t", 1)[1], [], 0, None]
            out.append(cur)
        elif cur is not None and ln.startswith("\t("):
            prob, name = ln[2:].split(") predicted: ", 1)
            cur[1].append((float(prob), name))
        elif cur is not None and "\tcontext: " in ln:
            cur[2] += 1
        elif ln.startswith("latency: "):
            for blk in out:
                if blk[3] is None:
                    blk[3] = ln
    return out


def request_ms(latency_line: str) -> float:
    """The request time of a REPL latency line."""
    return float(latency_line.split("latency: request ", 1)[1].split(" ", 1)[0])


def phase_repl(torch, np, tmp, kept, report):
    """[15]: the native extractor built and checked against the golden
    files, `--predict` as a subprocess, the REPL in this process with
    kernel 1 counted and its names held against the plain path, the
    Python frontend, and an extractor crash survived."""
    import shutil
    import unittest.mock

    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.extractor import native
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.resilience import faults
    from code2vec_tpu_torch.serving import interactive_predict
    from code2vec_tpu_torch.serving.extractor import Extractor, ExtractorError
    from code2vec_tpu_torch.serving.server import PredictionServer
    from code2vec_tpu_torch.training.steps import predict_step

    repo = os.path.dirname(os.path.abspath(__file__))
    out = {}
    # ---- the extractor (built in [2]), then the golden files
    binary = native.binary_path()
    built = report["extractor_build_s"]
    out["extractor_build_s"] = max(built.values())
    bin_s, lib_s = built["c2v_extract"], built["libc2v.so"]
    golden = os.path.join(repo, "tests", "golden")
    for name in ("Example.java", "Hard.java"):
        r = subprocess.run([binary, "--file", os.path.join(golden, name)],
                           capture_output=True, text=True, timeout=120)
        with open(os.path.join(golden, name + ".expected")) as f:
            want = f.read()
        check(r.returncode == 0 and r.stdout == want,
              f"(extractor) c2v_extract --file {name} differs from "
              f"{name}.expected (exit {r.returncode}): {r.stderr[-500:]}")
    print(f"  extractor built from the port's sources in [2] "
          f"(c2v_extract {bin_s:.1f} s, libc2v.so {lib_s:.1f} s, beside "
          f"the kernels); "
          f"c2v_extract --file on Example.java and Hard.java equals their "
          f".expected", flush=True)

    # ---- --predict as a subprocess: three Enters, then q ----
    work = os.path.join(tmp, "repl")
    os.makedirs(work)
    shutil.copy(os.path.join(repo, "Input.java"), work)
    rel = kept["released"]
    t = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "code2vec_tpu_torch", "--load", rel,
         "--predict"], cwd=work,
        input="\n" * REPL_ENTERS + "attack\nq\n",
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=repo))
    out["subprocess_s"] = time.perf_counter() - t
    check(r.returncode == 0, f"(repl) --predict exited {r.returncode}: "
          f"{r.stderr[-2000:]}")
    _names, java_lines = Extractor(Config()).extract_paths(
        os.path.join(work, "Input.java"))
    n_methods = len(java_lines)
    blocks = repl_blocks(r.stdout.splitlines())
    check(len(blocks) == REPL_ENTERS * n_methods,
          f"(repl) {len(blocks)} methods printed for {REPL_ENTERS} requests "
          f"of {n_methods}")
    for name, preds, n_attn, latency in blocks:
        check(len(preds) in (TOP_K - 1, TOP_K) and all(
            0 <= p <= 1 and np.isfinite(p) for p, _n in preds),
            f"(repl) {name}: predictions {preds}")
        check(1 <= n_attn <= interactive_predict.SHOW_TOP_CONTEXTS,
              f"(repl) {name}: {n_attn} attention lines")
        check(latency is not None, f"(repl) {name}: no latency line")
    check(r.stdout.rstrip().endswith("Exiting..."), "(repl) no exit line")
    check(any(ln.startswith(("[untargeted ", "Attack error:"))
              for ln in r.stdout.splitlines()), "(repl) no attack answer")
    # [28]'s --predict pair is held against this output
    kept["repl_stdout"] = r.stdout
    req_ms = [request_ms(blocks[i * n_methods][3])
              for i in range(REPL_ENTERS)]
    out.update({"requests_ms": req_ms, "first_ms": req_ms[0],
                "cached_p50_ms": float(np.median(req_ms[1:]))})
    print(f"  python3 -m code2vec_tpu_torch --load <[14]'s released model> "
          f"--predict: exit 0 in {out['subprocess_s']:.1f} s, {n_methods} "
          f"methods a request, request ms {', '.join(f'{x:.1f}' for x in req_ms)}"
          f"; the first (extract + device) {req_ms[0]:.1f} ms, the cached "
          f"p50 {out['cached_p50_ms']:.2f} ms", flush=True)

    # ---- the REPL in this process: kernel 1 counted, names vs plain ----
    cfg = Config.load_from_args(["--load", rel])
    trainer = Code2VecTrainer.from_config(cfg)
    model = trainer.predictor()
    keys = iter([""] * REPL_ENTERS + ["q"])
    repl = interactive_predict.InteractivePredictor(cfg, model)
    printed = []

    def run_repl():
        with unittest.mock.patch("builtins.input", lambda *a: next(keys)), \
                unittest.mock.patch("builtins.print",
                                    lambda *a, **k: printed.append(
                                        " ".join(map(str, a)))):
            repl.predict(os.path.join(work, "Input.java"))

    from torch.profiler import ProfilerActivity, profile
    attention_pool_fused.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_repl()
        torch.cuda.synchronize()
    launches = {"attention_pool": attention_pool_fused.launches}
    batches = repl.server.batches
    check(batches >= 1 and launches["attention_pool"] == batches,
          f"(repl) kernel 1 launched {launches['attention_pool']} times for "
          f"{batches} device batches")
    cuda_events = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    # printed, not checked (the wrapper's counter is the count): the
    # batcher thread's launches may not reach the trace
    named = {k: sum(k in n for n in cuda_events)
             for k in POOL_KERNELS["bfloat16"]} if cuda_events else None
    got = repl_blocks(printed)[:n_methods]

    def plain_step(batch):
        with torch.inference_mode():
            return predict_step(plain.params, batch, dims=plain.dims,
                                top_k=plain.top_k,
                                compute_dtype=plain.compute_dtype,
                                use_kernel=False)
    plain = trainer.predictor()
    plain._run_step = plain_step
    with PredictionServer(cfg, plain) as server:
        want = server.predict_lines(java_lines, deadline_ms=0)
    n_equal = 0
    for (name, preds, _a, _l), w in zip(got, want):
        check(name == w.original_name, f"(repl) {name} vs {w.original_name}")
        w_top = (w.predictions[0]["probability"],
                 str(w.predictions[0]["name"]))
        if preds[0][1] == w_top[1]:
            n_equal += 1
        else:
            check(abs(preds[0][0] - w_top[0]) <= REPL_PROB_TOL,
                  f"(repl) {name}: top-1 {preds[0]} vs the plain path's "
                  f"{w_top}, beyond {REPL_PROB_TOL}")
    print(f"  the REPL in this process under torch.profiler: kernel 1 "
          f"launched {launches['attention_pool']} times for {batches} device "
          f"batch(es) (by name in the trace of {len(cuda_events)} CUDA "
          f"events: {'not measured' if named is None else named}); top-1 "
          f"names equal to "
          f"the plain path's on {n_equal} of {n_methods} methods (the others "
          f"within {REPL_PROB_TOL})", flush=True)

    # ---- the Python frontend, and an extractor crash survived ----
    py = os.path.join(work, "demo.py")
    with open(py, "w") as f:
        f.write("def read_all_lines(path):\n    with open(path) as f:\n"
                "        return [ln.strip() for ln in f]\n")
    with PredictionServer(cfg, model) as server:
        res = server.predict_file(py, deadline_ms=0, language="python")
    check(len(res) == 1 and res[0].original_name == "read|all|lines" and
          len(res[0].predictions) >= TOP_K - 1,
          f"(python) {[(x.original_name, len(x.predictions)) for x in res]}")
    faults.install({"sites": {"serve/extract": {"action": "raise"}}},
                   log=lambda _m: None)
    try:
        with PredictionServer(cfg, model) as server:
            try:
                server.predict_file(os.path.join(work, "Input.java"),
                                    deadline_ms=0)
                check(False, "(crash) the injected extractor crash passed")
            except ExtractorError as e:
                crash = str(e)
            pool = server.extractor_pool()
            pool.restart_thread.join(timeout=60)
            check(not pool.restarting, "(crash) the pool did not restart")
            after = server.predict_file(os.path.join(work, "Input.java"),
                                        deadline_ms=0)
            check(len(after) == n_methods, "(crash) no results after restart")
    finally:
        faults.clear()
    print(f"  Extractor(language=\"python\") through the server: "
          f"{res[0].original_name} -> {res[0].predictions[0]['name']}; "
          f"serve/extract raise: the request failed with ExtractorError "
          f"({crash!r}), the pool restarted, the next request answered "
          f"{len(after)} methods", flush=True)
    del trainer, model, plain
    torch.cuda.empty_cache()
    out.update({"methods": n_methods, "launches": launches,
                "device_batches": batches, "launches_by_name": named,
                "top1_equal": n_equal})
    report["repl"] = out
    return launches


def run_events(tele_dir: str):
    """The events of each run under a telemetry dir, oldest first."""
    runs = []
    for name in sorted(os.listdir(tele_dir)):
        with open(os.path.join(tele_dir, name, "events.jsonl")) as f:
            runs.append([json.loads(ln) for ln in f])
    return runs


def report_tools_check(tele: str, n_spans: int) -> None:
    """[16]'s run record through the port's report tools
    (`tools/telemetry_report.py`, `tools/trace_report.py`): the headline
    table's step row, the critical-path tables, and the Chrome trace
    (its complete events one a span); their event counts printed."""
    import contextlib
    import io

    from code2vec_tpu_torch.tools import telemetry_report, trace_report
    t = time.perf_counter()
    runs = telemetry_report.find_runs(tele)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = telemetry_report.main([tele])
    text = buf.getvalue()
    path = os.path.join(tele, "trace.json")
    n_events = trace_report.write_chrome_trace(runs, path)
    with open(path) as f:
        chrome = json.load(f)["traceEvents"]
    complete = sum(e.get("ph") == "X" for e in chrome)
    table = trace_report.render(trace_report.load_spans(runs))
    check(rc == 0 and "| Config |" in text and "vs V100" not in text
          and n_events == len(chrome) and complete == n_spans
          and "infeed_wait" in table,
          f"(observed) the report tools: exit {rc}, {n_events} Chrome "
          f"events, {complete} complete of {n_spans} spans")
    print(f"  (observed) the run record through the port's report tools in "
          f"{time.perf_counter() - t:.2f} s: telemetry_report "
          f"{len(text.splitlines())} lines, trace_report's Chrome trace "
          f"{n_events} events ({complete} spans, "
          f"{sum(e.get('ph') in ('s', 'f') for e in chrome)} flow ends), "
          f"{len(table.splitlines())} lines of critical paths", flush=True)


def phase_observed(torch, np, vocabs, tmp, data_prefix, test_path, kept,
                   report):
    """[16]: the command line with the telemetry, the trace, the
    watchdog and the profiler window on (c)'s configuration and [14]'s
    data; the `ckpt/write` and `train/nan_loss` failpoints; then the
    telemetry's cost on the loop of (c) and (a). Its `train/kill` leg
    runs beside [19] (`start_kill_resume`)."""
    import errno
    import shutil

    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.resilience import retry
    from code2vec_tpu_torch.training import checkpoint as ckpt

    steps, base = kept["steps"], [str(a) for a in kept["base"]]
    n_test = count_lines(test_path)
    out = {}

    def cli_run(label, *argv):
        t = time.perf_counter()
        rc = cli.main([str(a) for a in argv])
        torch.cuda.synchronize()
        check(rc == 0, f"({label}) cli.main exited {rc}")
        return time.perf_counter() - t

    # ---- 1. telemetry, trace, watchdog and profiler (the main path) ----
    tele, prof_dir = os.path.join(tmp, "tele"), os.path.join(tmp, "prof")
    real_load = Config.load_from_args.__func__

    def load_logging_every_epoch(cls, args=None):
        # the memory gauges ride the progress log's cadence: once an epoch
        cfg = real_load(cls, args)
        cfg.NUM_BATCHES_TO_LOG_PROGRESS = steps
        return cfg
    Config.load_from_args = classmethod(load_logging_every_epoch)
    try:
        attention_pool_fused.launches = 0
        run_s = cli_run("observed", *base, "--save", os.path.join(tmp, "ck16"),
                        "--telemetry_dir", tele, "--trace",
                        "--watchdog_stall_s", WATCHDOG_S, "--profile",
                        prof_dir, "--profile_steps", 2)
        launches = {"attention_pool": attention_pool_fused.launches}
    finally:
        Config.load_from_args = classmethod(real_load)
    want_pool = CLI_EPOCHS * (steps + -(-n_test // TRAIN_B))
    check(launches["attention_pool"] == want_pool,
          f"(observed) kernel 1 launched {launches} times, expected {want_pool}")
    (events,) = run_events(tele)
    step_ev = [e for e in events if e["kind"] == "step"]
    check([e["step"] for e in step_ev] == list(range(1, CLI_EPOCHS * steps + 1))
          and all(np.isfinite(e["loss"]) and e["step_ms"] > 0
                  and e["infeed_wait_ms"] >= 0 for e in step_ev),
          f"(observed) step events {step_ev}")
    mem = {e["name"]: e["value"] for e in events if e["kind"] == "gauge"
           and e["name"].startswith("device/")}
    check(set(mem) == {"device/bytes_in_use", "device/peak_bytes_in_use"}
          and all(v > 0 for v in mem.values()), f"(observed) gauges {mem}")
    evals = [e for e in events if e["kind"] == "eval"]
    check([e["epoch"] for e in evals] == list(range(1, CLI_EPOCHS + 1)),
          f"(observed) eval events {evals}")
    summary = events[-1]
    check(summary["kind"] == "summary" and all(
        summary["timers"]["train/step_ms"][f"p{p}_ms"] > 0
        for p in (50, 95, 99)), f"(observed) summary {summary}")
    spans = [e for e in events if e["kind"] == "span"]
    produce = {e["span"] for e in spans if e["name"] == "infeed/produce"}
    linked = [e for e in spans if e["name"] == "train/step"
              and any(s in produce for _t, s in e.get("links", []))]
    check(len(linked) == CLI_EPOCHS * steps,
          f"(observed) {len(linked)} train/step spans linked to "
          f"infeed/produce")
    stalls = [e for e in events if e["kind"] == "stall"]
    dumps = [n for n in os.listdir(os.path.join(tele, os.listdir(tele)[0]))
             if n.startswith("stall_dump")]
    check(not stalls and not dumps, f"(observed) the watchdog fired: {stalls}")
    traces = os.listdir(prof_dir)
    check(len(traces) == 1, f"(observed) profile dir {traces}")
    with open(os.path.join(prof_dir, traces[0])) as f:
        chrome = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in chrome if e.get("cat") == "kernel"]
    named = {k: sum(k in n for n in kernels) for k in POOL_KERNELS["bfloat16"]}
    # a CUPTI trace now and then comes back without device activity (see
    # profile_calls): then kernel 1's names are not measured; a trace with
    # kernels must name kernel 1's
    check(not kernels or all(named.values()),
          f"(observed) the chrome trace's {len(kernels)} kernels do not name "
          f"kernel 1's launches: {named}")
    if not kernels:
        named = None
    print(f"  (observed) cli.main {CLI_EPOCHS} epochs x {steps} steps with "
          f"--telemetry_dir --trace --watchdog_stall_s {WATCHDOG_S} --profile "
          f"--profile_steps 2 in {run_s:.1f} s: {len(step_ev)} step events, "
          f"gauges {mem}, {len(evals)} eval events, step_ms p50/p95/p99 "
          + "/".join(f"{summary['timers']['train/step_ms'][f'p{p}_ms']:.2f}"
                     for p in (50, 95, 99))
          + f"; {len(linked)} train/step spans linked to infeed/produce; no "
          f"stall; the chrome trace ({os.path.getsize(os.path.join(prof_dir, traces[0])) / 1e6:.1f}"
          f" MB) names kernel 1 ({named}); launches {launches}", flush=True)
    report_tools_check(tele, len(spans))
    shutil.rmtree(tele)
    shutil.rmtree(os.path.join(tmp, "ck16"))

    # ---- 2. ckpt/write EIO (retried) with train/nan_loss at step 3 ----
    d, tele2 = os.path.join(tmp, "ck_eio"), os.path.join(tmp, "tele_eio")
    retries0 = retry.stats().get("checkpoint-io", {}).get("retries", 0)
    cli_run("eio", "--data", data_prefix, "--batch_size", TRAIN_B,
            "--max_contexts", C, "--epochs", 1, "--save", d,
            "--telemetry_dir", tele2, "--faults", json.dumps({"sites": {
                "ckpt/write": {"action": "io_error", "errno": "EIO",
                               "times": 1},
                "train/nan_loss": {"at": 3}}}))
    retried = retry.stats()["checkpoint-io"]["retries"] - retries0
    (events,) = run_events(tele2)
    nan_steps = [e["step"] for e in events if e["kind"] == "step"
                 and not np.isfinite(e["loss"])]
    retry_ev = [e for e in events if e["kind"] == "retry"]
    check(retried == 1 and len(retry_ev) == 1
          and retry_ev[0]["policy"] == "checkpoint-io",
          f"(eio) retries {retried}, events {retry_ev}")
    check(ckpt.latest_step(d) == steps and ckpt.verify_step(d, steps) is True,
          f"(eio) latest step {ckpt.latest_step(d)}")
    # the alert that acts on a non-finite loss is the live metrics plane's
    # (health monitors, alert rules): [17] holds it on the card
    check(nan_steps == [3], f"(nan) non-finite losses at steps {nan_steps}")
    print(f"  (eio) ckpt/write EIO once: retried {retried} time "
          f"({retry_ev[0]['error'][:60]}), step {steps} committed and its "
          f"checksums verify; (nan) train/nan_loss at 3: the step events' "
          f"non-finite losses at steps {nan_steps}", flush=True)
    shutil.rmtree(d)
    shutil.rmtree(tele2)

    # ---- 3. ckpt/write ENOSPC with the torn marker: the run gives up ----
    d = os.path.join(tmp, "ck_enospc")
    try:
        cli.main([str(a) for a in (
            "--data", data_prefix, "--batch_size", TRAIN_B, "--max_contexts",
            C, "--epochs", CLI_EPOCHS, "--save", d, "--faults", json.dumps(
                {"sites": {"ckpt/write": {"action": "io_error",
                                          "errno": "ENOSPC",
                                          "partial": True, "at": 2}}}))])
        check(False, "(enospc) the run did not fail")
    except OSError as e:
        check(e.errno == errno.ENOSPC, f"(enospc) {e!r}")
        gave_up = repr(e)
    last = CLI_EPOCHS * steps
    torn = os.path.join(d, f"step_{last}", "state.tmp")
    check(os.path.isdir(torn) and not os.path.exists(
        os.path.join(d, f"step_{last}", "state")),
        f"(enospc) step_{last}: {os.listdir(os.path.join(d, f'step_{last}'))}")
    fallback = ckpt.load_checkpoint(d)["step"]
    check(ckpt.latest_step(d) == fallback == last - steps,
          f"(enospc) loaded step {fallback}")
    print(f"  (enospc) ckpt/write ENOSPC at the second save: the run failed "
          f"with {gave_up}, step_{last}/state.tmp/ left behind, a load fell "
          f"back to step {fallback}", flush=True)
    shutil.rmtree(d)
    torch.cuda.empty_cache()

    # ---- 5. the telemetry's cost on the loop: all on vs all off ----
    cfg_c = Config(MAX_CONTEXTS=C, TRAIN_BATCH_SIZE=TRAIN_B, SEED=SEED,
                   NUM_TRAIN_EPOCHS=1)
    _, cfg_a = train_config("a", "bfloat16", True)
    path = data_prefix + ".train.c2v"
    tele4 = os.path.join(tmp, "tele_cost")
    cost = {}
    for n_label, (label, cfg) in enumerate((("c", cfg_c), ("a", cfg_a))):
        trainer = Code2VecTrainer(cfg, vocabs)
        trainer.train(path, epochs=1)  # warm: allocator, libraries
        runs = {"on": [], "off": []}
        first = []
        for pair in range(TELE_LOOP_PAIRS):  # on off, off on, ...
            on_first = (pair + n_label + ORDER_FLIP) % 2 == 0
            first.append("on" if on_first else "off")
            for mode in (("on", "off") if on_first else ("off", "on")):
                on = mode == "on"
                cfg.TELEMETRY_DIR = tele4 if on else None
                cfg.TRACE = on
                cfg.WATCHDOG_STALL_S = WATCHDOG_S if on else 0.0
                runs[mode].append(loop_window(torch, trainer, path,
                                              TELE_LOOP_EPOCHS, steps))
        cfg.TELEMETRY_DIR, cfg.TRACE, cfg.WATCHDOG_STALL_S = None, False, 0.0
        cost[label] = {**runs, "first": first}
        med = {k: sorted(v)[len(v) // 2] for k, v in runs.items()}
        print(f"  (cost) ({label}) steps/s over epochs 2..{TELE_LOOP_EPOCHS} "
              f"({(TELE_LOOP_EPOCHS - 1) * steps} steps), {TELE_LOOP_PAIRS} "
              f"pair(s), first in each: {', '.join(first)}; telemetry + "
              f"trace + watchdog on "
              + ", ".join(f"{x:.2f}" for x in runs["on"]) + "; all off "
              + ", ".join(f"{x:.2f}" for x in runs["off"])
              + f"; medians {med['on']:.2f} vs {med['off']:.2f} "
              f"({(1 - med['on'] / med['off']) * 100:+.1f} % slower on)",
              flush=True)
        trainer.close_session()
        del trainer
        torch.cuda.empty_cache()
        shutil.rmtree(tele4, ignore_errors=True)
    out.update({"observed_s": run_s, "launches": launches,
                "memory_gauges": mem, "profile_named": named,
                "eio_retries": retried, "nan_steps": nan_steps,
                "enospc": gave_up, "telemetry_cost_steps_per_s": cost})
    report["observed"] = out
    return launches


def start_kill_resume(tmp, kept) -> dict:
    """[16]'s `train/kill` leg, started beside [19] (whose children wait
    on a slow infeed, so the card is mostly idle): `python3 -m
    code2vec_tpu_torch` on [14]'s command with `train/kill` at the
    second epoch's second step (synchronous saves, so the first epoch's
    step is committed), then the same command with `--auto_resume`, in
    turn on a thread of this process."""
    steps, base = kept["steps"], [str(a) for a in kept["base"]]
    d, tele = os.path.join(tmp, "ck_kill"), os.path.join(tmp, "tele_kill")
    cmd = [sys.executable, "-m", "code2vec_tpu_torch", *base, "--save", d,
           "--async_checkpoint", "off", "--telemetry_dir", tele]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(
        __file__)))
    chain = {"dir": d, "tele": tele, "kill_at": steps + 2, "runs": []}

    def run() -> None:
        for extra in (["--faults", json.dumps({"sites": {"train/kill": {
                "action": "kill", "at": chain["kill_at"]}}})],
                      ["--auto_resume"]):
            t = time.perf_counter()
            r = subprocess.run(cmd + extra, capture_output=True, text=True,
                               timeout=600, env=env)
            chain["runs"].append((r, time.perf_counter() - t))

    chain["thread"] = threading.Thread(target=run, daemon=True,
                                       name="kill-resume")
    chain["thread"].start()
    return chain


def finish_kill_resume(torch, chain, kept, report) -> None:
    """[16]'s `train/kill` leg, waited for: the kill's SIGKILL with epoch
    1's step the latest, the resume's exit 0, the steps of each run's
    events, and the resumed run's final state and losses bit-identical
    to [14]'s uninterrupted run; then [14]'s run is removed."""
    import shutil
    import signal

    from code2vec_tpu_torch.training import checkpoint as ckpt
    steps, d, kill_at = kept["steps"], chain["dir"], chain["kill_at"]
    t = time.perf_counter()
    chain["thread"].join(timeout=1200)
    waited = time.perf_counter() - t
    check(not chain["thread"].is_alive() and len(chain["runs"]) == 2,
          f"(kill) the leg did not finish: {len(chain['runs'])} runs")
    (killed_r, kill_s), (resumed_r, resume_s) = chain["runs"]
    check(killed_r.returncode == -signal.SIGKILL,
          f"(kill) exit {killed_r.returncode}: {killed_r.stderr[-2000:]}")
    check(resumed_r.returncode == 0, f"(kill) --auto_resume exited "
          f"{resumed_r.returncode}: {resumed_r.stderr[-2000:]}")
    killed, resumed = run_events(chain["tele"])
    killed_steps = [e["step"] for e in killed if e["kind"] == "step"]
    resumed_losses = [e["loss"] for e in resumed if e["kind"] == "step"]
    # the kill lands after step `kill_at` and before its step event
    check(killed_steps == list(range(1, kill_at))
          and [e["step"] for e in resumed if e["kind"] == "step"]
          == list(range(steps + 1, CLI_EPOCHS * steps + 1)),
          f"(kill) steps {killed_steps} then {resumed}")
    a, b = ckpt.load_checkpoint(d), ckpt.load_checkpoint(kept["uninterrupted"])
    # the step events carry the loss to 6 decimals
    diff = {**state_diff(torch, a, b),
            "losses_equal": resumed_losses == [
                round(x, 6) for x in kept["losses"][-steps:]]}
    del a, b
    check(diff["differ"] == 0 and diff["losses_equal"],
          f"(kill) the resume is not bit-identical to the uninterrupted "
          f"run: {diff}")
    print(f"  (kill, [16]'s leg beside [19]) train/kill at step {kill_at}: "
          f"SIGKILL after {kill_s:.1f} s (latest step {steps}); "
          f"--auto_resume in {resume_s:.1f} s trained steps {steps + 1}.."
          f"{CLI_EPOCHS * steps}; final state bit-identical to the "
          f"uninterrupted run's ({diff['tensors']} tensors), its losses "
          f"equal; waited {waited:.1f} s after [19]", flush=True)
    shutil.rmtree(d)
    shutil.rmtree(chain["tele"])
    shutil.rmtree(kept["uninterrupted"])
    report["observed"].update(kill_s=kill_s, resume_s=resume_s, resume=diff,
                              kill_waited_s=waited)


# [17]: the plane's cadence in the scraped and the NaN runs (no flag: a
# wrapped Config.load_from_args sets HEALTH_EVERY_S; the scraped run's
# ~2-3 s of training then sees a few sweeps, fewer than the loss-spike
# monitor's 8-sample warmup: a default 1 s cadence saw none in one run of
# three); the stall leg's deadline and the injected producer sleep beyond
# it; the NaN's first step; the plane's cost in pairs of loop runs (one
# since [30] needed the time; three until [25]), ordered as [16]'s
SCRAPE_HEALTH_S, PLANE_HEALTH_S = 0.4, 0.05
STALL_DEADLINE_S, STALL_SLEEP_MS = 1.0, 3000
NAN_AT, PLANE_LOOP_PAIRS = 3, 1


def http_get(port: int, path: str, timeout: float = 5.0):
    """(status, body text, ms) of one GET to this machine's `port`."""
    import urllib.error
    import urllib.request
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://localhost:{port}{path}",
                                    timeout=timeout) as r:
            status, body = r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read().decode("utf-8")
    return status, body, (time.perf_counter() - t) * 1e3


class Poller:
    """A thread GETting `paths` of `port` every `every_s` while a `with`
    block runs: each answer's (path, status, body, ms), in order; a
    refused connection (the server not up yet, or down) is skipped."""

    def __init__(self, port: int, paths, every_s: float = 0.05):
        self.port, self.paths, self.every_s = port, paths, every_s
        self.seen = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            for path in self.paths:
                try:
                    self.seen.append((path, *http_get(self.port, path,
                                                      timeout=2.0)))
                except OSError:
                    pass
            self._stop.wait(self.every_s)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)
        check(not self._thread.is_alive(), "the poller did not stop")
        return False


def phase_live_plane(torch, np, vocabs, tmp, data_prefix, test_path, kept,
                     report):
    """[17]: the live metrics plane on (c)'s configuration and [14]'s
    binary data through `cli.main`: `/metrics`, `/healthz` and `/vars`
    scraped during a run with `--telemetry_dir --metrics_port
    --alerts_mode raise --watchdog_stall_s`; `/healthz` flipped by an
    injected infeed stall and back; `train/nan_loss` under
    `--alerts_mode raise`; `--no_pallas` against the default; the
    plane's cost on the loop."""
    import shutil

    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.obs import promtext
    from code2vec_tpu_torch.obs.alerts import AlertError
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.parallel.compat import free_port

    steps, base = kept["steps"], [str(a) for a in kept["base"]]
    train_only = ["--data", data_prefix, "--batch_size", TRAIN_B,
                  "--max_contexts", C, "--infeed_prefetch", 2]
    out, launches = {}, {"attention_pool": 0}
    real_load = Config.load_from_args.__func__

    def cli_run(label, *argv, health_s=None, expect_rc=0):
        """cli.main in this process (HEALTH_EVERY_S set when given);
        kernel 1's launches in it are added to the phase's count."""
        def load(cls, args=None):
            cfg = real_load(cls, args)
            if health_s is not None:
                cfg.HEALTH_EVERY_S = health_s
            return cfg
        Config.load_from_args = classmethod(load)
        attention_pool_fused.launches = 0
        t = time.perf_counter()
        try:
            rc = cli.main([str(a) for a in argv])
        finally:
            Config.load_from_args = classmethod(real_load)
            torch.cuda.synchronize()
            launches["attention_pool"] += attention_pool_fused.launches
        check(rc == expect_rc, f"({label}) cli.main exited {rc}")
        return time.perf_counter() - t

    # ---- 1. scraped during a run (the main path) ----
    port, tele = free_port(), os.path.join(tmp, "tele17")
    pool0 = launches["attention_pool"]
    with Poller(port, ("/metrics", "/healthz", "/vars")) as poll:
        run_s = cli_run("scraped", *base, "--telemetry_dir", tele,
                        "--metrics_port", port, "--alerts_mode", "raise",
                        "--watchdog_stall_s", WATCHDOG_S,
                        health_s=SCRAPE_HEALTH_S)
    pool_scraped = launches["attention_pool"] - pool0
    want_pool = CLI_EPOCHS * (steps + -(-count_lines(test_path) // TRAIN_B))
    check(pool_scraped == want_pool, f"(scraped) kernel 1 launched "
          f"{pool_scraped} times, expected {want_pool}")
    metrics = [(promtext.parse_prometheus(b), ms)
               for p, st, b, ms in poll.seen if p == "/metrics" and st == 200]
    full = [m for m, _ in metrics
            if promtext.scalar(m, "train_steps")
            and "health_loss_nonfinite" in m and "alert_active" in m]
    check(full, f"(scraped) {len(metrics)} scrapes, none during the steps "
          f"with the health and alert families")
    fam = full[-1]
    check(np.isfinite(promtext.scalar(fam, "train_loss"))
          and promtext.labeled(fam, "train_step_ms", quantile="0.5") > 0
          and promtext.scalar(fam, "train_step_ms_count") >= 1
          and all(v == 0 for _l, v in fam["alert_active"]),
          f"(scraped) families {sorted(fam)}")
    health = [st for p, st, _b, _ms in poll.seen if p == "/healthz"]
    check(health and all(st == 200 for st in health),
          f"(scraped) /healthz answered {sorted(set(health))}")
    card = [json.loads(b)["identity"]["devices"]
            for p, st, b, _ms in poll.seen if p == "/vars" and st == 200]
    check(card and card[-1].get("kind") == torch.cuda.get_device_name(0)
          and card[-1].get("platform") == "gpu", f"(scraped) /vars {card[-1:]}")
    scrape_ms = sorted(ms for _m, ms in metrics)
    with_health = sorted(f for f in fam if f.startswith("health_"))
    print(f"  (scraped) cli.main {CLI_EPOCHS} epochs x {steps} steps with "
          f"--telemetry_dir --metrics_port {port} --alerts_mode raise "
          f"--watchdog_stall_s {WATCHDOG_S} (cadence {SCRAPE_HEALTH_S} s) in "
          f"{run_s:.1f} s: {len(metrics)} "
          f"/metrics scrapes parsed (ms p50 {scrape_ms[len(scrape_ms) // 2]:.2f}"
          f", max {scrape_ms[-1]:.2f}), train_steps "
          f"{promtext.scalar(fam, 'train_steps'):.0f}, train_loss "
          f"{promtext.scalar(fam, 'train_loss'):.5f}, step_ms p50 "
          f"{promtext.labeled(fam, 'train_step_ms', quantile='0.5'):.2f}, "
          f"{len(with_health)} health_* families, alert_active all 0; "
          f"/healthz 200 x {len(health)}; /vars names {card[-1]['kind']}; "
          f"kernel 1 launched {pool_scraped} times", flush=True)
    http_refused = False
    try:
        http_get(port, "/metrics", timeout=1.0)
    except OSError:
        http_refused = True
    check(http_refused, "(scraped) the port still answers after the run")
    shutil.rmtree(tele)
    out["scraped"] = {"run_s": run_s, "scrapes": len(metrics),
                      "scrape_ms": scrape_ms, "healthz_200": len(health),
                      "health_families": with_health,
                      "launches": pool_scraped}

    # ---- 2. an injected infeed stall flips /healthz and back ----
    port, tele = free_port(), os.path.join(tmp, "tele17s")
    stall = {"sites": {"infeed/produce": {
        "action": "sleep", "delay_ms": STALL_SLEEP_MS, "at": steps + 2}}}
    with Poller(port, ("/healthz",)) as poll:
        cli_run("stall", *train_only, "--epochs", 2, "--telemetry_dir", tele,
                "--metrics_port", port, "--watchdog_stall_s",
                STALL_DEADLINE_S, "--faults", json.dumps(stall))
    seq = [st for _p, st, _b, _ms in poll.seen]
    flips = [seq[i] for i in range(len(seq)) if i == 0 or seq[i] != seq[i - 1]]
    stalled = sorted({c for _p, st, b, _ms in poll.seen if st == 503
                      for c in json.loads(b)["stalled"]})
    (events,) = run_events(tele)
    stall_ev = sorted({e.get("component") for e in events
                       if e["kind"] == "stall"})
    check(flips[:3] == [200, 503, 200] and "infeed_producer" in stalled,
          f"(stall) /healthz went {flips}, stalled {stalled}")
    print(f"  (stall) infeed/produce sleeping {STALL_SLEEP_MS} ms at batch "
          f"{steps + 2} against a {STALL_DEADLINE_S} s deadline: /healthz "
          f"{' -> '.join(map(str, flips))} over {len(seq)} polls "
          f"({seq.count(503)} answered 503, naming {stalled}); stall events "
          f"{stall_ev}", flush=True)
    shutil.rmtree(tele)
    out["stall"] = {"flips": flips, "polls": len(seq), "n_503": seq.count(503),
                    "stalled": stalled, "stall_events": stall_ev}

    # ---- 3. train/nan_loss under --alerts_mode raise ----
    tele = os.path.join(tmp, "tele17n")
    nan = {"sites": {"train/nan_loss": {"action": "nan", "at": NAN_AT,
                                        "times": -1}}}
    raised = None
    try:
        cli_run("nan", *train_only, "--epochs", 4, "--telemetry_dir", tele,
                "--alerts_mode", "raise", "--faults", json.dumps(nan),
                health_s=PLANE_HEALTH_S)
    except AlertError as e:
        raised = str(e)  # not the exception: its frames hold the trainer
    (events,) = run_events(tele)
    alerts = [e for e in events if e["kind"] == "alert"]
    step_ev = [e for e in events if e["kind"] == "step"]
    last = step_ev[-1]["step"] if step_ev else None
    check(raised is not None and "loss_nonfinite" in raised
          and [(e["rule"], e["transition"]) for e in alerts]
          == [("loss_nonfinite", "firing")]
          and last is not None and NAN_AT < last < 4 * steps,
          f"(nan) raised {raised!r}, alert events {alerts}, last step {last}")
    print(f"  (nan) train/nan_loss from step {NAN_AT} under --alerts_mode "
          f"raise (cadence {PLANE_HEALTH_S} s): AlertError at step {last} "
          f"({raised}); one alert event ({alerts[0]['rule']} "
          f"{alerts[0]['transition']})", flush=True)
    shutil.rmtree(tele)
    out["nan"] = {"nan_at": NAN_AT, "raised_at_step": last,
                  "alert_events": len(alerts)}

    # ---- 4. --no_pallas against the default ----
    runs = {}
    for label, extra in (("default", []), ("no_pallas", ["--no_pallas"])):
        n0 = launches["attention_pool"]
        with Recorder(torch) as rec:
            cli_run(label, *train_only, "--epochs", 1, *extra)
        runs[label] = (launches["attention_pool"] - n0, rec.loss_values())
    (n_def, l_def), (n_off, l_off) = runs["default"], runs["no_pallas"]
    rel = loss_rel(l_off, l_def)
    check(n_def == steps and n_off == 0 and len(l_off) == steps
          and rel <= LOSS_RTOL,
          f"(no_pallas) kernel 1 {n_def} vs {n_off} launches, losses "
          f"{l_def} vs {l_off}")
    print(f"  (no_pallas) kernel 1 launched {n_def} times in the default run "
          f"and {n_off} with --no_pallas; losses within {rel:.2e} of each "
          f"other (bound {LOSS_RTOL})", flush=True)
    out["no_pallas"] = {"launches_default": n_def, "launches_no_pallas": n_off,
                        "loss_rel": rel}

    # ---- 5. the plane's cost on the loop ----
    cfg = Config(MAX_CONTEXTS=C, TRAIN_BATCH_SIZE=TRAIN_B, SEED=SEED,
                 NUM_TRAIN_EPOCHS=1)
    path = data_prefix + ".train.c2v"
    tele = os.path.join(tmp, "tele17c")
    trainer = Code2VecTrainer(cfg, vocabs)
    trainer.train(path, epochs=1)  # warm: allocator, libraries
    arms = {"plane": ("on", "off"), "port_only": ("port", "none")}
    cost = {}
    for n_arm, (name, (a_on, a_off)) in enumerate(arms.items()):
        runs = {a_on: [], a_off: []}
        first = []
        for pair in range(PLANE_LOOP_PAIRS):
            on_first = (pair + n_arm + ORDER_FLIP) % 2 == 0
            first.append(a_on if on_first else a_off)
            for arm in ((a_on, a_off) if on_first else (a_off, a_on)):
                # telemetry and trace on in both arms of "plane"; the
                # metrics port alone against nothing in "port_only"
                cfg.TELEMETRY_DIR = tele if name == "plane" else None
                cfg.TRACE = name == "plane"
                cfg.METRICS_PORT = free_port() if arm in ("on", "port") else 0
                cfg.ALERTS_MODE = "warn" if arm == "on" else "off"
                runs[arm].append(loop_window(torch, trainer, path,
                                             TELE_LOOP_EPOCHS, steps,
                                             to_last_step=True))
        med = {k: sorted(v)[len(v) // 2] for k, v in runs.items()}
        cost[name] = {"runs": runs, "medians": med, "first": first}
        print(f"  (cost) (c) steps/s over epochs 2..{TELE_LOOP_EPOCHS} to "
              f"the last step's end, {PLANE_LOOP_PAIRS} pair(s), first in "
              f"each: {', '.join(first)}; "
              + ("telemetry + trace in both, the plane (--metrics_port, "
                 "--alerts_mode warn) on " if name == "plane" else
                 "--metrics_port alone (an in-memory registry, the per-step "
                 "loss read) ")
              + ", ".join(f"{x:.2f}" for x in runs[a_on]) + "; off "
              + ", ".join(f"{x:.2f}" for x in runs[a_off])
              + f"; medians {med[a_on]:.2f} vs {med[a_off]:.2f} "
              f"({(1 - med[a_on] / med[a_off]) * 100:+.1f} % slower on)",
              flush=True)
    cfg.TELEMETRY_DIR, cfg.TRACE, cfg.METRICS_PORT = None, False, 0
    cfg.ALERTS_MODE = "off"
    trainer.close_session()
    del trainer
    torch.cuda.empty_cache()
    shutil.rmtree(tele, ignore_errors=True)
    out["cost_steps_per_s"] = cost
    out["launches"] = launches
    report["live_plane"] = out
    return launches



# ---- [18] the phase profiler, [19] the supervisor ----

# [18]: steps between samples (a run of CLI_EPOCHS x 4 steps samples at
# steps-into-run 2, 4 and 6; a sample times PROBE_PASSES passes of the
# probes, the first sample one more, the warm-up unrecorded); the health cadence of the profiled runs (no flag:
# a wrapped Config.load_from_args sets it); how long the profiled run's
# last step waits for a mid-run scrape to see the phase gauges; the
# phase event's ms are rounded to 0.001, so its identity holds to this
PHASE_EVERY, PHASE_HEALTH_S, PHASE_GATE_S, PHASE_ID_TOL_MS = 2, 0.05, 60.0, 0.01
# [19]: the kill's step (in epoch 2, past epoch 1's save), the infeed's
# sleep per batch in the killed child, the fleet's sweep cadence and the
# /fleet poll's. A cohort rate is the counter's change over one sweep
# window, so it reads above 0 only in the sweep that follows a step.
# That child's infeed is synchronous: a prefetching one fills its queue
# during a process's slow first step, and the steps after it then run
# within one sweep. Steps spaced twice the sweep apart give each step
# such a sweep, and a poll ten times faster than the sweep sees every
# aggregate (neither the sleep nor the depth changes a value)
SUP_KILL_AT, SUP_INFEED_SLEEP_MS, SUP_FLEET_S, SUP_POLL_S = 5, 1000, 0.5, 0.05
SUP_TIMEOUT_S = 900


def phase_events_check(np, label, events, kit_phases):
    """[18]'s checks on one profiled run's `phase` events: every phase
    of the kit in each; the device phases plus residual_ms equal the
    fused ms of the sample wherever no chain difference was clamped to
    0 (a probe that ran faster than the one before it); returns the
    samples and the clamped ones."""
    from code2vec_tpu_torch.obs.phases import DEVICE_PHASES
    check(events, f"({label}) no phase events")
    clamped = []
    for e in events:
        missing = [p for p in kit_phases if f"{p}_ms" not in e]
        check(not missing, f"({label}) phase event without {missing}: {e}")
        dev = sum(e.get(f"{p}_ms", 0.0) for p in DEVICE_PHASES)
        chain = [p for p in kit_phases if p not in ("table_apply",
                                                     "backward_apply")]
        if any(e[f"{p}_ms"] == 0.0 for p in chain):
            clamped.append(e["step"])
            continue
        check(abs(dev + e["residual_ms"] - e["fused_ms"]) <= PHASE_ID_TOL_MS,
              f"({label}) device phases {dev:.3f} + residual "
              f"{e['residual_ms']:.3f} != fused {e['fused_ms']:.3f}: {e}")
    check(len(clamped) < len(events),
          f"({label}) every sample clamped a chain phase: {events}")
    return clamped


def phase_profiler_phase(torch, np, vocabs, tmp, data_prefix, kept, report):
    """[18]: the sampled phase profiler at java-large width through
    `cli.main` over [14]'s binary data, for (c) and (a): each run twice
    over the same steps, profiled (`--phase_profile on
    --phase_sample_every 2 --telemetry_dir --metrics_port`) and not;
    the same bits at the end; the phase events, a mid-run scrape, the
    launches, the per-phase table, (a)'s floor; then the sampled step's
    peak memory, an isolated apply probe for (c), and the card's
    streaming ceiling (ops/membench.py)."""
    import shutil

    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data.reader import open_reader
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.obs import Telemetry, promtext
    from code2vec_tpu_torch.obs.phases import PROBE_PASSES, PhaseProfiler
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.ops.membench import measure_hbm_ceiling
    from code2vec_tpu_torch.ops.sparse_update_kernel import \
        sparse_row_adam_fused
    from code2vec_tpu_torch.parallel.compat import free_port
    from code2vec_tpu_torch.training.phase_probes import make_code2vec_probes

    steps = kept["steps"]
    n_steps = CLI_EPOCHS * steps
    samples = [s for s in range(n_steps) if s and s % PHASE_EVERY == 0]
    train_only = ["--data", data_prefix, "--batch_size", TRAIN_B,
                  "--max_contexts", C, "--epochs", CLI_EPOCHS,
                  "--infeed_prefetch", 2]
    configs = (("c", []),
               ("a", ["--sparse_embeddings", "--embedding_optimizer", "adam",
                      "--lr_schedule", "constant", "--sampled_softmax",
                      "--num_sampled", TRAIN_S]))
    real_load = Config.load_from_args.__func__
    out, launches = {}, {"attention_pool": 0, "sparse_row_adam": 0}

    def load(cls, args=None):
        cfg = real_load(cls, args)
        cfg.HEALTH_EVERY_S = PHASE_HEALTH_S
        return cfg

    for label, flags in configs:
        runs = {}
        for mode in ("off", "on"):
            tele = os.path.join(tmp, f"tele18_{label}")
            port = free_port()
            argv = train_only + flags
            if mode == "on":
                argv += ["--phase_profile", "on", "--phase_sample_every",
                         PHASE_EVERY, "--telemetry_dir", tele,
                         "--metrics_port", port]
            want = {"health_phase_embed_gather", "train_phase_fused_step_ms"}
            if label == "a":
                want.add("health_opt_efficiency")
            seen, gate = {}, threading.Event()

            def scrape():
                deadline = time.monotonic() + PHASE_GATE_S + 60
                while not gate.is_set() and time.monotonic() < deadline:
                    try:
                        _st, body, _ms = http_get(port, "/metrics", 1.0)
                    except OSError:
                        time.sleep(0.05)
                        continue
                    fam = promtext.parse_prometheus(body)
                    if want <= set(fam):
                        seen["fam"] = fam
                        gate.set()
                    time.sleep(0.05)

            with Recorder(torch) as rec:
                real_step = Code2VecTrainer.train_step
                calls = [0]

                def held(self, batch, draws=None):
                    # the last step waits for the mid-run scrape
                    calls[0] += 1
                    if mode == "on" and calls[0] == n_steps:
                        gate.wait(timeout=PHASE_GATE_S)
                    return real_step(self, batch, draws)
                Code2VecTrainer.train_step = held
                scraper = threading.Thread(target=scrape, daemon=True)
                if mode == "on":
                    scraper.start()
                Config.load_from_args = classmethod(load)
                attention_pool_fused.launches = 0
                sparse_row_adam_fused.launches = 0
                t = time.perf_counter()
                try:
                    rc = cli.main([str(a) for a in argv])
                finally:
                    Config.load_from_args = classmethod(real_load)
                    gate.set()
                    torch.cuda.synchronize()
                run_s = time.perf_counter() - t
                if mode == "on":
                    scraper.join(timeout=30)
                n = {"attention_pool": attention_pool_fused.launches,
                     "sparse_row_adam": sparse_row_adam_fused.launches}
            check(rc == 0, f"({label} {mode}) cli.main exited {rc}")
            trainer = rec.made[-1]
            check(trainer.step_num == n_steps and len(rec.losses) == n_steps,
                  f"({label} {mode}) {len(rec.losses)} steps")
            runs[mode] = {"trainer": trainer, "run_s": run_s, "launches": n,
                          "seen": seen.get("fam"), "tele": tele}
            for k, v in n.items():
                launches[k] += v
            del rec
        # ---- the same bits with and without the profiler ----
        diff = state_diff(torch, {"params": runs["on"]["trainer"].params,
                                  "opt_state": runs["on"]["trainer"].opt_state},
                          {"params": runs["off"]["trainer"].params,
                           "opt_state": runs["off"]["trainer"].opt_state})
        check(diff["differ"] == 0, f"({label}) the profiled run's final "
              f"state differs from the unprofiled run's: {diff}")
        # ---- launches: the probes add kernel 1 (forward_pool, backward;
        # PROBE_PASSES passes a sample and the first sample's warm-up
        # pass), never kernel 5 ----
        per_step = {"attention_pool": 1,
                    "sparse_row_adam": 3 if label == "a" else 0}
        want_off = {k: v * n_steps for k, v in per_step.items()}
        want_on = dict(want_off, attention_pool=want_off["attention_pool"]
                       + 2 * (PROBE_PASSES * len(samples) + 1))
        check(runs["off"]["launches"] == want_off
              and runs["on"]["launches"] == want_on,
              f"({label}) launches off {runs['off']['launches']} (expected "
              f"{want_off}), on {runs['on']['launches']} (expected {want_on})")
        # ---- the phase events and the summary ----
        (events,) = run_events(runs["on"]["tele"])
        phase_ev = [e for e in events if e["kind"] == "phase"]
        check([e["step"] for e in phase_ev] == samples,
              f"({label}) phase events at {[e['step'] for e in phase_ev]}")
        kit = ["embed_gather", "concat_dense", "forward_pool", "backward",
               "table_apply"]
        clamped = phase_events_check(np, label, phase_ev, kit)
        summary = events[-1]
        check(summary["kind"] == "summary", f"({label}) no summary")
        for p in kit + ["infeed_wait", "fused_step"]:
            stat = summary["timers"].get(f"train/phase/{p}_ms")
            check(stat is not None and stat["count"] == len(samples),
                  f"({label}) train/phase/{p}_ms: {stat}")
        fam = runs["on"]["seen"]
        check(fam is not None, f"({label}) no mid-run scrape carried "
              f"health_phase_*{' and health_opt_efficiency' if label == 'a' else ''}")
        step_ev = {e["step"]: e["step_ms"] for e in events
                   if e["kind"] == "step"}
        sampled_ms = [step_ev[s + 1] for s in samples]
        other = sorted(v for k, v in step_ev.items()
                       if k - 1 not in samples and k > 1)
        unsampled_med = other[len(other) // 2]
        gauges = summary["gauges"]
        table = []
        for p in kit:
            ms = sorted(e[f"{p}_ms"] for e in phase_ev)[len(phase_ev) // 2]
            nbytes = gauges.get(f"train/phase_bytes/{p}")
            table.append({"phase": p, "ms": ms, "bytes": nbytes,
                          "gb_s": nbytes / ms / 1e6 if ms > 0 else None})
        fused_med = sorted(e["fused_ms"] for e in phase_ev)[len(phase_ev) // 2]
        floor = gauges.get("train/step_floor_ms")
        step_p50 = summary["timers"]["train/step_ms"]["p50_ms"]
        check((floor is not None and floor > 0) == (label == "a"),
              f"({label}) train/step_floor_ms {floor}")
        health = {k: promtext.scalar(fam, k) for k in sorted(fam)
                  if k.startswith("health_phase_")
                  or k == "health_opt_efficiency"}
        print(f"  ({label}) cli.main {n_steps} steps profiled every "
              f"{PHASE_EVERY} ({runs['on']['run_s']:.1f} s) and not "
              f"({runs['off']['run_s']:.1f} s): final params and optimizer "
              f"state the same bits ({diff['tensors']} tensors); launches "
              f"kernel 1 {runs['on']['launches']['attention_pool']} vs "
              f"{runs['off']['launches']['attention_pool']}, kernel 5 "
              f"{runs['on']['launches']['sparse_row_adam']} vs "
              f"{runs['off']['launches']['sparse_row_adam']} (profiled vs "
              f"not, the wrappers' counts); {len(phase_ev)} samples at "
              f"{samples}, {len(clamped)} with a chain phase clamped to 0 "
              f"{clamped}; sampled steps' train/step_ms "
              + ", ".join(f"{x:.2f}" for x in sampled_ms)
              + f" beside the unsampled median {unsampled_med:.2f}; fused "
              f"step median {fused_med:.2f} ms; mid-run scrape {health}",
              flush=True)
        print(f"  ({label}) per phase (median of {len(phase_ev)} samples): "
              + "; ".join(f"{r['phase']} {r['ms']:.3f} ms, "
                          f"{r['bytes'] / 1e6:.1f} MB, "
                          + (f"{r['gb_s']:.1f} GB/s" if r["gb_s"] else "-")
                          for r in table), flush=True)
        if label == "a":
            print(f"  (a) train/step_floor_ms {floor:.3f} (the model's bytes "
                  f"over HBM_CEILING_GBPS) beside the measured step p50 "
                  f"{step_p50:.2f} ms: opt_efficiency "
                  f"{floor / step_p50:.3f}", flush=True)
        # ---- the sampled step's peak memory; (c): the isolated apply ----
        trainer = runs["on"]["trainer"]
        batch = trainer.device_batch(next(iter(open_reader(
            data_prefix + ".train.c2v", trainer.vocabs, C, TRAIN_B,
            shuffle=False))))
        draws = trainer.draws_for(batch[0].shape[0], trainer.step_num)
        prof = trainer.phase_profiler(Telemetry.memory("train"))
        prof.run_split(trainer.params, trainer.opt_state, batch, draws)
        torch.cuda.synchronize()
        peaks = {}
        for name, fn in (
                ("fused", lambda: trainer.train_step(batch, draws)),
                ("sampled", lambda: prof.run_split(
                    trainer.params, trainer.opt_state, batch, draws))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() - base
        apply = None
        if label == "c":
            tele_iso = Telemetry.memory("train")
            iso = PhaseProfiler(
                tele_iso, fused_step=lambda _p, _s, b, d: trainer.train_step(b, d),
                probes_factory=lambda: make_code2vec_probes(
                    trainer.dims, trainer.optimizer,
                    compute_dtype=trainer.compute_dtype,
                    use_kernel=trainer.use_kernel, isolated_apply=True),
                sample_every=1)
            for _ in range(3):
                iso.run_split(trainer.params, trainer.opt_state, batch, draws)
            apply = {"isolated_apply_ms": tele_iso.timers[
                "train/phase/table_apply_ms"].percentile(50),
                "fused_ms": tele_iso.timers[
                    "train/phase/fused_step_ms"].percentile(50),
                "remainder_ms": sorted(e["table_apply_ms"] for e in phase_ev)[
                    len(phase_ev) // 2]}
            print(f"  (c) the isolated apply probe (optimizer update on a "
                  f"state clone, p + u into scratch): "
                  f"{apply['isolated_apply_ms']:.3f} ms beside the "
                  f"remainder table_apply {apply['remainder_ms']:.3f} ms of "
                  f"the profiled run", flush=True)
        print(f"  ({label}) peak allocation above the resident state: a "
              f"fused step {peaks['fused'] / 1e9:.3f} GB, a sampled step "
              f"(probes, then the fused step) {peaks['sampled'] / 1e9:.3f} GB",
              flush=True)
        out[label] = {
            "runs_s": {m: r["run_s"] for m, r in runs.items()},
            "launches": {m: r["launches"] for m, r in runs.items()},
            "tensors": diff["tensors"], "samples": samples,
            "clamped": clamped, "sampled_step_ms": sampled_ms,
            "unsampled_step_ms_median": unsampled_med,
            "fused_ms_median": fused_med, "phases": table,
            "phase_events": phase_ev, "step_floor_ms": floor,
            "step_ms_p50": step_p50, "scrape": health,
            "peak_bytes": peaks, "isolated_apply": apply}
        for r in runs.values():
            r["trainer"].close_session()
            shutil.rmtree(r["tele"], ignore_errors=True)
        del runs, trainer, prof, batch, draws
        torch.cuda.empty_cache()
    ceiling = measure_hbm_ceiling()
    print(f"  (membench) streaming ceiling (read + write over 1 GiB "
          f"float32, slope-timed by CUDA events): {ceiling / 1e9:.1f} GB/s; "
          f"Config.HBM_CEILING_GBPS {Config.HBM_CEILING_GBPS}", flush=True)
    out["hbm_ceiling_gbps"] = ceiling / 1e9
    torch.cuda.empty_cache()
    report["phases"] = out
    return launches


def phase_supervised(torch, np, tmp, data_prefix, kept, report):
    """[19]: `python3 -m code2vec_tpu_torch.tools.train_supervisor` over
    (c) on [14]'s data as a subprocess: (i) `train/kill` at step 5 (a
    once-latch marker), one restart, the final state bit-identical to
    [14]'s uninterrupted run, `/fleet` scraped during it; (iii) beside
    it, a child that always fails under `--max_restarts 1`: exit 3 and
    one page. (ii), a flipped byte in the latest step quarantined by the
    supervisor, is not run here, for the clock: [14] holds the
    quarantine and the fall-back load on the card, (i) and [14] the
    resume bit-identical, tests/test_torch_supervisor.py and
    tests/test_torch_chaos.py the supervisor's quarantine and its
    alert."""
    import gc
    import shutil

    from code2vec_tpu_torch.parallel.compat import free_port
    from code2vec_tpu_torch.training import checkpoint as ckpt

    steps, base = kept["steps"], [str(a) for a in kept["base"]]
    out = {}
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(
        __file__)))
    gc.collect()
    torch.cuda.empty_cache()  # the children need the card's memory

    def supervise(label, sup_flags, child, poll_fleet=None):
        sup_tele = os.path.join(tmp, f"sup19_{label}")
        cmd = [sys.executable, "-m",
               "code2vec_tpu_torch.tools.train_supervisor",
               "--telemetry_dir", sup_tele, "--backoff_base_s", "0.2",
               "--attempt_timeout_s", str(SUP_TIMEOUT_S - 100),
               "--out_dir", os.path.join(tmp, f"logs19_{label}"),
               *[str(a) for a in sup_flags], "--", *child]
        t = time.perf_counter()
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            if poll_fleet is not None:
                with Poller(poll_fleet, ("/fleet",),
                            every_s=SUP_POLL_S) as poll:
                    stdout, _ = proc.communicate(timeout=SUP_TIMEOUT_S)
                scrapes = [json.loads(b) for _p, st, b, _ms in poll.seen
                           if st == 200]
            else:
                stdout, _ = proc.communicate(timeout=SUP_TIMEOUT_S)
                scrapes = []
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        (events,) = run_events(sup_tele)
        shutil.rmtree(sup_tele)
        return proc.returncode, time.perf_counter() - t, events, scrapes, \
            stdout

    def firings(events, rule=None, severity=None):
        return [e for e in events if e["kind"] == "alert"
                and e["transition"] == "firing"
                and (rule is None or e["rule"] == rule)
                and (severity is None or e["severity"] == severity)]

    # ---- (iii) a child that always fails: the budget runs out ----
    # beside (i): it needs neither the card nor (i)'s files
    budget_box = []
    budget = threading.Thread(target=lambda: budget_box.append(supervise(
        "fail", ["--max_restarts", 1],
        [sys.executable, "-c", "import sys; sys.exit(1)"])), daemon=True)
    budget.start()

    # ---- (i) train/kill at step 5 under the supervisor, /fleet live ----
    d, tele_child = os.path.join(tmp, "ck19"), os.path.join(tmp, "tele19")
    marker = os.path.join(tmp, "killed19.once")
    child = [sys.executable, "-m", "code2vec_tpu_torch", *base, "--save", d,
             # synchronous saves: epoch 1's step is committed before the kill
             "--async_checkpoint", "off", "--telemetry_dir", tele_child]
    faults = {"sites": {
        "train/kill": {"action": "kill", "at": SUP_KILL_AT,
                       "marker": marker},
        "infeed/produce": {"action": "sleep", "delay_ms": SUP_INFEED_SLEEP_MS,
                           "prob": 1.0, "times": -1}}}
    fleet_port, member_base = free_port(), free_port()
    rc, kill_s, events, scrapes, stdout = supervise(
        "kill", ["--max_restarts", 2, "--fleet_port", fleet_port,
                 "--member_metrics_base", member_base, "--fleet_interval_s",
                 SUP_FLEET_S],
        child + ["--infeed_prefetch", "0", "--faults", json.dumps(faults)],
        poll_fleet=fleet_port)
    attempts = [e for e in events if e["kind"] == "supervisor_attempt"]
    launches_ev = [e for e in events if e["kind"] == "supervisor_launch"]
    check(rc == 0 and os.path.exists(marker)
          and [a["exit_codes"] for a in attempts] == [[-9], [0]]
          and [e["resume_step"] for e in launches_ev] == [-1, steps]
          and len(firings(events, "train_process_restarted")) == 1,
          f"(kill) supervisor exit {rc}, attempts {attempts}, launches "
          f"{launches_ev}: {stdout[-3000:]}")
    a, b = ckpt.load_checkpoint(d), ckpt.load_checkpoint(kept["uninterrupted"])
    diff = state_diff(torch, a, b)
    del a, b
    check(diff["differ"] == 0 and ckpt.latest_step(d) == CLI_EPOCHS * steps,
          f"(kill) the supervised run's final state is not [14]'s: {diff}")
    rows = [s for s in scrapes if s.get("cohort", {}).get("hosts_up") == 1]
    committed = [s for s in rows if s["hosts"][0].get("clock_committed")
                 and s["hosts"][0].get("clock_offset_s") is not None]
    moving = [s for s in rows if (s["cohort"].get("pc_per_sec") or 0) > 0]
    trail = [(h["steps"], h["ex_s"]) for _ts, h in sorted(
        {s["ts"]: s["hosts"][0] for s in rows}.items())]
    check(committed and moving and all(
        s["cohort"]["hosts_total"] == 1 and len(s["hosts"]) == 1
        and s["cohort"]["straggler_score"] is None for s in rows),
        f"(kill) /fleet: {len(scrapes)} scrapes, {len(rows)} with the member "
        f"up, {len(committed)} with a committed offset, {len(moving)} with "
        f"throughput; each member-up sweep's (steps, ex/s) {trail}; last "
        f"{scrapes[-1:]}")
    runs = sorted(os.listdir(tele_child))
    manifests = []
    for r in runs:
        with open(os.path.join(tele_child, r, "manifest.json")) as f:
            manifests.append(json.load(f).get("clock"))
    check(len(runs) == 2 and manifests[-1] is not None
          and manifests[-1].get("wall_offset_s") is not None,
          f"(kill) the relaunched child's manifest clock block: {manifests}")
    offsets = sorted({s["hosts"][0]["clock_offset_s"] for s in committed})
    print(f"  (kill) supervisor + train/kill at step {SUP_KILL_AT} "
          f"(synchronous infeed, sleep {SUP_INFEED_SLEEP_MS} ms a batch): "
          f"exit 0 in {kill_s:.1f} s, "
          f"attempts exited {[a['exit_codes'] for a in attempts]}, the "
          f"relaunch resumed from step {steps}, one train_process_restarted "
          f"ticket; final state bit-identical to [14]'s uninterrupted run "
          f"({diff['tensors']} tensors); /fleet: {len(scrapes)} scrapes, "
          f"{len(rows)} with the one member up, clock offsets "
          + ", ".join(f"{x * 1e3:+.3f} ms" for x in offsets)
          + f" committed (the relaunched child's manifest: "
          f"{manifests[-1]['wall_offset_s'] * 1e3:+.3f} ms), cohort pc/s up "
          f"to {max(s['cohort']['pc_per_sec'] for s in moving):.0f} in "
          f"{len({s['ts'] for s in moving})} of {len(trail)} polled sweeps, "
          f"no straggler", flush=True)
    out["kill"] = {"seconds": kill_s, "attempts": attempts,
                   "tensors": diff["tensors"], "fleet_scrapes": len(scrapes),
                   "offsets_s": offsets, "manifest_clock": manifests[-1],
                   "pc_per_sec_max": max(s["cohort"]["pc_per_sec"]
                                         for s in moving),
                   "sweeps_polled": len(trail),
                   "sweeps_moving": len({s["ts"] for s in moving})}
    shutil.rmtree(tele_child)
    shutil.rmtree(d)

    # ---- (iii) the budget: its result from beside (i) ----
    budget.join(timeout=SUP_TIMEOUT_S)
    check(budget_box, "(budget) the supervisor left no result")
    rc, fail_s, events, _s, stdout = budget_box[0]
    pages = firings(events, severity="page")
    check(rc == 3 and [p["rule"] for p in pages]
          == ["restart_budget_exhausted"],
          f"(budget) exit {rc}, pages {pages}: {stdout[-2000:]}")
    print(f"  (budget) a child that always fails, --max_restarts 1: exit 3 "
          f"in {fail_s:.1f} s, one page (restart_budget_exhausted)",
          flush=True)
    out["budget"] = {"seconds": fail_s}
    for name in ("kill", "fail"):
        shutil.rmtree(os.path.join(tmp, f"logs19_{name}"), ignore_errors=True)
    report["supervised"] = out


# [20] the serving fleet: the JAX `serve_swap_kill` leg's parameters
# (2 replicas, Poisson arrivals at 120 qps from 16 client workers, a
# quarter of them re-asking 8 hot keys, `serve/kill` at the 40th
# predict_lines), with a load long enough (about 20 s) that a 0.77 GB
# step is written, hashed, verified and swapped while it runs
FLEET_REPLICAS, FLEET_QPS, FLEET_CONCURRENCY = 2, 120.0, 16
FLEET_REQUESTS, FLEET_HOT_FRAC, FLEET_HOT_KEYS = 2400, 0.25, 8
FLEET_KILL_AT, FLEET_POLL_S, FLEET_HEALTHZ_S = 40, 0.1, 0.05
# the step committed under load holds weights from another seed, so that
# "the fleet serves the new weights" shows on bf16 tables (the JAX leg's
# x * 1.001 is below one bf16 step)
FLEET_NEW_SEED = 1


def fleet_requests(np, rng, n: int):
    """`n` requests of one method each over [4]'s vocabulary (tokens
    tok<i>, paths 1000003 * i, ~2% out-of-vocab words, 20-400
    contexts), drawn in bulk."""
    out = []
    for _ in range(n):
        n_ctx = int(rng.integers(20, 401))
        tok = rng.integers(JAVA_LARGE["token"], size=(n_ctx, 2))
        pth = rng.integers(JAVA_LARGE["path"], size=n_ctx)
        unk = rng.random((n_ctx, 3)) < 0.02
        unk_ids = rng.integers(1 << 30, size=(n_ctx, 3))
        ctxs = [
            ",".join((f"unk{unk_ids[i, 0]}" if unk[i, 0] else f"tok{tok[i, 0]}",
                      f"unk{unk_ids[i, 1]}" if unk[i, 1]
                      else str(1000003 * int(pth[i])),
                      f"unk{unk_ids[i, 2]}" if unk[i, 2] else f"tok{tok[i, 1]}"))
            for i in range(n_ctx)]
        target = f"m{rng.integers(4099)}|n{rng.integers(JAVA_LARGE['target'])}"
        out.append([target + " " + " ".join(ctxs)])
    return out


def fleet_dims(vocabs):
    """[4]'s java-large bag model with bf16 tables."""
    from code2vec_tpu_torch.models.encoder import ModelDims
    return ModelDims(token_vocab_size=vocabs.token_vocab.size,
                     path_vocab_size=vocabs.path_vocab.size,
                     target_vocab_size=vocabs.target_vocab.size,
                     embeddings_size=E, max_contexts=C, tables_dtype="bfloat16")


def fleet_weights(torch, dims, seed: int, device: str):
    """Random weights from `seed` on `device`, stretched as [4]'s."""
    from code2vec_tpu_torch.models.encoder import init_params
    params = init_params(torch.Generator(device=device).manual_seed(seed),
                         dims)
    stretch_tables(params)
    return params


def fleet_writer(reload_dir: str) -> None:
    """[20]'s trainer, in a process of its own as a trainer is: seed
    FLEET_NEW_SEED's weights on the host, then at each line of stdin
    commit the next step through `save_checkpoint` (step 2 with a byte
    flipped in its largest file), and say so on stdout."""
    import torch

    from code2vec_tpu_torch.tools.chaos import flip_byte_in_largest_file
    from code2vec_tpu_torch.training import checkpoint as ckpt
    vocabs = synthetic_vocabs()
    dims = fleet_dims(vocabs)
    params = fleet_weights(torch, dims, FLEET_NEW_SEED, "cpu")
    print("ready", flush=True)
    for step in (1, 2):
        if not sys.stdin.readline():
            return
        ckpt.save_checkpoint(reload_dir, {"params": params}, step, vocabs,
                             dims)
        if step == 2:
            flip_byte_in_largest_file(os.path.join(reload_dir, "step_2"))
        print(f"saved {step}", flush=True)


def fleet_client(base_url: str, corpus_path: str, out_path: str) -> None:
    """[20]'s clients, in a process of their own: the port loadgen's open
    loop through serving_bench's `HttpPredictClient`, at the JAX leg's
    rate, workers and hot-key skew. Says `start <clock>` before the first
    request and `done` after the report, every answered request's send
    and done times and each hot key's answer are written to `out_path`.
    It imports neither torch nor numpy."""
    from code2vec_tpu_torch.obs import Telemetry
    from code2vec_tpu_torch.tools import loadgen
    from code2vec_tpu_torch.tools.serving_bench import HttpPredictClient
    with open(corpus_path) as f:
        corpus = json.load(f)
    hot = {corpus[i][0]: i for i in range(FLEET_HOT_KEYS)}
    records, answered = [], []

    class RecordingClient(HttpPredictClient):
        def predict_lines(self, lines, deadline_ms=None):
            sent = time.perf_counter()
            out = super().predict_lines(lines, deadline_ms=deadline_ms)
            done = time.perf_counter()
            answered.append((sent, done))
            if lines[0] in hot:
                records.append((hot[lines[0]], sent, done, out[0]))
            return out

    client = RecordingClient(
        base_url, Telemetry.memory("fleet-clients").make_threadsafe())
    print(f"start {time.perf_counter()!r}", flush=True)
    report = loadgen.run_load(
        client, corpus, mode="open", concurrency=FLEET_CONCURRENCY,
        qps=FLEET_QPS, arrivals="poisson", hot_key_frac=FLEET_HOT_FRAC,
        hot_keys=FLEET_HOT_KEYS, seed=SEED)
    with open(out_path, "w") as f:
        json.dump({"report": report, "answered": answered,
                   "records": records}, f)
    print("done", flush=True)


def same_answer(np, got, ref) -> bool:
    """One method's answer (the front end's JSON) against a reference: the
    top-k probabilities position by position within E2E_PROB_RTOL, the
    names equal wherever the reference's neighbours are further apart
    than twice that ([4]'s comparison)."""
    g, r = got["predictions"], ref["predictions"]
    if len(g) != len(r):
        return False
    pg = np.array([p["probability"] for p in g])
    pr = np.array([p["probability"] for p in r])
    if np.any(np.abs(pg - pr) > E2E_PROB_RTOL * pr):
        return False
    for j in range(len(r) - 1):
        gap_lo = pr[j] - pr[j + 1]
        gap_hi = pr[j - 1] - pr[j] if j else np.inf
        if min(gap_lo, gap_hi) > 2 * E2E_PROB_RTOL * pr[j] \
                and g[j]["name"] != r[j]["name"]:
            return False
    return True


def phase_fleet(torch, np, vocabs, tmp, report, device: str = "cuda"):
    """[20]: the serving fleet at java-large width on the card, over HTTP:
    a `ReplicaPool` of 2 bag replicas behind a `ServingFrontend`, a
    `ReloadManager` polling every 0.1 s, the load from the port's
    loadgen through serving_bench's `HttpPredictClient`. Under it: a
    replica death, a verified step swapped in, a corrupt step refused;
    then the JAX leg's contract, no mixed weights, a refilled replica
    answering as its peers, `/healthz` 200 throughout, and one
    autoscaler decision each way. (`device="cpu"` rehearses the phase's
    control flow at a small vocabulary; its kernel check then fails.)"""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecModel
    from code2vec_tpu_torch.obs import Telemetry
    from code2vec_tpu_torch.obs.alerts import (AlertEngine, AlertRule,
                                               serving_slo_rules)
    from code2vec_tpu_torch.obs.promtext import parse_prometheus, scalar
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.resilience import faults
    from code2vec_tpu_torch.serving import (AutoScaler, PredictionServer,
                                            ReloadManager, ReplicaPool,
                                            ServingFrontend)
    from code2vec_tpu_torch.serving.frontend import serialize_prediction
    from code2vec_tpu_torch.tools import obs_top
    from code2vec_tpu_torch.training import checkpoint as ckpt

    import gc

    t_phase = time.perf_counter()
    dims = fleet_dims(vocabs)
    config = Config(MAX_CONTEXTS=C, USE_BF16=True, TABLES_DTYPE="bfloat16",
                    SERVE_REPLICAS=FLEET_REPLICAS)
    reload_dir = os.path.join(tmp, "fleet_ckpt")
    # the trainer that commits steps 1 and 2 runs in its own process, as a
    # trainer does: a checkpoint written in this one (torch.save, the
    # java-large vocab's pickle) holds the interpreter lock that every
    # serving thread needs (stalls of ~450 ms on the card's host)
    writer = subprocess.Popen(
        [sys.executable, "-c", "import json, sys, chip_smoke as cs; "
         "cs.JAVA_LARGE = json.loads(sys.argv[2]); "
         "cs.fleet_writer(sys.argv[1])", reload_dir, json.dumps(JAVA_LARGE)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def fingerprint(params) -> tuple:
        return tuple(float(params[k][:4096].float().sum()) for k in
                     ("token_emb", "path_emb", "target_emb", "transform",
                      "attention"))

    builds = []

    def factory():
        """Every call the same weights: a fresh generator seeded with
        SEED (a refilled or grown replica answers as its peers do)."""
        t = time.perf_counter()
        model = Code2VecModel(config, dims, vocabs,
                              fleet_weights(torch, dims, SEED, device),
                              device=device)
        builds.append({"s": time.perf_counter() - t,
                       "fingerprint": fingerprint(model.params)})
        return model

    def mem_gb() -> float:
        if device != "cuda":
            return 0.0
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated() / 1e9

    mem0 = mem_gb()
    # a long-lived server's start-up heap (the vocab, torch, the earlier
    # phases) need not be scanned again: full collections scanning it
    # stopped every serving thread for 135-254 ms, 6 times in a load. The
    # replicas come after the freeze: a dead one must stay collectable
    gc.collect()
    gc.freeze()
    tele = Telemetry.memory("fleet").make_threadsafe()
    t = time.perf_counter()
    pool = ReplicaPool(config, factory, replicas=FLEET_REPLICAS,
                       telemetry=tele).start()
    start_s = time.perf_counter() - t
    mem_2 = mem_gb()
    alerts = AlertEngine.create(tele, mode="warn",
                                rules=serving_slo_rules(config.SERVE_SLO_MS))
    rm = ReloadManager(reload_dir, pool, telemetry=tele, alerts=alerts,
                       poll_s=FLEET_POLL_S).start()
    fe = ServingFrontend(pool, port=0, telemetry=tele, alerts=alerts,
                         reload_manager=rm).start()
    build_s = ", ".join(f"{b['s']:.2f}" for b in builds)
    print(f"  pool of {FLEET_REPLICAS} java-large bag replicas started in "
          f"{start_s:.1f} s (replica builds {build_s} s); memory "
          f"allocated {mem0:.3f} -> {mem_2:.3f} GB; front end on port "
          f"{fe.bound_port}", flush=True)

    # the pool's state changes with their host times (swap window, each
    # replica's drain plus swap, the ready count all along)
    timeline = []
    publish = pool._publish

    def publish_timed():
        publish()
        with pool._lock:
            states = {r.idx: r.state for r in pool._replicas}
        timeline.append((time.perf_counter(), states))
    pool._publish = publish_timed
    window = {}
    swap = pool.swap_params

    def swap_timed(params, generation):
        window["start"] = time.perf_counter()
        swap(params, generation)
        window["end"] = time.perf_counter()
        window["mem_gb"] = mem_gb()
    pool.swap_params = swap_timed

    rng = np.random.default_rng(SEED + 20)
    corpus = fleet_requests(np, rng, FLEET_REQUESTS)
    t = time.perf_counter()
    ready = writer.stdout.readline().strip()
    check(ready == "ready", f"the writer process did not start: {ready!r}")
    print(f"  {len(corpus)} one-method requests drawn; the writer process "
          f"holds step 1's weights (seed {FLEET_NEW_SEED}, on its host "
          f"side) {time.perf_counter() - t:.1f} s later", flush=True)

    events = {}

    def commit(step: int) -> None:
        writer.stdin.write(f"{step}\n")
        writer.stdin.flush()
        said = writer.stdout.readline().strip()
        if said != f"saved {step}":
            raise RuntimeError(f"the writer said {said!r} for step {step}")

    def chaos_actions() -> None:
        try:
            time.sleep(0.5)  # the load establishes itself first
            events["save1_start"] = time.perf_counter()
            commit(1)
            events["save1_end"] = time.perf_counter()
            deadline = time.time() + 120
            while rm.last_step < 1 and time.time() < deadline:
                time.sleep(0.05)
            events["swapped"] = time.perf_counter()
            events["save2_start"] = time.perf_counter()
            commit(2)  # with a flipped byte
            events["save2_end"] = time.perf_counter()
            deadline = time.time() + 120
            while 2 not in rm.refused and time.time() < deadline:
                time.sleep(0.05)
            events["refused"] = time.perf_counter()
        except Exception as e:  # noqa: BLE001 — failed below
            events["error"] = repr(e)

    faults.install({"seed": 0, "sites": {
        "serve/kill": {"action": "raise", "at": FLEET_KILL_AT}}},
        log=lambda m: print(f"  {m}", flush=True))
    corpus_path = os.path.join(tmp, "fleet_corpus.json")
    client_out = os.path.join(tmp, "fleet_client.json")
    with open(corpus_path, "w") as f:
        json.dump(corpus, f)
    # the clients run in a process of their own, as a fleet's clients do:
    # in this one they took the interpreter lock from the replicas
    clients = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke as cs; "
         "cs.fleet_client(*sys.argv[1:])",
         f"http://127.0.0.1:{fe.bound_port}", corpus_path, client_out],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, text=True)
    actions = threading.Thread(target=chaos_actions, daemon=True)
    # the interpreter's full collections during the load (each stops
    # every serving thread), with their start and length
    collections, gc_t0 = [], {}

    def gc_timer(phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            gc_t0["t"] = time.perf_counter()
        elif "t" in gc_t0:
            collections.append((gc_t0["t"], time.perf_counter() - gc_t0["t"]))
    gc.callbacks.append(gc_timer)
    try:
        # ---- the main path: counts at 0 just before, read just after ----
        attention_pool_fused.launches = 0
        with Poller(fe.bound_port, ["/healthz"],
                    every_s=FLEET_HEALTHZ_S) as health:
            said = clients.stdout.readline().split()
            check(said[:1] == ["start"], f"the clients said {said}")
            t_load = float(said[1])  # CLOCK_MONOTONIC, one per machine
            actions.start()
            said = clients.stdout.readline().strip()
            t_end = time.perf_counter()
            check(clients.wait(timeout=120) == 0 and said == "done",
                  f"the clients exited {clients.returncode}: {said!r}")
            actions.join(timeout=240)
        launches = {"attention_pool": attention_pool_fused.launches}
        kill_fired = faults.stats().get("serve/kill", {}).get("fired", 0)
    finally:
        gc.unfreeze()
        gc.callbacks.remove(gc_timer)
        faults.clear()
        writer.stdin.close()
        for proc in (clients, writer):
            try:
                proc.wait(timeout=60)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    with open(client_out) as f:
        seen = json.load(f)
    load, answered = seen["report"], seen["answered"]
    records = [(k, sent, done, got) for k, sent, done, got in seen["records"]]
    check(not actions.is_alive(), "the chaos actions hung")
    pool.wait_ready(FLEET_REPLICAS, timeout_s=120)
    compile_delta = pool.compile_delta()
    table = pool.pool_table()
    counters = dict(tele.counters)
    refused_state = next((r["state"] for r in alerts.status_table()
                          if r["rule"] == "reload_refused"), None)
    lat = load["latency"]
    # the loadgen's percentiles read the registry's last 2048 samples; the
    # check reads every answered request
    all_ms = np.array([(d - s) * 1e3 for s, d in answered])
    p99_all = float(np.percentile(all_ms, 99)) if len(all_ms) else np.inf

    # ---- what the run shows (printed before any check) ----
    def rel(x):
        return f"{x - t_load:.2f}" if x is not None else "-"

    print(f"  load: {load['requests']} requests in {load['wall_s']:.1f} s "
          f"({load['throughput_rps']:.1f} ok/s; offered {FLEET_QPS} qps "
          f"Poisson, {FLEET_CONCURRENCY} workers, hot keys "
          f"{FLEET_HOT_FRAC} over {FLEET_HOT_KEYS}): ok {load['ok']}, shed "
          f"{load['shed']}, errors {load['errors']}; client latency over "
          f"HTTP p50 {lat['p50_ms']:.2f} ms p95 {lat['p95_ms']:.2f} p99 "
          f"{lat['p99_ms']:.2f} max {lat['max_ms']:.2f} (the last 2048); "
          f"over all {len(all_ms)}: p50 {np.percentile(all_ms, 50):.2f} p99 "
          f"{p99_all:.2f} (SLO {config.SERVE_SLO_MS} ms)", flush=True)
    if load["errors"]:
        print(f"  first error: {load.get('first_error')}", flush=True)
    server_ms = {name: tele.timer(f"serve/{name}_ms").summary()
                 for name in ("request", "parse", "encode", "predict",
                              "reload_verify", "reload_load")}
    print("  server side (in-process, p50 / p99 / max ms): " + "; ".join(
        f"{k} {v['p50_ms']:.2f} / {v['p99_ms']:.2f} / {v['max_ms']:.2f}"
        for k, v in server_ms.items() if v.get("count")), flush=True)
    per_replica = {r["replica"]: r["requests"] for r in table["replicas"]}
    print(f"  requests per live replica {per_replica}; deaths "
          f"{counters.get('serve/replica_dead', 0)}, refills "
          f"{counters.get('serve/replica_refill', 0)}, cache hits "
          f"{counters.get('serve/cache_hit', 0)}, kernel-1 launches "
          f"{launches['attention_pool']}", flush=True)
    drains, since, min_ready = {}, {}, FLEET_REPLICAS
    for ts, states in timeline:
        if window and window["start"] <= ts <= window["end"]:
            min_ready = min(min_ready, sum(s == "ready"
                                           for s in states.values()))
        for idx, st in states.items():
            if st == "draining" and idx not in since:
                since[idx] = ts
            elif st == "ready" and idx in since and idx not in drains:
                drains[idx] = (ts - since[idx]) * 1e3
    print("  timeline (s from the load's start): save 1 "
          f"{rel(events.get('save1_start'))}-{rel(events.get('save1_end'))}, "
          f"swap {rel(window.get('start'))}-{rel(window.get('end'))} "
          f"(each replica's drain + swap ms: "
          f"{', '.join(f'{k}: {v:.1f}' for k, v in sorted(drains.items()))};"
          f" at least {min_ready} ready), save 2 + flip "
          f"{rel(events.get('save2_start'))}-{rel(events.get('save2_end'))},"
          f" refused {rel(events.get('refused'))}, load end "
          f"{rel(t_end)}", flush=True)
    slow = sorted(((d - s) * 1e3, s) for s, d in answered)[-10:][::-1]
    print("  the 10 slowest requests (ms @ s sent): " + ", ".join(
        f"{ms:.1f} @ {rel(s)}" for ms, s in slow), flush=True)
    print(f"  full collections during the load: {len(collections)}" + (
        ", " + ", ".join(f"{ms * 1e3:.1f} ms @ {rel(t0)}"
                         for t0, ms in collections[:8]) if collections
        else ""), flush=True)
    statuses = [s for _p, s, _b, _ms in health.seen]
    print(f"  /healthz polled {len(statuses)} times every "
          f"{FLEET_HEALTHZ_S} s: {sorted(set(statuses))}", flush=True)
    mem_swap = window.get("mem_gb")
    if events.get("error"):
        print(f"  chaos actions failed: {events['error']}", flush=True)

    # ---- no mixed weights: hot keys against one server per weight set ----
    refs = []
    step1 = ckpt.load_checkpoint(reload_dir, step=1)["params"]
    for params in (None, step1):
        model = factory()
        if params is not None:
            model.params = {k: v.to(model.device) for k, v in params.items()}
        ref_cfg = Config(MAX_CONTEXTS=C, USE_BF16=True,
                         TABLES_DTYPE="bfloat16", SERVE_CACHE_SIZE=0)
        with PredictionServer(ref_cfg, model) as server:
            refs.append([serialize_prediction(server.predict_lines(
                corpus[i])[0]) for i in range(FLEET_HOT_KEYS)])
        del model, server
    del step1
    gc.collect()  # the reference servers' cycles (server <-> batcher)
    distinct = sum(not same_answer(np, refs[0][k], refs[1][k])
                   for k in range(FLEET_HOT_KEYS))
    mixed, n_old, n_new, n_either = [], 0, 0, 0
    for k, sent, done, got in records:
        if window and done < window["start"]:
            n_old += 1
            ok = same_answer(np, got, refs[0][k])
        elif window and sent > window["end"]:
            n_new += 1
            ok = same_answer(np, got, refs[1][k])
        else:
            n_either += 1
            ok = (same_answer(np, got, refs[0][k])
                  or same_answer(np, got, refs[1][k]))
        if not ok:
            mixed.append((k, rel(sent), rel(done)))
    print(f"  hot-key answers: {n_old} before the swap equal step 0's, "
          f"{n_new} sent after it equal step 1's, {n_either} during it "
          f"equal one of them; {len(mixed)} do not; the two steps answer "
          f"differently on {distinct} of {FLEET_HOT_KEYS} keys", flush=True)

    # ---- a refilled replica answers as its peers ----
    reps = sorted(pool._replicas, key=lambda r: r.idx)
    refilled = [r for r in reps if r.idx >= FLEET_REPLICAS]
    lines = [corpus[i][0] for i in range(FLEET_HOT_KEYS)]
    answers = {r.idx: [serialize_prediction(x)
                       for x in r.server.model.predict(lines)] for r in reps}
    fingerprints = {b["fingerprint"] for b in builds}

    # ---- the autoscaler on the live pool, an injected clock ----
    clk = [0.0]
    scaler = AutoScaler(pool, telemetry=tele, clock=lambda: clk[0],
                        hold_s=60.0, rules=[AlertRule(
                            "fleet_probe", metric="fleet/probe_load", op=">",
                            value=1.0, severity="page")])
    fe.autoscaler = scaler
    tele.gauge("fleet/probe_load", 5.0, emit=False)
    mem_pre = mem_gb()
    t = time.perf_counter()
    up = scaler.tick()
    grow_s = time.perf_counter() - t
    size_up, mem_3 = pool.size(), mem_gb()
    tele.gauge("fleet/probe_load", 0.5, emit=False)
    clk[0] = 10.0
    armed = scaler.tick()
    clk[0] = 71.0
    down = scaler.tick()
    size_down = pool.size()
    print(f"  autoscaler: {up!r} -> {size_up} replicas (a java-large replica "
          f"built and warmed in {grow_s:.2f} s; memory allocated "
          f"{mem_pre:.3f} -> {mem_3:.3f} GB), then {armed!r} at t = 10 s, "
          f"{down!r} at t = 71 s -> {size_down}", flush=True)
    status, body, _ = http_get(fe.bound_port, "/pool")
    pool_json = json.loads(body)
    status_m, metrics_text, _ = http_get(fe.bound_port, "/metrics")
    metrics = parse_prometheus(metrics_text)
    top = obs_top.EndpointState(f"127.0.0.1:{fe.bound_port}")
    top.poll(60.0)
    frame = obs_top.render([top.poll(60.0)])
    print("  obs_top over the front end:\n    "
          + frame.replace("\n", "\n    "), flush=True)
    fe.stop()
    rm.stop()
    pool.close()
    print(f"  memory allocated: {mem_2:.3f} GB with 2 replicas, "
          f"{mem_swap if mem_swap is None else round(mem_swap, 3)} GB after "
          f"the swap (one shared set), {mem_3:.3f} GB with 3 replicas "
          f"(before the phase {mem0:.3f} GB)", flush=True)

    # ---- the JAX leg's contract, then what only the card shows ----
    check(not events.get("error"), f"chaos actions: {events.get('error')}")
    check(load["errors"] == 0, f"{load['errors']} errors: "
          f"{load.get('first_error')}")
    check(load["requests"] == load["ok"] + load["shed"],
          "requests != ok + shed")
    check(max(lat["p99_ms"], p99_all) <= config.SERVE_SLO_MS,
          f"p99 {lat['p99_ms']:.2f} (last 2048) / {p99_all:.2f} ms (all) "
          f"over the {config.SERVE_SLO_MS} ms SLO")
    check(kill_fired == 1, f"serve/kill fired {kill_fired} times")
    check(counters.get("serve/replica_dead", 0) == 1
          and counters.get("serve/replica_refill", 0) == 1,
          f"deaths {counters.get('serve/replica_dead')}, refills "
          f"{counters.get('serve/replica_refill')}")
    check(rm.last_step == 1 and table["generation"] == 1,
          f"swapped step {rm.last_step}, generation {table['generation']}")
    check(bool(window) and window["end"] <= t_end, "step 1 not swapped "
          "under load")
    check(sorted(rm.refused) == [2], f"refused steps {sorted(rm.refused)}")
    check(refused_state == "firing", f"reload_refused {refused_state}")
    check(compile_delta == 0, f"compile_delta {compile_delta}")
    check(table["ready"] >= FLEET_REPLICAS, f"{table['ready']} ready")
    check(launches["attention_pool"] >= 1, "kernel 1 never launched under "
          "the load")
    check(min_ready >= FLEET_REPLICAS - 1, f"{min_ready} ready mid-swap")
    check(distinct >= FLEET_HOT_KEYS // 2, f"steps 0 and 1 answer alike on "
          f"{FLEET_HOT_KEYS - distinct} hot keys: the check would be vacuous")
    check(n_old >= 1 and n_new >= 1, f"hot-key answers {n_old} before, "
          f"{n_new} after the swap")
    check(not mixed, f"answers of neither weight set: {mixed[:5]}")
    check(len(refilled) == 1, f"refilled replicas {[r.idx for r in refilled]}")
    check(all(answers[r.idx] == answers[reps[0].idx] for r in reps),
          "a refilled replica answers otherwise than its peers")
    check(len(fingerprints) == 1, f"the factory built {len(fingerprints)} "
          "different weight sets")
    check(statuses and set(statuses) == {200}
          and len(statuses) >= (t_end - t_load) / FLEET_HEALTHZ_S / 4,
          f"/healthz {len(statuses)} polls: {sorted(set(statuses))}")
    check(up == "up" and size_up == FLEET_REPLICAS + 1 and armed is None
          and down == "down" and size_down == FLEET_REPLICAS,
          f"autoscaler {up}, {armed}, {down}; sizes {size_up}, {size_down}")
    check(status == 200 and pool_json["generation"] == 1
          and pool_json["reload"]["refused"] == [2]
          and "autoscale" in pool_json, f"/pool {status}: {body[:300]}")
    check(status_m == 200 and scalar(metrics, "serve_reloads") == 1
          and scalar(metrics, "serve_replica_dead") == 1,
          "/metrics lacks the fleet's counters")
    check("1/1 hosts up" in frame, "obs_top did not read the front end")
    seconds = time.perf_counter() - t_phase
    print(f"  [20] the JAX serve_swap_kill contract held on the card; "
          f"{seconds:.1f} s", flush=True)
    report["fleet"] = {
        "requests": load["requests"], "ok": load["ok"], "shed": load["shed"],
        "errors": load["errors"], "latency_ms": lat, "p99_all_ms": p99_all,
        "throughput_rps": load["throughput_rps"], "server_ms": server_ms,
        "requests_per_replica": per_replica, "drain_swap_ms": drains,
        "swap_window_s": [window["start"] - t_load, window["end"] - t_load],
        "events_s": {k: v - t_load for k, v in events.items()
                     if isinstance(v, float)},
        "cache_hits": counters.get("serve/cache_hit", 0),
        "launches": launches, "hot_answers": [n_old, n_new, n_either],
        "mem_gb": {"before": mem0, "replicas_2": mem_2,
                   "after_swap": mem_swap, "before_grow": mem_pre,
                   "replicas_3": mem_3},
        "full_collections": [[t0 - t_load, ms * 1e3]
                             for t0, ms in collections],
        "replica_build_s": [b["s"] for b in builds], "grow_s": grow_s,
        "healthz_polls": len(statuses), "seconds": seconds}
    return launches


# ---- [21] the VarMisuse head (kernels 1 and 5) ----

# (f) and (g): the candidate slots (the JAX default MAX_CANDIDATES); the
# command line's dataset (rows of the train, val and test splits, seed)
# and settings (tests/test_varmisuse.py's vm_config, where the command
# line has a flag)
VM_K = 8
VM_ROWS, VM_SEED = (1200, 150, 100), 11
VM_CLI_FLAGS = ["--head", "varmisuse", "--max_contexts", "64",
                "--batch_size", "32", "--epochs", "8", "--lr", "0.02",
                "--no_bf16", "--max_candidates", "6"]
# the JAX test's accuracy floor (5 live candidates: chance 0.2)
VM_MIN_ACC = 0.7


def vm_vocabs(vocabs):
    """[4]'s token and path vocabularies with the VarMisuse head's stub
    target vocabulary (its targets are the candidates)."""
    from code2vec_tpu_torch.vocab.vocabularies import (Code2VecVocabs, Vocab,
                                                       VocabType)
    return Code2VecVocabs(vocabs.token_vocab, vocabs.path_vocab,
                          Vocab(VocabType.Target, ["method"]))


def write_vm_file(np, path: str, n_rows: int, rng) -> None:
    """A `.vm.c2v` file of `n_rows` rows: a label in [0, VM_K), VM_K
    candidate words and 20..C contexts, the words drawn Zipf (s = ZIPF_S)
    over the synthetic vocab as `write_training_file` draws them."""
    tok, pth = (zipf_cdf(np, JAVA_LARGE[k]) for k in ("token", "path"))
    n_ctx = rng.integers(min(20, C), C + 1, n_rows)
    total = int(n_ctx.sum())
    src = np.searchsorted(tok, rng.random(total))
    dst = np.searchsorted(tok, rng.random(total))
    paths = np.searchsorted(pth, rng.random(total)) * 1000003
    cands = np.searchsorted(tok, rng.random((n_rows, VM_K)))
    labels = rng.integers(0, VM_K, n_rows)
    ctx = [f"tok{a},{p},tok{b}" for a, p, b in
           zip(src.tolist(), paths.tolist(), dst.tolist())]
    with open(path, "w") as f:
        start = 0
        for i, n in enumerate(n_ctx.tolist()):
            f.write(f"{labels[i]} " + ",".join(f"tok{c}" for c in cands[i])
                    + " " + " ".join(ctx[start:start + n]) + "\n")
            start += n


def vm_config(label: str, sparse: bool):
    """(f): the JAX package's defaults (bf16 tables and compute, Adafactor
    on the tables, Adam on the rest, cosine LR); (g): Adam, constant LR,
    --sparse_embeddings. Both at java-large width, B = TRAIN_B."""
    from code2vec_tpu_torch.config import Config
    kw = (dict(SPARSE_EMBEDDING_UPDATES=True, EMBEDDING_OPTIMIZER="adam",
               LR_SCHEDULE="constant") if sparse else {})
    cfg = Config(MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E,
                 TRAIN_BATCH_SIZE=TRAIN_B, TEST_BATCH_SIZE=TRAIN_B,
                 HEAD="varmisuse", MAX_CANDIDATES=VM_K, SEED=SEED, **kw)
    check((cfg.TABLES_DTYPE, cfg.USE_BF16) == ("bfloat16", True),
          f"({label}) not bf16")
    return cfg


def vm_counted(torch, np, model, data_path, label, want_rows):
    """The main path: `train` for TRAIN_STEPS steps with the counters at
    0 just before and read just after."""
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.ops.sparse_update_kernel import \
        sparse_row_adam_fused
    attention_pool_fused.launches = 0
    sparse_row_adam_fused.launches = 0
    t = time.perf_counter()
    losses = model.train(data_path, max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = {"attention_pool": attention_pool_fused.launches,
                "sparse_row_adam": sparse_row_adam_fused.launches}
    want = {"attention_pool": TRAIN_STEPS,
            "sparse_row_adam": TRAIN_STEPS * want_rows}
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"({label}) losses {losses}")
    check(launches == want, f"({label}) launches {launches}, expected {want}")
    print(f"  ({label}) train: {TRAIN_STEPS} steps in {run_s:.2f} s (host "
          f"parse included), losses {', '.join(f'{x:.5f}' for x in losses)}; "
          f"launches {launches}", flush=True)
    return launches, losses, run_s


def vm_fall(torch, np, model, batch, label):
    """The loss over FALL_STEPS steps of one batch and one set of draws."""
    fixed = model.draws_for(TRAIN_B, model.step_num)
    fall = [model.train_step(batch, fixed).item() for _ in range(FALL_STEPS)]
    check(all(np.isfinite(fall)) and fall[-1] < fall[0],
          f"({label}) loss over a repeated batch: {fall}")
    print(f"  ({label}) repeated batch, {FALL_STEPS} steps: "
          f"{', '.join(f'{x:.5f}' for x in fall)}", flush=True)
    return fall


def vm_step_ms(torch, model, batch):
    """Median of TIMED_STEPS synchronised steps, host clock."""
    ms = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.train_step(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return ms, sorted(ms)[len(ms) // 2]


def vm_split(torch, model, stages):
    """Each of `stages` [(name, fn(draws) -> None)] timed with CUDA events
    over TIMED_STEPS steps (one step's work, in order) -> median ms."""
    split = {n: [] for n, _ in stages}
    for _ in range(TIMED_STEPS):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(stages) + 2)]
        ev[0].record()
        d = model.draws_for(TRAIN_B, model.step_num)
        ev[1].record()
        for i, (_n, fn) in enumerate(stages):
            fn(d)
            ev[i + 2].record()
        ev[-1].synchronize()
        model.step_num += 1
        split.setdefault("draws", []).append(ev[0].elapsed_time(ev[1]))
        for i, (n, _fn) in enumerate(stages):
            split[n].append(ev[i + 1].elapsed_time(ev[i + 2]))
    return {n: sorted(v)[len(v) // 2] for n, v in split.items()}


def phase_vm_dense(torch, np, vocabs, data_path, report):
    """(f): the dense vm step at java-large width; returns the model (for
    the evaluation) and the counted run's launches."""
    from code2vec_tpu_torch.data.vm_reader import VMTextReader
    from code2vec_tpu_torch.models.vm_model import VarMisuseModel
    from code2vec_tpu_torch.training.steps import (apply_dense_updates,
                                                   dense_loss_and_grads)
    from code2vec_tpu_torch.training.vm_steps import make_vm_loss_fn
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = vm_config("f", sparse=False)
    model = VarMisuseModel(cfg, vocabs)  # device=None: the card
    check(model.device.type == "cuda", f"(f) model on {model.device}")
    dims = model.dims
    print(f"  (f) tables {tuple(model.params['token_emb'].shape)}, "
          f"{tuple(model.params['path_emb'].shape)} bf16, target "
          f"{tuple(model.params['target_emb'].shape)}, vm_pointer "
          f"{tuple(model.params['vm_pointer'].shape)}; Adafactor + Adam, "
          f"cosine LR; set up in {time.perf_counter() - t0:.1f} s", flush=True)
    launches, losses, run_s = vm_counted(torch, np, model, data_path, "f", 0)

    # ---- one step: kernel 1 vs its plain version, one state and draws ----
    reader = VMTextReader(data_path, vocabs, C, VM_K, TRAIN_B)
    batch = model.device_batch(next(iter(reader)))
    draws = model.draws_for(TRAIN_B, model.step_num)
    params, state, opt = model.params, model.opt_state, model.optimizer
    loss_fn_k = make_vm_loss_fn(dims, compute_dtype=torch.bfloat16,
                                use_kernel=True)
    loss_fn_p = make_vm_loss_fn(dims, compute_dtype=torch.bfloat16,
                                use_kernel=False)
    loss_k, grads, view = dense_loss_and_grads(params, batch, draws, loss_fn_k)
    loss_p, grads_p, _ = dense_loss_and_grads(params, batch, draws, loss_fn_p)
    grad_rel = {k: ((grads[k].float() - grads_p[k].float()).norm()
                    / grads_p[k].float().norm().clamp_min(1e-30)).item()
                for k in ("transform", "attention", "vm_pointer")}
    del grads_p
    updates = opt.update(grads, state, view)
    twin = clone_state(torch, params)
    apply_dense_updates(params, updates, draws.salts, use_kernel=True)
    apply_dense_updates(twin, updates, draws.salts, use_kernel=False)
    torch.cuda.synchronize()
    lk, lp = loss_k.item(), loss_p.item()
    rel = abs(lk - lp) / abs(lp)
    check(rel <= LOSS_RTOL, f"(f) loss kernel {lk} plain {lp}")
    for k in params:
        check(torch.equal(params[k], twin[k]),
              f"(f) {k}: kernel step and plain step differ given one update")
    model.step_num += 1
    del twin, grads, view, updates
    torch.cuda.empty_cache()
    print(f"  (f) kernel step vs plain step: loss {lk:.6f} vs {lp:.6f} (rel "
          f"{rel:.2e}); gradient l2 rel " + ", ".join(
              f"{k} {v:.2e}" for k, v in grad_rel.items()) +
          "; the same update gives bit-identical params", flush=True)

    same_bits_twice(torch, model, batch, "f", report)
    fall = vm_fall(torch, np, model, batch, "f")
    torch.cuda.reset_peak_memory_stats()  # the steps' peak, not the twin's
    step_ms, step_med = vm_step_ms(torch, model, batch)
    box = {}

    def fwd_bwd(d):
        box["out"] = dense_loss_and_grads(params, batch, d, loss_fn_k)

    def optimizer(d):
        box["upd"] = opt.update(box["out"][1], state, box["out"][2])

    def apply(d):
        apply_dense_updates(params, box.pop("upd"), d.salts)
        box.clear()
    med = vm_split(torch, model, [("forward+backward", fwd_bwd),
                                  ("optimizer", optimizer),
                                  ("apply", apply)])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  (f) step {step_med:.2f} ms (median of {TIMED_STEPS}, host clock, "
          f"synchronised); by phase (CUDA events, median): " +
          ", ".join(f"{n} {ms:.3f}" for n, ms in med.items()) +
          f"; peak device memory of the steps {peak_gb:.2f} GB", flush=True)
    prof, busy, _ = profile_step(torch, "f", lambda: model.train_step(batch),
                                 step_med)
    report["vm_f"] = {
        "launches": launches, "losses": losses, "run_s": run_s,
        "loss_kernel": lk, "loss_plain": lp, "loss_rel": rel,
        "grad_rel": grad_rel, "repeated_batch_losses": fall,
        "step_ms": step_ms, "step_ms_median": step_med,
        "phase_ms_median": med, "peak_memory_gb": peak_gb, "profile": prof,
        "device_busy_share": busy}
    return model, launches


def phase_vm_sparse(torch, np, vocabs, data_path, report):
    """(g): the sparse-row vm step (kernel 5 on token and path) at
    java-large width; returns the counted run's launches."""
    from code2vec_tpu_torch.data.vm_reader import VMTextReader
    from code2vec_tpu_torch.models.vm_model import VarMisuseModel
    from code2vec_tpu_torch.training.sparse_steps import apply_dense_updates
    from code2vec_tpu_torch.training.sparse_update import adam_lr_t, apply_rows
    from code2vec_tpu_torch.training.steps import dense_loss_and_grads
    from code2vec_tpu_torch.training.vm_steps import (VM_TABLE_KEYS,
                                                      apply_vm_row_updates,
                                                      make_vm_loss_fn,
                                                      vm_table_ids)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = VarMisuseModel(vm_config("g", sparse=True), vocabs)
    check(model.device.type == "cuda", f"(g) model on {model.device}")
    print(f"  (g) bf16 tables, Adam, constant LR, --sparse_embeddings; set up "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    launches, losses, run_s = vm_counted(torch, np, model, data_path, "g",
                                         len(VM_TABLE_KEYS))

    # ---- one step: kernel 5 vs its plain version, one state and draws ----
    reader = VMTextReader(data_path, vocabs, C, VM_K, TRAIN_B)
    batch = model.device_batch(next(iter(reader)))
    draws = model.draws_for(TRAIN_B, model.step_num)
    params, state, opt = model.params, model.opt_state, model.optimizer
    loss_fn = make_vm_loss_fn(model.dims, compute_dtype=torch.bfloat16)
    twin_p, twin_s = clone_state(torch, params), clone_state(torch, state)
    loss, grads, _view = dense_loss_and_grads(params, batch, draws, loss_fn)
    dense = {k: g for k, g in grads.items() if k not in VM_TABLE_KEYS}
    apply_dense_updates(params, state, opt, dense)
    U = apply_vm_row_updates(params, state, grads, batch, opt.learning_rate,
                             use_kernel=True)
    apply_dense_updates(twin_p, twin_s, opt, dense)
    apply_vm_row_updates(twin_p, twin_s, grads, batch, opt.learning_rate,
                         use_kernel=False)
    torch.cuda.synchronize()
    errs, notes = {}, []
    for k in params:
        errs[k], note = compare_tables(torch, f"(g) {k}", params[k],
                                       twin_p[k], U.get(k, 0) * E)
        notes.append(f"{k} {note}")
    for k, st in state["rows"].items():
        errs[f"rows.{k}"] = max(
            compare_moments(torch, f"(g) {k}.m", st.m, twin_s["rows"][k].m),
            compare_moments(torch, f"(g) {k}.v", st.v, twin_s["rows"][k].v))
        notes.append(f"{k} moments " + (
            "bit-identical" if torch.equal(st.m, twin_s["rows"][k].m)
            and torch.equal(st.v, twin_s["rows"][k].v)
            else f"max|d| {errs[f'rows.{k}']:.3g}"))
    model.step_num += 1
    del twin_p, twin_s, grads, dense
    torch.cuda.empty_cache()
    print(f"  (g) kernel 5 vs plain rows, one step (loss {loss.item():.6f}): "
          f"{'; '.join(notes)}; U {U}", flush=True)

    same_bits_twice(torch, model, batch, "g", report)
    fall = vm_fall(torch, np, model, batch, "g")
    torch.cuda.reset_peak_memory_stats()  # the steps' peak, not the twin's
    step_ms, step_med = vm_step_ms(torch, model, batch)
    box = {}

    def backward(d):
        box["loss"], box["grads"], _ = dense_loss_and_grads(params, batch, d,
                                                            loss_fn)

    def unique_gather(d):
        ids = vm_table_ids(batch)
        box["rows"] = {}
        for k in VM_TABLE_KEYS:
            uids = torch.unique(ids[k].to(torch.int32))
            box["rows"][k] = (uids, torch.index_select(
                box["grads"][k], 0, uids).to(torch.float32))

    def dense_adam(d):
        apply_dense_updates(params, state, opt, {
            k: g for k, g in box["grads"].items() if k not in VM_TABLE_KEYS})

    def row_apply(d):
        lr_t = adam_lr_t(state["count"], opt.learning_rate, 0.9, 0.999)
        for k, (uids, seg) in box["rows"].items():
            apply_rows(params[k], state["rows"][k], uids, seg, lr_t=lr_t,
                       b1=0.9, b2=0.999, eps=1e-8)
        box.clear()
    med = vm_split(torch, model, [("dense backward", backward),
                                  ("unique+gather", unique_gather),
                                  ("dense Adam", dense_adam),
                                  ("row apply", row_apply)])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  (g) step {step_med:.2f} ms (median of {TIMED_STEPS}, host clock, "
          f"synchronised); by phase (CUDA events, median): " +
          ", ".join(f"{n} {ms:.3f}" for n, ms in med.items()) +
          f"; peak device memory of the steps {peak_gb:.2f} GB", flush=True)
    prof, busy, row_ms = profile_step(torch, "g",
                                      lambda: model.train_step(batch),
                                      step_med, name_part="row_adam_kernel")
    report["vm_g"] = {
        "launches": launches, "losses": losses, "run_s": run_s,
        "errors": errs, "unique_rows": U, "repeated_batch_losses": fall,
        "step_ms": step_ms, "step_ms_median": step_med,
        "phase_ms_median": med, "peak_memory_gb": peak_gb, "profile": prof,
        "device_busy_share": busy, "kernel5_ms_per_step": row_ms}
    del model, params, state, opt
    torch.cuda.empty_cache()
    return launches


def vm_plain_eval(torch, params, batch):
    """The vm eval step with the attention pool's plain float32 version
    where the kernel runs (the code cast to bf16 after, as the kernel path
    casts it): (loss_sum, pred)."""
    from code2vec_tpu_torch.models.encoder import gather_contexts, take_rows
    from code2vec_tpu_torch.models.varmisuse import candidate_ce
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_plain
    labels, src, pth, dst, mask, cand, cand_mask, weights = batch
    ctx = gather_contexts(params, src, pth, dst, torch.bfloat16)
    code, _ = attention_pool_plain(ctx, params["transform"],
                                   params["attention"], mask)
    q = code.to(torch.bfloat16).float() @ params["vm_pointer"]
    scores = torch.einsum("be,bke->bk", q, take_rows(
        params, "token_emb", cand).float())
    scores = torch.where(cand_mask > 0, scores, torch.full_like(scores, -1e9))
    return ((candidate_ce(scores, labels) * weights).sum(),
            torch.argmax(scores, dim=-1))


def phase_vm_eval(torch, np, model, test_path, report):
    """`evaluate` over the 4096-row file (counted: kernel 1 once a batch),
    the kernel path against the plain path batch by batch, and
    `predict_batch` on 25 rows (counted) against the plain path's pred."""
    from code2vec_tpu_torch.data.vm_reader import VMTextReader, parse_vm_rows
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.training.vm_steps import vm_eval_step
    # stretched as [9] stretches: tables near 0 tie every candidate
    for key in ("token_emb", "path_emb"):
        t = model.params[key]
        t.mul_(1.0 / t.float().abs().max().item())
    model.evaluate(test_path)  # warm
    n_batches = -(-EVAL_METHODS // TRAIN_B)
    attention_pool_fused.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    results = model.evaluate(test_path)
    eval_s = time.perf_counter() - t
    eval_launches = attention_pool_fused.launches
    check(eval_launches == n_batches, f"vm eval: attention_pool launched "
          f"{eval_launches} times for {n_batches} batches")
    check(np.isfinite(results.loss) and 0 <= results.accuracy <= 1
          and results.num_examples == EVAL_METHODS, f"vm eval {results}")
    rate = EVAL_METHODS / eval_s
    print(f"  evaluate: {EVAL_METHODS} rows in {n_batches} batches of "
          f"{TRAIN_B}, {eval_s:.3f} s ({rate:.0f} methods/s, host parse "
          f"included); {results}; kernel 1 launches {eval_launches}",
          flush=True)
    loss_k = loss_p = 0.0
    same = total = 0
    with torch.inference_mode():
        for b in VMTextReader(test_path, model.vocabs, C, VM_K, TRAIN_B):
            batch = model.device_batch(b)
            lk, _ck, pk = vm_eval_step(model.params, batch,
                                       compute_dtype=torch.bfloat16)
            lp, pp = vm_plain_eval(torch, model.params, batch)
            nv = b.num_valid_examples
            loss_k += lk.item()
            loss_p += lp.item()
            same += int((pk[:nv] == pp[:nv]).sum().item())
            total += nv
    rel = abs(loss_k - loss_p) / abs(loss_p)
    share = same / total
    check(rel <= LOSS_RTOL, f"vm eval loss kernel {loss_k} plain {loss_p}")
    check(share >= EVAL_TOP1_SHARE, f"vm eval pred equal on {same}/{total}")
    with open(test_path) as f:
        rows = [next(f) for _ in range(25)]
    attention_pool_fused.launches = 0
    pred = model.predict_batch(rows)
    predict_launches = attention_pool_fused.launches
    check(predict_launches == 1, f"predict_batch launched kernel 1 "
          f"{predict_launches} times")
    parsed = parse_vm_rows(rows, model.vocabs, C, VM_K)
    batch = tuple(torch.from_numpy(a).to(model.device) for a in parsed[:8])
    with torch.inference_mode():
        _lp, plain_pred = vm_plain_eval(torch, model.params, batch)
    check(pred.shape == (25,) and np.array_equal(pred, plain_pred.cpu().numpy()),
          f"predict_batch {pred} vs plain {plain_pred.cpu().numpy()}")
    print(f"  kernel path vs plain path: loss sum {loss_k:.4f} vs {loss_p:.4f} "
          f"(rel {rel:.2e}), pred equal on {same}/{total}; predict_batch on 25 "
          f"rows: the plain path's ids, kernel 1 launched once", flush=True)
    report["vm_eval"] = {
        "rows": EVAL_METHODS, "seconds": eval_s, "methods_per_s": rate,
        "loss": results.loss, "accuracy": results.accuracy,
        "loss_rel_kernel_plain": rel, "pred_equal_share": share,
        "launches": eval_launches, "predict_launches": predict_launches}
    return eval_launches + predict_launches


class VMRecorder:
    """Every `VarMisuseModel` that `from_config` makes while in a `with`."""

    def __enter__(self):
        from code2vec_tpu_torch.models.vm_model import VarMisuseModel
        self.cls, self.made = VarMisuseModel, []
        real_from, made = VarMisuseModel.from_config.__func__, self.made

        def from_config(cls, *a, **k):
            m = real_from(cls, *a, **k)
            made.append(m)
            return m
        VarMisuseModel.from_config = classmethod(from_config)
        return self

    def __exit__(self, *exc):
        del self.cls.from_config  # back to the inherited one
        return False


def phase_vm_cli(torch, np, tmp, report):
    """The command line: `write_vm_dataset` through the port's native
    extractor, then `cli.main` with `--head varmisuse` (accuracy, reload,
    auto-resume, the refused combinations, a profiled run)."""
    import contextlib
    import io
    import shutil
    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.data.varmisuse_gen import write_vm_dataset
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.training import checkpoint as ckpt
    t0 = time.perf_counter()
    prefix = os.path.join(tmp, "vm_cli")
    write_vm_dataset(prefix, *VM_ROWS, seed=VM_SEED)
    gen_s = time.perf_counter() - t0
    val = prefix + ".val.vm.c2v"
    save = os.path.join(tmp, "vm_ckpt")
    argv = [*VM_CLI_FLAGS, "--data", prefix, "--save", save, "--test", val,
            "--auto_resume"]
    attention_pool_fused.launches = 0
    t = time.perf_counter()
    with VMRecorder() as rec:
        check(cli.main(argv) == 0, "vm cli: training run failed")
    train_s = time.perf_counter() - t
    cli_launches = attention_pool_fused.launches
    full = rec.made[-1]
    steps = full.step_num
    check(cli_launches > steps, f"vm cli: kernel 1 launched {cli_launches} "
          f"times over {steps} steps and the evaluations")
    acc = full.evaluate(val)
    check(acc.accuracy >= VM_MIN_ACC, f"vm cli: accuracy {acc}")
    out = io.StringIO()
    with VMRecorder() as rec, contextlib.redirect_stdout(out):
        # the compute dtype is a flag, not a checkpoint key
        check(cli.main(["--load", save, "--test", val, "--no_bf16"]) == 0,
              "vm cli: --load --test failed")
    check(str(acc) in out.getvalue(), f"vm cli: reload printed "
          f"{out.getvalue()!r}, the trained model gives {acc}")
    final = {"p": full.params, "s": full.opt_state}
    check(state_diff(torch, {"p": rec.made[-1].params},
                     {"p": full.params})["differ"] == 0,
          "vm cli: reloaded params differ")
    errs = io.StringIO()
    with contextlib.redirect_stderr(errs):
        rc_head = cli.main(["--load", save, "--head", "code2vec", "--test",
                            val])
        rc_int8 = cli.main([*VM_CLI_FLAGS, "--data", prefix,
                            "--tables_dtype", "int8"])
    check((rc_head, rc_int8) == (2, 2), f"vm cli: refused combinations exit "
          f"{rc_head}, {rc_int8}: {errs.getvalue()!r}")
    # the step before the end set aside: --auto_resume trains the last epoch
    last = ckpt.latest_step(save)
    shutil.rmtree(os.path.join(save, f"step_{last}"))
    before = ckpt.latest_step(save)
    with VMRecorder() as rec:
        check(cli.main(argv) == 0, "vm cli: resumed run failed")
    resumed = rec.made[-1]
    diff = state_diff(torch, {"p": resumed.params, "s": resumed.opt_state},
                      final)
    check(resumed.step_num == steps and diff["differ"] == 0,
          f"vm cli: --auto_resume from step {before} ends at step "
          f"{resumed.step_num} with {diff['differ']} of {diff['tensors']} "
          f"tensors differing")
    # the same command profiled, into another dir
    tele = os.path.join(tmp, "vm_tele")
    with VMRecorder() as rec:
        check(cli.main([*VM_CLI_FLAGS, "--data", prefix, "--save",
                        os.path.join(tmp, "vm_prof"), "--test", val,
                        "--phase_profile", "on", "--phase_sample_every", "16",
                        "--telemetry_dir", tele]) == 0,
              "vm cli: profiled run failed")
    prof = rec.made[-1]
    pdiff = state_diff(torch, {"p": prof.params, "s": prof.opt_state}, final)
    (run,) = os.listdir(tele)
    with open(os.path.join(tele, run, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    phases = [e for e in events if e["kind"] == "phase"]
    check(pdiff["differ"] == 0 and phases, f"vm cli: the profiled run "
          f"differs on {pdiff['differ']} tensors, {len(phases)} samples")
    summary = [e for e in events if e["kind"] == "summary"][-1]
    phase_ms = {p: summary["timers"][f"train/phase/{p}_ms"]["p50_ms"]
                for p in ("embed_gather", "forward_pool", "backward",
                          "table_apply")}
    print(f"  command line: {sum(VM_ROWS)} rows written in {gen_s:.1f} s; "
          f"{steps} steps + {VM_CLI_FLAGS[VM_CLI_FLAGS.index('--epochs') + 1]}"
          f" evaluations in {train_s:.1f} s (kernel 1 {cli_launches} "
          f"launches); {acc}; --load --test the same; --load --head code2vec "
          f"and --tables_dtype int8 exit 2; --auto_resume from step {before} "
          f"bit-identical; --phase_profile on bit-identical, {len(phases)} "
          f"samples, p50 ms " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in phase_ms.items()),
          flush=True)
    report["vm_cli"] = {"rows": VM_ROWS, "gen_s": gen_s, "train_s": train_s,
                        "steps": steps, "accuracy": acc.accuracy,
                        "loss": acc.loss, "launches": cli_launches,
                        "resumed_from": before, "phase_samples": len(phases),
                        "phase_p50_ms": phase_ms}
    return cli_launches


def phase_vm(torch, np, vocabs, tmp, report):
    """[21]: the VarMisuse head on the card: (f), (g), the evaluation and
    `predict_batch`, the command line. Returns the launches by kernel."""
    vv = vm_vocabs(vocabs)
    data_path = os.path.join(tmp, "vm.train.vm.c2v")
    test_path = os.path.join(tmp, "vm.test.vm.c2v")
    t0 = time.perf_counter()
    write_vm_file(np, data_path, (TRAIN_STEPS + 1) * TRAIN_B,
                  np.random.default_rng(SEED + 2))
    write_vm_file(np, test_path, EVAL_METHODS, np.random.default_rng(SEED + 3))
    print(f"  synthetic .vm.c2v: {(TRAIN_STEPS + 1) * TRAIN_B} training and "
          f"{EVAL_METHODS} test rows, K = {VM_K}, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    model, f_launches = phase_vm_dense(torch, np, vv, data_path, report)
    eval_launches = phase_vm_eval(torch, np, model, test_path, report)
    del model
    torch.cuda.empty_cache()
    g_launches = phase_vm_sparse(torch, np, vv, data_path, report)
    cli_launches = phase_vm_cli(torch, np, tmp, report)
    launches = {"attention_pool": f_launches["attention_pool"]
                + g_launches["attention_pool"] + eval_launches + cli_launches,
                "sparse_row_adam": g_launches["sparse_row_adam"]}
    report["vm_launches"] = {"f": f_launches, "g": g_launches,
                             "eval_predict": eval_launches,
                             "cli": cli_launches}
    return launches


# ---- [22] the adversarial attacks and the rename defense ----

# attack_method on this many methods of the test file (each untargeted
# and targeted); attack_batch's M; the sweep's methods; the transformer's
ATK_SERIAL, ATK_BATCH_M, ATK_SWEEP, ATK_XF = 8, 64, 256, 4
# kernel path vs plain path, one attack step of one method: the kernel
# pools in float32, the plain path in bf16 (the JAX package's XLA pool),
# so the plain code vector carries bf16 rounding; a single method's cross
# entropy, unlike (c)'s loss, is no mean over 1024 examples that averages
# it out: the exact losses within 2^-7 relative to max(1, |loss|) (a CPU
# rehearsal at a small vocab read 3e-3), and the accepted rename compared
# where the best two exact losses lie more than that apart. The
# first-order scores within ATK_SCORE_RTOL of their largest: both sides
# take the same plain recompute backward, but the two code vectors move
# the softmax's gradient (p - onehot) by ~1e-2 of itself. The
# transformer: its bf16 network's end-to-end bound (XF_E2E_PROB_RTOL)
ATK_LOSS_RTOL, ATK_SCORE_RTOL, ATK_XF_RTOL = 2.0 ** -7, 5e-2, XF_E2E_PROB_RTOL
# attack_batch vs attack_method: a method whose outcomes differ must be a
# tie: two exact losses of one decision within 2^-6 (relative to
# max(1, |loss|)) or a first-order shortlist boundary within
# ATK_SCORE_RTOL (a batch of 64 and a method alone round the logits'
# product otherwise)
ATK_TIE_RTOL = 2.0 ** -6
# the rename defense on (c) and (d): probability and mode
ATK_ADV = {"c": (0.3, "batch"), "d": (0.3, "uniform")}
# Input.java's corpus for the command line: Input.java's methods this many
# times, beside synthetic methods over these names and identifiers
ATK_JAVA_REPEAT, ATK_SYNTH, ATK_EPOCHS = 8, 96, 6
ATK_NAMES = ("get|value", "set|name", "is|empty", "to|string", "add|item",
             "sum|all", "find|index", "count|items")
ATK_IDENTS = ("count", "index", "value", "result", "item", "total", "size",
              "name", "flag", "temp", "offset", "limit", "buffer", "node",
              "key", "entry", "left", "right", "pivot", "sum")


def letter_word(i: int) -> str:
    """The i-th token word of the attacks' vocab: "zq" and i in base 26
    letters, an identifier the attack can render (the synthetic vocab's
    `tok<i>` has digits, which no rename may use)."""
    s = ""
    while True:
        s = chr(97 + i % 26) + s
        i //= 26
        if i == 0:
            return "zq" + s


def letter_vocabs(vocabs):
    """[4]'s vocab with letter token words at the same ids."""
    from code2vec_tpu_torch.vocab.vocabularies import (Code2VecVocabs, Vocab,
                                                       VocabType)
    return Code2VecVocabs(
        Vocab(VocabType.Token, (letter_word(i)
                                for i in range(JAVA_LARGE["token"]))),
        vocabs.path_vocab, vocabs.target_vocab)


def to_letters(line: str) -> str:
    import re
    return re.sub(r"\btok(\d+)\b", lambda m: letter_word(int(m.group(1))),
                  line)


def atk_model(torch, lv, transformer: bool):
    """[4]'s bag model (or [11]'s transformer) at java-large width over
    the letter vocab: seed 0's weights, stretched."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.encoder import init_params
    from code2vec_tpu_torch.models.torch_model import (Code2VecModel,
                                                       dims_from_config)
    config = (xf_config() if transformer else
              Config(MAX_CONTEXTS=C, USE_BF16=True, TABLES_DTYPE="bfloat16"))
    dims = dims_from_config(config, lv)
    params = init_params(torch.Generator(device=DEV).manual_seed(SEED), dims)
    stretch_tables(params)
    return Code2VecModel(config, dims, lv, params)  # the card


class StepTimer:
    """Wraps an attack's step functions (and the host shortlist) for the
    length of a `with`: each call synchronised and timed, and each exact
    evaluation's decision gap recorded (the untargeted attack loss's
    best two candidates, and the best against the current id)."""

    def __init__(self, torch, attack, tga):
        self.torch, self.attack, self.tga = torch, attack, tga
        self.ms = {"score": 0.0, "eval": 0.0, "predict": 0.0,
                   "shortlist": 0.0}
        self.calls = {k: 0 for k in self.ms}
        self.gaps, self.boundaries = [], []

    def _timed(self, name, fn, after=None):
        torch = self.torch

        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.ms[name] += (time.perf_counter() - t) * 1e3
            self.calls[name] += 1
            if after is not None:
                after(a, out)
            return out
        return run

    def _gap(self, _args, out):
        import numpy as np
        att = -out[0].float().cpu().numpy()   # untargeted: maximize CE
        best = np.sort(att[:-1])[:2]
        scale = 1.0 + abs(float(best[0]))
        self.gaps.append(min(best[1] - best[0] if len(best) > 1 else 1.0,
                             abs(att[-1] - best[0])) / scale)

    def _boundary(self, scores, legal, tried, k):
        import numpy as np
        scores[~legal] = np.inf
        scores[list(tried)] = np.inf
        finite = scores[np.isfinite(scores)]
        if len(finite) > k:
            part = np.partition(finite, (k - 2, k - 1))
            self.boundaries.append(float(part[k - 1] - part[k - 2])
                                   / max(float(np.abs(finite).max()), 1e-30))

    def __enter__(self):
        a = self.attack
        self.real = (a.score_fn, a.eval_fn, a.predict_fn,
                     self.tga.build_shortlist)
        a.score_fn = self._timed("score", a.score_fn)
        a.eval_fn = self._timed("eval", a.eval_fn, self._gap)
        a.predict_fn = self._timed("predict", a.predict_fn)
        real_short = self.tga.build_shortlist

        def shortlist(scores, legal, tried, k, cur):
            self._boundary(scores.copy(), legal, tried, k)
            t = time.perf_counter()
            out = real_short(scores, legal, tried, k, cur)
            self.ms["shortlist"] += (time.perf_counter() - t) * 1e3
            self.calls["shortlist"] += 1
            return out
        self.tga.build_shortlist = shortlist
        return self

    def __exit__(self, *exc):
        a = self.attack
        a.score_fn, a.eval_fn, a.predict_fn, self.tga.build_shortlist = \
            self.real
        return False


def atk_kernel_vs_plain(torch, np, model, attack, methods, label,
                        score_rtol, loss_rtol):
    """One attack step per method with the kernels and with their plain
    versions: the first-order scores (relative to their largest), the
    exact losses of one shortlist, and the accepted rename where the best
    two exact losses lie more than `loss_rtol` apart; the score the same
    bits twice. -> (worst score rel, worst loss rel, decided)."""
    from code2vec_tpu_torch.attacks import gradient_attack as tga
    score_p, eval_p, _ = tga.make_attack_steps(
        model.dims, compute_dtype=model.compute_dtype, use_kernel=False)
    worst_s = worst_l = 0.0
    decided = 0
    for m in methods:
        tok = attack.attackable_tokens(m[0], m[2], m[3])[0][0]
        occ = attack.tensors((m[0] == tok, m[2] == tok))
        ids = attack.tensors(m)
        lab = int(attack.predict_fn(model.params, ids))
        sk = attack.score_fn(model.params, ids, occ, lab, -1.0)
        sk2 = attack.score_fn(model.params, ids, occ, lab, -1.0)
        sp = score_p(model.params, ids, occ, lab, -1.0)
        check(torch.equal(sk, sk2), f"({label}) the score gave other bits "
              f"on a second call")
        rel = ((sk - sp).abs().max() / sp.abs().max()).item()
        worst_s = max(worst_s, rel)
        host = sk.cpu().numpy()
        tried = {tok} | set(np.unique(np.concatenate([m[0], m[2]])).tolist())
        cand = tga.build_shortlist(host.copy(), attack.legal, tried,
                                   attack.top_k, tok)
        lk, _ = attack.eval_fn(model.params, ids, occ, attack.tensor(cand), lab)
        lp, _ = eval_p(model.params, ids, occ, attack.tensor(cand), lab)
        lk, lp = lk.float().cpu().numpy(), lp.float().cpu().numpy()
        lrel = float(np.max(np.abs(lk - lp) / np.maximum(1.0, np.abs(lp))))
        worst_l = max(worst_l, lrel)
        top = np.sort(lp[:-1])[::-1][:2]
        if top[0] - top[1] > loss_rtol * max(1.0, abs(top[0])):
            decided += 1
            check(int(np.argmax(lk[:-1])) == int(np.argmax(lp[:-1])),
                  f"({label}) kernel and plain paths accept different "
                  f"renames where the best two losses are {top}")
    check(worst_s <= score_rtol, f"({label}) first-order scores kernel vs "
          f"plain: {worst_s} of the largest")
    check(worst_l <= loss_rtol, f"({label}) exact losses kernel vs plain: "
          f"{worst_l}")
    return worst_s, worst_l, decided


def phase_attack_bag(torch, np, vocabs, lv, tmp, test_path, peaks, report):
    """(h): the attack at java-large width on [4]'s bag model."""
    from code2vec_tpu_torch.attacks import gradient_attack as tga
    from code2vec_tpu_torch.attacks.detect import RarityDetector
    from code2vec_tpu_torch.attacks.robustness import evaluate_robustness
    from code2vec_tpu_torch.data.reader import parse_c2v_rows
    from code2vec_tpu_torch.ops.attention_kernel import (attention_pool_fused,
                                                         tc_terms)
    out = {}
    with open(test_path) as f:
        lines = [to_letters(next(f)) for _ in range(ATK_SWEEP)]
    sweep_path = os.path.join(tmp, "attack.test.c2v")
    with open(sweep_path, "w") as f:
        f.writelines(lines)
    model = atk_model(torch, lv, transformer=False)
    _labels, src, pth, dst, mask, _t, _c = parse_c2v_rows(lines, lv, C)
    methods = [(src[i], pth[i], dst[i], mask[i]) for i in range(len(lines))]
    t0 = time.perf_counter()
    attack = tga.GradientRenameAttack(
        model.dims, lv.token_vocab, lv.target_vocab,
        compute_dtype=model.compute_dtype)   # device=None: the card
    out["setup_s"] = time.perf_counter() - t0
    target = lv.target_vocab.lookup_word(
        min(2 + 4099, lv.target_vocab.size - 1))

    # ---- serial: the main path, counted (after one warm-up attack on a
    # method outside the 8, so the per-call times are steady) ----
    attack.attack_method(model.params, methods[-1])
    results = []
    with StepTimer(torch, attack, tga) as timer:
        attention_pool_fused.launches = 0
        t = time.perf_counter()
        for m in methods[:ATK_SERIAL]:
            results.append(attack.attack_method(model.params, m))
        for m in methods[:ATK_SERIAL]:
            results.append(attack.attack_method(
                model.params, m, targeted=True, target_name=target))
        torch.cuda.synchronize()
        serial_s = time.perf_counter() - t
        launches = attention_pool_fused.launches
    want = sum(2 + 2 * r.iterations for r in results)
    check(launches == want, f"(h) kernel 1 launched {launches} times; the "
          f"trajectories imply {want}")
    device_ms = timer.ms["score"] + timer.ms["eval"] + timer.ms["predict"]
    host_share = 1.0 - device_ms / (serial_s * 1e3)
    n_succ = [sum(r.success for r in results[:ATK_SERIAL]),
              sum(r.success for r in results[ATK_SERIAL:])]
    out["serial"] = {
        "attacks": len(results), "seconds": serial_s, "launches": launches,
        "iterations": [r.iterations for r in results],
        "successes_untargeted_targeted": n_succ, "ms": timer.ms,
        "calls": timer.calls, "host_share": host_share}
    print(f"  (h) serial: {ATK_SERIAL} methods untargeted ({n_succ[0]} "
          f"flipped) and targeted at '{target}' ({n_succ[1]} reached) in "
          f"{serial_s:.2f} s; kernel 1 {launches} launches = 2 + 2 x "
          f"iterations; per call (synchronised) score "
          f"{timer.ms['score'] / max(timer.calls['score'], 1):.2f} ms, exact "
          f"re-score {timer.ms['eval'] / max(timer.calls['eval'], 1):.2f} ms,"
          f" predict {timer.ms['predict'] / max(timer.calls['predict'], 1):.2f}"
          f" ms, host argpartition "
          f"{timer.ms['shortlist'] / max(timer.calls['shortlist'], 1):.2f} "
          f"ms; host share of the attack (shortlist, the scores' copy, the "
          f"loop) {host_share:.3f}", flush=True)

    # ---- kernel vs plain, the same bits twice ----
    worst_s, worst_l, decided = atk_kernel_vs_plain(
        torch, np, model, attack, methods[:ATK_SERIAL], "h", ATK_SCORE_RTOL,
        ATK_LOSS_RTOL)
    out["kernel_vs_plain"] = {"score_rel": worst_s, "loss_rel": worst_l,
                              "decided": decided, "methods": ATK_SERIAL}
    print(f"  (h) kernel vs plain, one step of {ATK_SERIAL} methods: scores "
          f"within {worst_s:.2e} of the largest, exact losses within "
          f"{worst_l:.2e}; the same rename accepted on the {decided} methods "
          f"whose best two losses lie over {ATK_LOSS_RTOL} apart; the score "
          f"the same bits twice", flush=True)

    # ---- lockstep vs serial at M = 64 ----
    eligible = [m for m in methods
                if attack.attackable_tokens(m[0], m[2], m[3])][:ATK_BATCH_M]
    t = time.perf_counter()
    batch = attack.attack_batch(model.params, eligible)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t
    equal = tied = 0
    for i, m in enumerate(eligible):
        with StepTimer(torch, attack, tga) as one:
            s = attack.attack_method(model.params, m)
        b = batch[i]
        if (s.success, s.renames, s.final_prediction, s.iterations) == \
                (b.success, b.renames, b.final_prediction, b.iterations):
            equal += 1
            continue
        tie = min(one.gaps) <= ATK_TIE_RTOL or \
            min(one.boundaries, default=1.0) <= ATK_SCORE_RTOL
        check(tie, f"(h) attack_batch and attack_method differ on method "
              f"{i} without a tie: {b} vs {s}")
        tied += 1
    out["lockstep"] = {"M": len(eligible), "equal": equal, "tied": tied,
                       "batch_s": batch_s}
    print(f"  (h) attack_batch at M = {len(eligible)} ({batch_s:.2f} s, "
          f"M x K = {len(eligible) * attack.top_k} variants a re-score): "
          f"{equal} methods equal to attack_method, {tied} differ on a "
          f"tie", flush=True)

    # ---- kernel 1 at B = M x K, the new shape ----
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    out["pool_2048"] = pool_case(torch, ATK_BATCH_M * attack.top_k,
                                 torch.bfloat16, gen, peaks, tc_terms())

    # ---- the sweep with the rarity detector ----
    dict_path = os.path.join(tmp, "attack.dict.c2v")
    write_dict_file(dict_path, ATK_SWEEP, token_word=letter_word,
                    token_count=lambda i: max(1, int(1e6 / (i + 1) ** ZIPF_S)))
    detector = RarityDetector.from_model(model, dict_path)
    sweep_ms = {"score": 0.0, "eval": 0.0, "predict": 0.0}
    real_steps = tga.make_batched_attack_steps

    def timed_steps(*a, **k):
        fns = real_steps(*a, **k)

        def wrap(name, fn):
            def run(*aa, **kk):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                r = fn(*aa, **kk)
                torch.cuda.synchronize()
                sweep_ms[name] += (time.perf_counter() - t1) * 1e3
                return r
            return run
        return tuple(wrap(n, f) for n, f in zip(("score", "eval", "predict"),
                                                fns))
    # the attacks' own time (the report's `seconds` is rounded to 0.1 s):
    # the lockstep passes, synchronised at their ends
    real_batch = tga.GradientRenameAttack.attack_batch
    batch_s = [0.0]

    def timed_batch(self, *a, **k):
        t1 = time.perf_counter()
        r = real_batch(self, *a, **k)
        torch.cuda.synchronize()
        batch_s[0] += time.perf_counter() - t1
        return r
    torch.cuda.reset_peak_memory_stats()
    tga.make_batched_attack_steps = timed_steps
    tga.GradientRenameAttack.attack_batch = timed_batch
    try:
        attention_pool_fused.launches = 0
        rep = evaluate_robustness(model, sweep_path, n_methods=ATK_SWEEP,
                                  detector=detector, log=lambda *_: None)
        sweep_launches = attention_pool_fused.launches
    finally:
        tga.make_batched_attack_steps = real_steps
        tga.GradientRenameAttack.attack_batch = real_batch
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(rep["n_methods"] == ATK_SWEEP and sweep_launches > 0
          and batch_s[0] > 0,
          f"(h) sweep: {rep['n_methods']} methods, {sweep_launches} launches")
    step_s = sum(sweep_ms.values()) / 1e3
    sweep_host = 1.0 - step_s / batch_s[0]
    print("  (h) sweep report: " + json.dumps(rep), flush=True)
    print(f"  (h) sweep: {ATK_SWEEP / batch_s[0]:.1f} methods/s over "
          f"{ATK_SWEEP} methods ({batch_s[0]:.3f} s in attack_batch), peak "
          f"device memory {peak_gb:.2f} GB, kernel 1 {sweep_launches} "
          f"launches; the step functions (synchronised) {step_s:.3f} s "
          f"(score {sweep_ms['score'] / 1e3:.3f}, re-score "
          f"{sweep_ms['eval'] / 1e3:.3f}, predict "
          f"{sweep_ms['predict'] / 1e3:.3f}), host share "
          f"{sweep_host:.3f}", flush=True)
    out["sweep"] = {"report": rep, "attack_s": batch_s[0],
                    "methods_per_s": ATK_SWEEP / batch_s[0],
                    "peak_memory_gb": peak_gb, "launches": sweep_launches,
                    "step_ms": sweep_ms, "host_share": sweep_host}
    report["attack_bag"] = out
    del model, attack, detector
    torch.cuda.empty_cache()
    return launches + sweep_launches


def phase_attack_xf(torch, np, lv, tmp, report):
    """(i): attack_method on bench.py's transformer (L = 2, H = 3): kernel
    2 L times a forward, kernel 3 L times a score; against the plain
    versions."""
    from code2vec_tpu_torch.attacks import gradient_attack as tga
    from code2vec_tpu_torch.data.reader import parse_c2v_rows
    model = atk_model(torch, lv, transformer=True)
    with open(os.path.join(tmp, "attack.test.c2v")) as f:
        lines = [next(f) for _ in range(ATK_XF)]
    _l, src, pth, dst, mask, _t, _c = parse_c2v_rows(lines, lv, C)
    methods = [(src[i], pth[i], dst[i], mask[i]) for i in range(ATK_XF)]
    attack = tga.GradientRenameAttack(model.dims, lv.token_vocab,
                                      lv.target_vocab,
                                      compute_dtype=model.compute_dtype)
    zero_xf_counts()
    t = time.perf_counter()
    results = [attack.attack_method(model.params, m) for m in methods]
    torch.cuda.synchronize()
    xf_s = time.perf_counter() - t
    counts = xf_counts()
    iters = sum(r.iterations for r in results)
    want = {"attention_pool": 0,
            "xf_attention_forward": XF_L * (2 * ATK_XF + 2 * iters),
            "xf_attention_backward": XF_L * iters}
    check(counts == want, f"(i) launches {counts}, the trajectories imply "
          f"{want}")
    worst_s, worst_l, decided = atk_kernel_vs_plain(
        torch, np, model, attack, methods, "i", ATK_XF_RTOL, ATK_XF_RTOL)
    print(f"  (i) transformer: {ATK_XF} methods attacked in {xf_s:.2f} s "
          f"({iters} iterations; {sum(r.success for r in results)} flipped); "
          f"launches {counts} (kernel 3 in each score); kernel vs plain: "
          f"scores within {worst_s:.2e} of the largest, losses "
          f"{worst_l:.2e}, the same rename on {decided} decided methods; the "
          f"score the same bits twice", flush=True)
    report["attack_xf"] = {"seconds": xf_s, "launches": counts,
                           "iterations": iters, "score_rel": worst_s,
                           "loss_rel": worst_l, "decided": decided}
    del model, attack
    torch.cuda.empty_cache()
    return counts


def phase_defended(torch, np, vocabs, lv, data_path, report):
    """(j): (c) and (d) with the rename defense: counted steps, the
    augmented batch against the CPU augment's, kernel vs plain step, one
    step twice, the step time beside the undefended one's."""
    import itertools

    from code2vec_tpu_torch.attacks.defense import (RenameDraws,
                                                    make_rename_augment)
    from code2vec_tpu_torch.data.reader import C2VTextReader
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.ops.requant_kernel import requantize_fused
    from code2vec_tpu_torch.training.draws import quantized_keys
    from code2vec_tpu_torch.training.steps import (apply_dense_updates,
                                                   dense_loss_and_grads,
                                                   make_train_loss_fn)
    total = {"attention_pool": 0, "requantize": 0}
    for label, tables, sampled in (("c", "bfloat16", False),
                                   ("d", "int8", True)):
        prob, mode = ATK_ADV[label]
        _, cfg = dense_config(label, tables, sampled)
        cfg.ADV_RENAME_PROB, cfg.ADV_RENAME_MODE = prob, mode
        tag = f"{label}+defense"
        trainer = Code2VecTrainer(cfg, lv)  # the card
        aug = trainer.step_config.augment
        check(aug is not None and (aug.prob, aug.mode) == (prob, mode),
              f"({tag}) the step has no augment")
        qkeys = quantized_keys(trainer.params)
        reader = C2VTextReader(data_path, vocabs, C, TRAIN_B)
        batches = [trainer.device_batch(b)
                   for b in itertools.islice(iter(reader), TRAIN_STEPS)]
        attention_pool_fused.launches = 0
        requantize_fused.launches = 0
        losses = [trainer.train_step(b).item() for b in batches]
        launches = {"attention_pool": attention_pool_fused.launches,
                    "requantize": requantize_fused.launches}
        want = {"attention_pool": TRAIN_STEPS,
                "requantize": TRAIN_STEPS * len(qkeys)}
        check(launches == want and all(np.isfinite(losses)),
              f"({tag}) launches {launches} (want {want}), losses {losses}")
        for k in total:
            total[k] += launches[k]
        batch = batches[0]
        draws = trainer.draws_for(TRAIN_B, trainer.step_num)
        got = aug(batch, draws.rename)
        r = draws.rename
        cpu = make_rename_augment(aug.legal_mask.cpu().numpy(), prob, mode,
                                  device="cpu")
        want_b = cpu(tuple(t.cpu() for t in batch), RenameDraws(
            gumbel=r.gumbel.cpu(), index=r.index.cpu(),
            apply_u=r.apply_u.cpu(), shift=r.shift))
        check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want_b)),
              f"({tag}) the card's augmented batch differs from the CPU "
              f"augment's")
        renamed = int(((got[1] != batch[1]).any(1)
                       | (got[3] != batch[3]).any(1)).sum().item())
        check(0 < renamed < TRAIN_B, f"({tag}) {renamed} examples renamed")
        # one step with the kernels against one with the plain versions
        kw = dict(use_sampled_softmax=sampled, num_sampled=TRAIN_S,
                  compute_dtype=trainer.compute_dtype)
        loss_k, grads, view = dense_loss_and_grads(
            trainer.params, got, draws, make_train_loss_fn(
                trainer.dims, use_kernel=True, **kw))
        loss_p, _, _ = dense_loss_and_grads(
            trainer.params, got, draws, make_train_loss_fn(
                trainer.dims, use_kernel=False, **kw))
        updates = trainer.optimizer.update(grads, trainer.opt_state, view)
        twin = clone_state(torch, trainer.params)
        apply_dense_updates(trainer.params, updates, draws.salts,
                            use_kernel=True)
        apply_dense_updates(twin, updates, draws.salts, use_kernel=False)
        lk, lp = loss_k.item(), loss_p.item()
        check(abs(lk - lp) <= LOSS_RTOL * abs(lp),
              f"({tag}) loss kernel {lk} plain {lp}")
        for k in trainer.params:
            a, b = trainer.params[k], twin[k]
            pairs = ([(a["q"], b["q"]), (a["s"], b["s"])]
                     if isinstance(a, dict) else [(a, b)])
            check(all(torch.equal(x, y) for x, y in pairs),
                  f"({tag}) {k}: kernel and plain steps differ given the "
                  f"same update")
        trainer.step_num += 1
        del twin, grads, view, updates
        torch.cuda.empty_cache()
        same_bits_twice(torch, trainer, batch, tag, report)
        step_ms = []
        for _ in range(TIMED_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        med = sorted(step_ms)[len(step_ms) // 2]
        plain = report.get(f"train_{label}", {}).get("step_ms_median")
        print(f"  ({tag}) --adv_rename_prob {prob} {mode}: {TRAIN_STEPS} "
              f"steps, launches {launches}; the augmented batch ({renamed} of "
              f"{TRAIN_B} examples renamed) the CPU augment's id for id; "
              f"kernel step vs plain: loss {lk:.6f} vs {lp:.6f}, the same "
              f"update bit-identical; step {med:.2f} ms (median of "
              f"{TIMED_STEPS}) against {fmt_ms(plain)} undefended in [8]",
              flush=True)
        report[f"defended_{label}"] = {
            "prob": prob, "mode": mode, "launches": launches,
            "losses": losses, "renamed": renamed, "loss_kernel": lk,
            "loss_plain": lp, "step_ms": step_ms, "step_ms_median": med,
            "undefended_step_ms_median": plain}
        del trainer, batches, batch, got
        torch.cuda.empty_cache()
    return total


def write_input_corpus(np, path: str, java_lines, rng) -> None:
    """Input.java's extracted methods ATK_JAVA_REPEAT times and ATK_SYNTH
    synthetic methods over ATK_NAMES and ATK_IDENTS, in raw extractor
    format."""
    lines = list(java_lines) * ATK_JAVA_REPEAT
    for _ in range(ATK_SYNTH):
        name = ATK_NAMES[int(rng.integers(len(ATK_NAMES)))]
        ctx = [f"{ATK_IDENTS[int(rng.integers(len(ATK_IDENTS)))]},"
               f"{int(rng.integers(1, 400)) * 7919},"
               f"{ATK_IDENTS[int(rng.integers(len(ATK_IDENTS)))]}"
               for _ in range(int(rng.integers(8, 40)))]
        lines.append(name + " " + " ".join(ctx))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def phase_attack_cli(torch, np, tmp, report):
    """(k): the command line's --attack and --adv_rename_prob and the
    REPL's `attack`, on a model trained on a corpus with Input.java's
    methods."""
    import contextlib
    import io
    import shutil
    import unittest.mock

    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data import preprocess
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.serving.extractor import Extractor
    from code2vec_tpu_torch.serving.interactive_predict import \
        InteractivePredictor
    repo = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(tmp, "attack_cli")
    os.makedirs(work)
    victim = os.path.join(work, "Input.java")
    shutil.copy(os.path.join(repo, "Input.java"), victim)
    names, java = Extractor(Config()).extract_paths(victim)
    raw = os.path.join(work, "raw.txt")
    write_input_corpus(np, raw, java, np.random.default_rng(SEED + 22))
    prefix = os.path.join(work, "input")
    with contextlib.redirect_stdout(io.StringIO()):
        preprocess.main(["--train_data", raw, "--val_data", raw,
                         "--test_data", raw, "--output_name", prefix])
    attention_pool_fused.launches = 0
    ckpt_plain, ckpt_adv = (os.path.join(work, "model"),
                            os.path.join(work, "model_adv"))
    train = ["--data", prefix, "--epochs", str(ATK_EPOCHS), "--batch_size",
             "16", "--lr", "0.01"]
    t = time.perf_counter()
    check(cli.main([*train, "--save", ckpt_plain]) == 0, "(k) training")
    check(cli.main([*train, "--save", ckpt_adv, "--adv_rename_prob", "0.3"])
          == 0, "(k) defended training")
    train_s = time.perf_counter() - t
    with open(os.path.join(ckpt_adv, "manifest.json")) as f:
        m = json.load(f)
    check((m["adv_rename_prob"], m["adv_rename_mode"]) == (0.3, "uniform"),
          f"(k) the defended run's manifest: {m.get('adv_rename_prob')}, "
          f"{m.get('adv_rename_mode')}")

    def run(argv):
        so, se = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            rc = cli.main(argv)
        return rc, so.getvalue(), se.getvalue()
    other = {"contains": "maxValue", "max|value": "contains"}.get(names[0],
                                                                 "maxValue")
    outcomes = {}
    for tag, extra in (("untargeted", ["--attack", "untargeted"]),
                       ("targeted", ["--attack", "targeted",
                                     "--attack_target", other]),
                       ("deadcode", ["--attack", "untargeted",
                                     "--attack_deadcode"]),
                       ("3 renames", ["--attack", "untargeted",
                                      "--attack_method_index", "1",
                                      "--attack_max_renames", "3"])):
        adv = victim + ".adversarial"
        if os.path.exists(adv):
            os.remove(adv)
        rc, so, se = run(["--load", ckpt_plain, "--attack_input", victim,
                          *extra])
        check(rc == 0 and ("re-extracted prediction" in so
                           or "(no rename)" in so),
              f"(k) --attack {tag}: exit {rc}, {so!r} {se[-500:]!r}")
        verified = "SUCCESS end-to-end" in so
        check(os.path.exists(adv) == verified, f"(k) --attack {tag}: "
              f".adversarial exists {os.path.exists(adv)}, printed {so!r}")
        outcomes[tag] = so.strip()
        if tag == "untargeted":
            # [28]'s --attack pair is held against this run
            adv_digest = file_digest(adv) if verified else None
        print(f"  (k) --attack {tag}: " + so.strip().replace("\n", " | "),
              flush=True)
    for argv, msg in (
            (["--load", ckpt_plain, "--attack", "untargeted", "--tables_dtype",
              "int8", "--attack_input", victim], "--attack needs float/bf16"),
            (["--data", prefix, "--attack", "untargeted"],
             "--attack requires --load.")):
        rc, _so, se = run(argv)
        check(rc == 2 and msg in se, f"(k) {argv}: exit {rc}, {se!r}")
    cfg = Config.load_from_args(["--load", ckpt_plain])
    model = Code2VecTrainer.from_config(cfg).predictor()
    keys = iter(["attack", f"attack {other}", "q"])
    so = io.StringIO()
    with unittest.mock.patch("builtins.input", lambda *a: next(keys)), \
            contextlib.redirect_stdout(so):
        InteractivePredictor(cfg, model).predict(victim)
    repl = so.getvalue().splitlines()
    answered = [ln for ln in repl if ln.startswith(("[untargeted ",
                                                     "[targeted ",
                                                     "Attack error:"))]
    check(len(answered) == 2 and repl[-1] == "Exiting...",
          f"(k) the REPL's attack answered {answered}")
    launches = attention_pool_fused.launches
    check(launches > 0, "(k) kernel 1 never launched")
    print(f"  (k) two trainings ({train_s:.1f} s; the defended one's "
          f"manifest records adv_rename_prob 0.3), --attack int8 and "
          f"without --load exit 2; the REPL answered: "
          + " | ".join(answered) + f"; kernel 1 {launches} launches",
          flush=True)
    report["attack_cli"] = {"outcomes": outcomes, "repl": answered,
                            "train_s": train_s, "launches": launches,
                            "ckpt": ckpt_plain, "victim": victim,
                            "untargeted_adversarial": adv_digest}
    del model
    torch.cuda.empty_cache()
    return launches


def phase_attack_vm(torch, tmp, report):
    """(l): `python -m code2vec_tpu_torch.attacks.vm_robustness` (its
    `main`, in this process) on [21]'s checkpoint and test split."""
    import contextlib
    import io

    from code2vec_tpu_torch.attacks import vm_robustness
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    so = io.StringIO()
    attention_pool_fused.launches = 0
    t = time.perf_counter()
    with contextlib.redirect_stdout(so):
        rc = vm_robustness.main(["--load", os.path.join(tmp, "vm_ckpt"),
                                 "--test", os.path.join(tmp,
                                                        "vm_cli.test.vm.c2v")])
    vm_s = time.perf_counter() - t
    launches = attention_pool_fused.launches
    line = so.getvalue().strip().splitlines()[-1]
    rep = json.loads(line)
    check(rc == 0 and rep["n_methods"] > 0 and
          launches >= 2 * rep["n_methods"],
          f"(l) exit {rc}, {line}, kernel 1 {launches} launches")
    print(f"  (l) vm_robustness ({vm_s:.1f} s, kernel 1 {launches} "
          f"launches): {line}", flush=True)
    report["attack_vm"] = {"report": rep, "launches": launches,
                           "seconds": vm_s}
    return launches


def phase_attacks(torch, np, vocabs, tmp, data_path, test_path, peaks,
                  report):
    """[22]: (h) to (l). Returns the launches by kernel."""
    t0 = time.perf_counter()
    lv = letter_vocabs(vocabs)
    print(f"  letter token vocab built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    bag = phase_attack_bag(torch, np, vocabs, lv, tmp, test_path, peaks,
                           report)
    xf = phase_attack_xf(torch, np, lv, tmp, report)
    defended = phase_defended(torch, np, vocabs, lv, data_path, report)
    cli_launches = phase_attack_cli(torch, np, tmp, report)
    vm_launches = phase_attack_vm(torch, tmp, report)
    phase_robustness_study(torch, np, tmp, report)
    return {"attention_pool": bag + defended["attention_pool"]
            + cli_launches + vm_launches,
            "xf_attention_forward": xf["xf_attention_forward"],
            "xf_attention_backward": xf["xf_attention_backward"],
            "requantize": defended["requantize"]}


# ---- [4], (c), (e): the float32 logits of bf16 operands ----

# the CPU test's bound (tests/test_torch_bf16_logits.py): each logit
# within 4 float32 ulp of sum_d |a_d * b_d|; the gradients, rounded to
# bf16 on both branches, within that plus 1 bf16 ulp of their largest
LOGITS_ULPS = 4
LOGITS_CPU_ROWS = 32768  # the rows held against the CPU branch


def logits_branches(torch, label, code, rows, report):
    """`ops/logits.rows_product_f32` on the card (`torch.mm(...,
    out_dtype=float32)`) against its CPU branch (`a.float() @
    b.float()`) on the same bf16 tensors, forward and both gradients,
    over the first LOGITS_CPU_ROWS rows; then its time on all the rows
    beside the product rounded to bf16 before the cast, the cost of the
    fix."""
    from code2vec_tpu_torch.ops.logits import rows_product_f32
    n = min(rows.shape[0], LOGITS_CPU_ROWS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    g = torch.randn((code.shape[0], n), generator=gen, device="cuda")
    outs = {}
    for dev in ("cuda", "cpu"):
        a = code.detach().to(dev).requires_grad_(True)
        r = rows[:n].detach().to(dev).requires_grad_(True)
        y = rows_product_f32(a, r)
        ga, gr = torch.autograd.grad(y, [a, r], g.to(dev))
        outs[dev] = [t.detach().double().cpu() for t in (y, ga, gr)]
    ulp = LOGITS_ULPS * 2.0 ** -23
    a64 = code.double().cpu().abs()
    r64 = rows[:n].to(code.dtype).double().cpu().abs()
    g64 = g.to(code.dtype).double().cpu().abs()
    bounds = [ulp * a64 @ r64.T, ulp * g64 @ r64, ulp * g64.T @ a64]
    worst = []
    for i, (x, y, b) in enumerate(zip(outs["cuda"], outs["cpu"], bounds)):
        if i:
            b = b + 2.0 ** -7 * y.abs().max()
        d = (x - y).abs()
        worst.append(d.max().item())
        check(bool((d <= b).all()), f"({label}) float32 logits: the card's "
              f"mm.dtype branch vs the CPU branch, output {i}: {d.max()} "
              f"over the bound")
    f32_ms = time_ms(torch, lambda: rows_product_f32(code, rows), reps=10)
    rounded_ms = time_ms(torch, lambda: (code @ rows.to(code.dtype).T)
                         .to(torch.float32), reps=10)
    report[f"logits_f32_{label}"] = {
        "shape": [code.shape[0], rows.shape[0], code.shape[1]],
        "max_abs_diff_cpu": worst, "f32_out_ms": f32_ms,
        "bf16_rounded_ms": rounded_ms}
    print(f"  ({label}) float32 logits [{code.shape[0]}, {rows.shape[0]}] "
          f"from bf16: the card's mm.dtype branch vs the CPU branch on "
          f"{n} rows, largest differences (logits, dcode, drows) "
          f"{', '.join(f'{w:.3g}' for w in worst)} within {LOGITS_ULPS} "
          f"float32 ulp of sum|a*b| (+1 bf16 ulp for the gradients); "
          f"{f32_ms:.3f} ms vs {rounded_ms:.3f} ms rounded to bf16 first "
          f"(CUDA events)", flush=True)


def random_code(torch, rows: int, seed: int):
    """A bf16 [rows, D] code vector block of the spread a pool gives."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.rand((rows, D), generator=gen, device="cuda") * 2 - 1) \
        .to(torch.bfloat16)


# ---- [22]: the robustness study ----

RS_TRAIN, RS_VAL, RS_ATTACKS = 512, 48, 8


def write_study_corpus(np, raw_dir: str) -> None:
    """Raw extractor lines whose target is recoverable from its
    identifiers (the class picks them; the paths carry it 30% of the
    time), all-letter identifiers the attack can rename."""
    rng = np.random.default_rng(SEED + 22)
    for split, n in (("train", RS_TRAIN), ("val", RS_VAL), ("test", RS_VAL)):
        with open(os.path.join(raw_dir, f"{split}.txt"), "w") as f:
            for _ in range(n):
                k = int(rng.integers(len(ATK_NAMES)))
                ctxs = []
                for _ in range(int(rng.integers(3, 12))):
                    a = ATK_IDENTS[(k + int(rng.integers(2)))
                                   % len(ATK_IDENTS)]
                    b = ATK_IDENTS[(3 * k + int(rng.integers(2)))
                                   % len(ATK_IDENTS)]
                    p = 1000 + (k if rng.random() < 0.3
                                else int(rng.integers(50)))
                    ctxs.append(f"{a},{p},{b}")
                f.write(ATK_NAMES[k] + " " + " ".join(ctxs) + "\n")


def phase_robustness_study(torch, np, tmp, report) -> None:
    """`python -m code2vec_tpu_torch.tools.robustness_study` on the card
    (its `main`, in this process): both arms, one epoch, a tiny corpus,
    `--detect`; one JSON row an arm and the table."""
    import contextlib
    import io

    from code2vec_tpu_torch.data import preprocess
    from code2vec_tpu_torch.tools import robustness_study
    t0 = time.perf_counter()
    raw = os.path.join(tmp, "study_raw")
    os.makedirs(raw, exist_ok=True)
    write_study_corpus(np, raw)
    prefix = os.path.join(tmp, "study")
    sizes = ["--word_vocab_size", "1000", "--path_vocab_size", "1000",
             "--target_vocab_size", "1000"]
    preprocess.main(["--train_data", os.path.join(raw, "train.txt"),
                     "--val_data", os.path.join(raw, "val.txt"),
                     "--test_data", os.path.join(raw, "test.txt"),
                     "--max_contexts", "16", *sizes,
                     "--output_name", prefix])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = robustness_study.main([
            "--data", prefix, "--epochs", "1", "--batch", "64",
            "--n_attacks", str(RS_ATTACKS), "--max_contexts", "16",
            "--detect", *sizes])
    out = buf.getvalue().splitlines()
    rows = [json.loads(ln) for ln in out if ln.startswith("{")]
    check(rc == 0 and [r["arm"] for r in rows] == ["baseline", "defended"],
          f"(study) rc {rc}, rows {rows}")
    for r in rows:
        # the detector scores the successful variants: its keys come
        # with a success
        check(0 < r["n_attacks"] <= RS_ATTACKS
              and 0.0 <= r["attack_success_rate"] <= 1.0
              and 0.0 <= r["clean_top1"] <= 1.0
              and ("detection_auc" in r) == (r["attack_success_rate"] > 0),
              f"(study) row {r}")
    check(any(ln.startswith("arm ") for ln in out), "(study) no table")
    study_s = time.perf_counter() - t0
    report["robustness_study"] = {"rows": rows, "s": study_s}
    for ln in out:
        if ln.startswith("{") or ln.split()[:1] in (["arm"], ["baseline"],
                                                     ["defended"]):
            print(f"  (study) {ln}", flush=True)
    print(f"  (study) robustness_study on the card, {RS_TRAIN} methods, "
          f"1 epoch, both arms, --detect: {study_s:.1f} s", flush=True)


# ---- [23]: data-parallel training across processes ----

DP_WORLD = 2
DP_CHILD_TIMEOUT_S = 560
DP_REPS = 2  # timed steps of each kind in the harness (3 before [25])
DP_CONFIGS = {
    "c": [],
    "a": ["--sparse_embeddings", "--embedding_optimizer", "adam",
          "--lr_schedule", "constant", "--sampled_softmax", "--num_sampled",
          str(TRAIN_S)],
}
# epochs of each command-line run: (a)'s two epochs are [24]'s oracle of
# the supervised cohort killed after epoch 1's save
DP_EPOCHS = {"c": 1, "a": 2}
# the harness's sampled (c) steps under the phase profiler (the first
# also runs the probes once unrecorded), and the rename defense's
# probability in its batch-mode step
DP_PHASE_SAMPLES, DP_RENAME_PROB = 2, 0.5


def dp_flags(port: int, world: int, rank: int):
    return ["--dist_coordinator", f"127.0.0.1:{port}",
            "--dist_num_processes", str(world), "--dist_process_id",
            str(rank), "--mesh_data", str(world)]


def dp_argv(base, label: str):
    """[23]'s command line of configuration `label` without --save and
    the --dist_* flags ([24] runs (a)'s under the supervisor)."""
    return [str(a) for a in base] + DP_CONFIGS[label] + [
        "--epochs", str(DP_EPOCHS[label])]


def leaf_digests(torch, params) -> dict:
    """{leaf path: sha256 of its bytes} of a params tree."""
    import hashlib
    return {p: hashlib.sha256(t.detach().contiguous().view(torch.uint8)
                              .cpu().numpy().tobytes()).hexdigest()
            for p, t in named_tensors(params)}


def dp_child() -> None:
    """One rank of [23] (`python3 -c 'import chip_smoke;
    chip_smoke.dp_child()' <spec.json>`): the command line with the
    `--dist_*` flags for (c) then (a) (`cli.main`, which `python3 -m
    code2vec_tpu_torch` runs), then the function-level harness
    (`dp_harness`), then [25]'s context axis (`ctx_harness`, `ctx_cli`),
    [26]'s model axis (`model_harness`, `model_cli`) and [27]'s VarMisuse
    head and gathered tables under it (`vm_model_harness`), then [28]'s
    predict-side model and attack over the windows (`cohort_harness`).
    Prints `DP_RESULT <json>` and exits 0 only if all passed."""
    import torch

    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.models.torch_model import TrainerBase
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.ops.sparse_update_kernel import \
        sparse_row_adam_fused
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank, world = spec["rank"], spec["world"]
    out = {"rank": rank}
    # the identity the training loop stamps on its telemetry, read while
    # the process group is up (cli.main leaves the group at its end)
    identities = []
    real_identity = TrainerBase.identity

    def identity(self):
        identities.append(real_identity(self))
        return identities[-1]

    TrainerBase.identity = identity
    for label, port in zip(DP_CONFIGS, spec["ports"]):
        argv = dp_argv(spec["base"], label) + [
            "--save", spec["ckpt"][label]] + dp_flags(port, world, rank)
        attention_pool_fused.launches = 0
        sparse_row_adam_fused.launches = 0
        t = time.perf_counter()
        with Recorder(torch) as rec:
            rc = cli.main(argv)
        torch.cuda.synchronize()
        check(rc == 0, f"(dp {label}) rank {rank}: cli.main exited {rc}")
        trainer = rec.made[-1]
        out[label] = {
            "run_s": time.perf_counter() - t,
            "launches": {"attention_pool": attention_pool_fused.launches,
                         "sparse_row_adam": sparse_row_adam_fused.launches},
            "losses": rec.loss_values(), "steps": trainer.step_num,
            "digests": leaf_digests(torch, trainer.params),
            "evals": [(s, vars(r)) for s, r in rec.evals],
            "identity": identities[-1]}
        del rec, trainer
        torch.cuda.empty_cache()
    out["harness"] = dp_harness(torch, rank, world,
                                spec["ports"][len(DP_CONFIGS)], spec["train"])
    # [25]: the context axis in the same two processes (no new start-up)
    out["ctx"] = ctx_harness(torch, rank, world,
                             spec["ports"][len(DP_CONFIGS) + 1],
                             spec["train"])
    out["ctx_cli"] = ctx_cli(torch, rank, world,
                             spec["ports"][len(DP_CONFIGS) + 2], spec)
    # [26]: the model axis in the same two processes
    out["model"] = model_harness(torch, rank, world,
                                 spec["ports"][len(DP_CONFIGS) + 3], spec)
    out["model_cli"] = model_cli(torch, rank, world,
                                 spec["ports"][len(DP_CONFIGS) + 4], spec)
    # [27]: the VarMisuse head and the gathered tables under the model axis
    out["vm_model"] = vm_model_harness(torch, rank, world,
                                       spec["ports"][len(DP_CONFIGS) + 5],
                                       spec, synthetic_vocabs())
    # [28]: the predict-side model and the attack over the windows
    out["cohort"] = cohort_harness(torch, rank, world,
                                   spec["ports"][len(DP_CONFIGS) + 6], spec)
    print("DP_RESULT " + json.dumps(out), flush=True)


def dp_harness(torch, rank: int, world: int, port: int, data_path: str):
    """One step of (c) and one of (a) at java-large width on `world`
    ranks (gloo, the card shared) against one process over the ranks'
    batches concatenated, with the same draws; the two-rank step twice
    from one state (the same bits); mesh_sparse_apply against the
    one-process compact apply on the same global parts (the same bits);
    the step times of one rank alone and of `world` ranks, and the
    gradient all-reduce's."""
    import numpy as np
    import torch.distributed as dist

    from code2vec_tpu_torch.data.reader import C2VTextReader
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.parallel import distributed
    from code2vec_tpu_torch.parallel.sharding import (batch_rows,
                                                      check_replicas)
    from code2vec_tpu_torch.training.checkpoint import (map_state,
                                                        state_tensors)
    from code2vec_tpu_torch.training.draws import make_draws
    from code2vec_tpu_torch.training.sparse_steps import reduce_step_grads
    from code2vec_tpu_torch.training.steps import dense_loss_and_grads
    check(distributed.maybe_initialize(f"127.0.0.1:{port}", world, rank,
                                       device_type="cuda"),
          "(dp harness) no process group")
    check(distributed.backend() == "gloo", f"(dp harness) backend "
          f"{distributed.backend()} for {world} ranks on one card")
    vocabs = synthetic_vocabs()
    G = TRAIN_B * world
    glob_np = next(iter(C2VTextReader(data_path, vocabs, C, G)))
    out = {}
    for label, cfg in (dense_config("c", "bfloat16", False),
                       train_config("a", "bfloat16", True)):
        trainer = Code2VecTrainer(cfg, vocabs)  # the mesh: world ranks
        mesh = trainer.mesh
        check(mesh is not None and mesh.world == world,
              f"(dp {label}) mesh {mesh}")
        glob = trainer.device_batch(glob_np)
        lo, hi = batch_rows(mesh, TRAIN_B)
        local = tuple(t[lo:hi] for t in glob)
        step = trainer.step_num
        draws = trainer.draws_for(TRAIN_B, step)
        whole = make_draws(trainer.dims, trainer.step_config,
                           trainer.params, G, cfg.SEED, step, trainer.device)
        check(torch.equal(draws.keep, whole.keep[lo:hi])
              and (draws.sampled is None
                   or torch.equal(draws.sampled, whole.sampled)),
              f"(dp {label}) the rank's draws are not its rows of the "
              "global draws")
        live = {"params": trainer.params, "opt_state": trainer.opt_state}
        start = map_state(lambda t: t.detach().clone(), live)

        def restore():
            for dst, src in zip(state_tensors(live), state_tensors(start)):
                dst.copy_(src)

        runs = []
        for _ in range(2):
            restore()
            loss = trainer._train_step(trainer.params, trainer.opt_state,
                                       local, draws)
            runs.append((loss.item(), leaf_digests(torch, trainer.params)))
        check_replicas(trainer.params, mesh)
        check(runs[0] == runs[1], f"(dp {label}) the two-rank step twice "
              "from one state differs")
        two = map_state(lambda t: t.detach().clone(), trainer.params)
        # one process over the concatenated batch: the same step without
        # the mesh, on this rank alone
        restore()
        trainer.mesh = None
        trainer._build_step()
        one_loss = trainer._train_step(trainer.params, trainer.opt_state,
                                       glob, whole).item()
        diffs = {}
        for (path, a), (_p, b) in zip(named_tensors(two),
                                      named_tensors(trainer.params)):
            if a.dtype == torch.int8:
                diffs[path] = ((a.int() - b.int()).abs().max().item(), 1.0)
                continue
            fa, fb = a.float(), b.float()
            top = fb.abs().max().item()
            diffs[path] = ((fa - fb).abs().max().item(),
                           2 * cfg.LEARNING_RATE + 2.0 ** -7 * top)
        loss_rel = abs(runs[0][0] - one_loss) / abs(one_loss)
        check(loss_rel <= LOSS_RTOL and all(d <= b for d, b in
                                            diffs.values()),
              f"(dp {label}) two ranks vs one process: loss rel "
              f"{loss_rel:.3g}, {diffs}")
        # one rank alone at the local batch, then `world` ranks, timed
        restore()
        times = {"one_rank_ms": [], "ranks_ms": [], "allreduce_ms": []}
        dist.barrier()
        if rank == 0:
            for _ in range(DP_REPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                trainer._train_step(trainer.params, trainer.opt_state, local,
                                    draws)
                torch.cuda.synchronize()
                times["one_rank_ms"].append((time.perf_counter() - t) * 1e3)
        dist.barrier()
        restore()
        trainer.mesh = mesh
        trainer._build_step()
        for _ in range(DP_REPS):
            dist.barrier()
            torch.cuda.synchronize()
            t = time.perf_counter()
            trainer._train_step(trainer.params, trainer.opt_state, local,
                                draws)
            torch.cuda.synchronize()
            times["ranks_ms"].append((time.perf_counter() - t) * 1e3)
        if label == "c":
            from code2vec_tpu_torch.training.steps import \
                make_train_loss_fn
            loss_fn = make_train_loss_fn(
                trainer.dims, compute_dtype=trainer.compute_dtype,
                mesh=mesh)
            loss, grads, _view = dense_loss_and_grads(
                trainer.params, local, draws, loss_fn)
            out["allreduce_bytes"] = sum(g.numel() * g.element_size()
                                         for g in grads.values())
            for _ in range(DP_REPS):
                dist.barrier()
                torch.cuda.synchronize()
                t = time.perf_counter()
                reduce_step_grads(loss, grads, mesh)
                torch.cuda.synchronize()
                times["allreduce_ms"].append((time.perf_counter() - t) * 1e3)
            del grads
            restore()
            out["phases_c"] = dp_profiled_phases(torch, trainer, local)
        if label == "a":
            out["mesh_sparse_apply_exact"] = dp_sparse_apply_check(
                torch, trainer, mesh)
        out[label] = {"loss_two": runs[0][0], "loss_one": one_loss,
                      "loss_rel": loss_rel,
                      "worst": max(diffs.items(), key=lambda kv: kv[1][0]
                                   / kv[1][1]),
                      **{k: sorted(v)[len(v) // 2] if v else None
                         for k, v in times.items()}}
        del trainer, live, start, two, glob
        torch.cuda.empty_cache()
    out["rename"] = dp_batch_rename(torch, vocabs, glob_np, world)
    distributed.shutdown()
    return out


class ListSink:
    """A telemetry sink keeping its events in a list."""

    def __init__(self):
        self.events = []

    def write(self, event) -> None:
        self.events.append(event)

    def close(self) -> None:
        pass


def dp_profiled_phases(torch, trainer, local) -> dict:
    """[23]: DP_PHASE_SAMPLES sampled (c) steps at the mesh's ranks
    through the trainer's own phase profiler (`phase_profiler`, which
    hands the probes its mesh): the last sample's phase event, the
    all-reduce pair among its phases."""
    from code2vec_tpu_torch.obs import Telemetry
    tele = Telemetry.memory("train")
    sink = ListSink()
    tele.sinks = [sink]
    trainer.config.PHASE_PROFILE = "on"
    prof = trainer.phase_profiler(tele)
    check(prof.enabled, "(dp c) the phase profiler is off")
    for _ in range(DP_PHASE_SAMPLES):
        prof.run_split(trainer.params, trainer.opt_state, local,
                       trainer.draws_for(TRAIN_B, trainer.step_num),
                       step=trainer.step_num)
    torch.cuda.synchronize()
    (ev, *_r) = [e for e in reversed(sink.events) if e["kind"] == "phase"]
    trainer.config.PHASE_PROFILE = "off"
    check("allreduce_ms" in ev and "allreduce_exposed_ms" in ev
          and 0.0 <= ev["allreduce_exposed_ms"] <= ev["allreduce_ms"],
          f"(dp c) the profiled step's phases {ev}")
    return {k: v for k, v in ev.items() if k.endswith("_ms")}


def dp_batch_rename(torch, vocabs, glob_np, world: int) -> dict:
    """[23]: one (c) step with `--adv_rename_prob DP_RENAME_PROB
    --adv_rename_mode batch` at `world` ranks over [22]'s letter-word
    token vocab (a renamed token must render as an identifier): the
    ranks' augmented rows, gathered in rank order, are the bits of the
    one-process augment over the concatenated batch with the global
    draws; the step's loss and params against one process's over that
    batch within the harness's bounds (the gradients are summed in
    another order)."""
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.parallel.distributed import all_gather_rows
    from code2vec_tpu_torch.parallel.sharding import batch_rows
    from code2vec_tpu_torch.training.checkpoint import (map_state,
                                                        state_tensors)
    from code2vec_tpu_torch.training.draws import make_draws
    t0 = time.perf_counter()
    _, cfg = dense_config("c", "bfloat16", False)
    cfg.ADV_RENAME_PROB, cfg.ADV_RENAME_MODE = DP_RENAME_PROB, "batch"
    trainer = Code2VecTrainer(cfg, letter_vocabs(vocabs))  # the mesh
    mesh, aug = trainer.mesh, trainer.step_config.augment
    check(aug is not None and aug.mode == "batch", "(dp rename) no augment")
    G = TRAIN_B * world
    glob = trainer.device_batch(glob_np)
    lo, hi = batch_rows(mesh, TRAIN_B)
    local = tuple(t[lo:hi] for t in glob)
    step = trainer.step_num
    draws = trainer.draws_for(TRAIN_B, step)
    whole = make_draws(trainer.dims, trainer.step_config, trainer.params, G,
                       cfg.SEED, step, trainer.device)
    check(draws.rename.rows == (lo, hi)
          and draws.rename.shift == whole.rename.shift,
          f"(dp rename) the rank's rename draws: rows {draws.rename.rows}, "
          f"shift {draws.rename.shift} vs {whole.rename.shift}")
    got = aug(local, draws.rename)
    gathered = [all_gather_rows(got[i]) for i in (1, 3)]
    want = aug(glob, whole.rename)
    same = all(torch.equal(g, want[i]) for g, i in zip(gathered, (1, 3)))
    renamed = int(((want[1] != glob[1]).any(1)
                   | (want[3] != glob[3]).any(1)).sum().item())
    check(same and 0 < renamed < G, f"(dp rename) the ranks' augmented "
          f"rows vs one process's: same bits {same}, {renamed} renamed")
    live = {"params": trainer.params, "opt_state": trainer.opt_state}
    start = map_state(lambda t: t.detach().clone(), live)
    loss_two = trainer._train_step(trainer.params, trainer.opt_state, local,
                                   draws).item()
    two = map_state(lambda t: t.detach().clone(), trainer.params)
    for dst, src in zip(state_tensors(live), state_tensors(start)):
        dst.copy_(src)
    trainer.mesh = None
    trainer._build_step()
    loss_one = trainer._train_step(trainer.params, trainer.opt_state, glob,
                                   whole).item()
    worst = 0.0
    for (path, a), (_p, b) in zip(named_tensors(two),
                                  named_tensors(trainer.params)):
        fa, fb = a.float(), b.float()
        bound = 2 * cfg.LEARNING_RATE + 2.0 ** -7 * fb.abs().max().item()
        worst = max(worst, (fa - fb).abs().max().item() / bound)
    loss_rel = abs(loss_two - loss_one) / abs(loss_one)
    check(loss_rel <= LOSS_RTOL and worst <= 1.0, f"(dp rename) the "
          f"defended step at {world} ranks vs one process: loss rel "
          f"{loss_rel:.3g}, worst param difference {worst:.3g} of its bound")
    del trainer, live, start, two, glob, local, got, want, gathered
    torch.cuda.empty_cache()
    return {"renamed": renamed, "rows": G, "shift": whole.rename.shift,
            "loss_two": loss_two, "loss_one": loss_one, "loss_rel": loss_rel,
            "worst_of_bound": worst, "seconds": time.perf_counter() - t0}


def dp_sparse_apply_check(torch, trainer, mesh) -> bool:
    """mesh_sparse_apply (kernel 5) over this rank's rows of global
    parts at the token table's size == the one-process compact apply of
    the global parts, bit for bit."""
    from code2vec_tpu_torch.training.sparse_adam import init_row_adam
    from code2vec_tpu_torch.training.sparse_update import (
        adam_lr_t, apply_rows, dedup_segment_sum, mesh_sparse_apply)
    table = trainer.params["token_emb"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    n = TRAIN_B * C * mesh.world
    ids = torch.randint(0, table.shape[0], (n,), generator=gen,
                        device="cuda", dtype=torch.int32)
    grads = torch.randn((n, E), generator=gen, device="cuda") * 1e-3
    count = torch.full((), 2, dtype=torch.int32, device="cuda")
    lr_t = adam_lr_t(count, 1e-3, 0.9, 0.999)
    ref, got = table.clone(), table.clone()
    ref_s, got_s = init_row_adam(ref), init_row_adam(got)
    apply_rows(ref, ref_s, *dedup_segment_sum(ids, grads), lr_t=lr_t,
               b1=0.9, b2=0.999, eps=1e-8)
    per = n // mesh.world
    lo = mesh.rank * per
    mesh_sparse_apply(mesh, got, got_s, [(ids[lo:lo + per],
                                          grads[lo:lo + per], True)],
                      lr_t=lr_t)
    same = (torch.equal(ref, got) and torch.equal(ref_s.m, got_s.m)
            and torch.equal(ref_s.v, got_s.v))
    del ref, got, ref_s, got_s
    return bool(same)


# ---- [25]: the context axis (run inside [23]'s two children) ----

# the ctx axis of [25]: two ranks on the card split C = 200 into 2 x 100
CTX = 2
# the ring against the one-rank plain_mha and kernel 2 at the main shape,
# over the largest |reference| value: the output is rounded to bf16 once on
# each side (one bf16 step, 2^-7 of the largest); dq, dk, dv come back
# through the ring's bf16 tensors, each hop's share rounded to bf16 and
# the shares summed in bf16, against one float32 sum rounded once: two
# steps (2^-6)
RING_OUT_TOL, RING_GRAD_TOL = 2.0 ** -7, 2.0 ** -6
# a ctx step against one rank's step over the same global batch, each
# leaf's raw gradient over its largest value: the bag's pool sees the same
# gathered contexts, and a table's gradient is the bf16 sum of the two
# ranks' shares against one float32 sum rounded once (one bf16 step of the
# largest, 2^-7); the transformer's attention rounds to bf16 in other
# places (the ring's shares, the gathered q, k, v products of shapes cuBLAS
# tiles otherwise), a one-step difference that travels through the layer's
# weight products as in XF_GRAD_RTOL's readings (5.2e-3, 5.6e-3): 2^-6
CTX_GRAD_RTOL = 2.0 ** -6
# the ctx command line's evaluation (the ring, bf16) against a one-process
# --load of its checkpoint (kernel 2): a code vector a few bf16 steps apart
# moves a logit by up to ~0.1 (XF_E2E_PROB_RTOL's reasoning); the mean loss
# over 4096 methods within 1 %, the top-1 accuracy within 1 % of the methods
CTX_EVAL_LOSS_RTOL, CTX_EVAL_TOP1 = 1e-2, 1.0 - EVAL_TOP1_SHARE
# ring attention on the card: (B, H, C, hd) of the main shape
RING_SHAPE = (TRAIN_B, XF_H, C, D // XF_H)


def ring_bytes(L: int, s: int) -> dict:
    """Bytes a rank sends around the ring in one training step of L layers
    at RING_SHAPE (bf16): each of the s - 1 forward hops of each layer
    moves its k and v blocks and its float32 key mask; each backward hop
    moves the k and v cotangents (bf16)."""
    B, H, Cf, hd = RING_SHAPE
    kv = 2 * B * H * (Cf // s) * hd * 2
    mask = B * (Cf // s) * 4
    fwd = L * (s - 1) * (kv + mask)
    return {"forward": fwd, "backward": L * (s - 1) * kv,
            "step": fwd + L * (s - 1) * kv}


def ctx_ring_check(torch, mesh) -> dict:
    """The ring at RING_SHAPE over the rank's block (its contexts of every
    row; data = 1) against the one-rank plain_mha (output and dq, dk, dv)
    and kernel 2 (output) on the whole inputs, the same on each rank from
    one seed; each path's peak memory a rank: the ring against the
    all-gathered q, k, v through kernels 2 and 3."""
    from code2vec_tpu_torch.ops.ring_attention import ring_attention
    from code2vec_tpu_torch.ops.xf_attention import (fused_mha,
                                                     mha_forward_fused,
                                                     plain_mha)
    from code2vec_tpu_torch.parallel.collectives import all_gather
    from code2vec_tpu_torch.parallel.sharding import context_cols
    B, H, Cf, hd = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    q, k, v, do = (torch.randn(RING_SHAPE, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    live = torch.randint(20, Cf + 1, (B, 1), generator=gen, device="cuda")
    mask = (torch.arange(Cf, device="cuda")[None, :] < live).float()
    log_mask = torch.log(torch.clamp(mask, min=1e-30))
    lo, hi = context_cols(mesh, Cf)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    ref = plain_mha(*leaves, log_mask)
    ref_grads = torch.autograd.grad(ref, leaves, do)
    kern = mha_forward_fused(q.detach(), k.detach(), v.detach(), log_mask)
    blocks = [t.detach()[:, :, lo:hi].contiguous().requires_grad_(True)
              for t in (q, k, v)]
    m_local = log_mask[:, lo:hi].contiguous()
    do_local = do[:, :, lo:hi].contiguous()

    def peak(fn):
        """fn's result, its peak memory above what was allocated, its
        ms (host clock, synchronised)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, torch.cuda.max_memory_allocated() - base,
                (time.perf_counter() - t) * 1e3)

    def ring_pass():
        out = ring_attention(*blocks, m_local, mesh)
        return out.detach(), torch.autograd.grad(out, blocks, do_local)

    def gathered_pass():
        full = [all_gather(t, 2, mesh) for t in blocks]
        out = fused_mha(*full, log_mask).narrow(2, lo, hi - lo)
        return out.detach(), torch.autograd.grad(out, blocks, do_local)

    (ring, ring_grads), ring_peak, ring_ms = peak(ring_pass)
    (gath, _g), gathered_peak, gathered_ms = peak(gathered_pass)
    rel = {}
    for name, got, want, tol in (
            ("out_vs_plain", ring, ref[:, :, lo:hi], RING_OUT_TOL),
            ("out_vs_kernel2", ring, kern[:, :, lo:hi], RING_OUT_TOL),
            ("dq", ring_grads[0], ref_grads[0][:, :, lo:hi], RING_GRAD_TOL),
            ("dk", ring_grads[1], ref_grads[1][:, :, lo:hi], RING_GRAD_TOL),
            ("dv", ring_grads[2], ref_grads[2][:, :, lo:hi], RING_GRAD_TOL),
            ("gathered_out_vs_kernel2", gath, kern[:, :, lo:hi],
             RING_OUT_TOL)):
        w = want.detach().float()
        rel[name] = ((got.float() - w).abs().max().item()
                     / w.abs().max().item(), tol)
    check(all(r <= t for r, t in rel.values()) and ring.dtype ==
          torch.bfloat16, f"(ctx ring) rank {mesh.rank}: {rel}")
    del q, k, v, do, leaves, ref, ref_grads, kern, blocks, ring, ring_grads
    torch.cuda.empty_cache()
    return {"rel": rel, "ring_peak_bytes": ring_peak,
            "gathered_peak_bytes": gathered_peak,
            "ring_fwd_bwd_ms": ring_ms, "gathered_fwd_bwd_ms": gathered_ms,
            "ring_bytes_a_layer": ring_bytes(1, CTX)}


def ctx_step_check(torch, trainer, glob, label: str) -> dict:
    """[25]: one ctx step of `trainer` (its mesh's ctx group) against one
    rank's step over the same global batch (`glob`, data = 1: every rank
    holds all its rows): the loss and every leaf's raw gradient, the
    ctx step's world sum against one rank's. The ctx step is the counted
    one, `steps.dense_train_step`'s phases run apart so that its raw
    gradients can be read (forward + backward + the world's sum, then
    the optimizer and the adds), timed without the comparison between
    them; its peak memory."""
    from code2vec_tpu_torch.parallel.sharding import (context_cols,
                                                      local_contexts)
    from code2vec_tpu_torch.training.draws import make_draws
    from code2vec_tpu_torch.training.sparse_steps import reduce_step_grads
    from code2vec_tpu_torch.training.steps import (apply_dense_updates,
                                                   dense_loss_and_grads,
                                                   make_train_loss_fn)
    mesh, cfg = trainer.mesh, trainer.config
    lo, hi = context_cols(mesh, C)
    local = tuple(t.contiguous() for t in local_contexts(mesh, glob))
    step = trainer.step_num
    draws = trainer.draws_for(TRAIN_B, step)
    whole = make_draws(trainer.dims, trainer.step_config, trainer.params,
                       TRAIN_B, cfg.SEED, step, trainer.device)
    check(torch.equal(draws.keep, whole.keep[:, lo:hi])
          and (draws.sampled is None
               or torch.equal(draws.sampled, whole.sampled)),
          f"(ctx {label}) the rank's draws are not its contexts of the "
          "global draws")
    kw = dict(use_sampled_softmax=cfg.USE_SAMPLED_SOFTMAX,
              num_sampled=cfg.NUM_SAMPLED_CLASSES,
              compute_dtype=trainer.compute_dtype, use_kernel=True)
    loss_one, grads_one, _v = dense_loss_and_grads(
        trainer.params, glob, whole,
        make_train_loss_fn(trainer.dims, **kw))  # one rank: not counted
    loss_fn = make_train_loss_fn(trainer.dims, mesh=mesh, **kw)
    zero_xf_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loss, grads, view = dense_loss_and_grads(trainer.params, local, draws,
                                             loss_fn)
    loss = reduce_step_grads(loss, grads, mesh)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    loss, loss_one = loss.item(), loss_one.item()
    worst, at = 0.0, None
    for path, g1 in grads_one.items():
        g1 = g1.float()
        rel = ((grads[path].float() - g1).abs().max().item()
               / max(g1.abs().max().item(), 1e-30))
        if rel >= worst:
            worst, at = rel, path
    loss_rel = abs(loss - loss_one) / abs(loss_one)
    check(loss_rel <= LOSS_RTOL and worst <= CTX_GRAD_RTOL,
          f"(ctx {label}) rank {mesh.rank}: loss {loss} vs one rank "
          f"{loss_one} (rel {loss_rel:.3g}), the worst raw gradient {at} "
          f"{worst:.3g} of its largest (bound {CTX_GRAD_RTOL:.3g})")
    del grads_one
    t = time.perf_counter()
    updates = trainer.optimizer.update(grads, trainer.opt_state, view)
    apply_dense_updates(trainer.params, updates, draws.salts,
                        use_kernel=trainer.requant_kernel)
    torch.cuda.synchronize()
    step_ms += (time.perf_counter() - t) * 1e3
    del grads, updates
    return {"loss": loss, "loss_one": loss_one, "loss_rel": loss_rel,
            "worst_grad": (at, worst), "step_ms": step_ms,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": xf_counts()}


def ctx_harness(torch, rank: int, world: int, port: int, data_path: str):
    """[25] in one of [23]'s children: the ring at the main shape, then
    the transformer's ctx step with the ring and with q, k, v all-gathered
    into kernels 2 and 3, and the bag's (c) ctx step into kernel 1, each
    against one rank; `world` ranks on the card over gloo, ctx = world."""
    import dataclasses

    import numpy as np

    from code2vec_tpu_torch.data.reader import C2VTextReader
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.parallel import distributed
    t0 = time.perf_counter()
    check(distributed.maybe_initialize(f"127.0.0.1:{port}", world, rank,
                                       device_type="cuda"),
          "(ctx harness) no process group")
    vocabs = synthetic_vocabs()
    glob_np = next(iter(C2VTextReader(data_path, vocabs, C, TRAIN_B)))
    out = {}
    xf = Code2VecTrainer(xf_config(MESH_CONTEXT_AXIS=world), vocabs)
    mesh = xf.mesh
    check(mesh is not None and (mesh.ctx, mesh.batch_shards) == (world, 1),
          f"(ctx harness) mesh {mesh}")
    out["ring"] = ctx_ring_check(torch, mesh)
    # the global batch, all C contexts (the trainer's device_batch would
    # cut them to the rank's)
    glob = tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in glob_np.host_arrays())
    for label, ring in (("e_ring", True), ("e_gathered", False)):
        xf.dims = dataclasses.replace(xf.dims, ring_attention=ring)
        xf._build_step()
        out[label] = ctx_step_check(torch, xf, glob, label)
    del xf
    torch.cuda.empty_cache()
    _, cfg = dense_config("c", "bfloat16", False)
    cfg.MESH_CONTEXT_AXIS = world
    bag = Code2VecTrainer(cfg, vocabs)
    out["c"] = ctx_step_check(torch, bag, glob, "c")
    del bag, glob
    torch.cuda.empty_cache()
    distributed.shutdown()
    out["seconds"] = time.perf_counter() - t0
    return out


def ctx_cli(torch, rank: int, world: int, port: int, spec) -> dict:
    """[25]'s command line in one of [23]'s children: `cli.main` with
    `--encoder transformer --mesh_context 2 --ring_attention` and the
    `--dist_*` flags over [14]'s binary shards, one epoch, `--test`,
    `--save`; kernels 2 and 3 counted (the ring takes their place)."""
    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.models import model_base
    counted = []
    real = model_base.MetricAccumulator.results

    def results(self):
        counted.append(self.num_examples)
        return real(self)

    model_base.MetricAccumulator.results = results
    argv = [str(a) for a in spec["base"]] + [
        "--encoder", "transformer", "--xf_layers", XF_L, "--xf_heads", XF_H,
        "--mesh_context", world, "--ring_attention", "--epochs", 1,
        "--save", spec["ctx_ckpt"], "--dist_coordinator",
        f"127.0.0.1:{port}", "--dist_num_processes", world,
        "--dist_process_id", rank]
    zero_xf_counts()
    t = time.perf_counter()
    try:
        with Recorder(torch) as rec:
            rc = cli.main([str(a) for a in argv])
        torch.cuda.synchronize()
    finally:
        model_base.MetricAccumulator.results = real
    check(rc == 0, f"(ctx cli) rank {rank}: cli.main exited {rc}")
    trainer = rec.made[-1]
    res = {"run_s": time.perf_counter() - t, "launches": xf_counts(),
           "losses": rec.loss_values(), "steps": trainer.step_num,
           "digests": leaf_digests(torch, trainer.params),
           "evals": [(s, vars(r)) for s, r in rec.evals],
           "num_examples": counted}
    del rec, trainer
    torch.cuda.empty_cache()
    return res


def phase_data_parallel(torch, np, vocabs, tmp, data_prefix, test_path,
                        report):
    """[23]: two ranks on the card over gloo through the command line,
    the function-level harness, one rank over NCCL. Returns the parent's
    launches (the NCCL step)."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.parallel import distributed
    from code2vec_tpu_torch.parallel.compat import free_port
    from code2vec_tpu_torch.training import checkpoint as ckpt
    from code2vec_tpu_torch.training.checkpoint import (map_state,
                                                        state_tensors)
    t0 = time.perf_counter()
    n_train = count_lines(data_prefix + ".train.c2v")
    steps = -(-(-(-n_train // DP_WORLD)) // TRAIN_B)
    base = ["--data", data_prefix, "--test", test_path, "--batch_size",
            str(TRAIN_B), "--max_contexts", str(C),
            "--async_checkpoint", "off"]
    ck = {label: os.path.join(tmp, f"dp_ckpt_{label}")
          for label in DP_CONFIGS}
    # the CLI runs', the harness's, [25]'s and [26]'s harness and CLI run,
    # [27]'s and [28]'s harnesses
    ports = [free_port() for _ in range(len(DP_CONFIGS) + 7)]
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for rank in range(DP_WORLD):
        spec_path = os.path.join(tmp, f"dp_spec{rank}.json")
        with open(spec_path, "w") as f:
            json.dump({"rank": rank, "world": DP_WORLD, "ports": ports,
                       "base": base, "ckpt": ck,
                       "ctx_ckpt": os.path.join(tmp, "ctx_ckpt"),
                       "model_ckpt": os.path.join(tmp, "model_ckpt"),
                       "train": data_prefix + ".train.c2v",
                       "test": test_path,
                       "vm_train": os.path.join(tmp, "vm.train.vm.c2v"),
                       "vm_test": os.path.join(tmp, "vm.test.vm.c2v")}, f)
        env = dict(os.environ, PYTHONPATH=here)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.dp_child()",
             spec_path], cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=DP_CHILD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, o) in enumerate(zip(procs, outs)):
        line = next((ln for ln in o.splitlines()
                     if ln.startswith("DP_RESULT ")), None)
        if p.returncode != 0 or line is None:
            print(o[-6000:], flush=True)
        check(p.returncode == 0 and line is not None,
              f"(dp) rank {rank} exited {p.returncode}")
        results.append(json.loads(line[len("DP_RESULT "):]))
    children_s = time.perf_counter() - t0
    r0, r1 = results
    for label in DP_CONFIGS:
        a, b = r0[label], r1[label]
        epochs = DP_EPOCHS[label]
        last = epochs * steps
        check(a["steps"] == b["steps"] == last,
              f"(dp {label}) steps {a['steps']}, {b['steps']} (want {last})")
        check(a["digests"] == b["digests"], f"(dp {label}) the ranks' final "
              "params differ")
        check(a["evals"] == b["evals"] and len(a["evals"]) == epochs,
              f"(dp {label}) merged evaluations {a['evals']} vs {b['evals']}")
        check(a["identity"] == {"process_index": 0,
                                "process_count": DP_WORLD,
                                "backend": "gloo"}, f"(dp {label}) identity "
              f"{a['identity']}")
        for r in (a, b):
            check(r["launches"]["attention_pool"] > 0,
                  f"(dp {label}) kernel 1 never launched in a child")
            if label == "a":
                check(r["launches"]["sparse_row_adam"] > 0,
                      f"(dp {label}) kernel 5 never launched in a child")
        step_dirs = [s for s, _d in ckpt._step_dirs(ck[label])]
        check(step_dirs == [steps * (e + 1) for e in range(epochs)],
              f"(dp {label}) step dirs {step_dirs}")
        topo = ckpt.load_step_topology(ck[label], last)
        check(topo["num_processes"] == DP_WORLD, f"(dp {label}) topology "
              f"{topo}")
        # one process's evaluation of the saved checkpoint
        cfg = Config.load_from_args(["--load", ck[label], "--test",
                                     test_path])
        one = Code2VecTrainer.from_config(cfg, vocabs=vocabs).evaluate()
        merged = a["evals"][-1][1]
        loss_rel = abs(merged["loss"] - one.loss) / abs(one.loss)
        check(merged["topk_acc"] == list(one.topk_acc)
              and merged["subtoken_f1"] == one.subtoken_f1
              and loss_rel <= 1e-5, f"(dp {label}) merged evaluation "
              f"{merged} vs one process {one}")
        print(f"  (dp {label}) two CLI ranks (gloo, cuda:0): {last} steps "
              f"each in {a['run_s']:.1f} / {b['run_s']:.1f} s, losses "
              f"{[round(x, 5) for x in a['losses']]}; final params "
              f"bit-identical ({len(a['digests'])} leaves, sha256); "
              f"launches rank 0 {a['launches']}, rank 1 {b['launches']}; "
              f"merged evaluation top-1 {merged['topk_acc'][0]:.4f} F1 "
              f"{merged['subtoken_f1']:.4f} = one process's (loss rel "
              f"{loss_rel:.2e}); rank 0 alone wrote {step_dirs}, "
              f"topology.json num_processes {topo['num_processes']}",
              flush=True)
    h0, h1 = r0["harness"], r1["harness"]
    check(h0["mesh_sparse_apply_exact"] and h1["mesh_sparse_apply_exact"],
          "(dp) mesh_sparse_apply differs from the compact apply")
    for label in DP_CONFIGS:
        h = h0[label]
        print(f"  (dp harness {label}) two ranks vs one process over the "
              f"concatenated batch: loss {h['loss_two']:.6f} vs "
              f"{h['loss_one']:.6f} (rel {h['loss_rel']:.2e}, bound "
              f"{LOSS_RTOL}); largest param difference {h['worst'][0]}: "
              f"{h['worst'][1][0]:.3g} (bound {h['worst'][1][1]:.3g}); "
              f"step twice: the same bits; step ms one rank "
              f"{fmt_ms(h['one_rank_ms'])}, {DP_WORLD} ranks "
              f"{fmt_ms(h['ranks_ms'])} / {fmt_ms(h1[label]['ranks_ms'])}",
              flush=True)
    print(f"  (dp harness) gradient all-reduce of (c): "
          f"{h0['allreduce_bytes'] / 1e9:.3f} GB a step in "
          f"{fmt_ms(h0['c']['allreduce_ms'])} (gloo through the host, "
          f"{DP_WORLD} ranks sharing one card: not a scaling number); "
          f"mesh_sparse_apply bit-identical to the compact apply", flush=True)
    for rank, h in enumerate((h0, h1)):
        ph = h["phases_c"]
        print(f"  (dp phases c) rank {rank}, the trainer's phase profiler at "
              f"{DP_WORLD} ranks (sample {DP_PHASE_SAMPLES}): allreduce "
              f"{ph['allreduce_ms']:.1f} ms, allreduce_exposed "
              f"{ph['allreduce_exposed_ms']:.1f} ms (beside the measured "
              f"all-reduce's {fmt_ms(h['c']['allreduce_ms'])}), fused "
              f"{ph['fused_ms']:.1f} ms, table_apply "
              f"{ph['table_apply_ms']:.1f} ms, backward "
              f"{ph['backward_ms']:.1f} ms, residual {ph['residual_ms']:.1f}"
              f" ms", flush=True)
    rn = h0["rename"]
    check(h1["rename"]["loss_two"] == rn["loss_two"],
          f"(dp rename) the ranks' losses {rn} vs {h1['rename']}")
    print(f"  (dp rename) (c) with --adv_rename_prob {DP_RENAME_PROB} "
          f"--adv_rename_mode batch at {DP_WORLD} ranks: the gathered "
          f"augmented rows ({rn['renamed']} of {rn['rows']} renamed, donor "
          f"roll {rn['shift']} across the ranks) bit-identical to one "
          f"process's augment of the concatenated batch; the step's loss "
          f"{rn['loss_two']:.6f} vs one process {rn['loss_one']:.6f} (rel "
          f"{rn['loss_rel']:.2e}), params within {rn['worst_of_bound']:.3f} "
          f"of the bound; {rn['seconds']:.1f} s", flush=True)

    # ---- one rank over NCCL, through the same flags ----
    t1 = time.perf_counter()
    cfg = Config.load_from_args(
        ["--data", data_prefix, "--batch_size", str(TRAIN_B),
         "--max_contexts", str(C)] + dp_flags(free_port(), 1, 0))
    check(distributed.maybe_initialize(
        cfg.DIST_COORDINATOR, cfg.DIST_NUM_PROCESSES, cfg.DIST_PROCESS_ID,
        device_type="cuda"), "(nccl) no process group")
    try:
        check(distributed.backend() == "nccl", f"(nccl) backend "
              f"{distributed.backend()}")
        trainer = Code2VecTrainer(cfg, vocabs)
        check(trainer.mesh is not None and trainer.mesh.world == 1,
              f"(nccl) mesh {trainer.mesh}")
        from code2vec_tpu_torch.data.reader import C2VTextReader
        batch = trainer.device_batch(next(iter(C2VTextReader(
            data_prefix + ".train.c2v", vocabs, C, TRAIN_B))))
        draws = trainer.draws_for(TRAIN_B, trainer.step_num)
        live = {"params": trainer.params, "opt_state": trainer.opt_state}
        start = map_state(lambda t: t.detach().clone(), live)
        attention_pool_fused.launches = 0
        loss_mesh = trainer._train_step(trainer.params, trainer.opt_state,
                                        batch, draws)
        torch.cuda.synchronize()
        launches = {"attention_pool": attention_pool_fused.launches}
        meshed = map_state(lambda t: t.detach().clone(), live)
        for dst, src in zip(state_tensors(live), state_tensors(start)):
            dst.copy_(src)
        trainer.mesh = None
        trainer._build_step()
        loss_plain = trainer._train_step(trainer.params, trainer.opt_state,
                                         batch, draws)
        diff = state_diff(torch, meshed, live)
        exact = distributed.allreduce_sum_hosts([2.0 ** 52 + 1.0])
        check(diff["differ"] == 0 and torch.equal(loss_mesh, loss_plain)
              and exact.tolist() == [2.0 ** 52 + 1.0],
              f"(nccl) the world-1 step vs the plain step: {diff}, loss "
              f"{loss_mesh.item()} vs {loss_plain.item()}")
        check(launches["attention_pool"] == 1, f"(nccl) launches {launches}")
        del trainer, live, start, meshed
    finally:
        distributed.shutdown()
    torch.cuda.empty_cache()
    nccl_s = time.perf_counter() - t1
    print(f"  (nccl) one rank over NCCL (--dist_num_processes 1): init, a "
          f"(c) step with its all-reduces and a float64 collective: "
          f"{diff['tensors']} param and optimizer tensors and the loss "
          f"bit-identical to the plain step; {nccl_s:.1f} s", flush=True)
    report["data_parallel"] = {
        "world": DP_WORLD, "steps": steps, "children_s": children_s,
        "nccl_s": nccl_s, "cli": {label: {"rank0": r0[label],
                                          "rank1": {k: v for k, v in
                                                    r1[label].items()
                                                    if k != "digests"}}
                                  for label in DP_CONFIGS},
        "harness": {"rank0": h0, "rank1": h1}}
    # (a)'s two-rank run: [24]'s oracle of the supervised cohort
    kept = {"argv": dp_argv(base, "a"), "digests": r0["a"]["digests"],
            "steps": DP_EPOCHS["a"] * steps, "steps_per_epoch": steps,
            "n_train": n_train}
    # [25]'s to [28]'s results from the same children
    ctx_runs = [{k: r[k] for k in ("ctx", "ctx_cli", "model", "model_cli",
                                   "vm_model", "cohort")} for r in results]
    return launches, kept, ctx_runs


def phase_context(torch, vocabs, test_path, runs, ckpt_dir, n_train,
                  report):
    """[25]: the context axis from [23]'s two children (`ctx_harness`,
    `ctx_cli`): the ring against one rank's attention, the ctx steps
    against one rank's, their launches; the ctx command line's run on both
    ranks, then a one-process `--load` of its checkpoint that evaluates
    it. Returns rank 0's launches of the counted ctx steps."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models import model_base
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.training import checkpoint as ckpt
    t0 = time.perf_counter()
    steps = -(-n_train // TRAIN_B)  # one batch shard: every rank all rows
    # what each counted ctx step launches: the ring none of kernels 1-3,
    # the gathered q, k, v kernels 2 and 3 L times, the bag kernel 1 once
    want = {"e_ring": {"attention_pool": 0, "xf_attention_forward": 0,
                       "xf_attention_backward": 0},
            "e_gathered": {"attention_pool": 0,
                           "xf_attention_forward": XF_L,
                           "xf_attention_backward": XF_L},
            "c": {"attention_pool": 1, "xf_attention_forward": 0,
                  "xf_attention_backward": 0}}
    for rank, r in enumerate(runs):
        h = r["ctx"]
        ring = h["ring"]
        print(f"  (ctx ring) rank {rank}, (B, H, C, hd) = {RING_SHAPE} bf16 "
              f"at ctx {CTX}: max |ring - ref| / max |ref| "
              + ", ".join(f"{k} {v[0]:.3g} (bound {v[1]:.3g})"
                          for k, v in ring["rel"].items())
              + f"; peak memory a rank, one layer's attention forward + "
              f"backward: ring {ring['ring_peak_bytes'] / 1e9:.3f} GB, "
              f"all-gathered q, k, v into kernels 2 and 3 "
              f"{ring['gathered_peak_bytes'] / 1e9:.3f} GB; "
              f"{ring['ring_fwd_bwd_ms']:.1f} vs "
              f"{ring['gathered_fwd_bwd_ms']:.1f} ms; the ring sends "
              f"{ring['ring_bytes_a_layer']['step'] / 1e6:.1f} MB a layer a "
              f"step", flush=True)
        for label in want:
            s = h[label]
            check(s["launches"] == want[label],
                  f"(ctx {label}) rank {rank}: launches {s['launches']}, "
                  f"want {want[label]}")
            print(f"  (ctx {label}) rank {rank}: loss {s['loss']:.6f} vs one "
                  f"rank {s['loss_one']:.6f} (rel {s['loss_rel']:.2e}); the "
                  f"worst raw gradient {s['worst_grad'][0]} "
                  f"{s['worst_grad'][1]:.3g} of its largest (bound "
                  f"{CTX_GRAD_RTOL:.3g}); a step {s['step_ms']:.1f} ms, peak "
                  f"{s['peak_bytes'] / 1e9:.2f} GB; launches {s['launches']}"
                  f" (gloo through the host, two ranks on one card: not a "
                  f"scaling number)", flush=True)
    a, b = runs[0]["ctx_cli"], runs[1]["ctx_cli"]
    for rank, c in enumerate((a, b)):
        check(c["steps"] == steps and c["num_examples"] == [EVAL_METHODS]
              and all(v == 0 for v in c["launches"].values()),
              f"(ctx cli) rank {rank}: steps {c['steps']} (want {steps}), "
              f"evaluated {c['num_examples']} (want [{EVAL_METHODS}]), "
              f"launches {c['launches']} (the ring: none of kernels 1-3)")
    check(a["digests"] == b["digests"] and a["evals"] == b["evals"],
          "(ctx cli) the ranks' final params or evaluations differ")
    topo = ckpt.load_step_topology(ckpt_dir, steps)
    check(topo is not None and topo["num_processes"] == DP_WORLD
          and topo.get("batch_shards") == 1, f"(ctx cli) topology {topo}")
    counted = []
    real = model_base.MetricAccumulator.results

    def results(self):
        counted.append(self.num_examples)
        return real(self)

    model_base.MetricAccumulator.results = results
    try:
        cfg = Config.load_from_args(["--load", ckpt_dir, "--test",
                                     test_path])
        trainer = Code2VecTrainer.from_config(cfg, vocabs=vocabs)
        check(trainer.mesh is None and trainer.dims.ring_attention,
              "(ctx load) not a one-process ring checkpoint")
        one = trainer.evaluate()
    finally:
        model_base.MetricAccumulator.results = real
    merged = a["evals"][-1][1]
    loss_rel_ = abs(merged["loss"] - one.loss) / abs(one.loss)
    top1 = abs(merged["topk_acc"][0] - one.topk_acc[0])
    check(counted == [EVAL_METHODS] and loss_rel_ <= CTX_EVAL_LOSS_RTOL
          and top1 <= CTX_EVAL_TOP1, f"(ctx load) the ctx run's merged "
          f"evaluation {merged} vs one process's {one} over {counted}")
    del trainer
    torch.cuda.empty_cache()
    print(f"  (ctx cli) cli.main --encoder transformer --mesh_context "
          f"{CTX} --ring_attention --dist_* on two ranks (gloo, cuda:0): "
          f"{steps} steps in {a['run_s']:.1f} / {b['run_s']:.1f} s, losses "
          f"{[round(x, 5) for x in a['losses']]}, final params bit-identical "
          f"({len(a['digests'])} leaves), kernels 1-3 launched 0 times; "
          f"merged evaluation of {EVAL_METHODS} methods (each counted once) "
          f"top-1 {merged['topk_acc'][0]:.4f} loss {merged['loss']:.5f}; "
          f"one-process --load of rank 0's checkpoint (topology "
          f"{topo}): top-1 {one.topk_acc[0]:.4f} loss {one.loss:.5f} (loss "
          f"rel {loss_rel_:.2e}, bound {CTX_EVAL_LOSS_RTOL}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    report["context"] = {"ranks": [r["ctx"] for r in runs],
                         "cli": {"rank0": a, "rank1": {
                             k: v for k, v in b.items() if k != "digests"}},
                         "one_process": vars(one), "loss_rel": loss_rel_}
    h0 = runs[0]["ctx"]
    return {"attention_pool": h0["c"]["launches"]["attention_pool"],
            "xf_attention_forward":
                h0["e_gathered"]["launches"]["xf_attention_forward"],
            "xf_attention_backward":
                h0["e_gathered"]["launches"]["xf_attention_backward"]}


# ---- [26]: the model axis (run inside [23]'s two children) ----

# the model axis of [26]: two ranks on the card, each holding half the
# rows of every table (java-large padded to a multiple of 2)
MODEL = 2
# a model step against one rank's step over the same global batch, each
# leaf's raw gradient over its largest value: the gathered contexts are
# one rank's bits and a table window's gradient is one rank's rows of the
# same scatter, but the logits of the full softmax are a [B, V/2] product
# a rank, which cuBLAS may tile otherwise than the [B, V] one, and a
# one-step bf16 difference travels on through the backward: [25]'s card
# bound for a raw gradient, 2^-6
MODEL_GRAD_RTOL = CTX_GRAD_RTOL
# the merged evaluation's top-1 against one rank's, held where the one
# rank's first two probabilities are more than this share of the first
# apart: the [B, V/2] logits of a rank and the one rank's [B, V] are
# products cuBLAS may tile otherwise (a few float32 ulp of a logit, ~1e-7
# of a probability); an absolute 1e-6 holds nothing here, where even the
# stretched tables give every probability under ~1e-5
MODEL_TOP1_GAP = 1e-6


def model_counts():
    from code2vec_tpu_torch.ops.sparse_update_kernel import \
        sparse_row_adam_fused
    return dict(xf_counts(), sparse_row_adam=sparse_row_adam_fused.launches)


def zero_model_counts():
    from code2vec_tpu_torch.ops.sparse_update_kernel import \
        sparse_row_adam_fused
    zero_xf_counts()
    sparse_row_adam_fused.launches = 0


def tensor_bytes(tree) -> int:
    from code2vec_tpu_torch.training.checkpoint import state_tensors
    return sum(t.numel() * t.element_size() for t in state_tensors(tree))


def model_step_check(torch, trainer, glob, label: str,
                     make_loss=None) -> dict:
    """[26]: one dense step of a model-2 `trainer` (data = 1: every rank
    holds all the rows) against one rank's step over the same batch on
    the whole tables (gathered from the windows): the gathered contexts
    (the same bits), the loss and every leaf's raw gradient (a table's
    over the rank's window). The model step is the counted one,
    `steps.dense_train_step`'s phases run apart so that its raw gradients
    can be read (forward + backward + the shard-replica sum, then the
    optimizer and the adds), timed without the comparison between them;
    the forward + backward's peak memory a rank beside one rank's (each
    its tables plus its peak above what was allocated), the step's peak,
    and the bytes of the model group's collectives. `make_loss(mesh)`
    gives the step's loss function (default: the code2vec head's; [27]
    passes the VarMisuse head's)."""
    from code2vec_tpu_torch.models.encoder import gather_contexts
    from code2vec_tpu_torch.parallel import collectives
    from code2vec_tpu_torch.parallel.sharding import (TABLE_KEYS, row_window,
                                                      unshard_params)
    from code2vec_tpu_torch.training.sparse_steps import reduce_step_grads
    from code2vec_tpu_torch.training.steps import (apply_dense_updates,
                                                   dense_loss_and_grads,
                                                   make_train_loss_fn)
    mesh, cfg = trainer.mesh, trainer.config
    draws = trainer.draws_for(TRAIN_B, trainer.step_num)
    if make_loss is None:
        kw = dict(use_sampled_softmax=cfg.USE_SAMPLED_SOFTMAX,
                  num_sampled=cfg.NUM_SAMPLED_CLASSES,
                  compute_dtype=trainer.compute_dtype, use_kernel=True)

        def make_loss(at):
            return make_train_loss_fn(trainer.dims, mesh=at, **kw)
    whole = unshard_params(trainer.params, mesh)
    src, pth, dst = glob[1], glob[2], glob[3]
    same = torch.equal(
        gather_contexts(trainer.params, src, pth, dst, trainer.compute_dtype,
                        mesh),
        gather_contexts(whole, src, pth, dst, trainer.compute_dtype))
    check(same, f"(model {label}) rank {mesh.rank}: the gathered contexts "
          "are not one rank's")
    tables = {k: tensor_bytes(trainer.params[k]) for k in TABLE_KEYS}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss_one, grads_one, _v = dense_loss_and_grads(whole, glob, draws,
                                                   make_loss(None))
    torch.cuda.synchronize()  # one rank: not counted
    one_peak = (torch.cuda.max_memory_allocated() - base
                + MODEL * sum(tables.values()))
    for k in TABLE_KEYS:
        grads_one[k] = grads_one[k][slice(*row_window(
            mesh, whole[k].shape[0]))].clone()
    loss_one = loss_one.item()
    del whole
    torch.cuda.empty_cache()
    loss_fn = make_loss(mesh)
    zero_model_counts()
    collectives.traffic.update(sum=0, max=0, gather=0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loss, grads, view = dense_loss_and_grads(trainer.params, glob, draws,
                                             loss_fn)
    loss = reduce_step_grads(loss, grads, mesh)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    fwd_bwd_peak = (torch.cuda.max_memory_allocated() - base
                    + sum(tables.values()))
    traffic = dict(collectives.traffic)
    loss = loss.item()
    worst, at = 0.0, None
    for path, g1 in grads_one.items():
        g1 = g1.float()
        rel = ((grads[path].float() - g1).abs().max().item()
               / max(g1.abs().max().item(), 1e-30))
        if rel >= worst:
            worst, at = rel, path
    loss_rel_ = abs(loss - loss_one) / abs(loss_one)
    check(loss_rel_ <= LOSS_RTOL and worst <= MODEL_GRAD_RTOL,
          f"(model {label}) rank {mesh.rank}: loss {loss} vs one rank "
          f"{loss_one} (rel {loss_rel_:.3g}), the worst raw gradient {at} "
          f"{worst:.3g} of its largest (bound {MODEL_GRAD_RTOL:.3g})")
    del grads_one
    t = time.perf_counter()
    updates = trainer.optimizer.update(grads, trainer.opt_state, view)
    apply_dense_updates(trainer.params, updates, draws.salts,
                        use_kernel=trainer.requant_kernel)
    torch.cuda.synchronize()
    step_ms += (time.perf_counter() - t) * 1e3
    del grads, updates
    return {"loss": loss, "loss_one": loss_one, "loss_rel": loss_rel_,
            "worst_grad": (at, worst), "step_ms": step_ms,
            "fwd_bwd_peak_bytes": fwd_bwd_peak,
            "one_rank_fwd_bwd_peak_bytes": one_peak,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "table_bytes": tables, "traffic": traffic,
            "launches": model_counts(), "contexts_equal": same}


def model_sparse_check(torch, trainer, glob) -> dict:
    """[26] (a): one sparse-row step of a model-2 `trainer` (counted),
    then the same step from the same state with the plain rows in place
    of kernel 5 on each window: the tables and every moment the same
    bits, the loss too."""
    from code2vec_tpu_torch.parallel import collectives
    from code2vec_tpu_torch.training.checkpoint import (map_state,
                                                        state_tensors)
    from code2vec_tpu_torch.training.steps import \
        make_train_step as port_train_step
    mesh, cfg = trainer.mesh, trainer.config
    draws = trainer.draws_for(TRAIN_B, trainer.step_num)
    live = {"params": trainer.params, "opt_state": trainer.opt_state}
    start = map_state(lambda t: t.detach().clone(), live)
    zero_model_counts()
    collectives.traffic.update(sum=0, max=0, gather=0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss = trainer._train_step(trainer.params, trainer.opt_state, glob,
                               draws)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    launches, traffic = model_counts(), dict(collectives.traffic)
    kernel = map_state(lambda t: t.detach().clone(), live)
    for dst, src in zip(state_tensors(live), state_tensors(start)):
        dst.copy_(src)
    plain = port_train_step(
        trainer.dims, trainer.optimizer,
        use_sampled_softmax=cfg.USE_SAMPLED_SOFTMAX,
        num_sampled=cfg.NUM_SAMPLED_CLASSES,
        compute_dtype=trainer.compute_dtype, use_kernel=True,
        row_kernel=False, sparse_updates=True, mesh=mesh)
    loss_plain = plain(trainer.params, trainer.opt_state, glob, draws)
    diff = state_diff(torch, kernel, live)
    check(diff["differ"] == 0 and torch.equal(loss, loss_plain),
          f"(model a) rank {mesh.rank}: kernel 5 on the window vs the plain "
          f"rows: {diff}, loss {loss.item()} vs {loss_plain.item()}")
    del start, kernel
    return {"loss": loss.item(), "step_ms": step_ms, "launches": launches,
            "tensors_equal": diff["tensors"], "traffic": traffic,
            "rows": {k: tuple(v.shape) for k, v in trainer.params.items()
                     if k.endswith("_emb")}}


def model_eval_check(torch, trainer, test_path: str, vocabs) -> dict:
    """[26]: the test file's methods through the model-2 evaluation step
    (the softmax over both ranks' columns, the top-k merged) against one
    rank's on the whole tables, after `stretch_tables`' stretch of the
    windows by the whole tables' largest values (at the init every logit
    is ~0 and the probabilities tie): the top-1 equal wherever one rank's
    first two probabilities are more than MODEL_TOP1_GAP of the first
    apart; the bytes of the merge and of the all-sums."""
    from code2vec_tpu_torch.data.reader import C2VTextReader
    from code2vec_tpu_torch.parallel import collectives
    from code2vec_tpu_torch.parallel.sharding import unshard_params
    from code2vec_tpu_torch.training.steps import eval_step
    mesh = trainer.mesh
    with torch.no_grad():
        for key, reach in (("token_emb", 1.0), ("path_emb", 1.0),
                           ("target_emb", 0.3)):
            t = trainer.params[key]
            top = collectives.model_max(t.float().abs().max().reshape(1),
                                        mesh)
            t.mul_((reach / top).to(t.dtype))
    whole = unshard_params(trainer.params, mesh)
    methods = held = agree = 0
    model_ms = 0.0
    collectives.traffic.update(sum=0, max=0, gather=0)
    for b in C2VTextReader(test_path, vocabs, C, TRAIN_B):
        batch = trainer.device_batch(b)
        kw = dict(dims=trainer.dims, top_k=TOP_K,
                  compute_dtype=trainer.compute_dtype, use_kernel=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            _ls, ids, _p = eval_step(trainer.params, batch, mesh=mesh, **kw)
        torch.cuda.synchronize()
        model_ms += (time.perf_counter() - t) * 1e3
        with torch.inference_mode():
            _ls1, ids1, probs1 = eval_step(whole, batch, **kw)
        nv = b.num_valid_examples
        clear = ((probs1[:nv, 0] - probs1[:nv, 1])
                 > MODEL_TOP1_GAP * probs1[:nv, 0])
        methods += nv
        held += int(clear.sum())
        agree += int((ids[:nv, 0] == ids1[:nv, 0])[clear].sum())
    del whole
    torch.cuda.empty_cache()
    check(methods == EVAL_METHODS and agree == held and held > 0,
          f"(model eval) rank {mesh.rank}: top-1 equal on {agree} of "
          f"{held} clear methods of {methods}")
    return {"methods": methods, "held": held, "agree": agree,
            "ms": model_ms, "traffic": dict(collectives.traffic)}


def model_harness(torch, rank: int, world: int, port: int, spec) -> dict:
    """[26] in one of [23]'s children: `world` ranks on the card over
    gloo at (data 1, model world): (c)'s dense step and (e)'s against one
    rank, (a)'s sparse-row step with kernel 5 on each window against the
    plain rows, and the merged evaluation of the test file."""
    import numpy as np

    from code2vec_tpu_torch.data.reader import C2VTextReader
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.parallel import distributed
    t0 = time.perf_counter()
    check(distributed.maybe_initialize(f"127.0.0.1:{port}", world, rank,
                                       device_type="cuda"),
          "(model harness) no process group")
    vocabs = synthetic_vocabs()
    glob_np = next(iter(C2VTextReader(spec["train"], vocabs, C, TRAIN_B)))
    glob = tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in glob_np.host_arrays())
    out = {}
    _, cfg = dense_config("c", "bfloat16", False)
    cfg.MESH_MODEL_AXIS = world
    for label, cfg in (("c", cfg), ("e", xf_config(MESH_MODEL_AXIS=world))):
        trainer = Code2VecTrainer(cfg, vocabs)
        mesh = trainer.mesh
        check(mesh is not None and (mesh.model, mesh.batch_shards) ==
              (world, 1), f"(model {label}) mesh {mesh}")
        out[label] = model_step_check(torch, trainer, glob, label)
        if label == "c":
            out["eval"] = model_eval_check(torch, trainer, spec["test"],
                                           vocabs)
        del trainer
        torch.cuda.empty_cache()
    _, cfg = train_config("a", "bfloat16", True)
    cfg.MESH_MODEL_AXIS = world
    trainer = Code2VecTrainer(cfg, vocabs)
    out["a"] = model_sparse_check(torch, trainer, glob)
    del trainer, glob
    torch.cuda.empty_cache()
    distributed.shutdown()
    out["seconds"] = time.perf_counter() - t0
    return out


def model_cli(torch, rank: int, world: int, port: int, spec) -> dict:
    """[26]'s command line in one of [23]'s children: `cli.main` with
    `--mesh_model 2` and the `--dist_*` flags over [14]'s binary shards,
    (c)'s defaults, one epoch, `--test`, `--save` (rank 0 writes whole
    tables); kernel 1 counted."""
    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.models import model_base
    counted = []
    real = model_base.MetricAccumulator.results

    def results(self):
        counted.append(self.num_examples)
        return real(self)

    model_base.MetricAccumulator.results = results
    argv = [str(a) for a in spec["base"]] + [
        "--mesh_model", world, "--epochs", 1, "--save", spec["model_ckpt"],
        "--dist_coordinator", f"127.0.0.1:{port}", "--dist_num_processes",
        world, "--dist_process_id", rank]
    zero_model_counts()
    t = time.perf_counter()
    try:
        with Recorder(torch) as rec:
            rc = cli.main([str(a) for a in argv])
        torch.cuda.synchronize()
    finally:
        model_base.MetricAccumulator.results = real
    check(rc == 0, f"(model cli) rank {rank}: cli.main exited {rc}")
    trainer = rec.made[-1]
    res = {"run_s": time.perf_counter() - t, "launches": model_counts(),
           "losses": rec.loss_values(), "steps": trainer.step_num,
           "digests": leaf_digests(torch, trainer.params),
           "rows": {k: tuple(v.shape) for k, v in trainer.params.items()
                    if k.endswith("_emb")},
           "evals": [(s, vars(r)) for s, r in rec.evals],
           "num_examples": counted}
    del rec, trainer
    torch.cuda.empty_cache()
    return res


def phase_model(torch, vocabs, test_path, runs, ckpt_dir, n_train, report):
    """[26]: the model axis from [23]'s two children (`model_harness`,
    `model_cli`): the model steps against one rank's, kernel 5 on the
    windows against the plain rows, the merged evaluation, their
    launches and collective bytes; the model command line's run on both
    ranks, then a one-process `--load` of its whole-table checkpoint that
    evaluates it. Returns rank 0's launches of the counted steps."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models import model_base
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.training import checkpoint as ckpt
    t0 = time.perf_counter()
    steps = -(-n_train // TRAIN_B)  # one batch shard: every rank all rows
    want = {"c": {"attention_pool": 1, "xf_attention_forward": 0,
                  "xf_attention_backward": 0, "sparse_row_adam": 0},
            "e": {"attention_pool": 0, "xf_attention_forward": XF_L,
                  "xf_attention_backward": XF_L, "sparse_row_adam": 0},
            "a": {"attention_pool": 1, "xf_attention_forward": 0,
                  "xf_attention_backward": 0, "sparse_row_adam": 3}}
    for rank, r in enumerate(runs):
        h = r["model"]
        for label in want:
            s = h[label]
            check(s["launches"] == want[label],
                  f"(model {label}) rank {rank}: launches {s['launches']}, "
                  f"want {want[label]}")
        for label in ("c", "e"):
            s = h[label]
            print(f"  (model {label}) rank {rank} at model {MODEL}: gathered"
                  f" contexts one rank's bits; loss {s['loss']:.6f} vs one "
                  f"rank {s['loss_one']:.6f} (rel {s['loss_rel']:.2e}); the "
                  f"worst raw gradient {s['worst_grad'][0]} "
                  f"{s['worst_grad'][1]:.3g} of its largest (bound "
                  f"{MODEL_GRAD_RTOL:.3g}); a step {s['step_ms']:.1f} ms; "
                  f"forward + backward peak a rank "
                  f"{s['fwd_bwd_peak_bytes'] / 1e9:.3f} GB against one "
                  f"rank's {s['one_rank_fwd_bwd_peak_bytes'] / 1e9:.3f} GB "
                  f"(each with its tables: a rank's "
                  f"{sum(s['table_bytes'].values()) / 1e9:.3f} GB), the "
                  f"step's peak {s['peak_bytes'] / 1e9:.2f} GB; the model "
                  f"pair's all-sums {s['traffic']['sum'] / 1e6:.1f} MB and "
                  f"maxes {s['traffic']['max'] / 1e6:.3f} MB a rank a step; "
                  f"launches {s['launches']} (gloo through the host, two "
                  f"ranks on one card: not a scaling number)", flush=True)
        a = h["a"]
        print(f"  (model a) rank {rank}: a sparse-row step {a['step_ms']:.1f}"
              f" ms, kernel 5 on each window ({a['rows']}) the plain rows' "
              f"bits ({a['tensors_equal']} tensors and the loss); the model "
              f"pair's all-sums {a['traffic']['sum'] / 1e6:.1f} MB a step; "
              f"launches {a['launches']}", flush=True)
        e = h["eval"]
        print(f"  (model eval) rank {rank}: {e['methods']} methods, the "
              f"merged top-1 one rank's on {e['agree']} of the {e['held']} "
              f"whose first two probabilities are > {MODEL_TOP1_GAP} of the "
              f"first apart; "
              f"the top-k merge gathered {e['traffic']['gather'] / 1e6:.3f} "
              f"MB a rank, the all-sums (the contexts' parts, the softmax's "
              f"and the label's sums) {e['traffic']['sum'] / 1e6:.3f} MB; "
              f"{e['ms']:.0f} ms; [26]'s harness {h['seconds']:.1f} s",
              flush=True)
    a, b = runs[0]["model_cli"], runs[1]["model_cli"]
    for rank, c in enumerate((a, b)):
        check(c["steps"] == steps and c["num_examples"] == [EVAL_METHODS]
              and c["launches"]["attention_pool"] >= steps,
              f"(model cli) rank {rank}: steps {c['steps']} (want {steps}), "
              f"evaluated {c['num_examples']} (want [{EVAL_METHODS}]), "
              f"launches {c['launches']}")
    check(a["evals"] == b["evals"], "(model cli) the ranks' evaluations "
          "differ")
    topo = ckpt.load_step_topology(ckpt_dir, steps)
    check(topo is not None and topo["num_processes"] == DP_WORLD
          and topo.get("batch_shards") == 1, f"(model cli) topology {topo}")
    counted = []
    real = model_base.MetricAccumulator.results

    def results(self):
        counted.append(self.num_examples)
        return real(self)

    model_base.MetricAccumulator.results = results
    try:
        cfg = Config.load_from_args(["--load", ckpt_dir, "--test",
                                     test_path])
        trainer = Code2VecTrainer.from_config(cfg, vocabs=vocabs)
        rows = {k: tuple(v.shape) for k, v in trainer.params.items()
                if k.endswith("_emb")}
        check(trainer.mesh is None and trainer.dims.vocab_pad_multiple ==
              MODEL and all(rows[k][0] == MODEL * a["rows"][k][0]
                            for k in rows),
              f"(model load) not a one-process whole-table checkpoint: "
              f"{rows} vs a rank's {a['rows']}")
        one = trainer.evaluate()
    finally:
        model_base.MetricAccumulator.results = real
    merged = a["evals"][-1][1]
    loss_rel_ = abs(merged["loss"] - one.loss) / abs(one.loss)
    check(counted == [EVAL_METHODS] and loss_rel_ <= 1e-5
          and merged["topk_acc"][0] == one.topk_acc[0],
          f"(model load) the model run's merged evaluation {merged} vs one "
          f"process's {one} over {counted}")
    del trainer
    torch.cuda.empty_cache()
    print(f"  (model cli) cli.main --mesh_model {MODEL} --dist_* on two "
          f"ranks (gloo, cuda:0): {steps} steps in {a['run_s']:.1f} / "
          f"{b['run_s']:.1f} s, losses {[round(x, 5) for x in a['losses']]}"
          f", a rank's tables {a['rows']}, launches {a['launches']}; merged "
          f"evaluation of {EVAL_METHODS} methods (each counted once) top-1 "
          f"{merged['topk_acc'][0]:.4f} loss {merged['loss']:.5f}; "
          f"one-process --load of rank 0's whole-table checkpoint "
          f"({rows}, topology {topo}): top-1 {one.topk_acc[0]:.4f} loss "
          f"{one.loss:.5f} (loss rel {loss_rel_:.2e}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    report["model"] = {"ranks": [r["model"] for r in runs],
                       "cli": {"rank0": a, "rank1": {
                           k: v for k, v in b.items() if k != "digests"}},
                       "one_process": vars(one), "loss_rel": loss_rel_}
    h0 = runs[0]["model"]
    return {k: sum(h0[label]["launches"][k] for label in want)
            for k in want["c"]}


# ---- [27]: the VarMisuse head and the writer's exports under the model
# axis (run inside [23]'s two children, and a pair of export processes
# beside [24]) ----

# [27]'s exports: the model-2 command line's w2v, t2v and code vectors of
# [14]'s released model and its release, in two processes of their own
# (`model_export_child`) beside [24]; the limit of the wait after [24]
MODEL_EXPORT_CHILD = "import chip_smoke; chip_smoke.model_export_child()"
MODEL_EXPORT_TIMEOUT_S = 600


def vm_model_eval_check(torch, trainer, test_path: str, vv) -> dict:
    """[27]: the VarMisuse evaluation of [21]'s test file at model 2 (the
    merged sums, one rank of the model group counted; counted: kernel 1
    once a batch) against one rank's `vm_eval_step` over the whole tables
    gathered from the windows, batch by batch: the same count (the
    file's rows), accuracy and loss."""
    from code2vec_tpu_torch.data.vm_reader import VMTextReader
    from code2vec_tpu_torch.parallel import collectives
    from code2vec_tpu_torch.parallel.sharding import unshard_params
    from code2vec_tpu_torch.training.vm_steps import vm_eval_step
    zero_model_counts()
    collectives.traffic.update(sum=0, max=0, gather=0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = trainer.evaluate(test_path)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches, traffic = model_counts(), dict(collectives.traffic)
    whole = unshard_params(trainer.params, trainer.mesh)
    loss_sum = correct = total = 0.0
    for b in VMTextReader(test_path, vv, C, VM_K, TRAIN_B):
        batch = trainer.device_batch(b)
        with torch.inference_mode():
            ls, cs, _pred = vm_eval_step(whole, batch,
                                         compute_dtype=trainer.compute_dtype,
                                         use_kernel=True)
        loss_sum += ls.item()
        correct += cs.item()
        total += b.num_valid_examples
    del whole
    torch.cuda.empty_cache()
    one = (loss_sum / total, correct / total, int(total))
    rows = count_lines(test_path)
    loss_rel_ = abs(res.loss - one[0]) / abs(one[0])
    check(res.num_examples == one[2] == rows and res.accuracy == one[1]
          and loss_rel_ <= 1e-5,
          f"(vm model eval) rank {trainer.mesh.rank}: {res} vs one rank's "
          f"{one} over a file of {rows} rows")
    return {"loss": res.loss, "accuracy": res.accuracy,
            "num_examples": res.num_examples, "one_rank": one,
            "loss_rel": loss_rel_, "ms": ms, "launches": launches,
            "traffic": traffic}


def gathered_tables_check(torch, vocabs, ckpt_dir: str, world: int) -> dict:
    """[27]: a model-`world` trainer loaded from [26]'s whole-table
    checkpoint; `get_embedding_table` of each table (gathered over the
    model group, the padding rows cut) against the checkpoint's rows,
    bit for bit (no text written at this width)."""
    import numpy as np

    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.training import checkpoint as ckpt
    from code2vec_tpu_torch.vocab.vocabularies import VocabType
    cfg = Config.load_from_args(["--load", ckpt_dir, "--mesh_model",
                                 str(world)])
    trainer = Code2VecTrainer.from_config(cfg, vocabs=vocabs)
    state = ckpt.load_checkpoint(ckpt_dir, mmap=True)
    out = {}
    for vt, key in ((VocabType.Token, "token_emb"),
                    (VocabType.Path, "path_emb"),
                    (VocabType.Target, "target_emb")):
        t = time.perf_counter()
        table = trainer.get_embedding_table(vt)
        gather_s = time.perf_counter() - t
        size = vocabs.get(vt).size
        saved = state["params"][key]
        same = table.shape == (size, saved.shape[1]) and np.array_equal(
            table, saved[:size].float().numpy())
        check(same, f"(vm model tables) rank {trainer.mesh.rank}: {key} "
              f"gathered {table.shape} is not the checkpoint's {size} rows "
              f"of {tuple(saved.shape)}")
        out[key] = {"rows": size, "saved_rows": int(saved.shape[0]),
                    "window_rows": int(trainer.params[key].shape[0]),
                    "gather_s": gather_s}
        del table
    del trainer, state
    torch.cuda.empty_cache()
    return out


def vm_model_harness(torch, rank: int, world: int, port: int, spec,
                     vocabs) -> dict:
    """[27] in one of [23]'s children: `world` ranks on the card over gloo
    at (data 1, model world): (f), the VarMisuse dense step, at [21]'s
    java-large token and path width against one rank's (loss, raw
    gradients; counted: kernel 1 once), the merged VarMisuse evaluation
    of [21]'s test file against one rank's, then the tables gathered by
    `get_embedding_table` from [26]'s checkpoint."""
    import numpy as np

    from code2vec_tpu_torch.data.vm_reader import VMTextReader
    from code2vec_tpu_torch.models.vm_model import VarMisuseModel
    from code2vec_tpu_torch.parallel import distributed
    from code2vec_tpu_torch.training.vm_steps import make_vm_loss_fn
    t0 = time.perf_counter()
    check(distributed.maybe_initialize(f"127.0.0.1:{port}", world, rank,
                                       device_type="cuda"),
          "(vm model harness) no process group")
    vv = vm_vocabs(vocabs)
    cfg = vm_config("f", False)
    cfg.MESH_MODEL_AXIS = world
    trainer = VarMisuseModel(cfg, vv)
    mesh = trainer.mesh
    check(mesh is not None and (mesh.model, mesh.batch_shards) == (world, 1),
          f"(vm model f) mesh {mesh}")
    b = next(iter(VMTextReader(spec["vm_train"], vv, C, VM_K, TRAIN_B)))
    glob = tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in b.host_arrays())

    def make_loss(at):
        return make_vm_loss_fn(trainer.dims,
                               compute_dtype=trainer.compute_dtype,
                               use_kernel=True, mesh=at)

    out = {"f": model_step_check(torch, trainer, glob, "vm f", make_loss)}
    del glob
    out["eval"] = vm_model_eval_check(torch, trainer, spec["vm_test"], vv)
    del trainer
    torch.cuda.empty_cache()
    out["tables"] = gathered_tables_check(torch, vocabs, spec["model_ckpt"],
                                          world)
    distributed.shutdown()
    out["seconds"] = time.perf_counter() - t0
    return out


def model_export_child() -> None:
    """One rank of [27]'s exports (`python3 -c 'import chip_smoke;
    chip_smoke.model_export_child()' <spec.json>`): `cli.main` with
    `--mesh_model 2` and the `--dist_*` flags on [14]'s released model,
    first `--test --export_code_vectors --save_w2v --save_t2v` (the
    model group gathers the tables, rank 0 writes), then `--release`, each
    joining the group on a port of its own; rank 0 hashes the files it
    wrote and removes them. Prints `MODEL_EXPORT_RESULT <json>` (the
    seconds and kernel 1's launches of each, rank 0's sha256s and sizes)
    and exits 0 only if both exited 0."""
    import logging

    import torch

    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(levelname)s %(message)s")
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank, world = spec["rank"], spec["world"]
    out = {}
    for label, port in zip(("exports", "release"), spec["ports"]):
        attention_pool_fused.launches = 0
        t = time.perf_counter()
        rc = cli.main([str(a) for a in spec[label] + [
            "--mesh_model", world, "--dist_coordinator",
            f"127.0.0.1:{port}", "--dist_num_processes", world,
            "--dist_process_id", rank]])
        torch.cuda.synchronize()
        check(rc == 0, f"(model exports) rank {rank}: {label} exited {rc}")
        out[label] = {"seconds": time.perf_counter() - t,
                      "launches": attention_pool_fused.launches}
        if label == "exports" and rank == 0:
            # the bytes' digests, then the files go (2.5 GB at this width)
            paths = export_paths(spec[label])
            out["digests"] = {k: file_digest(v) for k, v in paths.items()}
            out["bytes"] = {k: os.path.getsize(v) for k, v in paths.items()}
            for v in paths.values():
                os.remove(v)
    print("MODEL_EXPORT_RESULT " + json.dumps(out), flush=True)


def start_model_exports(tmp, kept) -> dict:
    """[27]'s export ranks, started beside [24]: two `model_export_child`
    processes on [14]'s released model, the code vectors beside a copy of
    the test file in a directory of their own (rank 0 hashes and removes
    the files it wrote); their output in files, killed at exit if still
    running."""
    import atexit
    import shutil

    from code2vec_tpu_torch.parallel.compat import free_port
    here = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(tmp, "m2x")
    os.makedirs(d, exist_ok=True)
    test_copy = os.path.join(d, "java.test.c2v")
    shutil.copy(kept["test_path"], test_copy)
    mx = {"w2v": os.path.join(d, "tok.w2v"), "t2v": os.path.join(d, "tgt.w2v"),
          "vectors": test_copy + ".vectors",
          "released": os.path.join(d, "released"), "procs": [], "logs": [],
          "t0": time.perf_counter()}
    ports = [free_port(), free_port()]
    for rank in range(DP_WORLD):
        spec_path = os.path.join(d, f"spec{rank}.json")
        with open(spec_path, "w") as f:
            json.dump({"rank": rank, "world": DP_WORLD, "ports": ports,
                       "exports": ["--load", kept["released"], "--test",
                                   test_copy, "--export_code_vectors",
                                   "--save_w2v", mx["w2v"], "--save_t2v",
                                   mx["t2v"]],
                       "release": ["--load", kept["released"], "--release",
                                   "--save", mx["released"]]}, f)
        log = os.path.join(d, f"rank{rank}.log")
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-c", MODEL_EXPORT_CHILD, spec_path],
                cwd=here, env=dict(os.environ, PYTHONPATH=here), stdout=f,
                stderr=subprocess.STDOUT)
        atexit.register(lambda p=proc: p.poll() is None and p.kill())
        mx["procs"].append(proc)
        mx["logs"].append(log)
    return mx


def finish_model_exports(torch, kept, mx, report) -> dict:
    """[27]'s exports, waited for: both ranks exit 0; the w2v, t2v and
    code-vector files byte-identical (sha256) to [14]'s one-process
    exports of the same released model; the model-2 release's tensors
    bit-identical to the released model's. Returns rank 0's results
    (its kernel-1 launches are outside this process's count) and removes
    the directory."""
    import shutil

    from code2vec_tpu_torch.training import checkpoint as ckpt
    t = time.perf_counter()
    results = []
    for rank, (proc, log) in enumerate(zip(mx["procs"], mx["logs"])):
        try:
            rc = proc.wait(timeout=MODEL_EXPORT_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(log) as f:
            text = f.read()
        line = next((ln for ln in text.splitlines()
                     if ln.startswith("MODEL_EXPORT_RESULT ")), None)
        check(rc == 0 and line is not None,
              f"(model exports) rank {rank} exited {rc}: {text[-3000:]}")
        results.append(json.loads(line[len("MODEL_EXPORT_RESULT "):]))
    waited = time.perf_counter() - t
    r0 = results[0]
    same = {k: r0["digests"][k] == kept["exports"]["digests"][k]
            for k in ("w2v", "t2v", "vectors")}
    check(all(same.values()), f"(model exports) the model-2 files vs [14]'s "
          f"one-process exports (sha256): {same}")
    got = ckpt.load_checkpoint(mx["released"], mmap=True)["params"]
    want = ckpt.load_checkpoint(kept["released"], mmap=True)["params"]
    released = got.keys() == want.keys() and all(
        got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
        for k in want)
    check(released, "(model exports) the model-2 release's tensors are not "
          "the released model's")
    sizes = r0["bytes"]
    mb = ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in sizes.items())
    print(f"  (model exports) cli.main --mesh_model {DP_WORLD} --dist_* on "
          f"[14]'s released model, two ranks beside [24]: w2v, t2v and "
          f"code vectors ({mb}) byte-identical (sha256) to [14]'s "
          f"one-process exports; --release's {len(want)} tensors bit-identical to the released model's; "
          f"rank 0 exports {r0['exports']['seconds']:.1f} s (kernel 1 "
          f"{r0['exports']['launches']} launches), release "
          f"{r0['release']['seconds']:.1f} s; waited {waited:.1f} s after "
          f"[24]", flush=True)
    shutil.rmtree(os.path.dirname(mx["w2v"]))
    report["model_exports"] = {"ranks": results, "waited_s": waited,
                               "bytes": sizes,
                               "started_to_checked_s":
                                   time.perf_counter() - mx["t0"]}
    return r0


def phase_vm_model(torch, runs, export_r0, report) -> dict:
    """[27]: the VarMisuse head and the writer's exports under the model
    axis, from [23]'s two children (`vm_model_harness`): (f) at model 2
    against one rank's, the merged VarMisuse evaluation, the gathered
    tables; the exports' results come from `finish_model_exports`.
    Returns rank 0's launches of the counted (f) step and evaluation."""
    want = {"attention_pool": 1, "xf_attention_forward": 0,
            "xf_attention_backward": 0, "sparse_row_adam": 0}
    for rank, r in enumerate(runs):
        h = r["vm_model"]
        s, e = h["f"], h["eval"]
        check(s["launches"] == want, f"(vm model f) rank {rank}: launches "
              f"{s['launches']}, want {want}")
        n_batches = -(-e["num_examples"] // TRAIN_B)
        check(e["launches"]["attention_pool"] == n_batches,
              f"(vm model eval) rank {rank}: kernel 1 launched "
              f"{e['launches']} for {n_batches} batches")
        print(f"  (vm model f) rank {rank} at model {MODEL}: gathered "
              f"contexts one rank's bits; loss {s['loss']:.6f} vs one rank "
              f"{s['loss_one']:.6f} (rel {s['loss_rel']:.2e}, bound "
              f"{LOSS_RTOL}); the worst raw gradient {s['worst_grad'][0]} "
              f"{s['worst_grad'][1]:.3g} of its largest (bound "
              f"{MODEL_GRAD_RTOL:.3g}); a step {s['step_ms']:.1f} ms; "
              f"forward + backward peak a rank "
              f"{s['fwd_bwd_peak_bytes'] / 1e9:.3f} GB against one rank's "
              f"{s['one_rank_fwd_bwd_peak_bytes'] / 1e9:.3f} GB; the model "
              f"pair's all-sums {s['traffic']['sum'] / 1e6:.1f} MB a step; "
              f"launches {s['launches']}", flush=True)
        print(f"  (vm model eval) rank {rank}: {e['num_examples']} rows "
              f"(the file's), accuracy {e['accuracy']:.5f}, loss "
              f"{e['loss']:.5f} = one rank's ({e['one_rank'][1]:.5f}, loss "
              f"rel {e['loss_rel']:.2e}); {e['ms']:.0f} ms, all-sums "
              f"{e['traffic']['sum'] / 1e6:.1f} MB; kernel 1 "
              f"{e['launches']['attention_pool']} launches", flush=True)
        tb = h["tables"]
        print(f"  (vm model tables) rank {rank}: get_embedding_table at "
              f"model {MODEL} from [26]'s checkpoint, "
              + ", ".join(f"{k} {v['rows']} rows (a window {v['window_rows']}"
                          f", saved {v['saved_rows']}; {v['gather_s']:.2f} s)"
                          for k, v in tb.items())
              + f", bit-identical to the checkpoint's; [27]'s harness "
              f"{h['seconds']:.1f} s", flush=True)
    report["vm_model"] = {"ranks": [r["vm_model"] for r in runs],
                          "exports_rank0": export_r0}
    h0 = runs[0]["vm_model"]
    return {"attention_pool": h0["f"]["launches"]["attention_pool"]
            + h0["eval"]["launches"]["attention_pool"]}


# ---- [28]: --predict, the REPL and --attack above one rank ----

# [28]'s serving buckets (the kernel check's), and its bounds against one
# rank's whole-table predictor: the gathered contexts and so the code
# vector and the attention are one rank's bits; the logits are a rank's
# [B, V/2] product against one rank's [B, V], which cuBLAS may tile
# otherwise (a few float32 ulp of a logit, ~1e-7 of a probability), so
# each probability within 1e-5 of itself and the ids held where two
# adjacent probabilities lie more than MODEL_TOP1_GAP of the first apart
# ([26]'s merged top-1 rule). The attack's first-order scores are linear
# in the gradient at the occurrence slots, whose path back from the
# logits crosses the model pair: the bf16 code vector's cotangent is a
# rank's [B, V/2] product rounded to bf16, then summed over the model
# group, where one rank rounds its [B, V] product once; a one-step bf16
# difference (2^-8 of a value) travels on through the pool's backward,
# so the scores take [26]'s card bound for a raw gradient through the
# model pair, 2^-6 of their largest (the CPU tests hold the float32
# attack to 1e-5)
COHORT_BUCKETS = (1, 7, 64)
COHORT_PROB_RTOL, COHORT_SCORE_RTOL = 1e-5, MODEL_GRAD_RTOL
COHORT_PAIR_CHILD = "import chip_smoke; chip_smoke.cohort_pair_child()"
COHORT_PAIR_TIMEOUT_S = 420


def sync(torch) -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def topk_held(np, ids, probs, w_ids, w_probs):
    """(held, agree): the top-k positions whose one-rank probability lies
    more than MODEL_TOP1_GAP of itself from both neighbours, and those
    whose ids are equal."""
    held = agree = 0
    for i in range(w_ids.shape[0]):
        for j in range(w_ids.shape[1]):
            p = w_probs[i, j]
            near = [abs(p - w_probs[i, k]) for k in (j - 1, j + 1)
                    if 0 <= k < w_ids.shape[1]]
            if min(near, default=np.inf) > MODEL_TOP1_GAP * p:
                held += 1
                agree += int(ids[i, j] == w_ids[i, j])
    return held, agree


def cohort_predict_check(torch, np, whole, sharded, lines, label) -> dict:
    """[28]: `predict_device` of the model-2 predictor on `lines` (counted
    and timed after one warm call) against one rank's whole-table
    predictor on the same rows: the attention and code vectors the same
    bits, the probabilities within COHORT_PROB_RTOL, the ids where held;
    the bytes the model group's sums and gathers moved and the outputs'
    gather over the ranks."""
    from code2vec_tpu_torch.parallel import collectives
    prepared = sharded.prepare_predict_rows(lines)
    sharded.predict_device(prepared)
    whole.predict_device(prepared)
    zero_xf_counts()
    collectives.traffic.update(sum=0, max=0, gather=0)
    sync(torch)
    t = time.perf_counter()
    got = sharded.predict_device(prepared)
    sync(torch)
    ms = (time.perf_counter() - t) * 1e3
    launches, traffic = xf_counts(), dict(collectives.traffic)
    t = time.perf_counter()
    want = whole.predict_device(prepared)
    sync(torch)
    one_ms = (time.perf_counter() - t) * 1e3
    ids, probs, attn, code = got
    w_ids, w_probs, w_attn, w_code = want
    n = prepared.n
    check(np.array_equal(attn, w_attn) and np.array_equal(code, w_code),
          f"({label}) B = {n}: the model-2 attention / code vectors are not "
          "one rank's bits")
    rel = float(np.max(np.abs(probs - w_probs) / w_probs))
    check(rel <= COHORT_PROB_RTOL, f"({label}) B = {n}: probabilities "
          f"{rel:.3g} of themselves from one rank's")
    held, agree = topk_held(np, ids, probs, w_ids, w_probs)
    check(agree == held, f"({label}) B = {n}: top-k ids equal on {agree} "
          f"of {held} held positions")
    padded = sharded.predict_bucket_size(n)
    fetch = sum(a.nbytes // n for a in got) * padded * sharded.mesh.world
    return {"B": n, "ms": ms, "one_rank_ms": one_ms, "prob_rel": rel,
            "held": held, "positions": int(ids.size), "launches": launches,
            "traffic": traffic, "fetch_bytes": fetch}


def cohort_attack_check(torch, np, whole, sharded, lv, test_path) -> dict:
    """[28]: one serial untargeted `attack_method` over the windows of a
    [22] method (letter words at [4]'s ids; counted: kernel 1 2 + 2 x
    iterations) against one rank's whole-table attack: the clean
    prediction, the first-order scores within COHORT_SCORE_RTOL of their
    largest, the shortlist where its boundary lies more than that apart,
    and the renames and final prediction (or, where they differ, a tie
    of one rank's exact losses within ATK_TIE_RTOL)."""
    from code2vec_tpu_torch.attacks import gradient_attack as tga
    from code2vec_tpu_torch.data.reader import parse_c2v_rows
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.parallel import collectives
    with open(test_path) as f:
        lines = [to_letters(next(f)) for _ in range(ATK_SERIAL)]
    _l, src, pth, dst, mask, _t, _c = parse_c2v_rows(lines, lv, C)
    kw = dict(compute_dtype=whole.compute_dtype, device=whole.device)
    one = tga.GradientRenameAttack(whole.dims, lv.token_vocab,
                                   lv.target_vocab, **kw)
    two = tga.GradientRenameAttack(sharded.dims, lv.token_vocab,
                                   lv.target_vocab, mesh=sharded.mesh, **kw)
    m = next((src[i], pth[i], dst[i], mask[i]) for i in range(len(lines))
             if one.attackable_tokens(src[i], dst[i], mask[i]))
    tok = one.attackable_tokens(m[0], m[2], m[3])[0][0]
    ids, occ = one.tensors(m), one.tensors((m[0] == tok, m[2] == tok))
    label = int(one.predict_fn(whole.params, ids))
    check(int(two.predict_fn(sharded.params, ids)) == label,
          "(cohort attack) the clean prediction differs from one rank's")
    s1 = one.score_fn(whole.params, ids, occ, label, -1.0).cpu().numpy()
    s2 = two.score_fn(sharded.params, ids, occ, label, -1.0).cpu().numpy()
    top = float(np.max(np.abs(s1)))
    score_rel = float(np.max(np.abs(s1 - s2))) / top
    check(score_rel <= COHORT_SCORE_RTOL, f"(cohort attack) first-order "
          f"scores {score_rel:.3g} of their largest from one rank's")
    tried = {tok} | set(np.unique(np.concatenate([m[0], m[2]])).tolist())
    c1 = tga.build_shortlist(s1.copy(), one.legal, tried, one.top_k, tok)
    c2 = tga.build_shortlist(s2.copy(), two.legal, tried, two.top_k, tok)
    free = s1.copy()
    free[~one.legal] = np.inf
    free[list(tried)] = np.inf
    part = np.partition(free, (one.top_k - 2, one.top_k - 1))
    boundary = float(part[one.top_k - 1] - part[one.top_k - 2]) / top
    same_list = set(c1.tolist()) == set(c2.tolist())
    check(same_list or boundary <= COHORT_SCORE_RTOL, f"(cohort attack) "
          f"shortlists differ with their boundary {boundary:.3g} apart")
    attention_pool_fused.launches = 0
    collectives.traffic.update(sum=0, max=0, gather=0)
    sync(torch)
    t = time.perf_counter()
    r2 = two.attack_method(sharded.params, m)
    sync(torch)
    ms = (time.perf_counter() - t) * 1e3
    launches = attention_pool_fused.launches
    traffic = dict(collectives.traffic)
    check(launches == 2 + 2 * r2.iterations, f"(cohort attack) kernel 1 "
          f"launched {launches} times for {r2.iterations} iterations")
    with StepTimer(torch, one, tga) as timer:
        t = time.perf_counter()
        r1 = one.attack_method(whole.params, m)
        sync(torch)
        one_ms = (time.perf_counter() - t) * 1e3
    same = (r1.success, r1.renames, r1.final_prediction) == \
        (r2.success, r2.renames, r2.final_prediction)
    tie = min(timer.gaps, default=1.0)
    check(same or tie <= ATK_TIE_RTOL, f"(cohort attack) {r2} vs one "
          f"rank's {r1} with the closest decision {tie:.3g} apart")
    return {"score_rel": score_rel, "boundary": boundary,
            "same_shortlist": same_list, "same_result": same,
            "result": str(r2), "iterations": r2.iterations, "ms": ms,
            "one_rank_ms": one_ms, "launches": launches, "traffic": traffic}


def cohort_harness(torch, rank: int, world: int, port: int, spec) -> dict:
    """[28] in one of [23]'s children: `world` ranks over gloo at (data 1,
    model world), [4]'s bag weights (seed 0, stretched; the tables padded
    to the model axis) as one rank's whole-table predictor and as the
    predict-side model over this rank's windows: the serving buckets,
    one serial attack on a [22] method; then [11]'s transformer on a
    batch of 64."""
    import dataclasses

    import numpy as np

    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.encoder import init_params
    from code2vec_tpu_torch.models.torch_model import (Code2VecModel,
                                                       dims_from_config)
    from code2vec_tpu_torch.parallel import distributed
    from code2vec_tpu_torch.parallel.mesh import make_mesh
    from code2vec_tpu_torch.parallel.sharding import shard_params
    t0 = time.perf_counter()
    check(distributed.maybe_initialize(
        f"127.0.0.1:{port}", world, rank,
        device_type="cuda" if DEV == "cuda" else "cpu"),
        "(cohort harness) no process group")
    mesh = make_mesh(1, world, 1, device=DEV)
    vocabs = synthetic_vocabs()
    lines = [ln for req in make_requests(np, np.random.default_rng(SEED))
             for ln in req]
    out = {}
    for label, config in (("bag", Config(MAX_CONTEXTS=C, USE_BF16=True,
                                         TABLES_DTYPE="bfloat16")),
                          ("xf", xf_config())):
        dims = dataclasses.replace(dims_from_config(config, vocabs),
                                   vocab_pad_multiple=world)
        params = init_params(torch.Generator(device=DEV).manual_seed(SEED),
                             dims)
        stretch_tables(params)
        whole = Code2VecModel(config, dims, vocabs, params, device=DEV)
        sharded = Code2VecModel(config, dims, vocabs,
                                shard_params(params, mesh), device=DEV,
                                mesh=mesh)
        buckets = COHORT_BUCKETS if label == "bag" else (COHORT_BUCKETS[-1],)
        out[label] = [cohort_predict_check(torch, np, whole, sharded,
                                           lines[:b], f"cohort {label}")
                      for b in buckets]
        if label == "bag":
            out["attack"] = cohort_attack_check(
                torch, np, whole, sharded, letter_vocabs(vocabs),
                spec["test"])
        del whole, sharded, params
        if DEV == "cuda":
            torch.cuda.empty_cache()
    distributed.shutdown()
    out["seconds"] = time.perf_counter() - t0
    return out


def cohort_pair_child() -> None:
    """One rank of [28]'s pairs (`python3 -c 'import chip_smoke;
    chip_smoke.cohort_pair_child()' <argv json>`): `cli.main(argv)` with
    this process's stdin, its log on standard error; prints
    `COHORT_PAIR_RESULT <json>` (the exit code, kernel 1's launches, the
    seconds) last."""
    import logging

    import torch

    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(message)s")
    argv = json.loads(sys.argv[1])
    attention_pool_fused.launches = 0
    t = time.perf_counter()
    rc = cli.main(argv)
    sync(torch)
    print("COHORT_PAIR_RESULT " + json.dumps({
        "rc": rc, "launches": attention_pool_fused.launches,
        "seconds": time.perf_counter() - t}), flush=True)


def start_cohort_pairs(tmp, kept, report) -> dict:
    """[28]'s two `cli.main --mesh_model 2 --dist_*` pairs, one after the
    other in a thread started beside [24]'s (i): `--predict` on [14]'s
    released model (rank 0 in a directory with Input.java, its stdin
    three Enters, `attack`, `q`), then `--attack untargeted` on
    [22](k)'s checkpoint (a copy of (k)'s Input.java). Each rank's stdout and stderr go to files;
    a rank still running at its timeout is killed."""
    import shutil

    from code2vec_tpu_torch.parallel.compat import free_port
    here = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(tmp, "cohort_pairs")
    k = report["attack_cli"]
    work = {"predict": os.path.join(d, "predict"),
            "attack": os.path.join(d, "attack"),
            "follower": os.path.join(d, "follower")}
    for w in work.values():
        os.makedirs(w)
    shutil.copy(os.path.join(here, "Input.java"), work["predict"])
    shutil.copy(k["victim"], work["attack"])
    victim = os.path.join(work["attack"], "Input.java")
    argv = {"predict": ["--load", kept["released"], "--predict"],
            "attack": ["--load", k["ckpt"], "--attack", "untargeted",
                       "--attack_input", victim]}
    stdin = {"predict": "\n" * REPL_ENTERS + "attack\nq\n", "attack": ""}
    pairs = {"dir": d, "victim": victim, "runs": {}, "t0": time.perf_counter()}

    def run_pair(label):
        port = free_port()
        procs, logs = [], []
        for rank in range(DP_WORLD):
            full = argv[label] + [
                "--mesh_model", str(DP_WORLD), "--dist_coordinator",
                f"127.0.0.1:{port}", "--dist_num_processes", str(DP_WORLD),
                "--dist_process_id", str(rank)]
            log = {s: os.path.join(d, f"{label}{rank}.{s}")
                   for s in ("out", "err")}
            with open(log["out"], "w") as fo, open(log["err"], "w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", COHORT_PAIR_CHILD,
                     json.dumps(full)],
                    cwd=work[label] if rank == 0 else work["follower"],
                    env=dict(os.environ, PYTHONPATH=here),
                    stdin=subprocess.PIPE if rank == 0 else
                    subprocess.DEVNULL, stdout=fo, stderr=fe, text=True))
            logs.append(log)
        procs[0].stdin.write(stdin[label])
        procs[0].stdin.close()
        t = time.perf_counter()
        try:
            rcs = [p.wait(timeout=COHORT_PAIR_TIMEOUT_S) for p in procs]
        except subprocess.TimeoutExpired:
            rcs = None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        pairs["runs"][label] = {"rcs": rcs, "logs": logs,
                                "seconds": time.perf_counter() - t}

    def run_all():
        for label in ("predict", "attack"):
            run_pair(label)
    pairs["thread"] = threading.Thread(target=run_all, daemon=True)
    pairs["thread"].start()
    return pairs


def pair_output(log) -> "tuple[str, dict]":
    """A pair rank's stdout without its result line, and the result."""
    with open(log["out"]) as f:
        lines = f.read().splitlines()
    result = next((json.loads(ln[len("COHORT_PAIR_RESULT "):])
                   for ln in lines if ln.startswith("COHORT_PAIR_RESULT ")),
                  None)
    text = "\n".join(ln for ln in lines
                     if not ln.startswith("COHORT_PAIR_RESULT "))
    return text, result


def same_repl_output(got: str, want: str, tol: float = 1e-6 + 1e-9) -> str:
    """'' when rank 0's REPL output is one process's, latency lines and
    log lines (`python3 -m code2vec_tpu_torch` logs to standard output)
    aside: the same lines, each printed number within one unit of its
    last digit (%.6f), a method's predicted names in the same order
    except between names whose probabilities lie within that of each
    other; else the first difference."""
    import re
    num = re.compile(r"-?\d+\.\d+")
    logged = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d+ [A-Z]+ ")

    def split(out):
        return [(num.sub("#", ln), [float(x) for x in num.findall(ln)])
                for ln in out.splitlines()
                if not ln.startswith("latency:") and not logged.match(ln)]
    g, w = split(got), split(want)
    if len(g) != len(w):
        return f"{len(g)} lines against {len(w)}"
    i = 0
    while i < len(w):
        if w[i][0].startswith("\t(#) predicted:"):
            j = i
            while j < len(w) and w[j][0].startswith("\t(#) predicted:"):
                j += 1
            for (gt, gn), (wt, wn) in zip(g[i:j], w[i:j]):
                if abs(gn[0] - wn[0]) > tol:
                    return f"probability {gn[0]} against {wn[0]}"
                if gt != wt and gt not in {t for t, n in w[i:j]
                                           if abs(n[0] - wn[0]) <= tol}:
                    return f"{gt!r} against {wt!r}"
            i = j
            continue
        if g[i][0] != w[i][0] or len(g[i][1]) != len(w[i][1]) or any(
                abs(a - b) > tol for a, b in zip(g[i][1], w[i][1])):
            return f"{g[i]} against {w[i]}"
        i += 1
    return ""


def finish_cohort_pairs(torch, kept, pairs, report) -> dict:
    """[28]'s pairs, waited for and checked: all four ranks exit 0; the
    `--predict` rank 0's output [15]'s (`same_repl_output`), rank 1's
    stdout empty; the `--attack` rank 0's outcome (k)'s one-process
    outcome and its `.adversarial` bytes (k)'s (sha256; none where (k)
    wrote none) unless one rank's closest decision lies within
    ATK_TIE_RTOL (`attack_cli_tie`), rank 1's stdout empty and no file
    beside it. Returns the ranks' results (their launches are outside
    this process's count)."""
    import shutil
    t = time.perf_counter()
    pairs["thread"].join(timeout=2 * COHORT_PAIR_TIMEOUT_S)
    check(not pairs["thread"].is_alive(), "(cohort pairs) still running")
    waited = time.perf_counter() - t
    out, rank0 = {}, {}
    for label, run in pairs["runs"].items():
        texts, results = zip(*(pair_output(log) for log in run["logs"]))
        if run["rcs"] != [0, 0] or None in results:
            for log in run["logs"]:
                with open(log["err"]) as f:
                    print(f.read()[-3000:], flush=True)
        check(run["rcs"] == [0, 0] and None not in results,
              f"(cohort {label}) exit codes {run['rcs']}")
        check(texts[1].strip() == "", f"(cohort {label}) rank 1 printed "
              f"{texts[1][:500]!r}")
        out[label] = {"seconds": run["seconds"], "ranks": list(results)}
        rank0[label] = texts[0]
    diff = same_repl_output(rank0["predict"], kept["repl_stdout"])
    check(diff == "", f"(cohort predict) rank 0's REPL output differs from "
          f"[15]'s one-process output: {diff}")
    k = report["attack_cli"]
    got = rank0["attack"].strip()
    adv = pairs["victim"] + ".adversarial"
    digest = file_digest(adv) if os.path.exists(adv) else None
    same = (got, digest) == (k["outcomes"]["untargeted"],
                             k["untargeted_adversarial"])
    tie = 1.0 if same else attack_cli_tie(torch, k)
    check(same or tie <= ATK_TIE_RTOL, f"(cohort attack) rank 0 printed "
          f"{got!r} and wrote .adversarial {digest}; one process "
          f"{k['outcomes']['untargeted']!r} and "
          f"{k['untargeted_adversarial']}, with one rank's closest decision "
          f"{tie:.3g} apart")
    check(os.listdir(os.path.join(pairs["dir"], "follower")) == [],
          "(cohort pairs) a follower wrote a file")
    out["waited_s"] = waited
    out["attack_outcome"] = got
    out["adversarial"] = digest
    out["attack_tie"] = None if same else tie
    shutil.rmtree(pairs["dir"])
    return out


def attack_cli_tie(torch, k) -> float:
    """The closest decision (`StepTimer`'s gaps) of (k)'s untargeted
    `--attack`, run again in this process on one rank over a copy of its
    input: the tie rule of [28]'s `--attack` pair, asked only when rank
    0's outcome differs from (k)'s."""
    import shutil

    from code2vec_tpu_torch.attacks import gradient_attack as tga
    from code2vec_tpu_torch.attacks.source_attack import SourceAttack
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    d = os.path.dirname(k["victim"]) + "_tie"
    os.makedirs(d)
    victim = os.path.join(d, "Input.java")
    shutil.copy(k["victim"], victim)
    cfg = Config.load_from_args(["--load", k["ckpt"], "--attack",
                                 "untargeted", "--attack_input", victim])
    model = Code2VecTrainer.from_config(cfg).predictor()
    attack = SourceAttack(cfg, model, top_k_candidates=cfg.ATTACK_TOPK,
                          max_iters=cfg.ATTACK_ITERS)
    with StepTimer(torch, attack.attack, tga) as timer:
        attack.attack_file(victim, method_index=cfg.ATTACK_METHOD_INDEX,
                           max_renames=cfg.ATTACK_MAX_RENAMES)
    del model, attack
    torch.cuda.empty_cache()
    shutil.rmtree(d)
    return min(timer.gaps, default=1.0)


def phase_cohort_serving(torch, runs, pair_out, report) -> dict:
    """[28]: the model-2 predictor and attack from [23]'s two children
    (`cohort_harness`) and the two pairs (`finish_cohort_pairs`). Returns
    rank 0's launches of the counted predictions and attack."""
    pool = fwd = 0
    for rank, r in enumerate(runs):
        h = r["cohort"]
        for label in ("bag", "xf"):
            for c in h[label]:
                want = ({"attention_pool": 1, "xf_attention_forward": 0}
                        if label == "bag" else
                        {"attention_pool": 0, "xf_attention_forward": XF_L})
                got = {k: c["launches"][k] for k in want}
                check(got == want, f"(cohort {label}) rank {rank} B = "
                      f"{c['B']}: launches {got}, want {want}")
                if rank == 0:
                    pool += got["attention_pool"]
                    fwd += got["xf_attention_forward"]
                print(f"  (cohort {label}) rank {rank} at model {MODEL}, B = "
                      f"{c['B']}: attention and code vectors one rank's "
                      f"bits, probabilities within {c['prob_rel']:.2e} of "
                      f"themselves, ids equal on {c['held']} held of "
                      f"{c['positions']}; {c['ms']:.1f} ms against one "
                      f"rank's {c['one_rank_ms']:.1f}; all-sums "
                      f"{c['traffic']['sum'] / 1e6:.2f} MB, maxes "
                      f"{c['traffic']['max'] / 1e3:.1f} kB, the top-k "
                      f"gather {c['traffic']['gather'] / 1e3:.1f} kB, the "
                      f"outputs' gather {c['fetch_bytes'] / 1e3:.1f} kB; "
                      f"launches {got}", flush=True)
        a = h["attack"]
        if rank == 0:
            pool += a["launches"]
        print(f"  (cohort attack) rank {rank}: first-order scores within "
              f"{a['score_rel']:.2e} of their largest, shortlist "
              f"{'the same' if a['same_shortlist'] else 'differs'} "
              f"(boundary {a['boundary']:.2e}), result "
              f"{'equal to' if a['same_result'] else 'tied with'} one "
              f"rank's: {a['result']}; {a['ms']:.1f} ms against "
              f"{a['one_rank_ms']:.1f} ({a['iterations']} iterations), "
              f"all-sums {a['traffic']['sum'] / 1e6:.2f} MB, gathers "
              f"{a['traffic']['gather'] / 1e6:.2f} MB; kernel 1 "
              f"{a['launches']} launches; [28]'s harness "
              f"{h['seconds']:.1f} s", flush=True)
    for label in ("predict", "attack"):
        p = pair_out[label]
        print(f"  (cohort {label} pair) cli.main --mesh_model {DP_WORLD} "
              f"--dist_*: both exit 0, rank 1 printed nothing; "
              f"{p['seconds']:.1f} s; kernel 1 "
              f"{[r['launches'] for r in p['ranks']]} launches a rank",
              flush=True)
    print(f"  (cohort pairs) rank 0's REPL output [15]'s (latency lines "
          f"aside); the attack's outcome and .adversarial "
          f"({pair_out['adversarial'] or 'none'}) "
          + ("(k)'s: " if pair_out["attack_tie"] is None else
             f"tied with (k)'s (one rank's closest decision "
             f"{pair_out['attack_tie']:.3g} apart): ")
          + pair_out["attack_outcome"].replace("\n", " | ")
          + f"; waited {pair_out['waited_s']:.1f} s after [27]", flush=True)
    report["cohort_serving"] = {"ranks": [r["cohort"] for r in runs],
                                "pairs": pair_out}
    return {"attention_pool": pool, "xf_attention_forward": fwd}


# ---- [24]: the supervised training cohort ----

# process 1's train/kill hit: its step 3, the first of epoch 2 at two
# ranks (2 steps an epoch), past epoch 1's synchronous save (step 2); the
# fleet's sweep and the /fleet poll; a tool call's and an attempt's
# limits
COHORT_KILL_AT, COHORT_FLEET_S, COHORT_POLL_S = 3, 0.5, 0.05
COHORT_TIMEOUT_S, COHORT_ATTEMPT_S = 300, 240
COHORT_CHILD = "import chip_smoke; chip_smoke.cohort_child()"
# an oracle member's token (taken out before cli.main): no epoch-boundary
# saves or evaluations, its params held by the digests it prints: each
# java-large (a) save writes a 3.8 GB state, and the script's disk writes
# (deleted files' too) must stay under its machine's cap of ~45 GiB
COHORT_ORACLE = "--cohort_oracle"


def cohort_child() -> None:
    """One member of [24]'s cohort (`python3 -c 'import chip_smoke;
    chip_smoke.cohort_child()' <argv>`, the supervisor's child command):
    `cli.main(argv)`, printing `COHORT_LAUNCHES <json>` (kernel 1's and
    kernel 5's launches so far) after each epoch's boundary work and at
    the end, so a member killed in epoch 2 has printed epoch 1's, and at
    the end `COHORT_DIGESTS <json>`: its trainer's step and the sha256 of
    each of its params (the rank's windows under a model axis). With
    COHORT_ORACLE in `argv` it makes no epoch-boundary save or
    evaluation. Its log on standard output, as `python3 -m
    code2vec_tpu_torch` has it; exits with cli.main's code."""
    import logging

    import torch

    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import (Code2VecTrainer,
                                                       TrainerBase)
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.ops.sparse_update_kernel import \
        sparse_row_adam_fused

    def launches() -> None:
        print("COHORT_LAUNCHES " + json.dumps({
            "attention_pool": attention_pool_fused.launches,
            "sparse_row_adam": sparse_row_adam_fused.launches}), flush=True)

    real_end = TrainerBase._epoch_end

    def epoch_end(self, *args, **kwargs):
        done = real_end(self, *args, **kwargs)
        launches()
        return done

    TrainerBase._epoch_end = epoch_end
    made = []
    real_from = Code2VecTrainer.from_config.__func__

    def from_config(cls, *a, **k):
        made.append(real_from(cls, *a, **k))
        return made[-1]

    Code2VecTrainer.from_config = classmethod(from_config)
    argv = sys.argv[1:]
    if COHORT_ORACLE in argv:
        argv.remove(COHORT_ORACLE)
        real_load = Config.load_from_args.__func__

        def load(cls, args=None):
            cfg = real_load(cls, args)
            cfg.SAVE_EVERY_EPOCHS = cfg.NUM_TRAIN_EPOCHS + 1
            return cfg
        Config.load_from_args = classmethod(load)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(levelname)s %(message)s")
    rc = cli.main(argv)
    launches()
    if rc == 0 and made:
        print("COHORT_DIGESTS " + json.dumps({
            "step": made[-1].step_num,
            "digests": leaf_digests(torch, made[-1].params)}), flush=True)
    sys.exit(rc)


def last_json_line(text: str, tag: str):
    """The JSON after `tag` on the last line of `text` that starts with
    it, or None."""
    lines = [ln for ln in text.splitlines() if ln.startswith(tag + " ")]
    return json.loads(lines[-1][len(tag) + 1:]) if lines else None


def cohort_logs(log_dir: str) -> dict:
    """{log name: the member's last COHORT_LAUNCHES, or None} of each
    member's log under a supervisor's --out_dir, {log name: its
    COHORT_DIGESTS, or None}, and the logs' text."""
    launches, digests, texts = {}, {}, {}
    for name in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, name), errors="replace") as f:
            texts[name] = f.read()
        launches[name] = last_json_line(texts[name], "COHORT_LAUNCHES")
        digests[name] = last_json_line(texts[name], "COHORT_DIGESTS")
    return {"launches": launches, "digests": digests, "texts": texts}


def runs_step_ms(tele_dir: str):
    """[(first event's ts, [step_ms of each step event])] of each run
    under a children's telemetry dir, oldest first."""
    out = []
    for events in run_events(tele_dir):
        if events:
            out.append((events[0]["ts"], [e["step_ms"] for e in events
                                          if e["kind"] == "step"]))
    return out


def median(xs):
    return sorted(xs)[len(xs) // 2] if xs else None


def start_supervised(tmp, label: str, argv, sup_flags, procs: int = 2,
                     kill_process=1) -> dict:
    """[24]'s supervisor tool over `procs` `cohort_child` members of
    `argv` (`--save` ck24_<label> under `tmp`, each member's log under
    logs24_<label>), `train/kill` on member `kill_process` at its step
    COHORT_KILL_AT (None: no fault, the members oracles,
    COHORT_ORACLE), started, not waited for (`finish_supervised`)."""
    here = os.path.dirname(os.path.abspath(__file__))
    s = {"label": label, "kill": kill_process,
         "d": os.path.join(tmp, f"ck24_{label}"),
         "sup_tele": os.path.join(tmp, f"sup24_{label}"),
         "child_tele": os.path.join(tmp, f"tele24_{label}"),
         "logs": os.path.join(tmp, f"logs24_{label}"),
         "marker": os.path.join(tmp, f"killed24_{label}.once")}
    faults = [COHORT_ORACLE] if kill_process is None else [
        "--faults", json.dumps(
            {"sites": {"train/kill": {"action": "kill", "at": COHORT_KILL_AT,
                                      "process": kill_process,
                                      "marker": s["marker"]}}})]
    cmd = [sys.executable, "-m", "code2vec_tpu_torch.tools.train_supervisor",
           "--procs", str(procs), "--telemetry_dir", s["sup_tele"],
           "--backoff_base_s", "0.2", "--attempt_timeout_s",
           str(COHORT_ATTEMPT_S), "--out_dir", s["logs"],
           *[str(a) for a in sup_flags], "--", sys.executable, "-c",
           COHORT_CHILD, *argv, "--save", s["d"], *faults, "--telemetry_dir",
           s["child_tele"]]
    s["t"] = time.perf_counter()
    s["proc"] = subprocess.Popen(cmd, cwd=here,
                                 env=dict(os.environ, PYTHONPATH=here),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
    return s


def finish_supervised(s: dict, poll_fleet=None):
    """Waits for `start_supervised`'s run (polling /fleet on
    `poll_fleet` meanwhile) and reads its supervisor's events and its
    members' logs: (run, /fleet scrapes, logs' texts, the tool's
    output). Checks exit 0, the kill fired and every member launched
    kernels 1 and 5."""
    import shutil

    from code2vec_tpu_torch.tools import chaos
    label, proc = s["label"], s["proc"]
    try:
        if poll_fleet is not None:
            with Poller(poll_fleet, ("/fleet",),
                        every_s=COHORT_POLL_S) as poll:
                stdout, _ = proc.communicate(timeout=COHORT_TIMEOUT_S)
            scrapes = [json.loads(b) for _p, st, b, _ms in poll.seen
                       if st == 200]
        else:
            stdout, _ = proc.communicate(timeout=COHORT_TIMEOUT_S)
            scrapes = []
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - s["t"]
    (events,) = run_events(s["sup_tele"])
    attempts = [e for e in events if e["kind"] == "supervisor_attempt"]
    launches_ev = [e for e in events if e["kind"] == "supervisor_launch"]
    resizes = [[e["from_procs"], e["to_procs"]] for e in events
               if e["kind"] == "cohort_resized"]
    spawns = [ln.split(": ", 2)[-1] for ln in stdout.splitlines()
              if "supervisor: spawn attempt=" in ln]
    members = cohort_logs(s["logs"])
    run = {"rc": proc.returncode, "seconds": seconds,
           "kill_fired": os.path.exists(s["marker"]),
           "kill_ts": chaos._marker_ts(s["marker"]),
           "exit_codes": [a["exit_codes"] for a in attempts],
           "reasons": [a["reason"] for a in attempts],
           "resume_steps": [e["resume_step"] for e in launches_ev],
           "launch_ts": [e["ts"] for e in launches_ev],
           "restarts": len(attempts) - 1, "resizes": resizes,
           "full_relaunches": len(attempts) - 1 - len(resizes),
           "spawns": spawns, "launches": members["launches"],
           "digests": members["digests"],
           "runs": runs_step_ms(s["child_tele"])}
    check(proc.returncode == 0
          and (s["kill"] is None or run["kill_fired"])
          and all(v is not None and v["attention_pool"] > 0
                  and v["sparse_row_adam"] > 0
                  for v in run["launches"].values()),
          f"({label}) supervisor exit {proc.returncode}, kill fired "
          f"{run['kill_fired']}, members' launches {run['launches']}: "
          f"{stdout[-3000:]}")
    shutil.rmtree(s["sup_tele"])
    return run, scrapes, members["texts"], stdout


def ckpt_digests(torch, d: str):
    """(step, {leaf: sha256}) of the params of `d`'s latest step."""
    from code2vec_tpu_torch.training import checkpoint as ckpt
    state = ckpt.load_checkpoint(d, mmap=True)
    digests = leaf_digests(torch, state["params"])
    step = state["step"]
    del state
    return step, digests


def reformed_stepped(s: dict) -> bool:
    """Whether the cohort `start_supervised` launched a second time has
    logged a step (read while its files are written: one missing or a
    line half written reads as not yet)."""
    from code2vec_tpu_torch.tools import chaos
    try:
        launch_ts = [e["ts"] for events in run_events(s["sup_tele"])
                     for e in events if e["kind"] == "supervisor_launch"]
        steps = chaos._step_event_times(s["child_tele"])
    except (OSError, ValueError):
        return False
    return len(launch_ts) > 1 and any(ts >= launch_ts[1] for ts, _ in steps)


def start_model_shrink(tmp, dp_kept) -> dict:
    """[24] (iv), started: four `cohort_child` members run (a) with
    `--mesh_model MODEL` on the card, a (data 2, model 2) mesh, under
    `--resize_policy shrink --min_procs 1`, `train/kill` on process 3 at
    its step COHORT_KILL_AT; a thread copies, once the kill has fired,
    the committed step the re-formed cohort restores (the first epoch's,
    COHORT_KILL_AT falling in the second), and starts the oracle once the
    re-formed cohort has logged a step (its recovery is read without the
    oracle's start-up beside it): two members at model MODEL under the
    tool (no fault) resumed from that copy."""
    from code2vec_tpu_torch.tools import chaos
    argv = [*dp_kept["argv"], "--mesh_model", str(MODEL)]
    ms = {"argv": argv, "S": dp_kept["steps_per_epoch"],
          "run": start_supervised(
              tmp, "model", argv, ["--max_restarts", 2, "--resize_policy",
                                   "shrink", "--min_procs", 1],
              procs=2 * MODEL, kill_process=2 * MODEL - 1)}

    def oracle_when_killed():
        run = ms["run"]
        deadline = time.monotonic() + COHORT_TIMEOUT_S
        while not os.path.exists(run["marker"]) \
                and run["proc"].poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.2)
        if os.path.exists(run["marker"]):
            # the kill's step follows the first epoch's synchronous save:
            # that step is committed and never changes
            chaos.copy_committed_step(run["d"], os.path.join(
                tmp, "ck24_model_oracle"), ms["S"])
            # the oracle's start-up kept off the recovery it would slow
            while not reformed_stepped(run) and run["proc"].poll() is None \
                    and time.monotonic() < deadline:
                time.sleep(0.2)
            ms["oracle"] = start_supervised(
                tmp, "model_oracle", argv, ["--max_restarts", 2],
                procs=MODEL, kill_process=None)

    ms["thread"] = threading.Thread(target=oracle_when_killed, daemon=True)
    ms["thread"].start()
    return ms


def finish_model_shrink(torch, ms, dp_kept) -> dict:
    """[24] (iv), waited for and checked: resizes [[4, 2]], one restart,
    no full relaunch, the re-formed members logging the resharding line
    (the step saved by 4 processes at 2 batch shards), their saves
    recording 2 processes, the final params bit-identical (sha256 per
    leaf) to the oracle's; the recovery seconds and steps lost."""
    from code2vec_tpu_torch.tools import chaos
    from code2vec_tpu_torch.training import checkpoint as ckpt
    run, _s, texts, stdout = finish_supervised(ms["run"])
    ms["thread"].join(timeout=COHORT_TIMEOUT_S)
    check("oracle" in ms, f"(iv) the oracle never started: {stdout[-3000:]}")
    o_run, _s, o_texts, o_stdout = finish_supervised(ms["oracle"])
    d, S = ms["run"]["d"], ms["S"]
    reformed = run["spawns"][2 * MODEL:]
    logs = [texts.get(f"attempt1.proc{i}.log", "") for i in range(MODEL)]
    saved = ckpt.load_step_topology(d, S) or {}
    topo = {s_: ckpt.load_step_topology(d, s_)["num_processes"]
            for s_, _d in ckpt._step_dirs(d) if s_ > S}
    check(run["restarts"] == 1 and run["resizes"] == [[2 * MODEL, MODEL]]
          and run["full_relaunches"] == 0 and run["resume_steps"][-1] == S
          and len(reformed) == MODEL
          and all(f"--dist_num_processes {MODEL}" in sp for sp in reformed)
          and all("resharding onto the new mesh" in t for t in logs)
          and saved.get("num_processes") == 2 * MODEL
          and saved.get("batch_shards") == 2
          and topo and set(topo.values()) == {MODEL}
          and o_run["restarts"] == 0 and o_run["resume_steps"] == [S],
          f"(iv) attempts {run['exit_codes']} ({run['reasons']}), resizes "
          f"{run['resizes']}, resumes {run['resume_steps']}, re-formed "
          f"spawns {reformed}, step {S}'s topology {saved}, after the "
          f"resize {topo}; the oracle's attempts {o_run['exit_codes']}, "
          f"resumes {o_run['resume_steps']}: {stdout[-3000:]}")
    # each re-formed rank's windows against the oracle rank's of the same
    # model index
    chaos_d = [run["digests"].get(f"attempt1.proc{i}.log")
               for i in range(MODEL)]
    oracle_d = [o_run["digests"].get(f"attempt0.proc{i}.log")
                for i in range(MODEL)]
    one_spe = -(-dp_kept["n_train"] // TRAIN_B)  # one batch shard's epoch
    want = S + (DP_EPOCHS["a"] - 1) * one_spe
    check(None not in chaos_d + oracle_d and ckpt.latest_step(d) == want
          and all(c["step"] == o["step"] == want
                  and c["digests"] == o["digests"]
                  for c, o in zip(chaos_d, oracle_d)),
          f"(iv) final steps {[x and x['step'] for x in chaos_d]} / "
          f"{[x and x['step'] for x in oracle_d]} (want {want}), each rank's "
          f"params bit-identical "
          f"{[c and o and c['digests'] == o['digests']
              for c, o in zip(chaos_d, oracle_d)]}")
    d_chaos = chaos_d[0]["digests"]
    reshard = next(ln for ln in logs[0].splitlines()
                   if "resharding onto the new mesh" in ln)
    steps_ev = chaos._step_event_times(ms["run"]["child_tele"])
    first_post = next((ts for ts, _s in steps_ev
                       if ts >= run["launch_ts"][-1]), None)
    recovery_s = (first_post - run["kill_ts"]
                  if first_post is not None and run["kill_ts"] else None)
    check(recovery_s is not None and recovery_s > 0,
          f"(iv) no step after the resize: {run['runs']}")
    lost = COHORT_KILL_AT - S
    print(f"  (iv) kill_resize at (data 2, model {MODEL}): supervisor "
          f"--procs {2 * MODEL} --resize_policy shrink --min_procs 1, child "
          f"--mesh_model {MODEL}, train/kill on process {2 * MODEL - 1} at "
          f"its step {COHORT_KILL_AT}: exit 0 in {run['seconds']:.1f} s, "
          f"attempts exited {run['exit_codes']} "
          f"({run['reasons']}), resizes {run['resizes']}, full_relaunches "
          f"{run['full_relaunches']}, restarts {run['restarts']}; step {S} "
          f"saved by {saved['num_processes']} processes at "
          f"{saved['batch_shards']} batch shards, both re-formed members "
          f"logged \"{reshard.split('INFO ')[-1]}\", saved steps "
          f"{sorted(topo)} with topology num_processes {MODEL}; each rank's "
          f"final params bit-identical to the rank of {MODEL} at model "
          f"{MODEL} resumed from a copy of step {S} ({len(d_chaos)} leaves a "
          f"rank, sha256; the oracle, without epoch saves, "
          f"{o_run['seconds']:.1f} s, launches {o_run['launches']}); "
          f"recovery_steps_lost {lost}, recovery_seconds {recovery_s:.3f}; "
          f"members' launches {run['launches']}", flush=True)
    return {**{k: v for k, v in run.items() if k != "spawns"},
            "resumed_from_step": S, "topology_saved": saved,
            "topology_after": topo, "recovery_steps_lost": lost,
            "recovery_seconds": recovery_s, "oracle_s": o_run["seconds"],
            "oracle_launches": o_run["launches"]}


def phase_cohort(torch, tmp, dp_kept, report, beside_i=lambda: None):
    """[24]: the supervised training cohort on the card. (a) at
    java-large width on [14]'s binary shards, two ranks sharing the card
    over gloo, driven through `python3 -m
    code2vec_tpu_torch.tools.train_supervisor --procs 2` with
    `cohort_child` members: (i) kill_resume_2proc, `train/kill` on
    process 1 at its step COHORT_KILL_AT: the whole cohort relaunched on
    a fresh port, the final params bit-identical (sha256 per leaf) to
    [23]'s uninterrupted two-rank run of the same command; (ii)
    kill_resize under `--resize_policy shrink --min_procs 1`: resizes
    [[2, 1]], no full relaunch, one restart, the re-formed member without
    --dist_* flags logging the resharding line, its saves' topology 1,
    the final params bit-identical to a one-process run resumed from a
    copy of the same committed step; (iii) /fleet during (ii): two
    members before the kill, one after; (iv) the shrink of a (data 2,
    model 2) cohort to (data 1, model 2) (`start_model_shrink`,
    `finish_model_shrink`). (iv) starts first, (ii) beside it (and
    [27]'s export ranks), then `beside_i()` starts what is to run beside
    (i) ([28]'s pairs), then (i) with (ii)'s oracle and the rest of (iv)
    running beside it. Every member's kernel 1 and kernel 5 launches are printed
    (outside this process's count). Returns what `beside_i` returned."""
    import gc
    import shutil

    from code2vec_tpu_torch.parallel.compat import free_port
    from code2vec_tpu_torch.tools import chaos
    from code2vec_tpu_torch.training import checkpoint as ckpt
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    argv = dp_kept["argv"]
    spe = dp_kept["steps_per_epoch"]
    last = dp_kept["steps"]
    gc.collect()
    torch.cuda.empty_cache()  # the members need the card's memory
    out = {}

    def supervise(label, sup_flags, poll_fleet=None):
        return finish_supervised(start_supervised(tmp, label, argv,
                                                  sup_flags),
                                 poll_fleet=poll_fleet)

    def port_of(spawn: str):
        toks = spawn.split()
        return toks[toks.index("--dist_coordinator") + 1] \
            if "--dist_coordinator" in toks else None

    # (iv) the shrink of a (data 2, model 2) cohort, the longest leg,
    # beside (ii) and then (i)
    model_shrink = start_model_shrink(tmp, dp_kept)
    # ---- (ii) kill_resize under the shrink policy, (iii) /fleet ----
    fleet_port, member_base = free_port(), free_port()
    run, scrapes, texts, stdout = supervise(
        "shrink", ["--max_restarts", 2, "--resize_policy", "shrink",
                   "--min_procs", 1, "--fleet_port", fleet_port,
                   "--member_metrics_base", member_base,
                   "--fleet_interval_s", COHORT_FLEET_S],
        poll_fleet=fleet_port)
    d = os.path.join(tmp, "ck24_shrink")
    S = run["resume_steps"][-1]
    reformed = run["spawns"][2:]
    log1 = texts.get("attempt1.proc0.log", "")
    topo = {s_: ckpt.load_step_topology(d, s_)["num_processes"]
            for s_, _d in ckpt._step_dirs(d) if s_ > S}
    check(run["restarts"] == 1 and run["resizes"] == [[2, 1]]
          and run["full_relaunches"] == 0 and S == spe
          and len(reformed) == 1 and "--dist_" not in reformed[0]
          and "initializing torch.distributed" not in log1
          and "resharding onto the new mesh" in log1
          and topo and set(topo.values()) == {1},
          f"(ii) attempts {run['exit_codes']} ({run['reasons']}), resizes "
          f"{run['resizes']}, resumes {run['resume_steps']}, re-formed "
          f"spawn {reformed}, topology after the resize {topo}: "
          f"{stdout[-3000:]}")
    reshard = next(ln for ln in log1.splitlines()
                   if "resharding onto the new mesh" in ln)
    # recovery: the kill (its marker's time) to the first step event of
    # the re-formed member
    steps_ev = chaos._step_event_times(os.path.join(tmp, "tele24_shrink"))
    first_post = next((ts for ts, _s in steps_ev
                       if ts >= run["launch_ts"][-1]), None)
    recovery_s = (first_post - run["kill_ts"]
                  if first_post is not None and run["kill_ts"] else None)
    lost = COHORT_KILL_AT - S
    check(recovery_s is not None and recovery_s > 0,
          f"(ii) no step after the resize: {run['runs']}")
    one_ms = [median(ms[1:]) for ts, ms in run["runs"]
              if ts >= run["launch_ts"][-1] and len(ms) > 1]
    two_ms = [median(ms[1:]) for ts, ms in run["runs"]
              if ts < run["launch_ts"][-1] and len(ms) > 1]
    before = [sc for sc in scrapes if sc.get("ts", 0) < run["kill_ts"]
              and sc.get("cohort", {}).get("hosts_total") == 2
              and sc["cohort"].get("hosts_up") == 2]
    after = [sc for sc in scrapes if sc.get("ts", 0) > run["launch_ts"][-1]
             and sc.get("cohort", {}).get("hosts_total") == 1
             and sc["cohort"].get("hosts_up") == 1]
    check(before and after, f"(iii) /fleet: {len(scrapes)} scrapes, "
          f"{len(before)} with two members up before the kill, {len(after)} "
          f"with one after the resize; last {scrapes[-1:]}")
    shrink = run
    # started only now, so (ii)'s readings are taken without them
    started = beside_i()
    # (ii)'s oracle, run beside (i): one process resumed from a copy of
    # the committed step the re-formed member restored
    oracle = os.path.join(tmp, "ck24_oracle")
    chaos.copy_committed_step(d, oracle, S)
    oracle_log = os.path.join(tmp, "oracle24.log")
    with open(oracle_log, "w") as f:
        oracle_proc = subprocess.Popen(
            [sys.executable, "-c", COHORT_CHILD, *argv, "--save", oracle,
             "--auto_resume", COHORT_ORACLE], cwd=here, env=env, stdout=f,
            stderr=subprocess.STDOUT)
    try:
        # ---- (i) kill_resume_2proc: the whole cohort relaunched ----
        run, _s, _t, stdout = supervise("relaunch", ["--max_restarts", 2])
        oracle_proc.wait(timeout=COHORT_TIMEOUT_S)
    finally:
        if oracle_proc.poll() is None:
            oracle_proc.kill()
            oracle_proc.wait()
    step_i, digests = ckpt_digests(torch, os.path.join(tmp, "ck24_relaunch"))
    ports = [port_of(sp) for sp in run["spawns"]]
    check(run["restarts"] == 1 and run["resizes"] == []
          and run["full_relaunches"] == 1
          and run["resume_steps"] == [-1, spe]
          and len(run["spawns"]) == 4 and None not in ports
          and ports[0] == ports[1] != ports[2] == ports[3]
          and sorted(run["exit_codes"][0])[0] == -9
          and run["exit_codes"][1] == [0, 0],
          f"(i) attempts {run['exit_codes']} ({run['reasons']}), resumes "
          f"{run['resume_steps']}, coordinators {ports}: {stdout[-3000:]}")
    same = digests == dp_kept["digests"]
    check(step_i == last and same, f"(i) final step {step_i} (want {last}); "
          f"params bit-identical to [23]'s uninterrupted run: {same}")
    print(f"  (i) kill_resume_2proc: supervisor --procs 2, train/kill on "
          f"process 1 at its step {COHORT_KILL_AT}: exit 0 in "
          f"{run['seconds']:.1f} s ((ii)'s one-process oracle running "
          f"beside it), attempts exited {run['exit_codes']} "
          f"({run['reasons']}), the whole cohort relaunched on a fresh port "
          f"({ports[0]} -> {ports[2]}), resumed_from_step {spe}; final step "
          f"{step_i}, params bit-identical to [23]'s uninterrupted two-rank "
          f"run ({len(digests)} leaves, sha256); members' launches "
          f"{run['launches']}", flush=True)
    out["kill_resume_2proc"] = {k: v for k, v in run.items()
                                if k != "spawns"}

    with open(oracle_log) as f:
        o_text = f.read()
    o_launches = last_json_line(o_text, "COHORT_LAUNCHES")
    o_final = last_json_line(o_text, "COHORT_DIGESTS")
    check(oracle_proc.returncode == 0 and o_launches and o_final,
          f"(ii) the one-process oracle exited {oracle_proc.returncode}: "
          f"{o_text[-3000:]}")
    # the re-formed member's params, as it printed them at its end and as
    # its one-process save holds them (the whole params), against the
    # oracle's printed ones (it saves no checkpoint)
    c_final = shrink["digests"].get("attempt1.proc0.log") or {}
    step_c, d_chaos = c_final.get("step"), c_final.get("digests")
    step_o, d_oracle = o_final["step"], o_final["digests"]
    step_s, d_saved = ckpt_digests(torch, d)
    one_spe = -(-dp_kept["n_train"] // TRAIN_B)  # one process's epoch
    check(step_c == step_o == step_s == S + (DP_EPOCHS["a"] - 1) * one_spe
          and d_chaos == d_oracle == d_saved
          and o_launches["attention_pool"] > 0
          and o_launches["sparse_row_adam"] > 0,
          f"(ii) final steps {step_c} / {step_o} / saved {step_s}, params "
          f"bit-identical {d_chaos == d_oracle}, the save's "
          f"{d_saved == d_oracle}, oracle launches {o_launches}")
    run = shrink
    print(f"  (ii) kill_resize: supervisor --procs 2 --resize_policy shrink "
          f"--min_procs 1, train/kill on process 1 at its step "
          f"{COHORT_KILL_AT}: exit 0 in {run['seconds']:.1f} s, attempts "
          f"exited {run['exit_codes']} ({run['reasons']}), resizes "
          f"{run['resizes']}, full_relaunches {run['full_relaunches']}, "
          f"restarts {run['restarts']}; the re-formed member has no --dist_* "
          f"flags, logged \"{reshard.split('INFO ')[-1]}\", saved steps "
          f"{sorted(topo)} with topology num_processes 1; final params, "
          f"as printed and as its last save holds them, bit-identical to "
          f"one process resumed from a copy of step {S} "
          f"({len(d_chaos)} leaves, sha256; the oracle, without epoch "
          f"saves, ran beside (i), launches {o_launches}); "
          f"recovery_steps_lost {lost}, recovery_seconds {recovery_s:.3f}; "
          f"members' launches {run['launches']}; step ms (median after "
          f"each member's first) at 2 ranks {[round(x, 1) for x in two_ms]}"
          f", at 1 after the resize {[round(x, 1) for x in one_ms]}",
          flush=True)
    print(f"  (iii) /fleet during (ii): {len(scrapes)} scrapes, "
          f"{len(before)} with both members up before the kill, "
          f"{len(after)} with the one member up after the resize", flush=True)
    out["kill_resize_model"] = finish_model_shrink(torch, model_shrink,
                                                   dp_kept)
    out["kill_resize"] = {
        **{k: v for k, v in run.items() if k != "spawns"},
        "resumed_from_step": S, "topology_after": topo,
        "recovery_steps_lost": lost, "recovery_seconds": recovery_s,
        "oracle_launches": o_launches,
        "step_ms_two_ranks": two_ms, "step_ms_one_rank": one_ms,
        "fleet": {"scrapes": len(scrapes), "two_up": len(before),
                  "one_up": len(after)}}
    for name in ("ck24_relaunch", "ck24_shrink", "ck24_oracle",
                 "ck24_model", "ck24_model_oracle", "tele24_relaunch",
                 "tele24_shrink", "tele24_model", "tele24_model_oracle",
                 "logs24_relaunch", "logs24_shrink", "logs24_model",
                 "logs24_model_oracle", "oracle24.log"):
        path = os.path.join(tmp, name)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
    report["cohort"] = out
    return started


# ---- [29]: the quality, coverage and decay studies ----

STUDY_CHILD = "import chip_smoke; chip_smoke.study_child()"
STUDY_NAMES, STUDY_METHODS, STUDY_SEED = 500, 2000, 7
STUDY_TIMEOUT_S, QS_BATCH = 600, 1024
# the JAX quality study's row (tools/quality_study.py run_variant), key
# for key
QS_ROW_KEYS = ["variant", "use_sampled_softmax", "tables_dtype",
               "embedding_optimizer", "encoder", "epochs", "batch", "lr",
               "lr_schedule", "warmup_steps", "trust_ratio",
               "trust_ratio_scope", "max_contexts", "steps", "train_seconds",
               "val_loss", "val_top1", "val_top5", "val_precision",
               "val_recall", "val_f1", "target_vocab_size"]


def study_child() -> None:
    """[29]'s studies in a process of their own (`python3 -c 'import
    chip_smoke; chip_smoke.study_child()' <dir>`), through the tools'
    `main`s on the card: `gen_java_corpus` (STUDY_NAMES names,
    STUDY_METHODS methods), the port's `c2v_extract --dir` on each split
    (the training split shuffled from STUDY_SEED), `extractor_coverage`
    on the corpus, `data.preprocess` at 200 contexts, `quality_study`
    over its six variants (one epoch each), `sampled_decay_study` for
    one probe. Prints `STUDY_RESULT <json>`: each tool's exit code and
    output, the training methods, the seconds of each, and the launches
    of kernels 1, 2, 3 and 4 (counted from 0 in this process)."""
    import contextlib
    import io
    import random

    import torch

    from code2vec_tpu_torch.data import preprocess
    from code2vec_tpu_torch.extractor import native
    from code2vec_tpu_torch.ops.requant_kernel import requantize_fused
    from code2vec_tpu_torch.tools import (extractor_coverage, gen_java_corpus,
                                          quality_study, sampled_decay_study)
    tmp = sys.argv[1]
    raw = os.path.join(tmp, "raw")
    out, secs = {}, {}

    def run(name, fn, argv):
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        rc = 0 if rc is None else rc  # data.preprocess returns None
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        out[name] = {"rc": rc, "stdout": buf.getvalue()}

    run("corpus", gen_java_corpus.main,
        ["--out", raw, "--names", str(STUDY_NAMES), "--methods",
         str(STUDY_METHODS), "--seed", str(STUDY_SEED)])
    t = time.perf_counter()
    binary = native.binary_path()
    files = {}
    for split in ("train", "val", "test"):
        lines = subprocess.run(
            [binary, "--dir", os.path.join(raw, split), "--max_path_length",
             "8", "--max_path_width", "2", "--num_threads", "4"],
            check=True, capture_output=True, text=True).stdout.splitlines()
        if split == "train":
            random.Random(STUDY_SEED).shuffle(lines)
        files[split] = os.path.join(tmp, f"qs.{split}.raw.txt")
        with open(files[split], "w") as f:
            f.write("".join(ln + "\n" for ln in lines if ln.strip()))
    secs["extract"] = time.perf_counter() - t
    total = int(out["corpus"]["stdout"].split("total: ")[1].split()[0])
    run("coverage", extractor_coverage.main,
        ["--dir", raw, "--expected", str(total)])
    prefix = os.path.join(tmp, "qs")
    run("preprocess", preprocess.main,
        ["--train_data", files["train"], "--val_data", files["val"],
         "--test_data", files["test"], "--max_contexts", "200",
         "--word_vocab_size", "1301136", "--path_vocab_size", "911417",
         "--target_vocab_size", "261245", "--output_name", prefix])
    out["n_train"] = count_lines(prefix + ".train.c2v")
    run("quality", quality_study.main,
        ["--data", prefix, "--epochs", "1", "--batch", str(QS_BATCH),
         "--max_contexts", "200"])
    run("decay", sampled_decay_study.main,
        ["--data", prefix, "--epochs", "1", "--probe_epochs", "1",
         "--batch", str(QS_BATCH)])
    out["seconds"] = secs
    out["launches"] = {**xf_counts(), "requantize": requantize_fused.launches}
    print("STUDY_RESULT " + json.dumps(out), flush=True)


def start_studies(tmp) -> dict:
    """[29]'s studies (`study_child`), started in a process of their own
    (its output in a file), killed at exit if still running."""
    import atexit
    here = os.path.dirname(os.path.abspath(__file__))
    st = {"dir": os.path.join(tmp, "studies"),
          "log": os.path.join(tmp, "studies.log"),
          "t": time.perf_counter()}
    os.makedirs(st["dir"])
    with open(st["log"], "w") as log:
        st["proc"] = subprocess.Popen(
            [sys.executable, "-c", STUDY_CHILD, st["dir"]], cwd=here,
            env=dict(os.environ, PYTHONPATH=here), stdout=log,
            stderr=subprocess.STDOUT)
    atexit.register(lambda p=st["proc"]: p.poll() is None and p.kill())
    return st


def finish_studies(np, st, report) -> dict:
    """[29]: the studies, waited for and checked: every tool exits 0;
    coverage at least 0.999; one quality row a variant, with the JAX
    row's keys, `steps` the reader's batches of the training split, F1
    and top-1 in [0, 1]; the decay probe's ten deciles, finite. Returns
    the child's kernel launches."""
    import shutil
    t = time.perf_counter()
    rc = st["proc"].wait(timeout=STUDY_TIMEOUT_S)
    waited = time.perf_counter() - t
    with open(st["log"]) as f:
        log = f.read()
    res = last_json_line(log, "STUDY_RESULT")
    check(rc == 0 and res is not None, f"(studies) exit {rc}: {log[-4000:]}")
    tools = ("corpus", "coverage", "preprocess", "quality", "decay")
    check(all(res[k]["rc"] == 0 for k in tools),
          f"(studies) exit codes { {k: res[k]['rc'] for k in tools} }")
    cov = json.loads(res["coverage"]["stdout"])
    check(cov["methods_expected"] == STUDY_METHODS
          and cov["coverage"] >= 0.999, f"(coverage) {cov}")
    rows = [json.loads(ln) for ln in res["quality"]["stdout"].splitlines()
            if ln.startswith("{")]
    from code2vec_tpu_torch.tools.quality_study import VARIANTS
    steps = -(-res["n_train"] // QS_BATCH)  # the reader's batches, an epoch
    check([r["variant"] for r in rows] == list(VARIANTS)
          and all(list(r) == QS_ROW_KEYS and r["steps"] == steps
                  and 0.0 <= r["val_f1"] <= 1.0 and 0.0 <= r["val_top1"] <= 1.0
                  for r in rows),
          f"(quality) {steps} steps wanted; rows {rows}")
    (probe,) = [json.loads(ln) for ln in res["decay"]["stdout"].splitlines()
                if ln.startswith("{")]
    check(all(len(probe[k]) == 10 and np.all(np.isfinite(probe[k]))
              for k in ("top1_by_decile", "row_norm_by_decile", "nu_by_decile",
                        "lr_x_update_by_decile"))
          and all(0.0 <= x <= 1.0 for x in probe["top1_by_decile"]),
          f"(decay) probe {probe}")
    launches = res["launches"]
    check(all(launches[k] > 0 for k in launches),
          f"(studies) kernel launches {launches}")
    secs = res["seconds"]
    print(f"  (corpus) gen_java_corpus --names {STUDY_NAMES} --methods "
          f"{STUDY_METHODS} --seed {STUDY_SEED}: "
          + res["corpus"]["stdout"].strip().replace("\n", "; ")
          + f" in {secs['corpus']:.1f} s; the port's c2v_extract on the "
          f"three splits {secs['extract']:.1f} s; {res['n_train']} training "
          f"methods preprocessed in {secs['preprocess']:.1f} s", flush=True)
    print(f"  (coverage) {json.dumps(cov)}", flush=True)
    for r in rows:
        print(f"  (quality) {r['variant']}: {r['steps']} steps, "
              f"train_seconds {r['train_seconds']}, val F1 {r['val_f1']}, "
              f"top-1 {r['val_top1']}, loss {r['val_loss']}, target vocab "
              f"{r['target_vocab_size']}", flush=True)
    print(f"  (decay) one probe after 1 epoch: top-1 by decile "
          f"{probe['top1_by_decile']}, row norms {probe['row_norm_by_decile']}"
          f", lr x update "
          f"{[f'{x:.3g}' for x in probe['lr_x_update_by_decile']]}",
          flush=True)
    print(f"  (studies) in a process of their own beside [23]-[28]: "
          f"{time.perf_counter() - st['t']:.1f} s from its start, waited "
          f"{waited:.1f} s; quality_study {secs['quality']:.1f} s, "
          f"sampled_decay_study {secs['decay']:.1f} s; kernel launches "
          f"{launches}", flush=True)
    report["studies"] = {"coverage": cov, "quality": rows, "decay": probe,
                         "seconds": secs, "waited_s": waited,
                         "launches": launches}
    shutil.rmtree(st["dir"])
    return launches


# ---- [30]: the profilers (code2vec_tpu_torch/tools) ----

TOOLS_CHILD = "import chip_smoke; chip_smoke.tools_child()"
TOOLS_STEPS, TOOLS_TIMEOUT_S = 2, 600
TOOLS_VOCAB, TOOLS_IDS = 1 << 20, 2 * TRAIN_B * C
TOOLS_DTYPES = ("bfloat16", "float32", "int8")
# the JAX tools' output: profile_step's telemetry phases and printed
# lines, xf_profile's phases, the sweeps' row keys
PROFILE_PHASES = ["hbm_ceiling", "forward", "forward_backward",
                  "full_step_adam", "full_step_adafactor"]
PROFILE_LINES = {"forward": "forward only:",
                 "forward_backward": "forward + backward:",
                 "full_step_adam": "full step (adam):",
                 "full_step_adafactor": "full step (adafactor):"}
XF_PHASES = ["matmul_peak_bf16", "emb_gathers_in_proj", "attn_core_fwd",
             "mlp_core_fwd", "encoder_fwd"] + [
    f"{p}_{tag}" for tag in ("plain", "kernel")
    for p in ("loss_fwd", "fwd_bwd", "full_step_adafactor")]
REQUANT_KEYS = ["vocab", "emb", "block_rows", "mode", "fused_ms",
                "reference_ms", "sweep_bytes", "fused_gbps"]
SPARSE_KEYS = ["vocab", "emb", "n_ids", "dtype", "block_rows", "mode",
               "unique_rows", "fused_ms", "reference_ms", "update_bytes",
               "fused_gbps"]


def tool_counters() -> dict:
    """The wrappers of kernels 1-6 by their launch-count names."""
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
    from code2vec_tpu_torch.ops.requant_kernel import requantize_fused
    from code2vec_tpu_torch.ops.sparse_update_kernel import (
        sparse_requant_adam_fused, sparse_row_adam_fused)
    from code2vec_tpu_torch.ops.xf_attention import (mha_backward_fused,
                                                     mha_forward_fused)
    return {"attention_pool": attention_pool_fused,
            "xf_attention_forward": mha_forward_fused,
            "xf_attention_backward": mha_backward_fused,
            "requantize": requantize_fused,
            "sparse_row_adam": sparse_row_adam_fused,
            "sparse_requant_adam": sparse_requant_adam_fused}


def tools_bits(torch) -> dict:
    """Kernel 4 and kernels 5, 6 against their plain versions on the
    sweeps' cells (their tools' `cell_inputs`, `cell_arrays`): {name:
    True when every output tensor has the plain version's bits}."""
    from code2vec_tpu_torch.ops.quant import requantize_reference
    from code2vec_tpu_torch.ops.requant_kernel import requantize_fused
    from code2vec_tpu_torch import tree
    from code2vec_tpu_torch.tools import requant_sweep
    from code2vec_tpu_torch.tools import sparse_update_sweep as sus
    out = {}
    qt, upd = requant_sweep.cell_inputs(TOOLS_VOCAB, E, DEV)
    mine = {k: v.clone() for k, v in qt.items()}
    requantize_fused(mine, upd, 0x9E3779B9)
    want = requantize_reference(qt, upd, 0x9E3779B9)
    out["requantize"] = all(torch.equal(mine[k], want[k]) for k in ("q", "s"))
    del qt, upd, mine, want
    arrays = sus.cell_arrays(TOOLS_VOCAB, E, TOOLS_IDS)
    for dtype in TOOLS_DTYPES:
        table, ids, grads = sus.cell_tensors(arrays, dtype, DEV)
        runs = []
        for use_kernel in (True, False):
            t = tree.map_leaves(torch.clone, table)
            state = sus.init_row_adam(t)
            count = torch.ones((), dtype=torch.int32, device=DEV)
            for salt in (1, 2):
                sus.apply_once(t, state, ids, grads, count, salt, use_kernel)
                count.add_(1)
            runs.append(([t["q"], t["s"]] if dtype == "int8" else [t])
                        + [state.m, state.v])
        out[f"sparse_{dtype}"] = all(torch.equal(a, b)
                                     for a, b in zip(*runs))
        del table, ids, grads, runs
    return out


def run_tools(torch, tele_dir: str) -> dict:
    """[30]'s profilers in this process, each through its tool's `main`
    on the card, counts at 0 just before: each tool's exit code, output
    and seconds, the launches of kernels 1-6 (read before
    `tools_bits`), profile_step's telemetry events, the bits."""
    import contextlib
    import io

    from code2vec_tpu_torch.tools import (profile_step, requant_sweep,
                                          sparse_update_sweep, xf_profile)
    out = {}

    def run(name, fn, argv):
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        torch.cuda.synchronize()
        out[name] = {"rc": rc, "stdout": buf.getvalue(),
                     "s": time.perf_counter() - t}

    counters = tool_counters()
    # ---- the main path: counts at 0 just before, read just after ----
    for wrapper in counters.values():
        wrapper.launches = 0
    steps = ["--steps", str(TOOLS_STEPS)]
    run("profile_step", profile_step.main, steps + ["--telemetry_dir",
                                                    tele_dir])
    run("xf_profile", xf_profile.main, steps)
    run("requant_sweep", requant_sweep.main,
        steps + ["--vocabs", str(TOOLS_VOCAB)])
    for dtype in TOOLS_DTYPES:
        run(f"sparse_update_sweep {dtype}", sparse_update_sweep.main,
            steps + ["--vocabs", str(TOOLS_VOCAB), "--ids", str(TOOLS_IDS),
                     "--dtype", dtype])
    launches = {k: w.launches for k, w in counters.items()}
    events = []
    for base, _dirs, files in os.walk(tele_dir):
        if "events.jsonl" in files:
            with open(os.path.join(base, "events.jsonl")) as f:
                events += [json.loads(ln) for ln in f if ln.strip()]
    return {"tools": out, "launches": launches,
            "profile_events": [e for e in events
                               if e.get("kind") == "profile"],
            "bits": tools_bits(torch)}


def tools_child() -> None:
    """[30]'s process (`python3 -c 'import chip_smoke;
    chip_smoke.tools_child()' <dir>`): it starts up (torch, the card,
    the kernels built by the parent), says `TOOLS_READY`, waits for a
    line on its standard input, then runs `run_tools` and prints
    `TOOLS_RESULT <json>`."""
    import torch

    from code2vec_tpu_torch.ops import _build
    for name in ("attention_pool", "xf_attention", "requant",
                 "sparse_row_update"):
        _build.load(name)
    torch.ones(1, device="cuda").sum().item()
    print("TOOLS_READY", flush=True)
    sys.stdin.readline()
    res = run_tools(torch, os.path.join(sys.argv[1], "tele"))
    print("TOOLS_RESULT " + json.dumps(res), flush=True)


def start_tools(tmp) -> dict:
    """[30]'s process (`tools_child`), started early so its start-up
    runs beside earlier phases; it does no work on the card until
    `phase_tools` says go. Killed at exit if still running."""
    import atexit
    here = os.path.dirname(os.path.abspath(__file__))
    tt = {"dir": os.path.join(tmp, "tools"),
          "log": os.path.join(tmp, "tools.log")}
    os.makedirs(tt["dir"])
    with open(tt["log"], "w") as log:
        tt["proc"] = subprocess.Popen(
            [sys.executable, "-c", TOOLS_CHILD, tt["dir"]], cwd=here,
            env=dict(os.environ, PYTHONPATH=here), stdin=subprocess.PIPE,
            stdout=log, stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda p=tt["proc"]: p.poll() is None and p.kill())
    return tt


def start_beside(fn, name: str) -> dict:
    """`fn()` on a thread of this process, its outcome (or exception)
    kept for `join_beside`."""
    box = {}

    def run() -> None:
        try:
            box["result"] = fn()
        except BaseException as e:  # raised again by join_beside
            box["error"] = e

    box["thread"] = threading.Thread(target=run, daemon=True, name=name)
    box["thread"].start()
    return box


def join_beside(box, timeout_s: float):
    """Wait for `start_beside`'s thread; raise what it raised."""
    box["thread"].join(timeout=timeout_s)
    check(not box["thread"].is_alive(),
          f"{box['thread'].name} still running after {timeout_s} s")
    if "error" in box:
        raise box["error"]
    return box.get("result")


def positive_ms(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x) and x > 0


def phase_tools(torch, tt, report) -> dict:
    """[30]: `start_tools`' process told to go once no other process
    uses the card, waited for and checked: each tool exits 0 and prints
    the card line; profile_step's four phases printed and its five
    telemetry phases written; xf_profile's phases in the JAX tool's
    order with their keys; one row a sweep cell with the JAX keys at the
    card's mode; every time finite and above 0; kernels 4, 5 and 6 the
    plain versions' bits on the cells. Returns the launches."""
    import re
    import shutil
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    proc = tt["proc"]
    try:
        proc.stdin.write("go\n")
        proc.stdin.close()
    except BrokenPipeError:
        pass  # it has died: its exit code and log are read below
    rc = proc.wait(timeout=TOOLS_TIMEOUT_S)
    with open(tt["log"]) as f:
        log = f.read()
    got = last_json_line(log, "TOOLS_RESULT")
    check(rc == 0 and got is not None and "TOOLS_READY" in log,
          f"(tools) exit {rc}: {log[-4000:]}")
    res = got["tools"]
    names = list(res)
    check(all(res[k]["rc"] == 0 and "card: " in res[k]["stdout"]
              for k in names),
          f"(tools) exit codes { {k: res[k]['rc'] for k in names} }: "
          + "; ".join(res[k]["stdout"][-1000:] for k in names
                      if res[k]["rc"] != 0))

    def json_rows(name):
        return [json.loads(ln) for ln in res[name]["stdout"].splitlines()
                if ln.startswith("{")]

    text = res["profile_step"]["stdout"]
    prof = {}
    for phase, label in PROFILE_LINES.items():
        m = re.search(re.escape(label) + r"\s+(-?[\d.]+) ms", text)
        prof[phase] = float(m[1]) if m else None
    hbm = re.search(r"HBM streaming \(1 GiB copy\): (\d+) GB/s", text)
    ev_phases = [e["phase"] for e in got["profile_events"]]
    check(all(positive_ms(v) for v in prof.values()) and hbm
          and int(hbm[1]) > 0 and ev_phases == PROFILE_PHASES
          and all(positive_ms(e.get("ms", e.get("gbps")))
                  for e in got["profile_events"]),
          f"(profile_step) {prof}, events {got['profile_events']}")
    xf = json_rows("xf_profile")
    check([r["phase"] for r in xf] == XF_PHASES
          and all(positive_ms(r["ms"]) and positive_ms(r["tflops_per_sec"])
                  for r in xf)
          and "xla_logits_hbm_bytes" in xf[2]
          and all("pc_per_sec" in r for r in xf
                  if r["phase"].startswith("full_step")),
          f"(xf_profile) rows {xf}")
    (rq,) = json_rows("requant_sweep")
    check(list(rq) == REQUANT_KEYS and rq["mode"] == "gpu"
          and rq["block_rows"] == 32 and rq["vocab"] == TOOLS_VOCAB
          and positive_ms(rq["fused_ms"]) and positive_ms(rq["reference_ms"]),
          f"(requant_sweep) {rq}")
    sparse = {d: json_rows(f"sparse_update_sweep {d}") for d in TOOLS_DTYPES}
    check(all(len(rows) == 4 and all(
        list(r) == SPARSE_KEYS and r["mode"] == "gpu" and r["dtype"] == d
        and r["n_ids"] == TOOLS_IDS and 0 < r["unique_rows"] <= TOOLS_IDS
        and positive_ms(r["fused_ms"]) and positive_ms(r["reference_ms"])
        for r in rows) for d, rows in sparse.items()),
        f"(sparse_update_sweep) {sparse}")
    check(all(got["bits"].values()), f"(tools) kernels against their plain "
          f"versions on the sweeps' cells: {got['bits']}")
    launches = got["launches"]
    check(all(launches[k] > 0 for k in launches),
          f"(tools) kernel launches {launches}")
    secs = {k: res[k]["s"] for k in names}
    print(f"  (profile_step) HBM {hbm[1]} GB/s; " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in prof.items()), flush=True)
    print("  (xf_profile) " + ", ".join(
        f"{r['phase']} {r['ms']} ms ({r['tflops_per_sec']} TFLOP/s)"
        for r in xf), flush=True)
    print(f"  (requant_sweep) {json.dumps(rq)}", flush=True)
    for d, rows in sparse.items():
        r = rows[0]
        print(f"  (sparse_update_sweep {d}) U {r['unique_rows']}, fused "
              f"{r['fused_ms']} ms, reference {r['reference_ms']} ms; "
              f"update_bytes by block " + ", ".join(
                  f"{x['block_rows']}: {x['update_bytes']}" for x in rows),
              flush=True)
    print(f"  (tools) {time.perf_counter() - t_phase:.1f} s in all: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + f"; kernels against their plain versions on the cells "
          f"{got['bits']}; kernel launches {launches}", flush=True)
    report["tools"] = {"profile_step": prof, "hbm_gbps": int(hbm[1]),
                       "xf_profile": xf, "requant_sweep": rq,
                       "sparse_update_sweep": sparse, "seconds": secs,
                       "bits": got["bits"], "launches": launches}
    shutil.rmtree(tt["dir"])
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write all measurements to this JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it runs on a CUDA card",
              file=sys.stderr)
        return 2
    import numpy as np

    t_start = time.perf_counter()
    # ---- 1. the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak_name, peaks = card_peaks(kind)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1] card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | peaks of {peak_name} | "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    report = {"card": card, "kind": kind, "torch": torch.__version__,
              "cuda": torch.version.cuda, "peaks_of": peak_name,
              "phase_s": {}}
    t_lap = [time.perf_counter()]

    def lap(phase: str) -> None:
        """Print and record the seconds since the previous phase ended."""
        now = time.perf_counter()
        report["phase_s"][phase] = now - t_lap[0]
        print(f"  phase {phase}: {now - t_lap[0]:.1f} s", flush=True)
        t_lap[0] = now

    # ---- 2. build ----
    phase_build(report)
    lap("[2]")

    # ---- 3. the attention-pool kernel vs its plain version ----
    print("[3] attention-pool kernel vs plain version (TF32 off)", flush=True)
    pool_rows = phase_kernels(torch, peaks, report)
    lap("[3]")

    # ---- 4. the serving path ----
    print("[4] java-large serving path", flush=True)
    t0 = time.perf_counter()
    vocabs = synthetic_vocabs()
    print(f"  synthetic vocab built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    serve_launches = phase_serving(torch, np, vocabs, report)
    lap("[4]")

    # ---- 5. the sparse-row training path ----
    print("[5] java-large sparse-row training path", flush=True)
    train_launches, java_u = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        data_prefix = os.path.join(tmp, "java")
        data_path = data_prefix + ".train.c2v"
        test_path = data_prefix + ".test.c2v"
        t0 = time.perf_counter()
        n_methods = (TRAIN_STEPS + 1) * TRAIN_B
        write_training_file(np, data_path, n_methods,
                            np.random.default_rng(SEED))
        write_training_file(np, test_path, EVAL_METHODS,
                            np.random.default_rng(SEED + 1))
        print(f"  synthetic .c2v: {n_methods} training and {EVAL_METHODS} "
              f"test methods, {os.path.getsize(data_path) / 1e6:.1f} + "
              f"{os.path.getsize(test_path) / 1e6:.1f} MB, written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for label, tables, sampled in (("a", "bfloat16", True),
                                       ("b", "int8", False)):
            _, cfg = train_config(label, tables, sampled)
            train_launches[label], java_u[label] = phase_train_config(
                torch, np, vocabs, data_path, label, cfg, report)

        # ---- 6. the live-row Adam kernels vs their plain versions ----
        print("[6] live-row Adam kernels vs plain versions", flush=True)
        lap("[5]")
        row_rows = phase_row_kernels(
            torch, peaks, {"bfloat16": java_u["a"], "float32": java_u["a"],
                           "int8": java_u["b"]}, report)

        # ---- 7. the dense requantize kernel vs its plain version ----
        print("[7] dense int8 requantize kernel vs plain version", flush=True)
        lap("[6]")
        requant_rows = phase_requant_kernel(torch, peaks, report)
        lap("[7]")

        # ---- 8. the dense training path ----
        print("[8] java-large dense training path (the default step)",
              flush=True)
        for label, tables, sampled in (("c", "bfloat16", False),
                                       ("d", "int8", True)):
            _, cfg = dense_config(label, tables, sampled)
            train_launches[label] = phase_dense_config(
                torch, np, vocabs, data_path, label, cfg, report)

        # ---- 9. evaluation ----
        print("[9] java-large evaluation", flush=True)
        lap("[8]")
        eval_launches = phase_eval(torch, np, vocabs, test_path, report)
        lap("[9]")

        # ---- 10. kernels 2 and 3 vs their plain versions ----
        print("[10] fused-MHA kernels (2, 3) vs plain versions (TF32 off)",
              flush=True)
        xf_rows = phase_xf_kernels(torch, peaks, report)
        lap("[10]")

        # ---- 11.-13. the transformer path-encoder ----
        print("[11] java-large transformer serving path", flush=True)
        xf_launches = {"serving": phase_xf_serving(torch, np, vocabs, report)}
        lap("[11]")
        print("[12] java-large transformer dense training path (e)",
              flush=True)
        xf_launches["train_e"] = phase_xf_train(torch, np, vocabs, data_path,
                                                report)
        lap("[12]")
        print("[13] java-large transformer evaluation", flush=True)
        xf_launches["eval"] = phase_xf_eval(torch, np, vocabs, test_path,
                                            report)

        # ---- 14. the command line ----
        print("[14] the command line (cli.main) at java-large width",
              flush=True)
        lap("[13]")
        cli_launches, kept = phase_cli(torch, np, vocabs, tmp, data_prefix,
                                       test_path, report)
        chunk_launches = chunked_infeed_check(torch, vocabs, data_prefix,
                                              report)
        lap("[14]")

        # ---- 15. the REPL ----
        print("[15] the --predict REPL on the card, through the extractor "
              "pool", flush=True)
        # `kept` holds [14]'s paths, step count and losses, no clock value
        repl_launches = phase_repl(  # graftlint: disable=nondeterminism
            torch, np, tmp, kept, report)
        lap("[15]")

        # ---- 16. the trainer observed and faulted ----
        print("[16] the trainer observed (telemetry, trace, watchdog, "
              "profiler) and faulted (ckpt/write, train/kill, "
              "train/nan_loss)", flush=True)
        observed_launches = phase_observed(  # graftlint: disable=nondeterminism
            torch, np, vocabs, tmp, data_prefix, test_path, kept, report)
        lap("[16]")

        # ---- 17. the live metrics plane ----
        print("[17] the live metrics plane (/metrics, /healthz, /vars; "
              "alerts; --no_pallas) on the card", flush=True)
        plane_launches = phase_live_plane(  # graftlint: disable=nondeterminism
            torch, np, vocabs, tmp, data_prefix, test_path, kept, report)
        lap("[17]")

        # ---- 18. the phase profiler ----
        print("[18] the sampled phase profiler (--phase_profile) on (c) and "
              "(a), the card's streaming ceiling", flush=True)
        phase_launches = phase_profiler_phase(  # graftlint: disable=nondeterminism
            torch, np, vocabs, tmp, data_prefix, kept, report)
        finish_exports(np, vocabs, kept, report)
        lap("[18]")

        # ---- 20. the serving fleet (alone: its p99 is checked) ----
        print("[20] the serving fleet over HTTP (replica pool, hot reload, "
              "a replica death, a refused step, the autoscaler) at "
              "java-large width", flush=True)
        # the earlier phases' disk writes (the exports' 2.6 GB of text,
        # the checkpoints) flushed first: the load's window holds only
        # its own
        os.sync()
        fleet_launches = phase_fleet(torch, np, vocabs, tmp, report)
        lap("[20]")

        # ---- 21. the VarMisuse head ----
        print("[21] the VarMisuse head (--head varmisuse) at java-large "
              "width: (f) dense, (g) sparse-row, evaluation, the command "
              "line", flush=True)
        vm_launches = phase_vm(torch, np, vocabs, tmp, report)
        lap("[21]")

        # ---- 22. the attacks and the rename defense ----
        print("[22] the adversarial attacks and the rename defense: (h) the "
              "attack at java-large width, (i) on the transformer, (j) the "
              "defended dense step, (k) --attack and the REPL, (l) the "
              "VarMisuse sweep", flush=True)
        attack_launches = phase_attacks(torch, np, vocabs, tmp, data_path,
                                        test_path, peaks, report)
        lap("[22]")

        # ---- 19. the restart supervisor, beside [23] ----
        print("[19] the restart supervisor (train/kill, an exhausted "
              "budget) with the fleet plane; [16]'s train/kill leg beside "
              "it; on a thread beside [23]", flush=True)

        def supervised_legs() -> None:
            kill_chain = start_kill_resume(tmp, kept)
            phase_supervised(  # graftlint: disable=nondeterminism
                torch, np, tmp, data_prefix, kept, report)
            # `kept` holds [14]'s paths, step count and losses, no clock
            finish_kill_resume(  # graftlint: disable=nondeterminism
                torch, kill_chain, kept, report)

        legs = start_beside(supervised_legs, "supervised-legs")

        # ---- 23. data-parallel training across processes ----
        print("[23] data-parallel training: two ranks on the card (gloo) "
              "through the command line and the function-level harness, "
              "one rank over NCCL", flush=True)
        # [29]'s studies, in a process of their own beside [23]-[28]
        studies = start_studies(tmp)
        dp_launches, dp_kept, ctx_runs = phase_data_parallel(
            torch, np, vocabs, tmp, data_prefix, test_path, report)
        # [27]'s model-2 exports, beside [24]
        model_exports = start_model_exports(tmp, kept)
        lap("[23]")
        join_beside(legs, SUP_TIMEOUT_S)
        lap("[19]")

        # ---- 24. the supervised training cohort ----
        print("[24] the supervised training cohort: (a) at two ranks on the "
              "card under the supervisor tool, (i) kill_resume_2proc, (ii) "
              "kill_resize (shrink to one process), (iii) /fleet, (iv) "
              "kill_resize at (data 2, model 2) (shrink to model 2)",
              flush=True)
        # [28]'s two pairs, beside [24]'s (i) and (ii)'s oracle; `kept`
        # holds [14]'s paths, step count and losses, no clock value
        cohort_pairs = phase_cohort(  # graftlint: disable=nondeterminism
            torch, tmp, dp_kept, report,
            beside_i=lambda: start_cohort_pairs(tmp, kept, report))
        lap("[24]")

        # [30]'s process starts up beside [25]-[29] and works at [30]
        tools = start_tools(tmp)

        # ---- 25. the context axis (run in [23]'s children) ----
        print("[25] the context axis: the ring and the ctx steps ((e) with "
              "the ring and with kernels 2, 3; (c) with kernel 1) against "
              "one rank, the ctx command line, a one-process --load",
              flush=True)
        ctx_launches = phase_context(
            torch, vocabs, test_path, ctx_runs,
            os.path.join(tmp, "ctx_ckpt"), dp_kept["n_train"], report)
        lap("[25]")

        # ---- 26. the model axis (run in [23]'s children) ----
        print("[26] the model axis: (c) and (e) against one rank, (a) with "
              "kernel 5 on each window, the merged evaluation, the model "
              "command line, a one-process --load", flush=True)
        model_launches = phase_model(
            torch, vocabs, test_path, ctx_runs,
            os.path.join(tmp, "model_ckpt"), dp_kept["n_train"], report)
        lap("[26]")

        # ---- 27. the VarMisuse head and the exports under the model axis
        print("[27] the model axis under the VarMisuse head and the writer: "
              "(f) and the evaluation against one rank, the gathered tables, "
              "the model-2 exports and release", flush=True)
        export_r0 = finish_model_exports(  # graftlint: disable=nondeterminism
            torch, kept, model_exports, report)
        vm_model_launches = phase_vm_model(torch, ctx_runs, export_r0, report)
        lap("[27]")

        # ---- 28. --predict, the REPL and --attack above one rank ----
        print("[28] --predict, the REPL and --attack above one rank: the "
              "predict-side model and the attack over the model axis's "
              "windows against one rank, the --predict and --attack pairs "
              "against [15] and (k)", flush=True)
        pair_out = finish_cohort_pairs(  # graftlint: disable=nondeterminism
            torch, kept, cohort_pairs, report)
        cohort_launches = phase_cohort_serving(torch, ctx_runs, pair_out,
                                               report)
        lap("[28]")

        # ---- 29. the studies ----
        print("[29] the studies on the card: gen_java_corpus, the port's "
              "extractor and extractor_coverage, quality_study's six "
              "variants, sampled_decay_study's probe", flush=True)
        study_launches = finish_studies(np, studies, report)
        lap("[29]")

        # ---- 30. the profilers, with the card to themselves ----
        print("[30] the profilers on the card: profile_step, xf_profile, "
              "requant_sweep, sparse_update_sweep (bf16, float32, int8)",
              flush=True)
        tool_launches = phase_tools(torch, tools, report)
        lap("[30]")

    # ---- 31. result ----
    # kernel 1's times at the training shape, where most of its device
    # time on the main paths goes (the serving buckets are in --out)
    main_pool = next(r for r in pool_rows
                     if r["B"] == TRAIN_B and r["ctx_dtype"] == "bfloat16")
    pool_launches = serve_launches["attention_pool"] + sum(
        v["attention_pool"] for v in train_launches.values()) \
        + eval_launches["attention_pool"] + sum(
            v["attention_pool"] for v in cli_launches.values()) \
        + repl_launches["attention_pool"] \
        + observed_launches["attention_pool"] \
        + plane_launches["attention_pool"] + phase_launches["attention_pool"] \
        + fleet_launches["attention_pool"] + vm_launches["attention_pool"] \
        + attack_launches["attention_pool"] + dp_launches["attention_pool"] \
        + ctx_launches["attention_pool"] + model_launches["attention_pool"] \
        + chunk_launches["attention_pool"] \
        + vm_model_launches["attention_pool"] \
        + cohort_launches["attention_pool"] \
        + study_launches["attention_pool"] + tool_launches["attention_pool"]
    main_requant = next(r for r in requant_rows
                        if r["V"] == JAVA_LARGE["token"] + 2)

    def row_entry(name, kind, replaces, launches):
        main = next(r for r in row_rows if r["kind"] == kind and r["E"] == E
                    and r["U"] == java_u["a" if kind != "int8" else "b"]
                    ["token_emb"])
        return {"name": name, "route": "cuda",
                "source": "code2vec_tpu_torch/csrc/sparse_row_update.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in row_rows
                                   if (r["kind"] == "int8") == (kind == "int8")),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": None}
    kernels = [
        {"name": main_pool["kernel"], "route": "cuda",
         "source": "code2vec_tpu_torch/csrc/attention_pool.cu",
         "replaces": "code2vec_tpu/ops/pallas_attention.py:75",
         "launches": pool_launches,
         "max_abs_err": max(max(r["max_abs_err_code"], r["max_abs_err_attn"])
                            for r in pool_rows),
         "ms": main_pool["ms"], "plain_ms": main_pool["plain_ms"],
         "bound_ms": main_pool["bound_ms"], "bound_by": main_pool["bound_by"],
         "library_ms": main_pool["library_ms"]},
        row_entry("sparse_row_adam", "bfloat16",
                  "code2vec_tpu/ops/pallas_sparse_update.py:110",
                  train_launches["a"]["sparse_row_adam"]
                  + cli_launches["sparse"]["sparse_row_adam"]
                  + phase_launches["sparse_row_adam"]
                  + vm_launches["sparse_row_adam"]
                  + model_launches["sparse_row_adam"]
                  + tool_launches["sparse_row_adam"]),
        row_entry("sparse_requant_adam", "int8",
                  "code2vec_tpu/ops/pallas_sparse_update.py:204",
                  train_launches["b"]["sparse_requant_adam"]
                  + tool_launches["sparse_requant_adam"]),
        {"name": main_requant["kernel"], "route": "cuda",
         "source": "code2vec_tpu_torch/csrc/requant.cu",
         "replaces": "code2vec_tpu/ops/pallas_requant.py:85",
         "launches": train_launches["d"]["requantize"]
         + cli_launches["int8"]["requantize"]
         + attack_launches["requantize"] + study_launches["requantize"]
         + tool_launches["requantize"],
         "max_abs_err": max(r["max_abs_err"] for r in requant_rows),
         "ms": main_requant["ms"], "plain_ms": main_requant["plain_ms"],
         "bound_ms": main_requant["bound_ms"],
         "bound_by": main_requant["bound_by"], "library_ms": None},
    ]
    # kernels 2 and 3 at the training shape, where most of their launches'
    # work is (the other shapes are in --out); every launch on the main
    # paths is bf16, so they are the tensor-core kernels, and max_abs_err
    # is over the bf16 rows
    for name, counter, direction, line in (
            (XF_FWD_KERNEL["bfloat16"], "xf_attention_forward", "forward", 120),
            ("+".join(XF_BWD_KERNELS["bfloat16"]), "xf_attention_backward",
             "backward", 138)):
        main_row = next(r for r in xf_rows[direction]
                        if r["shape"][0] == TRAIN_B)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "code2vec_tpu_torch/csrc/xf_attention.cu",
            "replaces": f"code2vec_tpu/ops/xf_attention.py:{line}",
            "launches": sum(v[counter] for v in xf_launches.values())
            + attack_launches[counter] + ctx_launches[counter]
            + model_launches[counter] + cohort_launches.get(counter, 0)
            + study_launches[counter] + tool_launches[counter],
            "max_abs_err": max(r["max_abs_err"] for r in xf_rows[direction]
                               if r["kernel"] == name),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
    for k in kernels:
        check(k["launches"] >= 1, f"kernel {k['name']} never launched on "
              f"a main path")
    report["kernels"] = kernels
    report["launches"] = {"serving": serve_launches, "eval": eval_launches,
                          **{f"train_{k}": v
                             for k, v in train_launches.items()},
                          **{f"xf_{k}": v for k, v in xf_launches.items()},
                          **{f"cli_{k}": v for k, v in cli_launches.items()},
                          "repl": repl_launches, "observed": observed_launches,
                          "live_plane": plane_launches,
                          "phases": phase_launches, "fleet": fleet_launches,
                          "vm": vm_launches, "attacks": attack_launches,
                          "data_parallel": dp_launches,
                          "context": ctx_launches, "model": model_launches,
                          "chunked": chunk_launches,
                          "vm_model": vm_model_launches,
                          "cohort": cohort_launches, "studies": study_launches,
                          "tools": tool_launches}
    report["total_s"] = time.perf_counter() - t_start
    print(f"  whole run {report['total_s']:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run the PyTorch port's serving, training and evaluation paths on one
CUDA card and check them.

    python3 chip_smoke.py [--out FILE]

Phases (any failure raises, and the script exits non-zero):

1. the card (`nvidia-smi` name and power limit), torch and CUDA versions;
   TF32 is switched off for float32 products and convolutions;
2. build every kernel of the ported paths from `code2vec_tpu_torch/csrc`,
   one `nvcc` per source, all started together; print each entry
   point's registers and spills;
3. the attention-pool kernel (kernel 1) against its plain PyTorch
   version on the card, at the serving shapes (B = 1, 7, 64; bf16 and
   float32 contexts) and the training shape (B = 1024, bf16), with its
   time beside the plain version's, a library yardstick's and the card's
   bound;
4. the serving path at java-large width (vocab sizes 1,301,136 tokens,
   911,417 paths, 261,245 targets; E = 128, C = 200, bf16 tables, bf16
   compute; random weights from seed 0, a synthetic vocab): the port's
   `PredictionServer` answers 32 concurrent requests of raw extractor
   lines. Every kernel's launch counter is set to 0 just before and read
   just after; each must have launched. One batch is then held against
   the plain path on the card;
5. the sparse-row training path at the same width (`TRAIN_BATCH_SIZE`
   1024, bf16 compute) over a synthetic `.c2v` file whose words are drawn
   Zipf (s = 1.1) over the vocab, through the trainer entry point, in two
   configurations: (a) bf16 tables, sampled softmax over 4096 classes
   (kernel 5 on token, path and target); (b) int8 token/path and bf16
   target tables, full softmax (kernel 6 on token and path, dense Adam on
   target). For each: a few steps with the counters at 0 just before and
   read just after (launches must match the tables updated per step);
   one step with the kernels against one with the plain versions from
   the same state, draws and row gradients; the loss falling over 5
   steps of a repeated batch; the step time and its split by phase;
6. the live-row Adam kernels (5 and 6) against their plain versions on
   the card, at U = 1, 1000 and the U of a java-large step, for E = 128
   bf16, E = 128 float32, E = 384 bf16 (kernel 5) and E = 128 int8
   (kernel 6), with their times beside the plain versions' and the bound;
7. the dense int8 requantize kernel (kernel 4) against its plain version
   on the card, at (V, E) = (1, 128), (1000, 128), (257, 100) and the two
   java-large int8 tables (1,301,138 and 911,419 rows of 128), bf16
   updates and one float32 case: q and s bit-identical, its time beside
   the plain version's and the byte bound;
8. the dense training path (the default step) at the same width through
   the trainer, over the same file, in two configurations: (c) the JAX
   package's defaults: bf16 tables, full softmax, Adafactor on the
   tables, Adam on TRANSFORM / ATTENTION, cosine LR; (d) int8 token/path
   and bf16 target tables, sampled softmax over 4096, Adafactor, cosine
   LR (kernel 4 on token and path every step). For each: counted steps
   (kernel 4 twice a step in (d), never in (c), kernel 1 once a step);
   one step with the kernels against one with the plain versions from the
   same state and draws (loss within 1e-3; the same optimizer update
   applied by both gives bit-identical tables, q and s); the loss falling
   over 5 steps of a repeated batch; the step time, its split by phase
   and the device busy share;
9. evaluation: `Code2VecTrainer.evaluate` over a synthetic 4096-method
   test file at TEST_BATCH_SIZE 1024 (counted: kernel 1 once a batch),
   its results and methods/s; the kernel path held against the plain
   path batch by batch (loss within 1e-3, top-1 equal on 99% of the
   methods);
10. the fused multi-head attention kernels (2: forward, 3: backward as
   launches 3a and 3b) against their plain versions on the card, at
   (B, H, C, hd) = (1, 3, 200, 128), (7, ...), (64, ...) and
   (1024, ...) in bf16 and (4, 4, 200, 96), (16, 2, 24, 16) in float32,
   with their times (CUDA events and profiler device time, 3a and 3b
   apart) beside the plain versions', the SDPA yardstick's and the bound;
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
   same loss), the loss falling over 5 steps of a repeated batch, the
   step time, its split by phase, the device busy share and peak memory;
13. evaluation of a transformer model over the 4096-method test file
   (kernel 2 L times a batch), against the plain path batch by batch;
14. a `{"kernels": [...]}` line, the card line, and last
   `{"ok": true, "device": {...}}`.

Without a CUDA card it exits with code 2 and prints no result. It imports
nothing of JAX. `--out FILE` also writes every measurement as JSON.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
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
# training batch, then H = 4's hd = 96 and the test shape, in float32
XF_CASES = (((1, XF_H, C, D // XF_H), "bfloat16"),
            ((7, XF_H, C, D // XF_H), "bfloat16"),
            ((64, XF_H, C, D // XF_H), "bfloat16"),
            ((TRAIN_B, XF_H, C, D // XF_H), "bfloat16"),
            ((4, 4, C, 96), "float32"), ((16, 2, 24, 16), "float32"))
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
    by_name = {}
    for e in cuda:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall_ms / n, "busy_ms": busy / 1e3 / n,
            "kernel_ms": {k: us / 1e3 / n for k, us in top}}


def kernel_device_ms(torch, fn, name_part: str, n: int = 10):
    """Device time of one launch of the kernel whose name holds
    `name_part`, from the profiler (no host time in it); None where the
    profiler saw no CUDA activity."""
    prof = profile_calls(torch, fn, n)
    if prof is None:
        return None
    hits = [ms for k, ms in prof["kernel_ms"].items() if name_part in k]
    check(len(hits) == 1, f"profiler kernels matching {name_part}: {hits}")
    return hits[0]


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


def pool_bound(B: int, ctx_bytes: int, peaks):
    """Least time for one pool call: each input read once, each output
    written once, against the float32 FMA peak (the kernel's arithmetic)."""
    f32_peak, bf16_peak, hbm = peaks
    nbytes = B * C * D * ctx_bytes + D * D * 4 + D * 4 + B * C * 4 \
        + B * D * 4 + B * C * 4
    flops = 2 * B * C * D * D + 4 * B * C * D
    ms_bytes = nbytes / hbm * 1e3
    ms_f32 = flops / f32_peak * 1e3
    ms_tc = flops / bf16_peak * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": ms_bytes,
            "f32_ops_ms": ms_f32, "tensor_core_ops_ms": ms_tc,
            "bound_ms": max(ms_bytes, ms_f32),
            "bound_by": "operations" if ms_f32 >= ms_bytes else "bytes"}


def phase_kernels(torch, peaks, report):
    from code2vec_tpu_torch.ops.attention_kernel import (attention_pool_fused,
                                                         attention_pool_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    both = (torch.bfloat16, torch.float32)
    cases = [(B, dt) for B in BUCKET_SHAPES for dt in both]
    cases.append((TRAIN_B, torch.bfloat16))  # the training step's pool
    for B, dtype in cases:
        ctx, tr, at, mask = pool_inputs(torch, B, dtype, gen)
        code_k, attn_k = attention_pool_fused(ctx, tr, at, mask)
        code_p, attn_p = attention_pool_plain(ctx, tr, at, mask)
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
        flat = ctx.float().reshape(B * C, D)
        k_ms = time_ms(torch, lambda: attention_pool_fused(ctx, tr, at, mask))
        p_ms = time_ms(torch, lambda: attention_pool_plain(ctx, tr, at, mask))
        lib_ms = time_ms(torch, lambda: torch.matmul(flat, tr))
        dev_ms = kernel_device_ms(
            torch, lambda: attention_pool_fused(ctx, tr, at, mask),
            "attention_pool_kernel")
        bound = pool_bound(B, ctx.element_size(), peaks)
        row = {"B": B, "ctx_dtype": str(dtype).replace("torch.", ""),
               "max_abs_err_code": err_c, "max_abs_err_attn": err_a,
               "ms": k_ms, "kernel_device_ms": dev_ms, "plain_ms": p_ms,
               "library_ms": lib_ms, **bound}
        rows.append(row)
        print(f"  attention_pool B={B:4d} {row['ctx_dtype']:8s} "
              f"err code {err_c:.3g} attn {err_a:.3g} | kernel {k_ms:.4f} ms"
              f" (device {fmt_ms(dev_ms)})"
              f" plain {p_ms:.4f} ms matmul {lib_ms:.4f} ms | bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; tensor-core "
              f"{bound['tensor_core_ops_ms']:.4f} ms)", flush=True)
    report["attention_pool"] = rows
    return rows


def synthetic_vocabs():
    """A java-large-sized vocab with words generated by rule."""
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


def phase_serving(torch, np, vocabs, report):
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.encoder import (ModelDims, gather_contexts,
                                                   init_params)
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
    """One `nvcc` per source, all started together."""
    from code2vec_tpu_torch.ops import _build
    from code2vec_tpu_torch.ops.attention_kernel import KERNEL as POOL
    from code2vec_tpu_torch.ops.requant_kernel import KERNEL as REQUANT
    from code2vec_tpu_torch.ops.sparse_update_kernel import KERNEL as ROWS
    from code2vec_tpu_torch.ops.xf_attention_kernel import KERNEL as XF
    names = (POOL, ROWS, REQUANT, XF)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        futures = {name: ex.submit(_build.build, name) for name in names}
        nvcc_s = {name: f.result() for name, f in futures.items()}
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
        dev_ms = kernel_device_ms(torch, run_kernel, "requant_kernel")
        bound = requant_bound(V, width, upd.element_size(), peaks)
        row = {"V": V, "E": width, "update": upd_name, "max_abs_err": 0.0,
               "zero_update_flips": flips, "ms": k_ms,
               "kernel_device_ms": dev_ms, "plain_ms": p_ms,
               "library_ms": None, **bound}
        rows.append(row)
        print(f"  requantize V={V:8d} E={width} {upd_name:8s}: q, s "
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
    labels, src, pth, dst, mask, weights = batch
    ctx = gather_contexts(params, src, pth, dst, torch.bfloat16)
    code, _ = attention_pool_plain(ctx, params["transform"],
                                   params["attention"], mask)
    logits = full_logits(params, code.to(torch.bfloat16),
                         dims.target_vocab_size)
    ce = torch.clamp(F.cross_entropy(logits, labels.long(), reduction="none"),
                     min=0.0)
    return (ce * weights).sum(), torch.topk(logits, top_k, dim=-1).indices


def phase_eval(torch, np, vocabs, test_path, report):
    """`evaluate` over the test file (counted), then the kernel path
    against the plain path batch by batch."""
    from code2vec_tpu_torch.data.reader import C2VTextReader
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
    of their operand types: `pair` products of two input arrays (q k^T,
    dO v^T) at the bf16 tensor-core peak when the inputs are bf16 (a bf16
    product is exact in a float32 sum), `wide` products with a float32
    operand (the softmax weights A, or dL) at the float32 peak, as every
    product of float32 inputs."""
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
        torch.cuda.synchronize()
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
            torch, lambda: xa.mha_forward_fused(q, k, v, lm), "mha_fwd_kernel")
        k3a_dev = kernel_device_ms(
            torch, lambda: xa.mha_backward_fused(q, k, v, lm, do),
            "mha_bwd_dq_kernel")
        k3b_dev = kernel_device_ms(
            torch, lambda: xa.mha_backward_fused(q, k, v, lm, do),
            "mha_bwd_dkv_kernel")
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
        # kernel 2: q k^T, A v; kernel 3 as the Pallas kernel counts it:
        # q k^T, dO v^T, A^T dO, dL k, dL^T q; 3a + 3b recompute q k^T and
        # dO v^T in both launches
        b2 = xf_bound(shape, elem, peaks, 1, 1, 4)
        b3 = xf_bound(shape, elem, peaks, 2, 3, 7)
        b3_split = xf_bound(shape, elem, peaks, 4, 3, 7)
        common = {"shape": list(shape), "dtype": dname}
        rows["forward"].append({
            **common, "max_abs_err": errs[0], "rel_err": rels[0],
            "ms": k2_ms, "kernel_device_ms": k2_dev, "plain_ms": p2_ms,
            "library_ms": l2_ms, **b2})
        rows["backward"].append({
            **common, "max_abs_err": max(errs[1:]), "rel_err": max(rels[1:]),
            "ms": k3_ms, "kernel_device_ms": (
                None if None in (k3a_dev, k3b_dev) else k3a_dev + k3b_dev),
            "kernel_3a_device_ms": k3a_dev, "kernel_3b_device_ms": k3b_dev,
            "plain_ms": p3_ms, "library_ms": l3_ms, **b3,
            "split_ops_ms": b3_split["ops_ms"]})
        print(f"  mha {tuple(shape)} {dname:8s} rel err o {rels[0]:.2g} "
              f"dq/dk/dv {max(rels[1:]):.2g} | kernel 2 {k2_ms:.4f} ms "
              f"(device {fmt_ms(k2_dev)}) plain {p2_ms:.4f} sdpa {l2_ms:.4f} "
              f"bound {b2['bound_ms']:.4f} ({b2['bound_by']}) | kernel 3 "
              f"{k3_ms:.4f} ms (device 3a {fmt_ms(k3a_dev)} + 3b "
              f"{fmt_ms(k3b_dev)}) "
              f"plain {p3_ms:.4f} sdpa bwd {l3_ms:.4f} bound "
              f"{b3['bound_ms']:.4f} ({b3['bound_by']}; 3a/3b recompute "
              f"{b3_split['ops_ms']:.4f})", flush=True)
        del q, k, v, lm, do, got, want
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
    # kernels 2 and 3 are mha_fwd_kernel, mha_bwd_dq_kernel, mha_bwd_dkv_kernel
    prof, busy_share, xf_ms = profile_step(
        torch, label, lambda: trainer.train_step(batch), step_med, top=8,
        name_part="mha_")
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
              "cuda": torch.version.cuda, "peaks_of": peak_name}

    # ---- 2. build ----
    phase_build(report)

    # ---- 3. the attention-pool kernel vs its plain version ----
    print("[3] attention-pool kernel vs plain version (TF32 off)", flush=True)
    pool_rows = phase_kernels(torch, peaks, report)

    # ---- 4. the serving path ----
    print("[4] java-large serving path", flush=True)
    t0 = time.perf_counter()
    vocabs = synthetic_vocabs()
    print(f"  synthetic vocab built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    serve_launches = phase_serving(torch, np, vocabs, report)

    # ---- 5. the sparse-row training path ----
    print("[5] java-large sparse-row training path", flush=True)
    train_launches, java_u = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        data_path = os.path.join(tmp, "train.c2v")
        test_path = os.path.join(tmp, "test.c2v")
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
        row_rows = phase_row_kernels(
            torch, peaks, {"bfloat16": java_u["a"], "float32": java_u["a"],
                           "int8": java_u["b"]}, report)

        # ---- 7. the dense requantize kernel vs its plain version ----
        print("[7] dense int8 requantize kernel vs plain version", flush=True)
        requant_rows = phase_requant_kernel(torch, peaks, report)

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
        eval_launches = phase_eval(torch, np, vocabs, test_path, report)

        # ---- 10. kernels 2 and 3 vs their plain versions ----
        print("[10] fused-MHA kernels (2, 3) vs plain versions (TF32 off)",
              flush=True)
        xf_rows = phase_xf_kernels(torch, peaks, report)

        # ---- 11.-13. the transformer path-encoder ----
        print("[11] java-large transformer serving path", flush=True)
        xf_launches = {"serving": phase_xf_serving(torch, np, vocabs, report)}
        print("[12] java-large transformer dense training path (e)",
              flush=True)
        xf_launches["train_e"] = phase_xf_train(torch, np, vocabs, data_path,
                                                report)
        print("[13] java-large transformer evaluation", flush=True)
        xf_launches["eval"] = phase_xf_eval(torch, np, vocabs, test_path,
                                            report)

    # ---- 14. result ----
    # kernel 1's times at the training shape, where most of its device
    # time on the main paths goes (the serving buckets are in --out)
    main_pool = next(r for r in pool_rows
                     if r["B"] == TRAIN_B and r["ctx_dtype"] == "bfloat16")
    pool_launches = serve_launches["attention_pool"] + sum(
        v["attention_pool"] for v in train_launches.values()) \
        + eval_launches["attention_pool"]
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
        {"name": "attention_pool", "route": "cuda",
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
                  train_launches["a"]["sparse_row_adam"]),
        row_entry("sparse_requant_adam", "int8",
                  "code2vec_tpu/ops/pallas_sparse_update.py:204",
                  train_launches["b"]["sparse_requant_adam"]),
        {"name": "requantize", "route": "cuda",
         "source": "code2vec_tpu_torch/csrc/requant.cu",
         "replaces": "code2vec_tpu/ops/pallas_requant.py:85",
         "launches": train_launches["d"]["requantize"],
         "max_abs_err": max(r["max_abs_err"] for r in requant_rows),
         "ms": main_requant["ms"], "plain_ms": main_requant["plain_ms"],
         "bound_ms": main_requant["bound_ms"],
         "bound_by": main_requant["bound_by"], "library_ms": None},
    ]
    # kernels 2 and 3 at the training shape, where most of their launches'
    # work is (the other shapes are in --out)
    for name, direction, line in (("xf_attention_forward", "forward", 120),
                                  ("xf_attention_backward", "backward", 138)):
        main_row = next(r for r in xf_rows[direction]
                        if r["shape"][0] == TRAIN_B)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "code2vec_tpu_torch/csrc/xf_attention.cu",
            "replaces": f"code2vec_tpu/ops/xf_attention.py:{line}",
            "launches": sum(v[name] for v in xf_launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in xf_rows[direction]),
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
                          **{f"xf_{k}": v for k, v in xf_launches.items()}}
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

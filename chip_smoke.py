#!/usr/bin/env python3
"""Run the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py [--out FILE]

Phases (any failure raises, and the script exits non-zero):

1. the card (`nvidia-smi` name and power limit), torch and CUDA versions;
   TF32 is switched off for float32 products and convolutions;
2. build every kernel of the serving path from `code2vec_tpu_torch/csrc`
   with `nvcc`;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, with its time beside the plain
   version's, a library yardstick's and the card's bound;
4. the serving path at java-large width (vocab sizes 1,301,136 tokens,
   911,417 paths, 261,245 targets; E = 128, C = 200, bf16 tables, bf16
   compute; random weights from seed 0, a synthetic vocab): the port's
   `PredictionServer` answers 32 concurrent requests of raw extractor
   lines. Every kernel's launch counter is set to 0 just before and read
   just after; each must have launched. One batch is then held against
   the plain path on the card;
5. a `{"kernels": [...]}` line, the card line, and last
   `{"ok": true, "device": {...}}`.

Without a CUDA card it exits with code 2 and prints no result. It imports
nothing of JAX. `--out FILE` also writes every measurement as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

SEED = 0
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
    for B in BUCKET_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
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
            bound = pool_bound(B, ctx.element_size(), peaks)
            row = {"B": B, "ctx_dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err_code": err_c, "max_abs_err_attn": err_a,
                   "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, **bound}
            rows.append(row)
            print(f"  attention_pool B={B:2d} {row['ctx_dtype']:8s} "
                  f"err code {err_c:.3g} attn {err_a:.3g} | kernel {k_ms:.4f} ms"
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


def phase_serving(torch, np, report):
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.encoder import (ModelDims, gather_contexts,
                                                   init_params)
    from code2vec_tpu_torch.models.torch_model import Code2VecModel
    from code2vec_tpu_torch.ops.attention_kernel import (attention_pool_fused,
                                                         attention_pool_plain)
    from code2vec_tpu_torch.serving.server import PredictionServer
    from code2vec_tpu_torch.training.steps import predict_head, predict_step

    t0 = time.perf_counter()
    vocabs = synthetic_vocabs()
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

    from code2vec_tpu_torch.ops import _build
    from code2vec_tpu_torch.ops.attention_kernel import KERNEL as POOL

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
    t0 = time.perf_counter()
    build_s = _build.build(POOL)
    report["build_s"] = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.build_log(POOL).splitlines()
            if "registers" in ln]
    print(f"[2] built {POOL}: nvcc {build_s:.2f} s, phase "
          f"{report['build_s']:.2f} s; ptxas: "
          f"{' / '.join(regs)}", flush=True)

    # ---- 3. kernels vs plain versions ----
    print("[3] kernels vs plain versions (TF32 off)", flush=True)
    rows = phase_kernels(torch, peaks, report)

    # ---- 4. the serving path ----
    print("[4] java-large serving path", flush=True)
    launches = phase_serving(torch, np, report)

    # ---- 5. result ----
    main_row = next(r for r in rows if r["B"] == 64 and r["ctx_dtype"] == "bfloat16")
    kernels = [{
        "name": POOL, "route": "cuda",
        "source": "code2vec_tpu_torch/csrc/attention_pool.cu",
        "replaces": "code2vec_tpu/ops/pallas_attention.py:75",
        "launches": launches[POOL],
        "max_abs_err": max(max(r["max_abs_err_code"], r["max_abs_err_attn"])
                           for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]
    report["kernels"] = kernels
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

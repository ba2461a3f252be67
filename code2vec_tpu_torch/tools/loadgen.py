"""Load generator for the batched serving path: a copy of tools/loadgen.py
of the JAX package over the port.

Replays extractor-format requests against `serving/server.py` (or a
`ReplicaPool`, or the HTTP front end through
`serving_bench.HttpPredictClient`: anything with `predict_lines` and a
`telemetry` registry) and reports p50/p95/p99 latency and throughput
through the obs registry.

Modes:
  - closed  — `--concurrency` workers, each issuing its next request the
              moment the previous one returns (throughput-bound).
  - open    — requests ARRIVE at `--qps` regardless of completions
              (fixed intervals, or Poisson with `--arrivals poisson`);
              overload shows up as shed requests, not as a slowed
              generator.
  - sequential — one `model.predict` at a time on one thread (what the
              REPL alone could drive).
  - compare — sequential then closed on the same corpus; prints the
              throughput ratio.

A corpus is one request per line-group: `--corpus <file.c2v>` (raw
extractor/preprocess lines, grouped `--methods` per request) or the
built-in synthetic generator (the JAX tool's, draw for draw). `--load
<ckpt>` serves a checkpoint of the port; without it a tiny random-weight
model is built in a temp dir (latency is shape-, not value-dependent).

    python3 -m code2vec_tpu_torch.tools.loadgen --mode open --qps 200
    python3 -m code2vec_tpu_torch.tools.loadgen --backend cpu --requests 32

`--backend gpu` (the default) serves on the CUDA card and exits 2
without one; `cpu` serves on the CPU. Reports go to stdout as JSON; with
`--telemetry_dir` the run also lands as a JSONL event log (`kind:
loadgen`), and with `--trace` each request's span tree is in that log,
exported after the run as a Chrome trace (`--trace_out`, default
`<run_dir>/trace.json`; tools/trace_report.py prints its critical-path
breakdown from the same run dir).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

# the JAX tool's synthetic corpus, kept standalone (tools do not import
# the test tree)
_TOKENS = ["foo", "bar", "baz", "qux", "value", "name", "index", "count"]
_PATHS = [str(h) for h in (123456, -98765, 424242, 1337, -777, 31415)]
_TARGETS = ["get|value", "set|value", "get|name", "set|name", "add|item",
            "remove|item", "to|string", "is|empty"]


def gen_corpus(n_requests: int, methods_per_request: int = 1,
               max_ctx: int = 12, seed: int = 0,
               distinct: bool = True) -> List[List[str]]:
    """Synthetic extractor-format requests. `distinct=True` salts every
    method's token choice with its global index so an LRU cache can't
    turn a throughput run into a cache benchmark."""
    rng = random.Random(seed)
    corpus = []
    for r in range(n_requests):
        lines = []
        for m in range(methods_per_request):
            uid = r * methods_per_request + m
            t_idx = rng.randrange(len(_TARGETS))
            ctxs = []
            for c in range(rng.randint(2, max_ctx)):
                tok_a = _TOKENS[(t_idx + c) % len(_TOKENS)]
                tok_b = (f"u{uid}" if distinct and c == 0
                         else _TOKENS[(t_idx * 3 + c) % len(_TOKENS)])
                ctxs.append(f"{tok_a},{rng.choice(_PATHS)},{tok_b}")
            lines.append(_TARGETS[t_idx] + " " + " ".join(ctxs))
        corpus.append(lines)
    return corpus


def _percentiles(stat) -> Dict[str, float]:
    s = stat.summary()
    return {k: s[k] for k in ("count", "mean_ms", "p50_ms", "p95_ms",
                              "p99_ms", "max_ms")}


def run_sequential(model, corpus: List[List[str]],
                   duration: Optional[float] = None) -> Dict:
    """One request at a time through `model.predict` (extract cost
    excluded)."""
    from code2vec_tpu_torch.obs import Telemetry
    tele = Telemetry.memory("loadgen-seq")
    t_start = time.perf_counter()
    done = 0
    i = 0
    while True:
        if duration is None:
            if i >= len(corpus):
                break
        elif time.perf_counter() - t_start >= duration:
            break
        t0 = time.perf_counter()
        model.predict(corpus[i % len(corpus)])
        tele.record_ms("loadgen/request_ms",
                       (time.perf_counter() - t0) * 1e3)
        done += 1
        i += 1
    wall = time.perf_counter() - t_start
    return {"mode": "sequential", "requests": done, "ok": done,
            "shed": 0, "errors": 0, "wall_s": round(wall, 3),
            "throughput_rps": round(done / max(wall, 1e-9), 2),
            "latency": _percentiles(tele.timer("loadgen/request_ms"))}


def _modulation_fn(modulation: Optional[str], period_s: float):
    """Offered-load multiplier over elapsed time:

      - None      — flat 1.0;
      - "diurnal" — a smooth day-cycle compressed to `period_s`:
                    1 + 0.5*sin(2*pi*t/period), floored at 0.05 so the
                    trough still trickles;
      - "bursty"  — a 3x spike for the first 10% of each period, 0.8x
                    the rest: the flash-crowd shape autoscaling and
                    admission control have to absorb.
    """
    if modulation is None or modulation == "none":
        return lambda _t: 1.0
    if modulation == "diurnal":
        import math
        return lambda t: max(
            0.05, 1.0 + 0.5 * math.sin(2 * math.pi * t / period_s))
    if modulation == "bursty":
        return lambda t: 3.0 if (t % period_s) < 0.1 * period_s else 0.8
    raise ValueError(f"unknown modulation {modulation!r}")


def run_load(server, corpus: List[List[str]], mode: str = "closed",
             concurrency: int = 8, qps: float = 100.0,
             duration: Optional[float] = None,
             arrivals: str = "fixed",
             modulation: Optional[str] = None,
             modulation_period_s: float = 60.0,
             hot_key_frac: float = 0.0, hot_keys: int = 8,
             seed: int = 0) -> Dict:
    """Drive `server.predict_lines` with the chosen arrival process. The
    server must be started (buckets warmed) by the caller.

    Open-loop extras: `arrivals="poisson"` draws exponential
    inter-arrival gaps (fixed intervals can phase-lock with the batcher
    window and hide tail latency); `modulation` shapes the instantaneous
    rate (see `_modulation_fn`); `hot_key_frac` sends that fraction of
    arrivals to the first `hot_keys` corpus entries (the skew that makes
    the shared prediction cache earn its keep). All draws come from one
    seeded stream, in the JAX tool's order, so a capture is replayable
    and the schedule is the JAX tool's for the same seed."""
    from code2vec_tpu_torch.serving.batcher import ServerOverloaded

    tele = server.telemetry
    lock = threading.Lock()
    state = {"next": 0, "ok": 0, "shed": 0, "errors": 0}
    t_start = time.perf_counter()

    def _expired() -> bool:
        return (duration is not None
                and time.perf_counter() - t_start >= duration)

    def one(i: int) -> None:
        t0 = time.perf_counter()
        try:
            server.predict_lines(corpus[i % len(corpus)])
            with lock:
                state["ok"] += 1
            tele.record_ms("loadgen/request_ms",
                           (time.perf_counter() - t0) * 1e3)
        except ServerOverloaded:
            with lock:
                state["shed"] += 1
        except Exception as e:  # noqa: BLE001 — counted + sampled,
            with lock:          # reported, not fatal
                state["errors"] += 1
                state.setdefault("first_error", repr(e))

    if mode == "closed":
        def worker():
            while True:
                with lock:
                    i = state["next"]
                    if _expired() or (duration is None
                                      and i >= len(corpus)):
                        return
                    state["next"] = i + 1
                one(i)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(concurrency)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    elif mode == "open":
        import concurrent.futures
        if arrivals not in ("fixed", "poisson"):
            raise ValueError(f"unknown arrivals {arrivals!r}")
        rng = random.Random(seed)
        mod_fn = _modulation_fn(modulation, modulation_period_s)
        n_hot = max(1, min(hot_keys, len(corpus)))
        n = len(corpus) if duration is None else (1 << 30)
        next_arrival = t_start
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=concurrency) as pool:
            futures = []
            for i in range(n):
                if _expired():
                    break
                idx = i
                if hot_key_frac > 0 and rng.random() < hot_key_frac:
                    # skewed traffic: this arrival re-asks one of the
                    # hot keys instead of walking the corpus
                    idx = rng.randrange(n_hot)
                futures.append(pool.submit(one, idx))
                if len(futures) >= 4096:
                    # long-run mode: reap finished futures so the list
                    # stays bounded over hours of offered load
                    futures = [f for f in futures if not f.done()]
                # instantaneous rate at THIS arrival; the gap to the
                # next one is 1/rate (fixed) or an exponential draw
                # with that mean (poisson)
                rate = max(1e-9, qps * mod_fn(next_arrival - t_start))
                gap = (rng.expovariate(rate) if arrivals == "poisson"
                       else 1.0 / rate)
                next_arrival += gap
                sleep = next_arrival - time.perf_counter()
                if sleep > 0:
                    time.sleep(sleep)
            for f in futures:
                f.result()
    else:
        raise ValueError(f"unknown mode {mode!r}")

    wall = time.perf_counter() - t_start
    issued = state["ok"] + state["shed"] + state["errors"]
    report = {
        "mode": mode, "concurrency": concurrency,
        "requests": issued, "ok": state["ok"], "shed": state["shed"],
        "errors": state["errors"], "wall_s": round(wall, 3),
        "throughput_rps": round(state["ok"] / max(wall, 1e-9), 2),
        "latency": _percentiles(tele.timer("loadgen/request_ms")),
        "counters": dict(tele.counters),
    }
    if state["errors"]:
        report["first_error"] = state["first_error"]
    if mode == "open":
        report["offered_qps"] = qps
        report["arrivals"] = arrivals
        report["modulation"] = modulation or "none"
        if modulation:
            report["modulation_period_s"] = modulation_period_s
        if hot_key_frac > 0:
            report["hot_key_frac"] = hot_key_frac
            report["hot_keys"] = hot_keys
    return report


def tiny_config(workdir: str):
    """The JAX tools' tiny serving configuration over a synthetic dataset
    preprocessed into `workdir` (vocab caps 1000, E = 16, C = 16, float32
    compute)."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data import preprocess as preprocess_mod
    raw = os.path.join(workdir, "raw.txt")
    flat = [ln for req in gen_corpus(64, 2, seed=7) for ln in req]
    with open(raw, "w", encoding="utf-8") as f:
        f.write("\n".join(flat) + "\n")
    prefix = os.path.join(workdir, "tiny")
    preprocess_mod.main([
        "--train_data", raw, "--val_data", raw, "--test_data", raw,
        "--max_contexts", "16", "--word_vocab_size", "1000",
        "--path_vocab_size", "1000", "--target_vocab_size", "1000",
        "--output_name", prefix])
    cfg = Config(MAX_CONTEXTS=16, MAX_TOKEN_VOCAB_SIZE=1000,
                 MAX_PATH_VOCAB_SIZE=1000, MAX_TARGET_VOCAB_SIZE=1000,
                 DEFAULT_EMBEDDINGS_SIZE=16, USE_BF16=False)
    cfg.train_data_path = prefix
    return cfg


def model_factory(cfg, device=None) -> Callable[[], object]:
    """A factory of predict models for `cfg` on `device` (None: the
    card). With `cfg.load_path`: the checkpoint's vocab, dims and latest
    params, read once; else random weights from `cfg.SEED` over the
    vocab of `cfg.train_data_path`'s `.dict.c2v`. Every call builds the
    same weights (a fresh generator seeded each time), so the replicas
    of a pool, and a replica refilled after a death, all answer alike."""
    import torch

    from code2vec_tpu_torch.models.encoder import init_params
    from code2vec_tpu_torch.models.torch_model import (Code2VecModel,
                                                       dims_from_config)
    from code2vec_tpu_torch.training import checkpoint as ckpt
    from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
    if cfg.load_path:
        dims = ckpt.load_dims(cfg.load_path)
        vocabs = ckpt.load_vocabs(cfg.load_path)
        cfg.MAX_CONTEXTS = dims.max_contexts
        cfg.TABLES_DTYPE = dims.tables_dtype
        params = ckpt.load_checkpoint(cfg.load_path, log=cfg.log)["params"]
        return lambda: Code2VecModel(cfg, dims, vocabs, params,
                                     device=device)
    vocabs = Code2VecVocabs.load_from_dict_file(
        cfg.word_freq_dict_path, cfg.MAX_TOKEN_VOCAB_SIZE,
        cfg.MAX_PATH_VOCAB_SIZE, cfg.MAX_TARGET_VOCAB_SIZE)
    dims = dims_from_config(cfg, vocabs)

    def build():
        model = Code2VecModel(cfg, dims, vocabs, {}, device=device)
        gen = torch.Generator(device=model.device).manual_seed(cfg.SEED)
        model.params = init_params(gen, dims)
        return model
    return build


def gpu_missing(backend: str) -> bool:
    """True (after saying so on stderr) when `--backend gpu`, the
    default, asks for a CUDA card and there is none: the tools then exit
    2 instead of running on the CPU."""
    if backend == "cpu":
        return False
    import torch
    if torch.cuda.is_available():
        return False
    print("error: --backend gpu (the default) needs a CUDA card and none "
          "is available; pass --backend cpu to run on the CPU",
          file=sys.stderr)
    return True


def backend_device(backend: str):
    """The device of `--backend`: "cpu", or None (the card) for gpu."""
    return "cpu" if backend == "cpu" else None


def _build_model(args):
    from code2vec_tpu_torch.config import Config
    if args.load:
        cfg = Config()
        cfg.load_path = args.load
    else:  # --synthetic: tiny random-weight model in a temp workdir
        cfg = tiny_config(tempfile.mkdtemp(prefix="loadgen_"))
    for name in ("serve_batch_max", "serve_batch_timeout_ms",
                 "serve_queue_depth", "serve_deadline_ms",
                 "serve_cache_size"):
        val = getattr(args, name)
        if val is not None:
            setattr(cfg, name.upper(), val)
    return cfg, model_factory(cfg, backend_device(args.backend))()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m code2vec_tpu_torch.tools.loadgen",
        description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("gpu", "cpu"), default="gpu",
                    help="gpu (default): the CUDA card; cpu")
    ap.add_argument("--mode", default="compare",
                    choices=["closed", "open", "sequential", "compare"])
    ap.add_argument("--load", default=None,
                    help="checkpoint dir; omit for --synthetic")
    ap.add_argument("--synthetic", action="store_true",
                    help="tiny random-weight model (default when no "
                         "--load)")
    ap.add_argument("--corpus", default=None,
                    help="file of raw extractor lines; default: "
                         "synthetic corpus")
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--methods", type=int, default=1,
                    help="methods per request")
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--qps", type=float, default=100.0,
                    help="open-loop offered load")
    ap.add_argument("--arrivals", default="fixed",
                    choices=["fixed", "poisson"],
                    help="open-loop arrival process: fixed intervals "
                         "or Poisson (exponential gaps)")
    ap.add_argument("--modulation", default="none",
                    choices=["none", "diurnal", "bursty"],
                    help="open-loop rate shaping: a compressed "
                         "day-cycle sine or a 3x flash-crowd burst "
                         "per period")
    ap.add_argument("--modulation_period_s", type=float, default=60.0,
                    help="one diurnal/bursty cycle length in seconds")
    ap.add_argument("--hot_key_frac", type=float, default=0.0,
                    help="fraction of open-loop arrivals redirected "
                         "to the --hot_keys hottest corpus entries "
                         "(cache-skew traffic)")
    ap.add_argument("--hot_keys", type=int, default=8,
                    help="size of the hot-key set")
    ap.add_argument("--seed", type=int, default=0,
                    help="arrival/hot-key draw seed (replayable "
                         "captures)")
    ap.add_argument("--duration", type=float, default=None,
                    help="long-run mode: loop the corpus for S seconds")
    ap.add_argument("--serve_batch_max", type=int, default=None)
    ap.add_argument("--serve_batch_timeout_ms", type=float, default=None)
    ap.add_argument("--serve_queue_depth", type=int, default=None)
    ap.add_argument("--serve_deadline_ms", type=float, default=None)
    ap.add_argument("--serve_cache_size", type=int, default=0,
                    help="0 (default) keeps throughput numbers honest "
                         "on a repeating corpus")
    ap.add_argument("--telemetry_dir", default=None)
    ap.add_argument("--trace", action="store_true",
                    help="request-scoped tracing: queue -> batch -> "
                         "device -> decode span trees per request in "
                         "the run's event log, exported after the run as "
                         "Chrome trace JSON (defaults --telemetry_dir "
                         "to a temp dir when unset)")
    ap.add_argument("--trace_out", default=None,
                    help="Chrome trace JSON path (default: "
                         "<run_dir>/trace.json)")
    ap.add_argument("--watchdog_stall_s", type=float, default=0.0,
                    help="stall watchdog deadline for the batcher "
                         "consumer (0 = off)")
    ap.add_argument("--watchdog_mode", default="warn",
                    choices=["warn", "raise"])
    ap.add_argument("--metrics_port", type=int, default=0,
                    help="serve /metrics //healthz //vars from the "
                         "PredictionServer while the load runs "
                         "(0 = off)")
    ap.add_argument("--alerts_mode", default="off",
                    choices=["off", "warn", "raise"],
                    help="serving health monitors (cache-hit "
                         "collapse, shed burn-rate) + alert rules "
                         "(defaults --telemetry_dir to a temp dir "
                         "when unset — alert events need a run dir)")
    ap.add_argument("--alerts_rules", default=None,
                    help="JSON alert-rule file")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)
    if args.load and args.synthetic:
        ap.error("--load and --synthetic are mutually exclusive")
    if (args.trace or args.watchdog_stall_s > 0
            or args.alerts_mode != "off") and not args.telemetry_dir:
        # spans, stall dumps and alert events live in the run dir
        args.telemetry_dir = tempfile.mkdtemp(prefix="loadgen_trace_")
    if gpu_missing(args.backend):
        return 2

    cfg, model = _build_model(args)
    if args.telemetry_dir:
        cfg.TELEMETRY_DIR = args.telemetry_dir
    cfg.TRACE = bool(args.trace)
    cfg.WATCHDOG_STALL_S = args.watchdog_stall_s
    cfg.WATCHDOG_MODE = args.watchdog_mode
    cfg.METRICS_PORT = args.metrics_port
    cfg.ALERTS_MODE = args.alerts_mode
    cfg.ALERTS_RULES = args.alerts_rules

    if args.corpus:
        with open(args.corpus, encoding="utf-8") as f:
            flat = [ln for ln in f if ln.strip()]
        corpus = [flat[i:i + args.methods]
                  for i in range(0, len(flat), args.methods)]
        if args.requests and len(corpus) > args.requests:
            corpus = corpus[:args.requests]
    else:
        corpus = gen_corpus(args.requests, args.methods,
                            max_ctx=min(cfg.MAX_CONTEXTS, 12))

    from code2vec_tpu_torch.obs import Telemetry
    from code2vec_tpu_torch.serving.server import PredictionServer
    tele = Telemetry.create(cfg.TELEMETRY_DIR, config=cfg,
                            component="loadgen")
    if not tele.enabled:
        tele = Telemetry.memory("loadgen")
    tele.make_threadsafe()

    reports = []
    if args.mode in ("sequential", "compare"):
        model.warmup_predict(args.methods)  # the batch-1 bucket
        reports.append(run_sequential(model, corpus,
                                      duration=args.duration))
    if args.mode != "sequential":
        server = PredictionServer(cfg, model, telemetry=tele)
        server.start()
        compiled_after_warmup = model.predict_compile_count()
        mode = "closed" if args.mode == "compare" else args.mode
        rep = run_load(server, corpus, mode=mode,
                       concurrency=args.concurrency, qps=args.qps,
                       duration=args.duration,
                       arrivals=args.arrivals,
                       modulation=(None if args.modulation == "none"
                                   else args.modulation),
                       modulation_period_s=args.modulation_period_s,
                       hot_key_frac=args.hot_key_frac,
                       hot_keys=args.hot_keys, seed=args.seed)
        rep["compiled_variants_after_warmup"] = compiled_after_warmup
        rep["new_compilations_under_load"] = (
            model.predict_compile_count() - compiled_after_warmup)
        server.close()
        reports.append(rep)

    out = {"backend": args.backend, "reports": reports}
    if args.mode == "compare" and len(reports) == 2:
        seq, bat = reports
        out["speedup"] = round(
            bat["throughput_rps"] / max(seq["throughput_rps"], 1e-9), 2)
    for rep in reports:
        tele.event("loadgen", **rep)
    tele.close()
    if args.trace and tele.run_dir:
        # the run's spans as Chrome trace-event JSON (Perfetto /
        # chrome://tracing)
        from code2vec_tpu_torch.tools.trace_report import write_chrome_trace
        trace_out = args.trace_out or os.path.join(tele.run_dir,
                                                   "trace.json")
        out["trace_json"] = trace_out
        out["trace_events"] = write_chrome_trace([tele.run_dir], trace_out)
        out["trace_run_dir"] = tele.run_dir
    text = json.dumps(out, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving-fleet round capture: a copy of tools/serving_bench.py of the
JAX package over the port. It drives the HTTP front end and the replica
pool with the open-loop traffic model and prints a capture of the round
(`serving_p99_ms`, `serving_req_per_sec`, the pool and the
zero-new-signature check).

The measured path is the WHOLE external plane: urllib POST /predict ->
front-end JSON translation -> least-outstanding dispatch -> micro-batch
-> device -> decode -> serialize, with client-side latency timing (the
number a real caller sees, not the in-process request_ms). The bench
reuses `loadgen.run_load` by presenting the HTTP endpoint as a
`predict_lines` surface that raises `ServerOverloaded` on 429, so sheds
stay explicitly counted, exactly like the in-process runs.

    python3 -m code2vec_tpu_torch.tools.serving_bench --out round.json

builds the loadgen's tiny synthetic model (random weights from the
config's seed), serves it from `--replicas` replicas on an ephemeral
port, offers `--qps` Poisson arrivals with hot-key skew for
`--requests` requests, and prints the round (and writes it to `--out`
when given). `--backend gpu` (the default) serves on the CUDA card and
exits 2 without one; `cpu` serves on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import urllib.error
import urllib.request

from code2vec_tpu_torch.tools import loadgen


class HttpPredictClient:
    """`run_load`'s server surface over the wire: predict_lines posts to
    the front end, 429 re-raises as ServerOverloaded so the load report's
    ok/shed/errors split matches the in-process runs. Returns the
    response's `predictions` (the JSON of `serialize_prediction`).

    The URL opener is built once, here: `urllib.request.urlopen` builds
    its shared one at first use, and client threads starting together
    each build one (an SSL context apiece, ~45 ms of the interpreter
    lock each), which put half a second into the first requests' latency
    of a 16-worker load."""

    def __init__(self, base_url: str, telemetry,
                 timeout_s: float = 30.0):
        from code2vec_tpu_torch.serving.batcher import ServerOverloaded
        self._overloaded = ServerOverloaded
        self._opener = urllib.request.build_opener()
        self.base_url = base_url
        self.telemetry = telemetry
        self.timeout_s = timeout_s

    def predict_lines(self, lines, deadline_ms: float = None):
        body = {"lines": list(lines)}
        if deadline_ms is not None:
            body["deadline_ms"] = deadline_ms
        req = urllib.request.Request(
            self.base_url + "/predict",
            data=json.dumps(body).encode("utf-8"), method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with self._opener.open(req, timeout=self.timeout_s) as r:
                return json.loads(r.read().decode("utf-8"))[
                    "predictions"]
        except urllib.error.HTTPError as e:
            detail = e.read().decode("utf-8", "replace")[:200]
            if e.code == 429:
                raise self._overloaded(f"shed by front-end: {detail}")
            raise RuntimeError(f"HTTP {e.code}: {detail}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m code2vec_tpu_torch.tools.serving_bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("gpu", "cpu"), default="gpu",
                    help="gpu (default): the CUDA card; cpu")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--methods", type=int, default=1)
    ap.add_argument("--qps", type=float, default=100.0)
    ap.add_argument("--concurrency", type=int, default=16,
                    help="client-side HTTP worker cap")
    ap.add_argument("--arrivals", default="poisson",
                    choices=["fixed", "poisson"])
    ap.add_argument("--modulation", default="none",
                    choices=["none", "diurnal", "bursty"])
    ap.add_argument("--modulation_period_s", type=float, default=30.0)
    ap.add_argument("--hot_key_frac", type=float, default=0.25)
    ap.add_argument("--hot_keys", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serve_batch_max", type=int, default=16)
    ap.add_argument("--serve_batch_timeout_ms", type=float,
                    default=2.0)
    ap.add_argument("--serve_queue_depth", type=int, default=128)
    ap.add_argument("--serve_deadline_ms", type=float, default=2000.0)
    ap.add_argument("--serve_cache_size", type=int, default=512)
    ap.add_argument("--round", type=int, default=None,
                    help="round number recorded in the capture "
                         "(default: parsed from --out, else 1)")
    ap.add_argument("--out", default=None,
                    help="also write the capture to this JSON file")
    args = ap.parse_args(argv)
    if loadgen.gpu_missing(args.backend):
        return 2
    device = loadgen.backend_device(args.backend)

    from code2vec_tpu_torch.obs import Telemetry
    from code2vec_tpu_torch.serving import ReplicaPool, ServingFrontend

    # the loadgen synthetic-model recipe: tiny vocabs, random weights
    # (latency is shape-dependent, not value-dependent)
    cfg = loadgen.tiny_config(tempfile.mkdtemp(prefix="serving_bench_"))
    cfg.SERVE_BATCH_MAX = args.serve_batch_max
    cfg.SERVE_BATCH_TIMEOUT_MS = args.serve_batch_timeout_ms
    cfg.SERVE_QUEUE_DEPTH = args.serve_queue_depth
    cfg.SERVE_DEADLINE_MS = args.serve_deadline_ms
    cfg.SERVE_CACHE_SIZE = args.serve_cache_size
    cfg.SERVE_REPLICAS = args.replicas
    cfg.SERVE_MAX_REPLICAS = max(args.replicas, cfg.SERVE_MAX_REPLICAS)

    tele = Telemetry.memory("serving-bench").make_threadsafe()
    pool = ReplicaPool(cfg, loadgen.model_factory(cfg, device),
                       replicas=args.replicas, telemetry=tele).start()
    frontend = ServingFrontend(pool, port=0, telemetry=tele).start()
    base = f"http://127.0.0.1:{frontend.bound_port}"

    corpus = loadgen.gen_corpus(args.requests, args.methods,
                                max_ctx=min(cfg.MAX_CONTEXTS, 12))
    client = HttpPredictClient(base, tele)
    try:
        report = loadgen.run_load(
            client, corpus, mode="open",
            concurrency=args.concurrency, qps=args.qps,
            arrivals=args.arrivals,
            modulation=(None if args.modulation == "none"
                        else args.modulation),
            modulation_period_s=args.modulation_period_s,
            hot_key_frac=args.hot_key_frac, hot_keys=args.hot_keys,
            seed=args.seed)
        compile_delta = pool.compile_delta()
        pool_table = pool.pool_table()
    finally:
        frontend.stop()
        pool.close()

    rnd = args.round
    if rnd is None:
        m = re.search(r"r(\d+)", os.path.basename(args.out or ""))
        rnd = int(m.group(1)) if m else 1
    capture = {
        "schema": "serving",
        "round": rnd,
        "backend": args.backend,
        "serving_p99_ms": report["latency"]["p99_ms"],
        "serving_req_per_sec": report["throughput_rps"],
        "serving_p50_ms": report["latency"]["p50_ms"],
        "replicas": args.replicas,
        "offered_qps": args.qps,
        "arrivals": report["arrivals"],
        "modulation": report["modulation"],
        "hot_key_frac": args.hot_key_frac,
        "requests": report["requests"],
        "ok": report["ok"],
        "shed": report["shed"],
        "errors": report["errors"],
        "cache_hits": report["counters"].get("serve/cache_hit", 0),
        "new_compilations_under_load": compile_delta,
        "pool": {"size": pool_table["size"],
                 "ready": pool_table["ready"],
                 "generation": pool_table["generation"]},
    }
    if report["errors"]:
        capture["first_error"] = report.get("first_error")
    text = json.dumps(capture, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

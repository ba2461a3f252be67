"""Batched prediction server over the PyTorch model.

A copy of `serving/server.py` of the JAX package:

  - client threads call `predict_lines()` / `predict_file()`; parsing
    (`model.prepare_predict_rows`) runs on the caller's thread, so host
    work scales with clients while the device stays single-owner;
  - a `MicroBatcher` (serving/batcher.py) coalesces concurrent requests
    into one padded device batch at the model's power-of-two buckets,
    all run once by `start()`;
  - an LRU prediction cache keyed by the normalized path-context bag:
    hits skip parse and device;
  - admission control: a bounded queue plus a per-request deadline shed
    load with `ServerOverloaded`;
  - extraction goes through a persistent `ExtractorPool`
    (serving/extractor.py): no subprocess or pool spawn per request.

Telemetry (obs/): `serve/request_ms` / `serve/extract_ms` histograms on
the request path, `serve/parse_ms` / `serve/encode_ms` /
`serve/predict_ms` from the model, the batcher's queue and batch
gauges, and `serve/requests`, `serve/cache_hit`, `serve/cache_miss`,
`serve/shed` counters, in a thread-safe registry (client threads, the
extractor pool and the batcher all record into it). With `--trace`, one
trace per request (request, extract, parse, queue wait, batch flush,
encode, device, decode); with `--watchdog_stall_s`, the batcher
consumer's heartbeat. The `serve/kill` failpoint fires before any span
opens. The live metrics plane (obs/exposition.build_live_plane):
`--metrics_port` serves `/metrics`, `/healthz` (readiness: the
batcher's heartbeat and the page alerts), `/vars` and `/clock` over the
serving registry, and `--alerts_mode` runs the serving health monitors
(cache-hit rate, shed rate) and alert rules.

Not here yet (a later slice): the replica fleet with hot reload.

Cache semantics: a method whose contexts exceed MAX_CONTEXTS is
downsampled at parse time by a draw seeded from the same normalized bag
the cache key uses (data/reader.parse_c2v_rows), so a cached prediction
equals what a fresh parse of that bag would produce.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from code2vec_tpu_torch.common import MethodPredictionResults
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.obs import (Telemetry, Tracer, Watchdog,
                                    build_live_plane)
from code2vec_tpu_torch.obs.alerts import default_serving_rules
from code2vec_tpu_torch.obs.health import default_serving_monitors
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.serving.batcher import (MicroBatcher, PredictRequest,
                                                ServerOverloaded)
from code2vec_tpu_torch.serving.extractor import ExtractorPool

__all__ = ["PredictionServer", "PredictionCache", "ServerOverloaded",
           "normalize_bag"]


def normalize_bag(line: str) -> Tuple[str, Tuple[str, ...]]:
    """Cache key for one extractor line: (method name, sorted bag of
    non-empty context fields). Context order is irrelevant to the bag
    encoder, so reordered extractions of one method hit one entry;
    padding fields ('' / ',,') are dropped as the parser drops them."""
    parts = line.rstrip("\n").split(" ")
    ctxs = sorted(p for p in parts[1:] if p and p != ",,")
    return parts[0], tuple(ctxs)


class PredictionCache:
    """Thread-safe LRU over normalized path-context bags; values are the
    finished `MethodPredictionResults`."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._d: "collections.OrderedDict" = collections.OrderedDict()

    def get(self, key) -> Optional[MethodPredictionResults]:
        if self.capacity <= 0:
            return None
        with self._lock:
            val = self._d.get(key)
            if val is not None:
                self._d.move_to_end(key)
            return val

    def put(self, key, value: MethodPredictionResults) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


class PredictionServer:
    """Request queue + micro-batcher + cache + extractor pool around one
    model. `InteractivePredictor` is a thin client of it.

    Counters (plain integers, read after the fact): `requests`,
    `batches` (device calls), `cache_hits`, `cache_misses`, `shed`; the
    same events go to `telemetry` (default: an in-memory registry).
    `tracer` (default: on with config.TRACE) and `watchdog` (default:
    config.WATCHDOG_STALL_S) need a file-backed registry to record.
    `health`, `alerts` and `metrics_server` are the live plane's engines
    (config.METRICS_PORT, ALERTS_MODE), started by `start()` and
    stopped by `close()`."""

    def __init__(self, config: Config, model, telemetry: Telemetry = None,
                 tracer: Tracer = None, watchdog: Watchdog = None,
                 cache=None):
        self.config = config
        self.model = model
        tele = telemetry if telemetry is not None \
            else Telemetry.memory("serve")
        tele.make_threadsafe()
        self.telemetry = tele
        # the model's serve/parse_ms, encode_ms and predict_ms spans land
        # in the same registry
        model.telemetry = tele
        # request-scoped tracing: the client threads open request /
        # extract / parse / decode spans, the batcher flush continues
        # them (serve/batch_flush + serve/encode + serve/device) through
        # the SpanContext riding each PredictRequest
        if tracer is None:
            tracer = Tracer.create(tele) if config.TRACE \
                else Tracer.disabled()
        self.tracer = tracer
        model.tracer = tracer
        # stall watchdog: the batcher consumer heartbeats per flush, so
        # a hung device call surfaces as a `stall` event and a dump
        if watchdog is None:
            watchdog = Watchdog.create(
                tele, stall_s=config.WATCHDOG_STALL_S,
                mode=config.WATCHDOG_MODE, tracer=tracer, log=config.log)
        self.watchdog = watchdog
        self._batcher_hb = watchdog.register("batcher_consumer")
        # the live metrics plane over the serving registry (readiness
        # gates on the batcher's heartbeat), with the serving health
        # monitors and alert rules on a cadence thread; shared no-op
        # singletons with the flags off
        self._live_plane = build_live_plane(
            tele, metrics_port=config.METRICS_PORT,
            alerts_mode=config.ALERTS_MODE,
            alerts_rules=config.ALERTS_RULES,
            health_every_s=config.HEALTH_EVERY_S, watchdog=watchdog,
            monitors=default_serving_monitors(),
            default_rules=default_serving_rules, log=config.log)
        self.health = self._live_plane.health
        self.alerts = self._live_plane.alerts
        self.metrics_server = self._live_plane.metrics
        self.cache = cache if cache is not None \
            else PredictionCache(config.SERVE_CACHE_SIZE)
        self.batcher = MicroBatcher(
            self._run_batch, max_batch=config.SERVE_BATCH_MAX,
            timeout_ms=config.SERVE_BATCH_TIMEOUT_MS,
            queue_depth=config.SERVE_QUEUE_DEPTH, telemetry=tele)
        self._extractors: Optional[ExtractorPool] = None
        self._extractor_kwargs: Optional[Dict] = None
        self.warmup_buckets: List[int] = []
        self.warmup_ms = 0.0
        self._started = False
        self._lifecycle_lock = threading.Lock()
        self._count_lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.shed = 0

    def _count(self, name: str, n: int = 1) -> None:
        with self._count_lock:
            setattr(self, name, getattr(self, name) + n)

    # ---- lifecycle ----
    def start(self, warmup: bool = True) -> "PredictionServer":
        """Run every shape bucket once and start the batcher thread (and
        the watchdog). Idempotent, and safe under concurrent first
        requests."""
        with self._lifecycle_lock:
            if self._started:
                return self
            if warmup:
                t0 = time.perf_counter()
                self.warmup_buckets = self.model.warmup_predict(
                    self.config.SERVE_BATCH_MAX)
                self.warmup_ms = (time.perf_counter() - t0) * 1e3
                self.telemetry.event("serve_warmup",
                                     buckets=self.warmup_buckets,
                                     warmup_ms=round(self.warmup_ms, 1))
            self.batcher.start()
            self.watchdog.start()
            self._live_plane.start()
            self._started = True
        return self

    def close(self) -> None:
        with self._lifecycle_lock:
            self.batcher.stop()
            if self._extractors is not None:
                self._extractors.close()
                self._extractors = None
                self._extractor_kwargs = None
            self._started = False
        self.watchdog.stop()
        self._live_plane.stop()
        # after teardown, so a raise-mode sticky stall or alert cannot
        # leak the batcher / extractor threads by raising mid-close
        self.watchdog.poll()
        self.alerts.poll()

    def __enter__(self) -> "PredictionServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def extractor_pool(self, **extractor_kwargs) -> ExtractorPool:
        """The persistent extraction pool, built (and preflighted, which
        builds the native extractor) once on first use, so line-only
        serving never needs it. The first call fixes the extractor
        configuration; a later call with other kwargs is an error."""
        with self._lifecycle_lock:
            if self._extractors is None:
                self._extractors = ExtractorPool(self.config,
                                                 telemetry=self.telemetry,
                                                 **extractor_kwargs)
                self._extractor_kwargs = dict(extractor_kwargs)
            elif extractor_kwargs != self._extractor_kwargs:
                raise ValueError(
                    f"extractor pool already built with "
                    f"{self._extractor_kwargs}; restart the server to "
                    f"change extractor settings (got {extractor_kwargs})")
            return self._extractors

    # ---- request path (client threads) ----
    def predict_file(self, path: str, deadline_ms: Optional[float] = None,
                     **extractor_kwargs) -> List[MethodPredictionResults]:
        """Extract one source file through the worker pool, then predict
        its methods through the batcher. `serve/request_ms` covers
        extract + predict end to end."""
        request_span = self.telemetry.span("serve/request_ms")
        root = self.tracer.start_trace("serve/request", file=path) \
            if self.tracer.enabled else None
        span = self.telemetry.span("serve/extract_ms")
        ex_span = self.tracer.start_span("serve/extract", parent=root) \
            if root is not None else None
        try:
            _, lines = self.extractor_pool(**extractor_kwargs) \
                .extract_paths(path)
        except BaseException:
            # a dead extract's partial ms would pollute the histograms,
            # so the spans cancel; request_span closes here, its
            # ownership passes to predict_lines only on success
            span.cancel()
            request_span.cancel()
            if root is not None:
                ex_span.end()
                root.end(outcome="error")
            raise
        if ex_span is not None:
            ex_span.end()
        extract_ms = span.stop()
        return self.predict_lines(lines, deadline_ms=deadline_ms,
                                  extract_ms=extract_ms,
                                  _request_span=request_span,
                                  _trace_root=root)

    def predict_lines(self, lines: Sequence[str],
                      deadline_ms: Optional[float] = None,
                      extract_ms: Optional[float] = None,
                      _request_span=None, _trace_root=None
                      ) -> List[MethodPredictionResults]:
        """Predict a bag of extractor lines (one result per non-empty
        line, input order). Raises `ServerOverloaded` when shed by
        admission control or past its deadline. `deadline_ms=0` disables
        the deadline (a single-user client waiting out a cold first
        call); None takes `config.SERVE_DEADLINE_MS`."""
        if not self._started:
            self.start()
        # chaos failpoint (--faults): process death on the request
        # path, before any span opens so nothing leaks when it fires;
        # disarmed it is one None check
        faults.fire("serve/kill")
        lines = [ln for ln in lines if ln.strip()]
        request_span = (_request_span if _request_span is not None
                        else self.telemetry.span("serve/request_ms"))
        root = _trace_root
        if root is None and self.tracer.enabled:
            root = self.tracer.start_trace("serve/request",
                                           n_methods=len(lines))
        if not lines:
            # all-blank input never reaches the queue: cancel (not stop)
            # so request_ms and serve/requests agree on what a request is
            request_span.cancel()
            if root is not None:
                root.end(n_results=0)
            return []
        if deadline_ms is None:
            deadline_ms = self.config.SERVE_DEADLINE_MS
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms and deadline_ms > 0 else None)
        try:
            out: List[Optional[MethodPredictionResults]] = [None] * len(lines)
            use_cache = self.cache.capacity > 0
            keys: List = [None] * len(lines)
            miss_idx: List[int] = []
            if use_cache:
                for i, ln in enumerate(lines):
                    keys[i] = key = normalize_bag(ln)
                    hit = self.cache.get(key)
                    if hit is not None:
                        out[i] = hit
                        self._count("cache_hits")
                        self.telemetry.count("serve/cache_hit")
                    else:
                        miss_idx.append(i)
                        self._count("cache_misses")
                        self.telemetry.count("serve/cache_miss")
            else:
                miss_idx = list(range(len(lines)))

            if miss_idx:
                # parse on the caller's thread; oversized requests chunk
                # to max_batch so every flush stays inside the warmed
                # buckets
                parse_span = self.tracer.start_span(
                    "serve/parse", parent=root, n=len(miss_idx)) \
                    if root is not None else None
                try:
                    prepared = self.model.prepare_predict_rows(
                        [lines[i] for i in miss_idx])
                finally:
                    if parse_span is not None:
                        parse_span.end()
                root_ctx = root.context() if root is not None else None
                cap = self.batcher.max_batch
                chunks = [prepared.slice(at, min(at + cap, prepared.n))
                          for at in range(0, prepared.n, cap)]
                reqs: List[PredictRequest] = []
                for chunk in chunks:
                    req = PredictRequest(chunk, chunk.n, deadline=deadline,
                                         trace_ctx=root_ctx)
                    if not self.batcher.submit(req):
                        # shed the whole request: resolve the sibling
                        # chunks already queued so the batcher skips them
                        overload = ServerOverloaded(
                            "server shutting down"
                            if not self.batcher.running else
                            f"request queue full "
                            f"(depth {self.batcher.queue_depth})")
                        n_shed = 1  # the refused chunk
                        for prev in reqs:
                            if prev.fail(overload):
                                n_shed += 1
                        self._count("shed")
                        self.telemetry.count("serve/shed", n_shed)
                        if root is not None:
                            root.end(outcome="shed")
                        raise overload
                    reqs.append(req)
                miss_results: List[MethodPredictionResults] = []
                decode_span = None
                try:
                    for chunk, req in zip(chunks, reqs):
                        # wait past the deadline by one batch window so
                        # an in-flight batch holding this request can
                        # still land
                        wait_s = None
                        if deadline is not None:
                            wait_s = max(0.0, deadline - time.monotonic()) \
                                + self.batcher.timeout_s + 5.0
                        if not req.wait(wait_s) and req.fail(
                                ServerOverloaded("request timed out")):
                            self._count("shed")
                            self.telemetry.count("serve/shed")
                        if req.error is not None:
                            raise req.error
                        # decode on the caller's thread: the batcher's
                        # critical path stays device-only
                        decode_span = self.tracer.start_span(
                            "serve/decode", parent=root, n=chunk.n) \
                            if root is not None else None
                        miss_results.extend(self.model.decode_predictions(
                            chunk, req.result))
                        if decode_span is not None:
                            decode_span.end()
                except BaseException:
                    # no device work for a dead waiter's remaining chunks
                    dead = ServerOverloaded("sibling chunk failed")
                    for r in reqs:
                        r.fail(dead)
                    if decode_span is not None:
                        decode_span.end()  # idempotent
                    raise
                for i, res in zip(miss_idx, miss_results):
                    out[i] = res
                    if use_cache:
                        self.cache.put(keys[i], res)

            self._count("requests")
            self.telemetry.count("serve/requests")
            request_ms = request_span.stop()
            if root is not None:
                root.end(n_results=len(lines),
                         n_cached=len(lines) - len(miss_idx))
            fields = {"request_ms": round(request_ms, 3),
                      "n_methods": len(lines),
                      "n_cached": len(lines) - len(miss_idx)}
            if extract_ms is not None:
                fields["extract_ms"] = round(extract_ms, 3)
            self.telemetry.event("request", **fields)
            return out
        except BaseException:
            # one outer fence for every error path: a failed request
            # must not leak its span (cancel: its partial ms would
            # pollute serve/request_ms) or leave its trace root open;
            # end() is idempotent, so inner closes are safe
            request_span.cancel()
            if root is not None:
                root.end(outcome="error")
            raise

    # ---- batch execution (batcher thread) ----
    def _run_batch(self, requests: Sequence[PredictRequest]) -> List:
        """One coalesced device call; each request gets back the row
        slice of the device output matching its own rows. Decode happens
        on the waiting client's thread.

        Tracing: the flush continues the first request's trace and links
        every other coalesced request; each request also gets a
        retroactive `serve/queue_wait` span from its `enqueued_at`. This
        thread only starts spans of its own, never ends the clients'."""
        self._batcher_hb.busy()
        try:
            # duck-typed through the rows' own class (PreparedRows.concat)
            prepared = type(requests[0].rows).concat(
                [r.rows for r in requests])
            if self.tracer.enabled:
                now = self.tracer.clock()
                ctxs = [r.trace_ctx for r in requests
                        if r.trace_ctx is not None]
                for r in requests:
                    if r.trace_ctx is not None:
                        self.tracer.record_span(
                            "serve/queue_wait", r.enqueued_at, now,
                            parent=r.trace_ctx, track="serve-queue")
                # context manager: serve/encode + serve/device inside
                # predict_device parent to the flush span
                with self.tracer.start_span(
                        "serve/batch_flush",
                        parent=ctxs[0] if ctxs else None,
                        links=ctxs[1:], n_requests=len(requests),
                        n_methods=prepared.n):
                    out = self.model.predict_device(prepared)
            else:
                out = self.model.predict_device(prepared)
        finally:
            self._batcher_hb.idle()
        self._count("batches")
        split = []
        at = 0
        for r in requests:
            split.append(tuple(a[at:at + r.n] for a in out))
            at += r.n
        return split

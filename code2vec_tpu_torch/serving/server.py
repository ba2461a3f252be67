"""Batched prediction server over the PyTorch model.

A trimmed copy of `serving/server.py` of the JAX package:

  - client threads call `predict_lines()`; parsing
    (`model.prepare_predict_rows`) runs on the caller's thread, so host
    work scales with clients while the device stays single-owner;
  - a `MicroBatcher` (serving/batcher.py) coalesces concurrent requests
    into one padded device batch at the model's power-of-two buckets,
    all run once by `start()`;
  - an LRU prediction cache keyed by the normalized path-context bag:
    hits skip parse and device;
  - admission control: a bounded queue plus a per-request deadline shed
    load with `ServerOverloaded`.

Not here yet (a later slice): the live metrics plane, the stall
watchdog, request tracing, fault points and the extractor pool.

Cache semantics: a method whose contexts exceed MAX_CONTEXTS is
downsampled at parse time by a draw seeded from the same normalized bag
the cache key uses (data/reader.parse_c2v_rows), so a cached prediction
equals what a fresh parse of that bag would produce.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, Optional, Sequence, Tuple

from code2vec_tpu_torch.common import MethodPredictionResults
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.serving.batcher import (MicroBatcher, PredictRequest,
                                                ServerOverloaded)

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
    """Request queue + micro-batcher + cache around one model.

    Counters (plain integers, read after the fact): `requests`,
    `batches` (device calls), `cache_hits`, `cache_misses`, `shed`."""

    def __init__(self, config: Config, model, cache=None):
        self.config = config
        self.model = model
        self.cache = cache if cache is not None \
            else PredictionCache(config.SERVE_CACHE_SIZE)
        self.batcher = MicroBatcher(
            self._run_batch, max_batch=config.SERVE_BATCH_MAX,
            timeout_ms=config.SERVE_BATCH_TIMEOUT_MS,
            queue_depth=config.SERVE_QUEUE_DEPTH)
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
        """Run every shape bucket once and start the batcher thread.
        Idempotent, and safe under concurrent first requests."""
        with self._lifecycle_lock:
            if self._started:
                return self
            if warmup:
                t0 = time.perf_counter()
                self.warmup_buckets = self.model.warmup_predict(
                    self.config.SERVE_BATCH_MAX)
                self.warmup_ms = (time.perf_counter() - t0) * 1e3
            self.batcher.start()
            self._started = True
        return self

    def close(self) -> None:
        with self._lifecycle_lock:
            self.batcher.stop()
            self._started = False

    def __enter__(self) -> "PredictionServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- request path (client threads) ----
    def predict_lines(self, lines: Sequence[str],
                      deadline_ms: Optional[float] = None
                      ) -> List[MethodPredictionResults]:
        """Predict a bag of extractor lines (one result per non-empty
        line, input order). Raises `ServerOverloaded` when shed by
        admission control or past its deadline. `deadline_ms=0` disables
        the deadline; None takes `config.SERVE_DEADLINE_MS`."""
        if not self._started:
            self.start()
        lines = [ln for ln in lines if ln.strip()]
        if not lines:
            return []
        if deadline_ms is None:
            deadline_ms = self.config.SERVE_DEADLINE_MS
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms and deadline_ms > 0 else None)
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
                else:
                    miss_idx.append(i)
                    self._count("cache_misses")
        else:
            miss_idx = list(range(len(lines)))

        if miss_idx:
            # parse on the caller's thread; oversized requests chunk to
            # max_batch so every flush stays inside the warmed buckets
            prepared = self.model.prepare_predict_rows(
                [lines[i] for i in miss_idx])
            cap = self.batcher.max_batch
            chunks = [prepared.slice(at, min(at + cap, prepared.n))
                      for at in range(0, prepared.n, cap)]
            reqs: List[PredictRequest] = []
            for chunk in chunks:
                req = PredictRequest(chunk, chunk.n, deadline=deadline)
                if not self.batcher.submit(req):
                    # shed the whole request: resolve the sibling chunks
                    # already queued so the batcher skips them
                    overload = ServerOverloaded(
                        "server shutting down"
                        if not self.batcher.running else
                        f"request queue full "
                        f"(depth {self.batcher.queue_depth})")
                    for prev in reqs:
                        prev.fail(overload)
                    self._count("shed")
                    raise overload
                reqs.append(req)
            miss_results: List[MethodPredictionResults] = []
            try:
                for chunk, req in zip(chunks, reqs):
                    # wait past the deadline by one batch window so an
                    # in-flight batch holding this request can still land
                    wait_s = None
                    if deadline is not None:
                        wait_s = max(0.0, deadline - time.monotonic()) \
                            + self.batcher.timeout_s + 5.0
                    if not req.wait(wait_s) and req.fail(
                            ServerOverloaded("request timed out")):
                        self._count("shed")
                    if req.error is not None:
                        raise req.error
                    # decode on the caller's thread: the batcher's
                    # critical path stays device-only
                    miss_results.extend(self.model.decode_predictions(
                        chunk, req.result))
            except BaseException:
                # no device work for a dead waiter's remaining chunks
                dead = ServerOverloaded("sibling chunk failed")
                for r in reqs:
                    r.fail(dead)
                raise
            for i, res in zip(miss_idx, miss_results):
                out[i] = res
                if use_cache:
                    self.cache.put(keys[i], res)
        self._count("requests")
        return out

    # ---- batch execution (batcher thread) ----
    def _run_batch(self, requests: Sequence[PredictRequest]) -> List:
        """One coalesced device call; each request gets back the row
        slice of the device output matching its own rows. Decode happens
        on the waiting client's thread."""
        # duck-typed through the rows' own class (PreparedRows.concat)
        prepared = type(requests[0].rows).concat(
            [r.rows for r in requests])
        out = self.model.predict_device(prepared)
        self._count("batches")
        split = []
        at = 0
        for r in requests:
            split.append(tuple(a[at:at + r.n] for a in out))
            at += r.n
        return split

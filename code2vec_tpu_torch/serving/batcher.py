"""Dynamic micro-batching for the prediction server.

A copy of `serving/batcher.py` of the JAX package. Concurrent predict requests land in a bounded queue; a single
batcher thread coalesces them into one device batch, flushing on
`max_batch` total methods or a `timeout_ms` deadline, whichever comes
first. `submit()` on a full queue returns False (the caller sheds with
`ServerOverloaded`), and requests whose deadline expired while queued
are shed at dequeue time.

Model-agnostic and stdlib-only: requests carry an opaque `rows` payload
plus its leading-dim size `n`; the server supplies
`batch_fn(requests) -> per-request results`. With a `telemetry`
registry it records the queue depth, shed requests and each batch's
size and occupancy (`serve/queue_depth`, `serve/shed`, `serve/batches`,
`serve/batch_methods`, `serve/batch_occupancy`).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

__all__ = ["ServerOverloaded", "PredictRequest", "MicroBatcher"]


class ServerOverloaded(RuntimeError):
    """Explicit load-shedding result: the request was refused (queue
    full) or dropped (deadline expired before it reached the device)."""


class PredictRequest:
    """One in-flight predict request: an opaque `rows` payload, its
    leading-dim size `n`, and an absolute monotonic `deadline` (None = no
    deadline). The submitting thread blocks on `wait()`; the batcher
    thread resolves it via `finish()` / `fail()`.

    `trace_ctx` is the request-scoped tracing handoff: an opaque
    `obs.trace.SpanContext` the client thread attaches and the
    batcher-thread flush reads to parent / link its spans (`enqueued_at`
    doubles as the queue-wait span's start: both use `time.monotonic`,
    the tracer's clock)."""

    __slots__ = ("rows", "n", "deadline", "enqueued_at", "result",
                 "error", "trace_ctx", "_done", "_lock")

    def __init__(self, rows: Any, n: int,
                 deadline: Optional[float] = None,
                 trace_ctx: Any = None):
        if n < 1:
            raise ValueError("empty requests never reach the batcher")
        self.rows = rows
        self.n = n
        self.deadline = deadline
        self.trace_ctx = trace_ctx
        self.enqueued_at = time.monotonic()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()
        self._lock = threading.Lock()

    def finish(self, result: Any) -> bool:
        # first resolution wins: a late batch result must not clobber a
        # timeout the waiter already acted on (and vice versa)
        with self._lock:
            if self._done.is_set():
                return False
            self.result = result
            self._done.set()
            return True

    def fail(self, error: BaseException) -> bool:
        with self._lock:
            if self._done.is_set():
                return False
            self.error = error
            self._done.set()
            return True

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """True when resolved; False on timeout."""
        return self._done.wait(timeout)


class MicroBatcher:
    """Single consumer thread over a bounded request queue.

    Flush policy (`_collect`): block for the first request, open a
    `timeout_ms` coalescing window, and keep admitting queued requests
    until the batch holds `max_batch` methods or the window closes. A
    request whose methods would overflow `max_batch` stays queued for the
    next batch: request payloads are never split.
    """

    def __init__(self, batch_fn: Callable[[Sequence[PredictRequest]],
                                          Sequence[Any]],
                 *, max_batch: int = 64, timeout_ms: float = 2.0,
                 queue_depth: int = 128, telemetry=None):
        if max_batch < 1 or queue_depth < 1 or timeout_ms < 0:
            raise ValueError("max_batch and queue_depth must be >= 1 and "
                             "timeout_ms >= 0")
        self._batch_fn = batch_fn
        self.max_batch = max_batch
        self.timeout_s = timeout_ms / 1e3
        self.queue_depth = queue_depth
        from code2vec_tpu_torch.obs import Telemetry
        self._tele = telemetry if telemetry is not None \
            else Telemetry.disabled()
        self._q: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle ----
    def start(self) -> None:
        with self._cond:  # atomic check-then-act: one consumer thread
            if self._running:
                return
            self._running = True
            self._thread = threading.Thread(
                target=self._run, name="micro-batcher", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        """Stop the consumer; queued-but-unserved requests are failed
        with `ServerOverloaded` so no submitter blocks forever."""
        with self._cond:
            if not self._running:
                return
            self._running = False
            pending = list(self._q)
            self._q.clear()
            # detach the handle under the lock, join after release:
            # joining under it would deadlock against a consumer blocked
            # in _cond.wait()
            thread, self._thread = self._thread, None
            self._cond.notify_all()
        for req in pending:
            req.fail(ServerOverloaded("server shutting down"))
        if thread is not None:
            thread.join(timeout=5)

    # ---- producer side ----
    def submit(self, req: PredictRequest) -> bool:
        """Enqueue; False when the bounded queue is full or the batcher
        is stopped."""
        if req.n > self.max_batch:
            raise ValueError(
                f"request of {req.n} methods exceeds max_batch "
                f"{self.max_batch}; split it before submitting")
        with self._cond:
            if not self._running or len(self._q) >= self.queue_depth:
                return False
            self._q.append(req)
            depth = len(self._q)
            self._cond.notify()
        self._tele.gauge("serve/queue_depth", depth, emit=False)
        return True

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    @property
    def running(self) -> bool:
        return self._running

    # ---- consumer side ----
    def _collect(self, me: threading.Thread) -> List[PredictRequest]:
        """One flush: first request (blocking) + coalescing window.

        `me` is the consumer's own thread object; `self._thread is me` is
        its generation token. A stop()/start() pair that completes while
        this consumer sleeps installs a new thread with `_running` True
        again, so exit conditions check the token, not the flag, or the
        superseded consumer would keep draining beside its
        replacement."""
        with self._cond:
            while self._thread is me and not self._q:
                self._cond.wait()
            if self._thread is not me:
                return []
            batch = [self._q.popleft()]
            n = batch[0].n
            flush_at = time.monotonic() + self.timeout_s
            while n < self.max_batch:
                if self._q:
                    if n + self._q[0].n > self.max_batch:
                        break  # would overflow: leave for the next batch
                    req = self._q.popleft()
                    batch.append(req)
                    n += req.n
                    continue
                remaining = flush_at - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
                if self._thread is not me:
                    break
            # the drain side keeps the gauge honest too
            depth = len(self._q)
        self._tele.gauge("serve/queue_depth", depth, emit=False)
        return batch

    def _shed_expired(self, batch: List[PredictRequest]
                      ) -> List[PredictRequest]:
        now = time.monotonic()
        live = []
        for req in batch:
            if req.done:
                continue  # already resolved by its waiter
            if req.deadline is not None and now > req.deadline:
                if req.fail(ServerOverloaded(
                        f"deadline exceeded after "
                        f"{(now - req.enqueued_at) * 1e3:.0f} ms in "
                        f"queue")):
                    # counted only when this fail resolved it: the
                    # waiter's timeout path counts its own shed
                    self._tele.count("serve/shed")
            else:
                live.append(req)
        return live

    def _run(self) -> None:
        me = threading.current_thread()
        while True:
            batch = self._collect(me)
            if not batch and self._thread is not me:
                # superseded: a batch already dequeued above is still
                # ours to finish, an empty one means exit
                return
            batch = self._shed_expired(batch)
            if not batch:
                continue
            n = sum(r.n for r in batch)
            self._tele.count("serve/batches")
            self._tele.record_ms("serve/batch_methods", n)
            self._tele.gauge("serve/batch_occupancy",
                             round(n / self.max_batch, 4), emit=False)
            try:
                results = self._batch_fn(batch)
            except BaseException as e:  # noqa: BLE001 — forwarded, not hidden
                for req in batch:
                    req.fail(e)
                continue
            if len(results) != len(batch):
                err = RuntimeError("batch_fn must return one result per "
                                   "request")
                for req in batch:
                    req.fail(err)
                continue
            for req, res in zip(batch, results):
                req.finish(res)

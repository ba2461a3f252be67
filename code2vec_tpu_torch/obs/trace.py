"""Request-scoped tracing: trace-id/span-id span trees with explicit
cross-thread handoff, recorded through the `Telemetry` JSONL sink. A
copy of obs/trace.py of the JAX package (stdlib only).

The telemetry registry answers "how slow"; this layer answers
"where": a serving request crosses three threads (client -> bounded
queue -> micro-batcher -> device -> client decode) and a training step
spans the infeed producer, the loop, and the async checkpoint writer —
a p99 outlier is only actionable once it decomposes into
queue_wait / parse / encode / device / decode (or
infeed_wait / step / save_blocked). Model (the Dapper shape):

  - a *trace* is one causal unit (a serving request, a training step);
    a *span* is one named interval on one thread, with a parent span
    and optional cross-trace *links* (the batcher flush serves many
    requests: it continues the FIRST request's trace and links the
    rest — the many-to-one arrows Chrome/Perfetto draw as flow events);
  - WITHIN a thread, parentage is implicit: entering a span as a
    context manager makes it the thread-local current span, so nested
    phases need no plumbing;
  - ACROSS threads, parentage is explicit: a `SpanContext` (immutable
    trace-id/span-id pair) is the handoff object that rides the work
    item — `PredictRequest.trace_ctx` through the serving queue, the
    checkpoint writer's job dict, and a `SpanChannel` alongside the
    infeed queue. The receiving thread parents (or links) its spans to
    the context it was handed; it never ends a span another thread
    owns (the span handoff discipline).

Spans are recorded AT END as one `kind="span"` JSONL event each — no
in-memory trace tree to drain, and a crashed run keeps every span that
finished. The port's `tools/trace_report.py` renders the log as Chrome
trace-event JSON (Perfetto / chrome://tracing, with flow events
stitching requests through batcher flushes) and computes the
critical-path breakdowns.

Timebase: `clock` (default `time.monotonic`, injectable for tests) is
shared by every span in a tracer, so retroactively recorded spans
(`record_span`) can be built from timestamps taken by other code — the
batcher reuses `PredictRequest.enqueued_at` (also `time.monotonic`)
as the queue-wait span's start.

Disabled path: `Tracer.disabled()` is a shared
singleton whose `enabled` is False and whose methods return the one
shared `_NullTraceSpan` — hot paths guard on the ONE boolean and
allocate nothing. Stdlib-only at import time; thread-safe by
construction (span creation takes the tracer lock; spans themselves
are single-owner by the handoff discipline).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Union

__all__ = ["SpanContext", "SpanChannel", "TraceSpan", "Tracer"]


class SpanContext(NamedTuple):
    """The immutable cross-thread handoff object: enough identity to
    parent or link a span on another thread, nothing else (no end(),
    no mutation — the owning thread keeps those)."""

    trace_id: str
    span_id: str


class SpanChannel:
    """FIFO side-channel carrying SpanContexts across a thread boundary
    in lockstep with a data queue: the producer `send()`s one context
    per item it enqueues, the consumer `recv()`s one per item it
    dequeues, and because both sides are sequential and the data queue
    is FIFO, position k's context describes position k's item — the
    infeed handoff (data/prefetch.py producer -> TrainStepRecorder)
    without changing the queue's item shape. deque append/popleft are
    atomic under the GIL."""

    __slots__ = ("_dq",)

    def __init__(self):
        self._dq: "collections.deque" = collections.deque()

    def send(self, ctx: Optional[SpanContext]) -> None:
        self._dq.append(ctx)

    def recv(self) -> Optional[SpanContext]:
        try:
            return self._dq.popleft()
        except IndexError:
            return None


class TraceSpan:
    """One open interval owned by the thread that started it. `end()`
    emits the span record; entering as a context manager makes it the
    thread-local current span (implicit within-thread parentage)."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "_t0", "_tid", "_tname", "links", "attrs", "_prev")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str],
                 links: Sequence[SpanContext], attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.links = list(links)
        self.attrs = attrs
        t = threading.current_thread()
        self._tid = t.ident or 0
        self._tname = t.name
        self._prev = None
        self._t0 = tracer.clock()

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def end(self, **extra) -> float:
        """Close the span and emit its record; returns the duration in
        ms. Idempotent: a second end() is a no-op returning 0.0, so
        error paths can close defensively without double-emitting (the
        ownership discipline still holds — only the OWNER may call)."""
        tracer, self._tracer = self._tracer, None
        if tracer is None:
            return 0.0
        t1 = tracer.clock()
        if extra:
            self.attrs.update(extra)
        tracer._finish(self, t1)
        return (t1 - self._t0) * 1e3

    # context-manager form: current-span bookkeeping for implicit
    # within-thread parentage
    def __enter__(self) -> "TraceSpan":
        tls = self._tracer._tls
        self._prev = getattr(tls, "current", None)
        tls.current = self
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        tracer = self._tracer
        if tracer is not None:  # not already end()ed early
            tracer._tls.current = self._prev
            self.end()


class _NullTraceSpan:
    """Shared no-op span: the disabled tracer hands out exactly one of
    these, so the off path allocates nothing per call."""

    __slots__ = ()
    name = ""
    trace_id = ""
    span_id = ""

    def context(self) -> None:
        return None

    def end(self, **extra) -> float:
        return 0.0

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NULL_SPAN = _NullTraceSpan()

# synthetic thread-id base for virtual tracks (retroactive spans that
# describe a queue or another non-thread location, kept off the real
# threads' rows in the Chrome view)
_VIRTUAL_TID_BASE = 1 << 20


class Tracer:
    """Span factory + live-span registry over one `Telemetry` registry.

    Construct via `create()` (returns the disabled singleton unless the
    telemetry run has sinks — spans are only useful once they persist)
    or `disabled()`. All span records flow through
    `telemetry.event("span", ...)`, so they land in the same
    `events.jsonl` the rest of the run writes and `--trace` needs no
    second output path. The live-span table (unfinished spans) feeds
    the watchdog's stall dump."""

    def __init__(self, telemetry, clock=time.monotonic):
        self.enabled = True
        self.telemetry = telemetry
        self.clock = clock
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._live: Dict[str, TraceSpan] = {}
        self._tls = threading.local()
        self._track_tids: Dict[str, int] = {}

    # ---- construction ----
    @classmethod
    def create(cls, telemetry, clock=time.monotonic) -> "Tracer":
        """A recording tracer over a sink-backed telemetry run; the
        shared disabled singleton otherwise (memory/disabled telemetry
        has nowhere durable to put spans)."""
        if telemetry is None or not telemetry.enabled \
                or not telemetry.sinks:
            return _NULL_TRACER
        return cls(telemetry, clock=clock)

    @classmethod
    def disabled(cls) -> "Tracer":
        return _NULL_TRACER

    # ---- span creation ----
    def _ids(self, parent) -> tuple:
        """(trace_id, parent_span_id) for a new span: explicit parent
        (TraceSpan or SpanContext) > thread-local current > new trace."""
        if parent is None:
            parent = getattr(self._tls, "current", None)
        if parent is None:
            return f"t{next(self._seq):x}", None
        if isinstance(parent, SpanContext):
            return parent.trace_id, parent.span_id
        return parent.trace_id, parent.span_id

    def start_trace(self, name: str, **attrs) -> TraceSpan:
        """Root span of a NEW trace (one serving request, one training
        step cycle) regardless of any current span on this thread."""
        trace_id = f"t{next(self._seq):x}"
        return self._start(name, trace_id, None, (), attrs)

    def start_span(self, name: str,
                   parent: Union[TraceSpan, SpanContext, None] = None,
                   links: Sequence[SpanContext] = (),
                   **attrs) -> TraceSpan:
        """Child span: of `parent` when given (the cross-thread case —
        pass the SpanContext that rode the work item), else of this
        thread's current span, else a fresh trace root."""
        trace_id, parent_id = self._ids(parent)
        return self._start(name, trace_id, parent_id, links, attrs)

    def _start(self, name, trace_id, parent_id, links, attrs
               ) -> TraceSpan:
        span = TraceSpan(self, name, trace_id, f"s{next(self._seq):x}",
                         parent_id, links, attrs)
        with self._lock:
            self._live[span.span_id] = span
        return span

    def record_span(self, name: str, t_start: float, t_end: float,
                    parent: Union[TraceSpan, SpanContext, None] = None,
                    links: Sequence[SpanContext] = (),
                    track: Optional[str] = None,
                    **attrs) -> SpanContext:
        """Retroactive span from two `clock` timestamps taken elsewhere
        (queue wait from `PredictRequest.enqueued_at`, a step interval
        the recorder already measured). `track` names a virtual Chrome
        row (e.g. "serve-queue") instead of the recording thread's —
        the span describes a location, not this thread's work."""
        trace_id, parent_id = self._ids(parent)
        span_id = f"s{next(self._seq):x}"
        if track is not None:
            with self._lock:
                tid = self._track_tids.setdefault(
                    track, _VIRTUAL_TID_BASE + len(self._track_tids))
            tname = track
        else:
            t = threading.current_thread()
            tid, tname = t.ident or 0, t.name
        self._emit(name, trace_id, span_id, parent_id, links, tid,
                   tname, t_start, t_end, attrs)
        return SpanContext(trace_id, span_id)

    # ---- record plumbing ----
    def _finish(self, span: TraceSpan, t1: float) -> None:
        with self._lock:
            self._live.pop(span.span_id, None)
        self._emit(span.name, span.trace_id, span.span_id,
                   span.parent_id, span.links, span._tid, span._tname,
                   span._t0, t1, span.attrs)

    def _emit(self, name, trace_id, span_id, parent_id, links, tid,
              tname, t0, t1, attrs) -> None:
        ev: Dict[str, Any] = {
            "name": name, "trace": trace_id, "span": span_id,
            "t0": round(t0, 6), "dur_ms": round((t1 - t0) * 1e3, 3),
            "tid": tid, "tname": tname,
        }
        if parent_id is not None:
            ev["parent"] = parent_id
        if links:
            ev["links"] = [[c.trace_id, c.span_id] for c in links
                           if c is not None]
        if attrs:
            ev["attrs"] = attrs
        self.telemetry.event("span", **ev)

    def live_spans(self) -> List[Dict[str, Any]]:
        """Snapshot of unfinished spans (the watchdog's stall dump:
        WHAT was in flight when a component went quiet)."""
        now = self.clock()
        with self._lock:
            spans = list(self._live.values())
        return [{"name": s.name, "trace": s.trace_id, "span": s.span_id,
                 "parent": s.parent_id, "tname": s._tname,
                 "tid": s._tid,
                 "age_ms": round((now - s._t0) * 1e3, 1),
                 "attrs": dict(s.attrs)} for s in spans]


class _NullTracer(Tracer):
    """The `--trace`-unset path: every method a no-op returning the
    shared null span; `enabled` False so hot loops skip with one
    boolean check."""

    def __init__(self):
        self.enabled = False
        self.telemetry = None
        self.clock = time.monotonic
        self._tls = threading.local()

    def start_trace(self, name, **attrs):
        return _NULL_SPAN

    def start_span(self, name, parent=None, links=(), **attrs):
        return _NULL_SPAN

    def record_span(self, name, t_start, t_end, parent=None, links=(),
                    track=None, **attrs):
        return None

    def live_spans(self):
        return []


_NULL_TRACER = _NullTracer()

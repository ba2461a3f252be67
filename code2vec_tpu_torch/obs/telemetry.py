"""Unified run telemetry: one registry, pluggable sinks.

A copy of obs/telemetry.py of the JAX package, with PyTorch where it
asked JAX (`device_sync`, the manifest's device topology):

  - counters / gauges / timer histograms (p50/p95/p99 + max) held
    in-process, cheap enough for per-step recording;
  - pluggable sinks (obs/sinks.py): a per-run JSONL event log under
    `--telemetry_dir` opened with a run manifest (run_id, config
    snapshot, device topology, process index), a TensorBoard adapter
    reusing `ScalarWriter`, and stdout;
  - span helpers explicit about host-vs-device time: `span()` is a
    plain monotonic host timer; `span().stop(sync=tree)` first waits for
    the device work behind a tensor of `tree`, so step latency measures
    the card, not the launch.

Imports only the stdlib at module scope; torch is imported by the calls
that touch a tensor or the card, so the serving control plane imports
without it. The disabled path (`--telemetry_dir`
unset) is a shared singleton whose `enabled` is False: hot loops guard
on that one boolean and allocate nothing per step.

Not thread-safe by default: record from the loop thread that owns the
instance. The serving subsystem (client threads, the extractor pool and
the batcher thread record into one registry), the async checkpoint
writer, the trace and the watchdog call `make_threadsafe()`, which
installs an RLock around the mutating surface.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence

__all__ = ["Telemetry", "TimerStat", "device_sync"]

# percentiles every summary reports; the serving latency line and
# the port's tools/telemetry_report.py render exactly these
SUMMARY_PERCENTILES = (50, 95, 99)


def _first_tensor(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def device_sync(tree) -> None:
    """Wait until the device work behind `tree` (a tensor, or dicts /
    lists / tuples holding tensors; the first tensor found stands for
    all) has completed: a synchronise of the current stream of that
    tensor's device, the stream the port's steps run on. A CPU tensor
    needs no wait. A tree without a tensor is a caller's error and
    raises, as does a failed synchronise: there is no weaker fallback.
    """
    t = _first_tensor(tree)
    if t is None:
        raise TypeError(f"device_sync: no tensor in {type(tree).__name__}")
    if t.device.type == "cuda":
        import torch
        torch.cuda.current_stream(t.device).synchronize()


class TimerStat:
    """Streaming timer histogram: exact count/total/max plus a bounded
    sample ring for percentiles (the last `cap` samples — recent-window
    percentiles, which is what a long run wants anyway: p99 of the
    current regime, not of compile-step outliers hours ago)."""

    __slots__ = ("count", "total_ms", "max_ms", "_ring", "_cap", "_lock")

    def __init__(self, cap: int = 2048):
        assert cap >= 1
        self.count = 0
        self.total_ms = 0.0
        self.max_ms = 0.0
        self._cap = cap
        self._ring: list = []
        # installed by Telemetry.make_threadsafe() (the OWNING
        # registry's lock): percentile reads then snapshot under it
        self._lock: Optional[threading.RLock] = None

    def record(self, ms: float) -> None:
        self.count += 1
        self.total_ms += ms
        if ms > self.max_ms:
            self.max_ms = ms
        if len(self._ring) < self._cap:
            self._ring.append(ms)
        else:
            self._ring[self.count % self._cap] = ms

    @property
    def mean_ms(self) -> float:
        return self.total_ms / self.count if self.count else float("nan")

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the sample window.

        Threadsafe mode (the registry's `make_threadsafe()`) installs
        the registry lock here, so the ring snapshot cannot interleave
        with a concurrent `record` from another thread. WITHOUT the
        lock (the train loop's single-threaded fast path) the snapshot
        relies on CPython list-copy atomicity under the GIL — safe only
        when every `record` happens on the reading thread; concurrent
        lock-free use could sort a ring mid-mutation and return a
        value from a torn window."""
        lock = self._lock
        if lock is not None:
            with lock:
                if not self._ring:
                    return float("nan")
                s = sorted(self._ring)
        else:
            if not self._ring:
                return float("nan")
            s = sorted(list(self._ring))
        k = int(round(p / 100.0 * (len(s) - 1)))
        return s[max(0, min(len(s) - 1, k))]

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {"count": self.count,
                                 "mean_ms": round(self.mean_ms, 4),
                                 "max_ms": round(self.max_ms, 4)}
        for p in SUMMARY_PERCENTILES:
            out[f"p{p}_ms"] = round(self.percentile(p), 4)
        return out


class _Span:
    """One in-flight timing: host-monotonic start at construction,
    `stop()` records into the owning timer. `stop(sync=tree)` makes it
    device-sync-aware: the span ends only when the device work behind
    `tree` has completed, so it measures device time, not launch time.
    """

    __slots__ = ("_tele", "_name", "_t0")

    def __init__(self, tele: "Telemetry", name: str):
        self._tele = tele
        self._name = name
        self._t0 = time.perf_counter()

    def stop(self, sync=None) -> float:
        if self._tele is None:  # cancelled: defensively closed already
            return 0.0
        if sync is not None:
            device_sync(sync)
        ms = (time.perf_counter() - self._t0) * 1e3
        self._tele.record_ms(self._name, ms)
        return ms

    def cancel(self) -> None:
        """Close WITHOUT recording — the error-path release (graftlint
        resource-leak discipline): a request that died mid-span must
        not leak the span, but its partial duration would pollute the
        latency histogram, so it is dropped instead of stopped."""
        self._tele = None


class _NullSpan:
    __slots__ = ()

    def stop(self, sync=None) -> float:
        return 0.0

    def cancel(self) -> None:
        pass


_NULL_SPAN = _NullSpan()

# run ids within one process get a monotonic suffix so two runs created
# in the same second (tests, back-to-back tools) never collide
_RUN_SEQ = [0]


def device_topology() -> Dict[str, Any]:
    """The devices this process runs on: the card's name and count where
    CUDA is available, else the CPU."""
    import torch
    if torch.cuda.is_available():
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "count": 1}


def _process_group():
    """(rank, world) of the process group joined through
    parallel/distributed.py, else (0, 1); never imports torch (a process
    that joined one has it loaded)."""
    dist_mod = sys.modules.get("code2vec_tpu_torch.parallel.distributed")
    if dist_mod is None or dist_mod.backend() is None:
        return 0, 1
    from code2vec_tpu_torch.parallel.compat import cohort_world
    return cohort_world()


def _build_run_manifest(config, component: str) -> Dict[str, Any]:
    """The run's identity: id, component, time, process index and
    count (the process group's, parallel/distributed.py; 0 of 1
    without one), the device topology and the config. The backend is in
    the trainer's live-plane identity (`TrainerBase.identity`)."""
    process_index, process_count = _process_group()
    devices = device_topology()
    _RUN_SEQ[0] += 1
    run_id = (f"run-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
              f"-p{process_index}-{_RUN_SEQ[0]}")
    manifest: Dict[str, Any] = {
        "run_id": run_id,
        "component": component,
        "created": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "created_unix": time.time(),
        "process_index": process_index,
        "process_count": process_count,
        "devices": devices,
    }
    if config is not None:
        try:
            manifest["config"] = dataclasses.asdict(config)
        except TypeError:
            manifest["config"] = {
                k: v for k, v in vars(config).items()
                if isinstance(v, (int, float, str, bool, type(None)))}
    return manifest


class Telemetry:
    """Registry of counters, gauges and timer histograms feeding a list
    of sinks. Construct via `create()` (file-backed run, or the shared
    disabled singleton when no directory is given) or `memory()` (live
    histograms, no persistence — the serving REPL's always-on mode)."""

    def __init__(self, sinks: Sequence = (), run_id: str = "",
                 enabled: bool = True):
        self.enabled = enabled
        self.run_id = run_id
        self.run_dir: Optional[str] = None
        self.sinks = list(sinks)
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        # last-update time (time.monotonic) per gauge: a dead producer's
        # queue-depth gauge must not read as a live value forever —
        # the watchdog's stall dump marks stale gauges from
        # these timestamps (gauge_ages()).
        self.gauge_updated: Dict[str, float] = {}
        self.timers: Dict[str, TimerStat] = {}
        # None = lock-free fast path (the train loop); serving calls
        # make_threadsafe() because many threads share one registry
        self._lock: Optional[threading.RLock] = None

    def make_threadsafe(self) -> "Telemetry":
        """Install an RLock around the mutating surface (count / gauge /
        record_ms / event / summary / close) and onto every timer's
        percentile reads (existing and future — TimerStat.percentile).
        Returns self, so call sites can chain:
        `Telemetry.memory("serve").make_threadsafe()`."""
        if self._lock is None:
            self._lock = threading.RLock()
            for t in self.timers.values():
                t._lock = self._lock
        return self

    # shared stateless instance: the lock-free path must not allocate
    # a context manager per record
    _NO_LOCK = contextlib.nullcontext()

    def _guard(self):
        return self._lock if self._lock is not None else self._NO_LOCK

    # ---- construction ----
    @classmethod
    def create(cls, telemetry_dir: Optional[str], *, config=None,
               component: str = "run", scalar_writer=None,
               log: Optional[Callable[[str], None]] = None) -> "Telemetry":
        """File-backed run telemetry under `telemetry_dir/<run_id>/`:
        `manifest.json` plus an `events.jsonl` sink (and optionally the
        TensorBoard adapter over an existing ScalarWriter and a stdout
        sink over `log`). Returns the disabled singleton when
        `telemetry_dir` is falsy — the call site needs no branching."""
        if not telemetry_dir:
            return _NULL
        from code2vec_tpu_torch.obs.sinks import (JsonlSink, ScalarSink,
                                                  StdoutSink)
        manifest = _build_run_manifest(config, component)
        run_dir = os.path.join(telemetry_dir, manifest["run_id"])
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "manifest.json"), "w",
                  encoding="utf-8") as f:
            json.dump(manifest, f, indent=2, default=str)
        sinks: list = [JsonlSink(os.path.join(run_dir, "events.jsonl"))]
        if scalar_writer is not None:
            sinks.append(ScalarSink(scalar_writer))
        if log is not None:
            sinks.append(StdoutSink(log))
        tele = cls(sinks, run_id=manifest["run_id"])
        tele.run_dir = run_dir
        if log is not None:
            log(f"telemetry: run {manifest['run_id']} -> {run_dir}")
        return tele

    @classmethod
    def memory(cls, component: str = "run") -> "Telemetry":
        """Enabled registry with no sinks: histograms live in-process
        only. Serving uses this when --telemetry_dir is unset so the
        p50/p95/p99 request line still works without persistence."""
        return cls((), run_id=f"mem-{component}")

    @classmethod
    def disabled(cls) -> "Telemetry":
        return _NULL

    # ---- recording ----
    def count(self, name: str, n: float = 1) -> None:
        with self._guard():
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float, emit: bool = True,
              static: bool = False) -> None:
        """`static=True` marks a set-once constant (a config echo like
        train/max_contexts): freshness is meaningless for it, so it is
        excluded from gauge_ages() — otherwise every staleness
        consumer (stall dumps) would flag it
        forever and bury the real dead-producer signal."""
        with self._guard():
            self.gauges[name] = value
            if static:
                self.gauge_updated.pop(name, None)
            else:
                self.gauge_updated[name] = time.monotonic()
        if emit:
            self.event("gauge", name=name, value=value)

    def gauge_ages(self, now: Optional[float] = None
                   ) -> Dict[str, float]:
        """Seconds since each gauge was last set (time.monotonic
        timebase). The freshness signal for pull-based consumers: a
        queue-depth gauge whose producer died keeps its last VALUE, but
        its age keeps growing, so a consumer
        can mark the gauge stale, and the watchdog's stall dump lists
        gauges older than the stall deadline."""
        t = time.monotonic() if now is None else now
        with self._guard():
            return {name: max(0.0, t - ts)
                    for name, ts in self.gauge_updated.items()}

    def timer(self, name: str) -> TimerStat:
        with self._guard():
            t = self.timers.get(name)
            if t is None:
                t = self.timers[name] = TimerStat()
                t._lock = self._lock  # threadsafe-mode percentile reads
            return t

    def record_ms(self, name: str, ms: float) -> None:
        with self._guard():
            self.timer(name).record(ms)

    def span(self, name: str) -> _Span:
        """Start a host-monotonic span; `stop()` records it, and
        `stop(sync=tree)` waits for device work first (host-vs-device
        explicitness lives in the call, not the name)."""
        return _Span(self, name)

    def timed(self, name: str):
        """Context-manager form of `span` for plain host phases."""
        return self._timed(name)

    @contextlib.contextmanager
    def _timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record_ms(name, (time.perf_counter() - t0) * 1e3)

    def event(self, kind: str, **fields) -> None:
        """One structured record to every sink. Sinks see a flat dict
        with `kind` and a wall-clock `ts`."""
        if not self.sinks:
            return
        ev: Dict[str, Any] = {"kind": kind, "ts": round(time.time(), 6)}
        ev.update(fields)
        with self._guard():
            for s in self.sinks:
                s.write(ev)

    def update_manifest(self, **fields: Any) -> bool:
        """Merge `fields` into this run's `manifest.json` (tmp-write +
        rename, so readers never see a torn file). The clock handshake
        (obs/exposition `/clock?commit=1`) persists a measured
        wall-clock offset this way. False = nothing durable to update
        (memory registry, or the manifest is unreadable) — callers
        treat that as "this run can't be clock-committed", not an
        error."""
        if not self.run_dir:
            return False
        path = os.path.join(self.run_dir, "manifest.json")
        with self._guard():
            try:
                with open(path, encoding="utf-8") as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                return False
            manifest.update(fields)
            tmp = path + ".tmp"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(manifest, f, indent=2, default=str)
                os.replace(tmp, path)
            except OSError:
                return False
        return True

    # ---- lifecycle ----
    def summary(self) -> Dict[str, Any]:
        with self._guard():
            return {"counters": dict(self.counters),
                    "gauges": dict(self.gauges),
                    "timers": {k: t.summary()
                               for k, t in sorted(self.timers.items())}}

    def close(self) -> None:
        if not self.enabled:
            return
        if self.sinks:
            self.event("summary", **self.summary())
        with self._guard():
            for s in self.sinks:
                s.close()
            self.sinks = []


class _NullTelemetry(Telemetry):
    """The `--telemetry_dir`-unset path: every method a no-op, shared
    singleton, `enabled=False` so hot loops skip with one check."""

    _NULL_TIMER = TimerStat(cap=1)

    def __init__(self):
        super().__init__((), run_id="disabled", enabled=False)

    def count(self, name, n=1):
        pass

    def gauge(self, name, value, emit=True, static=False):
        pass

    def timer(self, name):
        return self._NULL_TIMER

    def record_ms(self, name, ms):
        pass

    def span(self, name):
        return _NULL_SPAN

    def timed(self, name):
        return contextlib.nullcontext()

    def event(self, kind, **fields):
        pass

    def close(self):
        pass


_NULL = _NullTelemetry()


def format_latency_line(stat: TimerStat, last_ms: Optional[float] = None,
                        what: str = "request") -> str:
    """The serving REPL's one-line latency report."""
    s = stat.summary()
    head = (f"latency: {what} {last_ms:.1f} ms | "
            if last_ms is not None else "latency: ")
    return (head + f"p50 {s['p50_ms']:.1f} / p95 {s['p95_ms']:.1f} / "
            f"p99 {s['p99_ms']:.1f} / max {s['max_ms']:.1f} ms "
            f"over {s['count']} {what}s")

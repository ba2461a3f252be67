"""Train-loop instrumentation: a copy of obs/loop.py of the JAX package.

`TrainStepRecorder` answers the question the throughput log line can't:
is the step device-bound or infeed-bound? Per step it records

  - `infeed_wait_ms` — host time blocked on the prefetching infeed
    (data/prefetch.py). Near zero while the producer thread keeps up;
    grows exactly when the input pipeline, not the card, is the
    bottleneck.
  - `step_ms` — wall time from infeed yield to step completion,
    device-sync-aware: the recorder reads the loss to the host, which
    waits for the step's kernels, so the figure bounds the launched
    device work (and the loss ride-along means per-step loss costs no
    extra transfer).
  - periodic device-memory gauges (`device/bytes_in_use`,
    `device/peak_bytes_in_use`) from `torch.cuda.memory_stats()` where
    CUDA is available.

With a tracer attached (`--trace`) each step additionally becomes a
trace: a `train/step_cycle` root span with `train/infeed_wait` and
`train/step` children (recorded retroactively from the timings the
recorder already took), LINKING the `infeed/produce` span of the batch
it consumed (the producer thread sends that span's context through a
`SpanChannel` in lockstep with the infeed queue). `last_step_context`
exposes the newest step's context so the epoch-boundary save can link
the step that triggered it. A heartbeat (`--watchdog_stall_s`) beats
once per step, and an alert engine (`--alerts_mode raise`) raises its
sticky `AlertError` at the step after the sweep that fired it.

Cost model: telemetry is opt-in (`--telemetry_dir`), and enabling it
trades step pipelining for attribution — the per-step loss read waits
for the card every step, so the host no longer launches step k+1 while
step k runs. The `torch.profiler` window (`--profile`) remains the
non-intrusive tool. Disabled, the recorder costs ONE boolean check per
step and `wrap()` returns the infeed unchanged.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

from code2vec_tpu_torch.obs.telemetry import Telemetry
from code2vec_tpu_torch.obs.trace import SpanChannel, SpanContext, Tracer


def infeed_produce_instrument(tracer: Tracer,
                              channel: Optional[SpanChannel]):
    """Producer-side tracing hook for the infeed: wraps the
    per-batch parse/transfer function so each batch gets an
    `infeed/produce` span ON the producer thread, whose context is
    handed to the consuming step through `channel` (FIFO-aligned with
    the infeed queue — the recorder links it from the step span).
    Returns None when tracing is off, so the infeed path stays
    byte-identical to the untraced one."""
    if not tracer.enabled:
        return None

    def instrument(fn):
        def produce(batch):
            t0 = tracer.clock()
            out = fn(batch)
            channel.send(tracer.record_span(
                "infeed/produce", t0, tracer.clock()))
            return out
        return produce
    return instrument


class TrainStepRecorder:
    """Per-step telemetry for a `for dev_batch, batch in infeed:` loop.

    Usage:
        rec = TrainStepRecorder(telemetry, gauge_every=N)
        for epoch ...:
            for dev_batch, batch in rec.wrap(infeed):
                ... dispatch step ...
                loss_f = rec.end_step(step_num, loss, n) \
                    if rec.enabled else None
    """

    def __init__(self, telemetry: Telemetry, gauge_every: int = 100,
                 tracer: Optional[Tracer] = None,
                 infeed_channel: Optional[SpanChannel] = None,
                 heartbeat=None, alerts=None):
        self.enabled = telemetry.enabled
        self._tele = telemetry
        self._tracer = tracer if tracer is not None else Tracer.disabled()
        self._channel = infeed_channel
        self._heartbeat = heartbeat
        # alert engine (obs/alerts.py): end_step is "the training
        # loop's next beat" where a raise-mode sticky alert surfaces
        self._alerts = alerts
        self.last_step_context: Optional[SpanContext] = None
        self._gauge_every = max(1, gauge_every)
        self._steps = 0
        self._infeed_wait_ms = 0.0
        self._t_yield = 0.0

    @property
    def infeed_wait_ms(self) -> float:
        """Host ms the loop spent waiting on the most recent infeed
        pop: the phase profiler's `infeed_wait` input (obs/phases.py)."""
        return self._infeed_wait_ms

    def probe_tick(self) -> None:
        """Beat the loop heartbeat from inside a long in-step
        measurement: the phase profiler calls this after every probe
        dispatch, so its first sample (a kernel's first-use build among
        it) never reads as a train-loop stall to the watchdog."""
        if self._heartbeat is not None:
            self._heartbeat.beat()

    def rebase_step_window(self) -> None:
        """Restart the current step's timing window. The phase profiler
        calls this after its probe dispatches, so a SAMPLED step's
        train/step_ms (and `step` event) records the fused step alone:
        probe time belongs to the train/phase/* timers, and without the
        rebase 1/N of the step_ms samples would be probe-laden outliers
        whose p99 reports the profiler, not the step."""
        self._t_yield = time.perf_counter()
        if self._heartbeat is not None:
            self._heartbeat.beat()

    def wrap(self, infeed: Iterable) -> Iterable:
        """Time the infeed pops. Disabled: returns `infeed` itself, so
        the loop iterates exactly what it iterated before."""
        if not self.enabled:
            return infeed
        return self._timed_iter(infeed)

    def _timed_iter(self, infeed: Iterable):
        it = iter(infeed)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            now = time.perf_counter()
            self._infeed_wait_ms = (now - t0) * 1e3
            self._t_yield = now
            yield item

    def end_step(self, step: int, loss, n_examples: int,
                 params=None) -> float:
        """Close the current step: sync on the loss transfer, record the
        step/infeed timers, write the per-step event. Returns the loss
        as a float so the loop's log line reuses the one transfer.

        `params` (optional, the live params tree): every `gauge_every`
        steps a sampled fingerprint (sum of one sliver per tensor)
        publishes as a step-labeled gauge pair, which the JAX package's
        fleet plane compares across hosts."""
        loss_f = float(loss)  # waits for the card: bounds the step
        now = time.perf_counter()
        step_ms = (now - self._t_yield) * 1e3
        tele = self._tele
        tele.record_ms("train/step_ms", step_ms)
        tele.record_ms("train/infeed_wait_ms", self._infeed_wait_ms)
        tele.count("train/steps")
        tele.count("train/examples", int(n_examples))
        # the newest loss as a gauge, for monitors that read it off the
        # hot path (emit=False: a dict store, never a JSONL event)
        tele.gauge("train/loss", loss_f, emit=False)
        tele.gauge("train/loss_step", float(step), emit=False)
        tele.event("step", step=int(step), step_ms=round(step_ms, 3),
                   infeed_wait_ms=round(self._infeed_wait_ms, 3),
                   loss=round(loss_f, 6), examples=int(n_examples))
        if self._heartbeat is not None:
            self._heartbeat.beat()
        alerts = self._alerts
        if alerts is not None and alerts._sticky is not None:
            alerts.poll()  # raise-mode alert lands at the loop's beat
        if self._tracer.enabled:
            self._trace_step(step, step_ms, n_examples)
        self._steps += 1
        if self._steps % self._gauge_every == 0:
            self._device_memory_gauges()
            if params is not None:
                self._params_digest_gauges(step, params)
        return loss_f

    def _params_digest_gauges(self, step: int, params) -> None:
        """Sampled params fingerprint: one sliver (`leaf[..., :1]`) per
        tensor of the params tree, summed in float32 (an int8 table's
        q and s both count). A few hundred elements instead of the
        full model, cheap enough for the gauge cadence while still
        moving when any layer's leading column drifts."""
        import torch
        total = 0.0
        for leaf in _tensors(params):
            probe = leaf if leaf.ndim == 0 else leaf[..., :1]
            total += float(probe.to(torch.float32).sum())
        self._tele.gauge("train/params_digest", total, emit=False)
        self._tele.gauge("train/params_digest_step", float(step),
                         emit=False)

    def _trace_step(self, step: int, step_ms: float,
                    n_examples: int) -> None:
        """One trace per step, built retroactively from the timings
        end_step already measured (the tracer clock and perf_counter
        tick at the same rate; only the interval lengths matter).
        Root `train/step_cycle` = infeed wait + step; its `train/step`
        child links the consumed batch's `infeed/produce` span via the
        producer's SpanChannel (FIFO-aligned with the infeed queue)."""
        tracer = self._tracer
        t_end = tracer.clock()
        t_yield = t_end - step_ms / 1e3
        t_wait0 = t_yield - self._infeed_wait_ms / 1e3
        produced = self._channel.recv() if self._channel is not None \
            else None
        root = tracer.record_span(
            "train/step_cycle", t_wait0, t_end, parent=None,
            step=int(step), examples=int(n_examples))
        tracer.record_span("train/infeed_wait", t_wait0, t_yield,
                           parent=root)
        tracer.record_span(
            "train/step", t_yield, t_end, parent=root,
            links=(produced,) if produced is not None else (),
            step=int(step))
        self.last_step_context = root

    def _device_memory_gauges(self) -> None:
        import torch
        if not torch.cuda.is_available():  # the CPU keeps no such stats
            return
        stats = torch.cuda.memory_stats()
        for key, stat in (("bytes_in_use", "allocated_bytes.all.current"),
                          ("peak_bytes_in_use", "allocated_bytes.all.peak")):
            if stat in stats:
                self._tele.gauge(f"device/{key}", int(stats[stat]))


def _tensors(tree):
    """Every tensor of a tree of dicts, lists and tuples."""
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)

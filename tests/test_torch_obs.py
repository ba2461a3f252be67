"""The port's run telemetry (code2vec_tpu_torch/obs/) against the JAX
package's obs/, on the CPU: the same sequence of counters, gauges,
spans and events through both registries, the same latency line, the
same span trees, the same stalled heartbeats; and the port's own
`device_sync`, `ScalarWriter` and `StepProfiler`.

Tolerances: none. The summaries, the JSONL event keys and values (but
the clock and run-id fields), the latency line and the span trees
(names, parents, links) must be equal; timer values are fed in, not
measured, so they are the same floats on both sides.
"""

import json
import os
import sys

import pytest
import torch

from code2vec_tpu import obs as jobs
from code2vec_tpu_torch import obs as tobs
from code2vec_tpu_torch.training.profiler import StepProfiler
from code2vec_tpu_torch.training.scalars import ScalarWriter

# the clock, the run id and the process id differ between two runs
_VOLATILE = {"ts", "t0", "tid", "tname", "dur_ms", "created",
             "created_unix", "run_id"}


def _drive(mod, root):
    """One fixed sequence through a file-backed registry of `mod`."""
    tele = mod.Telemetry.create(str(root), component="train")
    tele.count("train/steps")
    tele.count("train/examples", 32)
    tele.count("train/examples", 8)
    tele.gauge("train/max_contexts", 200, emit=False, static=True)
    tele.gauge("device/bytes_in_use", 1024)
    for ms in (3.0, 1.0, 7.5, 2.25, 9.0, 4.0):
        tele.record_ms("train/step_ms", ms)
    tele.record_ms("serve/request_ms", 12.5)
    tele.span("train/eval_ms").cancel()
    tele.event("eval", epoch=1, step=4, loss=0.5, subtoken_f1=0.25)
    tele.event("step", step=1, step_ms=3.0, infeed_wait_ms=0.5, loss=2.0,
               examples=32)
    summary = tele.summary()
    tele.close()
    with open(os.path.join(tele.run_dir, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    with open(os.path.join(tele.run_dir, "manifest.json")) as f:
        manifest = json.load(f)
    return summary, events, manifest


def test_telemetry_summary_and_events_match_jax(tmp_path):
    want, want_events, want_manifest = _drive(jobs, tmp_path / "jax")
    got, got_events, got_manifest = _drive(tobs, tmp_path / "torch")
    assert got == want
    strip = [[{k: v for k, v in e.items() if k not in _VOLATILE}
              for e in evs] for evs in (got_events, want_events)]
    assert strip[0] == strip[1]
    assert [sorted(e) for e in got_events] == [sorted(e)
                                               for e in want_events]
    assert sorted(got_manifest) == sorted(want_manifest)
    assert (got_manifest["process_index"], got_manifest["process_count"]) \
        == (0, 1)
    assert got_manifest["devices"]["platform"] in ("gpu", "cpu")


def test_disabled_and_memory_registries_match_jax():
    for mod in (jobs, tobs):
        off = mod.Telemetry.create(None)
        assert off is mod.Telemetry.disabled() and not off.enabled
        off.record_ms("x", 1.0)
        assert off.summary()["timers"] == {}
    mem = [mod.Telemetry.memory("serve").make_threadsafe()
           for mod in (jobs, tobs)]
    for tele in mem:
        tele.record_ms("serve/request_ms", 5.0)
        tele.count("serve/requests")
    assert mem[0].summary() == mem[1].summary()
    assert not mem[1].sinks


@pytest.mark.parametrize("samples,last_ms,what", [
    ([5.0], None, "request"),
    ([27.4, 1.6, 1.7], 1.7, "request"),
    ([float(i) for i in range(1, 101)], 42.0, "step"),
    ([0.125] * 3000, 0.125, "request"),   # past the ring's cap
])
def test_format_latency_line_matches_jax(samples, last_ms, what):
    stats = [mod.TimerStat() for mod in (jobs, tobs)]
    for st in stats:
        for ms in samples:
            st.record(ms)
    lines = [mod.format_latency_line(st, last_ms, what)
             for mod, st in zip((jobs, tobs), stats)]
    assert lines[1] == lines[0]
    assert stats[1].summary() == stats[0].summary()


def _spans(mod, root):
    """A request-shaped and a step-shaped span tree through `mod`'s
    Tracer; returns {span name: (parent name, [link names])}."""
    clock = iter(float(i) for i in range(1000))
    tele = mod.Telemetry.create(str(root), component="serve")
    tracer = mod.Tracer.create(tele, clock=lambda: next(clock))
    req = tracer.start_trace("serve/request", file="Input.java")
    other = tracer.start_trace("serve/request", n_methods=2)
    try:
        with tracer.start_span("serve/extract", parent=req):
            pass
        ctx = req.context()
        tracer.record_span("serve/queue_wait", 1.0, 2.0, parent=ctx,
                           track="serve-queue")
        with tracer.start_span("serve/batch_flush", parent=ctx,
                               links=[other.context()]):
            tracer.start_span("serve/encode").end()
            tracer.start_span("serve/device").end()
        tracer.start_span("serve/decode", parent=req).end()
    finally:
        other.end(n_results=0)
        req.end(n_results=2)
    channel = mod.SpanChannel()
    channel.send(tracer.record_span("infeed/produce", 0.0, 1.0))
    produced = channel.recv()
    root_span = tracer.record_span("train/step_cycle", 0.0, 2.0, step=1)
    tracer.record_span("train/infeed_wait", 0.0, 1.0, parent=root_span)
    tracer.record_span("train/step", 1.0, 2.0, parent=root_span,
                       links=(produced,), step=1)
    assert tracer.live_spans() == []
    tele.close()
    with open(os.path.join(tele.run_dir, "events.jsonl")) as f:
        spans = [json.loads(ln) for ln in f]
    spans = [e for e in spans if e["kind"] == "span"]
    by_id = {e["span"]: e["name"] for e in spans}
    return sorted((e["name"], by_id.get(e.get("parent")),
                   tuple(by_id[s] for _t, s in e.get("links", [])),
                   json.dumps(e.get("attrs"), sort_keys=True))
                  for e in spans)


def test_tracer_span_trees_match_jax(tmp_path):
    want = _spans(jobs, tmp_path / "jax")
    got = _spans(tobs, tmp_path / "torch")
    assert got == want
    assert ("train/step", "train/step_cycle", ("infeed/produce",),
            '{"step": 1}') in got


@pytest.mark.parametrize("mode", ["warn", "raise"])
def test_watchdog_reports_the_same_stalls_as_jax(tmp_path, mode):
    """Three heartbeats under a fake clock: one beating, one silent past
    its deadline, one idle. Both watchdogs report the silent one; in
    raise mode its next beat raises StallError."""
    reports = []
    for mod, sub in ((jobs, "jax"), (tobs, "torch")):
        now = [0.0]
        tele = mod.Telemetry.create(str(tmp_path / sub), component="train")
        wd = mod.Watchdog.create(tele, stall_s=10.0, mode=mode,
                                 clock=lambda: now[0])
        loop, writer, infeed = (wd.register(n) for n in (
            "train_loop", "checkpoint_writer", "infeed_producer"))
        loop.busy()
        writer.busy()
        infeed.beat()
        infeed.idle()
        now[0] = 6.0
        loop.beat()
        now[0] = 12.0
        first = [s["component"] for s in wd.check_now()]
        again = [s["component"] for s in wd.check_now()]  # edge-triggered
        status = {k: v["stalled"] for k, v in wd.status().items()}
        raised = None
        if mode == "raise":
            with pytest.raises(mod.StallError) as info:
                writer.beat()
            raised = str(info.value).split(" (diagnostics")[0]
        else:
            writer.beat()
        tele.close()
        dumps = [n for n in os.listdir(tele.run_dir)
                 if n.startswith("stall_dump_")]
        reports.append((first, again, status, raised, len(dumps)))
    assert reports[1] == reports[0]
    assert reports[1][0] == ["checkpoint_writer"] and reports[1][4] == 1


def test_watchdog_and_tracer_off_without_a_file_backed_run():
    mem = tobs.Telemetry.memory("serve")
    assert not tobs.Tracer.create(mem).enabled
    wd = tobs.Watchdog.create(mem, stall_s=5.0)
    assert not wd.enabled
    wd.register("x").beat()  # the shared no-op heartbeat


def test_device_sync_waits_and_never_degrades():
    tobs.device_sync(torch.ones(3))                     # CPU: no wait
    tobs.device_sync({"a": [torch.ones(1)], "b": 2})    # a tree
    with pytest.raises(TypeError, match="no tensor"):
        tobs.device_sync({"a": 1.0})


def _recorded(mod, tmp_path, sub):
    tele = mod.Telemetry.create(str(tmp_path / sub), component="train")
    tracer = mod.Tracer.create(tele)
    channel = mod.SpanChannel()
    rec = mod.TrainStepRecorder(tele, gauge_every=2, tracer=tracer,
                                infeed_channel=channel)
    produce = mod.infeed_produce_instrument(tracer, channel)(lambda b: b)
    losses = []
    for i, b in enumerate(rec.wrap([produce(k) for k in range(3)])):
        losses.append(rec.end_step(i + 1, 0.5 * (b + 1), 16))
    tele.close()
    with open(os.path.join(tele.run_dir, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    return losses, [(e["kind"], e.get("name"), sorted(e)) for e in events]


def test_train_step_recorder_matches_jax(tmp_path):
    """The recorder over three steps of a fake infeed: the same losses
    back, the same events (kinds, span names, keys) in the same order.
    Off, `wrap` returns the infeed itself."""
    want = _recorded(jobs, tmp_path, "jax")
    got = _recorded(tobs, tmp_path, "torch")
    assert got == want
    feed = [1, 2]
    assert tobs.TrainStepRecorder(tobs.Telemetry.disabled()).wrap(feed) \
        is feed


def test_scalar_writer_writes_events_or_warns_once(tmp_path, caplog,
                                                   monkeypatch):
    ScalarWriter(None).write(1, {"x": 1.0})  # no directory: a no-op
    try:
        import torch.utils.tensorboard  # noqa: F401
        have_tb = True
    except ImportError:
        have_tb = False
    if have_tb:
        w = ScalarWriter(str(tmp_path / "tb"))
        w.write(3, {"train/loss": 0.5})
        w.close()
        assert any(n.startswith("events.out.tfevents")
                   for n in os.listdir(tmp_path / "tb"))
    from code2vec_tpu_torch.training import scalars
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(scalars, "_WARNED_MISSING_TB", False)
    for _ in range(2):
        w = ScalarWriter(str(tmp_path / "tb2"))
        w.write(1, {"x": 1.0})
        w.close()
    warned = [r for r in caplog.records if "tensorboard" in r.getMessage()]
    assert len(warned) == 1 and not os.path.exists(tmp_path / "tb2")


def test_step_profiler_window_writes_a_chrome_trace(tmp_path):
    logs = []
    prof = StepProfiler(str(tmp_path / "p"), start_step=2, num_steps=2,
                        log=logs.append)
    x = torch.ones(8)
    for step in range(6):
        prof.tick(step, x)
        x = x * 2 + 1
    prof.finish(x)
    with open(prof.trace_path) as f:
        trace = json.load(f)
    assert "traceEvents" in trace
    # a window still open when the run ends is closed by finish
    late = StepProfiler(str(tmp_path / "q"), start_step=1, num_steps=50)
    for step in range(3):
        late.tick(step, x)
    late.finish(x)
    assert os.path.exists(late.trace_path)
    # a run that ends before the window says so and writes nothing
    early = StepProfiler(str(tmp_path / "r"), start_step=9, num_steps=2,
                         log=logs.append)
    early.tick(0, x)
    early.finish(x)
    assert early.trace_path is None and "no trace written" in logs[-1]


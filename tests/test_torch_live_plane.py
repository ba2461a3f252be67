"""The port's live metrics plane (obs/promtext.py, health.py, alerts.py,
exposition.py) against the JAX package's, on the CPU.

- the same counter, gauge and timer events into a port `Telemetry` and a
  JAX one render (`render_prometheus`) to the same families and values,
  and the port's `promtext` parses its own rendering back;
- the default train and serving health monitors and alert rules, under
  one fake clock on both sides, fed the same series (a NaN loss, a loss
  spike, a throughput drop, a shed burn-rate window), give the same
  status rows and the same ok -> pending -> firing -> resolved
  transitions;
- `OptEfficiency` and `PhaseRoofline` report no data in the port (no
  floor gauge, no phase timers);
- the plane on the port's own entry points: a CPU `Code2VecTrainer.train`
  with `--metrics_port` scraped while it runs, `train/nan_loss` under
  `--alerts_mode raise`, a CPU `PredictionServer`'s `/healthz` and its
  port closed by `close()`.

Tolerances: none. The rows and the parsed families are compared exactly
(NaN equal to NaN), except the `gauge_age_seconds` values, which are
wall-clock ages and are compared by their labels only.
"""

import json
import math
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from code2vec_tpu.obs import alerts as jalerts
from code2vec_tpu.obs import exposition as jexpo
from code2vec_tpu.obs import health as jhealth
from code2vec_tpu.obs import telemetry as jtele
from code2vec_tpu_torch import cli
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
from code2vec_tpu_torch.obs import alerts as talerts
from code2vec_tpu_torch.obs import exposition as texpo
from code2vec_tpu_torch.obs import health as thealth
from code2vec_tpu_torch.obs import promtext
from code2vec_tpu_torch.obs import telemetry as ttele
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.serving.server import PredictionServer
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
from helpers import build_tiny_dataset

C, E = 16, 16


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _get(port, path, timeout=5.0):
    try:
        with urllib.request.urlopen(f"http://localhost:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def _norm(x):
    """Rows and parsed families with NaN made comparable."""
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _record(tele):
    tele.count("train/steps", 3)
    tele.count("serve/cache_hit")
    tele.gauge("train/loss", 1.25, emit=False)
    tele.gauge("train/max_contexts", 200, emit=False, static=True)
    tele.gauge("serve/queue_depth", float("nan"), emit=False)
    for ms in (3.0, 1.0, 2.0, 40.0, 5.5):
        tele.record_ms("train/step_ms", ms)
    tele.record_ms("serve/request_ms", 7.25)


def test_render_prometheus_matches_jax_and_round_trips():
    """The same events render to the same families and values (gauge
    ages by their labels); promtext parses the port's rendering back to
    the recorded values. Tolerance: none (exact, NaN equal to NaN)."""
    got_t, got_j = ttele.Telemetry.memory("x"), jtele.Telemetry.memory("x")
    for tele in (got_t, got_j):
        _record(tele)
    text_t = texpo.render_prometheus(got_t)
    text_j = jexpo.render_prometheus(got_j)
    fam_t = promtext.parse_prometheus(text_t)
    fam_j = promtext.parse_prometheus(text_j)
    ages_t = fam_t.pop("gauge_age_seconds")
    ages_j = fam_j.pop("gauge_age_seconds")
    assert [lab for lab, _ in ages_t] == [lab for lab, _ in ages_j]
    assert _norm(fam_t) == _norm(fam_j)
    assert text_t.splitlines()[0] == text_j.splitlines()[0]
    assert promtext.scalar(fam_t, "train_steps") == 3.0
    assert promtext.scalar(fam_t, "train_loss") == 1.25
    assert promtext.labeled(fam_t, "train_step_ms", quantile="0.5") == 3.0
    assert promtext.scalar(fam_t, "train_step_ms_count") == 5.0
    assert math.isnan(promtext.scalar(fam_t, "serve_queue_depth"))
    rates = promtext.CounterRates()
    assert rates.advance(0.0, fam_t)("train_steps") is None
    got_t.count("train/steps", 6)
    rate = rates.advance(2.0, promtext.parse_prometheus(
        texpo.render_prometheus(got_t)))
    assert rate("train_steps") == 3.0 and rates.restarted == []


def _series(scenario, tick):
    """(gauges, counters, timers) of one tick of a scenario."""
    if scenario == "nan_loss":
        loss = float("nan") if 5 <= tick < 8 else 2.0 - 0.01 * tick
        return {"train/loss": loss}, {"train/examples": 100 * tick}, \
            {"train/step_ms": 10.0}
    if scenario == "loss_spike":
        loss = 100.0 if tick == 14 else 1.0 + 0.001 * (tick % 3)
        return {"train/loss": loss}, {"train/examples": 100 * tick}, \
            {"train/step_ms": 10.0}
    if scenario == "throughput_drop":
        ex = 1000 * tick if tick < 10 else 9000 + 100 * tick
        return {"train/loss": 1.0}, {"train/examples": ex}, \
            {"train/step_ms": 10.0, "train/infeed_wait_ms": 1.0}
    # shed burn rate: half the submissions shed from tick 12 on
    shed = 0 if tick < 12 else 5 * (tick - 11)
    return {}, {"serve/requests": 10 * tick, "serve/shed": shed,
                "serve/cache_hit": 8 * tick, "serve/cache_miss": 2 * tick}, \
        {"serve/request_ms": 3.0}


def _drive(side, scenario, ticks, step_s):
    tele_mod, health_mod, alerts_mod = side
    clock = [0.0]
    tele = tele_mod.Telemetry.memory("run")
    serving = scenario == "shed_burn_rate"
    health = health_mod.HealthEngine(tele, interval_s=1.0,
                                     clock=lambda: clock[0])
    health.add(*(health_mod.default_serving_monitors() if serving
                 else health_mod.default_train_monitors()))
    rules = (alerts_mod.default_serving_rules() if serving
             else alerts_mod.default_train_rules())
    alerts = alerts_mod.AlertEngine(tele, rules, mode="warn",
                                    clock=lambda: clock[0])
    health.add_listener(alerts.evaluate)
    rows, transitions = [], []
    counts = {}
    for tick in range(ticks):
        clock[0] = tick * step_s
        gauges, counters, timers = _series(scenario, tick)
        for k, v in gauges.items():
            tele.gauge(k, v, emit=False)
        for k, v in counters.items():
            tele.count(k, v - counts.get(k, 0))
            counts[k] = v
        for k, v in timers.items():
            tele.record_ms(k, v)
        rows.append(health.check_now())
        transitions.append([(r["rule"], r["state"])
                            for r in alerts.status_table()])
    return rows, transitions


@pytest.mark.parametrize("scenario,ticks,step_s,rule", [
    ("nan_loss", 12, 1.0, "loss_nonfinite"),
    ("loss_spike", 20, 1.0, "loss_spike"),
    ("throughput_drop", 30, 1.0, "throughput_regression"),
    ("shed_burn_rate", 60, 10.0, "shed_burn_rate"),
])
def test_health_and_alerts_match_jax_under_one_fake_clock(scenario, ticks,
                                                           step_s, rule):
    """The same series under the same fake clock: every monitor's status
    row and every rule's state at every tick equal the JAX package's,
    and the scenario's rule goes through pending or straight to firing
    (ok -> firing -> ok for the NaN, the spike and the drop back). Tolerance:
    none (rows compared exactly, NaN equal to NaN)."""
    got = _drive((ttele, thealth, talerts), scenario, ticks, step_s)
    want = _drive((jtele, jhealth, jalerts), scenario, ticks, step_s)
    assert _norm(got[0]) == _norm(want[0])
    assert got[1] == want[1]
    states = [dict(t)[rule] for t in got[1]]
    assert "firing" in states, states
    if scenario in ("nan_loss", "loss_spike"):
        assert states[-1] == "ok", states


def test_opt_efficiency_and_phase_roofline_report_no_data():
    """Before a floor gauge and a sampled phase step are published (a
    dense run, profiling off), both monitors stay unknown with the JAX
    package's no-data details, while the step timer is fed. Tolerance:
    none."""
    tele = ttele.Telemetry.memory("train")
    for _ in range(5):
        tele.record_ms("train/step_ms", 30.0)
    monitors = {m.name: m for m in thealth.default_train_monitors()}
    for name in ("opt_efficiency", "phase_coverage"):
        monitors[name].evaluate(tele, 1.0)
    assert monitors["opt_efficiency"].row()["status"] == "unknown"
    assert monitors["opt_efficiency"].detail == \
        "no step-floor gauge published"
    assert monitors["phase_coverage"].row()["status"] == "unknown"
    assert monitors["phase_coverage"].detail == \
        "no sampled phase-split step yet"
    assert math.isnan(tele.gauges["health/opt_efficiency"])
    assert thealth.DEVICE_PHASES == (
        "embed_gather", "concat_dense", "forward_pool", "backward",
        "table_apply", "backward_apply")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("plane_data")
    return build_tiny_dataset(str(d), n_train=64, n_val=16, n_test=16,
                              max_contexts=C)


def _trainer(dataset, **kw):
    vocabs = Code2VecVocabs.load_from_dict_file(dataset + ".dict.c2v",
                                                1000, 1000, 1000)
    cfg = Config(MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E,
                 TRAIN_BATCH_SIZE=16, TEST_BATCH_SIZE=16, USE_BF16=False,
                 LEARNING_RATE=0.05, **kw)
    return Code2VecTrainer(cfg, vocabs, device="cpu")


def _paced(trainer, seconds):
    real = trainer.train_step

    def step(batch, draws=None):
        time.sleep(seconds)
        return real(batch, draws)
    trainer.train_step = step


def test_train_run_is_scraped_while_it_runs(dataset):
    """4 CPU steps with `--metrics_port` (an in-memory registry: no
    --telemetry_dir): a thread's scrapes during the run parse, hold the
    step families, and /healthz answers 200; the port is closed after
    the run. Tolerance: none
    (families and status codes)."""
    port = _free_port()
    trainer = _trainer(dataset, METRICS_PORT=port)
    _paced(trainer, 0.25)
    seen = {}

    def scrape():
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and "steps" not in seen:
            try:
                status, text = _get(port, "/metrics", timeout=1.0)
            except (urllib.error.URLError, OSError):
                time.sleep(0.05)
                continue
            fam = promtext.parse_prometheus(text)
            if promtext.scalar(fam, "train_steps"):
                seen["steps"] = promtext.scalar(fam, "train_steps")
                seen["families"] = set(fam)
                seen["healthz"] = _get(port, "/healthz")
                seen["vars"] = json.loads(_get(port, "/vars")[1])
            time.sleep(0.05)

    t = threading.Thread(target=scrape)
    t.start()
    losses = trainer.train(dataset + ".train.c2v", epochs=1)
    t.join(timeout=60)
    assert not t.is_alive()
    assert len(losses) == 4
    assert seen.get("steps", 0) >= 1, seen
    assert {"train_loss", "train_step_ms", "train_examples",
            "health_status"} <= seen["families"]
    status, body = seen["healthz"]
    assert status == 200 and json.loads(body)["status"] == "ok"
    assert seen["vars"]["identity"]["devices"]["platform"] == "cpu"
    assert seen["vars"]["identity"]["process_count"] == 1
    with pytest.raises((urllib.error.URLError, OSError)):
        _get(port, "/metrics", timeout=0.5)


def test_nan_loss_under_alerts_raise_ends_the_run(dataset, tmp_path):
    """`train/nan_loss` from step 2 on under `--alerts_mode raise`: the
    run ends with the port's AlertError naming loss_nonfinite, raised by
    the loop (steps were recorded after the NaN), with one firing
    `alert` event in the event log. Tolerance:
    none."""
    trainer = _trainer(dataset, TELEMETRY_DIR=str(tmp_path / "tele"),
                       ALERTS_MODE="raise", HEALTH_EVERY_S=0.05)
    _paced(trainer, 0.03)
    faults.install('{"sites": {"train/nan_loss": '
                   '{"action": "nan", "at": 2, "times": -1}}}')
    try:
        with pytest.raises(talerts.AlertError, match="loss_nonfinite"):
            trainer.train(dataset + ".train.c2v", epochs=20)
    finally:
        faults.clear()
    (run,) = os.listdir(tmp_path / "tele")
    with open(tmp_path / "tele" / run / "events.jsonl") as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    firing = [e for e in events if e["kind"] == "alert"
              and e["transition"] == "firing"]
    assert [e["rule"] for e in firing] == ["loss_nonfinite"]
    steps = [e for e in events if e["kind"] == "step"]
    assert len(steps) >= 2 and not math.isfinite(steps[-1]["loss"])


def test_cli_takes_the_plane_flags(dataset, tmp_path):
    """`python3 -m code2vec_tpu_torch ... --metrics_port P --alerts_mode
    warn` trains and exits 0; the port is free again after. Tolerance: none."""
    port = _free_port()
    rc = cli.main(["--data", dataset, "--backend", "cpu", "--max_contexts",
                   str(C), "--batch_size", "16", "--epochs", "1",
                   "--telemetry_dir", str(tmp_path / "t"), "--metrics_port",
                   str(port), "--alerts_mode", "warn"])
    assert rc == 0
    with pytest.raises((urllib.error.URLError, OSError)):
        _get(port, "/healthz", timeout=0.5)


def test_prediction_server_serves_healthz_and_closes_its_port(dataset):
    """A CPU PredictionServer with --metrics_port: /healthz 200 with the
    batcher's heartbeat among its components when a watchdog runs, the
    serving monitors in /vars, and the port refused after close().
    Tolerance: none."""
    port = _free_port()
    trainer = _trainer(dataset)
    cfg = trainer.config
    cfg.METRICS_PORT = port
    server = PredictionServer(cfg, trainer.predictor())
    assert server.metrics_server.enabled and server.health.enabled
    assert not server.alerts.enabled
    server.start(warmup=False)
    try:
        status, body = _get(port, "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        monitors = {r["monitor"] for r in
                    json.loads(_get(port, "/vars")[1])["health"]}
        assert monitors == {"cache_hit_rate", "shed_rate"}
    finally:
        server.close()
    with pytest.raises((urllib.error.URLError, OSError)):
        _get(port, "/healthz", timeout=0.5)


def test_healthz_flips_on_a_stalled_component():
    """/healthz reads the watchdog's heartbeat table at request time: a
    component past its deadline gives 503 naming it, its next beat 200
    (the JAX package's test_healthz_flips_on_injected_infeed_stall). Tolerance:
    none."""
    from code2vec_tpu_torch.obs.watchdog import Watchdog
    clock = [0.0]
    tele = ttele.Telemetry.memory("serve")
    tele.run_dir = None
    wd = Watchdog(tele, stall_s=5.0, clock=lambda: clock[0])
    hb = wd.register("infeed_producer")
    hb.beat()
    srv = texpo.MetricsServer(tele, port=0, watchdog=wd).start()
    try:
        assert _get(srv.bound_port, "/healthz")[0] == 200
        clock[0] = 10.0
        status, body = _get(srv.bound_port, "/healthz")
        assert status == 503
        assert json.loads(body)["stalled"] == ["infeed_producer"]
        hb.beat()
        assert _get(srv.bound_port, "/healthz")[0] == 200
        clock_body = json.loads(_get(srv.bound_port, "/clock?commit=1"
                                     "&offset_s=0.5")[1])
        assert clock_body["committed"] is False  # a memory registry
    finally:
        srv.stop()


def test_update_manifest_merges_into_the_run_manifest(tmp_path):
    """Telemetry.update_manifest (the /clock commit's write) merges
    fields into manifest.json, as the JAX package's does; a memory
    registry has nothing to update.
    Tolerance: none."""
    for mod in (ttele, jtele):
        tele = mod.Telemetry.create(str(tmp_path / mod.__name__))
        assert tele.update_manifest(clock={"wall_offset_s": 0.25})
        with open(os.path.join(tele.run_dir, "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["clock"] == {"wall_offset_s": 0.25}
        tele.close()
        assert not mod.Telemetry.memory("m").update_manifest(x=1)


def test_kernel_selection_maps_like_the_jax_flags():
    """auto|fused|reference -> None|True|False as the JAX package maps
    them; on the CPU `fused` raises naming the flag, the rest choose
    the wrapper (auto) or the plain version (reference). Tolerance:
    none."""
    from code2vec_tpu.ops.quant import resolve_tristate_mode as jresolve
    from code2vec_tpu_torch.ops.quant import (kernel_choice,
                                              resolve_tristate_mode)
    for mode in ("auto", "fused", "reference"):
        assert resolve_tristate_mode(mode, "X") == jresolve(mode, "X")
    with pytest.raises(ValueError, match="X"):
        resolve_tristate_mode("sometimes", "X")
    assert kernel_choice("auto", "--requant_pallas", "cpu") is True
    assert kernel_choice("reference", "--requant_pallas", "cpu") is False
    with pytest.raises(ValueError, match="--requant_pallas"):
        kernel_choice("fused", "--requant_pallas", torch.device("cpu"))


def test_kernel_selection_reaches_the_steps(dataset, monkeypatch, caplog):
    """--no_pallas, --requant_pallas reference and --sparse_update_pallas
    reference reach the trainer's step, its evaluation and its predict
    model as use_kernel=False, and the choice is logged once when the
    trainer is built; the defaults choose the kernels' wrappers.
    Tolerance: none."""
    import logging

    import code2vec_tpu_torch.models.torch_model as tm
    seen = []
    real_eval = tm.eval_step

    def eval_step(*a, **k):
        seen.append(k["use_kernel"])
        return real_eval(*a, **k)
    monkeypatch.setattr(tm, "eval_step", eval_step)
    caplog.set_level(logging.INFO, logger="code2vec_tpu_torch")
    off = _trainer(dataset, USE_PALLAS=False, REQUANT_PALLAS="reference",
                   SPARSE_UPDATE_PALLAS="reference")
    on = _trainer(dataset)
    assert (off.use_kernel, off.requant_kernel, off.row_kernel) == (
        False, False, False)
    assert (on.use_kernel, on.requant_kernel, on.row_kernel) == (
        True, True, True)
    assert not off.predictor().use_kernel and on.predictor().use_kernel
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("kernels on cpu")]
    assert len(lines) == 2 and "(1-3) plain version;" in lines[0]
    assert "plain version (cpu)" in lines[1]
    off.evaluate(dataset + ".val.c2v")
    on.evaluate(dataset + ".val.c2v")
    assert seen[0] is False and seen[-1] is True

"""The port's serving tools (code2vec_tpu_torch/tools/loadgen.py,
serving_bench.py, obs_top.py and chaos.py's serve_swap_kill leg) against
the JAX package's tools/, on the CPU (`--backend cpu`).

- `gen_corpus` and `run_load`'s arrival schedule (the corpus index of
  each arrival and the gap before the next) are the JAX tool's, byte for
  byte, for the same seed: the clock is a fake one that only the sleeps
  move, so each gap is read exactly.
- `serving_bench` and the `serve_swap_kill` leg run to their contracts
  at the JAX tools' tiny configuration.
- `obs_top` renders one pair of scrapes, and one fleet aggregate, as the
  JAX tool does, character for character.
- On the card (the `cuda` marker; skipped here), the mixing check of
  chip_smoke.py's fleet phase at the tiny size.

Tolerance: none anywhere in this file (strings, floats by repr, counts),
except the card test's, stated there.
"""

import importlib.util
import json
import os
import tempfile
import threading
import time

import pytest
import torch

from code2vec_tpu_torch.obs import Telemetry
from code2vec_tpu_torch.obs.exposition import render_prometheus
from code2vec_tpu_torch.tools import chaos, loadgen, obs_top, serving_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tmpdir():
    return tempfile.mkdtemp(prefix="serving_tools_")


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_loadgen():
    return _load_tool("loadgen")


@pytest.fixture(scope="module")
def jax_obs_top():
    return _load_tool("obs_top")


@pytest.mark.parametrize("n,methods,max_ctx,seed,distinct", [
    (8, 1, 12, 0, True), (16, 2, 12, 3, True), (5, 3, 7, 11, False),
    (64, 2, 12, 7, True)])
def test_gen_corpus_is_the_jax_tools(jax_loadgen, n, methods, max_ctx, seed,
                                     distinct):
    kw = dict(max_ctx=max_ctx, seed=seed, distinct=distinct)
    got = loadgen.gen_corpus(n, methods, **kw)
    want = jax_loadgen.gen_corpus(n, methods, **kw)
    assert json.dumps(got) == json.dumps(want)


class _FakeTime:
    """`perf_counter` that only `sleep` moves: each sleep is one gap of
    the schedule, read exactly."""

    def __init__(self):
        self.now = 1000.0
        self.sleeps = []

    def perf_counter(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s


class _RecordingServer:
    def __init__(self):
        self.telemetry = Telemetry.memory("schedule").make_threadsafe()
        self.seen = []

    def predict_lines(self, lines, deadline_ms=None):
        self.seen.append(lines[0])
        return []


@pytest.mark.parametrize("arrivals,modulation,hot", [
    ("poisson", None, 0.25), ("fixed", None, 0.0), ("poisson", "diurnal", 0.5),
    ("fixed", "bursty", 0.25), ("poisson", "bursty", 0.0)])
def test_run_load_schedule_is_the_jax_tools(jax_loadgen, monkeypatch,
                                            arrivals, modulation, hot):
    """One worker, so calls land in arrival order; the JAX tool and the
    port's draw the same hot-key redirections and the same gaps."""
    corpus = loadgen.gen_corpus(40, 1, seed=2)
    runs = []
    for mod in (jax_loadgen, loadgen):
        fake = _FakeTime()
        monkeypatch.setattr(mod, "time", fake)
        server = _RecordingServer()
        rep = mod.run_load(server, corpus, mode="open", concurrency=1,
                           qps=120.0, arrivals=arrivals,
                           modulation=modulation, modulation_period_s=0.2,
                           hot_key_frac=hot, hot_keys=8, seed=5)
        runs.append((server.seen, [repr(s) for s in fake.sleeps],
                     rep["requests"], rep["ok"]))
    assert runs[0] == runs[1]
    assert runs[1][2] == runs[1][3] == len(corpus)
    if hot:
        assert len(set(runs[1][0])) < len(corpus)  # some re-asks


def test_serving_bench_runs_on_the_cpu(capsys):
    assert serving_bench.main(["--backend", "cpu", "--requests", "48",
                               "--qps", "200"]) == 0
    out = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert out["errors"] == 0
    assert out["requests"] == out["ok"] + out["shed"] == 48
    assert out["new_compilations_under_load"] == 0
    assert out["pool"] == {"size": 2, "ready": 2, "generation": 0}
    assert out["backend"] == "cpu" and out["serving_p99_ms"] > 0


def test_chaos_serve_swap_kill_on_the_cpu(tmp_path):
    """The JAX leg's pass conditions (tools/chaos.py), all of them."""
    result = chaos.scenario_serve_swap_kill(str(tmp_path), backend="cpu")
    assert result["ok"], json.dumps(result, indent=1)
    assert (result["replica_dead"], result["replica_refill"],
            result["swapped_step"], result["refused_steps"],
            result["pool_generation"]) == (1, 1, 1, [2], 1)
    assert result["refused_alert_state"] == "firing"
    assert result["new_compilations_under_load"] == 0


@pytest.mark.parametrize("tool,argv", [
    (loadgen, ["--mode", "open", "--requests", "4"]),
    (serving_bench, ["--requests", "4"]),
    (chaos, ["serve_swap_kill"])])
def test_tools_exit_2_without_a_card(tool, argv, monkeypatch, capsys):
    """`--backend gpu` is the default and needs CUDA: without it the
    tools exit 2 and say so, never serving on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(argv) == 2
    assert "CUDA" in capsys.readouterr().err


def _scrapes():
    """Two /metrics payloads of one serving registry, a second apart in
    its counters."""
    tele = Telemetry.memory("obs-top")
    tele.count("serve/requests", 100)
    tele.gauge("serve/queue_depth", 3)
    tele.gauge("train_max_contexts", 200)
    for ms in (3.0, 5.0, 40.0):
        tele.record_ms("serve/request_ms", ms)
        tele.record_ms("train/phase/backward_ms", ms)
    first = render_prometheus(tele)
    tele.count("serve/requests", 60)
    tele.count("train/examples", 2048)
    tele.count("train/steps", 2)
    tele.gauge("train/loss", 4.25)
    return first, render_prometheus(tele)


def test_obs_top_renders_as_the_jax_tool(jax_obs_top, monkeypatch):
    texts = _scrapes()
    frames = []
    for mod in (jax_obs_top, obs_top):
        clock = iter([10.0, 12.0])

        class FakeTime:
            monotonic = staticmethod(lambda: next(clock))
            strftime = staticmethod(lambda fmt: "12:00:00")
            sleep = staticmethod(time.sleep)

        monkeypatch.setattr(mod, "time", FakeTime)
        payloads = iter(texts)
        monkeypatch.setattr(mod, "scrape", lambda endpoint, parse=mod.
                            parse_prometheus: parse(next(payloads)))
        state = mod.EndpointState("host:9100")
        state.poll(60.0)
        frames.append(mod.render([state.poll(60.0),
                                  {"endpoint": "down:1", "error": "refused"}]))
        frames.append(mod.render_fleet({
            "cohort": {"hosts_up": 1, "hosts_total": 2, "pc_per_sec": 1e6,
                       "straggler_score": 1.5, "straggler_host": "a:1",
                       "straggler_series": "step_ms", "divergence": False,
                       "clock_spread_s": 0.002},
            "hosts": [{"endpoint": "a:1", "up": True, "steps": 8,
                       "ex_s": 10.0, "pc_s": 2000.0, "step_p50": 3.5,
                       "infeed_p50": 0.1, "loss": 1.0,
                       "straggler_score": 1.5,
                       "straggler_series": "step_ms",
                       "clock_offset_s": 0.0004, "restarted": True,
                       "phases": {"backward": 2.0}},
                      {"endpoint": "b:1", "up": False,
                       "error": "timeout"}]}))
    assert frames[:2] == frames[2:]
    assert "req/s (sum) 30.0" in frames[2]


def test_obs_top_once_over_a_live_front_end(capsys):
    """`--once` against the fleet's front end: two polls, one frame with
    the host up."""
    from code2vec_tpu_torch.serving import ReplicaPool, ServingFrontend
    cfg = loadgen.tiny_config(_tmpdir())
    cfg.SERVE_BATCH_MAX = 4
    pool = ReplicaPool(cfg, loadgen.model_factory(cfg, "cpu"),
                       replicas=1).start()
    fe = ServingFrontend(pool, port=0, telemetry=pool.telemetry).start()
    try:
        pool.predict_lines(loadgen.gen_corpus(1, 1)[0])
        assert obs_top.main([f"127.0.0.1:{fe.bound_port}", "--once",
                             "--interval", "0.05"]) == 0
        frame = capsys.readouterr().out
        assert "1/1 hosts up" in frame and "DOWN" not in frame
    finally:
        fe.stop()
        pool.close()


@pytest.mark.cuda
def test_no_mixed_weights_across_a_swap_on_the_card():
    """chip_smoke.py's fleet check at the tiny size on the card: hot keys
    over HTTP while a 2-replica pool swaps to other weights. A response
    to a request sent before the swap began and done before it equals
    the old weights' answer; one sent after the last replica swapped
    equals the new weights'; every other one equals one of the two.
    Tolerance: top-k names equal, probabilities within 1e-5 (float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    from code2vec_tpu_torch.serving import (PredictionServer, ReplicaPool,
                                            ServingFrontend)
    from code2vec_tpu_torch.serving.frontend import serialize_prediction
    cfg = loadgen.tiny_config(_tmpdir())
    cfg.SERVE_REPLICAS = 2
    old_factory = loadgen.model_factory(cfg, None)
    cfg1 = loadgen.tiny_config(_tmpdir())
    cfg1.SEED = cfg.SEED + 1
    new_params = loadgen.model_factory(cfg1, None)().params
    pool = ReplicaPool(cfg, old_factory, replicas=2).start()
    fe = ServingFrontend(pool, port=0, telemetry=pool.telemetry).start()
    hot = loadgen.gen_corpus(8, 1, seed=1)
    refs = []
    for params in (None, new_params):
        model = old_factory()
        if params is not None:
            model.params = params
        with PredictionServer(cfg, model) as server:
            refs.append([serialize_prediction(server.predict_lines(r)[0])
                         for r in hot])
    client = serving_bench.HttpPredictClient(
        f"http://127.0.0.1:{fe.bound_port}", pool.telemetry)
    seen, window = [], {}
    orig = pool.swap_params

    def timed_swap(params, generation):
        window["start"] = time.perf_counter()
        orig(params, generation)
        window["end"] = time.perf_counter()
    pool.swap_params = timed_swap

    def same(got, want):
        return ([p["name"] for p in got["predictions"]]
                == [p["name"] for p in want["predictions"]]
                and all(abs(a["probability"] - b["probability"]) <= 1e-5
                        for a, b in zip(got["predictions"],
                                        want["predictions"])))

    def client_loop():
        for i in range(400):
            k = i % len(hot)
            t0 = time.perf_counter()
            got = client.predict_lines(hot[k])[0]
            seen.append((k, t0, time.perf_counter(), got))

    try:
        t = threading.Thread(target=client_loop)
        t.start()
        time.sleep(0.2)
        pool.swap_params(new_params, generation=1)
        t.join(timeout=120)
        assert window and len(seen) == 400
        for k, sent, done, got in seen:
            if done < window["start"]:
                assert same(got, refs[0][k])
            elif sent > window["end"]:
                assert same(got, refs[1][k])
            else:
                assert same(got, refs[0][k]) or same(got, refs[1][k])
        assert any(sent > window["end"] for _, sent, _, _ in seen)
    finally:
        fe.stop()
        pool.close()

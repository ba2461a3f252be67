"""The port's serving fleet (code2vec_tpu_torch/serving/replicas.py,
reload.py, autoscale.py, frontend.py, the cache generations of server.py
and the seven serving flags) against the JAX package's, on the CPU.

Both packages' classes run side by side on the same weights: a JAX model
over a synthetic vocabulary (about 1000 words: 800 tokens, 300 paths,
200 method names), its params carried into the port with `convert.py`
(float32 tables and compute, E = 16, C = 16, SERVE_BATCH_MAX 4), the
same raw lines (some over the context cap) through a 2-replica pool of
each package.

Tolerances: float32 compute, as tests/test_torch_serving.py states:
probabilities and attention scores within 1e-5 of the JAX ones; top-k
names equal wherever neighbouring probabilities are further apart than
twice that. Two replicas of the port on one set of weights answer with
the same bits (one device, one batch shape). Cache contents, pool
tables, autoscaler decisions, flag values and error texts: exact.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import textwrap
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.common import MethodPredictionResults as JaxResults
from code2vec_tpu.config import Config as JaxConfig
from code2vec_tpu.data import preprocess as jpreprocess
from code2vec_tpu.models.jax_model import Code2VecModel as JaxModel
from code2vec_tpu.obs import Telemetry as JaxTelemetry
from code2vec_tpu.obs.alerts import AlertRule as JaxAlertRule
from code2vec_tpu.obs.alerts import serving_slo_rules as jax_slo_rules
from code2vec_tpu.serving import AutoScaler as JaxAutoScaler
from code2vec_tpu.serving import PredictionCache as JaxCache
from code2vec_tpu.serving import ReplicaPool as JaxPool
from code2vec_tpu.serving import ServingFrontend as JaxFrontend
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.common import MethodPredictionResults
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.models.torch_model import Code2VecModel
from code2vec_tpu_torch.obs import Telemetry
from code2vec_tpu_torch.obs.alerts import AlertRule, serving_slo_rules
from code2vec_tpu_torch.obs.promtext import parse_prometheus, scalar
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.resilience import retry as retry_mod
from code2vec_tpu_torch.serving import (AutoScaler, PredictionCache,
                                        ReloadManager, ReplicaPool,
                                        ServerOverloaded, ServingFrontend)
from code2vec_tpu_torch.serving.frontend import serialize_prediction
from code2vec_tpu_torch.serving.reload import verify_step_files
from code2vec_tpu_torch.tools import loadgen
from code2vec_tpu_torch.training import checkpoint as ckpt
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
from test_model import tiny_config
from torch_helpers import assert_topk_agree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, E, BATCH_MAX = 16, 16, 4
TOL = 1e-5
SERVE = dict(SERVE_BATCH_MAX=BATCH_MAX, SERVE_BATCH_TIMEOUT_MS=1.0,
             SERVE_QUEUE_DEPTH=64, SERVE_DEADLINE_MS=0.0,
             SERVE_CACHE_SIZE=64, SERVE_REPLICAS=2, SERVE_MIN_REPLICAS=1,
             SERVE_MAX_REPLICAS=3)


def raw_lines(n, seed, max_ctx=24):
    """Extractor-format lines over a vocabulary of about 1000 words (800
    tokens, 300 paths, 200 names), some over the C = 16 cap."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        k = int(rng.integers(200))
        ctxs = [f"t{(k * 4 + int(rng.integers(8))) % 800},"
                f"{1000 + (k + int(rng.integers(3))) % 300},"
                f"t{int(rng.integers(800))}"
                for _ in range(int(rng.integers(2, max_ctx)))]
        lines.append(f"name|n{k} " + " ".join(ctxs))
    return lines


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A JAX model's vocabs and params (target table sharpened so names
    separate), a second weight set, and both packages' configs."""
    d = tmp_path_factory.mktemp("fleet")
    raw = str(d / "raw.txt")
    with open(raw, "w") as f:
        f.write("\n".join(raw_lines(2000, seed=1)) + "\n")
    prefix = str(d / "fleet")
    jpreprocess.main(["--train_data", raw, "--val_data", raw, "--test_data",
                      raw, "--max_contexts", str(C), "--word_vocab_size",
                      "1000", "--path_vocab_size", "1000",
                      "--target_vocab_size", "1000", "--output_name", prefix])
    # one device on the data axis, as the port serves: the JAX buckets
    # are then the port's (an 8-device mesh pads every batch to 8)
    jcfg = tiny_config(prefix, MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E,
                       TABLES_DTYPE="float32", USE_BF16=False,
                       MESH_DATA_AXIS=1, **SERVE)
    jmodel = JaxModel(jcfg)
    vocab_path = str(d / "vocab.pkl")
    jmodel.vocabs.save(vocab_path)
    p0 = jax.tree_util.tree_map(np.asarray, jax.device_get(jmodel.params))
    p0["target_emb"] = p0["target_emb"] * 10.0
    rng = np.random.default_rng(7)
    p1 = {k: (v + rng.normal(0, 0.5, v.shape)).astype(v.dtype)
          for k, v in p0.items()}
    tcfg = Config(MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E,
                  TABLES_DTYPE="float32", USE_BF16=False, **SERVE)
    tcfg.train_data_path = prefix
    return dict(dir=d, jcfg=jcfg, jmodel=jmodel, tcfg=tcfg,
                dims=tenc.ModelDims(**dataclasses.asdict(jmodel.dims)),
                vocabs=Code2VecVocabs.load(vocab_path), p0=p0, p1=p1)


def jax_placed(template, params):
    """Host `params` placed as the JAX `template` tree (its mesh's
    shardings)."""
    return jax.tree_util.tree_map(
        lambda old, new: jax.device_put(jnp.asarray(new), old.sharding),
        template, params)


def jax_factory(world, params):
    def build():
        m = JaxModel(world["jcfg"])
        m.params = jax_placed(m.params, params)
        return m
    return build


def torch_params(params):
    return convert.params_from_numpy(params, device="cpu")


def torch_factory(world, params):
    return lambda: Code2VecModel(world["tcfg"], world["dims"],
                                 world["vocabs"], torch_params(params),
                                 device="cpu")


def _norm(r):
    """One method's answer as the front end's JSON (either package's
    result object, or a JSON dict already)."""
    if isinstance(r, dict):
        return r
    return serialize_prediction(r)


def assert_answers_agree(got, want):
    """Names, probabilities and attention paths of two answers (lists of
    methods) within the module's tolerance."""
    assert len(got) == len(want)
    checked = 0
    for g, w in zip(map(_norm, got), map(_norm, want)):
        assert g["original_name"] == w["original_name"]
        assert len(g["predictions"]) == len(w["predictions"])
        names = {}
        ids = [[names.setdefault("|".join(p["name"]), len(names))
                for p in r["predictions"]] for r in (g, w)]
        probs = [[p["probability"] for p in r["predictions"]]
                 for r in (g, w)]
        checked += assert_topk_agree(np.array(ids[:1]), np.array(probs[:1]),
                                     np.array(ids[1:]), np.array(probs[1:]),
                                     TOL)
        key = [sorted(((a["source_token"], a["path"], a["target_token"]),
                       a["attention_score"]) for a in r["attention_paths"])
               for r in (g, w)]
        assert [k for k, _ in key[0]] == [k for k, _ in key[1]]
        np.testing.assert_allclose([s for _, s in key[0]],
                                   [s for _, s in key[1]], atol=TOL)
    assert checked >= 2 * len(got)  # most names separate enough to check


def requests(seed, n=10):
    lines = raw_lines(3 * n, seed=seed)
    return [lines[i:i + 1 + i % 3] for i in range(0, 3 * n, 3)]


@pytest.fixture
def pools(world):
    jtele = JaxTelemetry.memory("jax-fleet").make_threadsafe()
    ttele = Telemetry.memory("torch-fleet").make_threadsafe()
    jpool = JaxPool(world["jcfg"], jax_factory(world, world["p0"]),
                    replicas=2, telemetry=jtele).start()
    tpool = ReplicaPool(world["tcfg"], torch_factory(world, world["p0"]),
                        replicas=2, telemetry=ttele).start()
    try:
        yield jpool, tpool
    finally:
        jpool.close()
        tpool.close()


def _concurrently(pool, reqs):
    out, errors = [None] * len(reqs), []

    def client(k):
        try:
            for i in range(k, len(reqs), 4):
                out[i] = pool.predict_lines(reqs[i])
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    return out


# ---- the cache's generations ----

def test_cache_generations_match_jax():
    """One op sequence through both caches gives the same answers, the
    same sizes and generations. Tolerance: none."""
    ops = [("put", "a", 1, 0), ("get", "a", 0), ("get", "a", None),
           ("put", "b", 2, None), ("inv", 5), ("get", "a", 0),
           ("get", "a", None), ("put", "a", 3, 0), ("put", "c", 4, 5),
           ("get", "c", 5), ("get", "c", 0), ("put", "d", 5, 5),
           ("put", "e", 6, 5), ("get", "c", None), ("inv", 6),
           ("put", "f", 7, None), ("get", "f", 6)]
    seen = []
    for cache in (JaxCache(2), PredictionCache(2)):
        trace = []
        for op in ops:
            if op[0] == "put":
                cache.put(op[1], op[2], generation=op[3])
            elif op[0] == "get":
                trace.append(cache.get(op[1], generation=op[2]))
            else:
                cache.invalidate(op[1])
            trace.append((len(cache), cache.generation))
        seen.append(trace)
    assert seen[0] == seen[1]
    # capacity 0 stores nothing in either
    assert PredictionCache(0).get("a") is None


# ---- the pool on real models ----

def test_pools_of_both_packages_answer_alike(world, pools):
    jpool, tpool = pools
    reqs = requests(seed=3)
    got = _concurrently(tpool, reqs)
    want = [jpool.predict_lines(r) for r in reqs]
    for g, w in zip(got, want):
        assert_answers_agree(g, w)
    jt, tt = jpool.pool_table(), tpool.pool_table()
    assert sorted(tt) == sorted(jt)
    assert sorted(tt["replicas"][0]) == sorted(jt["replicas"][0])
    assert (tt["size"], tt["ready"], tt["generation"]) == (2, 2, 0)
    assert sum(r["requests"] for r in tt["replicas"]) == len(reqs)
    assert tpool.compile_delta() == 0


def test_swap_params_matches_jax_without_stale_entries(world, pools):
    """A swap to the second weight set: both pools answer alike after it,
    as a fresh model on those weights does; the shared cache is empty at
    generation 1 (no entry of the old weights is served), and the pool
    never had fewer than N - 1 = 1 replica ready."""
    jpool, tpool = pools
    reqs = requests(seed=4, n=6)
    before = [tpool.predict_lines(r) for r in reqs]
    ready = []
    orig = tpool._publish

    def spy():
        orig()
        ready.append(tpool.telemetry.gauges.get("serve/pool_ready"))
    tpool._publish = spy
    jpool.swap_params(jax_placed(jpool.params_template(), world["p1"]),
                      generation=1)
    tpool.swap_params(torch_params(world["p1"]), generation=1)
    assert ready and min(ready) >= 1
    table = tpool.pool_table()
    assert (table["generation"], table["cache_generation"],
            table["cache_entries"], table["ready"]) == (1, 1, 0, 2)
    assert all(r["generation"] == 1 and r["swaps"] == 1
               for r in table["replicas"])
    fresh = torch_factory(world, world["p1"])()
    for r, old in zip(reqs, before):
        got = tpool.predict_lines(r)
        assert_answers_agree(got, jpool.predict_lines(r))
        assert_answers_agree(got, fresh.predict(r))
        assert [_norm(x)["predictions"] for x in got] != \
            [_norm(x)["predictions"] for x in old]
    # every replica holds the one swapped-in params object
    objs = {id(rep.server.model.params) for rep in tpool._replicas}
    assert len(objs) == 1


def test_kill_retries_dies_once_refills_and_refill_answers_alike(world):
    """`serve/kill` raises in the replica serving the 2nd request: the
    request is answered anyway, one death, one refill, and the refilled
    replica (built by the tools' factory, a fresh generator seeded from
    the config) holds its peer's weights and answers with its bits."""
    faults.install({"seed": 0, "sites": {
        "serve/kill": {"action": "raise", "at": 2}}}, log=lambda _m: None)
    tele = Telemetry.memory("kill").make_threadsafe()
    pool = ReplicaPool(world["tcfg"], loadgen.model_factory(
        world["tcfg"], "cpu"), replicas=2, telemetry=tele).start()
    try:
        reqs = requests(seed=5, n=4)
        answers = [pool.predict_lines(r) for r in reqs]
        assert all(len(a) == len(r) for a, r in zip(answers, reqs))
        assert tele.counters.get("serve/replica_dead") == 1
        assert pool.wait_ready(2, timeout_s=60)
        for t in list(pool._refill_threads):
            t.join(timeout=60)
        assert tele.counters.get("serve/replica_refill") == 1
        assert pool.compile_delta() == 0
        reps = sorted(pool._replicas, key=lambda r: r.idx)
        assert [r.idx for r in reps] != [0, 1]  # one is the refill
        a, b = (r.server.model for r in reps)
        for k in a.params:
            assert torch.equal(a.params[k], b.params[k]), k
        lines = [ln for r in reqs for ln in r][:BATCH_MAX]
        ra, rb = a.predict(lines), b.predict(lines)
        assert [_norm(x) for x in ra] == [_norm(x) for x in rb]
    finally:
        faults.clear()
        pool.close()


def test_predict_compile_count_is_the_bucket_count_and_stays_flat(world):
    """Warm-up runs the buckets 1, 2, 4 of SERVE_BATCH_MAX 4: three
    signatures, as the JAX model's jit cache holds three compiles; no
    request of 1 to 7 methods adds one."""
    tmodel = torch_factory(world, world["p0"])()
    jmodel = jax_factory(world, world["p0"])()
    assert tmodel.predict_compile_count() == 0
    assert tmodel.warmup_predict(BATCH_MAX) == jmodel.warmup_predict(
        BATCH_MAX) == [1, 2, 4]
    assert tmodel.predict_compile_count() == \
        jmodel.predict_compile_count() == 3
    pool = ReplicaPool(world["tcfg"], lambda: tmodel, replicas=1).start()
    try:
        lines = raw_lines(7, seed=6)
        for n in range(1, 8):
            pool.predict_lines(lines[:n])
        assert tmodel.predict_compile_count() == 3
        assert pool.compile_delta() == 0
        assert pool.pool_table()["replicas"][0]["compiles"] == 3
    finally:
        pool.close()


# ---- hot reload over the port's checkpoints ----

def _save(world, root, step, params):
    ckpt.save_checkpoint(str(root), {"params": torch_params(params)}, step,
                         world["vocabs"], world["dims"])


def test_reload_over_port_checkpoints(world, tmp_path, monkeypatch):
    """Verified steps swap in (the pool then answers as a fresh model on
    those weights, the tables copied in slices of 256 bytes here); a
    flipped byte is refused, once; a committed step without checksums
    waits for them; each refusal is counted."""
    from code2vec_tpu_torch.serving import reload as reload_mod
    monkeypatch.setattr(reload_mod, "_SLICE_BYTES", 256)
    tele = Telemetry.memory("reload").make_threadsafe()
    pool = ReplicaPool(world["tcfg"], torch_factory(world, world["p0"]),
                       replicas=2, telemetry=tele).start()
    rm = ReloadManager(str(tmp_path), pool, telemetry=tele, poll_s=0.05)
    lines = raw_lines(3, seed=8)
    try:
        assert rm.check_now() is None  # nothing committed yet
        _save(world, tmp_path, 1, world["p1"])
        assert verify_step_files(str(tmp_path), 1) is True
        assert rm.check_now() == 1
        assert pool.pool_table()["generation"] == 1
        assert_answers_agree(pool.predict_lines(lines),
                             torch_factory(world, world["p1"])()
                             .predict(lines))
        swapped = pool.params_template()
        for k, t in torch_params(world["p1"]).items():
            assert torch.equal(swapped[k], t), k

        _save(world, tmp_path, 2, world["p0"])
        state = tmp_path / "step_2" / "state" / ckpt.STATE_FILE
        raw = bytearray(state.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        state.write_bytes(bytes(raw))
        assert verify_step_files(str(tmp_path), 2) is False
        assert rm.check_now() is None and rm.refused == {2}
        assert rm.check_now() is None
        assert tele.counters.get("serve/reload_refused") == 1
        assert pool.pool_table()["generation"] == 1

        _save(world, tmp_path, 3, world["p0"])
        os.remove(tmp_path / "step_3" / "checksums.json")
        assert verify_step_files(str(tmp_path), 3) is None
        assert rm.check_now() is None and 3 not in rm.refused
        ckpt.write_step_checksums(str(tmp_path), 3)
        assert rm.check_now() == 3
        assert_answers_agree(pool.predict_lines(lines),
                             torch_factory(world, world["p0"])()
                             .predict(lines))
        assert rm.status() == {"last_step": 3, "refused": [2],
                               "poll_s": 0.05}
    finally:
        rm.stop()
        pool.close()


def test_reload_read_io_error_retries_then_refuses(world, tmp_path):
    """A `reload/read` io_error on every read: the reload policy spends
    its three attempts (two retries), then refuses the step for "io";
    the pool keeps its weights."""
    faults.install({"seed": 0, "sites": {"reload/read": {
        "action": "io_error", "errno": "EIO", "times": -1}}},
        log=lambda _m: None)
    tele = Telemetry.memory("reload-io").make_threadsafe()
    pool = ReplicaPool(world["tcfg"], torch_factory(world, world["p0"]),
                       replicas=1, telemetry=tele).start()
    rm = ReloadManager(str(tmp_path), pool, telemetry=tele, poll_s=0.05)
    before = retry_mod.stats().get("reload-io", {"retries": 0,
                                                 "exhausted": 0})
    try:
        _save(world, tmp_path, 1, world["p1"])
        assert rm.check_now() is None
        assert rm.refused == {1}
        after = retry_mod.stats()["reload-io"]
        assert after["retries"] - before["retries"] == 2
        assert after["exhausted"] - before["exhausted"] == 1
        assert faults.stats()["reload/read"]["fired"] == 3
        assert tele.counters.get("serve/reload_refused") == 1
        assert pool.pool_table()["generation"] == 0
    finally:
        faults.clear()
        rm.stop()
        pool.close()


def test_swap_racing_a_refill_keeps_one_ready_and_rolls_the_refill():
    """A swap that begins while a death's refill is still warming up: the
    pool keeps one replica ready throughout (the swap waits for the
    refill before it drains the last ready one), and the refill, which
    read the old weights before the swap and was not in its roll, joins
    on the new weights at the new generation. (The JAX pool drains its
    last replica and lets the refill serve the old weights.)"""
    warming = threading.Event()
    release = threading.Event()

    class SlowWarmup(_FakeModel):
        def warmup_predict(self, max_batch):
            if self.ordinal >= 2:  # the refill, not the first two
                warming.set()
                assert release.wait(30)
            return [max_batch]

    built = []

    def factory():
        m = SlowWarmup(MethodPredictionResults)
        m.ordinal = len(built)
        built.append(m)
        return m

    faults.install({"seed": 0, "sites": {
        "serve/kill": {"action": "raise", "at": 1}}}, log=lambda _m: None)
    tele = Telemetry.memory("race").make_threadsafe()
    pool = ReplicaPool(Config(**SERVE), factory, replicas=2,
                       telemetry=tele).start()
    ready = []
    orig = pool._publish

    def spy():
        orig()
        ready.append(tele.gauges.get("serve/pool_ready"))
    pool._publish = spy
    try:
        assert pool.predict_lines(["m a,1,b"])[0].predictions[0]["name"] \
            == ["pred", "v0"]
        assert warming.wait(30)  # the refill is building
        swap = threading.Thread(target=pool.swap_params,
                                args=({"tag": "v1"}, 1))
        swap.start()
        swap.join(timeout=0.3)
        assert swap.is_alive()  # waiting for the refill, not draining
        release.set()
        swap.join(timeout=30)
        assert not swap.is_alive()
        assert min(ready) >= 1
        table = pool.pool_table()
        assert (table["size"], table["ready"], table["generation"]) == \
            (2, 2, 1)
        assert all(r["generation"] == 1 for r in table["replicas"])
        assert {rep.server.model.params["tag"]
                for rep in pool._replicas} == {"v1"}
        for line in ("m1 a,1,b", "m2 a,1,b", "m3 a,1,b", "m4 a,1,b"):
            out = pool.predict_lines([line])
            assert out[0].predictions[0]["name"] == ["pred", "v1"]
    finally:
        release.set()
        faults.clear()
        pool.close()


# ---- the autoscaler ----

class _FakePrepared:
    def __init__(self, lines):
        self.lines = list(lines)

    @property
    def n(self):
        return len(self.lines)

    def slice(self, a, b):
        return _FakePrepared(self.lines[a:b])

    @classmethod
    def concat(cls, parts):
        return cls([ln for p in parts for ln in p.lines])


class _FakeModel:
    """The model surface a pool drives; answers `pred|<tag>`."""

    def __init__(self, results_cls, tag="v0"):
        self.results_cls = results_cls
        self.params = {"tag": tag}

    def warmup_predict(self, max_batch):
        return [max_batch]

    def predict_compile_count(self):
        return 1

    def prepare_predict_rows(self, lines):
        for ln in lines:
            if ln.startswith("!"):
                raise ValueError(f"malformed line: {ln!r}")
        return _FakePrepared(lines)

    def predict_device(self, prepared):
        return (list(prepared.lines),)

    def decode_predictions(self, chunk, result):
        out = []
        for ln in result[0]:
            res = self.results_cls(ln.split(" ")[0])
            res.append_prediction("pred|" + self.params["tag"], 0.9)
            res.append_attention_path(0.5, "src", "1,2,3", "dst")
            out.append(res)
        return out


def _fake_pool(jax_side, replicas=1):
    if jax_side:
        cfg = JaxConfig(**SERVE)
        tele = JaxTelemetry.memory("fake").make_threadsafe()
        return JaxPool(cfg, lambda: _FakeModel(JaxResults),
                       replicas=replicas, telemetry=tele).start(), tele
    tele = Telemetry.memory("fake").make_threadsafe()
    return ReplicaPool(Config(**SERVE), lambda: _FakeModel(
        MethodPredictionResults), replicas=replicas,
        telemetry=tele).start(), tele


def _load_series(tele, t, v):
    tele.gauge("load", v, emit=False)


def _latency_series(tele, t, v):
    # a tick's worth of requests that turns the 2048-sample ring over,
    # so the p99 reads this tick's latency
    for _ in range(2048):
        tele.record_ms("serve/request_ms", v)
    tele.count("serve/requests", 2048)


# (when, value) pairs: a burn, a quiet hold, a second burn, quiet again;
# the SLO series burns past the p99 rule's 5 s `for_s`
SERIES = [(0, 5.0), (1, 5.0), (2, 5.0), (3, 5.0), (10, 0.5), (40, 0.5),
          (69, 0.5), (71, 0.5), (72, 0.5), (135, 0.5), (136, 5.0),
          (137, 5.0), (150, 0.5), (211, 0.5), (300, 0.5)]
SLO_SERIES = [(0, 5.0), (3, 5.0), (6, 5.0), (9, 5.0), (12, 0.5),
              (40, 0.5), (73, 0.5), (80, 0.5), (140, 0.5), (150, 5.0),
              (153, 5.0), (156, 5.0), (160, 0.5), (230, 0.5), (300, 0.5)]


@pytest.mark.parametrize("rules,feed,scale,series", [
    ("custom", _load_series, 1.0, SERIES),
    ("slo", _latency_series, 100.0, SLO_SERIES)], ids=["custom", "slo"])
def test_autoscaler_decisions_match_jax(rules, feed, scale, series):
    """Both packages' scalers over one synthetic series and one fake
    clock take the same decisions and reach the same targets: the custom
    page/ticket pair of tests/test_frontend.py, then the shipped SLO
    rules (p99 over 250 ms for 5 s) on recorded request latencies."""
    seqs = []
    for jax_side in (True, False):
        pool, tele = _fake_pool(jax_side)
        clk = [0.0]
        if rules == "custom":
            mk = JaxAlertRule if jax_side else AlertRule
            rule_set = [mk("hot", metric="load", op=">", value=1.0,
                           severity="page"),
                        mk("note", metric="load", op=">", value=0.0,
                           severity="ticket")]
        else:
            rule_set = (jax_slo_rules if jax_side else serving_slo_rules)(
                250.0)
        cls = JaxAutoScaler if jax_side else AutoScaler
        scaler = cls(pool, telemetry=tele, rules=rule_set, hold_s=60.0,
                     clock=lambda: clk[0])
        seq = []
        try:
            for t, v in series:
                clk[0] = float(t)
                feed(tele, t, v * scale)
                seq.append((scaler.tick(), pool.target))
        finally:
            scaler.stop()
            pool.close()
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert ("up", 2) in seqs[1] and ("down", 1) in seqs[1]


# ---- the HTTP front end ----

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        raw = e.read().decode("utf-8")
        try:
            return e.code, json.loads(raw)
        except json.JSONDecodeError:
            return e.code, raw


def test_frontends_answer_predict_alike(world, pools):
    """POST /predict of the same lines to both packages' front ends: the
    same JSON shape, names and probabilities within the tolerance; then
    /healthz, /pool and /metrics of both."""
    jpool, tpool = pools
    jfe = JaxFrontend(jpool, port=0, telemetry=jpool.telemetry).start()
    tfe = ServingFrontend(tpool, port=0, telemetry=tpool.telemetry).start()
    try:
        for r in requests(seed=9, n=4):
            body = json.dumps({"lines": r}).encode()
            (js, jb), (ts, tb) = (
                _post(f"http://127.0.0.1:{fe.bound_port}/predict", body)
                for fe in (jfe, tfe))
            assert js == ts == 200 and sorted(jb) == sorted(tb)
            assert tb["n"] == jb["n"] == len(r)
            for g, w in zip(tb["predictions"], jb["predictions"]):
                assert sorted(g) == sorted(w)
            assert_answers_agree(tb["predictions"], jb["predictions"])
        health = [json.loads(_get(f"http://127.0.0.1:{fe.bound_port}"
                                  "/healthz")[1]) for fe in (jfe, tfe)]
        assert health[0] == health[1]
        tables = [json.loads(_get(f"http://127.0.0.1:{fe.bound_port}"
                                  "/pool")[1]) for fe in (jfe, tfe)]
        assert sorted(tables[0]) == sorted(tables[1])
        status, raw = _get(f"http://127.0.0.1:{tfe.bound_port}/metrics")
        metrics = parse_prometheus(raw.decode("utf-8"))
        assert status == 200
        assert scalar(metrics, "serve_requests") >= 4
        assert scalar(metrics, "serve_pool_ready") == 2
        assert _get(f"http://127.0.0.1:{tfe.bound_port}/nope")[0] == 404
    finally:
        jfe.stop()
        tfe.stop()


class _StubPool:
    telemetry = None

    def __init__(self, exc):
        self.exc = exc

    def predict_lines(self, lines, deadline_ms=None):
        raise self.exc

    def pool_table(self):
        return {"replicas": [], "size": 1, "ready": 1, "target": 1,
                "generation": 0, "cache_entries": 0, "cache_generation": 0}


@pytest.mark.parametrize("body,exc,status", [
    (b'{"lines": ["m a,1,b"]}', ServerOverloaded("queue full"), 429),
    (b'{"lines": ["m a,1,b"]}', ValueError("bad line"), 400),
    (b'{"lines": ["m a,1,b"]}', RuntimeError("device fell over"), 500),
    (b"{not json", None, 400),
    (b'{"lines": "m a,1,b"}', None, 400),
    (b'{"lines": ["m"], "deadline_ms": "soon"}', None, 400)])
def test_frontend_error_mapping(body, exc, status):
    """The JAX front end's mapping: shed 429 with `"shed": true`, client
    errors 400, anything else 500, malformed bodies 400 before the pool;
    each with a JSON error body. Tolerance: none."""
    fe = ServingFrontend(_StubPool(exc or RuntimeError("unreached")),
                         port=0).start()
    try:
        got, reply = _post(f"http://127.0.0.1:{fe.bound_port}/predict", body)
        assert got == status and "error" in reply
        if status == 429:
            assert reply["shed"] is True
        assert _post(f"http://127.0.0.1:{fe.bound_port}/elsewhere",
                     body)[0] == 404
    finally:
        fe.stop()


def test_healthz_gates_on_ready_replicas_and_page_alerts():
    class StubAlerts:
        enabled = True

        def __init__(self, rows):
            self.rows = rows

        def status_table(self):
            return self.rows

    pool, _tele = _fake_pool(jax_side=False)
    ticket = StubAlerts([{"rule": "reload_refused", "state": "firing",
                          "severity": "ticket"}])
    page = StubAlerts([{"rule": "serving_p99_slo", "state": "firing",
                        "severity": "page"}])
    fe = ServingFrontend(pool, port=0, alerts=ticket).start()
    url = f"http://127.0.0.1:{fe.bound_port}/healthz"
    try:
        assert _get(url)[0] == 200  # a ticket never fails readiness
        fe.alerts = page
        status, raw = _get(url)
        assert status == 503
        assert json.loads(raw)["alerts_firing"] == ["serving_p99_slo"]
        fe.alerts = None
        for rep in list(pool._replicas):
            pool._stop_replica(rep, state="stopped")
        status, raw = _get(url)
        assert status == 503 and json.loads(raw)["ready"] == 0
    finally:
        fe.stop()
        pool.close()


def test_disabled_singletons():
    pool, _tele = _fake_pool(jax_side=False)
    try:
        assert not ServingFrontend.create(pool, port=0).enabled
        assert not ServingFrontend.create(None, port=9).enabled
        assert not ReloadManager.create(None, pool, poll_s=1.0).enabled
        assert ReloadManager.disabled().check_now() is None
        assert not AutoScaler.create(pool, enabled=False).enabled
        assert AutoScaler.disabled().tick() is None
    finally:
        pool.close()


# ---- the seven flags ----

GOOD = [[], ["--serve_port", "8080", "--serve_replicas", "2",
             "--serve_min_replicas", "1", "--serve_max_replicas", "3",
             "--serve_slo_ms", "120", "--serve_reload_poll_s", "0.5",
             "--serve_autoscale"],
        ["--serve_replicas", "4", "--serve_max_replicas", "4",
         "--serve_min_replicas", "4"]]
BAD = [["--serve_port", "70000"], ["--serve_port", "-1"],
       ["--serve_min_replicas", "0"],
       ["--serve_min_replicas", "3", "--serve_max_replicas", "2",
        "--serve_replicas", "2"],
       ["--serve_replicas", "5"], ["--serve_slo_ms", "0"],
       ["--serve_reload_poll_s", "-1"]]
FIELDS = ("SERVE_PORT", "SERVE_REPLICAS", "SERVE_MIN_REPLICAS",
          "SERVE_MAX_REPLICAS", "SERVE_SLO_MS", "SERVE_RELOAD_POLL_S",
          "SERVE_AUTOSCALE")


@pytest.mark.parametrize("flags", GOOD, ids=lambda f: " ".join(f) or "none")
def test_serve_flags_give_the_jax_fields(flags):
    j = JaxConfig.load_from_args(["--data", "p", *flags])
    t = Config.load_from_args(["--data", "p", "--backend", "cpu", *flags])
    assert [getattr(t, f) for f in FIELDS] == [getattr(j, f) for f in FIELDS]


@pytest.mark.parametrize("flags", BAD, ids=lambda f: " ".join(f))
def test_serve_flags_refuse_as_jax_does(flags):
    with pytest.raises(ValueError) as jerr:
        JaxConfig.load_from_args(["--data", "p", *flags])
    with pytest.raises(ValueError) as terr:
        Config.load_from_args(["--data", "p", "--backend", "cpu", *flags])
    assert str(terr.value) == str(jerr.value)


# ---- the control plane without torch ----

def test_control_plane_imports_and_runs_with_torch_blocked(tmp_path):
    """replicas, reload, autoscale and frontend import and run (a pool of
    fake models, a POST /predict, /healthz /metrics /pool, a verified
    reload through a stdlib load_fn, a grow) in a process where
    `import torch` raises."""
    code = textwrap.dedent("""
        import hashlib, json, os, sys, urllib.request
        sys.modules["torch"] = None
        from code2vec_tpu_torch.common import MethodPredictionResults
        from code2vec_tpu_torch.config import Config
        from code2vec_tpu_torch.obs import Telemetry
        from code2vec_tpu_torch.obs.alerts import AlertRule
        from code2vec_tpu_torch.serving.autoscale import AutoScaler
        from code2vec_tpu_torch.serving.frontend import ServingFrontend
        from code2vec_tpu_torch.serving.reload import ReloadManager
        from code2vec_tpu_torch.serving.replicas import ReplicaPool

        class Prepared:
            def __init__(self, lines):
                self.lines = list(lines)
            @property
            def n(self):
                return len(self.lines)
            def slice(self, a, b):
                return Prepared(self.lines[a:b])
            @classmethod
            def concat(cls, parts):
                return cls([x for p in parts for x in p.lines])

        class Model:
            def __init__(self):
                self.params = {"tag": "v0"}
            def warmup_predict(self, max_batch):
                return [max_batch]
            def predict_compile_count(self):
                return 1
            def prepare_predict_rows(self, lines):
                return Prepared(lines)
            def predict_device(self, prepared):
                return (list(prepared.lines),)
            def decode_predictions(self, chunk, result):
                out = []
                for ln in result[0]:
                    r = MethodPredictionResults(ln.split(" ")[0])
                    r.append_prediction("pred|" + self.params["tag"], 0.9)
                    out.append(r)
                return out

        cfg = Config(SERVE_BATCH_MAX=8, SERVE_BATCH_TIMEOUT_MS=1.0,
                     SERVE_DEADLINE_MS=0.0, SERVE_CACHE_SIZE=16,
                     SERVE_MAX_REPLICAS=3)
        tele = Telemetry.memory("guard").make_threadsafe()
        pool = ReplicaPool(cfg, Model, replicas=2, telemetry=tele).start()
        fe = ServingFrontend(pool, port=0, telemetry=tele).start()
        base = f"http://127.0.0.1:{fe.bound_port}"
        req = urllib.request.Request(
            base + "/predict", data=json.dumps({"lines": ["m a,1,b"]}).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            body = json.loads(r.read().decode())
        assert body["predictions"][0]["predictions"][0]["name"] == ["pred", "v0"]
        for path in ("/healthz", "/metrics", "/pool"):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                assert r.status == 200
        root = sys.argv[1]
        rm = ReloadManager(root, pool, load_fn=lambda step: {"tag": "s1"},
                           telemetry=tele, poll_s=0.05)
        os.makedirs(os.path.join(root, "step_1", "state"))
        blob = b"weights"
        with open(os.path.join(root, "step_1", "state", "state.pt"), "wb") as f:
            f.write(blob)
        with open(os.path.join(root, "step_1", "checksums.json"), "w") as f:
            json.dump({"step": 1, "files": {"state/state.pt": {
                "sha256": hashlib.sha256(blob).hexdigest(),
                "bytes": len(blob)}}}, f)
        assert rm.check_now() == 1 and pool.generation() == 1
        tele.gauge("load", 9.0, emit=False)
        sc = AutoScaler(pool, telemetry=tele,
                        rules=[AlertRule("hot", metric="load", op=">",
                                         value=1.0, severity="page")],
                        clock=lambda: 0.0)
        assert sc.tick() == "up" and pool.target == 3
        fe.stop()
        pool.close()
        assert sys.modules["torch"] is None
        print("FLEET-OK")
    """)
    root = tmp_path / "ckpt"
    root.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code, str(root)], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FLEET-OK" in r.stdout


def test_step_file_checksums_are_the_checkpoint_modules(world, tmp_path):
    """The reload's stdlib hash agrees with the checkpoint module's own
    verification on a step the port wrote, and on the same step with a
    flipped byte. Tolerance: none."""
    _save(world, tmp_path, 4, world["p0"])
    assert verify_step_files(str(tmp_path), 4) is True \
        and ckpt.verify_step(str(tmp_path), 4) is True
    recorded = json.loads((tmp_path / "step_4" / "checksums.json")
                          .read_text())["files"]
    state = tmp_path / "step_4" / "state" / ckpt.STATE_FILE
    assert recorded["state/" + ckpt.STATE_FILE]["sha256"] == \
        hashlib.sha256(state.read_bytes()).hexdigest()
    raw = bytearray(state.read_bytes())
    raw[-1] ^= 0x01
    state.write_bytes(bytes(raw))
    assert verify_step_files(str(tmp_path), 4) is False \
        and ckpt.verify_step(str(tmp_path), 4) is False

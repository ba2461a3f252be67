"""The port's sampled phase profiler (code2vec_tpu_torch/obs/phases.py,
training/phase_probes.py), its analytic traffic model
(training/sparse_update.py) and the trainer's wiring, held against the
JAX package on the CPU at a small width.

- the traffic model gives the JAX package's integers for the same table
  shapes and dtypes (float32, bf16, int8; sampled and full softmax;
  sparse and dense; 1 and 2 processes), at java-large shapes too (zero-
  memory arrays on both sides);
- `derive_chain_phases` is the JAX rule;
- the dense and sparse probes' outputs match the JAX probes' on weights
  carried across by convert.py and the JAX step's own draws;
- a sampled step (probes, then the fused step) leaves the params, the
  optimizer state and the loss bit-equal to the fused step alone, for
  the dense, sparse and int8 (`backward_apply`) kits, and no probe (the
  isolated apply among them) writes the state;
- the disabled profiler, the cadence on a fake clock, the recorder's
  beats and rebase, PhaseRoofline and OptEfficiency on /metrics, the
  config rules against the JAX package's;
- `cli.main` A/B (dense and sparse-row step): profiling on and off end
  in the same bits, and a mid-run scrape carries `health_phase_*`.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from code2vec_tpu.config import Config as JConfig
from code2vec_tpu.models import encoder as jenc
from code2vec_tpu.obs import phases as jphases
from code2vec_tpu.ops import sampled_softmax as jss
from code2vec_tpu.training import phase_probes as jprobes
from code2vec_tpu.training import sparse_update as jsu
from code2vec_tpu_torch import cli, convert
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
from code2vec_tpu_torch.obs import health as thealth
from code2vec_tpu_torch.obs import promtext
from code2vec_tpu_torch.obs.exposition import render_prometheus
from code2vec_tpu_torch.obs.phases import (PhaseProfiler, ProbeKit,
                                          derive_chain_phases)
from code2vec_tpu_torch.obs.telemetry import Telemetry
from code2vec_tpu_torch.parallel.compat import free_port
from code2vec_tpu_torch.training import sparse_update as tsu
from code2vec_tpu_torch.training.checkpoint import map_state, state_tensors
from code2vec_tpu_torch.training.draws import StepDraws, make_draws
from code2vec_tpu_torch.training.optimizers import (AdamF32Moments, make_lr,
                                                    make_optimizer)
from code2vec_tpu_torch.training.phase_probes import make_code2vec_probes
from code2vec_tpu_torch.training.sparse_steps import init_sparse_opt_state
from code2vec_tpu_torch.training.steps import make_train_step
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
from helpers import build_tiny_dataset
from torch_helpers import assert_close_f32_ulp, max_ulp_diff

B, C, E = 8, 6, 8
VT, VP, VY = 50, 40, 30
S = 16
JAVA = {"token_emb": 1301138, "path_emb": 911419, "target_emb": 261247}


def _dims(module, tables_dtype="float32", **kw):
    return module.ModelDims(token_vocab_size=VT, path_vocab_size=VP,
                            target_vocab_size=VY, embeddings_size=E,
                            max_contexts=C, tables_dtype=tables_dtype, **kw)


def _batch(seed=3):
    r = np.random.default_rng(seed)
    weights = np.ones((B,), np.float32)
    weights[-1] = 0.0
    return (r.integers(0, VY, B).astype(np.int32),
            r.integers(0, VT, (B, C)).astype(np.int32),
            r.integers(0, VP, (B, C)).astype(np.int32),
            r.integers(0, VT, (B, C)).astype(np.int32),
            (r.random((B, C)) > 0.3).astype(np.float32), weights)


# ---- the traffic model, integer for integer ----

def _zero_array(module, shape, dtype):
    """A table of `shape` that holds no memory: a zero-stride numpy view
    (the JAX functions read shape, size and dtype) or a meta tensor."""
    if module is np:
        return np.broadcast_to(np.zeros((), dtype), shape)
    return torch.empty(shape, dtype=dtype, device="meta")


def _java_params(module, tables_dtype):
    """java-large shaped params (no memory) for one package."""
    if module is np:
        dt = {"float32": np.float32, "bfloat16": jnp.bfloat16}
        f32, i8 = np.float32, np.int8
    else:
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
        f32, i8 = torch.float32, torch.int8
    D = 3 * 128
    params = {"transform": _zero_array(module, (D, D), f32),
              "attention": _zero_array(module, (D,), f32)}
    for key, rows in JAVA.items():
        width = D if key == "target_emb" else 128
        if tables_dtype == "int8" and key != "target_emb":
            params[key] = {"q": _zero_array(module, (rows, width), i8),
                           "s": _zero_array(module, (rows, 1), f32)}
        else:
            params[key] = _zero_array(
                module, (rows, width),
                dt["bfloat16" if tables_dtype == "int8" else tables_dtype])
    return params


def _small_params(tables_dtype, encoder="bag"):
    """(JAX params, the port's copy by convert.py) at the test width."""
    jd = _dims(jenc, tables_dtype, encoder_type=encoder)
    jp = jenc.init_params(jax.random.PRNGKey(0), jd)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    return jp, tp


def _model_calls(batch_size, max_contexts):
    for processes in (1, 2):
        for ns in (0, S):
            yield processes, ns, dict(num_sampled=ns, processes=processes)


@pytest.mark.parametrize("shape,tables_dtype", [
    (shape, dt) for shape in ("small", "java_large", "transformer")
    for dt in ("float32", "bfloat16", "int8")
    # the transformer has no int8 tables in either package
    if (shape, dt) != ("transformer", "int8")])
def test_traffic_model_matches_jax_integers(shape, tables_dtype):
    """All seven functions of the model (`_num_slots`,
    `sparse_update_traffic_bytes`, `table_id_counts`,
    `sparse_update_phase_bytes`, `sparse_step_floor_bytes`,
    `phase_traffic_bytes`, `expected_unique_rows`) over the same
    shapes and dtypes give the same integers. Tolerance: none (exact
    integers)."""
    if shape == "java_large":
        jp, tp = _java_params(np, tables_dtype), _java_params(torch,
                                                              tables_dtype)
        batch_size, max_contexts = 1024, 200
    else:
        jp, tp = _small_params(tables_dtype, "transformer"
                               if shape == "transformer" else "bag")
        batch_size, max_contexts = B, C
    for n in (1, 511, 512, 513, 409600):
        assert tsu._num_slots(n, 512) == jsu._num_slots(n, 512)
        for rows in (2, 30, 1301138):
            assert tsu.expected_unique_rows(n, rows) == \
                jsu.expected_unique_rows(n, rows)
    assert tsu._BLOCK_ROWS == jsu._BLOCK_ROWS
    for key in ("token_emb", "path_emb", "target_emb"):
        for n_ids, u, gi in ((10, 3, 4), (409600, 351393, 2), (0, 0, 4)):
            assert tsu.sparse_update_traffic_bytes(
                tp[key], n_ids, u, grad_itemsize=gi) == \
                jsu.sparse_update_traffic_bytes(jp[key], n_ids, u,
                                                grad_itemsize=gi)
    for processes, ns, kw in _model_calls(batch_size, max_contexts):
        assert tsu.table_id_counts(batch_size, max_contexts, ns) == \
            jsu.table_id_counts(batch_size, max_contexts, ns)
        assert tsu.sparse_update_phase_bytes(
            tp, batch_size, max_contexts, **kw) == \
            jsu.sparse_update_phase_bytes(jp, batch_size, max_contexts,
                                          **kw)
        for shards in (1, 2):
            assert tsu.sparse_step_floor_bytes(
                tp, batch_size, max_contexts, data_shards=shards, **kw) == \
                jsu.sparse_step_floor_bytes(jp, batch_size, max_contexts,
                                            data_shards=shards, **kw)
        for sparse in (False, True):
            for ci in (2, 4):
                got = tsu.phase_traffic_bytes(
                    tp, batch_size, max_contexts, sparse=sparse,
                    compute_itemsize=ci, **kw)
                assert got == jsu.phase_traffic_bytes(
                    jp, batch_size, max_contexts, sparse=sparse,
                    compute_itemsize=ci, **kw)
                assert all(v > 0 for v in got.values()), got


def test_derive_chain_phases_is_the_jax_rule():
    """Cumulative times, including ones that fall (clamped to 0).
    Tolerance: none (the same float arithmetic)."""
    r = np.random.default_rng(0)
    for _ in range(20):
        n = int(r.integers(1, 6))
        names = [f"p{i}" for i in range(n)]
        cum = list(np.cumsum(r.normal(1.0, 1.5, n)))
        assert derive_chain_phases(names, cum) == \
            jphases.derive_chain_phases(names, cum)
    assert derive_chain_phases(["a", "b", "c"], [2.0, 5.0, 4.0]) == [
        ("a", 2.0), ("b", 3.0), ("c", 0.0)]


# ---- the probes against the JAX probes ----

def _draws_from_jax(rng, sampled):
    """The JAX steps' draws for float tables: (drop, sample) = split(rng),
    the Bernoulli keep mask and the log-uniform sample."""
    drop_rng, sample_rng = jax.random.split(rng)
    keep = np.array(jax.random.bernoulli(drop_rng, 0.75, (B, C, 3 * E)))
    ids = (np.array(jss.log_uniform_sample(sample_rng, min(S, VY), VY))
           if sampled else None)
    return StepDraws(keep=torch.from_numpy(keep),
                     sampled=None if ids is None else torch.from_numpy(ids),
                     salts={})


def _assert_ulp(a, b, n, what):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, what
    if n == 0:
        assert max_ulp_diff(a, b) == 0, what
    else:
        assert_close_f32_ulp(a, b, n)


def _flat(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for v in x for v in _flat(v)]
    return [x]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("sampled", [False, True], ids=["full", "sampled"])
def test_probe_outputs_match_jax_probes(sparse, sampled):
    """embed_gather, concat_dense and forward_pool of the port's kit
    against `make_code2vec_probes` of the JAX package (float32 tables,
    float32 compute, the plain pool on both sides), on weights carried
    by convert.py and the JAX step's draws. Tolerance: the gathers are
    exact (0 ulp); tanh(contexts @ T) sums D = 24 products in another
    order, within 4 float32 ulp of the largest element; the loss within
    8 ulp of itself (a sum of B softmax terms over such products)."""
    jp, tp = _small_params("float32")
    jd, td = _dims(jenc), _dims(tenc)
    batch = _batch()
    rng = jax.random.PRNGKey(7)
    jkit = jprobes.make_code2vec_probes(
        jd, optax.adam(1e-2), use_sampled_softmax=sampled, num_sampled=S,
        sparse_updates=sparse)
    tkit = make_code2vec_probes(td, None, use_sampled_softmax=sampled,
                                num_sampled=S, sparse_updates=sparse)
    assert [n for n, _ in tkit.chain] == [n for n, _ in jkit.chain]
    draws = _draws_from_jax(rng, sampled)
    jb = tuple(jnp.asarray(a) for a in batch)
    tb = tuple(torch.from_numpy(a) for a in batch)
    outs = {}
    for (name, jfn), (_n, tfn) in zip(jkit.chain, tkit.chain):
        if name == "backward":
            continue
        outs[name] = (_flat(jfn(jp, jb, rng)), _flat(tfn(tp, tb, draws)))
    for name, n_ulp in (("embed_gather", 0), ("concat_dense", 4),
                        ("forward_pool", 8)):
        j, t = outs[name]
        assert len(j) == len(t), name
        for a, b in zip(t, j):
            _assert_ulp(a.detach().numpy(), np.asarray(b), n_ulp, name)


# ---- the sampled step: bit-equal to the fused step ----

def _port_setup(kind):
    """(params, opt_state, step, kit factory, batch, draws) of one of
    the port's steps at the test width, from a seeded CPU generator."""
    tables = {"dense": "float32", "sparse": "bfloat16",
              "int8": "int8"}[kind]
    sampled = kind != "dense"
    dims = _dims(tenc, tables)
    params = tenc.init_params(torch.Generator().manual_seed(1), dims)
    if kind == "sparse":
        opt = AdamF32Moments(1e-2)
        opt_state = init_sparse_opt_state(params, opt, True)
    else:
        from code2vec_tpu_torch.ops.quant import opt_param_view
        opt = make_optimizer(make_lr(1e-2, "cosine", 10))
        opt_state = opt.init(opt_param_view(params))
    compute = torch.float32 if kind == "dense" else torch.bfloat16
    step = make_train_step(dims, opt, use_sampled_softmax=sampled,
                           num_sampled=S, compute_dtype=compute,
                           sparse_updates=kind == "sparse")
    batch = tuple(torch.from_numpy(a) for a in _batch(11))
    draws = make_draws(dims, step.cfg, params, B, 5, 3, "cpu")

    def factory(**kw):
        return make_code2vec_probes(
            dims, opt, use_sampled_softmax=sampled, num_sampled=S,
            compute_dtype=compute, sparse_updates=kind == "sparse", **kw)
    return params, opt_state, step, factory, batch, draws


def _clone(x):
    return map_state(lambda t: t.clone(), x)


def _assert_bits(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert len(ta) == len(tb) and ta
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)


class _Sink:
    def __init__(self):
        self.events = []

    def write(self, e):
        self.events.append(e)

    def close(self):
        pass


@pytest.mark.parametrize("kind", ["dense", "sparse", "int8"])
def test_split_step_is_bit_equal_to_the_fused_step(kind):
    """run_split (the probes, then the fused step) against the fused
    step alone from one cloned state and the same draws: params,
    optimizer state and loss the same bits; every phase of the kit and
    its remainder (`table_apply`; `backward_apply` under int8) get one
    timer, and the `phase` event reconciles (fused = split_sum +
    residual). Tolerance: none (bits); the event's ms are rounded to
    0.001, so its identity holds within 0.01 ms."""
    params, opt_state, step, factory, batch, draws = _port_setup(kind)
    p1, s1 = _clone(params), _clone(opt_state)
    loss1 = step(p1, s1, batch, draws)
    tele = Telemetry.memory("train")
    sink = _Sink()
    tele.sinks = [sink]
    prof = PhaseProfiler.create(tele, fused_step=step,
                                probes_factory=factory, enabled=True,
                                sample_every=1)
    p2, s2 = _clone(params), _clone(opt_state)
    loss2 = prof.run_split(p2, s2, batch, draws, step=64,
                           infeed_wait_ms=0.5)
    assert torch.equal(loss1, loss2)
    _assert_bits({"p": p1, "s": s1}, {"p": p2, "s": s2})
    remainder = "backward_apply" if kind == "int8" else "table_apply"
    phases = [n for n, _ in prof._kit.chain] + [remainder, "infeed_wait",
                                               "fused_step"]
    for phase in phases:
        stat = tele.timers.get(f"train/phase/{phase}_ms")
        assert stat is not None and stat.count == 1, phase
    (ev,) = [e for e in sink.events if e.get("kind") == "phase"]
    assert ev["step"] == 64
    assert ev["fused_ms"] == pytest.approx(
        ev["split_sum_ms"] + ev["residual_ms"], abs=0.01)
    assert ev[f"{remainder}_ms"] >= 0.0


@pytest.mark.parametrize("kind", ["dense", "sparse", "int8"])
def test_probes_never_write_the_state(kind):
    """Every probe of the kit, and the dense kit's isolated apply probe,
    run on the live state and leave params and optimizer state bitwise
    unchanged; the apply probe computes the fused step's new params.
    Tolerance: none (bits)."""
    params, opt_state, step, factory, batch, draws = _port_setup(kind)
    before = _clone({"p": params, "s": opt_state})
    kit = factory(isolated_apply=kind == "dense") if kind != "sparse" \
        else factory()
    out = None
    for _name, fn in kit.chain:
        out = fn(params, batch, draws)
    if kit.apply_fn is not None:
        new = kit.apply_fn(params, opt_state, batch, draws, out)
        _assert_bits(before, {"p": params, "s": opt_state})
        step(params, opt_state, batch, draws)
        from code2vec_tpu_torch.ops.quant import opt_param_view
        for got, want in zip(new, opt_param_view(params).values()):
            assert torch.equal(got, want)
    else:
        _assert_bits(before, {"p": params, "s": opt_state})
    if kind == "int8":
        assert kit.remainder_name == "backward_apply"
        assert [n for n, _ in kit.chain][-1] == "forward_pool"


def test_run_split_beats_and_rebases_the_recorder():
    """The first sample beats the recorder after every warm-up and
    measured probe, then rebases the step window after the probes; the
    next sample has no warm-up. Tolerance: none (counts)."""
    params, opt_state, step, factory, batch, draws = _port_setup("dense")

    class FakeRecorder:
        ticks = rebased = ticks_at_rebase = 0

        def probe_tick(self):
            FakeRecorder.ticks += 1

        def rebase_step_window(self):
            FakeRecorder.rebased += 1
            FakeRecorder.ticks_at_rebase = FakeRecorder.ticks

    prof = PhaseProfiler.create(Telemetry.memory("train"), fused_step=step,
                                probes_factory=factory, enabled=True,
                                sample_every=1)
    prof.run_split(params, opt_state, batch, draws, recorder=FakeRecorder())
    n = len(prof._kit.chain)
    assert FakeRecorder.ticks == 2 * n and FakeRecorder.rebased == 1
    assert FakeRecorder.ticks_at_rebase == FakeRecorder.ticks
    prof.run_split(params, opt_state, batch, draws, recorder=FakeRecorder())
    assert FakeRecorder.ticks == 3 * n and FakeRecorder.rebased == 2


def test_recorder_rebase_restarts_the_step_window():
    """TrainStepRecorder's hooks: `infeed_wait_ms` is the last pop's
    wait, `rebase_step_window` moves the step's start (so train/step_ms
    times only what follows) and beats the heartbeat, as does
    `probe_tick`. Tolerance: the rebased step is under the 0.2 s slept
    before the rebase."""
    from code2vec_tpu_torch.obs.loop import TrainStepRecorder
    beats = []

    class Beat:
        def beat(self):
            beats.append(1)

    tele = Telemetry.memory("train")
    rec = TrainStepRecorder(tele, heartbeat=Beat())
    for _batch in rec.wrap([1]):
        assert rec.infeed_wait_ms >= 0.0
        rec.probe_tick()
        time.sleep(0.2)
        rec.rebase_step_window()
        rec.end_step(1, torch.tensor(0.5), 4)
    assert len(beats) == 3
    assert tele.timers["train/step_ms"].percentile(50) < 150.0


def test_disabled_profiler_is_the_shared_noop(dataset):
    """Off is one boolean: `create` returns the shared singleton for the
    flag off, a dead registry and a missing step; it never samples and
    refuses run_split. Tolerance: none."""
    dead, live = Telemetry.disabled(), Telemetry.memory("t")
    off = PhaseProfiler.create(live, fused_step=lambda *a: None,
                               probes_factory=lambda: None, enabled=False)
    assert off is PhaseProfiler.disabled()
    assert PhaseProfiler.create(dead, fused_step=lambda *a: None,
                                probes_factory=lambda: None,
                                enabled=True) is off
    assert PhaseProfiler.create(live, enabled=True) is off
    assert not off.enabled and not off.should_sample(64)
    with pytest.raises(RuntimeError):
        off.run_split(None, None, None, None)
    assert not [t for t in live.timers if t.startswith("train/phase/")]
    cfg = Config(PHASE_PROFILE="off", MAX_CONTEXTS=CLI_C,
                 DEFAULT_EMBEDDINGS_SIZE=E)
    trainer = Code2VecTrainer(cfg, _vocabs(dataset), device="cpu")
    assert trainer.phase_profiler(live) is off
    cfg.PHASE_PROFILE = "on"
    assert trainer.phase_profiler(dead) is off
    assert trainer.phase_profiler(live).enabled


def test_sampler_cadence_on_a_fake_clock():
    """Step 0 is never sampled; a due step waits for the min interval on
    the injected clock; no interval means a pure step cadence, as in
    the JAX package. Tolerance: none."""
    clock = {"t": 100.0}
    kw = dict(fused_step=lambda *a: None, probes_factory=lambda: None)
    prof = PhaseProfiler(Telemetry.memory("t"), sample_every=4,
                         min_interval_s=10.0, clock=lambda: clock["t"],
                         **kw)
    jprof = jphases.PhaseProfiler(
        Telemetry.memory("t"), sample_every=4, min_interval_s=10.0,
        clock=lambda: clock["t"], **kw)
    for p in (prof, jprof):
        assert not p.should_sample(0) and not p.should_sample(3)
        assert p.should_sample(4)
        p._last_sample_t = clock["t"]
    clock["t"] = 105.0
    assert not prof.should_sample(8) and not jprof.should_sample(8)
    clock["t"] = 111.0
    assert prof.should_sample(8) and jprof.should_sample(8)
    prof2 = PhaseProfiler(Telemetry.memory("t"), sample_every=2, **kw)
    assert [s for s in range(9) if prof2.should_sample(s)] == [2, 4, 6, 8]


def test_phase_roofline_and_opt_efficiency_render_on_metrics():
    """A sampled step's timers and the static gauges the profiler and
    the loop publish: PhaseRoofline's coverage and per-phase roofline
    gauges, OptEfficiency's floor over the step p50, both in the
    Prometheus text. Tolerance: 1e-9 relative (float arithmetic)."""
    tele = Telemetry.memory("train")
    prof = PhaseProfiler(tele, fused_step=lambda *a: None,
                         probes_factory=lambda: None,
                         phase_bytes={"embed_gather": 4_000_000},
                         ceiling_gbps=100.0)
    assert prof.enabled
    assert tele.gauges["train/phase_floor_ms/embed_gather"] == \
        pytest.approx(0.04)
    for name, ms in (("embed_gather", 0.2), ("concat_dense", 0.3),
                     ("forward_pool", 0.5), ("backward", 1.0),
                     ("table_apply", 1.0), ("infeed_wait", 5.0),
                     ("fused_step", 3.0)):
        tele.record_ms(f"train/phase/{name}_ms", ms)
    tele.gauge("train/step_floor_ms", 1.5, emit=False, static=True)
    for _ in range(3):
        tele.record_ms("train/step_ms", 3.0)
    monitors = {m.name: m for m in thealth.default_train_monitors()}
    monitors["phase_coverage"].evaluate(tele, 1.0)
    monitors["opt_efficiency"].evaluate(tele, 1.0)
    assert monitors["phase_coverage"].value == pytest.approx(1.0)
    assert monitors["phase_coverage"].status == "ok"
    assert tele.gauges["health/phase_embed_gather"] == pytest.approx(0.2)
    assert monitors["opt_efficiency"].value == pytest.approx(0.5)
    fam = promtext.parse_prometheus(render_prometheus(tele))
    for name in ("health_phase_embed_gather", "health_phase_coverage",
                 "health_opt_efficiency", "train_phase_backward_ms",
                 "train_step_floor_ms"):
        assert name in fam, name
    assert promtext.scalar(fam, "health_opt_efficiency") == \
        pytest.approx(0.5)


@pytest.mark.parametrize("fields,match", [
    (dict(PHASE_PROFILE="sometimes"), "phase_profile"),
    (dict(PHASE_SAMPLE_EVERY=0), "phase_sample_every"),
    (dict(PHASE_PROFILE="on"), "live registry"),
    (dict(PHASE_PROFILE="on", METRICS_PORT=9100), None),
    (dict(PHASE_PROFILE="on", TELEMETRY_DIR="/tmp/t"), None),
])
def test_phase_config_rules_match_jax(fields, match):
    """`verify` refuses (or accepts) what the JAX package's does, with
    its message; the flags parse into the fields. Tolerance: none."""
    for cls in (Config, JConfig):
        cfg = cls(load_path="x", **fields)
        if match is None:
            cfg.verify()
        else:
            with pytest.raises(ValueError, match=match):
                cfg.verify()
    cfg = Config.load_from_args([
        "--data", "p", "--backend", "cpu", "--phase_profile", "on",
        "--phase_sample_every", "3", "--metrics_port", "9100"])
    assert (cfg.PHASE_PROFILE, cfg.PHASE_SAMPLE_EVERY) == ("on", 3)


# ---- the trainer and the command line ----

CLI_C = 8


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("phase_data")
    return build_tiny_dataset(str(d), n_train=48, n_val=8, n_test=8,
                              max_contexts=CLI_C, binarize=True)


def _vocabs(prefix):
    return Code2VecVocabs.load_from_dict_file(prefix + ".dict.c2v", 1000,
                                              1000, 1000)


class _Trainers:
    """Every trainer cli.main makes, for the length of a `with`."""

    def __enter__(self):
        self.made = []
        self.real = Code2VecTrainer.from_config.__func__
        made, real = self.made, self.real

        def from_config(cls, *a, **k):
            t = real(cls, *a, **k)
            made.append(t)
            return t
        Code2VecTrainer.from_config = classmethod(from_config)
        return self

    def __exit__(self, *exc):
        Code2VecTrainer.from_config = classmethod(self.real)
        return False


def _small(monkeypatch):
    real = Config.load_from_args.__func__

    def load(cls, args=None):
        cfg = real(cls, args)
        cfg.DEFAULT_EMBEDDINGS_SIZE = E
        cfg.HEALTH_EVERY_S = 0.05
        return cfg
    monkeypatch.setattr(Config, "load_from_args", classmethod(load))


@pytest.mark.parametrize("step", ["dense", "sparse"])
def test_cli_profiled_run_ends_in_the_unprofiled_bits(dataset, tmp_path,
                                                      monkeypatch, step):
    """`cli.main` twice over the same 6 steps (2 epochs of 3), once with
    `--phase_profile on --phase_sample_every 2 --telemetry_dir`, once
    without: the final params and optimizer state are the same bits;
    the profiled run wrote a `phase` event at steps-into-run 2 and 4,
    the phase timers and bytes; the sparse-row run also its step-floor
    gauges. Tolerance: none (bits)."""
    _small(monkeypatch)
    base = ["--data", dataset, "--backend", "cpu", "--max_contexts",
            str(CLI_C), "--batch_size", "16", "--epochs", "2", "--no_bf16"]
    if step == "sparse":
        base += ["--sparse_embeddings", "--embedding_optimizer", "adam",
                 "--lr_schedule", "constant", "--sampled_softmax",
                 "--num_sampled", str(S)]
    states = {}
    tele = str(tmp_path / "tele")
    for mode in ("off", "on"):
        flags = (["--phase_profile", "on", "--phase_sample_every", "2",
                  "--telemetry_dir", tele] if mode == "on" else [])
        with _Trainers() as made:
            assert cli.main(base + flags) == 0
        t = made.made[-1]
        assert t.step_num == 6
        states[mode] = {"p": t.params, "s": t.opt_state}
    _assert_bits(states["off"], states["on"])
    (run,) = os.listdir(tele)
    with open(os.path.join(tele, run, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    phase_ev = [e for e in events if e["kind"] == "phase"]
    assert [e["step"] for e in phase_ev] == [2, 4]
    summary = [e for e in events if e["kind"] == "summary"][-1]
    assert summary["timers"]["train/phase/fused_step_ms"]["count"] == 2
    for p in ("embed_gather", "concat_dense", "forward_pool", "backward",
              "table_apply"):
        assert summary["timers"][f"train/phase/{p}_ms"]["count"] == 2, p
        assert summary["gauges"][f"train/phase_bytes/{p}"] > 0, p
    floors = {"train/step_floor_ms", "train/sparse_update_bytes",
              "train/sparse_update_floor_ms"}
    if step == "sparse":
        assert all(summary["gauges"][g] > 0 for g in floors)
    else:
        assert not floors & set(summary["gauges"])


def test_mid_run_scrape_has_health_phase(dataset, monkeypatch):
    """A /metrics scrape DURING a `--phase_profile on --metrics_port`
    run (sparse-row step, in-memory registry) carries the
    health_phase_* roofline gauges, health_opt_efficiency and the
    train_phase_* summaries: the run is held at its 5th step until the
    scrape has seen them (or 60 s pass). Tolerance: none (families)."""
    _small(monkeypatch)
    port = free_port()
    gate, seen = threading.Event(), {}
    real = Code2VecTrainer.train_step
    calls = []

    def held(self, batch, draws=None):
        calls.append(1)
        if len(calls) == 5:
            gate.wait(timeout=60)
        return real(self, batch, draws)

    monkeypatch.setattr(Code2VecTrainer, "train_step", held)

    def scrape():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not gate.is_set():
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics",
                        timeout=1.0) as r:
                    body = r.read().decode("utf-8")
            except (urllib.error.URLError, OSError):
                time.sleep(0.05)
                continue
            if "health_phase_embed_gather" in body \
                    and "train_phase_fused_step_ms" in body \
                    and "health_opt_efficiency" in body:
                seen["body"] = body
                gate.set()
            time.sleep(0.05)
        gate.set()

    t = threading.Thread(target=scrape)
    t.start()
    try:
        assert cli.main([
            "--data", dataset, "--backend", "cpu", "--max_contexts",
            str(CLI_C), "--batch_size", "16", "--epochs", "3", "--no_bf16",
            "--sparse_embeddings", "--embedding_optimizer", "adam",
            "--lr_schedule", "constant", "--phase_profile", "on",
            "--phase_sample_every", "2", "--metrics_port", str(port)]) == 0
    finally:
        gate.set()
        t.join(timeout=60)
    assert "body" in seen, "never scraped health_phase_* mid-run"
    fam = promtext.parse_prometheus(seen["body"])
    assert "health_phase_coverage" in fam
    assert "train_phase_table_apply_ms" in fam
    eff = promtext.scalar(fam, "health_opt_efficiency")
    assert eff is not None and 0 < eff <= 1

"""The port's fleet plane (code2vec_tpu_torch/obs/fleet.py: the cohort
collector, its alert rules; the `/fleet` route of obs/exposition.py)
against the JAX package's.

The cases of tests/test_fleet.py that need no JAX (the collector's
policy under a fake clock and an injected fetch: the offset median over
asymmetric round trips, the re-handshake on a restart, a member down as
a row, straggler attribution, divergence on matching steps, summed
throughput and its JSONL ring and Prometheus text, `set_members`, the
disabled singleton; the real-socket seams: `/fleet` 404 without a
collector, the clock commit persisted into the run manifest; the
supervisor hosting the collector) run on the port's modules. Members
are the port's memory registries rendered by the port's `/metrics`
renderer. Then the same scrape texts go to the JAX and the port
collectors, and their aggregates are held equal. Tolerance: 1e-12 on
offsets (float arithmetic), exact elsewhere.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import pytest

from code2vec_tpu.obs import Telemetry as JTelemetry
from code2vec_tpu.obs.fleet import FleetCollector as JFleetCollector
from code2vec_tpu_torch import obs
from code2vec_tpu_torch.obs.exposition import render_prometheus
from code2vec_tpu_torch.obs.fleet import FleetCollector, fleet_alert_rules


# ---- fakes -----------------------------------------------------------

class FakeClock:
    """One mutable timebase standing in for the collector's monotonic
    AND wall clocks (tests only care about deltas and offsets)."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    wall = __call__


class FakeCohort:
    """In-memory member endpoints behind an injectable fetch: real
    registries, the real /metrics renderer, fake member clocks, zero
    sockets. `legs` per member is a list of (request_s, response_s)
    pairs consumed by successive /clock reads — each leg advances the
    shared clock, so round-trip asymmetry is exact and deterministic."""

    def __init__(self, clock: FakeClock):
        self.clock = clock
        self.members = {}
        self.commits = []  # (endpoint, query) per commit round trip

    def add(self, endpoint, tele, *, run_id, process_index=0,
            offset_s=0.0, legs=None):
        self.members[endpoint] = {
            "tele": tele, "run_id": run_id,
            "process_index": process_index, "offset_s": offset_s,
            "legs": list(legs or [])}

    def fetch(self, url):
        endpoint, _, path = url.split("://", 1)[1].partition("/")
        m = self.members[endpoint]
        path, _, query = path.partition("?")
        if path == "clock":
            if "commit=1" in query:
                self.commits.append((endpoint, query))
                return json.dumps({"committed": True})
            a, b = (m["legs"].pop(0) if m["legs"] else (0.0, 0.0))
            self.clock.t += a  # request leg
            body = {"mono": 0.0,
                    "wall": self.clock.t + m["offset_s"],
                    "identity": {"run_id": m["run_id"],
                                 "process_index": m["process_index"]}}
            self.clock.t += b  # response leg
            return json.dumps(body)
        if path == "vars":
            return json.dumps({"identity": {
                "run_id": m["run_id"],
                "process_index": m["process_index"]}})
        if path == "metrics":
            return render_prometheus(m["tele"])
        raise ValueError(url)


def _collector(clock, cohort, endpoints, **kw):
    kw.setdefault("handshake_samples", 3)
    return FleetCollector(
        obs.Telemetry.memory("sup").make_threadsafe(),
        members=endpoints, clock=clock, wall=clock.wall,
        fetch=cohort.fetch, **kw)


def _member_tele(step_ms=None, **counts):
    t = obs.Telemetry.memory("member").make_threadsafe()
    for name, v in counts.items():
        t.count(f"train/{name}", v)
    if step_ms is not None:
        t.record_ms("train/step_ms", step_ms)
    return t


# ---- clock handshake -------------------------------------------------

def test_offset_median_survives_asymmetric_round_trips():
    """One slow request leg and one slow response leg bias their
    samples in OPPOSITE directions (+/- (a-b)/2); the median of three
    lands exactly on the true offset, where a mean would not."""
    clk = FakeClock()
    cohort = FakeCohort(clk)
    cohort.add("m0:1", _member_tele(steps=3), run_id="r1",
               offset_s=5.0,
               legs=[(0.001, 0.001), (0.010, 0.002), (0.002, 0.010)])
    fc = _collector(clk, cohort, ["m0:1"])
    agg = fc.sample()
    row = agg["hosts"][0]
    assert row["up"] and row["run_id"] == "r1"
    assert row["clock_offset_s"] == pytest.approx(5.0, abs=1e-12)
    assert row["clock_committed"] is True
    # the measurement went BACK to the member for manifest persistence
    assert len(cohort.commits) == 1
    ep, query = cohort.commits[0]
    assert ep == "m0:1"
    assert "offset_s=5.000000000" in query and "samples=3" in query


def test_restart_rehandshakes_and_resets_rates():
    """A changed run_id means a relaunched process: fresh clock
    measurement (a new process is a new clock relationship) and a
    rate-window reset, so counters restarting from zero never render
    as negative throughput."""
    clk = FakeClock()
    cohort = FakeCohort(clk)
    cohort.add("m0:1", _member_tele(steps=100, examples=3200),
               run_id="r1", offset_s=1.0)
    fc = _collector(clk, cohort, ["m0:1"])
    fc.sample()
    clk.t += 1.0
    fc.sample()  # second sweep: rates flow, no re-handshake
    assert len(cohort.commits) == 1
    assert fc.aggregate()["hosts"][0]["steps_s"] == pytest.approx(0.0)

    # relaunch: new run_id, counters back near zero, new clock skew
    cohort.members["m0:1"].update(
        tele=_member_tele(steps=2, examples=64), run_id="r2",
        offset_s=-3.0)
    clk.t += 1.0
    row = fc.sample()["hosts"][0]
    assert len(cohort.commits) == 2  # re-handshake committed
    assert row["run_id"] == "r2"
    assert row["clock_offset_s"] == pytest.approx(-3.0)
    # reset window: first post-restart sweep has no prior to rate from
    assert row["steps_s"] is None


def test_member_down_is_a_row_not_an_exception():
    def dead(_url):
        raise OSError("connection refused")

    clk = FakeClock()
    fc = FleetCollector(obs.Telemetry.memory("sup").make_threadsafe(),
                        members=["gone:9"], clock=clk, wall=clk.wall,
                        fetch=dead)
    agg = fc.sample()
    assert agg["hosts"][0] == {"endpoint": "gone:9", "up": False,
                               "error": "connection refused"}
    assert agg["cohort"]["hosts_up"] == 0
    assert agg["cohort"]["hosts_total"] == 1


# ---- straggler attribution ------------------------------------------

def test_straggler_score_attributes_worst_series():
    """Host 2 is 3x the cohort median on step_ms but 4x on the
    exposed-allreduce phase: the score takes the worst ratio and the
    attribution names the series — `phase_allreduce_exposed`, not a
    mystery step-time number."""
    clk = FakeClock()
    cohort = FakeCohort(clk)
    for i, (step, phase) in enumerate(((100.0, 10.0), (100.0, 10.0),
                                       (300.0, 40.0))):
        t = _member_tele(step_ms=step, steps=10)
        t.record_ms("train/phase_allreduce_exposed_ms", phase)
        cohort.add(f"m{i}:1", t, run_id=f"r{i}", process_index=i)
    fc = _collector(clk, cohort, ["m0:1", "m1:1", "m2:1"])
    engine = obs.AlertEngine.create(
        fc.telemetry, mode="warn", rules=fleet_alert_rules())
    fc.attach(alerts=engine)
    agg = fc.sample()
    c = agg["cohort"]
    assert c["straggler_host"] == "m2:1"
    assert c["straggler_score"] == pytest.approx(4.0)
    assert c["straggler_series"] == "phase_allreduce_exposed"
    assert c["step_p50_skew"] == pytest.approx(3.0)
    rows = [r for r in agg["hosts"] if r["endpoint"] != "m2:1"]
    assert all(r["straggler_score"] == pytest.approx(1.0)
               for r in rows)
    # the gauges landed in the hosting registry and the ticket fired
    # through the attached engine in the SAME sweep
    assert fc.telemetry.gauges["fleet/straggler_score"] == \
        pytest.approx(4.0)
    state = {r["rule"]: r["state"] for r in engine.status_table()}
    assert state["cohort_straggler"] == "firing"
    assert state["cohort_divergence"] != "firing"


def test_single_host_has_no_straggler():
    """Skew needs a cohort: one host never gets a score (a median of
    itself is a tautology, not a signal)."""
    clk = FakeClock()
    cohort = FakeCohort(clk)
    cohort.add("m0:1", _member_tele(step_ms=100.0, steps=1),
               run_id="r1")
    fc = _collector(clk, cohort, ["m0:1"])
    c = fc.sample()["cohort"]
    assert c["straggler_score"] is None
    assert c["step_p50_skew"] is None


# ---- divergence ------------------------------------------------------

def _loss_member(cohort, endpoint, run_id, step, loss, digest=None):
    t = _member_tele(steps=step)
    t.gauge("train/loss", loss, emit=False)
    t.gauge("train/loss_step", float(step), emit=False)
    if digest is not None:
        t.gauge("train/params_digest", digest, emit=False)
        t.gauge("train/params_digest_step", float(step), emit=False)
    if endpoint in cohort.members:
        cohort.members[endpoint]["tele"] = t
    else:
        cohort.add(endpoint, t, run_id=run_id)
    return t


def test_divergence_fires_on_matching_step_disagreement():
    clk = FakeClock()
    cohort = FakeCohort(clk)
    _loss_member(cohort, "m0:1", "r0", 10, 0.5)
    _loss_member(cohort, "m1:1", "r1", 10, 0.5)
    fc = _collector(clk, cohort, ["m0:1", "m1:1"])
    engine = obs.AlertEngine.create(
        fc.telemetry, mode="warn", rules=fleet_alert_rules())
    fc.attach(alerts=engine)
    c = fc.sample()["cohort"]
    assert c["divergence"] == 0
    assert c["loss_divergence_rel"] == pytest.approx(0.0)

    # same step, different loss: the replicas diverged at runtime
    clk.t += 1.0
    _loss_member(cohort, "m0:1", "r0", 20, 0.5)
    _loss_member(cohort, "m1:1", "r1", 20, 0.6)
    c = fc.sample()["cohort"]
    assert c["divergence"] == 1
    assert c["loss_divergence_step"] == 20
    assert c["loss_divergence_rel"] == pytest.approx(0.1 / 0.55,
                                                     rel=1e-6)
    state = {r["rule"]: r["state"] for r in engine.status_table()}
    assert state["cohort_divergence"] == "firing"


def test_divergence_params_digest_channel():
    """Loss can agree while weights drift (a buggy non-replicated
    optimizer state): the sampled params fingerprint is its own
    channel, matched at its own step labels."""
    clk = FakeClock()
    cohort = FakeCohort(clk)
    _loss_member(cohort, "m0:1", "r0", 10, 0.5, digest=1234.5)
    _loss_member(cohort, "m1:1", "r1", 10, 0.5, digest=1240.5)
    fc = _collector(clk, cohort, ["m0:1", "m1:1"])
    c = fc.sample()["cohort"]
    assert c["loss_divergence_rel"] == pytest.approx(0.0)
    assert c["params_digest_divergence_rel"] > 1e-4
    assert c["params_digest_divergence_step"] == 10
    assert c["divergence"] == 1


def test_disjoint_steps_never_compare():
    """Hosts scraped at different steps with no overlap: nothing to
    compare, no false alarm."""
    clk = FakeClock()
    cohort = FakeCohort(clk)
    _loss_member(cohort, "m0:1", "r0", 10, 0.5)
    _loss_member(cohort, "m1:1", "r1", 11, 0.9)
    fc = _collector(clk, cohort, ["m0:1", "m1:1"])
    c = fc.sample()["cohort"]
    assert c["divergence"] == 0
    assert c["loss_divergence_step"] is None


# ---- throughput, history, reads -------------------------------------

def test_cohort_throughput_sums_and_persists(tmp_path):
    clk = FakeClock()
    cohort = FakeCohort(clk)
    t0 = _member_tele(steps=10, examples=0)
    t0.gauge("train/max_contexts", 8, emit=False)
    t1 = _member_tele(steps=10, examples=0)
    t1.gauge("train/max_contexts", 8, emit=False)
    cohort.add("m0:1", t0, run_id="r0")
    cohort.add("m1:1", t1, run_id="r1")
    hist = str(tmp_path / "fleet.jsonl")
    fc = _collector(clk, cohort, ["m0:1", "m1:1"], history_path=hist)
    fc.sample()  # first sweep primes the rate windows
    clk.t += 2.0
    t0.count("train/examples", 64)
    t1.count("train/examples", 32)
    agg = fc.sample()
    c = agg["cohort"]
    assert c["ex_per_sec"] == pytest.approx(48.0)
    # pc/s = ex/s * max_contexts, summed over the cohort
    assert c["pc_per_sec"] == pytest.approx(384.0)
    assert [r["pc_s"] for r in agg["hosts"]] == \
        [pytest.approx(256.0), pytest.approx(128.0)]
    # ring + JSONL: the aggregate IS the durable record
    assert len(fc.history) == 2 and fc.aggregate() is agg
    brief = fc.brief()
    assert brief["sweeps"] == 2
    assert [h["endpoint"] for h in brief["hosts"]] == ["m0:1", "m1:1"]
    fc.stop()
    lines = [json.loads(ln) for ln in
             open(hist, encoding="utf-8").read().splitlines()]
    assert len(lines) == 2
    assert lines[1]["cohort"]["pc_per_sec"] == pytest.approx(384.0)
    # prometheus rendering: cohort totals bare, per-host labeled
    prom = fc.render_prometheus()
    assert "fleet_pc_per_sec 384.0" in prom
    assert 'fleet_host_pc_per_sec{host="m0:1"} 256.0' in prom


def test_set_members_keeps_surviving_state():
    """An elastic resize re-points the scrape set; survivors keep
    their handshake (no gratuitous re-measure), dropped members
    leave."""
    clk = FakeClock()
    cohort = FakeCohort(clk)
    cohort.add("m0:1", _member_tele(steps=1), run_id="r0",
               offset_s=2.0)
    cohort.add("m1:1", _member_tele(steps=1), run_id="r1")
    fc = _collector(clk, cohort, ["m0:1", "m1:1"])
    fc.sample()
    assert len(cohort.commits) == 2
    fc.set_members(["m0:1"])  # shrink to the survivor
    clk.t += 1.0
    agg = fc.sample()
    assert [r["endpoint"] for r in agg["hosts"]] == ["m0:1"]
    assert len(cohort.commits) == 2  # survivor NOT re-handshaked
    assert agg["hosts"][0]["clock_offset_s"] == pytest.approx(2.0)


def test_disabled_path_is_the_shared_singleton():
    off = FleetCollector.create(obs.Telemetry.memory("x"), members=())
    assert off is FleetCollector.disabled()
    assert FleetCollector.create(
        obs.Telemetry.disabled(), members=["m:1"]) is off
    assert FleetCollector.create(None, members=["m:1"]) is off
    before = threading.enumerate()
    assert off.start() is off
    assert off.sample() == {} and off.aggregate() == {}
    assert off.brief() == {}
    off.set_members(["m:1"])
    off.stop()
    assert threading.enumerate() == before


# ---- real-socket seams ----------------------------------------------

def test_fleet_endpoint_404_without_collector():
    t = obs.Telemetry.memory("m").make_threadsafe()
    srv = obs.MetricsServer(t, port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.bound_port}/fleet", timeout=5)
        assert e.value.code == 404
    finally:
        srv.stop()


def test_clock_commit_persists_manifest_block(tmp_path):
    """The member half of the handshake: a committed offset lands in
    the run manifest as the `clock` block: a fresh anchor pair, the
    measured offset, the sample count."""
    run = obs.Telemetry.create(str(tmp_path), component="train")
    srv = obs.MetricsServer(run, port=0,
                            identity={"run_id": run.run_id}).start()
    try:
        base = f"http://127.0.0.1:{srv.bound_port}"
        out = json.load(urllib.request.urlopen(
            base + "/clock?commit=1&offset_s=0.25&samples=5",
            timeout=5))
        assert out["committed"] is True
        manifest = json.load(
            open(os.path.join(run.run_dir, "manifest.json")))
        clock = manifest["clock"]
        assert clock["wall_offset_s"] == pytest.approx(0.25)
        assert clock["samples"] == 5
        assert isinstance(clock["mono"], float)
        assert isinstance(clock["wall"], float)
        # malformed commit: refused, manifest untouched
        bad = json.load(urllib.request.urlopen(
            base + "/clock?commit=1", timeout=5))
        assert bad["committed"] is False
    finally:
        srv.stop()
        run.close()


def test_supervisor_hosts_collector_and_rules():
    from code2vec_tpu_torch.training.supervisor import Supervisor
    sup = Supervisor(
        lambda *a: None, num_procs=1,
        telemetry=obs.Telemetry.memory("sup").make_threadsafe())
    # the cohort tickets ride the stock supervisor engine (quiet until
    # the fleet publishes: threshold rules on absent series never fire)
    rules = {r["rule"] for r in sup.alerts.status_table()}
    assert {"cohort_straggler", "cohort_divergence"} <= rules
    # null collector: attach is a no-op, topology stays fleet-free
    sup.attach_fleet(FleetCollector.disabled(), ["x:1"])
    assert sup.fleet is None
    assert "fleet" not in sup.cohort_topology()
    # live collector: cohort snapshot joins the stall-dump topology

    def dead(_url):
        raise OSError("down")

    clk = FakeClock()
    fc = FleetCollector(sup.telemetry, members=["m:1"], clock=clk,
                        wall=clk.wall, fetch=dead)
    sup.attach_fleet(fc, ["m:1"])
    assert sup.fleet is fc and fc._alerts is sup.alerts
    fc.sample()
    topo = sup.cohort_topology()
    assert topo["fleet"]["sweeps"] == 1
    assert topo["fleet"]["cohort"]["hosts_up"] == 0




def test_fleet_endpoint_serves_the_aggregate():
    """With a collector attached, `/fleet` serves its latest aggregate
    as JSON and `?format=prom` as Prometheus text."""
    clk = FakeClock()
    cohort = FakeCohort(clk)
    cohort.add("m0:1", _member_tele(step_ms=12.0, steps=4), run_id="r0",
               offset_s=0.5)
    fc = _collector(clk, cohort, ["m0:1"])
    fc.sample()
    srv = obs.MetricsServer(fc.telemetry, port=0, fleet=fc).start()
    try:
        base = f"http://127.0.0.1:{srv.bound_port}/fleet"
        agg = json.load(urllib.request.urlopen(base, timeout=5))
        assert agg["cohort"]["hosts_up"] == 1
        assert agg["hosts"][0]["clock_offset_s"] == pytest.approx(0.5)
        prom = urllib.request.urlopen(base + "?format=prom",
                                      timeout=5).read().decode()
        assert "fleet_hosts_up 1.0" in prom
        assert 'fleet_host_clock_offset_s{host="m0:1"} 0.5' in prom
    finally:
        srv.stop()


def _scripted_cohort(clk):
    """Three members with counters, step/phase timers, losses and
    digests: one scripted scrape history for both collectors."""
    cohort = FakeCohort(clk)
    for i, (step, phase, loss) in enumerate(((100.0, 10.0, 0.5),
                                             (110.0, 12.0, 0.5),
                                             (300.0, 40.0, 0.6))):
        t = _member_tele(step_ms=step, steps=10, examples=0)
        t.record_ms("train/phase/backward_ms", phase)
        t.gauge("train/max_contexts", 8, emit=False)
        t.gauge("train/loss", loss, emit=False)
        t.gauge("train/loss_step", 20.0, emit=False)
        t.gauge("train/params_digest", 100.0 + i, emit=False)
        t.gauge("train/params_digest_step", 20.0, emit=False)
        cohort.add(f"m{i}:1", t, run_id=f"r{i}", process_index=i,
                   offset_s=0.1 * i,
                   legs=[(0.001, 0.002), (0.003, 0.001), (0.002, 0.002)])
    return cohort


def test_aggregates_match_the_jax_collector():
    """The same scripted members, fetched through one scripted cohort
    per collector, over three sweeps (a rate window, a restart with a
    new run_id): the JAX collector and the port's give equal
    aggregates, gauges and Prometheus text."""
    out = {}
    for pkg in ("jax", "port"):
        clk = FakeClock()
        cohort = _scripted_cohort(clk)
        cls, tele = ((JFleetCollector, JTelemetry) if pkg == "jax"
                     else (FleetCollector, obs.Telemetry))
        fc = cls(tele.memory("sup").make_threadsafe(),
                 members=["m0:1", "m1:1", "m2:1"], clock=clk,
                 wall=clk.wall, fetch=cohort.fetch, handshake_samples=3)
        aggs = [fc.sample()]
        clk.t += 2.0
        for i, m in enumerate(cohort.members.values()):
            m["tele"].count("train/examples", 64 * (i + 1))
        aggs.append(fc.sample())
        cohort.members["m1:1"].update(
            tele=_member_tele(step_ms=105.0, steps=2, examples=8),
            run_id="r1b", offset_s=-0.25)
        clk.t += 1.0
        aggs.append(fc.sample())
        out[pkg] = (aggs, {k: v for k, v in fc.telemetry.gauges.items()
                           if k.startswith("fleet/")},
                    fc.render_prometheus(), cohort.commits)
    assert out["port"] == out["jax"]
    aggs = out["port"][0]
    assert aggs[1]["cohort"]["straggler_host"] == "m2:1"
    assert aggs[1]["cohort"]["divergence"] == 1
    assert aggs[2]["hosts"][1]["run_id"] == "r1b"

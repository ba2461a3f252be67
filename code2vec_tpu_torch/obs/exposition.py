"""Live metrics plane: a copy of obs/exposition.py of the JAX package.
Pull-based HTTP exposition of the telemetry registry.

The event log is record-then-analyze: JSONL on disk, summarized after
the run. Nothing answers "is this run healthy right now" without
tailing files. This module is the standard production answer — a tiny
stdlib HTTP server on a daemon thread, scrapable by Prometheus or curl:

  - `/metrics` — the registry snapshot in Prometheus text exposition
    format (version 0.0.4): counters as `counter`, gauges as `gauge`,
    timer histograms as `summary` (p50/p95/p99 quantiles + _sum/_count
    from the exact TimerStat fields). Gauge freshness rides along as
    a `gauge_age_seconds{gauge="..."}` family (telemetry.gauge_ages —
    a dead producer's queue-depth gauge keeps its last VALUE but its
    age grows, so scrapers can mark it stale instead of trusting it).
    Watchdog component liveness and alert states are exported too
    (`component_beat_age_seconds`, `component_stalled`,
    `alert_active`).
  - `/healthz` — component liveness fed by the watchdog's heartbeat
    table: 200 while every ACTIVE component is inside its deadline,
    503 the moment one is past it (computed from the live heartbeat
    timestamps at request time, not the edge-trigger memory — a load
    balancer probing readiness needs the current truth, not the event
    log), or while a page-severity alert fires. Serving readiness
    gates on this.
  - `/vars` — the raw JSON snapshot (registry + health monitor table
    + alert table + watchdog components), for humans and tools that
    want structure instead of the Prometheus grammar. It leads with an
    `identity` block: run_id, process index and count (the trainer's
    rank and world; 0 of 1 by default), the distributed backend, the
    devices (the card's name and count,
    obs/telemetry.device_topology) and the server's start
    wall/monotonic pair.
  - `/clock` — the clock handshake: a paired monotonic+wall timestamp
    sampled at response-build time, plus the identity block. A
    collector brackets K of these with its own wall clock to estimate
    this host's wall-clock offset, then COMMITS the measurement back
    (`/clock?commit=1&offset_s=...`): the run writes a `clock` block
    into its manifest (Telemetry.update_manifest).
  - `/fleet`: only when a FleetCollector is attached (the supervisor
    process, obs/fleet.py): the latest cohort aggregate as JSON, or
    Prometheus text with `?format=prom`; 404 otherwise.

Snapshot-don't-lock discipline: handler threads never take a lock the
hot path contends on — they read dict snapshots (atomic under the GIL
against the single-writer fast path; the threadsafe registries lock
internally) and TimerStat's copy-then-sort percentile reads. A scrape
can see metric A from tick k and metric B from tick k+1; it can never
block a training step.

Lifecycle: `create()` returns the shared disabled singleton unless a
port is configured AND the telemetry registry is live, so every call
site wires unconditionally and pays one boolean check when off.
`start()` binds (port 0 = ephemeral, `bound_port` tells the truth)
and serves on a daemon thread; `stop()` shuts down cleanly.
"""

from __future__ import annotations

import http.server
import json
import re
import threading
import time
import urllib.parse
from typing import Any, Callable, Dict, List, NamedTuple, Optional

from code2vec_tpu_torch.obs.telemetry import device_topology

__all__ = ["LivePlane", "MetricsServer", "build_live_plane",
           "render_prometheus"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

# quantiles the summary blocks export — TimerStat.summary()'s exact set
_QUANTILES = ((0.5, "p50_ms"), (0.95, "p95_ms"), (0.99, "p99_ms"))


def _san(name: str) -> str:
    """Prometheus metric-name sanitization: `train/step_ms` ->
    `train_step_ms` (labels keep the raw name where identity
    matters)."""
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _fmt(v: Any) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if isinstance(v, float) else str(v)


def render_prometheus(telemetry, watchdog=None, health=None,
                      alerts=None) -> str:
    """The /metrics payload: one registry snapshot in text exposition
    format 0.0.4. Pure function of the snapshot so tests (and
    obs/promtext.py's parser) can round-trip it without a socket."""
    lines: List[str] = []
    counters = dict(telemetry.counters)
    gauges = dict(telemetry.gauges)
    ages = telemetry.gauge_ages()
    timers = dict(telemetry.timers)

    for name in sorted(counters):
        n = _san(name)
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {_fmt(counters[name])}")
    for name in sorted(gauges):
        n = _san(name)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {_fmt(gauges[name])}")
    if ages:
        lines.append("# HELP gauge_age_seconds seconds since each "
                     "gauge was last set (stale gauge = dead producer)")
        lines.append("# TYPE gauge_age_seconds gauge")
        for name in sorted(ages):
            lines.append(f'gauge_age_seconds{{gauge="{_san(name)}"}} '
                         f"{_fmt(round(ages[name], 3))}")
    for name in sorted(timers):
        stat = timers[name]
        n = _san(name)
        s = stat.summary() if stat.count else None
        lines.append(f"# TYPE {n} summary")
        for q, key in _QUANTILES:
            v = s[key] if s else float("nan")
            lines.append(f'{n}{{quantile="{q}"}} {_fmt(v)}')
        lines.append(f"{n}_sum {_fmt(round(stat.total_ms, 4))}")
        lines.append(f"{n}_count {stat.count}")

    if watchdog is not None and watchdog.enabled:
        status = watchdog.status()
        if status:
            lines.append("# TYPE component_beat_age_seconds gauge")
            for comp in sorted(status):
                row = status[comp]
                lines.append(
                    f'component_beat_age_seconds{{component='
                    f'"{_san(comp)}"}} {_fmt(round(row["age_s"], 3))}')
            lines.append("# TYPE component_stalled gauge")
            for comp in sorted(status):
                lines.append(
                    f'component_stalled{{component="{_san(comp)}"}} '
                    f"{1 if status[comp]['stalled'] else 0}")
    if alerts is not None and alerts.enabled:
        rows = alerts.status_table()
        if rows:
            lines.append("# TYPE alert_active gauge")
            for row in rows:
                lines.append(
                    f'alert_active{{rule="{_san(row["rule"])}"}} '
                    f"{1 if row['state'] == 'firing' else 0}")
    if health is not None and health.enabled:
        rows = health.status_table()
        if rows:
            # monitor VALUES are already health/* gauges; this family
            # adds the ok/bad verdicts in scrapeable form
            lines.append("# TYPE health_status gauge")
            for row in rows:
                up = {"ok": 0, "unknown": 0}.get(row["status"], 1)
                lines.append(
                    f'health_status{{monitor="{_san(row["monitor"])}"'
                    f'}} {up}')
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Daemon-thread HTTP server exposing /metrics, /healthz and
    /vars over one telemetry registry (plus the watchdog / health /
    alert tables when attached). Construct via `create()`."""

    def __init__(self, telemetry, *, port: int, host: str = "",
                 watchdog=None, health=None, alerts=None, fleet=None,
                 identity: Optional[Dict[str, Any]] = None,
                 log: Optional[Callable[[str], None]] = None):
        self.enabled = True
        self.telemetry = telemetry
        self.watchdog = watchdog
        self.health = health
        self.alerts = alerts
        self.fleet = fleet
        self.port = port
        self.host = host
        self.bound_port: Optional[int] = None
        # identity block: who this endpoint is, stamped at construction
        # so the wall/monotonic pair anchors the process start (process
        # 0 of 1 unless the caller's identity says otherwise)
        self.identity: Dict[str, Any] = {
            "run_id": getattr(telemetry, "run_id", ""),
            "process_index": 0,
            "process_count": 1,
            "devices": device_topology(),
            "start_wall": time.time(),
            "start_mono": time.monotonic(),
        }
        self.identity.update(identity or {})
        self._log = log or (lambda _m: None)
        self._lock = threading.Lock()
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ---- construction ----
    @classmethod
    def create(cls, telemetry, *, port: int, **kw) -> "MetricsServer":
        """The wired-everywhere entry: disabled singleton unless a
        port is configured (`--metrics_port`, 0 = off) and the
        registry is live."""
        if port <= 0 or telemetry is None or not telemetry.enabled:
            return _NULL_SERVER
        return cls(telemetry, port=port, **kw)

    @classmethod
    def disabled(cls) -> "MetricsServer":
        return _NULL_SERVER

    # ---- request handling ----
    def _healthz(self) -> tuple:
        """(http_status, body_dict): 503 when any ACTIVE watchdog
        component is past its deadline RIGHT NOW, or a page-severity
        alert is firing; 200 otherwise. Liveness is recomputed from
        the heartbeat table at request time — a probe needs current
        truth, not the edge-trigger memory."""
        components: Dict[str, Any] = {}
        stalled: List[str] = []
        if self.watchdog is not None and self.watchdog.enabled:
            components = self.watchdog.status()
            stalled = [c for c, row in components.items()
                       if row["stalled"]]
        firing: List[str] = []
        if self.alerts is not None and self.alerts.enabled:
            firing = [r["rule"] for r in self.alerts.status_table()
                      if r["state"] == "firing"
                      and r.get("severity") == "page"]
        ok = not stalled and not firing
        body = {"status": "ok" if ok else "unhealthy",
                "stalled": stalled, "alerts_firing": firing,
                "components": components}
        return (200 if ok else 503), body

    def _vars(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"ts": time.time(),
                               "run_id": self.telemetry.run_id,
                               "identity": dict(self.identity),
                               **self.telemetry.summary()}
        out["gauge_age_s"] = {k: round(v, 3) for k, v in
                              self.telemetry.gauge_ages().items()}
        if self.watchdog is not None and self.watchdog.enabled:
            out["components"] = self.watchdog.status()
        if self.health is not None and self.health.enabled:
            out["health"] = self.health.status_table()
        if self.alerts is not None and self.alerts.enabled:
            out["alerts"] = self.alerts.status_table()
        return out

    def _clock(self, params: Dict[str, List[str]]) -> Dict[str, Any]:
        """The clock handshake endpoint. Plain GET: one paired
        monotonic+wall sample (the monotonic reading shares the
        tracer's timebase, so a measured wall offset can realign span
        t0s) plus the identity block. `?commit=1&offset_s=X`: the
        collector's measured offset comes BACK — persist it, with a
        fresh anchor pair, as the run manifest's `clock` block, which
        aligns this run's monotonic timeline onto the collector's wall
        clock. Memory registries have no manifest; `committed` reports
        the truth either way."""
        out: Dict[str, Any] = {"mono": time.monotonic(),
                               "wall": time.time(),
                               "identity": dict(self.identity)}
        if params.get("commit"):
            try:
                offset_s = float(params["offset_s"][0])
            except (KeyError, IndexError, ValueError):
                out["committed"] = False
                out["error"] = "commit needs a numeric offset_s"
                return out
            block = {"mono": out["mono"], "wall": out["wall"],
                     "wall_offset_s": offset_s}
            try:
                block["samples"] = int(params["samples"][0])
            except (KeyError, IndexError, ValueError):
                pass
            out["committed"] = bool(
                getattr(self.telemetry, "update_manifest",
                        lambda **_kw: False)(clock=block))
        return out

    def _respond(self, path: str) -> tuple:
        """(status, content_type, payload_bytes) for one GET; `path`
        may carry a query string."""
        path, _, query = path.partition("?")
        if path == "/metrics":
            text = render_prometheus(self.telemetry, self.watchdog,
                                     self.health, self.alerts)
            return (200, "text/plain; version=0.0.4; charset=utf-8",
                    text.encode("utf-8"))
        if path == "/healthz":
            status, body = self._healthz()
            return (status, "application/json",
                    json.dumps(body, default=str).encode("utf-8"))
        if path == "/vars":
            return (200, "application/json",
                    json.dumps(self._vars(), default=str,
                               indent=1).encode("utf-8"))
        if path == "/clock":
            body = self._clock(urllib.parse.parse_qs(query))
            return (200, "application/json",
                    json.dumps(body, default=str).encode("utf-8"))
        if path == "/fleet":
            fleet = self.fleet
            if fleet is None or not getattr(fleet, "enabled", False):
                return (404, "text/plain",
                        b"no fleet collector attached\n")
            params = urllib.parse.parse_qs(query)
            if params.get("format", [""])[0] == "prom":
                return (200,
                        "text/plain; version=0.0.4; charset=utf-8",
                        fleet.render_prometheus().encode("utf-8"))
            return (200, "application/json",
                    json.dumps(fleet.aggregate(), default=str,
                               indent=1).encode("utf-8"))
        return (404, "text/plain",
                b"not found (try /metrics, /healthz, /vars, /clock"
                b", /fleet)\n")

    # ---- lifecycle ----
    def start(self) -> "MetricsServer":
        with self._lock:
            if self._httpd is not None:
                return self
            server = self

            class _Handler(http.server.BaseHTTPRequestHandler):
                def do_GET(self):  # noqa: N802 — http.server API
                    try:
                        status, ctype, payload = server._respond(
                            self.path)
                    except Exception as e:  # noqa: BLE001 — a scrape
                        # must never take the run down with it
                        status, ctype = 500, "text/plain"
                        payload = repr(e).encode("utf-8")
                    self.send_response(status)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length",
                                     str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)

                def log_message(self, fmt, *args):
                    pass  # scrape chatter stays out of the train log

            self._httpd = http.server.ThreadingHTTPServer(
                (self.host, self.port), _Handler)
            self._httpd.daemon_threads = True
            self.bound_port = self._httpd.server_address[1]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="metrics-exposition")
            self._thread.start()
        self._log(f"metrics: serving /metrics /healthz /vars /clock"
                  f"{' /fleet' if self.fleet is not None else ''} on "
                  f"port {self.bound_port}")
        return self

    def stop(self) -> None:
        with self._lock:
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5)


class _NullMetricsServer(MetricsServer):
    """The `--metrics_port`-unset path: shared no-op singleton."""

    def __init__(self):
        self.enabled = False
        self.telemetry = None
        self.fleet = None
        self.identity = {}
        self.bound_port = None

    def start(self):
        return self

    def stop(self) -> None:
        pass


_NULL_SERVER = _NullMetricsServer()


class LivePlane(NamedTuple):
    """The three live-plane engines one call site wires together.
    Each is its own shared no-op singleton when its flag is off, so
    `start()`/`stop()` are unconditional."""

    health: Any
    alerts: Any
    metrics: Any

    def start(self) -> "LivePlane":
        self.health.start()
        self.metrics.start()
        return self

    def stop(self) -> None:
        self.health.stop()
        self.metrics.stop()


def build_live_plane(telemetry, *, metrics_port: int, alerts_mode: str,
                     alerts_rules: Optional[str],
                     health_every_s: float, watchdog, monitors,
                     default_rules: Callable[[], list],
                     identity: Optional[Dict[str, Any]] = None,
                     log: Optional[Callable[[str], None]] = None
                     ) -> LivePlane:
    """ONE wiring for the live metrics plane, shared by the train loop
    and the PredictionServer (hand-synced copies of cross-thread wiring
    drift): health monitors on a cadence thread,
    alert rules evaluated at each sweep's tail (so they always see the
    gauges that sweep just wrote), both attached to the watchdog's
    stall dump, and the /metrics //healthz //vars server over all of
    it. A user-supplied EMPTY rule file is honored as "no rules" —
    only the absence of a file falls back to `default_rules()`."""
    from code2vec_tpu_torch.obs.alerts import AlertEngine, load_rules
    from code2vec_tpu_torch.obs.health import HealthEngine

    live = metrics_port > 0 or alerts_mode != "off"
    health = HealthEngine.create(telemetry if live else None,
                                 interval_s=health_every_s, log=log)
    health.add(*monitors)
    rules = load_rules(alerts_rules)
    alerts = AlertEngine.create(
        telemetry, mode=alerts_mode,
        rules=rules if rules is not None else default_rules(),
        log=log)
    if alerts.enabled:
        health.add_listener(alerts.evaluate)
    watchdog.attach(health=health, alerts=alerts)
    metrics = MetricsServer.create(
        telemetry, port=metrics_port, watchdog=watchdog,
        health=health, alerts=alerts, identity=identity, log=log)
    return LivePlane(health, alerts, metrics)

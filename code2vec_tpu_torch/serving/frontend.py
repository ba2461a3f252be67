"""HTTP front end for the replica fleet: a copy of serving/frontend.py of
the JAX package.

A stdlib daemon-thread HTTP server (the `obs/exposition.MetricsServer`
pattern: inner handler class, ThreadingHTTPServer, port 0 = ephemeral
with `bound_port` telling the truth) in front of a `ReplicaPool`:

  - `POST /predict` — JSON `{"lines": [...], "deadline_ms"?: N}` ->
    `{"predictions": [...], "n": K}`. Dispatch, batching, caching and
    admission control all live in the pool and its replicas; this layer
    only translates HTTP <-> the in-process surface. `ServerOverloaded`
    maps to 429 (shed is an explicit outcome, not a 500), client input
    errors to 400, anything else to 500, each with a JSON error body.
  - `GET /healthz` — readiness gates on the POOL: 503 until at least
    one replica is ready (and, when an alert engine is attached, while
    a page-severity rule is firing). Load balancers probe this during
    rolling swaps; the one-replica-at-a-time swap keeps it 200
    throughout.
  - `GET /metrics` — the Prometheus exposition (`render_prometheus`)
    over the shared serving registry: the `serve/*` counters, pool
    gauges and alert states.
  - `GET /pool` — the fleet-style pool table (per-replica rows and
    aggregates, with the reload and autoscaler status) as JSON.

One change from the JAX package's: the listen backlog is 128, not the
stdlib's 5 (`_Server`).

Stdlib-only at module scope (tests/test_torch_serving_fleet.py imports
and round-trips it with torch blocked). `create()` follows the
disabled-singleton discipline: `--serve_port` 0/unset returns a shared
no-op, so call sites wire unconditionally; direct construction with
port=0 binds an ephemeral port (tests).
"""

from __future__ import annotations

import http.server
import json
import threading
from typing import Any, Callable, Dict, List, Optional

from code2vec_tpu_torch.common import MethodPredictionResults
from code2vec_tpu_torch.obs.exposition import render_prometheus
from code2vec_tpu_torch.serving.batcher import ServerOverloaded

__all__ = ["ServingFrontend", "serialize_prediction"]

# client mistakes the pool re-raises untouched; the HTTP layer's 400
# class (mirrors replicas._INPUT_ERRORS — one bad request is the
# CLIENT's problem)
_CLIENT_ERRORS = (ValueError, KeyError, TypeError)

_MAX_BODY_BYTES = 16 << 20  # refuse absurd bodies before reading them


class _Server(http.server.ThreadingHTTPServer):
    # the listen backlog: the stdlib's 5 overflows when a burst of client
    # connections arrives while the accept thread waits for the
    # interpreter lock, and the kernel retries a dropped SYN only after
    # a second, which lands in the tail latency
    request_queue_size = 128


def serialize_prediction(res: MethodPredictionResults) -> Dict[str, Any]:
    """JSON shape for one method's predictions. `code_vector` stays
    out — it is a device-sized array nobody wants in a latency-bound
    response (a future `?vectors=1` can opt in)."""
    return {
        "original_name": res.original_name,
        "predictions": [{"name": p["name"],
                         "probability": float(p["probability"])}
                        for p in res.predictions],
        "attention_paths": [{"source_token": ap.source_token,
                             "path": ap.path,
                             "target_token": ap.target_token,
                             "attention_score":
                                 float(ap.attention_score)}
                            for ap in res.attention_paths],
    }


class ServingFrontend:
    """One HTTP server over one `ReplicaPool` (or anything exposing
    `predict_lines` / `ready_count` / `pool_table`)."""

    def __init__(self, pool, *, port: int, host: str = "",
                 telemetry=None, health=None, alerts=None,
                 reload_manager=None, autoscaler=None,
                 log: Optional[Callable[[str], None]] = None):
        self.enabled = True
        self.pool = pool
        tele = telemetry if telemetry is not None \
            else getattr(pool, "telemetry", None)
        self.telemetry = tele
        self.health = health
        self.alerts = alerts
        self.reload_manager = reload_manager
        self.autoscaler = autoscaler
        self.port = port
        self.host = host
        self.bound_port: Optional[int] = None
        self._log = log or (lambda _m: None)
        self._lock = threading.Lock()
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ---- construction ----
    @classmethod
    def create(cls, pool, *, port: int, **kw) -> "ServingFrontend":
        """Disabled singleton unless `--serve_port` is set (0 = off;
        tests that want an ephemeral port construct directly)."""
        if port <= 0 or pool is None:
            return _NULL_FRONTEND
        return cls(pool, port=port, **kw)

    @classmethod
    def disabled(cls) -> "ServingFrontend":
        return _NULL_FRONTEND

    # ---- request handling ----
    def _healthz(self) -> tuple:
        """Readiness = the pool can take a request RIGHT NOW: at least
        one ready replica, and no page-severity alert firing."""
        table = self.pool.pool_table()
        firing: List[str] = []
        if self.alerts is not None and self.alerts.enabled:
            firing = [r["rule"] for r in self.alerts.status_table()
                      if r["state"] == "firing"
                      and r.get("severity") == "page"]
        ok = table["ready"] > 0 and not firing
        body = {"status": "ok" if ok else "unhealthy",
                "ready": table["ready"], "size": table["size"],
                "target": table["target"],
                "generation": table["generation"],
                "alerts_firing": firing}
        return (200 if ok else 503), body

    def _predict(self, body: bytes) -> tuple:
        try:
            req = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            return 400, {"error": "body must be JSON"}
        if not isinstance(req, dict) \
                or not isinstance(req.get("lines"), list) \
                or not all(isinstance(x, str) for x in req["lines"]):
            return 400, {"error":
                         'expected {"lines": ["<extractor line>", ...]'
                         ', "deadline_ms"?: <number>}'}
        deadline_ms = req.get("deadline_ms")
        if deadline_ms is not None \
                and not isinstance(deadline_ms, (int, float)):
            return 400, {"error": "deadline_ms must be a number"}
        try:
            results = self.pool.predict_lines(req["lines"],
                                              deadline_ms=deadline_ms)
        except ServerOverloaded as e:
            return 429, {"error": str(e), "shed": True}
        except _CLIENT_ERRORS as e:
            return 400, {"error": str(e)}
        return 200, {"predictions": [serialize_prediction(r)
                                     for r in results],
                     "n": len(results)}

    def _respond_get(self, path: str) -> tuple:
        path = path.partition("?")[0]
        if path == "/metrics":
            text = render_prometheus(self.telemetry, None, self.health,
                                     self.alerts)
            return (200, "text/plain; version=0.0.4; charset=utf-8",
                    text.encode("utf-8"))
        if path == "/healthz":
            status, body = self._healthz()
            return (status, "application/json",
                    json.dumps(body, default=str).encode("utf-8"))
        if path == "/pool":
            table = self.pool.pool_table()
            if self.reload_manager is not None \
                    and self.reload_manager.enabled:
                table["reload"] = self.reload_manager.status()
            if self.autoscaler is not None \
                    and self.autoscaler.enabled:
                table["autoscale"] = self.autoscaler.status()
            return (200, "application/json",
                    json.dumps(table, default=str,
                               indent=1).encode("utf-8"))
        return (404, "text/plain",
                b"not found (try POST /predict, GET /healthz, "
                b"/metrics, /pool)\n")

    # ---- lifecycle ----
    def start(self) -> "ServingFrontend":
        with self._lock:
            if self._httpd is not None:
                return self
            front = self

            class _Handler(http.server.BaseHTTPRequestHandler):
                def _send(self, status: int, ctype: str,
                          payload: bytes) -> None:
                    self.send_response(status)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length",
                                     str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)

                def do_GET(self):  # noqa: N802 — http.server API
                    try:
                        status, ctype, payload = front._respond_get(
                            self.path)
                    except Exception as e:  # noqa: BLE001 — a probe
                        # must never take the serving plane down
                        status, ctype = 500, "text/plain"
                        payload = repr(e).encode("utf-8")
                    self._send(status, ctype, payload)

                def do_POST(self):  # noqa: N802 — http.server API
                    try:
                        if self.path.partition("?")[0] != "/predict":
                            self._send(404, "text/plain",
                                       b"POST /predict only\n")
                            return
                        try:
                            n = int(self.headers.get(
                                "Content-Length", "0"))
                        except ValueError:
                            n = -1
                        if n < 0 or n > _MAX_BODY_BYTES:
                            self._send(400, "application/json",
                                       b'{"error": "bad Content-'
                                       b'Length"}')
                            return
                        status, body = front._predict(self.rfile.read(n))
                        self._send(status, "application/json",
                                   json.dumps(body, default=str)
                                   .encode("utf-8"))
                    except Exception as e:  # noqa: BLE001 — one bad
                        # request thread must not kill the listener
                        self._send(500, "application/json",
                                   json.dumps({"error": repr(e)})
                                   .encode("utf-8"))

                def log_message(self, fmt, *args):
                    pass  # request chatter stays out of the serve log

            self._httpd = _Server((self.host, self.port), _Handler)
            self._httpd.daemon_threads = True
            self.bound_port = self._httpd.server_address[1]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="serving-frontend")
            self._thread.start()
        self._log(f"serving: POST /predict, GET /healthz /metrics "
                  f"/pool on port {self.bound_port}")
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


class _NullServingFrontend(ServingFrontend):
    """The `--serve_port`-unset path: shared no-op singleton."""

    def __init__(self):
        self.enabled = False
        self.pool = None
        self.telemetry = None
        self.bound_port = None

    def start(self):
        return self

    def stop(self) -> None:
        pass


_NULL_FRONTEND = _NullServingFrontend()

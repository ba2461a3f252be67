"""code2vec_tpu_torch.obs: the run's telemetry, a copy of the JAX
package's obs/ for what the port has.

One registry (`Telemetry`: counters, gauges, p50/p95/p99 timer
histograms), sinks (a per-run JSONL event log and manifest under
`--telemetry_dir`, a TensorBoard adapter over `ScalarWriter`, stdout),
host-vs-device span helpers, request- and step-scoped tracing
(`Tracer`), the stall watchdog (`Watchdog`), the train-loop recorder
(`TrainStepRecorder`), and the live metrics plane: health monitors
(`HealthEngine`), alert rules (`AlertEngine`) and the `/metrics`,
`/healthz`, `/vars`, `/clock`, `/fleet` server (`MetricsServer`), wired
together by `build_live_plane`; the sampled phase profiler
(`PhaseProfiler`) and the cohort collector (`FleetCollector`) that the
restart supervisor hosts.
"""

from code2vec_tpu_torch.obs.alerts import (AlertEngine,  # noqa: F401
                                           AlertError, AlertRule,
                                           load_rules)
from code2vec_tpu_torch.obs.exposition import (  # noqa: F401
    LivePlane, MetricsServer, build_live_plane, render_prometheus)
from code2vec_tpu_torch.obs.fleet import (FleetCollector,  # noqa: F401
                                          fleet_alert_rules)
from code2vec_tpu_torch.obs.health import HealthEngine  # noqa: F401
from code2vec_tpu_torch.obs.loop import (TrainStepRecorder,  # noqa: F401
                                         infeed_produce_instrument)
from code2vec_tpu_torch.obs.phases import (PhaseProfiler,  # noqa: F401
                                           ProbeKit)
from code2vec_tpu_torch.obs.sinks import (JsonlSink, ScalarSink,  # noqa: F401
                                          StdoutSink)
from code2vec_tpu_torch.obs.telemetry import (  # noqa: F401
    SUMMARY_PERCENTILES, Telemetry, TimerStat, device_sync,
    format_latency_line)
from code2vec_tpu_torch.obs.trace import (SpanChannel,  # noqa: F401
                                          SpanContext, Tracer, TraceSpan)
from code2vec_tpu_torch.obs.watchdog import (Heartbeat,  # noqa: F401
                                             StallError, Watchdog)

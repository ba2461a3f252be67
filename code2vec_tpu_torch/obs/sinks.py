"""Telemetry sinks: where `Telemetry.event()` records go. A copy of
obs/sinks.py of the JAX package.

Three concrete sinks, all host-side and stdlib-only at import time:

  - `JsonlSink` — the per-run structured event log (`events.jsonl`
    next to the run's `manifest.json`), one JSON object per line.
    The durable artifact of a run.
  - `ScalarSink` — TensorBoard adapter: re-emits numeric fields of
    per-step events through an externally-owned
    `training/scalars.ScalarWriter` (reused, never reopened — the
    train loop already holds one for its loss/throughput scalars).
  - `StdoutSink` — forwards non-step events through a log callable
    (per-step volume would spam the console; steps stay in the JSONL).

A sink is anything with `write(event: dict)` and `close()`.
"""

from __future__ import annotations

import json
from typing import Callable, Sequence


def _json_default(o):
    try:
        return float(o)  # numpy / torch scalars
    except Exception:
        return str(o)


class JsonlSink:
    """Append-mode JSONL event log, flushed per event (step cadence is
    hundreds of Hz at worst; durability beats buffering for a log whose
    main consumer is a post-mortem)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", encoding="utf-8")

    def write(self, event: dict) -> None:
        self._f.write(json.dumps(event, default=_json_default) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class ScalarSink:
    """Re-emit per-step event fields as TensorBoard scalars under
    `telemetry/…`. Owns nothing: the ScalarWriter is the train loop's
    (a no-op writer when --tensorboard is unset, so attaching this sink
    unconditionally costs one isinstance-free call per step event)."""

    def __init__(self, writer):
        self._writer = writer

    def write(self, event: dict) -> None:
        if event.get("kind") != "step":
            return
        step = event.get("step")
        if step is None:
            return
        scalars = {f"telemetry/{k}": v for k, v in event.items()
                   if k not in ("kind", "ts", "step")
                   and isinstance(v, (int, float))
                   and not isinstance(v, bool)}
        if scalars:
            self._writer.write(int(step), scalars)

    def close(self) -> None:
        pass  # the train loop owns (and closes) the ScalarWriter


class StdoutSink:
    """Human-visible mirror of the low-volume events (run lifecycle,
    gauges, summaries) through the run's logger."""

    def __init__(self, log: Callable[[str], None],
                 skip_kinds: Sequence[str] = ("step", "span",
                                              "phase")):
        self._log = log
        self._skip = frozenset(skip_kinds)

    def write(self, event: dict) -> None:
        if event.get("kind") in self._skip:
            return
        body = {k: v for k, v in event.items()
                if k not in ("kind", "ts")}
        self._log(f"telemetry[{event.get('kind')}] "
                  + json.dumps(body, default=_json_default,
                               sort_keys=True))

    def close(self) -> None:
        pass

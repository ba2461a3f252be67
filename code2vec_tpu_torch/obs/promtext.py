"""Prometheus text-exposition parsing and counter-rate differencing: a
copy of obs/promtext.py of the JAX package, the one implementation
every scrape consumer shares.

  - `parse_prometheus` — text exposition format 0.0.4 ->
    `{metric: [(labels, value), ...]}` (the inverse of
    obs/exposition.render_prometheus; tests round-trip the pair).
  - `scalar` / `labeled` — sample lookup helpers.
  - `CounterRates` — consecutive-poll differencing of cumulative
    counters: a counter that went BACKWARD means the process restarted
    (a relaunch zeroes its counters), so the rate clamps to what the NEW
    process accumulated this window instead of rendering negative
    steps/s, and the reset is reported so renderers can annotate the
    row.

Pure stdlib (re only).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["CounterRates", "labeled", "parse_prometheus", "scalar"]

_LINE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')

Metrics = Dict[str, List[Tuple[Dict[str, str], float]]]


def parse_prometheus(text: str) -> Metrics:
    """Text exposition format -> {metric: [(labels, value), ...]}."""
    out: Metrics = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if not m:
            continue
        name, labels_raw, raw = m.groups()
        try:
            value = float(raw)
        except ValueError:
            continue
        labels = (dict(_LABEL_RE.findall(labels_raw))
                  if labels_raw else {})
        out.setdefault(name, []).append((labels, value))
    return out


def scalar(metrics: Metrics, name: str) -> Optional[float]:
    """First unlabeled sample of a family (counters/gauges here carry
    no labels)."""
    for labels, value in metrics.get(name, ()):
        if not labels:
            return value
    return None


def labeled(metrics: Metrics, name: str, **want: str) -> Optional[float]:
    for labels, value in metrics.get(name, ()):
        if all(labels.get(k) == v for k, v in want.items()):
            return value
    return None


class CounterRates:
    """One endpoint's counter-differencing state: holds the previous
    (t, metrics) sample so each poll yields rates, with counter
    resets surfaced instead of rendered as negative rates."""

    def __init__(self) -> None:
        self._last: Optional[Tuple[float, Metrics]] = None
        # counters that went backward in the CURRENT window (filled by
        # the rate calls the latest advance() handed out)
        self.restarted: List[str] = []

    def reset(self) -> None:
        """Forget the previous sample — a poller calls this when it
        KNOWS the process restarted (a fresh run_id), so the first
        post-restart poll starts a clean window instead of differencing
        across two processes."""
        self._last = None
        self.restarted = []

    def advance(self, t: float, metrics: Metrics
                ) -> Callable[[str], Optional[float]]:
        """Record this poll's sample; returns a `rate(counter_name)`
        lookup over the window just closed (None until two samples
        exist). Resets observed by those lookups accumulate in
        `self.restarted`."""
        prev, self._last = self._last, (t, metrics)
        self.restarted = []
        restarted = self.restarted

        def rate(counter: str) -> Optional[float]:
            cur = scalar(metrics, counter)
            if prev is None or cur is None:
                return None
            old = scalar(prev[1], counter)
            dt = t - prev[0]
            if old is None or dt <= 0:
                return None
            if cur < old:
                # counter reset: a restart replaced the process,
                # zeroing its cumulative counters — the raw difference
                # is negative garbage. Report the reset and rate what the NEW
                # process accumulated this window (cur since its
                # zero), clamped >= 0.
                restarted.append(counter)
                return max(0.0, cur) / dt
            return (cur - old) / dt
        return rate

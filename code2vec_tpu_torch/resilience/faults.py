"""Deterministic failpoint registry: a copy of resilience/faults.py of
the JAX package, with the same spec grammar and per-site seeded streams.

Crash-only software says the recovery path should be the ORDINARY
path — exercised constantly, not discovered in postmortems. This module
makes that exercise reproducible: named injection sites sit at the
port's real failure seams, and a seeded spec decides exactly which hit
of which site fails, how. The same `--faults` JSON replays the same
failure on every run.

Sites wired through the port:

  ckpt/write       training/checkpoint.save_checkpoint, inside the
                   retried write — slow disk (`sleep`), transient EIO
                   (`io_error`, retried), disk full (`io_error` ENOSPC,
                   given up; with `partial` the torn `state.tmp/` a
                   writer killed mid-save leaves), crash-before-rename
                   (`kill`)
  infeed/produce   data/prefetch's producer thread — an exception per
                   batch, raised in the consuming loop
  train/nan_loss   the train loop — poisons the step loss to NaN
                   (value substitution: the site calls `hit()` and
                   corrupts the loss itself)
  train/kill       the train loop — SIGKILL this process after a step
  serve/extract    serving/extractor.Extractor.extract_paths — worker
                   crash the pool must survive
  serve/kill       serving/server.PredictionServer.predict_lines —
                   replica death on the request path (a `raise` is what
                   a ReplicaPool absorbs: one death, the request retried
                   on a survivor, a refill)
  reload/read      serving/reload.ReloadManager — IO failure while
                   reading a VERIFIED checkpoint's weights for a hot
                   swap (`io_error`: exercises the reload retry policy;
                   exhausted retries refuse the step, the pool keeps
                   serving the weights it has)

(`dist/init` of the JAX package is wired when the multi-process init is
ported.)

Disabled path (the default): the module-level registry is None, so
`fire()` is one None check and `point()` returns a shared null handle
whose `armed` is False — hot loops guard on that one attribute read.
No thread is ever started by this module.

Spec format (`--faults <file-or-inline-json>`):

    {"seed": 0,
     "sites": {
       "train/kill":  {"action": "kill", "at": 5,
                       "marker": "/tmp/killed.once"},
       "ckpt/write":  {"action": "io_error", "errno": "ENOSPC",
                       "partial": true},
       "infeed/produce": {"action": "raise", "prob": 0.01}}}

Per-site fields: `action` (raise | io_error | sleep | kill | exit |
nan), `at` (1-based hit index that triggers; default 1), `times` (max
firings, default 1, -1 = unlimited), `prob` (per-hit probability from a
per-site seeded stream — deterministic given the seed; overrides `at`),
`delay_ms` (sleep), `errno` (io_error; name or number, default ENOSPC),
`partial` (io_error/kill: first create the torn `state.tmp/` (holding
an empty `state.pt`) under the site's `path` context — what a writer
killed mid-save leaves behind), `marker` (a file path created atomically
at first firing; while it exists the site is disarmed — the
cross-RESTART once-latch a relaunched process needs, or the kill would
replay forever), `process` (only fire on this `torch.distributed` rank
— kill one worker of a cohort), `code` (exit).
"""

from __future__ import annotations

import errno as errno_mod
import json
import os
import random
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional

__all__ = ["FaultInjected", "FaultPoint", "install", "clear", "enabled",
           "fire", "point", "stats"]

_ACTIONS = ("raise", "io_error", "sleep", "kill", "exit", "nan")

# training/checkpoint._write_state writes `step_N/state.tmp/state.pt`
# and commits by renaming the dir to `state/`
_TORN_MARKER, _TORN_FILE = "state.tmp", "state.pt"


class FaultInjected(RuntimeError):
    """An injected failure (action `raise`). Recovery code treats it
    like the real error it stands in for; nothing may catch it JUST
    because it is injected."""


def _process_index() -> int:
    """This process's `torch.distributed` rank, 0 when no process group
    is initialised (armed-path only — the disabled path never gets
    here)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


class _Site:
    """One armed injection site: trigger bookkeeping + the action."""

    def __init__(self, name: str, spec: Dict[str, Any], seed: int):
        unknown = set(spec) - {"action", "at", "times", "prob",
                               "delay_ms", "errno", "partial", "marker",
                               "process", "code"}
        if unknown:
            raise ValueError(f"fault site {name!r}: unknown spec "
                             f"fields {sorted(unknown)}")
        self.name = name
        self.action = spec.get("action", "raise")
        if self.action not in _ACTIONS:
            raise ValueError(f"fault site {name!r}: action must be one "
                             f"of {_ACTIONS} (got {self.action!r})")
        self.at = int(spec.get("at", 1))
        self.times = int(spec.get("times", 1))
        self.prob = spec.get("prob")
        self.delay_ms = float(spec.get("delay_ms", 100.0))
        err = spec.get("errno", "ENOSPC")
        self.errno = getattr(errno_mod, err) if isinstance(err, str) \
            else int(err)
        self.partial = bool(spec.get("partial", False))
        self.marker = spec.get("marker")
        self.process = spec.get("process")
        self.exit_code = int(spec.get("code", 17))
        # per-site seeded stream: which hits a `prob` site fails is a
        # function of (seed, site name) alone — independent of every
        # other site's draw order
        self._rng = random.Random(f"{seed}:{name}")
        self.hits = 0
        self.fired = 0
        self._lock = threading.Lock()

    def hit(self) -> bool:
        """Count one occurrence; True when THIS occurrence triggers."""
        if self.process is not None \
                and _process_index() != int(self.process):
            return False
        with self._lock:
            self.hits += 1
            if self.times >= 0 and self.fired >= self.times:
                return False
            if self.marker and os.path.exists(self.marker):
                return False  # already fired in an earlier incarnation
            if self.prob is not None:
                triggered = self._rng.random() < float(self.prob)
            else:
                triggered = self.hits >= self.at
            if not triggered:
                return False
            self.fired += 1
        if self.marker:
            # atomic cross-process once-latch: exactly one process of a
            # cohort wins the exclusive create; losers stay disarmed
            try:
                with open(self.marker, "x") as f:
                    f.write(f"{self.name} pid={os.getpid()} "
                            f"ts={time.time()}\n")
            except FileExistsError:
                return False
        return True

    def _make_partial(self, ctx: Dict[str, Any]) -> None:
        """Leave what a writer killed mid-save leaves: the torn
        `state.tmp/` with an empty `state.pt` under the site's `path`
        context (never a committed `state/`)."""
        path = ctx.get("path")
        if path:
            torn = os.path.join(path, _TORN_MARKER)
            os.makedirs(torn, exist_ok=True)
            open(os.path.join(torn, _TORN_FILE), "wb").close()

    def act(self, ctx: Dict[str, Any],
            log: Callable[[str], None]) -> None:
        log(f"faults: firing {self.name!r} action={self.action} "
            f"hit={self.hits} pid={os.getpid()}")
        if self.action == "sleep":
            time.sleep(self.delay_ms / 1e3)
            return
        if self.partial:
            self._make_partial(ctx)
        if self.action == "io_error":
            raise OSError(self.errno,
                          f"fault injected at {self.name}")
        if self.action == "kill":
            # SIGKILL: no handlers, no finallys — the real preemption
            os.kill(os.getpid(), signal.SIGKILL)
        if self.action == "exit":
            os._exit(self.exit_code)
        if self.action == "raise":
            raise FaultInjected(f"fault injected at {self.name}")
        # "nan" (and any future value-substitution action) has no side
        # effect here: the site consumes hit() and corrupts the value


class FaultPoint:
    """A site handle for hot paths: fetch once at loop setup, then
    `armed` is one attribute read per event when faults are off (or the
    site is not configured)."""

    __slots__ = ("armed", "_site", "_log")

    def __init__(self, site: Optional[_Site], log):
        self.armed = site is not None
        self._site = site
        self._log = log

    def hit(self) -> bool:
        """Trigger decision only — value-substitution sites (NaN loss)
        corrupt the value themselves when this returns True."""
        return self._site is not None and self._site.hit()

    def fire(self, **ctx) -> None:
        if self._site is not None and self._site.hit():
            self._site.act(ctx, self._log)


_NULL_POINT = FaultPoint(None, None)


class FaultRegistry:
    def __init__(self, spec: Dict[str, Any],
                 log: Optional[Callable[[str], None]] = None):
        self.seed = int(spec.get("seed", 0))
        sites = spec.get("sites")
        if not isinstance(sites, dict) or not sites:
            raise ValueError(
                "faults spec needs a non-empty 'sites' mapping "
                "(site name -> spec object)")
        self.log = log or (lambda m: print(m, flush=True))
        self.sites = {name: _Site(name, s, self.seed)
                      for name, s in sites.items()}

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {name: {"hits": s.hits, "fired": s.fired}
                for name, s in self.sites.items()}


_REGISTRY: Optional[FaultRegistry] = None


def install(spec, *, log: Optional[Callable[[str], None]] = None
            ) -> FaultRegistry:
    """Arm the registry from a dict, an inline JSON string, or a path
    to a JSON file. Install BEFORE building models/servers — sites
    fetch their `point()` handles at setup time."""
    global _REGISTRY
    if isinstance(spec, str):
        if os.path.exists(spec):
            with open(spec, encoding="utf-8") as f:
                spec = json.load(f)
        else:
            spec = json.loads(spec)
    _REGISTRY = FaultRegistry(spec, log=log)
    _REGISTRY.log(f"faults: armed {sorted(_REGISTRY.sites)} "
                  f"(seed {_REGISTRY.seed})")
    return _REGISTRY


def clear() -> None:
    global _REGISTRY
    _REGISTRY = None


def enabled() -> bool:
    return _REGISTRY is not None


def point(name: str) -> FaultPoint:
    """Armed handle for `name`, or the shared null handle (armed=False)
    when faults are off or the site is not in the spec."""
    reg = _REGISTRY
    if reg is None:
        return _NULL_POINT
    site = reg.sites.get(name)
    if site is None:
        return _NULL_POINT
    return FaultPoint(site, reg.log)


def fire(name: str, **ctx) -> None:
    """One-shot form for non-hot sites (checkpoint write, extractor,
    distributed init): disabled cost is this None check."""
    reg = _REGISTRY
    if reg is None:
        return
    site = reg.sites.get(name)
    if site is not None and site.hit():
        site.act(ctx, reg.log)


def train_step_points() -> "tuple[FaultPoint, FaultPoint]":
    """The two per-step train-loop failpoints, `(nan_loss, kill)`,
    fetched together at the loop's setup."""
    return point("train/nan_loss"), point("train/kill")


def stats() -> Dict[str, Dict[str, int]]:
    reg = _REGISTRY
    return reg.stats() if reg is not None else {}

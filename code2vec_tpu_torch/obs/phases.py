"""Sampled step-phase profiler: a copy of obs/phases.py of the JAX
package.

Every `--phase_sample_every` N steps, ONE training step is dispatched
through a phase-split path: each phase its own synced dispatch over the
measurement probes of training/phase_probes.py (embed-gather ->
concat/dense -> attention-softmax-pool forward -> backward -> table
apply), while every other step runs the fused step untouched.

Sample the split, trust the fused: on a sampled step the probes are
measurement-only prefixes whose outputs are DISCARDED (they read the
params and never write them); the state update still comes from the one
fused step, timed and synced like any other phase. That makes the
sampled step's loss and state bit-equal to an unprofiled run's by
construction (the tests and chip_smoke.py [18] hold it anyway), at the
price that the split cannot see intra-step fusion wins: the signed
`residual_ms` (fused minus the split's sum) is published so that blind
spot is a number.

Phase derivation: the probe chain is CUMULATIVE (each probe re-runs its
predecessors plus one more stage), so phase k's device time is the
difference of consecutive synced probe times (`derive_chain_phases`,
clamped at 0). The chain runs PROBE_PASSES times in a row and each
probe keeps its fastest pass: a stage adds well under a millisecond at
java-large width, while one probe's host time can jump by several when
another thread of the process (the infeed's prefetch, the health
engine, a /metrics scrape) holds the interpreter lock as its sync
returns. One such stall on probe k-1 clamps phase k to 0; interleaved
passes put the stalls on different passes, and the minimum drops them.
An apply probe, where a kit has one, times the optimizer apply alone;
otherwise the apply is the remainder `fused - chain`.

Publication: per-phase `train/phase/<name>_ms` timers and one `phase`
JSONL event per sampled step; the analytic per-phase traffic
(training/sparse_update.phase_traffic_bytes) is published once as static
`train/phase_bytes/<name>` / `train/phase_floor_ms/<name>` gauges, and
the health engine's PhaseRoofline (obs/health.py) turns the pair into
live `health/phase_*` roofline gauges on /metrics.

Disabled path: `create()` returns a shared no-op singleton unless phase
profiling is on AND the telemetry registry is live; the train loop pays
one boolean check per step. The probes are built, and run once
unrecorded, at the first sampled step: on the card that keeps a kernel's
first-use build and the allocator's growth out of the timers.

Differences from the JAX package: the port's steps update the state in
place and return the loss, so `fused_step(params, opt_state, batch,
draws)` returns the loss tensor and `run_split` returns it too; a
step's randomness is its `StepDraws` (training/draws.py), drawn once by
the caller and handed to the probes and to the fused step alike. `_timed`
waits through obs/telemetry.device_sync, which raises rather than
degrades. The JAX package times the chain once a sample; the port takes
the fastest of PROBE_PASSES passes (above).
"""

from __future__ import annotations

import time
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

from code2vec_tpu_torch.obs.telemetry import device_sync

__all__ = ["DEVICE_PHASES", "PHASE_ORDER", "PROBE_PASSES", "PhaseProfiler",
           "ProbeKit", "derive_chain_phases"]

# timed passes of the probe chain in a sample; each probe keeps its
# fastest (the warm-up pass of the first sample comes on top)
PROBE_PASSES = 3

# canonical render order; heads emit the subset their ProbeKit supports
PHASE_ORDER = ("infeed_wait", "embed_gather", "concat_dense",
               "forward_pool", "backward", "table_apply",
               "backward_apply", "allreduce", "allreduce_exposed")

# phases summed by the coverage/roofline monitor against the fused
# dispatch (infeed_wait is host time outside it; the allreduce pair is
# a mesh's, timed apart from the step)
DEVICE_PHASES = ("embed_gather", "concat_dense", "forward_pool",
                 "backward", "table_apply", "backward_apply")


class ProbeKit:
    """The measurement probes one model head hands the profiler.

    `chain` is a sequence of (phase_name, fn(params, batch, draws))
    CUMULATIVE prefixes of the step's forward/backward computation:
    each fn re-runs everything before it plus one more stage, so phase
    k's time is the difference of consecutive probe times. When
    `apply_fn(params, opt_state, batch, draws, chain_out)` is given, the
    last chain fn's output must carry what it needs; it must not write
    the state. `allreduce_fn(chain_out)` times an isolated grads-shaped
    reduction (a mesh of more than one rank's, dense kit:
    training/phase_probes._make_allreduce).

    `derive_remainder` (the default) books the fused step's time not
    covered by the probes as one more phase, `remainder_name`:
    `table_apply` when the chain ends at backward, `backward_apply`
    when the kit stops at the forward chain. Kits that measure every
    phase directly set it False and publish the residual instead."""

    def __init__(self, chain: Sequence[Tuple[str, Callable]], *,
                 apply_fn: Optional[Callable] = None,
                 allreduce_fn: Optional[Callable] = None,
                 derive_remainder: bool = True,
                 remainder_name: str = "table_apply"):
        assert chain, "a ProbeKit needs at least one chain probe"
        self.chain = list(chain)
        self.apply_fn = apply_fn
        self.allreduce_fn = allreduce_fn
        self.derive_remainder = derive_remainder
        self.remainder_name = remainder_name


class PhaseProfiler:
    """Sampled phase-split dispatcher for a train loop.

    Usage:
        prof = PhaseProfiler.create(telemetry, fused_step=step,
                                    probes_factory=..., enabled=...,
                                    sample_every=cfg.PHASE_SAMPLE_EVERY)
        ... in the loop:
        if prof.enabled and prof.should_sample(step_num):
            loss = prof.run_split(params, opt_state, batch, draws,
                                  infeed_wait_ms=...)
        else:
            loss = step(params, opt_state, batch, draws)
    """

    def __init__(self, telemetry, fused_step: Callable,
                 probes_factory: Callable[[], ProbeKit], *,
                 sample_every: int = 64, min_interval_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic,
                 phase_bytes: Optional[Dict[str, int]] = None,
                 ceiling_gbps: float = 0.0,
                 log: Optional[Callable[[str], None]] = None):
        assert sample_every >= 1
        self.enabled = True
        self._tele = telemetry
        self._fused = fused_step
        self._factory = probes_factory
        self._every = sample_every
        self._min_interval_s = min_interval_s
        self._clock = clock
        self._log = log or (lambda _m: None)
        self._kit: Optional[ProbeKit] = None
        self._last_sample_t: Optional[float] = None
        self.samples = 0
        if ceiling_gbps > 0:
            telemetry.gauge("train/phase_ceiling_gbps", ceiling_gbps,
                            emit=False, static=True)
        for name, nbytes in (phase_bytes or {}).items():
            # analytic facts, set once: static keeps them out of the
            # staleness plane (they are not heartbeats)
            telemetry.gauge(f"train/phase_bytes/{name}", int(nbytes),
                            emit=False, static=True)
            if ceiling_gbps > 0:
                telemetry.gauge(
                    f"train/phase_floor_ms/{name}",
                    nbytes / (ceiling_gbps * 1e9) * 1e3,
                    emit=False, static=True)

    # ---- construction ----
    @classmethod
    def create(cls, telemetry, *, fused_step=None, probes_factory=None,
               enabled: bool = False, **kw) -> "PhaseProfiler":
        """The shared no-op singleton unless phase profiling is on AND
        the registry is live AND the head supplied its step + probes."""
        if (not enabled or telemetry is None or not telemetry.enabled
                or fused_step is None or probes_factory is None):
            return _NULL_PHASES
        return cls(telemetry, fused_step, probes_factory, **kw)

    @classmethod
    def disabled(cls) -> "PhaseProfiler":
        return _NULL_PHASES

    # ---- cadence ----
    def should_sample(self, step: int) -> bool:
        """True every `sample_every` steps, rate-limited by
        `min_interval_s` on the injected clock. Step 0 is never sampled:
        it is the step that builds the kernels and grows the allocator,
        and its time would poison the phase histograms."""
        if step == 0 or step % self._every != 0:
            return False
        if self._min_interval_s > 0 and self._last_sample_t is not None:
            if self._clock() - self._last_sample_t < self._min_interval_s:
                return False
        return True

    # ---- the sampled step ----
    def _build(self) -> ProbeKit:
        kit = self._factory()
        assert isinstance(kit, ProbeKit)
        self._kit = kit
        return kit

    @staticmethod
    def _timed(fn, *args) -> Tuple[float, Any]:
        t0 = time.perf_counter()
        out = fn(*args)
        device_sync(out)
        return (time.perf_counter() - t0) * 1e3, out

    def run_split(self, params, opt_state, batch, draws, *,
                  step: int = 0, infeed_wait_ms: Optional[float] = None,
                  recorder=None):
        """One sampled step: synced probe dispatches for attribution
        (the chain PROBE_PASSES times, each probe's fastest pass kept),
        then the fused step for the state update. Returns the fused
        step's loss tensor, so the sampled step's trajectory is
        bit-identical to an unprofiled run's. The probes run BEFORE the
        fused step (it updates params / opt_state in place; the probes
        only read them), all on the same `draws`.

        `recorder` (the loop's TrainStepRecorder, when enabled) is
        beaten after every probe dispatch and its step window is
        rebased before the fused step, so the sampled step's
        train/step_ms records the fused step alone."""
        first = self._kit is None
        kit = self._kit if not first else self._build()
        tick = recorder.probe_tick if recorder is not None \
            else (lambda: None)
        if first:
            # warm-up, unrecorded: first-use builds, allocator growth
            out = None
            for _name, fn in kit.chain:
                _ms, out = self._timed(fn, params, batch, draws)
                tick()
            if kit.apply_fn is not None:
                self._timed(kit.apply_fn, params, opt_state, batch,
                            draws, out)
                tick()
            if kit.allreduce_fn is not None:
                self._timed(kit.allreduce_fn, out)
                tick()

        tele = self._tele
        names: List[str] = [name for name, _fn in kit.chain]
        cum: List[float] = [float("inf")] * len(names)
        for _pass in range(PROBE_PASSES):
            out = None  # the last pass's output feeds the apply probe
            for i, (_name, fn) in enumerate(kit.chain):
                ms, out = self._timed(fn, params, batch, draws)
                cum[i] = min(cum[i], ms)
                tick()
        chain_ms = cum[-1]
        phases: Dict[str, float] = dict(derive_chain_phases(names, cum))
        apply_ms = None
        if kit.apply_fn is not None:
            apply_ms, _ = self._timed(kit.apply_fn, params, opt_state,
                                      batch, draws, out)
            phases["table_apply"] = apply_ms
            tick()
        allreduce_ms = None
        if kit.allreduce_fn is not None:
            allreduce_ms, _ = self._timed(kit.allreduce_fn, out)
            phases["allreduce"] = allreduce_ms
            tick()
        del out  # the probes' outputs (a dense step's grads) go now
        # the state update: the fused step, synced through the loss read
        # exactly as TrainStepRecorder.end_step bounds it. Rebase the
        # recorder first: train/step_ms must record THIS dispatch.
        if recorder is not None:
            recorder.rebase_step_window()
        t0 = time.perf_counter()
        loss = self._fused(params, opt_state, batch, draws)
        loss_f = float(loss)
        fused_ms = (time.perf_counter() - t0) * 1e3
        remainder_ms = None
        if kit.derive_remainder:
            remainder_ms = max(0.0, fused_ms - chain_ms
                               - (apply_ms or 0.0))
            phases[kit.remainder_name] = remainder_ms
        if allreduce_ms is not None and apply_ms is not None:
            phases["allreduce_exposed"] = min(
                allreduce_ms,
                max(0.0, allreduce_ms + fused_ms - chain_ms - apply_ms))
        if infeed_wait_ms is not None:
            phases["infeed_wait"] = infeed_wait_ms

        # split_sum = what the published phases claim, vs fused = what
        # the one real dispatch took
        split_sum = (chain_ms + (apply_ms or 0.0)
                     + (remainder_ms or 0.0))
        residual_ms = fused_ms - split_sum
        for name, ms in phases.items():
            tele.record_ms(f"train/phase/{name}_ms", ms)
        tele.record_ms("train/phase/fused_step_ms", fused_ms)
        event = {f"{k}_ms": round(v, 3) for k, v in phases.items()}
        tele.event("phase", step=int(step),
                   fused_ms=round(fused_ms, 3),
                   split_sum_ms=round(split_sum, 3),
                   residual_ms=round(residual_ms, 3),
                   loss=round(loss_f, 6), **event)
        self.samples += 1
        self._last_sample_t = self._clock()
        return loss


class _NullPhaseProfiler(PhaseProfiler):
    """The off path: `enabled` False, every method inert, shared
    singleton: the hot loop's guard short-circuits on the boolean."""

    def __init__(self):
        self.enabled = False
        self.samples = 0

    def should_sample(self, step: int) -> bool:
        return False

    def run_split(self, params, opt_state, batch, draws, *,
                  step: int = 0, infeed_wait_ms: Optional[float] = None,
                  recorder=None):
        raise RuntimeError("disabled PhaseProfiler cannot run_split")


_NULL_PHASES = _NullPhaseProfiler()


def derive_chain_phases(names: Sequence[str], cumulative_ms:
                        Sequence[float]) -> List[Tuple[str, float]]:
    """Cumulative probe times -> per-phase deltas (clamped at 0)."""
    out: List[Tuple[str, float]] = []
    prev = 0.0
    for name, t in zip(names, cumulative_ms):
        out.append((name, max(0.0, t - prev)))
        prev = t
    return out

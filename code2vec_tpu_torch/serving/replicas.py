"""Replica fleet behind the serving front end: a copy of
serving/replicas.py of the JAX package.

A `ReplicaPool` owns N `PredictionServer` instances (one model each, so
a wedged device call on one replica never blocks the others) behind ONE
shared `PredictionCache` and dispatches each request to the ready
replica with the fewest outstanding requests:

  - admission control stays per replica (bounded queue, deadlines,
    `serve/shed`): the pool never catches `ServerOverloaded`, shed is
    an explicit client-visible outcome, not a retry;
  - a replica that DIES mid-request (the `serve/kill` failpoint, a
    kernel that fails to launch, any non-input crash) is removed, the
    request retries on a surviving replica (zero requests lost) and a
    background refill grows the pool back toward target through the
    supervisor's replacement discipline (`replacement_fn` gate, one
    replica at a time). Nothing swaps in a plain-version replica;
  - hot weight swap (`swap_params`) invalidates the shared cache
    atomically, then drains and swaps ONE replica at a time, so the
    pool never drops below N-1 ready and post-swap predictions never
    mix old and new params (the cache generation refuses stale readers
    and writers). Every replica is handed the same params object: the
    serving path never writes params in place, so sharing is safe, and
    the replicas hold one set of tables on the card after a swap.
    Two changes from the JAX package's pool close a race between a
    swap and a replica still building (a death's refill, a grow): the
    swap waits for that replica before it drains the last ready one,
    and the replica, which the swap did not roll, joins on the current
    weights and generation (the JAX pool lets it join on the older
    ones and serve them until the next swap);
  - no new predict-step signature under load: each replica runs its
    power-of-two buckets at start (`warmup_predict`: kernel builds,
    allocator and library set-up), the pool records that count as the
    replica's baseline, and `compile_delta()` reports any signature the
    serving path added afterwards.

All replicas share one card and its default stream. The reload copies
new weights on a side stream and hands them to `swap_params` only once
that stream has finished (serving/reload.py), so the swap needs no
events.

Telemetry rides the shared registry: `serve/pool_size` /
`serve/pool_ready` / `serve/pool_target` / `serve/pool_generation`
gauges, `serve/replica_dead` / `serve/replica_refill` counters, and a
fleet-style `pool_table()` for the front end's `/pool` route.

Stdlib-only at module scope (tests/test_torch_serving_fleet.py imports
it with torch blocked); the models behind the replicas are whatever the
`model_factory` builds. A factory must build the same weights on every
call (seed a fresh `torch.Generator` each time): a refilled replica
serves what its peers serve.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Callable, List, Optional

from code2vec_tpu_torch.obs import Telemetry
from code2vec_tpu_torch.serving.batcher import ServerOverloaded
from code2vec_tpu_torch.serving.server import PredictionCache, PredictionServer

__all__ = ["Replica", "ReplicaPool", "SharedCacheView"]

# client mistakes stay client errors: a malformed line must bounce off
# ONE replica as 400-class, not execute N times and drain the pool
_INPUT_ERRORS = (ValueError, KeyError, TypeError)

# replica lifecycle: starting -> ready -> (draining -> ready)* and
# terminally dead (crashed) or stopped (shrunk/closed)
_PICKABLE = "ready"

# how long a swap waits for a replica still building (a refill, a grow)
# before it drains the last ready one
_WAIT_PEER_S = 60.0


class SharedCacheView:
    """A replica's window onto the pool's shared cache: every get/put
    carries the OWNING replica's weight generation, so a mid-swap
    replica still serving old params can neither read entries computed
    under the new weights nor poison the cache with old-params results.
    Duck-types the `PredictionCache` surface `PredictionServer` uses
    (`capacity`, `get`, `put`, `__len__`)."""

    def __init__(self, cache: PredictionCache, replica: "Replica"):
        self._cache = cache
        self._replica = replica

    @property
    def capacity(self) -> int:
        return self._cache.capacity

    def get(self, key):
        return self._cache.get(key, generation=self._replica.generation)

    def put(self, key, value) -> None:
        self._cache.put(key, value, generation=self._replica.generation)

    def __len__(self) -> int:
        return len(self._cache)


class Replica:
    """One pool member: a `PredictionServer` plus the pool-side state
    the dispatcher and swapper need. Mutations happen under the pool
    lock; `server` itself is internally thread-safe."""

    def __init__(self, idx: int, generation: int):
        self.idx = idx
        self.generation = generation
        self.server: Optional[PredictionServer] = None
        self.state = "starting"
        self.outstanding = 0
        self.requests = 0
        self.failures = 0
        self.swaps = 0
        self.compile_baseline = 0
        self.born_s = time.monotonic()

    def row(self) -> dict:
        """One `pool_table()` row — the fleet-plane host-row shape."""
        c = (self.server.model.predict_compile_count()
             if self.server is not None else -1)
        return {"replica": self.idx, "state": self.state,
                "generation": self.generation,
                "outstanding": self.outstanding,
                "requests": self.requests, "failures": self.failures,
                "swaps": self.swaps,
                "compiles": c,
                "compile_delta": (max(0, c - self.compile_baseline)
                                  if c >= 0 else 0),
                "age_s": round(time.monotonic() - self.born_s, 3)}


class ReplicaPool:
    """N prediction replicas, one cache, least-outstanding dispatch.

    `model_factory()` builds one model per replica (called with the
    pool lock NOT held — factories may allocate and warm up for
    seconds). The pool exposes the same `predict_lines` surface as a
    single `PredictionServer`, so `tools/loadgen.py` and the HTTP front
    end drive either interchangeably.
    """

    def __init__(self, config, model_factory: Callable[[], object], *,
                 replicas: Optional[int] = None,
                 telemetry: Telemetry = None,
                 cache: Optional[PredictionCache] = None,
                 replacement_fn: Optional[Callable[[], bool]] = None,
                 log=None):
        self.config = config
        self._factory = model_factory
        tele = telemetry if telemetry is not None \
            else Telemetry.memory("serve")
        tele.make_threadsafe()
        self.telemetry = tele
        self.cache = cache if cache is not None \
            else PredictionCache(getattr(config, "SERVE_CACHE_SIZE", 0))
        self._replacement_fn = replacement_fn
        self._log = log if log is not None \
            else getattr(config, "log", None) or (lambda *a, **k: None)
        n = replicas if replicas is not None \
            else getattr(config, "SERVE_REPLICAS", 1)
        self.min_replicas = getattr(config, "SERVE_MIN_REPLICAS", 1)
        self.max_replicas = max(getattr(config, "SERVE_MAX_REPLICAS", n),
                                n)
        self._target = max(1, n)
        self._params = None           # set by the first swap_params
        self._params_gen: Optional[int] = None
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._replicas: List[Replica] = []
        self._next_idx = 0
        self._refill_threads: List[threading.Thread] = []
        self._closed = False

    # ---- lifecycle ----
    def start(self, warmup: bool = True) -> "ReplicaPool":
        for _ in range(self._target):
            self._add_replica(warmup=warmup)
        self._publish()
        return self

    def close(self) -> None:
        with self._lock:
            self._closed = True
            reps = list(self._replicas)
            refills = list(self._refill_threads)
            self._cv.notify_all()
        for t in refills:
            t.join(timeout=30.0)
        for rep in reps:
            self._stop_replica(rep, state="stopped")
        self._publish()

    def _replica_config(self):
        """Each replica gets a copy with the live-plane flags OFF: the
        pool/front-end owns the single exposition server and alert
        engine — N replicas must not race to bind N metrics ports."""
        cfg = copy.copy(self.config)
        cfg.METRICS_PORT = 0
        cfg.ALERTS_MODE = "off"
        return cfg

    def _add_replica(self, warmup: bool = True) -> Replica:
        """Build + start one replica and make it pickable. The model
        build and bucket warmup run OUTSIDE the pool lock (they may
        take seconds); the replica only becomes visible to the
        dispatcher once ready."""
        with self._lock:
            gen = self._params_gen if self._params_gen is not None else 0
            rep = Replica(self._next_idx, generation=gen)
            self._next_idx += 1
        model = self._factory()
        server = PredictionServer(
            self._replica_config(), model, telemetry=self.telemetry,
            cache=SharedCacheView(self.cache, rep))
        # a refill that joins after a swap must serve the CURRENT
        # weights, not the factory's initial ones
        params = self._params
        if params is not None:
            model.params = params
        server.start(warmup=warmup)
        rep.server = server
        c = model.predict_compile_count()
        rep.compile_baseline = c if c >= 0 else 0
        with self._lock:
            # a swap that began while this replica was building did not
            # roll it (it was not in the pool yet): it joins on the
            # weights and generation the pool serves now, never on older
            # ones (the same shapes: the warmed buckets stay warm)
            if self._params_gen is not None \
                    and rep.generation != self._params_gen:
                model.params = self._params
                rep.generation = self._params_gen
            rep.state = "ready"
            self._replicas.append(rep)
            self._cv.notify_all()
        self._publish()
        return rep

    def _stop_replica(self, rep: Replica, state: str) -> None:
        with self._lock:
            rep.state = state
            if rep in self._replicas:
                self._replicas.remove(rep)
            self._cv.notify_all()
        if rep.server is not None:
            try:
                rep.server.close()
            except Exception as e:  # a dying replica must not take
                self._log(f"replica {rep.idx} close failed: {e!r}")
        self._publish()

    # ---- dispatch ----
    def _pick(self, exclude, wait_s: float = 5.0) -> Replica:
        """Least-outstanding ready replica (tie-break: lowest idx).
        Waits briefly when none is ready — the N=1 pool mid-swap has
        zero ready replicas for the drain window, and shedding there
        would turn every swap into downtime."""
        deadline = time.monotonic() + wait_s
        with self._lock:
            while True:
                if self._closed:
                    raise ServerOverloaded("replica pool closed")
                ready = [r for r in self._replicas
                         if r.state == _PICKABLE and r not in exclude]
                if ready:
                    rep = min(ready,
                              key=lambda r: (r.outstanding, r.idx))
                    rep.outstanding += 1
                    rep.requests += 1
                    return rep
                left = deadline - time.monotonic()
                if left <= 0:
                    raise ServerOverloaded("no ready replicas")
                self._cv.wait(timeout=left)

    def predict_lines(self, lines, deadline_ms: float = None):
        """Dispatch one request; on a replica DEATH (not overload, not
        a client input error) the request transparently retries on a
        surviving replica while a background refill replaces the dead
        one — the `serve_swap_kill` chaos leg's \"0 requests lost\"
        contract."""
        tried: List[Replica] = []
        # bound the retry walk: every attempt burns a distinct replica,
        # so max_replicas+1 attempts means the whole fleet died on us
        for _ in range(self.max_replicas + 1):
            rep = self._pick(exclude=tried)
            try:
                return rep.server.predict_lines(lines,
                                                deadline_ms=deadline_ms)
            except ServerOverloaded:
                raise
            except _INPUT_ERRORS:
                raise
            except Exception as e:
                tried.append(rep)
                self._on_replica_death(rep, e)
            finally:
                with self._lock:
                    rep.outstanding -= 1
                    self._cv.notify_all()
        raise ServerOverloaded(
            f"all {self.max_replicas + 1} dispatch attempts hit dead "
            f"replicas")

    def _on_replica_death(self, rep: Replica, exc: BaseException) -> None:
        with self._lock:
            if rep.state == "dead":      # concurrent requests on the
                return                   # same corpse report it once
            rep.state = "dead"
            rep.failures += 1
            self._cv.notify_all()
        self.telemetry.count("serve/replica_dead")
        self.telemetry.event("replica_dead", replica=rep.idx,
                             error=repr(exc))
        self._log(f"replica {rep.idx} died: {exc!r}")
        t = threading.Thread(target=self._reap_and_refill, args=(rep,),
                             name=f"replica-reap-{rep.idx}", daemon=True)
        t.start()
        with self._lock:
            self._refill_threads.append(t)

    def _reap_and_refill(self, rep: Replica) -> None:
        self._stop_replica(rep, state="dead")
        # grow back toward target one replica at a time, consulting the
        # same replacement gate the training supervisor uses — a budget
        # that says no leaves the pool smaller, not wedged
        while True:
            with self._lock:
                if self._closed or len(self._replicas) >= self._target:
                    return
            if self._replacement_fn is not None \
                    and not self._replacement_fn():
                self.telemetry.event("replica_refill_denied",
                                     replica=rep.idx)
                return
            self.telemetry.count("serve/replica_refill")
            self._add_replica(warmup=True)

    # ---- hot weight swap (reload.py drives this) ----
    def swap_params(self, params, generation: int) -> None:
        """Roll new weights across the fleet, one replica at a time.

        Commit point FIRST: the shared cache is atomically cleared and
        advanced to `generation`, so from that instant old-generation
        replicas are cache-isolated (no stale reads, no stale writes).
        Then each replica is drained (no new picks, in-flight requests
        finish), its params assigned (same shapes -> the warmed pow-2
        buckets stay warm), its generation bumped, and it returns
        to ready before the next replica leaves — the pool never drops
        below N-1 ready."""
        with self._lock:
            self._params = params
            self._params_gen = generation
            reps = list(self._replicas)
        self.cache.invalidate(generation)
        for rep in reps:
            with self._lock:
                # keep one replica ready while this one drains: with a
                # death's refill (or a grow) still building, wait for it
                # (bounded) rather than drain the last ready replica; a
                # pool of one has none to spare and drains at once
                deadline = time.monotonic() + _WAIT_PEER_S
                while (rep.state == "ready"
                       and len(self._replicas) < self._target
                       and not any(r.state == "ready" and r is not rep
                                   for r in self._replicas)
                       and time.monotonic() < deadline):
                    self._cv.wait(timeout=deadline - time.monotonic())
                if rep.state != "ready":
                    continue
                rep.state = "draining"
                self._cv.notify_all()
            self._publish()
            self._drain(rep)
            rep.server.model.params = params
            with self._lock:
                rep.generation = generation
                rep.swaps += 1
                rep.state = "ready"
                self._cv.notify_all()
            self._publish()
        self.telemetry.event("weights_swapped", generation=generation,
                             replicas=len(reps))

    def _drain(self, rep: Replica, timeout_s: float = 60.0) -> None:
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while rep.outstanding > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    self._log(f"replica {rep.idx} drain timed out with "
                              f"{rep.outstanding} outstanding")
                    return
                self._cv.wait(timeout=left)

    # ---- autoscaler surface ----
    def grow(self) -> bool:
        with self._lock:
            if self._closed or self._target >= self.max_replicas:
                return False
            self._target += 1
        self._add_replica(warmup=True)
        return True

    def shrink(self) -> bool:
        with self._lock:
            ready = [r for r in self._replicas if r.state == "ready"]
            if self._closed or self._target <= self.min_replicas \
                    or self._target <= 1 or len(ready) <= 1:
                return False
            self._target -= 1
            # youngest ready replica leaves: the long-lived ones carry
            # the warmest device state
            rep = max(ready, key=lambda r: r.idx)
            rep.state = "draining"
            self._cv.notify_all()
        self._publish()
        self._drain(rep)
        self._stop_replica(rep, state="stopped")
        return True

    # ---- introspection ----
    @property
    def target(self) -> int:
        with self._lock:
            return self._target

    def ready_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas if r.state == "ready")

    def size(self) -> int:
        with self._lock:
            return len(self._replicas)

    def generation(self) -> int:
        with self._lock:
            return self._params_gen if self._params_gen is not None else 0

    def params_template(self):
        """A live replica's current params — the restore template the
        reload manager hands to `load_checkpoint` (shapes/dtypes must
        match the checkpoint; any live replica's do)."""
        with self._lock:
            for rep in self._replicas:
                if rep.server is not None:
                    return rep.server.model.params
        raise RuntimeError("replica pool has no live replica to "
                           "template params from")

    def compile_delta(self) -> int:
        """Predict-step signatures the SERVING path added after warmup,
        summed over live replicas (models that cannot introspect report
        -1 and are skipped): the chaos leg's zero-new-signature gate."""
        with self._lock:
            reps = list(self._replicas)
        total = 0
        for rep in reps:
            if rep.server is None:
                continue
            c = rep.server.model.predict_compile_count()
            if c >= 0:
                total += max(0, c - rep.compile_baseline)
        return total

    def wait_ready(self, n: int, timeout_s: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while sum(1 for r in self._replicas
                      if r.state == "ready") < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=left)
            return True

    def pool_table(self) -> dict:
        """Fleet-plane-style snapshot for `/pool` and the chaos/bench
        reports: per-replica rows + pool aggregates."""
        with self._lock:
            rows = [r.row() for r in self._replicas]
            gen = self._params_gen if self._params_gen is not None else 0
            target = self._target
        ready = sum(1 for r in rows if r["state"] == "ready")
        return {"replicas": rows, "size": len(rows), "ready": ready,
                "target": target, "generation": gen,
                "cache_entries": len(self.cache),
                "cache_generation": self.cache.generation}

    def _publish(self) -> None:
        with self._lock:
            size = len(self._replicas)
            ready = sum(1 for r in self._replicas
                        if r.state == "ready")
            gen = self._params_gen if self._params_gen is not None else 0
            target = self._target
        self.telemetry.gauge("serve/pool_size", size, emit=False)
        self.telemetry.gauge("serve/pool_ready", ready, emit=False)
        self.telemetry.gauge("serve/pool_target", target, emit=False)
        self.telemetry.gauge("serve/pool_generation", gen, emit=False)

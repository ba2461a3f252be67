"""Crash-recovery supervisor: a copy of training/supervisor.py of the
JAX package. It closes the detect -> decide -> recover loop:

  - it spawns the training run as child process(es) and watches their
    exit codes;
  - BEFORE every (re)launch it verifies the checkpoint directory
    (`checkpoint.verify_and_resolve`): a corrupt latest step is
    quarantined and the child auto-resumes from the last VERIFIED
    committed step, never from rotten bytes;
  - any nonzero or signal exit fails the attempt: the remaining cohort
    members get a grace window to die on their own, then are SIGKILLed,
    and the cohort relaunches COHERENTLY;
  - `resize_policy="shrink"` makes peer loss a RESIZE: the next launch
    re-forms the cohort at N-k processes (k = `group`, below) and grows
    back toward the target in steps of k when a replacement is
    available (`replacement_fn`); where N-k is below `min_procs` the
    cohort relaunches at N. Hangs (attempt timeouts) and a whole cohort
    failing together relaunch at the same size;
  - a child that finishes (all exit 0) ends the supervised run;
  - the restart budget is bounded, the pacing is the shared
    `resilience/retry` backoff, and every decision escalates through the
    alert engine (`supervisor/*` gauges drive edge-triggered `alert`
    events: restarted -> ticket, quarantined checkpoint -> ticket,
    cohort resized -> ticket, budget exhausted -> page).

The spawn function is injectable, so the policy logic tests without real
training runs; `code2vec_tpu_torch/the supervisor tool` is the
command line and `code2vec_tpu_torch/tools/chaos.py` drives the
acceptance legs (SIGKILL parity, corrupt-checkpoint fallback) end to
end. The class is the JAX package's, shrink and grow included, and
`build_cli_spawn` launches a cohort of N processes with the `--dist_*`
flags of the port's data axis (parallel/distributed.py), a fresh
coordinator port per attempt. `cohort_topology()` exposes the live
process set and target size; pass a `watchdog=` and the supervisor
attaches it to stall dumps and beats its supervise loop.

The shrink's step k (`group`) departs from the JAX supervisor's "minus
one". A JAX process is a host holding several devices, and its mesh
sizes the data axis from the devices left (`make_mesh` with data=0), so
N-1 hosts still fill the ctx, dcn and model axes whenever one host's
devices do. A port process holds one card, so the port's "host" is one
group of k = dcn * model * ctx processes, the least a mesh of the
child's axes can lose: a peer's death re-forms the cohort at N-k and
drops k-1 healthy processes with the dead one, the price of one card a
process. On hosts of k devices this is the JAX decision on N/k hosts
with ceil(min_procs / k) hosts as the floor; at k = 1 it is the JAX
decision.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from code2vec_tpu_torch.resilience import retry as retry_mod
from code2vec_tpu_torch.training import checkpoint as ckpt

__all__ = ["RestartBudgetExceeded", "Supervisor", "build_cli_spawn",
           "supervisor_alert_rules"]


class RestartBudgetExceeded(RuntimeError):
    """The cohort kept dying past `max_restarts` relaunches — a human's
    problem now; the page-severity alert already fired."""


def supervisor_alert_rules():
    """Escalation through the EXISTING alert engine: the
    supervisor publishes gauges, these rules turn them into
    edge-triggered `alert` events + stdout lines."""
    from code2vec_tpu_torch.obs.alerts import AlertRule
    from code2vec_tpu_torch.obs.fleet import fleet_alert_rules
    return [
        AlertRule("train_process_restarted",
                  metric="supervisor/restarts", op=">=", value=1,
                  severity="ticket"),
        AlertRule("checkpoint_quarantined",
                  metric="resilience/ckpt_quarantined", op=">=",
                  value=1, severity="ticket"),
        # elastic re-form: a resized cohort keeps training,
        # but a human should know capacity degraded — warn-tier ticket,
        # not a page
        AlertRule("cohort_resized",
                  metric="supervisor/cohort_resized", op=">=",
                  value=1, severity="ticket"),
        # an explicit 0/1 gauge, not `restarts_remaining <= 0`: a
        # max_restarts=0 supervisor would otherwise page on a run that
        # SUCCEEDED without ever restarting
        AlertRule("restart_budget_exhausted",
                  metric="supervisor/budget_exhausted", op=">=",
                  value=1, severity="page"),
        # fleet plane: the cohort collector publishes its
        # gauges into THIS registry, so its straggler/divergence
        # tickets ride the same engine. Installed unconditionally —
        # threshold rules stay quiet while the fleet/* series are
        # absent (fleet plane off).
        *fleet_alert_rules(),
    ]


class Supervisor:
    """Restart supervisor over an injectable spawn function.

    `spawn_fn(attempt, proc_id, port, cohort_size) -> subprocess.Popen`
    launches one cohort member (`port` is a fresh coordinator port per
    attempt, 0 for single-process launches; `cohort_size` is the size
    of THIS attempt's cohort — under `resize_policy="shrink"` it can
    differ from the configured `num_procs`). The supervisor owns
    reaping: no child outlives a failed attempt (the tests/conftest.py
    leak-guard discipline).
    """

    def __init__(self, spawn_fn: Callable[[int, int, int, int],
                                          "subprocess.Popen"], *,
                 num_procs: int = 1, max_restarts: int = 3,
                 resize_policy: str = "relaunch",
                 min_procs: int = 1, group: int = 1,
                 replacement_fn: Optional[Callable[[], bool]] = None,
                 ckpt_dir: Optional[str] = None,
                 telemetry=None, watchdog=None,
                 log: Optional[Callable[[str], None]] = None,
                 poll_s: float = 0.2, peer_grace_s: float = 15.0,
                 attempt_timeout_s: Optional[float] = None,
                 backoff: Optional[retry_mod.RetryPolicy] = None,
                 sleep: Callable[[float], None] = time.sleep):
        assert num_procs >= 1 and max_restarts >= 0
        assert resize_policy in ("relaunch", "shrink"), resize_policy
        assert 1 <= min_procs <= num_procs, (min_procs, num_procs)
        assert group >= 1, group
        self._spawn_fn = spawn_fn
        self.num_procs = num_procs      # configured TARGET cohort size
        self.cur_procs = num_procs      # this attempt's cohort size
        self.resize_policy = resize_policy
        self.min_procs = min_procs
        # the processes one shrink or grow moves: the child mesh's
        # dcn * model * ctx (the module docstring)
        self.group = group
        self.replacement_fn = replacement_fn
        self.max_restarts = max_restarts
        self.ckpt_dir = ckpt_dir
        self._log = log or (lambda m: print(m, flush=True))
        self.poll_s = poll_s
        self.peer_grace_s = peer_grace_s
        self.attempt_timeout_s = attempt_timeout_s
        self._sleep = sleep
        # ONE backoff math for the whole repo: the supervisor's restart
        # pacing is the retry policy's delay curve, not a second
        # implementation
        self.backoff = backoff if backoff is not None else \
            retry_mod.RetryPolicy("supervisor-restart", max_attempts=1,
                                  base_delay_s=1.0, max_delay_s=60.0)
        if telemetry is None:
            from code2vec_tpu_torch.obs import Telemetry
            telemetry = Telemetry.memory("supervisor")
        self.telemetry = telemetry
        retry_mod.set_telemetry(telemetry)
        from code2vec_tpu_torch.obs.alerts import AlertEngine
        self.alerts = AlertEngine.create(
            telemetry, mode="warn", rules=supervisor_alert_rules(),
            log=self._log)
        self.restarts = 0
        self.quarantined: List[str] = []
        self.resumed_from_step: Optional[int] = None
        # elastic bookkeeping: every resize decision and the
        # count of same-size do-overs (a shrink that handled a peer
        # death makes none)
        self.resizes: List[Tuple[int, int]] = []
        self.full_relaunches = 0
        self.last_launch_ts: Optional[float] = None
        self._procs: List["subprocess.Popen"] = []
        # watchdog: attach the live cohort
        # topology to stall dumps and heartbeat the supervise loop —
        # a supervisor wedged in a hung spawn_fn or a reap that never
        # ends shows up as a stall whose dump says WHO was in the
        # mesh. The supervisor tool wires this behind
        # --watchdog_stall_s; embedders can also call
        # Watchdog.attach(cohort=sup.cohort_topology) themselves.
        self._watchdog_hb = None
        if watchdog is not None and getattr(watchdog, "enabled", False):
            watchdog.attach(cohort=self.cohort_topology)
            self._watchdog_hb = watchdog.register("supervisor_loop")
        # fleet plane: None until attach_fleet — one None
        # check per site is the whole disabled-path cost
        self.fleet = None
        self._fleet_members: List[str] = []

    def attach_fleet(self, collector,
                     member_urls: Sequence[str]) -> None:
        """Host the cohort collector (obs/fleet.py) in the supervisor:
        its gauges land in this registry, its straggler/divergence
        tickets ride `self.alerts`, its members re-point per attempt
        (an elastic resize shrinks the scrape set with the mesh), and
        its cohort snapshot joins stall dumps next to
        `cohort_topology` (which reads it live)."""
        if collector is None or not collector.enabled:
            return
        self.fleet = collector.attach(alerts=self.alerts)
        self._fleet_members = list(member_urls)

    def cohort_topology(self) -> dict:
        """The live cohort, as a stall-dump-attachable snapshot:
        target vs current size, live member pids, the resize history.
        Read from other threads (the watchdog's dump path) — every
        field is rebuilt per call, nothing is mutated."""
        procs = list(self._procs)
        topo = {
            "target_procs": self.num_procs,
            "cohort_size": self.cur_procs,
            "min_procs": self.min_procs,
            "resize_policy": self.resize_policy,
            "attempt": self.restarts,
            "live_pids": [p.pid for p in procs if p.poll() is None],
            "resizes": [list(r) for r in self.resizes],
            "full_relaunches": self.full_relaunches,
        }
        if self.fleet is not None:
            # a wedged cohort's stall dump answers "who was slow"
            # from the latest fleet sweep, right next to who was in
            # the mesh
            topo["fleet"] = self.fleet.brief()
        return topo

    # ---- checkpoint verification (runs before EVERY launch) ----
    def verify_checkpoint(self) -> Optional[int]:
        """Verify + quarantine so the child only ever resumes from a
        VERIFIED committed step; returns that step (None = fresh
        start). Quarantines escalate through the alert engine."""
        if not self.ckpt_dir or not os.path.isdir(self.ckpt_dir):
            return None
        good, quarantined = ckpt.verify_and_resolve(
            self.ckpt_dir, log=self._log)
        if quarantined:
            self.quarantined.extend(quarantined)
            self.telemetry.gauge("resilience/ckpt_quarantined",
                                 len(self.quarantined), emit=False)
            self.telemetry.event(
                "ckpt_quarantine", dirs=quarantined,
                fallback_step=good)
            self.alerts.check_now()
        return good

    # ---- one attempt ----
    def _kill_all(self, procs: Sequence["subprocess.Popen"]) -> None:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            if p.poll() is None:
                p.wait()

    def _reap_with_grace(self, procs: Sequence["subprocess.Popen"]
                         ) -> None:
        """A peer died: give the rest `peer_grace_s` to notice (the
        coordination-service heartbeat eviction takes them down on
        their own), then SIGKILL the stragglers — the next launch is
        always a COHERENT cohort, whatever size it re-forms at."""
        deadline = time.monotonic() + self.peer_grace_s
        while time.monotonic() < deadline \
                and any(p.poll() is None for p in procs):
            if self._watchdog_hb is not None:
                self._watchdog_hb.beat()  # the grace wait IS progress
            self._sleep(self.poll_s)
        self._kill_all(procs)

    def _run_cohort(self, attempt: int
                    ) -> Tuple[bool, List[int], str]:
        """One coherent attempt at the CURRENT cohort size. Returns
        (ok, exit codes, reason) with reason one of "done",
        "peer_death", "cohort_failure", "timeout" — the resize policy
        shrinks only on peer death. A whole-cohort hang (timeout) or
        EVERY member of a multi-process cohort exiting nonzero
        together (cohort_failure — the same bad --data path killing
        all of them identically) is no evidence any ONE member is bad:
        shrinking would relaunch ever-smaller equally-doomed cohorts,
        so those relaunch at full size."""
        from code2vec_tpu_torch.parallel.compat import free_port
        n = self.cur_procs
        port = free_port() if n > 1 else 0
        self.last_launch_ts = time.time()
        if self.fleet is not None:
            # this attempt's scrape set: the first n member endpoints
            # (a shrunk cohort scrapes the shrunk set; relaunched
            # members re-handshake when their run_id changes)
            self.fleet.set_members(self._fleet_members[:n])
        procs = [self._spawn_fn(attempt, i, port, n) for i in range(n)]
        self._procs = procs
        deadline = (time.monotonic() + self.attempt_timeout_s
                    if self.attempt_timeout_s else None)
        try:
            while True:
                rcs = [p.poll() for p in procs]
                if all(rc is not None for rc in rcs):
                    ok = all(rc == 0 for rc in rcs)
                    if ok:
                        return ok, rcs, "done"
                    # every member of a >1 cohort failed in the same
                    # poll window: systemic, not a lost peer (a single
                    # supervised process dying IS its peer dying)
                    systemic = len(rcs) > 1 \
                        and all(rc != 0 for rc in rcs)
                    return ok, rcs, ("cohort_failure" if systemic
                                     else "peer_death")
                if any(rc is not None and rc != 0 for rc in rcs):
                    # dead peer detected: coherent cohort teardown
                    self._reap_with_grace(procs)
                    return False, [p.poll() for p in procs], \
                        "peer_death"
                if deadline is not None and time.monotonic() > deadline:
                    self._log(f"supervisor: attempt {attempt} exceeded "
                              f"{self.attempt_timeout_s:.0f}s — "
                              "killing cohort")
                    self._kill_all(procs)
                    return False, [p.poll() for p in procs], "timeout"
                if self._watchdog_hb is not None:
                    self._watchdog_hb.beat()  # the loop is alive
                self._sleep(self.poll_s)
        finally:
            self._kill_all(procs)  # no orphan survives any exit path

    def _next_cohort_size(self, reason: str) -> int:
        """The resize decision: shrink by one group of `group` processes
        on peer death, unless that leaves fewer than `min_procs` (then
        the cohort relaunches at its size, as the JAX supervisor does
        at its floor), then grow back toward the configured target a
        group for each replacement available — a replacement arriving
        in the same window the peer died re-fills its slot, so the
        cohort re-forms at N, not N−k."""
        size = self.cur_procs
        if (self.resize_policy == "shrink" and reason == "peer_death"
                and size - self.group >= self.min_procs):
            size -= self.group
        while (self.replacement_fn is not None
               and size < self.num_procs and self.replacement_fn()):
            size += self.group
        return size

    def shrink_sizes(self) -> List[int]:
        """The cohort sizes successive shrinks re-form at, largest first
        (empty: a death relaunches the whole cohort)."""
        sizes: List[int] = []
        size = self.num_procs
        while (self.resize_policy == "shrink"
               and size - self.group >= self.min_procs):
            size -= self.group
            sizes.append(size)
        return sizes

    # ---- the supervised run ----
    def run(self) -> int:
        if self.fleet is not None:
            self.fleet.start()
        try:
            return self._run()
        finally:
            if self.fleet is not None:
                self.fleet.stop()

    def _run(self) -> int:
        self.telemetry.gauge("supervisor/restarts", 0, emit=False)
        self.telemetry.gauge("supervisor/restarts_remaining",
                             self.max_restarts, emit=False)
        self.telemetry.gauge("supervisor/cohort_target",
                             self.num_procs, emit=False)
        while True:
            if self._watchdog_hb is not None:
                # covers the pre-launch checkpoint-verify sweep; size
                # --watchdog_stall_s above that sweep (the train
                # loops' eval-vs-deadline guidance applies here too)
                self._watchdog_hb.beat()
            step = self.verify_checkpoint()
            if self.restarts > 0 or step is not None:
                self.resumed_from_step = step
            self.telemetry.gauge("supervisor/cohort_size",
                                 self.cur_procs, emit=False)
            self.telemetry.event(
                "supervisor_launch", attempt=self.restarts,
                num_procs=self.cur_procs,
                cohort_target=self.num_procs,
                resume_step=step if step is not None else -1)
            if step is not None:
                self._log(f"supervisor: launching attempt "
                          f"{self.restarts} at {self.cur_procs} "
                          f"process(es) (resume from verified "
                          f"step {step})")
            ok, rcs, reason = self._run_cohort(self.restarts)
            self.telemetry.event("supervisor_attempt",
                                 attempt=self.restarts, ok=ok,
                                 num_procs=self.cur_procs,
                                 reason=reason, exit_codes=rcs)
            if ok:
                self._log(f"supervisor: run completed after "
                          f"{self.restarts} restart(s)")
                self.alerts.check_now()
                if self._watchdog_hb is not None:
                    self._watchdog_hb.idle()  # no deadline after done
                return 0
            self.restarts += 1
            self.telemetry.count("supervisor/attempts_failed")
            self.telemetry.gauge("supervisor/restarts", self.restarts,
                                 emit=False)
            self.telemetry.gauge("supervisor/restarts_remaining",
                                 self.max_restarts - self.restarts,
                                 emit=False)
            # elastic re-form: decide the NEXT cohort size
            # before the budget check so the resize escalates in the
            # same alert sweep as the restart itself
            new_size = self._next_cohort_size(reason)
            if new_size != self.cur_procs:
                self.resizes.append((self.cur_procs, new_size))
                self.telemetry.count("resilience/resize")
                self.telemetry.gauge("supervisor/cohort_resized",
                                     len(self.resizes), emit=False)
                self.telemetry.gauge("supervisor/cohort_size",
                                     new_size, emit=False)
                self.telemetry.event("cohort_resized",
                                     from_procs=self.cur_procs,
                                     to_procs=new_size, reason=reason)
                self._log(f"supervisor: re-forming cohort at "
                          f"{new_size} process(es) (was "
                          f"{self.cur_procs}; {reason})")
                self.cur_procs = new_size
            else:
                self.full_relaunches += 1
                self.telemetry.gauge("supervisor/full_relaunches",
                                     self.full_relaunches, emit=False)
            self.alerts.check_now()
            if self.restarts > self.max_restarts:
                self.telemetry.gauge("supervisor/budget_exhausted", 1,
                                     emit=False)
                self.alerts.check_now()  # the page-severity alert
                self._log(f"supervisor: restart budget exhausted "
                          f"({self.max_restarts}); exit codes {rcs}")
                raise RestartBudgetExceeded(
                    f"training cohort died {self.restarts} times "
                    f"(budget {self.max_restarts}); last exit codes "
                    f"{rcs}")
            delay = self.backoff.delay_s(self.restarts)
            self._log(f"supervisor: cohort died (exit codes {rcs}); "
                      f"relaunching in {delay:.2f}s "
                      f"(restart {self.restarts}/{self.max_restarts})")
            if self._watchdog_hb is not None:
                # the backoff sleep is a DELIBERATE wait (up to the
                # policy's max delay), not silence: exempt it from the
                # deadline; the loop-top beat re-arms on relaunch
                self._watchdog_hb.idle()
            self._sleep(delay)


def build_cli_spawn(child_cmd: Sequence[str], *, num_procs: int = 1,
                    out_dir: Optional[str] = None,
                    metrics_ports: Optional[Sequence[int]] = None,
                    env: Optional[Dict[str, str]] = None,
                    log: Optional[Callable[[str], None]] = None
                    ) -> Callable[[int, int, int, int],
                                  "subprocess.Popen"]:
    """Spawn function over a command-line child (the supervisor tool and
    the chaos legs use it): `python3 -m code2vec_tpu_torch ...` or any
    other command. A cohort of more than one process gets the explicit
    `--dist_coordinator 127.0.0.1:<port> --dist_num_processes <n>
    --dist_process_id <i>` flags appended per member, with the fresh
    port of the attempt and `n` the size of THIS attempt's cohort: a
    cohort re-formed at N-k gets N-k, so the children rebuild the mesh
    and the readers' host shards from the surviving process set, and a
    cohort re-formed at ONE process gets no flags at all and runs as a
    plain single process. `metrics_ports` gives member i a fixed
    `--metrics_port` (the fleet collector's scrape set must be known
    BEFORE launch, so members can't pick ephemeral ports); `env` is the
    children's environment (default: this process's). Child output
    streams to `attempt<k>.proc<i>.log` under `out_dir` (or inherits the
    supervisor's stdio)."""
    child_cmd = list(child_cmd)

    def spawn(attempt: int, proc_id: int, port: int,
              cohort_size: Optional[int] = None) -> "subprocess.Popen":
        n = num_procs if cohort_size is None else cohort_size
        cmd = list(child_cmd)
        if n > 1:
            cmd += ["--dist_coordinator", f"127.0.0.1:{port}",
                    "--dist_num_processes", str(n),
                    "--dist_process_id", str(proc_id)]
        if metrics_ports is not None and proc_id < len(metrics_ports):
            cmd += ["--metrics_port", str(metrics_ports[proc_id])]
        stdout = None
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            log_path = os.path.join(
                out_dir, f"attempt{attempt}.proc{proc_id}.log")
            stdout = open(log_path, "w", encoding="utf-8")
        if log is not None:
            log(f"supervisor: spawn attempt={attempt} proc={proc_id}: "
                f"{' '.join(cmd)}")
        try:
            return subprocess.Popen(cmd, env=dict(env or os.environ),
                                    stdout=stdout,
                                    stderr=subprocess.STDOUT
                                    if stdout is not None else None)
        finally:
            if stdout is not None:
                stdout.close()  # the child holds its own dup
    return spawn

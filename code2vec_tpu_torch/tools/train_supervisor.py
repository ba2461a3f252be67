"""Restart supervisor command line: wrap a training command with a bounded
restart budget, verified auto-resume and the cohort fleet plane. The
counterpart of tools/train_supervisor.py of the JAX package.

Usage (repo root):

  # one process, up to 3 restarts, resume from --save's checkpoints
  python3 -m code2vec_tpu_torch.tools.train_supervisor --max_restarts 3 \
      -- python3 -m code2vec_tpu_torch --data d/ds --save ckpt \
      --lr_schedule constant

Everything after `--` is the child command. The supervisor:

  - appends `--auto_resume` when the child has `--save` but not the flag
    (a supervised run that restarts from scratch would defeat the point;
    announced, not silent);
  - verifies the checkpoint dir before EVERY launch, quarantining
    corrupt step dirs (training/checkpoint.verify_and_resolve), so the
    child resumes from the last VERIFIED committed step;
  - escalates through the alert engine (`--telemetry_dir` makes the
    `alert` / `supervisor_*` events durable JSONL);
  - hosts the fleet plane behind `--fleet_port`: the member gets a fixed
    `--metrics_port` (`--member_metrics_base` + its process index), the
    supervisor's collector scrapes it, runs the clock handshake (the
    member commits the measured offset into its run manifest), publishes
    cohort throughput, straggler and divergence gauges, and serves the
    aggregate on `http://localhost:<fleet_port>/fleet` (JSON;
    `?format=prom` for Prometheus text).

The child trains on one card: `--procs` above 1 and `--resize_policy
shrink` exit 2, since a cohort of several processes needs multi-GPU
training, which the port does not have yet.

Exit codes: 0 = the supervised run completed; 3 = restart budget
exhausted; 2 = usage error.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional


def _child_save_dir(child_cmd) -> Optional[str]:
    for i, tok in enumerate(child_cmd):
        if tok == "--save" and i + 1 < len(child_cmd):
            return child_cmd[i + 1]
        if tok.startswith("--save="):
            return tok.split("=", 1)[1]
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m code2vec_tpu_torch.tools.train_supervisor",
        description="restart supervisor: <flags> -- <child command>")
    ap.add_argument("--max_restarts", type=int, default=3,
                    help="relaunches before giving up (page alert + "
                         "exit 3)")
    ap.add_argument("--procs", type=int, default=1,
                    help="cohort size; only 1 (multi-GPU training is "
                         "not ported)")
    ap.add_argument("--resize_policy", choices=("relaunch", "shrink"),
                    default="relaunch",
                    help="on a death: 'relaunch' (the only policy a "
                         "one-process cohort has); 'shrink' needs "
                         "multi-GPU training")
    ap.add_argument("--min_procs", type=int, default=1,
                    help="smallest cohort 'shrink' may re-form at")
    ap.add_argument("--peer_grace_s", type=float, default=15.0,
                    help="after one member dies, how long the rest get "
                         "to exit on their own before SIGKILL")
    ap.add_argument("--attempt_timeout_s", type=float, default=None,
                    help="wall limit per attempt (unset = none)")
    ap.add_argument("--backoff_base_s", type=float, default=1.0,
                    help="restart backoff base (jittered exponential, "
                         "the shared resilience/retry math)")
    ap.add_argument("--telemetry_dir", default=None,
                    help="supervisor run telemetry (supervisor_* + "
                         "alert JSONL events)")
    ap.add_argument("--watchdog_stall_s", type=float, default=0.0,
                    help="with --telemetry_dir: stall watchdog over the "
                         "supervise loop; a missed deadline dumps "
                         "diagnostics with the live cohort topology")
    ap.add_argument("--out_dir", default=None,
                    help="per-attempt child logs "
                         "(attempt<k>.proc<i>.log); default: inherit "
                         "stdio")
    ap.add_argument("--fleet_port", type=int, default=None,
                    help="host the fleet collector and serve /fleet on "
                         "this port (0 = any free port); the member "
                         "gets a fixed --metrics_port")
    ap.add_argument("--member_metrics_base", type=int, default=9200,
                    help="member i serves /metrics on base+i (the "
                         "fleet collector's scrape set)")
    ap.add_argument("--fleet_interval_s", type=float, default=2.0,
                    help="fleet collector sweep interval")
    ap.add_argument("child", nargs=argparse.REMAINDER,
                    help="-- <child command>")
    args = ap.parse_args(argv)

    child = list(args.child)
    if child and child[0] == "--":
        child = child[1:]
    if not child:
        ap.error("no child command given (put it after `--`)")
    if args.procs != 1 or args.resize_policy == "shrink":
        ap.error("--procs above 1 and --resize_policy shrink need "
                 "multi-GPU training (ROADMAP Queue 1 item 8), which "
                 "code2vec_tpu_torch does not have yet")

    from code2vec_tpu_torch.obs import (FleetCollector, MetricsServer,
                                        Telemetry, Watchdog)
    from code2vec_tpu_torch.parallel.compat import free_port
    from code2vec_tpu_torch.resilience.retry import RetryPolicy
    from code2vec_tpu_torch.training.supervisor import (
        RestartBudgetExceeded, Supervisor, build_cli_spawn)

    def log(msg: str) -> None:
        print(f"[train_supervisor] {msg}", flush=True)

    save_dir = _child_save_dir(child)
    if save_dir and "--auto_resume" not in child:
        log("child has --save but no --auto_resume; appending it "
            "(a supervised restart must resume, not retrain)")
        child.append("--auto_resume")

    telemetry = Telemetry.create(args.telemetry_dir,
                                 component="supervisor", log=log) \
        if args.telemetry_dir else None
    watchdog = None
    if args.watchdog_stall_s > 0 and telemetry is not None:
        watchdog = Watchdog.create(telemetry,
                                   stall_s=args.watchdog_stall_s,
                                   log=log).start()

    member_ports = None
    if args.fleet_port is not None:
        member_ports = [args.member_metrics_base + i
                        for i in range(args.procs)]

    sup = Supervisor(
        build_cli_spawn(child, num_procs=args.procs, out_dir=args.out_dir,
                        metrics_ports=member_ports, log=log),
        num_procs=args.procs, max_restarts=args.max_restarts,
        resize_policy=args.resize_policy, min_procs=args.min_procs,
        ckpt_dir=save_dir, telemetry=telemetry, watchdog=watchdog,
        log=log, peer_grace_s=args.peer_grace_s,
        attempt_timeout_s=args.attempt_timeout_s,
        backoff=RetryPolicy("supervisor-restart", max_attempts=1,
                            base_delay_s=args.backoff_base_s,
                            max_delay_s=60.0))
    fleet_server = None
    if member_ports is not None:
        # the collector's thread and the server's handler threads share
        # the registry with the supervise loop
        sup.telemetry.make_threadsafe()
        members = [f"127.0.0.1:{p}" for p in member_ports]
        collector = FleetCollector.create(
            sup.telemetry, members=members,
            interval_s=args.fleet_interval_s, log=log)
        sup.attach_fleet(collector, members)
        # the supervisor's own /metrics (+ /fleet) endpoint: the
        # collector's fleet/* gauges live in sup.telemetry, so one
        # scrape of this port sees both the supervisor and the cohort
        port = args.fleet_port or free_port()
        fleet_server = MetricsServer.create(
            sup.telemetry, port=port, fleet=collector, log=log).start()
    try:
        rc = sup.run()
    except RestartBudgetExceeded as e:
        log(str(e))
        rc = 3
    finally:
        if fleet_server is not None:
            fleet_server.stop()
        if watchdog is not None:
            watchdog.stop()
        if telemetry is not None:
            telemetry.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())

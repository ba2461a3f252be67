"""Chaos legs: the recovery contracts of tools/chaos.py of the JAX
package, end to end over the port's command line and supervisor.

Each leg builds a tiny synthetic dataset, runs REAL `python3 -m
code2vec_tpu_torch` training processes under the REAL supervisor
(training/supervisor.py) with a `--faults` spec arming the failpoint,
and checks the contract:

  kill_resume        SIGKILL the training run mid-epoch (constant LR,
                     `train/kill` with a once-latch marker); the
                     supervisor relaunches it with --auto_resume and the
                     final checkpoint is BIT-IDENTICAL to an
                     uninterrupted run's (step-keyed draws and the
                     resumed shuffle stream replay the trajectory).
  kill_resume_2proc  The same contract through a 2-process cohort (gloo):
                     SIGKILL process 1 mid-epoch; the supervisor reaps
                     the survivor and relaunches the WHOLE cohort on a
                     fresh port; the final params are bit-identical to
                     an uninterrupted 2-process supervised run's.
  corrupt_checkpoint Flip a byte in the largest file of the latest
                     committed step; the supervisor's pre-launch
                     verification QUARANTINES the step dir, one
                     `checkpoint_quarantined` alert fires, and training
                     resumes from the prior committed step and finishes.
  serve_swap_kill    A 2-replica pool (serving/replicas.py) under
                     open-loop Poisson load with hot-key skew takes a
                     mid-request replica death (`serve/kill`), a rolling
                     hot swap of a verified committed step
                     (serving/reload.py) and a refused bit-flipped step:
                     p99 within the SLO, no request lost, no new predict
                     signature under load, the pool back to full
                     strength. It runs in this process, on the tools'
                     tiny synthetic model.
  kill_resize        SIGKILL process 1 of a 2-process cohort mid-epoch;
                     the supervisor (resize_policy shrink) RE-FORMS the
                     cohort at 1 process (no `--dist_*` flags) with zero
                     full relaunches, the child logs the resharding line
                     loading a step saved by 2 processes, and the final
                     params are BIT-IDENTICAL to an uninterrupted
                     1-process run resumed from a copy of the same
                     committed step (constant LR). Reports the recovery
                     cost: recovery_steps_lost, recovery_seconds. Its
                     functions also take the child's mesh flags and the
                     cohort size (`mesh`, `procs`): a cohort of 4 with
                     `--mesh_model 2` (data 2, model 2) loses its last
                     process, re-forms at 2 (data 1, model 2; the shrink
                     steps by dcn * model * ctx), and is held to an
                     uninterrupted 2-rank cohort resumed from a copy of
                     the same committed step.

Usage (repo root):

  python3 -m code2vec_tpu_torch.tools.chaos --list
  python3 -m code2vec_tpu_torch.tools.chaos kill_resume --backend cpu \
      --out /tmp/chaos
  python3 -m code2vec_tpu_torch.tools.chaos corrupt_checkpoint
  python3 -m code2vec_tpu_torch.tools.chaos serve_swap_kill --backend cpu
  python3 -m code2vec_tpu_torch.tools.chaos kill_resume_2proc --backend cpu
  python3 -m code2vec_tpu_torch.tools.chaos kill_resize --backend cpu

`--backend gpu` (the default) trains and serves on the CUDA card (exit 2
without one; the members of a cohort share it over gloo), `cpu` on the
CPU (gloo). Every training process runs under a time limit (`timeout_s`,
600 s by default: an uninterrupted run's, and each supervised
attempt's). Prints a JSON result; exit 0 = the contract held, 1 = it did
not. The fault markers make every kill a cross-restart once-latch, so a
leg is a test, not a dice roll.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from code2vec_tpu_torch.tools.train_supervisor import mesh_group

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# tiny-but-learnable synthetic corpus (the JAX chaos tool's)
_TOKENS = ["foo", "bar", "baz", "qux", "value", "name", "index", "count"]
_PATHS = [str(h) for h in (123456, -98765, 424242, 1337, -777, 31415)]
_TARGETS = ["get|value", "set|value", "get|name", "set|name",
            "add|item", "remove|item", "to|string", "is|empty"]

def _raw_lines(n: int, seed: int, max_ctx: int) -> list:
    rng = random.Random(seed)
    lines = []
    for _ in range(n):
        t = rng.randrange(len(_TARGETS))
        ctxs = []
        for _ in range(rng.randint(1, max_ctx)):
            a = _TOKENS[(t + rng.randrange(2)) % len(_TOKENS)]
            b = _TOKENS[(t * 3 + rng.randrange(2)) % len(_TOKENS)]
            p = _PATHS[t % len(_PATHS)] if rng.random() < 0.7 \
                else rng.choice(_PATHS)
            ctxs.append(f"{a},{p},{b}")
        lines.append(_TARGETS[t] + " " + " ".join(ctxs))
    return lines


def build_dataset(out_dir: str, *, n_train: int = 96,
                  max_contexts: int = 8) -> str:
    from code2vec_tpu_torch.data import preprocess
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for split, n, seed in (("train", n_train, 1), ("val", 16, 2),
                           ("test", 16, 3)):
        p = os.path.join(out_dir, f"raw.{split}.txt")
        with open(p, "w", encoding="utf-8") as f:
            f.write("\n".join(_raw_lines(n, seed, max_contexts)) + "\n")
        paths[split] = p
    prefix = os.path.join(out_dir, "chaos")
    preprocess.main([
        "--train_data", paths["train"], "--val_data", paths["val"],
        "--test_data", paths["test"],
        "--max_contexts", str(max_contexts),
        "--word_vocab_size", "1000", "--path_vocab_size", "1000",
        "--target_vocab_size", "1000", "--output_name", prefix])
    return prefix


def train_cmd(prefix: str, save_dir: str, *, epochs: int, backend: str,
              batch: int = 32, max_contexts: int = 8) -> list:
    """Constant LR (a resumed decaying horizon would legitimately
    diverge) over the tiny corpus; everything else is the default,
    async checkpointing included."""
    return [sys.executable, "-m", "code2vec_tpu_torch",
            "--data", prefix, "--save", save_dir,
            "--epochs", str(epochs), "--batch_size", str(batch),
            "--max_contexts", str(max_contexts),
            "--lr_schedule", "constant", "--seed", "11",
            "--backend", backend]


def child_env() -> Dict[str, str]:
    """The children's environment: this one, with the repo on the path
    so `python3 -m code2vec_tpu_torch` resolves from any directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in (env.get("PYTHONPATH") or "").split(os.pathsep)
                   if p])
    return env


def _run_plain(cmd: list, *, timeout_s: float) -> str:
    """Run `cmd` to its end; its output (RuntimeError if it failed)."""
    r = subprocess.run(cmd, env=child_env(), stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True,
                       timeout=timeout_s)
    if r.returncode != 0:
        raise RuntimeError(f"uninterrupted run failed (rc {r.returncode}):"
                           f"\n{r.stdout[-4000:]}")
    return r.stdout


def latest_state(ckpt_dir: str):
    """(step, state) of the latest committed step, CPU tensors."""
    from code2vec_tpu_torch.training import checkpoint as ckpt
    state = ckpt.load_checkpoint(ckpt_dir)
    return state["step"], {"params": state["params"],
                           "opt_state": state["opt_state"]}


def states_differ(a, b) -> List[str]:
    """Paths of the tensors whose bits DIFFER between two state trees
    (empty: bit-identical; -0.0 and 0.0 differ)."""
    import torch

    def named(x, path=""):
        if isinstance(x, torch.Tensor):
            return [(path, x)]
        if isinstance(x, dict):
            items = sorted(x.items())
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            items = zip(x._fields, x)
        elif isinstance(x, (list, tuple)):
            items = enumerate(x)
        else:
            return []
        return [nt for k, v in items for nt in named(v, f"{path}/{k}")]

    def bits(t):
        return t.detach().contiguous().reshape(-1).view(torch.uint8)

    la, lb = named(a), named(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return ["<structure mismatch>"]
    return [p for (p, x), (_, y) in zip(la, lb)
            if x.dtype != y.dtype or x.shape != y.shape
            or not torch.equal(bits(x), bits(y))]


def _write_faults(path: str, sites: dict) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"seed": 0, "sites": sites}, f)
    return path


def _supervised(child_cmd: list, *, out: str, ckpt_dir: str,
                num_procs: int = 1, telemetry_dir: Optional[str] = None,
                max_restarts: int = 2, attempt_timeout_s: float = 600.0,
                **sup_kwargs):
    from code2vec_tpu_torch.obs import Telemetry
    from code2vec_tpu_torch.resilience.retry import RetryPolicy
    from code2vec_tpu_torch.training.supervisor import (Supervisor,
                                                        build_cli_spawn)

    def log(msg: str) -> None:
        print(f"[chaos] {msg}", flush=True)

    telemetry = Telemetry.create(telemetry_dir, component="supervisor",
                                 log=log) if telemetry_dir else None
    spawn = build_cli_spawn(child_cmd, num_procs=num_procs,
                            out_dir=os.path.join(out, "logs"),
                            env=child_env(), log=log)
    sup = Supervisor(
        spawn, num_procs=num_procs, max_restarts=max_restarts,
        ckpt_dir=ckpt_dir, telemetry=telemetry, log=log, peer_grace_s=10.0,
        attempt_timeout_s=attempt_timeout_s,
        backoff=RetryPolicy("supervisor-restart", max_attempts=1,
                            base_delay_s=0.2, max_delay_s=1.0, seed=0),
        **sup_kwargs)
    try:
        rc = sup.run()
    finally:
        # flush even when the budget runs out: the supervisor's JSONL is
        # the postmortem for exactly that case
        if telemetry is not None:
            telemetry.close()
    return rc, sup, telemetry.run_dir if telemetry is not None else None


def read_events(run_dir: str) -> list:
    with open(os.path.join(run_dir, "events.jsonl"),
              encoding="utf-8") as f:
        return [json.loads(ln) for ln in f if ln.strip()]


# ------------------------------------------------------------ the legs

def scenario_kill_resume(out: str, *, backend: str = "gpu",
                         epochs: int = 2, kill_at_step: int = 5,
                         timeout_s: float = 600.0) -> dict:
    """SIGKILL mid-epoch -> supervisor relaunch -> auto-resume -> final
    checkpoint bit-identical to an uninterrupted run's."""
    prefix = build_dataset(os.path.join(out, "data"))
    oracle_dir = os.path.join(out, "ckpt_oracle")
    chaos_dir = os.path.join(out, "ckpt_chaos")
    t0 = time.time()
    _run_plain(train_cmd(prefix, oracle_dir, epochs=epochs,
                         backend=backend), timeout_s=timeout_s)

    marker = os.path.join(out, "killed.once")
    faults = _write_faults(os.path.join(out, "faults.json"), {
        "train/kill": {"action": "kill", "at": kill_at_step,
                       "marker": marker}})
    cmd = train_cmd(prefix, chaos_dir, epochs=epochs, backend=backend) \
        + ["--auto_resume", "--faults", faults]
    rc, sup, run_dir = _supervised(
        cmd, out=out, ckpt_dir=chaos_dir,
        telemetry_dir=os.path.join(out, "tele"),
        attempt_timeout_s=timeout_s)

    o_step, o_state = latest_state(oracle_dir)
    c_step, c_state = latest_state(chaos_dir)
    diffs = states_differ(o_state, c_state)
    result = {
        "scenario": "kill_resume",
        "backend": backend,
        "kill_fired": os.path.exists(marker),
        "supervisor_rc": rc,
        "restarts": sup.restarts,
        "resumed_from_step": sup.resumed_from_step,
        "oracle_step": o_step, "chaos_step": c_step,
        "param_diffs": diffs,
        "wall_s": round(time.time() - t0, 1),
        "telemetry_run_dir": run_dir,
    }
    result["ok"] = (result["kill_fired"] and rc == 0
                    and sup.restarts == 1 and o_step == c_step
                    and not diffs)
    return result


def scenario_kill_resume_2proc(out: str, *, backend: str = "gpu",
                               epochs: int = 3, kill_at_step: int = 4,
                               timeout_s: float = 600.0) -> dict:
    """The same parity contract through a real 2-process gloo cohort:
    process 1 is SIGKILLed mid-epoch; the supervisor reaps the surviving
    peer and relaunches the cohort coherently on a fresh port."""
    prefix = build_dataset(os.path.join(out, "data"))
    oracle_dir = os.path.join(out, "ckpt_oracle")
    chaos_dir = os.path.join(out, "ckpt_chaos")
    t0 = time.time()
    # the oracle is ALSO a 2-process supervised run: the same topology,
    # the only difference is the injected fault. A transient loopback
    # failure may restart the oracle too (its child has --auto_resume
    # like any supervised run): fine precisely BECAUSE resume is
    # bit-exact, which is the property under test; oracle restarts are
    # recorded, not rejected
    rc_o, sup_o, _ = _supervised(
        train_cmd(prefix, oracle_dir, epochs=epochs, backend=backend)
        + ["--auto_resume"], out=os.path.join(out, "oracle"), num_procs=2,
        ckpt_dir=oracle_dir, attempt_timeout_s=timeout_s)
    if rc_o != 0:
        return {"scenario": "kill_resume_2proc", "backend": backend,
                "ok": False, "error": f"oracle cohort failed (rc {rc_o}, "
                                      f"restarts {sup_o.restarts})"}

    marker = os.path.join(out, "killed.once")
    faults = _write_faults(os.path.join(out, "faults.json"), {
        "train/kill": {"action": "kill", "at": kill_at_step,
                       "process": 1, "marker": marker}})
    cmd = train_cmd(prefix, chaos_dir, epochs=epochs, backend=backend) \
        + ["--auto_resume", "--faults", faults]
    rc, sup, run_dir = _supervised(
        cmd, out=os.path.join(out, "chaos"), num_procs=2,
        ckpt_dir=chaos_dir, telemetry_dir=os.path.join(out, "tele"),
        attempt_timeout_s=timeout_s)

    o_step, o_state = latest_state(oracle_dir)
    c_step, c_state = latest_state(chaos_dir)
    diffs = states_differ(o_state, c_state)
    result = {
        "scenario": "kill_resume_2proc",
        "backend": backend,
        "kill_fired": os.path.exists(marker),
        "supervisor_rc": rc,
        "oracle_restarts": sup_o.restarts,
        "restarts": sup.restarts,
        "resumed_from_step": sup.resumed_from_step,
        "oracle_step": o_step, "chaos_step": c_step,
        "param_diffs": diffs,
        "wall_s": round(time.time() - t0, 1),
        "telemetry_run_dir": run_dir,
    }
    result["ok"] = (result["kill_fired"] and rc == 0
                    and sup.restarts >= 1 and o_step == c_step
                    and not diffs)
    return result


def _step_event_times(tele_root: str) -> list:
    """(ts, step) for every per-step telemetry event under any run dir
    of `tele_root`. The event log is flushed per event, so even a
    SIGKILLed attempt's steps are on disk up to the kill."""
    import glob as glob_mod
    out = []
    for path in glob_mod.glob(os.path.join(tele_root, "*",
                                           "events.jsonl")):
        with open(path, encoding="utf-8") as f:
            for ln in f:
                if not ln.strip():
                    continue
                ev = json.loads(ln)
                if ev.get("kind") == "step":
                    out.append((float(ev["ts"]), int(ev["step"])))
    return sorted(out)


def _marker_ts(marker: str) -> Optional[float]:
    """The firing wall-clock the fault site wrote into its once-latch
    marker (`... ts=<float>`)."""
    import re as re_mod
    try:
        with open(marker, encoding="utf-8") as f:
            m = re_mod.search(r"ts=([0-9.]+)", f.read())
        return float(m.group(1)) if m else None
    except OSError:
        return None


def run_kill_resize(out: str, *, backend: str = "gpu", epochs: int = 3,
                    kill_at_step: int = 4, procs: int = 2,
                    mesh: Optional[List[str]] = None,
                    timeout_s: float = 600.0, tries: int = 3) -> dict:
    """The run half of the kill_resize leg: train a `procs`-process
    cohort (the child's mesh flags `mesh`, e.g. ["--mesh_model", "2"])
    under the shrink-policy supervisor, SIGKILL its last process at
    `kill_at_step`, let the cohort RE-FORM at procs-k (k = dcn * model *
    ctx of `mesh`), and measure the recovery cost: steps lost (the
    kill's step minus the committed step the re-formed cohort resumed
    from) and seconds from the kill to the
    first training step after the resize (the relaunched children's
    per-step telemetry events against the kill's time the fault marker
    recorded).

    A loopback transport failure can abort a cohort at start-up BEFORE
    the injected kill arms: the supervisor handles it by its policy (a
    lone early death resizes, a whole-cohort crash relaunches at full
    size), but as a measurement such a try is transient infrastructure,
    not the contract: it is retried in a fresh subdirectory until the
    kill fired after a committed checkpoint existed."""
    last = None
    for i in range(max(1, tries)):
        sub = os.path.join(out, f"try{i}")
        os.makedirs(sub, exist_ok=True)
        last = _run_kill_resize_once(
            sub, backend=backend, epochs=epochs, kill_at_step=kill_at_step,
            procs=procs, mesh=list(mesh or []), timeout_s=timeout_s)
        if (last["kill_fired"] and last["supervisor_rc"] == 0
                and last["resumed_from_step"] is not None):
            return last
        print(f"[chaos] kill_resize try {i} hit transient infra "
              f"(kill_fired={last['kill_fired']}, resumed="
              f"{last['resumed_from_step']}); retrying in a fresh dir",
              flush=True)
    return last


def _run_kill_resize_once(out: str, *, backend: str, epochs: int,
                          kill_at_step: int, procs: int, mesh: List[str],
                          timeout_s: float) -> dict:
    prefix = build_dataset(os.path.join(out, "data"))
    chaos_dir = os.path.join(out, "ckpt_chaos")
    child_tele = os.path.join(out, "child_tele")
    marker = os.path.join(out, "killed.once")
    faults = _write_faults(os.path.join(out, "faults.json"), {
        "train/kill": {"action": "kill", "at": kill_at_step,
                       "process": procs - 1, "marker": marker}})
    # synchronous checkpointing: the contract under test is TOPOLOGY
    # recovery from a committed step, so the committed step must be
    # deterministic (an async commit could lose the race to a mid-epoch
    # kill). kill_resume keeps the default async saves
    cmd = train_cmd(prefix, chaos_dir, epochs=epochs, backend=backend) \
        + mesh + ["--async_checkpoint", "off", "--auto_resume",
                  "--faults", faults, "--telemetry_dir", child_tele]
    rc, sup, run_dir = _supervised(
        cmd, out=out, num_procs=procs, ckpt_dir=chaos_dir,
        telemetry_dir=os.path.join(out, "tele"),
        attempt_timeout_s=timeout_s, resize_policy="shrink", min_procs=1,
        group=mesh_group(mesh))

    kill_ts = _marker_ts(marker)
    resumed = sup.resumed_from_step
    steps = _step_event_times(child_tele)
    first_post = next((ts for ts, _s in steps
                       if sup.last_launch_ts is not None
                       and ts >= sup.last_launch_ts), None)
    recovery_seconds = (round(first_post - kill_ts, 3)
                        if first_post is not None
                        and kill_ts is not None else None)
    recovery_steps_lost = (kill_at_step - resumed
                           if resumed is not None else kill_at_step)
    # the re-formed member's own log: whether it joined a process group
    # (a cohort of one must not) and logged the resharding line
    final_log = os.path.join(out, "logs",
                             f"attempt{sup.restarts}.proc0.log")
    try:
        with open(final_log, encoding="utf-8", errors="replace") as f:
            text = f.read()
    except OSError:
        text = ""
    from code2vec_tpu_torch.training import checkpoint as ckpt
    topo_after = {s: (ckpt.load_step_topology(chaos_dir, s) or {}).get(
        "num_processes") for s, _d in ckpt._step_dirs(chaos_dir)
        if resumed is not None and s > resumed} \
        if os.path.isdir(chaos_dir) else {}
    # the record of the step the re-formed cohort restored: the saving
    # cohort's processes and (where fewer) batch shards
    topo_resumed = (ckpt.load_step_topology(chaos_dir, resumed) or {}) \
        if resumed is not None else {}
    return {
        "kill_fired": os.path.exists(marker),
        "supervisor_rc": rc,
        "restarts": sup.restarts,
        "resizes": [list(r) for r in sup.resizes],
        "full_relaunches": sup.full_relaunches,
        "cohort_size_final": sup.cur_procs,
        "resumed_from_step": resumed,
        "kill_at_step": kill_at_step,
        "recovery_steps_lost": recovery_steps_lost,
        "recovery_seconds": recovery_seconds,
        "reformed_joined_group": "initializing torch.distributed" in text,
        "resharding_logged": "resharding onto the new mesh" in text,
        "topology_after_resize": topo_after,
        "topology_resumed": topo_resumed,
        "mesh": mesh,
        "data_prefix": prefix,
        "ckpt_dir": chaos_dir,
        "telemetry_run_dir": run_dir,
    }


def copy_committed_step(src_dir: str, dest_dir: str, step: int) -> None:
    """`dest_dir` holding `src_dir`'s committed step `step` and its
    sidecars: what a run resumed from that step alone sees. The step
    dir's files are hard-linked: they are written by tmp + os.replace
    and never rewritten in place, so the links are the exact bytes the
    re-formed cohort restored, and no data is written. vocab.pkl and
    manifest.json are copied: a save rewrites them in place."""
    import shutil
    os.makedirs(dest_dir)
    shutil.copytree(os.path.join(src_dir, f"step_{step}"),
                    os.path.join(dest_dir, f"step_{step}"),
                    copy_function=os.link)
    for sidecar in ("manifest.json", "vocab.pkl"):
        shutil.copy2(os.path.join(src_dir, sidecar),
                     os.path.join(dest_dir, sidecar))


def scenario_kill_resize(out: str, *, backend: str = "gpu",
                         epochs: int = 3, kill_at_step: int = 4,
                         procs: int = 2, mesh: Optional[List[str]] = None,
                         timeout_s: float = 600.0) -> dict:
    """SIGKILL one peer of a 2-process cohort mid-epoch; the supervisor
    re-forms the cohort at 1 process (a resize, ZERO full-cohort
    relaunches), the survivor loads the step saved by 2 processes, and
    the final params are bit-identical to an uninterrupted 1-process run
    resumed from a copy of the same committed step (constant LR): the
    elastic resume parity bar. With `procs` and the child's mesh flags
    `mesh` the cohort re-forms at procs-k (k = dcn * model * ctx) and
    the oracle is an uninterrupted cohort of procs-k."""
    t0 = time.time()
    mesh = list(mesh or [])
    reformed = procs - mesh_group(mesh)
    run = run_kill_resize(out, backend=backend, epochs=epochs,
                          kill_at_step=kill_at_step, procs=procs, mesh=mesh,
                          timeout_s=timeout_s)
    result = dict(run, scenario="kill_resize", backend=backend,
                  wall_s=None, param_diffs=["<not compared>"])
    chaos_dir = run["ckpt_dir"]
    S = run["resumed_from_step"]
    if run["supervisor_rc"] != 0 or S is None:
        result["ok"] = False
        result["wall_s"] = round(time.time() - t0, 1)
        return result

    # the oracle: an UNINTERRUPTED run of the re-formed cohort's size
    # resumed from the SAME committed step the re-formed cohort
    # restored, with the re-formed child's checkpoint mode (sync saves),
    # so the two runs differ in nothing but history
    oracle_dir = os.path.join(out, "ckpt_oracle")
    copy_committed_step(chaos_dir, oracle_dir, S)
    oracle_cmd = train_cmd(run["data_prefix"], oracle_dir, epochs=epochs,
                           backend=backend) \
        + mesh + ["--async_checkpoint", "off", "--auto_resume"]
    if reformed == 1:
        _run_plain(oracle_cmd, timeout_s=timeout_s)
    else:
        rc_o, sup_o, _ = _supervised(
            oracle_cmd, out=os.path.join(out, "oracle"), num_procs=reformed,
            ckpt_dir=oracle_dir, attempt_timeout_s=timeout_s)
        result["oracle_restarts"] = sup_o.restarts
        if rc_o != 0:
            result.update(ok=False, error=f"oracle cohort failed (rc {rc_o})",
                          wall_s=round(time.time() - t0, 1))
            return result

    o_step, o_state = latest_state(oracle_dir)
    c_step, c_state = latest_state(chaos_dir)
    diffs = states_differ(o_state, c_state)
    result.update(
        oracle_step=o_step, chaos_step=c_step, param_diffs=diffs,
        wall_s=round(time.time() - t0, 1))
    result["ok"] = (run["kill_fired"] and run["supervisor_rc"] == 0
                    and run["restarts"] == 1
                    and run["resizes"] == [[procs, reformed]]
                    and run["full_relaunches"] == 0
                    and o_step == c_step and not diffs)
    return result


def flip_byte_in_largest_file(step_dir: str) -> str:
    """Flip one byte mid-file in the largest file of the step's state
    tree: the bit rot the checksums exist to catch."""
    state = os.path.join(step_dir, "state")
    largest, size = None, -1
    for base, _dirs, files in os.walk(state):
        for name in files:
            p = os.path.join(base, name)
            s = os.path.getsize(p)
            if s > size:
                largest, size = p, s
    assert largest is not None and size > 0
    with open(largest, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    return largest


def scenario_corrupt_checkpoint(out: str, *, backend: str = "gpu",
                                timeout_s: float = 600.0) -> dict:
    """A flipped byte in the latest committed step: the supervisor's
    verification quarantines the step dir, one `checkpoint_quarantined`
    alert fires, and training resumes from the prior committed step."""
    from code2vec_tpu_torch.training import checkpoint as ckpt
    prefix = build_dataset(os.path.join(out, "data"))
    ckpt_dir = os.path.join(out, "ckpt")
    t0 = time.time()
    # 2 epochs -> two committed, checksummed steps (3 and 6)
    _run_plain(train_cmd(prefix, ckpt_dir, epochs=2, backend=backend),
               timeout_s=timeout_s)
    steps = sorted(s for s, _ in ckpt._step_dirs(ckpt_dir))
    assert len(steps) == 2, steps
    flipped = flip_byte_in_largest_file(
        os.path.join(ckpt_dir, f"step_{steps[-1]}"))

    # resume for a 3rd epoch: the supervisor must fall back to steps[0]
    cmd = train_cmd(prefix, ckpt_dir, epochs=3, backend=backend) \
        + ["--auto_resume"]
    rc, sup, run_dir = _supervised(
        cmd, out=out, ckpt_dir=ckpt_dir,
        telemetry_dir=os.path.join(out, "tele"),
        attempt_timeout_s=timeout_s)

    quarantined = os.path.join(ckpt_dir, ckpt.QUARANTINE_DIRNAME,
                               f"step_{steps[-1]}")
    alerts = [e for e in read_events(run_dir)
              if e.get("kind") == "alert"
              and e.get("rule") == "checkpoint_quarantined"
              and e.get("transition") == "firing"] if run_dir else []
    final = ckpt.latest_step(ckpt_dir)
    result = {
        "scenario": "corrupt_checkpoint",
        "backend": backend,
        "flipped_file": os.path.relpath(flipped, out),
        "supervisor_rc": rc,
        "restarts": sup.restarts,
        "resumed_from_step": sup.resumed_from_step,
        "quarantined": sup.quarantined,
        "quarantine_dir_exists": os.path.isdir(quarantined),
        "alert_events": len(alerts),
        "final_step": final,
        "wall_s": round(time.time() - t0, 1),
        "telemetry_run_dir": run_dir,
    }
    result["ok"] = (rc == 0 and result["quarantine_dir_exists"]
                    and sup.resumed_from_step == steps[0]
                    and len(alerts) == 1
                    and final is not None and final > steps[-1])
    return result


def scenario_serve_swap_kill(out: str, *, backend: str = "gpu",
                             timeout_s: float = 120.0, replicas: int = 2,
                             requests: int = 768, qps: float = 120.0,
                             kill_at: int = 40) -> dict:
    """A replica pool under open-loop Poisson load with hot-key skew takes
    a mid-request replica death (`serve/kill`), a rolling hot swap of a
    VERIFIED committed checkpoint and a REFUSED bit-flipped step, and the
    external contract holds: p99 under the SLO, zero requests lost
    (sheds are explicit), no new predict signature under load, the pool
    back to full strength."""
    import threading

    from code2vec_tpu_torch import tree
    from code2vec_tpu_torch.obs import Telemetry
    from code2vec_tpu_torch.obs.alerts import (AlertEngine,
                                               serving_slo_rules)
    from code2vec_tpu_torch.resilience import faults
    from code2vec_tpu_torch.serving import ReloadManager, ReplicaPool
    from code2vec_tpu_torch.tools import loadgen
    from code2vec_tpu_torch.training import checkpoint as ckpt

    t0 = time.time()
    # the loadgen tiny-model recipe: latency is shape-dependent, not
    # value-dependent, so random weights over tiny vocabs serve fine
    data_dir = os.path.join(out, "data")
    os.makedirs(data_dir, exist_ok=True)
    cfg = loadgen.tiny_config(data_dir)
    cfg.SERVE_REPLICAS = replicas
    cfg.SERVE_MAX_REPLICAS = max(replicas, cfg.SERVE_MAX_REPLICAS)

    # one in-band kill: the kill_at-th predict_lines call raises
    # FaultInjected inside whichever replica serves it (action "kill"
    # would SIGKILL this whole process); the pool must retry the request
    # on a survivor and refill in the background
    faults.install({"seed": 0, "sites": {
        "serve/kill": {"action": "raise", "at": kill_at}}},
        log=lambda m: print(f"[chaos] {m}", flush=True))

    tele = Telemetry.memory("chaos-serving").make_threadsafe()
    pool = ReplicaPool(cfg, loadgen.model_factory(
        cfg, loadgen.backend_device(backend)),
        replicas=replicas, telemetry=tele).start()
    alerts = AlertEngine.create(
        tele, mode="warn", rules=serving_slo_rules(cfg.SERVE_SLO_MS))
    reload_dir = os.path.join(out, "serve_ckpt")
    rm = ReloadManager(reload_dir, pool, telemetry=tele, alerts=alerts,
                       poll_s=0.1).start()

    progress = {}

    def _chaos_actions() -> None:
        # vocabs/dims for the sidecars come from a live replica; the
        # swapped-in params are a real value change (the float32 dense
        # leaves move; same shapes, so no new predict signature)
        model = pool._replicas[0].server.model
        new_params = tree.map_leaves(lambda x: (x * 1.001).to(x.dtype),
                                     pool.params_template())
        time.sleep(0.5)  # let the load establish itself first
        ckpt.save_checkpoint(reload_dir, {"params": new_params}, 1,
                             model.vocabs, model.dims)
        deadline = time.time() + timeout_s
        while rm.last_step < 1 and time.time() < deadline:
            time.sleep(0.05)
        if rm.last_step >= 1:
            progress["swap_ts"] = time.time()
        ckpt.save_checkpoint(reload_dir, {"params": new_params}, 2,
                             model.vocabs, model.dims)
        flip_byte_in_largest_file(os.path.join(reload_dir, "step_2"))
        deadline = time.time() + timeout_s
        while 2 not in rm.refused and time.time() < deadline:
            time.sleep(0.05)
        if 2 in rm.refused:
            progress["refused_ts"] = time.time()

    actions = threading.Thread(target=_chaos_actions,
                               name="chaos-actions", daemon=True)
    corpus = loadgen.gen_corpus(requests, 1,
                                max_ctx=min(cfg.MAX_CONTEXTS, 12))
    try:
        actions.start()
        report = loadgen.run_load(
            pool, corpus, mode="open", concurrency=16, qps=qps,
            arrivals="poisson", hot_key_frac=0.25, hot_keys=8, seed=0)
        t_load_end = time.time()
        actions.join(timeout=2 * timeout_s)
        # the refill may still be warming when the load drains; it
        # must land (back to full strength) before the verdict
        pool.wait_ready(replicas, timeout_s=timeout_s)
        compile_delta = pool.compile_delta()
        table = pool.pool_table()
        counters = dict(tele.counters)
        fired = faults.stats().get("serve/kill", {}).get("fired", 0)
        refused_state = next(
            (r["state"] for r in alerts.status_table()
             if r["rule"] == "reload_refused"), None)
    finally:
        rm.stop()
        pool.close()
        faults.clear()

    result = {
        "scenario": "serve_swap_kill",
        "backend": backend,
        "requests": report["requests"],
        "ok_requests": report["ok"],
        "shed": report["shed"],
        "errors": report["errors"],
        "p50_ms": report["latency"]["p50_ms"],
        "p99_ms": report["latency"]["p99_ms"],
        "slo_ms": cfg.SERVE_SLO_MS,
        "throughput_rps": report["throughput_rps"],
        "kill_fired": fired == 1,
        "replica_dead": counters.get("serve/replica_dead", 0),
        "replica_refill": counters.get("serve/replica_refill", 0),
        "reloads": counters.get("serve/reloads", 0),
        "reload_refused": counters.get("serve/reload_refused", 0),
        "swapped_step": rm.last_step,
        "refused_steps": sorted(rm.refused),
        "swap_under_load": ("swap_ts" in progress
                            and progress["swap_ts"] <= t_load_end),
        "refused_alert_state": refused_state,
        "pool_generation": table["generation"],
        "pool_ready": table["ready"],
        "new_compilations_under_load": compile_delta,
        "cache_hits": counters.get("serve/cache_hit", 0),
        "wall_s": round(time.time() - t0, 1),
    }
    if report["errors"]:
        result["first_error"] = report.get("first_error")
    result["ok"] = (
        report["errors"] == 0
        and report["requests"] == report["ok"] + report["shed"]
        and report["latency"]["p99_ms"] <= cfg.SERVE_SLO_MS
        and result["kill_fired"]
        and result["replica_dead"] == 1
        and result["replica_refill"] == 1
        and result["swapped_step"] == 1
        and table["generation"] == 1
        and result["refused_steps"] == [2]
        and result["swap_under_load"]
        and refused_state == "firing"
        and compile_delta == 0
        and table["ready"] >= replicas)
    return result


SCENARIOS = {
    "kill_resume": scenario_kill_resume,
    "kill_resume_2proc": scenario_kill_resume_2proc,
    "corrupt_checkpoint": scenario_corrupt_checkpoint,
    "serve_swap_kill": scenario_serve_swap_kill,
    "kill_resize": scenario_kill_resize,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m code2vec_tpu_torch.tools.chaos",
        description="chaos legs over the real supervisor and failpoints")
    ap.add_argument("scenario", nargs="?", choices=sorted(SCENARIOS),
                    help="which contract to exercise")
    ap.add_argument("--list", action="store_true",
                    help="list the legs and exit")
    ap.add_argument("--backend", choices=("gpu", "cpu"), default="gpu",
                    help="where the training children run (default: "
                         "the CUDA card)")
    ap.add_argument("--out", default=None,
                    help="work dir (default: a fresh temp dir)")
    args = ap.parse_args(argv)

    if args.list or not args.scenario:
        for name, fn in sorted(SCENARIOS.items()):
            print(f"{name}: {' '.join((fn.__doc__ or '').split())}")
        return 0

    if args.scenario == "serve_swap_kill":
        # the leg serves in this process; the training legs' children
        # refuse a missing card themselves
        from code2vec_tpu_torch.tools.loadgen import gpu_missing
        if gpu_missing(args.backend):
            return 2
    out = args.out or tempfile.mkdtemp(prefix=f"chaos_{args.scenario}_")
    os.makedirs(out, exist_ok=True)
    result = SCENARIOS[args.scenario](out, backend=args.backend)
    print(json.dumps(result, indent=1, default=str))
    return 0 if result.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())

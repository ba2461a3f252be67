"""Chaos legs: the single-process recovery contracts of tools/chaos.py of
the JAX package, end to end over the port's command line and supervisor.

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
  corrupt_checkpoint Flip a byte in the largest file of the latest
                     committed step; the supervisor's pre-launch
                     verification QUARANTINES the step dir, one
                     `checkpoint_quarantined` alert fires, and training
                     resumes from the prior committed step and finishes.

Not ported yet (`--list` names them): `kill_resume_2proc` and
`kill_resize` need multi-GPU training; `serve_swap_kill` needs the
serving fleet (replica pool, hot reload).

Usage (repo root):

  python3 -m code2vec_tpu_torch.tools.chaos --list
  python3 -m code2vec_tpu_torch.tools.chaos kill_resume --backend cpu \
      --out /tmp/chaos
  python3 -m code2vec_tpu_torch.tools.chaos corrupt_checkpoint

`--backend gpu` (the default) trains on the CUDA card, `cpu` on the CPU.
Every training process runs under a time limit (`timeout_s`, 600 s by
default: an uninterrupted run's, and each supervised attempt's). Prints
a JSON result; exit 0 = the contract held, 1 = it did not.
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

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# tiny-but-learnable synthetic corpus (the JAX chaos tool's)
_TOKENS = ["foo", "bar", "baz", "qux", "value", "name", "index", "count"]
_PATHS = [str(h) for h in (123456, -98765, 424242, 1337, -777, 31415)]
_TARGETS = ["get|value", "set|value", "get|name", "set|name",
            "add|item", "remove|item", "to|string", "is|empty"]

_NOT_PORTED = {
    "kill_resume_2proc": "SIGKILL one process of a 2-process cohort "
                         "(needs multi-GPU training)",
    "kill_resize": "re-form a cohort at N-1 processes (needs multi-GPU "
                   "training)",
    "serve_swap_kill": "a replica death and a hot reload under load "
                       "(needs the serving fleet)",
}


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


def _run_plain(cmd: list, *, timeout_s: float) -> None:
    r = subprocess.run(cmd, env=child_env(), stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True,
                       timeout=timeout_s)
    if r.returncode != 0:
        raise RuntimeError(f"uninterrupted run failed (rc {r.returncode}):"
                           f"\n{r.stdout[-4000:]}")


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
                telemetry_dir: Optional[str] = None,
                max_restarts: int = 2, attempt_timeout_s: float = 600.0):
    from code2vec_tpu_torch.obs import Telemetry
    from code2vec_tpu_torch.resilience.retry import RetryPolicy
    from code2vec_tpu_torch.training.supervisor import (Supervisor,
                                                        build_cli_spawn)

    def log(msg: str) -> None:
        print(f"[chaos] {msg}", flush=True)

    telemetry = Telemetry.create(telemetry_dir, component="supervisor",
                                 log=log) if telemetry_dir else None
    spawn = build_cli_spawn(child_cmd, out_dir=os.path.join(out, "logs"),
                            env=child_env(), log=log)
    sup = Supervisor(
        spawn, max_restarts=max_restarts, ckpt_dir=ckpt_dir,
        telemetry=telemetry, log=log, peer_grace_s=10.0,
        attempt_timeout_s=attempt_timeout_s,
        backoff=RetryPolicy("supervisor-restart", max_attempts=1,
                            base_delay_s=0.2, max_delay_s=1.0, seed=0))
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


SCENARIOS = {
    "kill_resume": scenario_kill_resume,
    "corrupt_checkpoint": scenario_corrupt_checkpoint,
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
        for name, what in sorted(_NOT_PORTED.items()):
            print(f"{name}: not ported: {what}")
        return 0

    out = args.out or tempfile.mkdtemp(prefix=f"chaos_{args.scenario}_")
    os.makedirs(out, exist_ok=True)
    result = SCENARIOS[args.scenario](out, backend=args.backend)
    print(json.dumps(result, indent=1, default=str))
    return 0 if result.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())

"""`--predict`, the REPL and `--attack` on a cohort of ranks: rank 0
leads, the other ranks follow.

The JAX package's `code2vec.py` starts its REPL on every process with no
rank gate: each process of its SPMD program reads its own stdin and
enters each jitted call with the same inputs. A cohort of the port is a
process group (parallel/distributed.py) whose launcher gives stdin to
one process, and its ranks must enter each collective in the same
order. So the port departs from the JAX package here:

- **Rank 0 leads.** It alone reads stdin and the input file, runs the
  extractor, the prediction server (its batcher, cache and deadline),
  the attack's host loop and all printing, and alone writes
  `<attack_input>.adversarial`. It decides each cache hit; a hit
  launches nothing on any rank.
- **The other ranks follow** (`follow`). Each waits for the next command
  from rank 0 and joins the collective device call it names, with the
  inputs rank 0 sent: a predict batch (`Code2VecModel.predict_padded`),
  the attack's score, re-score or predict (attacks/gradient_attack.py's
  batched steps, collective under a model axis only), or stop. A follower
  prints none of the REPL's answers and never runs on another device
  than its rank's.
- **Every way out of rank 0 sends stop with its exit code** (`lead`):
  `q`, EOF, Ctrl-C, an extractor error, an attack's ValueError (exit 2)
  or any exception (exit 1; a KeyboardInterrupt outside the REPL's
  prompt 130). Each follower then exits with that code.

The commands travel over a gloo group of their own
(`CohortChannel`), whose timeout is the wait of an idle REPL
(`IDLE_TIMEOUT_S`, a week): a follower may wait at the prompt's pace
while the process group's collectives keep their 300 s
(parallel/distributed.maybe_initialize). A lost leader fails the
follower's wait at once (the connection closes). A command's inputs
are host arrays (numpy), pickled with the command.

Torch is imported inside the functions (serving/ imports with torch
blocked, tests/test_torch_serving_fleet.py).
"""

from __future__ import annotations

import datetime
import threading
from typing import Any, Callable, Tuple

# a follower's wait for rank 0's next command (an idle REPL)
IDLE_TIMEOUT_S = 7 * 24 * 3600.0
STOP = "stop"
PREDICT = "predict"


def to_host(x):
    """Tensors (in tuples and lists) as numpy arrays; the rest as is."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(to_host(v) for v in x)
    return x


def to_device(x, device):
    """`to_host`'s inverse: numpy arrays as tensors on `device`."""
    import numpy as np
    import torch
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, device) for v in x)
    return x


class CohortChannel:
    """Rank 0's commands to the other ranks of the world, over a gloo
    group of their own with `timeout_s` (built on every rank: collective).
    The leader's `call` runs one collective device call; every such call
    of the leader holds one lock, so the commands and the collectives
    keep one order across the batcher's thread and the REPL's."""

    def __init__(self, timeout_s: float = IDLE_TIMEOUT_S):
        import torch.distributed as dist
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.group = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))
        self._lock = threading.Lock()

    @property
    def leads(self) -> bool:
        return self.rank == 0

    def _send(self, op: str, payload: Any) -> None:
        import torch.distributed as dist
        dist.broadcast_object_list([(op, payload)], src=0, group=self.group)

    def receive(self) -> Tuple[str, Any]:
        """A follower's wait for the next command -> (op, payload)."""
        import torch.distributed as dist
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def call(self, op: str, payload: Any, fn: Callable[[], Any]) -> Any:
        """The leader's collective call: `payload` (host arrays) to the
        followers as command `op`, then `fn()`, which they join."""
        with self._lock:
            self._send(op, to_host(payload))
            return fn()

    def stop(self, code: int) -> None:
        """The leader's last command; every rank then meets at a barrier
        of the group, so no follower misses it when the process group
        goes down."""
        import torch.distributed as dist
        with self._lock:
            self._send(STOP, int(code))
            dist.barrier(group=self.group)

    def finish(self) -> None:
        """A follower's side of `stop`'s barrier."""
        import torch.distributed as dist
        dist.barrier(group=self.group)


def follow(channel: CohortChannel, model) -> int:
    """A follower's loop over a predict-side model (`Code2VecModel` on
    the cohort's mesh): the commands of rank 0 until stop -> its exit
    code."""
    from code2vec_tpu_torch.attacks.gradient_attack import (
        ATTACK_OPS, make_batched_attack_steps)
    steps = []
    while True:
        op, payload = channel.receive()
        if op == STOP:
            channel.finish()
            return int(payload)
        if op in ATTACK_OPS:
            if not steps:
                steps.extend(make_batched_attack_steps(
                    model.dims, compute_dtype=model.compute_dtype,
                    use_kernel=model.use_kernel, mesh=model.mesh))
            fn = steps[ATTACK_OPS.index(op)]
            fn(model.params, *to_device(payload, model.device))
        elif op == PREDICT:
            model.predict_padded(payload)
        else:
            raise RuntimeError(f"cohort: unknown command {op!r} from rank 0")


def lead(channel: CohortChannel, model, fn: Callable[[], int]) -> int:
    """Rank 0's run of `fn()` (the REPL or the attack over `model`, which
    leads while it runs) -> its exit code, sent to the followers as
    stop on every way out."""
    code = 1
    model.cohort = channel
    try:
        code = fn()
        return code
    except KeyboardInterrupt:
        code = 130
        raise
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
        raise
    finally:
        model.cohort = None
        channel.stop(code)


def run(model, fn: Callable[[], int]) -> int:
    """`fn()` on a predict-side model: alone when its mesh spans one rank,
    else rank 0 leads it and the others follow (collective: every rank
    calls it) -> this rank's exit code."""
    if model.mesh is None or model.mesh.world == 1:
        return fn()
    channel = CohortChannel()
    if channel.leads:
        return lead(channel, model, fn)
    return follow(channel, model)

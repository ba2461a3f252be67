"""Multi-process initialization and cross-process data movement: the
counterpart of `parallel/distributed.py` in the JAX package, over
`torch.distributed`.

The JAX package runs one process per host in one SPMD program. The port
runs one process per rank (a card, or a share of one), joined in a
process group:

    python3 -m code2vec_tpu_torch ... --dist_coordinator <host0>:<port> \\
        --dist_num_processes <N> --dist_process_id <i> --mesh_data <N>

`maybe_initialize` joins the group over a TCP store at the coordinator
(`env://` when only the environment says the process is one of a job),
retried through `resilience/retry.transient_distributed` with the
`dist/init` failpoint fired inside each attempt.

The backend rule is one function, `choose_backend`:
- `nccl` when every rank of the host has a card of its own (local rank
  r -> `cuda:r`);
- `gloo` on the CPU, and when ranks share a card (all on `cuda:0` of a
  one-card machine: NCCL refuses two ranks on one device). Gloo then
  moves the CUDA tensors through the host.
An NCCL failure raises; it is never retried on gloo. NCCL beyond one
rank has not been run: the card's machine has one card.

`allreduce_sum_hosts` sums a host vector in float64 (exact for integer
counts up to 2^53; torch's gloo and nccl reduce float64, so the JAX
package's 2^24 split is not needed); `fetch_global` all-gathers a tensor
in rank order; `all_reduce_sum_` and `all_gather_rows` are the
training step's collectives (training/steps.py, sparse_steps.py).
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

# environment markers of "this process is one worker of a multi-host
# job" (the JAX package's, as they are)
_MULTIHOST_ENV_MARKERS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "MEGASCALE_COORDINATOR_ADDRESS",
)


def _looks_multihost() -> bool:
    # CODE2VEC_DIST_DISABLE=1 is the escape hatch for a process launched
    # inside an allocation that looks multi-task but is not one job: the
    # rendezvous would otherwise wait forever for peers that never come
    if os.environ.get("CODE2VEC_DIST_DISABLE", "").lower() in (
            "1", "true", "yes"):
        return False
    if any(os.environ.get(k) for k in _MULTIHOST_ENV_MARKERS):
        return True
    hostnames = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    if len([h for h in hostnames.split(",") if h.strip()]) > 1:
        return True
    # Slurm: SLURM_NTASKS > 1 alone is too weak a signal (a single-task
    # step inside a multi-task allocation inherits it); require the
    # per-step variables too
    ntasks = int(os.environ.get("SLURM_STEP_NUM_TASKS")
                 or os.environ.get("SLURM_NTASKS") or 1)
    return ntasks > 1 and "SLURM_PROCID" in os.environ \
        and "SLURM_STEP_NODELIST" in os.environ


# the joined group: its backend and this rank's device (None before)
_state = {"backend": None, "device": None}


def choose_backend(device_type: str, local_rank: int, local_world: int,
                   device_count: int) -> Tuple[str, torch.device, str]:
    """The backend rule -> (backend, this rank's device, the reason).
    `device_type` is "cuda" or "cpu"; `local_world` ranks run on this
    host, which has `device_count` cards."""
    if device_type == "cpu":
        return "gloo", torch.device("cpu"), "ranks on the CPU"
    if device_count < 1:
        raise RuntimeError("CUDA is not available; pass --backend cpu to "
                           "run on the CPU")
    if local_world <= device_count:
        return ("nccl", torch.device("cuda", local_rank),
                f"{local_world} rank(s) on this host, {device_count} "
                "card(s): one card a rank")
    return ("gloo", torch.device("cuda", local_rank % device_count),
            f"{local_world} ranks share {device_count} card(s) (NCCL "
            "refuses two ranks on one device)")


def backend() -> Optional[str]:
    """The joined group's backend ("nccl" / "gloo"), None before."""
    return _state["backend"]


def rank_device() -> Optional[torch.device]:
    """This rank's device as the backend rule chose it, None before."""
    return _state["device"]


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     log: Optional[Callable[[str], None]] = None, *,
                     device_type: str = "cuda",
                     timeout_s: float = 300.0) -> bool:
    """Join the process group when the flags ask for it (or the
    environment says this is one process of a multi-host job). Safe to
    call unconditionally: a single-process run detects nothing and
    returns False. Returns True when the group is (or already was)
    initialized. `device_type` is the run's ("cuda": the card; "cpu")."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    flags = (coordinator_address, num_processes, process_id)
    if any(f is not None for f in flags) and any(f is None for f in flags):
        raise ValueError(
            "--dist_coordinator, --dist_num_processes and "
            "--dist_process_id must be given together (got "
            f"coordinator={coordinator_address!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r})")
    explicit = coordinator_address is not None
    if not (explicit or _looks_multihost()):
        return False
    if explicit:
        rank, world = int(process_id), int(num_processes)
        init_method = f"tcp://{coordinator_address}"
    else:
        rank = int(os.environ.get("RANK", os.environ.get("SLURM_PROCID",
                                                         0)))
        world = int(os.environ.get("WORLD_SIZE", os.environ.get(
            "SLURM_NTASKS", 1)))
        init_method = "env://"
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    name, dev, why = choose_backend(device_type, local_rank, local_world,
                                    count)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if log is not None:
        # the rendezvous blocks until every peer connects: say so first
        log(f"initializing torch.distributed (explicit={explicit}, "
            f"rank {rank}/{world}, backend {name}: {why}, device {dev}) "
            "- blocks until all peers connect")
    from code2vec_tpu_torch.resilience import faults
    from code2vec_tpu_torch.resilience import retry as retry_mod

    def _init() -> None:
        faults.fire("dist/init")
        dist.init_process_group(
            name, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))

    retry_mod.transient_distributed("distributed-init", log=log).call(_init)
    _state.update(backend=name, device=dev)
    if log is not None:
        log(f"torch.distributed initialized: rank {dist.get_rank()}/"
            f"{dist.get_world_size()} over {name} on {dev}")
    return True


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _state.update(backend=None, device=None)


def _world() -> int:
    from code2vec_tpu_torch.parallel.compat import cohort_world
    return cohort_world()[1]


def _comm_device() -> torch.device:
    """Where a host value is staged for a collective: the card under
    nccl, the CPU under gloo."""
    return _state["device"] if _state["backend"] == "nccl" \
        else torch.device("cpu")


def allreduce_sum_hosts(vec: Sequence[float]) -> np.ndarray:
    """The float64 sum of a small host vector over the ranks (identity
    without a group): the evaluation's metric partials. Exact for
    integer counts up to 2^53."""
    vec = np.asarray(vec, np.float64)
    if _world() == 1 and _state["backend"] is None:
        return vec
    import torch.distributed as dist
    t = torch.from_numpy(vec.copy()).to(_comm_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def _alone(group) -> bool:
    """True for a group of one rank (a model axis's shard-replica group at
    data 1), whose sum and gather are the identity: no collective."""
    import torch.distributed as dist
    return group is not None and dist.get_world_size(group=group) == 1


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum of `t` over the ranks of `group` (default the world),
    in its own dtype; every rank ends with the same bits."""
    import torch.distributed as dist
    if not _alone(group):
        dist.all_reduce(t, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `t` (equal shapes) of `group` (default the world)
    concatenated along dim 0 in rank order, on every rank."""
    import torch.distributed as dist
    if _alone(group):
        return t
    out = [torch.empty_like(t)
           for _ in range(dist.get_world_size(group=group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.cat(out, dim=0)


def fetch_global(x: torch.Tensor) -> np.ndarray:
    """A tensor of every rank, concatenated along dim 0 in rank order, as
    numpy on every rank (plain `.cpu().numpy()` without a group): the
    deliberate fetch that ends a host-decoded path."""
    if _state["backend"] is None and _world() == 1:
        return x.detach().cpu().numpy()
    dev = _comm_device()
    return all_gather_rows(x.detach().to(dev)).cpu().numpy()

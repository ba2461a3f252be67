"""The mesh of a multi-process run: the counterpart of `parallel/mesh.py`
in the JAX package.

The JAX package runs one SPMD program over a ('dcn', 'data', 'ctx',
'model') device mesh. The port runs one process per card with
`torch.distributed` (parallel/distributed.py), so its mesh is a record:
the four axis sizes, this process's rank, the world and its device. The
batch rides ('dcn', 'data'), as in the JAX package; every rank holds
whole tables (parallel/sharding.py).

Only the data axis is ported: `model`, `ctx` or `dcn` above 1 raises
`ValueError` (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

DCN_AXIS = "dcn"
DATA_AXIS = "data"
CONTEXT_AXIS = "ctx"
MODEL_AXIS = "model"
AXES = (DCN_AXIS, DATA_AXIS, CONTEXT_AXIS, MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's view of the mesh."""
    dcn: int
    data: int
    ctx: int
    model: int
    rank: int
    world: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, (self.dcn, self.data, self.ctx, self.model)))

    @property
    def batch_shards(self) -> int:
        """Ranks the batch is split over: ('dcn', 'data')."""
        return self.dcn * self.data


def make_mesh(data: int = 0, model: int = 1, context: int = 1,
              dcn: int = 1, *, rank: Optional[int] = None,
              world: Optional[int] = None,
              device: Union[str, torch.device, None] = None) -> Mesh:
    """The ('dcn', 'data', 'ctx', 'model') mesh of this process. `rank`
    and `world` default to the process group's (parallel/compat.
    cohort_world); `data=0` means the whole world. The data axis must
    span the world: one rank a data shard, each with its own device
    (`device`, default the card)."""
    from code2vec_tpu_torch.device import resolve_device
    from code2vec_tpu_torch.parallel.compat import cohort_world

    if rank is None or world is None:
        rank, world = cohort_world()
    model, context, dcn = max(1, model), max(1, context), max(1, dcn)
    for name, size in (("model", model), ("ctx", context), ("dcn", dcn)):
        if size > 1:
            raise ValueError(
                f"mesh axis {name!r} = {size}: code2vec_tpu_torch ports "
                "the data axis only; the context, model and dcn axes "
                "are ROADMAP.md Queue 1 item 5")
    if data <= 0:
        data = world
    if data != world:
        raise ValueError(f"--mesh_data {data}: the data axis needs {data} "
                         f"processes (one rank a data shard), have {world}")
    return Mesh(dcn=1, data=data, ctx=1, model=1, rank=rank, world=world,
                device=resolve_device(device))

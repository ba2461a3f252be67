"""The mesh of a multi-process run: the counterpart of `parallel/mesh.py`
in the JAX package.

The JAX package runs one SPMD program over a ('dcn', 'data', 'ctx',
'model') device mesh. The port runs one process per card with
`torch.distributed` (parallel/distributed.py), so its mesh is a record:
the four axis sizes, this process's rank, the world, its device, its
coordinates on the axes and the process groups of its ctx peers, its
model peers and its shard replicas.

A rank's coordinates are its rank unravelled row-major over (dcn, data,
ctx, model), as the JAX mesh lays out `jax.devices()` by a reshape. The
batch rides ('dcn', 'data') jointly: a rank's batch shard is
`dcn_index * data + data_index`, and the ranks of one ctx group (the
same dcn, data and model index) read the same rows, each keeping its
`C / ctx` contexts (parallel/sharding.py).

The model axis row-shards the three vocab tables: model index i of m
holds rows [i * V/m, (i + 1) * V/m) of every table (V padded to a
multiple of m, `ModelDims.vocab_pad_multiple`). Two more groups of
ranks matter then:
- the model group: the m ranks of the same (dcn, data, ctx)
  coordinates, adjacent ranks; they read the same rows and contexts and
  assemble each gathered row and each softmax over their windows
  (parallel/collectives.py's model pair);
- the shard-replica group: the ranks of the same model index, which
  hold the same window (their data, dcn and ctx peers); every gradient
  sums over it, never over the world (a model peer's gradient of a
  replicated leaf is the same gradient, not a share of it).

The JAX package builds a dcn axis with
`mesh_utils.create_hybrid_device_mesh` so each slice's devices sit
together on the axis, and falls back to a plain reshape where devices
carry no slice topology. The port needs neither: one card a process, so
the dcn axis is a second factor of the batch shards and adds no
collective of its own (the gradient sum runs over the shard-replica
group, the whole world at model 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

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
    # the process group of this rank's ctx peers (None at ctx = 1, or
    # when no process group is up: a ctx collective then raises)
    ctx_group: Any = dataclasses.field(default=None, compare=False,
                                       repr=False)
    # at model above 1, the groups of this rank's model peers and of its
    # shard replicas (None otherwise, or without a process group: a
    # model collective then raises)
    model_group: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)
    replica_group: Any = dataclasses.field(default=None, compare=False,
                                           repr=False)

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, (self.dcn, self.data, self.ctx, self.model)))

    @property
    def coords(self) -> Tuple[int, int, int, int]:
        """(dcn, data, ctx, model) index of this rank: its rank
        unravelled row-major over the axes."""
        r = self.rank
        model_i, r = r % self.model, r // self.model
        ctx_i, r = r % self.ctx, r // self.ctx
        data_i, dcn_i = r % self.data, r // self.data
        return dcn_i, data_i, ctx_i, model_i

    @property
    def ctx_index(self) -> int:
        return self.coords[2]

    @property
    def model_index(self) -> int:
        return self.coords[3]


    @property
    def batch_shards(self) -> int:
        """Shards the batch is split over: ('dcn', 'data')."""
        return self.dcn * self.data

    @property
    def batch_shard(self) -> int:
        """This rank's shard of the batch: dcn_index * data + data_index
        (the same for every rank of a ctx group)."""
        dcn_i, data_i, _c, _m = self.coords
        return dcn_i * self.data + data_i

    def ctx_ranks(self) -> Tuple[int, ...]:
        """The global ranks of this rank's ctx group, in ctx order."""
        base = self.batch_shard * self.ctx * self.model + self.coords[3]
        return tuple(base + c * self.model for c in range(self.ctx))

    def model_ranks(self) -> Tuple[int, ...]:
        """The global ranks of this rank's model group, in model order
        (adjacent ranks)."""
        base = self.rank - self.model_index
        return tuple(range(base, base + self.model))


def row_sharded(mesh: Optional["Mesh"]) -> bool:
    """True under a mesh whose model axis row-shards the tables (model
    above 1); False without a mesh."""
    return mesh is not None and mesh.model > 1


def _groups(dcn: int, data: int, ctx: int, model: int, rank: int) -> dict:
    """This rank's process groups {"ctx_group", "model_group",
    "replica_group"}: every group is built on every rank in the same
    order (`dist.new_group` is collective over the world); a group is
    None where its axis is 1 or without a process group."""
    import torch.distributed as dist
    mine = {"ctx_group": None, "model_group": None, "replica_group": None}
    if not (dist.is_available() and dist.is_initialized()):
        return mine

    def build(key, rank_lists):
        for ranks in rank_lists:
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[key] = group

    if ctx > 1:
        build("ctx_group", [[(shard * ctx + c) * model + m
                             for c in range(ctx)]
                            for shard in range(dcn * data)
                            for m in range(model)])
    if model > 1:
        cells = dcn * data * ctx
        build("model_group", [[cell * model + m for m in range(model)]
                              for cell in range(cells)])
        build("replica_group", [[cell * model + m for cell in range(cells)]
                                for m in range(model)])
    return mine


def make_mesh(data: int = 0, model: int = 1, context: int = 1,
              dcn: int = 1, *, rank: Optional[int] = None,
              world: Optional[int] = None,
              device: Union[str, torch.device, None] = None) -> Mesh:
    """The ('dcn', 'data', 'ctx', 'model') mesh of this process. `rank`
    and `world` default to the process group's (parallel/compat.
    cohort_world); `data=0` means `world // (dcn * model * ctx)`, as the
    JAX package's does with its devices. The mesh must span the world:
    one rank a device (`device`, default the card). Under a process
    group with ctx or model above 1 their groups are built here, on
    every rank in the same order."""
    from code2vec_tpu_torch.device import resolve_device
    from code2vec_tpu_torch.parallel.compat import cohort_world

    if rank is None or world is None:
        rank, world = cohort_world()
    model, context, dcn = max(1, model), max(1, context), max(1, dcn)
    if data <= 0:
        if world % (dcn * model * context) != 0:
            raise ValueError(
                f"{world} devices not divisible by dcn*model*ctx="
                f"{dcn * model * context}")
        data = world // (dcn * model * context)
    need = dcn * data * model * context
    if need != world:
        raise ValueError(
            f"--mesh_data {data}: the data axis needs {need} processes "
            f"(mesh {dcn}x{data}x{context}x{model} needs {need} devices, "
            f"one rank a device), have {world}")
    return Mesh(dcn=dcn, data=data, ctx=context, model=model, rank=rank,
                world=world, device=resolve_device(device),
                **_groups(dcn, data, context, model, rank))

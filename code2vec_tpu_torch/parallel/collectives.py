"""The collectives of the context and model axes, differentiable: the
counterparts of `jax.lax.ppermute`, `all_gather` and `psum` over a
mesh's ctx group (parallel/mesh.Mesh.ctx_group), and the pair of the
model group (Mesh.model_group) that XLA's SPMD partitioner inserts
around the JAX package's row-sharded tables.

Each is a `torch.autograd.Function` whose backward is its transpose, the
rule the JAX package's autodiff follows:

- `ppermute(x, mesh)` sends x to ctx index + 1 and returns what index - 1
  sent; its backward is the rotation the other way;
- `all_gather(x, dim, mesh)` concatenates the group's x along `dim` in
  ctx order; its backward is a reduce-scatter sum, written as an
  all-reduce and this rank's slice (gloo has no reduce-scatter, and the
  same code then runs on gloo and nccl);
- `all_sum(x, mesh)` sums x over the group; its backward sums the
  cotangents over the group.

Why the transposes give one device's gradients: under a ctx axis of s
each rank of a group computes the loss of its batch shard over the
global weight sum, which counts each row s times (the world's sum), so a
value replicated over the group gets 1/s of its cotangent on each peer,
and each transpose above sums those shares back into the one cotangent
of the shard that owns the value. The world's gradient sum
(training/sparse_steps.reduce_step_grads) then adds the shards.

The model group follows another convention. Its m ranks read the same
rows and contexts and hold different rows of each table, so every
value downstream of a gathered row is replicated over the group and its
loss is the same loss, not a share of it. Its pair is Megatron's:
- `copy_to_model(x, mesh)`: the identity forward (x replicated enters a
  sharded computation: the code vector before the logits of the rank's
  columns) and an all-sum backward (each rank's cotangent is the part
  of its columns);
- `reduce_from_model(x, mesh)`: an all-sum forward (each rank's part of
  a gathered row or of a softmax's sum) and the identity backward (the
  replicated cotangent goes to each rank's part as it is).
`all_sum` is not used over the model group: its backward sums again,
which would count a replicated cotangent m times. `model_sum`,
`model_max` and `model_gather` (no autograd) take the optimizer's sums
across a table's rows, the softmax's global max and the top-k merge's
candidates in model order. Every gradient is then summed over
the shard-replica group only (`replica_group`: the ranks of one model
index, which read other rows or other contexts), the world at model 1:
each gradient of a replicated leaf is computed once in each model
group, and each table shard's is its window's. `traffic` counts the
bytes each model collective moves (a rank's tensor), which
`chip_smoke.py` reads a step.

A two-rank ring sends to and receives from the same peer, so the sends
and receives of `ppermute` are posted together (`batch_isend_irecv`).
Under gloo a CUDA tensor is staged through the host (`_staged`), as the
other collectives of parallel/ do; under nccl it stays on the card. A
mesh with ctx or model above 1 but no group raises: no step falls back
to the one-process step.
"""

from __future__ import annotations

import torch


def _group(mesh):
    if mesh.ctx_group is None:
        raise RuntimeError(
            f"mesh ctx = {mesh.ctx} has no process group of ctx peers "
            "(parallel/mesh.make_mesh builds it when torch.distributed is "
            "initialized)")
    return mesh.ctx_group


def _model_group(mesh):
    if mesh.model_group is None:
        raise RuntimeError(
            f"mesh model = {mesh.model} has no process group of model peers "
            "(parallel/mesh.make_mesh builds it when torch.distributed is "
            "initialized)")
    return mesh.model_group


def replica_group(mesh):
    """The group every gradient and the loss's weight sum are summed
    over: the shard-replica group at model above 1 (raises without it),
    None (the world) at model 1."""
    if mesh.model == 1:
        return None
    if mesh.replica_group is None:
        raise RuntimeError(
            f"mesh model = {mesh.model} has no process group of shard "
            "replicas (parallel/mesh.make_mesh builds it when "
            "torch.distributed is initialized)")
    return mesh.replica_group


# bytes a rank's tensors of the model collectives (reset by the caller)
traffic = {"sum": 0, "max": 0, "gather": 0}


def _staged(t: torch.Tensor) -> torch.Tensor:
    """`t`, contiguous, where the group's backend can move it: the host
    under gloo for a CUDA tensor, else where it is."""
    import torch.distributed as dist
    if t.is_cuda and dist.get_backend() == "gloo":
        return t.detach().to("cpu").contiguous()
    return t.detach().contiguous()


def gather_along(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The group's `x` concatenated along `dim` in ctx order (no
    autograd): the forward of `all_gather`, and the gather of masks and
    ids."""
    import torch.distributed as dist
    group = _group(mesh)
    xs = _staged(x)
    parts = [torch.empty_like(xs) for _ in range(mesh.ctx)]
    dist.all_gather(parts, xs, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _sum(x: torch.Tensor, mesh) -> torch.Tensor:
    import torch.distributed as dist
    xs = _staged(x)
    if xs.data_ptr() == x.data_ptr():
        xs = xs.clone()
    dist.all_reduce(xs, group=_group(mesh))
    return xs.to(x.device)


def _rotate(x: torch.Tensor, mesh, shift: int) -> torch.Tensor:
    """What ctx index - shift sent; this rank's x goes to index + shift."""
    import torch.distributed as dist
    ranks = mesh.ctx_ranks()
    i, s = mesh.ctx_index, mesh.ctx
    group = _group(mesh)
    xs = _staged(x)
    out = torch.empty_like(xs)
    ops = [dist.P2POp(dist.isend, xs, ranks[(i + shift) % s], group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % s], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, mesh):
        fctx.mesh = mesh
        return _rotate(x, mesh, 1)

    @staticmethod
    def backward(fctx, g):
        return _rotate(g, fctx.mesh, -1), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, mesh):
        fctx.mesh, fctx.dim, fctx.width = mesh, dim, x.shape[dim]
        return gather_along(x, dim, mesh)

    @staticmethod
    def backward(fctx, g):
        lo = fctx.mesh.ctx_index * fctx.width
        g = _sum(g, fctx.mesh).narrow(fctx.dim, lo, fctx.width)
        return g.contiguous(), None, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, mesh):
        fctx.mesh = mesh
        return _sum(x, mesh)

    @staticmethod
    def backward(fctx, g):
        return _sum(g, fctx.mesh), None


def ppermute(x: torch.Tensor, mesh) -> torch.Tensor:
    """`jax.lax.ppermute(x, 'ctx', [(i, (i + 1) % s)])`: x to ctx index +
    1, the result from index - 1 (differentiable)."""
    return _PPermute.apply(x, mesh)


def all_gather(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The group's x along `dim` in ctx order (differentiable: the
    backward is a reduce-scatter sum)."""
    return _AllGather.apply(x, dim, mesh)


def all_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """`jax.lax.psum(x, 'ctx')` (differentiable: the backward sums the
    cotangents)."""
    return _AllSum.apply(x, mesh)


def _model_reduce(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """x summed (or maxed) over the model group (no autograd)."""
    import torch.distributed as dist
    group = _model_group(mesh)
    xs = _staged(x)
    if xs.data_ptr() == x.data_ptr():
        xs = xs.clone()
    traffic[op] += xs.numel() * xs.element_size()
    dist.all_reduce(xs, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    return xs.to(x.device)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, mesh):
        fctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return _model_reduce(g, fctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, mesh):
        return _model_reduce(x, mesh)

    @staticmethod
    def backward(fctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """A replicated value entering the rank's part of a model-sharded
    computation: the identity (differentiable: the backward sums the
    parts' cotangents over the model group)."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of the model group's parts (differentiable: the backward
    is the identity, the replicated cotangent going to each part)."""
    return _ReduceFromModel.apply(x, mesh)


def model_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over the model group (no autograd): the optimizer's
    reductions across a table's rows."""
    return _model_reduce(x.detach(), mesh)


def model_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise max of x over the model group (no autograd)."""
    return _model_reduce(x.detach(), mesh, "max")


def model_gather(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The model group's x concatenated along `dim` in model order (no
    autograd): the top-k merge's candidates and the whole-table save."""
    import torch.distributed as dist
    group = _model_group(mesh)
    xs = _staged(x)
    traffic["gather"] += xs.numel() * xs.element_size()
    parts = [torch.empty_like(xs) for _ in range(mesh.model)]
    dist.all_gather(parts, xs, group=group)
    return torch.cat(parts, dim=dim).to(x.device)

"""Measurement-only prefixes of the train step: the counterpart of
training/phase_probes.py of the JAX package.

obs/phases.PhaseProfiler dispatches these, each its own synced call, on
a sampled step. The chain is CUMULATIVE (probe k re-runs probes 1..k-1
plus one more stage); the profiler differences consecutive synced times
into per-phase device ms (obs/phases.derive_chain_phases).

Probe outputs are DISCARDED: the sampled step's state update is the
fused step. A probe reads the params and the optimizer state and never
writes them (the port's steps update both in place, so a probe that
wrote would change the run's bits; the tests and chip_smoke.py [18]
hold a profiled run to the same bits as an unprofiled one). The prefixes
are built from the step's own pieces, so a probe cannot measure other
math than the step runs:
- dense: `steps.make_train_loss_fn` (the function the fused step
  differentiates) and `steps.dense_loss_and_grads`; the isolated apply
  probe runs the optimizer's `update` on a clone of its state and adds
  the updates into scratch tensors;
- sparse: `sparse_steps.prepare_step_inputs`, `make_gathered_loss` and
  `loss_and_grads`, the helpers `sparse_train_step` calls.
The concat/dense prefix stops after the TRANSFORM product
(tanh(contexts @ T)), the last point before the attention pool.

int8 tables: the chain stops at the forward (the {q, s} gradients need
the fused step's carrier plumbing), so backward + apply report as one
`backward_apply` remainder.

`make_vm_probes` is the VarMisuse head's kit (training/vm_steps.py):
gather, forward, backward, and the apply as the fused remainder; under a
mesh of more than one rank the dense kit's all-reduce and isolated apply
probes too, its gathers over the rank's windows under a model axis.

Under a mesh of more than one rank (data, ctx or dcn) the dense kit
(float tables) also times the gradient all-reduce alone (`_make_allreduce`: a
sum over the world of clones of the backward probe's gradients,
through parallel/distributed.all_reduce_sum_) with the isolated apply
beside it, so obs/phases.py derives `allreduce_exposed`; the forward's
loss denominator is the global one, as in the step. At a world of one
there is nothing to reduce and the kit is the one-device kit, as the
JAX package's is at a mesh without batch sharding. Under a model axis
the gathers read the rank's windows (models/encoder.take_rows), the
sparse kit's preliminaries take the mesh, and the all-reduce runs over
the shard-replica group, as the step's does.
"""

from __future__ import annotations

import torch

from code2vec_tpu_torch.models.encoder import (ModelDims, apply_dropout,
                                               gather_contexts, take_rows)
from code2vec_tpu_torch.obs.phases import ProbeKit
from code2vec_tpu_torch.parallel.mesh import row_sharded
from code2vec_tpu_torch.training.checkpoint import map_state

__all__ = ["make_code2vec_probes", "make_vm_probes"]


def _transformed(contexts: torch.Tensor, transform: torch.Tensor,
                 keep, keep_rate: float) -> torch.Tensor:
    """Dropout (the step's keep mask) then tanh(contexts @ T): the
    attention pool's first stage."""
    if keep_rate < 1.0:
        contexts = apply_dropout(contexts, keep, keep_rate)
    return torch.tanh(contexts @ transform.to(contexts.dtype))


def _make_dense_apply(optimizer):
    """The optimizer apply over the backward probe's gradients, timed
    alone: `optimizer.update` on a clone of the state (the port's
    optimizer writes its state in place) and `p + u` into new tensors,
    so neither the params nor the state change."""

    @torch.no_grad()
    def apply_fn(params, opt_state, _batch, _draws, chain_out):
        _loss, grads, view = chain_out
        scratch = map_state(torch.clone, opt_state)
        updates = optimizer.update(grads, scratch, view)
        return [(view[k] + u).to(view[k].dtype)
                for k, u in updates.items()]

    return apply_fn


def _make_allreduce(mesh):
    """The gradient all-reduce timed alone: the backward probe's
    gradients cloned (the probe's outputs stay as they were) and each
    summed over the ranks in its own dtype, the step's collective
    (training/sparse_steps.reduce_step_grads) on a grads-shaped tree.
    The sums, world x grads where the ranks' gradients agree, are
    discarded; only the communication is being timed. None at a world
    of one (nothing to reduce); a ctx axis reduces over the world too,
    whatever its batch shards."""
    if mesh is None or mesh.world <= 1:
        return None
    from code2vec_tpu_torch.parallel.collectives import replica_group
    from code2vec_tpu_torch.parallel.distributed import all_reduce_sum_
    group = replica_group(mesh)

    @torch.no_grad()
    def allreduce_fn(chain_out):
        _loss, grads, _view = chain_out
        return {k: all_reduce_sum_(g.clone(
            memory_format=torch.contiguous_format), group)
            for k, g in grads.items()}

    return allreduce_fn


def make_code2vec_probes(dims: ModelDims, optimizer, *,
                         use_sampled_softmax: bool = False,
                         num_sampled: int = 4096,
                         compute_dtype=torch.float32,
                         use_kernel: bool = True,
                         sparse_updates: bool = False,
                         isolated_apply: bool = False,
                         mesh=None) -> ProbeKit:
    """The code2vec head's probe kit, mirroring `make_train_step`'s
    choice: the sparse chain when `sparse_updates` (gathered-row
    granularity: its backward emits no dense carrier, as in the step),
    the dense chain otherwise. `use_kernel` is the step's pool choice.

    The train loop's kit times the apply as the remainder of the fused
    step, as the JAX package's single-device kit does. Under a `mesh`
    of more than one rank the dense kit (float tables) adds the
    all-reduce and the optimizer apply probes and publishes the real
    residual instead (the JAX mesh kit's shape). `isolated_apply`
    (dense float tables) adds the apply probe on one rank too, for a
    reading of how well the remainder stands for the apply."""
    if sparse_updates:
        return _sparse_kit(dims, use_sampled_softmax=use_sampled_softmax,
                           num_sampled=num_sampled,
                           compute_dtype=compute_dtype,
                           use_kernel=use_kernel,
                           mesh=mesh if row_sharded(mesh) else None)
    return _dense_kit(dims, optimizer,
                      use_sampled_softmax=use_sampled_softmax,
                      num_sampled=num_sampled, compute_dtype=compute_dtype,
                      use_kernel=use_kernel, isolated_apply=isolated_apply,
                      mesh=mesh)


def _dense_kit(dims, optimizer, *, use_sampled_softmax, num_sampled,
               compute_dtype, use_kernel, isolated_apply,
               mesh=None) -> ProbeKit:
    from code2vec_tpu_torch.training.steps import (dense_loss_and_grads,
                                                   make_train_loss_fn)
    loss_fn = make_train_loss_fn(
        dims, use_sampled_softmax=use_sampled_softmax,
        num_sampled=num_sampled, compute_dtype=compute_dtype,
        use_kernel=use_kernel, mesh=mesh)

    @torch.no_grad()
    def embed_gather(params, batch, _draws):
        _l, src, pth, dst, _m, _w = batch
        return (take_rows(params, "token_emb", src, mesh),
                take_rows(params, "path_emb", pth, mesh),
                take_rows(params, "token_emb", dst, mesh))

    chain = [("embed_gather", embed_gather)]

    if dims.encoder_type == "bag":
        @torch.no_grad()
        def concat_dense(params, batch, draws):
            _l, src, pth, dst, _m, _w = batch
            contexts = gather_contexts(params, src, pth, dst, compute_dtype,
                                       mesh)
            return _transformed(contexts, params["transform"], draws.keep,
                                dims.dropout_keep_rate)

        chain.append(("concat_dense", concat_dense))
    # transformer encoder: no pre-attention seam to stop at; the
    # concat/dense stage folds into forward_pool

    chain.append(("forward_pool", torch.no_grad()(loss_fn)))

    if dims.tables_dtype == "int8":
        # no backward probe: backward + apply report as one remainder
        return ProbeKit(chain, remainder_name="backward_apply")

    chain.append(("backward", lambda p, b, d: dense_loss_and_grads(
        p, b, d, loss_fn)))
    allreduce_fn = _make_allreduce(mesh)
    if allreduce_fn is None and not isolated_apply:
        # table_apply is the fused remainder: exact on one device (fused
        # = chain + apply, nothing else runs), and the sample costs the
        # chain alone
        return ProbeKit(chain)
    # the isolated apply is what lets the exposed-comm derivation
    # separate the all-reduce from the apply (obs/phases.py): every
    # phase is measured, table_apply stays the MEASURED apply, and the
    # residual (the in-step communication the split cannot see) is
    # published instead of folded into table_apply
    return ProbeKit(chain, apply_fn=_make_dense_apply(optimizer),
                    allreduce_fn=allreduce_fn, derive_remainder=False)


def _sparse_kit(dims, *, use_sampled_softmax, num_sampled, compute_dtype,
                use_kernel, mesh=None) -> ProbeKit:
    """The sparse (--sparse_embeddings) chain over sparse_steps' own
    helpers. No apply probe: the dedup / segment-sum / live-row apply
    reports as the fused remainder (`table_apply = fused - chain`)."""
    from code2vec_tpu_torch.training.sparse_steps import (
        SparseStepConfig, loss_and_grads, make_gathered_loss,
        prepare_step_inputs)
    S = min(num_sampled, dims.target_vocab_size)
    # the forward and backward read no learning rate
    cfg = SparseStepConfig(learning_rate=0.0,
                           use_sampled_softmax=use_sampled_softmax,
                           num_sampled=S, compute_dtype=compute_dtype)

    def prep(params, batch, draws):
        return prepare_step_inputs(
            params, batch, draws, use_sampled_softmax=use_sampled_softmax,
            num_sampled=S, target_vocab=dims.target_vocab_size, mesh=mesh)

    @torch.no_grad()
    def embed_gather(params, batch, draws):
        _dense, gathered, _ctx = prep(params, batch, draws)
        return gathered

    @torch.no_grad()
    def concat_dense(params, batch, draws):
        dense, gathered, ctx = prep(params, batch, draws)
        contexts = torch.cat(
            [gathered["src_e"], gathered["pth_e"], gathered["dst_e"]],
            dim=-1).to(compute_dtype)
        return _transformed(contexts, dense["transform"], ctx["keep"],
                            dims.dropout_keep_rate)

    @torch.no_grad()
    def forward_pool(params, batch, draws):
        dense, gathered, ctx = prep(params, batch, draws)
        loss_fn = make_gathered_loss(
            dims, ctx, use_sampled_softmax=use_sampled_softmax,
            compute_dtype=compute_dtype, use_kernel=use_kernel)
        return loss_fn(dense, gathered)

    def backward(params, batch, draws):
        dense, gathered, ctx = prep(params, batch, draws)
        return loss_and_grads(dims, cfg, dense, gathered, ctx,
                              use_kernel=use_kernel)

    return ProbeKit([("embed_gather", embed_gather),
                     ("concat_dense", concat_dense),
                     ("forward_pool", forward_pool),
                     ("backward", backward)])


def make_vm_probes(dims: ModelDims, *, compute_dtype=torch.float32,
                   use_kernel: bool = True, optimizer=None,
                   mesh=None) -> ProbeKit:
    """The VarMisuse head's kit (vm_steps.make_vm_train_step's shape):
    embed_gather (the four gathers: src, pth, dst and the candidates),
    forward_pool (the vm loss), backward (its gradients), and
    table_apply as the fused remainder on both the dense and the
    sparse-row apply (the remainder covers whichever apply the fused
    step runs, so the one-rank kit needs neither the optimizer nor the
    sparse flag). The vm loss gathers inside the differentiated
    function, so there is no concat/dense seam to stop at. The head
    refuses int8 tables (config.py), so the chain always reaches
    backward. Under a `mesh` (the dense step: the sparse-row step
    refuses one) the loss is the step's, over the global weight sum and
    the rank's windows; above one rank, with the dense `optimizer`, the
    kit adds the all-reduce and the isolated apply, as the code2vec
    dense kit does."""
    from code2vec_tpu_torch.training.steps import dense_loss_and_grads
    from code2vec_tpu_torch.training.vm_steps import make_vm_loss_fn
    loss_fn = make_vm_loss_fn(dims, compute_dtype=compute_dtype,
                              use_kernel=use_kernel, mesh=mesh)

    @torch.no_grad()
    def embed_gather(params, batch, _draws):
        _l, src, pth, dst, _m, cand, _cm, _w = batch
        return (take_rows(params, "token_emb", src, mesh),
                take_rows(params, "path_emb", pth, mesh),
                take_rows(params, "token_emb", dst, mesh),
                take_rows(params, "token_emb", cand, mesh))

    chain = [
        ("embed_gather", embed_gather),
        ("forward_pool", torch.no_grad()(loss_fn)),
        ("backward", lambda p, b, d: dense_loss_and_grads(p, b, d, loss_fn))]
    allreduce_fn = _make_allreduce(mesh)
    if allreduce_fn is None or optimizer is None:
        return ProbeKit(chain)
    return ProbeKit(chain, apply_fn=_make_dense_apply(optimizer),
                    allreduce_fn=allreduce_fn, derive_remainder=False)

"""The port's ring attention (ops/ring_attention.py) against the JAX
package's (`code2vec_tpu.ops.ring_attention.ring_attention` on a
(data, ctx) mesh of the virtual CPU devices), forward and the gradients
of q, k and v of `sum(out ** 2)`, on the same numpy inputs.

The port's ring runs in gloo workers spawned by this file's fixtures
(tests/test_torch_multiprocess.py's `_spawn`: one spawn a world size):
each rank holds the [B/shards, H, C/s, hd] block of its batch shard and
ctx index, and the parent puts the blocks back together.

Layouts: (data 1, ctx 2) and (data 1, ctx 4) against the JAX ring at
ctx 2 and 4, float32, the output and the q, k, v gradients within `atol
1e-5` (the JAX tests' output bound against its dense oracle); a shard whose keys are all padding; the (dcn 2,
data 1, ctx 2) layout, the counterpart of the JAX package's
`test_ring_on_combined_dcn_ctx_mesh`; and bf16 q, k, v, where both
rings accumulate in float32 and round the output once to bf16, so they
may differ by the rounding of their float32 sums: the bound is two bf16
ulps of the largest output magnitude (2 * 2^-7 * max|out|), the
gradients' two ulps of the largest gradient.
"""

from __future__ import annotations


import numpy as np
import pytest

B, H, C, HD = 4, 2, 8, 4
# world -> [(layout name, mesh axes)]
LAYOUTS = {2: [("ctx2", dict(data=1, context=2, dcn=1))],
           4: [("ctx4", dict(data=1, context=4, dcn=1)),
               ("dcn2_ctx2", dict(data=1, context=2, dcn=2))]}
BF16_ULP = 2.0 ** -7


def _inputs(seed=0, padded_shard=False):
    """q, k, v [B, H, C, hd] float32 and the additive key mask [B, C] (the
    JAX test's: the last two keys padded, or the whole second half)."""
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=(B, H, C, HD)).astype(np.float32)
               for _ in range(3))
    mask = np.zeros((B, C), np.float32)
    if padded_shard:
        mask[:, C // 2:] = -1e30
    else:
        mask[:, -2:] = -1e30
    return q, k, v, mask


CASES = {"f32": dict(seed=0), "padded": dict(seed=1, padded_shard=True),
         "bf16": dict(seed=2)}


# ---- the workers (run by tests/test_torch_multiprocess.py's worker) ----

def _port_ring(mesh, q, k, v, mask, dtype):
    """This rank's block of the ring's output and of the gradients of
    sum(out ** 2), as float32 numpy."""
    import torch

    from code2vec_tpu_torch.ops.ring_attention import ring_attention
    from code2vec_tpu_torch.parallel.sharding import batch_rows, context_cols
    rows = slice(*batch_rows(mesh, B // mesh.batch_shards))
    cols = slice(*context_cols(mesh, C))
    leaves = [torch.from_numpy(np.ascontiguousarray(a[rows, :, cols]))
              .to(dtype).requires_grad_(True) for a in (q, k, v)]
    m = torch.from_numpy(np.ascontiguousarray(mask[rows, cols]))
    out = ring_attention(*leaves, m, mesh)
    (out.float() ** 2).sum().backward()
    return [t.detach().float().numpy() for t in [out] + [x.grad
                                                         for x in leaves]]


def ring_worker(rank, world, out_dir, deadline):
    """Every layout of `world` and every case, on this rank."""
    import torch

    from code2vec_tpu_torch.parallel.mesh import make_mesh
    out = {}
    for name, axes in LAYOUTS[world]:
        mesh = make_mesh(axes["data"], context=axes["context"],
                         dcn=axes["dcn"], device="cpu")
        out[name] = {"coords": (mesh.batch_shard, mesh.batch_shards,
                                mesh.ctx_index, mesh.ctx)}
        for case, kw in CASES.items():
            deadline.beat(f"{name}/{case}")
            dtype = torch.bfloat16 if case == "bf16" else torch.float32
            out[name][case] = _port_ring(mesh, *_inputs(**kw), dtype)
    return out


# ---- the parent side ----

def _spawn_ring(world, tmp_path_factory):
    from test_torch_multiprocess import _spawn
    return _spawn(world, str(tmp_path_factory.mktemp(f"ring{world}")),
                  "test_torch_ring_attention:ring_worker")


@pytest.fixture(scope="module")
def ring_ranks(tmp_path_factory):
    return {w: _spawn_ring(w, tmp_path_factory) for w in LAYOUTS}


def _assemble(ranks, name, case):
    """The ranks' blocks put back into [B, H, C, hd] arrays (output, dq,
    dk, dv); each block checked written once."""
    full = [np.full((B, H, C, HD), np.nan, np.float32) for _ in range(4)]
    for r in ranks:
        shard, shards, c, s = r[name]["coords"]
        rows = slice(shard * B // shards, (shard + 1) * B // shards)
        cols = slice(c * C // s, (c + 1) * C // s)
        for f, block in zip(full, r[name][case]):
            assert np.isnan(f[rows, :, cols]).all()
            f[rows, :, cols] = block
    return full


def _jax_ring(case, layout):
    """The JAX ring's output and q, k, v gradients of sum(out ** 2) on
    the layout's JAX mesh, float32 numpy."""
    import jax
    import jax.numpy as jnp

    from code2vec_tpu.ops.ring_attention import ring_attention
    from code2vec_tpu.parallel.mesh import make_mesh
    q, k, v, mask = (jnp.asarray(a) for a in _inputs(**CASES[case]))
    if case == "bf16":
        q, k, v = (t.astype(jnp.bfloat16) for t in (q, k, v))
    mesh = {"ctx2": lambda: make_mesh(4, 1, 2),
            "ctx4": lambda: make_mesh(2, 1, 4),
            "dcn2_ctx2": lambda: make_mesh(1, 2, 2, dcn=2)}[layout]()

    def loss(q, k, v):
        out = ring_attention(q, k, v, mask, mesh)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    # jitted, as the JAX package runs it (eager shard_map is slow); one
    # call a test
    loss_and_grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))
    (_, out), grads = loss_and_grads(q, k, v)
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


def _check(got, want, case):
    names = ("out", "dq", "dk", "dv")
    for name, a, b in zip(names, got, want):
        assert np.isfinite(a).all(), name
        if case == "bf16":
            atol = 2 * BF16_ULP * np.abs(b).max()
        else:
            atol = 1e-5
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("layout", ["ctx2", "ctx4"])
def test_ring_matches_the_jax_ring_forward_and_grad(ring_ranks, layout):
    """ctx 2 and 4, float32: the output and the q, k, v gradients within
    1e-5 of the JAX ring's."""
    world = 2 if layout == "ctx2" else 4
    got = _assemble(ring_ranks[world], layout, "f32")
    _check(got, _jax_ring("f32", layout), "f32")


@pytest.mark.parametrize("layout", ["ctx2", "ctx4"])
def test_ring_handles_a_fully_padded_shard(ring_ranks, layout):
    """Every key of the second half padded: at ctx 2 a whole shard, at
    ctx 4 two; the running max stays finite once a live key is seen."""
    world = 2 if layout == "ctx2" else 4
    got = _assemble(ring_ranks[world], layout, "padded")
    _check(got, _jax_ring("padded", layout), "padded")


def test_ring_on_the_combined_dcn_ctx_layout(ring_ranks):
    """(dcn 2, data 1, ctx 2): the batch over the two dcn shards, a ring
    of two in each; the JAX ring on its (dcn 2, data 1, ctx 2, model 2)
    mesh."""
    got = _assemble(ring_ranks[4], "dcn2_ctx2", "f32")
    _check(got, _jax_ring("f32", "dcn2_ctx2"), "f32")


@pytest.mark.parametrize("layout", ["ctx2", "ctx4"])
def test_ring_in_bf16_matches_the_jax_ring(ring_ranks, layout):
    """bf16 q, k, v: the output stays bf16, within two bf16 ulps of the
    largest output of the JAX ring's (the module docstring)."""
    world = 2 if layout == "ctx2" else 4
    got = _assemble(ring_ranks[world], layout, "bf16")
    _check(got, _jax_ring("bf16", layout), "bf16")


def test_ring_blocks_cover_the_whole_output_once(ring_ranks):
    """Every rank of every layout wrote its own block (no two ranks the
    same coordinates)."""
    for world, layouts in LAYOUTS.items():
        for name, _axes in layouts:
            coords = [r[name]["coords"] for r in ring_ranks[world]]
            assert len(set(coords)) == world
            full = _assemble(ring_ranks[world], name, "f32")
            assert not np.isnan(full[0]).any()

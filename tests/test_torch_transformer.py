"""The port's transformer path-encoder and its dense training step against
the JAX package's (models/transformer_encoder.py, `make_train_step`).

Weights come from JAX `init_params` (encoder_type "transformer") and are
carried over with convert.py; batches are numpy from a seed; the step's
draws (the dropout keep mask from `split(rng)`, the sampled ids) are made
on the JAX side as its step makes them and handed to the port. The JAX
side runs its fused attention kernels (`use_pallas=True`: Pallas in
interpret mode), the port its kernel wrappers on CPU tensors (the plain
versions of kernels 2 and 3); with `use_kernel=False` the port runs the
plain versions on any device, held against the Pallas kernels and
against JAX's XLA path (`use_pallas=False`).

Sizes: E = 16 (D = 48), C = 12, L = 2 layers, H = 2 heads (hd = 24).

Tolerances, each test repeating its own:
- the encoder in float32: code vectors and pool weights within 1e-5
  (two layers of float32 products summed in another order); bf16: code
  within 3e-2 of the largest value (activations rounded to bf16 at every
  product, GELU's tanh in bf16 on the JAX side, in float32 rounded once
  here) and pool weights within 2e-2 (a softmax of those);
- the float32 step: loss within 1e-5 relative; params within 1e-5 of
  their largest value on 99% of the elements and within 2 * lr * steps
  everywhere (Adam divides a gradient by its own magnitude, so an
  element whose gradient is within rounding of 0 can move by up to lr
  either way); optimizer state within 1e-4 of its largest value on 99%
  of the elements and within 1e-3 everywhere (such an element, moved
  ~lr apart in one step, changes the next step's gradients around it;
  and the norm scales and the pool query, which take the gradient of the
  whole network, differ by up to ~4e-5 after 3 steps);
- the bf16 step: loss within 1e-2 relative; params within
  2 * lr * steps + 1 bf16 ulp of the largest value, 95% of the elements
  within the ulp; optimizer moments within 5e-2 of their largest value.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.models import encoder as jenc
from code2vec_tpu.models import transformer_encoder as jxf
from code2vec_tpu.ops import sampled_softmax as jss
from code2vec_tpu.training import optimizers as jopt
from code2vec_tpu.training.steps import make_train_step as j_make_train_step
from code2vec_tpu_torch import convert, tree
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.models import transformer_encoder as txf
from code2vec_tpu_torch.ops.xf_attention import (mha_backward_fused,
                                                 mha_forward_fused)
from code2vec_tpu_torch.training import optimizers as topt
from code2vec_tpu_torch.training.draws import StepDraws
# the port's step updates in place and donates nothing
from code2vec_tpu_torch.training.steps import (dense_loss_and_grads,
                                               make_train_loss_fn)
from code2vec_tpu_torch.training.steps import \
    make_train_step as make_port_train_step

B, C, E, L, H = 6, 12, 16, 2, 2
VT, VP, VY = 50, 40, 30
S = 8
LR = 0.01
HORIZON = 10
BF16_ULP = 2.0 ** -7
CPU = torch.device("cpu")


def _dims(module, tables_dtype="float32", **kw):
    return module.ModelDims(token_vocab_size=VT, path_vocab_size=VP,
                            target_vocab_size=VY, embeddings_size=E,
                            max_contexts=C, vocab_pad_multiple=4,
                            tables_dtype=tables_dtype,
                            encoder_type="transformer", xf_layers=L,
                            xf_heads=H, **kw)


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _batch(r):
    weights = np.ones((B,), np.float32)
    weights[-1] = 0.0  # a padding row, as the reader's last batch has
    mask = (r.random((B, C)) > 0.3).astype(np.float32)
    mask[0] = 0.0      # a method with no context: all keys kept live
    return (r.integers(0, VY, B).astype(np.int32),
            r.integers(0, VT, (B, C)).astype(np.int32),
            r.integers(0, VP, (B, C)).astype(np.int32),
            r.integers(0, VT, (B, C)).astype(np.int32), mask, weights)


# ---- the encoder ----

@pytest.mark.parametrize("use_kernel,use_pallas",
                         [(True, True), (False, True), (False, False)],
                         ids=["kernel-pallas", "plain-pallas", "plain-xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype, use_kernel, use_pallas):
    """encode_transformer against the JAX package's: the port's kernel
    wrappers (`fused_mha`, the plain versions on CPU tensors) or its
    plain path (`plain_mha`) against the Pallas kernels in interpret
    mode, and the plain path against JAX's XLA path too (the same
    function with other rounding places): float32 code and pool weights
    within 1e-5; bf16 code within 3e-2 of its largest value and weights
    within 2e-2. A method with no live context keeps every key live:
    finite pool weights that sum to 1."""
    jd = _dims(jenc, dtype)
    jp = jenc.init_params(jax.random.PRNGKey(0), jd)
    _labels, src, pth, dst, mask, _w = _batch(np.random.default_rng(1))
    code_j, attn_j = jxf.encode_transformer(
        jp, src, pth, dst, mask, dims=jd, compute_dtype=getattr(jnp, dtype),
        use_pallas=use_pallas)
    tp = convert.params_from_numpy(_np(jp), CPU)
    with torch.inference_mode():
        code_t, attn_t = txf.encode_transformer(
            tp, *(torch.from_numpy(a) for a in (src, pth, dst, mask)),
            dims=_dims(tenc, dtype), compute_dtype=getattr(torch, dtype),
            use_kernel=use_kernel)
    assert code_t.dtype == getattr(torch, dtype)
    assert attn_t.dtype == torch.float32 and attn_t.shape == (B, C)
    code_j, attn_j = _f32(code_j), _f32(attn_j)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(code_t), code_j, atol=1e-5)
        np.testing.assert_allclose(attn_t.numpy(), attn_j, atol=1e-5)
    else:
        np.testing.assert_allclose(_f32(code_t), code_j,
                                   atol=3e-2 * np.abs(code_j).max())
        np.testing.assert_allclose(attn_t.numpy(), attn_j, atol=2e-2)
    assert np.isfinite(attn_t.numpy()[0]).all()
    assert abs(attn_t.numpy()[0].sum() - 1.0) < 1e-5


def test_init_tree_matches_jax_and_params_round_trip():
    """init_params with the transformer has the JAX package's tree: the
    same keys, a list of L layer dicts, the same shapes and dtypes (and
    uniform draws within the fan-avg limit); JAX params (bf16 tables,
    float32 "xf") cross to the port and back bit for bit, leaf by leaf
    in `jax.tree_util.tree_leaves` order."""
    jd, td = _dims(jenc, "bfloat16"), _dims(tenc, "bfloat16")
    jp = _np(jenc.init_params(jax.random.PRNGKey(2), jd))
    tp = tenc.init_params(torch.Generator().manual_seed(2), td)
    assert isinstance(tp["xf"]["layers"], list)
    assert len(tp["xf"]["layers"]) == L
    t_np = convert.params_to_numpy(tp)
    assert jax.tree_util.tree_structure(t_np) == \
        jax.tree_util.tree_structure(jp)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                            jax.tree_util.tree_leaves(t_np)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    qkv = tp["xf"]["layers"][1]["qkv"]
    assert qkv.abs().max() <= (3.0 / ((3 * E + 9 * E) / 2.0)) ** 0.5
    back = convert.params_to_numpy(convert.params_from_numpy(jp, CPU))
    ref = jax.tree_util.tree_leaves(jp)
    got = jax.tree_util.tree_leaves(back)
    assert len(got) == len(ref) == 5 + 3 + 6 * L
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_tree_paths_keep_list_order_past_ten_layers():
    """Path-keyed leaves come back nested with the layers as a list in
    index order, so 12 layers do not sort "10" before "2"."""
    params = {"xf": {"layers": [{"w": i} for i in range(12)], "b": -1},
              "a": 0}
    flat = tree.flatten(params)
    assert flat["xf/layers/10/w"] == 10 and flat["a"] == 0
    back = tree.unflatten(dict(sorted(flat.items())))
    assert [layer["w"] for layer in back["xf"]["layers"]] == list(range(12))
    assert jax.tree_util.tree_leaves(back) == \
        jax.tree_util.tree_leaves(params)


def test_remat_gives_the_same_loss_and_gradients():
    """XF_REMAT recomputes each layer in the backward pass: the loss and
    every gradient equal those without it, bit for bit (the same
    operations on the same inputs on the CPU)."""
    jd = _dims(jenc, "float32")
    params = convert.params_from_numpy(
        _np(jenc.init_params(jax.random.PRNGKey(3), jd)), CPU)
    r = np.random.default_rng(4)
    batch = tuple(torch.from_numpy(a) for a in _batch(r))
    draws = StepDraws(keep=torch.from_numpy(r.random((B, C, 3 * E)) < 0.75),
                      sampled=None, salts={})
    out = {}
    for remat in (False, True):
        loss_fn = make_train_loss_fn(_dims(tenc, xf_remat=remat))
        out[remat] = dense_loss_and_grads(params, batch, draws, loss_fn)
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1].keys() == out[False][1].keys()
    for k, g in out[False][1].items():
        assert torch.equal(out[True][1][k], g), k
    assert any(k.startswith("xf/layers/1/") for k in out[True][1])


@pytest.mark.parametrize("encoder", ["transformer", "bag"])
def test_only_the_encoders_unused_params_get_zero_gradients(encoder):
    """Under the transformer, TRANSFORM and ATTENTION (the bag pool's,
    which init_params makes for either encoder) get zero gradients, as
    jax.grad gives them; the bag has no unused param. A leaf the loss
    fails to reach anywhere else (`path_emb` cut off by a detach) raises
    instead of training silently."""
    dims = dataclasses.replace(_dims(tenc), encoder_type=encoder)
    params = tenc.init_params(torch.Generator().manual_seed(5), dims)
    r = np.random.default_rng(6)
    batch = tuple(torch.from_numpy(a) for a in _batch(r))
    draws = StepDraws(keep=torch.from_numpy(r.random((B, C, 3 * E)) < 0.75),
                      sampled=None, salts={})
    loss_fn = make_train_loss_fn(dims)
    unused = {"transformer": ("transform", "attention"), "bag": ()}[encoder]
    assert loss_fn.unused_keys == unused
    _loss, grads, _view = dense_loss_and_grads(params, batch, draws, loss_fn)
    leaves = tree.flatten(params)
    assert grads.keys() == leaves.keys()
    for k, g in grads.items():
        assert g.shape == leaves[k].shape, k
        assert (not g.any()) == (k in unused), k

    def cut_loss_fn(p, batch_, draws_):
        return loss_fn(dict(p, path_emb=p["path_emb"].detach()), batch_,
                       draws_)
    cut_loss_fn.unused_keys = loss_fn.unused_keys
    with pytest.raises(RuntimeError, match="path_emb"):
        dense_loss_and_grads(params, batch, draws, cut_loss_fn)


@pytest.mark.parametrize("heads,error", [(3, None), (4, None), (5, ValueError),
                                         (0, ValueError)])
def test_config_verify_checks_the_head_count(heads, error):
    """XF_HEADS must divide D = 3 * DEFAULT_EMBEDDINGS_SIZE (384 at
    java-large width), which the JAX package asserts when it builds the
    params; the port's Config.verify raises ValueError."""
    cfg = Config(ENCODER_TYPE="transformer", XF_HEADS=heads)
    if error is None:
        cfg.verify()
    else:
        with pytest.raises(error):
            cfg.verify()


# ---- the dense step against make_train_step(use_pallas=True) ----

STEP_CASES = {
    "f32-full-adafactor-3": ("float32", False, {}, 3),
    "f32-sampled-adam-1": ("float32", True, {"embedding_optimizer": "adam"},
                           1),
    "f32-full-trust-1": ("float32", False, {"trust_ratio": True}, 1),
    "bf16-full-adafactor-3": ("bfloat16", False, {}, 3),
    "bf16-sampled-adam-3": ("bfloat16", True, {"embedding_optimizer": "adam"},
                            3),
}


def _jax_draws(rng, dims, sampled):
    drop_rng, sample_rng = jax.random.split(rng)
    keep = np.array(jax.random.bernoulli(
        drop_rng, dims.dropout_keep_rate, (B, C, 3 * E)))
    ids = (np.array(jss.log_uniform_sample(sample_rng, S, VY))
           if sampled else None)
    return StepDraws(keep=torch.from_numpy(keep),
                     sampled=None if ids is None else torch.from_numpy(ids),
                     salts={})


def _run_both(dtype, sampled, opt_kw, steps):
    jd, td = _dims(jenc, dtype), _dims(tenc, dtype)
    jp = jenc.init_params(jax.random.PRNGKey(7), jd)
    j_tx = jopt.make_optimizer(jopt.make_lr(LR, "cosine", HORIZON), **opt_kw)
    js = j_tx.init(jp)
    tp = convert.params_from_numpy(_np(jp), CPU)
    ts = convert.dense_opt_state_from_numpy(_np(js), CPU)
    jstep = j_make_train_step(jd, j_tx, use_sampled_softmax=sampled,
                              num_sampled=S, compute_dtype=getattr(jnp, dtype),
                              use_pallas=True)
    tstep = make_port_train_step(
        td, topt.make_optimizer(topt.make_lr(LR, "cosine", HORIZON),
                                **opt_kw),
        use_sampled_softmax=sampled, num_sampled=S,
        compute_dtype=getattr(torch, dtype))
    r = np.random.default_rng(8)
    launches = (mha_forward_fused.launches, mha_backward_fused.launches)
    losses = []
    for i in range(steps):
        batch = _batch(r)
        rng = jax.random.PRNGKey(100 + i)
        draws = _jax_draws(rng, jd, sampled)
        jp, js, jl = jstep(jp, js, tuple(jnp.asarray(a) for a in batch), rng)
        tl = tstep(tp, ts, tuple(torch.from_numpy(a) for a in batch), draws)
        losses.append((float(tl), float(jl)))
    assert (mha_forward_fused.launches, mha_backward_fused.launches) == \
        launches  # CPU tensors: the plain versions
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (convert.params_to_numpy(tp), to_np(jp),
            convert.dense_opt_state_to_numpy(ts), to_np(js), losses)


def _pairs(t_tree, j_tree, prefix):
    got = jax.tree_util.tree_leaves(t_tree)
    ref = jax.tree_util.tree_leaves_with_path(j_tree)
    assert len(got) == len(ref)
    for a, (path, b) in zip(got, ref):
        yield prefix + jax.tree_util.keystr(path), a, b


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_dense_step_matches_jax(case):
    """The port's dense step against make_train_step(use_pallas=True) for
    the transformer, leaf for leaf in `tree_leaves` order: the loss,
    every "xf" leaf, the tables, TRANSFORM / ATTENTION (unused by the
    encoder: zero gradients on both sides), and the optimizer state,
    under the float32 or bf16 bounds of the module docstring; the step
    counts equal."""
    dtype, sampled, opt_kw, steps = STEP_CASES[case]
    tp, jp, ts, js, losses = _run_both(dtype, sampled, opt_kw, steps)
    f32 = dtype == "float32"
    for lt, lj in losses:
        assert abs(lt - lj) <= (1e-5 if f32 else 1e-2) * abs(lj)
    pairs = [*_pairs(tp, jp, "params"), *_pairs(ts, js, "state")]
    assert any("'xf'" in name and "'layers'][1]" in name
               for name, _a, _b in pairs if name.startswith("state"))
    for name, a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name.endswith(".count"):
            assert int(a) == int(b) == steps, name
            continue
        fa, fb = _f32(a), _f32(b)
        top = np.abs(fb).max()
        d = np.abs(fa - fb)
        if name.startswith("state"):
            if f32:
                assert d.max() <= 1e-3 * top, name
                assert np.mean(d <= 1e-4 * top) >= 0.99, name
            else:
                assert d.max() <= 5e-2 * top, name
        elif f32:
            assert d.max() <= 2 * LR * steps + 1e-5 * top, name
            assert np.mean(d <= 1e-5 * top) >= 0.99, name
        else:
            assert d.max() <= 2 * LR * steps + BF16_ULP * top, name
            assert np.mean(d <= BF16_ULP * top) >= 0.95, name

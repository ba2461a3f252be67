"""The port's dense training step and its optimizers against the JAX
package's.

Both sides start from the same params (JAX `init_params`, carried over by
`convert.params_from_numpy`) and the same optimizer state (the JAX
optimizer's `init`, carried over by `convert.dense_opt_state_from_numpy`),
and take the same numpy batches. The step's randomness is drawn on the
JAX side exactly as its dense step draws it and handed to the port as
`StepDraws`: `drop_rng, sample_rng = split(rng)` for float tables;
`rng, loss_rng, *qrngs = split(rng, 2 + n_int8)`, then `split(loss_rng)`
and one `jax.random.bits` salt per int8 table for int8 tables. The
reference is `make_train_step(...)` (`use_pallas=False`: the plain pool,
as the port's training pool runs on CPU tensors).

The step tests run at E = 128 with every vocab over 128 rows, so every
table takes Adafactor's factored branch, as at java-large.

Tolerances, each test repeating its own:
- the optimizers against optax, eagerly: bf16 values within 1 bf16 ulp
  of the array's largest value and bit-identical on 95% of the elements
  (a float32 mean or norm summed in another order can land on the other
  side of a bf16 rounding edge, and a trust ratio then moves a whole
  update by an ulp; the same update order is otherwise bit-identical),
  float32 within 4
  float32 ulp of the array's largest value (sums in another order, `pow`
  and `cos` from two libraries);
- the schedules: within 2 float32 ulp of the value;
- float32 tables and compute: loss within 1e-6 relative; params within
  1e-5 of their largest value on 99% of the elements, and within
  2 * lr * steps of it everywhere (Adam divides each gradient element by
  its own magnitude, so an element whose gradient is within rounding of
  0 turns a float32 difference into a step of up to lr); optimizer state
  within 1e-5 of its largest value on 99% of the elements and within
  1e-4 everywhere (the next step's gradients inherit those params);
- bf16 tables and compute: the frameworks round bf16 products and sums
  at different places, so a gradient near 0 may change sign, and
  Adafactor moves each element by ~lr either way. Loss within 1e-3
  relative; each param within 2 * lr * steps + 1 bf16 ulp of its largest
  value, and 95% of elements within 1 bf16 ulp of it; optimizer moments
  within 5e-2 of their largest value;
- int8 token/path tables with float32 compute: `target_emb` is bf16, so
  after the first step it may differ by a bf16 ulp here and there, and
  the dense requantize re-rounds EVERY element of both tables each step,
  so any such difference in an update flips the elements that lie on a
  rounding edge, and each flip moves its row by a quantum and the next
  step's gradients with it (the XLA reference requantize flips more from
  the first step on: its jit contracts `q * s + u` into an FMA). So: q
  within 1 on at most 1e-2 of the elements, the loss within 1e-5, the
  rest under the bf16 bound. With bf16 compute the dequantized rows and
  the rest follow the bf16 bound.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from code2vec_tpu.models import encoder as jenc
from code2vec_tpu.ops import sampled_softmax as jss
from code2vec_tpu.ops.quant import is_quantized as j_is_quantized
from code2vec_tpu.ops.quant import opt_param_view as j_opt_param_view
from code2vec_tpu.training import optimizers as jopt
from code2vec_tpu.training.steps import make_train_step as j_make_train_step
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.ops.quant import opt_param_view
from code2vec_tpu_torch.training import optimizers as topt
from code2vec_tpu_torch.training.draws import StepDraws
# the port's step updates in place and donates nothing
from code2vec_tpu_torch.training.steps import \
    make_train_step as make_port_train_step
from torch_helpers import max_ulp_diff

LR = 0.01
B, C, E = 6, 12, 128
VT, VP, VY = 150, 130, 140
S = 16
HORIZON = 10
BF16_ULP = 2.0 ** -7
CPU = torch.device("cpu")


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _t(tree):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                     CPU)


# ---- the optimizers against optax ----

def _opt_params(r, table_dtype, table_shape):
    return {"token_emb": jnp.asarray(r.normal(size=table_shape) * 0.1,
                                     table_dtype),
            "transform": jnp.asarray(r.normal(size=(24, 24)) * 0.1,
                                     jnp.float32),
            "attention": jnp.asarray(r.normal(size=(24,)) * 0.1,
                                     jnp.float32)}


def _run_optimizers(j_tx, t_tx, table_dtype, table_shape, steps):
    r = np.random.default_rng(3)
    jp = _opt_params(r, table_dtype, table_shape)
    js = j_tx.init(jp)
    tp = _t(jp)
    ts = convert.dense_opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), CPU)
    for i in range(steps):
        g = {k: jnp.asarray(r.normal(size=v.shape) * 10.0 ** -i, v.dtype)
             for k, v in jp.items()}
        u, js = j_tx.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        t_tx.apply(tp, _t(g), ts)
    return (convert.params_to_numpy(tp), jax.tree_util.tree_map(np.asarray, jp),
            convert.dense_opt_state_to_numpy(ts),
            jax.tree_util.tree_map(np.asarray, js))


def _assert_optax_match(a, b, name):
    """bf16 within 1 ulp of the largest value and 95% bit-identical;
    float32 within 4 ulp of the largest value; integers equal."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    if a.dtype.name == "bfloat16":
        fa, fb = _f32(a), _f32(b)
        assert np.all(np.abs(fa - fb) <= BF16_ULP * np.abs(fb).max()), name
        assert np.mean(fa == fb) >= 0.95, name
    elif a.dtype == np.float32 and b.size:
        tol = 4 * float(np.spacing(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)
    else:
        np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_trees_match(t_tree, j_tree):
    """The port's state leaves, in `tree_leaves` order, against the JAX
    state's (MaskedNode placeholders hold no leaves)."""
    got = jax.tree_util.tree_leaves(t_tree)
    ref = jax.tree_util.tree_leaves_with_path(j_tree)
    assert len(got) == len(ref)
    for a, (path, b) in zip(got, ref):
        _assert_optax_match(a, b, jax.tree_util.keystr(path))


OPTIMIZER_CASES = {
    "adafactor": dict(embedding_optimizer="adafactor"),
    "adam": dict(embedding_optimizer="adam"),
    "trust_all": dict(embedding_optimizer="adafactor", trust_ratio=True),
    "trust_dense": dict(embedding_optimizer="adafactor", trust_ratio=True,
                        trust_ratio_scope="dense"),
    "adam_trust": dict(embedding_optimizer="adam", trust_ratio=True),
}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("table_shape", [(150, 128), (40, 8)],
                         ids=["factored", "unfactored"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(OPTIMIZER_CASES))
def test_optimizer_matches_optax(case, dtype, table_shape, steps):
    """Every branch of make_optimizer under a cosine schedule against the
    JAX package's, 1 and 3 eager updates, a [150, 128] table (Adafactor's
    factored branch) and a [40, 8] one (unfactored): bf16 params and
    state within 1 ulp of the largest value and 95% bit-identical,
    float32 within 4 ulp of the largest value."""
    kw = OPTIMIZER_CASES[case]
    j_tx = jopt.make_optimizer(jopt.make_lr(LR, "cosine", HORIZON), **kw)
    t_tx = topt.make_optimizer(topt.make_lr(LR, "cosine", HORIZON), **kw)
    tp, jp, ts, js = _run_optimizers(j_tx, t_tx, getattr(jnp, dtype),
                                     table_shape, steps)
    for k in jp:
        _assert_optax_match(tp[k], jp[k], k)
    _assert_trees_match(ts, js)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear",
                                      "warmup_cosine"])
def test_schedule_matches_optax(schedule):
    """make_lr's four schedules at steps 0, 1, the warmup's end, and the
    horizon -1, 0 and +1, within 2 float32 ulp of the JAX package's;
    warmup_length and schedule_total_steps equal."""
    horizon, warm = 40, 5
    j_lr = jopt.make_lr(LR, schedule, horizon, warm if schedule ==
                        "warmup_cosine" else 0)
    t_lr = topt.make_lr(LR, schedule, horizon, warm if schedule ==
                        "warmup_cosine" else 0)
    if schedule == "constant":
        assert t_lr == j_lr == LR
        return
    for step in (0, 1, warm - 1, warm, warm + 1, horizon - 1, horizon,
                 horizon + 1):
        ref = np.float32(j_lr(jnp.asarray(step, jnp.int32)))
        got = t_lr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert max_ulp_diff(got.numpy(), ref) <= 2, (step, got, ref)
    for total, w in ((1, 0), (2, 0), (40, 0), (40, 5), (40, 80), (1000, 0)):
        assert topt.warmup_length(total, w) == jopt.warmup_length(total, w)
    for n, b, e in ((1, 1024, 20), (1024, 1024, 3), (1025, 1024, 2)):
        assert topt.schedule_total_steps(n, b, e) == \
            jopt.schedule_total_steps(n, b, e)


def test_optimizer_refuses_what_the_jax_package_refuses():
    """Unknown optimizers, schedules and scopes raise ValueError, as do a
    dense trust scope with adam and a schedule without a horizon."""
    for call in (lambda: topt.make_optimizer(LR, "sgd"),
                 lambda: topt.make_optimizer(LR, "adam", True, "dense"),
                 lambda: topt.make_optimizer(LR, "adafactor", True, "half"),
                 lambda: topt.make_lr(LR, "step", 10),
                 lambda: topt.make_lr(LR, "cosine", 0)):
        with pytest.raises(ValueError):
            call()


# ---- the dense step against make_train_step ----

def _dims(module, tables_dtype):
    return module.ModelDims(token_vocab_size=VT, path_vocab_size=VP,
                            target_vocab_size=VY, embeddings_size=E,
                            max_contexts=C, vocab_pad_multiple=4,
                            tables_dtype=tables_dtype)


def _batch(r):
    weights = np.ones((B,), np.float32)
    weights[-1] = 0.0  # a padding row, as the reader's last batch has
    return (r.integers(0, VY, B).astype(np.int32),
            r.integers(0, VT, (B, C)).astype(np.int32),
            r.integers(0, VP, (B, C)).astype(np.int32),
            r.integers(0, VT, (B, C)).astype(np.int32),
            (r.random((B, C)) > 0.3).astype(np.float32), weights)


def _jax_draws(rng, params, dims, sampled):
    """The draws of the JAX dense step (float or quantized)."""
    qkeys = sorted(k for k in ("token_emb", "path_emb")
                   if j_is_quantized(params[k]))
    salts = {}
    if qkeys:
        rng, loss_rng, *qrngs = jax.random.split(rng, 2 + len(qkeys))
        salts = {k: int(np.asarray(jax.random.bits(q, dtype=jnp.uint32)))
                 for k, q in zip(qkeys, qrngs)}
        rng = loss_rng
    drop_rng, sample_rng = jax.random.split(rng)
    keep = np.array(jax.random.bernoulli(
        drop_rng, dims.dropout_keep_rate, (B, C, 3 * E)))
    ids = (np.array(jss.log_uniform_sample(sample_rng, min(S, VY), VY))
           if sampled else None)
    return StepDraws(keep=torch.from_numpy(keep),
                     sampled=None if ids is None else torch.from_numpy(ids),
                     salts=salts)


def _run_both(tables_dtype, compute, sampled, steps, requant_fused=False,
              seed=0):
    jd, td = _dims(jenc, tables_dtype), _dims(tenc, tables_dtype)
    jp = jenc.init_params(jax.random.PRNGKey(seed), jd)
    j_tx = jopt.make_optimizer(jopt.make_lr(LR, "cosine", HORIZON))
    js = j_tx.init(j_opt_param_view(jp))
    tp = _t(jp)
    ts = convert.dense_opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), CPU)
    jstep = j_make_train_step(jd, j_tx, use_sampled_softmax=sampled,
                              num_sampled=S,
                              compute_dtype=getattr(jnp, compute),
                              requant_fused=requant_fused)
    tstep = make_port_train_step(
        td, topt.make_optimizer(topt.make_lr(LR, "cosine", HORIZON)),
        use_sampled_softmax=sampled, num_sampled=S,
        compute_dtype=getattr(torch, compute))
    r = np.random.default_rng(seed + 1)
    losses = []
    for i in range(steps):
        batch = _batch(r)
        rng = jax.random.PRNGKey(100 + i)
        draws = _jax_draws(rng, jp, jd, sampled)
        jp, js, jl = jstep(jp, js, tuple(jnp.asarray(a) for a in batch), rng)
        tl = tstep(tp, ts, tuple(torch.from_numpy(a) for a in batch), draws)
        losses.append((float(tl), float(jl)))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (convert.params_to_numpy(tp), to_np(jp),
            convert.dense_opt_state_to_numpy(ts), to_np(js), losses)


def _param_pairs(tp, jp):
    for k, ref in jp.items():
        if isinstance(ref, dict):
            for kk in ref:
                yield f"{k}.{kk}", tp[k][kk], ref[kk]
        else:
            yield k, tp[k], ref


def _state_pairs(ts, js):
    got = jax.tree_util.tree_leaves(ts)
    ref = jax.tree_util.tree_leaves_with_path(js)
    assert len(got) == len(ref)
    for a, (path, b) in zip(got, ref):
        yield "state" + jax.tree_util.keystr(path), a, b


def _check_counts(ts, js, steps):
    counts = [np.asarray(b) for name, _a, b in _state_pairs(ts, js)
              if name.endswith(".count")]
    assert counts and all(int(c) == steps for c in counts)
    for name, a, b in _state_pairs(ts, js):
        if name.endswith(".count"):
            assert a.dtype == np.int32 and int(a) == int(b), name


def _check_f32_bound(name, a, b, steps):
    a, b = _f32(a), _f32(b)
    top = np.abs(b).max()
    d = np.abs(a - b)
    if name.startswith("state"):
        assert d.max() <= 1e-4 * top, name
        assert np.mean(d <= 1e-5 * top) >= 0.99, name
    else:
        assert d.max() <= 2 * LR * steps + 1e-5 * top, name
        assert np.mean(d <= 1e-5 * top) >= 0.99, name


def _check_bf16_bound(name, a, b, steps):
    a, b = _f32(a), _f32(b)
    top = np.abs(b).max()
    d = np.abs(a - b)
    if name.startswith("state"):
        assert d.max() <= 5e-2 * top, name
    else:
        assert d.max() <= 2 * LR * steps + BF16_ULP * top, name
        assert np.mean(d <= BF16_ULP * top) >= 0.95, name


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("sampled", [False, True], ids=["full", "sampled"])
def test_float32_dense_step_matches_jax(sampled, steps):
    """float32 tables and compute: loss within 1e-6 relative; params
    within 1e-5 of their largest value on 99% of the elements and
    within 2 * lr * steps everywhere; optimizer state within 1e-5 of its
    largest value on 99% and within 1e-4 everywhere."""
    tp, jp, ts, js, losses = _run_both("float32", "float32", sampled, steps)
    for lt, lj in losses:
        assert abs(lt - lj) <= 1e-6 * abs(lj)
    for name, a, b in [*_param_pairs(tp, jp), *_state_pairs(ts, js)]:
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if not name.endswith(".count"):
            _check_f32_bound(name, a, b, steps)
    _check_counts(ts, js, steps)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("sampled", [False, True], ids=["full", "sampled"])
def test_bf16_dense_step_matches_jax(sampled, steps):
    """bf16 tables and compute: loss within 1e-3 relative; params within
    2 * lr * steps + 1 bf16 ulp of the largest value (95% of elements
    within the ulp); optimizer moments within 5e-2 of their largest
    value."""
    tp, jp, ts, js, losses = _run_both("bfloat16", "bfloat16", sampled,
                                       steps)
    for lt, lj in losses:
        assert abs(lt - lj) <= 1e-3 * abs(lj)
    for name, a, b in [*_param_pairs(tp, jp), *_state_pairs(ts, js)]:
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if not name.endswith(".count"):
            _check_bf16_bound(name, a, b, steps)
    _check_counts(ts, js, steps)


@pytest.mark.parametrize("compute,requant_fused", [
    ("float32", False), ("float32", True), ("bfloat16", False)],
    ids=["f32-reference", "f32-pallas-interpret", "bf16-reference"])
@pytest.mark.parametrize("sampled", [False, True], ids=["full", "sampled"])
def test_int8_dense_step_matches_jax(sampled, compute, requant_fused):
    """int8 token/path tables, 3 steps, against the JAX step with its
    requantize as the Pallas kernel (interpret mode) and as the XLA
    reference. float32 compute: q within 1 on at most 1e-2 of the
    elements, loss within 1e-5, the dequantized rows and the rest under
    the bf16 bound. bf16 compute: the bf16 bound on the dequantized rows
    and the rest, loss within 1e-3."""
    steps = 3
    tp, jp, ts, js, losses = _run_both("int8", compute, sampled, steps,
                                       requant_fused=requant_fused)
    loss_rtol = 1e-5 if compute == "float32" else 1e-3
    for lt, lj in losses:
        assert abs(lt - lj) <= loss_rtol * abs(lj)
    for k in ("token_emb", "path_emb"):
        q_t, q_j = tp[k]["q"], jp[k]["q"]
        assert q_t.dtype == np.int8 and q_j.dtype == np.int8
        if compute == "float32":
            dq = np.abs(q_t.astype(np.int32) - q_j.astype(np.int32))
            assert dq.max() <= 1 and (dq > 0).mean() <= 1e-2, k
        _check_bf16_bound(k, q_t * tp[k]["s"], q_j * jp[k]["s"], steps)
    for name, a, b in [*_param_pairs(tp, jp), *_state_pairs(ts, js)]:
        if not name.endswith((".q", ".s", ".count")):
            _check_bf16_bound(name, a, b, steps)
    _check_counts(ts, js, steps)


@pytest.mark.parametrize("case", ["adafactor-cosine", "adam-warmup_cosine",
                                  "trust_dense-linear"])
def test_dense_opt_state_converter_round_trips(case):
    """JAX dense opt state (after a bf16 step, so nothing is zero) ->
    port -> numpy is bit-identical leaf by leaf, bf16 leaves included,
    for each optimizer variant and schedule state."""
    opt, schedule = case.split("-")
    kw = {"adafactor": {}, "adam": {"embedding_optimizer": "adam"},
          "trust_dense": {"trust_ratio": True,
                          "trust_ratio_scope": "dense"}}[opt]
    jd = _dims(jenc, "bfloat16")
    jp = jenc.init_params(jax.random.PRNGKey(4), jd)
    tp = _t(jp)  # before the step, which donates jp
    j_tx = jopt.make_optimizer(jopt.make_lr(LR, schedule, HORIZON), **kw)
    js = j_tx.init(jp)
    step = j_make_train_step(jd, j_tx, compute_dtype=jnp.bfloat16)
    r = np.random.default_rng(5)
    _jp, js, _ = step(jp, js, tuple(jnp.asarray(a) for a in _batch(r)),
                      jax.random.PRNGKey(6))
    js = jax.tree_util.tree_map(np.asarray, js)
    port = convert.dense_opt_state_from_numpy(js, CPU)
    back = convert.dense_opt_state_to_numpy(port)
    ref = jax.tree_util.tree_leaves(js)
    got = jax.tree_util.tree_leaves(back)
    assert len(got) == len(ref) and len(ref) > 0
    # Adafactor keeps the bf16 tables' moments in bf16
    assert (opt != "adam") == any(np.asarray(b).dtype.name == "bfloat16"
                                  for b in ref)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # the port's own init has the converted state's structure
    t_tx = topt.make_optimizer(topt.make_lr(LR, schedule, HORIZON), **kw)
    fresh = t_tx.init(tp)
    assert jax.tree_util.tree_structure(
        convert.dense_opt_state_to_numpy(fresh)) == \
        jax.tree_util.tree_structure(back)


def test_int8_opt_state_is_built_on_bf16_stand_ins():
    """The quantized step's optimizer sees each int8 table as a flat bf16
    [V, E] stand-in (its Adafactor factors are bf16, as the JAX
    package's), built without materializing a [V, E] buffer."""
    td = _dims(tenc, "int8")
    tp = tenc.init_params(torch.Generator().manual_seed(0), td)
    view = opt_param_view(tp)
    for k in ("token_emb", "path_emb"):
        assert view[k].dtype == torch.bfloat16
        assert view[k].shape == tp[k]["q"].shape
        assert view[k].stride() == (0, 0)
    state = topt.make_optimizer(LR).init(view)
    fac = state["table"][0]
    assert fac.v_row["token_emb"].dtype == torch.bfloat16
    assert fac.v_row["token_emb"].shape == (E,)
    assert fac.v_col["token_emb"].shape == (tp["token_emb"]["q"].shape[0],)
    js = jopt.make_optimizer(LR).init(j_opt_param_view(
        jenc.init_params(jax.random.PRNGKey(0), _dims(jenc, "int8"))))
    assert jax.tree_util.tree_structure(convert.dense_opt_state_to_numpy(
        state)) == jax.tree_util.tree_structure(
        convert.dense_opt_state_to_numpy(convert.dense_opt_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, js), CPU)))


VERIFY_CASES = {
    "defaults": ({}, None),
    "int8-transformer": ({"TABLES_DTYPE": "int8",
                          "ENCODER_TYPE": "transformer"}, ValueError),
    "int8-trust": ({"TABLES_DTYPE": "int8", "TRUST_RATIO": True},
                   ValueError),
    "int8-adafactor": ({"TABLES_DTYPE": "int8"}, None),
    "warmup-negative": ({"LR_WARMUP_STEPS": -1}, ValueError),
    "warmup-cosine": ({"LR_WARMUP_STEPS": 5}, ValueError),
    "warmup-warmup_cosine": ({"LR_WARMUP_STEPS": 5,
                              "LR_SCHEDULE": "warmup_cosine"}, None),
    "trust-dense-adam": ({"TRUST_RATIO": True, "TRUST_RATIO_SCOPE": "dense",
                          "EMBEDDING_OPTIMIZER": "adam"}, ValueError),
    "trust-dense-adafactor": ({"TRUST_RATIO": True,
                               "TRUST_RATIO_SCOPE": "dense"}, None),
    "trust-sparse": ({"TRUST_RATIO": True, "SPARSE_EMBEDDING_UPDATES": True,
                      "EMBEDDING_OPTIMIZER": "adam",
                      "LR_SCHEDULE": "constant"}, ValueError),
}


@pytest.mark.parametrize("case", list(VERIFY_CASES))
def test_config_verify_matches_jax_rules(case):
    """The port's Config.verify accepts and refuses the same combinations
    of the dense-step fields as the JAX package's (given a training
    run), with ValueError."""
    from code2vec_tpu.config import Config as JConfig
    from code2vec_tpu_torch.config import Config
    fields, error = VERIFY_CASES[case]
    j_cfg = JConfig(**fields)
    j_cfg.train_data_path = "train.c2v"
    t_cfg = Config(**fields)
    for cfg in (j_cfg, t_cfg):
        if error is None:
            cfg.verify()
        else:
            with pytest.raises(error):
                cfg.verify()
    assert (t_cfg.LR_WARMUP_STEPS, t_cfg.TRUST_RATIO, t_cfg.TRUST_RATIO_SCOPE,
            t_cfg.TEST_BATCH_SIZE, t_cfg.NUM_TRAIN_EPOCHS) == \
        (j_cfg.LR_WARMUP_STEPS, j_cfg.TRUST_RATIO, j_cfg.TRUST_RATIO_SCOPE,
         j_cfg.TEST_BATCH_SIZE, j_cfg.NUM_TRAIN_EPOCHS)

"""The port's sparse-row training step against the JAX package's.

Both sides start from the same params (JAX `init_params`, carried over by
`convert.params_from_numpy`) and the same sparse opt state (JAX
`init_sparse_opt_state`, carried over by
`convert.sparse_opt_state_from_numpy`), and take the same numpy batches.
The step's randomness is drawn on the JAX side exactly as its step draws
it (`drop_rng, sample_rng, *qrngs = jax.random.split(rng, 2 + n_int8)`,
the Bernoulli keep mask, `log_uniform_sample`, one `jax.random.bits`
salt per int8 table) and handed to the port as `StepDraws`. The
reference is `make_sparse_train_step(..., sparse_update_fused=False)`.

Tolerances, each test repeating its own:
- float32 tables and compute: loss within 1e-6 relative, every param and
  moment within 1e-5 of its largest value (XLA contracts multiply-adds
  into FMAs and sums in another order);
- bf16 tables and compute: the frameworks round bf16 products and sums
  at different places, so a gradient near 0 may change sign, and Adam's
  first steps move such an element by ~lr either way. Loss within 1e-3
  relative; each param within 2 * lr * steps + 1 bf16 ulp of its largest
  value, and 95% of elements within 1 bf16 ulp of it; moments within 5e-2
  of their largest value;
- int8 token/path tables with float32 compute: q within 1 on at most 1e-3
  of the elements, the loss within 1e-6, s and everything else within
  1e-4 of the largest value (a q one apart moves a row by one quantum,
  and the next step's gradients with it). With bf16 compute the
  dequantized rows follow the bf16 bound.
"""

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from code2vec_tpu.data.reader import C2VTextReader as JReader
from code2vec_tpu.models import encoder as jenc
from code2vec_tpu.ops import sampled_softmax as jss
from code2vec_tpu.ops.quant import is_quantized as j_is_quantized
from code2vec_tpu.training.optimizers import (make_optimizer as j_make_opt,
                                              scale_by_adam_f32_moments)
from code2vec_tpu.training.sparse_steps import (init_sparse_opt_state,
                                                make_sparse_train_step)
from code2vec_tpu.vocab import vocabularies as jvocab
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data.reader import C2VTextReader
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
from code2vec_tpu_torch.ops import sampled_softmax as tss
from code2vec_tpu_torch.ops.attention import attention_pool
from code2vec_tpu_torch.ops.attention_kernel import (attention_pool_fused,
                                                     attention_pool_train)
from code2vec_tpu_torch.training import optimizers as topt
from code2vec_tpu_torch.training.draws import StepDraws, make_draws
from code2vec_tpu_torch.training.optimizers import (AdamF32Moments, make_lr,
                                                    make_optimizer)
# the port's step updates in place and donates nothing
from code2vec_tpu_torch.training.steps import \
    make_train_step as make_port_train_step
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
from helpers import PATHS, TARGETS, TOKENS, make_raw_lines

LR = 0.01
B, C, E = 6, 12, 8
VT, VP, VY = 41, 23, 19
S = 8
BF16_ULP = 2.0 ** -7


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
    """The draws of JAX `prepare_step_inputs` / `sparse_requant_adam`."""
    qkeys = sorted(k for k in ("token_emb", "path_emb")
                   if j_is_quantized(params[k]))
    drop_rng, sample_rng, *qrngs = jax.random.split(rng, 2 + len(qkeys))
    keep = np.array(jax.random.bernoulli(
        drop_rng, dims.dropout_keep_rate, (B, C, 3 * E)))
    ids = (np.array(jss.log_uniform_sample(sample_rng, min(S, VY), VY))
           if sampled else None)
    salts = {k: int(np.asarray(jax.random.bits(q, dtype=jnp.uint32)))
             for k, q in zip(qkeys, qrngs)}
    return StepDraws(keep=torch.from_numpy(keep),
                     sampled=None if ids is None else torch.from_numpy(ids),
                     salts=salts)


def _run_both(tables_dtype, compute, sampled, steps, seed=0):
    jd, td = _dims(jenc, tables_dtype), _dims(tenc, tables_dtype)
    jp = jenc.init_params(jax.random.PRNGKey(seed), jd)
    jopt = j_make_opt(LR, "adam")
    js = init_sparse_opt_state(jp, jopt, sampled)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    ts = convert.sparse_opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), "cpu")
    jstep = make_sparse_train_step(
        jd, learning_rate=LR, dense_optimizer=jopt,
        use_sampled_softmax=sampled, num_sampled=S,
        compute_dtype=getattr(jnp, compute), sparse_update_fused=False)
    tstep = make_port_train_step(td, AdamF32Moments(LR),
                                 use_sampled_softmax=sampled, num_sampled=S,
                                 compute_dtype=getattr(torch, compute),
                                 sparse_updates=True)
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
            convert.sparse_opt_state_to_numpy(ts), to_np(js), losses)


def _pairs(tp, jp, ts, js):
    """(name, port array, JAX array) over params and every moment."""
    for k, ref in jp.items():
        if isinstance(ref, dict):
            for kk in ref:
                yield f"{k}.{kk}", tp[k][kk], ref[kk]
        else:
            yield k, tp[k], ref
    for k, st in js["rows"].items():
        yield f"rows.{k}.m", ts["rows"][k]["m"], st.m
        yield f"rows.{k}.v", ts["rows"][k]["v"], st.v
    adam = js["dense"][0]
    for k in adam.mu:
        yield f"dense.mu.{k}", ts["dense"]["mu"][k], adam.mu[k]
        yield f"dense.nu.{k}", ts["dense"]["nu"][k], adam.nu[k]


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _check_counts(ts, js, steps):
    assert int(ts["count"]) == int(js["count"]) == steps
    assert int(ts["dense"]["count"]) == int(js["dense"][0].count) == steps


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("sampled", [False, True], ids=["full", "sampled"])
def test_float32_step_matches_jax(sampled, steps):
    """float32 tables and compute: loss within 1e-6 relative, every param
    and moment within 1e-5 of its largest value."""
    tp, jp, ts, js, losses = _run_both("float32", "float32", sampled, steps)
    for lt, lj in losses:
        assert abs(lt - lj) <= 1e-6 * abs(lj)
    for name, a, b in _pairs(tp, jp, ts, js):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        tol = 1e-5 * np.abs(_f32(b)).max()
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=0, atol=tol,
                                   err_msg=name)
    _check_counts(ts, js, steps)


def _check_bf16_bound(name, a, b, steps):
    a, b = _f32(a), _f32(b)
    top = np.abs(b).max()
    d = np.abs(a - b)
    if name.startswith(("rows.", "dense.")):
        assert d.max() <= 5e-2 * top, name
    else:
        assert d.max() <= 2 * LR * steps + BF16_ULP * top, name
        assert np.mean(d <= BF16_ULP * top) >= 0.95, name


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("sampled", [False, True], ids=["full", "sampled"])
def test_bf16_step_matches_jax(sampled, steps):
    """bf16 tables and compute: loss within 1e-3 relative; params within
    2 * lr * steps + 1 bf16 ulp of the largest value (95% of elements
    within the ulp); moments within 5e-2 of their largest value."""
    tp, jp, ts, js, losses = _run_both("bfloat16", "bfloat16", sampled,
                                       steps)
    for lt, lj in losses:
        assert abs(lt - lj) <= 1e-3 * abs(lj)
    for name, a, b in _pairs(tp, jp, ts, js):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        _check_bf16_bound(name, a, b, steps)
    _check_counts(ts, js, steps)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("sampled", [False, True], ids=["full", "sampled"])
def test_int8_step_matches_jax(sampled, compute):
    """int8 token/path tables, 3 steps. float32 compute: q within 1 on at
    most 1e-3 of the elements, s and the rest within 1e-4 of the largest
    value, loss within 1e-6. bf16 compute: the bf16 bound on the
    dequantized rows and the rest, loss within 1e-3."""
    steps = 3
    tp, jp, ts, js, losses = _run_both("int8", compute, sampled, steps)
    tight = compute == "float32"
    for lt, lj in losses:
        assert abs(lt - lj) <= (1e-6 if tight else 1e-3) * abs(lj)
    for k in ("token_emb", "path_emb"):
        q_t, q_j = tp[k]["q"], jp[k]["q"]
        assert q_t.dtype == np.int8 and q_j.dtype == np.int8
        if tight:
            dq = np.abs(q_t.astype(np.int32) - q_j.astype(np.int32))
            assert dq.max() <= 1 and (dq > 0).mean() <= 1e-3, k
        else:
            _check_bf16_bound(k, q_t * tp[k]["s"], q_j * jp[k]["s"], steps)
    for name, a, b in _pairs(tp, jp, ts, js):
        if name.endswith(".q"):
            continue
        if tight:
            tol = 1e-4 * np.abs(_f32(b)).max()
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=0, atol=tol,
                                       err_msg=name)
        elif not name.endswith(".s"):
            _check_bf16_bound(name, a, b, steps)
    _check_counts(ts, js, steps)


def test_dense_adam_cast_order_on_bf16_target_emb():
    """The dense optimizer on a bf16 param with bf16 grads (target_emb
    under full softmax) against optax `scale_by_adam_f32_moments` +
    `scale_by_learning_rate` + `apply_updates`, three updates: params
    within 1 bf16 ulp elementwise and equal on at least 99% of elements,
    moments within 1e-5 of their largest value. Rounding the update only
    once at the end instead gives other params, so the test sees the
    cast order."""
    r = np.random.default_rng(7)
    p0 = jnp.asarray(r.normal(size=(64, 24)) * 0.05, jnp.bfloat16)
    tx = optax.chain(scale_by_adam_f32_moments(),
                     optax.scale_by_learning_rate(LR))
    j_params = {"target_emb": p0}
    j_state = tx.init(j_params)
    t_params = convert.params_from_numpy({"target_emb": np.asarray(p0)},
                                         "cpu")
    opt = AdamF32Moments(LR)
    t_state = opt.init(t_params)
    once = _f32(p0)
    upd = jax.jit(tx.update)
    for i in range(3):
        g = jnp.asarray(r.normal(size=(64, 24)) * 10.0 ** -i, jnp.bfloat16)
        j_grads = {"target_emb": g}
        u, j_state = upd(j_grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, u)
        opt.step(t_params, convert.params_from_numpy(
            {"target_emb": np.asarray(g)}, "cpu"), t_state)
        mu, nu = _f32(j_state[0].mu["target_emb"]), _f32(
            j_state[0].nu["target_emb"])
        bc1, bc2 = 1 - 0.9 ** (i + 1), 1 - 0.999 ** (i + 1)
        once = once - LR * (mu / bc1) / (np.sqrt(nu / bc2) + 1e-8)
    got = t_params["target_emb"]
    assert got.dtype == torch.bfloat16
    got, ref = _f32(convert.params_to_numpy(t_params)["target_emb"]), \
        _f32(j_params["target_emb"])
    assert np.all(np.abs(got - ref) <= BF16_ULP * np.abs(ref))
    assert np.mean(got == ref) >= 0.99
    rounded_once = _f32(jnp.asarray(once, jnp.bfloat16))
    assert np.mean(rounded_once != ref) > 0.01
    for name in ("mu", "nu"):
        a = t_state[name]["target_emb"].numpy()
        b = _f32(getattr(j_state[0], name)["target_emb"])
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
    assert int(t_state["count"]) == int(j_state[0].count) == 3


@pytest.mark.parametrize("tables_dtype", ["float32", "int8"])
@pytest.mark.parametrize("sampled", [False, True], ids=["full", "sampled"])
def test_sparse_opt_state_converter_round_trips(sampled, tables_dtype):
    """JAX sparse opt state (after one step, so nothing is zero) -> port
    -> numpy is bit-identical, leaf by leaf, with the port's layout."""
    _tp, _jp, _ts, js, _ = _run_both(tables_dtype, "float32", sampled, 1)
    port = convert.sparse_opt_state_from_numpy(js, "cpu")
    back = convert.sparse_opt_state_to_numpy(port)
    assert set(port["rows"]) == set(js["rows"])
    assert port["rows"]["token_emb"].m.dtype == torch.float32
    assert port["count"].dtype == torch.int32 and port["count"].dim() == 0
    adam = js["dense"][0]
    ref = {"dense": {"count": adam.count, "mu": adam.mu, "nu": adam.nu},
           "rows": {k: {"m": s.m, "v": s.v} for k, s in js["rows"].items()},
           "count": js["count"]}
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_got, flat_ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path


def test_sampled_softmax_helpers_match_jax():
    """`_effective_num_tries` equal (float64 on the host), log expected
    counts within 1e-6 relative, and the sampler's ids unique, in range
    and int32 (its numbers differ: another generator)."""
    V, n = 1000, 50
    assert tss._effective_num_tries(n, V) == jss._effective_num_tries(n, V)
    ids = np.arange(V, dtype=np.int32)
    ref = np.asarray(jss._log_expected_count(jnp.asarray(ids), n, V))
    got = tss._log_expected_count(torch.from_numpy(ids), n, V).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert np.all(tss._log_expected_count(torch.from_numpy(ids), V, V)
                  .numpy() == 0)
    gen = torch.Generator().manual_seed(0)
    s = tss.log_uniform_sample(gen, n, V)
    assert s.dtype == torch.int32 and s.shape == (n,)
    assert len(set(s.tolist())) == n and 0 <= s.min() and s.max() < V
    assert torch.equal(tss.log_uniform_sample(gen, V + 1, V),
                       torch.arange(V, dtype=torch.int32))
    np.testing.assert_allclose(
        tss._log_uniform_log_probs(V).numpy(),
        np.asarray(jss._log_uniform_log_probs(V)), rtol=1e-6)


def test_make_draws_is_seeded_by_seed_and_step():
    """The trainer's own draws: the same (seed, step) gives the same mask,
    ids and salts; another step gives others. Keep rate and shapes are
    the step's."""
    dims = _dims(tenc, "int8")
    params = tenc.init_params(torch.Generator().manual_seed(0), dims)
    cfg = make_port_train_step(dims, AdamF32Moments(LR),
                               use_sampled_softmax=True, num_sampled=S,
                               sparse_updates=True).cfg
    assert cfg.learning_rate == LR
    a = make_draws(dims, cfg, params, 64, 239, 0, torch.device("cpu"))
    b = make_draws(dims, cfg, params, 64, 239, 0, torch.device("cpu"))
    c = make_draws(dims, cfg, params, 64, 239, 1, torch.device("cpu"))
    assert a.keep.shape == (64, C, 3 * E) and a.keep.dtype == torch.bool
    assert abs(a.keep.float().mean().item() - dims.dropout_keep_rate) < 0.02
    assert torch.equal(a.keep, b.keep) and torch.equal(a.sampled, b.sampled)
    assert a.salts == b.salts and set(a.salts) == {"path_emb", "token_emb"}
    assert not torch.equal(a.keep, c.keep) and a.salts != c.salts
    assert all(0 <= s < 2 ** 32 for s in a.salts.values())


def test_attention_pool_train_on_cpu_is_the_plain_pool():
    """On CPU tensors the training pool is the plain pool in the compute
    dtype, gradients included, and launches no kernel."""
    r = np.random.default_rng(8)
    ctx = torch.from_numpy(r.normal(size=(3, 5, 24)).astype(np.float32))
    tr = torch.from_numpy(r.normal(size=(24, 24)).astype(np.float32) * 0.2)
    at = torch.from_numpy(r.normal(size=(24,)).astype(np.float32))
    mask = torch.ones(3, 5)
    mask[0] = 0
    launches = attention_pool_fused.launches
    leaves = [x.clone().requires_grad_() for x in (ctx, tr, at)]
    code, attn = attention_pool_train(*leaves, mask)
    code.sum().backward()
    ref = [x.clone().requires_grad_() for x in (ctx, tr, at)]
    code_r, attn_r = attention_pool(*ref, mask)
    code_r.sum().backward()
    assert torch.equal(code, code_r) and torch.equal(attn, attn_r)
    for a, b in zip(leaves, ref):
        assert torch.equal(a.grad, b.grad)
    assert attention_pool_fused.launches == launches


@pytest.mark.cuda
def test_kernel_pool_backward_matches_plain_pool_on_the_card():
    """On the card the training pool's forward is the kernel and its
    backward the plain pool's VJP: gradients within 1e-4 of the plain
    pool's, float32 contexts (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    ctx = torch.randn(4, 200, 384, generator=gen, device="cuda")
    tr = torch.randn(384, 384, generator=gen, device="cuda") * 0.05
    at = torch.randn(384, generator=gen, device="cuda") * 0.1
    mask = (torch.rand(4, 200, generator=gen, device="cuda") > 0.3).float()
    launches = attention_pool_fused.launches
    k = [x.clone().requires_grad_() for x in (ctx, tr, at)]
    code_k, _ = attention_pool_train(*k, mask)
    code_k.square().sum().backward()
    p = [x.clone().requires_grad_() for x in (ctx, tr, at)]
    code_p, _ = attention_pool_train(*p, mask, use_kernel=False)
    code_p.square().sum().backward()
    torch.cuda.synchronize()
    assert attention_pool_fused.launches == launches + 1
    for a, b in zip(k, p):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-4)


# ---- the reader and the trainer ----

def _write_c2v(path, n, seed):
    with open(path, "w") as f:
        f.write("\n".join(make_raw_lines(n, seed=seed, max_ctx=C)) + "\n")


def _vocabs(tmp_path):
    V, T = jvocab.Vocab, jvocab.VocabType
    jv = jvocab.Code2VecVocabs(V(T.Token, TOKENS), V(T.Path, PATHS),
                               V(T.Target, TARGETS), num_training_examples=7)
    path = str(tmp_path / "vocab.pkl")
    jv.save(path)
    return jv, Code2VecVocabs.load(path)


def test_c2v_reader_matches_jax_reader(tmp_path):
    """The same file, batch size, seed and epochs give the same batches,
    padding and valid counts (the `(seed + epoch)` shuffle)."""
    jv, tv = _vocabs(tmp_path)
    path = str(tmp_path / "train.c2v")
    _write_c2v(path, 23, seed=1)
    jr = JReader(path, jv, C, 8, shuffle=True, seed=5)
    tr = C2VTextReader(path, tv, C, 8, shuffle=True, seed=5)
    for _epoch in range(2):
        jb, tb = list(jr), list(tr)
        assert len(jb) == len(tb) == 3
        for a, b in zip(jb, tb):
            assert a.num_valid_examples == b.num_valid_examples
            for x, y in zip(a[:5], b[:5]):
                assert x.dtype == y.dtype and np.array_equal(x, y)
    weights = tb[-1].host_arrays()[5]
    assert weights.tolist() == [1.0] * 7 + [0.0]


def _sparse_config(**kw):
    base = dict(MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E, TRAIN_BATCH_SIZE=16,
                USE_BF16=False, TABLES_DTYPE="float32", LEARNING_RATE=0.05,
                SPARSE_EMBEDDING_UPDATES=True, EMBEDDING_OPTIMIZER="adam",
                LR_SCHEDULE="constant", NUM_BATCHES_TO_LOG_PROGRESS=4)
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("tables,sampled", [("float32", False),
                                            ("int8", True)])
def test_trainer_loss_falls_on_a_tiny_c2v_file(tmp_path, tables, sampled,
                                               caplog):
    """The trainer on the CPU over a tiny `.c2v` file: 4 epochs of 2
    batches; the last epoch's mean loss is below the first's."""
    _jv, tv = _vocabs(tmp_path)
    path = str(tmp_path / "train.c2v")
    _write_c2v(path, 32, seed=2)
    cfg = _sparse_config(TABLES_DTYPE=tables, USE_SAMPLED_SOFTMAX=sampled,
                         NUM_SAMPLED_CLASSES=4)
    trainer = Code2VecTrainer(cfg, tv, device="cpu")
    assert trainer.device.type == "cpu"
    with caplog.at_level(logging.INFO, logger="code2vec_tpu_torch"):
        losses = trainer.train(path, epochs=4)
    assert len(losses) == 8 and trainer.step_num == 8
    assert all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
    assert any("step 4: loss" in m for m in caplog.messages)
    assert int(trainer.opt_state["count"]) == 8
    assert trainer.train(path, max_steps=1) and trainer.step_num == 9


_DENSE = {"SPARSE_EMBEDDING_UPDATES": False}


@pytest.mark.parametrize("change,error", [
    ({**_DENSE, "EMBEDDING_OPTIMIZER": "adafactor", "LR_SCHEDULE": "cosine"},
     None),
    ({**_DENSE, "LR_SCHEDULE": "cosine"}, None),
    ({**_DENSE, "ENCODER_TYPE": "transformer", "LR_SCHEDULE": "cosine"},
     None),
    ({"LR_SCHEDULE": "cosine"}, ValueError),
    ({"ENCODER_TYPE": "transformer"}, ValueError),
    ({"EMBEDDING_OPTIMIZER": "adafactor"}, ValueError),
    ({"NUM_SAMPLED_CLASSES": 0, "USE_SAMPLED_SOFTMAX": True}, ValueError),
    ({"TABLES_DTYPE": "float16"}, ValueError),
])
def test_trainer_refuses_unported_and_invalid_configs(tmp_path, change,
                                                      error):
    """The dense step trains (the JAX defaults: Adafactor and a cosine
    LR; Adam and a cosine LR; the transformer encoder with Adam), with
    the dense optimizer's state and the loss falling over two epochs of
    a tiny file. A sparse configuration
    the JAX package's `Config.verify` rejects (another optimizer,
    schedule or encoder) raises its ValueError. Nothing switches quietly
    to another path."""
    _jv, tv = _vocabs(tmp_path)
    if error is not None:
        with pytest.raises(error):
            Code2VecTrainer(_sparse_config(**change), tv, device="cpu")
        return
    path = str(tmp_path / "train.c2v")
    _write_c2v(path, 32, seed=4)
    trainer = Code2VecTrainer(_sparse_config(**change), tv, device="cpu")
    assert not isinstance(trainer.optimizer, AdamF32Moments)
    assert "opt_state" in vars(trainer) and "rows" not in trainer.opt_state
    losses = trainer.train(path, epochs=2)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert trainer.total_steps == 4
    assert np.mean(losses[-2:]) < np.mean(losses[:2])


@pytest.mark.parametrize("field", ["HEAD", "MESH_DATA_AXIS",
                                   "MESH_MODEL_AXIS"])
def test_config_cannot_ask_for_another_head_or_a_mesh(field):
    """HEAD takes the JAX package's two heads (code2vec, varmisuse), and
    `verify` refuses any other. The mesh the port has is the data axis
    alone: MESH_DATA_AXIS passes `verify` and must equal the world
    (parallel/mesh.make_mesh refuses a data axis the processes cannot
    fill), and a model axis above 1 is refused (ROADMAP.md Queue 1
    item 5)."""
    if field == "HEAD":
        with pytest.raises(ValueError, match="HEAD must be"):
            Config(HEAD="transformer").verify()
        return
    assert field in {f.name for f in dataclasses.fields(Config)}
    if field == "MESH_DATA_AXIS":
        Config(MESH_DATA_AXIS=2).verify()
        from code2vec_tpu_torch.parallel.mesh import make_mesh
        with pytest.raises(ValueError, match="the data axis needs 2 processes"):
            make_mesh(2, rank=0, world=1, device="cpu")
        return
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 5"):
        Config(**{field: 2}).verify()


def test_trainer_reads_no_batch_past_its_last_step(tmp_path, monkeypatch):
    """`train(max_steps=n)` parses exactly n batches, whatever the
    number of epochs asked for."""
    _jv, tv = _vocabs(tmp_path)
    path = str(tmp_path / "train.c2v")
    _write_c2v(path, 32, seed=3)
    parsed = []
    parse = C2VTextReader._parse_batch
    monkeypatch.setattr(C2VTextReader, "_parse_batch",
                        lambda self, lines: parsed.append(1) or parse(
                            self, lines))
    trainer = Code2VecTrainer(_sparse_config(), tv, device="cpu")
    assert len(trainer.train(path, max_steps=3, epochs=5)) == 3
    assert len(parsed) == 3
    assert len(trainer.train(path, max_steps=2)) == 2 and len(parsed) == 5


def test_default_config_is_the_unported_dense_step(tmp_path):
    """The port's Config keeps the JAX defaults, and they build the dense
    Adafactor step: Adafactor's factored state on the tables, Adam's on
    TRANSFORM / ATTENTION, each with its schedule count. Every schedule
    and both optimizers construct (a schedule needs its horizon)."""
    _jv, tv = _vocabs(tmp_path)
    cfg = Config()
    assert (cfg.SPARSE_EMBEDDING_UPDATES, cfg.EMBEDDING_OPTIMIZER,
            cfg.LR_SCHEDULE, cfg.TABLES_DTYPE, cfg.USE_SAMPLED_SOFTMAX) == \
        (False, "adafactor", "cosine", "bfloat16", False)
    trainer = Code2VecTrainer(dataclasses.replace(cfg, MAX_CONTEXTS=C,
                                                  DEFAULT_EMBEDDINGS_SIZE=E),
                              tv, device="cpu")
    state = trainer.opt_state
    assert set(state) == {"table", "small"}
    assert isinstance(state["table"][0], topt.FactoredState)
    assert isinstance(state["table"][2], topt.ScaleByScheduleState)
    assert isinstance(state["small"][0], topt.ScaleByAdamState)
    assert set(state["table"][0].v) == {"token_emb", "path_emb",
                                        "target_emb"}
    assert set(state["small"][0].mu) == {"transform", "attention"}
    assert state["table"][0].v["token_emb"].dtype == torch.bfloat16
    assert make_lr(LR) == LR
    for schedule in ("cosine", "linear", "warmup_cosine"):
        with pytest.raises(ValueError):
            make_lr(LR, schedule)
        lr = make_lr(LR, schedule, 100)
        assert 0 <= float(lr(torch.tensor(50, dtype=torch.int32))) <= LR
        for opt in ("adafactor", "adam"):
            assert isinstance(make_optimizer(lr, opt),
                              topt.GradientTransformation)

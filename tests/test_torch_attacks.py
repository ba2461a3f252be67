"""The port's attacks (code2vec_tpu_torch/attacks/: the gradient rename
attack, the lockstep batch, the robustness sweep, the rarity detector,
the source-level driver) against the JAX package's, on the CPU.

One JAX model is trained as tests/test_attacks.py trains it; its params
go into the port with `convert.py` and the port's predict-side model is
built on the same vocabularies. Both attacks then run on the same numpy
methods. The step functions are also held at a wider random model (300
tokens) with each encoder, table dtype and compute dtype.

Tolerances:
- float32 compute: the first-order scores within 1e-5 of max |score|
  (2^-7 with bf16 tables, whose gradient is rounded to bf16 — JAX's
  cotangent dtype — and summed in another order), the exact losses
  within 1e-6 (relative to max(1, |loss|)), top-1 equal;
- bf16 compute: scores within 2^-7 of max |score|, losses within 2^-7
  relative (the transformer: 3e-2, tests/test_torch_transformer.py's
  bf16 bound for its code vectors); top-1 is not compared at random
  weights, where near-equal logits are common;
- whole attacks, sweeps and detector scores: JAX's field for field (the
  steps' losses within 1e-6), the report but for `seconds`. A method
  where they differed would have to be a first-order or exact-loss tie
  within the tolerances above; on these fixtures none differs, and the
  test says so by comparing every field.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.attacks import detect as jdetect
from code2vec_tpu.attacks import gradient_attack as jga
from code2vec_tpu.attacks import robustness as jrob
from code2vec_tpu.attacks import source_attack as jsrc
from code2vec_tpu.data.reader import parse_c2v_rows as jparse
from code2vec_tpu.models import encoder as jenc
from code2vec_tpu.models.jax_model import Code2VecModel as JaxModel
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.attacks import detect as tdetect
from code2vec_tpu_torch.attacks import gradient_attack as tga
from code2vec_tpu_torch.attacks import robustness as trob
from code2vec_tpu_torch.attacks import source_attack as tsrc
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.models.torch_model import (Code2VecModel,
                                                  Code2VecTrainer)
from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
from helpers import build_tiny_dataset
from test_model import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_SCORE, F32_LOSS = 1e-5, 1e-6
BF16 = 2.0 ** -7
XF_BF16 = 3e-2


def port_model(jmodel, vocab_path, **cfg) -> Code2VecModel:
    """The port's predict-side model on the JAX model's params, dims and
    vocabularies, on the CPU."""
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(jmodel.params))
    tcfg = Config(MAX_CONTEXTS=jmodel.dims.max_contexts,
                  DEFAULT_EMBEDDINGS_SIZE=jmodel.dims.embeddings_size,
                  TABLES_DTYPE=jmodel.dims.tables_dtype,
                  USE_BF16=jmodel.compute_dtype == jnp.bfloat16, **cfg)
    return Code2VecModel(tcfg, tenc.ModelDims(**dataclasses.asdict(
        jmodel.dims)), Code2VecVocabs.load(vocab_path),
        convert.params_from_numpy(host, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """tests/test_attacks.py's fixture model, and the port's on it."""
    d = tmp_path_factory.mktemp("torch_attack_data")
    prefix = build_tiny_dataset(str(d), n_train=256, n_val=32, n_test=64,
                                max_contexts=16)
    cfg = tiny_config(prefix)
    jmodel = JaxModel(cfg)
    jmodel.train()
    vocab_path = str(d / "vocab.pkl")
    jmodel.vocabs.save(vocab_path)
    return cfg, jmodel, port_model(jmodel, vocab_path), prefix


def _methods(jmodel, prefix, n):
    with open(prefix + ".test.c2v", encoding="utf-8") as f:
        lines = [ln for ln in f if ln.strip()][:n]
    labels, src, pth, dst, mask, _, _ = jparse(
        lines, jmodel.vocabs, jmodel.dims.max_contexts)
    return labels, [(src[i], pth[i], dst[i], mask[i])
                    for i in range(len(lines))]


def _attacks(jmodel, tmodel, **kw):
    ja = jga.GradientRenameAttack(
        jmodel.dims, jmodel.vocabs.token_vocab, jmodel.vocabs.target_vocab,
        compute_dtype=jmodel.compute_dtype, **kw)
    ta = tga.GradientRenameAttack(
        tmodel.dims, tmodel.vocabs.token_vocab, tmodel.vocabs.target_vocab,
        compute_dtype=tmodel.compute_dtype, device="cpu", **kw)
    return ja, ta


def assert_same_result(got, want):
    """An AttackResult of the port equal to the JAX one, field for field
    (the accepted steps' losses within F32_LOSS)."""
    for field in ("success", "targeted", "original_prediction",
                  "final_prediction", "target_name", "renames",
                  "iterations"):
        assert getattr(got, field) == getattr(want, field), field
    assert len(got.steps) == len(want.steps)
    for g, w in zip(got.steps, want.steps):
        assert (g.from_token, g.to_token) == (w.from_token, w.to_token)
        for a, b in ((g.loss_before, w.loss_before),
                     (g.loss_after, w.loss_after)):
            assert abs(a - b) <= F32_LOSS * max(1.0, abs(b)), (a, b)
    for g, w in zip(got.final_method, want.final_method):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---- the host helpers, copied as they are ----

@pytest.mark.parametrize("word", [
    "array|index", "foo", "get|html|body", "<PAD>", "a|2b", "while", "int",
    "string", "self", "match|result", "x|y|z", ""])
def test_render_identifier_matches_jax(word):
    assert tga.render_identifier(word) == jga.render_identifier(word)


def test_keyword_sets_match_jax():
    assert tga.JAVA_KEYWORDS == jga.JAVA_KEYWORDS
    assert tga.PYTHON_KEYWORDS == jga.PYTHON_KEYWORDS
    assert tga.RESERVED_WORDS == jga.RESERVED_WORDS


def test_host_helpers_match_jax(trained):
    _, jmodel, _, _ = trained
    tv = jmodel.vocabs.token_vocab
    for rows in (tv.size, tv.size + 5):
        np.testing.assert_array_equal(tga.candidate_mask(tv, rows),
                                      jga.candidate_mask(tv, rows))
    r = np.random.default_rng(0)
    a, b = r.integers(0, 40, 30), r.integers(0, 40, 30)
    assert tga.spare_row(64, a, b) == jga.spare_row(64, a, b)
    for t, p, lab, o in ((True, 3, 3, 1), (True, 2, 3, 2), (False, 3, 3, 3),
                         (False, 4, 3, 3)):
        assert tga.attack_succeeded(t, p, lab, o) \
            == jga.attack_succeeded(t, p, lab, o)
    legal = r.random(200) < 0.7
    scores = r.normal(size=200).astype(np.float32)
    tried = {3, 5, 7}
    got = tga.build_shortlist(scores.copy(), legal, set(tried), 16, 9)
    want = jga.build_shortlist(scores.copy(), legal, set(tried), 16, 9)
    assert sorted(got[:-1]) == sorted(want[:-1]) and got[-1] == want[-1]
    s = scores.copy()
    s[[1, 2]] = np.inf
    short = np.array([1, 4, 2, 9], np.int32)
    losses = np.array([0.5, 0.1, 0.2, 0.3], np.float32)
    np.testing.assert_array_equal(
        tga.guard_leaked(losses.copy(), s, short),
        jga.guard_leaked(losses.copy(), s, short))


# ---- the step functions at a wider random model ----

def _random_world(encoder, tables, compute):
    dims = jenc.ModelDims(token_vocab_size=300, path_vocab_size=200,
                          target_vocab_size=150, embeddings_size=16,
                          max_contexts=16, tables_dtype=tables,
                          encoder_type=encoder, xf_layers=1, xf_heads=2)
    jparams = jenc.init_params(jax.random.PRNGKey(3), dims)
    host = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = convert.params_from_numpy(host, device="cpu")
    tdims = tenc.ModelDims(**dataclasses.asdict(dims))
    jdt = jnp.bfloat16 if compute == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if compute == "bfloat16" else torch.float32
    return dims, jparams, jdt, tdims, tparams, tdt


def _random_method(r, dims, n_valid=12, n_occ=4):
    C = dims.max_contexts
    src = r.integers(2, dims.token_vocab_size, C).astype(np.int32)
    dst = r.integers(2, dims.token_vocab_size, C).astype(np.int32)
    pth = r.integers(2, dims.path_vocab_size, C).astype(np.int32)
    tok = int(r.integers(2, dims.token_vocab_size))
    src[r.choice(C, n_occ, replace=False)] = tok
    dst[r.choice(C, n_occ // 2, replace=False)] = tok
    mask = np.zeros(C, np.float32)
    mask[:n_valid] = 1.0
    return (src, pth, dst, mask), tok


@pytest.mark.parametrize("encoder,tables,compute", [
    ("bag", "float32", "float32"), ("bag", "bfloat16", "float32"),
    ("bag", "bfloat16", "bfloat16"), ("transformer", "float32", "float32"),
    ("transformer", "float32", "bfloat16")])
def test_step_functions_match_jax(encoder, tables, compute):
    """score_fn / eval_fn / predict_fn (and their batched forms at M = 3)
    on the same methods: scores within 1e-5 of max |score| (float32
    compute) or 2^-7 (bf16), losses within 1e-6 (relative to max(1,
    |loss|)) or 2^-7 relative, top-1 equal (bf16: where the reference's
    loss gap between it and the runner-up exceeds 2^-7)."""
    dims, jparams, jdt, tdims, tparams, tdt = _random_world(
        encoder, tables, compute)
    j_score, j_eval, j_pred = jga.make_attack_steps(dims, compute_dtype=jdt)
    t_score, t_eval, t_pred = tga.make_attack_steps(tdims,
                                                    compute_dtype=tdt)
    # a bf16 table's gradient is rounded to bf16 (the JAX cotangent's
    # dtype; the port's CPU scatter adds in bf16, XLA's in float32)
    score_tol = F32_SCORE if (tables, compute) == ("float32",
                                                   "float32") else BF16
    loss_tol = F32_LOSS if compute == "float32" else BF16
    if (encoder, compute) == ("transformer", "bfloat16"):
        # tests/test_torch_transformer.py's bf16 bound: activations
        # rounded at every product, GELU's tanh in bf16 on the JAX side
        score_tol = loss_tol = XF_BF16
    r = np.random.default_rng(5)
    rows = dims.padded(dims.token_vocab_size)
    for trial in range(3):
        method, tok = _random_method(r, dims, n_valid=10 + trial)
        src, pth, dst, mask = method
        occ = (src == tok, dst == tok)
        label = int(r.integers(2, dims.target_vocab_size))
        jids = tuple(jnp.asarray(a) for a in method)
        tids = tuple(torch.from_numpy(a) for a in method)
        tocc = tuple(torch.from_numpy(o) for o in occ)
        spare = tga.spare_row(rows, src, dst)
        for sign in (1.0, -1.0):
            want = np.asarray(j_score(jparams, jids, tuple(
                jnp.asarray(o) for o in occ), jnp.int32(spare),
                jnp.int32(label), sign))
            got = t_score(tparams, tids, tocc, label, sign).numpy()
            np.testing.assert_allclose(
                got, want, rtol=0, atol=score_tol * np.abs(want).max())
        cand = r.choice(np.arange(2, dims.token_vocab_size), 8,
                        replace=False).astype(np.int32)
        jl, jt = j_eval(jparams, jids, tuple(jnp.asarray(o) for o in occ),
                        jnp.asarray(cand), jnp.int32(label))
        tl, tt = t_eval(tparams, tids, tocc, torch.from_numpy(cand), label)
        jl, jt = np.asarray(jl), np.asarray(jt)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=loss_tol,
                                   atol=loss_tol)
        if compute == "float32":
            np.testing.assert_array_equal(tt.numpy(), jt)
        assert int(t_pred(tparams, tids)) == int(j_pred(jparams, jids)) \
            or compute == "bfloat16"
    # the batched steps: each method's row as the serial step gives it
    methods = [_random_method(r, dims) for _ in range(3)]
    src = np.stack([m[0][0] for m in methods])
    pth = np.stack([m[0][1] for m in methods])
    dst = np.stack([m[0][2] for m in methods])
    mask = np.stack([m[0][3] for m in methods])
    toks = np.array([m[1] for m in methods])
    occ = (src == toks[:, None], dst == toks[:, None])
    labels = torch.tensor([3, 4, 5])
    b_score, b_eval, b_pred = tga.make_batched_attack_steps(
        tdims, compute_dtype=tdt)
    tids = tuple(torch.from_numpy(a) for a in (src, pth, dst, mask))
    tocc = tuple(torch.from_numpy(o) for o in occ)
    got = b_score(tparams, tids, tocc, labels, -1.0).numpy()
    cand = np.stack([r.choice(np.arange(2, 300), 8, replace=False)
                     for _ in range(3)]).astype(np.int32)
    bl, _ = b_eval(tparams, tids, tocc, torch.from_numpy(cand), labels)
    for i in range(3):
        one = tuple(t[i] for t in tids)
        o1 = tuple(o[i] for o in tocc)
        want = t_score(tparams, one, o1, int(labels[i]), -1.0).numpy()
        np.testing.assert_allclose(got[i], want, rtol=0,
                                   atol=score_tol * np.abs(want).max())
        wl, _ = t_eval(tparams, one, o1, torch.from_numpy(cand[i]),
                       int(labels[i]))
        np.testing.assert_allclose(bl[i].numpy(), wl.numpy(),
                                   rtol=loss_tol, atol=loss_tol)
    assert b_pred(tparams, tids).shape == (3,)


def test_device_top_list_is_jax_top_k():
    """The batch path's top-T (`top_scores`, through topk_stable) is
    `jax.lax.top_k(-where(legal, s, inf), T)`: the same ids in the same
    order, exact ties and infinities included."""
    r = np.random.default_rng(1)
    s = r.normal(size=(4, 500)).astype(np.float32)
    s[:, 10:20] = s[:, 30:40]        # exact ties at distinct ids
    s[0, 50:60] = 0.0
    legal = r.random(500) < 0.8
    neg, want = jax.lax.top_k(-jnp.where(jnp.asarray(legal), s, jnp.inf),
                              120)
    vals, got = tga.top_scores(torch.from_numpy(s), torch.from_numpy(legal),
                               120)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))


# ---- whole attacks on the fixture model ----

@pytest.mark.parametrize("kw", [
    dict(targeted=False, max_renames=1), dict(targeted=False, max_renames=2),
    dict(targeted=True, max_renames=1), dict(targeted=True, max_renames=2)],
    ids=["untargeted", "untargeted-2", "targeted", "targeted-2"])
def test_attack_method_matches_jax(trained, kw):
    """attack_method on every fixture method gives JAX's AttackResult;
    targeted runs aim each method at a class other than its truth."""
    _, jmodel, tmodel, prefix = trained
    ja, ta = _attacks(jmodel, tmodel, max_iters=6 if kw["targeted"] else 4,
                      top_k_candidates=48 if kw["targeted"] else 32)
    labels, methods = _methods(jmodel, prefix, 12)
    tv = jmodel.vocabs.target_vocab
    n = 0
    for lbl, m in zip(labels, methods):
        extra = {}
        if kw["targeted"]:
            other = [w for w in tv.to_word_list()[2:]
                     if tv.lookup_index(w) != int(lbl)]
            extra["target_name"] = other[n % len(other)]
        want = ja.attack_method(jmodel.params, m, **kw, **extra)
        got = ta.attack_method(tmodel.params, m, **kw, **extra)
        assert_same_result(got, want)
        n += 1
    assert n == 12


def test_attack_batch_matches_jax_and_the_serial_path(trained):
    _, jmodel, tmodel, prefix = trained
    ja, ta = _attacks(jmodel, tmodel, max_iters=4)
    _, methods = _methods(jmodel, prefix, 24)
    eligible = [m for m in methods
                if ta.attackable_tokens(m[0], m[2], m[3])]
    want = ja.attack_batch(jmodel.params, eligible)
    got = ta.attack_batch(tmodel.params, eligible)
    serial = [ta.attack_method(tmodel.params, m, targeted=False,
                               max_renames=1) for m in eligible]
    assert len(got) == len(want) == len(eligible) > 10
    for g, w, s in zip(got, want, serial):
        assert_same_result(g, w)
        assert (g.success, g.renames, g.final_prediction, g.iterations) \
            == (s.success, s.renames, s.final_prediction, s.iterations)


def test_attack_errors_match_jax(trained):
    _, jmodel, tmodel, prefix = trained
    ja, ta = _attacks(jmodel, tmodel, max_iters=2)
    _, methods = _methods(jmodel, prefix, 2)
    m = methods[0]
    dead = (m[0], m[1], m[2], np.zeros_like(m[3]))
    for attack, params in ((ja, jmodel.params), (ta, tmodel.params)):
        with pytest.raises(ValueError, match="no attackable tokens"):
            attack.attack_batch(params, [methods[1], dead])
        with pytest.raises(ValueError, match="out of vocabulary"):
            attack.attack_method(params, m, targeted=True,
                                 target_name="no|such|name")
        with pytest.raises(ValueError, match="needs a target name"):
            attack.attack_method(params, m, targeted=True)


def test_bf16_compute_attack_agrees_with_jax(trained, tmp_path):
    """The fixture model at bf16 compute: every method's first-order
    scores within 2^-4 of max |score| of JAX's, the exact losses within
    2^-7 relative, and the untargeted attack's outcome JAX's where the
    two largest exact losses over the vocabulary lie more than twice
    that apart (the rename the attack accepts first).

    2^-4, not the random model's 2^-7: the trained model is confident
    (clean losses ~1e-4), so the gradient's scale is 1 - p of the label,
    and the port rounds the bf16 logits to bf16 before the softmax
    (`encoder.logits_vs_table`) where the JAX package's jitted steps
    keep them in float32 (XLA folds the cast into the product): the
    scores differ by a common factor of 1.03-1.04 here (ROADMAP.md
    Queue 3)."""
    _, jmodel, _, prefix = trained
    jmodel_bf = JaxModel(tiny_config(prefix, USE_BF16=True))
    jmodel_bf.params = jmodel.params
    vocab_path = str(tmp_path / "vocab.pkl")
    jmodel.vocabs.save(vocab_path)
    tmodel = port_model(jmodel_bf, vocab_path)
    assert tmodel.compute_dtype == torch.bfloat16
    # the JAX attack pools with the plain pool in the compute dtype (no
    # use_pallas); the port's counterpart is use_kernel=False (the
    # kernel's plain version pools in float32, as the kernel does)
    ja = jga.GradientRenameAttack(
        jmodel_bf.dims, jmodel.vocabs.token_vocab,
        jmodel.vocabs.target_vocab, compute_dtype=jnp.bfloat16, max_iters=4)
    ta = tga.GradientRenameAttack(
        tmodel.dims, tmodel.vocabs.token_vocab, tmodel.vocabs.target_vocab,
        compute_dtype=torch.bfloat16, max_iters=4, device="cpu",
        use_kernel=False)
    _, methods = _methods(jmodel, prefix, 12)
    rows = jmodel.dims.padded(jmodel.dims.token_vocab_size)
    decided = 0
    for m in methods:
        toks = ta.attackable_tokens(m[0], m[2], m[3])
        if not toks:
            continue
        tok = toks[0][0]
        occ = (m[0] == tok, m[2] == tok)
        jids = tuple(jnp.asarray(a) for a in m)
        tids = ta.tensors(m)
        label = int(ja.predict_fn(jmodel_bf.params, jids))
        want = np.asarray(ja.score_fn(
            jmodel_bf.params, jids, tuple(jnp.asarray(o) for o in occ),
            jnp.int32(tga.spare_row(rows, m[0], m[2])), jnp.int32(label),
            -1.0))
        got = ta.score_fn(tmodel.params, tids, ta.tensors(occ), label,
                          -1.0).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.0 ** -4 * np.abs(want).max())
        cand = np.arange(2, jmodel.vocabs.token_vocab.size, dtype=np.int32)
        jl, _ = ja.eval_fn(jmodel_bf.params, jids, tuple(
            jnp.asarray(o) for o in occ), jnp.asarray(cand),
            jnp.int32(label))
        tl, _ = ta.eval_fn(tmodel.params, tids, ta.tensors(occ),
                           ta.tensor(cand), label)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=BF16, atol=BF16)
        top2 = np.sort(jl)[-2:]
        if top2[1] - top2[0] > 2 * BF16 * (1.0 + top2[1]):
            want_r = ja.attack_method(jmodel_bf.params, m, targeted=False)
            got_r = ta.attack_method(tmodel.params, m, targeted=False)
            assert (got_r.success, got_r.renames, got_r.final_prediction) \
                == (want_r.success, want_r.renames,
                    want_r.final_prediction)
            decided += 1
    assert decided >= 1


# ---- the sweep and the detector ----

def _same_report(got, want):
    got, want = dict(got), dict(want)
    got.pop("seconds"), want.pop("seconds")
    assert got == want


@pytest.mark.parametrize("max_renames", [1, 2])
def test_robustness_report_matches_jax(trained, max_renames):
    _, jmodel, tmodel, prefix = trained
    kw = dict(n_methods=24, max_renames=max_renames, max_iters=3,
              log=lambda *_: None)
    want = jrob.evaluate_robustness(jmodel, prefix + ".test.c2v", **kw)
    got = trob.evaluate_robustness(tmodel, prefix + ".test.c2v", **kw)
    assert got["n_methods"] > 0
    _same_report(got, want)


def test_robustness_report_with_detector_matches_jax(trained):
    _, jmodel, tmodel, prefix = trained
    jdet = jdetect.RarityDetector.from_model(jmodel, prefix + ".dict.c2v")
    tdet = tdetect.RarityDetector.from_model(tmodel, prefix + ".dict.c2v")
    np.testing.assert_array_equal(tdet.rarity, jdet.rarity)
    np.testing.assert_array_equal(tdet.counts, jdet.counts)
    kw = dict(n_methods=64, max_renames=1, max_iters=4, log=lambda *_: None)
    want = jrob.evaluate_robustness(jmodel, prefix + ".test.c2v",
                                    detector=jdet, **kw)
    got = trob.evaluate_robustness(tmodel, prefix + ".test.c2v",
                                   detector=tdet, **kw)
    assert "detection_auc" in got
    _same_report(got, want)


def test_rarity_scores_and_auc_match_jax(trained):
    """score_batch over 70 methods (a full chunk of 64 and a padded
    tail), score of one, calibrate and auc: JAX's within 1e-6 of max
    |score| (float32 compute)."""
    _, jmodel, tmodel, prefix = trained
    jdet = jdetect.RarityDetector.from_model(jmodel, prefix + ".dict.c2v")
    tdet = tdetect.RarityDetector.from_model(tmodel, prefix + ".dict.c2v")
    _, methods = _methods(jmodel, prefix, 64)
    methods = methods + methods[:6]
    want = jdet.score_batch(jmodel.params, methods)
    got = tdet.score_batch(tmodel.params, methods)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert abs(tdet.score(tmodel.params, methods[3])
               - jdet.score(jmodel.params, methods[3])) <= 1e-6 * max(
                   1.0, abs(want[3]))
    assert tdet.calibrate(want) == jdet.calibrate(want)
    r = np.random.default_rng(2)
    clean, attacked = r.normal(size=50), r.normal(0.5, size=40)
    attacked[:5] = clean[:5]  # ties
    assert tdetect.auc(clean, attacked) == jdetect.auc(clean, attacked)
    assert np.isnan(tdetect.auc([], attacked))


def test_freq_stats_match_jax(trained):
    _, jmodel, _, prefix = trained
    det = jdetect.RarityDetector.from_model(jmodel, prefix + ".dict.c2v")
    tv = jmodel.vocabs.token_vocab
    words = tv.to_word_list()[2:] + ["no|such|word", "<OOV>"]
    assert trob._freq_stats(words, det.counts, tv) \
        == jrob._freq_stats(words, det.counts, tv)
    assert trob._freq_stats([], det.counts, tv) \
        == jrob._freq_stats([], det.counts, tv)


# ---- the source driver's scanners and rewriters ----

JAVA_SNIPPETS = [
    "int f(int value, String name) { int count = value + 1; return count; }",
    "void g() { // int fake;\n int real = 1; String s = \"int ghost = 2;\"; }",
    "int h(List<String> items, int[] arr) { for (int i : arr) { items"
    ".add(i); } return items.size(); }",
    "String t() { String x = \"\"\"\n  a \"quoted\" int y;\n\"\"\"; "
    "int z = 0; return x; }",
    "char c() { char q = '\\''; /* int no; */ return q; }",
    "boolean check() { return index > 0; } void run() { if (check()) { "
    "run(); } } void check(int a) { int b; }",
]
PY_SNIPPETS = [
    "def foo(value, count):\n    total = value + count\n    return total\n",
    "def f(x, *args, key=None, **kw):\n    global g\n    g = x\n"
    "    for i in args:\n        y = i\n    return fetch(timeout=x)\n",
    "def h(a):\n    try:\n        b = a\n    except E as err:\n        pass\n"
    "    import os.path\n    with open(a) as fh:\n"
    "        z = [q for q in fh]\n    return b\n",
    "def broken(:\n",
]


@pytest.mark.parametrize("source", JAVA_SNIPPETS)
def test_java_scanners_and_rewriters_match_jax(source):
    assert tsrc.code_char_mask(source) == jsrc.code_char_mask(source)
    assert tsrc.mask_non_code(source) == jsrc.mask_non_code(source)
    assert tsrc.declared_variables(source) == jsrc.declared_variables(source)
    idents = set(tsrc._IDENT_RE.findall(source))
    for ident in sorted(idents):
        word = tsrc.normalize_identifier(ident)
        assert word == jsrc.normalize_identifier(ident)
        for decl in (True, False):
            assert tsrc.identifiers_for_token(source, word, decl) \
                == jsrc.identifiers_for_token(source, word, decl)
        assert tsrc.rename_in_source(source, ident, "renamed") \
            == jsrc.rename_in_source(source, ident, "renamed")
        for ordinal in (0, 1):
            assert tsrc.insert_dead_declaration(source, word, "dead",
                                                ordinal) \
                == jsrc.insert_dead_declaration(source, word, "dead",
                                                ordinal)


@pytest.mark.parametrize("source", PY_SNIPPETS)
def test_python_scanners_and_rewriters_match_jax(source):
    assert tsrc.declared_variables_python(source) \
        == jsrc.declared_variables_python(source)
    for lang in ("python", "java"):
        assert tsrc.declared_for(source, lang) == jsrc.declared_for(
            source, lang)
    for ident in sorted(set(tsrc._IDENT_RE.findall(source))):
        assert tsrc.rename_in_source_python(source, ident, "nu") \
            == jsrc.rename_in_source_python(source, ident, "nu")
        word = tsrc.normalize_identifier(ident)
        assert tsrc.identifiers_for_token(source, word, True, "python") \
            == jsrc.identifiers_for_token(source, word, True, "python")


@pytest.mark.parametrize("name", ["sortArray", "sort|array", None, "",
                                  "get_HTML2body"])
def test_normalize_target_name_matches_jax(name):
    assert tsrc.normalize_target_name(name) \
        == jsrc.normalize_target_name(name)


# ---- the source driver end to end, through the port's extractor ----

JAVA_VICTIM = """class Victim {
    int sumAll(int value, int count) {
        int index = value + count;
        // the index is the answer
        return index + value;
    }
    boolean isEmpty(int count) {
        int value = count;
        return value == 0;
    }
}
"""
PY_VICTIM = ("def sum_all(value, count):\n    index = value + count\n"
             "    return index + value\n\n"
             "def is_empty(count):\n    value = count\n"
             "    return value == 0\n")


@pytest.fixture(scope="module")
def source_world(trained, tmp_path_factory):
    """Both SourceAttacks on one extractor binary (the port's, named by
    C2V_EXTRACTOR), a Java and a Python victim whose identifiers are in
    the fixture vocabulary."""
    try:
        _build.cxx_path()
    except _build.KernelBuildError as e:
        pytest.skip(f"no host C++ compiler to build the native extractor "
                    f"({e})")
    from code2vec_tpu_torch.extractor import native
    d = tmp_path_factory.mktemp("source_attack")
    (d / "Victim.java").write_text(JAVA_VICTIM)
    (d / "victim.py").write_text(PY_VICTIM)
    return d, native.binary_path()


@pytest.mark.parametrize("victim,kw", [
    ("Victim.java", dict()), ("Victim.java", dict(max_renames=2)),
    ("Victim.java", dict(deadcode=True)),
    ("Victim.java", dict(method_index=1, targeted=True,
                         target_name="set|name")),
    ("victim.py", dict()), ("victim.py", dict(method_index=1))],
    ids=["java-rename", "java-rename-2", "java-deadcode", "java-targeted",
         "py-rename", "py-rename-1"])
def test_source_attack_matches_jax(trained, source_world, monkeypatch, victim,
                                   kw):
    """SourceAttack.attack_file on the same file: JAX's renames,
    adversarial source, verified prediction and trajectory."""
    cfg, jmodel, tmodel, _ = trained
    d, binary = source_world
    monkeypatch.setenv("C2V_EXTRACTOR", binary)
    path = str(d / victim)
    tv = jmodel.vocabs.target_vocab
    if kw.get("targeted"):
        assert tv.lookup_index(kw["target_name"]) != tv.oov_index
    want = jsrc.SourceAttack(cfg, jmodel).attack_file(path, **kw)
    got = tsrc.SourceAttack(tmodel.config, tmodel).attack_file(path, **kw)
    assert got.renames == want.renames
    assert got.adversarial_source == want.adversarial_source
    assert got.verified_prediction == want.verified_prediction
    assert got.verified_success == want.verified_success
    assert_same_result(got.attack, want.attack)
    assert str(got) == str(want)


def test_source_attack_refuses_what_jax_refuses(trained, source_world,
                                                monkeypatch):
    cfg, jmodel, tmodel, _ = trained
    d, binary = source_world
    monkeypatch.setenv("C2V_EXTRACTOR", binary)
    for path, kw, msg in ((d / "victim.py", dict(deadcode=True),
                           "Java sources only"),
                          (d / "Victim.java", dict(method_index=9),
                           "asked for #9")):
        for attack in (jsrc.SourceAttack(cfg, jmodel),
                       tsrc.SourceAttack(tmodel.config, tmodel)):
            with pytest.raises(ValueError, match=msg):
                attack.attack_file(str(path), **kw)


# ---- the module CLI and the card default ----

def test_attack_entry_points_default_to_the_card(trained, monkeypatch,
                                                 capsys):
    """`device=None` is the card: without one the attacks raise, and the
    sweeps' module CLIs exit 2, as cli.main does."""
    _, _, tmodel, prefix = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tga.GradientRenameAttack(tmodel.dims, tmodel.vocabs.token_vocab,
                                 tmodel.vocabs.target_vocab)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdetect.RarityDetector(tmodel.dims, tmodel.vocabs.token_vocab, {})
    from code2vec_tpu_torch.attacks import vm_robustness
    for main in (trob.main, vm_robustness.main):
        assert main(["--load", "x", "--test", prefix + ".test.c2v"]) == 2
        assert "CUDA" in capsys.readouterr().err


def test_robustness_cli_runs_on_a_port_checkpoint(trained, tmp_path, capsys):
    """`python -m code2vec_tpu_torch.attacks.robustness --backend cpu`
    over a checkpoint the port's command line saved: one JSON line, the
    report of evaluate_robustness on the loaded model."""
    import json

    from code2vec_tpu_torch import cli
    _, _, _, prefix = trained
    ckpt = str(tmp_path / "ckpt")
    assert cli.main(["--data", prefix, "--save", ckpt, "--epochs", "2",
                     "--batch_size", "32", "--max_contexts", "16",
                     "--backend", "cpu", "--no_bf16"]) == 0
    capsys.readouterr()
    out = str(tmp_path / "r.json")
    assert trob.main(["--load", ckpt, "--test", prefix + ".test.c2v",
                      "--n", "16", "--dict", prefix + ".dict.c2v",
                      "--out", out, "--backend", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    report = json.loads(line)
    assert report == json.loads(open(out).read())
    assert report["n_methods"] > 0
    assert report["robustness"] == pytest.approx(
        1.0 - report["attack_success_rate"], abs=1e-6)
    _, model = trob.load_predictor(ckpt, "cpu")
    again = trob.evaluate_robustness(model, prefix + ".test.c2v",
                                     n_methods=16, log=lambda *_: None)
    for k in ("n_methods", "attack_success_rate", "clean_top1_acc"):
        assert again[k] == report[k]


# ---- the command line's --attack ----

@pytest.fixture(scope="module")
def cli_world(trained, source_world, tmp_path_factory):
    """A checkpoint the port's command line trained on the fixture data,
    float32 tables and compute."""
    from code2vec_tpu_torch import cli
    _, _, _, prefix = trained
    ckpt = str(tmp_path_factory.mktemp("attack_cli") / "ckpt")
    assert cli.main(["--data", prefix, "--save", ckpt, "--epochs", "3",
                     "--batch_size", "32", "--max_contexts", "16",
                     "--backend", "cpu", "--no_bf16", "--tables_dtype",
                     "float32"]) == 0
    return ckpt


@pytest.mark.parametrize("flags", [
    [], ["--attack_deadcode"], ["--attack_max_renames", "2"],
    ["--attack_method_index", "1", "--attack_iters", "2", "--attack_topk",
     "4"]], ids=["rename", "deadcode", "renames-2", "knobs"])
def test_cli_attack_prints_the_verified_outcome(cli_world, source_world,
                                                trained, tmp_path,
                                                monkeypatch, capsys, flags):
    """`--load <ckpt> --attack untargeted --attack_input <file>` exits 0
    and prints SourceAttack's outcome on the loaded model; the
    `.adversarial` file exists exactly when the outcome is a verified
    success, and holds the adversarial source."""
    from code2vec_tpu_torch import cli
    d, binary = source_world
    monkeypatch.setenv("C2V_EXTRACTOR", binary)
    victim = str(tmp_path / "Victim.java")
    shutil.copy(d / "Victim.java", victim)
    argv = ["--load", cli_world, "--backend", "cpu", "--no_bf16",
            "--attack", "untargeted", "--attack_input", victim, *flags]
    capsys.readouterr()
    assert cli.main(argv) == 0
    out = capsys.readouterr().out.strip()
    cfg = Config.load_from_args(argv)
    # the checkpoint's dims adopted into cfg (MAX_CONTEXTS), as cli.main
    # adopts them
    model = Code2VecTrainer.from_config(cfg, device="cpu").predictor()
    want = tsrc.SourceAttack(cfg, model, top_k_candidates=cfg.ATTACK_TOPK,
                             max_iters=cfg.ATTACK_ITERS).attack_file(
        victim, method_index=cfg.ATTACK_METHOD_INDEX,
        max_renames=cfg.ATTACK_MAX_RENAMES, deadcode=cfg.ATTACK_DEADCODE)
    assert out.endswith(str(want))
    adv = victim + ".adversarial"
    assert os.path.exists(adv) == bool(want.verified_success)
    if want.verified_success:
        assert open(adv).read() == want.adversarial_source


def test_cli_targeted_attack_and_its_refusals(cli_world, source_world,
                                              tmp_path, monkeypatch, capsys):
    """`--attack targeted --attack_target <camelCase>` aims at the
    normalized name; an out-of-vocabulary target, int8 tables and a
    missing --load exit 2 with the JAX package's messages."""
    from code2vec_tpu_torch import cli
    d, binary = source_world
    monkeypatch.setenv("C2V_EXTRACTOR", binary)
    victim = str(tmp_path / "Victim.java")
    shutil.copy(d / "Victim.java", victim)
    base = ["--load", cli_world, "--backend", "cpu", "--no_bf16",
            "--attack_input", victim]
    capsys.readouterr()
    assert cli.main([*base, "--attack", "targeted", "--attack_target",
                     "setName"]) == 0
    out = capsys.readouterr().out
    assert "[targeted " in out and "(target 'set|name')" in out
    for argv, msg in (
            ([*base, "--attack", "targeted", "--attack_target", "noSuch"],
             "target name 'no|such' is out of vocabulary"),
            ([*base, "--attack", "untargeted", "--tables_dtype", "int8"],
             "--attack needs float/bf16 tables"),
            (["--data", "p", "--backend", "cpu", "--attack", "untargeted"],
             "--attack requires --load.")):
        assert cli.main(argv) == 2
        assert msg in capsys.readouterr().err
    assert not os.path.exists(victim + ".adversarial.tmp")

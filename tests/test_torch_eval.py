"""The port's evaluation against the JAX package's: the eval step
(`make_eval_step`), the metric accumulator and subtoken helpers
(`MetricAccumulator`, `common.py`), and `Code2VecTrainer.evaluate` over a
`.c2v` file; and the default configuration training on the CPU.

Weights come from JAX `init_params` and are carried over bit for bit;
batches are numpy from a seed, or the same file read by both packages'
readers.

Tolerances, each test repeating its own:
- float32 compute: loss_sum within 1e-5 relative, top-k probabilities
  within 1e-5 (the predict step's bar);
- bf16 compute: loss_sum within 2e-2 relative and probabilities within
  3e-2 relative: the logits are rounded to bf16 at a few units, so each
  moves by ~1e-2 in either framework;
- top-k ids equal wherever the probabilities are separated by more than
  twice their tolerance;
- the metrics are exact: the same predicted words give the same counts.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu import common as jcommon
from code2vec_tpu.data.reader import C2VTextReader as JReader
from code2vec_tpu.models import encoder as jenc
from code2vec_tpu.models.model_base import MetricAccumulator as JAccumulator
from code2vec_tpu.training.steps import make_eval_step
from code2vec_tpu.vocab import vocabularies as jvocab
from code2vec_tpu_torch import common as tcommon
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.models.model_base import MetricAccumulator
from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
from code2vec_tpu_torch.ops.requant_kernel import requantize_fused
from code2vec_tpu_torch.training import optimizers as topt
from code2vec_tpu_torch.training.steps import eval_step
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
from helpers import PATHS, TARGETS, TOKENS, make_raw_lines
from torch_helpers import assert_topk_agree

TOP_K = 10
C, E = 12, 8


def _batch(r, B, V=(41, 23, 19)):
    weights = np.ones((B,), np.float32)
    weights[-2:] = 0.0
    mask = (r.random((B, C)) > 0.4).astype(np.float32)
    mask[0] = 0.0  # a method with no context
    return (r.integers(0, V[2], B).astype(np.int32),
            r.integers(0, V[0], (B, C)).astype(np.int32),
            r.integers(0, V[1], (B, C)).astype(np.int32),
            r.integers(0, V[0], (B, C)).astype(np.int32), mask, weights)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("tables,compute", [("float32", "float32"),
                                            ("bfloat16", "bfloat16"),
                                            ("int8", "float32")])
def test_eval_step_matches_jax(tables, compute, use_kernel):
    """eval_step against make_eval_step (the port's kernel wrapper on CPU
    tensors against the Pallas kernel in interpret mode; the plain pool
    against the XLA pool): loss_sum within 1e-5 relative (float32) or
    2e-2 (bf16), top-k probabilities within 1e-5 / 3e-2 relative, top-k
    ids equal where separated."""
    kw = dict(token_vocab_size=41, path_vocab_size=23, target_vocab_size=19,
              embeddings_size=E, max_contexts=C, vocab_pad_multiple=4,
              tables_dtype=tables)
    jdims, tdims = jenc.ModelDims(**kw), tenc.ModelDims(**kw)
    ref = jax.tree_util.tree_map(
        np.asarray, jenc.init_params(jax.random.PRNGKey(1), jdims))
    # sharpen the head so the top-k order is well separated
    ref["target_emb"] = (ref["target_emb"].astype(np.float32) * 10).astype(
        ref["target_emb"].dtype)
    batch = _batch(np.random.default_rng(2), 13)
    step = make_eval_step(jdims, top_k=TOP_K,
                          compute_dtype=getattr(jnp, compute),
                          use_pallas=use_kernel)
    loss_j, ids_j, probs_j = (np.asarray(x) for x in step(ref, batch))
    params = convert.params_from_numpy(ref, "cpu")
    with torch.inference_mode():
        loss_t, ids_t, probs_t = eval_step(
            params, tuple(torch.from_numpy(a) for a in batch), dims=tdims,
            top_k=TOP_K, compute_dtype=getattr(torch, compute),
            use_kernel=use_kernel)
    f32 = compute == "float32"
    assert loss_t.dim() == 0 and loss_t.dtype == torch.float32
    assert abs(float(loss_t) - float(loss_j)) <= \
        (1e-5 if f32 else 2e-2) * abs(float(loss_j))
    checked = assert_topk_agree(ids_t.numpy(), probs_t.numpy(), ids_j,
                                probs_j, 1e-5 if f32 else 0.0,
                                rtol=0.0 if f32 else 3e-2)
    assert checked >= batch[0].shape[0]


NAMES = ["get|name", "set|value", "is|empty", "to|string", "get", "run",
         "<OOV>", "<PAD>", "", "add|all|items", "x", "size"]


def test_subtoken_helpers_match_jax():
    """normalize_word, split_to_subtokens, legal_method_names_checker,
    filter_impossible_names and calculate_subtoken_tp_fp_fn give the JAX
    package's results on the same words."""
    raw = ["setFooBar_2x", "HTTPServer", "get_URL", "a1b2", "___", "X",
           "toString", "  spaced  name ", "42"]
    for w in raw:
        assert tcommon.normalize_word(w) == jcommon.normalize_word(w)
        assert tcommon.split_to_subtokens(w) == jcommon.split_to_subtokens(w)
    for n in NAMES + ["12", "a|1"]:
        assert tcommon.legal_method_names_checker(n) == \
            jcommon.legal_method_names_checker(n)
    assert tcommon.filter_impossible_names(NAMES) == \
        jcommon.filter_impossible_names(NAMES)
    for a in NAMES:
        for b in NAMES:
            assert tcommon.calculate_subtoken_tp_fp_fn(a, b) == \
                jcommon.calculate_subtoken_tp_fp_fn(a, b)


def test_metric_accumulator_matches_jax():
    """The same originals, predicted words and loss sums give the same
    top-k accuracy, subtoken precision / recall / F1 and loss."""
    r = np.random.default_rng(3)
    t_acc, j_acc = MetricAccumulator(4), JAccumulator(4)
    for _batch_i in range(3):
        originals = [NAMES[i] for i in r.integers(0, len(NAMES), 9)]
        words = [[NAMES[i] for i in r.integers(0, len(NAMES), 6)]
                 for _ in originals]
        for i in range(0, len(words), 3):
            words[i][r.integers(0, 6)] = originals[i]  # some hits
        loss = float(r.random() * 5)
        t_acc.update_batch(originals, words, loss)
        j_acc.update_batch(originals, words, loss)
    t_res, j_res = t_acc.results(), j_acc.results()
    assert t_res.topk_acc == j_res.topk_acc
    assert (t_res.subtoken_precision, t_res.subtoken_recall,
            t_res.subtoken_f1, t_res.loss) == \
        (j_res.subtoken_precision, j_res.subtoken_recall,
         j_res.subtoken_f1, j_res.loss)
    assert str(t_res) == str(j_res)
    assert any(t_res.topk_acc) and t_res.subtoken_f1 > 0


def _vocabs(tmp_path):
    V, T = jvocab.Vocab, jvocab.VocabType
    jv = jvocab.Code2VecVocabs(V(T.Token, TOKENS), V(T.Path, PATHS),
                               V(T.Target, TARGETS), num_training_examples=7)
    path = str(tmp_path / "vocab.pkl")
    jv.save(path)
    return jv, Code2VecVocabs.load(path)


def _write_c2v(path, n, seed):
    with open(path, "w") as f:
        f.write("\n".join(make_raw_lines(n, seed=seed, max_ctx=C)) + "\n")


def _config(**kw):
    base = dict(MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E,
                TRAIN_BATCH_SIZE=16, TEST_BATCH_SIZE=8, LEARNING_RATE=0.05,
                NUM_BATCHES_TO_LOG_PROGRESS=4)
    base.update(kw)
    return Config(**base)


def test_trainer_evaluate_matches_jax_eval_over_a_file(tmp_path):
    """Code2VecTrainer.evaluate on a 21-method file (a padded last batch)
    against the JAX eval step (Pallas pool in interpret mode) and
    MetricAccumulator over the JAX reader's batches of the same file,
    from the same float32 weights (the head sharpened): top-k accuracy
    and subtoken P/R/F1 exact, loss within 1e-5 relative."""
    jv, tv = _vocabs(tmp_path)
    path = str(tmp_path / "test.c2v")
    _write_c2v(path, 21, seed=5)
    cfg = _config(USE_BF16=False, TABLES_DTYPE="float32")
    trainer = Code2VecTrainer(cfg, tv, device="cpu")
    jdims = jenc.ModelDims(
        token_vocab_size=jv.token_vocab.size, path_vocab_size=jv.path_vocab.size,
        target_vocab_size=jv.target_vocab.size, embeddings_size=E,
        max_contexts=C)
    ref = jax.tree_util.tree_map(
        np.asarray, jenc.init_params(jax.random.PRNGKey(7), jdims))
    ref["target_emb"] = ref["target_emb"] * 10
    trainer.params = convert.params_from_numpy(ref, "cpu")
    got = trainer.evaluate(path)

    step = make_eval_step(jdims, top_k=TOP_K, use_pallas=True)
    acc = JAccumulator(TOP_K)
    for b in JReader(path, jv, C, 8, shuffle=False, keep_strings=True):
        loss_sum, ids, _ = step(ref, tuple(jnp.asarray(a) for a in (
            b.target_index, b.path_source_token_indices, b.path_indices,
            b.path_target_token_indices, b.context_valid_mask,
            (np.arange(8) < b.num_valid_examples).astype(np.float32))))
        nv = b.num_valid_examples
        words = [[jv.target_vocab.lookup_word(int(i)) for i in row]
                 for row in np.asarray(ids)[:nv]]
        acc.update_batch(b.target_strings[:nv], words, float(loss_sum))
    want = acc.results()
    assert acc.num_examples == 21
    assert got.topk_acc == want.topk_acc
    assert (got.subtoken_precision, got.subtoken_recall, got.subtoken_f1) \
        == (want.subtoken_precision, want.subtoken_recall, want.subtoken_f1)
    assert abs(got.loss - want.loss) <= 1e-5 * abs(want.loss)


@pytest.mark.parametrize("tables", ["bfloat16", "int8"])
def test_default_config_trains_and_evaluates(tmp_path, tables, caplog):
    """The JAX defaults (dense step, Adafactor tables, Adam on TRANSFORM /
    ATTENTION, cosine LR, full softmax, bf16 compute), with bf16 or int8
    token/path tables, on the CPU over a tiny `.c2v` file: 4 epochs of 2
    batches, the last epoch's mean loss below the first's, the schedule's
    horizon is the run's 8 steps, and evaluate returns finite metrics
    that training moved up. The int8 run requantizes through the kernel
    wrapper (its plain version on CPU tensors: no launch)."""
    _jv, tv = _vocabs(tmp_path)
    path = str(tmp_path / "train.c2v")
    _write_c2v(path, 32, seed=2)
    cfg = _config(TABLES_DTYPE=tables)
    assert (cfg.EMBEDDING_OPTIMIZER, cfg.LR_SCHEDULE, cfg.USE_BF16,
            cfg.SPARSE_EMBEDDING_UPDATES) == ("adafactor", "cosine", True,
                                              False)
    trainer = Code2VecTrainer(cfg, tv, device="cpu")
    before = trainer.evaluate(path)
    launches = requantize_fused.launches
    with caplog.at_level(logging.INFO, logger="code2vec_tpu_torch"):
        losses = trainer.train(path, epochs=4)
    assert requantize_fused.launches == launches
    assert len(losses) == 8 and trainer.step_num == 8
    assert trainer.total_steps == 8
    assert any("lr schedule cosine over 8 steps" in m for m in caplog.messages)
    assert all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
    counted = (topt.FactoredState, topt.ScaleByAdamState,
               topt.ScaleByScheduleState)
    counts = [st.count for chain in trainer.opt_state.values()
              for st in chain if isinstance(st, counted)]
    assert counts and all(int(c) == 8 for c in counts)
    assert isinstance(trainer.opt_state["table"][0], topt.FactoredState)
    if tables == "int8":
        assert trainer.params["token_emb"]["q"].dtype == torch.int8
    after = trainer.evaluate(path)
    assert np.isfinite(after.loss) and after.loss < before.loss
    assert after.topk_acc[0] >= before.topk_acc[0]
    assert len(after.topk_acc) == TOP_K

"""The transformer encoder through the port's entry points, against the
JAX package, on the CPU: `Code2VecTrainer` trains and evaluates a
transformer model, and `PredictionServer` serves one.

The references are the JAX steps with their fused attention kernels
(`use_pallas=True`, Pallas in interpret mode) on the same weights: the
eval step with the JAX `MetricAccumulator` over the JAX reader's batches
of the same file, and the predict step with the JAX model's decode over
the same raw lines. On CPU tensors the port's kernel wrappers run the
plain versions and launch nothing.

Tolerances: float32 loss within 1e-5 relative and the metrics exact (the
same predicted names give the same counts); probabilities within 1e-5
(float32) or 5e-2 (bf16: two bf16 layers move a code vector by a few
bf16 steps, which moves a logit of the sharpened head by up to ~0.2 and
a probability p by that times p (1 - p); the server coalesces requests
into batches of another shape from run to run, and a bf16 product's
rounding depends on the shape, so up to 2.5e-2 was seen) and pool
weights within 1e-5 (float32) or 2e-2 (bf16 activations); names equal
wherever the probabilities are further apart than twice that.
"""

import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.data.reader import C2VTextReader as JReader
from code2vec_tpu.data.reader import parse_c2v_rows as jax_parse
from code2vec_tpu.models import encoder as jenc
from code2vec_tpu.models import jax_model
from code2vec_tpu.models.model_base import MetricAccumulator as JAccumulator
from code2vec_tpu.training.steps import make_eval_step, make_predict_step
from code2vec_tpu.vocab import vocabularies as jvocab
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.models.torch_model import (Code2VecModel,
                                                   Code2VecTrainer)
from code2vec_tpu_torch.ops.xf_attention import (mha_backward_fused,
                                                 mha_forward_fused)
from code2vec_tpu_torch.serving.server import PredictionServer
from code2vec_tpu_torch.training import optimizers as topt
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
from helpers import PATHS, TARGETS, TOKENS, make_raw_lines
from torch_helpers import assert_topk_agree

TOP_K = 10
C, E, L, H = 12, 8, 2, 2


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


def _jdims(jv, tables="float32"):
    return jenc.ModelDims(
        token_vocab_size=jv.token_vocab.size,
        path_vocab_size=jv.path_vocab.size,
        target_vocab_size=jv.target_vocab.size, embeddings_size=E,
        max_contexts=C, tables_dtype=tables, encoder_type="transformer",
        xf_layers=L, xf_heads=H)


def test_trainer_trains_and_evaluates_like_jax(tmp_path):
    """Code2VecTrainer with ENCODER_TYPE="transformer" (the dense step,
    Adafactor tables, Adam on every "xf" leaf, cosine LR, float32) trains
    3 epochs on a 32-method file: the loss falls and every "xf" leaf
    moves. `evaluate` on a 21-method file (a padded last batch) then
    equals the JAX eval step with the trained weights: top-k accuracy
    and subtoken P/R/F1 exact, the loss within 1e-5 relative."""
    jv, tv = _vocabs(tmp_path)
    train, test = str(tmp_path / "train.c2v"), str(tmp_path / "test.c2v")
    _write_c2v(train, 32, seed=2)
    _write_c2v(test, 21, seed=5)
    cfg = Config(MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E,
                 TRAIN_BATCH_SIZE=16, TEST_BATCH_SIZE=8, LEARNING_RATE=0.01,
                 USE_BF16=False, TABLES_DTYPE="float32",
                 ENCODER_TYPE="transformer", XF_LAYERS=L, XF_HEADS=H)
    trainer = Code2VecTrainer(cfg, tv, device="cpu")
    assert (trainer.dims.xf_layers, trainer.dims.xf_heads) == (L, H)
    assert set(trainer.opt_state["small"][0].mu) >= {
        "transform", "attention", "xf/in_proj", "xf/layers/1/mlp_down"}
    before = jax.tree_util.tree_map(np.copy,
                                    convert.params_to_numpy(trainer.params))
    launches = (mha_forward_fused.launches, mha_backward_fused.launches)
    losses = trainer.train(train, epochs=3)
    assert (mha_forward_fused.launches, mha_backward_fused.launches) == \
        launches  # CPU: the plain versions
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
    counts = [st.count for chain in trainer.opt_state.values()
              for st in chain if isinstance(st, topt.ScaleByAdamState)]
    assert counts and all(int(c) == 6 for c in counts)
    ref = convert.params_to_numpy(trainer.params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref["xf"]),
                            jax.tree_util.tree_leaves(before["xf"])):
        assert not np.array_equal(a, b), path
    got = trainer.evaluate(test)

    step = make_eval_step(_jdims(jv), top_k=TOP_K, use_pallas=True)
    acc = JAccumulator(TOP_K)
    for b in JReader(test, jv, C, 8, shuffle=False, keep_strings=True):
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


def _jax_reference(jv, jdims, ref, lines, compute):
    labels, src, pth, dst, mask, tstr, cstr = jax_parse(lines, jv, C,
                                                        keep_strings=True)
    step = make_predict_step(jdims, top_k=TOP_K,
                             compute_dtype=getattr(jnp, compute),
                             use_pallas=True)
    out = tuple(np.asarray(x) for x in step(
        ref, (labels, src, pth, dst, mask, np.ones(len(lines), np.float32))))
    stub = types.SimpleNamespace(
        vocabs=jv, config=types.SimpleNamespace(export_code_vectors=False))
    prepared = jax_model.PreparedRows(labels, src, pth, dst, mask, tstr, cstr)
    return jax_model.Code2VecModel.decode_predictions(stub, prepared, out)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_server_serves_a_transformer_model_like_jax(tmp_path, compute):
    """PredictionServer over a transformer model (bf16 tables, JAX weights
    with the head sharpened) answers 8 requests from 4 threads, some
    lines over the MAX_CONTEXTS cap, with the JAX predict step's top-k
    (probabilities within 1e-5 / 5e-2, names equal where separated) and
    its attention-ranked paths (pool weights within 1e-5 / 2e-2)."""
    jv, tv = _vocabs(tmp_path)
    jdims = _jdims(jv, "bfloat16")
    ref = jax.tree_util.tree_map(
        np.asarray, jenc.init_params(jax.random.PRNGKey(5), jdims))
    ref["target_emb"] = (ref["target_emb"].astype(np.float32) * 10).astype(
        ref["target_emb"].dtype)
    config = Config(MAX_CONTEXTS=C, USE_BF16=compute == "bfloat16",
                    SERVE_BATCH_MAX=8, ENCODER_TYPE="transformer",
                    XF_LAYERS=L, XF_HEADS=H)
    tdims = tenc.ModelDims(**{f: getattr(jdims, f) for f in (
        "token_vocab_size", "path_vocab_size", "target_vocab_size",
        "embeddings_size", "max_contexts", "tables_dtype", "encoder_type",
        "xf_layers", "xf_heads")})
    model = Code2VecModel(config, tdims, tv,
                          convert.params_from_numpy(ref, "cpu"), device="cpu")
    lines = make_raw_lines(20, seed=3, max_ctx=20)
    requests = np.split(np.arange(20), [1, 5, 8, 10, 14, 15, 18])
    results = [None] * len(requests)
    errors = []
    with PredictionServer(config, model) as server:
        def client(k):
            try:
                for i in range(k, len(requests), 4):
                    results[i] = server.predict_lines(
                        [lines[j] for j in requests[i]], deadline_ms=0)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    assert not errors
    got = [r for res in results for r in res]
    want = _jax_reference(jv, jdims, ref, lines, compute)
    f32 = compute == "float32"
    assert len(got) == len(want) == 20
    checked = 0
    for g, w in zip(got, want):
        assert g.original_name == w.original_name
        names = {}
        ids = [[names.setdefault("|".join(p["name"]), len(names))
                for p in r.predictions] for r in (g, w)]
        probs = [[p["probability"] for p in r.predictions] for r in (g, w)]
        checked += assert_topk_agree(
            np.array(ids[:1]), np.array(probs[:1]), np.array(ids[1:]),
            np.array(probs[1:]), 1e-5 if f32 else 5e-2)
        key = [sorted(((a.source_token, a.path, a.target_token),
                       a.attention_score) for a in r.attention_paths)
               for r in (g, w)]
        assert [k for k, _ in key[0]] == [k for k, _ in key[1]]
        np.testing.assert_allclose([s for _, s in key[0]],
                                   [s for _, s in key[1]],
                                   atol=1e-5 if f32 else 2e-2)
    assert checked >= len(got)

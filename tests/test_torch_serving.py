"""The whole serving slice of the port against the JAX package, on the CPU.

Raw extractor lines (tests/helpers.make_raw_lines, some over the
MAX_CONTEXTS cap) go through the port's `PredictionServer` from several
client threads, on weights made by JAX `init_params` and carried over
with `convert.params_from_numpy`. The reference is the JAX path on the
same lines: `parse_c2v_rows` + `make_predict_step` (Pallas pool in
interpret mode) + the JAX model's own `decode_predictions`.

Tolerances: float32 compute agrees to 1e-5 on probabilities and
attention scores; bf16 compute to 3e-2 relative on probabilities (bf16
logits, see tests/test_torch_predict.py) and 1e-5 on attention (the
pool runs in float32 on both sides: the kernel's plain version and the
Pallas kernel). Names must agree wherever the probabilities are further
apart than that.
"""

import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.data.reader import parse_c2v_rows as jax_parse
from code2vec_tpu.models import encoder as jenc
from code2vec_tpu.models import jax_model
from code2vec_tpu.training.steps import make_predict_step
from code2vec_tpu.vocab import vocabularies as jvocab
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data.reader import parse_c2v_rows
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.models.torch_model import Code2VecModel
from code2vec_tpu_torch.ops.attention_kernel import attention_pool_fused
from code2vec_tpu_torch.serving.batcher import (MicroBatcher, PredictRequest,
                                                ServerOverloaded)
from code2vec_tpu_torch.serving.server import PredictionServer
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
from helpers import PATHS, TARGETS, TOKENS, make_raw_lines
from torch_helpers import assert_topk_agree

C = 16       # MAX_CONTEXTS; make_raw_lines(max_ctx=30) goes over it
TOP_K = 10


def _jax_vocabs():
    V = jvocab.Vocab
    T = jvocab.VocabType
    # a few words the lines never use, so the tables hold unused rows
    return jvocab.Code2VecVocabs(
        V(T.Token, TOKENS + ["unused"]), V(T.Path, PATHS),
        V(T.Target, TARGETS + ["never|seen", "x"]),
        num_training_examples=7)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX vocabs + params, saved/loaded into the port's types."""
    jv = _jax_vocabs()
    path = str(tmp_path_factory.mktemp("vocab") / "vocab.pkl")
    jv.save(path)
    tv = Code2VecVocabs.load(path)
    kw = dict(token_vocab_size=jv.token_vocab.size,
              path_vocab_size=jv.path_vocab.size,
              target_vocab_size=jv.target_vocab.size, embeddings_size=8,
              max_contexts=C, vocab_pad_multiple=4, tables_dtype="bfloat16")
    ref = jax.tree_util.tree_map(
        np.asarray, jenc.init_params(jax.random.PRNGKey(5),
                                     jenc.ModelDims(**kw)))
    # sharpen the head so names are well separated
    ref["target_emb"] = (ref["target_emb"].astype(np.float32) * 10).astype(
        ref["target_emb"].dtype)
    return types.SimpleNamespace(jv=jv, tv=tv, kw=kw, ref=ref)


def _jax_reference(world, lines, compute):
    """The JAX path on `lines`: parse + predict step + the JAX decode."""
    labels, src, pth, dst, mask, tstr, cstr = jax_parse(
        lines, world.jv, C, keep_strings=True)
    step = make_predict_step(jenc.ModelDims(**world.kw), top_k=TOP_K,
                             compute_dtype=getattr(jnp, compute),
                             use_pallas=True)
    out = step(world.ref, (labels, src, pth, dst, mask,
                           np.ones(len(lines), np.float32)))
    out = tuple(np.asarray(x) for x in out)
    stub = types.SimpleNamespace(
        vocabs=world.jv,
        config=types.SimpleNamespace(export_code_vectors=False))
    prepared = jax_model.PreparedRows(labels, src, pth, dst, mask, tstr, cstr)
    return jax_model.Code2VecModel.decode_predictions(stub, prepared, out)


def _model(world, compute, **cfg):
    config = Config(MAX_CONTEXTS=C, USE_BF16=compute == "bfloat16",
                    SERVE_BATCH_MAX=8, **cfg)
    params = convert.params_from_numpy(world.ref, device="cpu")
    return Code2VecModel(config, tenc.ModelDims(**world.kw), world.tv, params,
                         device="cpu")


def _assert_results_agree(got, want, compute):
    f32 = compute == "float32"
    assert len(got) == len(want)
    checked = 0
    for g, w in zip(got, want):
        assert g.original_name == w.original_name
        assert len(g.predictions) == len(w.predictions)
        # names -> ids in one shared order so the top-k helper can compare
        names = {}
        ids = [[names.setdefault("|".join(p["name"]), len(names))
                for p in r.predictions] for r in (g, w)]
        probs = [[p["probability"] for p in r.predictions] for r in (g, w)]
        checked += assert_topk_agree(
            np.array(ids[:1]), np.array(probs[:1]), np.array(ids[1:]),
            np.array(probs[1:]), 1e-5 if f32 else 0.0,
            rtol=0.0 if f32 else 3e-2)
        # attention-ranked paths: the same contexts with the same scores
        # (ties may order differently), ranked by descending score
        key = [sorted(((a.source_token, a.path, a.target_token),
                       a.attention_score) for a in r.attention_paths)
               for r in (g, w)]
        assert [k for k, _ in key[0]] == [k for k, _ in key[1]]
        np.testing.assert_allclose([s for _, s in key[0]],
                                   [s for _, s in key[1]], atol=1e-5)
        scores = [a.attention_score for a in g.attention_paths]
        assert scores == sorted(scores, reverse=True)
    # most names were far enough apart to be compared
    assert checked >= 2 * len(got)


def test_vocab_sidecar_is_shared_both_ways(world, tmp_path):
    for v in ("token_vocab", "path_vocab", "target_vocab"):
        assert getattr(world.tv, v).to_word_list() == \
            getattr(world.jv, v).to_word_list()
    assert world.tv.num_training_examples == 7
    path = str(tmp_path / "port.pkl")
    world.tv.save(path)
    back = jvocab.Code2VecVocabs.load(path)
    assert back.target_vocab.to_word_list() == \
        world.jv.target_vocab.to_word_list()


def test_parse_matches_jax_including_over_cap_rows(world):
    lines = make_raw_lines(40, seed=11, max_ctx=30)
    lines.append(lines[0].split(" ")[0] + " " + " ".join(
        reversed(lines[0].split(" ")[1:])) + " ,, ")  # reordered + padding
    mine = parse_c2v_rows(lines, world.tv, C, keep_strings=True)
    ref = jax_parse(lines, world.jv, C, keep_strings=True)
    assert sum(len(ln.split(" ")) - 1 > C for ln in lines) >= 5
    for a, b in zip(mine[:5], ref[:5]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert mine[5:] == ref[5:]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_server_matches_jax_path_under_concurrency(world, compute):
    model = _model(world, compute)
    server = PredictionServer(model.config, model)
    try:
        server.start(warmup=True)
        assert server.warmup_buckets == [1, 2, 4, 8]
        lines = make_raw_lines(36, seed=3, max_ctx=30)
        # 12 requests of 1..5 methods from 4 client threads
        cuts = np.cumsum([1, 5, 3, 2, 4, 1, 5, 3, 2, 4, 1, 5])
        requests = np.split(np.arange(36), cuts[cuts < 36])
        results = [None] * len(requests)
        errors = []

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
        _assert_results_agree(got, _jax_reference(world, lines, compute),
                              compute)
        assert server.requests == len(requests)
        assert 1 <= server.batches <= len(requests)
        assert attention_pool_fused.launches == 0  # CPU: the plain version
    finally:
        server.close()
    assert not server.batcher.running


def test_cache_hit_returns_the_same_result(world):
    model = _model(world, "float32")
    with PredictionServer(model.config, model) as server:
        lines = make_raw_lines(3, seed=8, max_ctx=30)
        first = server.predict_lines(lines)
        batches = server.batches
        # a reordered copy of a method hits the same cache entry
        parts = lines[1].split(" ")
        again = server.predict_lines([lines[0], " ".join(
            [parts[0]] + parts[:0:-1]), lines[2]])
        assert server.batches == batches
        assert server.cache_hits == 3 and server.cache_misses == 3
        assert again == first


def test_model_predict_matches_server(world):
    model = _model(world, "float32")
    lines = make_raw_lines(11, seed=9, max_ctx=30)
    direct = model.predict(lines + ["   "])
    with PredictionServer(model.config, model) as server:
        # 11 methods > SERVE_BATCH_MAX = 8: chunked into two device calls
        assert server.predict_lines(lines) == direct
        assert server.batches == 2
    assert model.predict([]) == []


def test_batcher_refuses_oversized_and_fails_pending_on_stop():
    gate = threading.Event()

    def batch_fn(reqs):
        gate.wait(5)
        return [r.n for r in reqs]
    b = MicroBatcher(batch_fn, max_batch=4, timeout_ms=0, queue_depth=2)
    with pytest.raises(ValueError):
        b.submit(PredictRequest("rows", 5))
    assert not b.submit(PredictRequest("rows", 1))  # not started
    b.start()
    try:
        first = PredictRequest("rows", 3)
        assert b.submit(first)
        # the consumer takes `first` and blocks in batch_fn; fill the queue
        assert first.wait(0.0) is False
        queued = [PredictRequest("rows", 2) for _ in range(2)]
        deadline = threading.Event()
        for q in queued:
            while not b.submit(q):
                deadline.wait(0.01)
        assert not b.submit(PredictRequest("rows", 1))  # queue full
    finally:
        gate.set()
        b.stop()
    assert first.wait(5) and first.result == 3
    for q in queued:
        assert q.wait(5)
        assert q.result == 2 or isinstance(q.error, ServerOverloaded)


def test_model_without_cuda_refuses_default_device(world):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    params = convert.params_from_numpy(world.ref, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Code2VecModel(Config(), tenc.ModelDims(**world.kw), world.tv, params)

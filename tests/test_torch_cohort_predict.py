"""The port's predict side above one rank (serving/cohort.py,
`Code2VecModel` on a mesh), against the JAX package's, on the CPU.

Gloo workers spawned by this file's fixture (tests/
test_torch_multiprocess.py's `_spawn`, one spawn a world size) build a
predict-side model on their mesh over the JAX package's params (carried
with convert.py, the tables padded to 2 and cut to each rank's window)
and all call `predict_device` with the same rows:

- layouts (data 2), (model 2) and (ctx 2) at two ranks, (data 2, model
  2) at four; the bag encoder and the transformer; float32. Each rank's
  output is held to JAX's one-device `make_predict_step` on the same
  params and rows: the top-k ids equal, the probabilities within rtol
  1e-5, the attention and the code vectors within atol 2e-5. The rows
  are a bucket of 5 padded to 8 and one row padded to divide the data
  axis (B = 1 at data 2).
- at (model 2), the JAX package's own `Code2VecModel` at
  MESH_MODEL_AXIS=2, which runs in this process over the 8 host devices
  tests/conftest.py sets: the same tolerances on its prepared rows.
- the command line: `cli.main --predict --mesh_model 2 --dist_*` on two
  ranks, stdin to rank 0 (two Enters, `attack`, `q`): rank 0 prints what
  one process prints, latency lines aside (names in the same order
  where the probabilities are more than 1e-6 apart, every printed number
  within one unit of its last digit); rank 1 prints no answer; both
  exit 0. A second run starts where Input.java is missing, then meets a
  rank-0 `ExtractorError` (the `serve/extract` failpoint) and a REPL
  left idle longer than the process group's timeout (6 s here, the
  cohort's wait its own): both ranks keep serving and exit 0.

The spawn's `communicate` timeout bounds every run: a hung follower
fails the test.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import os
import pickle
import re
import shutil
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
C, E = 8, 16
VT, VP, VY = 47, 39, 29     # odd: padded to 48, 40, 30 for the model axis
K = 10
N = 5                       # rows of the bucket (padded to 8)
ENCODERS = ("bag", "transformer")
# world -> [(layout, mesh axes)]
LAYOUTS = {2: [("data2", dict(data=2, context=1, model=1)),
               ("model2", dict(data=1, context=1, model=2)),
               ("ctx2", dict(data=1, context=2, model=1))],
           4: [("data2_model2", dict(data=2, context=1, model=2))]}
CASES = [(layout, enc) for w in LAYOUTS for layout, _a in LAYOUTS[w]
         for enc in ENCODERS]
WORLD_OF = {layout: w for w in LAYOUTS for layout, _a in LAYOUTS[w]}
# the REPL's printed numbers: %.6f, held within one unit of the last digit
PRINT_TOL = 1e-6 + 1e-9
# the process group's timeout in the idle run, and the REPL's idle wait
IDLE_PG_TIMEOUT_S, IDLE_S = 6.0, 8.0
REPL_KEYS = ["", "", "attack", "q"]


def _dims(module, encoder):
    return module.ModelDims(token_vocab_size=VT, path_vocab_size=VP,
                            target_vocab_size=VY, embeddings_size=E,
                            max_contexts=C, vocab_pad_multiple=2,
                            encoder_type=encoder, xf_layers=2, xf_heads=2)


def _rows(seed):
    r = np.random.default_rng(seed)
    mask = (r.random((N, C)) > 0.3).astype(np.float32)
    mask[1, C // 2:] = 0.0    # a ctx shard of padding
    return (r.integers(0, VY, N).astype(np.int32),
            r.integers(0, VT, (N, C)).astype(np.int32),
            r.integers(0, VP, (N, C)).astype(np.int32),
            r.integers(0, VT, (N, C)).astype(np.int32), mask)


def _prepared(rows, n):
    from code2vec_tpu_torch.models.torch_model import PreparedRows
    return PreparedRows(*(a[:n] for a in rows), [""] * n, [[]] * n)


def _predict_config():
    from code2vec_tpu_torch.config import Config
    return Config(MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E,
                  TABLES_DTYPE="float32", USE_BF16=False,
                  TOP_K_WORDS_CONSIDERED_DURING_PREDICTION=K)


def mesh_model(params, dims, mesh, config=None, vocabs=None):
    """The port's predict-side model on `mesh` over whole numpy params
    (each table cut to the rank's window)."""
    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.models.torch_model import Code2VecModel
    from code2vec_tpu_torch.parallel.sharding import shard_params
    whole = convert.params_from_numpy(pickle.loads(pickle.dumps(params)),
                                      "cpu")
    return Code2VecModel(config or _predict_config(), dims, vocabs,
                         shard_params(whole, mesh), device="cpu", mesh=mesh)


def _cli_flags(rank, world, port):
    return ["--dist_coordinator", f"127.0.0.1:{port}",
            "--dist_num_processes", str(world), "--dist_process_id",
            str(rank)]


def run_cli(argv, keys, cwd):
    """`cli.main(argv)` in `cwd` with `keys` as stdin (None: stdin must
    not be read) -> (exit code, stdout). A key that is a callable is
    called (a side effect at that prompt) and returns the line."""
    from code2vec_tpu_torch import cli
    lines = iter(keys or [])

    def fake_input(*_a):
        if keys is None:
            raise AssertionError("a follower read stdin")
        try:
            key = next(lines)
        except StopIteration:
            raise EOFError from None
        return key() if callable(key) else key

    import builtins
    real, here = builtins.input, os.getcwd()
    out = io.StringIO()
    builtins.input = fake_input
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    finally:
        builtins.input = real
        os.chdir(here)
    return rc, out.getvalue()


# ---- the workers (run by tests/test_torch_multiprocess.py's worker) ----

def predict_worker(rank, world, out_dir, deadline):
    """Every layout of `world` with both encoders; at two ranks also the
    JAX `Code2VecModel` case and the two command-line runs (last: cli.main
    leaves the group)."""
    from code2vec_tpu_torch.models import encoder as tenc
    from code2vec_tpu_torch.parallel.mesh import make_mesh
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}
    for layout, axes in LAYOUTS[world]:
        mesh = make_mesh(axes["data"], axes["model"], axes["context"],
                         device="cpu")
        for enc in ENCODERS:
            deadline.beat(f"{layout}/{enc}")
            model = mesh_model(inp["params"][enc], _dims(tenc, enc), mesh)
            out[(layout, enc)] = {
                n: model.predict_device(_prepared(inp["rows"], n))
                for n in (N, 1)}
    if world == 4:
        return out
    deadline.beat("jax_model")
    out["jax_model"] = _jax_model_case(inp["jax_model"])
    deadline.beat("cli", timeout_s=120.0)
    out["cli"] = _cli_runs(rank, world, inp["cli"])
    return out


def _jax_model_case(j):
    """The port's model-2 predictor on the JAX model's params, dims and
    vocabularies over its raw lines."""
    from code2vec_tpu_torch.models import encoder as tenc
    from code2vec_tpu_torch.parallel.mesh import make_mesh
    from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
    cfg = _predict_config()
    cfg.MAX_CONTEXTS = j["dims"]["max_contexts"]
    model = mesh_model(j["params"], tenc.ModelDims(**j["dims"]),
                       make_mesh(1, 2, 1, device="cpu"), config=cfg,
                       vocabs=Code2VecVocabs.load(j["vocab"]))
    return model.predict_device(model.prepare_predict_rows(j["lines"]))


def _cli_runs(rank, world, spec):
    """The REPL on two ranks: the plain run, then the one that meets a
    missing Input.java, an extractor error and an idle prompt longer than
    the process group's timeout (each cli.main on a port of its own)."""
    import functools

    from code2vec_tpu_torch.parallel import distributed
    base = ["--backend", "cpu", "--load", spec["ckpt"], "--predict",
            "--no_bf16", "--mesh_model", "2"]
    lead = rank == 0
    plain = run_cli(base + _cli_flags(rank, world, spec["ports"][0]),
                    REPL_KEYS if lead else None,
                    spec["work"] if lead else spec["elsewhere"])
    empty = os.path.join(spec["elsewhere"], f"empty{rank}")
    os.makedirs(empty, exist_ok=True)

    def bring_input():
        shutil.copy(spec["input_java"], os.path.join(empty, "Input.java"))
        return ""

    def idle():
        time.sleep(IDLE_S)
        return ""
    real = distributed.maybe_initialize
    distributed.maybe_initialize = functools.partial(
        real, timeout_s=IDLE_PG_TIMEOUT_S)
    try:
        t = time.perf_counter()
        faulted = run_cli(
            base + _cli_flags(rank, world, spec["ports"][1])
            + ["--faults", '{"sites": {"serve/extract": {"action": '
               '"raise", "at": 1}}}'],
            ["", bring_input, idle, "q"] if lead else None, empty)
        seconds = time.perf_counter() - t
    finally:
        distributed.maybe_initialize = real
    return {"plain": plain, "faulted": faulted, "faulted_s": seconds}


# ---- the parent side ----

def _jax_predict(params, encoder, rows):
    import jax.numpy as jnp

    from code2vec_tpu.models import encoder as jenc
    from code2vec_tpu.training.steps import make_predict_step
    step = make_predict_step(_dims(jenc, encoder), top_k=K,
                             compute_dtype=jnp.float32)
    n = rows[0].shape[0]
    out = step(params, tuple(rows) + (np.ones((n,), np.float32),))
    return tuple(np.asarray(a) for a in out)


def build_repl_world(base):
    """Input.java and its methods' dataset (with synthetic methods), the
    native extractor built, and a one-process checkpoint trained on it
    (float32 tables) -> {dir, input_java, prefix, ckpt}."""
    from helpers import make_raw_lines

    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.data import preprocess
    from code2vec_tpu_torch.extractor import native
    from code2vec_tpu_torch.ops import _build
    try:
        _build.cxx_path()
    except _build.KernelBuildError as e:
        pytest.skip(f"no host C++ compiler to build the native extractor "
                    f"({e})")
    native.binary_path()
    native.library_path()
    d = os.path.join(base, "repl")
    os.makedirs(d)
    input_java = os.path.join(d, "Input.java")
    shutil.copy(os.path.join(REPO, "Input.java"), input_java)
    with open(input_java) as f:
        java = native.extract_source(f.read())
    lines = java * 4 + make_raw_lines(32, seed=1)
    raw = os.path.join(d, "raw.txt")
    with open(raw, "w") as f:
        f.write("\n".join(lines) + "\n")
    prefix = os.path.join(d, "repl")
    with contextlib.redirect_stdout(io.StringIO()):
        preprocess.main(["--train_data", raw, "--val_data", raw,
                         "--test_data", raw, "--max_contexts", "32",
                         "--output_name", prefix])
    ckpt = os.path.join(d, "ckpt")
    rc = cli.main(["--backend", "cpu", "--data", prefix, "--save", ckpt,
                   "--epochs", "2", "--batch_size", "16", "--max_contexts",
                   "32", "--tables_dtype", "float32", "--no_bf16",
                   "--async_checkpoint", "off", "--lr", "0.01"])
    assert rc == 0
    return {"dir": d, "input_java": input_java, "prefix": prefix,
            "ckpt": ckpt}


@pytest.fixture(scope="module")
def cohort_ranks(tmp_path_factory):
    import jax

    from code2vec_tpu.models import encoder as jenc
    from code2vec_tpu.models.jax_model import Code2VecModel as JaxModel
    from helpers import build_tiny_dataset, make_raw_lines
    from test_model import tiny_config
    from test_torch_multiprocess import _spawn

    from code2vec_tpu_torch.parallel.compat import free_port
    base = str(tmp_path_factory.mktemp("torch_cohort_predict"))
    rows = _rows(7)
    params = {enc: jax.tree_util.tree_map(np.asarray, jenc.init_params(
        jax.random.PRNGKey(i), _dims(jenc, enc)))
        for i, enc in enumerate(ENCODERS)}
    want = {enc: {n: _jax_predict(params[enc], enc, [a[:n] for a in rows])
                  for n in (N, 1)} for enc in ENCODERS}
    # the JAX package's model at MESH_MODEL_AXIS=2 over 8 host devices
    prefix = build_tiny_dataset(base, n_train=16, n_val=4, n_test=4,
                                max_contexts=16)
    jmodel = JaxModel(tiny_config(prefix, MESH_MODEL_AXIS=2))
    vocab = os.path.join(base, "vocab.pkl")
    jmodel.vocabs.save(vocab)
    lines = make_raw_lines(6, seed=5)
    jm_out = jmodel.predict_device(jmodel.prepare_predict_rows(lines))
    jax_model = {"params": jax.tree_util.tree_map(
        np.asarray, jax.device_get(jmodel.params)),
        "dims": dataclasses.asdict(jmodel.dims), "vocab": vocab,
        "lines": lines}
    world = build_repl_world(base)
    elsewhere = os.path.join(base, "elsewhere")
    os.makedirs(elsewhere)
    world.update(ports=[free_port(), free_port()], elsewhere=elsewhere,
                 work=world["dir"])
    dirs = {}
    for w in LAYOUTS:
        dirs[w] = os.path.join(base, f"w{w}")
        os.makedirs(dirs[w])
        with open(os.path.join(dirs[w], "inputs.pkl"), "wb") as f:
            pickle.dump({"params": params, "rows": rows,
                         "jax_model": jax_model, "cli": world}, f)
    # the two spawns together (each under its own timeout)
    with concurrent.futures.ThreadPoolExecutor(len(LAYOUTS)) as ex:
        futures = {w: ex.submit(_spawn, w, dirs[w],
                                "test_torch_cohort_predict:predict_worker")
                   for w in LAYOUTS}
        ranks = {w: f.result() for w, f in futures.items()}
    return want, jm_out, ranks, world


def assert_same_predictions(got, want):
    """(topk_ids, topk_probs, attention, code) of the port against the
    JAX package's: ids equal, probabilities within rtol 1e-5, attention
    and code vectors within atol 2e-5."""
    ids, probs, attn, code = got
    w_ids, w_probs, w_attn, w_code = want
    np.testing.assert_array_equal(ids, w_ids)
    np.testing.assert_allclose(probs, w_probs, rtol=1e-5, atol=0)
    np.testing.assert_allclose(attn, w_attn, rtol=0, atol=2e-5)
    np.testing.assert_allclose(code, w_code, rtol=0, atol=2e-5)


@pytest.mark.parametrize("layout,encoder", CASES)
def test_mesh_predictor_matches_one_jax_device(cohort_ranks, layout,
                                               encoder):
    """Every rank's `predict_device` on its mesh: the padded bucket of 5
    rows and one row padded to the batch shards, against JAX's
    one-device predict step on the same params and rows."""
    want, _j, ranks, _w = cohort_ranks
    for r in ranks[WORLD_OF[layout]]:
        for n in (N, 1):
            got = r[(layout, encoder)][n]
            assert got[0].shape == (n, K) and got[2].shape == (n, C)
            assert_same_predictions(got, want[encoder][n])


def test_model2_predictor_matches_the_jax_model_on_its_mesh(cohort_ranks):
    """The JAX `Code2VecModel` at MESH_MODEL_AXIS=2 (data 4 x model 2 over
    the 8 host devices) and the port's at model 2 on two ranks, over the
    same raw lines, params and vocabularies."""
    _w, jm_out, ranks, _x = cohort_ranks
    for r in ranks[2]:
        assert_same_predictions(r["jax_model"], jm_out)


_NUM = re.compile(r"-?\d+\.\d+")


def _answer_lines(out):
    """The REPL's printed lines but its latency lines, each split into
    its text (numbers blanked) and its numbers."""
    return [(_NUM.sub("#", ln), [float(x) for x in _NUM.findall(ln)])
            for ln in out.splitlines() if not ln.startswith("latency:")]


def assert_same_repl(got, want, tol=PRINT_TOL):
    """Rank 0's REPL lines against one process's: the same text; each
    number within `tol`; within a method's predictions a name may differ
    only from one whose probability lies within `tol` of it."""
    got, want = _answer_lines(got), _answer_lines(want)
    assert len(got) == len(want)
    i = 0
    while i < len(want):
        if want[i][0].startswith("\t(#) predicted:"):
            j = i
            while j < len(want) and want[j][0].startswith("\t(#) predicted:"):
                j += 1
            run = want[i:j]
            for (g_txt, g_num), (w_txt, w_num) in zip(got[i:j], run):
                assert abs(g_num[0] - w_num[0]) <= tol
                if g_txt != w_txt:
                    assert g_txt in {t for t, n in run
                                     if abs(n[0] - w_num[0]) <= tol}
            i = j
            continue
        assert got[i][0] == want[i][0], (got[i], want[i])
        np.testing.assert_allclose(got[i][1], want[i][1], rtol=0, atol=tol)
        i += 1


def _one_process_repl(world, tmp_path):
    work = tmp_path / "one"
    work.mkdir()
    shutil.copy(world["input_java"], work / "Input.java")
    return run_cli(["--backend", "cpu", "--load", world["ckpt"],
                    "--predict", "--no_bf16"], REPL_KEYS, str(work))


def test_cli_predict_on_two_ranks_prints_what_one_process_prints(
        cohort_ranks, tmp_path):
    """`cli.main --predict --mesh_model 2` on two ranks, stdin to rank 0:
    rank 0's output is one process's (latency lines aside), with the
    attack's answer; rank 1 prints no answer; both exit 0."""
    _w, _j, ranks, world = cohort_ranks
    rc, want = _one_process_repl(world, tmp_path)
    assert rc == 0
    (rc0, out0), (rc1, out1) = (r["cli"]["plain"] for r in ranks[2])
    assert rc0 == rc1 == 0
    assert sum(ln.startswith("Original name:")
               for ln in out0.splitlines()) >= 2
    assert any(ln.startswith(("[untargeted ", "Attack error:"))
               for ln in out0.splitlines())
    assert out0.rstrip().endswith("Exiting...")
    assert_same_repl(out0, want)
    assert out1 == ""


def test_rank0_errors_and_an_idle_prompt_leave_both_ranks_serving(
        cohort_ranks):
    """A missing Input.java, then a rank-0 ExtractorError (the
    `serve/extract` failpoint), then a prompt idle for longer than the
    process group's timeout: rank 0 prints each and answers the next
    Enter; rank 1 prints nothing; both exit 0."""
    _w, _j, ranks, _world = cohort_ranks
    (rc0, out0), (rc1, out1) = (r["cli"]["faulted"] for r in ranks[2])
    assert rc0 == rc1 == 0
    lines = out0.splitlines()
    assert "File not found: Input.java" in lines
    assert any(ln.startswith("Extraction error:") for ln in lines)
    assert sum(ln.startswith("Original name:") for ln in lines) >= 1
    assert lines[-1] == "Exiting..."
    assert out1 == ""
    assert ranks[2][1]["cli"]["faulted_s"] >= IDLE_S > IDLE_PG_TIMEOUT_S

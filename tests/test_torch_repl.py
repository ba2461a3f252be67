"""The `--predict` REPL of the port (serving/interactive_predict.py)
against the JAX package's, on the CPU.

Input.java goes through both REPLs with stdin piped (two Enters, then
`q`). Both use one model: the JAX package's, initialised on a vocabulary
built from Input.java's own path-contexts, its params carried into the
port with `convert.py`; both extract with the same binary, the port's
native extractor named by `C2V_EXTRACTOR`. A Python file also goes
through both servers with the Python frontend, and the command line's
`--predict` answers as the REPL does on the model it saved.

Tolerances (float32 compute, as tests/test_torch_predict.py states):
the printed lines are equal apart from the latency lines and the
numbers; each probability and attention score within 1e-5 of the
JAX one. Where two predictions of a method are within 1e-5 of each
other their order may differ; the name at each rank must then be one of
the near-tied names.
"""

import dataclasses
import json
import os
import re
import shutil

import jax
import numpy as np
import pytest

from code2vec_tpu.data import preprocess as jpreprocess
from code2vec_tpu.models.jax_model import Code2VecModel as JaxModel
from code2vec_tpu.serving import interactive_predict as jrepl
from code2vec_tpu.serving.server import PredictionServer as JaxServer
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.models.torch_model import Code2VecModel
from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.serving import interactive_predict as trepl
from code2vec_tpu_torch.serving.server import PredictionServer
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
from helpers import make_raw_lines
from test_model import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, E = 32, 16
TOL = 1e-5
PY_SOURCE = ("def read_all_lines(path, strip=True):\n"
             "    with open(path) as f:\n"
             "        return [ln.strip() for ln in f]\n\n"
             "def count_items(items):\n"
             "    total = 0\n    for x in items:\n        total += 1\n"
             "    return total\n")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's c2v_extract, a JAX model over a vocabulary of
    Input.java's and PY_SOURCE's path-contexts (and the synthetic
    corpus's), and the port's model on the same params."""
    try:
        _build.cxx_path()
    except _build.KernelBuildError as e:
        pytest.skip(f"no host C++ compiler to build the native extractor "
                    f"({e})")
    from code2vec_tpu.extractor import python_extractor
    from code2vec_tpu_torch.extractor import native
    binary = native.binary_path()
    d = tmp_path_factory.mktemp("repl")
    shutil.copy(os.path.join(REPO, "Input.java"), d / "Input.java")
    (d / "demo.py").write_text(PY_SOURCE)
    java = native.extract_source(open(d / "Input.java").read())
    # more method names than top-k, from the synthetic corpus
    lines = (java + python_extractor.extract_source(PY_SOURCE)) * 4 \
        + make_raw_lines(32, seed=1)
    raw = {}
    for split in ("train", "val", "test"):
        raw[split] = str(d / f"raw.{split}.txt")
        with open(raw[split], "w") as f:
            f.write("\n".join(lines) + "\n")
    prefix = str(d / "repl")
    jpreprocess.main(["--train_data", raw["train"], "--val_data",
                      raw["val"], "--test_data", raw["test"],
                      "--max_contexts", str(C), "--word_vocab_size", "1000",
                      "--path_vocab_size", "1000", "--target_vocab_size",
                      "1000", "--output_name", prefix])
    jcfg = tiny_config(prefix, MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E,
                       TABLES_DTYPE="float32", USE_BF16=False)
    jmodel = JaxModel(jcfg)
    vocab_path = str(d / "vocab.pkl")
    jmodel.vocabs.save(vocab_path)
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(jmodel.params))
    tcfg = Config(MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E,
                  TABLES_DTYPE="float32", USE_BF16=False)
    tmodel = Code2VecModel(
        tcfg, tenc.ModelDims(**dataclasses.asdict(jmodel.dims)),
        Code2VecVocabs.load(vocab_path),
        convert.params_from_numpy(host, device="cpu"), device="cpu")
    return dict(dir=d, binary=binary, jcfg=jcfg, jmodel=jmodel, tcfg=tcfg,
                tmodel=tmodel, n_java=len(java))


def _run_repl(predictor_cls, config, model, input_file, monkeypatch,
              capsys):
    keys = iter(["", "", "q"])
    monkeypatch.setattr("builtins.input", lambda *a: next(keys))
    predictor_cls(config, model).predict(input_file)
    return capsys.readouterr().out.splitlines()


_NUM = re.compile(r"\d+\.\d+")


def _blocks(out):
    """The REPL's lines without the latency lines, each split into its
    text (numbers blanked) and its numbers."""
    return [(_NUM.sub("#", ln), [float(x) for x in _NUM.findall(ln)])
            for ln in out if not ln.startswith("latency:")]


def _assert_same_lines(got, want):
    assert len(got) == len(want)
    i = 0
    while i < len(want):
        (gt, gn), (wt, wn) = got[i], want[i]
        if wt.startswith("\t(#) predicted:"):
            # one method's run of predictions, compared as a ranking
            j = i
            while j < len(want) and want[j][0].startswith("\t(#) predicted:"):
                j += 1
            g_run, w_run = got[i:j], want[i:j]
            w_probs = [n[0] for _t, n in w_run]
            for k, ((g_txt, g_num), (w_txt, w_num)) in enumerate(
                    zip(g_run, w_run)):
                assert abs(g_num[0] - w_num[0]) <= TOL
                if g_txt != w_txt:
                    tied = {w_run[m][0] for m in range(len(w_run))
                            if abs(w_probs[m] - w_num[0]) <= TOL}
                    assert g_txt in tied, (g_txt, w_txt)
            i = j
            continue
        assert gt == wt, (gt, wt)
        assert len(gn) == len(wn)
        np.testing.assert_allclose(gn, wn, atol=TOL)
        i += 1


def test_repl_prints_what_the_jax_repl_prints(world, monkeypatch, capsys):
    monkeypatch.setenv("C2V_EXTRACTOR", world["binary"])
    monkeypatch.chdir(world["dir"])
    want = _run_repl(jrepl.InteractivePredictor, world["jcfg"],
                     world["jmodel"], "Input.java", monkeypatch, capsys)
    got = _run_repl(trepl.InteractivePredictor, world["tcfg"],
                    world["tmodel"], "Input.java", monkeypatch, capsys)
    latency = [ln for ln in got if ln.startswith("latency: request ")]
    assert len(latency) == 2 and latency[1].endswith("over 2 requests")
    assert got[-1] == "Exiting..."
    assert sum(ln.startswith("Original name:") for ln in got) \
        == 2 * world["n_java"]
    runs = "".join("c" if "\tcontext: " in ln else "." for ln in got)
    assert max(len(r) for r in runs.split(".")) \
        <= trepl.SHOW_TOP_CONTEXTS < runs.count("c")
    _assert_same_lines(_blocks(got), _blocks(want))


def test_repl_attack_says_not_ported_and_goes_on(world, monkeypatch,
                                                 capsys):
    """`attack` and `attack <name>` run the source-level attack (its
    outcome, or `Attack error:` for a target out of the vocabulary), as
    the JAX REPL prints them, and the loop goes on to a prediction."""
    monkeypatch.setenv("C2V_EXTRACTOR", world["binary"])
    monkeypatch.chdir(world["dir"])

    def run(predictor_cls, config, model):
        keys = iter(["attack", "attack noSuchTargetName", ""])

        def fake_input(*a):
            try:
                return next(keys)
            except StopIteration:
                raise EOFError from None
        monkeypatch.setattr("builtins.input", fake_input)
        predictor_cls(config, model).predict()
        return capsys.readouterr().out.splitlines()
    want = run(jrepl.InteractivePredictor, world["jcfg"], world["jmodel"])
    out = run(trepl.InteractivePredictor, world["tcfg"], world["tmodel"])
    assert sum(ln.startswith("[untargeted ") for ln in out) == 1
    errors = [ln for ln in out if ln.startswith("Attack error:")]
    assert errors == ["Attack error: target name 'no|such|target|name' is "
                      "out of vocabulary"]
    assert not any("not ported" in ln for ln in out)
    assert sum(ln.startswith("Original name:") for ln in out) \
        == world["n_java"]
    assert out[-1] == "Exiting..."
    # the attack's lines as the JAX REPL prints them
    attack = [ln for ln in out if ln.startswith(("[untargeted ",
                                                 "source rewrites:",
                                                 "re-extracted ",
                                                 "Attack error:"))]
    assert attack == [ln for ln in want if ln.startswith((
        "[untargeted ", "source rewrites:", "re-extracted ",
        "Attack error:"))]


def test_python_file_through_both_servers(world):
    """demo.py through each server's extractor pool with the Python
    frontend: the same names, probabilities within 1e-5."""
    path = str(world["dir"] / "demo.py")
    js = JaxServer(world["jcfg"], world["jmodel"]).start(warmup=False)
    try:
        want = js.predict_file(path, deadline_ms=0, language="python")
    finally:
        js.close()
    with PredictionServer(world["tcfg"], world["tmodel"]) as ts:
        got = ts.predict_file(path, deadline_ms=0, language="python")
    assert [r.original_name for r in got] == \
        [r.original_name for r in want] == ["read|all|lines", "count|items"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            [p["probability"] for p in g.predictions],
            [p["probability"] for p in w.predictions], atol=TOL)
        assert g.predictions[0]["name"] == w.predictions[0]["name"]


def test_cli_predict_runs_the_repl_on_a_saved_model(world, tmp_path,
                                                    monkeypatch, capsys):
    """`python3 -m code2vec_tpu_torch --load <ckpt> --predict
    --telemetry_dir <d>` in process: the REPL answers Input.java with the
    saved model's predictions (those of the model it was saved from) and
    the serve run's event log ends with its summary."""
    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    tm = world["tmodel"]
    trainer = Code2VecTrainer(world["tcfg"], tm.vocabs, params=tm.params,
                              device="cpu", dims=tm.dims)
    trainer.save(str(tmp_path / "ckpt"))
    trainer.close_session()
    monkeypatch.setenv("C2V_EXTRACTOR", world["binary"])
    monkeypatch.chdir(world["dir"])
    want = _run_repl(trepl.InteractivePredictor, world["tcfg"], tm,
                     "Input.java", monkeypatch, capsys)
    keys = iter(["", "", "q"])
    monkeypatch.setattr("builtins.input", lambda *a: next(keys))
    rc = cli.main(["--backend", "cpu", "--load", str(tmp_path / "ckpt"),
                   "--predict", "--no_bf16", "--telemetry_dir",
                   str(tmp_path / "t")])
    assert rc == 0
    got = capsys.readouterr().out.splitlines()
    assert _blocks(got) == _blocks(want)
    (run,) = os.listdir(tmp_path / "t")
    with open(tmp_path / "t" / run / "events.jsonl") as f:
        kinds = [json.loads(ln)["kind"] for ln in f]
    assert kinds.count("request") == 2 and kinds[-1] == "summary"

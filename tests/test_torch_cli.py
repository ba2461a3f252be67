"""The port's command line (`python3 -m code2vec_tpu_torch`,
code2vec_tpu_torch/cli.py) driven in process with `--backend cpu`, at a
small width (64 training methods, E = 16, C = 20), and the JAX package's
checkpoints carried into it (tools/import_jax_checkpoint.py).

- train -> save per epoch -> evaluate -> release -> the w2v, t2v and
  code-vector exports, and the released model evaluating as the trained
  one did;
- a 2-epoch run interrupted after its first epoch's save, then rerun
  with `--auto_resume`, equals the uninterrupted run bit for bit:
  params, optimizer state, step and per-step losses (the port is
  deterministic on the CPU; dropout draws are keyed by step);
- `--backend` unset without CUDA, and the JAX package's flags the port
  does not have, exit 2 with an error naming them;
- a JAX checkpoint (float32 tables, 2 steps) imported by the tool gives
  the port the same params and optimizer state bit for bit, and the
  port's evaluation of the test file gives the JAX package's top-k ids
  and metrics, the loss within LOSS_RTOL;
- from the imported step-0 state, with dropout off (DROPOUT_KEEP_RATE
  1.0) and full softmax so that no random draw enters, both training
  loops over the same binary shards give per-step losses within
  LOSS_RTOL and final params within PARAM_TOL;
- one transformer run (L = 1) saved and loaded again.

Tolerances (float32): the JAX package runs on an 8-device CPU mesh, so
its batch means are sums of 8 partial sums, another order than the
port's one sum; each such sum is a few float32 ulp of its terms. The
loss (of order 1) is held within LOSS_RTOL = 1e-6 relative, and two
optimizer steps of Adafactor and Adam at LR 0.05 carry that into the
params (of order 0.1 to 1), held within PARAM_TOL = 1e-6 absolute.
Measured on the CPU: 8.7e-8 relative on the second step's loss (one
ulp), 4.5e-8 on the params (on `attention`); the evaluation's loss
agreed to the bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

from code2vec_tpu_torch import cli
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
from code2vec_tpu_torch.training import checkpoint as ckpt
from code2vec_tpu_torch.vocab.vocabularies import VocabType
from helpers import build_tiny_dataset
from torch_helpers import assert_topk_agree

E, C = 16, 20
LOSS_RTOL, PARAM_TOL = 1e-6, 1e-6


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_data")
    return build_tiny_dataset(str(d), n_train=64, n_val=16, n_test=24,
                              max_contexts=C, binarize=True)


@pytest.fixture(autouse=True)
def small_width(monkeypatch):
    """E = 16: the embedding size has no flag (in either package)."""
    real = Config.load_from_args.__func__

    def load(cls, args=None):
        cfg = real(cls, args)
        cfg.DEFAULT_EMBEDDINGS_SIZE = E
        return cfg
    monkeypatch.setattr(Config, "load_from_args", classmethod(load))


@pytest.fixture
def trainers(monkeypatch):
    """Every trainer the command line makes, and each step's loss."""
    made, losses = [], []
    real_from = Code2VecTrainer.from_config.__func__
    real_step = Code2VecTrainer.train_step

    def from_config(cls, *a, **k):
        t = real_from(cls, *a, **k)
        made.append(t)
        return t

    def train_step(self, batch, draws=None):
        loss = real_step(self, batch, draws)
        losses.append(loss.item())
        return loss
    monkeypatch.setattr(Code2VecTrainer, "from_config",
                        classmethod(from_config))
    monkeypatch.setattr(Code2VecTrainer, "train_step", train_step)
    return made, losses


def run(*argv):
    return cli.main(["--backend", "cpu", "--max_contexts", str(C),
                     *[str(a) for a in argv]])


def _same_state(a, b):
    ta, tb = ckpt.state_tensors(a), ckpt.state_tensors(b)
    assert len(ta) == len(tb) > 0
    return all(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
               for x, y in zip(ta, tb))


def _jax_w2v(trainer, path, vocab_type):
    """The JAX package's `save_word2vec_format` on the port's table."""
    from code2vec_tpu.models.model_base import Code2VecModelBase as JaxBase
    JaxBase.save_word2vec_format(trainer, path, vocab_type)


def test_vector_line_is_the_jax_text():
    from code2vec_tpu_torch.models.model_base import vector_line
    rng = np.random.default_rng(7)
    row = np.concatenate([
        rng.standard_normal(64) * 10.0 ** rng.integers(-8, 4, 64),
        # -0.0, the halfway cases of the sixth digit (exact in binary),
        # values of 10 and more, and the non-finite ones
        [-0.0, 0.0, 0.5e-6, -0.5e-6, 2.5e-6, 0.0000005, 0.125, -3.0000005,
         10.0, -99.9999995, 12345.678, 1e9, -3e12, np.inf, -np.inf, np.nan],
    ]).astype(np.float32)
    assert vector_line(row) == " ".join(f"{x:.6f}" for x in row)
    assert vector_line(row[:0]) == ""


def test_train_save_evaluate_release_export(dataset, tmp_path, trainers,
                                            capsys):
    made, _ = trainers
    ck, rel = str(tmp_path / "ck"), str(tmp_path / "rel")
    test = dataset + ".test.c2v"
    assert run("--data", dataset, "--test", dataset + ".val.c2v",
               "--save", ck, "--epochs", 2, "--batch_size", 16) == 0
    assert [s for s, _ in ckpt._step_dirs(ck)] == [4, 8]
    assert ckpt.verify_step(ck, 8) is True
    trained = made[-1]
    state = ckpt.load_checkpoint(ck)
    assert state["step"] == 8 == trained.step_num
    assert _same_state(state["params"], trained.params)
    capsys.readouterr()

    w2v, t2v = str(tmp_path / "tok.w2v"), str(tmp_path / "tgt.w2v")
    assert run("--load", ck, "--test", test, "--export_code_vectors",
               "--save_w2v", w2v, "--save_t2v", t2v) == 0
    before = capsys.readouterr().out.strip().splitlines()[-1]
    assert before.startswith("loss: ") and "F1:" in before
    vocabs = made[-1].vocabs
    for path, vocab, dim in ((w2v, vocabs.token_vocab, E),
                             (t2v, vocabs.target_vocab, 3 * E)):
        with open(path) as f:
            lines = f.read().splitlines()
        assert lines[0] == f"{vocab.size} {dim}"
        assert len(lines) == vocab.size + 1
        first = lines[1].split(" ")
        assert first[0] == "<PAD>" and len(first) == dim + 1
        vals = np.array([ln.split(" ")[1:] for ln in lines[1:]], float)
        assert np.isfinite(vals).all()
    # the token table's text is the JAX package's, character for character
    _jax_w2v(made[-1], str(tmp_path / "jax.w2v"), VocabType.Token)
    with open(w2v) as f, open(tmp_path / "jax.w2v") as g:
        assert f.read() == g.read()
    with open(test + ".vectors") as f:
        vectors = f.read().splitlines()
    assert len(vectors) == 24
    assert all(len(v.split(" ")) == 3 * E for v in vectors)

    assert run("--load", ck, "--release", "--save", rel) == 0
    assert ckpt.load_manifest(rel)["released"] is True
    assert set(ckpt.load_checkpoint(rel)) == {"params"}
    capsys.readouterr()
    assert run("--load", rel, "--test", test) == 0
    after = capsys.readouterr().out.strip().splitlines()[-1]
    assert after == before
    assert made[-1].step_num == 8


def test_interrupted_run_resumes_bit_for_bit(dataset, tmp_path, trainers,
                                             monkeypatch):
    """The same 2-epoch command (dense step, cosine LR, dropout on), once
    uninterrupted and once stopped at the first step of epoch 2 (after
    epoch 1's async save) and rerun with `--auto_resume`."""
    made, losses = trainers
    argv = ("--data", dataset, "--test", dataset + ".val.c2v",
            "--epochs", 2, "--batch_size", 16, "--tables_dtype",
            "bfloat16", "--auto_resume")
    whole = str(tmp_path / "whole")
    assert run(*argv, "--save", whole) == 0
    whole_losses = list(losses)
    assert len(whole_losses) == 8
    losses.clear()

    real_step = Code2VecTrainer.train_step  # the fixture's recording step

    def interrupted(self, batch, draws=None):
        if self.step_num == 4:
            raise KeyboardInterrupt("preempted")
        return real_step(self, batch, draws)
    monkeypatch.setattr(Code2VecTrainer, "train_step", interrupted)
    part = str(tmp_path / "part")
    with pytest.raises(KeyboardInterrupt):
        run(*argv, "--save", part)
    assert ckpt.latest_step(part) == 4
    monkeypatch.setattr(Code2VecTrainer, "train_step", real_step)
    first = list(losses)
    losses.clear()
    assert run(*argv, "--save", part) == 0
    resumed = made[-1]
    assert resumed.step_num == 8
    assert first + losses == whole_losses
    a, b = ckpt.load_checkpoint(whole), ckpt.load_checkpoint(part)
    assert a["step"] == b["step"] == 8
    assert _same_state(a, b)
    # a completed run rerun with --auto_resume trains nothing more
    losses.clear()
    assert run(*argv, "--save", part) == 0
    assert losses == [] and ckpt.latest_step(part) == 8


def test_backend_gpu_without_cuda_exits_2(dataset, tmp_path, monkeypatch,
                                          capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--data", dataset, "--save", str(tmp_path / "c")])
    assert rc == 2
    assert "CUDA" in capsys.readouterr().err
    assert not os.path.exists(str(tmp_path / "c"))


@pytest.mark.parametrize("flags,named", [
    (["--serve_port", "8080"], "--serve_port"),
    (["--head", "varmisuse"], "--head varmisuse"),
    (["--attack", "untargeted"], "--attack"),
    (["--infeed_chunk", "2"], "--infeed_chunk 2"),
    (["--mesh_data", "2"], "--mesh_data"),
    (["--serve_autoscale"], "--serve_autoscale"),
    (["--adv_rename_prob", "0.3"], "--adv_rename_prob"),
    (["--serve_replicas", "2"], "--serve_replicas"),
    (["--backend", "tpu"], "--backend tpu"),
])
def test_unported_flags_exit_2_naming_them(dataset, flags, named, capsys):
    rc = cli.main(["--data", dataset, "--backend", "cpu", *flags])
    assert rc == 2
    assert named in capsys.readouterr().err


def test_flags_the_port_has_take_the_jax_spelling():
    cfg = Config.load_from_args([
        "--data", "p", "--backend", "cpu", "--framework", "jax",
        "--head", "code2vec", "--infeed_chunk", "1", "--epochs", "3",
        "--batch_size", "8", "--lr", "0.5", "--lr_schedule",
        "warmup_cosine", "--warmup_steps", "2", "--infeed_prefetch", "0",
        "--async_checkpoint", "off", "--sampled_softmax", "--num_sampled",
        "7", "--tables_dtype", "int8", "--no_bf16", "--seed", "5"])
    assert (cfg.NUM_TRAIN_EPOCHS, cfg.TRAIN_BATCH_SIZE, cfg.LEARNING_RATE,
            cfg.LR_SCHEDULE, cfg.LR_WARMUP_STEPS, cfg.INFEED_PREFETCH,
            cfg.ASYNC_CHECKPOINT, cfg.USE_SAMPLED_SOFTMAX,
            cfg.NUM_SAMPLED_CLASSES, cfg.TABLES_DTYPE, cfg.USE_BF16,
            cfg.SEED, cfg.DL_FRAMEWORK) == (
        3, 8, 0.5, "warmup_cosine", 2, 0, False, True, 7, "int8", False,
        5, "jax")
    assert cfg.data_path("train") == "p.train.c2v"
    assert cfg.word_freq_dict_path == "p.dict.c2v"
    with pytest.raises(ValueError, match="release requires"):
        Config.load_from_args(["--data", "p", "--release"])
    cfg = Config.load_from_args([
        "--load", "m", "--predict", "--telemetry_dir", "t", "--trace",
        "--watchdog_stall_s", "30", "--watchdog_mode", "raise",
        "--profile", "pd", "--profile_steps", "4", "--tensorboard", "tb",
        "--faults", '{"sites": {}}', "--serve_batch_max", "16",
        "--serve_batch_timeout_ms", "0.5", "--serve_queue_depth", "9",
        "--serve_deadline_ms", "0", "--serve_cache_size", "3",
        "--serve_extract_workers", "4"])
    assert (cfg.is_predict, cfg.TELEMETRY_DIR, cfg.TRACE,
            cfg.WATCHDOG_STALL_S, cfg.WATCHDOG_MODE, cfg.PROFILE_DIR,
            cfg.PROFILE_STEPS, cfg.TENSORBOARD_DIR, cfg.FAULTS,
            cfg.SERVE_BATCH_MAX, cfg.SERVE_BATCH_TIMEOUT_MS,
            cfg.SERVE_QUEUE_DEPTH, cfg.SERVE_DEADLINE_MS,
            cfg.SERVE_CACHE_SIZE, cfg.SERVE_EXTRACT_WORKERS) == (
        True, "t", True, 30.0, "raise", "pd", 4, "tb", '{"sites": {}}', 16,
        0.5, 9, 0.0, 3, 4)
    for argv, match in ((["--data", "p", "--predict"], "predict requires"),
                        (["--load", "m", "--trace"], "trace requires"),
                        (["--load", "m", "--watchdog_stall_s", "5"],
                         "watchdog_stall_s requires"),
                        (["--load", "m", "--serve_batch_max", "12"],
                         "power of two")):
        with pytest.raises(ValueError, match=match):
            Config.load_from_args(argv)


def test_plane_selection_and_logging_flags_take_the_jax_spelling(tmp_path):
    """--metrics_port, --alerts_mode, --alerts_rules, --no_pallas,
    --requant_pallas, --sparse_update_pallas, -v and --logs-path parse
    to the JAX package's dests and values, and its verify refusals are
    the port's."""
    from code2vec_tpu.config import Config as JConfig
    argv = ["--data", "p", "--telemetry_dir", "t", "--metrics_port", "9",
            "--alerts_mode", "raise", "--alerts_rules", "r.json",
            "--no_pallas", "--requant_pallas", "reference",
            "--sparse_update_pallas", "fused", "-v", "0", "--logs-path",
            str(tmp_path / "l.log")]
    jns = JConfig.arguments_parser().parse_args(argv)
    ns = Config.arguments_parser().parse_args(["--backend", "cpu", *argv])
    for dest in ("metrics_port", "alerts_mode", "alerts_rules", "no_pallas",
                 "requant_pallas", "sparse_update_pallas", "verbose_mode",
                 "logs_path"):
        assert getattr(ns, dest) == getattr(jns, dest), dest
    cfg = Config.load_from_args(["--backend", "cpu", *argv])
    assert (cfg.METRICS_PORT, cfg.ALERTS_MODE, cfg.ALERTS_RULES,
            cfg.USE_PALLAS, cfg.REQUANT_PALLAS, cfg.SPARSE_UPDATE_PALLAS,
            cfg.VERBOSE_MODE, cfg.LOG_PATH, cfg.HEALTH_EVERY_S) == (
        9, "raise", "r.json", False, "reference", "fused", 0,
        str(tmp_path / "l.log"), 1.0)
    for extra, match in (
            (["--alerts_mode", "warn"], "alerts_mode warn/raise requires"),
            (["--telemetry_dir", "t", "--alerts_rules", "r.json"],
             "alerts_rules without"),
            (["--metrics_port", "70000"], r"metrics_port must be in")):
        with pytest.raises(ValueError, match=match):
            Config.load_from_args(["--data", "p", *extra])
        with pytest.raises(ValueError, match=match):
            JConfig.load_from_args(["--data", "p", *extra]).verify()


def test_fused_kernel_flags_on_the_cpu_exit_2_naming_them(dataset, capsys):
    """`--requant_pallas fused` and `--sparse_update_pallas fused` on
    `--backend cpu` are refused, naming the flag: the kernels run on the
    card, and nothing gives way to a plain version silently."""
    for flag in ("--requant_pallas", "--sparse_update_pallas"):
        rc = cli.main(["--data", dataset, "--backend", "cpu",
                       "--max_contexts", str(C), flag, "fused"])
        assert rc == 2
        assert f"{flag} fused" in capsys.readouterr().err


def test_logs_path_and_verbose_reach_the_log(dataset, tmp_path):
    """--logs-path appends the run's log to the file; -v 0 logs at
    WARNING (the INFO lines stay out of the file)."""
    import logging
    logger = logging.getLogger("code2vec_tpu_torch")
    try:
        for verbose, name in (("1", "info.log"), ("0", "quiet.log")):
            path = tmp_path / name
            rc = cli.main(["--data", dataset, "--backend", "cpu",
                           "--max_contexts", str(C), "--batch_size", "32",
                           "--epochs", "1", "-v", verbose, "--logs-path",
                           str(path)])
            assert rc == 0
            text = path.read_text() if path.exists() else ""
            assert ("model loaded" in text) == (verbose == "1"), text
    finally:
        for h in list(logger.handlers):
            if isinstance(h, logging.FileHandler):
                logger.removeHandler(h)
                h.close()
        logger.setLevel(logging.NOTSET)


@pytest.fixture(scope="module")
def jax_run(dataset, tmp_path_factory):
    """The JAX package's model (float32 tables and compute, dropout off,
    full softmax) saved at step 0, trained one epoch of 2 steps at
    B = 32, saved again: both dirs, the per-step losses and the final
    state as numpy."""
    from code2vec_tpu.models.jax_model import Code2VecModel
    from tests.test_model import tiny_config
    root = tmp_path_factory.mktemp("jax_ckpt")
    cfg = tiny_config(dataset, MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E,
                      TABLES_DTYPE="float32", USE_BF16=False,
                      DROPOUT_KEEP_RATE=1.0, NUM_TRAIN_EPOCHS=1,
                      TRAIN_BATCH_SIZE=32, TEST_BATCH_SIZE=8)
    cfg.test_data_path = None
    model = Code2VecModel(cfg)
    start, end = str(root / "step0"), str(root / "step2")
    model.save(start)
    losses = []
    step = model._train_step

    def recording(*a):
        out = step(*a)
        losses.append(float(out[2]))
        return out
    model._train_step = recording
    model.train()
    model.save(end)
    model.close_session()
    cfg.test_data_path = dataset + ".test.c2v"
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(
        {"params": model.params, "opt_state": model.opt_state}))
    return {"start": start, "end": end, "losses": losses, "model": model,
            "state": host, "step": model.step_num}


def _import(src, dest):
    import tools.import_jax_checkpoint as tool
    assert tool.main(["--jax_checkpoint", src, "--save", dest]) == 0


def test_imported_jax_checkpoint_loads_bit_for_bit_and_evaluates_alike(
        dataset, tmp_path, jax_run):
    from code2vec_tpu_torch import convert
    dest = str(tmp_path / "imported")
    _import(jax_run["end"], dest)
    with open(os.path.join(jax_run["end"], "manifest.json")) as f, \
            open(os.path.join(dest, "manifest.json")) as g:
        assert f.read() == g.read()
    with open(os.path.join(jax_run["end"], "vocab.pkl"), "rb") as f, \
            open(os.path.join(dest, "vocab.pkl"), "rb") as g:
        assert f.read() == g.read()
    assert ckpt.verify_step(dest, 2) is True
    cfg = Config.load_from_args(["--load", dest, "--backend", "cpu",
                                 "--test", dataset + ".test.c2v",
                                 "--no_bf16"])
    cfg.TEST_BATCH_SIZE = 8
    port = Code2VecTrainer.from_config(cfg, device="cpu")
    assert port.step_num == jax_run["step"] == 2
    want_p = jax_run["state"]["params"]
    got_p = convert.params_to_numpy(port.params)
    assert set(got_p) == set(want_p)
    for k in want_p:
        np.testing.assert_array_equal(got_p[k], want_p[k])
    want_o = jax.tree_util.tree_leaves(jax_run["state"]["opt_state"])
    got_o = jax.tree_util.tree_leaves(
        convert.dense_opt_state_to_numpy(port.opt_state))
    assert len(got_o) == len(want_o) > 0
    for a, b in zip(got_o, want_o):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    model = jax_run["model"]
    ref = model.evaluate()
    res = port.evaluate()
    assert res.topk_acc == ref.topk_acc
    assert (res.subtoken_precision, res.subtoken_recall, res.subtoken_f1) \
        == (ref.subtoken_precision, ref.subtoken_recall, ref.subtoken_f1)
    assert res.loss == pytest.approx(ref.loss, rel=LOSS_RTOL)
    # and batch by batch, the top-k ids and probabilities
    from code2vec_tpu.data.reader import open_reader as jax_open
    from code2vec_tpu_torch.data.reader import BatchTensors
    from code2vec_tpu_torch.training.steps import eval_step
    for b in jax_open(dataset + ".test.c2v", model.vocabs, C, 8):
        _l, ids_j, probs_j = model._eval_step(model.params,
                                              model._device_batch(b))
        _lp, ids_p, probs_p = eval_step(
            port.params, port.device_batch(BatchTensors(*b)),
            dims=port.dims, top_k=10)
        nv = b.num_valid_examples
        assert_topk_agree(ids_p[:nv].numpy(), probs_p[:nv].numpy(),
                          np.asarray(ids_j)[:nv], np.asarray(probs_j)[:nv],
                          tol=1e-6)


def test_training_from_an_imported_state_follows_the_jax_loop(
        dataset, tmp_path, jax_run):
    """The port's loop from the imported step-0 checkpoint over the same
    binary shard (one epoch of 2 steps at B = 32; the same cosine
    horizon): per-step losses within LOSS_RTOL and final params within
    PARAM_TOL of the JAX loop's."""
    from code2vec_tpu_torch import convert
    dest = str(tmp_path / "imported0")
    _import(jax_run["start"], dest)
    cfg = Config.load_from_args(["--load", dest, "--data", dataset,
                                 "--backend", "cpu", "--epochs", "1",
                                 "--batch_size", "32", "--no_bf16",
                                 "--lr", "0.05", "--max_contexts", str(C)])
    port = Code2VecTrainer.from_config(cfg, device="cpu")
    assert port.step_num == 0 and port.dims.dropout_keep_rate == 1.0
    losses = port.train()
    assert len(losses) == len(jax_run["losses"]) == 2
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=LOSS_RTOL)
    got = convert.params_to_numpy(port.params)
    for k, want in jax_run["state"]["params"].items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=PARAM_TOL,
                                   err_msg=k)
    moved = np.abs(got["transform"] - convert.params_to_numpy(
        Code2VecTrainer.from_config(cfg, device="cpu").params)["transform"])
    assert moved.max() > 100 * PARAM_TOL  # the steps moved the params


def test_transformer_run_saves_and_loads(dataset, tmp_path, trainers):
    made, _ = trainers
    ck = str(tmp_path / "xf")
    assert run("--data", dataset, "--save", ck, "--epochs", 1,
               "--batch_size", 32, "--encoder", "transformer",
               "--xf_layers", 1, "--xf_heads", 3) == 0
    trained = made[-1]
    assert ckpt.latest_step(ck) == 2
    assert run("--load", ck, "--test", dataset + ".test.c2v") == 0
    loaded = made[-1]
    assert loaded.dims == trained.dims and loaded.dims.encoder_type == \
        "transformer" and loaded.dims.xf_layers == 1
    assert _same_state({"p": loaded.params, "o": loaded.opt_state},
                       {"p": trained.params, "o": trained.opt_state})
    assert loaded.step_num == trained.step_num == 2

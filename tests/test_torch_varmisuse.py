"""The port's VarMisuse head end to end against the JAX package's: the
`.vm.c2v` reader and vocabularies, the dataset generator, the trainer
(models/vm_model.py), the `--head` rules and command line, a JAX
VarMisuse checkpoint carried across (tools/import_jax_checkpoint.py),
and `make_vm_probes` under `--phase_profile`. All on the CPU
(`device="cpu"`, `--backend cpu`), at the JAX test's width (E = 32,
C = 64, K = 6, B = 32).

Tolerances, each test repeating its own:
- the reader, the vocabularies and the generator: equal, array for
  array and row for row (the generator through the port's native
  extractor on both sides; the JAX one takes it as its `extract`);
- the trainer: at least 0.7 validation accuracy after 8 epochs (chance
  is 0.2 with 5 live candidates), as the JAX test asks; a reload
  evaluates to the same accuracy, bit for bit state;
- a JAX checkpoint carried across: params and optimizer state bit for
  bit; the port's evaluation of it against the JAX model's, accuracy
  equal and loss within 1e-6 relative (the JAX package evaluates on an
  8-device CPU mesh, whose batch sums add in another order);
- `--auto_resume` and `--phase_profile on`: the final state the same
  bits as the uninterrupted, unprofiled run's.
"""

import json
import os
import random
import shutil

import jax
import numpy as np
import pytest
import torch

from code2vec_tpu.config import Config as JConfig
from code2vec_tpu.data import varmisuse_gen as jgen
from code2vec_tpu.data import vm_reader as jreader
from code2vec_tpu_torch import cli, convert
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data import varmisuse_gen as tgen
from code2vec_tpu_torch.data import vm_reader as treader
from code2vec_tpu_torch.models.vm_model import VarMisuseModel
from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.training import checkpoint as ckpt

C, E, K, B = 64, 32, 6, 32
SETTINGS = dict(MAX_CONTEXTS=C, MAX_TOKEN_VOCAB_SIZE=1000,
                MAX_PATH_VOCAB_SIZE=2000, MAX_TARGET_VOCAB_SIZE=10,
                DEFAULT_EMBEDDINGS_SIZE=E, TRAIN_BATCH_SIZE=B,
                TEST_BATCH_SIZE=B, NUM_TRAIN_EPOCHS=8, SAVE_EVERY_EPOCHS=100,
                NUM_BATCHES_TO_LOG_PROGRESS=1000, LEARNING_RATE=0.02,
                USE_BF16=False, HEAD="varmisuse", MAX_CANDIDATES=K)
# the command line's flags for SETTINGS (E, the vocab caps, the test
# batch and the boundary cadence have none: `small_width` sets them)
CLI_FLAGS = ["--backend", "cpu", "--head", "varmisuse", "--max_contexts",
             str(C), "--batch_size", str(B), "--lr", "0.02", "--no_bf16",
             "--max_candidates", str(K)]


def vm_config(prefix, **kw):
    cfg = Config(**SETTINGS)
    cfg.train_data_path = prefix
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _native():
    """The port's native extractor (built at first use), or a skip."""
    try:
        _build.cxx_path()
    except _build.KernelBuildError as e:
        pytest.skip(f"no host C++ compiler to build the native extractor "
                    f"({e})")
    from code2vec_tpu_torch.extractor import native
    return native


@pytest.fixture(scope="module")
def vm_dataset(tmp_path_factory):
    _native()
    prefix = os.path.join(str(tmp_path_factory.mktemp("vm")), "vm")
    tgen.write_vm_dataset(prefix, n_train=1200, n_val=150, n_test=100,
                          seed=11)
    return prefix


# ---- the reader and the vocabularies ----

def _rows(r, n):
    """`.vm.c2v` rows: 3 to 7 candidates (a label past K = 4 cut in some),
    0 to 30 contexts (some over C = 16, some empty or pathless)."""
    words = [f"w{i}" for i in range(40)]
    rows = []
    for _ in range(n):
        cands = list(r.choice(words, int(r.integers(3, 8)), replace=False))
        label = int(r.integers(0, len(cands)))
        ctxs = []
        for _ in range(int(r.integers(0, 31))):
            kind = r.random()
            if kind < 0.05:
                ctxs.append(",,")
            elif kind < 0.1:
                ctxs.append(f"{r.choice(words)},,{r.choice(words)}")
            else:
                ctxs.append(f"{r.choice(words)},p{int(r.integers(0, 25))},"
                            f"{r.choice(words)}")
        rows.append(" ".join([str(label), ",".join(cands), *ctxs]))
    return rows


@pytest.fixture
def vm_file(tmp_path):
    path = str(tmp_path / "r.train.vm.c2v")
    rows = _rows(np.random.default_rng(4), 40)
    assert any(int(r.split(" ")[0]) >= 4 for r in rows)  # a cut label
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path, rows


def test_build_vm_vocabs_matches_jax(vm_file):
    path, _rows_ = vm_file
    jv = jreader.build_vm_vocabs(path, 30, 20)
    tv = treader.build_vm_vocabs(path, 30, 20)
    for name in ("token_vocab", "path_vocab", "target_vocab"):
        assert getattr(tv, name).word_to_index == \
            getattr(jv, name).word_to_index, name


def test_parse_vm_rows_matches_jax(vm_file):
    path, rows = vm_file
    jv = jreader.build_vm_vocabs(path, 30, 20)
    tv = treader.build_vm_vocabs(path, 30, 20)
    got = treader.parse_vm_rows(rows, tv, 16, 4)
    ref = jreader.parse_vm_rows(rows, jv, 16, 4)
    assert len(got) == len(ref) == 9
    for a, b in zip(got[:8], ref[:8]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[8] == ref[8]
    assert (got[7] == 0).any()  # a row whose label was cut


@pytest.mark.parametrize("shuffle", [False, True])
def test_vm_reader_batches_match_jax(vm_file, shuffle):
    """Two passes of 16-row batches over 40 rows (the last one padded,
    its padded rows keeping candidate 0 live), shuffled or not, from
    epoch 1: every field of every batch equal."""
    path, _rows_ = vm_file
    jv = jreader.build_vm_vocabs(path, 30, 20)
    tv = treader.build_vm_vocabs(path, 30, 20)
    jr = jreader.VMTextReader(path, jv, 16, 4, 16, shuffle=shuffle, seed=3,
                              epoch_offset=1)
    tr = treader.VMTextReader(path, tv, 16, 4, 16, shuffle=shuffle, seed=3,
                              epoch_offset=1)
    for _ in range(2):
        got, ref = list(tr), list(jr)
        assert [b.num_valid_examples for b in got] == \
            [b.num_valid_examples for b in ref] == [16, 16, 8]
        for tb, jb in zip(got, ref):
            for field in jreader.VMBatch._fields:
                a, b = getattr(tb, field), getattr(jb, field)
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype, field
                    np.testing.assert_array_equal(a, b, err_msg=field)
                else:
                    assert a == b, field
    last = got[-1]
    assert (last.cand_mask[8:, 0] == 1).all()
    weights = last.host_arrays()[-1]
    np.testing.assert_array_equal(weights[8:], 0)
    np.testing.assert_array_equal(weights[:8], last.row_valid[:8])


# ---- the generator ----

def test_make_vm_source_matches_jax():
    """The same `random.Random` seed gives the same sources, candidates
    and labels, 20 methods from each of 25 seeds."""
    for seed in range(25):
        jr, tr = random.Random(seed), random.Random(seed)
        for _ in range(20):
            assert tgen.make_vm_source(tr) == jgen.make_vm_source(jr)


def test_make_vm_rows_match_jax():
    """`make_vm_rows` for three seeds: the port's rows (its native
    extractor by default) equal the JAX generator's given that
    extractor."""
    native = _native()
    for seed in (0, 5, 99):
        assert tgen.make_vm_rows(25, seed=seed) == jgen.make_vm_rows(
            25, seed=seed, extract=native.extract_source)


# ---- the trainer ----

def test_vm_training_beats_chance_and_roundtrips(vm_dataset, tmp_path):
    """The port of the JAX test: 8 epochs reach 0.7 validation accuracy
    (chance 0.2) with the loss down; the saved checkpoint loads at the
    same step with the same params and optimizer state (bits) and the
    same accuracy; `predict_batch` on 25 unseen rows beats 0.5."""
    ckpt_dir = str(tmp_path / "ckpt")
    cfg = vm_config(vm_dataset, save_path=ckpt_dir)
    cfg.test_data_path = vm_dataset + ".val.vm.c2v"
    model = VarMisuseModel.from_config(cfg, device="cpu")
    before = model.evaluate()
    model.train()
    after = model.evaluate()
    assert after.loss < before.loss
    assert after.accuracy >= 0.7, after
    assert after.num_examples == 150
    model.save(ckpt_dir)
    model.close_session()

    cfg2 = vm_config(vm_dataset, LR_SCHEDULE="constant")
    cfg2.train_data_path = None
    cfg2.load_path = ckpt_dir
    cfg2.test_data_path = vm_dataset + ".val.vm.c2v"
    model2 = VarMisuseModel.from_config(cfg2, device="cpu")
    assert model2.step_num == model.step_num == 8 * 38
    assert cfg2.LR_SCHEDULE == "cosine"  # the manifest's
    for a, b in zip(ckpt.state_tensors({"p": model.params,
                                        "s": model.opt_state}),
                    ckpt.state_tensors({"p": model2.params,
                                        "s": model2.opt_state})):
        assert torch.equal(a, b)
    assert model2.evaluate().accuracy == after.accuracy

    rows = tgen.make_vm_rows(25, seed=99)
    pred = model2.predict_batch(rows)
    assert pred.shape == (25,)
    labels = [int(r.split(" ")[0]) for r in rows]
    assert np.mean([p == lb for p, lb in zip(pred, labels)]) >= 0.5


def test_vm_cosine_schedule_trains(vm_dataset, tmp_path):
    """--lr_schedule reaches the vm head (its horizon from the `.vm.c2v`
    split's rows); a load restores the schedule of the manifest over a
    conflicting request."""
    cfg = vm_config(vm_dataset, NUM_TRAIN_EPOCHS=3, LR_SCHEDULE="cosine")
    cfg.save_path = str(tmp_path / "vmck")
    m = VarMisuseModel.from_config(cfg, device="cpu")
    m.train()
    assert m.total_steps == 3 * 38
    m.save()
    m.close_session()
    res = m.evaluate(vm_dataset + ".train.vm.c2v")
    assert res.accuracy > 0.3
    cfg2 = vm_config(vm_dataset, LR_SCHEDULE="constant")
    cfg2.train_data_path = None
    cfg2.load_path = str(tmp_path / "vmck")
    cfg2.test_data_path = "unused"
    VarMisuseModel.from_config(cfg2, device="cpu")
    assert cfg2.LR_SCHEDULE == "cosine"


def test_vm_sparse_row_training_learns_and_roundtrips(vm_dataset, tmp_path):
    """--sparse_embeddings on the vm head (Adam, constant LR): the tables
    train through rows_from_dense, the accuracy beats chance after 2
    epochs, and the {dense, rows, count} state saves and loads bit for
    bit with the manifest's sparse flag."""
    cfg = vm_config(vm_dataset, NUM_TRAIN_EPOCHS=2,
                    SPARSE_EMBEDDING_UPDATES=True, EMBEDDING_OPTIMIZER="adam",
                    LR_SCHEDULE="constant", LEARNING_RATE=0.01)
    cfg.save_path = str(tmp_path / "sp")
    m = VarMisuseModel.from_config(cfg, device="cpu")
    assert set(m.opt_state) == {"dense", "rows", "count"}
    assert set(m.opt_state["rows"]) == {"token_emb", "path_emb"}
    start = m.params["token_emb"].clone()
    m.train()
    m.save()
    m.close_session()
    assert int(m.opt_state["count"]) == 2 * 38
    assert not torch.equal(start, m.params["token_emb"])
    assert m.evaluate(vm_dataset + ".val.vm.c2v").accuracy > 0.3
    cfg2 = vm_config(vm_dataset)
    cfg2.train_data_path = None
    cfg2.load_path = cfg.save_path
    m2 = VarMisuseModel.from_config(cfg2, device="cpu")
    assert cfg2.SPARSE_EMBEDDING_UPDATES and \
        cfg2.EMBEDDING_OPTIMIZER == "adam"
    for a, b in zip(ckpt.state_tensors({"p": m.params, "s": m.opt_state}),
                    ckpt.state_tensors({"p": m2.params, "s": m2.opt_state})):
        assert torch.equal(a, b)


def test_vm_trainer_refuses_a_config_of_the_other_head(vm_dataset):
    with pytest.raises(ValueError, match="trains 'varmisuse'"):
        VarMisuseModel.from_config(vm_config(vm_dataset, HEAD="code2vec"),
                                   device="cpu")


# ---- the --head rules, in both packages ----

CODE2VEC_ONLY = ("--predict/--release/--save_w2v/--save_t2v/"
                 "--export_code_vectors apply to the code2vec head only.")


@pytest.mark.parametrize("flags,port_says", [
    (["--load", "x", "--predict"], CODE2VEC_ONLY),
    (["--load", "x", "--release"], CODE2VEC_ONLY),
    (["--save_w2v", "w"], CODE2VEC_ONLY),
    (["--save_t2v", "t"], CODE2VEC_ONLY),
    (["--load", "x", "--test", "t", "--export_code_vectors"], CODE2VEC_ONLY),
    (["--tables_dtype", "int8"],
     "--tables_dtype int8 supports the code2vec head only."),
    (["--adv_rename_prob", "0.3"],
     "--adv_rename_prob applies to the code2vec head only (the varmisuse "
     "train step has no augmentation hook)."),
    (["--load", "x", "--attack", "untargeted"],
     "--attack applies to the code2vec head only."),
    (["--encoder", "transformer"],
     "--head varmisuse supports the bag encoder only"),
], ids=["predict", "release", "save_w2v", "save_t2v", "export_code_vectors",
        "int8", "adv_rename_prob", "attack", "transformer"])
def test_head_rules_refuse_what_the_jax_package_refuses(flags, port_says):
    """Each combination the JAX package's verify refuses with --head
    varmisuse is refused by the port's command line too, with the same
    message; without --head varmisuse both accept it."""
    argv = ["--data", "p", "--head", "varmisuse", "--backend", "cpu", *flags]
    with pytest.raises(ValueError) as jax_err:
        JConfig.load_from_args(argv)
    with pytest.raises(ValueError) as port_err:
        Config.load_from_args(argv)
    assert port_says in str(port_err.value)
    assert str(port_err.value) == str(jax_err.value)
    code2vec = [a for a in argv if a not in ("--head", "varmisuse")]
    Config.load_from_args(code2vec)


# ---- the command line ----

@pytest.fixture
def small_width(monkeypatch):
    """E = 32, the vocab caps and the test batch of SETTINGS, which have
    no flag (in either package); and every model the command line
    builds."""
    real = Config.load_from_args.__func__
    made = []

    def load(cls, args=None):
        cfg = real(cls, args)
        for k in ("DEFAULT_EMBEDDINGS_SIZE", "MAX_TOKEN_VOCAB_SIZE",
                  "MAX_PATH_VOCAB_SIZE", "TEST_BATCH_SIZE",
                  "NUM_BATCHES_TO_LOG_PROGRESS"):
            setattr(cfg, k, SETTINGS[k])
        return cfg
    monkeypatch.setattr(Config, "load_from_args", classmethod(load))
    real_from = VarMisuseModel.from_config.__func__

    def from_config(cls, *a, **k):
        m = real_from(cls, *a, **k)
        made.append(m)
        return m
    monkeypatch.setattr(VarMisuseModel, "from_config",
                        classmethod(from_config))
    return made


def _bits_equal(a, b):
    ta, tb = ckpt.state_tensors(a), ckpt.state_tensors(b)
    return len(ta) == len(tb) > 0 and all(
        torch.equal(x, y) for x, y in zip(ta, tb))


def test_cli_trains_saves_loads_and_evaluates(vm_dataset, tmp_path,
                                              small_width, capsys):
    """`--head varmisuse --data --save --test`: 8 epochs, the last one's
    evaluation at 0.7 accuracy or more; `--load --test` (no --head: the
    manifest's) prints the same accuracy; `--load --head code2vec` and
    `--head varmisuse --tables_dtype int8` exit 2."""
    save = str(tmp_path / "cli")
    val = vm_dataset + ".val.vm.c2v"
    assert cli.main([*CLI_FLAGS, "--data", vm_dataset, "--save", save,
                     "--test", val, "--epochs", "8"]) == 0
    trained = small_width[-1]
    assert trained.step_num == 8 * 38 and ckpt.latest_step(save) == 8 * 38
    res = trained.evaluate(val)
    assert res.accuracy >= 0.7, res
    with open(os.path.join(save, "manifest.json")) as f:
        manifest = json.load(f)
    assert (manifest["head"], manifest["max_candidates"],
            manifest["embedding_optimizer"], manifest["lr_schedule"]) == (
        "varmisuse", K, "adafactor", "cosine")
    capsys.readouterr()
    # the compute dtype is a flag, not a checkpoint key
    assert cli.main(["--backend", "cpu", "--load", save, "--test", val,
                     "--no_bf16"]) == 0
    assert str(res) in capsys.readouterr().out
    assert _bits_equal(small_width[-1].params, trained.params)
    assert cli.main(["--backend", "cpu", "--load", save, "--head",
                     "code2vec", "--test", val]) == 2
    assert ("checkpoint was trained with --head varmisuse, but --head "
            "code2vec was given") in capsys.readouterr().err
    assert cli.main([*CLI_FLAGS, "--data", vm_dataset, "--tables_dtype",
                     "int8"]) == 2
    assert "int8 supports the code2vec head only" in capsys.readouterr().err


def test_cli_auto_resume_is_bit_identical(vm_dataset, tmp_path,
                                          small_width):
    """2 epochs saved at each boundary; the last step set aside and the
    same command rerun with --auto_resume: it trains the second epoch
    again and ends in the uninterrupted run's state, bits."""
    save = str(tmp_path / "run")
    argv = [*CLI_FLAGS, "--data", vm_dataset, "--save", save, "--epochs",
            "2", "--auto_resume"]
    assert cli.main(argv) == 0
    full = small_width[-1]
    assert full.step_num == 76 and ckpt.latest_step(save) == 76
    shutil.rmtree(os.path.join(save, "step_76"))
    assert ckpt.latest_step(save) == 38
    assert cli.main(argv) == 0
    resumed = small_width[-1]
    assert resumed is not full and resumed.step_num == 76
    assert _bits_equal({"p": full.params, "s": full.opt_state},
                       {"p": resumed.params, "s": resumed.opt_state})


def test_profiled_vm_run_ends_in_the_unprofiled_bits(vm_dataset, tmp_path):
    """Two 6-step runs, one with PHASE_PROFILE on (sample every 2 steps,
    a telemetry dir): the same final bits, and the profiled run's
    phases are make_vm_probes' (embed_gather, forward_pool, backward and
    table_apply as the remainder), timed at steps 2 and 4, with no
    analytic bytes."""
    states = {}
    tele = str(tmp_path / "tele")
    for mode in ("off", "on"):
        kw = dict(PHASE_PROFILE="on", PHASE_SAMPLE_EVERY=2,
                  TELEMETRY_DIR=tele) if mode == "on" else {}
        m = VarMisuseModel.from_config(vm_config(vm_dataset, **kw),
                                       device="cpu")
        m.train(max_steps=6)
        states[mode] = {"p": m.params, "s": m.opt_state}
    assert _bits_equal(states["off"], states["on"])
    (run,) = os.listdir(tele)
    with open(os.path.join(tele, run, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    assert [e["step"] for e in events if e["kind"] == "phase"] == [2, 4]
    summary = [e for e in events if e["kind"] == "summary"][-1]
    for p in ("embed_gather", "forward_pool", "backward", "table_apply"):
        assert summary["timers"][f"train/phase/{p}_ms"]["count"] == 2, p
    assert "train/phase/concat_dense_ms" not in summary["timers"]
    assert not any(g.startswith("train/phase_bytes/")
                   for g in summary["gauges"])


# ---- a JAX VarMisuse checkpoint carried across ----

def test_jax_vm_checkpoint_carries_across(tmp_path):
    """A JAX VarMisuseModel (float32, the default Adafactor + Adam chain,
    cosine LR) trained one epoch of 3 steps and saved; the import tool
    reads its manifest's head and restores it through the JAX
    VarMisuseModel; the port loads the same params and optimizer state,
    bits, at the same step, and evaluates the validation file to the JAX
    model's accuracy (equal) and loss (within 1e-6 relative)."""
    _native()
    from code2vec_tpu.models.vm_model import VarMisuseModel as JVM
    import tools.import_jax_checkpoint as tool
    prefix = str(tmp_path / "small")
    tgen.write_vm_dataset(prefix, n_train=96, n_val=40, n_test=8, seed=21)
    jcfg = JConfig(**dict(SETTINGS, MESH_MODEL_AXIS=1,
                          TABLES_DTYPE="float32", NUM_TRAIN_EPOCHS=1))
    jcfg.train_data_path = prefix
    jcfg.test_data_path = prefix + ".val.vm.c2v"
    jm = JVM(jcfg)
    jm.train()
    src = str(tmp_path / "jax_ckpt")
    jm.save(src)
    jm.close_session()
    dest = str(tmp_path / "port_ckpt")
    assert tool.main(["--jax_checkpoint", src, "--save", dest]) == 0

    cfg = Config.load_from_args(["--load", dest, "--backend", "cpu",
                                 "--test", prefix + ".val.vm.c2v",
                                 "--no_bf16"])
    cfg.TEST_BATCH_SIZE = B
    port = VarMisuseModel.from_config(cfg, device="cpu")
    assert (cfg.HEAD, cfg.MAX_CANDIDATES) == ("varmisuse", K)
    assert port.step_num == jm.step_num == 3
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(
        {"params": jm.params, "opt_state": jm.opt_state}))
    got_p = convert.params_to_numpy(port.params)
    assert set(got_p) == set(host["params"]) and "vm_pointer" in got_p
    for k, v in host["params"].items():
        np.testing.assert_array_equal(got_p[k], v)
    want = jax.tree_util.tree_leaves(host["opt_state"])
    got = jax.tree_util.tree_leaves(
        convert.dense_opt_state_to_numpy(port.opt_state))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ref, res = jm.evaluate(), port.evaluate()
    assert res.num_examples == ref.num_examples == 40
    assert res.accuracy == ref.accuracy
    assert res.loss == pytest.approx(ref.loss, rel=1e-6)


def test_vm_model_and_command_line_default_to_the_card(vm_dataset,
                                                       monkeypatch, capsys):
    """Without a CUDA card, `VarMisuseModel` with device=None raises and
    `--head varmisuse` without `--backend cpu` exits 2; neither falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VarMisuseModel.from_config(vm_config(vm_dataset))
    assert cli.main(["--head", "varmisuse", "--data", vm_dataset]) == 2
    assert "CUDA" in capsys.readouterr().err

"""The port's checkpoint protocol (code2vec_tpu_torch/training/
checkpoint.py, resilience/retry.py), held to the JAX package's tests of
its own (tests/test_async_checkpoint.py, the checkpoint tests of
tests/test_model.py): the step-dir layout and a manifest with the JAX
package's keys, MAX_TO_KEEP pruning, a torn dir invisible to
`latest_step`, a crash before the commit keeping the previous step,
quarantine of a corrupt latest step with fall-back and
`CheckpointCorrupt` for an explicit one, ENOSPC given up and EIO
retried, a second async submit that blocks and drops nothing, the
snapshot taken at submit time, sidecars written once and a release of
params only at the right step. The state files load with
`torch.load(weights_only=True)` for float32, bf16 and int8 tables and
for the dense and the sparse optimizer states, bit for bit.
"""

import errno
import json
import os
import threading
import time

import pytest
import torch

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
from code2vec_tpu_torch.resilience.retry import RetryPolicy
from code2vec_tpu_torch.training import checkpoint as ckpt
from code2vec_tpu_torch.training import optimizers as topt
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
from helpers import build_tiny_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_data")
    return build_tiny_dataset(str(d), n_train=64, n_val=8, n_test=16,
                              max_contexts=16)


@pytest.fixture(scope="module")
def vocabs(dataset):
    return Code2VecVocabs.load_from_dict_file(dataset + ".dict.c2v",
                                              1000, 1000, 1000)


def _config(**kw):
    base = dict(MAX_CONTEXTS=16, DEFAULT_EMBEDDINGS_SIZE=8,
                TRAIN_BATCH_SIZE=16, TEST_BATCH_SIZE=16,
                TABLES_DTYPE="float32", USE_BF16=False, MAX_TO_KEEP=10)
    base.update(kw)
    return Config(**base)


def _trainer(vocabs, **kw):
    return Code2VecTrainer(_config(**kw), vocabs, device="cpu")


def _assert_same_state(a, b):
    assert ckpt.map_state(lambda t: (t.shape, t.dtype), a) == \
        ckpt.map_state(lambda t: (t.shape, t.dtype), b)
    ta, tb = ckpt.state_tensors(a), ckpt.state_tensors(b)
    assert len(ta) == len(tb) > 0
    for x, y in zip(ta, tb):
        assert torch.equal(x.cpu(), y.cpu())


def test_layout_and_manifest_keys_match_the_jax_package(dataset, vocabs,
                                                        tmp_path):
    """A save writes `step_<N>/{state/state.pt, checksums.json,
    topology.json}`, `vocab.pkl` and `manifest.json`; the manifest has
    the keys of the JAX package's (its `_build_manifest` and
    `Code2VecModel.save`'s extras) with the same values for the same
    dims and configuration."""
    from code2vec_tpu.models.jax_model import Code2VecModel
    from tests.test_model import tiny_config
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcfg = tiny_config(dataset, DEFAULT_EMBEDDINGS_SIZE=8,
                       TRAIN_BATCH_SIZE=16, TABLES_DTYPE="float32")
    jmodel = Code2VecModel(jcfg)
    jmodel.save(jdir)
    jmodel.close_session()
    trainer = _trainer(vocabs)
    trainer.save(tdir)
    trainer.close_session()
    with open(os.path.join(jdir, "manifest.json")) as f:
        jm = json.load(f)
    with open(os.path.join(tdir, "manifest.json")) as f:
        tm = json.load(f)
    assert set(tm) == set(jm)
    for key in ("token_vocab_size", "path_vocab_size", "target_vocab_size",
                "embeddings_size", "max_contexts", "dropout_keep_rate",
                "vocab_pad_multiple", "tables_dtype", "encoder_type",
                "use_sampled_softmax", "num_sampled", "embedding_optimizer",
                "sparse_embedding_updates", "trust_ratio", "lr_schedule",
                "step"):
        assert tm[key] == jm[key], key
    assert sorted(os.listdir(tdir)) == ["manifest.json", "step_0",
                                        "vocab.pkl"]
    assert sorted(os.listdir(os.path.join(tdir, "step_0"))) == [
        "checksums.json", "state", "topology.json"]
    assert os.listdir(os.path.join(tdir, "step_0", "state")) == ["state.pt"]
    with open(os.path.join(tdir, "step_0", "topology.json")) as f:
        assert json.load(f) == {"step": 0, "num_processes": 1}
    assert ckpt.verify_step(tdir, 0) is True
    assert ckpt.load_dims(tdir) == trainer.dims


def test_max_to_keep_prunes_the_oldest(vocabs, tmp_path):
    trainer = _trainer(vocabs, MAX_TO_KEEP=2, ASYNC_CHECKPOINT=False)
    d = str(tmp_path / "c")
    for step in (1, 2, 3, 4):
        trainer.step_num = step
        trainer.save(d)
    assert [s for s, _ in ckpt._step_dirs(d)] == [3, 4]
    assert ckpt.latest_step(d) == 4
    assert ckpt.load_manifest(d)["step"] == 4


def test_torn_step_dir_is_invisible(vocabs, tmp_path):
    d = str(tmp_path / "c")
    os.makedirs(os.path.join(d, "step_7", "state.tmp"))
    assert ckpt.latest_step(d) is None
    trainer = _trainer(vocabs)
    trainer.step_num = 3
    trainer.save(d)
    trainer.close_session()
    assert ckpt.latest_step(d) == 3


def test_crash_before_commit_keeps_the_previous_step(vocabs, tmp_path,
                                                     monkeypatch):
    """A writer that dies inside the state write (after part of the file)
    leaves `state.tmp/` and no `state/`: `latest_step` and a load stay on
    the step before, and the error surfaces at the barrier."""
    d = str(tmp_path / "c")
    trainer = _trainer(vocabs)
    trainer.step_num = 1
    trainer.save(d)
    before = ckpt.load_checkpoint(d)
    real_save = torch.save

    def dying_save(obj, path, *a, **k):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise RuntimeError("killed mid-write")

    monkeypatch.setattr(torch, "save", dying_save)
    trainer.step_num = 2
    with pytest.raises(RuntimeError, match="killed mid-write"):
        trainer.save(d)
    monkeypatch.setattr(torch, "save", real_save)
    assert os.path.exists(os.path.join(d, "step_2", "state.tmp"))
    assert ckpt.latest_step(d) == 1
    _assert_same_state(ckpt.load_checkpoint(d), before)
    trainer.close_session()


def _flip_byte(d: str, step: int) -> None:
    path = os.path.join(d, f"step_{step}", "state", ckpt.STATE_FILE)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x40]))


def test_corrupt_latest_quarantines_and_falls_back(vocabs, tmp_path):
    trainer = _trainer(vocabs, ASYNC_CHECKPOINT=False)
    d = str(tmp_path / "c")
    states = {}
    for step in (1, 2):
        trainer.step_num = step
        trainer.params["transform"].add_(0.5)
        trainer.save(d)
        states[step] = ckpt.load_checkpoint(d)
    _flip_byte(d, 2)
    assert ckpt.verify_step(d, 2) is False
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.load_checkpoint(d, step=2)
    assert ckpt.latest_step(d) == 2  # an explicit load moves nothing
    logs = []
    got = ckpt.load_checkpoint(d, log=logs.append)
    _assert_same_state(got, states[1])
    assert ckpt.latest_step(d) == 1
    assert os.path.isdir(os.path.join(d, "quarantine", "step_2"))
    assert any("quarantined" in m for m in logs)


def test_verify_and_resolve_walks_newest_first(vocabs, tmp_path):
    trainer = _trainer(vocabs, ASYNC_CHECKPOINT=False)
    d = str(tmp_path / "c")
    for step in (1, 2, 3):
        trainer.step_num = step
        trainer.save(d)
    _flip_byte(d, 3)
    os.remove(os.path.join(d, "step_2", ckpt.CHECKSUMS_NAME))
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.verify_and_resolve(d, quarantine=False)
    step, moved = ckpt.verify_and_resolve(d)
    assert step == 2 and len(moved) == 1  # step 2 loads unverified


def test_retry_policy_gives_up_on_enospc_and_retries_eio():
    sleeps = []
    calls = {"n": 0}

    def flaky(code, fail_times):
        calls["n"] += 1
        if calls["n"] <= fail_times:
            raise OSError(code, os.strerror(code))
        return "ok"

    policy = RetryPolicy("t", max_attempts=3, base_delay_s=0.01,
                         retry_on=(OSError,), seed=0, sleep=sleeps.append,
                         giveup=lambda e: e.errno == errno.ENOSPC)
    assert policy.call(flaky, errno.EIO, 2) == "ok"
    assert calls["n"] == 3 and len(sleeps) == 2
    calls["n"] = 0
    with pytest.raises(OSError) as e:
        policy.call(flaky, errno.ENOSPC, 5)
    assert e.value.errno == errno.ENOSPC and calls["n"] == 1
    calls["n"] = 0
    with pytest.raises(OSError):
        policy.call(flaky, errno.EIO, 5)
    assert calls["n"] == 3
    assert 0.005 <= policy.delay_s(1) <= 0.01


@pytest.mark.parametrize("code,writes", [(errno.EIO, 2), (errno.ENOSPC, 1)])
def test_checkpoint_write_retries_eio_not_enospc(vocabs, tmp_path,
                                                 monkeypatch, code, writes):
    """The save's own policy: one EIO is retried and the step commits;
    ENOSPC is raised at once, nothing committed."""
    real_save = torch.save
    calls = {"n": 0}

    def failing_once(obj, path, *a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError(code, os.strerror(code))
        return real_save(obj, path, *a, **k)

    monkeypatch.setattr(torch, "save", failing_once)
    trainer = _trainer(vocabs, ASYNC_CHECKPOINT=False)
    d = str(tmp_path / "c")
    if code == errno.ENOSPC:
        with pytest.raises(OSError):
            trainer.save(d)
        assert ckpt.latest_step(d) is None
    else:
        trainer.save(d)
        assert ckpt.latest_step(d) == 0
    assert calls["n"] == writes


def test_second_submit_blocks_never_drops(vocabs, tmp_path):
    """With a save in flight, a second submit waits for its commit; both
    steps are written, in order."""
    gate = threading.Event()
    order = []

    def slow_save(ckpt_dir, state, step, *a, **k):
        if step == 1:
            gate.wait(10.0)
        order.append(step)
        return ckpt.save_checkpoint(ckpt_dir, state, step, *a, **k)

    trainer = _trainer(vocabs)
    writer = ckpt.AsyncCheckpointWriter(save_fn=slow_save)
    d = str(tmp_path / "c")
    state = {"params": trainer.params, "opt_state": trainer.opt_state,
             "step": 1}
    writer.submit(d, state, 1, vocabs, trainer.dims)
    done = threading.Event()

    def second():
        writer.submit(d, dict(state, step=2), 2, vocabs, trainer.dims)
        done.set()

    t = threading.Thread(target=second)
    t.start()
    time.sleep(0.2)
    assert not done.is_set()  # blocked behind the first save
    gate.set()
    t.join(10.0)
    assert done.is_set() and not t.is_alive()
    writer.close()
    assert order == [1, 2]
    assert [s for s, _ in ckpt._step_dirs(d)] == [1, 2]


def test_snapshot_is_the_state_at_submit(vocabs, tmp_path):
    """The steps update params in place: what the writer saves is the
    state when `save` was called, whatever changes after."""
    gate = threading.Event()

    def gated(ckpt_dir, state, step, *a, **k):
        gate.wait(10.0)
        return ckpt.save_checkpoint(ckpt_dir, state, step, *a, **k)

    trainer = _trainer(vocabs)
    trainer._ckpt_writer = ckpt.AsyncCheckpointWriter(save_fn=gated)
    d = str(tmp_path / "c")
    expect = ckpt.map_state(lambda t: t.clone(),
                            {"params": trainer.params,
                             "opt_state": trainer.opt_state})
    trainer.save(d, block=False)
    for t in ckpt.state_tensors(trainer.params):
        t.add_(1)
    gate.set()
    trainer.close_session()
    got = ckpt.load_checkpoint(d)
    _assert_same_state({"params": got["params"],
                        "opt_state": got["opt_state"]}, expect)


def test_writer_error_is_sticky(vocabs, tmp_path):
    def broken(*a, **k):
        raise OSError(errno.ENOSPC, "disk full")

    writer = ckpt.AsyncCheckpointWriter(save_fn=broken)
    trainer = _trainer(vocabs)
    writer.submit(str(tmp_path / "c"), {"params": trainer.params}, 0,
                  vocabs, trainer.dims)
    with pytest.raises(OSError, match="disk full"):
        writer.wait()
    writer.close()


def test_sidecars_written_once_and_release_at_the_right_step(vocabs,
                                                             tmp_path):
    """Epoch saves do not rewrite vocab.pkl or manifest.json; a release
    of the dir writes params only, at the latest committed step, with
    `released` in its manifest."""
    trainer = _trainer(vocabs, ASYNC_CHECKPOINT=False)
    d = str(tmp_path / "c")
    trainer.step_num = 2
    trainer.save(d)
    stamps = {n: os.stat(os.path.join(d, n)).st_mtime_ns
              for n in ("vocab.pkl", "manifest.json")}
    time.sleep(0.01)
    trainer.step_num = 5
    trainer.save(d)
    assert {n: os.stat(os.path.join(d, n)).st_mtime_ns
            for n in stamps} == stamps
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["step"] == 2  # advisory
    assert ckpt.load_manifest(d)["step"] == 5
    rel = str(tmp_path / "rel")
    ckpt.release_checkpoint(d, rel, trainer.params)
    assert sorted(os.listdir(rel)) == ["manifest.json", "step_5",
                                       "vocab.pkl"]
    state = ckpt.load_checkpoint(rel)
    assert set(state) == {"params"}
    _assert_same_state(state["params"], trainer.params)
    assert ckpt.load_manifest(rel)["released"] is True


@pytest.mark.parametrize("kw", [
    dict(TABLES_DTYPE="float32"),
    dict(TABLES_DTYPE="bfloat16", USE_BF16=True),
    dict(TABLES_DTYPE="int8", USE_BF16=True, USE_SAMPLED_SOFTMAX=True,
         NUM_SAMPLED_CLASSES=4),
    dict(TABLES_DTYPE="float32", TRUST_RATIO=True, LR_SCHEDULE="linear"),
    dict(TABLES_DTYPE="float32", EMBEDDING_OPTIMIZER="adam"),
    dict(TABLES_DTYPE="float32", SPARSE_EMBEDDING_UPDATES=True,
         EMBEDDING_OPTIMIZER="adam", LR_SCHEDULE="constant"),
    dict(TABLES_DTYPE="int8", USE_BF16=True, SPARSE_EMBEDDING_UPDATES=True,
         EMBEDDING_OPTIMIZER="adam", LR_SCHEDULE="constant",
         USE_SAMPLED_SOFTMAX=True, NUM_SAMPLED_CLASSES=4),
    dict(ENCODER_TYPE="transformer", XF_LAYERS=1, XF_HEADS=3,
         TABLES_DTYPE="float32"),
], ids=["f32", "bf16", "int8", "trust", "adam", "sparse", "sparse_int8",
        "xf"])
def test_state_loads_weights_only_bit_for_bit(dataset, vocabs, tmp_path,
                                              kw):
    """After two training steps the saved state, read back with
    `torch.load(weights_only=True)` and rebuilt, equals the trainer's:
    every tensor bit for bit, the optimizer state's NamedTuples
    (`FactoredState`, `ScaleByAdamState`, `RowAdamState`, ...) rebuilt
    with their types; a trainer made from the checkpoint by `--load`
    holds the same state and step."""
    trainer = _trainer(vocabs, **kw)
    trainer.train(dataset + ".train.c2v", max_steps=2)
    d = str(tmp_path / "c")
    trainer.save(d)
    trainer.close_session()
    raw = torch.load(os.path.join(d, "step_2", "state", ckpt.STATE_FILE),
                     weights_only=True)
    assert raw["step"] == 2
    state = ckpt.load_checkpoint(d)
    want = {"params": trainer.params, "opt_state": trainer.opt_state,
            "step": 2}
    _assert_same_state(state, want)
    assert ckpt.map_state(lambda t: None, state) == \
        ckpt.map_state(lambda t: None, want)
    named = set()

    def walk(x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            named.add(type(x))
        if isinstance(x, dict):
            x = list(x.values())
        if isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(state["opt_state"])
    if kw.get("SPARSE_EMBEDDING_UPDATES"):
        assert {type(v).__name__ for v in
                state["opt_state"]["rows"].values()} == {"RowAdamState"}
    else:
        assert topt.ScaleByAdamState in named
        assert (topt.FactoredState in named) == \
            (kw.get("EMBEDDING_OPTIMIZER", "adafactor") == "adafactor")
    cfg = _config(**kw)
    cfg.load_path = d
    loaded = Code2VecTrainer.from_config(cfg, device="cpu")
    assert loaded.step_num == 2 and loaded.dims == trainer.dims
    _assert_same_state({"params": loaded.params,
                        "opt_state": loaded.opt_state},
                       {"params": trainer.params,
                        "opt_state": trainer.opt_state})


def test_load_refuses_another_structure(vocabs, tmp_path):
    """A checkpoint restored under flags that build another optimizer
    state is refused with a clear error, not loaded into the wrong
    slots."""
    trainer = _trainer(vocabs, EMBEDDING_OPTIMIZER="adam")
    d = str(tmp_path / "c")
    trainer.save(d)
    trainer.close_session()
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["embedding_optimizer"] = "adafactor"
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    cfg = _config()
    cfg.load_path = d
    with pytest.raises(ValueError, match="optimizer state"):
        Code2VecTrainer.from_config(cfg, device="cpu")

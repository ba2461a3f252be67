"""The port's failpoints (code2vec_tpu_torch/resilience/faults.py) against
the JAX package's registry, and at the port's seams, on the CPU.

- the same specs give the same `ValueError`s, and the same hit
  sequences for `at`, `times` and a seeded `prob`;
- `kill` sends SIGKILL to its process;
- `ckpt/write` with EIO is retried and the step committed; with ENOSPC
  and `partial` the save gives up, `state.tmp/` (what a writer killed
  mid-save leaves) stays, and a load falls back to the step before;
- `infeed/produce` surfaces in the consuming loop at its batch;
- the retry policy's telemetry equals the JAX policy's;
- `train/nan_loss` poisons the recorded loss; `train/kill` kills a
  command-line run that `--auto_resume` then finishes with the state of
  an uninterrupted run.

Tolerances: none. The port trains deterministically on the CPU (the
dropout draws are keyed by step), so the resumed run's final state and
losses equal the uninterrupted run's bit for bit.
"""

import errno
import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from code2vec_tpu.resilience import faults as jfaults
from code2vec_tpu.resilience import retry as jretry
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data.prefetch import build_train_infeed
from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
from code2vec_tpu_torch.obs import Telemetry
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.resilience import retry
from code2vec_tpu_torch.training import checkpoint as ckpt
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
from helpers import build_tiny_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _quiet(_msg):
    pass


@pytest.mark.parametrize("spec", [
    {"sites": {}},
    {"seed": 1},
    {"sites": {"ckpt/write": {"action": "explode"}}},
    {"sites": {"train/kill": {"action": "kill", "when": 3}}},
    {"sites": {"ckpt/write": {"action": "io_error", "errno": "ENOPE"}}},
    "not json",
])
def test_bad_specs_raise_the_jax_errors(spec):
    errors = []
    for mod in (jfaults, faults):
        with pytest.raises((ValueError, AttributeError)) as info:
            mod.install(spec, log=_quiet)
        errors.append((type(info.value), str(info.value)))
    assert errors[1] == errors[0]


@pytest.mark.parametrize("site", [
    {"action": "raise"},
    {"action": "raise", "at": 3},
    {"action": "raise", "at": 2, "times": 3},
    {"action": "raise", "times": -1, "at": 4},
    {"action": "raise", "prob": 0.3, "times": -1},
    {"action": "nan", "prob": 0.5, "times": 5},
])
@pytest.mark.parametrize("seed", [0, 7])
def test_hit_sequences_match_jax(site, seed):
    """60 hits of one site through `point().hit()` and 60 through
    `fire()`: which ones trigger is the same for both registries."""
    seqs = []
    for mod in (jfaults, faults):
        mod.install({"seed": seed, "sites": {"train/nan_loss": dict(site),
                                             "serve/extract": dict(site)}},
                    log=_quiet)
        fp = mod.point("train/nan_loss")
        hits = [fp.hit() for _ in range(60)]
        fired = []
        for i in range(60):
            try:
                mod.fire("serve/extract")
                fired.append(False)
            except mod.FaultInjected:
                fired.append(True)
        seqs.append((hits, fired if site["action"] == "raise" else None,
                     mod.stats()))
        mod.clear()
    assert seqs[1] == seqs[0]
    assert any(seqs[1][0])


def test_disarmed_and_unknown_sites_are_null_handles():
    assert not faults.enabled()
    assert not faults.point("train/kill").armed
    faults.fire("ckpt/write", path="/nonexistent")  # one None check
    faults.install({"sites": {"train/kill": {"action": "kill"}}}, log=_quiet)
    assert not faults.point("ckpt/write").armed
    nan_fp, kill_fp = faults.train_step_points()
    assert kill_fp.armed and not nan_fp.armed


def test_marker_is_a_cross_restart_once_latch(tmp_path):
    marker = str(tmp_path / "fired.once")
    for _incarnation in range(2):
        faults.install({"sites": {"serve/extract": {
            "action": "raise", "times": -1, "marker": marker}}}, log=_quiet)
        fired = 0
        for _ in range(3):
            try:
                faults.fire("serve/extract")
            except faults.FaultInjected:
                fired += 1
        assert fired == (1 if _incarnation == 0 else 0)
    assert os.path.exists(marker)


def test_kill_action_sends_sigkill():
    code = ("from code2vec_tpu_torch.resilience import faults\n"
            "faults.install({'sites': {'train/kill': {'action': 'kill', "
            "'at': 2}}}, log=lambda m: None)\n"
            "fp = faults.point('train/kill')\n"
            "for i in range(5):\n"
            "    fp.fire(step=i)\n"
            "    print(i, flush=True)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == -signal.SIGKILL
    assert r.stdout.split() == ["0"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("faults_data")
    return build_tiny_dataset(str(d), n_train=64, n_val=8, n_test=8,
                              max_contexts=16, binarize=True)


@pytest.fixture(scope="module")
def vocabs(dataset):
    return Code2VecVocabs.load_from_dict_file(dataset + ".dict.c2v",
                                              1000, 1000, 1000)


def _trainer(vocabs, **kw):
    base = dict(MAX_CONTEXTS=16, DEFAULT_EMBEDDINGS_SIZE=8,
                TRAIN_BATCH_SIZE=16, TEST_BATCH_SIZE=16,
                TABLES_DTYPE="float32", USE_BF16=False)
    base.update(kw)
    return Code2VecTrainer(Config(**base), vocabs, device="cpu")


def test_ckpt_write_eio_is_retried_and_committed(vocabs, tmp_path):
    before = retry.stats().get("checkpoint-io", {}).get("retries", 0)
    faults.install({"sites": {"ckpt/write": {
        "action": "io_error", "errno": "EIO", "times": 1}}}, log=_quiet)
    trainer = _trainer(vocabs)
    d = str(tmp_path / "c")
    trainer.save(d)
    assert faults.stats()["ckpt/write"] == {"hits": 2, "fired": 1}
    assert retry.stats()["checkpoint-io"]["retries"] == before + 1
    assert ckpt.latest_step(d) == 0 and ckpt.verify_step(d, 0) is True
    assert not os.path.exists(os.path.join(d, "step_0", "state.tmp"))
    trainer.close_session()


@pytest.mark.parametrize("async_save", [False, True])
def test_ckpt_write_enospc_partial_gives_up_torn_and_falls_back(
        vocabs, tmp_path, async_save):
    trainer = _trainer(vocabs, ASYNC_CHECKPOINT=async_save)
    d = str(tmp_path / "c")
    trainer.save(d)  # step 0 committed
    trainer.step_num = 4
    faults.install({"sites": {"ckpt/write": {
        "action": "io_error", "errno": "ENOSPC", "partial": True}}},
        log=_quiet)
    with pytest.raises(OSError) as info:
        trainer.save(d)  # the async writer's error lands at the barrier
    assert info.value.errno == errno.ENOSPC
    assert faults.stats()["ckpt/write"] == {"hits": 1, "fired": 1}
    torn = os.path.join(d, "step_4", "state.tmp")
    assert os.path.isdir(torn) and os.listdir(torn) == [ckpt.STATE_FILE]
    assert not os.path.exists(os.path.join(d, "step_4", "state"))
    assert ckpt.latest_step(d) == 0
    assert ckpt.load_checkpoint(d)["step"] == 0
    # the disk recovers: the next save of the same step commits over it
    faults.clear()
    trainer.save(d)
    assert ckpt.latest_step(d) == 4 and ckpt.verify_step(d, 4) is True
    trainer.close_session()


@pytest.mark.parametrize("depth", [0, 2])
def test_infeed_produce_fault_surfaces_in_the_consumer(depth):
    faults.install({"sites": {"infeed/produce": {"action": "raise",
                                                 "at": 3}}}, log=_quiet)
    infeed = build_train_infeed([1, 2, 3, 4, 5], lambda b: b * 10, depth)
    seen = []
    with pytest.raises(faults.FaultInjected):
        for dev, host in infeed:
            seen.append((dev, host))
    assert seen == [(10, 1), (20, 2)]
    faults.clear()
    assert [h for _d, h in build_train_infeed([1, 2], lambda b: b, depth)] \
        == [1, 2]


def test_retry_telemetry_matches_jax():
    """The same flaky calls through a JAX and a port policy with
    telemetry on: the same counters and `retry` events; with telemetry
    off, and on a call that succeeds first time, nothing is recorded."""
    def run(mod_retry, tele):
        mod_retry.set_telemetry(tele)
        try:
            state = {"n": 0}

            def flaky(fail):
                state["n"] += 1
                if state["n"] <= fail:
                    raise OSError(errno.EIO, "flaky")
                return state["n"]
            p = mod_retry.RetryPolicy("t-tele", max_attempts=3, seed=0,
                                      base_delay_s=0.0,
                                      sleep=lambda _s: None,
                                      retry_on=(OSError,))
            assert p.call(flaky, 0) == 1   # nothing recorded
            state["n"] = 0
            p.call(flaky, 2)
            state["n"] = 0
            with pytest.raises(OSError):
                p.call(flaky, 9)
        finally:
            mod_retry.set_telemetry(None)
        return tele.summary()["counters"]

    from code2vec_tpu import obs as jobs
    want = run(jretry, jobs.Telemetry.memory("t"))
    got = run(retry, Telemetry.memory("t"))
    assert got == want == {"resilience/retry": 4,
                           "resilience/retry_exhausted": 1}


def _events(tele_dir):
    (run,) = os.listdir(tele_dir)
    with open(os.path.join(tele_dir, run, "events.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_nan_loss_poisons_the_recorded_loss(dataset, vocabs, tmp_path):
    """`train/nan_loss` at hit 3: the recorder's event for step 3
    carries a non-finite loss, the other steps finite ones (acting on it
    is the live plane's alert, not ported yet)."""
    faults.install({"sites": {"train/nan_loss": {"at": 3}}}, log=_quiet)
    trainer = _trainer(vocabs, TELEMETRY_DIR=str(tmp_path / "t"),
                       LR_SCHEDULE="constant")
    losses = trainer.train(dataset + ".train.c2v", epochs=2)
    steps = {e["step"]: e["loss"] for e in _events(str(tmp_path / "t"))
             if e["kind"] == "step"}
    assert sorted(steps) == list(range(1, 9))
    assert [s for s, v in steps.items() if v != v] == [3]
    assert losses[2] != losses[2] and all(x == x for i, x in
                                          enumerate(losses) if i != 2)


def _cli(args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "code2vec_tpu_torch", "--backend", "cpu",
         *args], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=timeout)


def test_train_kill_then_auto_resume_equals_uninterrupted(dataset,
                                                          tmp_path):
    """`train/kill` at step 6 of 8 (2 epochs of 4): the process dies by
    SIGKILL after epoch 1's save; the same command with `--auto_resume`
    restores step 4, trains epoch 2 and ends with the uninterrupted
    run's state, bit for bit."""
    base = ["--data", dataset, "--test", dataset + ".val.c2v", "--epochs",
            "2", "--batch_size", "16", "--max_contexts", "16",
            "--async_checkpoint", "off"]
    whole, part = str(tmp_path / "whole"), str(tmp_path / "part")
    r = _cli([*base, "--save", whole])
    assert r.returncode == 0, r.stderr
    r = _cli([*base, "--save", part, "--faults",
              json.dumps({"sites": {"train/kill": {"action": "kill",
                                                   "at": 6}}})])
    assert r.returncode == -signal.SIGKILL, r.stdout + r.stderr
    assert ckpt.latest_step(part) == 4
    r = _cli([*base, "--save", part, "--auto_resume"])
    assert r.returncode == 0, r.stderr
    assert "resuming" in r.stdout
    a, b = ckpt.load_checkpoint(whole), ckpt.load_checkpoint(part)
    assert a["step"] == b["step"] == 8
    ta, tb = ckpt.state_tensors(a), ckpt.state_tensors(b)
    assert len(ta) == len(tb) > 0
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))


def test_bad_faults_spec_exits_2(dataset, capsys):
    from code2vec_tpu_torch import cli
    rc = cli.main(["--data", dataset, "--backend", "cpu", "--faults",
                   '{"sites": {"train/kill": {"action": "explode"}}}'])
    assert rc == 2
    assert "--faults" in capsys.readouterr().err
    assert not faults.enabled()

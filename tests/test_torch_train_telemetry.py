"""The port's training loop under `--telemetry_dir --trace` against the
JAX package's, on the CPU, over the same tiny data: 2 epochs of 2 steps
with a save and an evaluation at each epoch boundary.

- the event log holds the same event kinds with the same keys, the same
  span names with the same attribute keys, the same parent and link
  structure (`train/step` under `train/step_cycle`, linked to the
  `infeed/produce` span of its batch; `train/save_write` under
  `train/save_blocked`), and the same summary sections and timer names;
- the losses (and the final params) with the recorder, the trace and
  the watchdog on are bit-identical to those with everything off: the
  recorder reads the loss, it changes nothing the step computes.

Tolerances: none (names and keys are compared, and on the CPU the port
is deterministic).
"""

import json
import os

import pytest
import torch

from code2vec_tpu.models.jax_model import Code2VecModel as JaxModel
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
from code2vec_tpu_torch.training import checkpoint as ckpt
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
from helpers import build_tiny_dataset
from test_model import tiny_config

B, E, C = 32, 16, 16


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("tele_data")
    return build_tiny_dataset(str(d), n_train=64, n_val=16, n_test=16,
                              max_contexts=C)


def _events(tele_dir):
    (run,) = os.listdir(tele_dir)
    with open(os.path.join(tele_dir, run, "events.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _shape(events):
    """What the log says, without its values: the kinds with their keys,
    the span names with their attribute keys, parent and link names, and
    the summary's sections and timers."""
    spans = [e for e in events if e["kind"] == "span"]
    by_id = {e["span"]: e["name"] for e in spans}
    kinds = {(e["kind"], tuple(sorted(e))) for e in events
             if e["kind"] != "span"}
    tree = {(e["name"], by_id.get(e.get("parent")),
             tuple(sorted(by_id.get(s, "?") for _t, s in e.get("links", []))),
             tuple(sorted(e.get("attrs", {})))) for e in spans}
    (summary,) = [e for e in events if e["kind"] == "summary"]
    return kinds, tree, sorted(summary["timers"]), sorted(summary["counters"])


def _jax_events(dataset, root):
    cfg = tiny_config(dataset, MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E,
                      TRAIN_BATCH_SIZE=B, TEST_BATCH_SIZE=B,
                      NUM_TRAIN_EPOCHS=2, SAVE_EVERY_EPOCHS=1,
                      TELEMETRY_DIR=str(root / "tele"), TRACE=True)
    cfg.save_path = str(root / "ckpt")
    cfg.test_data_path = dataset + ".val.c2v"
    model = JaxModel(cfg)
    model.train()
    model.close_session()
    return _events(str(root / "tele"))


def _port_trainer(dataset, vocabs, root, telemetry: bool):
    cfg = Config(MAX_CONTEXTS=C, DEFAULT_EMBEDDINGS_SIZE=E,
                 TRAIN_BATCH_SIZE=B, TEST_BATCH_SIZE=B, NUM_TRAIN_EPOCHS=2,
                 LEARNING_RATE=0.05, USE_BF16=False,
                 TELEMETRY_DIR=str(root / "tele") if telemetry else None,
                 TRACE=telemetry,
                 WATCHDOG_STALL_S=120.0 if telemetry else 0.0)
    cfg.save_path = str(root / "ckpt")
    cfg.test_data_path = dataset + ".val.c2v"
    return Code2VecTrainer(cfg, vocabs, device="cpu")


def test_event_log_matches_the_jax_trainers(dataset, tmp_path):
    vocabs = Code2VecVocabs.load_from_dict_file(dataset + ".dict.c2v",
                                                1000, 1000, 1000)
    want = _shape(_jax_events(dataset, tmp_path / "jax"))
    trainer = _port_trainer(dataset, vocabs, tmp_path / "torch", True)
    trainer.train(dataset + ".train.c2v")
    trainer.close_session()
    events = _events(str(tmp_path / "torch" / "tele"))
    got = _shape(events)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2:] == want[2:]
    steps = [e for e in events if e["kind"] == "step"]
    assert [e["step"] for e in steps] == [1, 2, 3, 4]
    assert [e["epoch"] for e in events if e["kind"] == "eval"] == [1, 2]
    (summary,) = [e for e in events if e["kind"] == "summary"]
    assert summary["timers"]["train/step_ms"]["count"] == 4
    assert summary["counters"]["train/examples"] == 2 * 64


def test_losses_are_bit_identical_with_the_recorder_on(dataset, tmp_path):
    vocabs = Code2VecVocabs.load_from_dict_file(dataset + ".dict.c2v",
                                                1000, 1000, 1000)
    runs = []
    for on in (True, False):
        trainer = _port_trainer(dataset, vocabs, tmp_path / str(on), on)
        losses = trainer.train(dataset + ".train.c2v")
        trainer.close_session()
        runs.append((losses, ckpt.load_checkpoint(
            str(tmp_path / str(on) / "ckpt"))))
    (on_losses, on_state), (off_losses, off_state) = runs
    assert len(on_losses) == 4 and on_losses == off_losses
    a, b = ckpt.state_tensors(on_state), ckpt.state_tensors(off_state)
    assert len(a) == len(b) > 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))

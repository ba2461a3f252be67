"""The writing rank's exports under the model mesh axis across real
processes, against the port's one-process exports.

Two gloo workers spawned by this file's fixture (tests/
test_torch_multiprocess.py's `_spawn`) run `cli.main --mesh_model 2
--dist_*` three times, each joining the group on a port of its own
(`cli.main` leaves the group at its end): an epoch of training with
`--test` and `--save` (rank 0 writes the whole-table checkpoint); then
on that checkpoint `--test --export_code_vectors --save_w2v --save_t2v`
(the ranks of the writer's model group gather the whole tables, rank 0
alone writes); then `--release`. Between the first two, with the group
up again, a model-2 trainer loaded from the checkpoint gives
`get_embedding_table` of each table. Last, a fourth run releases a
one-process checkpoint whose tables have odd rows (padded with a zero
row each on load at model 2).

The parent runs the same exports and the releases in one process from
the same checkpoints. Tolerances: none. The w2v, t2v and code-vector
files are byte-identical, the released tensors bit-identical (the odd
checkpoint's release in its own layout, without the padding rows, so
that it loads in one process), and each gathered table equals the
checkpoint's rows up to its vocab size, bit for bit, with no padding
row. Earlier tests hold the one-process exports
to the JAX package's (tests/test_torch_cli.py).
"""

from __future__ import annotations

import os
import pickle
import shutil
import sys

import pytest

TABLES = {"token": "token_emb", "path": "path_emb", "target": "target_emb"}


def _flags(world, rank, port):
    return ["--mesh_model", str(world), "--dist_coordinator",
            f"127.0.0.1:{port}", "--dist_num_processes", str(world),
            "--dist_process_id", str(rank)]


def _exports_argv(ckpt, test_path, out):
    """The exports' command line over `ckpt`: the code vectors beside
    `test_path`, the token and target tables under `out`."""
    return ["--backend", "cpu", "--load", ckpt, "--test", test_path,
            "--export_code_vectors", "--save_w2v",
            os.path.join(out, "tokens.w2v"), "--save_t2v",
            os.path.join(out, "targets.w2v"), "--no_bf16"]


def _release_argv(ckpt, dest):
    return ["--backend", "cpu", "--load", ckpt, "--release", "--save",
            dest, "--no_bf16"]


# ---- the workers (run by tests/test_torch_multiprocess.py's worker) ----

def exports_worker(rank, world, out_dir, deadline):
    """The training run, the gathered tables, the exports and the
    release at model `world`."""
    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.parallel import distributed
    from code2vec_tpu_torch.vocab.vocabularies import VocabType
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    prefix, ports = inputs["prefix"], inputs["ports"]
    ckpt = os.path.join(out_dir, "ckpt")
    deadline.beat("train", timeout_s=120.0)
    out = {"train_rc": cli.main([
        "--backend", "cpu", "--data", prefix, "--test", prefix + ".val.c2v",
        "--save", ckpt, "--max_contexts", "16", "--batch_size", "8",
        "--epochs", "1", "--async_checkpoint", "off", "--no_bf16",
        *_flags(world, rank, sys.argv[3])])}
    deadline.beat("tables")
    distributed.maybe_initialize(f"127.0.0.1:{ports[0]}", world, rank,
                                 device_type="cpu")
    cfg = Config.load_from_args(["--backend", "cpu", "--load", ckpt,
                                 "--no_bf16", "--mesh_model", str(world)])
    trainer = Code2VecTrainer.from_config(cfg, device="cpu")
    out["windows"] = {k: tuple(trainer.params[v].shape)
                      for k, v in TABLES.items()}
    out["tables"] = {k: trainer.get_embedding_table(getattr(VocabType,
                                                            k.title()))
                     for k in TABLES}
    deadline.beat("exports", timeout_s=120.0)
    m2 = inputs["m2"]
    out["exports_rc"] = cli.main(
        _exports_argv(ckpt, os.path.join(m2, "test.c2v"), m2)
        + _flags(world, rank, ports[0]))
    deadline.beat("release", timeout_s=120.0)
    out["release_rc"] = cli.main(
        _release_argv(ckpt, os.path.join(out_dir, "released"))
        + _flags(world, rank, ports[1]))
    deadline.beat("release_odd", timeout_s=120.0)
    out["release_odd_rc"] = cli.main(
        _release_argv(inputs["odd_ckpt"],
                      os.path.join(out_dir, "released_odd"))
        + _flags(world, rank, ports[2]))
    return out


# ---- the parent side ----

@pytest.fixture(scope="module")
def export_ranks(tmp_path_factory):
    from helpers import build_tiny_dataset
    from test_torch_multiprocess import _spawn, _trainer_config

    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.parallel.compat import free_port
    base = tmp_path_factory.mktemp("torch_model_exports")
    prefix = build_tiny_dataset(str(base), n_train=40, n_val=13, n_test=11,
                                max_contexts=16)
    # a one-process checkpoint of 9, 7 and 9 rows (the capped vocabs)
    cfg = _trainer_config(prefix)
    cfg.MAX_TOKEN_VOCAB_SIZE = cfg.MAX_TARGET_VOCAB_SIZE = 7
    cfg.MAX_PATH_VOCAB_SIZE = 5
    odd = Code2VecTrainer.from_config(cfg, device="cpu")
    odd.train(prefix + ".train.c2v", max_steps=1)
    odd_ckpt = str(base / "odd_ckpt")
    odd.save(odd_ckpt)
    out_dir = str(base / "w2")
    m2, one = str(base / "m2"), str(base / "one")
    for d in (out_dir, m2, one):
        os.makedirs(d)
    for d in (m2, one):  # each run's code vectors beside its own copy
        shutil.copy(prefix + ".test.c2v", os.path.join(d, "test.c2v"))
    with open(os.path.join(out_dir, "inputs.pkl"), "wb") as f:
        pickle.dump({"prefix": prefix, "m2": m2, "odd_ckpt": odd_ckpt,
                     "ports": [free_port() for _ in range(3)]}, f)
    ranks = _spawn(2, out_dir, "test_torch_model_exports:exports_worker")
    return ranks, out_dir, m2, one


def test_exports_run_on_two_model_ranks(export_ranks):
    """The training run, the exports and the release exit 0 on both
    ranks; a rank holds half the rows of each table."""
    ranks, out_dir, _m2, _one = export_ranks
    for r in ranks:
        assert (r["train_rc"], r["exports_rc"], r["release_rc"],
                r["release_odd_rc"]) == (0, 0, 0, 0)
    from code2vec_tpu_torch.training import checkpoint as ckpt
    state = ckpt.load_checkpoint(os.path.join(out_dir, "ckpt"))
    for r in ranks:
        for k, v in TABLES.items():
            assert r["windows"][k][0] * 2 == state["params"][v].shape[0]


@pytest.mark.parametrize("name", ["tokens.w2v", "targets.w2v",
                                  "test.c2v.vectors"])
def test_model_axis_exports_are_the_one_process_bytes(export_ranks, name):
    """Each export written at model 2 (rank 0 over the tables its model
    group gathered) is byte-identical to one process's export from the
    same checkpoint."""
    from code2vec_tpu_torch import cli
    _ranks, out_dir, m2, one = export_ranks
    path = os.path.join(one, name)
    if not os.path.exists(path):
        assert cli.main(_exports_argv(os.path.join(out_dir, "ckpt"),
                                      os.path.join(one, "test.c2v"),
                                      one)) == 0
    with open(os.path.join(m2, name), "rb") as f:
        got = f.read()
    with open(path, "rb") as f:
        want = f.read()
    assert len(got) > 0 and got == want


def test_model_axis_release_holds_the_one_process_tensors(export_ranks):
    """`--release` at model 2 writes the whole params: every tensor bit
    for bit the one-process release's from the same checkpoint, and no
    optimizer state."""
    import torch

    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.training import checkpoint as ckpt
    _ranks, out_dir, _m2, one = export_ranks
    dest = os.path.join(one, "released")
    assert cli.main(_release_argv(os.path.join(out_dir, "ckpt"), dest)) == 0
    got = ckpt.load_checkpoint(os.path.join(out_dir, "released"))
    want = ckpt.load_checkpoint(dest)
    assert "opt_state" not in got and got.keys() == want.keys()
    g, w = got["params"], want["params"]
    assert g.keys() == w.keys() and "token_emb" in g
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def test_model_axis_release_of_a_one_process_checkpoint(export_ranks,
                                                        tmp_path):
    """`--release` at model 2 of a one-process checkpoint with odd rows
    (9, 7, 9), which the load pads to (10, 8, 10): the released tensors
    are the one-process release's bit for bit, in the checkpoint's rows,
    and it loads in one process (its manifest's shapes)."""
    import torch

    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.training import checkpoint as ckpt
    _ranks, out_dir, _m2, _one = export_ranks
    src = os.path.join(os.path.dirname(out_dir), "odd_ckpt")
    dest = str(tmp_path / "released_odd")
    assert cli.main(_release_argv(src, dest)) == 0
    got_dir = os.path.join(out_dir, "released_odd")
    got = ckpt.load_checkpoint(got_dir)["params"]
    want = ckpt.load_checkpoint(dest)["params"]
    assert [got[k].shape[0] for k in TABLES.values()] == [9, 7, 9]
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    one = Code2VecTrainer.from_config(
        Config.load_from_args(["--backend", "cpu", "--load", got_dir]),
        device="cpu")
    for k in want:
        assert torch.equal(one.params[k], want[k]), k


def test_gathered_tables_are_the_checkpoints_rows(export_ranks):
    """`get_embedding_table` at model 2 on both ranks: each table
    gathered whole, cut to its vocab size (no padding row), its float32
    rows the checkpoint's bit for bit."""
    import numpy as np

    from code2vec_tpu_torch.training import checkpoint as ckpt
    ranks, out_dir, _m2, _one = export_ranks
    path = os.path.join(out_dir, "ckpt")
    state = ckpt.load_checkpoint(path)
    vocabs = ckpt.load_vocabs(path)
    for r in ranks:
        for k, v in TABLES.items():
            size = getattr(vocabs, f"{k}_vocab").size
            want = state["params"][v].float().numpy()[:size]
            got = r["tables"][k]
            assert state["params"][v].shape[0] % 2 == 0
            assert got.shape == (size, want.shape[1])
            assert np.array_equal(got, want), k

"""The port's attack on model-sharded params, and `--attack` above one
rank: the counterpart of tests/test_attacks.py:158
(`test_attack_works_on_model_sharded_params`), on the CPU.

One model is trained in one process on Input.java's methods and
synthetic ones (tests/test_torch_cohort_predict.py's `build_repl_world`,
float32 tables and compute). Two gloo workers spawned by this file's
fixture load its checkpoint at `--mesh_model 2` (each rank a window of
every table, padded to 2) and run the attack's steps over the windows:

- `attack_method` (untargeted and targeted, up to two renames) and
  `attack_batch` on the test methods, on both ranks, against the port's
  one-process attack and the JAX package's one-device attack on the same
  params (carried with convert.py) and methods: the original prediction
  equal, each method's first-order scores within atol 1e-5 of JAX's
  (the real rows; the padding row is illegal), and the trajectory
  equal, the accepted steps' losses within 1e-6 (relative to max(1,
  |loss|)). A method whose trajectory differed would have to be a tie
  of its exact losses; on this fixture none differs, and the test says
  so by comparing every field.
- the same attack built over the model (`GradientRenameAttack.over`)
  and led by rank 0 alone (`serving/cohort.run`), rank 1 following each
  announced step: `attack_batch` and one `attack_method` give one
  process's results;
- `cli.main --attack untargeted --mesh_model 2 --dist_*` on two ranks:
  rank 0 prints what one process prints and writes the same
  `<attack_input>.adversarial` bytes (or none where one process writes
  none); rank 1 prints nothing and writes no file; both exit 0.
- an attack error on rank 0 (`--attack_method_index` out of range):
  both ranks exit 2 within the spawn's `communicate` timeout.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil

import numpy as np
import pytest

MAX_RENAMES = 2
N_METHODS = 6
SCORE_ATOL, LOSS_RTOL = 1e-5, 1e-6
ATTACK_FLAGS = ["--attack", "untargeted", "--no_bf16", "--backend", "cpu"]


def _methods(prefix, vocabs, n=N_METHODS):
    from code2vec_tpu_torch.data.reader import parse_c2v_rows
    with open(prefix + ".test.c2v", encoding="utf-8") as f:
        lines = [ln for ln in f if ln.strip()][:n]
    _l, src, pth, dst, mask, _t, _c = parse_c2v_rows(lines, vocabs, 32)
    return [(src[i], pth[i], dst[i], mask[i]) for i in range(len(lines))]


def _first_scores(attack, params, methods):
    """The first-order scores of each method's most frequent attackable
    token against its clean prediction (the untargeted loss)."""
    out = []
    for m in methods:
        tok = attack.attackable_tokens(m[0], m[2], m[3])[0][0]
        ids = attack.tensors(m)
        occ = attack.tensors((m[0] == tok, m[2] == tok))
        label = int(attack.predict_fn(params, ids))
        out.append(np.asarray(attack.score_fn(params, ids, occ, label,
                                              -1.0)))
    return out


def _attack_all(attack, params, methods, target):
    """Per method: untargeted then targeted at `target`; then the lockstep
    batch of the methods."""
    serial = []
    for m in methods:
        serial.append(attack.attack_method(params, m,
                                           max_renames=MAX_RENAMES))
        serial.append(attack.attack_method(params, m, targeted=True,
                                           target_name=target,
                                           max_renames=MAX_RENAMES))
    return serial, attack.attack_batch(params, methods)


def _port_attack(ckpt, **cfg):
    """The port's predictor on `ckpt` (CPU) and its attack."""
    from code2vec_tpu_torch.attacks import gradient_attack as tga
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    config = Config.load_from_args(["--load", ckpt, "--no_bf16"])
    for k, v in cfg.items():
        setattr(config, k, v)
    model = Code2VecTrainer.from_config(config, device="cpu").predictor()
    return model, tga.GradientRenameAttack(
        model.dims, model.vocabs.token_vocab, model.vocabs.target_vocab,
        compute_dtype=model.compute_dtype, device="cpu", mesh=model.mesh)


def _lead_attack(model, methods, out) -> int:
    """The leader's run under `cohort.run`: `attack_batch` and one
    `attack_method` of the attack built over the model, into `out`."""
    from code2vec_tpu_torch.attacks import gradient_attack as tga
    attack = tga.GradientRenameAttack.over(model)
    out["batch"] = attack.attack_batch(model.params, methods)
    out["serial"] = attack.attack_method(model.params, methods[0],
                                         max_renames=MAX_RENAMES)
    return 0


# ---- the worker (run by tests/test_torch_multiprocess.py's worker) ----

def attack_worker(rank, world, out_dir, deadline):
    """The attack at (data 1, model 2) on the checkpoint, then the two
    command-line runs (last: cli.main leaves the group)."""
    from test_torch_cohort_predict import _cli_flags, run_cli

    from code2vec_tpu_torch.serving import cohort
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        spec = pickle.load(f)
    deadline.beat("attack")
    model, attack = _port_attack(spec["ckpt"], MESH_MODEL_AXIS=2)
    assert model.mesh.model == 2 and attack.mesh is model.mesh
    methods = _methods(spec["prefix"], model.vocabs)
    out = {"rows": model.params["token_emb"].shape[0],
           "scores": _first_scores(attack, model.params, methods)}
    out["serial"], out["batch"] = _attack_all(attack, model.params, methods,
                                              spec["target"])
    # the same attack led by rank 0 alone, the other rank following
    deadline.beat("led", timeout_s=120.0)
    out["led"] = {}
    out["led_rc"] = cohort.run(model, lambda: _lead_attack(
        model, methods, out["led"]))
    lead = rank == 0
    base = ["--load", spec["ckpt"], "--attack_input", spec["victim"],
            "--mesh_model", "2", *ATTACK_FLAGS]
    for label, port, extra in (("cli", spec["ports"][0], []),
                               ("error", spec["ports"][1],
                                ["--attack_method_index", "99"])):
        deadline.beat(label, timeout_s=120.0)
        out[label] = run_cli(base + extra + _cli_flags(rank, world, port),
                             None, spec["work"] if lead
                             else spec["elsewhere"])
        out[label + "_files"] = sorted(os.listdir(spec["elsewhere"]))
    return out


# ---- the parent side ----

@pytest.fixture(scope="module")
def attack_ranks(tmp_path_factory):
    from test_torch_cohort_predict import build_repl_world, run_cli
    from test_torch_multiprocess import _spawn

    from code2vec_tpu_torch.parallel.compat import free_port
    base = str(tmp_path_factory.mktemp("torch_cohort_attack"))
    world = build_repl_world(base)
    one_model, one_attack = _port_attack(world["ckpt"])
    target = one_model.vocabs.target_vocab.lookup_word(2)
    work = os.path.join(base, "victim")
    one_dir = os.path.join(base, "one")
    elsewhere = os.path.join(base, "elsewhere")
    for d in (work, one_dir, elsewhere):
        os.makedirs(d)
        if d != elsewhere:
            shutil.copy(world["input_java"], d)
    spec = dict(world, target=target, work=work, elsewhere=elsewhere,
                victim=os.path.join(work, "Input.java"),
                ports=[free_port(), free_port()])
    out_dir = os.path.join(base, "w2")
    os.makedirs(out_dir)
    with open(os.path.join(out_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(spec, f)
    ranks = _spawn(2, out_dir, "test_torch_cohort_attack:attack_worker")
    methods = _methods(world["prefix"], one_model.vocabs)
    one = {"scores": _first_scores(one_attack, one_model.params, methods)}
    one["serial"], one["batch"] = _attack_all(one_attack, one_model.params,
                                              methods, target)
    victim = os.path.join(one_dir, "Input.java")
    one["cli"] = run_cli(["--load", world["ckpt"], "--attack_input", victim,
                          *ATTACK_FLAGS], None, one_dir)
    adv = victim + ".adversarial"
    one["adversarial"] = (open(adv, "rb").read() if os.path.exists(adv)
                          else None)
    return spec, one, ranks, one_model, methods


def _jax_attack(one_model, ckpt):
    """The JAX package's one-device attack on the checkpoint's params,
    dims and vocabularies."""
    import jax.numpy as jnp

    from code2vec_tpu.attacks import gradient_attack as jga
    from code2vec_tpu.models import encoder as jenc
    from code2vec_tpu.vocab.vocabularies import Code2VecVocabs
    from code2vec_tpu_torch import convert
    vocabs = Code2VecVocabs.load(os.path.join(ckpt, "vocab.pkl"))
    dims = jenc.ModelDims(**dataclasses.asdict(one_model.dims))
    params = {k: jnp.asarray(v) for k, v in
              convert.params_to_numpy(one_model.params).items()}
    return jga.GradientRenameAttack(
        dims, vocabs.token_vocab, vocabs.target_vocab,
        compute_dtype=jnp.float32), params


def test_first_order_scores_on_model_shards_match_one_jax_device(
        attack_ranks):
    """Each rank's scores (the windows' products gathered over the model
    group) against the JAX attack's and the port's one-process ones, over
    the real rows; the padding row lies beyond them."""
    import jax.numpy as jnp

    from code2vec_tpu_torch.attacks import gradient_attack as tga
    spec, one, ranks, one_model, methods = attack_ranks
    ja, jparams = _jax_attack(one_model, spec["ckpt"])
    V = one_model.dims.token_vocab_size
    rows = one_model.params["token_emb"].shape[0]
    for i, m in enumerate(methods):
        tok = ja.attackable_tokens(m[0], m[2], m[3])[0][0]
        label = int(ja.predict_fn(jparams, tuple(jnp.asarray(a)
                                                 for a in m)))
        want = np.asarray(ja.score_fn(
            jparams, tuple(jnp.asarray(a) for a in m),
            (jnp.asarray(m[0] == tok), jnp.asarray(m[2] == tok)),
            jnp.int32(tga.spare_row(rows, m[0], m[2])), jnp.int32(label),
            jnp.float32(-1.0)))
        np.testing.assert_allclose(one["scores"][i][:V], want[:V], rtol=0,
                                   atol=SCORE_ATOL)
        for r in ranks:
            assert r["rows"] * 2 == -(-V // 2) * 2
            assert r["scores"][i].shape == (r["rows"] * 2,)
            np.testing.assert_allclose(r["scores"][i][:V], want[:V],
                                       rtol=0, atol=SCORE_ATOL)


def _assert_same_result(got, want):
    for field in ("success", "targeted", "original_prediction",
                  "final_prediction", "target_name", "renames",
                  "iterations"):
        assert getattr(got, field) == getattr(want, field), field
    assert [(s.from_token, s.to_token) for s in got.steps] == \
        [(s.from_token, s.to_token) for s in want.steps]
    for g, w in zip(got.steps, want.steps):
        for a, b in ((g.loss_before, w.loss_before),
                     (g.loss_after, w.loss_after)):
            assert abs(a - b) <= LOSS_RTOL * max(1.0, abs(b)), (a, b)
    for g, w in zip(got.final_method, want.final_method):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_attack_on_model_shards_matches_one_process_and_jax(attack_ranks):
    """`attack_method` (untargeted, targeted) and `attack_batch` at model
    2 on both ranks: the port's one-process results and the JAX
    one-device attack's, field for field."""
    import jax.numpy as jnp
    spec, one, ranks, one_model, methods = attack_ranks
    ja, jparams = _jax_attack(one_model, spec["ckpt"])
    jax_serial = []
    for m in methods:
        jax_serial.append(ja.attack_method(jparams, m,
                                           max_renames=MAX_RENAMES))
        jax_serial.append(ja.attack_method(jparams, m, targeted=True,
                                           target_name=spec["target"],
                                           max_renames=MAX_RENAMES))
    assert any(r.steps for r in jax_serial)
    for got, want in zip(one["serial"], jax_serial):
        _assert_same_result(got, want)
    for r in ranks:
        assert len(r["serial"]) == len(jax_serial)
        for got, want in zip(r["serial"], one["serial"]):
            _assert_same_result(got, want)
        assert len(r["batch"]) == len(methods)
        for got, want in zip(r["batch"], one["batch"]):
            _assert_same_result(got, want)


def test_attack_led_by_rank_zero_matches_one_process(attack_ranks):
    """`attack_batch` and `attack_method` of the attack built over the
    model (`GradientRenameAttack.over`) on rank 0 alone, leading the
    cohort: every step is announced, rank 1 joins it, and the results are
    one process's; both ranks leave with code 0."""
    spec, one, ranks, _m, methods = attack_ranks
    assert [r["led_rc"] for r in ranks] == [0, 0]
    led = ranks[0]["led"]
    assert ranks[1]["led"] == {} and len(led["batch"]) == len(methods)
    for got, want in zip(led["batch"], one["batch"]):
        _assert_same_result(got, want)
    _assert_same_result(led["serial"], one["serial"][0])


def test_cli_attack_on_two_ranks_writes_one_processs_file_once(
        attack_ranks):
    """`cli.main --attack untargeted --mesh_model 2` on two ranks: rank
    0's printed outcome and `.adversarial` bytes are one process's; rank
    1 prints nothing and writes nothing; both exit 0."""
    spec, one, ranks, _m, _x = attack_ranks
    rc, want = one["cli"]
    assert rc == 0 and want.strip()
    (rc0, out0), (rc1, out1) = ranks[0]["cli"], ranks[1]["cli"]
    assert rc0 == rc1 == 0
    assert out0 == want and out1 == ""
    adv = spec["victim"] + ".adversarial"
    if one["adversarial"] is None:
        assert not os.path.exists(adv)
    else:
        with open(adv, "rb") as f:
            assert f.read() == one["adversarial"]
    assert ranks[1]["cli_files"] == []


def test_an_attack_error_on_rank0_exits_2_on_both_ranks(attack_ranks):
    """`--attack_method_index 99` on a file of fewer methods: rank 0
    prints nothing to stdout and exits 2 (the error on stderr), and its
    stop takes rank 1 out with the same code."""
    _s, _o, ranks, _m, _x = attack_ranks
    assert [r["error"][0] for r in ranks] == [2, 2]
    assert [r["error"][1] for r in ranks] == ["", ""]
    assert ranks[1]["error_files"] == []

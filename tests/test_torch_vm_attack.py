"""The port's VarMisuse attack (attacks/vm_attack.py) and its sweep
(attacks/vm_robustness.py) against the JAX package's, on the CPU.

The fixture is tests/test_vm_attack.py's: a `.vm.c2v` dataset from the
generator (1200 / 150 / 100 rows, seed 11; written by the port's
generator through the port's native extractor, which the port's tests
hold row for row to the JAX generator's), a JAX VarMisuseModel trained
on it at tests/test_varmisuse.py's settings (bf16 tables, float32
compute), saved and carried into the port by
tools/import_jax_checkpoint.py, and loaded by the port's command-line
loader. Both attacks then run on the same parsed rows.

Tolerances: the first-order scores within 2^-7 of max |score| (the
tables are bf16: the gradient reaching them is rounded to bf16, JAX's
cotangent dtype, and summed in another order); the exact candidate
losses within 1e-5 relative (float32 compute: the pointer's scores are
products of sums summed in another order, and its cross entropies reach
35, where 1e-6 is ~10 float32 ulp) and the predicted slots equal; the
attack results and the sweep's report JAX's, field for field (the
report but for `seconds`).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.attacks import vm_attack as jvm
from code2vec_tpu.attacks import vm_robustness as jvmr
from code2vec_tpu.data import vm_reader as jreader
from code2vec_tpu_torch.attacks import gradient_attack as tga
from code2vec_tpu_torch.attacks import vm_attack as tvm
from code2vec_tpu_torch.attacks import vm_robustness as tvmr
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data import varmisuse_gen as tgen
from code2vec_tpu_torch.models.vm_model import VarMisuseModel
from code2vec_tpu_torch.ops import _build
from test_varmisuse import vm_config as jax_vm_config

BF16 = 2.0 ** -7
F32_LOSS = 1e-5


@pytest.fixture(scope="module")
def vm_trained(tmp_path_factory):
    try:
        _build.cxx_path()
    except _build.KernelBuildError as e:
        pytest.skip(f"no host C++ compiler to build the native extractor "
                    f"({e})")
    import tools.import_jax_checkpoint as tool
    from code2vec_tpu.models.vm_model import VarMisuseModel as JVM
    d = tmp_path_factory.mktemp("torch_vm_attack")
    prefix = os.path.join(str(d), "vm")
    tgen.write_vm_dataset(prefix, n_train=1200, n_val=150, n_test=100,
                          seed=11)
    cfg = jax_vm_config(prefix)
    cfg.test_data_path = prefix + ".val.vm.c2v"
    jmodel = JVM(cfg)
    jmodel.train()
    src, dest = os.path.join(str(d), "jax"), os.path.join(str(d), "port")
    jmodel.save(src)
    assert tool.main(["--jax_checkpoint", src, "--save", dest]) == 0
    tcfg = Config.load_from_args(["--load", dest, "--backend", "cpu",
                                  "--no_bf16"])
    tmodel = VarMisuseModel.from_config(tcfg, device="cpu")
    return cfg, jmodel, tmodel, prefix, dest


def _rows(cfg, model, prefix, n):
    with open(prefix + ".val.vm.c2v", encoding="utf-8") as f:
        lines = [ln for ln in f if ln.strip()][:n]
    labels, src, pth, dst, mask, cand, cmask, valid, _ = \
        jreader.parse_vm_rows(lines, model.vocabs, cfg.MAX_CONTEXTS,
                              cfg.MAX_CANDIDATES)
    keep = [i for i in range(len(lines)) if valid[i] > 0]
    return [(src[i], pth[i], dst[i], mask[i], cand[i], cmask[i])
            for i in keep], [int(labels[i]) for i in keep]


def _attacks(jmodel, tmodel, **kw):
    ja = jvm.VMGradientRenameAttack(jmodel.dims, jmodel.vocabs.token_vocab,
                                    compute_dtype=jmodel.compute_dtype, **kw)
    ta = tvm.VMGradientRenameAttack(tmodel.dims, tmodel.vocabs.token_vocab,
                                    compute_dtype=tmodel.compute_dtype,
                                    device="cpu", **kw)
    return ja, ta


def test_vm_port_model_is_the_jax_model(vm_trained):
    cfg, jmodel, tmodel, _, _ = vm_trained
    assert tmodel.dims.tables_dtype == jmodel.dims.tables_dtype == "bfloat16"
    assert tmodel.compute_dtype == torch.float32
    assert tmodel.config.MAX_CANDIDATES == cfg.MAX_CANDIDATES


def test_vm_step_functions_match_jax(vm_trained):
    """score_fn / eval_fn / predict_fn on the first 8 valid rows, each
    candidate slot attacked with either sign."""
    cfg, jmodel, tmodel, prefix, _ = vm_trained
    ja, ta = _attacks(jmodel, tmodel)
    rows, _ = _rows(cfg, jmodel, prefix, 12)
    rows_padded = jmodel.dims.padded(jmodel.dims.token_vocab_size)
    checked = 0
    for row in rows[:8]:
        src, pth, dst, mask, cand, cmask = row
        jids = tuple(jnp.asarray(a) for a in row)
        tids = ta.tensors(row)
        assert int(ta.predict_fn(tmodel.params, tids)) \
            == int(ja.predict_fn(jmodel.params, jids))
        for k in ta.attackable_slots(cand, cmask)[:2]:
            tok = int(cand[k])
            occ = (src == tok, dst == tok, cand == tok)
            spare = tga.spare_row(rows_padded, src, dst, cand)
            for label, sign in ((k, 1.0), (0, -1.0)):
                want = np.asarray(ja.score_fn(
                    jmodel.params, jids, tuple(jnp.asarray(o) for o in occ),
                    jnp.int32(spare), jnp.int32(label), sign))
                got = ta.score_fn(tmodel.params, tids, ta.tensors(occ),
                                  label, sign).numpy()
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=BF16 * np.abs(want).max())
            short = np.arange(2, 34, dtype=np.int32)
            jl, jp = ja.eval_fn(jmodel.params, jids, tuple(
                jnp.asarray(o) for o in occ), jnp.asarray(short),
                jnp.int32(k))
            (sl,) = ta.tensors((short,))
            tl, tp = ta.eval_fn(tmodel.params, tids, ta.tensors(occ), sl, k)
            jl = np.asarray(jl)
            np.testing.assert_allclose(tl.numpy(), jl, rtol=F32_LOSS,
                                       atol=F32_LOSS)
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
            checked += 1
    assert checked >= 8


def _same(got, want):
    assert got.__dict__ == want.__dict__


@pytest.mark.parametrize("kw", [dict(max_renames=1), dict(max_renames=2),
                                dict(max_renames=0)],
                         ids=["one", "two", "none"])
def test_vm_untargeted_attack_matches_jax(vm_trained, kw):
    cfg, jmodel, tmodel, prefix, _ = vm_trained
    ja, ta = _attacks(jmodel, tmodel, max_iters=4)
    rows, _ = _rows(cfg, jmodel, prefix, 12)
    for r in rows:
        _same(ta.attack_method(tmodel.params, r, targeted=False, **kw),
              ja.attack_method(jmodel.params, r, targeted=False, **kw))


def test_vm_targeted_attack_matches_jax(vm_trained):
    """Each row aimed at a live slot other than its clean prediction, as
    tests/test_vm_attack.py aims it, with the forbidden-id guard."""
    cfg, jmodel, tmodel, prefix, _ = vm_trained
    ja, ta = _attacks(jmodel, tmodel, max_iters=5, top_k_candidates=48)
    rows, _ = _rows(cfg, jmodel, prefix, 12)
    tried = 0
    for r in rows:
        cmask = np.asarray(r[5])
        clean = ja.attack_method(jmodel.params, r, max_renames=0)
        live = [k for k in range(len(cmask))
                if cmask[k] > 0 and k != clean.original_slot]
        if not live:
            continue
        kw = dict(targeted=True, target_slot=live[0], max_renames=2,
                  forbidden=frozenset({2, 3}))
        _same(ta.attack_method(tmodel.params, r, **kw),
              ja.attack_method(jmodel.params, r, **kw))
        tried += 1
    assert tried >= 8


def test_vm_attack_errors_match_jax(vm_trained):
    cfg, jmodel, tmodel, prefix, _ = vm_trained
    ja, ta = _attacks(jmodel, tmodel)
    rows, _ = _rows(cfg, jmodel, prefix, 1)
    for attack, params in ((ja, jmodel.params), (ta, tmodel.params)):
        with pytest.raises(ValueError, match="slot"):
            attack.attack_method(params, rows[0], targeted=True)
        with pytest.raises(ValueError, match="not a live candidate"):
            attack.attack_method(params, rows[0], targeted=True,
                                 target_slot=99)


@pytest.mark.parametrize("max_renames", [1, 2])
def test_vm_robustness_report_matches_jax(vm_trained, max_renames):
    _, jmodel, tmodel, prefix, _ = vm_trained
    kw = dict(n_methods=20, max_renames=max_renames, max_iters=3,
              log=lambda *_: None)
    want = jvmr.evaluate_vm_robustness(jmodel, prefix + ".val.vm.c2v", **kw)
    got = tvmr.evaluate_vm_robustness(tmodel, prefix + ".val.vm.c2v", **kw)
    assert got["n_methods"] > 0
    want.pop("seconds"), got.pop("seconds")
    assert got == want


def test_vm_robustness_cli_matches_the_function(vm_trained, capsys):
    """`python -m code2vec_tpu_torch.attacks.vm_robustness --backend cpu`
    on the imported checkpoint prints the report of
    evaluate_vm_robustness (but for `seconds`)."""
    import json
    _, _, tmodel, prefix, dest = vm_trained
    test = prefix + ".val.vm.c2v"
    assert tvmr.main(["--load", dest, "--test", test, "--n", "12",
                      "--iters", "2", "--backend", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = tvmr.evaluate_vm_robustness(tmodel, test, n_methods=12,
                                       max_iters=2, log=lambda *_: None)
    got.pop("seconds"), want.pop("seconds")
    assert got == want

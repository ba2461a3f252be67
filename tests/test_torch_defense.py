"""The port's rename defense (attacks/defense.py and the dense step's
augmentation hook, `--adv_rename_prob`) against the JAX package's, on
the CPU.

JAX's augment draws its slot choice, replacement and gate from the key
its step splits off (`rng, aug_rng = split(rng)`, then `r_slot, r_new,
r_apply = split(aug_rng, 3)`); the same values are drawn here with
`jax.random` from those keys and handed to the port as `RenameDraws`
(the Gumbel noise of `categorical`, the `randint` indices, the
`uniform` under `bernoulli`, the `batch` roll). The augmented batch is
then JAX's, id for id. The defended dense step is held to the JAX step
on the same params, batches and draws within tests/test_torch_dense_step
.py's bounds for its table and compute dtypes.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.attacks import defense as jdef
from code2vec_tpu.models import encoder as jenc
from code2vec_tpu.ops.quant import opt_param_view as j_opt_param_view
from code2vec_tpu.training import optimizers as jopt
from code2vec_tpu.training.steps import make_train_step as j_make_train_step
from code2vec_tpu.vocab.vocabularies import Vocab as JVocab
from code2vec_tpu.vocab.vocabularies import VocabType as JVocabType
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.attacks import defense as tdef
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models import encoder as tenc
from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
from code2vec_tpu_torch.training import optimizers as topt
from code2vec_tpu_torch.training.draws import make_draws
# the port's step updates in place and donates nothing
from code2vec_tpu_torch.training.steps import \
    make_train_step as make_port_train_step
from code2vec_tpu_torch.vocab.vocabularies import Vocab, VocabType
import test_torch_dense_step as tds

CPU = torch.device("cpu")


def jax_rename_draws(aug_rng, batch_size: int, max_contexts: int,
                     n_legal: int, mode: str) -> tdef.RenameDraws:
    """The values JAX's augment draws from `aug_rng`, as RenameDraws."""
    B = batch_size
    r_slot, r_new, r_apply = jax.random.split(aug_rng, 3)
    gumbel = jax.random.gumbel(r_slot, (B, 2 * max_contexts), jnp.float32)
    shift = 0
    if mode == "batch" and B > 1:
        shift = int(jax.random.randint(r_new, (), 1, B))
        index = jax.random.randint(jax.random.fold_in(r_new, 1), (B,), 0,
                                   n_legal)
    else:
        index = jax.random.randint(r_new, (B,), 0, n_legal)
    apply_u = jax.random.uniform(r_apply, (B,), jnp.float32)
    return tdef.RenameDraws(
        gumbel=torch.from_numpy(np.array(gumbel)),
        index=torch.from_numpy(np.array(index).astype(np.int64)),
        apply_u=torch.from_numpy(np.array(apply_u)), shift=shift)


def _words(r, n):
    """Token words: renderable identifiers, literals, two-part names."""
    out = []
    for i in range(n):
        kind = i % 4
        out.append(f"v{i}" if kind == 0 else
                   f"name|part{chr(97 + i % 26)}" if kind == 1 else
                   "".join(chr(97 + int(c)) for c in r.integers(0, 26, 5)))
    return out


def test_legal_token_mask_matches_jax():
    r = np.random.default_rng(0)
    words = _words(r, 60) + ["while", "int", "get|html"]
    dims = jenc.ModelDims(token_vocab_size=len(words) + 2, path_vocab_size=5,
                          target_vocab_size=5, vocab_pad_multiple=8)
    want = jdef.legal_token_mask(JVocab(JVocabType.Token, words), dims)
    got = tdef.legal_token_mask(Vocab(VocabType.Token, words),
                                tenc.ModelDims(**vars(dims)))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(words)
    with pytest.raises(ValueError, match="no legal rename tokens"):
        tdef.legal_token_mask(Vocab(VocabType.Token, ["1", "x2"]),
                              tenc.ModelDims(4, 3, 3))


def _aug_batch(r, B, C, V):
    src = r.integers(0, V, (B, C)).astype(np.int32)
    dst = r.integers(0, V, (B, C)).astype(np.int32)
    # repeated variables, so a rename touches several slots
    src[:, :3] = src[:, :1]
    dst[:, 2:4] = src[:, :1]
    mask = (r.random((B, C)) > 0.25).astype(np.float32)
    if B > 2:
        mask[1] = 0.0                  # an all-padding row
        src[2], dst[2] = 1, 0          # a row with no legal token
    return (r.integers(0, 9, B).astype(np.int32), src,
            r.integers(0, 50, (B, C)).astype(np.int32), dst, mask,
            np.ones((B,), np.float32))


@pytest.mark.parametrize("prob", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("B", [1, 2, 7])
@pytest.mark.parametrize("mode", ["uniform", "batch"])
def test_rename_augment_matches_jax(mode, B, prob):
    """make_rename_augment with the JAX draws gives JAX's batch, id for
    id, over 6 keys (both sides, src and dst)."""
    C, V = 12, 90
    r = np.random.default_rng(B)
    legal = r.random(96) < 0.6
    legal[:2] = False                  # PAD, OOV
    legal[V:] = False                  # padding rows
    j_aug = jdef.make_rename_augment(legal, prob, mode=mode)
    t_aug = tdef.make_rename_augment(legal, prob, mode=mode, device="cpu")
    changed = 0
    for seed in range(6):
        batch = _aug_batch(r, B, C, V)
        key = jax.random.PRNGKey(seed)
        want = j_aug(tuple(jnp.asarray(a) for a in batch), key)
        draws = jax_rename_draws(key, B, C, int(legal.sum()), mode)
        got = t_aug(tuple(torch.from_numpy(a) for a in batch), draws)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        changed += int((np.asarray(want[1]) != batch[1]).sum()
                       + (np.asarray(want[3]) != batch[3]).sum())
    assert (changed > 0) == (prob > 0)


def test_jax_gumbel_is_the_categorical_noise():
    """`categorical(key, logits)` is `argmax(logits + gumbel(key))`, the
    identity the port's slot choice rests on."""
    logits = jnp.where(jnp.asarray(np.random.default_rng(1).random((9, 40))
                                   > 0.5), 0.0, -1e9)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = jax.random.categorical(key, logits, axis=-1)
        got = jnp.argmax(logits + jax.random.gumbel(key, logits.shape,
                                                    jnp.float32), axis=-1)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _legal(dims):
    r = np.random.default_rng(7)
    legal = r.random(dims.padded(dims.token_vocab_size)) < 0.5
    legal[:2] = False
    legal[dims.token_vocab_size:] = False
    return legal


def _run_defended(tables_dtype, compute, mode, steps=2, prob=0.7):
    """The dense step with the rename augment, both packages, `steps`
    steps from one state with the same draws."""
    jd, td = tds._dims(jenc, tables_dtype), tds._dims(tenc, tables_dtype)
    legal = _legal(jd)
    jp = jenc.init_params(jax.random.PRNGKey(0), jd)
    j_tx = jopt.make_optimizer(jopt.make_lr(tds.LR, "cosine", tds.HORIZON))
    js = j_tx.init(j_opt_param_view(jp))
    tp = tds._t(jp)
    ts = convert.dense_opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), CPU)
    jstep = j_make_train_step(
        jd, j_tx, compute_dtype=getattr(jnp, compute),
        augment_fn=jdef.make_rename_augment(legal, prob, mode=mode))
    t_aug = tdef.make_rename_augment(legal, prob, mode=mode, device="cpu")
    tstep = make_port_train_step(
        td, topt.make_optimizer(topt.make_lr(tds.LR, "cosine", tds.HORIZON)),
        compute_dtype=getattr(torch, compute), augment_fn=t_aug)
    assert tstep.cfg.augment is t_aug
    r = np.random.default_rng(1)
    losses = []
    for i in range(steps):
        batch = tds._batch(r)
        rng = jax.random.PRNGKey(100 + i)
        rest, aug_rng = jax.random.split(rng)
        draws = tds._jax_draws(rest, jp, jd, False)
        draws.rename = jax_rename_draws(aug_rng, tds.B, tds.C,
                                        int(legal.sum()), mode)
        jp, js, jl = jstep(jp, js, tuple(jnp.asarray(a) for a in batch), rng)
        tl = tstep(tp, ts, tuple(torch.from_numpy(a) for a in batch), draws)
        losses.append((float(tl), float(jl)))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (convert.params_to_numpy(tp), to_np(jp),
            convert.dense_opt_state_to_numpy(ts), to_np(js), losses)


@pytest.mark.parametrize("mode", ["uniform", "batch"])
def test_defended_float32_dense_step_matches_jax(mode):
    """float32 tables and compute, 2 defended steps: the bounds of
    test_float32_dense_step_matches_jax (loss within 1e-6 relative;
    params within 1e-5 of their largest value on 99% of the elements,
    within 2 * lr * steps everywhere; state within 1e-5 on 99%, 1e-4
    everywhere)."""
    steps = 2
    tp, jp, ts, js, losses = _run_defended("float32", "float32", mode, steps)
    for lt, lj in losses:
        assert abs(lt - lj) <= 1e-6 * abs(lj)
    for name, a, b in [*tds._param_pairs(tp, jp), *tds._state_pairs(ts, js)]:
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if not name.endswith(".count"):
            tds._check_f32_bound(name, a, b, steps)
    tds._check_counts(ts, js, steps)


@pytest.mark.parametrize("mode", ["uniform", "batch"])
def test_defended_int8_dense_step_matches_jax(mode):
    """int8 token/path tables with float32 compute and shared salts, 2
    defended steps: test_int8_dense_step_matches_jax's bounds (q within
    1 on at most 1e-2 of the elements, loss within 1e-5 relative, the
    dequantized rows and the rest under the bf16 bound)."""
    steps = 2
    tp, jp, ts, js, losses = _run_defended("int8", "float32", mode, steps)
    for lt, lj in losses:
        assert abs(lt - lj) <= 1e-5 * abs(lj)
    for k in ("token_emb", "path_emb"):
        q_t, q_j = tp[k]["q"], jp[k]["q"]
        dq = np.abs(q_t.astype(np.int32) - q_j.astype(np.int32))
        assert dq.max() <= 1 and (dq > 0).mean() <= 1e-2, k
        tds._check_bf16_bound(k, q_t * tp[k]["s"], q_j * jp[k]["s"], steps)
    for name, a, b in [*tds._param_pairs(tp, jp), *tds._state_pairs(ts, js)]:
        if not name.endswith((".q", ".s", ".count")):
            tds._check_bf16_bound(name, a, b, steps)
    tds._check_counts(ts, js, steps)


def test_the_defense_changes_the_step():
    """A defended step's loss is not the undefended one's (the rename
    reaches the forward), and the sparse-row step refuses the hook."""
    defended = _run_defended("float32", "float32", "batch", 1, prob=1.0)
    plain = tds._run_both("float32", "float32", False, 1)
    assert defended[4][0][1] != plain[4][0][1]
    with pytest.raises(ValueError, match="no augmentation hook"):
        make_port_train_step(tds._dims(tenc, "float32"),
                             topt.AdamF32Moments(0.01), sparse_updates=True,
                             augment_fn=lambda b, d: b)


@pytest.mark.parametrize("mode", ["uniform", "batch"])
def test_make_draws_adds_the_rename_draws(mode):
    """make_draws with an augment draws RenameDraws from a generator of
    their own: the same (seed, step) gives the same draws, the keep mask
    is that of a step without the augment, and the draws are in range."""
    dims = tds._dims(tenc, "float32")
    legal = _legal(dims)
    aug = tdef.make_rename_augment(legal, 0.3, mode=mode, device="cpu")
    params = tds._t(jenc.init_params(jax.random.PRNGKey(0),
                                     tds._dims(jenc, "float32")))

    def draws(augment, step):
        cfg = make_port_train_step(
            dims, topt.make_optimizer(topt.make_lr(0.1, "constant", 1)),
            augment_fn=augment).cfg
        return make_draws(dims, cfg, params, 8, 239, step, CPU)
    a, b, plain = draws(aug, 3), draws(aug, 3), draws(None, 3)
    assert plain.rename is None
    assert torch.equal(a.keep, plain.keep)
    for x, y in ((a.rename.gumbel, b.rename.gumbel),
                 (a.rename.index, b.rename.index),
                 (a.rename.apply_u, b.rename.apply_u)):
        assert torch.equal(x, y)
    assert a.rename.shift == b.rename.shift
    assert a.rename.gumbel.shape == (8, 2 * dims.max_contexts)
    assert int(a.rename.index.max()) < int(legal.sum())
    assert (1 <= a.rename.shift <= 7) if mode == "batch" \
        else a.rename.shift == 0
    assert not torch.equal(draws(aug, 4).rename.gumbel, a.rename.gumbel)


# ---- the trainer, the manifest and the import tool ----

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from helpers import build_tiny_dataset
    return build_tiny_dataset(str(tmp_path_factory.mktemp("defense")),
                              n_train=128, n_val=16, n_test=16,
                              max_contexts=16)


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("flags,prob,mode", [
    ([], 0.0, "uniform"),
    (["--adv_rename_prob", "0.4"], 0.4, "uniform"),
    (["--adv_rename_prob", "0.3", "--adv_rename_mode", "batch"], 0.3,
     "batch")], ids=["off", "uniform", "batch"])
def test_cli_training_records_the_defense_in_the_manifest(dataset, tmp_path,
                                                          flags, prob, mode):
    """`--adv_rename_prob` trains through the augmented dense step, and the
    manifest records the run's prob and mode, as the JAX package's does
    (it wrote 0.0 / "uniform" whatever the run did before)."""
    from code2vec_tpu_torch import cli
    ckpt = str(tmp_path / "ckpt")
    argv = ["--data", dataset, "--save", ckpt, "--epochs", "1",
            "--batch_size", "32", "--max_contexts", "16", "--backend", "cpu",
            "--no_bf16", *flags]
    assert cli.main(argv) == 0
    m = _manifest(ckpt)
    assert (m["adv_rename_prob"], m["adv_rename_mode"]) == (prob, mode)
    cfg = Config.load_from_args(argv)
    trainer = Code2VecTrainer.from_config(cfg, device="cpu")
    aug = trainer.step_config.augment
    assert (aug is None) == (prob == 0.0)
    if aug is not None:
        assert (aug.prob, aug.mode) == (prob, mode)
        draws = trainer.draws_for(32, 0)
        assert draws.rename is not None
        trainer.train_step(trainer.device_batch(next(iter(
            trainer._train_reader(cfg.data_path("train"), 0)))), draws)


def test_import_tool_carries_the_jax_manifest_values(dataset, tmp_path):
    """tools/import_jax_checkpoint.py keeps a JAX manifest's
    adv_rename_prob and adv_rename_mode unchanged."""
    import tools.import_jax_checkpoint as tool
    from code2vec_tpu.models.jax_model import Code2VecModel as JaxModel
    from test_model import tiny_config
    cfg = tiny_config(dataset, NUM_TRAIN_EPOCHS=1, ADV_RENAME_PROB=0.25,
                      ADV_RENAME_MODE="batch", TABLES_DTYPE="float32")
    cfg.test_data_path = None
    model = JaxModel(cfg)
    model.train()
    src = str(tmp_path / "jax")
    model.save(src)
    model.close_session()
    dest = str(tmp_path / "imported")
    assert tool.main(["--jax_checkpoint", src, "--save", dest]) == 0
    want = _manifest(src)
    assert (want["adv_rename_prob"], want["adv_rename_mode"]) \
        == (0.25, "batch")
    got = _manifest(dest)
    assert (got["adv_rename_prob"], got["adv_rename_mode"]) \
        == (0.25, "batch")

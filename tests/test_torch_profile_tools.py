"""The port's profilers (code2vec_tpu_torch/tools/_bench_common.py,
profile_step.py, xf_profile.py) against the JAX package's root tools of
the same names, on the CPU at a tiny size (V <= 512, E 8, C 16, B 8).

Both sides take the same params (the JAX `init_params`, carried over by
`convert.params_from_numpy`) and the same numpy inputs; the sampled
classes are drawn on the JAX side (`sampled_softmax_loss` returns them)
and handed to the port. Tolerances, each test repeating its own:
- the constants, the slope arithmetic and the FLOP counts: equal;
- bf16 compute (profile_step's loss and gradients, xf_profile's cores):
  the two frameworks round bf16 products and sums at different places,
  so the loss is held within 1e-3 relative and each output or gradient
  leaf within 2 bf16 ulps (2^-6) of its largest magnitude (the largest
  differences seen are 2^-8 to 2^-7.2 of it).
"""

import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.models import encoder as jenc
from code2vec_tpu.models import transformer_encoder as jxf
from code2vec_tpu.ops import sampled_softmax as jss
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.models.encoder import ModelDims
from code2vec_tpu_torch.tools import _bench_common as bc
from code2vec_tpu_torch.tools import profile_step, xf_profile
from code2vec_tpu_torch.training.draws import StepDraws
from code2vec_tpu_torch.training.steps import dense_loss_and_grads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
B, C, E = 8, 16, 8
VT, VP, VY, S = 300, 200, 150, 32
BF16_TOL = 2.0 ** -6   # 2 bf16 ulps of the largest magnitude
LOSS_RTOL = 1e-3


def _jax_tool(name):
    """A JAX root tool loaded from tools/ by path (no import of bench.py
    happens: the loaded tools import it only inside functions)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dims(**kw):
    fields = dict(token_vocab_size=VT, path_vocab_size=VP,
                  target_vocab_size=VY, embeddings_size=E, max_contexts=C,
                  tables_dtype="bfloat16", **kw)
    return jenc.ModelDims(**fields), ModelDims(**fields)


def _params(jd):
    jp = jenc.init_params(jax.random.PRNGKey(0), jd)
    return jp, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), CPU)


def _f32(a):
    return np.asarray(a).astype(np.float32)


@pytest.fixture
def one_thread():
    """One intra-op thread for the timed chains at a tiny size: with the
    suite's workers sharing the cores, each tiny op's thread team waited
    on the others (the xf_profile chains took 100 s under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _assert_bf16_close(got, want, name):
    """Within BF16_TOL of the reference's largest magnitude."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= BF16_TOL * scale, (
        name, float(np.abs(got - want).max()), scale)


# ---- _bench_common ----

def test_bench_common_constants_equal_the_jax_module():
    jb = _jax_tool("_bench_common")
    for name in ("TOKEN_VOCAB", "PATH_VOCAB", "TARGET_VOCAB", "BATCH",
                 "CTX", "NUM_SAMPLED"):
        assert getattr(bc, name) == getattr(jb, name), name
    # the port's profile_step keeps the JAX tool's own copies too
    jp = _jax_tool("profile_step")
    for name in ("TOKEN_VOCAB", "PATH_VOCAB", "TARGET_VOCAB", "CTX",
                 "NUM_SAMPLED"):
        assert getattr(profile_step, name) == getattr(jp, name), name


@pytest.mark.parametrize("warmup,base,steps", [(5, 10, 20), (1, 2, 3),
                                               (0, 4, 1)])
def test_slope_time_on_a_scripted_chain_gives_the_jax_result(warmup, base,
                                                             steps):
    """A chain whose n calls take 0.25 + 0.5 n + n^2 / 1000 s (a fixed
    cost, a per-call cost, a drift): both helpers read the same seconds
    a call, exactly, and see the same chain lengths."""
    jb = _jax_tool("_bench_common")
    results = []
    for helper in (bc.slope_time, jb.slope_time):
        seen = []

        def chain(n, state):
            seen.append((n, state))
            return 0.25 + 0.5 * n + n * n / 1000.0, state + 1

        results.append((helper(chain, 0, steps, warmup=warmup, base=base),
                        seen))
    assert results[0] == results[1]
    assert [n for n, _ in results[0][1]] == [warmup, base, base + steps]


def test_time_fn_syncs_each_chain_on_the_last_output():
    outs = []

    def fn(x):
        outs.append(x + len(outs))
        return outs[-1]

    synced = []
    dt = bc.time_fn(fn, (torch.zeros(3),), 4,
                    sync=lambda o: synced.append(o.clone()))
    assert math.isfinite(dt)
    assert len(outs) == 5 + 10 + 14 and len(synced) == 3
    assert torch.equal(synced[-1], outs[-1])
    # the default sync reads one element back
    assert bc.scalar_sync(torch.tensor([[3.5, 1.0]])) == 3.5


def test_backend_gpu_without_a_card_is_none():
    assert not torch.cuda.is_available()
    assert bc.backend_device("gpu") is None
    assert bc.backend_device("cpu") == CPU
    assert bc.card_line(CPU) == "cpu"


# ---- profile_step ----

def _profile_inputs(jd, td):
    batch = profile_step.make_batch(td, B, CPU)
    return batch, tuple(jnp.asarray(t.numpy()) for t in batch)


def _jax_loss_fn(jd, jbatch):
    """The JAX tool's loss_fn (tools/profile_step.py), over these dims."""
    labels, src, pth, dst, mask, weights = jbatch

    def loss_fn(params, rng):
        code, _ = jenc.encode(params, src, pth, dst, mask,
                              compute_dtype=jnp.bfloat16)
        loss, sampled = jss.sampled_softmax_loss(
            params["target_emb"], code, labels, rng, S,
            example_weights=weights, vocab_size=VY)
        return loss, sampled
    return loss_fn


def test_profile_step_batch_is_the_jax_tools_draws():
    """The JAX tool's ids: numpy seed 0, labels, src, pth, dst in turn;
    every context and example live."""
    _, td = _dims()
    labels, src, pth, dst, mask, weights = profile_step.make_batch(td, B, CPU)
    r = np.random.default_rng(0)
    np.testing.assert_array_equal(
        labels.numpy(), r.integers(0, VY, (B,), dtype=np.int32))
    for got, v in ((src, VT), (pth, VP), (dst, VT)):
        np.testing.assert_array_equal(
            got.numpy(), r.integers(0, v, (B, C), dtype=np.int32))
    assert torch.all(mask == 1) and torch.all(weights == 1)


def test_profile_step_forward_loss_matches_jax():
    """Loss within LOSS_RTOL (bf16 compute)."""
    jd, td = _dims()
    jp, tp = _params(jd)
    batch, jbatch = _profile_inputs(jd, td)
    jloss, sampled = _jax_loss_fn(jd, jbatch)(jp, jax.random.PRNGKey(1))
    draws = StepDraws(keep=None, sampled=torch.from_numpy(
        np.array(sampled)), salts={})
    tloss = profile_step.forward_loss_fn(td, S, use_kernel=True)(
        tp, batch, draws)
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))


def test_profile_step_forward_backward_gradients_match_jax():
    """jax.value_and_grad of the JAX tool's loss against the port's
    `dense_loss_and_grads` of its loss: the loss within LOSS_RTOL, every
    gradient leaf within BF16_TOL of its largest magnitude."""
    jd, td = _dims()
    jp, tp = _params(jd)
    batch, jbatch = _profile_inputs(jd, td)
    loss_fn = _jax_loss_fn(jd, jbatch)
    rng = jax.random.PRNGKey(1)
    sampled = loss_fn(jp, rng)[1]
    (jloss, _), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jp, rng)
    draws = StepDraws(keep=None, sampled=torch.from_numpy(
        np.array(sampled)), salts={})
    tloss, tgrads, _ = dense_loss_and_grads(
        tp, batch, draws, profile_step.forward_loss_fn(td, S, True))
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert sorted(tgrads) == sorted(jgrads)
    for k in jgrads:
        _assert_bf16_close(tgrads[k].float().numpy(), jgrads[k], k)


def test_profile_step_runs_every_phase_at_a_tiny_size(capsys, one_thread):
    """The JAX tool's phases and telemetry names, each time finite."""
    _, td = _dims()
    emitted = []
    out = profile_step.run_profile(
        td, B, 2, CPU, use_kernel=True, num_sampled=S,
        emit=lambda phase, ms, **extra: emitted.append((phase, extra)))
    names = ["forward", "forward_backward", "full_step_adam",
             "full_step_adafactor"]
    assert list(out) == names == [p for p, _ in emitted]
    assert all(math.isfinite(v) for v in out.values())
    assert all("pc_per_sec" in x for p, x in emitted if p.startswith("full"))
    printed = capsys.readouterr().out
    for line in ("forward only:", "forward + backward:",
                 "full step (adam):", "full step (adafactor):"):
        assert line in printed, line


# ---- xf_profile ----

def _xf_dims():
    return _dims(encoder_type="transformer", xf_layers=2, xf_heads=3)


def _x_bcd(D):
    r = np.random.default_rng(5)
    return r.normal(size=(B, C, D)).astype(np.float32)


def test_xf_profile_attn_core_matches_jax():
    """The L attention blocks (JAX `_rms_norm` + `_mha`, the tool's
    attn_fn) on one bf16 input: within BF16_TOL."""
    jd, td = _xf_dims()
    jp, tp = _params(jd)
    x = _x_bcd(td.context_vector_size)
    log_mask = np.zeros((B, C), np.float32)
    log_mask[:, C - 3:] = math.log(1e-30)  # three masked keys
    jx = jnp.asarray(x, jnp.bfloat16)
    for layer in jp["xf"]["layers"]:
        h = jxf._rms_norm(jx, layer["ln1_scale"])
        jx = jx + jxf._mha(h, layer["qkv"], layer["out"],
                           jnp.asarray(log_mask), 3)
    got = xf_profile.attn_core(
        tp["xf"], torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(log_mask), 3, use_kernel=True)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got.float().numpy(), jx, "attn_core_fwd")


def test_xf_profile_mlp_core_matches_jax():
    """The L MLP blocks (the tool's mlp_fn, `jax.nn.gelu`'s tanh form):
    within BF16_TOL."""
    jd, td = _xf_dims()
    jp, tp = _params(jd)
    x = _x_bcd(td.context_vector_size)
    jx = jnp.asarray(x, jnp.bfloat16)
    for layer in jp["xf"]["layers"]:
        h = jxf._rms_norm(jx, layer["ln2_scale"])
        h = jax.nn.gelu(h @ layer["mlp_up"].astype(jnp.bfloat16))
        jx = jx + h @ layer["mlp_down"].astype(jnp.bfloat16)
    got = xf_profile.mlp_core(tp["xf"],
                              torch.from_numpy(x).to(torch.bfloat16))
    _assert_bf16_close(got.float().numpy(), jx, "mlp_core_fwd")


def test_xf_profile_emb_gathers_match_jax():
    """The tool's emb_fn: three takes, concat, bf16, in_proj."""
    jd, td = _xf_dims()
    jp, tp = _params(jd)
    batch = profile_step.make_batch(td, B, CPU)
    src, pth, dst = (jnp.asarray(t.numpy()) for t in batch[1:4])
    e = jnp.concatenate([jnp.take(jp["token_emb"], src, axis=0),
                         jnp.take(jp["path_emb"], pth, axis=0),
                         jnp.take(jp["token_emb"], dst, axis=0)],
                        axis=-1).astype(jnp.bfloat16)
    want = e @ jp["xf"]["in_proj"].astype(jnp.bfloat16)
    got = xf_profile.emb_in_proj(tp, *batch[1:4])
    _assert_bf16_close(got.float().numpy(), want, "emb_gathers_in_proj")


@pytest.mark.parametrize("L,H,batch,sampled", [(2, 3, 1024, 4096),
                                               (1, 4, 8, 32), (3, 2, 64, 7)])
def test_xf_profile_flops_equal_the_jax_expressions(L, H, batch, sampled):
    """tools/xf_profile.py's analytic FLOPs and logits bytes, written out
    as the JAX tool writes them: equal."""
    Bq, CTX, D = batch, 200, 384
    MLP = 4 * D
    attn_flops = L * (2 * Bq * CTX * D * 3 * D
                      + 2 * 2 * Bq * H * CTX * CTX * (D // H)
                      + 2 * Bq * CTX * D * D)
    mlp_flops = L * 2 * 2 * Bq * CTX * D * MLP
    enc_flops = (2 * Bq * CTX * D * D + attn_flops + mlp_flops
                 + 2 * Bq * CTX * D)
    head_flops = 2 * Bq * (sampled + 1) * D
    dims = xf_profile.java_large_dims(L, H)
    got = xf_profile.phase_flops(dims, batch, sampled)
    assert got == {
        "emb_gathers_in_proj": 2 * Bq * CTX * D * D,
        "attn_core_fwd": attn_flops,
        "xla_logits_hbm_bytes": L * Bq * H * CTX * CTX * 4,
        "mlp_core_fwd": mlp_flops, "encoder_fwd": enc_flops,
        "loss_fwd": enc_flops + head_flops,
        "fwd_bwd": 3 * (enc_flops + head_flops)}


def test_xf_profile_runs_every_phase_at_a_tiny_size(capsys, one_thread):
    """The JAX tool's phase names and row keys (the plain variant off the
    card), each time finite."""
    _, td = _xf_dims()
    rows = xf_profile.run_profile(td, B, 2, CPU, matmul_size=64,
                                  num_sampled=S)
    assert [r["phase"] for r in rows] == [
        "matmul_peak_bf16", "emb_gathers_in_proj", "attn_core_fwd",
        "mlp_core_fwd", "encoder_fwd", "loss_fwd_plain", "fwd_bwd_plain",
        "full_step_adafactor_plain"]
    for r in rows:
        assert set(r) >= {"phase", "ms", "tflops_per_sec"}, r
        assert math.isfinite(r["ms"]), r
    assert set(rows[2]) == {"phase", "ms", "tflops_per_sec",
                            "xla_logits_hbm_bytes"}
    assert "pc_per_sec" in rows[-1]
    assert "measured bf16 matmul peak:" in capsys.readouterr().out


# ---- the command lines ----

@pytest.mark.parametrize("tool", [profile_step, xf_profile],
                         ids=["profile_step", "xf_profile"])
def test_the_profilers_exit_2_without_a_card(tool, capsys):
    assert tool.main([]) == 2
    assert "--backend gpu" in capsys.readouterr().err

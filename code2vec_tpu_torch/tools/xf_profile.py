"""Phase-level profile of the transformer training step on the card: a
copy of tools/xf_profile.py of the JAX package over the port.

It slope-times each phase of the xf2 java-large step (B = 1024, C = 200,
D = 384, `--heads` H = 3, `--layers` L = 2, bf16 compute) and compares it
with a measured matmul peak (a big bf16 product on this card, not a
quoted figure), so the output says whether the step is bound by the
tensor cores, by memory, or idle.

Phases (one JSON line each, the JAX tool's keys and phase names):
  matmul_peak_bf16     [8192 x 8192] @ [8192 x 8192] bf16 (`torch.matmul`)
  emb_gathers_in_proj  the 3 embedding takes + concat + in_proj
  attn_core_fwd        the L attention blocks alone (qkv, the attention
                       core, out) on real shapes; with the logits bytes
                       an unfused path writes ([B, H, C, C] float32)
  mlp_core_fwd         the L MLP blocks alone
  encoder_fwd          the whole encoder forward (layers + pool)
  loss_fwd_<tag>       encoder + sampled softmax head
  fwd_bwd_<tag>        forward + backward (every gradient made)
  full_step_adafactor_<tag>  the shipped Adafactor train step

Analytic FLOPs (the JAX tool's expressions) give each phase's TFLOP/s.
The JAX tool's two variants, XLA (`use_pallas=False`) and its Pallas
kernels, are here `plain` (`use_kernel=False`: kernels 2 and 3's plain
versions) and `kernel` (`use_kernel=True`: kernels 2 and 3 on the card);
`kernel` runs only on the card, as the JAX tool's Pallas variant runs
only on a TPU. The attention and encoder phases run the port's default
path: kernels 2 and 3 on the card, their plain versions on the CPU.

    python3 -m code2vec_tpu_torch.tools.xf_profile [--steps 30]
        [--layers 2] [--heads 3] [--backend gpu|cpu]

`--backend gpu` (the default) exits 2 without a CUDA card. The phases
are functions of their dims (`run_profile`), so they run at any size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from code2vec_tpu_torch import tree
from code2vec_tpu_torch.models.encoder import ModelDims, init_params
from code2vec_tpu_torch.models.transformer_encoder import (_mha, _rms_norm,
                                                           encode_transformer)
from code2vec_tpu_torch.ops.quant import opt_param_view
from code2vec_tpu_torch.tools._bench_common import (
    BATCH, CTX, NUM_SAMPLED, PATH_VOCAB, TARGET_VOCAB, TOKEN_VOCAB,
    backend_device, card_line, scalar_sync, slope_time, time_fn)
from code2vec_tpu_torch.training.draws import make_draws
from code2vec_tpu_torch.training.optimizers import make_optimizer
from code2vec_tpu_torch.training.steps import (DenseStepConfig,
                                               dense_loss_and_grads,
                                               make_train_loss_fn,
                                               make_train_step)

E = 128
MATMUL_SIZE = 8192
BF16 = torch.bfloat16


def java_large_dims(layers: int = 2, heads: int = 3) -> ModelDims:
    """The JAX tool's dims: java-large vocabularies, E = 128, C = 200,
    bf16 tables, the transformer encoder."""
    return ModelDims(token_vocab_size=TOKEN_VOCAB,
                     path_vocab_size=PATH_VOCAB,
                     target_vocab_size=TARGET_VOCAB,
                     embeddings_size=E, max_contexts=CTX,
                     tables_dtype="bfloat16", encoder_type="transformer",
                     xf_layers=layers, xf_heads=heads)


def phase_flops(dims: ModelDims, batch: int,
                num_sampled: int = NUM_SAMPLED) -> Dict[str, int]:
    """The JAX tool's analytic FLOPs (and the logits bytes) of each
    phase at `dims` and `batch`."""
    B, C, L, H = batch, dims.max_contexts, dims.xf_layers, dims.xf_heads
    D = dims.context_vector_size
    MLP = dims.xf_mlp_ratio * D
    attn = L * (2 * B * C * D * 3 * D               # qkv
                + 2 * 2 * B * H * C * C * (D // H)  # qk, av
                + 2 * B * C * D * D)                # out
    mlp = L * 2 * 2 * B * C * D * MLP
    enc = 2 * B * C * D * D + attn + mlp + 2 * B * C * D
    head = 2 * B * (num_sampled + 1) * D
    return {"emb_gathers_in_proj": 2 * B * C * D * D, "attn_core_fwd": attn,
            "xla_logits_hbm_bytes": L * B * H * C * C * 4,
            "mlp_core_fwd": mlp, "encoder_fwd": enc,
            "loss_fwd": enc + head, "fwd_bwd": 3 * (enc + head)}


def emb_in_proj(params, src, pth, dst) -> torch.Tensor:
    """The three embedding takes, concatenated, cast to bf16, times
    in_proj."""
    e = torch.cat([params["token_emb"][src], params["path_emb"][pth],
                   params["token_emb"][dst]], dim=-1).to(BF16)
    return e @ params["xf"]["in_proj"].to(BF16)


def attn_core(xf, x: torch.Tensor, log_mask: torch.Tensor, heads: int,
              use_kernel: bool) -> torch.Tensor:
    """The L pre-norm attention blocks alone: x + MHA(rms_norm(x))."""
    for layer in xf["layers"]:
        h = _rms_norm(x, layer["ln1_scale"])
        x = x + _mha(h, layer["qkv"], layer["out"], log_mask, heads,
                     use_kernel)
    return x


def mlp_core(xf, x: torch.Tensor) -> torch.Tensor:
    """The L MLP blocks alone: x + down(gelu(up(rms_norm(x))))."""
    for layer in xf["layers"]:
        h = _rms_norm(x, layer["ln2_scale"])
        h = F.gelu(h @ layer["mlp_up"].to(BF16), approximate="tanh")
        x = x + h @ layer["mlp_down"].to(BF16)
    return x


def run_profile(dims: ModelDims, batch: int, steps: int, device, *,
                variants=None, matmul_size: int = MATMUL_SIZE,
                num_sampled: int = NUM_SAMPLED) -> List[dict]:
    """Every phase at `dims` on `device`, one row a phase as the JAX
    tool prints it. `variants` (default: `plain`, then `kernel` on the
    card) are the loss / fwd+bwd / full-step tags."""
    if variants is None:
        variants = ("plain", "kernel") if device.type == "cuda" \
            else ("plain",)
    on_card = device.type == "cuda"
    B, C, H = batch, dims.max_contexts, dims.xf_heads
    D = dims.context_vector_size
    fl = phase_flops(dims, B, num_sampled)
    params = init_params(torch.Generator(device=device).manual_seed(0), dims)

    r = np.random.default_rng(0)
    labels = r.integers(0, dims.target_vocab_size, (B,), np.int32)
    src = r.integers(0, dims.token_vocab_size, (B, C), np.int32)
    pth = r.integers(0, dims.path_vocab_size, (B, C), np.int32)
    dst = r.integers(0, dims.token_vocab_size, (B, C), np.int32)
    ids = [torch.from_numpy(a).to(device) for a in (labels, src, pth, dst)]
    mask = torch.ones((B, C), dtype=torch.float32, device=device)
    weights = torch.ones((B,), dtype=torch.float32, device=device)
    data = tuple(ids) + (mask, weights)
    x_bcd = torch.from_numpy(
        r.normal(size=(B, C, D)).astype(np.float32)).to(device).to(BF16)
    log_mask = torch.zeros((B, C), dtype=torch.float32, device=device)

    rows: List[dict] = []
    rates: Dict[str, float] = {}  # unrounded TFLOP/s, for the ratios

    def rec(name, dt, flops=None, extra=None):
        row = {"phase": name, "ms": round(dt * 1e3, 2)}
        if flops:
            rates[name] = flops / dt / 1e12
            row["tflops_per_sec"] = round(rates[name], 1)
        if extra:
            row.update(extra)
        rows.append(row)
        print(json.dumps(row), flush=True)
        return row

    # ---- the measured matmul peak ----
    M = matmul_size
    a = torch.from_numpy(r.standard_normal((M, M), np.float32)).to(
        device).to(BF16)
    bmat = torch.from_numpy(r.standard_normal((M, M), np.float32)).to(
        device).to(BF16)
    dt = time_fn(torch.matmul, (a, bmat), steps)
    peak_row = rec("matmul_peak_bf16", dt, flops=2 * M ** 3)
    del a, bmat

    xf = params["xf"]
    with torch.no_grad():
        dt = time_fn(emb_in_proj, (params, *ids[1:]), steps)
        rec("emb_gathers_in_proj", dt, flops=fl["emb_gathers_in_proj"])
        dt = time_fn(lambda x: attn_core(xf, x, log_mask, H, on_card),
                     (x_bcd,), steps)
        rec("attn_core_fwd", dt, flops=fl["attn_core_fwd"],
            extra={"xla_logits_hbm_bytes": fl["xla_logits_hbm_bytes"]})
        dt = time_fn(lambda x: mlp_core(xf, x), (x_bcd,), steps)
        rec("mlp_core_fwd", dt, flops=fl["mlp_core_fwd"])
        dt = time_fn(lambda *t: encode_transformer(
            params, *t, dims=dims, compute_dtype=BF16,
            use_kernel=on_card)[0], (*ids[1:], mask), steps)
        rec("encoder_fwd", dt, flops=fl["encoder_fwd"])

    cfg = DenseStepConfig(use_sampled_softmax=True, num_sampled=num_sampled,
                          compute_dtype=BF16)
    draws = make_draws(dims, cfg, params, B, 1, 0, device)
    fb = full = None
    for tag in variants:
        fb, full = measure_variant(tag, tag == "kernel", dims, params, data,
                                   draws, steps, device, rec, fl,
                                   num_sampled)

    peak = rates[peak_row["phase"]]
    print(f"\nmeasured bf16 matmul peak: "
          f"{peak_row['tflops_per_sec']} TFLOP/s")
    print(f"full step achieved:        {full['tflops_per_sec']} "
          f"TFLOP/s = {rates[full['phase']] / peak:.0%} of measured peak")
    print(f"fwd+bwd achieved:          {fb['tflops_per_sec']} TFLOP/s "
          f"= {rates[fb['phase']] / peak:.0%}", flush=True)
    return rows


def measure_variant(tag: str, use_kernel: bool, dims: ModelDims, params,
                    data, draws, steps: int, device, rec: Callable,
                    fl: Dict[str, int], num_sampled: int):
    """One attention path's loss, fwd+bwd and full Adafactor step (the
    JAX tool's `measure_variant`). Returns the fwd+bwd and full-step
    rows."""
    B = data[0].shape[0]
    loss_fn = make_train_loss_fn(dims, use_sampled_softmax=True,
                                 num_sampled=num_sampled, compute_dtype=BF16,
                                 use_kernel=use_kernel)
    with torch.no_grad():
        dt = time_fn(loss_fn, (params, data, draws), steps)
    rec(f"loss_fwd_{tag}", dt, flops=fl["loss_fwd"])
    dt = time_fn(dense_loss_and_grads, (params, data, draws, loss_fn),
                 steps, sync=lambda o: scalar_sync(o[0]))
    fb = rec(f"fwd_bwd_{tag}", dt, flops=fl["fwd_bwd"])

    opt = make_optimizer(1e-3)
    step = make_train_step(dims, opt, use_sampled_softmax=True,
                           num_sampled=num_sampled, compute_dtype=BF16,
                           use_kernel=use_kernel)
    # the step updates in place: each variant steps a copy of the params
    p = tree.map_leaves(torch.clone, params)
    s = opt.init(opt_param_view(p))

    def chain(n, k):
        t0 = time.perf_counter()
        loss = None
        for i in range(n):
            loss = step(p, s, data,
                        make_draws(dims, step.cfg, p, B, 2, k + i, device))
        scalar_sync(loss)
        return time.perf_counter() - t0, k + n

    dt = slope_time(chain, 0, steps)
    full = rec(f"full_step_adafactor_{tag}", dt, flops=fl["fwd_bwd"],
               extra={"pc_per_sec": round(B * dims.max_contexts / dt, 1)})
    return fb, full


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m code2vec_tpu_torch.tools.xf_profile",
        description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=3)  # the shipped default
    ap.add_argument("--backend", choices=("gpu", "cpu"), default="gpu",
                    help="gpu (default): the CUDA card, both variants; "
                         "cpu: the plain variant")
    args = ap.parse_args(argv)
    device = backend_device(args.backend)
    if device is None:
        return 2
    print(f"card: {card_line(device)}", flush=True)
    run_profile(java_large_dims(args.layers, args.heads), BATCH, args.steps,
                device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Phase-level profile of the java-large training step on the card: a
copy of tools/profile_step.py of the JAX package over the port.

Times, slope-timed (chains of `--steps` and 3 x `--steps` calls, each
ending in a scalar read, differenced), each of:

  - the card's streaming bandwidth (ops/membench.py, a 1 GiB read +
    write copy) -- the ceiling
  - forward only (encode + sampled softmax loss)
  - forward + backward (every gradient made)
  - the full step (forward, backward, optimizer, apply), Adam and
    Adafactor

at the JAX tool's shape: java-large vocabularies, bf16 tables and
compute, B = `--batch`, 200 contexts, 4096 sampled classes, random
weights and ids from seed 0. On the card every phase pools with kernel
1 (`use_kernel=True`; the JAX tool's steps take its Pallas kernel on a
TPU, its forward phases pool with XLA); with `--backend cpu` the plain
version, and the ceiling is not measured (ops/membench.py times the
card). `--telemetry_dir` also
writes each phase as a `profile` event and a `profile/<phase>_ms`
timer (code2vec_tpu_torch/obs), as the JAX tool does.

    python3 -m code2vec_tpu_torch.tools.profile_step [--batch 1024]
        [--steps 20] [--telemetry_dir DIR] [--backend gpu|cpu]

`--backend gpu` (the default) exits 2 without a CUDA card. The phases
are functions of their dims (`run_profile`), so they run at any size.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

from code2vec_tpu_torch import tree
from code2vec_tpu_torch.models.encoder import (ModelDims, encode,
                                               init_params, unused_param_keys)
from code2vec_tpu_torch.ops.quant import opt_param_view
from code2vec_tpu_torch.ops.sampled_softmax import (log_uniform_sample,
                                                    sampled_softmax_loss)
from code2vec_tpu_torch.tools._bench_common import (
    CTX, NUM_SAMPLED, PATH_VOCAB, TARGET_VOCAB, TOKEN_VOCAB, backend_device,
    card_line, scalar_sync)
from code2vec_tpu_torch.training.draws import StepDraws, make_draws
from code2vec_tpu_torch.training.optimizers import make_optimizer
from code2vec_tpu_torch.training.steps import (dense_loss_and_grads,
                                               make_train_step)

OPTIMIZERS = ("adam", "adafactor")


def java_large_dims() -> ModelDims:
    """The JAX tool's dims: java-large vocabularies, E = 128, C = 200,
    bf16 tables (the shipped config)."""
    return ModelDims(token_vocab_size=TOKEN_VOCAB,
                     path_vocab_size=PATH_VOCAB,
                     target_vocab_size=TARGET_VOCAB,
                     embeddings_size=128, max_contexts=CTX,
                     tables_dtype="bfloat16")


def timeit(fn: Callable, sync: Callable, steps: int, warmup: int = 3
           ) -> float:
    """Seconds a call: chains of `steps` and 3 x `steps` calls, each
    ended by `sync(last output)`, differenced (the JAX tool's method)."""
    def chain(n):
        out = None
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        sync(out)
        return time.perf_counter() - t0

    chain(warmup)
    t1 = chain(steps)
    t2 = chain(3 * steps)
    return (t2 - t1) / (2 * steps)


def make_batch(dims: ModelDims, batch: int, device) -> tuple:
    """The JAX tool's batch `(labels, src, pth, dst, mask, weights)`:
    ids from numpy seed 0 in its order, every context and example live."""
    r = np.random.default_rng(0)
    C = dims.max_contexts
    labels = r.integers(0, dims.target_vocab_size, (batch,), dtype=np.int32)
    src = r.integers(0, dims.token_vocab_size, (batch, C), dtype=np.int32)
    pth = r.integers(0, dims.path_vocab_size, (batch, C), dtype=np.int32)
    dst = r.integers(0, dims.token_vocab_size, (batch, C), dtype=np.int32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (labels, src, pth, dst)) + (
        torch.ones((batch, C), dtype=torch.float32, device=device),
        torch.ones((batch,), dtype=torch.float32, device=device))


def forward_loss_fn(dims: ModelDims, num_sampled: int, use_kernel: bool
                    ) -> Callable:
    """The JAX tool's `loss_fn`: encode (bf16 compute, no dropout) and
    the sampled softmax over `draws.sampled`, weighted by the example
    weights. `loss_fn(params, batch, draws)`, as `dense_loss_and_grads`
    takes it."""
    def loss_fn(params, batch, draws: StepDraws) -> torch.Tensor:
        labels, src, pth, dst, mask, weights = batch
        code, _ = encode(params, src, pth, dst, mask,
                         compute_dtype=torch.bfloat16,
                         use_kernel=use_kernel, train=True)
        return sampled_softmax_loss(
            params["target_emb"], code, labels, draws.sampled, num_sampled,
            example_weights=weights, vocab_size=dims.target_vocab_size)

    loss_fn.unused_keys = unused_param_keys(dims)
    return loss_fn


def run_profile(dims: ModelDims, batch: int, steps: int, device, *,
                use_kernel: bool, num_sampled: int = NUM_SAMPLED,
                emit: Callable = lambda phase, ms, **extra: None
                ) -> Dict[str, float]:
    """The tool's phases at `dims` on `device`: ms of "forward",
    "forward_backward", "full_step_adam" and "full_step_adafactor"
    (the JAX tool's telemetry phase names), each also passed to
    `emit(phase, ms, **extra)` with the full steps' `pc_per_sec`."""
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(gen, dims)
    data = make_batch(dims, batch, device)
    S = min(num_sampled, dims.target_vocab_size)
    sampled = log_uniform_sample(
        torch.Generator(device=device).manual_seed(1), S,
        dims.target_vocab_size)
    draws = StepDraws(keep=None, sampled=sampled, salts={})
    loss_fn = forward_loss_fn(dims, num_sampled, use_kernel)
    out: Dict[str, float] = {}

    def record(phase, dt, **extra):
        out[phase] = dt * 1e3
        emit(phase, dt * 1e3, **extra)

    with torch.no_grad():
        dt = timeit(lambda: loss_fn(params, data, draws), scalar_sync, steps)
    print(f"forward only:        {dt*1e3:6.2f} ms", flush=True)
    record("forward", dt)

    dt = timeit(lambda: dense_loss_and_grads(params, data, draws, loss_fn),
                lambda o: scalar_sync(o[0]), steps)
    print(f"forward + backward:  {dt*1e3:6.2f} ms", flush=True)
    record("forward_backward", dt)

    for oname in OPTIMIZERS:
        opt = make_optimizer(1e-3, oname)
        step = make_train_step(dims, opt, use_sampled_softmax=True,
                               num_sampled=num_sampled,
                               compute_dtype=torch.bfloat16,
                               use_kernel=use_kernel)
        # the step updates in place: each optimizer from the same params
        p = tree.map_leaves(torch.clone, params)
        s = opt.init(opt_param_view(p))
        n = [0]

        def one():
            d = make_draws(dims, step.cfg, p, batch, 2, n[0], device)
            n[0] += 1
            return step(p, s, data, d)

        dt = timeit(one, scalar_sync, steps)
        pc = batch * dims.max_contexts / dt
        label = f"full step ({oname})"
        print(f"{label}: {dt*1e3:6.2f} ms -> {pc/1e6:.2f}M pc/s", flush=True)
        record(f"full_step_{oname}", dt, pc_per_sec=round(pc, 1))
        del p, s
    return out


def main(argv=None) -> int:
    # argv=None (programmatic callers) means "no flags", not sys.argv, as
    # the JAX tool's main
    ap = argparse.ArgumentParser(
        prog="python3 -m code2vec_tpu_torch.tools.profile_step",
        description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--telemetry_dir", default=None,
                    help="also emit each phase measurement as telemetry "
                         "events (code2vec_tpu_torch/obs)")
    ap.add_argument("--backend", choices=("gpu", "cpu"), default="gpu",
                    help="gpu (default): the CUDA card, kernel 1; cpu: its "
                         "plain version")
    args = ap.parse_args(argv if argv is not None else [])
    device = backend_device(args.backend)
    if device is None:
        return 2
    B = args.batch
    print(f"card: {card_line(device)}", flush=True)

    from code2vec_tpu_torch.obs import Telemetry
    tele = Telemetry.create(args.telemetry_dir, component="profile")

    def emit(phase: str, ms: float, **extra) -> None:
        tele.record_ms(f"profile/{phase}_ms", ms)
        tele.event("profile", phase=phase, ms=round(ms, 3), batch=B,
                   **extra)

    if device.type == "cuda":
        from code2vec_tpu_torch.ops.membench import measure_hbm_ceiling
        bw = measure_hbm_ceiling(device=device)
        print(f"HBM streaming (1 GiB copy): {bw/1e9:.0f} GB/s effective",
              flush=True)
        tele.gauge("profile/hbm_ceiling_gbps", round(bw / 1e9, 1),
                   emit=False)
        tele.event("profile", phase="hbm_ceiling", gbps=round(bw / 1e9, 1))
    else:
        print("HBM streaming (1 GiB copy): not measured (--backend cpu)",
              flush=True)
    run_profile(java_large_dims(), B, args.steps, device,
                use_kernel=device.type == "cuda", emit=emit)
    tele.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

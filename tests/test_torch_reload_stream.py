"""The hot reload's copy onto the card (serving/reload.py::load_params)
gives the checkpoint's bits while the replicas' batches allocate and
free tensors on the default stream.

The copier writes each new tensor on a side stream. The caching
allocator may hand the reload a block that a batch freed while that
batch's kernels are still queued on the default stream, so the side
stream has to wait for the default stream before it writes: otherwise a
queued batch kernel reads the new weights' bytes as its intermediate, or
writes over the weights just copied. Here two threads keep the default
stream backlogged with matmuls and, behind them, fill, sum and free
tensors of the reloaded tensors' sizes, while the reload runs again and
again. Both sides are checked: every reloaded tensor equals the host
tensor it came from, and every batch's sum is the one its fill gives
(tolerance: none). This file imports no JAX.
"""

import threading

import pytest
import torch

from code2vec_tpu_torch.serving import reload as reload_mod
from code2vec_tpu_torch.training import checkpoint as ckpt

# the shapes of a bag model's small leaves and of one table slice
SHAPES = {"transform": (384, 384), "attention": (384, 1),
          "bias": (384,), "rows": (512, 128)}


def _host_params(seed):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=g) for k, s in SHAPES.items()}


def test_load_params_on_the_cpu_gives_the_checkpoint_bits(monkeypatch):
    """On the CPU the slices are plain copies; the loaded params equal
    the restored ones (tolerance: none) and lie where the template
    does."""
    host = _host_params(1)
    monkeypatch.setattr(ckpt, "load_checkpoint",
                        lambda *a, **k: {"params": host})
    monkeypatch.setattr(reload_mod, "_SLICE_BYTES", 4096)
    template = {k: torch.zeros_like(t) for k, t in host.items()}
    got = reload_mod.load_params("unused", 1, template)
    for k, t in host.items():
        assert got[k].device == t.device and torch.equal(got[k], t), k


@pytest.mark.cuda
def test_reload_beside_batches_that_free_tensors(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    hosts = [_host_params(s) for s in range(4)]
    current = {"params": hosts[0]}
    monkeypatch.setattr(ckpt, "load_checkpoint", lambda *a, **k: current)
    # several slices for the larger tensors
    monkeypatch.setattr(reload_mod, "_SLICE_BYTES", 64 << 10)
    template = {k: torch.zeros(s, device=dev) for k, s in SHAPES.items()}
    stop = threading.Event()
    wrong = []

    def batches(seed):
        busy = torch.randn((2048, 2048), device=dev)
        n = 0
        while not stop.is_set():
            sums = []
            for shape in SHAPES.values():
                busy = busy @ busy / 2048.0  # keeps the stream backlogged
                t = torch.empty(shape, device=dev)
                t.fill_(float(seed + n % 7))
                sums.append((t.sum(), float(seed + n % 7) * t.numel()))
                del t  # freed while its fill and sum are still queued
                n += 1
            for got, want in sums:
                if got.item() != want:
                    wrong.append((seed, got.item(), want))

    threads = [threading.Thread(target=batches, args=(s,), daemon=True)
               for s in (1, 100)]
    for th in threads:
        th.start()
    try:
        for r in range(60):
            current["params"] = hosts[r % len(hosts)]
            got = reload_mod.load_params("unused", r, template)
            for k, t in current["params"].items():
                # read on the default stream, behind the batches' kernels
                assert torch.equal(got[k].cpu(), t), (r, k)
            del got
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
    assert not wrong, wrong[:5]

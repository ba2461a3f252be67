"""The port's training infeed (code2vec_tpu_torch/data/prefetch.py),
held to the JAX package's tests of data/prefetch.py: the order is kept
and the infeed iterates again, depth 0 is synchronous, the producer runs
ahead of the consumer, a producer exception surfaces at its position,
no thread leaks and an abandoned iteration releases its producer.
Beyond those: `persistent_epochs` from a later first epoch gives, epoch
by epoch, the batches of the JAX package's reader with the same
`epoch_offset`; the trainer's losses are the same bits with the infeed
at depth 0 and 2. The `cuda`-marked test holds the pinned-buffer ring
(`PinnedRingPut`) to the synchronous copy on the card; it skips here.
"""

import threading
import time

import numpy as np
import pytest
import torch

from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.data.prefetch import persistent_epochs as jax_persistent
from code2vec_tpu.data.prefetch import prefetch_to_device as jax_prefetch
from code2vec_tpu_torch.data import reader as torch_reader
from code2vec_tpu_torch.data.prefetch import (DevicePrefetcher, _SyncInfeed,
                                              persistent_epochs,
                                              prefetch_to_device)
from helpers import build_tiny_dataset


def test_prefetcher_preserves_order_and_reiterates():
    batches = list(range(7))
    pf = prefetch_to_device(batches, lambda b: b * 10, depth=2)
    for _epoch in range(3):  # re-iterable across epochs
        assert list(pf) == [(b * 10, b) for b in batches]


def test_depth_zero_is_synchronous_and_reiterable():
    calls = []
    pf = prefetch_to_device(list(range(3)), lambda b: calls.append(b),
                            depth=0)
    assert isinstance(pf, _SyncInfeed)
    it = iter(pf)
    assert calls == []          # nothing copied ahead of the loop
    next(it)
    assert calls == [0]         # one copy per consumed item
    assert len(list(pf)) == 3   # a fresh second epoch


def test_prefetcher_runs_ahead_of_consumer():
    """With the consumer holding batch 0, the producer puts batches 1 and
    2 (a queue slot and the one in flight) without being asked."""
    put_times = {}

    def put(b):
        put_times[b] = time.monotonic()
        return b

    pf = DevicePrefetcher(list(range(4)), put, depth=2)
    it = iter(pf)
    next(it)
    deadline = time.monotonic() + 5.0
    while len(put_times) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(put_times) >= 3, sorted(put_times)
    assert [h for _d, h in it] == [1, 2, 3]


def test_prefetcher_propagates_producer_exception_in_position():
    def put(b):
        if b == 2:
            raise RuntimeError("boom at batch 2")
        return b

    pf = DevicePrefetcher(list(range(5)), put, depth=2)
    seen = []
    with pytest.raises(RuntimeError, match="boom at batch 2"):
        for dev, _host in pf:
            seen.append(dev)
    assert seen == [0, 1]  # everything before the failure was delivered


def test_ready_fn_runs_on_the_consumer_thread():
    """`ready_fn` (the ring's stream wait) runs where the steps run."""
    threads = []
    pf = DevicePrefetcher(list(range(3)), lambda b: b, depth=2,
                          ready_fn=lambda d: threads.append(
                              threading.get_ident()) or d + 100)
    assert [d for d, _h in pf] == [100, 101, 102]
    assert set(threads) == {threading.get_ident()}


def _settled(before: int) -> bool:
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.02)
    return threading.active_count() <= before


def test_prefetcher_threads_do_not_leak():
    before = threading.active_count()
    pf = DevicePrefetcher(list(range(20)), lambda b: b, depth=2)
    for _ in range(5):
        list(pf)
    assert _settled(before)


def test_abandoned_iteration_releases_producer_thread():
    """Leaving the consumer loop early (an exception in the step) stops
    the producer instead of leaving it blocked on a full queue; so does
    abandoning `persistent_epochs`."""
    before = threading.active_count()
    pf = DevicePrefetcher(list(range(100)), lambda b: b, depth=2)
    for _t in range(4):
        it = iter(pf)
        next(it)
        it.close()
    passes = persistent_epochs(pf, 5)
    _epoch, batches = next(passes)
    next(batches)
    passes.close()
    assert _settled(before), threading.enumerate()


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    d = tmp_path_factory.mktemp("prefetch")
    return build_tiny_dataset(str(d), n_train=90, n_val=8, n_test=8,
                              max_contexts=16, binarize=True)


@pytest.mark.parametrize("first_epoch,depth", [(1, 2), (3, 2), (2, 0),
                                               (4, 1)])
def test_persistent_epochs_match_the_reference_reader(shard, first_epoch,
                                                      depth):
    """Epochs `first_epoch..5` through the port's `persistent_epochs` over
    its binary reader opened at `epoch_offset = first_epoch - 1` equal,
    epoch by epoch, the JAX package's over its reader at that offset
    (and so the batches an uninterrupted run draws in those epochs)."""
    prefix = shard + ".train"

    def run(reader_mod, prefetch, persistent):
        r = reader_mod.BinaryShardReader(prefix, 32, shuffle=True, seed=239,
                                         epoch_offset=first_epoch - 1)
        infeed = prefetch(r, lambda b: b.target_index.copy(), depth)
        return [(e, [(d.tolist(), b.path_indices.copy()) for d, b in it])
                for e, it in persistent(infeed, 5, first_epoch=first_epoch)]

    got = run(torch_reader, prefetch_to_device, persistent_epochs)
    want = run(jax_reader, jax_prefetch, jax_persistent)
    assert [e for e, _ in got] == list(range(first_epoch, 6))
    assert len(got) == len(want)
    for (e, g), (f, w) in zip(got, want):
        assert e == f and len(g) == len(w) == 3
        for (gd, gp), (wd, wp) in zip(g, w):
            assert gd == wd
            np.testing.assert_array_equal(gp, wp)


def test_trainer_losses_same_bits_at_depth_zero_and_two(shard):
    """The trainer over the binary shard, infeed synchronous and two
    ahead: the same per-step losses and final params, bit for bit."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
    vocabs = Code2VecVocabs.load_from_dict_file(shard + ".dict.c2v",
                                                1000, 1000, 1000)

    def run(depth):
        cfg = Config(MAX_CONTEXTS=16, DEFAULT_EMBEDDINGS_SIZE=8,
                     TRAIN_BATCH_SIZE=32, TABLES_DTYPE="float32",
                     USE_BF16=False, INFEED_PREFETCH=depth)
        t = Code2VecTrainer(cfg, vocabs, device="cpu")
        return t.train(shard + ".train.c2v", epochs=2), t.params

    l0, p0 = run(0)
    l2, p2 = run(2)
    assert len(l0) == 6 and l0 == l2
    for k in p0:
        assert torch.equal(p0[k], p2[k]), k


@pytest.mark.cuda
def test_pinned_ring_matches_the_synchronous_copy_on_the_card(shard):
    """Every batch of two epochs through the prefetcher with the pinned
    ring (depth 2, 3 slots, side-stream copies) equals the synchronous
    copy of the same host batch, read on the consumer's stream after a
    kernel queued there (so a ring that refilled a slot early, or an
    allocator that reused a batch's memory, would show)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from code2vec_tpu_torch.data.prefetch import PinnedRingPut
    dev = torch.device("cuda", torch.cuda.current_device())
    reader = torch_reader.BinaryShardReader(shard + ".train", 16,
                                            shuffle=True, seed=3)
    ring = PinnedRingPut(dev, 3)
    infeed = prefetch_to_device(reader, lambda b: ring(b.host_arrays()), 2,
                                ring.ready)
    busy = torch.randn((2048, 2048), device=dev)
    n = 0
    for _epoch, batches in persistent_epochs(infeed, 2):
        for got, host in batches:
            busy = busy @ busy / 2048.0  # keeps the stream busy
            want = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in host.host_arrays()]
            for g, w in zip(got, want):
                assert g.device == dev and torch.equal(g, w)
            n += 1
    assert n == 2 * 6

"""The port's chunked infeed (`--infeed_chunk`,
code2vec_tpu_torch/data/prefetch.ChunkedDevicePrefetcher) against the
depth infeed and the JAX package's `ChunkedDevicePrefetcher`.

Tolerances: none, every check is exact.
- For G in {1, 2, 3, 4}, three shuffled epochs through
  `persistent_epochs` give the depth infeed's batches in its order, bit
  for bit, with the host batch beside each (10 batches an epoch: a
  partial tail chunk at G = 3 and 4), on one producer thread that runs
  across the epoch boundaries;
- the JAX `ChunkedDevicePrefetcher` (its transfer a numpy copy) and the
  port's yield the same batch sequence over one reader's batches;
- the `infeed/produce` failpoint fires at its batch on the chunked path
  (the per-batch host function's 6th call; the consumer takes the whole
  chunk before it, then it raises), and the trace hook runs once a batch
  there; the producer's heartbeat beats and goes idle;
- under a mesh `build_train_infeed` falls back to the depth infeed and
  logs the JAX package's line;
- the rules of `--infeed_chunk` are the JAX package's, message for
  message;
- `cli.main --infeed_chunk 4` trains to params bit-identical to
  `--infeed_chunk 1`, for the code2vec and the VarMisuse head.
The `cuda`-marked test holds `PinnedChunkPut` (a pinned ring of chunk
slots, one copy a field a chunk) to the synchronous copy on the card;
it skips here.
"""


import numpy as np
import pytest
import torch

from code2vec_tpu_torch.data import reader as torch_reader
from code2vec_tpu_torch.data.prefetch import (ChunkedDevicePrefetcher,
                                              DevicePrefetcher,
                                              build_train_infeed,
                                              persistent_epochs)
from code2vec_tpu_torch.resilience import faults
from helpers import build_tiny_dataset

B = 4          # rows a batch: 40 training methods -> 10 batches an epoch
EPOCHS = 3


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return build_tiny_dataset(str(tmp_path_factory.mktemp("chunked")),
                              n_train=40, n_val=13, n_test=8,
                              max_contexts=16)


def _reader(prefix, **kw):
    from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs
    vocabs = Code2VecVocabs.load_from_dict_file(prefix + ".dict.c2v", 1000,
                                                1000, 1000)
    return torch_reader.C2VTextReader(prefix + ".train.c2v", vocabs, 16, B,
                                      shuffle=True, seed=3, **kw)


def _host(b):
    return b.host_arrays()


def _put(b):
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in b.host_arrays())


def _epochs(infeed):
    """[[(device fields as numpy, valid rows), ...] an epoch]."""
    out = []
    for _epoch, batches in persistent_epochs(infeed, EPOCHS):
        out.append([([t.numpy().copy() for t in dev], host.num_valid_examples)
                    for dev, host in batches])
    return out


@pytest.mark.parametrize("chunk", [1, 2, 3, 4])
def test_chunked_infeed_gives_the_depth_infeeds_batches(dataset, chunk):
    """Every batch of three epochs, in order, the depth infeed's bits;
    each an epoch of 10 batches (the tail chunk partial at 3 and 4)."""
    depth = _epochs(build_train_infeed(_reader(dataset), _put, 2))
    infeed = build_train_infeed(_reader(dataset), _put, 2, chunk=chunk,
                                host_arrays_fn=_host)
    assert isinstance(infeed, ChunkedDevicePrefetcher) == (chunk > 1)
    got = _epochs(infeed)
    assert [len(e) for e in got] == [len(e) for e in depth] == [10] * EPOCHS
    for ge, de in zip(got, depth):
        for (g, gn), (d, dn) in zip(ge, de):
            assert gn == dn and len(g) == len(d) == 6
            for a, b in zip(g, d):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    # the epochs are shuffled apart (an epoch boundary crossed for real)
    assert not np.array_equal(got[0][0][0][0], got[1][0][0][0])


def test_jax_and_port_chunked_prefetchers_yield_the_same_batches(dataset):
    """The JAX `ChunkedDevicePrefetcher` (a numpy transfer) and the port's
    over one reader's batches at G = 3 (10 batches: 3 full chunks and a
    tail of 1): the same fields, the same host batches, in order."""
    from code2vec_tpu.data.prefetch import \
        ChunkedDevicePrefetcher as JaxChunked
    batches = list(_reader(dataset))
    jax_side = list(JaxChunked(batches, _host, 3, transfer=np.asarray))
    port = list(ChunkedDevicePrefetcher(batches, _host, 3))
    assert len(jax_side) == len(port) == len(batches) == 10
    for (jd, jh), (td, th) in zip(jax_side, port):
        assert jh is th
        for a, b in zip(jd, td):
            assert np.array_equal(np.asarray(a), b.numpy())


def test_failpoint_trace_hook_and_heartbeat_on_the_chunked_path():
    """`infeed/produce` at its 6th batch with G = 4: the first chunk's
    four batches reach the consumer, then it raises there (the second
    chunk never ships); the trace hook ran once a batch, up to the
    faulted one; the heartbeat beat and went idle."""
    class Beat:
        beats, idled = 0, False

        def beat(self):
            self.beats += 1

        def idle(self):
            self.idled = True

    calls = []

    def instrument(fn):
        def traced(b):
            calls.append(b)
            return fn(b)
        return traced

    hb = Beat()
    faults.install({"sites": {"infeed/produce": {"action": "raise",
                                                 "at": 6}}},
                   log=lambda _m: None)
    try:
        infeed = build_train_infeed(
            list(range(12)), None, 2, instrument=instrument, heartbeat=hb,
            chunk=4, host_arrays_fn=lambda b: (np.full((2,), b),))
        seen = []
        with pytest.raises(faults.FaultInjected):
            for dev, host in infeed:
                seen.append((int(dev[0][0]), host))
    finally:
        faults.clear()
    assert seen == [(b, b) for b in range(4)]
    assert calls == list(range(6))
    assert hb.beats >= 1 and hb.idled
    # disarmed: the same infeed runs every batch, the hook still once each
    calls.clear()
    infeed = build_train_infeed(list(range(6)), None, 2,
                                instrument=instrument, chunk=4,
                                host_arrays_fn=lambda b: (np.full((2,), b),))
    assert [h for _d, h in infeed] == list(range(6))
    assert calls == list(range(6))


def test_chunk_under_a_mesh_falls_back_and_logs():
    """A mesh forces the depth infeed, with the JAX package's log line."""
    logs = []
    infeed = build_train_infeed([1, 2, 3], lambda b: b * 10, 2, chunk=4,
                                mesh=object(), host_arrays_fn=_host,
                                log=logs.append)
    assert type(infeed) is DevicePrefetcher
    assert [(d, h) for d, h in infeed] == [(10, 1), (20, 2), (30, 3)]
    assert logs == ["--infeed_chunk ignored: chunked infeed is "
                    "single-device only (mesh active); using depth "
                    "prefetch"]


@pytest.mark.parametrize("fields", [dict(INFEED_CHUNK=0),
                                    dict(INFEED_CHUNK=2, INFEED_PREFETCH=0),
                                    dict(INFEED_CHUNK=4)])
def test_infeed_chunk_rules_are_the_jax_packages(fields):
    """The port's `verify` and the JAX package's agree on each setting:
    G < 1 and G > 1 at prefetch 0 refused with the same message, G = 4
    at the default prefetch accepted; the flag sets the field."""
    from code2vec_tpu.config import Config as JaxConfig
    from code2vec_tpu_torch.config import Config
    errors = []
    for cls in (Config, JaxConfig):
        cfg = cls(**fields)
        cfg.train_data_path = "x"
        try:
            cfg.verify()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    assert (errors[0] is None) == (fields == dict(INFEED_CHUNK=4))
    argv = ["--data", "x", "--infeed_chunk", "4"]
    assert Config.load_from_args(argv).INFEED_CHUNK == \
        JaxConfig.load_from_args(argv).INFEED_CHUNK == 4


def _trained(argv, model_cls):
    """The params of the model `cli.main(argv)` trained."""
    from code2vec_tpu_torch import cli
    made = []
    real = model_cls.from_config.__func__

    def from_config(cls, *a, **k):
        made.append(real(cls, *a, **k))
        return made[-1]

    model_cls.from_config = classmethod(from_config)
    try:
        assert cli.main(argv) == 0
    finally:
        model_cls.from_config = classmethod(real)
    return made[-1]


@pytest.mark.parametrize("head", ["code2vec", "varmisuse"])
def test_cli_chunked_infeed_trains_to_the_same_bits(dataset, tmp_path,
                                                    head):
    """`cli.main --infeed_chunk 4` and `--infeed_chunk 1` over the same
    data, two epochs (10 steps an epoch at B = 4, a partial tail chunk
    in each): the same steps and every param the same bits."""
    from code2vec_tpu_torch.models.torch_model import Code2VecTrainer
    from code2vec_tpu_torch.models.vm_model import VarMisuseModel
    from test_torch_vm_model_axis import write_vm_files
    base = ["--backend", "cpu", "--batch_size", str(B), "--epochs", "2",
            "--no_bf16", "--max_contexts", "16", "--async_checkpoint",
            "off"]
    if head == "varmisuse":
        prefix = str(tmp_path / "vm")
        write_vm_files(prefix)
        base += ["--head", "varmisuse", "--data", prefix,
                 "--max_candidates", "4"]
        model_cls = VarMisuseModel
    else:
        base += ["--data", dataset]
        model_cls = Code2VecTrainer
    runs = [_trained(base + ["--infeed_chunk", g], model_cls)
            for g in ("4", "1")]
    assert runs[0].config.INFEED_CHUNK == 4
    assert runs[0].step_num == runs[1].step_num == 20
    a, b = runs[0].params, runs[1].params
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_pinned_chunk_ring_matches_the_synchronous_copy_on_the_card(
        dataset):
    """Two epochs at G = 3 through `PinnedChunkPut` (depth 2, 3 chunk
    slots, side-stream copies): every batch equals the synchronous copy
    of its host batch, read on the consumer's stream after a kernel
    queued there; one copy a field a chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from code2vec_tpu_torch.data.prefetch import PinnedChunkPut
    dev = torch.device("cuda", torch.cuda.current_device())
    ring = PinnedChunkPut(dev, 3)
    infeed = build_train_infeed(_reader(dataset), None, 2, chunk=3,
                                host_arrays_fn=_host, chunk_put=ring)
    busy = torch.randn((2048, 2048), device=dev)
    n = 0
    for _epoch, batches in persistent_epochs(infeed, 2):
        for got, host in batches:
            busy = busy @ busy / 2048.0
            for g, a in zip(got, host.host_arrays()):
                w = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                assert g.device == dev and torch.equal(g, w)
            n += 1
    assert n == 20
    assert ring.copies == 2 * 4 * 6  # 4 chunks an epoch, 6 fields

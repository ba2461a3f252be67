"""The training infeed: batches parsed and copied to the card ahead of
the step that takes them.

A copy of `data/prefetch.py` in the JAX package: a daemon thread runs
the host side of the next `depth` batches (reading, padding, the
host-to-device copy) while the card runs the current step;
`persistent_epochs` keeps that one thread running across epoch
boundaries, so the next epoch's first batches are ready while the
boundary's save and evaluation run. `--infeed_prefetch 0` is the
synchronous control (`_SyncInfeed`). `--infeed_chunk G` (G > 1) is
`ChunkedDevicePrefetcher`: the producer groups G host batches, makes one
host-to-device copy a field of the chunk's stacked arrays, and the
consumer takes the chunk's batches one by one as views of the stacked
tensors (the last chunk of a pass may be partial). The JAX package's
docstring says what it is for: a link where each copy pays a long fixed
latency; on local PCIe the depth infeed is the tool. It runs in one
process without a mesh: under any mesh `build_train_infeed` falls back
to the depth infeed and logs the JAX package's line.

`build_train_infeed` is the train loop's infeed: it adds the
`infeed/produce` failpoint (resilience/faults.py; an injected raise on
the producer thread surfaces in the consumer at its position, the path
a real read or copy failure takes), the `instrument` hook (the trace's
`infeed/produce` span a batch, obs/loop.py), both around the per-batch
host function on the chunked path, so each still fires once a batch, and
the producer's watchdog heartbeat, which beats on every queue-put
attempt (a put blocked on a full queue beats too: then the consumer is
the slow one) and goes idle when the producer is done. None of them
synchronises with the card.

On the card the put function is `PinnedRingPut`: each field of a batch
is written into one of `depth + 1` page-locked host buffers, copied with
`copy_(non_blocking=True)` on a side `torch.cuda.Stream` into a device
tensor allocated on that stream, and a CUDA event is recorded behind the
copies. The producer waits on a slot's previous event before it writes
the slot again (the copy out of it has finished). The consumer
(`PinnedRingPut.ready`, on the thread that runs the steps) makes its
current stream wait on the batch's event and marks the device tensors
as used on that stream (`record_stream`), so the caching allocator does
not hand their memory to the side stream while a step may still read
them. The chunked infeed's `PinnedChunkPut` is the same ring with a
chunk a slot: each field of the chunk is stacked straight into the
slot's page-locked buffer, copied once, and the consumer waits on the
chunk's event and marks the stacked tensor once, before the first of
its batches (every batch is a view of it).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

_SENTINEL = object()
_EPOCH_END = object()


class _Producer:
    """A daemon thread running `produce(put)` into a queue of `depth`
    items, then a (sentinel, exception) item. `put(item)` returns False
    once `close` was called, so an abandoned producer stops; `get`
    returns the next item, None after the end (for good), and raises the
    producer's exception where it was put. `close` releases the thread
    and the batches it holds. `heartbeat` (obs/watchdog.py) beats on
    every put attempt and goes idle when the thread ends."""

    def __init__(self, produce: Callable, depth: int, name: str = None,
                 heartbeat=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._heartbeat = heartbeat

        def run() -> None:
            try:
                produce(self.put)
            except BaseException as e:  # raised again on the consumer
                self.put((_SENTINEL, e))
            else:
                self.put((_SENTINEL, None))
            finally:
                # idle last (the sentinel put beats): a finished
                # producer is exempt from the deadline, not stalled
                if heartbeat is not None:
                    heartbeat.idle()

        self._thread = threading.Thread(target=run, daemon=True, name=name)
        self._thread.start()

    def put(self, item) -> bool:
        # a bounded wait, so that close can interrupt a full queue
        while not self._stop.is_set():
            if self._heartbeat is not None:
                self._heartbeat.beat()
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def get(self):
        if self._done:
            return None
        item = self._q.get()
        if item[0] is not _SENTINEL:
            return item
        self._done = True
        self._thread.join()
        if item[1] is not None:
            raise item[1]
        return None

    def close(self) -> None:
        self._stop.set()
        while self._thread.is_alive():  # drain, so a blocked put returns
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)


class DevicePrefetcher:
    """Iterate `(put_fn(batch), batch)` pairs with `put_fn` run up to
    `depth` batches ahead on a producer thread; `ready_fn`, when given,
    runs on the consumer's thread on each device batch before it is
    yielded (`PinnedRingPut.ready`). The host batch rides along for its
    host-side fields (num_valid_examples, target_strings). An exception
    of the producer is raised in the consumer at its position. Each
    `__iter__` is one epoch; a consumer that stops early releases the
    thread. `heartbeat` is the producer thread's (see `_Producer`)."""

    def __init__(self, batches: Iterable, put_fn: Callable, depth: int = 2,
                 ready_fn: Optional[Callable] = None, heartbeat=None):
        if depth < 1:
            raise ValueError(f"prefetch depth {depth} < 1")
        self._depth = depth
        self._batches = batches
        self._put_fn = put_fn
        self._ready_fn = ready_fn
        self._heartbeat = heartbeat

    def _produce(self, put: Callable) -> bool:
        """One pass over the batches; False if the consumer went away."""
        for b in self._batches:
            if not put((self._put_fn(b), b)):
                return False
        return True

    def _emit(self, item) -> Iterator[Tuple]:
        """The consumer's (device batch, host batch) pairs of one queue
        item."""
        dev, host = item
        yield (dev if self._ready_fn is None else self._ready_fn(dev)), host

    def __iter__(self) -> Iterator[Tuple]:
        producer = _Producer(self._produce, self._depth,
                             heartbeat=self._heartbeat)
        try:
            while (item := producer.get()) is not None:
                yield from self._emit(item)
        finally:
            producer.close()


def _host_tensors(fields) -> Tuple[torch.Tensor, ...]:
    """Stacked numpy fields as tensors over the same memory (the CPU's
    "copy")."""
    return tuple(torch.from_numpy(f) for f in fields)


class ChunkedDevicePrefetcher(DevicePrefetcher):
    """The counterpart of the JAX package's `ChunkedDevicePrefetcher`:
    `chunk` host batches grouped on the producer thread and moved as ONE
    stacked tensor a field, then yielded one batch at a time as
    `(views of the stacked tensors, host batch)`; the last chunk of a
    pass may be partial. `to_arrays(batch)` gives a host batch's fields
    (numpy); `transfer(rows)` takes the chunk's list of field tuples and
    returns what the queue carries: by default the fields stacked with
    numpy as CPU tensors; on the card `PinnedChunkPut`, with its `ready`
    as `ready_fn`, run once a chunk on the consumer's thread before the
    chunk's first batch. Always threaded (`depth` >= 1 chunks ahead)."""

    def __init__(self, batches: Iterable, to_arrays: Callable, chunk: int,
                 depth: int = 2, transfer: Optional[Callable] = None,
                 ready_fn: Optional[Callable] = None, heartbeat=None):
        if chunk < 1:
            raise ValueError(f"infeed chunk {chunk} < 1")
        super().__init__(batches, to_arrays, depth, ready_fn, heartbeat)
        self._chunk = chunk
        self._transfer = transfer or (lambda rows: _host_tensors(
            np.stack([r[f] for r in rows]) for f in range(len(rows[0]))))

    def _produce(self, put: Callable) -> bool:
        hosts, rows = [], []
        for b in self._batches:
            hosts.append(b)
            rows.append(self._put_fn(b))
            if len(rows) == self._chunk:
                if not put((self._transfer(rows), hosts)):
                    return False
                hosts, rows = [], []
        if rows:  # the partial tail chunk
            return put((self._transfer(rows), hosts))
        return True

    def _emit(self, item) -> Iterator[Tuple]:
        stacked, hosts = item
        if self._ready_fn is not None:
            stacked = self._ready_fn(stacked)
        for i, host in enumerate(hosts):
            yield tuple(a[i] for a in stacked), host


class _SyncInfeed:
    """depth 0: the copy runs in the consumer's loop (the A/B control of
    `--infeed_prefetch 0`); re-iterable like DevicePrefetcher."""

    def __init__(self, batches: Iterable, put_fn: Callable):
        self._batches = batches
        self._put_fn = put_fn

    def __iter__(self) -> Iterator[Tuple]:
        for b in self._batches:
            yield self._put_fn(b), b


def prefetch_to_device(batches: Iterable, put_fn: Callable, depth: int = 2,
                       ready_fn: Optional[Callable] = None, heartbeat=None
                       ) -> Iterable[Tuple]:
    """The infeed: `depth` batches ahead on a producer thread, or
    synchronous at depth 0."""
    if depth <= 0:
        return _SyncInfeed(batches, put_fn)
    return DevicePrefetcher(batches, put_fn, depth, ready_fn, heartbeat)


def build_train_infeed(batches: Iterable, put_fn: Callable, depth: int,
                       ready_fn: Optional[Callable] = None,
                       instrument: Optional[Callable] = None,
                       heartbeat=None, *, chunk: int = 1, mesh=None,
                       host_arrays_fn: Optional[Callable] = None,
                       chunk_put=None,
                       log: Optional[Callable] = None) -> Iterable[Tuple]:
    """The train loop's infeed: `ChunkedDevicePrefetcher` over
    `host_arrays_fn` when `chunk` > 1 and there is no `mesh` (its copy
    `chunk_put`, a `PinnedChunkPut` on the card, None on the CPU), else
    `prefetch_to_device` over `put_fn` (a chunk under a mesh is logged
    and ignored, as the JAX package does). The `infeed/produce`
    failpoint (only when armed) and `instrument(fn)` (the trace hook)
    wrap the per-batch function the chosen infeed calls on its producer
    thread, so each acts once a batch; `heartbeat` is the producer's.
    The three default to off and then cost nothing."""
    use_chunked = chunk > 1 and mesh is None
    fn = host_arrays_fn if use_chunked else put_fn
    from code2vec_tpu_torch.resilience import faults
    fp = faults.point("infeed/produce")
    if fp.armed:
        inner = fn

        def fn(b):
            fp.fire()
            return inner(b)
    if instrument is not None:
        fn = instrument(fn)
    if use_chunked:
        return ChunkedDevicePrefetcher(
            batches, fn, chunk, depth=max(1, depth), transfer=chunk_put,
            ready_fn=chunk_put.ready if chunk_put is not None else None,
            heartbeat=heartbeat)
    if chunk > 1 and log is not None:
        log("--infeed_chunk ignored: chunked infeed is single-device "
            "only (mesh active); using depth prefetch")
    return prefetch_to_device(batches, fn, depth, ready_fn, heartbeat)


def persistent_epochs(infeed, num_epochs: int, first_epoch: int = 1
                      ) -> Iterator[Tuple[int, Iterator[Tuple]]]:
    """Yields `(epoch, epoch_batches)` for epochs `first_epoch ..
    num_epochs` (1-based; `first_epoch > 1` is the auto-resume path, the
    reader's `epoch_offset` replaying the matching shuffle). For a
    threaded infeed one producer thread runs every pass over the reader
    back to back, with an epoch-end marker between them, so it prepares
    epoch k + 1 while the consumer does epoch k's boundary work. Each
    pass is one `iter(reader)`, the same seeded permutation as a fresh
    thread would draw. The synchronous infeed re-iterates per epoch.

    The consumer drains each epoch's iterator before it takes the next
    pair; abandoning the generator releases the producer thread."""
    epochs = range(first_epoch, num_epochs + 1)
    if not isinstance(infeed, DevicePrefetcher):
        for epoch in epochs:
            yield epoch, iter(infeed)
        return

    def produce(put: Callable) -> None:
        for _ in epochs:
            if not (infeed._produce(put) and put((_EPOCH_END, None))):
                return

    producer = _Producer(produce, infeed._depth, name="train-infeed",
                         heartbeat=infeed._heartbeat)

    def epoch_iter() -> Iterator[Tuple]:
        while (item := producer.get()) is not None \
                and item[0] is not _EPOCH_END:
            yield from infeed._emit(item)

    try:
        for epoch in epochs:
            yield epoch, epoch_iter()
    finally:
        producer.close()


def _dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


class PinnedRingPut:
    """The card's put function for a prefetching infeed: host arrays ->
    device tensors through a ring of `slots` page-locked buffers per
    field and asynchronous copies on a side stream (see the module
    docstring). Called on the producer thread; `ready` on the
    consumer's. `copies` counts the host-to-device copies it made."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._slots: List[Optional[Tuple[List[torch.Tensor],
                                         torch.cuda.Event]]] = [None] * slots
        self._next = 0
        self.copies = 0

    def _buffers(self, slot: int, specs) -> List[torch.Tensor]:
        """The slot's pinned buffers for `specs` [(shape, torch dtype)],
        once the copies out of them have finished."""
        held = self._slots[slot]
        if held is not None:
            held[1].synchronize()
            bufs = held[0]
            if [(tuple(b.shape), b.dtype) for b in bufs] == specs:
                return bufs
        return [torch.empty(shape, dtype=dtype, pin_memory=True)
                for shape, dtype in specs]

    def _copy(self, specs, fill: Callable
              ) -> Tuple[Tuple[torch.Tensor, ...], torch.cuda.Event]:
        """The next slot's buffers filled by `fill(i, host numpy view)`
        and copied to the card on the side stream behind one event."""
        slot = self._next
        self._next = (slot + 1) % len(self._slots)
        bufs = self._buffers(slot, specs)
        out = []
        with torch.cuda.stream(self.stream):
            for i, buf in enumerate(bufs):
                fill(i, buf.numpy())
                d = torch.empty(buf.shape, dtype=buf.dtype,
                                device=self.device)
                d.copy_(buf, non_blocking=True)
                out.append(d)
            self.copies += len(bufs)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._slots[slot] = (bufs, event)
        return tuple(out), event

    def __call__(self, arrays) -> Tuple[Tuple[torch.Tensor, ...],
                                        torch.cuda.Event]:
        def fill(i, buf):
            buf[...] = arrays[i]
        return self._copy([(tuple(a.shape), _dtype(a)) for a in arrays],
                          fill)

    def ready(self, item) -> Tuple[torch.Tensor, ...]:
        tensors, event = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in tensors:
            t.record_stream(stream)
        return tensors


class PinnedChunkPut(PinnedRingPut):
    """The chunked infeed's copy on the card (`ChunkedDevicePrefetcher`'s
    `transfer`): a chunk's field tuples stacked straight into a slot's
    page-locked buffer a field ([G, ...]; a partial chunk has its own
    buffers), one copy a field, one event a chunk; `ready` makes the
    consumer's stream wait on it and marks the stacked tensors used
    there, so the views yielded from them are safe."""

    def __call__(self, rows) -> Tuple[Tuple[torch.Tensor, ...],
                                      torch.cuda.Event]:
        def fill(i, buf):
            np.stack([r[i] for r in rows], out=buf)
        return self._copy([((len(rows),) + tuple(a.shape), _dtype(a))
                           for a in rows[0]], fill)

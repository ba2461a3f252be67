"""Checkpoint and resume: the step-dir protocol of the JAX package.

A copy of `training/checkpoint.py` in the JAX package, with the state
written by `torch.save` where the JAX package writes an orbax tree:

  <ckpt_dir>/
    step_<N>/state/state.pt  params (+ opt_state + step unless released)
    step_<N>/checksums.json  sha256 and size of every file under state/
    step_<N>/topology.json   {step, num_processes, epoch}: the saver's
                             world (1 for one process)
    vocab.pkl                Code2VecVocabs sidecar (loads need no dataset)
    manifest.json            ModelDims and the optimizer's configuration

- A step is committed by renaming `state.tmp/` to `state/`; `_step_dirs`
  counts only committed dirs, so a writer killed mid-save leaves
  `latest_step` at the last committed step.
- `checksums.json` and `topology.json` are written after the commit. A
  load verifies the files first (`verify_step`): a corrupt latest step
  is moved under `<ckpt_dir>/quarantine/` and the load falls back to
  the step before it; an explicitly requested corrupt step raises
  `CheckpointCorrupt`, and so does a corrupt latest step above one
  process (every rank of a cohort loads: the supervisor quarantines
  before it relaunches, no rank moves the dir on its own). A step
  without checksums loads unverified.
- A step saved by another number of processes than the loader's world
  logs the resharding line and loads: a checkpoint always holds whole
  tables (under a model axis the trainer gathers the windows before
  rank 0 writes, parallel/sharding.unshard_state, and a loading rank
  keeps its window of the whole state, sharding.shard_state; the
  manifest's `vocab_pad_multiple` records the rows' padding), so the
  load itself does not change.
- The sidecars are written once a dir (the manifest's `step` is
  advisory; `load_manifest` corrects it from the committed dirs).
- MAX_TO_KEEP pruning keeps the newest steps.
- Transient IO errors retry (`resilience/retry.RetryPolicy`); ENOSPC
  does not, a full disk does not empty on a backoff schedule. The
  `ckpt/write` failpoint (resilience/faults.py) fires inside the retried
  write: a slow disk, a transient EIO (retried), ENOSPC (given up; with
  `partial`, the torn `state.tmp/` left behind), a kill before the
  rename.

`state.pt` holds plain dicts, lists, tuples, ints and CPU tensors, so it
loads with `torch.load(weights_only=True)`: each optimizer-state
NamedTuple (`EmptyState`, `ScaleByAdamState`, `FactoredState`,
`ScaleByScheduleState`, `RowAdamState`) is written as a dict tagged
with its class name and rebuilt on load. int8 tables are `{"q", "s"}`
dicts already.

Async saves (`AsyncCheckpointWriter`, `--async_checkpoint on`): the
steps update params and optimizer state in place, so `snapshot_state`
clones them on the device, on the stream of the loop, behind the step
that produced them, and records an event; the one writer thread makes
its own stream wait on that event and copies the clones to the host on
it (a copy on the loop's stream would queue behind the next steps),
then writes, commits, hashes and prunes. One save is in flight at a
time: a second `submit` blocks until the first commits, never drops. Its
watchdog heartbeat is busy from a job's pickup to its commit, so a write
hung in disk IO reads as a stall.
"""

from __future__ import annotations

import contextlib
import errno
import hashlib
import json
import os
import re
import shutil
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from code2vec_tpu_torch.models.encoder import ModelDims
from code2vec_tpu_torch.ops.sparse_update import RowAdamState
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.resilience.retry import RetryPolicy
from code2vec_tpu_torch.training import optimizers
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs

_STEP_RE = re.compile(r"^step_(\d+)$")

STATE_FILE = "state.pt"
CHECKSUMS_NAME = "checksums.json"
TOPOLOGY_NAME = "topology.json"
QUARANTINE_DIRNAME = "quarantine"

# the NamedTuples a state may hold, by the tag their dicts carry
_NAMED = {cls.__name__: cls for cls in (
    optimizers.EmptyState, optimizers.ScaleByAdamState,
    optimizers.FactoredState, optimizers.ScaleByScheduleState,
    RowAdamState)}
_TAG = "__namedtuple__"


class CheckpointCorrupt(RuntimeError):
    """An explicitly requested step, or above one process the latest,
    failed its checksum verification."""


def _step_dirs(ckpt_dir: str) -> List[Tuple[int, str]]:
    """Committed step dirs only (a torn `step_N/` without its renamed
    `state` is not counted), oldest first."""
    out = []
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(ckpt_dir, name, "state")):
                out.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return sorted(out)


def _build_manifest(step: int, dims: ModelDims,
                    extra_manifest: Optional[Dict[str, Any]]
                    ) -> Dict[str, Any]:
    manifest = {
        "token_vocab_size": dims.token_vocab_size,
        "path_vocab_size": dims.path_vocab_size,
        "target_vocab_size": dims.target_vocab_size,
        "embeddings_size": dims.embeddings_size,
        "max_contexts": dims.max_contexts,
        "dropout_keep_rate": dims.dropout_keep_rate,
        "vocab_pad_multiple": dims.vocab_pad_multiple,
        "tables_dtype": dims.tables_dtype,
        "encoder_type": dims.encoder_type,
        "xf_layers": dims.xf_layers,
        "xf_heads": dims.xf_heads,
        "xf_mlp_ratio": dims.xf_mlp_ratio,
        "xf_remat": dims.xf_remat,
        "ring_attention": dims.ring_attention,
        "step": step,
    }
    if extra_manifest:
        manifest.update(extra_manifest)
    return manifest


# ckpt_dir -> weakref to the vocabs whose pickle this process last wrote
# there: epoch saves with the same vocabs skip the re-pickle, another
# vocabs object (or a stale sidecar) is written
_VOCAB_WRITTEN: Dict[str, Any] = {}


def _write_sidecars(ckpt_dir: str, vocabs: Code2VecVocabs,
                    manifest: Dict[str, Any]) -> None:
    """vocab.pkl and manifest.json, skipped when present and unchanged
    (a difference in `step` alone does not rewrite the manifest)."""
    vocab_path = os.path.join(ckpt_dir, "vocab.pkl")
    ref = _VOCAB_WRITTEN.get(ckpt_dir)
    if (ref is None or ref() is not vocabs
            or not os.path.exists(vocab_path)):
        vocabs.save(vocab_path)
        _VOCAB_WRITTEN[ckpt_dir] = weakref.ref(vocabs)
    manifest_path = os.path.join(ckpt_dir, "manifest.json")
    if os.path.exists(manifest_path):
        try:
            with open(manifest_path, encoding="utf-8") as f:
                old = json.load(f)
        except (OSError, ValueError):
            old = None
        if old is not None and (
                {k: v for k, v in old.items() if k != "step"}
                == {k: v for k, v in manifest.items() if k != "step"}):
            return
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=1)


_CKPT_IO_RETRY = RetryPolicy(
    "checkpoint-io", max_attempts=3, base_delay_s=0.05, max_delay_s=1.0,
    retry_on=(OSError,),
    # a full disk is not transient: raise it now
    giveup=lambda e: getattr(e, "errno", None) == errno.ENOSPC)


def map_state(fn: Callable[[torch.Tensor], Any], x):
    """`fn` on every tensor of a state tree (dicts, lists, tuples and
    NamedTuples kept); other leaves pass through."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: map_state(fn, v) for k, v in x.items()}
    if isinstance(x, list):
        return [map_state(fn, v) for v in x]
    if isinstance(x, tuple):
        fields = [map_state(fn, v) for v in x]
        return type(x)(*fields) if hasattr(x, "_fields") else tuple(fields)
    return x


def state_tensors(x) -> List[torch.Tensor]:
    """Every tensor of a state tree, in a fixed depth-first order."""
    out: List[torch.Tensor] = []
    map_state(out.append, x)
    return out


def _encode(x):
    """NamedTuples -> tagged dicts, tensors -> contiguous CPU tensors."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").contiguous()
    if isinstance(x, dict):
        return {k: _encode(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_encode(v) for v in x]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        name = type(x).__name__
        if name not in _NAMED:
            raise TypeError(f"cannot checkpoint a {name}")
        return {_TAG: name, "fields": [_encode(v) for v in x]}
    if isinstance(x, tuple):
        return tuple(_encode(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _decode(x):
    if isinstance(x, dict):
        if _TAG in x:
            return _NAMED[x[_TAG]](*(_decode(v) for v in x["fields"]))
        return {k: _decode(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_decode(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_decode(v) for v in x)
    return x


def _write_state(step_dir: str, state: Dict[str, Any]) -> None:
    """Write `state` to `step_dir/state.tmp/` and commit it by renaming
    that dir to `state/`."""
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, "state.tmp")
    final = os.path.join(step_dir, "state")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_encode(state), os.path.join(tmp, STATE_FILE))
    if os.path.exists(final):  # the same step saved again
        shutil.rmtree(final)
    os.replace(tmp, final)


def save_checkpoint(ckpt_dir: str, state: Dict[str, Any], step: int,
                    vocabs: Code2VecVocabs, dims: ModelDims,
                    extra_manifest: Optional[Dict[str, Any]] = None,
                    max_to_keep: int = 10,
                    topology: Optional[Dict[str, Any]] = None) -> str:
    """Write and commit step `step`, then its checksums, topology and
    the dir's sidecars, and prune to the newest `max_to_keep` steps.
    Tensors on the card are copied to the host on the current stream."""
    os.makedirs(ckpt_dir, exist_ok=True)
    step_dir = os.path.join(ckpt_dir, f"step_{step}")

    def write() -> None:
        # the failpoint INSIDE the retried callable: an injected EIO is
        # retried here, an ENOSPC given up
        faults.fire("ckpt/write", path=step_dir, step=step)
        _write_state(step_dir, state)

    _CKPT_IO_RETRY.call(write)
    write_step_checksums(ckpt_dir, step)
    write_step_topology(ckpt_dir, step, topology)
    _write_sidecars(ckpt_dir, vocabs,
                    _build_manifest(step, dims, extra_manifest))
    for _s, d in _step_dirs(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(d, ignore_errors=True)
    return os.path.join(step_dir, "state")


# ---- integrity: per-file checksums, verify-on-restore, quarantine ----

def _hash_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _state_file_digests(step_dir: str) -> Dict[str, Dict[str, Any]]:
    """{path under step_dir: {sha256, bytes}} of every file under
    `state/`, sorted."""
    state_dir = os.path.join(step_dir, "state")
    out: Dict[str, Dict[str, Any]] = {}
    for base, _dirs, files in os.walk(state_dir):
        for name in sorted(files):
            p = os.path.join(base, name)
            rel = os.path.relpath(p, step_dir).replace(os.sep, "/")
            out[rel] = {"sha256": _hash_file(p),
                        "bytes": os.path.getsize(p)}
    return dict(sorted(out.items()))


def _write_json(dest: str, payload: Dict[str, Any]) -> None:
    tmp = dest + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, dest)


def write_step_checksums(ckpt_dir: str, step: int) -> str:
    """Write `step_<N>/checksums.json` over the committed state files
    (after the commit: a death between the two leaves a step that loads
    unverified)."""
    step_dir = os.path.join(ckpt_dir, f"step_{step}")
    dest = os.path.join(step_dir, CHECKSUMS_NAME)
    _write_json(dest, {"step": step, "files": _state_file_digests(step_dir)})
    return dest


def write_step_topology(ckpt_dir: str, step: int,
                        extra: Optional[Dict[str, Any]] = None) -> str:
    """Write `step_<N>/topology.json`: {step, num_processes} and the
    caller's fields. `num_processes` is 1 unless the caller says
    otherwise: the trainer writes its world, and the completed `epoch`,
    which a resume reads back."""
    payload: Dict[str, Any] = {"step": step, "num_processes": 1}
    if extra:
        payload.update({k: v for k, v in extra.items() if v is not None})
    dest = os.path.join(ckpt_dir, f"step_{step}", TOPOLOGY_NAME)
    _write_json(dest, payload)
    return dest


def load_step_topology(ckpt_dir: str,
                       step: int) -> Optional[Dict[str, Any]]:
    """The step's topology record, or None (none written, unreadable)."""
    path = os.path.join(ckpt_dir, f"step_{step}", TOPOLOGY_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def verify_step(ckpt_dir: str, step: int) -> Optional[bool]:
    """True: every state file matches its recorded digest; False: a
    mismatch, a missing or an extra file (corrupt); None: no checksums
    to verify against."""
    step_dir = os.path.join(ckpt_dir, f"step_{step}")
    manifest_path = os.path.join(step_dir, CHECKSUMS_NAME)
    if not os.path.exists(manifest_path):
        return None
    try:
        with open(manifest_path, encoding="utf-8") as f:
            recorded = json.load(f)["files"]
    except (OSError, ValueError, KeyError):
        return False  # an unreadable checksums file is corruption
    actual = _state_file_digests(step_dir)
    if set(actual) != set(recorded):
        return False
    return all(actual[k]["sha256"] == v.get("sha256")
               for k, v in recorded.items())


def quarantine_step(ckpt_dir: str, step: int,
                    log: Optional[Callable[[str], None]] = None) -> str:
    """Move a corrupt step dir under `<ckpt_dir>/quarantine/` (kept for
    inspection, out of `latest_step`'s sight). Returns where it went."""
    qdir = os.path.join(ckpt_dir, QUARANTINE_DIRNAME)
    os.makedirs(qdir, exist_ok=True)
    src = os.path.join(ckpt_dir, f"step_{step}")
    dest = os.path.join(qdir, f"step_{step}")
    n = 0
    while os.path.exists(dest):  # the same step corrupted again
        n += 1
        dest = os.path.join(qdir, f"step_{step}.{n}")
    os.replace(src, dest)
    if log is not None:
        log(f"checkpoint step {step} failed verification -> "
            f"quarantined at {dest}")
    return dest


def verify_and_resolve(ckpt_dir: str, *, quarantine: bool = True,
                       log: Optional[Callable[[str], None]] = None
                       ) -> Tuple[Optional[int], List[str]]:
    """Walk the committed steps newest first, verifying each; corrupt
    ones are quarantined (or, with `quarantine=False`, raise). Returns
    (the first step that verifies or has no checksums, or None; the
    quarantined paths)."""
    quarantined: List[str] = []
    for step, _d in reversed(_step_dirs(ckpt_dir)):
        ok = verify_step(ckpt_dir, step)
        if ok is False:
            if not quarantine:
                raise CheckpointCorrupt(
                    f"checkpoint step {step} under {ckpt_dir} failed "
                    f"checksum verification")
            quarantined.append(quarantine_step(ckpt_dir, step, log))
            continue
        if ok is None and log is not None:
            log(f"checkpoint step {step}: no {CHECKSUMS_NAME}; restoring "
                "unverified")
        return step, quarantined
    return None, quarantined


# ---- the async writer ----

def snapshot_state(state: Dict[str, Any]
                   ) -> Tuple[Dict[str, Any], Optional[torch.cuda.Event]]:
    """Clones of every tensor of `state` (on its device, on the current
    stream, so behind the step that produced it) and, for tensors on the
    card, an event recorded after the clones; the steps update the
    originals in place."""
    snap = map_state(lambda t: t.detach().clone(), state)
    event = None
    tensors = state_tensors(snap)
    if tensors and tensors[0].is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(tensors[0].device))
    return snap, event


class AsyncCheckpointWriter:
    """One background thread that writes checkpoints: `submit` returns
    once the snapshot is queued, the thread copies it to the host on its
    own stream and runs the save (commit rename, checksums, pruning).

    - One save in flight: a second `submit` blocks until the first
      commits; nothing is dropped or reordered.
    - `wait()` is the commit barrier (end of training, anything that
      reads the dir next).
    - A failed background save is sticky: it is raised at the next
      `submit` / `wait` / `close`.

    `save_fn` (default: this module's `save_checkpoint`, looked up at
    write time) is injectable for crash tests; `last_total_ms` is the
    last save's time in the writer. `heartbeat` (obs/watchdog.py) is
    busy from a job's pickup to its commit. A job's `telemetry` gets
    the `train/save_total_ms` timer and a `save_committed` event, its
    `tracer` a `train/save_write` span parented to `trace_ctx`."""

    def __init__(self, log: Optional[Callable[[str], None]] = None,
                 save_fn: Optional[Callable] = None, heartbeat=None):
        self._log = log or (lambda _m: None)
        self._save_fn = save_fn
        self._heartbeat = heartbeat
        self._cond = threading.Condition()
        self._job: Optional[Dict[str, Any]] = None
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._stream = None
        self.last_total_ms: Optional[float] = None

    def _raise_pending(self) -> None:
        with self._cond:
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def submit(self, ckpt_dir: str, state: Dict[str, Any], step: int,
               vocabs: Code2VecVocabs, dims: ModelDims, *,
               extra_manifest: Optional[Dict[str, Any]] = None,
               max_to_keep: int = 10,
               topology: Optional[Dict[str, Any]] = None,
               telemetry=None, tracer=None, trace_ctx=None) -> None:
        """Snapshot `state` and queue its save; blocks while an earlier
        save is in flight. `trace_ctx` (with its `tracer`) is the
        cross-thread span handoff: the writer parents its
        `train/save_write` span to the loop's save span."""
        snap, event = snapshot_state(state)
        with self._cond:
            self._raise_pending()
            if self._closed:
                raise RuntimeError("AsyncCheckpointWriter is closed")
            while self._job is not None:
                self._cond.wait()
                self._raise_pending()
            self._job = {
                "ckpt_dir": ckpt_dir, "state": snap, "event": event,
                "step": step, "vocabs": vocabs, "dims": dims,
                "extra_manifest": extra_manifest,
                "max_to_keep": max_to_keep, "topology": topology,
                "telemetry": telemetry, "tracer": tracer,
                "trace_ctx": trace_ctx}
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="ckpt-writer")
                self._thread.start()
            self._cond.notify_all()

    def _on_own_stream(self, event):
        """The writer's stream as the current one, after `event`: the
        host copies of the snapshot run there, not behind the loop's
        next steps."""
        if event is None:
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(event.device)
        self._stream.wait_event(event)
        return torch.cuda.stream(self._stream)

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._job is None and not self._closed:
                    self._cond.wait()
                if self._job is None:
                    return  # closed and drained
                job = self._job
            hb = self._heartbeat
            try:
                if hb is not None:
                    hb.busy()  # the deadline runs while writing
                t0 = time.perf_counter()
                tracer = job["tracer"]
                t0_trace = tracer.clock() if tracer is not None else 0.0
                save_fn = self._save_fn or save_checkpoint
                with self._on_own_stream(job["event"]):
                    save_fn(job["ckpt_dir"], job["state"], job["step"],
                            job["vocabs"], job["dims"],
                            extra_manifest=job["extra_manifest"],
                            max_to_keep=job["max_to_keep"],
                            topology=job["topology"])
                self.last_total_ms = (time.perf_counter() - t0) * 1e3
                if tracer is not None:
                    tracer.record_span(
                        "train/save_write", t0_trace, tracer.clock(),
                        parent=job["trace_ctx"], step=int(job["step"]))
                tele = job["telemetry"]
                if tele is not None:
                    tele.record_ms("train/save_total_ms",
                                   self.last_total_ms)
                    tele.event("save_committed", step=int(job["step"]),
                               total_ms=round(self.last_total_ms, 3))
                self._log(f"async checkpoint step {job['step']} committed "
                          f"-> {job['ckpt_dir']} ({self.last_total_ms:.0f} "
                          f"ms in background)")
            except BaseException as e:  # raised at the next submit / wait
                with self._cond:
                    self._error = e
            finally:
                if hb is not None:
                    hb.idle()
                with self._cond:
                    self._job = None
                    self._cond.notify_all()

    def wait(self) -> None:
        """Commit barrier: returns once no save is in flight; raises a
        background failure."""
        with self._cond:
            while self._job is not None:
                self._cond.wait()
            self._raise_pending()

    def drain_quiet(self) -> None:
        """Barrier without the raise (teardown on an exception path: the
        original error is not masked; a writer error stays pending)."""
        with self._cond:
            while self._job is not None:
                self._cond.wait()

    def close(self) -> None:
        """Commit barrier and writer-thread shutdown."""
        with self._cond:
            while self._job is not None:
                self._cond.wait()
            self._closed = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join()
        self._raise_pending()


# ---- reading ----

def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _step_dirs(ckpt_dir)
    return steps[-1][0] if steps else None


def load_manifest(ckpt_dir: str) -> Dict[str, Any]:
    """The manifest with its `step` set to the latest committed step."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    step = latest_step(ckpt_dir)
    if step is not None:
        manifest["step"] = step
    return manifest


def load_dims(ckpt_dir: str) -> ModelDims:
    m = load_manifest(ckpt_dir)
    return ModelDims(
        token_vocab_size=m["token_vocab_size"],
        path_vocab_size=m["path_vocab_size"],
        target_vocab_size=m["target_vocab_size"],
        embeddings_size=m["embeddings_size"],
        max_contexts=m["max_contexts"],
        dropout_keep_rate=m["dropout_keep_rate"],
        vocab_pad_multiple=m.get("vocab_pad_multiple", 1),
        tables_dtype=m.get("tables_dtype", "float32"),
        encoder_type=m.get("encoder_type", "bag"),
        xf_layers=m.get("xf_layers", 2),
        xf_heads=m.get("xf_heads", 4),
        xf_mlp_ratio=m.get("xf_mlp_ratio", 4),
        xf_remat=m.get("xf_remat", False),
        ring_attention=m.get("ring_attention", False),
    )


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None, *,
                    verify: bool = True, mmap: bool = False,
                    log: Optional[Callable[[str], None]] = None
                    ) -> Dict[str, Any]:
    """The state of step `step` (default: the latest) with CPU tensors.

    With `verify` (the default) the step's files are checked first: an
    explicitly requested corrupt step raises `CheckpointCorrupt`; a
    corrupt latest step is quarantined and the load falls back to the
    step before it. `verify=False` is for a caller that has just checked
    the same files itself (the serving plane's hot reload), so a
    0.77 GB step is not hashed twice. `mmap` maps the state file instead
    of reading it: a read holds the interpreter lock while it copies
    each table, a mapping defers the copy to the caller's `.to(device)`,
    which releases it (the hot reload reads while replicas serve).

    Above one process (`torch.distributed` up, world > 1) a corrupt
    latest step raises `CheckpointCorrupt` too: every rank loads the
    same dir, so the supervisor quarantines it before the relaunch. A
    step whose `topology.json` names another number of processes than
    the world logs the resharding line (with `log`) and loads as it
    is."""
    from code2vec_tpu_torch.parallel.compat import cohort_world
    world = cohort_world()[1]
    explicit = step is not None
    while True:
        if step is None:
            step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        if not verify or verify_step(ckpt_dir, step) is not False:
            break
        if explicit or world > 1:
            raise CheckpointCorrupt(
                f"checkpoint step {step} under {ckpt_dir} failed checksum "
                f"verification"
                + ("" if explicit else
                   " (multi-process load: quarantine via the "
                   "supervisor, not unilaterally)"))
        quarantine_step(ckpt_dir, step, log)
        step = None  # fall back to the step before
    saved = load_step_topology(ckpt_dir, step)
    if (log is not None and saved
            and saved.get("num_processes") is not None
            and int(saved["num_processes"]) != world):
        log(f"checkpoint step {step}: saved by "
            f"{saved['num_processes']} process(es), restoring onto "
            f"{world} — resharding onto the new mesh")
    path = os.path.join(ckpt_dir, f"step_{step}", "state", STATE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing: {ckpt_dir} is not a code2vec_tpu_torch "
            "checkpoint (import one of the JAX package with "
            "tools/import_jax_checkpoint.py)")
    return _decode(torch.load(path, map_location="cpu", weights_only=True,
                              mmap=mmap))


def load_vocabs(ckpt_dir: str) -> Code2VecVocabs:
    return Code2VecVocabs.load(os.path.join(ckpt_dir, "vocab.pkl"))


def release_checkpoint(load_dir: str, dest_dir: str,
                       params: Dict[str, Any]) -> None:
    """`--release`: an inference-only checkpoint (params, no optimizer
    state) at the source's latest step, with its vocab and manifest."""
    os.makedirs(dest_dir, exist_ok=True)
    manifest = load_manifest(load_dir)
    manifest["released"] = True
    step = manifest.get("step", 0)
    _write_state(os.path.join(dest_dir, f"step_{step}"), {"params": params})
    shutil.copy(os.path.join(load_dir, "vocab.pkl"),
                os.path.join(dest_dir, "vocab.pkl"))
    with open(os.path.join(dest_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)

"""Hot weight reload from committed checkpoints: a copy of
serving/reload.py of the JAX package.

A watcher polls the checkpoint dir for committed steps (the
`step_<N>/state` rename is the commit point, exactly what
`training/checkpoint._step_dirs` counts), verifies each candidate
against its `checksums.json` sidecar, and rolls verified weights across
the `ReplicaPool` one replica at a time (`pool.swap_params`, generation
= step). The discipline is commit-or-refuse:

  - sha256 mismatch / missing file / unreadable manifest -> the step is
    REFUSED: `serve/reload_refused` counter, a `reload_refused` event,
    and (when an alert engine is attached) an immediate sweep so the
    ticket-severity `reload_refused` rule fires. The step lands in a
    refused set so one corrupt write doesn't log-spam every poll; the
    pool keeps serving the weights it has.
  - checksums not written yet (the trainer dies, or is slow, in the
    rename->sidecar window) -> no verdict this sweep; the step is
    re-examined next poll instead of being served unverified.
  - IO errors while READING verified weights retry under the shared
    `RetryPolicy` shape (`reload-io`), with the `reload/read` failpoint
    inside the retried window so chaos runs exercise exactly the
    production path; exhausted retries refuse the step (reason "io")
    rather than crashing the serving plane.

The checkpoint layout is the JAX package's (training/checkpoint.py of
the port writes `step_<N>/state/` committed by a rename, then
`checksums.json`), so the verification here is a stdlib copy over the
same manifest format: the control plane imports without torch. Loading
the weights does need it: the default `load_fn` late-imports the port's
checkpoint module, reads the step with `verify=False` (this manager has
just verified it; hashing a 0.77 GB step twice would double the reload
IO), checks the tensors against the pool's live params
(`pool.params_template()`: the same structure, shapes and dtypes) and
moves them onto the replicas' device: on the card through two pinned
staging buffers and a side stream, so the replicas' batches on the
default stream never queue behind the copy, and the weights reach the
pool only once the side stream has finished. Tests inject a stdlib
`load_fn`.

Beyond the JAX package's counters, each sweep that finds a new step
times its sha256 verification (`serve/reload_verify_ms`) and each
verified step its read onto the device (`serve/reload_load_ms`).

`ReloadManager.create()` follows the disabled-singleton discipline:
poll_s <= 0 or no checkpoint dir returns a shared no-op.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
from typing import Callable, Optional

from code2vec_tpu_torch.obs import Telemetry
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.resilience.retry import RetryPolicy

__all__ = ["ReloadManager", "committed_steps", "load_params",
           "verify_step_files", "CHECKSUMS_NAME"]

# the committed-checkpoint layout contract (training/checkpoint.py owns
# the write side; this module only ever reads)
_STEP_RE = re.compile(r"^step_(\d+)$")
CHECKSUMS_NAME = "checksums.json"


def committed_steps(ckpt_dir: str):
    """Sorted [(step, step_dir)] of COMMITTED steps only — a torn save
    (temp dir present, no renamed `state`) is invisible, the same rule
    `checkpoint._step_dirs` applies on the restore side."""
    out = []
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(ckpt_dir, name,
                                                 "state")):
                out.append((int(m.group(1)),
                            os.path.join(ckpt_dir, name)))
    return sorted(out)


# the read-and-hash unit of a step's verification: both halves release
# the interpreter lock and each chunk takes it back once, from the
# serving threads that hold it: 48 times for a java-large step where
# 1 MB chunks took it 770 times
_HASH_CHUNK = 16 << 20


def _hash_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_HASH_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def verify_step_files(ckpt_dir: str, step: int) -> Optional[bool]:
    """`checkpoint.verify_step`'s tri-state, stdlib-only: True = every
    state file matches its recorded sha256 (and no file is missing or
    extra); False = corrupt; None = no checksums manifest yet."""
    step_dir = os.path.join(ckpt_dir, f"step_{step}")
    manifest_path = os.path.join(step_dir, CHECKSUMS_NAME)
    if not os.path.exists(manifest_path):
        return None
    try:
        with open(manifest_path, encoding="utf-8") as f:
            recorded = json.load(f)["files"]
    except (OSError, ValueError, KeyError):
        return False  # an unreadable integrity manifest IS corruption
    state_dir = os.path.join(step_dir, "state")
    actual = {}
    for base, _dirs, files in os.walk(state_dir):
        for name in files:
            p = os.path.join(base, name)
            rel = os.path.relpath(p, step_dir).replace(os.sep, "/")
            actual[rel] = _hash_file(p)
    if set(actual) != set(recorded):
        return False
    return all(actual[k] == v.get("sha256")
               for k, v in recorded.items())


# the largest piece of a table copied onto the device at once
_SLICE_BYTES = 32 << 20


class _SliceCopier:
    """Copies host tensors onto `device` in row slices of at most
    _SLICE_BYTES. On the card each slice is copied from the mapped file
    into one of two page-locked staging buffers (a host copy, the
    interpreter lock released) and from there onto the card with
    `non_blocking=True` on a side stream, so the replicas' batches on
    the default stream run beside the copies. (On the default stream
    each slice's copy from the mapped, pageable file held the stream,
    and the batches queued behind it: the slowest requests of a
    java-large reload, 135-204 ms on an H100, were those sent while the
    0.77 GB step went onto the card; one copy of a whole table had held
    it for up to 390 ms.) Each output is allocated on the default stream
    and the side stream waits for that stream before writing it: the
    caching allocator may hand out a block that a batch freed while its
    kernels are still queued there. A staging buffer is refilled only
    once its previous copy has finished (an event each); `finish()`
    waits for the side stream, so the copies are complete before
    anything reads them. On the CPU the slices are plain copies."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.device = device
        self.on_card = device.type == "cuda"
        if self.on_card:
            self.stream = torch.cuda.Stream(device)
            self.staging = [torch.empty(_SLICE_BYTES, dtype=torch.uint8,
                                        pin_memory=True) for _ in range(2)]
            self.done = [None, None]
            self.turn = 0

    def _slice_to_card(self, dst, src) -> None:
        i, self.turn = self.turn, 1 - self.turn
        if self.done[i] is not None:
            self.done[i].synchronize()
        n = src.numel() * src.element_size()
        buf = self.staging[i][:n].view(src.dtype).view(src.shape)
        buf.copy_(src)
        with self.torch.cuda.stream(self.stream):
            dst.copy_(buf, non_blocking=True)
            self.done[i] = self.torch.cuda.Event()
            self.done[i].record(self.stream)

    def copy(self, t):
        out = self.torch.empty(t.shape, dtype=t.dtype, device=self.device)
        if self.on_card:
            # `out` may be a block whose last reader or writer, a batch's
            # kernel, is still queued on the default stream
            self.stream.wait_stream(
                self.torch.cuda.current_stream(self.device))
        copy_slice = self._slice_to_card if self.on_card \
            else (lambda dst, src: dst.copy_(src))
        if t.ndim == 0:
            copy_slice(out, t)
            return out
        rows = max(1, _SLICE_BYTES // max(1, t[0].numel()
                                          * t.element_size()))
        for i in range(0, t.shape[0], rows):
            copy_slice(out[i:i + rows], t[i:i + rows])
        return out

    def finish(self) -> None:
        if self.on_card:
            self.stream.synchronize()


def load_params(ckpt_dir: str, step: int, template):
    """Step `step`'s params, already verified by the caller, checked
    against `template` (a live replica's params) and copied onto its
    device (`_SliceCopier`). The state file is mapped, not read (a read
    would hold the interpreter lock, and so every serving thread, for
    the length of a table's copy); no served tensor maps the file."""
    from code2vec_tpu_torch.models.torch_model import _like
    from code2vec_tpu_torch.obs.telemetry import _first_tensor
    from code2vec_tpu_torch.training import checkpoint as ckpt
    restored = ckpt.load_checkpoint(ckpt_dir, step=step, verify=False,
                                    mmap=True)
    # the structure, shapes and dtypes checked where the tensors lie
    host = _like(restored["params"], template, "params",
                 _first_tensor(restored["params"]).device)
    copier = _SliceCopier(_first_tensor(template).device)
    params = ckpt.map_state(copier.copy, host)
    copier.finish()
    return params


class ReloadManager:
    """Watch a checkpoint dir, verify, swap. One instance per pool.

    `load_fn(step) -> params` is injectable; the default is
    `load_params` against the pool's live param template.
    """

    def __init__(self, ckpt_dir: str, pool, *,
                 load_fn: Optional[Callable[[int], object]] = None,
                 telemetry: Telemetry = None, alerts=None,
                 poll_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 retry: Optional[RetryPolicy] = None, log=None):
        self.enabled = True
        self.ckpt_dir = ckpt_dir
        self.pool = pool
        self._load_fn = load_fn
        tele = telemetry if telemetry is not None \
            else getattr(pool, "telemetry", None)
        self.telemetry = tele if tele is not None \
            else Telemetry.disabled()
        self.alerts = alerts
        self.poll_s = poll_s
        self._clock = clock
        self._log = log or (lambda *a, **k: None)
        self.retry = retry if retry is not None else RetryPolicy(
            "reload-io", max_attempts=3, base_delay_s=0.05,
            max_delay_s=1.0, retry_on=(OSError,),
            log=self._log)
        # start from the present: steps already on disk at construction
        # are the weights the pool booted from, not news
        steps = committed_steps(ckpt_dir)
        self.last_step = steps[-1][0] if steps else -1
        self.refused: set = set()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- construction ----
    @classmethod
    def create(cls, ckpt_dir: Optional[str], pool, *,
               poll_s: float = 0.0, **kw) -> "ReloadManager":
        if not ckpt_dir or poll_s <= 0:
            return _NULL_RELOAD
        return cls(ckpt_dir, pool, poll_s=poll_s, **kw)

    @classmethod
    def disabled(cls) -> "ReloadManager":
        return _NULL_RELOAD

    # ---- the sweep ----
    def check_now(self) -> Optional[int]:
        """One watcher sweep. Returns the step swapped in, or None
        (nothing new / refused / verdict pending)."""
        steps = committed_steps(self.ckpt_dir)
        if not steps:
            return None
        step = steps[-1][0]
        if step <= self.last_step or step in self.refused:
            return None
        t0 = time.perf_counter()
        verdict = verify_step_files(self.ckpt_dir, step)
        self.telemetry.record_ms("serve/reload_verify_ms",
                                 (time.perf_counter() - t0) * 1e3)
        if verdict is None:
            # committed state, no checksums yet: the trainer is inside
            # the rename->sidecar window (or died there). Wait — a
            # serving plane never swaps unverified weights.
            return None
        if verdict is False:
            self._refuse(step, reason="checksum_mismatch")
            return None
        t0 = time.perf_counter()
        try:
            params = self.retry.call(self._read_params, step)
        except OSError as e:
            self._refuse(step, reason="io", error=repr(e))
            return None
        self.telemetry.record_ms("serve/reload_load_ms",
                                 (time.perf_counter() - t0) * 1e3)
        self.pool.swap_params(params, generation=step)
        self.last_step = step
        self.telemetry.count("serve/reloads")
        self.telemetry.gauge("serve/reload_step", step, emit=False)
        self.telemetry.event("weights_reloaded", step=step)
        self._log(f"reload: step {step} verified and swapped in")
        return step

    def _read_params(self, step: int):
        # inside the retry window AND before any bytes move: chaos
        # `reload/read` io_error specs exercise the retry policy on
        # exactly the path production IO errors take
        faults.fire("reload/read", step=step, path=self.ckpt_dir)
        if self._load_fn is not None:
            return self._load_fn(step)
        return load_params(self.ckpt_dir, step,
                           self.pool.params_template())

    def _refuse(self, step: int, reason: str, **fields) -> None:
        self.refused.add(step)
        self.telemetry.count("serve/reload_refused")
        self.telemetry.event("reload_refused", step=step,
                             reason=reason, **fields)
        self._log(f"reload REFUSED step {step}: {reason}")
        if self.alerts is not None:
            # sweep immediately so the ticket-severity rule transitions
            # on the refusal, not up to a poll period later
            self.alerts.check_now()

    # ---- polling thread ----
    def start(self) -> "ReloadManager":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name="weight-reload",
                                            daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check_now()
            except Exception as e:
                # the watcher must outlive a bad sweep (transient FS
                # weirdness, a pool mid-close); refusals and retries
                # are handled above — this is the backstop
                self._log(f"reload sweep failed: {e!r}")
                self.telemetry.count("serve/reload_sweep_errors")

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30.0)

    def status(self) -> dict:
        return {"last_step": self.last_step,
                "refused": sorted(self.refused),
                "poll_s": self.poll_s}


class _NullReloadManager(ReloadManager):
    """Reload off: the shared no-op singleton."""

    def __init__(self):
        self.enabled = False
        self.ckpt_dir = None
        self.pool = None
        self.telemetry = Telemetry.disabled()
        self.alerts = None
        self.poll_s = 0.0
        self.last_step = -1
        self.refused = set()
        self._thread = None

    def check_now(self):
        return None

    def start(self):
        return self

    def stop(self) -> None:
        pass

    def status(self) -> dict:
        return {"last_step": -1, "refused": [], "poll_s": 0.0}


_NULL_RELOAD = _NullReloadManager()

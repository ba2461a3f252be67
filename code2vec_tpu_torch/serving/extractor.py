"""Extraction bridge for the serving layer: a copy of serving/extractor.py
of the JAX package over the port's own native extractor (extractor/).

`Extractor` runs the extractor on one file and returns
(method_names, raw_context_lines), raising `ExtractorError` on failure.
Java goes in process through `libc2v.so` (extractor/native.py), built at
first use from the port's copy of the C++ sources, or, with
`use_native=False`, through the `c2v_extract` binary built from the same
sources. `C2V_EXTRACTOR` (or `extractor_path=`) names another binary,
which then runs in place of both. Python goes through the CPython `ast`
frontend (extractor/python_extractor.py). A failed build raises
`ExtractorError` with the compiler's stderr; there is no fallback to
another extractor.

`ExtractorPool` is the serving server's persistent worker pool: N
threads sharing one `Extractor`, validated up front (`preflight()`, which
also builds the native extractor), so a missing compiler or binary fails
at server start instead of on the first request.

Crash recovery: a WORKER-LEVEL failure — an exec-layer death or the
`serve/extract` failpoint, both raised as `ExtractorCrash` — restarts the pool
IN PLACE on a background thread (fresh `Extractor`, fresh preflight,
fresh executor) instead of poisoning every subsequent request. While the
restart is in flight, submissions shed with the server's explicit
`ServerOverloaded`; per-INPUT failures (bad source, no methods, timeout)
stay plain `ExtractorError` and never trigger a restart. Restart
attempts ride the retry policy (resilience/retry.py); if they exhaust,
the pool goes dead and every submit re-raises the preflight error.
"""

from __future__ import annotations

import concurrent.futures
import os
import subprocess
import threading
from typing import List, Optional, Tuple

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.ops._build import KernelBuildError
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.resilience import retry as retry_mod


class ExtractorError(RuntimeError):
    pass


class ExtractorCrash(ExtractorError):
    """A worker-level death (exec failure, injected crash) rather than
    a per-input failure: the pool restarts in place on seeing one.
    Subclasses ExtractorError so callers' contracts hold."""


class Extractor:
    def __init__(self, config: Config, extractor_path: Optional[str] = None,
                 max_path_length: int = 8, max_path_width: int = 2,
                 language: str = "java", use_native: bool = True):
        self.config = config
        self.max_path_length = max_path_length
        self.max_path_width = max_path_width
        self.language = language
        # a binary named by the caller or C2V_EXTRACTOR runs in place of
        # the port's own build
        self.extractor_path = (extractor_path
                               or os.environ.get("C2V_EXTRACTOR"))
        # in-process libc2v (thread-safe: the C API is stateless):
        # no subprocess spawn per request
        self.use_native = use_native and self.extractor_path is None

    def _binary(self) -> str:
        if self.extractor_path is None:
            from code2vec_tpu_torch.extractor import native
            return native.binary_path()
        if not os.path.exists(self.extractor_path):
            raise ExtractorError(
                f"native extractor not found at {self.extractor_path} "
                f"(C2V_EXTRACTOR)")
        if not os.access(self.extractor_path, os.X_OK):
            raise ExtractorError(
                f"native extractor at {self.extractor_path} is not "
                f"executable")
        return self.extractor_path

    def preflight(self) -> None:
        """Validate the extraction backend up front (server start / pool
        construction), building the native extractor if needed, so a
        misconfiguration raises `ExtractorError` here, not mid-request."""
        if self.language == "python":
            return  # the frontend is this package's own Python
        try:
            if self.use_native:
                from code2vec_tpu_torch.extractor import native
                native.library_path()
            else:
                self._binary()
        except KernelBuildError as e:
            raise ExtractorError(str(e)) from e

    def extract_paths(self, path: str) -> Tuple[List[str], List[str]]:
        """Returns (method_names, raw_context_lines) for one source file;
        line format: `name tok,pathHash,tok ...`."""
        # chaos failpoint (--faults): an injected worker death, raised
        # as the ExtractorCrash it stands in for, which the pool survives
        # by restarting in place; disarmed = one None check
        try:
            faults.fire("serve/extract", path=path)
        except faults.FaultInjected as e:
            raise ExtractorCrash(f"extractor worker crashed: {e}") from e
        if self.language == "python":
            from code2vec_tpu_torch.extractor.python_extractor import (
                extract_file)
            lines = extract_file(path, self.max_path_length,
                                 self.max_path_width)
        elif self.use_native:
            from code2vec_tpu_torch.extractor import native
            try:
                with open(path, "r", encoding="utf-8",
                          errors="replace") as f:
                    source = f.read()
            except OSError as e:
                raise ExtractorError(f"cannot read {path}: {e}") from e
            try:
                lines = native.extract_source(source, self.max_path_length,
                                              self.max_path_width)
            except KernelBuildError as e:
                raise ExtractorError(str(e)) from e
        else:
            try:
                binary = self._binary()
            except KernelBuildError as e:
                raise ExtractorError(str(e)) from e
            cmd = [binary, "--file", path,
                   "--max_path_length", str(self.max_path_length),
                   "--max_path_width", str(self.max_path_width)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=120)
            except subprocess.TimeoutExpired as e:
                raise ExtractorError(
                    f"extractor timed out on {path}") from e
            except OSError as e:
                # exec failure (wrong arch, truncated binary, perms
                # dropped after the preflight) — a WORKER death, not a
                # per-input failure: the pool restarts on it
                raise ExtractorCrash(
                    f"cannot run extractor {cmd[0]}: {e}") from e
            if proc.returncode != 0:
                raise ExtractorError(
                    f"extractor failed ({proc.returncode}): {proc.stderr}")
            lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
        if not lines:
            raise ExtractorError(f"no methods extracted from {path}")
        names = [ln.split(" ", 1)[0] for ln in lines]
        return names, lines


class ExtractorPool:
    """Persistent extraction workers for the prediction server: N
    threads over ONE `Extractor` (stateless per call), preflighted at
    construction.

    A worker CRASH (`ExtractorCrash` / an injected `serve/extract`
    fault) restarts the pool in place: the crashing request re-raises,
    requests racing the restart shed with `ServerOverloaded`, and the
    next request after the rebuild succeeds."""

    def __init__(self, config: Config, workers: Optional[int] = None,
                 telemetry=None, **extractor_kwargs):
        self._config = config
        self._extractor_kwargs = dict(extractor_kwargs)
        self._telemetry = telemetry
        self.extractor = Extractor(config, **extractor_kwargs)
        self.extractor.preflight()
        self._workers = workers if workers is not None \
            else max(1, config.SERVE_EXTRACT_WORKERS)
        self._lock = threading.Lock()
        self._pool = self._new_executor()
        self._generation = 0
        self._restarting = False
        self._closed = False
        self._dead: Optional[BaseException] = None
        # the last restart's thread (joinable by tests and close)
        self.restart_thread: Optional[threading.Thread] = None

    def _new_executor(self) -> "concurrent.futures.ThreadPoolExecutor":
        return concurrent.futures.ThreadPoolExecutor(
            max_workers=self._workers, thread_name_prefix="extract")

    def _count(self, name: str) -> None:
        if self._telemetry is not None:
            self._telemetry.count(name)

    def submit(self, path: str) -> "concurrent.futures.Future":
        """Async extraction; the future resolves to
        (method_names, raw_context_lines) or raises `ExtractorError`.
        Sheds with `ServerOverloaded` while a crash restart is in
        flight; re-raises the terminal preflight error once restart
        attempts are exhausted."""
        from code2vec_tpu_torch.serving.batcher import ServerOverloaded
        with self._lock:
            if self._dead is not None:
                raise self._dead
            if self._restarting:
                self._count("serve/shed")
                raise ServerOverloaded(
                    "extractor pool restarting after a worker crash")
            # submit UNDER the lock: _begin_restart flips _restarting
            # and shuts the old executor down under/after this same
            # lock, so a request that passed the check above reaches the
            # executor before the shutdown
            return self._pool.submit(self._run_extract,
                                     self._generation, path)

    def _run_extract(self, generation: int, path: str):
        try:
            return self.extractor.extract_paths(path)
        except ExtractorCrash:
            self._begin_restart(generation)
            raise

    def _begin_restart(self, generation: int) -> None:
        with self._lock:
            if (self._closed or self._restarting
                    or self._generation != generation):
                return  # a newer pool already exists / is being built
            self._restarting = True
            old = self._pool
            self.restart_thread = threading.Thread(
                target=self._restart, daemon=True, name="extract-restart")
        self._count("serve/extractor_restart")
        old.shutdown(wait=False)
        self.restart_thread.start()

    def _restart(self) -> None:
        """Background rebuild: fresh Extractor + preflight + executor,
        under the retry policy (a crash during a binary swap resolves
        itself; a permanently-gone binary exhausts the budget and the
        pool goes dead)."""
        policy = retry_mod.RetryPolicy(
            "extractor-restart", max_attempts=3, base_delay_s=0.05,
            max_delay_s=1.0, retry_on=(ExtractorError, OSError))

        def build() -> Extractor:
            ex = Extractor(self._config, **self._extractor_kwargs)
            ex.preflight()
            return ex

        try:
            fresh = policy.call(build)
        except BaseException as e:
            with self._lock:
                self._dead = e
                self._restarting = False
            return
        with self._lock:
            if self._closed:
                return
            self.extractor = fresh
            self._pool = self._new_executor()
            self._generation += 1
            self._restarting = False

    @property
    def restarting(self) -> bool:
        with self._lock:
            return self._restarting

    def extract_paths(self, path: str) -> Tuple[List[str], List[str]]:
        """Synchronous extraction through the pool (keeps concurrent
        callers bounded by the worker count)."""
        return self.submit(path).result()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            pool = self._pool
        pool.shutdown(wait=False)

"""Build the package's CUDA kernels with `nvcc` and load them with ctypes.

Each `csrc/<name>.cu` is compiled on first use into a shared library with
a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

The library lands in `code2vec_tpu_torch/build/`, keyed by a hash of the
source, the `csrc/` headers it includes with `#include "..."` (followed
through headers that include others) and the flags, so an edited source
or header is rebuilt and an unchanged one is not. The compiler's output
(ptxas register and shared-memory report included) is kept beside it as
`<name>-<hash>.log`. Nothing is built at
import time: the package imports on machines without `nvcc`.

`build_host` compiles host C++ (the native path-context extractor under
`extractor/`) with the host compiler (`$CXX`, else `c++`), one compiler
call per target, into `build/<subdir>/`, keyed the same way by a hash of
its sources, headers and flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_host_locks: Dict[str, threading.Lock] = {}


class KernelBuildError(RuntimeError):
    """A compiler (`nvcc`, the host C++ compiler) is missing or refused a
    source."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels are built from csrc/ on a machine with the CUDA "
            "toolkit")
    return found


def source_files(name: str) -> List[str]:
    """`csrc/<name>.cu` and every `csrc/` file it includes with a quoted
    `#include`, directly or through another such header, in the order
    first seen."""
    seen, todo = [], [name + ".cu"]
    while todo:
        rel = todo.pop(0)
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(SRC_DIR, rel), "rb") as f:
            text = f.read()
        todo += [m.decode() for m in _INCLUDE.findall(text)
                 if os.path.exists(os.path.join(SRC_DIR, m.decode()))]
    return [os.path.join(SRC_DIR, rel) for rel in seen]


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for path in source_files(name):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> float:
    """Compile `csrc/<name>.cu` unless its library is already built.
    Returns the seconds the build took (0.0 when it was already there).
    Raises `KernelBuildError` with the compiler's output when it fails."""
    so = library_path(name)
    if os.path.exists(so):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(SRC_DIR, name + ".cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        seconds = time.perf_counter() - t0
        with open(so[:-len(".so")] + ".log", "wb") as f:
            f.write(proc.stdout)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"kernel build failed: {name} (nvcc exit {proc.returncode}):"
                "\n" + proc.stdout.decode(errors="replace"))
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return seconds


def build_log(name: str) -> str:
    path = library_path(name)[:-len(".so")] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path, encoding="utf-8", errors="replace") as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib


def cxx_path() -> str:
    """The host C++ compiler: `$CXX`, else `c++` or `g++` on PATH."""
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        found = shutil.which(cand) if cand else None
        if found is not None:
            return found
    raise KernelBuildError("no host C++ compiler ($CXX, c++ or g++ on PATH)")


def build_host(target: str, src_dir: str, sources: List[str],
               flags: List[str], suffix: str = "") -> str:
    """Compile the host C++ `sources` (file names in `src_dir`) into
    `build/<target>-<hash><suffix>` in one compiler call, unless it is
    already built; returns its path. The hash covers every `.cc` / `.h`
    of `src_dir` and the flags. Raises `KernelBuildError` with the
    compiler's stderr when it fails."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(src_dir)):
        if name.endswith((".cc", ".h")):
            with open(os.path.join(src_dir, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join([*flags, *sources]).encode())
    out = os.path.join(BUILD_DIR, f"{target}-{h.hexdigest()[:16]}{suffix}")
    with _lock:  # one build a target at a time, targets in parallel
        target_lock = _host_locks.setdefault(target, threading.Lock())
    with target_lock:
        if os.path.exists(out):
            return out
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [cxx_path(), *flags, "-o", tmp,
               *(os.path.join(src_dir, s) for s in sources)]
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE)
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"build of {target} failed ({cmd[0]} exit "
                    f"{proc.returncode}):\n"
                    + proc.stderr.decode(errors="replace"))
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out

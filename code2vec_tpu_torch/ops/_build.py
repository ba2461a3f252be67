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


class KernelBuildError(RuntimeError):
    """`nvcc` is missing or refused a source."""


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

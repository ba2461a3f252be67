"""The native Java path-context extractor, built from this directory's
C++ sources at first use.

A copy of extractor/native.py of the JAX package (ctypes over
`libc2v.so`, then the `c2v_extract` command line), building both from
the port's own copy of the sources with the host C++ compiler, one
compiler call per target, with the settings of the JAX package's
CMakeLists.txt (C++17, -O2; -fPIC for the library, -pthread for the
binary), into `code2vec_tpu_torch/build/extractor/` (ops/_build.py).
A failed build raises `KernelBuildError` with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional

from code2vec_tpu_torch.ops import _build

_DIR = os.path.dirname(os.path.abspath(__file__))
_CORE = ["lexer.cc", "parser.cc", "paths.cc"]
_FLAGS = ["-std=c++17", "-O2"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def library_path() -> str:
    """`libc2v.so`, built first if needed."""
    return _build.build_host("extractor/libc2v", _DIR, ["capi.cc", *_CORE],
                             [*_FLAGS, "-fPIC", "-shared"], ".so")


def binary_path() -> str:
    """`c2v_extract`, built first if needed."""
    return _build.build_host("extractor/c2v_extract", _DIR,
                             ["main.cc", *_CORE], [*_FLAGS, "-pthread"])


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(library_path())
            lib.c2v_extract_source.restype = ctypes.c_void_p
            lib.c2v_extract_source.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int]
            lib.c2v_free.argtypes = [ctypes.c_void_p]
            lib.c2v_java_string_hash.restype = ctypes.c_int
            lib.c2v_java_string_hash.argtypes = [ctypes.c_char_p]
            _lib = lib
        return _lib


def extract_source(source: str, max_path_length: int = 8,
                   max_path_width: int = 2,
                   max_leaves: int = 1000) -> List[str]:
    """Java source text -> extractor output lines (`name tok,hash,tok ...`),
    in process through `libc2v.so`."""
    lib = _load()
    ptr = lib.c2v_extract_source(source.encode("utf-8"), max_path_length,
                                 max_path_width, max_leaves)
    if not ptr:
        return []
    try:
        text = ctypes.string_at(ptr).decode("utf-8", errors="replace")
    finally:
        lib.c2v_free(ptr)
    return [ln for ln in text.splitlines() if ln.strip()]


def java_string_hash(s: str) -> int:
    """Java String.hashCode through the C implementation (the Python one
    is python_extractor.java_string_hash)."""
    return _load().c2v_java_string_hash(s.encode("utf-8"))

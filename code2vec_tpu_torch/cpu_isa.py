"""The process's permission to use AMX, asked for once at import.

On the CPU, PyTorch runs bf16 matmuls through oneDNN, which uses Intel
AMX tiles where the CPU has them and otherwise AVX-512 BF16 code that
rounds differently. Linux hands out AMX per process: the first user
asks with `arch_prctl(ARCH_REQ_XCOMP_PERM, XFEATURE_XTILEDATA)`, and the
kernel refuses (ENOSPC) while any thread of the process has an alternate
signal stack too small for the AMX signal frame. oneDNN asks lazily, at
the process's first bf16 matmul, and on a refusal runs every matmul of
the process without AMX. So whether two identical CPU trainings round
alike can depend on which threads are alive at that moment: a thread
with a small signal stack makes one run of a pair take the other path
(tests/test_torch_cpu_isa.py forces it). This is a hardening: identical
CPU trainings started together were seen to differ in rounding bits in
a few percent of pairs, and this mechanism gives such a difference,
but no such run has been shown to take it.

`request_amx()` asks at the package's import, before the port starts a
thread of its own; the permission then holds for the process whatever
threads come later, and oneDNN finds it granted. The request is
process-wide and made in every process that imports the package, on
the card too, where it changes nothing the port runs. It is stdlib only (the
serving control plane imports without torch) and a no-op off x86-64
Linux; on a CPU without AMX the request fails and nothing changes.
"""

from __future__ import annotations

import ctypes
import platform
import sys
from typing import Optional

_SYS_ARCH_PRCTL = 158           # x86-64
_ARCH_GET_XCOMP_PERM = 0x1022
_ARCH_REQ_XCOMP_PERM = 0x1023
_XFEATURE_XTILEDATA = 18

_granted: Optional[bool] = None


def _syscall():
    if not sys.platform.startswith("linux") \
            or platform.machine() not in ("x86_64", "AMD64"):
        return None
    try:
        fn = ctypes.CDLL(None, use_errno=True).syscall
    except (OSError, AttributeError):
        return None
    fn.restype = ctypes.c_long
    return fn


def amx_permitted() -> bool:
    """True when this process may use AMX tiles (the kernel's permitted
    xstate mask holds XTILEDATA)."""
    fn = _syscall()
    if fn is None:
        return False
    mask = ctypes.c_ulong(0)
    if fn(_SYS_ARCH_PRCTL, _ARCH_GET_XCOMP_PERM, ctypes.byref(mask)) != 0:
        return False
    return bool(mask.value & (1 << _XFEATURE_XTILEDATA))


def request_amx() -> bool:
    """Ask once for the process's AMX permission; True when it holds."""
    global _granted
    if _granted is None:
        fn = _syscall()
        _granted = fn is not None and fn(
            _SYS_ARCH_PRCTL, _ARCH_REQ_XCOMP_PERM,
            _XFEATURE_XTILEDATA) == 0
    return _granted

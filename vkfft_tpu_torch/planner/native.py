"""ctypes binding to the native C++ planner core (port of
``vkfft_tpu/planner/native.py``).

The core is ``vkfft_tpu_torch/native/planner_core.cpp``, a copy of the JAX
package's.  It is built at first use, as the CUDA kernels are
(`ops.cuda_kernels.build_kernels`): ``c++ -O2 -fPIC -std=c++17 -shared``
into `BUILD_DIR` (``vkfft_tpu_torch/_build/`` unless
`cache.enable_persistent_cache` moves it), under a name keyed by a hash of
the source, the flags and the compiler, apart from the kernels' libraries
(``planner_core-<key>.so``).  The compiler writes a temporary name that is
``os.replace``d into place under a file lock, so a concurrent process (an
xdist worker, a second rank) sees either no library or the whole of one,
and only one of them compiles.

Every entry point returns None where the core is unavailable (no compiler,
a failed build, or ``VKFFT_TPU_TORCH_NATIVE=0``, the reference's
``VKFFT_TPU_NATIVE=0``), and `planner.factorize` then runs its pure-Python
body, which is bit-identical (``tests/test_torch_native.py``).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "native", "planner_core.cpp")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
BUILD_TIMEOUT_S = 120

_lib: Optional[ctypes.CDLL] = None
# Why the core did not load in this process (None: not tried, or loaded);
# a failed build is not retried until the build directory changes.
error: Optional[str] = None


def set_build_dir(path: str) -> None:
    """Build and load the core from ``path`` from now on (a library this
    process already loaded stays loaded)."""
    global BUILD_DIR, error
    BUILD_DIR = path
    error = None


def _compiler() -> str:
    for name in ("c++", "g++", "clang++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler (c++, g++ or clang++) on PATH")


def library_path(cxx: str) -> str:
    """The library of this source built with ``cxx`` and `CXX_FLAGS`."""
    h = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"planner_core-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Build the core unless its library exists; returns its path.  Raises
    RuntimeError without a compiler or when the compile fails."""
    cxx = _compiler()
    path = library_path(cxx)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "planner_core.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if os.path.exists(path):           # another process built it
            return path
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                                 capture_output=True, text=True,
                                 timeout=BUILD_TIMEOUT_S)
            if res.returncode:
                raise RuntimeError(f"{cxx} failed on {SOURCE}:\n"
                                   f"{res.stderr[-4000:]}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded core, built at first use; None where it is unavailable
    (`error` says why)."""
    global _lib, error
    if os.environ.get("VKFFT_TPU_TORCH_NATIVE", "1") == "0":
        return None
    if _lib is not None:
        return _lib
    if error is not None:
        return None
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        error = f"{type(e).__name__}: {e}"
        return None
    i64 = ctypes.c_int64
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.vt_prime_factors.restype = i64
    lib.vt_prime_factors.argtypes = [i64, p64, i64]
    lib.vt_is_prime.restype = ctypes.c_int32
    lib.vt_is_prime.argtypes = [i64]
    lib.vt_next_smooth.restype = i64
    lib.vt_next_smooth.argtypes = [i64]
    lib.vt_group_radices.restype = i64
    lib.vt_group_radices.argtypes = [p64, i64, i64, p64, i64]
    lib.vt_primitive_root.restype = i64
    lib.vt_primitive_root.argtypes = [i64]
    lib.vt_bluestein_size.restype = i64
    lib.vt_bluestein_size.argtypes = [i64, i64, i64]
    lib.vt_decompose.restype = i64
    lib.vt_decompose.argtypes = [i64, ctypes.c_int32, i64, i64, i64, p64, i64]
    _lib = lib
    return _lib


def prime_factors(n: int) -> Optional[list[int]]:
    lib = get_lib()
    if lib is None:
        return None
    buf = (ctypes.c_int64 * 64)()
    cnt = lib.vt_prime_factors(n, buf, 64)
    if cnt < 0:
        return None
    return [int(buf[i]) for i in range(cnt)]


def is_prime(n: int) -> Optional[bool]:
    lib = get_lib()
    if lib is None:
        return None
    return bool(lib.vt_is_prime(n))


def next_smooth(n: int) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.vt_next_smooth(n))


def group_radices(primes: list[int], max_radix: int) -> Optional[list[int]]:
    lib = get_lib()
    if lib is None:
        return None
    arr = (ctypes.c_int64 * max(1, len(primes)))(*primes)
    out = (ctypes.c_int64 * 64)()
    cnt = lib.vt_group_radices(arr, len(primes), max_radix, out, 64)
    if cnt < 0:
        return None
    return [int(out[i]) for i in range(cnt)]


def primitive_root(p: int) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    g = lib.vt_primitive_root(p)
    return int(g) if g > 0 else None


def bluestein_size(n: int, max_direct_prime: int,
                   group_radix: int) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    m = lib.vt_bluestein_size(n, max_direct_prime, group_radix)
    return int(m) if m > 0 else None


def decompose(n: int, allow_rader: bool, max_direct_prime: int,
              group_radix: int, rader_max_prime: int
              ) -> Optional[tuple[int, int, int, list[int]]]:
    """Full decomposition cascade (``vt_decompose``).  Returns
    ``(algo, aux1, aux2, radices)`` with algo 0=DIRECT 1=RADER 2=BLUESTEIN
    3=SPLIT, or None when the native core is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = (ctypes.c_int64 * 96)()
    rc = lib.vt_decompose(n, 1 if allow_rader else 0, max_direct_prime,
                          group_radix, rader_max_prime, out, 96)
    if rc < 4:
        return None
    nrad = int(out[3])
    return (int(out[0]), int(out[1]), int(out[2]),
            [int(out[4 + i]) for i in range(nrad)])

"""The port's native C++ planner core (`vkfft_tpu_torch.planner.native`)
against the port's pure-Python planner and the JAX package's, bit for bit.

The twins of the 7 parity cases of ``tests/test_native.py``, each holding
the core to the port's Python body (the core switched off with
``VKFFT_TPU_TORCH_NATIVE=0``) and to the JAX package's Python body, over the
same sweeps; then the build: the core's library beside the kernels' in the
build directory under a key of its own, several processes building it into
one empty directory at once (each must load a whole library),
and the Python fallback where no compiler exists.

The core is built once per worker by a session fixture before the cases,
so under ``-n 6`` none of them skips; they skip, saying why, only where no
C++ compiler exists.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from vkfft_tpu import luts as jluts
from vkfft_tpu.planner import factorize as jf

from vkfft_tpu_torch import luts as tluts
from vkfft_tpu_torch.planner import factorize as tf
from vkfft_tpu_torch.planner import native

OFF = "VKFFT_TPU_TORCH_NATIVE"
RACING = 6          # processes building into one directory at once
BUILD_WAIT_S = 120


@pytest.fixture(scope="session", autouse=True)
def core():
    """The native core, built (or found) once before the cases."""
    if not any(shutil.which(c) for c in ("c++", "g++", "clang++")):
        pytest.skip("no C++ compiler on PATH: the native planner core "
                    "cannot build here, the Python planner runs alone")
    lib = native.get_lib()
    assert lib is not None, native.error
    return lib


def _python(fn):
    """``fn()`` on the port's pure-Python planner: the core switched off
    and the planner's caches emptied around the call."""
    old = os.environ.get(OFF)
    os.environ[OFF] = "0"
    tf.decompose.cache_clear()
    tf.next_smooth.cache_clear()
    try:
        return fn()
    finally:
        if old is None:
            del os.environ[OFF]
        else:
            os.environ[OFF] = old
        tf.decompose.cache_clear()
        tf.next_smooth.cache_clear()


def _py_prime_factors(n):
    out = []
    for p in (2, 3, 5, 7, 11, 13):
        while n % p == 0:
            out.append(p)
            n //= p
    f = 17
    while f * f <= n:
        while n % f == 0:
            out.append(f)
            n //= f
        f += 2
    if n > 1:
        out.append(n)
    return out


def test_prime_factors_parity():
    sizes = list(range(2, 2000)) + [10007, 2 * 5003, 1 << 20, 3 ** 10]
    nat = [native.prime_factors(n) for n in sizes]
    assert nat == [_py_prime_factors(n) for n in sizes]
    assert nat == _python(lambda: [tf.prime_factors(n) for n in sizes])
    assert nat == [jf.prime_factors(n) for n in sizes]


def test_is_prime_parity():
    def py_is_prime(n):
        return n >= 2 and all(n % d for d in range(2, int(n ** 0.5) + 1))
    sizes = list(range(0, 500)) + [10007, 10006, 99991]
    nat = [native.is_prime(n) for n in sizes]
    assert nat == [py_is_prime(n) for n in sizes]
    assert nat == _python(lambda: [tf.is_prime(n) for n in sizes])
    assert nat == [jf.is_prime(n) for n in sizes]


def test_next_smooth_parity():
    sizes = list(range(1, 300)) + [1000, 4099, 12345, 65537]
    nat = [native.next_smooth(n) for n in sizes]
    for n, m in zip(sizes, nat):
        assert m >= n
        assert m == 1 or all(p <= 13 for p in _py_prime_factors(m)), n
    # the primes reordered take the Python search in both packages
    order = (13, 11, 7, 5, 3, 2)
    assert nat == _python(lambda: [tf.next_smooth(n) for n in sizes])
    assert nat == [tf.next_smooth(n, order) for n in sizes]
    assert nat == [jf.next_smooth(n, order) for n in sizes]


def test_group_radices_parity():
    rng = np.random.default_rng(0)
    for _ in range(300):
        primes = []
        for p, maxc in ((2, 12), (3, 4), (5, 3), (7, 2), (11, 1), (13, 1)):
            primes += [p] * int(rng.integers(0, maxc))
        if not primes:
            continue
        for max_radix in (8, 16, 32):
            nat = native.group_radices(sorted(primes), max_radix)
            assert nat == tf._group_radices(sorted(primes), max_radix)
            assert nat == jf._group_radices(sorted(primes), max_radix)


def test_primitive_root_parity():
    for p in (3, 5, 7, 17, 97, 101, 257, 641, 1009, 10007):
        assert native.primitive_root(p) == tluts._primitive_root(p)
        assert native.primitive_root(p) == jluts._primitive_root(p)


def test_bluestein_size_parity():
    sizes = (17, 101, 127, 997, 10007, 65537, 1031, 8209, 40961)
    nat = [native.bluestein_size(n, tf.MAX_DIRECT_PRIME, tf.MAX_GROUP_RADIX)
           for n in sizes]
    assert nat == _python(lambda: [tf._bluestein_padded_size(n)
                                   for n in sizes])
    assert nat == [jf._bluestein_padded_size(n) for n in sizes]


DECOMPOSE_SIZES = (list(range(2, 1500))
                   + [4096, 10007, 1 << 13, 1 << 17, 131 * 64, 347, 587,
                      131 * 131, 2 * 5003, 9973, 100003, 1 << 20, 3 ** 10,
                      131 * 257, 127 * 128, 10007 * 4])
CODE = {"direct": 0, "rader": 1, "bluestein": 2, "split": 3}


def _fields(d):
    """A decomposition's fields as ``vt_decompose`` returns them."""
    code = CODE[d.algorithm.value]
    aux = {1: (d.rader_prime, 0), 2: (d.bluestein_size, 0),
           3: d.split}.get(code)
    return code, aux, tuple(d.radices)


def test_decompose_parity():
    """The full native cascade (``vt_decompose``) against the Python oracle
    of both packages: algorithm, radices and aux fields; and the planner's
    `decompose`, which delegates to the core, gives the Python body's
    decompositions."""
    for allow_rader in (True, False):
        nat = []
        for n in DECOMPOSE_SIZES:
            r = native.decompose(n, allow_rader, tf.MAX_DIRECT_PRIME,
                                 tf.MAX_GROUP_RADIX, tf.RADER_MAX_PRIME)
            assert r is not None, n
            algo, aux1, aux2, radices = r
            aux = None if algo == 0 else (aux1, aux2 if algo == 3 else 0)
            nat.append((algo, aux, tuple(radices)))
        py = _python(lambda: [tf._decompose_py(n, allow_rader)
                              for n in DECOMPOSE_SIZES])
        assert nat == [_fields(d) for d in py], allow_rader
        ref = [jf._decompose_py(n, allow_rader) for n in DECOMPOSE_SIZES]
        assert nat == [_fields(d) for d in ref], allow_rader
        tf.decompose.cache_clear()
        assert [tf.decompose(n, allow_rader) for n in DECOMPOSE_SIZES] == py


def test_library_keyed_apart_in_build_dir():
    """The core's library sits in the build directory beside the kernels'
    libraries (``<kernel>-<key>.so``) under a name of its own."""
    from vkfft_tpu_torch.ops import cuda_kernels as ck
    path = native.library_path(native._compiler())
    assert os.path.dirname(path) == native.BUILD_DIR
    name = os.path.basename(path)
    assert name.startswith("planner_core-") and name.endswith(".so")
    assert not any(name.startswith(k + "-") for k in ck.KERNEL_SOURCES)
    assert os.path.exists(path)


# One building process: native.py loaded by its path (it imports nothing of the
# package, so the process starts without torch), pointed at the shared
# directory, waiting for the start file so that every process races.
BUILD_SCRIPT = """
import importlib.util, os, sys, time
spec = importlib.util.spec_from_file_location("native", sys.argv[1])
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
native.set_build_dir(sys.argv[2])
while not os.path.exists(sys.argv[3]):
    time.sleep(0.005)
lib = native.get_lib()
assert lib is not None, native.error
print(native.decompose(10007, True, 127, 16, 10007),
      native.prime_factors(2 * 5003), os.path.basename(lib._name))
"""


def test_concurrent_builds(tmp_path):
    """Several processes build the core into one empty directory at once:
    each loads a whole library (the same one), and the directory ends with
    that library and its lock alone (no temporary file left)."""
    build = tmp_path / "build"
    start = tmp_path / "start"
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_SCRIPT, native.__file__, str(build),
         str(start)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(RACING)]
    time.sleep(0.5)
    start.touch()
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=BUILD_WAIT_S)
        assert p.returncode == 0, err
        outs.append(out.strip())
    want = (f"(2, 32768, 0, [16, 16, 16, 8]) [2, 5003] "
            f"{os.path.basename(native.library_path(native._compiler()))}")
    assert outs == [want] * RACING
    assert sorted(os.listdir(build)) == sorted(
        [os.path.basename(native.library_path(native._compiler())),
         "planner_core.lock"])


def test_python_fallback_without_compiler(tmp_path, monkeypatch):
    """Where no compiler exists the core is unavailable, says why, and the
    planner runs its Python body, with the same decompositions."""
    want = [tf.decompose(n) for n in (10007, 10006, 7919, 4096, 131 * 257)]
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "error", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    try:
        assert native.get_lib() is None
        assert "no C++ compiler" in native.error
        tf.decompose.cache_clear()
        tf.next_smooth.cache_clear()
        assert [tf.decompose(n) for n in (10007, 10006, 7919, 4096,
                                          131 * 257)] == want
        assert os.listdir(tmp_path) == []
    finally:
        tf.decompose.cache_clear()
        tf.next_smooth.cache_clear()

"""The double-double FFT engine: routes, the N-D axis walk and `fft_dd`.

Port of ``vkfft_tpu/precision/dd_fft.py``.  Every dd DFT runs in
`dd_kernel.fft_dd_lines` / `fft_dd_strided` (``csrc/fft_dd.cu`` on a card,
the plain versions on CPU planes); the tier's dd products ride those
passes as their ``pre``/``post`` options, split exactly from host fp64
tables (``dd_fft.py:47-48``).  `dd_route` is the one place a length's
route is decided:

* ``kernel``: a 13-smooth n <= 4096, one pass;
* ``four_step``: a 13-smooth n with a split n1 * n2 into two kernel
  lengths (`dd_split`), as ``_dd_four_step`` (``dd_fft.py:128``): a
  strided pass over n1 with the twiddle w_n^(k1*j2) on its write, a lines
  pass over n2, and the transpose to natural order as a tensor op;
* ``rader``: a prime p whose p - 1 is 13-smooth (``dd_fft.py:197``): the
  (p-1)-point cyclic convolution, forward, then inverse with the spectrum
  on its read and x0 added on its write.  X0 = x0 + A[0], A the forward
  DFT of the gathered points, on `dd_kernel.dd_pointwise` (the identity in
  place of ``_dd_tree_sum``); the gathers are tensor ops;
* ``bluestein``: every other n (``dd_fft.py:244-259``), the padded
  m-point convolution with the chirp and spectrum on the forward pass and
  the chirp on the inverse; padding and cropping are tensor ops.

The JAX package runs 11- and 13-smooth lengths and lengths without a
two-kernel split in its XLA stage pipeline; here a length with no route
(a 13-smooth n with no split, or a Rader/Bluestein length whose core has
none, all beyond 4096^2) raises `NotImplementedError` naming ROADMAP
queue 1 item 16.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from vkfft_tpu_torch import luts
from vkfft_tpu_torch.planner.factorize import (
    _bluestein_padded_size,
    prime_factors,
)
from vkfft_tpu_torch.precision import dd_kernel
from vkfft_tpu_torch.precision.dd_kernel import (
    DD_MAX_PRIME,
    dd_pointwise,
    device_quads,
    fft_dd_lines,
    fft_dd_strided,
    quads_of,
    use_dd_kernel,
)
from vkfft_tpu_torch.precision.doubledouble import (
    DDComplex,
    ddc_from_complex128,
    ddc_to_complex128,
)

ROUTES = ("kernel", "four_step", "rader", "bluestein")


@functools.lru_cache(maxsize=4096)
def dd_split(n: int):
    """(n1, n2), n = n1 * n2 with both kernel lengths, n2 a multiple of
    128 where one exists (``_dd_split``, ``dd_fft.py:97``), else the most
    balanced; None where there is none."""
    for n1 in range(math.isqrt(n), 1, -1):
        n2 = n // n1
        if (n % n1 == 0 and n2 % 128 == 0 and use_dd_kernel(n1)
                and use_dd_kernel(n2)):
            return n1, n2
    for n1 in range(math.isqrt(n), 1, -1):
        if n % n1 == 0 and use_dd_kernel(n1) and use_dd_kernel(n // n1):
            return n1, n // n1
    return None


def _no_route(n: int) -> NotImplementedError:
    return NotImplementedError(
        f"double-double length {n} has no route on the port's dd kernel "
        "(a 13-smooth core beyond one kernel or two uploads of it, "
        f"{dd_kernel.DD_KERNEL_MAX_N}^2): ROADMAP queue 1 item 16")


@functools.lru_cache(maxsize=4096)
def dd_route(n: int) -> tuple:
    """The route of a dd transform of length n >= 2: ("kernel", n),
    ("four_step", n1, n2), ("rader", p - 1) or ("bluestein", m), the
    second item(s) the length(s) of the DFTs it runs.  Raises
    `NotImplementedError` where no route holds the length."""
    if n < 2:
        raise ValueError(f"a dd route needs n >= 2, got {n}")
    primes = prime_factors(n)
    if primes[-1] <= DD_MAX_PRIME:
        if use_dd_kernel(n):
            return ("kernel", n)
        split = dd_split(n)
        if split is None:
            raise _no_route(n)
        return ("four_step",) + split
    if len(primes) == 1 and prime_factors(n - 1)[-1] <= DD_MAX_PRIME:
        core = ("rader", n - 1)
    else:
        core = ("bluestein", _bluestein_padded_size(n))
    if dd_route(core[1])[0] not in ("kernel", "four_step"):
        raise _no_route(n)
    return core


# ---------------------------------------------------------------------------
# Tables, split exactly from host fp64, cached per device.
# ---------------------------------------------------------------------------

def _swapped(t: np.ndarray, n1: int, n2: int) -> np.ndarray:
    """A natural-order table of n1*n2 as the four-step's lines pass leaves
    its output: position k1*n2 + k2 holds bin k1 + n1*k2."""
    return np.ascontiguousarray(t.reshape(n2, n1).T).ravel()


def _four_step_twiddle(n1: int, n2: int, inverse: bool) -> np.ndarray:
    """w_n^(k1*j2) at [k1, j2] (``luts.ct_twiddle(n1, n2).T``)."""
    return np.ascontiguousarray(luts.ct_twiddle(n1, n2, inverse).T)


@functools.lru_cache(maxsize=64)
def _rader_spectrum(p: int, inverse: bool) -> np.ndarray:
    """FFT_{p-1}(w^(g^-q)) / (p - 1), w = exp(-+2 pi i / p): the inverse's
    spectrum conjugates the root, so no conjugation of the data is needed
    (the JAX package conjugates, ``dd_fft.py:205-207``)."""
    _, inv_perm, b_fft = luts.rader_tables(p)
    if inverse:
        b_fft = np.fft.fft(np.exp(2.0j * np.pi / p * inv_perm))
    return b_fft / (p - 1)


def _bluestein_tables(n: int, m: int, inverse: bool):
    """(chirp a zero-padded to m, the spectrum FFT_m(b) / m)."""
    a, b = luts.bluestein_chirp(n, m, inverse)
    return np.concatenate([a, np.zeros(m - n)]), b / m


# ---------------------------------------------------------------------------
# Transforms of (B, n) quad planes.
# ---------------------------------------------------------------------------

def _dd_four_step(x: DDComplex, n1: int, n2: int, inverse: bool, pre=None,
                  post=None, add=None, scale: float = 1.0) -> DDComplex:
    """Two passes (``_dd_four_step``, ``dd_fft.py:128``): the strided pass
    over n1 with ``pre`` on its read and the twiddle on its write, the
    lines pass over n2 with ``post`` (in its swapped order), ``add`` and
    ``scale`` on its write, then X[k1 + n1*k2] = Y[k1, k2] transposed to
    natural order.  ``pre`` is a device table in natural order, ``post``
    (key, build) of a natural-order host table."""
    B, dev = x.shape[0], x.device
    n = n1 * n2
    tw = device_quads(("twiddle", n1, n2, inverse), dev,
                      lambda: _four_step_twiddle(n1, n2, inverse))
    a = fft_dd_strided(x.reshape(B, n1, n2), inverse, pre=pre, post=tw)
    post_t = None
    if post is not None:
        key, build = post
        post_t = device_quads(key + ("swapped", n1, n2), dev,
                              lambda: _swapped(build(), n1, n2))
    if add is not None:
        add = add.repeat_interleave(n1, dim=0)
    b = fft_dd_lines(a.reshape(B * n1, n2), inverse, post=post_t, add=add,
                     scale=scale)
    return b.map(lambda p: p.reshape(B, n1, n2).transpose(1, 2)
                 .reshape(B, n))


def _core_fft_dd(x: DDComplex, n: int, inverse: bool, pre=None, post=None,
                 add=None, scale: float = 1.0) -> DDComplex:
    """The DFT of a kernel or four-step length (``_core_fft_dd``,
    ``dd_fft.py:150``).  ``pre``/``post``: None or (key, build) of a
    natural-order host table of length n; ``add``: (B, 4) quads."""
    route = dd_route(n)
    dev = x.device
    pre_t = None if pre is None else device_quads(pre[0], dev, pre[1])
    if route[0] == "kernel":
        post_t = (None if post is None
                  else device_quads(post[0], dev, post[1]))
        return fft_dd_lines(x, inverse, pre=pre_t, post=post_t, add=add,
                            scale=scale)
    _, n1, n2 = route
    return _dd_four_step(x, n1, n2, inverse, pre_t, post, add, scale)


def _fft_rader_dd(x: DDComplex, p: int, inverse: bool,
                  scale: float) -> DDComplex:
    """Rader's algorithm for prime p (``dd_fft.py:197``):
    A = DFT(x[perm]); X0 = (x0 + A[0]) * scale; c = (IDFT(A * spectrum) +
    x0) * scale; X[inv_perm[k]] = c[k]."""
    perm, inv_perm, _ = luts.rader_tables(p)
    dev = x.device
    idx = torch.from_numpy(perm).to(dev)
    a = x.map(lambda t: t.index_select(1, idx))
    A = _core_fft_dd(a, p - 1, False)
    x0 = quads_of(x[:, 0])
    X0 = dd_pointwise(A[:, :1].contiguous(), add=x0, scale=scale)
    spec = (("rader", p, inverse), lambda: _rader_spectrum(p, inverse))
    c = _core_fft_dd(A, p - 1, True, pre=spec, add=x0, scale=scale)
    order = torch.from_numpy(np.argsort(inv_perm)).to(dev)
    return DDComplex.of([torch.cat([h, t.index_select(1, order)], dim=1)
                         for h, t in zip(X0.planes(), c.planes())])


def _fft_bluestein_dd(x: DDComplex, n: int, m: int, inverse: bool,
                      scale: float) -> DDComplex:
    """Bluestein (``dd_fft.py:244-259``): the zero-padded line times the
    chirp, its m-point DFT times the spectrum (both on one pass), the
    inverse DFT times the chirp and ``scale`` on its write, cropped."""
    chirp = (("blu_a", n, m, inverse),
             lambda: _bluestein_tables(n, m, inverse)[0])
    spec = (("blu_b", n, m, inverse),
            lambda: _bluestein_tables(n, m, inverse)[1])
    y = x.map(lambda t: torch.nn.functional.pad(t, (0, m - n)))
    Y = _core_fft_dd(y, m, False, pre=chirp, post=spec)
    z = _core_fft_dd(Y, m, True, post=chirp, scale=scale)
    return z.map(lambda t: t[:, :n].contiguous())


def fft_lines_dd(x: DDComplex, n: int, inverse: bool = False,
                 scale: float = 1.0) -> DDComplex:
    """The dd DFT of each line of (B, n) quad planes, natural order, times
    ``scale`` (``fft_lines_dd``, ``dd_fft.py:234``, unnormalized there)."""
    if x.shape[-1] != n:
        raise ValueError(f"planes of {x.shape} for length {n}")
    if n == 1:
        return x if scale == 1.0 else dd_pointwise(x, scale=scale)
    route = dd_route(n)
    if route[0] in ("kernel", "four_step"):
        return _core_fft_dd(x, n, inverse, scale=scale)
    if route[0] == "rader":
        return _fft_rader_dd(x, n, inverse, scale)
    return _fft_bluestein_dd(x, n, route[1], inverse, scale)


def fft_axis_dd(x: DDComplex, axis: int, n: int, inverse: bool = False,
                scale: float = 1.0) -> DDComplex:
    """The dd DFT along ``axis`` of N-D quad planes, times ``scale``
    (``fft_axis_dd``, ``dd_fft.py:300``).  The last axis runs as lines; a
    non-minor axis of a kernel length runs the strided pass in place of
    the trailing dims; any other axis is moved last and back."""
    shape = x.shape
    ndim = len(shape)
    axis = axis % ndim
    if shape[axis] != n:
        raise ValueError(f"axis {axis} of {shape} is not of length {n}")
    if axis == ndim - 1:
        return fft_lines_dd(x.reshape(-1, n), n, inverse,
                            scale).reshape(*shape)
    if use_dd_kernel(n):
        p = math.prod(shape[:axis])
        s = math.prod(shape[axis + 1:])
        y = fft_dd_strided(x.reshape(p, n, s), inverse, scale=scale)
        return y.reshape(*shape)
    moved = x.map(lambda t: t.movedim(axis, -1).contiguous())
    y = fft_lines_dd(moved.reshape(-1, n), n, inverse, scale)
    return y.reshape(*moved.shape).map(
        lambda t: t.movedim(-1, axis).contiguous())


def dd_scale(x: DDComplex, value: float) -> DDComplex:
    """x times an fp64 host scalar split exactly into a dd pair
    (``dd_scale``, ``dd_fft.py:332``), on `dd_kernel.dd_pointwise`."""
    shape = x.shape
    last = shape[-1] if shape else 1
    return dd_pointwise(x.contiguous().reshape(-1, last),
                        scale=value).reshape(*shape)


def fft_dd(x, inverse: bool = False, normalize: bool = False,
           device="cuda") -> np.ndarray:
    """Host convenience (``fft_dd``, ``dd_fft.py:282``): complex128 (...,
    n) host data through the dd tier on ``device`` and back as numpy
    complex128; the inverse with ``normalize`` times 1/n in the last
    pass."""
    from vkfft_tpu_torch.api import resolve_device
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    xd = ddc_from_complex128(x.reshape(-1, n), resolve_device(device))
    scale = 1.0 / n if inverse and normalize else 1.0
    y = fft_lines_dd(xd, n, inverse, scale)
    return ddc_to_complex128(y).cpu().numpy().reshape(x.shape)

"""Fused frequency-domain convolution.

Port of ``vkfft_tpu/transforms/conv.py`` (the reference's
``PrePostProcessing/vkFFT_Convolution.h``: scalar and 2x2/3x3 matrix
kernels, multi-kernel batching, conjugate and cross-power-spectrum
options).  A convolution is the forward transform, a per-frequency (matrix)
multiply and the inverse transform.  On the card the fused modes run the
whole circular convolution of the minor axis, or of the minor pair, in one
kernel launch (`ops/cuda_engine.py` ``conv_fused_*``); everything else runs
as the composition of the port's `fftn`/`ifftn` with the multiply, the
einsum and the cross-power normalization as torch ops, as the JAX package
does.

Like the reference, convolutions are circular; a linear convolution comes
from zero padding (README.md:15-16): a config's ``zeropad_input`` declares
the data zero outside its window before the forward pass and its
``zeropad_output`` the result outside its window after the inverse.  In
the "pair" mode on the card, prefix windows run in the kernels, as the
JAX package's pair mode does (``vkfft_tpu/transforms/conv.py:218-276``):
input windows on every axis (`api._prefix_keep_all`) are read only where
kept (the outer axes' forward passes on `fft_strided`'s windowed entry,
the minor pair's (ky, kz) corner read in place by `fft_conv_pair`'s
windowed 2-D entry), and output windows of the two minor axes
(`api._pair_prefix_keep`) are written only where kept, the rest zeros
restored once at the end; every other mode and window, and the
composition, mask (`api.apply_zeropad`) before the forward and after the
inverse.  ``keep_intermediate_order`` leaves a convolution as it is, as in
the JAX package.

Inputs follow the port's conventions: a ``Planar`` gives a ``Planar`` on its
device, a torch tensor (complex, or real read as complex) a complex tensor,
a host array (placed on ``device`` as float32) a numpy complex array.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from vkfft_tpu_torch import api
from vkfft_tpu_torch.config import FFTConfig, config_from_reference
from vkfft_tpu_torch.errors import InvalidConfigError
from vkfft_tpu_torch.ops import cuda_engine as ce
from vkfft_tpu_torch.pcomplex import (Planar, from_complex, from_numpy_planar,
                                      to_complex, to_numpy, widened)
from vkfft_tpu_torch.planner.plan import plan_axis


def _as_planar(x, device) -> tuple[Planar, str]:
    """(planes, kind of the input) with kind "planar", "tensor" or "host";
    host input goes to ``device`` as float32 (``_as_planar``, :29)."""
    if isinstance(x, Planar):
        return x, "planar"
    if isinstance(x, torch.Tensor):
        return from_complex(x), "tensor"
    return from_complex(np.asarray(x), api.resolve_device(device)), "host"


def _as_kind(p: Planar, kind: str):
    if kind == "planar":
        return p
    return to_complex(p) if kind == "tensor" else to_numpy(p)


def fftconvolve(x, h, axes: Optional[Sequence[int]] = None,
                engine: Optional[str] = None, device="cuda"):
    """Circular convolution of ``x`` with ``h`` over ``axes`` (default the
    trailing ``h.ndim`` axes) via the FFT (``fftconvolve``, :42).  A host
    ``h`` goes to the device of ``x``."""
    xp, kind = _as_planar(x, device)
    hp, _ = _as_planar(h, xp.device)
    if axes is None:
        axes = tuple(range(-hp.ndim, 0))
    X = api.fftn(xp, axes=axes, engine=engine)
    H = api.fftn(hp, axes=axes, engine=engine)
    return _as_kind(api.ifftn(X * H, axes=axes, engine=engine), kind)


def _planar_einsum(subs: str, K: Planar, X: Planar) -> Planar:
    """Complex einsum via four real einsums (``_planar_einsum``, :54)."""
    def e(a, b):
        return torch.einsum(subs, a, b)

    return Planar(e(K.re, X.re) - e(K.im, X.im), e(K.re, X.im) + e(K.im, X.re))


class ConvolutionApplication:
    """Planned convolution (reference: ``performConvolution`` +
    ``kernelConvolution`` app pair; ``ConvolutionApplication``, :63).

    The kernel is transformed once at construction with the port's `fftn`
    (pass ``kernel_in_freq_domain=True`` for a spectrum).  Shapes, with
    ``S = config.shape``, ``m = config.matrix_convolution`` and ``K =
    config.number_kernels``:

      scalar (m == 1): kernel (*S) or (coordinate_features, *S), with a
        leading (K,) when K > 1; data (batch..., [coordinate_features,]
        *S); output as data, with a leading (K,) when K > 1.
      matrix (m in {2, 3}): kernel ([K,] m, m, *S); data (batch..., m, *S);
        output (batch..., m, *S), with a leading (K,) when K > 1.

    ``engine``: "cuda", "torch", or None to pick by each call's planes;
    ``device``: where host input goes.  The CUDA engine runs the fused mode
    `fusion_mode` names (`cuda_engine.conv_route`); the torch engine, and
    the CUDA engine where no mode holds, run the composition."""

    def __init__(self, config: FFTConfig, kernel, engine: Optional[str] = None,
                 kernel_in_freq_domain: bool = False, device="cuda"):
        if not config.convolution:
            raise InvalidConfigError("config.convolution must be True")
        if engine is not None and engine not in api.ENGINES:
            raise InvalidConfigError(f"unknown engine {engine!r}")
        self.config = config
        self.engine = engine
        self.device = torch.device(device)
        m = config.matrix_convolution
        shape = config.shape
        ndim = len(shape)
        kp, _ = _as_planar(kernel, device)
        if m > 1 and kp.shape[-ndim - 2: -ndim] != (m, m):
            raise InvalidConfigError(
                f"matrix kernel must have shape (..., {m}, {m}, *{shape}), "
                f"got {kp.shape}")
        if kp.shape[-ndim:] != shape:
            raise InvalidConfigError(
                f"kernel must end with transform shape {shape}, got "
                f"{kp.shape}")
        if config.number_kernels > 1 and kp.shape[0] != config.number_kernels:
            raise InvalidConfigError(
                "kernel leading dim must be number_kernels="
                f"{config.number_kernels}")
        if kernel_in_freq_domain:
            self.kernel_f = kp
        else:
            self.kernel_f = api.fftn(kp, axes=tuple(range(-ndim, 0)),
                                     engine=engine)
        self._mode = (None if engine == "torch"
                      else ce.conv_route(config, self.kernel_f.ndim))
        self._tables: dict = {}   # (what, device, dtype) -> kernel_f there

    @property
    def fusion_mode(self) -> Optional[str]:
        """The fused mode a call on the CUDA engine runs: ``'v3_1d'``,
        ``'v2_2k'``, ``'pair'``, ``'v3_rows'`` or ``'v3_mat'``, or None for
        the composition; always None with engine "torch".  With engine
        None it describes calls on the card's planes: planes on the CPU
        pick the torch engine, which runs the composition."""
        return self._mode

    def _table(self, what: str, device, dtype=torch.float32):
        """``kernel_f`` on ``device``, made once: "kernel" as planes of
        ``dtype`` for the composition, "fused" as the fused mode's table
        (`cuda_engine.conv_spectrum`: conjugated for a conjugated kernel, in
        `fft_twofactor`'s swapped order for `v2_2k`)."""
        key = (what, str(device), dtype)
        if key not in self._tables:
            kf = self.kernel_f
            kf = Planar(kf.re.to(device, dtype), kf.im.to(device, dtype))
            if what == "fused":
                kf = ce.conv_spectrum(
                    kf, conj=self.config.conjugate_convolution == 1,
                    swapped=self._mode == "v2_2k")
            self._tables[key] = kf
        return self._tables[key]

    def _pair_windows(self):
        """(input keeps, output keep) of the "pair" mode's elided windows
        (``_convolve``, :218-236): `api._prefix_keep_all` of the input
        windows ((ky, kz), {outer axis: kept}), `api._pair_prefix_keep` of
        the output windows ((oy, oz)); None for a window the kernels do
        not elide, which is masked."""
        cfg = self.config
        keeps = (None if cfg.zeropad_input is None
                 else api._prefix_keep_all(cfg.zeropad_input, cfg.shape))
        keep = (None if cfg.zeropad_output is None
                else api._pair_prefix_keep(cfg.zeropad_output, cfg.shape))
        return keeps, keep

    def _fused_call(self, x: Planar, owned, keeps=None,
                    keep_out=None) -> Planar:
        """The fused mode on the card (``_convolve``, :238-307); ``owned``
        tells planes the call made, which a pass may write over.  The
        "pair" mode's elided windows (`_pair_windows`): ``keeps`` read only
        the kept corner, ``keep_out`` writes only its corner and restores
        the zeros once at the end."""
        cfg = self.config
        mode = self._mode
        spec = self._table("fused", x.device)
        shape = cfg.shape
        ndim, n = len(shape), shape[-1]
        total = math.prod(shape)
        kw = dict(conj_data=cfg.conjugate_convolution == 2,
                  xpow=bool(cfg.cross_power_spectrum_normalization))
        if mode in ("v2_2k", "v3_1d"):
            lines = x.reshape(-1, n)
            if mode == "v2_2k":
                y = ce.conv_fused_planar(lines, n, spec, donate=owned(lines))
            else:
                y = ce.conv_fused_v3(lines, n, spec, scale=1.0 / n,
                                     donate=owned(lines), **kw)
            return y.reshape(*x.shape)
        if mode == "v3_mat":
            m = cfg.matrix_convolution
            planes = x.reshape(-1, m, n)
            y = ce.conv_fused_v3_matrix(planes, n, m, spec, scale=1.0 / n,
                                        donate=owned(planes), **kw)
            return y.reshape(*x.shape)
        # N-D: the outer axes forward, the fused minor axis (v3_rows) or
        # pair, the outer axes inverse (:256-299); the 1/N rides the fused
        # pass's inverse
        inner = 2 if mode == "pair" else 1
        off = x.ndim - ndim
        outer = range(ndim - inner)
        pair_in, outer_in = keeps or ((0, 0), {})
        ny = shape[-2]
        if keeps is not None and outer:
            # the outer passes on the kept corner of the minor pair only,
            # read in place
            x = x[..., :pair_in[0] or ny, :pair_in[1] or n]
        for ax in outer:
            if keeps is None:
                x = ce.fft_axis_p(x, off + ax, plan_axis(shape[ax]), False,
                                  donate=owned(x))
            else:
                x = ce.axis_window(x, off + ax, plan_axis(shape[ax]), False,
                                   in_keep=outer_in.get(ax, 0))
        if mode == "pair":
            x = ce.conv_fused_pair(x, ny, n, spec, scale=1.0 / total,
                                   donate=owned(x), in_keep=pair_in,
                                   out_keep=keep_out, **kw)
        else:
            lines = x.reshape(-1, n)
            x = ce.conv_fused_v3_rows(
                lines, n, total // n, spec, scale=1.0 / total,
                donate=owned(lines), **kw).reshape(*x.shape)
        for ax in reversed(outer):
            x = ce.fft_axis_p(x, off + ax, plan_axis(shape[ax]), True,
                              donate=owned(x))
        if keep_out is not None:
            x = api._pad_planar_tail(
                x, [(0, shape[a]) for a in outer]
                + [(keep_out[0], ny), (keep_out[1], n)])
        return x

    def _composition(self, x: Planar, engine: str) -> Planar:
        """fftn, the multiply and ifftn (``_convolve``, :309-335).  Half
        planes run the forward at their dtype, then the multiply and the
        inverse in fp32, as the JAX package computes them; the result is
        narrowed once to the data's dtype, as the fused modes' is (the JAX
        package's composition returns float32 there)."""
        cfg = self.config
        ndim = len(cfg.shape)
        m = cfg.matrix_convolution
        multi = cfg.number_kernels > 1
        axes = tuple(range(-ndim, 0))
        X = api.fftn(x, axes=axes, engine=engine)
        dt = X.dtype
        X = widened(X)
        Kf = self._table("kernel", X.device, X.dtype)
        if cfg.conjugate_convolution == 1:
            Kf = Kf.conj()
        elif cfg.conjugate_convolution == 2:
            X = X.conj()
        freq = "uvw"[:ndim]
        if m > 1:
            subs = (f"koi{freq},...i{freq}->k...o{freq}" if multi
                    else f"oi{freq},...i{freq}->...o{freq}")
            Y = _planar_einsum(subs, Kf, X)
        elif multi:
            pad = X.ndim - (Kf.ndim - 1)
            Kb = Kf.reshape(*(Kf.shape[:1] + (1,) * pad + Kf.shape[1:]))
            Y = Kb * Planar(X.re[None], X.im[None])
        else:
            Y = Kf * X   # trailing-dim broadcasting covers coord features
        if cfg.cross_power_spectrum_normalization:
            mag = torch.sqrt(Y.re * Y.re + Y.im * Y.im)
            Y = Y * (1.0 / torch.clamp_min(mag, 1e-30))
        return api.ifftn(Y, axes=axes, engine=engine).astype(dt)

    def _convolve(self, x: Planar) -> Planar:
        cfg = self.config
        ndim = len(cfg.shape)
        want = cfg.shape if cfg.matrix_convolution == 1 else (
            (cfg.matrix_convolution,) + cfg.shape)
        if x.shape[x.ndim - len(want):] != want:
            raise InvalidConfigError(
                f"input trailing shape {x.shape[x.ndim - len(want):]} != "
                f"configured {want}")
        owned = api.owned_by_walk(x.re, x.im)
        engine = self.engine or api.engine_for(x)
        fused = self._mode is not None and engine == "cuda"
        keeps = keep_out = None
        if fused and self._mode == "pair":
            keeps, keep_out = self._pair_windows()
        if keeps is None:
            x = api.apply_zeropad(x, cfg.zeropad_input, ndim)
        if fused:
            y = self._fused_call(x, owned, keeps, keep_out)
        else:
            y = self._composition(x, engine)
        if keep_out is None:
            y = api.apply_zeropad(y, cfg.zeropad_output, ndim)
        return y

    def __call__(self, x):
        """Convolve ``x`` with the kernel (``__call__``, :341); the input
        is never written over."""
        xp, kind = _as_planar(x, self.device)
        return _as_kind(self._convolve(xp), kind)


def convolution_from_reference(config_fields: dict, kernel_f_re, kernel_f_im,
                               engine: Optional[str] = None,
                               device="cuda") -> ConvolutionApplication:
    """The port's application for a JAX package's one: ``config_fields`` is
    ``dataclasses.asdict`` of its config, ``kernel_f_re``/``kernel_f_im``
    the planes of its ``kernel_f`` as host arrays (the state that crosses
    between the packages), taken as the spectrum."""
    cfg = config_from_reference(dict(config_fields))
    kf = from_numpy_planar(np.asarray(kernel_f_re), np.asarray(kernel_f_im),
                           api.resolve_device(device))
    return ConvolutionApplication(cfg, kf, engine=engine,
                                  kernel_in_freq_domain=True, device=device)


__all__ = ["ConvolutionApplication", "fftconvolve",
           "convolution_from_reference"]

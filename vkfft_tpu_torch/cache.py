"""Plan and binary caching — the reference's checkpoint/resume subsystem
(port of ``vkfft_tpu/cache.py``).

The reference serializes every compiled kernel binary into one blob
(``saveApplicationToString``, ``vkFFT_InitializeApp.h:1726-1845``) and skips
compilation on reload (``vkFFT_CompileKernel.h:43-55``).  Here:

  1. The build cache (``enable_persistent_cache``): the kernels' libraries,
     compiled by ``nvcc`` at first use (`ops.cuda_kernels.build_kernels`),
     and the native planner core's (`planner.native`), keyed on disk by a
     hash of their sources and flags; a process that finds them loads them
     and runs no compiler.  The counterpart of the JAX package's XLA
     persistent cache.
  2. Plan serialization (``save_plan``/``load_plan``): the host-side
     factorization decisions as a *declarative JSON document* (unlike
     pickle it cannot execute code on load): config fields + per-axis (n,
     algorithm, radices), rebuilt through ``plan_axis`` and cross-checked.
     The blob is byte for byte the JAX package's for the same config (the
     two ``FFTConfig``s have the same fields), so a blob written by either
     package loads in the other: with ``config.config_from_reference`` it
     is the state that crosses between them (an FFT has no weights).
  3. ``save_executable``: None, as the JAX package returns where its
     backend declines; the port's binaries are the build cache's
     libraries.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

from vkfft_tpu_torch.config import FFTConfig, Precision, TransformKind
from vkfft_tpu_torch.planner.plan import AxisPlan, plan_axis

_MAGIC = b"VKFFT-TPU-PLAN\x00"
_VERSION = 2


def enable_persistent_cache(path: str) -> None:
    """Build and load the kernels' libraries (`cuda_kernels.BUILD_DIR`) and
    the native planner core (`native.BUILD_DIR`) in the directory ``path``
    from now on (created if missing): a process that finds them there
    loads them and runs no compiler.  Libraries this process already
    loaded stay loaded.  The counterpart of XLA's on-disk cache."""
    from vkfft_tpu_torch.ops import cuda_kernels
    from vkfft_tpu_torch.planner import native

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    cuda_kernels.BUILD_DIR = path
    native.set_build_dir(path)


def _config_to_dict(config: FFTConfig) -> dict:
    d = dataclasses.asdict(config)
    d["kind"] = config.kind.value
    d["precision"] = config.precision.value
    return d


def _maybe_tuple(v):
    if isinstance(v, list):
        return tuple(_maybe_tuple(x) for x in v)
    return v


def _config_from_dict(d: dict) -> FFTConfig:
    known = {f.name for f in dataclasses.fields(FFTConfig)}
    kw: dict[str, Any] = {}
    for key, val in d.items():
        if key not in known:
            continue  # forward compatibility: ignore unknown fields
        if key == "kind":
            val = TransformKind(val)
        elif key == "precision":
            val = Precision(val)
        else:
            val = _maybe_tuple(val)
        kw[key] = val
    return FFTConfig(**kw)


def save_plan(config: FFTConfig, plans: dict[int, AxisPlan]) -> bytes:
    """Serialize an application's planning state (config + per-axis plans)
    as a passive JSON document — safe to load from untrusted sources."""
    payload = {
        "version": _VERSION,
        "config": _config_to_dict(config),
        "plans": {
            str(ax): {
                "n": p.n,
                "algorithm": p.algorithm.value,
                "radices": [s.r for s in p.stages],
            }
            for ax, p in plans.items()
        },
    }
    return _MAGIC + json.dumps(payload).encode("utf-8")


def load_plan(blob: bytes) -> tuple[FFTConfig, dict[int, AxisPlan]]:
    """The config and per-axis plans of a blob, each axis replanned by this
    planner; raises ValueError for a foreign blob, another version, or an
    axis this planner gives another algorithm or other radices."""
    if not blob.startswith(_MAGIC):
        raise ValueError("not a vkfft_tpu plan blob")
    payload = json.loads(blob[len(_MAGIC):].decode("utf-8"))
    if payload["version"] != _VERSION:
        raise ValueError(f"unsupported plan version {payload['version']}")
    config = _config_from_dict(payload["config"])
    plans: dict[int, AxisPlan] = {}
    for ax_str, rec in payload["plans"].items():
        plan = plan_axis(int(rec["n"]))
        if plan.algorithm.value != rec["algorithm"]:
            raise ValueError(
                f"plan blob algorithm {rec['algorithm']!r} for n={rec['n']} "
                f"does not match this planner ({plan.algorithm.value!r})")
        radices = tuple(s.r for s in plan.stages)
        if tuple(rec["radices"]) != radices:
            raise ValueError(
                f"plan blob radices {tuple(rec['radices'])} for n={rec['n']} "
                f"do not match this planner's {radices}")
        plans[int(ax_str)] = plan
    return config, plans


def save_application_to_string(app) -> bytes:
    """``saveApplicationToString`` analog: serialize the app's planning
    state.  Compiled binaries ride the build cache instead of the blob."""
    return save_plan(app.config, app.axis_plans)


def load_application_from_string(blob: bytes, engine: Optional[str] = None,
                                 device="cuda"):
    """``loadApplicationFromString`` analog: rebuild an ``FFTApplication``
    from a plan blob.  The application is built the normal way from the
    blob's config, so it carries every route its constructor sets up
    (``double_route``, the zero-pad and kept-order routes), and its plans
    are checked against the blob's (ValueError where they differ).  The
    kernels load from the build cache on first use."""
    from vkfft_tpu_torch.api import FFTApplication

    config, plans = load_plan(blob)
    app = FFTApplication(config, engine=engine, device=device)
    mine = {ax: p.cache_key() for ax, p in app.axis_plans.items()}
    theirs = {ax: p.cache_key() for ax, p in plans.items()}
    if mine != theirs:
        raise ValueError(f"plan blob's axis plans {theirs} do not match "
                         f"the application's {mine}")
    return app


def save_executable(fn, *example_args) -> Optional[bytes]:
    """Ahead-of-time executable serialization: None, as the JAX package's
    returns where its backend declines.  The port's executables are the
    build cache's libraries (`enable_persistent_cache`), which a process
    loads instead of compiling."""
    return None

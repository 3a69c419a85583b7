"""Debug observability — ``keepShaderCode`` / ``printMemoryLayout`` analogs
(port of ``vkfft_tpu/debug.py``).

The reference can dump each generated kernel's source at execution
(``keepShaderCode``, ``vkFFT_RunApp.h:59``) and print which buffer each pass
reads/writes (``printMemoryLayout``, ``:60-77``).  Here ``describe`` prints
the plan structure and the route of kernels the CUDA engine runs
(`cuda_engine.route`), ``memory_layout`` narrates the pass/buffer schedule,
``dump_kernels`` lists the kernels one call launches (the launch counters
of `ops.cuda_kernels`) with the ``csrc/`` sources and ``nvcc`` flags each is
built from, and ``profile_trace`` records a ``torch.profiler`` trace."""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Optional

import torch

from vkfft_tpu_torch.planner.factorize import Algorithm
from vkfft_tpu_torch.planner.plan import AxisPlan, plan_axis


def _route_lines(plan: AxisPlan) -> list[str]:
    """The CUDA engine's kernels for one direction of a C2C line of
    ``plan`` (`cuda_engine.route`), with the split each kernel runs."""
    from vkfft_tpu_torch.ops import cuda_engine as ce
    from vkfft_tpu_torch.ops import cuda_kernels as ck
    try:
        steps = ce.route(plan)
    except ValueError as e:
        return [f"  cuda route: none ({e})"]
    if not steps:
        return ["  cuda route: tensor ops (n <= 4)"]
    lines = ["  cuda route (c2c, one direction): "
             + " -> ".join(f"{k}({length})" for k, _, length in steps)]
    for kernel, length in dict.fromkeys((k, n) for k, _, n in steps):
        if kernel == "fft_twofactor":
            threads, per_block, smem = ck.twofactor_layout(length)
            n1, n2 = ck.twofactor_split(length)
            lines.append(f"    fft_twofactor({length}) split n1={n1} x "
                         f"n2={n2}; layout: {threads} threads, {per_block} "
                         f"lines a block, {smem} B shared")
        elif kernel == "fft_lines":
            n1, n2 = ck.lines_split(length)
            lines.append(f"    fft_lines({length}) split {n1} x {n2}")
        elif kernel == "fft_conv_pair":
            nc, ns, cluster = ck.conv_pair_plan(length)
            lines.append(f"    fft_conv_pair({length}) plane {nc} x {ns}, "
                         f"cluster {cluster}")
    return lines


def describe_axis(plan: AxisPlan) -> str:
    d = plan.decomp
    lines = [f"axis n={plan.n}: algorithm={d.algorithm.value}"]
    if d.algorithm is Algorithm.SPLIT:
        a, b = d.split
        lines.append(f"  cooley-tukey split {a} x {b}; factor plans:")
        for f in (a, b):
            sub = describe_axis(plan_axis(f))
            lines.extend("    " + ln for ln in sub.splitlines())
        lines.extend(_route_lines(plan))
        return "\n".join(lines)
    if d.algorithm is Algorithm.BLUESTEIN:
        lines.append(f"  bluestein padded size m={d.bluestein_size}")
    if d.algorithm is Algorithm.RADER:
        lines.append(f"  rader prime p={d.rader_prime} (convolution length {plan.n - 1})")
    lines.append(f"  core length {plan.core_n}, stages: "
                 + " -> ".join(f"r{s.r}(L={s.L},M'={s.Mp})" for s in plan.stages))
    lines.append(f"  cost model: {sum(s.r for s in plan.stages)} MACs/point")
    lines.extend(_route_lines(plan))
    return "\n".join(lines)


def describe(app) -> str:
    """Plan dump for an FFT/Convolution application (keepShaderCode-class
    introspection)."""
    if hasattr(app, "fusion_mode"):  # ConvolutionApplication
        cfg = app.config
        return (f"ConvolutionApplication shape={cfg.shape} "
                f"matrix={cfg.matrix_convolution} "
                f"number_kernels={cfg.number_kernels} "
                f"fusion={app.fusion_mode or 'none (composition: fftn, multiply, ifftn)'}")
    cfg = app.config
    out = [f"FFTApplication shape={cfg.shape} axes={cfg.axes} "
           f"engine={app.engine_name} kind={cfg.kind.value} "
           f"precision={cfg.precision.value}"]
    if app.double_route is not None:
        out[0] += f" double_route={app.double_route}"
    zp = app.zeropad_mode
    if zp is not None:
        out[0] += f" zeropad={zp}"
    if cfg.keep_intermediate_order:
        out[0] += " keep_intermediate_order"
    for ax, plan in sorted(app.axis_plans.items()):
        out.append(describe_axis(plan).replace("axis ", f"axis {ax}: ", 1))
    return "\n".join(out)


def memory_layout(app) -> str:
    """``printMemoryLayout`` analog: which logical buffer each pass touches
    (input -> per-axis passes -> output); the walk writes a pass in place
    over planes it made itself."""
    cfg = app.config
    rows = []
    src = "input"
    for ax in cfg.axes:
        plan = app.axis_plans[ax]
        extra = ""
        if plan.algorithm is Algorithm.BLUESTEIN:
            extra = f" (+chirp/b_fft tables, temp len {plan.decomp.bluestein_size})"
        elif plan.algorithm is Algorithm.RADER:
            extra = f" (+g-power tables, conv len {plan.n - 1})"
        rows.append(f"pass axis{ax}: read {src} -> write temp{ax}{extra}")
        src = f"temp{ax}"
    rows.append(f"final: {src} -> output")
    return "\n".join(rows)


def launch_counts() -> dict:
    """Every launch counter of `cuda_kernels`, by C entry name (an fp64
    instantiation as ``<kernel>_f64``)."""
    from vkfft_tpu_torch.ops import cuda_kernels as ck
    out = dict(ck.launches)
    out.update({k + "_f64": v for k, v in ck.f64_launches.items()})
    for counts in (ck.storage_launches, ck.zp_launches, ck.tl_launches):
        out.update(counts)
    return out


def launched(fn, *args) -> dict:
    """{entry: launches} of the kernels one call ``fn(*args)`` launches,
    read from the launch counters (which it leaves counting)."""
    before = launch_counts()
    fn(*args)
    after = launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def library_of(entry: str) -> str:
    """The library (``csrc/<library>.cu``) that holds C entry ``entry``."""
    from vkfft_tpu_torch.ops import cuda_kernels as ck
    base = entry
    for tag in ("_zp", "_tl"):
        if tag in base:
            base = base[:base.index(tag)]
    for suffix in ("_f64", "_f16", "_bf16"):
        if base.endswith(suffix):
            base = base[:-len(suffix)]
    return ck.STORAGE_LIBRARY.get(base, base)


def sources_of(library: str) -> list[str]:
    """``csrc/<library>.cu`` and every ``csrc/`` header it includes."""
    from vkfft_tpu_torch.ops import cuda_kernels as ck
    seen, todo = [], [library + ".cu"]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        with open(os.path.join(ck.CSRC_DIR, name)) as f:
            todo += re.findall(r'^\s*#include\s+"([^"]+)"', f.read(), re.M)
    return ["csrc/" + s for s in seen]


def dump_kernels(app, x, inverse: bool = False) -> str:
    """The kernels one ``app.forward(x)`` (``app.inverse(x)``) launches, by
    C entry and count from the launch counters, each with the ``csrc/``
    sources and the ``nvcc`` command its library is built from (the
    ``keepShaderCode`` analog; planes on the CPU run the kernels' plain
    versions and launch none)."""
    from vkfft_tpu_torch.ops import cuda_kernels as ck
    counts = launched(app.inverse if inverse else app.forward, x)
    what = "inverse" if inverse else "forward"
    out = [f"{what}: {sum(counts.values())} kernel launches"]
    if not counts:
        out[0] += " (planes on the CPU run the plain versions)"
    for entry, count in counts.items():
        lib = library_of(entry)
        out.append(f"{entry} x{count}: C entry vk_{entry} of {lib}")
        out.append(f"  sources: {' '.join(sources_of(lib))}")
        out.append(f"  build: nvcc {' '.join(ck.NVCC_FLAGS)} -o "
                   f"{ck.library_path(lib)} csrc/{lib}.cu")
    return "\n".join(out)


def profile_trace(fn, *args, outdir: Optional[str] = None,
                  iters: int = 5) -> str:
    """Record a ``torch.profiler`` trace (CPU and, with a card, CUDA
    activities, Python stacks) of ``iters`` calls of ``fn(*args)`` after
    one warm-up call, written as a Chrome trace ``outdir/trace.json`` (a
    new temporary directory when ``outdir`` is None).  Returns the outdir;
    `device_ops` reads its device kernels back."""
    import torch.profiler as tp
    cuda = torch.cuda.is_available()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    fn(*args)
    sync()
    outdir = outdir or tempfile.mkdtemp(prefix="vkfft_tpu_torch_trace")
    os.makedirs(outdir, exist_ok=True)
    acts = [tp.ProfilerActivity.CPU] + ([tp.ProfilerActivity.CUDA]
                                        if cuda else [])
    with tp.profile(activities=acts, with_stack=True) as prof:
        for _ in range(iters):
            fn(*args)
        sync()
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))
    return outdir


def trace_events(outdir: str) -> list:
    """The events of `profile_trace`'s Chrome trace in ``outdir``."""
    with open(os.path.join(outdir, "trace.json")) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def device_ops(outdir: str) -> list[tuple[str, float, int]]:
    """(name, total ms, count) of each device kernel of the trace in
    ``outdir``, longest first."""
    total: dict = {}
    for e in trace_events(outdir):
        if e.get("cat") == "kernel":
            ms, n = total.get(e["name"], (0.0, 0))
            total[e["name"]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    return sorted(((k, ms, n) for k, (ms, n) in total.items()),
                  key=lambda r: -r[1])

"""The port's CLI (``vkfft_tpu_torch.cli``) on the CPU, held against the JAX
package's (``vkfft_tpu.cli``).

The port's samples run in this process through ``cli.main([..., "--cpu"])``
with their output captured.  The JAX CLI runs in subprocesses with
``--cpu`` (its ``main`` sets JAX's global flags), all started together in
one module fixture when the first test asks for it, so they run while the
port's own tests do; each comparison then reads its sample's output.  The
JAX sample 51 benchmarks 128 MiB after its check, so its process is
stopped once the check's line is out.  The benchmark samples run at about
1 MiB (their byte targets and system lists patched): their rows must be
finite, and nothing here asserts on a time.
"""
import contextlib
import io
import math
import os
import pathlib
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from vkfft_tpu_torch import cli

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 900

# tests/test_cli.py's samples, then the precision and sweep samples that
# the port runs fast enough here
SAMPLES = (11, 12, 13, 14, 15, 16, 17, 18, 50, 51, 52, 10, 19, 1002, 1003,
           1004)
# those whose JAX CLI run is held beside the port's.  Not 11, 16, 17, 19
# and 1003: the JAX CLI takes 50, 26, 20, 127 and 75 s alone on 8 cores
# (19 and 1003 run its dd Pallas kernel in interpret mode), and in the
# contention of a six-worker run of the whole suite this file took 977 s
# with them.  11's 1-D and N-D systems are held to the JAX package below
# (`_run_fft_host`), its long ones to numpy fp64 by the sample's own gate;
# fft_dd and the DCT/DST against the JAX package are
# tests/test_torch_dd.py's and tests/test_torch_r2r.py's.
COMPARED = (12, 13, 14, 15, 18, 50, 51, 52, 10, 1002, 1004)
# each sample's gate on its figures (sample 13: by tier)
GATES = {12: 1e-12, 14: 1e-3, 15: 1e-4, 18: 1e-12, 50: 1e-4, 51: 1e-4,
         52: 1e-4, 1002: 8e-2, 1004: 1e-4}
TIER_GATES = {"bfloat16": 8e-2, "half": 1e-2}
DOUBLE_SAMPLES = (12, 18)   # fp64 figures
# the JAX process is stopped after this line of its sample
STOP_AFTER = {51: "matrix conv rel err"}
BLOB_ARGS = ["-vkfft", "200", "-X", "64", "-B", "2", "-N", "2"]

_ROW = re.compile(r"^  (?P<name>.+?): avg_diff \S+  max_diff \S+  "
                  r"avg_eps \S+  max_eps (?P<eps>\S+)$")
_ERR = re.compile(r"(?:rel err|max err):? (?P<eps>[0-9.e+-]+)")
_MS = re.compile(r"(\S+) ms")


def figures(text: str) -> list:
    """(system, error figure) of each row of a sample's output, in order:
    the per-system max_eps rows, and the one error of the convolution and
    sweep samples."""
    rows = []
    for line in text.splitlines():
        m = _ROW.match(line)
        if m:
            rows.append((m["name"], float(m["eps"])))
            continue
        m = _ERR.search(line)
        if m:
            rows.append(("summary", float(m["eps"])))
    return rows


def run_port(*argv) -> tuple:
    """(returncode, stdout) of the port's CLI in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*map(str, argv), "--cpu"])
    return rc, buf.getvalue()


_PORT_RUNS = {}


def port_sample(num: int) -> tuple:
    """`run_port` of sample ``num``, run once for this module's tests."""
    if num not in _PORT_RUNS:
        _PORT_RUNS[num] = run_port("-vkfft", num)
    return _PORT_RUNS[num]


def assert_green(rc: int, out: str) -> None:
    assert rc == 0, out
    assert "FAIL" not in out, out
    assert out.strip().splitlines()[-1].startswith("  done in"), out


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch's CPU ops on one thread for each test, restored after: the
    samples make many small calls, which under a parallel test run's
    oversubscribed cores took 100x their time on the default threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    """The benchmarks at about 1 MiB, with small cubes, 4 timed calls a
    row."""
    for name in ("TARGET_BYTES", "SMALL_TARGET_BYTES", "DCT_ND_BYTES",
                 "FP64_BLUESTEIN_BYTES"):
        monkeypatch.setattr(cli, name, 1 << 20)
    monkeypatch.setattr(cli, "SAMPLE_3_SYSTEMS",
                        [(16, 16, 16), (24, 24, 24), (32, 32, 32)])
    monkeypatch.setattr(cli, "SAMPLE_4_SYSTEMS", [(64, 128), (32, 32, 32)])
    monkeypatch.setattr(cli, "ITERS", 4)


class _Run:
    """A JAX CLI subprocess whose stdout a thread reads to its end, or to
    the line after which the process is stopped."""

    def __init__(self, argv, env, stop=None):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "vkfft_tpu.cli", *argv, "--cpu"],
            cwd=str(ROOT), env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        self.lines, self.stopped = [], False
        self.thread = threading.Thread(target=self._read, args=(stop,),
                                       daemon=True)
        self.thread.start()

    def _read(self, stop):
        for line in self.proc.stdout:
            self.lines.append(line)
            if stop and stop in line:
                self.stopped = True
                self.proc.kill()
                break

    def result(self) -> tuple:
        """(returncode, stdout, stderr); returncode 0 for a stopped run."""
        self.thread.join(TIMEOUT_S)
        _, err = self.proc.communicate(timeout=TIMEOUT_S)
        return (0 if self.stopped else self.proc.returncode,
                "".join(self.lines), err)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """{key: _Run} of the JAX CLI: each compared sample, and sample 200
    saving a plan blob and loading the port's.  Started together; the
    port's blob is written first."""
    work = tmp_path_factory.mktemp("cli")
    port_blob, jax_blob = work / "port.blob", work / "jax.blob"
    rc, out = run_port(*BLOB_ARGS, "-save", port_blob)
    assert rc == 0 and port_blob.exists(), out
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    runs = {s: _Run(["-vkfft", str(s)], env, STOP_AFTER.get(s))
            for s in COMPARED}
    runs["save"] = _Run(BLOB_ARGS + ["-save", str(jax_blob)], env)
    runs["load"] = _Run(BLOB_ARGS + ["-load", str(port_blob)], env)
    runs["blobs"] = (port_blob, jax_blob)
    yield runs
    for key, run in runs.items():
        if key != "blobs":
            run.kill()


def test_sample_numbers_match_jax(jax_runs):
    """The port has the JAX CLI's 31 samples (and starts the JAX runs)."""
    from vkfft_tpu import cli as jax_cli
    assert sorted(cli._SAMPLES) == sorted(jax_cli._SAMPLES)
    assert len(cli._SAMPLES) == 31


def test_list():
    rc, out = run_port("-list")
    assert rc == 0
    nums = [int(ln.split()[0]) for ln in out.splitlines()[1:]]
    assert nums == sorted(cli._SAMPLES)


def test_devices_cpu():
    rc, out = run_port("-devices")
    assert rc == 0
    assert out.strip().startswith("device 0: cpu"), out


def test_without_cpu_and_card_fails(monkeypatch, capsys):
    """No CUDA device and no --cpu: a non-zero exit naming --cpu, and no
    sample output."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["-vkfft", "12"]) != 0
    cap = capsys.readouterr()
    assert "--cpu" in cap.err
    assert "sample 12" not in cap.out


@pytest.mark.parametrize("num", SAMPLES)
def test_port_sample(num):
    """Each sample green on the CPU: rc 0, no FAIL, its summary PASS."""
    rc, out = port_sample(num)
    assert_green(rc, out)
    verdicts = [ln for ln in out.splitlines() if "PASS" in ln]
    assert verdicts, out


@pytest.mark.parametrize("num", COMPARED)
def test_port_matches_jax(jax_runs, num):
    """The same systems in the same order as the JAX CLI's, each under its
    gate and at most 4x the JAX figure plus 1e-6 (fp32) or 1e-14 (fp64,
    double-double)."""
    rc, out = port_sample(num)
    assert_green(rc, out)
    jrc, jout, jerr = jax_runs[num].result()
    assert jrc == 0, jout + jerr
    mine, theirs = figures(out), figures(jout)
    assert [n for n, _ in mine] == [n for n, _ in theirs], (out, jout)
    assert "PASS" in jout and "FAIL" not in jout, jout
    assert mine or num == 10, out   # sample 10 prints no figure
    slack = 1e-14 if num in DOUBLE_SAMPLES else 1e-6
    for (name, eps), (_, ref) in zip(mine, theirs):
        gate = GATES.get(num) or TIER_GATES[name.split()[0]]
        assert eps < gate, (num, name, eps)
        assert eps <= 4 * ref + slack, (num, name, eps, ref)


def _host_systems():
    from vkfft_tpu.cli import (_PRECISION_SYSTEMS_1D, _PRECISION_SYSTEMS_ND)
    cases = [(shape, 1, None) for shape in
             _PRECISION_SYSTEMS_1D + _PRECISION_SYSTEMS_ND]
    cases += [((3, n), n, (-1,)) for n in
              (17, 31, 61, 67, 97, 101, 257, 641, 1009, 10007)]
    return cases


@pytest.mark.parametrize("shape,seed,axes", _host_systems(),
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_run_fft_host_matches_jax(shape, seed, axes):
    """`_run_fft_host` of both packages on sample 11's 1-D and N-D systems
    and sample 14's primes to 10007, within 1e-5 of max|JAX|."""
    from vkfft_tpu import cli as jax_cli
    x = cli._rand_complex(shape, seed=seed)
    got = cli._run_fft_host(x, None, axes=axes, device="cpu")
    ref = np.asarray(jax_cli._run_fft_host(x, None, axes=axes))
    assert got.shape == ref.shape and got.dtype == np.complex64
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("flags", [["-R2C", "1"], ["-DCT", "2"], ["-P", "1"],
                                   ["-Y", "16"]],
                         ids=["r2c", "dct2", "fp64", "c2c_2d"])
def test_user_benchmark(flags):
    rc, out = run_port("-vkfft", 200, "-X", 64, "-B", 4, "-N", 2, *flags)
    assert_green(rc, out)
    ms = [float(v) for v in _MS.findall(out)]
    assert len(ms) == 1 and math.isfinite(ms[0]) and ms[0] > 0, out


def test_blob_port_to_jax(jax_runs):
    """The port's -save blob loaded by the JAX CLI's -load."""
    rc, out, err = jax_runs["load"].result()
    assert rc == 0, out + err
    assert "loaded plan blob" in out and "(64,) batch 2" in out, out


def test_blob_jax_to_port(jax_runs):
    """The JAX CLI's -save blob loaded by the port's -load."""
    jrc, jout, jerr = jax_runs["save"].result()
    assert jrc == 0, jout + jerr
    _, jax_blob = jax_runs["blobs"]
    rc, out = run_port(*BLOB_ARGS, "-load", jax_blob)
    assert_green(rc, out)
    assert f"loaded plan blob from {jax_blob}" in out
    assert "(64,) batch 2:" in out


def test_compare_sample_52():
    """-compare runs the cuda engine (its plain versions here), then the
    torch engine, each labelled and green."""
    rc, out = run_port("-vkfft", 52, "-compare")
    assert rc == 0 and "FAIL" not in out, out
    heads = [ln for ln in out.splitlines() if ln.startswith("sample 52")]
    assert [h.rsplit(" ", 1)[-1] for h in heads] == ["[engine=cuda]",
                                                     "[engine=torch]"]
    assert out.count("(PASS)") == 2


def test_output_file_appends(tmp_path):
    path = tmp_path / "results.txt"
    path.write_text("earlier\n")
    for _ in range(2):
        rc, out = run_port("-vkfft", 18, "-o", path)
        assert rc == 0
    text = path.read_text()
    assert text.startswith("earlier\n")
    assert text.count("sample 18:") == 2
    assert text.count("(PASS)") == 2


@pytest.mark.parametrize("num", [0, 2, 3, 4, 5, 6, 7, 9, 100, 101])
def test_timed_sample(num):
    """The benchmark samples at about 1 MiB: every row's time finite and
    positive."""
    rc, out = run_port("-vkfft", num)
    assert_green(rc, out)
    ms = [float(v) for v in _MS.findall(out)]
    assert ms and all(math.isfinite(v) and v > 0 for v in ms), out


@pytest.mark.parametrize("num", [0, 7])
def test_timed_compare(num):
    """-compare on the timed C2C rows: torch.fft's round trip beside each."""
    rc, out = run_port("-vkfft", num, "-compare")
    assert rc == 0, out
    rows = [ln for ln in out.splitlines() if "est" in ln and "GB/s" in ln]
    lib = [ln for ln in out.splitlines() if "torch.fft" in ln]
    assert rows and len(lib) == len(rows), out

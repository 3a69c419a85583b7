"""Every example twin (``examples_torch/ex*.py``, the PyTorch port's
counterparts of ``examples/ex*.py``) runs green on the CPU, as
``tests/test_examples.py`` holds the JAX examples: each in a subprocess with
``VKFFT_TPU_TORCH_EXAMPLES_CPU=1``, its last line "ok".

The ten scripts start together in one module fixture (each one process,
ex09 a gloo world of 8 ranks, the JAX example's 8 devices), so the module
costs about the slowest script rather than their sum; each test then reads
its own script's result.  ex08's build cache goes to a temporary directory.
"""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted((ROOT / "examples_torch").glob("ex*.py"))
TIMEOUT_S = 600


def test_every_example_has_a_twin():
    """One twin a JAX example, by name."""
    assert [p.name for p in EXAMPLES] == sorted(
        p.name for p in (ROOT / "examples").glob("ex*.py"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{script name: (returncode, stdout, stderr)} of every twin, run at
    once."""
    env = dict(os.environ, VKFFT_TPU_TORCH_EXAMPLES_CPU="1",
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               VKFFT_TPU_TORCH_CACHE=str(tmp_path_factory.mktemp("cache")))
    procs = {p.name: subprocess.Popen(
        [sys.executable, str(p)], cwd=p.parent, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for p in EXAMPLES}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
            out[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.mark.parametrize("script", EXAMPLES, ids=lambda p: p.stem)
def test_example(runs, script):
    rc, stdout, stderr = runs[script.name]
    assert rc == 0, f"{script.name} failed:\n{stdout}\n{stderr}"
    assert stdout.strip().endswith("ok"), stdout

"""Checks that need an NVIDIA GPU: the two eigh paths of svd_trunc through
cuSOLVER at the benchmark's width, and the n=50 chi=64 sweep. On the card
run them with `python -m pytest -m gpu tests/`; elsewhere they skip.

The test process itself stays on the CPU (conftest); each check runs in a
child process that opens the card alone.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_env():
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run(
            [smi, "-L"], capture_output=True, timeout=60).returncode != 0:
        pytest.skip("no NVIDIA GPU on this host")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


def _on_card(env, code):
    proc = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke as cs; cs._require_checkout(); "
         "cs._require_gpu(1); " + code],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_eigh_paths_on_card(gpu_env):
    _on_card(gpu_env, "cs.phase_kernels()")


def test_sweep_on_card(gpu_env):
    out = _on_card(gpu_env, "cs.phase_sweep(cs.nvidia_smi())")
    assert "equivalent evals/s" in out

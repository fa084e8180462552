"""The chip smoke run, the benchmark's device handling, the compile cache and
the native helper build: what of them a CPU can check.

chip_smoke.py and bench.py must refuse to run anywhere but on a GPU; their
phases that need no card run here at tiny sizes.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke as cs  # noqa: E402


def _run(args, cwd=REPO, **env_over):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": ""}, **env_over)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(stdout):
    return any(line.startswith("{") and '"ok"' in line
               for line in stdout.splitlines())


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    proc = _run([os.path.join(REPO, script)])
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)
    assert "GPU" in proc.stderr or "gpu" in proc.stderr


def test_smoke_refuses_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run([str(tmp_path / "chip_smoke.py")], cwd=str(tmp_path))
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)
    assert "checkout" in proc.stderr


def test_smoke_compile_phase_small():
    cs._require_checkout()
    result = cs.phase_compile(n=6, max_chi=8, layers=3)
    assert 0.0 < result.overlap <= 1.0


def test_smoke_eigh_checks_small():
    out = cs.check_eigh_paths(8, 8, 4)
    assert set(out) == {(i, c) for i in ("embed", "tridiag")
                        for c in ("random", "ghz")}
    for s_err, recon, o_err in out.values():
        assert s_err <= cs.SVAL_TOL and recon <= cs.RECON_TOL
        assert o_err <= cs.ORTHO_TOL


def test_smoke_four_phase_on_virtual_devices():
    """The --four phase on 4 of the virtual CPU devices (tiny sizes): the
    mesh spans all four, and each sharded path matches one device."""
    cs._require_checkout()
    cs.phase_four(n_mps=6, chi=8, n_sv=6, adapt_n=6, adapt_layers=2,
                  n_devices=4)


def test_peaks_known_kind():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["fp32_flops"] == 67e12 and peaks["bf16_flops"] == 989e12


def test_peaks_unknown_kind_raises():
    with pytest.raises(KeyError):
        bench.device_peaks("cpu")


@pytest.mark.parametrize("preset", [False, True])
def test_compile_cache_placement(tmp_path, preset):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise one fixed path
    inside the checkout."""
    code = ("import jax, adaptaqc_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    over = {"PYTHONPATH": REPO}
    if preset:
        over["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    proc = _run(["-c", code], **over)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = str(tmp_path) if preset else os.path.join(REPO, ".jax_cache")
    assert proc.stdout.strip().splitlines()[-1] == want


def test_native_library_named_by_source_hash(tmp_path, monkeypatch):
    """A library built from other sources is never picked up: the path
    changes with the source content."""
    from adaptaqc_tpu.ops import native
    src = tmp_path / "native"
    src.mkdir()
    shutil.copy(os.path.join(REPO, "native", "circkit.cpp"), src)
    monkeypatch.setattr(native, "_NATIVE_DIR", str(src))
    before = native.library_path()
    with open(src / "circkit.cpp", "a") as f:
        f.write("\n// edited\n")
    after = native.library_path()
    assert before != after
    assert os.path.dirname(before) == str(src / "build")

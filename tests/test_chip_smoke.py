"""CPU tests of the GPU smoke run (chip_smoke.py) and the compile-cache
helper: the refusal to run off the GPU, the form of the last line, the
reference problem the multistage phases check against, and where the
persistent cache lands."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

import jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from piqp_tpu.utils import compile_cache  # noqa: E402


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_gpu(alone, tmp_path):
    """On a CPU, and in a directory holding the script alone, the run
    fails and prints no result."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        script = str(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = _run(script, tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_result_line_form():
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    line = chip_smoke.result_line(dev, 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100", "count": 1},
    }


@pytest.mark.parametrize("T,Da", [(6, 3), (5, 0)])
def test_stage_problem_matches_dense(T, Da):
    """The sparse user-order problem the smoke run checks multistage
    solutions against equals the dense materialization."""
    from piqp_tpu import multistage as ms

    sd = ms.random_multistage_qp(T=T, D=3, Da=Da, ra=2, rg=2, seed=T)
    prob = chip_smoke.stage_problem(sd)
    dense = ms.to_dense(sd)
    for k in ("P", "A", "G"):
        np.testing.assert_array_equal(prob[k].toarray(), np.asarray(
            getattr(dense, k)))
    hl = np.asarray(dense.hl_mask)
    np.testing.assert_array_equal(np.isfinite(prob["h_l"]), hl)
    np.testing.assert_array_equal(prob["h_l"][hl], np.asarray(dense.h_l)[hl])


def test_compile_cache_honours_env(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, no directory is set in code."""
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert all(k != "jax_compilation_cache_dir" for k, _ in calls)


def test_compile_cache_default_in_checkout(monkeypatch):
    """Without it, the cache lands in <checkout>/.jax_cache."""
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(os.path.abspath(ROOT), ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls

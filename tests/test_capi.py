"""C interface test — builds the embedded-interpreter C library and runs
the C test binary (the analog of the reference's
interfaces/c/tests/src/c_interface_test.cpp)."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "csrc")


@pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("python3-config") is None,
    reason="C toolchain not available",
)
def test_c_interface(tmp_path):
    build = subprocess.run(
        ["sh", os.path.join(CSRC, "build_capi.sh"), str(tmp_path)],
        capture_output=True,
        text=True,
    )
    assert build.returncode == 0, build.stderr

    env = dict(os.environ)
    site = [p for p in sys.path if p.endswith("site-packages")]
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + site)
    env["JAX_PLATFORMS"] = "cpu"  # the embedded interpreter runs on the CPU
    run = subprocess.run(
        [str(tmp_path / "test_capi")],
        capture_output=True,
        text=True,
        env=env,
        timeout=600,
    )
    assert run.returncode == 0, run.stdout + run.stderr
    assert "C interface test passed" in run.stdout

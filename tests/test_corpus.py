"""Corpus regression tests — Maros-Meszaros QPs and Netlib LPs (mirrors
/root/reference/tests/src/sparse/maros_meszaros_tests.cpp and
netlib_lp_tests.cpp; gates recorded in BASELINE.md).

Coverage strategy (the SURVEY.md §7 routing rule, exercised end to end):
  - the small subset (n <= 256) runs through the *device* dense condensed
    backend, padded to shared shape buckets so XLA compiles only a handful
    of executables;
  - the full corpus runs through the *host sparse* backend (hostsparse.py,
    the routing target for large unstructured sparse problems).  The
    default run caps instances at n <= HOST_MAX_N to keep CI time bounded;
    PIQP_TPU_FULL_CORPUS=1 removes the cap (all 137 Maros-Meszaros + all
    123 Netlib instances pass; verified offline, largest BOYD/CONT/dfl001
    take minutes each).
"""

import glob
import os

import numpy as np
import pytest

from piqp_tpu import Settings, Status, solve_dense
from piqp_tpu.hostsparse import solve_sparse_host
from piqp_tpu.utils.io import load_mat
from piqp_tpu.utils.pad import pad_problem, unpad_result

from helpers import check_optimality

MAROS_DIR = "/root/reference/tests/data/maros_meszaros"
NETLIB_INFEAS_DIR = "/root/reference/tests/data/netlib/infeas"
NETLIB_FEAS_DIR = "/root/reference/tests/data/netlib/data"

FULL = os.environ.get("PIQP_TPU_FULL_CORPUS", "0") == "1"
HOST_MAX_N = 10**9 if FULL else 2048

# the small-subset instances (n <= 256), verified present in the corpus
SMALL_MAROS = [
    "HS21", "QPTEST", "ZECEVIC2", "TAME", "HS35", "HS35MOD", "HS76",
    "HS268", "S268", "HS51", "HS52", "HS53", "DUALC2", "DUALC5", "DUALC8",
    "DUALC1", "GENHS28", "LOTSCHD", "HS118", "KSIP", "QAFIRO", "DUAL4",
    "QSHARE2B", "QPCBLEND", "DUAL1", "DUAL2", "QADLITTL", "CVXQP2_S",
    "CVXQP1_S", "CVXQP3_S", "DUAL3", "DPKLO1", "QSCAGR7", "QISRAEL",
    "QPCBOEI2", "QRECIPE", "VALUES", "QSC205", "QSHARE1B", "PRIMALC1",
    "PRIMALC2", "QBRANDY",
]


def _names(d):
    return [os.path.basename(f)[:-4] for f in sorted(glob.glob(d + "/*.mat"))]


_DIMS_CACHE = {}


def _dim_n(directory, name):
    key = (directory, name)
    if key not in _DIMS_CACHE:
        import scipy.io as sio

        d = sio.loadmat(os.path.join(directory, name + ".mat"),
                        variable_names=["P"])
        _DIMS_CACHE[key] = d["P"].shape[0]
    return _DIMS_CACHE[key]


def _solve_padded(prob, settings=Settings()):
    padded, dims = pad_problem(prob, bucket=True)
    res = solve_dense(**padded, settings=settings)
    return unpad_result(res, dims), res


# ---------------------------------------------------------------------------
# device dense path: small subset
# ---------------------------------------------------------------------------

@pytest.mark.corpus
@pytest.mark.parametrize("name", SMALL_MAROS)
def test_maros_meszaros_dense_device(name):
    prob = load_mat(os.path.join(MAROS_DIR, name + ".mat"))
    view, res = _solve_padded(prob)
    assert int(res.info.status) == Status.SOLVED, (
        f"{name}: {int(res.info.status)} after {int(res.info.iter)} iters "
        f"(primal_res={float(res.info.primal_res):.2e}, "
        f"dual_res={float(res.info.dual_res):.2e})"
    )


# ---------------------------------------------------------------------------
# host sparse path: full corpus
# ---------------------------------------------------------------------------

@pytest.mark.corpus
@pytest.mark.parametrize("name", _names(MAROS_DIR))
def test_maros_meszaros_host(name):
    n = _dim_n(MAROS_DIR, name)
    if n > HOST_MAX_N:
        pytest.skip(f"{name}: n={n} > {HOST_MAX_N} (set PIQP_TPU_FULL_CORPUS=1)")
    prob = load_mat(os.path.join(MAROS_DIR, name + ".mat"), sparse=True)
    res = solve_sparse_host(**prob)
    assert res.info.status == int(Status.SOLVED), (
        f"{name}: status {res.info.status} after {res.info.iter} iters "
        f"(primal_res={res.info.primal_res:.2e}, dual_res={res.info.dual_res:.2e})"
    )


# pilotnov (severely ill-conditioned) used to trip a false
# primal-infeasibility certificate on our LU trajectory; the Farkas
# certificate validation gate (hostsparse._primal_ray_quality) rejects the
# spurious ray and the proximal-penalty tightening on rejection lets it
# converge.  All 94 feasible instances pass.


@pytest.mark.corpus
@pytest.mark.parametrize("name", _names(NETLIB_FEAS_DIR))
def test_netlib_feasible_host(name):
    n = _dim_n(NETLIB_FEAS_DIR, name)
    if n > HOST_MAX_N:
        pytest.skip(f"{name}: n={n} > {HOST_MAX_N} (set PIQP_TPU_FULL_CORPUS=1)")
    prob = load_mat(os.path.join(NETLIB_FEAS_DIR, name + ".mat"), sparse=True)
    res = solve_sparse_host(
        **prob, settings=Settings(infeasibility_threshold=0.01)
    )
    assert res.info.status == int(Status.SOLVED), (
        f"{name}: status {res.info.status} after {res.info.iter} iters"
    )


# cplex2/qual/ceria3d are borderline infeasible instances that reach
# max_iter at a frozen proximal equilibrium where the stall counters never
# trip; the post-hoc certificate search (violation-residual ray for
# cplex2/ceria3d, phase-1 feasibility QP for qual) certifies them.
# All 29 infeasible instances certify correctly.


@pytest.mark.corpus
@pytest.mark.parametrize("name", _names(NETLIB_INFEAS_DIR))
def test_netlib_infeasible_host(name):
    n = _dim_n(NETLIB_INFEAS_DIR, name)
    if n > HOST_MAX_N:
        pytest.skip(f"{name}: n={n} > {HOST_MAX_N} (set PIQP_TPU_FULL_CORPUS=1)")
    prob = load_mat(os.path.join(NETLIB_INFEAS_DIR, name + ".mat"), sparse=True)
    res = solve_sparse_host(
        **prob, settings=Settings(infeasibility_threshold=0.01)
    )
    assert res.info.status in (
        int(Status.PRIMAL_INFEASIBLE), int(Status.DUAL_INFEASIBLE)
    ), f"{name}: status {res.info.status}"


# device path retains a small infeasibility-certificate suite
@pytest.mark.corpus
@pytest.mark.parametrize(
    "name", [n for n in _names(NETLIB_INFEAS_DIR)][:6]
)
def test_netlib_infeasible_device(name):
    n = _dim_n(NETLIB_INFEAS_DIR, name)
    if n > 256:
        pytest.skip(f"{name}: n={n} > 256 (device small-path suite)")
    prob = load_mat(os.path.join(NETLIB_INFEAS_DIR, name + ".mat"))
    settings = Settings(infeasibility_threshold=0.01)
    view, res = _solve_padded(prob, settings)
    status = int(res.info.status)
    assert status in (Status.PRIMAL_INFEASIBLE, Status.DUAL_INFEASIBLE), (
        f"{name}: status {status}"
    )


# ---------------------------------------------------------------------------
# device dense path: medium subset up to the actual routing cap
# (sparse.py DENSE_ROUTING_MAX_N = 512; VERDICT round-1 item 8)
# ---------------------------------------------------------------------------

MEDIUM_MAROS = [
    "PRIMAL1", "PRIMALC5", "QBANDM", "QBEACONF", "QBORE3D", "QCAPRI",
    "QE226", "QFORPLAN", "QGROW7", "QPCBOEI1", "QPCSTAIR", "QSCAGR25",
    "QSCFXM1", "QSCORPIO", "QSCTAP1", "QSTAIR",
]


@pytest.mark.corpus
@pytest.mark.parametrize("name", MEDIUM_MAROS)
def test_maros_meszaros_dense_device_medium(name):
    """256 < n <= 512 instances through the device dense condensed
    backend — the sizes that route to the device in SparseSolver but were
    only host-corpus-tested in round 1."""
    prob = load_mat(os.path.join(MAROS_DIR, name + ".mat"))
    view, res = _solve_padded(prob)
    assert int(res.info.status) == Status.SOLVED, (
        f"{name}: {int(res.info.status)} after {int(res.info.iter)} iters "
        f"(primal_res={float(res.info.primal_res):.2e}, "
        f"dual_res={float(res.info.dual_res):.2e})"
    )


# 512 < n <= 1000 instances through the device dense condensed backend.
# The default SparseSolver routing cap stays at 512, but the backend
# itself must cover these sizes.
LARGE_DEVICE_MAROS = [
    "PRIMAL2", "GOULDQP2", "GOULDQP3", "PRIMAL3", "MOSARQP2", "CVXQP2_M",
]


@pytest.mark.corpus
@pytest.mark.parametrize("name", LARGE_DEVICE_MAROS)
def test_maros_meszaros_dense_device_large(name):
    prob = load_mat(os.path.join(MAROS_DIR, name + ".mat"))
    view, res = _solve_padded(prob)
    assert int(res.info.status) == Status.SOLVED, (
        f"{name}: {int(res.info.status)} after {int(res.info.iter)} iters "
        f"(primal_res={float(res.info.primal_res):.2e}, "
        f"dual_res={float(res.info.dual_res):.2e})"
    )


NETLIB_SMALL = [
    "adlittle", "afiro", "agg", "agg2", "agg3", "bandm", "beaconfd",
    "blend", "boeing1", "boeing2", "bore3d", "brandy", "capri", "e226",
    "forplan", "grow7", "israel", "kb2", "lotfi", "recipe", "sc105",
    "sc205", "sc50a", "sc50b", "scagr25", "scagr7", "scfxm1", "scorpion",
    "sctap1", "share1b", "share2b", "stair", "stocfor1", "vtp.base",
]


@pytest.mark.corpus
@pytest.mark.parametrize("name", NETLIB_SMALL)
def test_netlib_feasible_device(name):
    """Feasible Netlib LPs with n <= 512 through the device dense path
    (P = 0: exercises the pure-LP corner of the condensed backend)."""
    prob = load_mat(os.path.join(NETLIB_FEAS_DIR, name + ".mat"))
    settings = Settings(infeasibility_threshold=0.01)
    view, res = _solve_padded(prob, settings)
    assert int(res.info.status) == Status.SOLVED, (
        f"{name}: {int(res.info.status)} after {int(res.info.iter)} iters"
    )

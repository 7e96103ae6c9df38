#!/usr/bin/env python3
"""End-to-end check of the solver on one NVIDIA GPU.

    python chip_smoke.py               # every one-card phase
    python chip_smoke.py --multichip   # the multi-device paths, 4 cards

Each phase drives a public entry point at a size users run and checks
every solution with the independent numpy KKT checker of
``tests/helpers.py`` (primal and dual feasibility, stationarity and the
duality gap against the unscaled data, tol 1e-6, solver at eps_abs 1e-8).
A phase that raises or fails a check fails the run.  The script refuses
to run anywhere but on a GPU: it exits nonzero and prints no result.

Output: one line per phase with its wall time (compilation included), the
card's name and power limit, then one JSON object as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-6
EPS = 1e-8
# problem sizes of the phases (n, batch, horizon, scenarios, ...)
SIZES = dict(dense_n=100, fleet=(512, 256), small=(64, 1024), sqp=(256, 16),
             T=100, S=10000, diff_n=32, fleet2d=(4, 16))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0]
    except Exception as e:  # reported, never fatal
        return f"nvidia-smi unavailable ({e})"


# ---------------------------------------------------------------------------
# problem builders and checks
# ---------------------------------------------------------------------------

def stage_problem(sd) -> dict:
    """User-order problem dict (scipy CSC matrices) of a StageQPData built
    with from_stage_blocks: stage variables first, then the arrow."""
    import numpy as np
    import scipy.sparse as sp

    T, D, Da, n = sd.T, sd.D, sd.Da, sd.n
    t = np.arange(T)[:, None, None]
    i = np.arange(D)[None, :, None]
    j = np.arange(D)[None, None, :]
    g = np.arange(Da)[None, :, None]

    def csc(entries, shape):
        r, c, v = zip(*[
            (a.ravel(), b.ravel(), w.ravel()) for a, b, w in (
                np.broadcast_arrays(r_, c_, np.asarray(v_))
                for r_, c_, v_ in entries)
        ])
        M = sp.csc_matrix((np.concatenate(v),
                           (np.concatenate(r), np.concatenate(c))),
                          shape=shape)
        M.eliminate_zeros()
        return M

    # K[(t+1)D + i, tD + j] = Psub[t, i, j], and its mirror
    sub, tt = np.asarray(sd.Psub)[:T - 1], t[:T - 1]
    P = [(t * D + i, t * D + j, sd.Pd),
         ((tt + 1) * D + i, tt * D + j, sub),
         (tt * D + j, (tt + 1) * D + i, sub)]
    if Da:
        P += [(T * D + g, t * D + j, sd.Pa), (t * D + j, T * D + g, sd.Pa),
              (T * D + g[0], T * D + g[0].T, sd.Pc)]

    def expand(M1, M2, Mg, r):
        rows = t * r + np.arange(r)[None, :, None]
        ents = [(rows, t * D + j, M1),
                (rows[:T - 1], (tt + 1) * D + j, np.asarray(M2)[:T - 1])]
        if Da:
            ents.append((rows, T * D + np.arange(Da)[None, None, :], Mg))
        return csc(ents, (T * r, n)) if r else sp.csc_matrix((0, n))

    def bound(v, mask, inf):
        return np.where(np.asarray(mask), np.asarray(v), inf)

    return dict(
        P=csc(P, (n, n)), c=np.asarray(sd.c),
        A=expand(sd.A1, sd.A2, sd.Ag, sd.ra), b=np.asarray(sd.b),
        G=expand(sd.G1, sd.G2, sd.Gg, sd.rg),
        h_l=bound(sd.h_l, sd.hl_mask, -np.inf),
        h_u=bound(sd.h_u, sd.hu_mask, np.inf),
        x_l=bound(sd.x_l, sd.xl_mask, -np.inf),
        x_u=bound(sd.x_u, sd.xu_mask, np.inf),
    )


def row(res, i):
    import jax

    return jax.tree.map(lambda v: v[i], res)


def check_fleet(probs, res, what: str):
    import numpy as np

    from helpers import check_optimality

    status = np.asarray(res.info.status)
    bad = np.nonzero(status != 1)[0]
    assert bad.size == 0, f"{what}: {bad.size} not SOLVED: {status[bad][:8]}"
    for i, prob in enumerate(probs):
        check_optimality(prob, row(res, i), tol=TOL)
    it = np.asarray(res.info.iter)
    return f"iters mean {it.mean():.2f} max {it.max()}"


def scaled_c(prob, f):
    return dict(prob, c=prob["c"] * f)


def timed(fn):
    """Run fn once, wait for its device work, return (out, seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------

def phase_dense_solver():
    import numpy as np

    from helpers import check_optimality
    from piqp_tpu import DenseSolver, Settings, Status
    from piqp_tpu.utils.random import dense_strongly_convex_qp

    doc = dict(P=np.array([[6.0, 0.0], [0.0, 4.0]]),
               c=np.array([-1.0, -4.0]),
               A=np.array([[1.0, -2.0]]), b=np.array([0.0]))
    n = SIZES["dense_n"]
    big = dense_strongly_convex_qp(n, n // 4, n // 2, seed=1)
    notes = []
    for name, prob in (("doc", doc), (f"n{n}", big)):
        s = DenseSolver(Settings(eps_abs=EPS))
        s.setup(**prob)
        assert s.solve() == Status.SOLVED, name
        check_optimality(prob, s.result, tol=TOL)
        s.update(c=prob["c"] * 1.01)
        assert s.solve(warm_start=True) == Status.SOLVED, name + " warm"
        check_optimality(scaled_c(prob, 1.01), s.result, tol=TOL)
        notes.append(f"{name} warm iters {int(s.result.info.iter)}")
    return ", ".join(notes)


def _fleet(n, B, seed):
    from piqp_tpu import prepare_batch
    from piqp_tpu.utils.random import dense_strongly_convex_qp

    probs = [dense_strongly_convex_qp(n, n // 4, n // 2, seed=seed + i)
             for i in range(B)]
    return probs, prepare_batch(probs)


def phase_dense_fleet():
    from piqp_tpu import Settings, solve_batch, warm_from_result

    n, B = SIZES["fleet"]
    probs, data = _fleet(n, B, seed=1000)
    data2 = data.replace(c=data.c * 1.01)
    probs2 = [scaled_c(p, 1.01) for p in probs]
    notes = []
    for tag, s in (("f64", Settings(eps_abs=EPS)),
                   ("mixed", Settings(eps_abs=EPS, mixed_precision=True))):
        res, t_cold = timed(lambda: solve_batch(data, s))
        cold = check_fleet(probs, res, f"{tag} cold")
        warm = warm_from_result(res)
        resw, t_warm = timed(lambda: solve_batch(data2, s, warm=warm))
        warm_it = check_fleet(probs2, resw, f"{tag} warm")
        _, t_steady = timed(lambda: solve_batch(data2, s, warm=warm))
        notes.append(
            f"{tag}: cold {cold} ({t_cold:.1f}s), warm {warm_it} "
            f"({t_warm:.1f}s), warm steady {B / t_steady:.0f} solves/s"
        )
    return "; ".join(notes)


SMALL = {}


def phase_factor_failure():
    """cuSOLVER's potrf failure must reach the solver as NaN inside a vmap
    under a while_loop: the retry ladder's failure signal
    (kkt._factor_dense)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from piqp_tpu.ops.pallas_chol import cholesky_with_inverse

    n, B = SIZES["small"]
    rng = np.random.default_rng(0)
    Q = rng.standard_normal((B, n, n))
    K = Q @ np.swapaxes(Q, 1, 2) + n * np.eye(n)
    bad = np.arange(0, B, 7)
    K[bad, n // 2, n // 2] = -1.0
    K = jnp.asarray(K)

    def loop(factor):
        def one(k):
            def body(c):
                return c[0] + 1, factor(k)
            return jax.lax.while_loop(lambda c: c[0] < 2, body,
                                      (0, factor(k)))[1]
        return jax.jit(jax.vmap(one))

    for name, factor in (("cholesky", jnp.linalg.cholesky),
                         ("with_inverse",
                          lambda k: cholesky_with_inverse(k)[0])):
        L = np.asarray(loop(factor)(K))
        finite = np.all(np.isfinite(L), axis=(1, 2))
        assert not finite[bad].any(), f"{name}: failed factor is finite"
        good = np.setdiff1d(np.arange(B), bad)
        assert finite[good].all(), f"{name}: healthy factor not finite"
    return f"{bad.size}/{B} failed factors are NaN, the rest finite"


def phase_small_fleet():
    from piqp_tpu import Settings, solve_batch

    n, B = SIZES["small"]
    probs, data = _fleet(n, B, seed=5000)
    s = Settings(eps_abs=EPS)
    res, t_cold = timed(lambda: solve_batch(data, s))
    note = check_fleet(probs, res, "small fleet")
    _, t_steady = timed(lambda: solve_batch(data, s))
    SMALL.update(probs=probs, data=data, res=res)
    return f"{note} ({t_cold:.1f}s), steady {B / t_steady:.0f} solves/s"


def phase_sqp():
    import jax
    import numpy as np

    from piqp_tpu import Settings, solve_batch_sqp, warm_from_result

    if not SMALL:
        phase_small_fleet()
    B, K = SIZES["sqp"]
    probs = SMALL["probs"][:B]
    data = jax.tree.map(lambda v: v[:B], SMALL["data"])
    warm = jax.tree.map(lambda v: v[:B], warm_from_result(SMALL["res"]))
    s = Settings(eps_abs=EPS)
    (wf, status, iters), _ = timed(
        lambda: solve_batch_sqp(data, s, rounds=K, warm=warm))
    status = np.asarray(status)
    assert status.shape == (B, K) and np.all(status == 1), (
        f"{int(np.sum(status != 1))} round solves not SOLVED")
    # the last round solved c * (1 + 0.01 K)
    from helpers import check_optimality

    for i, prob in enumerate(probs):
        check_optimality(scaled_c(prob, 1.0 + 0.01 * K), row(wf, i), tol=TOL)
    iters = np.asarray(iters)
    return f"{B}x{K} solves, iters mean {iters.mean():.2f} max {iters.max()}"


def phase_sparse_multistage():
    from helpers import check_optimality
    from piqp_tpu import KKTBackend, Settings, SparseSolver, Status
    from piqp_tpu import _native
    from piqp_tpu import multistage as ms

    sd = ms.random_multistage_qp(T=SIZES["T"], D=8, Da=4, ra=4, rg=4, seed=4)
    prob = stage_problem(sd)
    assert _native._lib() is not None, "structure detector did not build"
    s = SparseSolver(Settings(eps_abs=EPS, kkt_solver=KKTBackend.multistage),
                     multistage_fallback=False)
    s.setup(**prob)
    assert s._stage_data is not None, "not routed to the multistage backend"
    T, D = s._stage_data.T, s._stage_data.D
    assert s.solve() == Status.SOLVED
    check_optimality(prob, s.result, tol=TOL)
    s.update(c=prob["c"] * 1.01)
    assert s.solve(warm_start=True) == Status.SOLVED
    check_optimality(scaled_c(prob, 1.01), s.result, tol=TOL)
    return (f"multistage route T={T} D={D}, warm iters "
            f"{int(s.result.info.iter)}")


def phase_scenario():
    from helpers import check_optimality
    from piqp_tpu import Settings, Status, solve_prepared

    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from scenario_bench import build

    S = SIZES["S"]
    sd = build(S)
    res, _ = timed(lambda: solve_prepared(sd, Settings(eps_abs=EPS)))
    assert int(res.info.status) == Status.SOLVED, int(res.info.status)
    check_optimality(stage_problem(sd), res, tol=TOL)
    return f"S={S} n={sd.n}, iters {int(res.info.iter)}"


def _nondegenerate_qp(n, p, m, seed):
    """QP with a strictly complementary active set chosen by inverse KKT,
    so that x*(c) is affine near c and central differences are exact up
    to the solve tolerance."""
    import numpy as np

    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    P = M @ M.T + n * np.eye(n)
    A = rng.standard_normal((p, n))
    G = rng.standard_normal((m, n))
    xs, ys = rng.standard_normal(n), rng.standard_normal(p)
    Gx = G @ xs
    h_l, h_u = Gx - 1.0, Gx + 1.0
    z_l, z_u = np.zeros(m), np.zeros(m)
    h_u[0], z_u[0] = Gx[0], 0.7
    h_l[1], z_l[1] = Gx[1], 0.9
    c = -(P @ xs + A.T @ ys + G.T @ (z_u - z_l))
    return dict(P=P, c=c, A=A, b=A @ xs, G=G, h_l=h_l, h_u=h_u)


def phase_diff():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from helpers import check_optimality
    from piqp_tpu import Settings, prepare_data, solve_qp_diff

    n = SIZES["diff_n"]
    prob = _nondegenerate_qp(n, n // 4, n // 2, seed=3)
    data = prepare_data(**prob)
    s = Settings(eps_abs=1e-11, eps_rel=1e-12)
    w = jnp.asarray(np.random.default_rng(7).standard_normal(n))
    x_of = lambda c: solve_qp_diff(data.replace(c=c), s).x
    sol = solve_qp_diff(data, s)
    check_optimality(prob, sol, tol=TOL)
    g = jax.grad(lambda c: w @ x_of(c))(data.c)
    h = 1e-3
    E = h * jnp.eye(n, dtype=data.c.dtype)
    xs = jax.vmap(x_of)(jnp.concatenate([data.c + E, data.c - E]))
    fd = (xs[:n] @ w - xs[n:] @ w) / (2 * h)
    err = float(jnp.max(jnp.abs(g - fd)) / jnp.max(jnp.abs(fd)))
    assert err < 1e-5, f"grad vs central differences: rel err {err:.2e}"
    return f"grad vs FD rel err {err:.2e}"


def phase_full_kkt():
    from helpers import check_optimality
    from piqp_tpu import KKTBackend, Settings, Status, solve_dense
    from piqp_tpu.utils.random import dense_strongly_convex_qp

    n = SIZES["dense_n"]
    prob = dense_strongly_convex_qp(n, n // 4, n // 2, seed=2)
    notes = []
    for kkt in (KKTBackend.dense_lu, KKTBackend.dense_ldlt):
        res = solve_dense(**prob, settings=Settings(eps_abs=EPS,
                                                     kkt_solver=kkt))
        assert int(res.info.status) == Status.SOLVED, kkt.name
        check_optimality(prob, res, tol=TOL)
        notes.append(f"{kkt.name} iters {int(res.info.iter)}")
    return ", ".join(notes)


PHASES = [
    ("dense_solver", phase_dense_solver),
    ("dense_fleet", phase_dense_fleet),
    ("factor_failure", phase_factor_failure),
    ("small_fleet", phase_small_fleet),
    ("solve_batch_sqp", phase_sqp),
    ("sparse_multistage", phase_sparse_multistage),
    ("scenario", phase_scenario),
    ("solve_qp_diff", phase_diff),
    ("dense_lu_ldlt", phase_full_kkt),
]


# ---------------------------------------------------------------------------
# multi-device phases (--multichip)
# ---------------------------------------------------------------------------

def _spans(x, ndev: int) -> bool:
    return len(x.sharding.device_set) == ndev


def _assert_spread(tree, ndev, what):
    import jax

    for leaf in jax.tree.leaves(tree):
        if hasattr(leaf, "sharding") and leaf.ndim > 0 and leaf.size > ndev:
            assert _spans(leaf, ndev), (
                f"{what}: a leaf of shape {leaf.shape} sits on "
                f"{leaf.sharding.device_set}")


def _close(a, b, rtol, what):
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    err = np.max(np.abs(a - b), axis=-1) / np.maximum(
        np.max(np.abs(b), axis=-1), 1e-300)
    assert np.all(err <= rtol), f"{what}: rel diff {np.max(err):.2e}"
    return float(np.max(err))


def phase_dp():
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from piqp_tpu import Settings, solve_batch

    devs = jax.devices()
    n, B = SIZES["fleet"]
    probs, data = _fleet(n, B, seed=1000)
    s = Settings(eps_abs=EPS)
    one, t1 = timed(lambda: solve_batch(
        jax.device_put(data, devs[0]), s))
    check_fleet(probs, one, "dp 1 card")
    sh = NamedSharding(Mesh(devs, ("dp",)), P("dp"))
    res, t4 = timed(lambda: solve_batch(data, s, sharding=sh))
    check_fleet(probs, res, "dp")
    _assert_spread(jax.device_put(data, sh), len(devs), "dp inputs")
    _assert_spread(res, len(devs), "dp outputs")
    err = _close(res.x, one.x, 1e-8, "dp vs 1 card")
    _, s1 = timed(lambda: solve_batch(jax.device_put(data, devs[0]), s))
    _, s4 = timed(lambda: solve_batch(data, s, sharding=sh))
    return (f"x rel diff {err:.1e}; 1 card {B / s1:.0f} solves/s, "
            f"{len(devs)} cards {B / s4:.0f} solves/s "
            f"(first calls {t1:.1f}s / {t4:.1f}s)")


def phase_sp():
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from piqp_tpu import Settings, solve_horizon_sharded, solve_prepared
    from piqp_tpu import multistage as ms
    from piqp_tpu.parallel import shard_horizon

    devs = jax.devices()
    T = SIZES["T"]
    sd = ms.random_multistage_qp(T=T, D=8, Da=4, ra=4, rg=4, seed=4)
    s = Settings(eps_abs=EPS)
    one = solve_prepared(jax.device_put(sd, devs[0]), s)
    assert int(one.info.status) == 1
    mesh = Mesh(np.array(devs), ("sp",))
    sh = shard_horizon(sd, mesh, "sp")
    _assert_spread([sh.Pd, sh.Psub, sh.Pa, sh.A1, sh.G1], len(devs),
                   "sp inputs")
    res, t = timed(lambda: solve_horizon_sharded(sh, mesh, "sp", s))
    assert int(res.info.status) == 1, int(res.info.status)
    from helpers import check_optimality

    check_optimality(stage_problem(sd), res, tol=TOL)
    assert len(res.x.sharding.device_set) == len(devs), res.x.sharding
    err = _close(res.x, one.x, 1e-7, "sp vs 1 card")
    return f"T={T} over {len(devs)} cards, x rel diff {err:.1e} ({t:.1f}s)"


def phase_dp_sp():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from piqp_tpu import Settings, solve_batch
    from piqp_tpu import multistage as ms

    devs = jax.devices()
    assert len(devs) == 4
    # the scenario-fleet x horizon composition of __graft_entry__.py
    B, T = SIZES["fleet2d"]
    base = ms.random_multistage_qp(T=T, D=4, Da=2, ra=2, rg=2, seed=0)
    fleet = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        base.replace(c=base.c * (1.0 + 0.01 * i)) for i in range(B)])
    s = Settings(eps_abs=EPS)
    one = solve_batch(jax.device_put(fleet, devs[0]), s)
    mesh = Mesh(np.array(devs).reshape(2, 2), ("dp", "sp"))

    def spec(x):
        if x.ndim >= 3 and x.shape[1] == base.T:
            return NamedSharding(mesh, P("dp", "sp"))
        return NamedSharding(mesh, P("dp"))

    placed = jax.tree.map(lambda x: jax.device_put(x, spec(x)), fleet)
    _assert_spread([placed.Pd, placed.A1, placed.G1], 4, "2D inputs")
    res, t = timed(lambda: solve_batch(placed, s))
    status = np.asarray(res.info.status)
    assert np.all(status == 1), status
    from helpers import check_optimality

    for i in range(B):
        check_optimality(stage_problem(row(fleet, i)), row(res, i), tol=TOL)
    assert len(res.x.sharding.device_set) > 1, res.x.sharding
    err = _close(res.x, one.x, 1e-7, "2D vs 1 card")
    return (f"{B} x T={T} on 2x2 (dp x sp), x rel diff {err:.1e}, "
            f"outputs on {len(res.x.sharding.device_set)} cards ({t:.1f}s)")


MULTI_PHASES = [("dp", phase_dp), ("sp", phase_sp), ("dp_x_sp", phase_dp_sp)]


def result_line(dev, count: int) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run the multi-device paths on 4 cards")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, found {dev.platform}",
              file=sys.stderr)
        return 1
    ndev = len(jax.devices())
    if args.multichip and ndev != 4:
        print(f"chip_smoke: --multichip needs 4 GPUs, found {ndev}",
              file=sys.stderr)
        return 1

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from piqp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(f"card: {card_line()}", flush=True)

    phases = MULTI_PHASES if args.multichip else PHASES
    ok = True
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            note = fn()
            print(f"phase {name}: ok {time.perf_counter() - t0:.1f}s "
                  f"{note}", flush=True)
        except Exception:
            ok = False
            print(f"phase {name}: FAILED {time.perf_counter() - t0:.1f}s",
                  flush=True)
            traceback.print_exc()
    print(f"total {time.perf_counter() - t_all:.1f}s", flush=True)
    if not ok:
        return 1
    print(card_line(), flush=True)
    print(result_line(dev, ndev))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Factor representations on the GPU: kernel time and end to end.

    python benchmarks/chol_kernel_bench.py [kernel] [fleet] [cr]

kernel: device time (profiler trace) of one batched factorization, XLA's
        Cholesky alone (cuSOLVER potrf) and with its triangular inverse
        (plus cuBLAS trsm), at (n=64, B=1024) and (n=128, B=256) in f32 and
        f64.
fleet:  warm-started solve_batch throughput at the same shapes, f64 and
        mixed precision, for the plain factor (pallas_kernels=False) and
        the factor with its inverse (pallas_kernels=True).
cr:     the T=100 multistage solve with the cyclic-reduction chain step in
        the factor-with-inverse composition against the plain factor.

Prints one JSON line per measurement with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from piqp_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

CARD = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True,
).stdout.strip()


def emit(**kw):
    kw["card"] = CARD
    print(json.dumps(kw), flush=True)


def wall(fn, reps=5):
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def spd(B, n, dt, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.uniform(-1, 1, (B, n, n))
    K = Q @ np.swapaxes(Q, 1, 2) + n * np.eye(n)
    d = 1.0 / np.sqrt(np.einsum("bii->bi", K))
    return jnp.asarray(K * d[:, :, None] * d[:, None, :], dt)


def bench_kernel():
    from devtrace import device_time
    from piqp_tpu.ops import pallas_chol as pc

    for n, B in ((64, 1024), (128, 256)):
        for dt in (jnp.float32, jnp.float64):
            K = spd(B, n, dt, seed=n)
            Kn = np.asarray(K, np.float64)
            L_ref = np.linalg.cholesky(Kn)
            cands = {"xla": jax.jit(jax.vmap(pc.cholesky_with_inverse)),
                     "xla_chol_only": jax.jit(jax.vmap(jnp.linalg.cholesky))}
            for name, f in cands.items():
                try:
                    out = jax.block_until_ready(f(K))
                    L = out[0] if isinstance(out, tuple) else out
                    err = float(np.max(np.abs(np.asarray(L, np.float64)
                                              - L_ref)))
                    tr = device_time(lambda: jax.block_until_ready(f(K)), 10)
                    emit(what="kernel", n=n, B=B, dtype=jnp.dtype(dt).name,
                         impl=name, max_err_vs_numpy=err,
                         device_us=tr["busy_ns_per_call"] / 1e3,
                         wall_us=wall(lambda: jax.block_until_ready(f(K)))
                         * 1e6,
                         top=[(k[:60], v / 1e3) for k, v in tr["top_kernels"]],
                         lines=tr["lines"][:6])
                except Exception as e:
                    emit(what="kernel", n=n, B=B, dtype=jnp.dtype(dt).name,
                         impl=name, error=repr(e)[:400])


def bench_fleet():
    from piqp_tpu import Settings, prepare_batch, solve_batch
    from piqp_tpu import warm_from_result
    from piqp_tpu.utils.random import dense_strongly_convex_qp

    for n, B in ((64, 1024), (128, 256)):
        probs = [dense_strongly_convex_qp(n, n // 4, n // 2, seed=9000 + i)
                 for i in range(B)]
        data = prepare_batch(probs)
        base = Settings(pallas_kernels=False)
        warm = warm_from_result(solve_batch(data, base))
        data2 = data.replace(c=data.c * 1.01)
        for mixed in (False, True):
            for impl in ("plain", "inv_xla"):
                s = Settings(pallas_kernels=impl != "plain",
                             mixed_precision=mixed)
                run = lambda: jax.block_until_ready(
                    solve_batch(data2, s, warm=warm))
                t0 = time.perf_counter()
                res = run()
                t_first = time.perf_counter() - t0
                st = np.asarray(res.info.status)
                it = np.asarray(res.info.iter)
                t = wall(run, reps=3)
                emit(what="fleet", n=n, B=B, mixed=mixed, impl=impl,
                     solved=int(np.sum(st == 1)), iters_mean=float(it.mean()),
                     iters_max=int(it.max()), first_call_s=t_first,
                     warm_solve_s=t, solves_per_s=B / t)


def bench_cr():
    from devtrace import device_time
    from piqp_tpu import Settings, solve_prepared
    from piqp_tpu import multistage as ms

    sd = jax.device_put(
        ms.random_multistage_qp(T=100, D=8, Da=4, ra=4, rg=4, seed=4))
    for impl, pk in (("plain", False), ("inv_composition", True)):
        s = Settings(pallas_kernels=pk)
        run = lambda: jax.block_until_ready(solve_prepared(sd, s))
        res = run()
        tr = device_time(run, 3)
        emit(what="cr_T100", impl=impl, status=int(res.info.status),
             iters=int(res.info.iter), solve_ms=wall(run) * 1e3,
             device_ms=tr["busy_ns_per_call"] / 1e6,
             top=[(k[:60], v / 1e3) for k, v in tr["top_kernels"]])


def main():
    if jax.devices()[0].platform != "gpu":
        print("chol_kernel_bench: needs a GPU", file=sys.stderr)
        return 1
    enable_compile_cache()
    which = sys.argv[1:] or ["kernel", "fleet", "cr"]
    for w in which:
        {"kernel": bench_kernel, "fleet": bench_fleet, "cr": bench_cr}[w]()
    return 0


if __name__ == "__main__":
    sys.exit(main())

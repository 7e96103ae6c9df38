"""Dense solver size sweep — the analog of the reference's
dense_sparse_solver_benchmark (/root/reference/benchmarks/src/
dense_sparse_solver_benchmark.cpp:17-56): strongly convex QPs with
n_eq = n_ineq = dim/2 over a range of dimensions.

Per dimension, prints one JSON line with:
  - warm single-solve latency on the accelerator,
  - batched throughput (batch sized so B * n stays bounded),
  - sequential single-solve latency on the host CPU backend (the stand-in
    for the reference's single-core solve).

Each dimension runs in its own subprocess, one JAX process on the card
at a time.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

import piqp_tpu
from piqp_tpu import Settings
from piqp_tpu.api import _solve_fresh
from piqp_tpu.batch import _solve_batch_jit, prepare_batch
from piqp_tpu.utils.random import dense_strongly_convex_qp

DIMS = [16, 32, 64, 128, 256, 512]
REPS = 10


def batch_for(n):
    # keep B * n bounded
    return int(max(8, min(256, 2 ** int(np.log2(max(1, 16384 // n))))))


def run_one(n):
    settings = Settings()
    if True:
        p, m = n // 2, n // 2
        prob = dense_strongly_convex_qp(n, p, m, seed=0)
        data = prepare_batch([prob])
        one = jax.tree.map(lambda x: x[0], data)

        # accelerator single-solve latency
        r, _ = _solve_fresh(one, settings, True)
        jax.block_until_ready(r)
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            r, _ = _solve_fresh(one, settings, True)
            jax.block_until_ready(r)
            ts.append(time.perf_counter() - t0)
        single_ms = float(np.median(ts)) * 1e3

        # batched throughput
        B = batch_for(n)
        bdata = prepare_batch(
            [dense_strongly_convex_qp(n, p, m, seed=i) for i in range(B)]
        )
        res = jax.block_until_ready(_solve_batch_jit(bdata, settings, True))
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            res = jax.block_until_ready(_solve_batch_jit(bdata, settings, True))
            ts.append(time.perf_counter() - t0)
        thr = B / float(np.median(ts))
        solved = int(jnp.sum(res.info.status == 1))

        # host CPU single-solve
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            onec = jax.device_put(one, cpu)
            r, _ = _solve_fresh(onec, settings, True)
            jax.block_until_ready(r)
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                r, _ = _solve_fresh(onec, settings, True)
                jax.block_until_ready(r)
                ts.append(time.perf_counter() - t0)
        cpu_ms = float(np.median(ts)) * 1e3

        print(
            json.dumps(
                dict(
                    n=n, p=p, m=m,
                    single_solve_ms=round(single_ms, 3),
                    batch=B,
                    batch_throughput_per_s=round(thr, 1),
                    batch_solved=solved,
                    cpu_single_solve_ms=round(cpu_ms, 3),
                    device=str(jax.devices()[0]),
                )
            ),
            flush=True,
        )


def main():
    import subprocess

    for n in DIMS:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), str(n)],
            capture_output=True, text=True, timeout=1800,
        )
        out = [l for l in r.stdout.splitlines() if l.startswith("{")]
        print(out[-1] if out else json.dumps(dict(n=n, error=r.stderr[-200:])),
              flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        run_one(int(sys.argv[1]))
    else:
        main()

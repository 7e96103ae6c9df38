"""Generate the BASELINE-config-2 batch (B dense strongly-convex QPs of one
size) and write it as the flat binary consumed by benchmarks/ref_driver.cpp.

The SAME generator (piqp_tpu.utils.random.dense_strongly_convex_qp, seeds
base_seed..base_seed+B-1) is used by the JAX side (bench.py), so the
reference solver and the JAX solver race on identical problem data.
Mirrors the reference harness dimensions
(benchmarks/src/dense_sparse_solver_benchmark.cpp:17-56: n_eq = n_ineq =
dim/2).
"""

from __future__ import annotations

import struct
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from piqp_tpu.utils.random import dense_strongly_convex_qp  # noqa: E402

PIQP_INF = 1e30


def batch_problems(dim: int, count: int, base_seed: int = 1000):
    return [
        dense_strongly_convex_qp(dim, dim // 2, dim // 2, seed=base_seed + i)
        for i in range(count)
    ]


def write_batch(path: str, problems) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<q", len(problems)))
        for prob in problems:
            n = prob["P"].shape[0]
            p = prob["A"].shape[0]
            m = prob["G"].shape[0]
            f.write(struct.pack("<qqq", n, p, m))
            for key in ("P", "c", "A", "b", "G", "h_l", "h_u", "x_l", "x_u"):
                arr = np.ascontiguousarray(prob[key], dtype=np.float64)
                arr = np.clip(arr, -PIQP_INF, PIQP_INF)  # inf -> +/-1e30
                f.write(arr.tobytes())


if __name__ == "__main__":
    dim = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    count = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    out = sys.argv[3] if len(sys.argv) > 3 else f"/tmp/batch_n{dim}_B{count}.bin"
    write_batch(out, batch_problems(dim, count))
    print(out)

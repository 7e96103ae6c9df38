"""Config-5 analog scaling curves on the virtual 8-device CPU mesh.

Two curves (BASELINE.md configs 4/5):
  dp: batched fleet of tiny QPs, batch axis sharded over 1/2/4/8 devices
      (10k-scenario stochastic QP analog);
  sp: horizon-sharded multistage solve latency vs T at 1/2/4/8 devices.

HONESTY NOTE (printed in the output): this host exposes ONE physical CPU
core, so all virtual devices share it and wall-clock "speedup" is not
observable — the curves assert the *structural* scaling facts instead:
  - dp executables contain ZERO collectives (embarrassingly parallel: on
    real hardware the batch scales linearly by construction), and per-
    device memory/work shrinks as B/ndev;
  - sp executables carry a collective count independent of T (pinned by
    tests/test_comm_structure.py) and O(ndev * D^2) exchanged volume.
Wall times are reported for completeness; on >=8-core hosts or real
multi-chip meshes the same script produces true scaling curves.

Usage: python benchmarks/scaling_curve.py [B] (CPU-only; forces the
virtual mesh).  Prints one JSON line per point.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import jax.numpy as jnp

try:
    jax.config.update("jax_platforms", "cpu")
except Exception:
    pass
from piqp_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

from piqp_tpu import Settings
from piqp_tpu import multistage as ms
from piqp_tpu.batch import _solve_batch_jit, prepare_batch
from piqp_tpu.parallel import shard_horizon
from piqp_tpu.parallel.horizon import _solve_sharded_jit
from piqp_tpu.utils.random import dense_strongly_convex_qp

_COLLECTIVE_RE = re.compile(
    r"\b(all-reduce|all-gather|collective-permute|all-to-all|reduce-scatter)\b"
)


def _collective_count(hlo: str) -> tuple[int, int]:
    """(data_collectives, pred_collectives): scalar pred[] all-reduces are
    the lockstep while-loop conditions XLA inserts for any sharded
    lax.while_loop (O(1) bytes, not data movement) — counted separately so
    'zero data collectives' remains the dp linear-scaling guarantee."""
    n = npred = 0
    for line in hlo.splitlines():
        if "=" in line and _COLLECTIVE_RE.search(line.split("=", 1)[1][:80]):
            if "pred[] all-reduce" in line:
                npred += 1
            else:
                n += 1
    return n, npred


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    settings = Settings()
    n, p, m = 16, 4, 8

    probs = [dense_strongly_convex_qp(n, p, m, seed=500 + i) for i in range(B)]
    data = prepare_batch(probs)

    # ---- dp curve ----
    for ndev in (1, 2, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:ndev]), ("dp",))
        sharded = jax.tree.map(
            lambda x: jax.device_put(
                x, NamedSharding(mesh, PS("dp", *([None] * (x.ndim - 1))))
            ),
            data,
        )
        with mesh:
            lowered = _solve_batch_jit.lower(sharded, settings, True, None)
            compiled = lowered.compile()
            hlo = compiled.as_text()
            res = compiled(sharded, None)
            jax.block_until_ready(res)
            t0 = time.perf_counter()
            res = compiled(sharded, None)
            jax.block_until_ready(res)
            dt = time.perf_counter() - t0
        datac, predc = _collective_count(hlo)
        print(json.dumps(dict(
            curve="dp", ndev=ndev, B=B, n=n,
            wall_s=round(dt, 3),
            qps_per_s=round(B / dt, 1),
            data_collectives=datac, pred_collectives=predc,
            solved=int(jnp.sum(res.info.status == 1)),
            note="1-core host: devices share a core; data_collectives==0 "
                 "is the linear-scaling guarantee (pred[] loop-condition "
                 "all-reduces move O(1) bytes)",
        )), flush=True)

    # ---- sp curve ----
    for ndev in (1, 2, 4, 8):
        for T in (32, 64):
            mesh = Mesh(np.array(jax.devices()[:ndev]), ("sp",))
            sdata = ms.random_multistage_qp(T=T, D=4, Da=2, ra=2, rg=2, seed=0)
            sh = shard_horizon(sdata, mesh, "sp")
            with mesh:
                lowered = _solve_sharded_jit.lower(sh, settings, True, None)
                compiled = lowered.compile()
                hlo = compiled.as_text()
                res = compiled(sh, None)
                jax.block_until_ready(res)
                t0 = time.perf_counter()
                res = compiled(sh, None)
                jax.block_until_ready(res)
                dt = time.perf_counter() - t0
            datac, predc = _collective_count(hlo)
            print(json.dumps(dict(
                curve="sp", ndev=ndev, T=T,
                wall_s=round(dt, 3),
                data_collectives=datac, pred_collectives=predc,
                status=int(res.info.status),
            )), flush=True)


if __name__ == "__main__":
    main()

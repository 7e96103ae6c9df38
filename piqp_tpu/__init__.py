"""piqp_tpu — an accelerator-native proximal interior-point QP solver framework.

A from-scratch JAX/XLA re-design with the capabilities of PIQP
(PREDICT-EPFL/piqp): an infeasible primal-dual interior-point method combined
with the proximal method of multipliers, solving convex QPs

    min 0.5 x'Px + c'x   s.t.  Ax = b,  h_l <= Gx <= h_u,  x_l <= x <= x_u

Everything is pure-functional JAX under the hood: solves jit-compile once per
problem shape, ``vmap`` gives batched solves of thousands of QPs, and
``jax.sharding`` scales batches and multistage horizons across GPUs.
"""

import jax as _jax

# The solver targets float64 parity with the reference by default; JAX needs
# the explicit opt-in.  float32 (+ iterative refinement) is the fast path.
_jax.config.update("jax_enable_x64", True)

from .types import (  # noqa: E402
    PIQP_INF,
    Info,
    KKTBackend,
    QPData,
    Result,
    Scaling,
    Settings,
    Status,
    status_to_string,
)
from .api import (  # noqa: E402
    DenseSolver,
    has_cone,
    prepare_data,
    solve_dense,
    solve_prepared,
)
from .sparse import SparseSolver  # noqa: E402
from .batch import (  # noqa: E402
    prepare_batch,
    solve_batch,
    solve_batch_compact,
    solve_batch_sqp,
    warm_from_result,
)
from . import multistage  # noqa: E402  (registers the block backend dispatch)
from .multistage import StageQPData  # noqa: E402
from . import parallel  # noqa: E402  (registers the sharded backend dispatch)
from .parallel import (  # noqa: E402
    ShardedStageQPData,
    shard_horizon,
    solve_horizon_sharded,
)
from .diff import qp_layer, solve_qp_diff  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "PIQP_INF",
    "DenseSolver",
    "SparseSolver",
    "Info",
    "KKTBackend",
    "QPData",
    "Result",
    "Scaling",
    "Settings",
    "Status",
    "status_to_string",
    "has_cone",
    "prepare_data",
    "prepare_batch",
    "solve_dense",
    "solve_prepared",
    "solve_batch",
    "solve_batch_compact",
    "solve_batch_sqp",
    "warm_from_result",
    "StageQPData",
    "ShardedStageQPData",
    "shard_horizon",
    "solve_horizon_sharded",
    "qp_layer",
    "solve_qp_diff",
    "__version__",
]

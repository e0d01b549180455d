"""Batched Gauss-Newton / Levenberg-Marquardt factor-graph engine.

JAX replacement for the reference's g2o stack
(orb_slam3/Thirdparty/g2o + orb_slam3/src/Optimizer.cc's 12 BA/PGO variants).
One engine, a factor registry, Schur elimination of landmarks, dense reduced
solves as batched matrix products — instead of sparse CPU block solvers.
"""

from visual_sgraphs.optim.graph import (  # noqa: F401
    FactorBatch,
    VarFamily,
    GraphProblem,
    se3_family,
    sim3_family,
    point_family,
    plane_family,
)
from visual_sgraphs.optim.solve import (  # noqa: F401
    OptimizeResult,
    gate_masks,
    optimize,
    optimize_rounds,
    problem_cost,
)
from visual_sgraphs.optim import factors  # noqa: F401

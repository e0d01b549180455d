"""Multi-chip / multi-host scaling: sharded bundle adjustment.

The reference has no distributed execution at all (SURVEY §2.7); this package
is the multi-device scaling story: the factor graph is sharded over a
``jax.sharding.Mesh``, per-device partial normal equations are assembled
locally and reduced with ``psum`` over the interconnect, and the reduced camera system is
solved replicated (small) — the covisibility-block partitioning of
BASELINE.json's north star.
"""

from visual_sgraphs.parallel.dist_ba import (  # noqa: F401
    global_ba_sharded,
    group_observations,
    make_mesh,
    sharded_ba,
    sharded_ba_grouped,
)
from visual_sgraphs.parallel.distributed import (  # noqa: F401
    maybe_initialize_distributed,
)

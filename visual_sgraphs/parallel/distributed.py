"""Multi-host bootstrap: ``jax.distributed`` initialization behind a flag.

The reference's only "network" layer is single-machine ROS pub/sub
(SURVEY §5.8); this rebuild scales the sharded BA across devices and hosts
with JAX collectives instead (NCCL over NVLink within a host).  Because most
deployments are single-host, the multi-host runtime is opt-in:

    VSG_DISTRIBUTED=1 [VSG_COORDINATOR=host:port VSG_NUM_PROCESSES=N
    VSG_PROCESS_ID=i] python ...

Where no cluster manager describes the job, all three detail variables
must be given (the coordinator can be ``localhost:<port>`` on one host).
After initialization, ``jax.devices()`` spans every host and
``make_mesh()`` builds the global mesh, so the landmark-sharded BA's one
``psum`` per iteration crosses hosts unchanged.
"""

from __future__ import annotations

import os

_initialized = False


def maybe_initialize_distributed() -> bool:
    """Initialize ``jax.distributed`` when VSG_DISTRIBUTED=1 (idempotent).

    Returns True when the distributed runtime is active."""
    global _initialized
    if _initialized:
        return True
    if os.environ.get("VSG_DISTRIBUTED", "0") != "1":
        return False
    import jax

    kwargs = {}
    if os.environ.get("VSG_COORDINATOR"):
        kwargs["coordinator_address"] = os.environ["VSG_COORDINATOR"]
    if os.environ.get("VSG_NUM_PROCESSES"):
        kwargs["num_processes"] = int(os.environ["VSG_NUM_PROCESSES"])
    if os.environ.get("VSG_PROCESS_ID"):
        kwargs["process_id"] = int(os.environ["VSG_PROCESS_ID"])
    jax.distributed.initialize(**kwargs)
    _initialized = True
    return True

"""visual_sgraphs: a visual S-Graphs engine in JAX/XLA.

A from-scratch rebuild of the capability set of snt-arg/visual_sgraphs
(ORB-SLAM3 + hierarchical 3D scene graphs; see SURVEY.md) for an
accelerator (one or four NVIDIA GPUs):

- the map is an immutable pytree of fixed-capacity arrays advanced by a
  single-writer update loop (no mutexes, no threads);
- per-item loops of the reference become ``vmap``/``lax.scan``;
- all g2o graphs become one batched Gauss-Newton/Levenberg-Marquardt engine
  with a factor registry and Schur elimination of landmarks;
- hot image/descriptor ops are batched jax.numpy programs XLA fuses;
- multi-device scaling is ``jax.sharding`` over keyframe-covisibility blocks.
"""

__version__ = "0.1.0"

from visual_sgraphs import core  # noqa: F401

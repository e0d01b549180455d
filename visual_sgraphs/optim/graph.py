"""Factor-graph problem representation: variable families + factor batches.

The reference builds a fresh g2o ``SparseOptimizer`` per solve, adding
vertices/edges in per-item loops (e.g. Optimizer.cc:1454-2455 for local BA).
Here a problem is a *static-shape pytree*: every variable family is a fixed
capacity table with a validity/fixed mask, every factor type is one batch with
index arrays, and the whole solve jits once per shape bucket.

Variable families
-----------------
A family is a table of like-typed variables (all keyframe poses, all map
points, all planes ...) with

- ``values``   (n, store_dim) storage,
- ``tangent_dim`` the chart dimension used by the optimizer,
- ``retract``  the boxplus map applied per row,
- ``fixed``    (n,) rows held constant (gauge / fixed keyframes).

Factor batches
--------------
A batch is *all* factors of one type: a residual function evaluated per item
on gathered variable rows plus per-item constants, with per-item information
weights, validity mask, optional Huber robustification and chi2 gate.
Jacobians are forward-mode autodiff through ``retract`` at delta=0 — no
hand-derived Jacobians anywhere (the reference hand-codes every
``linearizeOplus``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import jax
import jax.numpy as jnp

from visual_sgraphs.core import lie, plane as plane_mod

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VarFamily:
    """A fixed-capacity table of variables of one geometric type."""

    values: Array  # (n, store_dim)
    fixed: Array  # (n,) bool — excluded from the update
    tangent_dim: int = dataclasses.field(metadata=dict(static=True))
    retract: Callable[[Array, Array], Array] = dataclasses.field(
        metadata=dict(static=True)
    )  # (store_dim,), (tangent_dim,) -> (store_dim,)

    @property
    def n(self) -> int:
        return self.values.shape[0]


def se3_family(values: Array, fixed: Array | None = None) -> VarFamily:
    if fixed is None:
        fixed = jnp.zeros(values.shape[0], bool)
    return VarFamily(values=values, fixed=fixed, tangent_dim=6,
                     retract=lie.se3_boxplus)


def point_family(values: Array, fixed: Array | None = None) -> VarFamily:
    if fixed is None:
        fixed = jnp.zeros(values.shape[0], bool)
    return VarFamily(values=values, fixed=fixed, tangent_dim=3,
                     retract=lambda v, d: v + d)


def plane_family(values: Array, fixed: Array | None = None) -> VarFamily:
    """Planes with the 3-dof azimuth/elevation/distance chart (g2o VertexPlane
    equivalent, Thirdparty/g2o/g2o/types/vertex_plane.h)."""
    if fixed is None:
        fixed = jnp.zeros(values.shape[0], bool)
    return VarFamily(values=values, fixed=fixed, tangent_dim=3,
                     retract=plane_mod.oplus)


def sim3_family(values: Array, fixed: Array | None = None) -> VarFamily:
    if fixed is None:
        fixed = jnp.zeros(values.shape[0], bool)
    return VarFamily(values=values, fixed=fixed, tangent_dim=7,
                     retract=lie.sim3_boxplus)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FactorBatch:
    """All factors of one type, as a batch of m items.

    ``residual_fn(values: tuple[Array, ...], const: pytree) -> (res_dim,)``
    receives one gathered row per connected family and this item's constants.
    """

    families: tuple[str, ...] = dataclasses.field(metadata=dict(static=True))
    residual_fn: Callable[..., Array] = dataclasses.field(
        metadata=dict(static=True)
    )
    res_dim: int = dataclasses.field(metadata=dict(static=True))
    var_idx: Array  # (m, len(families)) int32 rows into each family
    const: Any  # pytree with leading dim m
    info: Array  # (m,) or (m, res_dim) information (1/sigma^2) weights
    valid: Array  # (m,) bool
    # Huber robust kernel half-width in *whitened* residual units (sqrt chi2);
    # None disables (static so it participates in tracing).
    huber: float | None = dataclasses.field(default=None,
                                            metadata=dict(static=True))
    # chi2 gate: items whose whitened squared norm exceeds this are masked
    # out *between rounds* by optimize_rounds (the reference's setLevel(1)
    # outlier marking, Optimizer.cc:1256+). None disables.
    chi2_gate: float | None = dataclasses.field(default=None,
                                                metadata=dict(static=True))

    @property
    def m(self) -> int:
        return self.var_idx.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GraphProblem:
    """A full nonlinear least-squares problem over named variable families.

    ``eliminated`` names at most one family (the landmarks) that is removed
    from the dense reduced system by Schur complement — everything else
    (poses, planes, rooms, doors, markers) stays in the dense block, mirroring
    how the reference marginalizes only map points
    (Optimizer.cc:1860+ setMarginalized).
    """

    families: Mapping[str, VarFamily]
    factors: Sequence[FactorBatch]
    eliminated: str | None = dataclasses.field(default=None,
                                               metadata=dict(static=True))

    def reduced_names(self) -> tuple[str, ...]:
        return tuple(k for k in self.families.keys() if k != self.eliminated)

    def reduced_dim(self) -> int:
        return sum(self.families[k].n * self.families[k].tangent_dim
                   for k in self.reduced_names())

    def offsets(self) -> dict[str, int]:
        off, out = 0, {}
        for k in self.reduced_names():
            out[k] = off
            off += self.families[k].n * self.families[k].tangent_dim
        return out


def linearize_batch(
    batch: FactorBatch, families: Mapping[str, VarFamily]
) -> tuple[Array, tuple[Array, ...], Array]:
    """Residuals and per-family Jacobians for every item of a factor batch.

    Returns ``(r (m, res_dim), jacs tuple of (m, res_dim, t_k), w (m,))``.
    Residuals and Jacobians come back *whitened* by sqrt(information), so the
    normal equations use them directly; ``w`` folds validity, Huber weight and
    the chi2 gate into one per-item multiplier.
    """
    fams = [families[name] for name in batch.families]
    gathered = tuple(f.values[batch.var_idx[:, i]] for i, f in enumerate(fams))
    tangent_zeros = tuple(
        jnp.zeros(batch.var_idx.shape[:1] + (f.tangent_dim,),
                  fams[0].values.dtype)
        for f in fams
    )

    def item_residual(deltas, values, const):
        retracted = tuple(
            f.retract(v, d) for f, v, d in zip(fams, values, deltas)
        )
        return batch.residual_fn(retracted, const)

    def item_lin(deltas, values, const):
        r = item_residual(deltas, values, const)
        jacs = jax.jacfwd(item_residual)(deltas, values, const)
        return r, jacs

    r, jacs = jax.vmap(item_lin)(tangent_zeros, gathered, batch.const)

    # whiten by sqrt(information): per-item scalar or per-residual-dim
    info = batch.info
    sqrt_info = jnp.sqrt(info)
    if info.ndim == 1:
        r = r * sqrt_info[:, None]
        jacs = tuple(j * sqrt_info[:, None, None] for j in jacs)
    else:
        r = r * sqrt_info
        jacs = tuple(j * sqrt_info[..., None] for j in jacs)

    chi2 = jnp.sum(r * r, axis=-1)
    w = jnp.where(batch.valid, 1.0, 0.0)
    if batch.huber is not None:
        # Huber as iteratively-reweighted least squares: w_h = min(1, δ/√chi2)
        s = jnp.sqrt(jnp.maximum(chi2, 1e-12))
        w = w * jnp.minimum(1.0, batch.huber / s)
    # chi2_gate is deliberately NOT applied here: gating happens only between
    # rounds (optimize_rounds), like the reference's outlier re-marking —
    # a per-iteration gate would let LM "improve" cost by ejecting items.
    return r, jacs, w


def batch_chi2(batch: FactorBatch, families: Mapping[str, VarFamily]) -> Array:
    """Per-item whitened squared residual (no Huber), for gating decisions."""
    fams = [families[name] for name in batch.families]
    gathered = tuple(f.values[batch.var_idx[:, i]] for i, f in enumerate(fams))
    r = jax.vmap(lambda vals, c: batch.residual_fn(vals, c))(gathered, batch.const)
    if batch.info.ndim == 1:
        return batch.info * jnp.sum(r * r, axis=-1)
    return jnp.sum(batch.info * r * r, axis=-1)

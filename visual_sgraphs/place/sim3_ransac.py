"""Batched Sim3/SE3 RANSAC between matched 3D point sets.

Replaces the reference's sequential ``Sim3Solver`` (orb_slam3/src/
Sim3Solver.cc: iterate -> sample 3 -> Horn -> count inliers -> repeat).
All H hypotheses are drawn and solved at once: one vmap'd closed-form Horn
solve over (H, 3, 3) samples and one (H, M) distance matrix for inlier
counting — RANSAC as two dense tensor ops instead of a loop.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from visual_sgraphs.core import geometry, lie


class Sim3Result(NamedTuple):
    S_ab: jax.Array  # (8,) Sim3 mapping frame-a points into frame-b
    inliers: jax.Array  # (M,) bool
    n_inliers: jax.Array  # () int32


@partial(jax.jit, static_argnames=("n_hyp", "fix_scale"))
def ransac_sim3(
    p_a: jax.Array,
    p_b: jax.Array,
    valid: jax.Array,
    key: jax.Array,
    n_hyp: int = 256,
    inlier_thresh: float = 0.10,
    fix_scale: bool = False,
) -> Sim3Result:
    """Estimate the similarity S_ab with p_b ~= S_ab . p_a.

    ``p_a``/``p_b``: (M, 3) matched points (invalid rows arbitrary);
    ``inlier_thresh`` is a metric 3D residual gate (the reference gates on
    reprojection chi2 in both frames, Sim3Solver.cc:CheckInliers; a metric
    gate is the calibrated-depth equivalent).  Degenerate (collinear) samples
    produce poor hypotheses and simply lose the inlier vote.
    """
    M = p_a.shape[0]
    w = valid.astype(jnp.float32)
    probs = w / jnp.maximum(jnp.sum(w), 1.0)
    samples = jax.random.choice(
        key, M, shape=(n_hyp, 3), replace=True, p=probs
    )

    S_hyp = jax.vmap(
        lambda idx: geometry.horn_sim3(p_a[idx], p_b[idx],
                                       fix_scale=fix_scale)
    )(samples)  # (H, 8)

    pred = jax.vmap(lambda S: lie.sim3_apply(S, p_a))(S_hyp)  # (H, M, 3)
    err = jnp.linalg.norm(pred - p_b[None], axis=-1)
    inl = (err < inlier_thresh) & valid[None, :]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)

    # polish: weighted Horn on the best hypothesis' inliers
    w_best = inl[best].astype(jnp.float32)
    S_ref = geometry.horn_sim3(p_a, p_b, weights=w_best + 1e-9,
                               fix_scale=fix_scale)
    err_ref = jnp.linalg.norm(lie.sim3_apply(S_ref, p_a) - p_b, axis=-1)
    inl_ref = (err_ref < inlier_thresh) & valid
    # keep the polish only if it didn't lose support
    better = jnp.sum(inl_ref) >= counts[best]
    S_out = jnp.where(better, S_ref, S_hyp[best])
    inl_out = jnp.where(better, inl_ref, inl[best])
    return Sim3Result(S_ab=S_out, inliers=inl_out,
                      n_inliers=jnp.sum(inl_out).astype(jnp.int32))


@partial(jax.jit, static_argnames=("iters", "fix_scale"))
def refine_sim3(S: jax.Array, p_a: jax.Array, p_b: jax.Array,
                valid: jax.Array, inlier_thresh: float = 0.10,
                iters: int = 5, fix_scale: bool = False) -> Sim3Result:
    """Nonlinear Sim3 refinement over all matches with Huber IRLS — the
    OptimizeSim3 step the reference runs after RANSAC acceptance
    (Optimizer.cc:3261; it refines on reprojection in both images — with
    calibrated depth the 3D alignment residual r = S·p_a − p_b carries the
    same constraint).  Gauss-Newton on the 7-dof tangent with re-gating per
    iteration; returns the refreshed inlier classification."""

    def step(S, _):
        def res(xi):
            Sx = lie.sim3_boxplus(S, xi)
            return lie.sim3_apply(Sx, p_a) - p_b  # (M, 3)

        z = jnp.zeros((7,), S.dtype)
        r = res(z)
        J = jax.jacfwd(res)(z)  # (M, 3, 7)
        d = jnp.linalg.norm(r, axis=-1)
        w = jnp.where(valid & (d < inlier_thresh * 3.0),
                      jnp.minimum(1.0, inlier_thresh / jnp.maximum(d, 1e-9)),
                      0.0)
        Jw = J * w[:, None, None]
        H = jnp.einsum("mri,mrj->ij", Jw, J)
        g = jnp.einsum("mri,mr->i", Jw, r)
        if fix_scale:
            H = H.at[6, :].set(0.0).at[:, 6].set(0.0).at[6, 6].set(1.0)
            g = g.at[6].set(0.0)
        H = H + jnp.eye(7, dtype=H.dtype) * 1e-5
        dx = jnp.linalg.solve(H, -g)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        return lie.sim3_normalize(lie.sim3_boxplus(S, dx)), None

    S, _ = jax.lax.scan(step, S, None, length=iters)
    err = jnp.linalg.norm(lie.sim3_apply(S, p_a) - p_b, axis=-1)
    inl = (err < inlier_thresh) & valid
    return Sim3Result(S_ab=S, inliers=inl,
                      n_inliers=jnp.sum(inl.astype(jnp.int32)))

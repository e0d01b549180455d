"""Batched PnP RANSAC for relocalization.

Replaces the reference's MLPnPsolver (orb_slam3/src/MLPnPsolver.cpp, used by
Tracking::Relocalization at Tracking.cc:3732): instead of an iterative
maximum-likelihood solver with sequential RANSAC, every hypothesis is solved
*simultaneously* — H minimal 6-point DLT problems as one batched SVD (a
batched (H, 12, 12) eigendecomposition), scored against all matches with
one projection matmul, winner refined by the analytic pose-only GN.

The 6-point DLT (P6P) trades the reference's 3-point minimal solver for a
batched-friendly linear one: no polynomial root finding, no per-hypothesis
control flow — hypothesis count covers the slightly higher sample size.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from visual_sgraphs.core import cameras, lie


class PnPResult(NamedTuple):
    T_cw: jax.Array  # (7,) best pose
    n_inliers: jax.Array  # ()
    inliers: jax.Array  # (M,) bool


def _dlt_pose(xw: jax.Array, xy: jax.Array):
    """One 6-point DLT: world points (6, 3) + normalized image points
    (6, 2) -> T_cw (7,).  Solves the 3x4 projection P (up to scale) from
    A p = 0, then orthonormalizes the rotation block (procrustes)."""
    n = xw.shape[0]
    X = jnp.concatenate([xw, jnp.ones((n, 1), xw.dtype)], axis=1)  # (6,4)
    zero = jnp.zeros_like(X)
    # rows: [X 0 -x*X ; 0 X -y*X]
    r1 = jnp.concatenate([X, zero, -xy[:, 0:1] * X], axis=1)
    r2 = jnp.concatenate([zero, X, -xy[:, 1:2] * X], axis=1)
    A = jnp.concatenate([r1, r2], axis=0)  # (12, 12)
    # null vector = eigenvector of AᵀA with the smallest eigenvalue
    _, V = jnp.linalg.eigh(A.T @ A)
    p = V[:, 0]
    P = p.reshape(3, 4)
    M, t = P[:, :3], P[:, 3]
    # fix the sign so points land in front of the camera
    depth_sign = jnp.sign(jnp.sum(X[0, :3] @ M.T + t)[None] * 0 +
                          (X[0, :3] @ M[2] + t[2]))
    M = M * depth_sign
    t = t * depth_sign
    # procrustes: nearest rotation to M, consistent scale for t
    U, S, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.diag(jnp.asarray([1.0, 1.0, 1.0], M.dtype).at[2].set(det))
    R = U @ D @ Vt
    scale = jnp.mean(S)
    t = t / jnp.maximum(scale, 1e-9)
    q = lie.matrix_to_quat(R)
    return lie.se3_normalize(jnp.concatenate([q, t]))


@partial(jax.jit, static_argnames=("n_hyp", "refine_iters"))
def ransac_pnp(
    xw: jax.Array,  # (M, 3) world points
    uv: jax.Array,  # (M, 2) pixel observations
    valid: jax.Array,  # (M,)
    cam_K: jax.Array,
    key: jax.Array,
    n_hyp: int = 256,
    inlier_px: float = 5.0,
    refine_iters: int = 10,
) -> PnPResult:
    """All-hypotheses PnP: sample H 6-tuples, solve H DLTs as one batched
    eigh, score every hypothesis against every match in one matmul-shaped
    projection, refine the winner with the analytic pose-only GN.

    Mirrors MLPnPsolver::iterate's RANSAC loop (MLPnPsolver.cpp) with the
    sequential trials flattened into the batch dimension."""
    from visual_sgraphs.slam.tracking import pose_only_gn

    M = xw.shape[0]
    dt = xw.dtype
    # normalized image coordinates
    xy = jnp.stack(
        [(uv[:, 0] - cam_K[2]) / cam_K[0], (uv[:, 1] - cam_K[3]) / cam_K[1]],
        axis=1,
    )
    # weighted sampling: valid entries only (invalid get ~0 probability)
    logits = jnp.where(valid, 0.0, -1e9)
    picks = jax.random.categorical(
        key, logits[None, None, :], axis=-1, shape=(n_hyp, 6)
    )  # (H, 6)
    poses = jax.vmap(_dlt_pose)(xw[picks], xy[picks])  # (H, 7)

    # score: project all M points under all H poses
    def score(T):
        p = lie.se3_apply(T, xw)
        uvh = cameras.project_pinhole(cam_K, p)
        err = jnp.sum((uvh - uv) ** 2, axis=-1)
        inl = valid & (p[:, 2] > 0.05) & (err < inlier_px * inlier_px)
        return jnp.sum(inl.astype(jnp.int32))

    counts = jax.vmap(score)(poses)
    counts = jnp.where(jnp.all(jnp.isfinite(poses), axis=1), counts, -1)
    best = jnp.argmax(counts)
    T0 = poses[best]
    T0 = jnp.where(jnp.all(jnp.isfinite(T0)), T0, lie.se3_identity().astype(dt))

    # refinement: wide-gate GN over all matches from the winning pose
    T, inl = pose_only_gn(
        T0, xw, uv, valid, cam_K, iters=refine_iters,
        gate0=(4.0 * inlier_px) ** 2,
    )
    return PnPResult(T_cw=T, n_inliers=jnp.sum(inl.astype(jnp.int32)),
                     inliers=inl)

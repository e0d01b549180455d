"""Closed-form multi-view geometry: triangulation, Horn alignment, epipolar.

JAX equivalents of the reference's `GeometricTools::Triangulate`
(orb_slam3/src/GeometricTools.cc:30-68), the Horn closed-form alignment used
by its evaluation harness (evaluation/evaluate_ate_scale.py:50-80), and the
Sim3 Horn solve inside `Sim3Solver` (orb_slam3/src/Sim3Solver.cc).

All routines are batched (leading dims broadcast) and rely on dense 3x3/4x4
linear algebra — ideal shapes for vmap batching.
"""

from __future__ import annotations

import jax.numpy as jnp

from visual_sgraphs.core import lie


def triangulate_dlt(ray1, ray2, T_21):
    """Triangulate in frame 1 from unit-depth rays and relative pose T_21.

    ``ray*``: (..., 3) normalized image coordinates (z=1) in each camera;
    ``T_21``: (..., 7) SE3 mapping frame-1 points into frame 2.  Linear DLT:
    builds the 4x4 system A X = 0 and takes the smallest singular vector
    (GeometricTools.cc:30-68 does the same with Eigen::JacobiSVD).
    Returns (point_in_1 (...,3), depth1, depth2).
    """
    P1 = jnp.concatenate(
        [
            jnp.broadcast_to(jnp.eye(3, dtype=ray1.dtype), ray1.shape[:-1] + (3, 3)),
            jnp.zeros(ray1.shape[:-1] + (3, 1), ray1.dtype),
        ],
        axis=-1,
    )
    R = lie.quat_to_matrix(T_21[..., :4])
    t = T_21[..., 4:7]
    P2 = jnp.concatenate([R, t[..., :, None]], axis=-1)

    def rows(ray, P):
        x, y = ray[..., 0:1], ray[..., 1:2]
        r1 = x * P[..., 2, :] - P[..., 0, :]
        r2 = y * P[..., 2, :] - P[..., 1, :]
        return jnp.stack([r1, r2], axis=-2)

    A = jnp.concatenate([rows(ray1, P1), rows(ray2, P2)], axis=-2)
    # Smallest right-singular vector of A via eigh of AᵀA (4x4, batched)
    AtA = jnp.einsum("...ki,...kj->...ij", A, A)
    _, V = jnp.linalg.eigh(AtA)
    X = V[..., :, 0]
    w = X[..., 3]
    w_safe = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    p1 = X[..., :3] / w_safe[..., None]
    p2 = jnp.einsum("...ij,...j->...i", R, p1) + t
    return p1, p1[..., 2], p2[..., 2]


def parallax_cos(ray1, ray2, T_21):
    """Cosine of the parallax angle between the two viewing rays."""
    R = lie.quat_to_matrix(T_21[..., :4])
    r2_in_1 = jnp.einsum("...ji,...j->...i", R, ray2)  # Rᵀ ray2
    num = jnp.sum(ray1 * r2_in_1, axis=-1)
    den = jnp.linalg.norm(ray1, axis=-1) * jnp.linalg.norm(r2_in_1, axis=-1)
    return num / jnp.maximum(den, 1e-12)


def horn_se3(src, dst, weights=None):
    """Weighted closed-form rigid alignment: find (R, t) minimizing
    Σ w |R·src + t − dst|².  Horn's method via SVD of the correlation matrix
    (same algorithm as evaluate_ate_scale.py:align and Sim3Solver.cc
    ComputeSim3's rotation step).  Returns SE3 (..., 7)."""
    if weights is None:
        weights = jnp.ones(src.shape[:-1], src.dtype)
    w = weights / jnp.maximum(jnp.sum(weights, axis=-1, keepdims=True), 1e-12)
    mu_s = jnp.sum(w[..., None] * src, axis=-2)
    mu_d = jnp.sum(w[..., None] * dst, axis=-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    W = jnp.einsum("...n,...ni,...nj->...ij", w, dc, sc)
    U, _, Vt = jnp.linalg.svd(W)
    det = jnp.linalg.det(jnp.einsum("...ij,...jk->...ik", U, Vt))
    D = jnp.zeros(W.shape[:-2] + (3, 3), W.dtype)
    D = D.at[..., 0, 0].set(1.0).at[..., 1, 1].set(1.0).at[..., 2, 2].set(det)
    R = jnp.einsum("...ij,...jk,...kl->...il", U, D, Vt)
    t = mu_d - jnp.einsum("...ij,...j->...i", R, mu_s)
    return lie.se3_from_rt(lie.matrix_to_quat(R), t)


def horn_sim3(src, dst, weights=None, fix_scale: bool = False):
    """Closed-form similarity alignment (Horn with scale; Sim3Solver.cc:180+).

    Returns Sim3 (..., 8) mapping src -> dst.
    """
    if weights is None:
        weights = jnp.ones(src.shape[:-1], src.dtype)
    w = weights / jnp.maximum(jnp.sum(weights, axis=-1, keepdims=True), 1e-12)
    mu_s = jnp.sum(w[..., None] * src, axis=-2)
    mu_d = jnp.sum(w[..., None] * dst, axis=-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    W = jnp.einsum("...n,...ni,...nj->...ij", w, dc, sc)
    U, S, Vt = jnp.linalg.svd(W)
    det = jnp.linalg.det(jnp.einsum("...ij,...jk->...ik", U, Vt))
    D = jnp.zeros(W.shape[:-2] + (3, 3), W.dtype)
    D = D.at[..., 0, 0].set(1.0).at[..., 1, 1].set(1.0).at[..., 2, 2].set(det)
    R = jnp.einsum("...ij,...jk,...kl->...il", U, D, Vt)
    if fix_scale:
        s = jnp.ones(W.shape[:-2], W.dtype)
    else:
        var_s = jnp.sum(w * jnp.sum(sc * sc, axis=-1), axis=-1)
        trace_DS = S[..., 0] + S[..., 1] + det * S[..., 2]
        s = trace_DS / jnp.maximum(var_s, 1e-12)
    t = mu_d - s[..., None] * jnp.einsum("...ij,...j->...i", R, mu_s)
    q = lie.matrix_to_quat(R)
    return jnp.concatenate([q, t, s[..., None]], axis=-1)


def ate_rmse(est, gt, with_scale: bool = False):
    """Absolute trajectory error after Horn alignment — the reference's own
    metric (evaluation/evaluate_ate_scale.py).  ``est``/``gt``: (N, 3)."""
    S = horn_sim3(est, gt, fix_scale=not with_scale)
    aligned = lie.sim3_apply(S, est)
    err2 = jnp.sum((aligned - gt) ** 2, axis=-1)
    return jnp.sqrt(jnp.mean(err2)), S


def essential_from_pose(T_21):
    """E = [t]× R for relative pose T_21 (frame1 -> frame2)."""
    R = lie.quat_to_matrix(T_21[..., :4])
    return lie.hat(T_21[..., 4:7]) @ R


def sampson_error(E, x1, x2):
    """First-order geometric (Sampson) epipolar error for normalized coords."""
    x1h = jnp.concatenate([x1[..., :2], jnp.ones_like(x1[..., :1])], axis=-1)
    x2h = jnp.concatenate([x2[..., :2], jnp.ones_like(x2[..., :1])], axis=-1)
    Ex1 = jnp.einsum("...ij,...j->...i", E, x1h)
    Etx2 = jnp.einsum("...ji,...j->...i", E, x2h)
    num = jnp.sum(x2h * Ex1, axis=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / jnp.maximum(den, 1e-12)

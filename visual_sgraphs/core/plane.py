"""Minimal-chart 3D plane parameterization (azimuth/elevation/distance).

Behavioral equivalent of g2o's ``Plane3D``
(reference: orb_slam3/Thirdparty/g2o/g2o/types/plane3d.h:50-115) used by every
plane factor and plane association routine in vS-Graphs.  A plane is stored as
``coeffs = [nx, ny, nz, c]`` with ``|n| = 1``; the signed distance is
``d = -c`` (point on plane satisfies ``n·x + c = 0``).  The 3-dof local chart
is ``(azimuth, elevation, distance)`` of the normal expressed in the frame of
a reference plane — this is what makes plane updates well-conditioned inside
Gauss-Newton.

Pure JAX, batched over leading dims, vmap/jit-safe.
"""

from __future__ import annotations

import jax.numpy as jnp


def normalize(coeffs):
    """Scale so the normal part has unit length (sign preserved)."""
    n = jnp.linalg.norm(coeffs[..., :3], axis=-1, keepdims=True)
    return coeffs / jnp.maximum(n, jnp.finfo(coeffs.dtype).tiny)


def from_normal_distance(n, d):
    """Build coeffs from unit normal and signed distance (n·x = d)."""
    return normalize(jnp.concatenate([n, -d[..., None] if d.ndim < n.ndim else -d],
                                     axis=-1))


def plane_normal(coeffs):
    return coeffs[..., :3]


def plane_distance(coeffs):
    return -coeffs[..., 3]


def azimuth(v):
    return jnp.arctan2(v[..., 1], v[..., 0])


def elevation(v):
    return jnp.arctan2(v[..., 2], jnp.linalg.norm(v[..., :2], axis=-1))


def normal_rotation(v):
    """Rotation R = Rz(azimuth) @ Ry(-elevation) mapping +x to v/|v|.

    Mirrors plane3d.h:64-71; columns form an orthonormal frame whose first
    axis is the normal direction.
    """
    az, el = azimuth(v), elevation(v)
    ca, sa = jnp.cos(az), jnp.sin(az)
    ce, se = jnp.cos(el), jnp.sin(el)
    # Rz(az) @ Ry(-el); first column is the unit normal direction
    m = jnp.stack(
        [
            ca * ce, -sa, -ca * se,
            sa * ce, ca, -sa * se,
            se, jnp.zeros_like(az), ce,
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def oplus(coeffs, delta):
    """Apply chart perturbation ``delta = (d_az, d_el, d_dist)`` to a plane.

    The perturbation normal (built from azimuth/elevation) is rotated into the
    plane's own frame; the distance is additive (plane3d.h:73-89).
    """
    d_az, d_el, d_d = delta[..., 0], delta[..., 1], delta[..., 2]
    c, s = jnp.cos(d_el), jnp.sin(d_el)
    n_local = jnp.stack([c * jnp.cos(d_az), c * jnp.sin(d_az), s], axis=-1)
    R = normal_rotation(plane_normal(coeffs))
    n_new = jnp.einsum("...ij,...j->...i", R, n_local)
    d_new = plane_distance(coeffs) + d_d
    return normalize(jnp.concatenate([n_new, -d_new[..., None]], axis=-1))


def ominus(ref, other):
    """Chart coordinates of ``other`` relative to ``ref``: the exact inverse
    of ``oplus`` (plane3d.h:91-99).  Near-zero iff the planes coincide.

    Note: g2o's ominus returns ``d = ref.distance - other.distance`` while
    its oplus *adds* the distance perturbation — an internal sign asymmetry
    that is harmless there because the residual is squared.  We flip the sign
    so ``ominus(p, oplus(p, delta)) == delta`` holds exactly, which the
    Gauss-Newton retraction relies on.
    """
    R_T = jnp.swapaxes(normal_rotation(plane_normal(ref)), -1, -2)
    n = jnp.einsum("...ij,...j->...i", R_T, plane_normal(other))
    d = plane_distance(other) - plane_distance(ref)
    return jnp.stack([azimuth(n), elevation(n), d], axis=-1)


def transform(T_se3, coeffs):
    """Transform plane coefficients by an SE3 ``[q, t]`` (points map x' = Rx+t).

    ``n' = R n``, ``c' = c - t·n'`` (plane3d.h:108-115).
    """
    from visual_sgraphs.core import lie

    n_new = lie.quat_rotate(T_se3[..., :4], coeffs[..., :3])
    c_new = coeffs[..., 3] - jnp.sum(T_se3[..., 4:7] * n_new, axis=-1)
    return normalize(jnp.concatenate([n_new, c_new[..., None]], axis=-1))


def transform_sim3(S, coeffs):
    """Transform plane coefficients by a Sim3 ``[q, t, s]`` (points map
    x' = s·R·x + t): ``n' = R n``, ``c' = s·c - t·n'`` — the similarity
    generalization of plane3d.h:108-115, needed when loop-closure Sim3
    corrections move scene-graph planes (LoopClosing.cc:1010-1035 moves
    points; the reference re-fits planes afterwards, here the equation is
    carried through the same correction in closed form)."""
    from visual_sgraphs.core import lie

    n_new = lie.quat_rotate(S[..., :4], coeffs[..., :3])
    c_new = S[..., 7] * coeffs[..., 3] - jnp.sum(
        S[..., 4:7] * n_new, axis=-1
    )
    return normalize(jnp.concatenate([n_new, c_new[..., None]], axis=-1))


def point_plane_distance(coeffs, p):
    """Signed distance of point(s) p from plane (|n|=1 assumed)."""
    return jnp.sum(coeffs[..., :3] * p, axis=-1) + coeffs[..., 3]


def fit_centroid_svd(points, weights=None):
    """Weighted total-least-squares plane through a point set.

    Returns normalized coeffs.  Used for refining RANSAC inlier sets; the
    normal is the smallest right-singular vector of the centered cloud.
    """
    if weights is None:
        weights = jnp.ones(points.shape[:-1], points.dtype)
    wsum = jnp.maximum(jnp.sum(weights, axis=-1, keepdims=True), 1e-12)
    centroid = jnp.sum(weights[..., None] * points, axis=-2) / wsum[..., None][..., 0, :]
    centered = (points - centroid[..., None, :]) * jnp.sqrt(weights)[..., None]
    # normal = eigenvector of smallest eigenvalue of 3x3 scatter
    scatter = jnp.einsum("...ni,...nj->...ij", centered, centered)
    _, eigvecs = jnp.linalg.eigh(scatter)
    n = eigvecs[..., :, 0]
    c = -jnp.sum(n * centroid, axis=-1)
    return normalize(jnp.concatenate([n, c[..., None]], axis=-1))

"""Batched (weighted) RANSAC plane extraction.

Replaces ``Utils::ransacPlaneFitting`` (Utils.cc:291-371) and the
confidence-weighted SAC model of ``pcl_custom``
(WeightedSACModelPlane.hpp:21-49): all H hypotheses are evaluated at once —
3-point minimal samples -> candidate planes, the inlier score is one (H, N)
distance matrix reduction where each inlier contributes its confidence
weight (uniform weights reproduce plain RANSAC).  Sequential multi-plane
extraction keeps the reference's extract-then-remove loop but over a fixed
round count with masking.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from visual_sgraphs.core import plane as plane_mod


@functools.partial(jax.jit, static_argnames=("n_hyp",))
def ransac_plane(points, valid, weights, key, n_hyp: int = 256,
                 dist_thresh: float = 0.04):
    """One weighted-RANSAC plane fit.

    Returns (coeffs (4,), inlier_mask (N,), score ()) — score is the summed
    confidence of inliers (WeightedSACModelPlane's weighted count).
    """
    N = points.shape[0]
    idx = jax.random.randint(key, (n_hyp, 3), 0, N)
    ok_h = valid[idx].all(axis=1)  # (H,)
    p0, p1, p2 = points[idx[:, 0]], points[idx[:, 1]], points[idx[:, 2]]
    n = jnp.cross(p1 - p0, p2 - p0)
    nn = jnp.linalg.norm(n, axis=-1, keepdims=True)
    degen = nn[:, 0] < 1e-8
    n = n / jnp.maximum(nn, 1e-12)
    c = -jnp.sum(n * p0, axis=-1)
    coeffs = jnp.concatenate([n, c[:, None]], axis=-1)  # (H, 4)

    dist = jnp.abs(
        jnp.einsum("hi,ni->hn", coeffs[:, :3], points) + coeffs[:, 3:4]
    )
    inl = (dist < dist_thresh) & valid[None, :]
    scores = jnp.sum(inl * weights[None, :], axis=1)
    scores = jnp.where(ok_h & ~degen, scores, -1.0)
    best = jnp.argmax(scores)
    best_mask = inl[best]
    # weighted total-least-squares refinement on the inlier set
    refined = plane_mod.fit_centroid_svd(
        points, jnp.where(best_mask, weights, 0.0)
    )
    dist_r = jnp.abs(plane_mod.point_plane_distance(refined, points))
    mask_r = (dist_r < dist_thresh) & valid
    score_r = jnp.sum(mask_r * weights)
    return refined, mask_r, score_r


@functools.partial(jax.jit, static_argnames=("n_planes", "n_hyp"))
def extract_planes(points, valid, weights, key, n_planes: int = 4,
                   n_hyp: int = 256, dist_thresh: float = 0.04,
                   min_inliers: float = 50.0):
    """Sequential-RANSAC extraction of up to ``n_planes`` planes.

    Fixed trip count with masking (the extract-then-remove loop of
    Utils.cc:291-371).  Returns (coeffs (n_planes, 4), plane_valid
    (n_planes,), assignment (N,) int32 plane index or -1).
    """
    N = points.shape[0]
    coeffs_out = jnp.zeros((n_planes, 4), points.dtype)
    valid_out = jnp.zeros((n_planes,), bool)
    assign = jnp.full((N,), -1, jnp.int32)
    remaining = valid

    keys = jax.random.split(key, n_planes)
    for i in range(n_planes):
        coeffs, mask, score = ransac_plane(
            points, remaining, weights, keys[i], n_hyp=n_hyp,
            dist_thresh=dist_thresh,
        )
        good = score >= min_inliers
        coeffs_out = coeffs_out.at[i].set(jnp.where(good, coeffs, 0.0))
        valid_out = valid_out.at[i].set(good)
        take = mask & remaining & good
        assign = jnp.where(take, i, assign)
        remaining = remaining & ~take
    return coeffs_out, valid_out, assign


def plane_centroid(points, mask):
    w = mask.astype(points.dtype)
    s = jnp.maximum(jnp.sum(w), 1.0)
    return jnp.sum(points * w[:, None], axis=0) / s

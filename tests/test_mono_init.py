"""Two-view bootstrapping: homography branch on planar scenes + H/E model
selection (TwoViewReconstruction.cc ReconstructH / RH>0.40 rule)."""

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.core import lie
from visual_sgraphs.slam.mono_init import (
    essential_ransac,
    homography_ransac,
    recover_pose_homography,
)


def _rays(p):
    return p / p[:, 2:3]


def _planar_pair(rng, n=300, noise=0.0):
    """Points on the z=3 plane in cam-1; cam-2 displaced + yawed."""
    xy = rng.uniform(-1.5, 1.5, (n, 2))
    p1 = np.concatenate([xy, np.full((n, 1), 3.0)], axis=1)
    xi = np.array([0.03, -0.02, 0.01, 0.25, 0.1, 0.05], np.float32)
    T_21 = lie.se3_exp(jnp.asarray(xi))
    p2 = np.asarray(lie.se3_apply(T_21, jnp.asarray(p1, jnp.float32)))
    x1 = _rays(p1) + rng.normal(0, noise, (n, 3)) * [1, 1, 0]
    x2 = _rays(p2) + rng.normal(0, noise, (n, 3)) * [1, 1, 0]
    return (jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32),
            T_21)


def test_homography_recovers_planar_motion(rng):
    x1, x2, T_gt = _planar_pair(rng)
    valid = jnp.ones((x1.shape[0],), bool)
    Hm, inl, n_inl = homography_ransac(x1, x2, valid,
                                       jax.random.PRNGKey(0))
    assert int(n_inl) > 250
    T, p1, good = recover_pose_homography(Hm, x1, x2, inl)
    assert int(jnp.sum(good)) > 200
    # rotation must match GT; translation matches up to scale
    q_err = lie.se3_multiply(T, lie.se3_inverse(T_gt))
    ang = 2 * np.arccos(min(abs(float(q_err[0])), 1.0))
    assert ang < 0.02, f"rotation error {ang:.4f} rad"
    t_est = np.asarray(T[4:7])
    t_gt = np.asarray(T_gt[4:7])
    cos = abs(t_est @ t_gt) / (
        np.linalg.norm(t_est) * np.linalg.norm(t_gt) + 1e-12
    )
    assert cos > 0.99, f"translation direction cos {cos:.4f}"


def test_planar_scene_supports_homography_over_essential(rng):
    """On a single-plane scene the homography explains at least as much
    support as the (degenerate) essential model — the regime where the
    reference switches to ReconstructH (RH > 0.40)."""
    x1, x2, _ = _planar_pair(rng, noise=5e-4)
    valid = jnp.ones((x1.shape[0],), bool)
    _, _, n_h = homography_ransac(x1, x2, valid, jax.random.PRNGKey(0))
    _, _, n_e = essential_ransac(x1, x2, valid, jax.random.PRNGKey(0))
    assert int(n_h) >= 0.45 * (int(n_h) + int(n_e))


def test_general_scene_prefers_essential(rng):
    """A deep 3D cloud with real parallax: the essential model explains
    clearly more support than any single homography."""
    n = 300
    p1 = np.concatenate(
        [rng.uniform(-1.5, 1.5, (n, 2)),
         rng.uniform(2.0, 8.0, (n, 1))], axis=1
    )
    xi = np.array([0.03, -0.02, 0.01, 0.3, 0.1, 0.05], np.float32)
    T_21 = lie.se3_exp(jnp.asarray(xi))
    p2 = np.asarray(lie.se3_apply(T_21, jnp.asarray(p1, jnp.float32)))
    x1 = jnp.asarray(_rays(p1), jnp.float32)
    x2 = jnp.asarray(_rays(p2), jnp.float32)
    valid = jnp.ones((n,), bool)
    _, _, n_h = homography_ransac(x1, x2, valid, jax.random.PRNGKey(0))
    _, _, n_e = essential_ransac(x1, x2, valid, jax.random.PRNGKey(0))
    assert int(n_e) > int(n_h)

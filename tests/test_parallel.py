"""Sharded BA on the virtual 8-device CPU mesh: correctness vs single-device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from visual_sgraphs.core import cameras, lie
from visual_sgraphs.parallel import make_mesh, sharded_ba


def build_problem(rng, n_kf=8, n_pt=128):
    CAM = jnp.asarray([300.0, 300.0, 160.0, 120.0], jnp.float32)
    pts = jnp.asarray(rng.normal(size=(n_pt, 3)) * [2, 1.5, 0.5] + [0, 0, 5.0],
                      jnp.float32)
    T = jax.vmap(lie.se3_exp)(
        jnp.asarray(
            np.concatenate(
                [rng.normal(size=(n_kf, 3)) * 0.1,
                 rng.normal(size=(n_kf, 3)) * 0.05], 1
            ),
            jnp.float32,
        )
    )
    kf_idx, pt_idx = np.meshgrid(np.arange(n_kf), np.arange(n_pt),
                                 indexing="ij")
    obs_kf = jnp.asarray(kf_idx.ravel(), jnp.int32)
    obs_pt = jnp.asarray(pt_idx.ravel(), jnp.int32)
    uv = cameras.project_pinhole(CAM, lie.se3_apply(T[obs_kf], pts[obs_pt]))
    T0 = jax.vmap(lie.se3_boxplus)(
        T,
        jnp.asarray(
            np.concatenate([np.zeros((2, 6)),
                            rng.normal(size=(n_kf - 2, 6)) * 0.02]),
            jnp.float32,
        ),
    )
    X0 = pts + jnp.asarray(rng.normal(size=pts.shape) * 0.05, jnp.float32)
    fixed = jnp.asarray([True, True] + [False] * (n_kf - 2))
    valid = jnp.ones(obs_kf.shape[0], bool)
    valid_pt = jnp.ones(n_pt, bool)
    return CAM, T, pts, T0, X0, obs_kf, obs_pt, uv, valid, fixed, valid_pt


def test_sharded_ba_converges(rng):
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    CAM, T, pts, T0, X0, obs_kf, obs_pt, uv, valid, fixed, valid_pt = (
        build_problem(rng)
    )
    mesh = make_mesh(8)
    pose, pts_out, costs = sharded_ba(
        T0, X0, obs_kf, obs_pt, uv, valid, CAM, fixed, valid_pt, mesh,
        iters=12,
    )
    assert float(costs[-1]) < 1e-4 * float(costs[0])
    err = jax.vmap(
        lambda a, b: lie.se3_log(lie.se3_multiply(a, lie.se3_inverse(b)))
    )(pose, T)
    assert float(jnp.abs(err).max()) < 1e-3


def test_sharded_matches_single_device(rng):
    """The psum-reduced normal equations must match a 1-device mesh bitwise
    up to float reduction order."""
    CAM, T, pts, T0, X0, obs_kf, obs_pt, uv, valid, fixed, valid_pt = (
        build_problem(rng, n_kf=4, n_pt=64)
    )
    pose8, pts8, costs8 = sharded_ba(
        T0, X0, obs_kf, obs_pt, uv, valid, CAM, fixed, valid_pt,
        make_mesh(8), iters=5,
    )
    pose1, pts1, costs1 = sharded_ba(
        T0, X0, obs_kf, obs_pt, uv, valid, CAM, fixed, valid_pt,
        make_mesh(1), iters=5,
    )
    np.testing.assert_allclose(np.asarray(costs8), np.asarray(costs1),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(pose8), np.asarray(pose1),
                               atol=1e-4)

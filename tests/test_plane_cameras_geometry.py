"""Tests for plane chart, camera models, and closed-form geometry."""

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.core import cameras, geometry, lie, plane


# ---------------------------------------------------------------- plane chart


def random_plane(rng):
    n = rng.normal(size=3)
    n /= np.linalg.norm(n)
    return jnp.asarray(np.concatenate([n, rng.normal(size=1)]))


def test_plane_oplus_ominus_roundtrip(rng):
    for _ in range(10):
        p = random_plane(rng)
        delta = jnp.asarray(rng.normal(size=3) * 0.2)
        p2 = plane.oplus(p, delta)
        rec = plane.ominus(p, p2)
        np.testing.assert_allclose(rec, delta, atol=1e-9)


def test_plane_ominus_self_is_zero(rng):
    p = random_plane(rng)
    np.testing.assert_allclose(plane.ominus(p, p), 0.0, atol=1e-9)


def test_plane_transform_preserves_incidence(rng):
    """Points on the plane stay on the transformed plane."""
    p = random_plane(rng)
    T = lie.se3_exp(jnp.asarray(rng.normal(size=6)))
    # sample points on the plane: x = -c*n + tangent components
    n, c = np.asarray(p[:3]), float(p[3])
    basis = np.linalg.svd(n[None, :])[2][1:]  # two tangent vectors
    pts = -c * n + rng.normal(size=(20, 2)) @ basis
    pts = jnp.asarray(pts)
    np.testing.assert_allclose(plane.point_plane_distance(p, pts), 0, atol=1e-9)
    p_w = plane.transform(T, p)
    pts_w = lie.se3_apply(T, pts)
    np.testing.assert_allclose(plane.point_plane_distance(p_w, pts_w), 0,
                               atol=1e-9)


def test_plane_fit_svd(rng):
    n = np.array([0.0, 0.0, 1.0])
    pts = rng.normal(size=(100, 3))
    pts[:, 2] = 2.0  # plane z = 2
    coeffs = plane.fit_centroid_svd(jnp.asarray(pts))
    d = plane.point_plane_distance(coeffs, jnp.asarray(pts))
    np.testing.assert_allclose(d, 0, atol=1e-9)
    np.testing.assert_allclose(np.abs(np.asarray(coeffs[:3]) @ n), 1, atol=1e-9)


def test_plane_fit_weighted(rng):
    """Outliers with zero weight must not perturb the fit."""
    pts = rng.normal(size=(50, 3))
    pts[:, 2] = 1.0
    out = rng.normal(size=(10, 3)) * 5
    allpts = jnp.asarray(np.concatenate([pts, out]))
    w = jnp.asarray(np.concatenate([np.ones(50), np.zeros(10)]))
    coeffs = plane.fit_centroid_svd(allpts, w)
    np.testing.assert_allclose(
        plane.point_plane_distance(coeffs, jnp.asarray(pts)), 0, atol=1e-8
    )


# ------------------------------------------------------------------- cameras


def test_pinhole_roundtrip(rng):
    params = jnp.asarray([520.9, 521.0, 325.1, 249.7])
    p = jnp.asarray(rng.normal(size=(30, 3)) * [1, 1, 0.3] + [0, 0, 3.0])
    uv = cameras.project_pinhole(params, p)
    rays = cameras.unproject_pinhole(params, uv, depth=p[..., 2])
    np.testing.assert_allclose(rays, p, atol=1e-9)


def test_radtan_roundtrip(rng):
    dist = jnp.asarray([0.26, -0.57, -0.0007, -0.0008, 0.5])  # TUM1-like
    xy = jnp.asarray(rng.uniform(-0.4, 0.4, size=(50, 2)))
    xyd = cameras.distort_radtan(dist, xy)
    rec = cameras.undistort_radtan(dist, xyd, iters=20)
    np.testing.assert_allclose(rec, xy, atol=1e-7)


def test_kb8_roundtrip(rng):
    params = jnp.asarray(
        [190.98, 190.97, 254.93, 256.90, 0.0035, 0.0008, -0.0025, 0.0007]
    )  # TUM-VI fisheye
    p = jnp.asarray(rng.normal(size=(40, 3)))
    p = p.at[:, 2].set(jnp.abs(p[:, 2]) + 0.5)
    uv = cameras.project_kb8(params, p)
    ray = cameras.unproject_kb8(params, uv)
    # rays should be parallel to p
    cos = jnp.sum(ray * p, axis=-1) / (
        jnp.linalg.norm(ray, axis=-1) * jnp.linalg.norm(p, axis=-1)
    )
    np.testing.assert_allclose(cos, 1.0, atol=1e-8)


# ------------------------------------------------------------------ geometry


def test_triangulate_exact(rng):
    pts = jnp.asarray(rng.normal(size=(25, 3)) + [0, 0, 4.0])
    T_21 = lie.se3_exp(jnp.asarray([0.3, 0.02, 0.01, 0.01, -0.04, 0.02]))
    p2 = lie.se3_apply(T_21, pts)
    ray1 = pts / pts[..., 2:3]
    ray2 = p2 / p2[..., 2:3]
    rec, z1, z2 = geometry.triangulate_dlt(ray1, ray2, jnp.broadcast_to(T_21, (25, 7)))
    np.testing.assert_allclose(rec, pts, atol=1e-6)
    assert np.all(np.asarray(z1) > 0) and np.all(np.asarray(z2) > 0)


def test_horn_se3(rng):
    T = lie.se3_exp(jnp.asarray(rng.normal(size=6)))
    src = jnp.asarray(rng.normal(size=(40, 3)))
    dst = lie.se3_apply(T, src)
    est = geometry.horn_se3(src, dst)
    np.testing.assert_allclose(lie.se3_to_matrix(est), lie.se3_to_matrix(T),
                               atol=1e-9)


def test_horn_sim3(rng):
    S = lie.sim3_exp(jnp.asarray(rng.normal(size=7) * 0.5))
    src = jnp.asarray(rng.normal(size=(40, 3)))
    dst = lie.sim3_apply(S, src)
    est = geometry.horn_sim3(src, dst)
    np.testing.assert_allclose(lie.sim3_apply(est, src), dst, atol=1e-9)
    # fixed-scale variant recovers rotation/translation of an SE3 problem
    est_fixed = geometry.horn_sim3(src, dst, fix_scale=True)
    assert abs(float(est_fixed[7]) - 1.0) < 1e-12


def test_ate_rmse_zero_for_aligned(rng):
    traj = jnp.asarray(np.cumsum(rng.normal(size=(100, 3)) * 0.1, axis=0))
    T = lie.se3_exp(jnp.asarray(rng.normal(size=6)))
    moved = lie.se3_apply(T, traj)
    rmse, _ = geometry.ate_rmse(moved, traj)
    assert float(rmse) < 1e-9
    # scale-corrected version handles monocular scale ambiguity
    rmse_s, _ = geometry.ate_rmse(2.5 * traj, traj, with_scale=True)
    assert float(rmse_s) < 1e-9


def test_sampson_zero_on_epipolar(rng):
    T_21 = lie.se3_exp(jnp.asarray([0.5, 0.1, 0.0, 0.0, 0.2, 0.0]))
    pts = jnp.asarray(rng.normal(size=(20, 3)) + [0, 0, 5.0])
    x1 = pts / pts[..., 2:3]
    p2 = lie.se3_apply(T_21, pts)
    x2 = p2 / p2[..., 2:3]
    E = geometry.essential_from_pose(T_21)
    err = geometry.sampson_error(E, x1, x2)
    np.testing.assert_allclose(err, 0, atol=1e-12)


def test_kb8_frame_pipeline_tracks():
    """A kb8-model camera config flows through the frame pipeline: fisheye
    keypoints land on virtual-pinhole pixels consistent with the 3D
    geometry (KannalaBrandt8.cpp wired end-to-end, not dead code)."""
    import dataclasses

    import jax

    from visual_sgraphs.config import CameraConfig, OrbConfig
    from visual_sgraphs.core import cameras
    from visual_sgraphs.io.synthetic import SyntheticScene, render
    from visual_sgraphs.slam.frame import make_frame_obs

    scene = SyntheticScene(h=240, w=320)
    cam = dataclasses.replace(
        scene.cam, model="kb8", k1=0.02, k2=-0.005, k3=0.001, k4=0.0
    )
    gray, depth, _ = render(
        jnp.asarray(scene.trajectory(1)[0]), scene.planes, scene.cam_K,
        240, 320,
    )
    frame = make_frame_obs(gray, depth, 0.0, cam, OrbConfig(n_features=256))
    ok = np.asarray(frame.valid)
    assert ok.sum() > 100
    # kb8 unprojection of the undistorted uv must round-trip: project the
    # virtual-pinhole uv back through kb8 to approximately the raw pixels
    kb = jnp.asarray([cam.fx, cam.fy, cam.cx, cam.cy,
                      cam.k1, cam.k2, cam.k3, cam.k4], jnp.float32)
    pin = jnp.asarray(cam.K)
    rays = cameras.unproject_pinhole(pin, frame.uv)
    uv_kb8 = cameras.project_kb8(kb, rays)
    rays2 = cameras.unproject_kb8(kb, uv_kb8)
    z = jnp.maximum(rays2[:, 2:3], 1e-6)
    uv_back = jnp.stack(
        [rays2[:, 0] / z[:, 0] * cam.fx + cam.cx,
         rays2[:, 1] / z[:, 0] * cam.fy + cam.cy], -1
    )
    err = np.asarray(jnp.linalg.norm(uv_back - frame.uv, axis=-1))[ok]
    assert np.percentile(err, 95) < 0.5, np.percentile(err, 95)

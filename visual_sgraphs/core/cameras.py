"""Camera models: pinhole (+radtan distortion) and Kannala-Brandt-8 fisheye.

JAX equivalent of the reference's ``CameraModels/`` hierarchy
(reference: orb_slam3/src/CameraModels/Pinhole.cpp,
orb_slam3/src/CameraModels/KannalaBrandt8.cpp).  Instead of virtual-dispatch
objects we use a flat parameter vector + static model tag, so a whole
keyframe table can share one jitted projection regardless of camera:

- ``PINHOLE``: params ``[fx, fy, cx, cy]`` (+ optional ``k1 k2 p1 p2 k3``)
- ``KB8``:     params ``[fx, fy, cx, cy, k1, k2, k3, k4]``

Projection Jacobians are obtained by ``jax.jacfwd`` at the factor level —
no hand-derived Jacobians (the reference hand-codes them,
Pinhole.cpp:projectJac).
"""

from __future__ import annotations

import jax.numpy as jnp

PINHOLE = 0
KB8 = 1


def project_pinhole(params, p_cam):
    """Project camera-frame points (..., 3) -> pixels (..., 2). No distortion."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = p_cam[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = fx * p_cam[..., 0] * inv_z + cx
    v = fy * p_cam[..., 1] * inv_z + cy
    return jnp.stack([u, v], axis=-1)


def unproject_pinhole(params, uv, depth=None):
    """Pixels (..., 2) -> unit-depth rays (..., 3) (or scaled by depth)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    ray = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)
    if depth is not None:
        ray = ray * depth[..., None]
    return ray


def distort_radtan(dist, xy):
    """Apply radial-tangential distortion to normalized coords (..., 2).

    ``dist = [k1, k2, p1, p2, k3]`` (OpenCV order, as in the reference's
    Settings.cc distortion handling)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def undistort_radtan(dist, xy, iters: int = 8):
    """Invert radtan by fixed-point iteration (fixed trip count — jit-safe)."""
    out = xy
    for _ in range(iters):
        delta = distort_radtan(dist, out) - out
        out = xy - delta
    return out


def project_kb8(params, p_cam):
    """Kannala-Brandt (equidistant, 4 coeffs) fisheye projection
    (KannalaBrandt8.cpp:project)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, k3, k4 = params[4], params[5], params[6], params[7]
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    r = jnp.sqrt(x * x + y * y)
    r_safe = jnp.where(r < 1e-9, 1e-9, r)
    theta = jnp.arctan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = theta_d / r_safe
    u = fx * x * scale + cx
    v = fy * y * scale + cy
    # degenerate on-axis point: project to principal point
    on_axis = r < 1e-9
    return jnp.stack([jnp.where(on_axis, cx, u), jnp.where(on_axis, cy, v)],
                     axis=-1)


def unproject_kb8(params, uv, iters: int = 10):
    """Invert the KB8 model by Newton iteration on theta (fixed trip count;
    mirrors the iterative solve in KannalaBrandt8.cpp:unproject)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, k3, k4 = params[4], params[5], params[6], params[7]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    theta_d = jnp.sqrt(mx * mx + my * my)
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d
        df = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        theta = theta - f / jnp.where(jnp.abs(df) < 1e-9, 1e-9, df)
    scale = jnp.tan(theta) / jnp.where(theta_d < 1e-9, 1e-9, theta_d)
    small = theta_d < 1e-9
    x = jnp.where(small, mx, mx * scale)
    y = jnp.where(small, my, my * scale)
    return jnp.stack([x, y, jnp.ones_like(x)], axis=-1)


def project(model: int, params, p_cam):
    """Static-dispatch projection (model is a Python int — resolved at trace)."""
    if model == PINHOLE:
        return project_pinhole(params, p_cam)
    return project_kb8(params, p_cam)


def unproject(model: int, params, uv):
    if model == PINHOLE:
        return unproject_pinhole(params, uv)
    return unproject_kb8(params, uv)


def in_image(uv, width, height, border: float = 0.0):
    return (
        (uv[..., 0] >= border)
        & (uv[..., 0] < width - border)
        & (uv[..., 1] >= border)
        & (uv[..., 1] < height - border)
    )

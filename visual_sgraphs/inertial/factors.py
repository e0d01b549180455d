"""Inertial factor residuals for the graph engine.

Equivalents of the reference's hand-coded inertial g2o edges
(orb_slam3/include/G2oTypes.h):

- ``imu_factor``          <- EdgeInertial (G2oTypes.h:523-600): the 9-dof
  Forster preintegration residual (r_R, r_V, r_P)
- ``imu_factor_gs``       <- EdgeInertialGS (:601-666): same + shared
  gravity-direction and scale vertices (used by inertial initialization)
- ``bias_walk``           <- EdgeGyroRW / EdgeAccRW (:668-744)
- ``prior_3``             <- bias priors (:771-858)

Residuals are whitened inside the factor by a per-item 9x9 sqrt-information
matrix (the engine's ``info`` stays 1) so the full preintegration covariance
is honoured, matching g2o's ``setInformation(cov.inverse())``.

Pose convention: the map stores camera poses **T_cw**; the IMU residual
lives in the body frame via the camera-to-body extrinsic ``T_bc``
(ImuCamPose, G2oTypes.h).
"""

from __future__ import annotations

import jax.numpy as jnp

from visual_sgraphs.core import lie

GRAVITY = 9.81


def gravity_from_quat(q_wg: jnp.ndarray) -> jnp.ndarray:
    """World gravity vector from the gravity-direction quaternion:
    g_w = R_wg · (0, 0, -9.81) (VertexGDir convention)."""
    gz = jnp.asarray([0.0, 0.0, -GRAVITY], q_wg.dtype)
    return lie.quat_rotate(q_wg, gz)


def gdir_retract(q: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """2-dof update of the gravity rotation (z-rotation is unobservable)."""
    delta = jnp.concatenate([d, jnp.zeros((1,), d.dtype)])
    return lie.quat_normalize(
        lie.quat_multiply(q, lie.so3_exp(delta))
    )


def scale_retract(s: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Multiplicative scale chart (VertexScale)."""
    return s * jnp.exp(d)


def _body_state(T_cw, T_bc):
    """(R_wb (3,3), p_wb (3,)) from a camera pose and extrinsics."""
    T_bw = lie.se3_multiply(T_bc, T_cw)
    T_wb = lie.se3_inverse(T_bw)
    return lie.quat_to_matrix(T_wb[:4]), T_wb[4:7]


def _imu_residual(T_i, T_j, v_i, v_j, bg, ba, g_w, scale, const):
    """Shared core of the preintegration residual (Forster eq. 37-39)."""
    R_i, p_i = _body_state(T_i, const["T_bc"])
    R_j, p_j = _body_state(T_j, const["T_bc"])
    dt = const["dt"]

    # first-order bias-corrected deltas
    dbg = bg - const["bias_g"]
    dba = ba - const["bias_a"]
    dR = lie.quat_multiply(const["dR"], lie.so3_exp(const["JRg"] @ dbg))
    dV = const["dV"] + const["JVg"] @ dbg + const["JVa"] @ dba
    dP = const["dP"] + const["JPg"] @ dbg + const["JPa"] @ dba

    RiT = R_i.T
    r_R = lie.so3_log(
        lie.quat_multiply(
            lie.quat_conjugate(dR),
            lie.matrix_to_quat(RiT @ R_j),
        )
    )
    r_V = RiT @ (scale * (v_j - v_i) - g_w * dt) - dV
    r_P = RiT @ (scale * (p_j - p_i - v_i * dt) - 0.5 * g_w * dt * dt) - dP
    r = jnp.concatenate([r_R, r_V, r_P])
    return const["sqrt_info"] @ r


def imu_factor(values, const):
    """families: (pose_i, pose_j, vel_i, vel_j, bias_g, bias_a).

    const: dR/dV/dP/J*/dt/bias_g/bias_a/sqrt_info (9,9)/T_bc/g_w.
    Gravity is a constant here (post-initialization EdgeInertial, which
    fixes gravity in the world frame)."""
    T_i, T_j, v_i, v_j, bg, ba = values
    one = jnp.ones((), T_i.dtype)
    return _imu_residual(T_i, T_j, v_i, v_j, bg, ba, const["g_w"], one,
                         const)


def imu_factor_gs(values, const):
    """families: (pose_i, pose_j, vel_i, vel_j, bias_g, bias_a, gdir,
    scale) — the initialization variant with shared gravity-direction and
    scale vertices (EdgeInertialGS)."""
    T_i, T_j, v_i, v_j, bg, ba, q_wg, s = values
    return _imu_residual(T_i, T_j, v_i, v_j, bg, ba,
                         gravity_from_quat(q_wg), s[0], const)


def bias_walk(values, const):
    """families: (bias_i, bias_j).  r = b_j - b_i, info = 1/(walk²·dt)."""
    b_i, b_j = values
    return b_j - b_i


def prior_3(values, const):
    """families: (x,).  r = x - mean (bias / velocity priors)."""
    (x,) = values
    return x - const["mean"]

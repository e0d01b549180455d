"""Factor residual library for the graph engine.

Each function is a per-item residual ``f(values: tuple, const: dict) ->
(res_dim,)`` used by ``FactorBatch``; Jacobians come from forward-mode AD
through the family retractions.  Equivalents of the reference's hand-coded
g2o edges:

- ``reproj_mono/stereo``    <- EdgeSE3ProjectXYZ / EdgeStereoSE3ProjectXYZ
  (orb_slam3/include/OptimizableTypes.h:34-157)
- ``reproj_mono_pose_only`` <- the *OnlyPose variants used by
  PoseOptimization (Optimizer.cc:1063)
- ``relative_se3``          <- essential-graph / odometry edges
  (Optimizer.cc:2456 OptimizeEssentialGraph, on SE3 here; Sim3 variant below)
- ``relative_sim3``         <- EdgeSim3 (OptimizableTypes.h:159-231)
- ``pose_prior``            <- prior / fixed-lag anchors
- ``plane_kf``              <- EdgeVertexPlaneProjectSE3KF: (T_kf · pi_w) ⊖
  pi_meas in the minimal azimuth/elevation/distance chart
  (OptimizableTypes.h:336-374)
- ``point_on_plane``        <- EdgeVertexPlaneProjectPointXYZ
  (OptimizableTypes.h:379-399)
- ``plane_quadric``         <- EdgeSE3KFPointToPlane, the point-cloud-to-plane
  quadric factor e = piᵀ T G Tᵀ pi (OptimizableTypes.h:296-330)

Pose convention: keyframe poses are **T_cw** (world -> camera), matching the
reference throughout.
"""

from __future__ import annotations

import jax.numpy as jnp

from visual_sgraphs.core import cameras, lie, plane as plane_mod


# ----------------------------------------------------------- reprojection


def reproj_mono(values, const):
    """families: (kf_pose T_cw, point X_w); const: uv (2,), cam (4,)."""
    T_cw, X_w = values
    p_cam = lie.se3_apply(T_cw, X_w)
    uv_hat = cameras.project_pinhole(const["cam"], p_cam)
    return uv_hat - const["uv"]


def reproj_stereo(values, const):
    """families: (kf_pose, point); const: uv_ur (3,), cam (4,), bf ().

    Third coordinate is the right-image u of a rectified stereo pair:
    u_r = u - bf/z (same parameterization as the reference's stereo edges).
    """
    T_cw, X_w = values
    p_cam = lie.se3_apply(T_cw, X_w)
    uv_hat = cameras.project_pinhole(const["cam"], p_cam)
    z = jnp.maximum(p_cam[2], 1e-6)
    ur_hat = uv_hat[0] - const["bf"] / z
    return jnp.concatenate([uv_hat, ur_hat[None]]) - const["uv_ur"]


def reproj_mono_pose_only(values, const):
    """families: (kf_pose,); const: uv (2,), xw (3,), cam (4,).

    Motion-only variant: the landmark is a constant (PoseOptimization's
    EdgeSE3ProjectXYZOnlyPose)."""
    (T_cw,) = values
    p_cam = lie.se3_apply(T_cw, const["xw"])
    return cameras.project_pinhole(const["cam"], p_cam) - const["uv"]


def reproj_stereo_pose_only(values, const):
    """families: (kf_pose,); const: uv_ur (3,), xw (3,), cam (4,), bf ()."""
    (T_cw,) = values
    p_cam = lie.se3_apply(T_cw, const["xw"])
    uv_hat = cameras.project_pinhole(const["cam"], p_cam)
    z = jnp.maximum(p_cam[2], 1e-6)
    ur_hat = uv_hat[0] - const["bf"] / z
    return jnp.concatenate([uv_hat, ur_hat[None]]) - const["uv_ur"]


# ------------------------------------------------------------- pose graph


def pose_prior(values, const):
    """families: (pose,); const: T_meas (7,).  r = log(T · T_meas⁻¹)."""
    (T,) = values
    return lie.se3_log(lie.se3_multiply(T, lie.se3_inverse(const["T_meas"])))


def relative_se3(values, const):
    """families: (pose_i, pose_j) both T_cw; const: T_ji (7,) measured
    relative transform.  r = log(T_ji_meas⁻¹ · T_j · T_i⁻¹)."""
    T_i, T_j = values
    T_ji = lie.se3_multiply(T_j, lie.se3_inverse(T_i))
    return lie.se3_log(
        lie.se3_multiply(lie.se3_inverse(const["T_ji"]), T_ji)
    )


def relative_sim3(values, const):
    """families: (sim3_i, sim3_j); const: S_ji (8,).  The essential-graph
    edge of loop closing (OptimizeEssentialGraph operates on Sim3)."""
    S_i, S_j = values
    S_ji = lie.sim3_multiply(S_j, lie.sim3_inverse(S_i))
    return lie.sim3_log(
        lie.sim3_multiply(lie.sim3_inverse(const["S_ji"]), S_ji)
    )


# ----------------------------------------------------------------- planes


def plane_kf(values, const):
    """families: (kf_pose T_cw, plane_w (4,)); const: pi_obs (4,) local plane.

    r = (T_cw · pi_w) ⊖ pi_obs in the minimal chart — the plane-KF
    observation factor (OptimizableTypes.h:336-374)."""
    T_cw, pi_w = values
    pi_local = plane_mod.transform(T_cw, pi_w)
    return plane_mod.ominus(const["pi_obs"], pi_local)


def point_on_plane(values, const):
    """families: (plane_w, point X_w); const: none.  r = n·x + c."""
    pi_w, X_w = values
    return plane_mod.point_plane_distance(pi_w, X_w)[None]


def plane_quadric(values, const):
    """families: (kf_pose T_cw, plane_w); const: G (4,4) point quadric
    Σ w·p̃ p̃ᵀ of the keyframe's supporting cloud in the *camera* frame.

    chi2 equals the weighted sum of squared point-to-plane distances:
    e = piᵀ_local G pi_local with pi_local = T_cw · pi_w
    (EdgeSE3KFPointToPlane, OptimizableTypes.h:296-330).  Returned as
    sqrt(e) so the engine's squared norm reproduces e.
    """
    T_cw, pi_w = values
    pi_local = plane_mod.transform(T_cw, pi_w)
    e = pi_local @ const["G"] @ pi_local
    return jnp.sqrt(jnp.maximum(e, 1e-12))[None]


# ------------------------------------------------------------ rooms / doors


def _room_pair_vec(w1, w2):
    """Mid-surface anchor point of a facing wall pair — the reference's
    getRoomCenter pair vector (Utils.cc:153-205) with the d<=0 direction
    normalization (correctPlaneDirection, OptimizableTypes.h:497-501),
    branch-free for jit."""
    w1 = jnp.where(w1[3] > 0, -w1, w1)
    w2 = jnp.where(w2[3] > 0, -w2, w2)
    d1 = jnp.abs(w1[3])
    d2 = jnp.abs(w2[3])
    big = jnp.where(d1 > d2, w1, w2)
    small = jnp.where(d1 > d2, w2, w1)
    db, ds = jnp.abs(big[3]), jnp.abs(small[3])
    return 0.5 * (db * big[:3] - ds * small[:3]) + ds * small[:3]


def room_2wall(values, const):
    """families: (room_center (3,), plane_w, plane_w); const: none.

    Corridor-center-from-2-walls (EdgeVertex2PlaneProjectSE3Room,
    OptimizableTypes.h:452-502): r = c − pairVec(w1, w2).  The room center
    here is a free 3-dof point; the reference uses the translation of an
    SE3 room vertex with the same 3-dim error."""
    c, w1, w2 = values
    return c - _room_pair_vec(w1, w2)


def room_4wall(values, const):
    """families: (room_center (3,), x1, x2, y1, y2 plane_w); const: none.

    Room-center-from-4-walls (EdgeVertex4PlaneProjectSE3Room,
    OptimizableTypes.h:508-557): r = c − (pairVec(x1,x2) + pairVec(y1,y2))."""
    c, x1, x2, y1, y2 = values
    return c - (_room_pair_vec(x1, x2) + _room_pair_vec(y1, y2))


def door_room(values, const):
    """families: (door_pose T_wd (7,), room_center (3,)); const: rel (3,)
    measured door-minus-room offset.

    Adaptation of EdgeSE3DoorProjectSE3Room (OptimizableTypes.h:266-290,
    used at Optimizer.cc:461-498): the reference constrains the full
    relative SE3 between room and door vertices to its value at graph
    build; with the room reduced to a 3-dof center the rigid part is the
    translation offset."""
    T_wd, c = values
    return (T_wd[4:7] - c) - const["rel"]

"""Jitted tracking programs: local-map matching + motion-only pose solve.

The reference's per-frame hot path (Tracking::Track, Tracking.cc:1874-2393 —
TrackWithMotionModel / TrackLocalMap / PoseOptimization) re-expressed as two
fixed-shape device programs:

1. gather the local map (points seen by the covisibility neighbourhood of
   the reference keyframe) into a compact table,
2. window-match those points against the frame's keypoints under the
   predicted pose, motion-only LM with chi2 gating, then a second tighter
   match + solve pass (the TrackLocalMap refinement).

Control-flow decisions (keyframe need, lost detection) are made by the host
from the returned scalars; everything heavy stays on device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.config import SystemConfig
from visual_sgraphs.core import cameras, lie
from visual_sgraphs.features.match import match_window
from visual_sgraphs.optim import (
    FactorBatch,
    GraphProblem,
    factors,
    optimize_rounds,
    se3_family,
)
from visual_sgraphs.slam.frame import FrameObs
from visual_sgraphs.slam.map_state import (
    MapState,
    covisibility_counts,
    observed_mask,
)

CHI2_MONO = 5.991


class TrackResult(NamedTuple):
    pose: jax.Array  # (7,) optimized T_cw
    slot_pt: jax.Array  # (F,) map-point id matched to each frame keypoint, -1
    vis_pt: jax.Array  # (n_local,) point ids predicted visible this frame, -1
    n_matches: jax.Array  # () int32 matches fed to the solver
    n_inliers: jax.Array  # () int32 inliers after gating
    n_local_pts: jax.Array  # () int32 size of the local map used


def _local_point_table(m: MapState, ref_kf: jax.Array, n_window: int,
                       n_local: int):
    """Compact (n_local,) table of map points seen by the covisibility
    neighbourhood of ``ref_kf`` (UpdateLocalKeyFrames/Points,
    Tracking.cc:3536/3507)."""
    counts = covisibility_counts(m, ref_kf)
    top_counts, top_kfs = jax.lax.top_k(counts, n_window)
    kf_ids = jnp.concatenate([ref_kf[None], top_kfs])
    kf_mask = jnp.concatenate(
        [jnp.ones((1,), bool), top_counts > 0]
    ) & m.kf_valid[kf_ids]
    mask = observed_mask(m, kf_ids, kf_mask) & m.pt_valid
    (ids,) = jnp.nonzero(mask, size=n_local, fill_value=-1)
    valid = ids >= 0
    safe = jnp.maximum(ids, 0)
    return ids, safe, valid


def pose_only_gn(T_init, xw, uv, valid, cam_K, iters: int = 10,
                 chi2_gate: float = CHI2_MONO, huber: float = 2.447,
                 gate0: float | None = None,
                 depth: jax.Array | None = None,
                 bf: jax.Array | None = None,
                 T_prior: jax.Array | None = None,
                 prior_weight: float = 0.0):
    """Dedicated motion-only Gauss-Newton (the PoseOptimization hot loop,
    Optimizer.cc:1063) with analytic Jacobians and dense normal
    equations — one residual evaluation per iteration.

    The generic LM engine evaluates residuals ~3x per iteration (linearize,
    candidate cost, gate) through autodiff; at 30+ iterations per frame that
    dominated the whole tracking step.  Here each iteration is: project,
    analytic (M, 2, 6) Jacobian, Huber IRLS + chi2 gating as weights, one
    (6, M*2)x(M*2, 6) matmul, one 6x6 solve.

    The chi2 gate starts at ``gate0`` (default: wide open — residuals up to
    the match search window must stay in play or GN can never pull a
    mispredicted pose into the basin) and decays geometrically to the final
    ``chi2_gate*4`` across the schedule — the reference's equivalent is
    re-marking outliers between its 4 rounds (Optimizer.cc:1255-1267) so
    early rounds keep large-residual observations too.

    ``depth``/``bf``: when given, points with depth > 0 get a third stereo
    residual row u_r = u - bf/z against the observed u_r (the reference's
    RGB-D PoseOptimization path, Optimizer.cc:1127+), anchoring scale.

    ``T_prior``/``prior_weight``: optional pose prior r = log(T·T_prior⁻¹)
    with isotropic weight — the tracking-time inertial factor
    (PoseInertialOptimizationLastFrame, Optimizer.cc:5999, reduced to the
    dead-reckoned pose prior; the full preintegration residual lives in
    the VI local BA).

    Returns (T (7,), inliers (M,) bool).
    """
    fx, fy = cam_K[0], cam_K[1]
    M = xw.shape[0]
    final_gate = chi2_gate * 4.0
    if gate0 is None or gate0 < final_gate:
        gate0 = final_gate
    # reference-like round structure: the first quarter of the schedule
    # keeps every match in play (round 1 of the 4x10 with all edges at
    # level 0), then the tight gate applies with per-iteration re-testing
    n_wide = max(iters // 4, 1) if gate0 > final_gate else 0
    sched = jnp.where(
        jnp.arange(iters) < n_wide,
        jnp.float32(gate0), jnp.float32(final_gate),
    )
    use_stereo = depth is not None and bf is not None
    if use_stereo:
        has_d = valid & (depth > 0)
        ur_obs = uv[:, 0] - bf / jnp.where(has_d, depth, 1.0)
        # depth-noise-aware disparity weight: RGB-D range error grows
        # ~quadratically with range (Kinect: sigma_z ~ 0.002 z^2), so a
        # far measurement's u_r residual carries proportionally less
        # information.  sqrt-weight = min(1, (z0/z)^2), z0 = 2.5 m — the
        # reference instead treats points beyond ThDepth (~40 baselines)
        # as mono-only (Tracking.cc:3318); a continuous downweight keeps
        # far structure usable without letting its noise steer the solve
        w_ur = jnp.minimum(1.0, (2.5 / jnp.maximum(depth, 0.1)) ** 2)

    # every contraction at HIGHEST: on the GPU a float32 matmul may run
    # in TF32 (10-bit mantissa), which moved the solved pose by 0.3 mm
    # against float32 at M=1000 (chip_smoke.py precision phase)
    HIGH = jax.lax.Precision.HIGHEST

    def step(T, gate):
        R = lie.quat_to_matrix(T[:4])
        # (M, 3) camera-frame points
        p = jnp.matmul(xw, R.T, precision=HIGH) + T[4:7]
        z = jnp.maximum(p[:, 2], 1e-6)
        inv_z = 1.0 / z
        u_hat = fx * p[:, 0] * inv_z + cam_K[2]
        v_hat = fy * p[:, 1] * inv_z + cam_K[3]
        if use_stereo:
            ur_hat = u_hat - bf * inv_z
            r = jnp.stack([
                u_hat - uv[:, 0], v_hat - uv[:, 1],
                jnp.where(has_d, (ur_hat - ur_obs) * w_ur, 0.0),
            ], axis=1)  # (M, 3)
        else:
            r = jnp.stack([u_hat - uv[:, 0], v_hat - uv[:, 1]],
                          axis=1)  # (M, 2)
        chi2 = jnp.sum(r * r, axis=1)
        ok = valid & (p[:, 2] > 0.05)
        # Huber IRLS weight + decaying hard gate
        s = jnp.sqrt(jnp.maximum(chi2, 1e-12))
        w = jnp.where(ok & (chi2 <= gate),
                      jnp.minimum(1.0, huber / s), 0.0)
        # d uv / d p  (M, R, 3)
        rows = [
            jnp.stack([fx * inv_z, jnp.zeros_like(z),
                       -fx * p[:, 0] * inv_z * inv_z], axis=1),
            jnp.stack([jnp.zeros_like(z), fy * inv_z,
                       -fy * p[:, 1] * inv_z * inv_z], axis=1),
        ]
        if use_stereo:
            rows.append(jnp.stack([
                fx * inv_z, jnp.zeros_like(z),
                (-fx * p[:, 0] + bf) * inv_z * inv_z,
            ], axis=1) * (has_d * w_ur)[:, None])
        Jp = jnp.stack(rows, axis=1)
        R_dim = Jp.shape[1]
        # d p / d xi = [I | -hat(p)]  (M, 3, 6)
        hatp = jax.vmap(lie.hat)(p)
        Jx = jnp.concatenate([
            jnp.broadcast_to(jnp.eye(3, dtype=p.dtype), (M, 3, 3)), -hatp
        ], axis=2)
        J = jnp.einsum("mij,mjk->mik", Jp, Jx, precision=HIGH)  # (M, R, 6)
        Jw = J * w[:, None, None]
        J2 = J.reshape(M * R_dim, 6)
        Jw2 = Jw.reshape(M * R_dim, 6)
        H = jax.lax.dot_general(Jw2, J2, (((0,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32,
                                precision=HIGH)
        g = jnp.einsum("mri,mr->i", Jw, r, precision=HIGH)
        if T_prior is not None and prior_weight > 0.0:
            # prior residual log(T·T_prior⁻¹): J ≈ I near convergence
            r_p = lie.se3_log(lie.se3_multiply(T, lie.se3_inverse(T_prior)))
            H = H + jnp.eye(6, dtype=H.dtype) * prior_weight
            g = g + prior_weight * r_p
        H = H + jnp.eye(6, dtype=H.dtype) * 1e-3
        dx = jnp.linalg.solve(H, -g)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        return lie.se3_normalize(lie.se3_boxplus(T, dx)), None

    T, _ = jax.lax.scan(step, T_init, sched)
    # final inlier classification at the solution (2-dof pixel test — the
    # stereo row only steers the solve)
    p = lie.se3_apply(T, xw)
    uv_hat = cameras.project_pinhole(cam_K, p)
    chi2 = jnp.sum((uv_hat - uv) ** 2, axis=1)
    inl = valid & (p[:, 2] > 0.05) & (chi2 <= chi2_gate)
    return T, inl


def _pose_only_solve(T_init, xw, uv, valid, cam_K, rounds, iters):
    m = uv.shape[0]
    batch = FactorBatch(
        families=("kf",),
        residual_fn=factors.reproj_mono_pose_only,
        res_dim=2,
        var_idx=jnp.zeros((m, 1), jnp.int32),
        const={"uv": uv, "xw": xw, "cam": jnp.broadcast_to(cam_K, (m, 4))},
        info=jnp.ones((m,), T_init.dtype),
        valid=valid,
        huber=float(np.sqrt(CHI2_MONO)),
        chi2_gate=CHI2_MONO,
    )
    problem = GraphProblem(families={"kf": se3_family(T_init[None])},
                           factors=[batch])
    res, masks = optimize_rounds(problem, rounds=rounds, iters=iters)
    return res.values["kf"][0], masks[0]


@functools.partial(
    jax.jit,
    static_argnames=("n_window", "n_local", "fx_radius", "fine_radius",
                     "img_wh"),
)
def track_frame(
    m: MapState,
    frame: FrameObs,
    T_pred: jax.Array,
    ref_kf: jax.Array,
    cam_K: jax.Array,
    n_window: int = 10,
    n_local: int = 4096,
    fx_radius: float = 15.0,
    fine_radius: float = 7.0,
    cam_bf: jax.Array = None,
    img_wh: tuple | None = None,
) -> TrackResult:
    return _track_frame_impl(m, frame, T_pred, ref_kf, cam_K, n_window,
                             n_local, fx_radius, fine_radius, cam_bf, img_wh)


def _track_frame_impl(
    m: MapState,
    frame: FrameObs,
    T_pred: jax.Array,
    ref_kf: jax.Array,
    cam_K: jax.Array,
    n_window: int = 10,
    n_local: int = 4096,
    fx_radius: float = 15.0,
    fine_radius: float = 7.0,
    cam_bf: jax.Array = None,
    img_wh: tuple | None = None,
    local_table=None,
    prior_weight: float = 0.0,
) -> TrackResult:
    """Track one frame against the local map from predicted pose ``T_pred``.

    ``local_table``: optional precomputed (ids, safe, lvalid) — the batch
    scan hoists the table out of the per-frame loop (same ref_kf and map
    for the whole batch)."""
    if local_table is None:
        ids, safe, lvalid = _local_point_table(m, ref_kf, n_window, n_local)
    else:
        ids, safe, lvalid = local_table
    xw = m.pt_pos[safe]
    desc = m.pt_desc[safe]

    def predict_uv(T):
        p_cam = lie.se3_apply(T, xw)
        uvp = cameras.project_pinhole(cam_K, p_cam)
        vis = (p_cam[:, 2] > 0.05) & lvalid
        if img_wh is not None:
            # frustum test includes image bounds (Frame::isInFrustum) —
            # points projecting off-image are not visibility chances
            w, h = img_wh
            vis = vis & (uvp[:, 0] >= 0) & (uvp[:, 0] < w) & \
                (uvp[:, 1] >= 0) & (uvp[:, 1] < h)
        return uvp, vis

    # ---- pass 1: coarse window match at predicted pose + solve
    uv_pred, vis = predict_uv(T_pred)
    match, _ = match_window(
        desc, uv_pred, vis, frame.desc, frame.uv, frame.valid,
        radius=fx_radius,
    )
    ok = match >= 0
    slot = jnp.maximum(match, 0)
    T1, inl1 = pose_only_gn(
        T_pred, xw, frame.uv[slot], ok, cam_K, iters=12,
        gate0=(2.0 * fx_radius) ** 2,
        depth=frame.depth[slot] if cam_bf is not None else None,
        bf=cam_bf,
        T_prior=T_pred if prior_weight > 0 else None,
        prior_weight=prior_weight,
    )

    # ---- pass 2: tighter re-match at refined pose + solve (TrackLocalMap)
    uv_pred2, vis2 = predict_uv(T1)
    match2, _ = match_window(
        desc, uv_pred2, vis2, frame.desc, frame.uv, frame.valid,
        radius=fine_radius,
    )
    ok2 = match2 >= 0
    slot2 = jnp.maximum(match2, 0)
    # pass 2 polishes from an already-refined pose over a tight re-match —
    # the final chi2 gate applies from iteration 0 (no wide phase)
    T2, inlier_mask = pose_only_gn(
        T1, xw, frame.uv[slot2], ok2, cam_K, iters=12,
        depth=frame.depth[slot2] if cam_bf is not None else None,
        bf=cam_bf,
        T_prior=T_pred if prior_weight > 0 else None,
        prior_weight=prior_weight,
    )

    # per-frame-slot matched point ids (for keyframe insertion), inliers only
    F = frame.uv.shape[0]
    keep = ok2 & inlier_mask
    slot_pt = jnp.full((F,), -1, jnp.int32).at[
        jnp.where(keep, match2, F - 1)
    ].max(jnp.where(keep, ids, -1).astype(jnp.int32), mode="drop")
    # visibility stats for culling (MapPoint::IncreaseVisible): every local
    # point predicted in this frame's frustum counts as a sighting chance
    vis_pt = jnp.where(vis2, ids, -1).astype(jnp.int32)
    return TrackResult(
        pose=T2,
        slot_pt=slot_pt,
        vis_pt=vis_pt,
        n_matches=jnp.sum(ok2.astype(jnp.int32)),
        n_inliers=jnp.sum(keep.astype(jnp.int32)),
        n_local_pts=jnp.sum(lvalid.astype(jnp.int32)),
    )


@functools.partial(
    jax.jit, static_argnames=("n_window", "n_local", "fx_radius",
                              "fine_radius", "img_wh", "prior_weight"),
)
def track_frame_full(
    m: MapState,
    frame: FrameObs,
    T_pred: jax.Array,
    T_last: jax.Array,
    ref_kf: jax.Array,
    cam_K: jax.Array,
    min_inliers: jax.Array,
    n_window: int = 10,
    n_local: int = 4096,
    fx_radius: float = 15.0,
    fine_radius: float = 7.0,
    cam_bf: jax.Array = None,
    img_wh: tuple | None = None,
    prior_weight: float = 0.0,
):
    """The whole per-frame tracking decision tree as ONE program: coarse
    track at the predicted pose, and — only when inliers fall short — the
    wide-window re-track from the last good pose (TrackReferenceKeyFrame
    fallback) via ``lax.cond``.  Also folds the point-stats update in.

    Returns (result, new_map, packed) where ``packed`` is a (4,) float32
    [n_matches, n_inliers, n_local_pts, retried] — the ONLY thing the host
    needs to read back per frame (each device->host readback waits for
    the device, so the hot loop does exactly one).
    """
    res1 = _track_frame_impl(m, frame, T_pred, ref_kf, cam_K, n_window,
                             n_local, fx_radius, fine_radius, cam_bf, img_wh,
                             prior_weight=prior_weight)
    need_retry = res1.n_inliers < min_inliers

    def retry(_):
        # the retry abandons the (possibly bad) prediction, so no prior
        return _track_frame_impl(m, frame, T_last, ref_kf, cam_K, n_window,
                                 n_local, fx_radius * 4.0, fine_radius * 2.0,
                                 cam_bf, img_wh)

    res = jax.lax.cond(need_retry, retry, lambda _: res1, None)
    new_m = update_point_stats(m, res)
    packed = jnp.stack([
        res.n_matches.astype(jnp.float32),
        res.n_inliers.astype(jnp.float32),
        res.n_local_pts.astype(jnp.float32),
        need_retry.astype(jnp.float32),
    ])
    return res, new_m, packed


@functools.lru_cache(maxsize=None)
def make_frame_step(cam, orb, n_window: int, n_local: int,
                    fx_radius: float, fine_radius: float, has_depth: bool):
    """Build the fused per-frame program: ORB extraction + prediction +
    coarse/retry/fine tracking + stats + trajectory bookkeeping, ONE
    executable and ONE packed-scalar readback per frame.

    Every program launch and every D2H read costs host latency, so the
    reference's per-frame hot path (Frame ctor + Track(), SURVEY §3.2) is
    a single dispatch.
    """
    from visual_sgraphs.slam.frame import _jit_frame_obs

    frame_fn = _jit_frame_obs(cam, orb, has_depth)

    def step(m: MapState, gray, depth_img, ts, T_last, velocity,
             ref_kf, cam_K, min_inliers, cam_bf=None):
        frame = frame_fn(gray, depth_img, ts)
        T_pred = lie.se3_normalize(lie.se3_multiply(velocity, T_last))
        wh = (cam.width, cam.height)
        res1 = _track_frame_impl(m, frame, T_pred, ref_kf, cam_K,
                                 n_window, n_local, fx_radius, fine_radius,
                                 cam_bf, wh)
        need_retry = res1.n_inliers < min_inliers

        def retry(_):
            return _track_frame_impl(m, frame, T_last, ref_kf, cam_K,
                                     n_window, n_local, fx_radius * 4.0,
                                     fine_radius * 2.0, cam_bf, wh)

        res = jax.lax.cond(need_retry, retry, lambda _: res1, None)
        accepted = res.n_inliers >= min_inliers
        new_pose = lie.se3_normalize(res.pose)
        pose_sel = jnp.where(accepted, new_pose, T_last)
        vel_new = lie.se3_normalize(
            lie.se3_multiply(new_pose, lie.se3_inverse(T_last))
        )
        vel_sel = jnp.where(accepted, vel_new, lie.se3_identity())
        T_rel = lie.se3_normalize(
            lie.se3_multiply(pose_sel, lie.se3_inverse(m.kf_pose[ref_kf]))
        )
        packed = jnp.stack([
            res.n_matches.astype(jnp.float32),
            res.n_inliers.astype(jnp.float32),
            res.n_local_pts.astype(jnp.float32),
            need_retry.astype(jnp.float32),
        ])
        # the map is deliberately NOT threaded through: per-frame point
        # stats are accumulated by the host (res.slot_pt) and folded in at
        # keyframe time, so consecutive steps have no map data hazard and
        # can be dispatched without waiting for the previous decision
        return frame, res, pose_sel, vel_sel, T_rel, packed

    return jax.jit(step)


@functools.lru_cache(maxsize=None)
def make_frame_scan(cam, orb, n_window: int, n_local: int,
                    fx_radius: float, fine_radius: float, has_depth: bool,
                    batch: int):
    """Build the B-frame pipelined tracking program: ``lax.scan`` of the
    fused per-frame step over a stacked frame batch — ONE dispatch and ONE
    packed readback per B frames.

    Per-frame results are identical to the serial fused path; host
    decisions (keyframe policy, lost handling) resolve after the batch, so
    mapping lags tracking by up to B frames — the reference's
    tracking/mapping thread decoupling (SURVEY §2.7) expressed as pipeline
    depth.  The map is constant within a batch (keyframes insert between
    batches), which is what makes the scan legal.
    """
    from visual_sgraphs.slam.frame import _jit_frame_obs

    frame_fn = _jit_frame_obs(cam, orb, has_depth)
    wh = (cam.width, cam.height)

    def scan(m: MapState, grays, depths, tss, T_last, velocity,
             ref_kf, cam_K, min_inliers, cam_bf=None):
        kf_base = m.kf_pose[ref_kf]
        # hoisted once per batch: ref_kf and the map are constant inside
        table = _local_point_table(m, ref_kf, n_window, n_local)

        def step(carry, inp):
            T_prev, vel = carry
            gray, depth_img, ts = inp
            frame = frame_fn(gray, depth_img, ts)
            T_pred = lie.se3_normalize(lie.se3_multiply(vel, T_prev))
            res1 = _track_frame_impl(m, frame, T_pred, ref_kf, cam_K,
                                     n_window, n_local, fx_radius,
                                     fine_radius, cam_bf, wh,
                                     local_table=table)
            need_retry = res1.n_inliers < min_inliers

            def retry(_):
                return _track_frame_impl(m, frame, T_prev, ref_kf, cam_K,
                                         n_window, n_local, fx_radius * 4.0,
                                         fine_radius * 2.0, cam_bf, wh,
                                         local_table=table)

            res = jax.lax.cond(need_retry, retry, lambda _: res1, None)
            accepted = res.n_inliers >= min_inliers
            new_pose = lie.se3_normalize(res.pose)
            pose_sel = jnp.where(accepted, new_pose, T_prev)
            vel_new = lie.se3_normalize(
                lie.se3_multiply(new_pose, lie.se3_inverse(T_prev))
            )
            vel_sel = jnp.where(accepted, vel_new, lie.se3_identity())
            T_rel = lie.se3_normalize(
                lie.se3_multiply(pose_sel, lie.se3_inverse(kf_base))
            )
            packed = jnp.stack([
                res.n_matches.astype(jnp.float32),
                res.n_inliers.astype(jnp.float32),
                res.n_local_pts.astype(jnp.float32),
                need_retry.astype(jnp.float32),
            ])
            return (pose_sel, vel_sel), (frame, res, T_rel, packed)

        (T_out, vel_out), outs = jax.lax.scan(
            step, (T_last, velocity), (grays, depths, tss)
        )
        frames, results, T_rels, packeds = outs
        return frames, results, T_rels, packeds, T_out, vel_out

    return jax.jit(scan)


@functools.partial(jax.jit, static_argnames=())
def update_point_stats(m: MapState, track: TrackResult) -> MapState:
    """Increment visible/found counters used by point culling
    (MapPoint::IncreaseVisible/IncreaseFound)."""
    found_ids = track.slot_pt
    pt_found = m.pt_found.at[jnp.maximum(found_ids, 0)].add(
        (found_ids >= 0).astype(jnp.int32), mode="drop"
    )
    vis_ids = track.vis_pt
    pt_visible = m.pt_visible.at[jnp.maximum(vis_ids, 0)].add(
        (vis_ids >= 0).astype(jnp.int32), mode="drop"
    )
    return m._replace(pt_found=pt_found, pt_visible=pt_visible)

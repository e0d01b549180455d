"""Scene-graph manager: per-keyframe plane pipeline + room inference.

Host-facing orchestration of the vS-Graphs semantic layer, replacing three
reference threads with two jitted programs invoked per keyframe:

- ``process_keyframe``: depth -> cloud -> downsample -> batched RANSAC ->
  world transform -> association/creation -> semantic voting (the work of
  GeometricSegmentation.cc:29-99 + SemanticSegmentation.cc:16-292 +
  GeoSemHelpers create/updateMapPlane).
- ``detect_rooms``: facing/perpendicular wall analysis -> corridor (2-wall)
  and room (4-wall) candidates with closed-form centers (the work of
  SemanticsManager.cc:302-403 + GeoSemHelpers room candidates).  Free-space
  clusters from the external voxblox process are re-scoped to wall-geometry
  inference (SURVEY §7.3 — the one intentional capability re-interpretation).

Semantic input is a per-pixel class image (dataset GT, precomputed segmenter
output, or an in-framework model) — the ROS round-trip to segmenter_ros
becomes a function argument.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.config import SceneGraphConfig
from visual_sgraphs.core import lie, plane as plane_mod
from visual_sgraphs.scenegraph.plane_fit import extract_planes
from visual_sgraphs.scenegraph.pointcloud import (
    backproject_depth,
    voxel_downsample,
)
from visual_sgraphs.scenegraph.state import (
    CEILING,
    GROUND,
    N_CLASSES,
    UNDEFINED,
    WALL,
    SceneGraphState,
    plane_semantics,
)


# ---------------------------------------------------------------------------
# per-keyframe plane update
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_det",))
def associate_and_update(
    sg: SceneGraphState,
    det_coeffs: jax.Array,  # (n_det, 4) world-frame detected planes
    det_valid: jax.Array,  # (n_det,)
    det_centroid: jax.Array,  # (n_det, 3)
    det_npts: jax.Array,  # (n_det,)
    det_votes: jax.Array,  # (n_det, N_CLASSES) confidence mass per class
    det_local: jax.Array,  # (n_det, 4) plane in camera frame (observation)
    kf_id: jax.Array,
    det_quadric: jax.Array = None,  # (n_det, 4, 4) camera-frame Gij
    det_vox: jax.Array = None,  # (n_det, V) surface-membership voxel keys
    ominus_thresh: float = 0.3,
    dist_thresh: float = 0.35,
    centroid_thresh: float = 1.5,
    n_det: int = 4,
):
    """Associate detected planes against the map table; update matches,
    create the rest (Utils::associatePlanes, Utils.cc:413-536 +
    GeoSemHelpers::create/updateMapPlane)."""
    dt = sg.pl_coeffs.dtype
    det_coeffs = det_coeffs.astype(dt)
    det_centroid = det_centroid.astype(dt)
    det_npts = det_npts.astype(dt)
    det_votes = det_votes.astype(dt)
    det_local = det_local.astype(dt)
    if det_quadric is None:
        det_quadric = jnp.zeros((n_det, 4, 4), dt)
    det_quadric = det_quadric.astype(dt)
    P = sg.P
    for i in range(n_det):
        coeffs = det_coeffs[i]
        ok = det_valid[i]
        # chart distance to every map plane
        diff = jax.vmap(lambda ref: plane_mod.ominus(ref, coeffs))(
            sg.pl_coeffs
        )  # (P, 3)
        ang = jnp.linalg.norm(diff[:, :2], axis=-1)
        dd = jnp.abs(diff[:, 2])
        cdist = jnp.linalg.norm(sg.pl_centroid - det_centroid[i], axis=-1)
        cand = sg.pl_valid & (ang < ominus_thresh) & (dd < dist_thresh) & (
            cdist < centroid_thresh
        )
        score = jnp.where(cand, ang + dd, jnp.inf)
        best = jnp.argmin(score)
        matched = ok & jnp.isfinite(score[best])

        # --- update matched plane: running weighted average of the equation
        # and centroid, vote accumulation
        w_old = jnp.maximum(sg.pl_npts[best], 1.0)
        w_new = jnp.maximum(det_npts[i], 1.0)
        alpha = w_new / (w_old + w_new)
        # blend in the chart of the old plane for stability
        blended = plane_mod.oplus(
            sg.pl_coeffs[best],
            alpha * plane_mod.ominus(sg.pl_coeffs[best], coeffs),
        )
        new_coeffs = jnp.where(matched, blended, sg.pl_coeffs[best])
        new_centroid = jnp.where(
            matched,
            sg.pl_centroid[best] * (1 - alpha) + det_centroid[i] * alpha,
            sg.pl_centroid[best],
        )
        sg = sg._replace(
            pl_coeffs=sg.pl_coeffs.at[best].set(new_coeffs),
            pl_centroid=sg.pl_centroid.at[best].set(new_centroid),
            pl_npts=sg.pl_npts.at[best].add(
                jnp.where(matched, det_npts[i], 0.0)
            ),
            pl_votes=sg.pl_votes.at[best].add(
                jnp.where(matched, det_votes[i], 0.0)
            ),
            pl_nobs=sg.pl_nobs.at[best].add(
                jnp.where(matched, 1, 0).astype(jnp.int32)
            ),
        )

        # --- or create a new plane
        create = ok & ~matched
        slot = jnp.minimum(sg.n_planes, P - 1)
        can_alloc = create & (sg.n_planes < P)
        sg = sg._replace(
            pl_coeffs=sg.pl_coeffs.at[slot].set(
                jnp.where(can_alloc, coeffs, sg.pl_coeffs[slot])
            ),
            pl_valid=sg.pl_valid.at[slot].set(
                can_alloc | sg.pl_valid[slot]
            ),
            pl_centroid=sg.pl_centroid.at[slot].set(
                jnp.where(can_alloc, det_centroid[i], sg.pl_centroid[slot])
            ),
            pl_npts=sg.pl_npts.at[slot].add(
                jnp.where(can_alloc, det_npts[i], 0.0)
            ),
            pl_votes=sg.pl_votes.at[slot].add(
                jnp.where(can_alloc, det_votes[i], 0.0)
            ),
            pl_nobs=sg.pl_nobs.at[slot].add(can_alloc.astype(jnp.int32)),
            n_planes=sg.n_planes + can_alloc.astype(jnp.int32),
        )
        plane_id = jnp.where(matched, best, jnp.where(can_alloc, slot, -1))

        # --- merge the detection's surface-membership voxels into the
        # plane's table (Plane.cc accumulates the observation cloud into
        # the per-plane octree the same way); new keys overwrite their
        # hash slot, untouched slots keep their history
        if det_vox is not None:
            row = jnp.maximum(plane_id, 0)
            merged_vox = jnp.where(
                (plane_id >= 0) & (det_vox[i] >= 0),
                det_vox[i], sg.pl_vox[row],
            )
            sg = sg._replace(pl_vox=sg.pl_vox.at[row].set(merged_vox))

        # --- record the observation for plane-KF factors
        oslot = jnp.minimum(sg.n_obs, sg.ob_kf.shape[0] - 1)
        rec = (plane_id >= 0) & (sg.n_obs < sg.ob_kf.shape[0])
        sg = sg._replace(
            ob_kf=sg.ob_kf.at[oslot].set(
                jnp.where(rec, kf_id, sg.ob_kf[oslot])
            ),
            ob_plane=sg.ob_plane.at[oslot].set(
                jnp.where(rec, plane_id, sg.ob_plane[oslot])
            ),
            ob_coeffs=sg.ob_coeffs.at[oslot].set(
                jnp.where(rec, det_local[i], sg.ob_coeffs[oslot])
            ),
            ob_conf=sg.ob_conf.at[oslot].set(
                jnp.where(rec, jnp.sum(det_votes[i]) /
                          jnp.maximum(det_npts[i], 1.0), sg.ob_conf[oslot])
            ),
            ob_quadric=sg.ob_quadric.at[oslot].set(
                jnp.where(rec, det_quadric[i], sg.ob_quadric[oslot])
            ),
            ob_valid=sg.ob_valid.at[oslot].set(rec | sg.ob_valid[oslot]),
            n_obs=sg.n_obs + rec.astype(jnp.int32),
        )
    return sg


@functools.partial(jax.jit, static_argnames=("n_cloud", "n_det", "n_hyp",
                                             "vox_slots"))
def detect_planes_from_depth(
    depth_img: jax.Array,
    sem_img: jax.Array | None,
    T_cw: jax.Array,
    cam_K: jax.Array,
    key: jax.Array,
    conf_img: jax.Array | None = None,
    n_cloud: int = 2048,
    n_det: int = 4,
    n_hyp: int = 192,
    voxel: float = 0.08,
    dist_thresh: float = 0.04,
    min_inliers: float = 150.0,
    vox_slots: int = 512,
):
    """Depth (+ optional per-pixel class / confidence) image -> detected
    world planes.

    Returns (world_coeffs (n_det,4), valid, centroid (n_det,3), npts,
    votes (n_det, N_CLASSES), local_coeffs (n_det,4), quadric (n_det,4,4)).

    ``conf_img``: optional (H, W) per-pixel confidence in [0, 1] — the
    reference's α channel (class probability × depth-interpolated
    uncertainty, SemanticSegmentation.cc:93-175).  It drives the
    confidence-weighted RANSAC inlier score (WeightedSACModelPlane.hpp:
    21-49), the weighted semantic votes (Plane::castWeightedVote), and the
    Gij quadric weights.

    Design note vs the reference: instead of running one RANSAC per semantic
    class on thresholded class clouds (SemanticSegmentation.cc:177-207), we
    extract planes geometrically on the full cloud and derive each plane's
    class votes from the labels of its inliers — same voting semantics
    (confidence mass per class, Plane.cc:166-197), one extraction.
    """
    pts_cam, valid, rc = backproject_depth(depth_img, cam_K, stride=4)
    if sem_img is not None:
        labels = sem_img[rc[:, 0], rc[:, 1]]
    else:
        labels = jnp.full(pts_cam.shape[:1], UNDEFINED, jnp.int32)
    if conf_img is not None:
        conf = conf_img[rc[:, 0], rc[:, 1]].astype(jnp.float32)
    else:
        conf = jnp.ones(pts_cam.shape[:1], jnp.float32)

    # voxel-downsampled cloud for fitting; per-point confidences feed the
    # weighted RANSAC inlier score (pcl_custom WeightedSACSegmentation)
    cloud, cvalid, cweight = voxel_downsample(
        pts_cam, valid, voxel, n_cloud, min_points_per_voxel=1,
        point_weight=conf,
    )
    coeffs_c, det_valid, assign = extract_planes(
        cloud, cvalid, cweight, key, n_planes=n_det, n_hyp=n_hyp,
        dist_thresh=dist_thresh, min_inliers=min_inliers,
    )

    # votes + centroid from the raw labeled cloud (denser than the fit cloud)
    T_wc = lie.se3_inverse(T_cw)
    coeffs_w = jax.vmap(lambda c: plane_mod.transform(T_wc, c))(coeffs_c)
    pts_w = lie.se3_apply(T_wc, pts_cam)

    dists = jnp.abs(
        jnp.einsum("di,ni->dn", coeffs_c[:, :3], pts_cam) + coeffs_c[:, 3:4]
    )  # (n_det, M)
    member = (dists < dist_thresh * 1.5) & valid[None, :]
    memw = member.astype(jnp.float32) * conf[None, :]  # confidence mass
    npts = jnp.sum(member, axis=1).astype(jnp.float32)
    centroid = jnp.einsum("dn,ni->di", member.astype(jnp.float32), pts_w) / (
        jnp.maximum(npts, 1.0)[:, None]
    )
    votes = jnp.stack(
        [
            jnp.sum(memw * (labels == c)[None, :], axis=1)
            for c in range(N_CLASSES)
        ],
        axis=-1,
    )
    # normalize votes so one observation contributes at most ~1 vote per
    # class-majority (keeps min_votes thresholds image-size independent)
    votes = votes / jnp.maximum(jnp.sum(votes, axis=-1, keepdims=True), 1.0)
    # Gij point quadric per detection: Σ w·p̃ p̃ᵀ over the supporting cloud
    # in the CAMERA frame (GeoSemHelpers.cc:24-35), normalized by the
    # member count so the factor's chi2 is a mean squared distance (f32
    # conditioning; the count re-enters through the factor info weight)
    ph = jnp.concatenate(
        [pts_cam, jnp.ones(pts_cam.shape[:1] + (1,), jnp.float32)], axis=-1
    )  # (M, 4)
    quad = jnp.einsum("dn,ni,nj->dij", memw, ph, ph) / jnp.maximum(
        jnp.sum(memw, axis=1), 1.0
    )[:, None, None]
    # per-detection surface-membership voxel keys (the per-Plane octree
    # the reference queries for membership, Plane.cc:81-140): every member
    # point PROJECTED onto its plane, quantized, hashed into a (V,) row
    from visual_sgraphs.scenegraph.state import voxel_key, voxel_slot

    V = vox_slots
    nvec = coeffs_w[:, :3]  # (n_det, 3)
    sd_w = pts_w @ nvec.T + coeffs_w[:, 3][None, :]  # (M, n_det)
    proj = pts_w[None, :, :] - sd_w.T[:, :, None] * nvec[:, None, :]
    keys = voxel_key(proj)  # (n_det, M)
    slots = voxel_slot(keys, V)
    d_idx = jnp.broadcast_to(
        jnp.arange(keys.shape[0], dtype=jnp.int32)[:, None], keys.shape
    )
    det_vox = jnp.full((keys.shape[0], V), -1, jnp.int32).at[
        jnp.where(member, d_idx, 0), jnp.where(member, slots, 0)
    ].max(jnp.where(member, keys, -1))
    return (coeffs_w, det_valid, centroid, npts, votes, coeffs_c, quad,
            det_vox)


# ---------------------------------------------------------------------------
# room / corridor inference from wall geometry
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("max_candidates",))
def detect_rooms(sg: SceneGraphState, min_votes: float = 3.0,
                 min_gap: float = 0.8, max_gap: float = 12.0,
                 perp_tol: float = 0.2, max_candidates: int = 3):
    """Facing-wall-pair analysis -> corridor (2-wall) / room (4-wall)
    candidates with centers from the wall geometry
    (SemanticsManager::detectMapRoomCandidate*, getRectangularRoom,
    Utils::getAllPlanesFacingEachOther / getRoomCenter).

    Runs ``max_candidates`` greedy rounds, masking out walls already
    consumed, so multi-room environments yield several candidates per pass
    (the reference iterates over all free-space clusters,
    SemanticsManager.cc:302-403).  Each found candidate also gets the
    nearest compatible ground plane attached
    (GeoSemHelpers::associateGroundPlaneToRoom, GeoSemHelpers.cc:421-459).
    """
    sem = plane_semantics(sg, min_votes)
    P = sg.P
    n = sg.pl_coeffs[:, :3]
    is_ground = sg.pl_valid & (sem == GROUND)
    pi, pj = jnp.nonzero(jnp.ones((P, P), bool), size=P * P)

    wall_free = sg.pl_valid & (sem == WALL)

    def round_body(sg_and_free, _):
        sg, wall_free = sg_and_free
        is_wall = wall_free

        dot = n @ n.T
        cdiff = sg.pl_centroid[None, :, :] - sg.pl_centroid[:, None, :]
        gap = jnp.abs(jnp.einsum("pi,pqi->pq", n, cdiff))
        lateral = jnp.linalg.norm(
            cdiff - jnp.einsum("pqi,pi->pq", cdiff, n)[..., None]
            * n[:, None, :],
            axis=-1,
        )
        facing = (
            is_wall[:, None]
            & is_wall[None, :]
            & (dot < -0.9)
            & (gap > min_gap)
            & (gap < max_gap)
            & (lateral < max_gap)
        )
        facing = facing & (jnp.arange(P)[:, None] < jnp.arange(P)[None, :])
        pair_center = 0.5 * (
            sg.pl_centroid[:, None, :] + sg.pl_centroid[None, :, :]
        )
        fac_flat = facing[pi, pj]
        support = jnp.where(fac_flat, sg.pl_npts[pi] + sg.pl_npts[pj], -1.0)
        b1 = jnp.argmax(support)
        i1, j1 = pi[b1], pj[b1]
        have1 = support[b1] > 0
        n1 = n[i1]
        perp = jnp.abs(jnp.einsum("i,qi->q", n1, n[pi])) < perp_tol
        center_dist = jnp.linalg.norm(
            pair_center[pi, pj] - pair_center[i1, j1], axis=-1
        )
        score2 = jnp.where(fac_flat & perp, -center_dist, -jnp.inf)
        b2 = jnp.argmax(score2)
        i2, j2 = pi[b2], pj[b2]
        have2 = jnp.isfinite(score2[b2])

        room_found = have1 & have2
        room_center = 0.5 * (pair_center[i1, j1] + pair_center[i2, j2])
        room_walls = jnp.stack([i1, j1, i2, j2]).astype(jnp.int32)
        corridor_found = have1 & ~have2
        corr_center = pair_center[i1, j1]
        corr_walls = jnp.stack(
            [i1, j1, jnp.asarray(-1), jnp.asarray(-1)]
        ).astype(jnp.int32)
        found = room_found | corridor_found
        center = jnp.where(room_found, room_center, corr_center)
        walls = jnp.where(room_found, room_walls, corr_walls)

        # ground association: biggest ground plane laterally close to the
        # candidate center
        g_support = jnp.where(is_ground, sg.pl_npts, -1.0)
        g_lat = jnp.linalg.norm(sg.pl_centroid - center[None, :], axis=-1)
        g_ok = is_ground & (g_lat < max_gap)
        g_best = jnp.argmax(jnp.where(g_ok, g_support, -1.0))
        ground_id = jnp.where(
            found & jnp.any(g_ok), g_best.astype(jnp.int32), -1
        )

        # associate with existing rooms by shared walls or center distance
        # (roomAssociation, SemanticsManager.cc:410-474) else create
        shared = jnp.sum(
            (sg.room_walls[:, :, None] == walls[None, None, :])
            & (sg.room_walls[:, :, None] >= 0),
            axis=(1, 2),
        )
        cdist = jnp.linalg.norm(sg.room_center - center[None, :], axis=-1)
        cand = sg.room_valid & ((cdist < 1.5) | (shared >= 2))
        match = jnp.argmin(jnp.where(cand, cdist, jnp.inf))
        matched = found & cand[match]
        slot = jnp.where(
            matched, match,
            jnp.minimum(sg.n_rooms, sg.room_valid.shape[0] - 1),
        )
        can = found & (matched | (sg.n_rooms < sg.room_valid.shape[0]))
        sg = sg._replace(
            room_center=sg.room_center.at[slot].set(
                jnp.where(can, center, sg.room_center[slot])
            ),
            room_walls=sg.room_walls.at[slot].set(
                jnp.where(can, walls, sg.room_walls[slot])
            ),
            room_is_corridor=sg.room_is_corridor.at[slot].set(
                jnp.where(can, corridor_found, sg.room_is_corridor[slot])
            ),
            room_ground=sg.room_ground.at[slot].set(
                jnp.where(can, ground_id, sg.room_ground[slot])
            ),
            room_valid=sg.room_valid.at[slot].set(can | sg.room_valid[slot]),
            n_rooms=sg.n_rooms + (can & ~matched).astype(jnp.int32),
        )
        # consume this candidate's walls for the next greedy round
        used = jnp.zeros((P,), bool).at[
            jnp.clip(walls, 0, P - 1)
        ].set(walls >= 0)
        wall_free = wall_free & ~jnp.where(found, used, False)
        return (sg, wall_free), None

    (sg, _), _ = jax.lax.scan(
        round_body, (sg, wall_free), None, length=max_candidates
    )
    return sg


@jax.jit
def refine_points_semantic(m, sg: SceneGraphState, T_cw: jax.Array,
                           min_votes: float = 3.0,
                           behind_thresh: float = 0.15,
                           lateral_radius: float = 2.5):
    """Cull map points lying BEHIND a settled semantic plane — the
    reference's semantic map-point refinement inside PoseOptimization
    (Optimizer.cc:1271-1336), which deletes points whose position falls
    through a wall/ground the segmenter has confirmed (membership via the
    plane's octree, Plane.cc:81-140; here: signed side test vs the camera
    center + lateral distance to the plane centroid as the extent proxy).

    Depth sensors produce such points at depth discontinuities and around
    reflective surfaces; they corrupt both tracking and BA.  Runs at
    keyframe rate (the device pipeline mutates the map per keyframe, not per
    frame).  Returns the updated map."""
    import jax.numpy as jnp

    from visual_sgraphs.scenegraph.state import voxel_key, voxel_slot

    sem = plane_semantics(sg, min_votes)
    planes_ok = sg.pl_valid & (sem != UNDEFINED)
    n = sg.pl_coeffs[:, :3]  # (P, 3)
    d = sg.pl_coeffs[:, 3]  # (P,)
    C = lie.se3_inverse(T_cw)[4:7]  # camera center in world
    side_cam = n @ C + d  # (P,) camera side of each plane
    sd = m.pt_pos @ n.T + d[None, :]  # (N, P) signed point distances
    # extent test: the point's PROJECTION onto the plane must fall in a
    # voxel the plane's observations actually covered (the reference's
    # octree membership query, Plane.cc:121 — replaces the centroid
    # lateral-radius proxy, which wrongly culled points on parallel-but-
    # distinct walls and wrongly spared a long wall's far end)
    proj = m.pt_pos[:, None, :] - sd[:, :, None] * n[None, :, :]  # (N,P,3)
    keys = voxel_key(proj)  # (N, P)
    slots = voxel_slot(keys, sg.pl_vox.shape[1])
    in_extent = (
        jnp.take_along_axis(sg.pl_vox, slots.T, axis=1).T == keys
    )  # (N, P): pl_vox[p, slots[n,p]] == keys[n,p]
    behind = (
        (sd * side_cam[None, :] < 0)
        & (jnp.abs(sd) > behind_thresh)
        & in_extent
        & planes_ok[None, :]
    )
    bad = m.pt_valid & jnp.any(behind, axis=1)
    obs = m.kf_obs_pt
    linked_bad = (obs >= 0) & bad[jnp.maximum(obs, 0)]
    return m._replace(
        pt_valid=m.pt_valid & ~bad,
        pt_freed_seq=jnp.where(bad, m.n_kf, m.pt_freed_seq),
        kf_obs_pt=jnp.where(linked_bad, -1, obs),
    )


@functools.partial(jax.jit, static_argnames=("K",))
def plane_covis_bonus(sg: SceneGraphState, kf_id: jax.Array, K: int,
                      min_votes: float = 3.0, score: float = 10.0,
                      undefined_factor: float = 0.2) -> jax.Array:
    """(K,) covisibility-weight bonus from planes shared with ``kf_id``
    (KeyFrame::UpdateConnections' plane-based weighting, KeyFrame.cc:
    486-523): every plane observed by both keyframes adds ``score``
    shared-point equivalents (``score * undefined_factor`` while its
    semantic class is unsettled), so structurally-related keyframes enter
    each other's local-BA windows even with few shared map points."""
    sem = plane_semantics(sg, min_votes)  # (P,)
    P = sg.pl_coeffs.shape[0]
    ob_ok = sg.ob_valid & (sg.ob_plane >= 0) & (sg.ob_kf >= 0) & \
        (sg.ob_kf < K)
    member = jnp.zeros((K, P), jnp.int32).at[
        jnp.clip(sg.ob_kf, 0, K - 1), jnp.maximum(sg.ob_plane, 0)
    ].max(ob_ok.astype(jnp.int32)) > 0  # (K, P)
    mine = member[kf_id]  # (P,)
    w = jnp.where(sem != UNDEFINED, score, score * undefined_factor)
    w = jnp.where(sg.pl_valid, w, 0.0)
    bonus = jnp.sum(
        (member & mine[None, :]).astype(w.dtype) * w[None, :], axis=1
    )
    return bonus.at[kf_id].set(0.0)


@jax.jit
def filter_semantic_planes(sg: SceneGraphState, min_votes: float = 3.0,
                           max_tilt_wall: float = 0.25,
                           max_tilt_ground: float = 0.25,
                           max_step_elevation: float = 0.5):
    """Reset mislabeled wall/ground semantics against the biggest ground
    plane's reference frame (SemanticsManager::filterWallPlanes /
    filterGroundPlanes, SemanticsManager.cc:65-113): walls whose normal
    tilts out of the ground plane, and grounds that sit a step above/below
    the dominant ground or tilt away from it, lose their votes."""
    sem = plane_semantics(sg, min_votes)
    is_g = sg.pl_valid & (sem == GROUND)
    has_g = jnp.any(is_g)
    gidx = jnp.argmax(jnp.where(is_g, sg.pl_npts, -1.0))
    up = sg.pl_coeffs[gidx, :3]  # unit ground normal (the rectifying axis)

    tilt_w = jnp.abs(sg.pl_coeffs[:, :3] @ up)
    reset_w = sg.pl_valid & (sem == WALL) & (tilt_w > max_tilt_wall)

    h = sg.pl_centroid @ up
    dh = jnp.abs(h - h[gidx])
    align_g = jnp.abs(sg.pl_coeffs[:, :3] @ up)
    reset_g = (
        sg.pl_valid & (sem == GROUND)
        & (jnp.arange(sg.P) != gidx)
        & ((dh > max_step_elevation) | (align_g < 1.0 - max_tilt_ground))
    )
    reset = (reset_w | reset_g) & has_g
    return sg._replace(
        pl_votes=jnp.where(reset[:, None], 0.0, sg.pl_votes)
    )


@jax.jit
def reassociate_planes(sg: SceneGraphState, min_votes: float = 3.0,
                       ominus_thresh: float = 0.2,
                       dist_thresh: float = 0.25,
                       centroid_thresh: float = 2.0):
    """Post-BA re-association: merge the single closest same-class plane
    pair that optimization moved together (Utils::reAssociateSemanticPlanes,
    Utils.cc:550-620 — the reference's 1 Hz thread merges one pair per
    visit too; repeated calls converge).  The smaller plane's observations,
    votes and support transfer to the bigger one and its slot invalidates.
    """
    sem = plane_semantics(sg, min_votes)
    P = sg.P
    diff = jax.vmap(
        lambda c: jax.vmap(lambda r: plane_mod.ominus(r, c))(sg.pl_coeffs)
    )(sg.pl_coeffs)  # (P, P, 3): diff[j, i] = ominus(ref=i, other=j)
    ang = jnp.linalg.norm(diff[..., :2], axis=-1)
    dd = jnp.abs(diff[..., 2])
    cdist = jnp.linalg.norm(
        sg.pl_centroid[:, None, :] - sg.pl_centroid[None, :, :], axis=-1
    )
    same = (
        sg.pl_valid[:, None] & sg.pl_valid[None, :]
        & (sem[:, None] == sem[None, :])
        & (sem[:, None] != UNDEFINED)
        & (jnp.arange(P)[:, None] < jnp.arange(P)[None, :])
    )
    mergeable = same & (ang < ominus_thresh) & (dd < dist_thresh) & (
        cdist < centroid_thresh
    )
    score = jnp.where(mergeable, ang + dd, jnp.inf)
    flat = jnp.argmin(score.reshape(-1))
    i, j = flat // P, flat % P
    do = jnp.isfinite(score.reshape(-1)[flat])
    # bigger plane keeps the slot
    big = jnp.where(sg.pl_npts[i] >= sg.pl_npts[j], i, j)
    small = jnp.where(sg.pl_npts[i] >= sg.pl_npts[j], j, i)
    w_b = jnp.maximum(sg.pl_npts[big], 1.0)
    w_s = jnp.maximum(sg.pl_npts[small], 1.0)
    alpha = w_s / (w_b + w_s)
    new_centroid = sg.pl_centroid[big] * (1 - alpha) + \
        sg.pl_centroid[small] * alpha
    return sg._replace(
        pl_votes=sg.pl_votes.at[big].add(
            jnp.where(do, sg.pl_votes[small], 0.0)
        ),
        pl_npts=sg.pl_npts.at[big].add(
            jnp.where(do, sg.pl_npts[small], 0.0)
        ),
        pl_nobs=sg.pl_nobs.at[big].add(
            jnp.where(do, sg.pl_nobs[small], 0)
        ),
        pl_centroid=sg.pl_centroid.at[big].set(
            jnp.where(do, new_centroid, sg.pl_centroid[big])
        ),
        pl_valid=sg.pl_valid.at[small].set(
            jnp.where(do, False, sg.pl_valid[small])
        ),
        # re-point the smaller plane's observations (and room walls);
        # cast keeps the stored index dtype under x64 (lax.cond branch
        # parity in the fused keyframe program)
        ob_plane=jnp.where(
            do & (sg.ob_plane == small),
            big.astype(sg.ob_plane.dtype), sg.ob_plane,
        ),
        room_walls=jnp.where(
            do & (sg.room_walls == small),
            big.astype(sg.room_walls.dtype), sg.room_walls,
        ),
        room_ground=jnp.where(
            do & (sg.room_ground == small),
            big.astype(sg.room_ground.dtype), sg.room_ground,
        ),
    )


# ---------------------------------------------------------------------------
# host-side manager
# ---------------------------------------------------------------------------


class SceneGraphManager:
    """Attachable scene-graph pipeline (system.scenegraph = manager)."""

    def __init__(self, cfg: SceneGraphConfig = SceneGraphConfig(),
                 capacity=None, seed: int = 0):
        from visual_sgraphs.config import CapacityConfig
        from visual_sgraphs.scenegraph.state import empty_scenegraph

        self.cfg = cfg
        self.state = empty_scenegraph(capacity or CapacityConfig())
        self._key = jax.random.PRNGKey(seed)
        self._pending_sem = {}
        # lagged host mirror of n_obs: refreshed one keyframe behind so the
        # hot path never blocks on a device scalar
        self.n_obs_host = 0
        self._nobs_handle = None
        # when True the system reads n_obs back through the loop-detect
        # scalar board instead of a dedicated per-KF sync
        self.defer_nobs_readback = False
        self._kf_count = 0
        self.maintenance_interval = 4  # KFs between filter/re-associate runs
        # free-space room inference (room_method="freespace"): transient
        # observed-free voxel grid, the in-framework voxblox-skeleton
        # equivalent (Atlas.h:138 skeleton store; not checkpointed there
        # either)
        self._free_grid = None
        self._free_origin = None

    def update_freespace(self, depth_img, T_cw, cam_K) -> None:
        """Accumulate this keyframe's observed free space into the grid
        (scenegraph/freespace.py; called at keyframe cadence when
        room_method == "freespace")."""
        import jax.numpy as jnp

        from visual_sgraphs.scenegraph import freespace as fs

        G = self.cfg.freespace_grid
        vox = self.cfg.freespace_voxel
        if self._free_grid is None:
            self._free_grid = jnp.zeros((G, G, G), bool)
            # grid centered on the current camera position
            import jax

            from visual_sgraphs.core import lie as _lie
            C = _lie.se3_inverse(jnp.asarray(T_cw))[4:7]
            self._free_origin = C - 0.5 * G * vox
        self._free_grid = fs.accumulate_freespace(
            self._free_grid, self._free_origin,
            jnp.asarray(vox, jnp.float32), jnp.asarray(depth_img),
            jnp.asarray(T_cw), jnp.asarray(cam_K), G=G,
        )

    def infer_rooms_freespace(self) -> None:
        """Cluster the free-space grid and upsert room candidates seeded
        by the cluster centers (detectMapRoomCandidateVoxblox)."""
        import jax.numpy as jnp

        from visual_sgraphs.scenegraph import freespace as fs

        if self._free_grid is None:
            return
        centers, valid = fs.freespace_cluster_centers(
            self._free_grid, self._free_origin,
            jnp.asarray(self.cfg.freespace_voxel, jnp.float32),
            G=self.cfg.freespace_grid,
        )
        self.state = fs.detect_rooms_freespace(
            self.state, centers, valid,
            min_votes=self.cfg.plane_min_votes,
            wall_dist=self.cfg.room_wall_dist_thresh,
        )

    def provide_semantics(self, timestamp: float, sem_img, conf_img=None):
        """Register a per-pixel class image (and optional per-pixel
        confidence in [0, 1]) for the frame at ``timestamp`` — the
        segmenter_ros result channel (System::addSegmentedImage; probability
        + uncertainty images, SemanticSegmentation.cc:93-175).  Timestamps
        are kept as host float64: TUM-epoch stamps (~1.3e9 s) need full
        precision."""
        self._pending_sem[float(timestamp)] = (sem_img, conf_img)

    def pop_semantics(self, ts: float | None, max_dt: float = 0.05):
        """Pop the semantics registered nearest to ``ts`` (<``max_dt`` s —
        the reference's nearest-in-time marker/semantics attachment window,
        common.cc:1190).  Entries older than ts−1 s are garbage-collected
        (SemanticSegmentation.cc:54-68's stale-buffer GC)."""
        if ts is None or not self._pending_sem:
            return None
        ts = float(ts)
        best = min(self._pending_sem.keys(), key=lambda k: abs(k - ts))
        out = None
        if abs(best - ts) <= max_dt:
            out = self._pending_sem.pop(best)
        for k in [k for k in self._pending_sem if k < ts - 1.0]:
            del self._pending_sem[k]
        return out

    def on_keyframe(self, system, kf_id, frame, depth_img=None,
                    sem_img=None, conf_img=None, ts=None):
        if depth_img is None:
            depth_img = getattr(frame, "_depth_img", None)
        if depth_img is None:
            return
        if sem_img is None:
            pending = self.pop_semantics(
                ts if ts is not None else getattr(system, "_last_ts", None)
            )
            if pending is not None:
                sem_img, conf_img = pending
        self._key, sub = jax.random.split(self._key)
        T_cw = system.map.kf_pose[kf_id]
        det = detect_planes_from_depth(
            jnp.asarray(depth_img),
            None if sem_img is None else jnp.asarray(sem_img),
            T_cw, system.cam_K, sub,
            conf_img=None if conf_img is None else jnp.asarray(conf_img),
            dist_thresh=self.cfg.ransac_dist_thresh,
        )
        (coeffs_w, det_valid, centroid, npts, votes, local, quad,
         det_vox) = det
        self.state = associate_and_update(
            self.state, coeffs_w, det_valid, centroid, npts, votes, local,
            kf_id, det_quadric=quad, det_vox=det_vox,
            ominus_thresh=self.cfg.plane_assoc_ominus_thresh,
            dist_thresh=self.cfg.plane_assoc_dist_thresh,
        )
        # periodic semantics maintenance (the 1 Hz SemanticsManager thread,
        # SemanticsManager.cc:13-56): tilt/elevation filtering of mislabeled
        # planes, then post-optimization re-association/merging
        self._kf_count += 1
        if self._kf_count % self.maintenance_interval == 0:
            self.state = filter_semantic_planes(
                self.state, min_votes=self.cfg.plane_min_votes
            )
            self.state = reassociate_planes(
                self.state, min_votes=self.cfg.plane_min_votes,
            )
        if self.cfg.refine_map_points:
            system.map = refine_points_semantic(
                system.map, self.state, T_cw,
                min_votes=self.cfg.plane_min_votes,
                behind_thresh=self.cfg.refine_behind_thresh,
                lateral_radius=self.cfg.refine_lateral_radius,
            )
        self.state = detect_rooms(
            self.state, min_votes=self.cfg.plane_min_votes
        )
        if self.defer_nobs_readback:
            self._nobs_handle = self.state.n_obs
        else:
            if self._nobs_handle is not None:
                self.n_obs_host = int(self._nobs_handle)
            self._nobs_handle = self.state.n_obs

    # ---- fiducial markers -> doors / marker-based rooms

    def observe_markers(self, system, kf_id, markers, env=None):
        """Ingest fiducial-marker detections attached to a keyframe.

        ``markers``: iterable of (aruco_id, T_cm (7,) marker pose in the
        camera frame).  Classification against the environment database
        follows GeoSemHelpers::markerSemanticAnalysis (GeoSemHelpers.cc:
        143-203): a marker listed as a door marker creates/updates a Door
        (:226-253); a room meta-marker creates/updates a marker-based Room
        candidate (:288-330).  Marker counts are tiny (<=32), so this stage
        is host-side numpy like the config layer.
        """
        from visual_sgraphs.core import lie as _lie

        env = env or getattr(system.cfg, "env", None)
        door_ids = {d.marker: d.name for d in env.doors} if env else {}
        room_meta = {r.meta_marker: r for r in env.rooms} if env else {}
        sg = self.state
        T_wc = _lie.se3_inverse(system.map.kf_pose[kf_id])
        mid = np.array(sg.marker_id)
        did = np.array(sg.door_marker)
        rmk = np.array(sg.room_marker)
        for aruco_id, T_cm in markers:
            T_wm = _lie.se3_multiply(T_wc, jnp.asarray(T_cm, jnp.float32))
            # upsert marker
            hit = np.nonzero(mid == aruco_id)[0]
            if len(hit):
                slot = int(hit[0])
            else:
                slot = int(sg.n_markers)
                if slot >= mid.shape[0]:
                    continue
                mid[slot] = aruco_id
                sg = sg._replace(n_markers=sg.n_markers + 1)
            sg = sg._replace(
                marker_pose=sg.marker_pose.at[slot].set(T_wm),
                marker_id=sg.marker_id.at[slot].set(aruco_id),
                marker_valid=sg.marker_valid.at[slot].set(True),
            )
            if aruco_id in door_ids:
                dhit = np.nonzero(did == aruco_id)[0]
                dslot = int(dhit[0]) if len(dhit) else int(sg.n_doors)
                if dslot < did.shape[0]:
                    if not len(dhit):
                        did[dslot] = aruco_id
                        sg = sg._replace(n_doors=sg.n_doors + 1)
                    sg = sg._replace(
                        door_pose=sg.door_pose.at[dslot].set(T_wm),
                        door_marker=sg.door_marker.at[dslot].set(aruco_id),
                        door_valid=sg.door_valid.at[dslot].set(True),
                    )
            elif aruco_id in room_meta:
                rhit = np.nonzero(rmk == aruco_id)[0]
                rslot = int(rhit[0]) if len(rhit) else int(sg.n_rooms)
                if rslot < rmk.shape[0]:
                    if not len(rhit):
                        rmk[rslot] = aruco_id
                        sg = sg._replace(n_rooms=sg.n_rooms + 1)
                    sg = sg._replace(
                        room_center=sg.room_center.at[rslot].set(T_wm[4:7]),
                        room_marker=sg.room_marker.at[rslot].set(aruco_id),
                        room_is_corridor=sg.room_is_corridor.at[rslot].set(
                            bool(room_meta[aruco_id].is_corridor)
                        ),
                        room_valid=sg.room_valid.at[rslot].set(True),
                    )
        self.state = sg

    # ---- queries (the System.h:230-238 scene-graph getters)

    def planes(self):
        from visual_sgraphs.scenegraph.state import plane_semantics

        sem = plane_semantics(self.state, self.cfg.plane_min_votes)
        ok = np.asarray(self.state.pl_valid)
        return {
            "coeffs": np.asarray(self.state.pl_coeffs)[ok],
            "centroid": np.asarray(self.state.pl_centroid)[ok],
            "semantic": np.asarray(sem)[ok],
            "n_points": np.asarray(self.state.pl_npts)[ok],
        }

    def rooms(self):
        ok = np.asarray(self.state.room_valid)
        return {
            "center": np.asarray(self.state.room_center)[ok],
            "walls": np.asarray(self.state.room_walls)[ok],
            "is_corridor": np.asarray(self.state.room_is_corridor)[ok],
            "meta_marker": np.asarray(self.state.room_marker)[ok],
        }

    def doors(self):
        ok = np.asarray(self.state.door_valid)
        return {
            "pose": np.asarray(self.state.door_pose)[ok],
            "marker": np.asarray(self.state.door_marker)[ok],
        }

    def markers(self):
        ok = np.asarray(self.state.marker_valid)
        return {
            "pose": np.asarray(self.state.marker_pose)[ok],
            "id": np.asarray(self.state.marker_id)[ok],
        }

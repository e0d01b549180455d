"""Jitted mapping programs: keyframe insertion, point creation, local BA.

Device-side equivalents of the reference's LocalMapping thread
(LocalMapping.cc:58-278): ProcessNewKeyFrame, CreateNewMapPoints
(epipolar triangulation), the Schur local BA (Optimizer.cc:1454) and
map-point culling (LocalMapping.cc:341).  Instead of a worker thread popping
a queue, the host calls these after each keyframe decision; the map pytree
is replaced functionally.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.core import cameras, geometry, lie
from visual_sgraphs.features.match import match_nn_ratio
from visual_sgraphs.optim import (
    FactorBatch,
    GraphProblem,
    factors,
    optimize,
    point_family,
    se3_family,
)
from visual_sgraphs.slam.frame import FrameObs
from visual_sgraphs.slam.map_state import (
    MapState,
    covisibility_counts,
    point_obs_count,
)

CHI2_MONO = 5.991


# ---------------------------------------------------------------------------
# keyframe insertion + RGB-D point seeding
# ---------------------------------------------------------------------------


def retire_keyframe(m: MapState, slot: jax.Array,
                    do: jax.Array) -> MapState:
    """Retire keyframe ``slot`` (cull or capacity eviction), masked by
    ``do``: invalidate the slot, append (seq, parent_seq, T_cp) to the
    retirement ledger so old trajectory rows can re-base through the
    surviving parent — the reference re-bases culled keyframes' relative
    trajectory entries through the spanning-tree parent the same way
    (System::SaveTrajectoryTUM's ``Trel = Trel*pKF->mTcp`` walk) — and
    re-point pt_first_kf at the parent (loop correction moves those points
    with the parent afterwards, LoopClosing.cc:1010-1035)."""
    K = m.K
    seq_s = m.kf_seq[slot]
    cand = m.kf_valid & (jnp.arange(K) != slot)
    dist = jnp.where(cand, jnp.abs(m.kf_seq - seq_s), jnp.int32(2**30))
    parent = jnp.argmin(dist)
    T_cp = lie.se3_normalize(lie.se3_multiply(
        m.kf_pose[slot], lie.se3_inverse(m.kf_pose[parent])
    ))
    # a ledger entry is only written when it can ever resolve: a
    # parentless retirement (no other valid keyframe) would record
    # parent_seq −1 or itself — an unresolvable/self-referential chain —
    # and a saturated ledger must DROP the entry rather than overwrite
    # slot E−1 (which would sever every chain routed through it);
    # frame_poses marks rows whose chain is missing as untracked, and
    # emits a ledger_saturated event when led_n hits capacity
    write = do & jnp.any(cand) & (m.led_n < m.E)
    e = jnp.minimum(m.led_n, m.E - 1)
    return m._replace(
        kf_valid=m.kf_valid.at[slot].set(
            jnp.where(do, False, m.kf_valid[slot])
        ),
        pt_first_kf=jnp.where(
            do & jnp.any(cand) & (m.pt_first_kf == slot),
            parent.astype(m.pt_first_kf.dtype), m.pt_first_kf,
        ),
        led_seq=m.led_seq.at[e].set(
            jnp.where(write, seq_s, m.led_seq[e])
        ),
        led_parent_seq=m.led_parent_seq.at[e].set(
            jnp.where(write, m.kf_seq[parent], m.led_parent_seq[e])
        ),
        led_T_cp=m.led_T_cp.at[e].set(
            jnp.where(write, T_cp, m.led_T_cp[e])
        ),
        led_n=jnp.minimum(m.led_n + write.astype(jnp.int32), m.E),
    )


@functools.partial(jax.jit, static_argnames=("quarantine",))
def insert_keyframe(
    m: MapState,
    frame: FrameObs,
    pose: jax.Array,
    slot_pt: jax.Array,
    cam_K: jax.Array,
    slot: jax.Array = None,
    quarantine: int = 3,
) -> tuple[MapState, jax.Array, jax.Array]:
    """Write the frame into keyframe slot ``slot``; seed new map points
    from keypoints with valid depth that didn't match an existing point
    (CreateNewKeyFrame's close-point seeding, Tracking.cc:3318-3394).

    Slot ALLOCATION is the host's job (SlamSystem._host_alloc_kf_slot:
    first slot its validity mirror shows free, else evict the oldest) —
    passing the slot as an operand makes host/device agreement structural
    instead of two copies of one allocation rule racing against in-flight
    cull boards.  If the chosen slot is still valid on device (capacity
    eviction, or the host's mirror is behind), the occupant retires
    through the ledger first — no more silent overwrite (round-3's
    slot-K−1 bug).  ``slot=None`` falls back to the device-side first-free
    rule (standalone/test use).

    Returns (new_map, kf_slot, evicted: bool scalar).
    """
    K, F = m.K, m.F
    if slot is None:
        free = ~m.kf_valid
        k = jnp.where(jnp.any(free), jnp.argmax(free),
                      jnp.minimum(m.n_kf, K - 1))
    else:
        k = jnp.asarray(slot, jnp.int32)
    evicted = m.kf_valid[k]
    m = retire_keyframe(m, k, evicted)

    # backproject unmatched keypoints with depth into world points
    T_wc = lie.se3_inverse(pose)
    rays = cameras.unproject_pinhole(cam_K, frame.uv)
    p_cam = rays * frame.depth[:, None]
    p_world = lie.se3_apply(T_wc, p_cam)
    new_mask = frame.valid & (frame.depth > 0) & (slot_pt < 0)
    # allocate point ids from the free list; freshly culled ids stay
    # quarantined for ``quarantine`` keyframes so in-flight pipeline match
    # tables can't be relinked to an unrelated reused point — callers on
    # the pipelined path scale this with pipeline_depth (a dispatched
    # batch can span that many frames of stale match tables, ADVICE r4 #2)
    allocatable = ~m.pt_valid & (m.n_kf - m.pt_freed_seq >= quarantine)
    (free_ids,) = jnp.nonzero(allocatable, size=F, fill_value=-1)
    order = jnp.cumsum(new_mask.astype(jnp.int32)) - 1
    new_ids = jnp.where(new_mask, free_ids[jnp.minimum(order, F - 1)], -1)
    alloc = new_ids >= 0
    safe_ids = jnp.maximum(new_ids, 0)

    pt_pos = m.pt_pos.at[safe_ids].set(
        jnp.where(alloc[:, None], p_world, m.pt_pos[safe_ids])
    )
    pt_valid = m.pt_valid.at[safe_ids].set(
        alloc | m.pt_valid[safe_ids]
    )
    pt_desc = m.pt_desc.at[safe_ids].set(
        jnp.where(alloc[:, None], frame.desc, m.pt_desc[safe_ids])
    )
    pt_first = m.pt_first_kf.at[safe_ids].set(
        jnp.where(alloc, k, m.pt_first_kf[safe_ids])
    )
    pt_first_seq = m.pt_first_seq.at[safe_ids].set(
        jnp.where(alloc, m.n_kf, m.pt_first_seq[safe_ids])
    )
    obs_pt = jnp.where(alloc, new_ids, slot_pt)

    new_m = m._replace(
        kf_pose=m.kf_pose.at[k].set(pose),
        kf_valid=m.kf_valid.at[k].set(True),
        kf_timestamp=m.kf_timestamp.at[k].set(frame.timestamp),
        kf_uv=m.kf_uv.at[k].set(frame.uv),
        kf_depth=m.kf_depth.at[k].set(frame.depth),
        kf_level=m.kf_level.at[k].set(frame.level),
        kf_angle=m.kf_angle.at[k].set(frame.angle),
        kf_desc=m.kf_desc.at[k].set(frame.desc),
        kf_kp_valid=m.kf_kp_valid.at[k].set(frame.valid),
        kf_obs_pt=m.kf_obs_pt.at[k].set(obs_pt),
        kf_seq=m.kf_seq.at[k].set(m.n_kf),
        pt_pos=pt_pos,
        pt_valid=pt_valid,
        pt_desc=pt_desc,
        pt_first_kf=pt_first,
        pt_first_seq=pt_first_seq,
        # reused point slots must not inherit the culled point's stats
        pt_visible=m.pt_visible.at[safe_ids].set(
            jnp.where(alloc, 1, m.pt_visible[safe_ids])
        ),
        pt_found=m.pt_found.at[safe_ids].set(
            jnp.where(alloc, 1, m.pt_found[safe_ids])
        ),
        n_kf=m.n_kf + 1,
        n_pt=m.n_pt + jnp.sum(alloc.astype(jnp.int32)),
    )
    return new_m, k, evicted


@jax.jit
def apply_found_stats(m: MapState, slot_pts: jax.Array,
                      vis_pts: jax.Array = None) -> MapState:
    """Fold a batch of per-frame match tables into the found counters, and
    per-frame visibility tables into the visible counters
    (MapPoint::IncreaseFound/IncreaseVisible accumulated lazily).
    ``slot_pts``: (B, F) point ids or -1; ``vis_pts``: (B, n_local) point
    ids predicted visible or -1 (padding rows all -1)."""
    flat = slot_pts.reshape(-1)
    pt_found = m.pt_found.at[jnp.maximum(flat, 0)].add(
        (flat >= 0).astype(jnp.int32), mode="drop"
    )
    pt_visible = m.pt_visible
    if vis_pts is not None:
        vflat = vis_pts.reshape(-1)
        pt_visible = pt_visible.at[jnp.maximum(vflat, 0)].add(
            (vflat >= 0).astype(jnp.int32), mode="drop"
        )
    return m._replace(pt_found=pt_found, pt_visible=pt_visible)


@functools.partial(
    jax.jit,
    static_argnames=("do_fuse", "do_ba", "do_cull", "n_window", "lba_iters",
                     "cull_min_obs", "cull_min_found_ratio"),
)
def insert_and_maintain(
    m: MapState,
    frame: FrameObs,
    pose: jax.Array,
    slot_pt: jax.Array,
    cam_K: jax.Array,
    stats_slots: jax.Array,
    cull_kf_redundancy: float,
    cam_bf: jax.Array = None,
    stats_vis: jax.Array = None,
    do_fuse: bool = True,
    do_ba: bool = False,
    do_cull: bool = True,
    n_window: int = 10,
    lba_iters: int = 10,
    cull_min_obs: int = 2,
    cull_min_found_ratio: float = 0.25,
) -> tuple[MapState, jax.Array]:
    """The whole keyframe bookkeeping path fused into ONE program: lazy
    found/visible stats, insertion + point seeding, observation fusion,
    point and keyframe culling, and (``do_ba``) the windowed Schur BA — the
    LocalMapping chain (LocalMapping.cc:58-278) as one executable: one
    dispatch and no host round trip between its steps."""
    m = apply_found_stats(m, stats_slots, stats_vis)
    m, kf, _ = insert_keyframe(m, frame, pose, slot_pt, cam_K)
    if do_fuse:
        m = fuse_observations(m, kf, cam_K)
    if do_cull:
        m = cull_points(m, min_obs=cull_min_obs,
                        min_found_ratio=cull_min_found_ratio)
        m, _ = cull_keyframes(m, kf, cull_kf_redundancy)
    if do_ba:
        m, _ = local_ba(m, kf, cam_K, cam_bf, n_window=n_window,
                        iters=lba_iters)
    return m, kf


# ---------------------------------------------------------------------------
# mono point creation: epipolar-guided triangulation with top-N neighbours
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_neighbours",))
def create_points_mono(m: MapState, kf_id: jax.Array,
                       cam_K: jax.Array,
                       n_neighbours: int = 3) -> MapState:
    """Triangulate new points between ``kf_id`` and its top-N covisible
    neighbours under the epipolar constraint (CreateNewMapPoints,
    LocalMapping.cc:382 + ORBmatcher::SearchForTriangulation,
    ORBmatcher.h:72): for each neighbour the descriptor NN search runs
    only over the epipolar band implied by the current relative pose, so
    a repeated-texture match off the epipolar line cannot shadow the true
    correspondence, and keypoints the best neighbour cannot triangulate
    (too little parallax, occlusion) get further chances."""
    counts = covisibility_counts(m, kf_id)
    _, top_nb = jax.lax.top_k(counts, n_neighbours)
    nb_has = counts[top_nb] > 0
    T_c = m.kf_pose[kf_id]
    fx = cam_K[0]
    eps_epi = (2.5 / fx) ** 2  # ~2.5 px epipolar band in normalized units
    un_c = m.kf_kp_valid[kf_id] & (m.kf_obs_pt[kf_id] < 0)
    ray_c = cameras.unproject_pinhole(cam_K, m.kf_uv[kf_id])

    F = m.F
    has_pt = jnp.zeros((F,), bool)
    p_world_acc = jnp.zeros((F, 3), m.pt_pos.dtype)
    takes, slots = [], []
    for i in range(n_neighbours):
        nb = top_nb[i]
        T_n = m.kf_pose[nb]
        T_nc = lie.se3_multiply(T_n, lie.se3_inverse(T_c))
        R_nc = lie.quat_to_matrix(T_nc[:4])
        t_nc = T_nc[4:7]
        E = lie.hat(t_nc) @ R_nc  # x_nᵀ E x_c = 0
        un_n = m.kf_valid[nb] & m.kf_kp_valid[nb] & (m.kf_obs_pt[nb] < 0)
        ray_n_all = cameras.unproject_pinhole(cam_K, m.kf_uv[nb])
        # (Fc, Fn) Sampson distances -> epipolar band mask
        Exc = ray_c @ E.T          # (Fc, 3)
        Etxn = ray_n_all @ E       # (Fn, 3)
        num = Exc @ ray_n_all.T    # (Fc, Fn) = x_nᵀ E x_c
        den = (Exc[:, 0] ** 2 + Exc[:, 1] ** 2)[:, None] + \
            (Etxn[:, 0] ** 2 + Etxn[:, 1] ** 2)[None, :]
        band = (num * num) / jnp.maximum(den, 1e-12) < eps_epi
        match, _ = match_nn_ratio(
            m.kf_desc[kf_id], un_c & ~has_pt, m.kf_desc[nb], un_n,
            ratio=0.8,
            angle_a=m.kf_angle[kf_id], angle_b=m.kf_angle[nb],
            pair_mask=band,
        )
        ok = (match >= 0) & nb_has[i]
        slot_n = jnp.maximum(match, 0)
        ray_n = ray_n_all[slot_n]
        p_c, z1, z2 = geometry.triangulate_dlt(
            ray_c, ray_n, jnp.broadcast_to(T_nc, ray_c.shape[:1] + (7,))
        )
        cosp = geometry.parallax_cos(ray_c, ray_n, T_nc)
        uv_c = cameras.project_pinhole(cam_K, p_c)
        p_n = lie.se3_apply(T_nc, p_c)
        uv_n = cameras.project_pinhole(cam_K, p_n)
        err_c = jnp.sum((uv_c - m.kf_uv[kf_id]) ** 2, axis=-1)
        err_n = jnp.sum((uv_n - m.kf_uv[nb][slot_n]) ** 2, axis=-1)
        good = (
            ok & ~has_pt
            & (z1 > 0.05) & (z2 > 0.05)
            & (cosp < 0.9998)  # enough parallax (~1 deg)
            & (err_c < CHI2_MONO) & (err_n < CHI2_MONO)
        )
        p_world_i = lie.se3_apply(lie.se3_inverse(T_c), p_c)
        p_world_acc = jnp.where(good[:, None], p_world_i, p_world_acc)
        has_pt = has_pt | good
        takes.append(good)
        slots.append(slot_n)

    allocatable = ~m.pt_valid & (m.n_kf - m.pt_freed_seq >= 3)
    (free_ids,) = jnp.nonzero(allocatable, size=F, fill_value=-1)
    order = jnp.cumsum(has_pt.astype(jnp.int32)) - 1
    new_ids = jnp.where(has_pt, free_ids[jnp.minimum(order, F - 1)], -1)
    alloc = new_ids >= 0
    safe = jnp.maximum(new_ids, 0)

    obs = m.kf_obs_pt.at[kf_id].set(
        jnp.where(alloc, new_ids, m.kf_obs_pt[kf_id])
    )
    for i in range(n_neighbours):
        take_i = takes[i] & alloc
        obs = obs.at[top_nb[i], slots[i]].set(
            jnp.where(take_i, new_ids, obs[top_nb[i], slots[i]]),
            mode="drop",
        )

    return m._replace(
        pt_pos=m.pt_pos.at[safe].set(
            jnp.where(alloc[:, None], p_world_acc, m.pt_pos[safe])
        ),
        pt_valid=m.pt_valid.at[safe].set(alloc | m.pt_valid[safe]),
        pt_desc=m.pt_desc.at[safe].set(
            jnp.where(alloc[:, None], m.kf_desc[kf_id], m.pt_desc[safe])
        ),
        pt_first_kf=m.pt_first_kf.at[safe].set(
            jnp.where(alloc, kf_id, m.pt_first_kf[safe])
        ),
        pt_first_seq=m.pt_first_seq.at[safe].set(
            jnp.where(alloc, m.kf_seq[kf_id], m.pt_first_seq[safe])
        ),
        pt_visible=m.pt_visible.at[safe].set(
            jnp.where(alloc, 1, m.pt_visible[safe])
        ),
        pt_found=m.pt_found.at[safe].set(
            jnp.where(alloc, 1, m.pt_found[safe])
        ),
        kf_obs_pt=obs,
        n_pt=m.n_pt + jnp.sum(alloc.astype(jnp.int32)),
    )


# ---------------------------------------------------------------------------
# local bundle adjustment
# ---------------------------------------------------------------------------


class LbaStats(NamedTuple):
    cost0: jax.Array
    cost1: jax.Array
    n_obs: jax.Array
    n_local_kf: jax.Array


CHI2_STEREO = 7.815


@functools.partial(jax.jit, static_argnames=("n_window", "n_local_pts",
                                             "iters"))
def local_ba(
    m: MapState,
    kf_id: jax.Array,
    cam_K: jax.Array,
    cam_bf: jax.Array = None,
    n_window: int = 10,
    n_local_pts: int = 8192,
    iters: int = 10,
) -> tuple[MapState, LbaStats]:
    """Windowed BA over the covisibility neighbourhood of ``kf_id``
    (Optimizer::LocalBundleAdjustment, Optimizer.cc:1454): top covisible
    keyframes + the points they see; the oldest local keyframe (and any
    keyframe 0) is held fixed as gauge anchor.

    Keypoints with valid depth get stereo (u, v, u_r) factors with
    ``u_r = u - bf/z`` — the reference's RGB-D treatment, which anchors the
    map scale inside the window; depthless keypoints get mono factors.
    """
    counts = covisibility_counts(m, kf_id)
    top_counts, top_kfs = jax.lax.top_k(counts, n_window)
    kf_ids = jnp.concatenate([kf_id[None], top_kfs])  # (L,)
    kf_mask = jnp.concatenate([jnp.ones((1,), bool), top_counts > 0])
    kf_mask = kf_mask & m.kf_valid[kf_ids]
    L = kf_ids.shape[0]

    # local point set: everything observed by the local keyframes
    obs = m.kf_obs_pt[kf_ids]  # (L, F)
    obs_ok = m.kf_kp_valid[kf_ids] & kf_mask[:, None] & (obs >= 0)
    obs_safe = jnp.maximum(obs, 0)
    obs_ok = obs_ok & m.pt_valid[obs_safe]
    member = jnp.zeros((m.N + 1,), bool).at[
        jnp.where(obs_ok, obs, -1).reshape(-1) + 1
    ].set(True).at[0].set(False)
    (local_pt,) = jnp.nonzero(member[1:], size=n_local_pts, fill_value=-1)
    pt_ok = local_pt >= 0
    safe_pt = jnp.maximum(local_pt, 0)
    inv = jnp.full((m.N + 1,), -1, jnp.int32).at[safe_pt + 1].set(
        jnp.where(pt_ok, jnp.arange(n_local_pts, dtype=jnp.int32), -1)
    )
    # observations -> compact indices
    pt_local_idx = inv[obs_safe + 1]  # (L, F)
    use = obs_ok & (pt_local_idx >= 0)

    kf_rows = jnp.broadcast_to(jnp.arange(L)[:, None], obs.shape)
    var_idx = jnp.stack(
        [kf_rows.reshape(-1), jnp.maximum(pt_local_idx, 0).reshape(-1)],
        axis=1,
    ).astype(jnp.int32)
    uv = m.kf_uv[kf_ids].reshape(-1, 2)
    depth = m.kf_depth[kf_ids].reshape(-1)
    mtot = var_idx.shape[0]
    use_flat = use.reshape(-1)
    has_depth = depth > 0
    batches = [
        FactorBatch(
            families=("kf", "pt"),
            residual_fn=factors.reproj_mono,
            res_dim=2,
            var_idx=var_idx,
            const={"uv": uv, "cam": jnp.broadcast_to(cam_K, (mtot, 4))},
            info=jnp.ones((mtot,), jnp.float32),
            valid=use_flat & ~has_depth,
            huber=float(np.sqrt(CHI2_MONO)),
            chi2_gate=CHI2_MONO * 2,
        )
    ]
    if cam_bf is not None:
        z = jnp.maximum(depth, 1e-3)
        uv_ur = jnp.concatenate(
            [uv, (uv[:, :1] - cam_bf / z[:, None])], axis=1
        )
        batches.append(
            FactorBatch(
                families=("kf", "pt"),
                residual_fn=factors.reproj_stereo,
                res_dim=3,
                var_idx=var_idx,
                const={
                    "uv_ur": uv_ur,
                    "cam": jnp.broadcast_to(cam_K, (mtot, 4)),
                    "bf": jnp.broadcast_to(cam_bf, (mtot,)),
                },
                info=jnp.ones((mtot,), jnp.float32),
                valid=use_flat & has_depth,
                huber=float(np.sqrt(CHI2_STEREO)),
                chi2_gate=CHI2_STEREO * 2,
            )
        )
    else:
        import dataclasses as _dc

        batches[0] = _dc.replace(batches[0], valid=use_flat)

    # gauge: fix the oldest valid local KF (lowest id), plus invalid slots
    min_id = jnp.min(jnp.where(kf_mask, kf_ids, m.K))
    kf_fixed = (~kf_mask) | (kf_ids == min_id) | (kf_ids == 0)
    if cam_bf is None:
        # monocular: depth factors don't anchor scale, so one fixed pose
        # leaves the scale gauge free and the map shrinks/grows per solve —
        # fix the two oldest local KFs (their baseline pins the scale), the
        # role the reference's fixed out-of-window KFs play
        # (Optimizer.cc:1741-1757)
        min2_id = jnp.min(jnp.where(kf_mask & (kf_ids != min_id), kf_ids,
                                    m.K))
        kf_fixed = kf_fixed | (kf_ids == min2_id)
    problem = GraphProblem(
        families={
            "kf": se3_family(m.kf_pose[kf_ids], kf_fixed),
            "pt": point_family(m.pt_pos[safe_pt], ~pt_ok),
        },
        factors=batches,
        eliminated="pt",
    )
    res = optimize(problem, iters=iters)

    # write back (only non-fixed entries changed; duplicates in kf_ids are
    # impossible: top_k returns distinct slots and kf_id scored 0 for itself)
    new_kf_pose = m.kf_pose.at[kf_ids].set(
        jnp.where(kf_mask[:, None], res.values["kf"], m.kf_pose[kf_ids])
    )
    new_pt_pos = m.pt_pos.at[safe_pt].set(
        jnp.where(pt_ok[:, None], res.values["pt"], m.pt_pos[safe_pt])
    )
    stats = LbaStats(
        cost0=res.initial_cost,
        cost1=res.cost,
        n_obs=jnp.sum(use),
        n_local_kf=jnp.sum(kf_mask),
    )
    return m._replace(kf_pose=new_kf_pose, pt_pos=new_pt_pos), stats


@functools.partial(jax.jit, static_argnames=("n_local", "radius"))
def fuse_observations(m: MapState, kf_id: jax.Array, cam_K: jax.Array,
                      n_local: int = 4096, radius: float = 4.0) -> MapState:
    """Link map points seen by covisible keyframes to this keyframe's still
    unassociated keypoints (the observation-completing half of
    LocalMapping::SearchInNeighbors, LocalMapping.cc:712 — projection +
    descriptor check; duplicate-point *replacement* happens in the loop
    closer's fuse).  One projection + window match, then a masked scatter."""
    from visual_sgraphs.features.match import match_window
    from visual_sgraphs.slam.map_state import observed_mask

    counts = covisibility_counts(m, kf_id)
    _, top_kfs = jax.lax.top_k(counts, 8)
    kf_mask = counts[top_kfs] > 0
    pmask = observed_mask(m, top_kfs, kf_mask) & m.pt_valid
    (ids,) = jnp.nonzero(pmask, size=n_local, fill_value=-1)
    lvalid = ids >= 0
    safe = jnp.maximum(ids, 0)
    xw = m.pt_pos[safe]
    p_cam = lie.se3_apply(m.kf_pose[kf_id], xw)
    uv_pred = cameras.project_pinhole(cam_K, p_cam)
    vis = (p_cam[:, 2] > 0.05) & lvalid
    # only match into keypoints that have no point yet
    free = m.kf_kp_valid[kf_id] & (m.kf_obs_pt[kf_id] < 0)
    match, _ = match_window(
        m.pt_desc[safe], uv_pred, vis,
        m.kf_desc[kf_id], m.kf_uv[kf_id], free,
        radius=radius,
    )
    ok = match >= 0
    slot = jnp.where(ok, match, m.F - 1)
    new_obs = m.kf_obs_pt[kf_id].at[slot].max(
        jnp.where(ok, ids, -1).astype(jnp.int32), mode="drop"
    )
    return m._replace(kf_obs_pt=m.kf_obs_pt.at[kf_id].set(new_obs))


@functools.partial(jax.jit, static_argnames=("iters",))
def global_ba(
    m: MapState,
    cam_K: jax.Array,
    cam_bf: jax.Array = None,
    iters: int = 10,
) -> tuple[MapState, LbaStats]:
    """Full-map bundle adjustment over every keyframe and point
    (Optimizer::GlobalBundleAdjustemnt, Optimizer.cc:45-641 — run after loop
    closure, LoopClosing::RunGlobalBundleAdjustment :2141).  Keyframe 0 is
    the gauge anchor.  One dense problem: all K x F observations in a single
    factor batch, points Schur-eliminated."""
    K, F = m.K, m.F
    obs = m.kf_obs_pt  # (K, F)
    obs_ok = m.kf_kp_valid & m.kf_valid[:, None] & (obs >= 0)
    obs_safe = jnp.maximum(obs, 0)
    obs_ok = obs_ok & m.pt_valid[obs_safe]

    kf_rows = jnp.broadcast_to(jnp.arange(K)[:, None], obs.shape)
    var_idx = jnp.stack(
        [kf_rows.reshape(-1), obs_safe.reshape(-1)], axis=1
    ).astype(jnp.int32)
    uv = m.kf_uv.reshape(-1, 2)
    depth = m.kf_depth.reshape(-1)
    mtot = var_idx.shape[0]
    use_flat = obs_ok.reshape(-1)
    has_depth = depth > 0
    batches = [
        FactorBatch(
            families=("kf", "pt"),
            residual_fn=factors.reproj_mono,
            res_dim=2,
            var_idx=var_idx,
            const={"uv": uv, "cam": jnp.broadcast_to(cam_K, (mtot, 4))},
            info=jnp.ones((mtot,), jnp.float32),
            valid=use_flat & ~has_depth if cam_bf is not None else use_flat,
            huber=float(np.sqrt(CHI2_MONO)),
            chi2_gate=CHI2_MONO * 2,
        )
    ]
    if cam_bf is not None:
        z = jnp.maximum(depth, 1e-3)
        uv_ur = jnp.concatenate([uv, (uv[:, :1] - cam_bf / z[:, None])],
                                axis=1)
        batches.append(
            FactorBatch(
                families=("kf", "pt"),
                residual_fn=factors.reproj_stereo,
                res_dim=3,
                var_idx=var_idx,
                const={
                    "uv_ur": uv_ur,
                    "cam": jnp.broadcast_to(cam_K, (mtot, 4)),
                    "bf": jnp.broadcast_to(cam_bf, (mtot,)),
                },
                info=jnp.ones((mtot,), jnp.float32),
                valid=use_flat & has_depth,
                huber=float(np.sqrt(CHI2_STEREO)),
                chi2_gate=CHI2_STEREO * 2,
            )
        )
    kf_fixed = (~m.kf_valid) | (jnp.arange(K) == 0)
    problem = GraphProblem(
        families={
            "kf": se3_family(m.kf_pose, kf_fixed),
            "pt": point_family(m.pt_pos, ~m.pt_valid),
        },
        factors=batches,
        eliminated="pt",
    )
    res = optimize(problem, iters=iters)
    stats = LbaStats(
        cost0=res.initial_cost,
        cost1=res.cost,
        n_obs=jnp.sum(obs_ok),
        n_local_kf=jnp.sum(m.kf_valid),
    )
    return m._replace(
        kf_pose=jnp.where(kf_fixed[:, None], m.kf_pose, res.values["kf"]),
        pt_pos=jnp.where(m.pt_valid[:, None], res.values["pt"], m.pt_pos),
    ), stats


# ---------------------------------------------------------------------------
# culling
# ---------------------------------------------------------------------------


@jax.jit
def cull_keyframes(m: MapState, kf_id: jax.Array,
                   redundancy: float = 0.9
                   ) -> tuple[MapState, jax.Array]:
    """Drop local keyframes ≥90% of whose points are seen by ≥3 other
    keyframes (KeyFrameCulling, LocalMapping.cc:898).  Checks the covisible
    neighbours of ``kf_id``; keyframe 0 and the newest keyframe survive.
    The dropped keyframe retires through the ledger (slot becomes
    reusable); returns (map, dropped_slot or -1).

    One batched pass: per-point observation counts once, then per-candidate
    redundancy ratios as a masked gather — no per-KF loop.
    """
    nobs = point_obs_count(m)  # (N,)
    counts = covisibility_counts(m, kf_id)
    candidate = (counts > 0) & m.kf_valid
    candidate = candidate.at[0].set(False).at[kf_id].set(False)

    obs = m.kf_obs_pt  # (K, F)
    ok = m.kf_kp_valid & (obs >= 0)
    safe = jnp.maximum(obs, 0)
    ok = ok & m.pt_valid[safe]
    redundant_obs = ok & (nobs[safe] >= 4)  # seen by >=3 others + this one
    n_obs_kf = jnp.sum(ok, axis=1)
    n_red = jnp.sum(redundant_obs, axis=1)
    ratio = n_red / jnp.maximum(n_obs_kf, 1)
    drop = candidate & (ratio > redundancy) & (n_obs_kf > 0)
    # never drop more than one keyframe per pass (the reference culls inside
    # a loop with fresh counts each time; one-at-a-time keeps counts honest)
    first_drop = jnp.argmax(drop)
    do = jnp.any(drop)
    m = retire_keyframe(m, first_drop, do)
    return m, jnp.where(do, first_drop, -1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("min_obs", "min_found_ratio"))
def cull_points(m: MapState, min_obs: int = 2,
                min_found_ratio: float = 0.25) -> MapState:
    """Drop points observed by fewer than ``min_obs`` keyframes once they
    are old enough, or *recently created* points whose found/visible ratio
    collapsed (MapPointCulling, LocalMapping.cc:341 — GetFoundRatio < 0.25
    is tested only while the point sits in mlpRecentAddedMapPoints, i.e.
    its first ~3 keyframes; older points are no longer candidates).  The
    ratio test additionally arms only after a few visibility chances so a
    fresh point isn't judged on one frame."""
    nobs = point_obs_count(m)
    age = m.n_kf - m.pt_first_seq  # keyframes since creation (seq-based)
    ratio = m.pt_found.astype(jnp.float32) / jnp.maximum(
        m.pt_visible.astype(jnp.float32), 1.0
    )
    low_ratio = (
        (age <= 3) & (m.pt_visible >= 8) & (ratio < min_found_ratio)
    )
    bad = m.pt_valid & (((age >= 3) & (nobs < min_obs)) | low_ratio)
    pt_valid = m.pt_valid & ~bad
    # unlink culled points from keyframes
    obs = m.kf_obs_pt
    linked_bad = (obs >= 0) & bad[jnp.maximum(obs, 0)]
    return m._replace(
        pt_valid=pt_valid,
        pt_freed_seq=jnp.where(bad, m.n_kf, m.pt_freed_seq),
        kf_obs_pt=jnp.where(linked_bad, -1, obs),
    )

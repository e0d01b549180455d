"""Analytic windowed bundle adjustment — the hot-path LBA engine.

The generic LM engine (optim/solve.py) linearizes through autodiff and
scatters a dense (3N, 6K) coupling; fine for correctness, but it
evaluates residuals several times per iteration.  This module is the
fast path for the per-keyframe solve
(Optimizer::LocalBundleAdjustment, Optimizer.cc:1454): it reuses the
landmark-grouped analytic reduction of parallel/dist_ba.py (per-landmark
Schur blocks, no dense coupling, hand-written reprojection Jacobians) and
embeds it in a dense reduced system that can also carry the vS-Graphs
plane/room/door blocks (linearized generically — they are few).

Layout of the reduced tangent vector:
    [ kf (L, 6) | plane (P, 3) | room (R, 3) | door (D, 6) ]
Landmarks are eliminated per landmark; the scene-graph families are dense
rows appended to the same solve, so planes still steer keyframe poses
jointly (Optimizer.cc:2049-2260 semantics) at a fraction of the generic
engine's cost.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.core import lie
from visual_sgraphs.optim.graph import (
    FactorBatch,
    GraphProblem,
    linearize_batch,
    plane_family,
    point_family,
    se3_family,
)
from visual_sgraphs.parallel.dist_ba import (
    _back_substitute,
    _local_reduced_system,
    group_observations,
)


def _assemble_dense(problem: GraphProblem, values):
    """Dense H, g over the problem's (non-eliminated) families — the
    generic assembly of optim/solve.py without an eliminated family."""
    fams = {
        k: dataclasses.replace(problem.families[k], values=values[k])
        for k in problem.families
    }
    D = problem.reduced_dim()
    dtype = next(iter(values.values())).dtype
    H = jnp.zeros((D, D), dtype)
    g = jnp.zeros((D,), dtype)
    offs = problem.offsets()

    def cols(name, idx):
        fam = problem.families[name]
        t = fam.tangent_dim
        return offs[name] + idx[:, None] * t + jnp.arange(t)[None, :]

    for batch in problem.factors:
        r, jacs, w = linearize_batch(batch, fams)
        names = batch.families
        for i, ni in enumerate(names):
            Ji = jacs[i]
            ci = cols(ni, batch.var_idx[:, i])
            g = g.at[ci].add(jnp.einsum("mri,mr->mi", Ji, r) * w[:, None])
            for j, nj in enumerate(names):
                if j < i:
                    continue
                Jj = jacs[j]
                cj = cols(nj, batch.var_idx[:, j])
                block = jnp.einsum("mri,mrj->mij", Ji, Jj) * w[:, None, None]
                H = H.at[ci[:, :, None], cj[:, None, :]].add(block)
                if i != j:
                    H = H.at[cj[:, :, None], ci[:, None, :]].add(
                        jnp.swapaxes(block, -1, -2)
                    )
    return H, g


@functools.partial(
    jax.jit,
    static_argnames=("n_window", "n_local_pts", "max_obs", "iters"),
)
def fast_local_ba(
    m,
    kf_id: jax.Array,
    cam_K: jax.Array,
    cam_bf: jax.Array = None,
    n_window: int = 10,
    n_local_pts: int = 8192,
    max_obs: int = 12,
    iters: int = 10,
    lam: float = 1e-4,
):
    """Analytic windowed BA (reprojection only).  Drop-in for
    mapping.local_ba with the same window/gauge policy; returns
    (map, final_cost)."""
    from visual_sgraphs.slam.map_state import covisibility_counts

    counts = covisibility_counts(m, kf_id)
    top_counts, top_kfs = jax.lax.top_k(counts, n_window)
    kf_ids = jnp.concatenate([kf_id[None], top_kfs])
    kf_mask = jnp.concatenate([jnp.ones((1,), bool), top_counts > 0])
    kf_mask = kf_mask & m.kf_valid[kf_ids]
    L = kf_ids.shape[0]

    obs = m.kf_obs_pt[kf_ids]
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
    pt_local_idx = inv[obs_safe + 1]
    use = obs_ok & (pt_local_idx >= 0)

    kf_rows = jnp.broadcast_to(
        jnp.arange(L, dtype=jnp.int32)[:, None], obs.shape
    )
    uv = m.kf_uv[kf_ids].reshape(-1, 2)
    depth = m.kf_depth[kf_ids].reshape(-1)
    if cam_bf is None:
        bf = jnp.asarray(0.0, jnp.float32)
        ur = jnp.full_like(depth, -1.0)
    else:
        bf = cam_bf
        ur = jnp.where(
            depth > 0, uv[:, 0] - bf / jnp.maximum(depth, 1e-3), -1.0
        )
    uvr = jnp.concatenate([uv, ur[:, None]], axis=1)
    kf_tab, uvr_tab, val_tab, _ = group_observations(
        kf_rows.reshape(-1), pt_local_idx.reshape(-1), uvr,
        use.reshape(-1), n_local_pts, max_obs,
    )

    min_id = jnp.min(jnp.where(kf_mask, kf_ids, m.K))
    kf_fixed = (~kf_mask) | (kf_ids == min_id) | (kf_ids == 0)
    if cam_bf is None:
        min2_id = jnp.min(
            jnp.where(kf_mask & (kf_ids != min_id), kf_ids, m.K)
        )
        kf_fixed = kf_fixed | (kf_ids == min2_id)

    poses0 = m.kf_pose[kf_ids]
    pts0 = m.pt_pos[safe_pt]
    lam_a = jnp.asarray(lam, jnp.float32)

    def one_iter(carry, _):
        poses, pts = carry
        S, rhs, Lc, c, C, cost = _local_reduced_system(
            poses, pts, kf_tab, uvr_tab, val_tab, cam_K, bf, lam_a, 2.45,
        )
        diag = jnp.clip(jnp.diagonal(S), 1e-6, None)
        S = S + jnp.diag(lam_a * diag + 1e-5)
        free = jnp.repeat(~kf_fixed, 6).astype(S.dtype)
        S = S * free[:, None] * free[None, :] + jnp.diag(1.0 - free)
        rhs = rhs * free
        cf = jax.scipy.linalg.cho_factor(S, lower=True)
        dxr = jax.scipy.linalg.cho_solve(cf, rhs)
        dxr = jnp.where(jnp.isfinite(dxr), dxr, 0.0) * free
        dxr6 = dxr.reshape(L, 6)
        new_poses = jax.vmap(
            lambda T, d: lie.se3_normalize(lie.se3_boxplus(T, d))
        )(poses, jnp.where(kf_fixed[:, None], 0.0, dxr6))
        dxe = _back_substitute(Lc, c, C, kf_tab, val_tab, dxr6)
        new_pts = pts + jnp.where(pt_ok[:, None], dxe, 0.0)
        return (new_poses, new_pts), cost

    (poses, pts), costs = jax.lax.scan(
        one_iter, (poses0, pts0), None, length=iters
    )
    new_kf_pose = m.kf_pose.at[kf_ids].set(
        jnp.where((kf_mask & ~kf_fixed)[:, None], poses, m.kf_pose[kf_ids])
    )
    new_pt_pos = m.pt_pos.at[safe_pt].set(
        jnp.where(pt_ok[:, None], pts, m.pt_pos[safe_pt])
    )
    return m._replace(kf_pose=new_kf_pose, pt_pos=new_pt_pos), costs[-1]


@functools.partial(
    jax.jit,
    static_argnames=("n_window", "n_local_pts", "max_obs", "iters",
                     "config"),
)
def fast_scenegraph_ba(
    m,
    sg,
    kf_id: jax.Array,
    cam_K: jax.Array,
    cam_bf: jax.Array,
    n_window: int = 10,
    n_local_pts: int = 8192,
    max_obs: int = 12,
    iters: int = 8,
    lam: float = 1e-4,
    config=None,
):
    """Analytic LBA with the scene-graph families in the same reduced
    solve: landmark reprojection terms reduce per landmark (analytic);
    plane-KF, Gij-quadric, room and door factor blocks are linearized
    generically (they are ≤ ~1k items) and added as dense rows.  Joint —
    planes still pull keyframe poses — at ~3x the plain analytic LBA cost
    instead of ~10x the generic engine's.

    Returns (map, scenegraph, final_cost)."""
    from visual_sgraphs.config import SceneGraphConfig
    from visual_sgraphs.optim import factors as factors_mod
    from visual_sgraphs.slam.map_state import covisibility_counts

    if config is None:
        config = SceneGraphConfig()

    counts = covisibility_counts(m, kf_id).astype(jnp.float32)
    if config.plane_covis_enabled:
        # plane-based covisibility weighting: shared planes boost the
        # pair weight before the window is picked (KeyFrame.cc:486-523)
        from visual_sgraphs.scenegraph.manager import plane_covis_bonus

        counts = counts + plane_covis_bonus(
            sg, kf_id, m.K, min_votes=config.plane_min_votes,
            score=config.plane_covis_score,
            undefined_factor=config.plane_covis_undefined_factor,
        ) * jnp.where(m.kf_valid, 1.0, 0.0)
    top_counts, top_kfs = jax.lax.top_k(counts, n_window)
    kf_ids = jnp.concatenate([kf_id[None], top_kfs])
    kf_mask = jnp.concatenate([jnp.ones((1,), bool), top_counts > 0])
    kf_mask = kf_mask & m.kf_valid[kf_ids]
    L = kf_ids.shape[0]

    obs = m.kf_obs_pt[kf_ids]
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
    pt_local_idx = inv[obs_safe + 1]
    use = obs_ok & (pt_local_idx >= 0)

    kf_rows = jnp.broadcast_to(
        jnp.arange(L, dtype=jnp.int32)[:, None], obs.shape
    )
    uv = m.kf_uv[kf_ids].reshape(-1, 2)
    depth = m.kf_depth[kf_ids].reshape(-1)
    ur = jnp.where(
        depth > 0, uv[:, 0] - cam_bf / jnp.maximum(depth, 1e-3), -1.0
    )
    uvr = jnp.concatenate([uv, ur[:, None]], axis=1)
    kf_tab, uvr_tab, val_tab, _ = group_observations(
        kf_rows.reshape(-1), pt_local_idx.reshape(-1), uvr,
        use.reshape(-1), n_local_pts, max_obs,
    )

    min_id = jnp.min(jnp.where(kf_mask, kf_ids, m.K))
    kf_fixed = (~kf_mask) | (kf_ids == min_id) | (kf_ids == 0)

    # ---- scene-graph factor batches (small; generic linearization)
    kf_inv = jnp.full((m.K,), -1, jnp.int32).at[kf_ids].set(
        jnp.where(kf_mask, jnp.arange(L, dtype=jnp.int32), -1)
    )
    ob_local_kf = kf_inv[jnp.clip(sg.ob_kf, 0, m.K - 1)]
    ob_use = sg.ob_valid & (sg.ob_plane >= 0) & (ob_local_kf >= 0)
    plane_var_idx = jnp.stack(
        [jnp.maximum(ob_local_kf, 0), jnp.maximum(sg.ob_plane, 0)], axis=1
    ).astype(jnp.int32)
    sg_batches = []
    if config.plane_kf_factor:
        sg_batches.append(FactorBatch(
            families=("kf", "plane"),
            residual_fn=factors_mod.plane_kf,
            res_dim=3,
            var_idx=plane_var_idx,
            const={"pi_obs": sg.ob_coeffs},
            info=jnp.maximum(sg.ob_conf, 0.1),
            valid=ob_use,
            huber=2.79,
        ))
    if config.plane_point_factor:
        sg_batches.append(FactorBatch(
            families=("kf", "plane"),
            residual_fn=factors_mod.plane_quadric,
            res_dim=1,
            var_idx=plane_var_idx,
            const={"G": sg.ob_quadric},
            info=jnp.full(
                (sg.ob_kf.shape[0],), config.plane_point_info, jnp.float32
            ),
            valid=ob_use & (jnp.einsum("qii->q", sg.ob_quadric) > 1e-6),
            huber=1.96,
        ))
    plane_seen = jnp.zeros((sg.P,), bool).at[
        jnp.where(ob_use, sg.ob_plane, sg.P - 1)
    ].set(ob_use, mode="drop")
    plane_fixed = ~(plane_seen & sg.pl_valid)

    R = sg.room_valid.shape[0]
    rw = jnp.clip(sg.room_walls, 0, sg.P - 1)
    walls_ok = sg.room_walls >= 0
    is4 = sg.room_valid & jnp.all(walls_ok, axis=1)
    is2 = sg.room_valid & walls_ok[:, 0] & walls_ok[:, 1] & ~is4
    room_idx = jnp.arange(R, dtype=jnp.int32)
    if config.room_factor:
        sg_batches.append(FactorBatch(
            families=("room", "plane", "plane", "plane", "plane"),
            residual_fn=factors_mod.room_4wall,
            res_dim=3,
            var_idx=jnp.concatenate([room_idx[:, None], rw], axis=1),
            const={},
            info=jnp.full((R,), config.room_info, jnp.float32),
            valid=is4, huber=1.0,
        ))
        sg_batches.append(FactorBatch(
            families=("room", "plane", "plane"),
            residual_fn=factors_mod.room_2wall,
            res_dim=3,
            var_idx=jnp.concatenate([room_idx[:, None], rw[:, :2]], axis=1),
            const={},
            info=jnp.full((R,), config.room_info, jnp.float32),
            valid=is2, huber=1.0,
        ))
    room_fixed = ~(sg.room_valid & (is2 | is4))

    Dn = sg.door_valid.shape[0]
    door_fixed = ~sg.door_valid
    if config.door_factor:
        ddist = jnp.linalg.norm(
            sg.door_pose[:, None, 4:7] - sg.room_center[None, :, :], axis=-1
        )
        ddist = jnp.where(sg.room_valid[None, :], ddist, jnp.inf)
        door_room_idx = jnp.argmin(ddist, axis=1).astype(jnp.int32)
        has_room = jnp.isfinite(jnp.min(ddist, axis=1))
        rel = sg.door_pose[:, 4:7] - sg.room_center[door_room_idx]
        sg_batches.append(FactorBatch(
            families=("door", "room"),
            residual_fn=factors_mod.door_room,
            res_dim=3,
            var_idx=jnp.stack(
                [jnp.arange(Dn, dtype=jnp.int32), door_room_idx], axis=1
            ),
            const={"rel": rel},
            info=jnp.ones((Dn,), jnp.float32),
            valid=sg.door_valid & has_room, huber=1.0,
        ))

    lam_a = jnp.asarray(lam, jnp.float32)
    poses0 = m.kf_pose[kf_ids]
    pts0 = m.pt_pos[safe_pt]

    def one_iter(carry, _):
        poses, pts, planes, rooms, doors = carry
        # landmark part: analytic per-landmark Schur reduction over kf rows
        S_kf, rhs_kf, Lc, c, C, cost = _local_reduced_system(
            poses, pts, kf_tab, uvr_tab, val_tab, cam_K, cam_bf, lam_a, 2.45,
        )
        # scene-graph part: generic dense assembly over the full layout
        problem = GraphProblem(
            families={
                "kf": se3_family(poses, kf_fixed),
                "plane": plane_family(planes, plane_fixed),
                "room": point_family(rooms, room_fixed),
                "door": se3_family(doors, door_fixed),
            },
            factors=sg_batches,
        )
        values = {"kf": poses, "plane": planes, "room": rooms,
                  "door": doors}
        H_sg, g_sg = _assemble_dense(problem, values)
        D = H_sg.shape[0]
        kf_dim = L * 6
        S = H_sg.at[:kf_dim, :kf_dim].add(S_kf)
        # rhs = [rhs_kf − g_sg_kf | −g_sg_rest]
        rhs = (-g_sg).at[:kf_dim].add(rhs_kf)
        diag = jnp.clip(jnp.diagonal(S), 1e-6, None)
        S = S + jnp.diag(lam_a * diag + 1e-5)
        free = jnp.concatenate([
            jnp.repeat(~kf_fixed, 6),
            jnp.repeat(~plane_fixed, 3),
            jnp.repeat(~room_fixed, 3),
            jnp.repeat(~door_fixed, 6),
        ]).astype(S.dtype)
        S = S * free[:, None] * free[None, :] + jnp.diag(1.0 - free)
        rhs = rhs * free
        cf = jax.scipy.linalg.cho_factor(S, lower=True)
        dx = jax.scipy.linalg.cho_solve(cf, rhs)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0) * free
        dkf = dx[:kf_dim].reshape(L, 6)
        off = kf_dim
        dpl = dx[off:off + sg.P * 3].reshape(sg.P, 3)
        off += sg.P * 3
        drm = dx[off:off + R * 3].reshape(R, 3)
        off += R * 3
        ddr = dx[off:off + Dn * 6].reshape(Dn, 6)
        new_poses = jax.vmap(
            lambda T, d: lie.se3_normalize(lie.se3_boxplus(T, d))
        )(poses, jnp.where(kf_fixed[:, None], 0.0, dkf))
        from visual_sgraphs.core import plane as plane_mod

        new_planes = jax.vmap(plane_mod.oplus)(
            planes, jnp.where(plane_fixed[:, None], 0.0, dpl)
        )
        new_rooms = rooms + jnp.where(room_fixed[:, None], 0.0, drm)
        new_doors = jax.vmap(
            lambda T, d: lie.se3_normalize(lie.se3_boxplus(T, d))
        )(doors, jnp.where(door_fixed[:, None], 0.0, ddr))
        dxe = _back_substitute(Lc, c, C, kf_tab, val_tab, dkf)
        new_pts = pts + jnp.where(pt_ok[:, None], dxe, 0.0)
        return (new_poses, new_pts, new_planes, new_rooms, new_doors), cost

    (poses, pts, planes, rooms, doors), costs = jax.lax.scan(
        one_iter, (poses0, pts0, sg.pl_coeffs, sg.room_center, sg.door_pose),
        None, length=iters,
    )
    new_kf_pose = m.kf_pose.at[kf_ids].set(
        jnp.where((kf_mask & ~kf_fixed)[:, None], poses, m.kf_pose[kf_ids])
    )
    new_pt_pos = m.pt_pos.at[safe_pt].set(
        jnp.where(pt_ok[:, None], pts, m.pt_pos[safe_pt])
    )
    nrm = jnp.linalg.norm(planes[:, :3], axis=-1, keepdims=True)
    planes = planes / jnp.maximum(nrm, 1e-9)
    return (
        m._replace(kf_pose=new_kf_pose, pt_pos=new_pt_pos),
        sg._replace(
            pl_coeffs=jnp.where(plane_fixed[:, None], sg.pl_coeffs, planes),
            room_center=jnp.where(room_fixed[:, None], sg.room_center,
                                  rooms),
            door_pose=jnp.where(door_fixed[:, None], sg.door_pose, doors),
        ),
        costs[-1],
    )

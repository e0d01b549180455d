"""Free-space room segmentation: the reference's primary room-detection
path, on the device.

The reference consumes voxblox skeleton *free-space clusters* from an
external process and, per cluster, gathers the walls within a distance of
the cluster's points and runs the facing-pair analysis among THOSE walls
(SemanticsManager::detectMapRoomCandidateVoxblox, SemanticsManager.cc:
302-403; cluster store Atlas.h:138).  Wall-pairing alone — the reference's
*deprecated* method (SemanticsManager.cc:206-300) — mispairs walls of
different rooms the moment two rooms share orientations.

Here the external voxblox process is replaced by a batched in-framework
equivalent (SURVEY §7.3's planned ESDF replacement):

1. ``accumulate_freespace``: mark voxels of a fixed (G, G, G) grid as
   free by sampling along each depth ray at interior fractions — one
   scatter per keyframe, no ray marching loop.
2. ``freespace_cluster_centers``: 6-connected components by iterative
   min-label propagation (pure ``lax`` ops), then the C largest
   components' centroids.
3. ``detect_rooms_freespace``: per cluster, restrict the wall set to
   walls near the cluster center and run the facing-pair / perpendicular-
   pair analysis of ``manager.detect_rooms`` on that subset, upserting
   room/corridor candidates into the scene graph.

The grid is a transient manager-side buffer (the reference's skeleton
cluster store is likewise not serialized), so checkpoints are unaffected.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from visual_sgraphs.core import lie
from visual_sgraphs.scenegraph.state import SceneGraphState


@functools.partial(jax.jit, static_argnames=("G", "stride"))
def accumulate_freespace(grid, origin, voxel, depth_img, T_cw, cam_K,
                         G: int = 32, stride: int = 8):
    """Mark grid voxels crossed by the camera's viewing rays as free.

    ``grid``: (G, G, G) bool; ``origin``: (3,) world min corner;
    ``voxel``: () edge length.  Samples each ``stride``-subsampled pixel's
    ray at 5 interior fractions of its measured depth — a point BETWEEN
    the camera and a measured surface is observed free space."""
    h, w = depth_img.shape
    fx, fy, cx, cy = cam_K[0], cam_K[1], cam_K[2], cam_K[3]
    vs = jnp.arange(0, h, stride, dtype=jnp.float32)
    us = jnp.arange(0, w, stride, dtype=jnp.float32)
    z = depth_img[::stride, ::stride]  # (hs, ws)
    rays = jnp.stack([
        (us[None, :] - cx) / fx * jnp.ones_like(vs)[:, None],
        (vs[:, None] - cy) / fy * jnp.ones_like(us)[None, :],
        jnp.ones((vs.shape[0], us.shape[0]), jnp.float32),
    ], axis=-1)  # (hs, ws, 3) camera-frame unit-depth rays
    T_wc = lie.se3_inverse(T_cw)
    R = lie.quat_to_matrix(T_wc[:4])
    C = T_wc[4:7]
    fracs = jnp.asarray([0.2, 0.4, 0.55, 0.7, 0.85], jnp.float32)
    ok = z > 0.3
    p_cam = rays[None] * (z[None, :, :, None] * fracs[:, None, None, None])
    p_w = jnp.einsum("ij,fhwj->fhwi", R, p_cam) + C  # (5, hs, ws, 3)
    idx = jnp.floor((p_w - origin) / voxel).astype(jnp.int32)
    inb = jnp.all((idx >= 0) & (idx < G), axis=-1) & ok[None]
    idx = jnp.clip(idx, 0, G - 1)
    flat = (idx[..., 0] * G + idx[..., 1]) * G + idx[..., 2]
    g = grid.reshape(-1).at[jnp.where(inb, flat, 0)].max(inb)
    return g.reshape(G, G, G)


@functools.partial(jax.jit, static_argnames=("G", "n_clusters", "iters"))
def freespace_cluster_centers(grid, origin, voxel, G: int = 32,
                              n_clusters: int = 4, iters: int = 48):
    """(C, 3) world centroids of the C largest 6-connected free-space
    components + (C,) validity.  Label propagation: every free voxel
    starts with its flat index and repeatedly takes the min over its free
    6-neighbourhood — after ``iters`` sweeps labels are constant within a
    component (the voxblox skeleton's cluster ids, computed on the device)."""
    BIG = jnp.int32(G * G * G + 1)
    lab = jnp.where(
        grid, jnp.arange(G * G * G, dtype=jnp.int32).reshape(G, G, G), BIG
    )

    def sweep(lab, _):
        def sh(a, ax, d):
            return jnp.roll(a, d, axis=ax).at[
                (slice(None),) * ax + ((0 if d > 0 else -1),)
            ].set(BIG)
        m = lab
        for ax in range(3):
            for d in (1, -1):
                m = jnp.minimum(m, sh(lab, ax, d))
        return jnp.where(grid, jnp.minimum(lab, m), BIG), None

    lab, _ = jax.lax.scan(sweep, lab, None, length=iters)
    flat = lab.reshape(-1)
    occ = grid.reshape(-1)
    sizes = jnp.zeros((G * G * G + 2,), jnp.int32).at[
        jnp.where(occ, flat, G * G * G + 1)
    ].add(occ.astype(jnp.int32))
    sizes = sizes[:G * G * G]  # drop the BIG bucket
    top_sz, top_lab = jax.lax.top_k(sizes, n_clusters)
    ii, jj, kk = jnp.meshgrid(*([jnp.arange(G, dtype=jnp.float32)] * 3),
                              indexing="ij")
    coords = jnp.stack([ii, jj, kk], axis=-1).reshape(-1, 3)
    centers = []
    for c in range(n_clusters):
        msk = occ & (flat == top_lab[c])
        cnt = jnp.maximum(jnp.sum(msk), 1)
        ctr = jnp.sum(
            jnp.where(msk[:, None], coords, 0.0), axis=0
        ) / cnt
        centers.append((ctr + 0.5) * voxel + origin)
    valid = top_sz > 8  # ignore slivers
    return jnp.stack(centers), valid


def detect_rooms_freespace(sg: SceneGraphState, centers, centers_valid,
                           min_votes: float = 3.0,
                           wall_dist: float = 4.0,
                           min_gap: float = 0.8, max_gap: float = 12.0,
                           perp_tol: float = 0.2):
    """Room/corridor candidates seeded by free-space cluster centers:
    per cluster, only walls within ``wall_dist`` of the center compete in
    the facing-pair analysis (detectMapRoomCandidateVoxblox,
    SemanticsManager.cc:302-403 + Utils::getRoomCenter), so adjacent
    rooms with parallel walls cannot cross-pair."""
    from visual_sgraphs.scenegraph.manager import (
        GROUND,
        WALL,
        plane_semantics,
    )

    sem = plane_semantics(sg, min_votes)
    P = sg.P
    n = sg.pl_coeffs[:, :3]
    d = sg.pl_coeffs[:, 3]
    is_ground = sg.pl_valid & (sem == GROUND)
    is_wall_all = sg.pl_valid & (sem == WALL)
    pi, pj = jnp.nonzero(jnp.ones((P, P), bool), size=P * P)

    def per_cluster(sg, c_and_ok):
        center_c, ok_c = c_and_ok
        plane_d = jnp.abs(n @ center_c + d)
        lat_c = jnp.linalg.norm(sg.pl_centroid - center_c[None, :], axis=-1)
        near = (plane_d < wall_dist) & (lat_c < 2.0 * wall_dist)
        is_wall = is_wall_all & near & ok_c

        dot = n @ n.T
        cdiff = sg.pl_centroid[None, :, :] - sg.pl_centroid[:, None, :]
        gap = jnp.abs(jnp.einsum("pi,pqi->pq", n, cdiff))
        facing = (
            is_wall[:, None] & is_wall[None, :]
            & (dot < -0.9) & (gap > min_gap) & (gap < max_gap)
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
        score2 = jnp.where(fac_flat & perp, -jnp.linalg.norm(
            pair_center[pi, pj] - center_c[None, :], axis=-1
        ), -jnp.inf)
        b2 = jnp.argmax(score2)
        i2, j2 = pi[b2], pj[b2]
        have2 = jnp.isfinite(score2[b2])

        room_found = have1 & have2
        room_center = 0.5 * (pair_center[i1, j1] + pair_center[i2, j2])
        room_walls = jnp.stack([i1, j1, i2, j2]).astype(jnp.int32)
        corridor_found = have1 & ~have2
        corr_walls = jnp.stack(
            [i1, j1, jnp.asarray(-1), jnp.asarray(-1)]
        ).astype(jnp.int32)
        found = room_found | corridor_found
        center = jnp.where(room_found, room_center, pair_center[i1, j1])
        walls = jnp.where(room_found, room_walls, corr_walls)

        g_support = jnp.where(is_ground, sg.pl_npts, -1.0)
        g_lat = jnp.linalg.norm(sg.pl_centroid - center[None, :], axis=-1)
        g_ok = is_ground & (g_lat < max_gap)
        g_best = jnp.argmax(jnp.where(g_ok, g_support, -1.0))
        ground_id = jnp.where(
            found & jnp.any(g_ok), g_best.astype(jnp.int32), -1
        )
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
            room_valid=sg.room_valid.at[slot].set(
                can | sg.room_valid[slot]
            ),
            n_rooms=sg.n_rooms + (can & ~matched).astype(jnp.int32),
        )
        return sg, None

    sg, _ = jax.lax.scan(per_cluster, sg, (centers, centers_valid))
    return sg


detect_rooms_freespace = jax.jit(detect_rooms_freespace,
                                 static_argnames=())

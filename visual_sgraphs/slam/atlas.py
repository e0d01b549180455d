"""Atlas: multi-map container with merge — the elastic-recovery mechanism.

Replaces the reference's ``Atlas`` (orb_slam3/include/Atlas.h) + the map
surgery of ``LoopClosing::MergeLocal`` (LoopClosing.cc:1182-1683): on
unrecoverable tracking loss the system stashes the active map and starts a
fresh one (Tracking::CreateMapInAtlas, Tracking.cc:2733); when place
recognition later locates the camera inside a stashed map, the young map is
transformed by the welding SE3 and its keyframes/points are copied into the
old map's free capacity (the reference migrates entities the same way,
LoopClosing.cc:1552-1683).

The merge itself is ONE jitted scatter program: no per-entity loops.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from visual_sgraphs.core import lie
from visual_sgraphs.slam.map_state import MapState


class MergeStats(NamedTuple):
    n_kf_moved: jax.Array
    n_pt_moved: jax.Array
    kf_new: jax.Array  # (K,) dst slot per src keyframe slot, -1 dropped


@jax.jit
def transform_map(m: MapState, T_new_old: jax.Array) -> MapState:
    """Re-express a whole map in a new world frame: X' = T_new_old · X,
    T_cw' = T_cw · T_new_old⁻¹ (the Sim3-free special case of the merge
    welding transform)."""
    T_inv = lie.se3_inverse(T_new_old)
    new_pose = jax.vmap(
        lambda T: lie.se3_normalize(lie.se3_multiply(T, T_inv))
    )(m.kf_pose)
    new_pts = jax.vmap(lambda p: lie.se3_apply(T_new_old, p))(m.pt_pos)
    return m._replace(
        kf_pose=jnp.where(m.kf_valid[:, None], new_pose, m.kf_pose),
        pt_pos=jnp.where(m.pt_valid[:, None], new_pts, m.pt_pos),
    )


@jax.jit
def merge_maps(
    dst: MapState,
    src: MapState,
    T_dst_src: jax.Array,
) -> tuple[MapState, MergeStats]:
    """Copy every valid keyframe/point of ``src`` into ``dst``'s free
    capacity, with ``src`` world coordinates mapped through ``T_dst_src``
    (points X_dst = T·X_src, poses T_cw_dst = T_cw_src·T⁻¹).

    Point ids are remapped by a single gather; keyframes or points beyond
    capacity are dropped (the reference instead grows heap structures — a
    fixed-capacity map drops the overflow and reports it in the stats).
    """
    src = transform_map(src, T_dst_src)
    K, N = dst.K, dst.N

    # --- allocate KF slots from dst's FREE slots, in src-seq order so the
    # merged sequence numbering preserves the young map's temporal order.
    # Dropped rows get slot==K and fall off through the scatters'
    # mode="drop": routing them to slot 0 would race the real slot-0 write
    # (XLA scatter order with duplicate indices is undefined).
    kf_take = src.kf_valid
    seq_key = jnp.where(kf_take, src.kf_seq, jnp.int32(2**30))
    order_idx = jnp.argsort(seq_key)  # src slots by seq, taken first
    rank = jnp.zeros((K,), jnp.int32).at[order_idx].set(
        jnp.arange(K, dtype=jnp.int32)
    )
    (kf_free,) = jnp.nonzero(~dst.kf_valid, size=K, fill_value=-1)
    kf_new = jnp.where(kf_take, kf_free[jnp.minimum(rank, K - 1)], -1)
    kf_ok = kf_new >= 0
    kf_slot = jnp.where(kf_ok, kf_new, K)
    kf_seq_new = jnp.where(kf_ok, dst.n_kf + rank, -1)

    # --- allocate point slots from dst's free list
    pt_take = src.pt_valid
    pt_order = jnp.cumsum(pt_take.astype(jnp.int32)) - 1
    (pt_free,) = jnp.nonzero(~dst.pt_valid, size=N, fill_value=-1)
    pt_new = jnp.where(pt_take, pt_free[jnp.minimum(pt_order, N - 1)], -1)
    pt_ok = pt_new >= 0
    pt_slot = jnp.where(pt_ok, pt_new, N)

    # observation remap: src point id -> dst point id (or -1)
    remap = jnp.full((src.N + 1,), -1, jnp.int32).at[1:].set(
        jnp.where(pt_ok, pt_new, -1)
    )
    obs_remap = remap[jnp.maximum(src.kf_obs_pt, -1) + 1]  # (K, F)

    def scatter_rows(table_dst, table_src, ok, slots):
        del ok  # dropped rows carry an out-of-bounds slot
        return table_dst.at[slots].set(table_src, mode="drop")

    new = dst._replace(
        kf_pose=scatter_rows(dst.kf_pose, src.kf_pose, kf_ok, kf_slot),
        kf_valid=dst.kf_valid.at[kf_slot].set(True, mode="drop"),
        kf_timestamp=scatter_rows(dst.kf_timestamp, src.kf_timestamp,
                                  kf_ok, kf_slot),
        kf_uv=scatter_rows(dst.kf_uv, src.kf_uv, kf_ok, kf_slot),
        kf_depth=scatter_rows(dst.kf_depth, src.kf_depth, kf_ok, kf_slot),
        kf_level=scatter_rows(dst.kf_level, src.kf_level, kf_ok, kf_slot),
        kf_angle=scatter_rows(dst.kf_angle, src.kf_angle, kf_ok, kf_slot),
        kf_desc=scatter_rows(dst.kf_desc, src.kf_desc, kf_ok, kf_slot),
        kf_kp_valid=scatter_rows(dst.kf_kp_valid, src.kf_kp_valid,
                                 kf_ok, kf_slot),
        kf_obs_pt=scatter_rows(dst.kf_obs_pt, obs_remap, kf_ok, kf_slot),
        kf_seq=dst.kf_seq.at[kf_slot].set(kf_seq_new, mode="drop"),
        pt_pos=scatter_rows(dst.pt_pos, src.pt_pos, pt_ok, pt_slot),
        pt_valid=dst.pt_valid.at[pt_slot].set(True, mode="drop"),
        pt_desc=scatter_rows(dst.pt_desc, src.pt_desc, pt_ok, pt_slot),
        pt_first_kf=dst.pt_first_kf.at[pt_slot].set(
            jnp.where(
                src.pt_first_kf >= 0,
                remap_kf(kf_new, src.pt_first_kf), -1
            ),
            mode="drop",
        ),
        # points' creation seq re-expressed in the merged namespace (their
        # creating keyframe's new seq; dropped-KF points read as new)
        pt_first_seq=dst.pt_first_seq.at[pt_slot].set(
            jnp.where(
                remap_kf(kf_new, src.pt_first_kf) >= 0,
                remap_kf(kf_seq_new, src.pt_first_kf), dst.n_kf,
            ),
            mode="drop",
        ),
        pt_visible=scatter_rows(dst.pt_visible, src.pt_visible,
                                pt_ok, pt_slot),
        pt_found=scatter_rows(dst.pt_found, src.pt_found, pt_ok, pt_slot),
        n_kf=dst.n_kf + jnp.sum(kf_take.astype(jnp.int32)),
        n_pt=dst.n_pt + jnp.sum(pt_take.astype(jnp.int32)),
    )
    stats = MergeStats(
        n_kf_moved=jnp.sum(kf_ok.astype(jnp.int32)),
        n_pt_moved=jnp.sum(pt_ok.astype(jnp.int32)),
        kf_new=kf_new,
    )
    return new, stats


def remap_kf(kf_new: jax.Array, idx: jax.Array) -> jax.Array:
    """Map src keyframe indices through the slot allocation (helper)."""
    table = jnp.concatenate(
        [jnp.full((1,), -1, jnp.int32), kf_new.astype(jnp.int32)]
    )
    return table[jnp.clip(idx, -1, kf_new.shape[0] - 1) + 1]


class SgMergeStats(NamedTuple):
    n_planes_moved: jax.Array
    n_obs_moved: jax.Array
    n_rooms_moved: jax.Array


@jax.jit
def merge_scenegraphs(dst, src, T_dst_src: jax.Array, kf_new: jax.Array):
    """Migrate every scene-graph entity of ``src`` into ``dst``, re-expressed
    through the welding SE3 — the entity-migration half of
    ``LoopClosing::MergeLocal`` (LoopClosing.cc:1552-1683, which moves
    Planes/Markers/Rooms/Doors between maps and re-associates them).

    ``kf_new``: (K,) dst keyframe slot for each src keyframe (or -1 for
    dropped ones) — plane observations remap through it so plane-KF factors
    keep pointing at real keyframes after the merge.  Overflowing entities
    are dropped and counted in the stats (the fixed-capacity analogue of the
    reference's heap growth).
    """
    from visual_sgraphs.core import plane as plane_mod

    # --- re-express src in dst world coordinates
    pl_coeffs = jax.vmap(
        lambda c: plane_mod.transform(T_dst_src, c)
    )(src.pl_coeffs)
    pl_centroid = jax.vmap(
        lambda p: lie.se3_apply(T_dst_src, p)
    )(src.pl_centroid)
    room_center = jax.vmap(
        lambda p: lie.se3_apply(T_dst_src, p)
    )(src.room_center)
    door_pose = jax.vmap(
        lambda T: lie.se3_normalize(lie.se3_multiply(T_dst_src, T))
    )(src.door_pose)
    marker_pose = jax.vmap(
        lambda T: lie.se3_normalize(lie.se3_multiply(T_dst_src, T))
    )(src.marker_pose)

    def alloc(take, n_dst, cap):
        order = jnp.cumsum(take.astype(jnp.int32)) - 1
        new = jnp.where(take, n_dst + order, -1)
        new = jnp.where(new < cap, new, -1)
        # dropped rows scatter out of bounds (mode="drop" discards them) —
        # routing them to slot 0 instead would race the real slot-0 write
        # (XLA scatter order with duplicate indices is undefined)
        return new, new >= 0, jnp.where(new >= 0, new, cap)

    P, R, D, M = dst.pl_coeffs.shape[0], dst.room_valid.shape[0], \
        dst.door_valid.shape[0], dst.marker_valid.shape[0]
    Q = dst.ob_kf.shape[0]
    pl_new, pl_ok, pl_slot = alloc(src.pl_valid, dst.n_planes, P)
    rm_new, rm_ok, rm_slot = alloc(src.room_valid, dst.n_rooms, R)
    dr_new, dr_ok, dr_slot = alloc(src.door_valid, dst.n_doors, D)
    mk_new, mk_ok, mk_slot = alloc(src.marker_valid, dst.n_markers, M)

    # plane-id remap for observations and room wall/ground references
    pl_remap = jnp.concatenate(
        [jnp.full((1,), -1, jnp.int32), jnp.where(pl_ok, pl_new, -1)]
    )

    def remap_pl(idx):
        return pl_remap[jnp.clip(idx, -1, src.pl_valid.shape[0] - 1) + 1]

    # observations: remap kf + plane ids; local-frame coeffs/quadrics are
    # keyframe-relative and move WITH their keyframe, so they stay unchanged
    ob_kf_new = remap_kf(kf_new, src.ob_kf)
    ob_pl_new = remap_pl(src.ob_plane)
    ob_take = src.ob_valid & (ob_kf_new >= 0) & (ob_pl_new >= 0)
    ob_new, ob_ok, ob_slot = alloc(ob_take, dst.n_obs, Q)

    def scatter(table_dst, table_src, ok, slots):
        del ok  # not-ok rows carry slot==cap and fall off via mode="drop"
        return table_dst.at[slots].set(table_src, mode="drop")

    new = dst._replace(
        pl_coeffs=scatter(dst.pl_coeffs, pl_coeffs, pl_ok, pl_slot),
        pl_valid=dst.pl_valid.at[pl_slot].set(True, mode="drop"),
        pl_centroid=scatter(dst.pl_centroid, pl_centroid, pl_ok, pl_slot),
        pl_npts=scatter(dst.pl_npts, src.pl_npts, pl_ok, pl_slot),
        pl_votes=scatter(dst.pl_votes, src.pl_votes, pl_ok, pl_slot),
        pl_nobs=scatter(dst.pl_nobs, src.pl_nobs, pl_ok, pl_slot),
        ob_kf=scatter(dst.ob_kf, ob_kf_new, ob_ok, ob_slot),
        ob_plane=scatter(dst.ob_plane, ob_pl_new, ob_ok, ob_slot),
        ob_coeffs=scatter(dst.ob_coeffs, src.ob_coeffs, ob_ok, ob_slot),
        ob_conf=scatter(dst.ob_conf, src.ob_conf, ob_ok, ob_slot),
        ob_quadric=scatter(dst.ob_quadric, src.ob_quadric, ob_ok, ob_slot),
        ob_valid=dst.ob_valid.at[ob_slot].set(True, mode="drop"),
        room_center=scatter(dst.room_center, room_center, rm_ok, rm_slot),
        room_walls=scatter(dst.room_walls, remap_pl(src.room_walls),
                           rm_ok, rm_slot),
        room_is_corridor=scatter(dst.room_is_corridor, src.room_is_corridor,
                                 rm_ok, rm_slot),
        room_valid=dst.room_valid.at[rm_slot].set(True, mode="drop"),
        room_marker=scatter(dst.room_marker, src.room_marker, rm_ok,
                            rm_slot),
        room_ground=scatter(dst.room_ground, remap_pl(src.room_ground),
                            rm_ok, rm_slot),
        door_pose=scatter(dst.door_pose, door_pose, dr_ok, dr_slot),
        door_marker=scatter(dst.door_marker, src.door_marker, dr_ok,
                            dr_slot),
        door_valid=dst.door_valid.at[dr_slot].set(True, mode="drop"),
        marker_pose=scatter(dst.marker_pose, marker_pose, mk_ok, mk_slot),
        marker_id=scatter(dst.marker_id, src.marker_id, mk_ok, mk_slot),
        marker_valid=dst.marker_valid.at[mk_slot].set(True, mode="drop"),
        n_planes=jnp.minimum(
            dst.n_planes + jnp.sum(src.pl_valid.astype(jnp.int32)), P
        ).astype(jnp.int32),
        n_obs=jnp.minimum(
            dst.n_obs + jnp.sum(ob_take.astype(jnp.int32)), Q
        ).astype(jnp.int32),
        n_rooms=jnp.minimum(
            dst.n_rooms + jnp.sum(src.room_valid.astype(jnp.int32)), R
        ).astype(jnp.int32),
        n_doors=jnp.minimum(
            dst.n_doors + jnp.sum(src.door_valid.astype(jnp.int32)), D
        ).astype(jnp.int32),
        n_markers=jnp.minimum(
            dst.n_markers + jnp.sum(src.marker_valid.astype(jnp.int32)), M
        ).astype(jnp.int32),
    )
    stats = SgMergeStats(
        n_planes_moved=jnp.sum(pl_ok.astype(jnp.int32)),
        n_obs_moved=jnp.sum(ob_ok.astype(jnp.int32)),
        n_rooms_moved=jnp.sum(rm_ok.astype(jnp.int32)),
    )
    return new, stats


class StashedMap(NamedTuple):
    """One inactive Atlas map with its place-recognition state and scene
    graph (the reference keeps these alive on the Map object itself,
    Map.h:200-216)."""

    epoch: int
    map: MapState
    db: object = None
    vocab: object = None
    sg: object = None  # SceneGraphState or None


class Atlas:
    """Host-side multi-map registry (the reference's Atlas object graph,
    reduced to: one active map + stashed inactive maps with their
    place-recognition databases and scene graphs)."""

    def __init__(self):
        self.stashed: list[StashedMap] = []
        self.n_maps_created = 1

    def stash(self, epoch: int, m: MapState, db=None, vocab=None,
              sg=None) -> None:
        self.stashed.append(StashedMap(epoch, m, db, vocab, sg))
        self.n_maps_created += 1

    def __len__(self) -> int:
        return len(self.stashed) + 1

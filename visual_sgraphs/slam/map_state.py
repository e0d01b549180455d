"""The map as an immutable pytree of fixed-capacity arrays.

Replaces the reference's mutex-guarded ``Atlas``/``Map``/``KeyFrame``/
``MapPoint`` object graph (orb_slam3/include/Atlas.h, Map.h, KeyFrame.h,
MapPoint.h).  Keyframes own per-slot keypoint tables; the keyframe→point
association ``kf_obs_pt`` is the primary observation structure (the
reference's ``mvpMapPoints``), from which covisibility and BA factor lists
are derived on demand by batched reductions instead of being cached behind
locks (KeyFrame::UpdateConnections, KeyFrame.cc:486).

All updates are functional scatter ops inside jitted update programs; the
host keeps only integer counters it reads back for control-flow decisions.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from visual_sgraphs.config import CapacityConfig, OrbConfig


class MapState(NamedTuple):
    """Fixed-capacity SLAM map (one active map of the Atlas)."""

    # --- keyframes (K = max_keyframes, F = features/frame) ---
    kf_pose: jax.Array  # (K, 7) T_cw
    kf_valid: jax.Array  # (K,)
    kf_timestamp: jax.Array  # (K,)
    kf_uv: jax.Array  # (K, F, 2) keypoint pixels (undistorted)
    kf_depth: jax.Array  # (K, F) metric depth (<=0: unknown)
    kf_level: jax.Array  # (K, F) int8-ish pyramid level (int32)
    kf_angle: jax.Array  # (K, F)
    kf_desc: jax.Array  # (K, F, 32) uint8
    kf_kp_valid: jax.Array  # (K, F)
    kf_obs_pt: jax.Array  # (K, F) int32 map-point id or -1
    # monotone insertion sequence per slot (-1 invalid).  Slots are REUSED
    # after culling/eviction, so slot index no longer encodes age; every
    # temporal-order heuristic (loop min_gap, essential-graph consecutive
    # edges, trajectory references) keys on kf_seq instead.
    kf_seq: jax.Array  # (K,) int32
    # --- map points (N = max_points) ---
    pt_pos: jax.Array  # (N, 3) world
    pt_valid: jax.Array  # (N,)
    pt_desc: jax.Array  # (N, 32) uint8 representative descriptor
    pt_first_kf: jax.Array  # (N,) creating keyframe SLOT (re-pointed to
    # the parent when that keyframe retires — used by loop correction)
    pt_first_seq: jax.Array  # (N,) creating keyframe SEQUENCE (age)
    # n_kf at the moment the slot was culled: freed ids are QUARANTINED
    # for a few keyframes before reuse, because in-flight pipeline match
    # tables (dispatched against the pre-cull map) may still reference
    # them — immediate reuse would silently relink those observations to
    # an unrelated new point
    pt_freed_seq: jax.Array  # (N,)
    pt_visible: jax.Array  # (N,) times predicted visible (culling stats)
    pt_found: jax.Array  # (N,) times actually matched
    # --- retirement ledger: culled/evicted keyframes' relative pose to a
    # surviving parent, so old trajectory rows re-base through the chain
    # exactly like the reference's Trel*mTcp parent walk in
    # SaveTrajectoryTUM (System.cc) ---
    led_seq: jax.Array  # (E,) retired keyframe's sequence number
    led_parent_seq: jax.Array  # (E,) surviving parent's sequence number
    led_T_cp: jax.Array  # (E, 7) T_retired_cw . T_parent_cw^-1 at retire
    led_n: jax.Array  # () ledger length
    # --- counters (device scalars; monotone creation counts) ---
    n_kf: jax.Array  # ()
    n_pt: jax.Array  # ()

    @property
    def K(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def F(self) -> int:
        return self.kf_uv.shape[1]

    @property
    def N(self) -> int:
        return self.pt_pos.shape[0]

    @property
    def E(self) -> int:
        return self.led_seq.shape[0]


def empty_map(cap: CapacityConfig = CapacityConfig(),
              orb: OrbConfig = OrbConfig()) -> MapState:
    K, F, N = cap.max_keyframes, orb.n_features, cap.max_points
    E = cap.max_retired
    f32, i32 = jnp.float32, jnp.int32
    return MapState(
        kf_pose=jnp.zeros((K, 7), f32).at[:, 0].set(1.0),
        kf_valid=jnp.zeros((K,), bool),
        kf_timestamp=jnp.zeros((K,), f32),
        kf_uv=jnp.zeros((K, F, 2), f32),
        kf_depth=jnp.full((K, F), -1.0, f32),
        kf_level=jnp.zeros((K, F), i32),
        kf_angle=jnp.zeros((K, F), f32),
        kf_desc=jnp.zeros((K, F, 32), jnp.uint8),
        kf_kp_valid=jnp.zeros((K, F), bool),
        kf_obs_pt=jnp.full((K, F), -1, i32),
        kf_seq=jnp.full((K,), -1, i32),
        pt_pos=jnp.zeros((N, 3), f32),
        pt_valid=jnp.zeros((N,), bool),
        pt_desc=jnp.zeros((N, 32), jnp.uint8),
        pt_first_kf=jnp.full((N,), -1, i32),
        pt_first_seq=jnp.full((N,), -1, i32),
        pt_freed_seq=jnp.full((N,), -(10**6), i32),
        pt_visible=jnp.zeros((N,), i32),
        pt_found=jnp.zeros((N,), i32),
        led_seq=jnp.full((E,), -1, i32),
        led_parent_seq=jnp.full((E,), -1, i32),
        led_T_cp=jnp.zeros((E, 7), f32).at[:, 0].set(1.0),
        led_n=jnp.zeros((), i32),
        n_kf=jnp.zeros((), i32),
        n_pt=jnp.zeros((), i32),
    )


def point_obs_count(m: MapState) -> jax.Array:
    """(N,) number of keyframe observations per map point — derived from the
    primary kf_obs_pt table (the reference caches this in
    MapPoint::nObs)."""
    obs = jnp.where(m.kf_kp_valid & m.kf_valid[:, None], m.kf_obs_pt, -1)
    flat = obs.reshape(-1)
    counts = jnp.zeros((m.N + 1,), jnp.int32).at[
        jnp.clip(flat, -1, m.N - 1) + 1
    ].add(1)
    return counts[1:]


def covisibility_counts(m: MapState, kf_id: jax.Array) -> jax.Array:
    """(K,) number of map points shared between ``kf_id`` and every KF —
    the covisibility weights of KeyFrame::UpdateConnections
    (KeyFrame.cc:486-523), computed on demand as one masked reduction."""
    obs_k = m.kf_obs_pt[kf_id]  # (F,)
    member = jnp.zeros((m.N + 1,), bool).at[
        jnp.where(m.kf_kp_valid[kf_id], obs_k, -1) + 1
    ].set(True)
    member = member.at[0].set(False)
    # culled points no longer create covisibility (their kf_obs_pt links
    # are unlinked lazily; a reused slot must not bridge unrelated KFs)
    member = member & jnp.concatenate(
        [jnp.zeros((1,), bool), m.pt_valid]
    )
    shared = member[
        jnp.where(m.kf_kp_valid, m.kf_obs_pt, -1) + 1
    ]  # (K, F)
    counts = jnp.sum(shared, axis=1).astype(jnp.int32)
    counts = jnp.where(m.kf_valid, counts, 0)
    return counts.at[kf_id].set(0)


def observed_mask(m: MapState, kf_ids: jax.Array,
                  kf_mask: jax.Array) -> jax.Array:
    """(N,) bool — map points observed by any of ``kf_ids`` (masked)."""
    obs = m.kf_obs_pt[kf_ids]  # (L, F)
    ok = m.kf_kp_valid[kf_ids] & kf_mask[:, None]
    flat = jnp.where(ok, obs, -1).reshape(-1)
    mask = jnp.zeros((m.N + 1,), bool).at[flat + 1].set(True)
    return mask[1:]

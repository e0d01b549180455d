"""Scene-graph state: plane / room / door / marker tables + observations.

Fixed-capacity pytree replacing the reference's Plane/Room/Door/Marker
entities and their Atlas indices (include/Geometric/Plane.h,
include/Semantic/{Room,Door,Marker,Floor}.h, Atlas.h:93-126).  Per-plane
semantic class is decided by *weighted voting* over per-observation
confidences with a minimum-vote gate, exactly the reference's
``Plane::castWeightedVote`` / ``getExpectedPlaneType`` scheme
(Plane.cc:148-197).

Plane observations (per keyframe local plane equations) are kept in a flat
table so the optimizer can add plane-KF factors (EdgeVertexPlaneProjectSE3KF)
over exactly the same data.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from visual_sgraphs.config import CapacityConfig

N_CLASSES = 3  # ground / wall / ceiling
GROUND, WALL, CEILING, UNDEFINED = 0, 1, 2, -1


class SceneGraphState(NamedTuple):
    # planes (P,)
    pl_coeffs: jax.Array  # (P, 4) world plane, |n|=1
    pl_valid: jax.Array  # (P,)
    pl_centroid: jax.Array  # (P, 3) running centroid of supporting points
    pl_npts: jax.Array  # (P,) supporting point count
    pl_votes: jax.Array  # (P, N_CLASSES) weighted semantic votes
    pl_nobs: jax.Array  # (P,) observation count
    # plane observations (Q,)
    ob_kf: jax.Array  # (Q,) keyframe id
    ob_plane: jax.Array  # (Q,) plane id
    ob_coeffs: jax.Array  # (Q, 4) plane in the keyframe's camera frame
    ob_conf: jax.Array  # (Q,) mean confidence of the observation
    ob_quadric: jax.Array  # (Q, 4, 4) Gij = Σ w·p̃p̃ᵀ (camera frame)
    ob_valid: jax.Array  # (Q,)
    # rooms (R,)
    room_center: jax.Array  # (R, 3)
    room_walls: jax.Array  # (R, 4) plane ids (corridor: first 2, rest -1)
    room_is_corridor: jax.Array  # (R,)
    room_valid: jax.Array  # (R,)
    room_marker: jax.Array  # (R,) meta-marker id or -1
    room_ground: jax.Array  # (R,) associated ground plane id or -1
    # doors (D,)
    door_pose: jax.Array  # (D, 7) world SE3
    door_marker: jax.Array  # (D,) marker id
    door_valid: jax.Array  # (D,)
    # fiducial markers (M,)
    marker_pose: jax.Array  # (M, 7) world SE3
    marker_id: jax.Array  # (M,) detected aruco id
    marker_valid: jax.Array  # (M,)
    # counters
    n_planes: jax.Array
    n_obs: jax.Array
    n_rooms: jax.Array
    n_doors: jax.Array
    n_markers: jax.Array
    # per-plane voxel-membership hash table (LAST field: checkpoint v3
    # archives predate it and upgrade by appending the default) — the
    # octree the reference keeps per Plane for membership queries
    # (Plane.cc:81-140), as an open-addressed set of occupied surface
    # voxel keys
    pl_vox: jax.Array = None  # (P, V) int32 voxel key or -1

    @property
    def P(self):
        return self.pl_coeffs.shape[0]


def empty_scenegraph(cap: CapacityConfig = CapacityConfig(),
                     max_obs: int = 1024) -> SceneGraphState:
    P, R, D, M = cap.max_planes, cap.max_rooms, cap.max_doors, cap.max_markers
    f32, i32 = jnp.float32, jnp.int32
    return SceneGraphState(
        pl_coeffs=jnp.zeros((P, 4), f32),
        pl_valid=jnp.zeros((P,), bool),
        pl_centroid=jnp.zeros((P, 3), f32),
        pl_npts=jnp.zeros((P,), f32),
        pl_votes=jnp.zeros((P, N_CLASSES), f32),
        pl_nobs=jnp.zeros((P,), i32),
        ob_kf=jnp.full((max_obs,), -1, i32),
        ob_plane=jnp.full((max_obs,), -1, i32),
        ob_coeffs=jnp.zeros((max_obs, 4), f32),
        ob_conf=jnp.zeros((max_obs,), f32),
        ob_quadric=jnp.zeros((max_obs, 4, 4), f32),
        ob_valid=jnp.zeros((max_obs,), bool),
        room_center=jnp.zeros((R, 3), f32),
        room_walls=jnp.full((R, 4), -1, i32),
        room_is_corridor=jnp.zeros((R,), bool),
        room_valid=jnp.zeros((R,), bool),
        room_marker=jnp.full((R,), -1, i32),
        room_ground=jnp.full((R,), -1, i32),
        door_pose=jnp.zeros((D, 7), f32).at[:, 0].set(1.0),
        door_marker=jnp.full((D,), -1, i32),
        door_valid=jnp.zeros((D,), bool),
        marker_pose=jnp.zeros((M, 7), f32).at[:, 0].set(1.0),
        marker_id=jnp.full((M,), -1, i32),
        marker_valid=jnp.zeros((M,), bool),
        n_planes=jnp.zeros((), i32),
        n_obs=jnp.zeros((), i32),
        n_rooms=jnp.zeros((), i32),
        n_doors=jnp.zeros((), i32),
        n_markers=jnp.zeros((), i32),
        pl_vox=jnp.full((P, cap.plane_vox_slots), -1, i32),
    )


MEMBERSHIP_VOXEL = 0.3  # m — plane-surface membership resolution


def voxel_key(p: jax.Array, vox: float = MEMBERSHIP_VOXEL) -> jax.Array:
    """(..., 3) world points -> (...) int32 packed voxel keys (10 bits
    per axis, +-~150 m range at 0.3 m)."""
    idx = jnp.floor(p / vox).astype(jnp.int32) + 512
    idx = jnp.clip(idx, 0, 1023)
    return (idx[..., 0] << 20) | (idx[..., 1] << 10) | idx[..., 2]


def voxel_slot(key: jax.Array, V: int) -> jax.Array:
    """Hash slot of a voxel key in a (V,)-row table (Knuth multiplicative;
    uint32 wraparound is the modulo)."""
    h = (key.astype(jnp.uint32) * jnp.uint32(2654435761)) >> jnp.uint32(16)
    return (h % jnp.uint32(V)).astype(jnp.int32)


def plane_semantics(sg: SceneGraphState, min_votes: float = 3.0) -> jax.Array:
    """(P,) expected semantic class per plane: argmax of weighted votes,
    UNDEFINED until the winning class accumulates ``min_votes``
    (Plane::getExpectedPlaneType, Plane.cc:148-164)."""
    best = jnp.argmax(sg.pl_votes, axis=-1).astype(jnp.int32)
    strength = jnp.max(sg.pl_votes, axis=-1)
    return jnp.where(sg.pl_valid & (strength >= min_votes), best, UNDEFINED)

"""Per-plane voxel membership (Plane.cc:81-140 octree equivalent):
semantic map-point refinement culls only points behind the plane's
OBSERVED surface extent — not points near a parallel-but-distinct wall,
and not sparing a long wall's far end (the old centroid lateral-radius
proxy failed both ways, VERDICT r4 Missing #8)."""

import jax.numpy as jnp
import numpy as np

from visual_sgraphs.config import CapacityConfig, OrbConfig
from visual_sgraphs.core import lie
from visual_sgraphs.scenegraph.manager import refine_points_semantic
from visual_sgraphs.scenegraph.state import (
    WALL,
    empty_scenegraph,
    voxel_key,
    voxel_slot,
)
from visual_sgraphs.slam.map_state import empty_map


def _sg_with_wall(extent_x=(0.0, 8.0)):
    """One wall plane z=4 (n=-z so the camera at origin is on the + side)
    whose observed membership covers x in ``extent_x`` at y in [-1, 1]."""
    sg = empty_scenegraph(CapacityConfig(max_planes=8, max_rooms=4,
                                         max_doors=4, max_markers=4,
                                         plane_vox_slots=512))
    coeffs = jnp.asarray([0.0, 0.0, -1.0, 4.0], jnp.float32)
    votes = jnp.zeros((8, 3), jnp.float32).at[0, WALL].set(10.0)
    # membership: grid of surface samples on the wall
    xs = np.arange(extent_x[0], extent_x[1], 0.15)
    ys = np.arange(-1.0, 1.0, 0.15)
    pts = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    surf = jnp.asarray(
        np.concatenate([pts, np.full((len(pts), 1), 4.0)], 1), jnp.float32
    )
    keys = voxel_key(surf)
    slots = voxel_slot(keys, 512)
    vox = jnp.full((8, 512), -1, jnp.int32).at[0, slots].set(keys)
    return sg._replace(
        pl_coeffs=sg.pl_coeffs.at[0].set(coeffs),
        pl_valid=sg.pl_valid.at[0].set(True),
        pl_centroid=sg.pl_centroid.at[0].set(
            jnp.asarray([1.0, 0.0, 4.0])  # centroid near the NEAR end
        ),
        pl_votes=votes,
        pl_vox=vox,
        n_planes=jnp.asarray(1, jnp.int32),
    )


def _map_with_points(pts):
    m = empty_map(CapacityConfig(max_keyframes=8, max_points=64),
                  OrbConfig(n_features=16))
    n = len(pts)
    return m._replace(
        pt_pos=m.pt_pos.at[:n].set(jnp.asarray(pts, jnp.float32)),
        pt_valid=m.pt_valid.at[:n].set(True),
        n_pt=jnp.asarray(n, jnp.int32),
    )


def test_membership_culls_far_end_spares_parallel_wall():
    sg = _sg_with_wall()
    T_cw = lie.se3_identity()  # camera at origin, + side of the wall
    pts = [
        [0.5, 0.0, 4.5],   # behind the wall, near end -> cull
        [7.5, 0.0, 4.5],   # behind the wall, FAR end (6.5 m from the
        # centroid — outside any lateral-radius proxy) -> cull
        [0.5, 0.0, 7.0],   # behind, but its projection (x=0.5) IS on the
        # wall surface -> cull (depth-through-wall artifact)
        [12.0, 0.0, 4.5],  # behind the infinite plane but beyond the
        # observed extent (a parallel-but-distinct wall) -> KEEP
        [0.5, 0.0, 3.0],   # in FRONT of the wall -> keep
    ]
    m = _map_with_points(pts)
    m2 = refine_points_semantic(m, sg, T_cw, min_votes=3.0,
                                behind_thresh=0.15)
    v = np.asarray(m2.pt_valid[:5])
    assert not v[0], "near-end behind point survived"
    assert not v[1], "far-end behind point survived (radius-proxy bug)"
    assert not v[2], "deep through-wall point survived"
    assert v[3], "point on a parallel-but-distinct wall was culled"
    assert v[4], "point in front of the wall was culled"

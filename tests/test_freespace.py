"""Free-space room segmentation (scenegraph/freespace.py): clustering of
the observed-free grid and cluster-seeded room detection — the reference's
primary (voxblox) room path, SemanticsManager.cc:302-403."""

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.config import CapacityConfig
from visual_sgraphs.scenegraph import freespace as fs
from visual_sgraphs.scenegraph.manager import detect_rooms
from visual_sgraphs.scenegraph.state import (
    GROUND,
    WALL,
    empty_scenegraph,
)


def _wall(n, d, centroid, npts=500.0):
    return np.asarray(n + [d]), np.asarray(centroid), npts


def _two_room_sg():
    """Two 4 x 4 m rooms side by side along x, sharing wall orientations:
    room A spans x in [0, 4], room B x in [5, 9]; both span z in [0, 4].
    Walls: for each room, two x-normal walls and two z-normal walls."""
    sg = empty_scenegraph(CapacityConfig(max_planes=16, max_rooms=8,
                                         max_doors=4, max_markers=4))
    # plane: n.x + d = 0
    walls = [
        # room A x-walls at x=0 (n=+x) and x=4 (n=-x)
        _wall([1.0, 0.0, 0.0], 0.0, [0.0, 0.0, 2.0]),
        _wall([-1.0, 0.0, 0.0], 4.0, [4.0, 0.0, 2.0]),
        # room A z-walls at z=0, z=4
        _wall([0.0, 0.0, 1.0], 0.0, [2.0, 0.0, 0.0]),
        _wall([0.0, 0.0, -1.0], 4.0, [2.0, 0.0, 4.0]),
        # room B x-walls at x=5, x=9
        _wall([1.0, 0.0, 0.0], -5.0, [5.0, 0.0, 2.0]),
        _wall([-1.0, 0.0, 0.0], 9.0, [9.0, 0.0, 2.0]),
        # room B z-walls at z=0, z=4
        _wall([0.0, 0.0, 1.0], 0.0, [7.0, 0.0, 0.0]),
        _wall([0.0, 0.0, -1.0], 4.0, [7.0, 0.0, 4.0]),
    ]
    P = len(walls)
    coeffs = jnp.asarray(np.stack([w[0] for w in walls]), jnp.float32)
    cents = jnp.asarray(np.stack([w[1] for w in walls]), jnp.float32)
    votes = np.zeros((16, 4), np.float32)
    votes[:P, WALL] = 10.0
    sg = sg._replace(
        pl_coeffs=sg.pl_coeffs.at[:P].set(coeffs),
        pl_centroid=sg.pl_centroid.at[:P].set(cents),
        pl_npts=sg.pl_npts.at[:P].set(500.0),
        pl_valid=sg.pl_valid.at[:P].set(True),
        pl_votes=jnp.asarray(votes),
        n_planes=jnp.asarray(P, jnp.int32),
    )
    return sg


def _room_wall_sets(sg):
    out = []
    for r in range(sg.room_valid.shape[0]):
        if bool(sg.room_valid[r]):
            out.append(sorted(int(w) for w in np.asarray(sg.room_walls[r])
                              if w >= 0))
    return out


def _wall_gap(sg, r):
    """Largest facing-pair gap among a room's walls (room x/z extent)."""
    walls = [int(w) for w in np.asarray(sg.room_walls[r]) if w >= 0]
    n = np.asarray(sg.pl_coeffs)[:, :3]
    c = np.asarray(sg.pl_centroid)
    best = 0.0
    for a in walls:
        for b in walls:
            if a < b and float(n[a] @ n[b]) < -0.9:
                best = max(best, abs(float(n[a] @ (c[b] - c[a]))))
    return best


def test_freespace_rejects_cross_room_pairing():
    """Two same-orientation rooms with room A's far x-wall UNSURVEYED:
    pure wall-pairing pairs A's x=0 wall with B's x=9 wall (facing, 9 m
    apart — a hallucinated mega-room spanning both), while cluster-seeded
    detection restricted to each room's free space never pairs walls more
    than one room apart."""
    sg = _two_room_sg()
    # drop wall 1 (room A's x=4 wall): never surveyed
    sg = sg._replace(pl_valid=sg.pl_valid.at[1].set(False))

    centers = jnp.asarray([[2.0, 0.0, 2.0], [7.0, 0.0, 2.0],
                           [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], jnp.float32)
    valid = jnp.asarray([True, True, False, False])
    def _inside_a_room(c):
        return (0.2 < c[0] < 3.8 or 5.2 < c[0] < 8.8) and 0.0 <= c[2] <= 4.0

    sg_fs = fs.detect_rooms_freespace(sg, centers, valid, wall_dist=2.5)
    rooms = _room_wall_sets(sg_fs)
    assert [4, 5, 6, 7] in rooms, f"room B walls wrong: {rooms}"
    for r in range(sg_fs.room_valid.shape[0]):
        if bool(sg_fs.room_valid[r]):
            c = np.asarray(sg_fs.room_center[r])
            assert _inside_a_room(c), (
                f"freespace candidate center {c.round(2)} lies outside "
                "both rooms"
            )
            assert _wall_gap(sg_fs, r) < 5.0

    # the wall-pairing-only path cross-pairs walls of DIFFERENT rooms
    # (measured: it pairs room A's z=4 wall with room B's z=0 wall and
    # places a corridor at x=4.5 — in the dividing gap where no room is)
    sg_geo = detect_rooms(sg, max_candidates=3)
    centers_geo = [
        np.asarray(sg_geo.room_center[r])
        for r in range(sg_geo.room_valid.shape[0])
        if bool(sg_geo.room_valid[r])
    ]
    assert any(not _inside_a_room(c) for c in centers_geo) or not any(
        sorted(w) == [4, 5, 6, 7]
        for w in _room_wall_sets(sg_geo)
    ), (
        "wall pairing unexpectedly solved the two-room scene; "
        f"centers={[c.round(2) for c in centers_geo]}"
    )


def test_freespace_grid_clusters_two_volumes():
    """Two separated free-space blobs cluster into two components with
    centroids at the blob centers."""
    G = 32
    vox = jnp.asarray(0.25, jnp.float32)
    origin = jnp.zeros((3,), jnp.float32)
    grid = jnp.zeros((G, G, G), bool)
    grid = grid.at[4:10, 4:10, 4:10].set(True)
    grid = grid.at[20:28, 20:28, 20:28].set(True)
    centers, valid = fs.freespace_cluster_centers(grid, origin, vox, G=G)
    got = np.asarray(centers)[np.asarray(valid)]
    assert got.shape[0] == 2
    expect_a = (np.array([6.5, 6.5, 6.5])) * 0.25
    expect_b = (np.array([23.5, 23.5, 23.5]) + 0.5) * 0.25 - 0.125
    da = min(np.linalg.norm(g - expect_a) for g in got)
    db = min(np.linalg.norm(g - expect_b) for g in got)
    assert da < 0.3 and db < 0.3, (got, expect_a, expect_b)


def test_accumulate_freespace_marks_interior():
    """Rays through a synthetic depth image mark interior voxels free and
    never mark voxels beyond the measured surface."""
    from visual_sgraphs.core import lie

    G = 32
    vox = jnp.asarray(0.25, jnp.float32)
    origin = jnp.asarray([-4.0, -4.0, 0.0], jnp.float32)
    h, w = 120, 160
    cam_K = jnp.asarray([80.0, 80.0, 79.5, 59.5], jnp.float32)
    depth = jnp.full((h, w), 5.0, jnp.float32)  # wall 5 m ahead
    T_cw = lie.se3_identity()  # camera at origin looking +z
    grid = jnp.zeros((G, G, G), bool)
    grid = fs.accumulate_freespace(grid, origin, vox, depth, T_cw, cam_K,
                                   G=G)
    g = np.asarray(grid)
    assert g.sum() > 50
    # the near-axis column has free voxels spread through the interior
    col = g[15:18, 15:18, :].any(axis=(0, 1))
    assert col[2:19].sum() >= 3, col
    # nothing beyond the wall (z > 5 m)
    kz = int((5.2 - 0.0) / 0.25)
    assert not g[:, :, kz:].any()

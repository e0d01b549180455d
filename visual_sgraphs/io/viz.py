"""Map / scene-graph export for offline visualization.

Replaces the reference's live publishing layer (common.cc:716-1070 planes
and rooms as rviz markers, :124-178 map points and KF path) and the PCD
export (System::SavePointCloudMap, System.cc:1409) with file artifacts any
point-cloud viewer opens: PLY for geometry, JSON for the scene-graph
structure."""

from __future__ import annotations

import json

import numpy as np

# distinct colors per semantic class (ground, wall, ceiling, undefined)
_CLASS_COLORS = {
    0: (80, 170, 80),
    1: (200, 120, 60),
    2: (100, 120, 220),
    -1: (150, 150, 150),
}


def _write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None,
               edges: np.ndarray | None = None) -> None:
    n = xyz.shape[0]
    has_c = rgb is not None
    lines = [
        "ply", "format ascii 1.0", f"element vertex {n}",
        "property float x", "property float y", "property float z",
    ]
    if has_c:
        lines += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    if edges is not None:
        lines += [f"element edge {edges.shape[0]}",
                  "property int vertex1", "property int vertex2"]
    lines.append("end_header")
    for i in range(n):
        row = f"{xyz[i, 0]:.4f} {xyz[i, 1]:.4f} {xyz[i, 2]:.4f}"
        if has_c:
            row += f" {int(rgb[i, 0])} {int(rgb[i, 1])} {int(rgb[i, 2])}"
        lines.append(row)
    if edges is not None:
        for a, b in edges:
            lines.append(f"{int(a)} {int(b)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def export_map_ply(path: str, system) -> int:
    """Map points (white) + keyframe camera centers (red, chained as edges)
    -> one PLY.  Returns the number of exported points."""
    import jax
    import jax.numpy as jnp

    from visual_sgraphs.core import lie

    m = system.map
    ok = np.asarray(m.pt_valid)
    pts = np.asarray(m.pt_pos)[ok]
    kf_ok = np.asarray(m.kf_valid)
    T_wc = np.asarray(jax.vmap(lie.se3_inverse)(jnp.asarray(m.kf_pose)))
    centers = T_wc[kf_ok][:, 4:7]
    xyz = np.concatenate([pts, centers], axis=0)
    rgb = np.concatenate([
        np.full((pts.shape[0], 3), 200, np.uint8),
        np.tile(np.asarray([[255, 40, 40]], np.uint8),
                (centers.shape[0], 1)),
    ])
    k = pts.shape[0]
    edges = np.stack([
        np.arange(k, k + centers.shape[0] - 1),
        np.arange(k + 1, k + centers.shape[0]),
    ], axis=1) if centers.shape[0] > 1 else None
    _write_ply(path, xyz, rgb, edges)
    return int(pts.shape[0])


def export_scenegraph_ply(path: str, manager, grid: int = 12,
                          half: float = 1.2) -> int:
    """Planes as colored sample grids + room centers + door positions
    (the publishPlanes/publishRooms rviz view, common.cc:716-1070)."""
    from visual_sgraphs.scenegraph.state import plane_semantics

    sg = manager.state
    sem = np.asarray(plane_semantics(sg, manager.cfg.plane_min_votes))
    ok = np.asarray(sg.pl_valid)
    coeffs = np.asarray(sg.pl_coeffs)
    cent = np.asarray(sg.pl_centroid)
    pts, cols = [], []
    lin = np.linspace(-half, half, grid)
    for i in np.nonzero(ok)[0]:
        n = coeffs[i, :3]
        # orthonormal basis of the plane
        a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
        u = np.cross(n, a)
        u /= max(np.linalg.norm(u), 1e-9)
        v = np.cross(n, u)
        for s in lin:
            for t in lin:
                pts.append(cent[i] + u * s + v * t)
                cols.append(_CLASS_COLORS.get(int(sem[i]), (150,) * 3))
    for r in np.nonzero(np.asarray(sg.room_valid))[0]:
        pts.append(np.asarray(sg.room_center[r]))
        cols.append((255, 255, 0))
    for d in np.nonzero(np.asarray(sg.door_valid))[0]:
        pts.append(np.asarray(sg.door_pose[d, 4:7]))
        cols.append((255, 0, 255))
    if not pts:
        _write_ply(path, np.zeros((0, 3)), np.zeros((0, 3), np.uint8))
        return 0
    _write_ply(path, np.stack(pts), np.asarray(cols, np.uint8))
    return len(pts)


def export_scenegraph_json(path: str, manager) -> dict:
    """Hierarchical scene-graph dump: planes, rooms (with wall ids), doors,
    markers — the structure the reference exposes through its System getters
    (System.h:230-238)."""
    out = {
        "planes": {
            k: np.asarray(v).tolist()
            for k, v in manager.planes().items()
        },
        "rooms": {
            k: np.asarray(v).tolist() for k, v in manager.rooms().items()
        },
        "doors": {
            k: np.asarray(v).tolist() for k, v in manager.doors().items()
        },
        "markers": {
            k: np.asarray(v).tolist() for k, v in manager.markers().items()
        },
    }
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out

"""Fixed-shape point-cloud operations (the PCL replacement).

Replaces the reference's PCL pipeline (Utils.cc:~230-290: distance filter,
voxel-grid downsample with min-points-per-voxel, statistical outlier
removal).  Clouds are fixed-capacity (N, 3) arrays with validity masks;
voxel binning is a hash-scatter, not a tree.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from visual_sgraphs.core import cameras, lie


def backproject_depth(depth_img: jax.Array, cam_K: jax.Array,
                      stride: int = 4, min_depth: float = 0.2,
                      max_depth: float = 8.0):
    """Depth image -> camera-frame cloud on a strided pixel grid.

    Returns (points (M, 3), valid (M,), pixel_rc (M, 2)) with
    M = (H//stride) * (W//stride).  The reference builds the organized cloud
    in the ROS wrapper (ros_rgbd.cc:116-131) and filters by distance
    (SystemParams pointcloud.distance_thresh).
    """
    h, w = depth_img.shape
    rs = jnp.arange(0, h - (h % stride), stride)
    cs = jnp.arange(0, w - (w % stride), stride)
    rr, cc = jnp.meshgrid(rs, cs, indexing="ij")
    d = depth_img[rr, cc].reshape(-1)
    uv = jnp.stack(
        [cc.reshape(-1).astype(jnp.float32), rr.reshape(-1).astype(jnp.float32)],
        axis=-1,
    )
    rays = cameras.unproject_pinhole(cam_K, uv)
    pts = rays * d[:, None]
    valid = (d > min_depth) & (d < max_depth)
    rc = jnp.stack([rr.reshape(-1), cc.reshape(-1)], axis=-1)
    return pts, valid, rc


def voxel_downsample(points: jax.Array, valid: jax.Array, voxel: float,
                     n_out: int, min_points_per_voxel: int = 1,
                     point_weight: jax.Array | None = None):
    """Voxel-grid downsample: one centroid per occupied voxel.

    Hash-scatter binning (Utils::pointcloudDownsample semantics including the
    min-points-per-voxel gate).  ``point_weight``: optional per-point
    confidence — the voxel inherits the mean weight of its points (the α
    channel the weighted RANSAC consumes, WeightedSACModelPlane.hpp:21-49).
    Returns (centroids (n_out, 3), valid (n_out,)) or, with weights,
    (centroids, valid, weights (n_out,)).
    """
    n = points.shape[0]
    # integer voxel coords; hash into a table ~4x the output capacity
    table = 4 * n_out
    key = jnp.floor(points / voxel).astype(jnp.int32)
    h = (
        key[:, 0] * 73856093 ^ key[:, 1] * 19349663 ^ key[:, 2] * 83492791
    ) % table
    h = jnp.where(valid, h, table)  # invalid points into overflow bin
    sums = jnp.zeros((table + 1, 3), points.dtype).at[h].add(
        jnp.where(valid[:, None], points, 0.0)
    )
    counts = jnp.zeros((table + 1,), jnp.int32).at[h].add(
        valid.astype(jnp.int32)
    )
    occupied = counts[:table] >= min_points_per_voxel
    centroids = sums[:table] / jnp.maximum(counts[:table, None], 1)
    # compact the first n_out occupied voxels
    (idx,) = jnp.nonzero(occupied, size=n_out, fill_value=-1)
    ok = idx >= 0
    out_pts = centroids[jnp.maximum(idx, 0)]
    if point_weight is None:
        return out_pts, ok
    wsums = jnp.zeros((table + 1,), points.dtype).at[h].add(
        jnp.where(valid, point_weight, 0.0)
    )
    wmean = wsums[:table] / jnp.maximum(counts[:table], 1)
    return out_pts, ok, wmean[jnp.maximum(idx, 0)]


def remove_statistical_outliers(points: jax.Array, valid: jax.Array,
                                voxel: float = 0.15,
                                min_neighbors: int = 3):
    """Approximate statistical outlier removal: drop points in sparsely
    populated voxels (the reference's SOR with meanK/stddev — replaced by a
    density gate at similar granularity; Utils.cc:~270)."""
    n = points.shape[0]
    table = 2 * n
    key = jnp.floor(points / voxel).astype(jnp.int32)
    h = (
        key[:, 0] * 73856093 ^ key[:, 1] * 19349663 ^ key[:, 2] * 83492791
    ) % table
    h = jnp.where(valid, h, table)
    counts = jnp.zeros((table + 1,), jnp.int32).at[h].add(
        valid.astype(jnp.int32)
    )
    return valid & (counts[jnp.minimum(h, table - 1)] >= min_neighbors)


def transform_cloud(T: jax.Array, points: jax.Array) -> jax.Array:
    return lie.se3_apply(T, points)

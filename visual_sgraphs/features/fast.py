"""FAST-9/16 corner scoring as whole-image tensor ops.

Equivalent of the grid-celled FAST detection inside
``ORBextractor::ComputeKeyPointsOctTree`` (ORBextractor.cc:~460-560), but
instead of per-cell cv::FAST calls we score *every pixel at once*: 16 shifted
copies of the image give the Bresenham ring, min/max over the 16 cyclic
9-windows give the corner score — 100% element-wise work that XLA fuses
into a handful of passes.

Score definition: ``score(p) = max(min over some 9-arc of (ring - p),
min over some 9-arc of (p - ring))`` — the largest threshold t for which p is
still a FAST-9 corner, matching OpenCV's score semantics used by the
reference for NMS.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3 (row, col offsets), OpenCV ordering
RING_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9


def _shift2d(img: jax.Array, dr: int, dc: int) -> jax.Array:
    """Image shifted so out[r, c] = img[r+dr, c+dc] (edge padded)."""
    h, w = img.shape
    pad = jnp.pad(img, 3, mode="edge")
    return jax.lax.dynamic_slice(pad, (3 + dr, 3 + dc), (h, w))


def fast_score(img: jax.Array) -> jax.Array:
    """Per-pixel FAST-9 corner score (0 where not a corner at any t>0).

    ``img``: (H, W) float.  Border pixels (3px) score 0.
    """
    ring = jnp.stack([_shift2d(img, dr, dc) for dr, dc in RING_OFFSETS])
    diff = ring - img[None]  # (16, H, W)

    # min over each cyclic 9-window, then max over the 16 windows
    def arc_extreme(d):
        # windows w: positions w..w+8 (mod 16)
        mins = []
        for w in range(16):
            idx = [(w + i) % 16 for i in range(ARC_LEN)]
            mins.append(jnp.min(d[jnp.asarray(idx)], axis=0))
        return jnp.max(jnp.stack(mins), axis=0)

    score_bright = arc_extreme(diff)        # arc all brighter than p
    score_dark = arc_extreme(-diff)         # arc all darker than p
    score = jnp.maximum(score_bright, score_dark)
    score = jnp.maximum(score, 0.0)
    # zero the 3px border
    h, w = img.shape
    rows = jnp.arange(h)[:, None]
    cols = jnp.arange(w)[None, :]
    interior = (rows >= 3) & (rows < h - 3) & (cols >= 3) & (cols < w - 3)
    return jnp.where(interior, score, 0.0)


def nms3x3(score: jax.Array) -> jax.Array:
    """3x3 non-maximum suppression: keep score only at local maxima."""
    neigh = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= neigh, score, 0.0)

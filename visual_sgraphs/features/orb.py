"""ORB extractor: grid-distributed FAST + IC-angle + steered rBRIEF.

Batched redesign of ``ORBextractor::operator()``
(orb_slam3/src/ORBextractor.cc:1090-1170):

- the per-level feature budget follows the same geometric series over 8
  levels (ORBextractor.cc ctor);
- the sequential quadtree distribution (DistributeOctTree,
  ORBextractor.cc:562) becomes 3x3 NMS + per-cell top-2 + per-level global
  top-K — a deterministic, batched spatial-suppression scheme with the same
  intent (behavioral parity; validated by match recall / ATE, SURVEY §7.3);
- the dual FAST threshold (ini 20 / min 7) is preserved: global top-K keeps
  strong corners first, weak cells still contribute down to min_thresh;
- IC angle uses the same circular patch of radius 15 (IC_Angle,
  ORBextractor.cc:70-97);
- descriptors are steered BRIEF-256 sampled from the sigma-2-blurred level
  image.  The 256 point pairs are a *seeded Gaussian pattern* (classic rBRIEF
  construction), not a copy of OpenCV's learned table.

Everything runs per-level with static shapes; all keypoint tensors are fixed
capacity with validity masks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.features.fast import fast_score, nms3x3
from visual_sgraphs.features.pyramid import build_pyramid, gaussian_blur

PATCH_RADIUS = 15  # IC-angle circular patch (HALF_PATCH_SIZE in reference)
GATHER_RADIUS = 20  # descriptor sampling patch (covers rotated +-13 offsets)


@dataclasses.dataclass(frozen=True)
class OrbParams:
    n_features: int = 1000
    n_levels: int = 8
    scale: float = 1.2
    ini_thresh: float = 20.0
    min_thresh: float = 7.0
    cell_size: int = 32
    pattern_seed: int = 42


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set for one image (K = n_features)."""

    uv: jax.Array  # (K, 2) float32, level-0 pixel coords (x, y)
    response: jax.Array  # (K,) FAST score
    level: jax.Array  # (K,) int32 pyramid level
    angle: jax.Array  # (K,) radians
    valid: jax.Array  # (K,) bool
    desc: jax.Array  # (K, 32) uint8 packed 256-bit descriptors

    @property
    def count(self):
        return jnp.sum(self.valid.astype(jnp.int32))


def level_budgets(params: OrbParams) -> list[int]:
    """Geometric per-level feature budget (ORBextractor.cc ctor)."""
    inv = 1.0 / params.scale
    total = (1 - inv**params.n_levels) / (1 - inv)
    per0 = params.n_features * (1 - inv) / (1 - inv**params.n_levels)
    budgets = [int(round(per0 * inv**lv)) for lv in range(params.n_levels)]
    budgets[-1] = max(0, params.n_features - sum(budgets[:-1]))
    return budgets


def _brief_pattern(seed: int) -> np.ndarray:
    """(256, 4) int8 sampling offsets (x1, y1, x2, y2), Gaussian sigma=S/5."""
    rng = np.random.default_rng(seed)
    sigma = 31 / 5.0
    pts = rng.normal(0.0, sigma, size=(256, 4))
    return np.clip(np.round(pts), -13, 13).astype(np.int8)


def _circular_mask(radius: int) -> np.ndarray:
    ys, xs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    return (xs * xs + ys * ys) <= radius * radius


def _detect_level(score: jax.Array, budget: int, params: OrbParams):
    """Per-cell top-2 then global top-``budget`` keypoints on one level.

    Returns (rc (budget, 2) int32, resp (budget,), valid (budget,)).
    """
    h, w = score.shape
    cs = params.cell_size
    ncy, ncx = -(-h // cs), -(-w // cs)
    padded = jnp.pad(score, ((0, ncy * cs - h), (0, ncx * cs - w)))
    cells = padded.reshape(ncy, cs, ncx, cs).transpose(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, cs * cs)
    vals, idx = jax.lax.top_k(cells, 2)  # (C, 2)
    cell_ids = jnp.arange(ncy * ncx)
    cy, cx = cell_ids // ncx, cell_ids % ncx
    rr = cy[:, None] * cs + idx // cs
    cc = cx[:, None] * cs + idx % cs
    cand_r = rr.reshape(-1)
    cand_c = cc.reshape(-1)
    cand_v = vals.reshape(-1)
    k = min(budget, cand_v.shape[0])
    top_v, top_i = jax.lax.top_k(cand_v, k)
    rc = jnp.stack([cand_r[top_i], cand_c[top_i]], axis=-1).astype(jnp.int32)
    valid = top_v >= params.min_thresh
    if k < budget:  # tiny levels: pad to static budget
        pad = budget - k
        rc = jnp.concatenate([rc, jnp.zeros((pad, 2), jnp.int32)])
        top_v = jnp.concatenate([top_v, jnp.zeros((pad,), top_v.dtype)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)])
    return rc, top_v, valid


def _gather_patches(img: jax.Array, rc: jax.Array, radius: int) -> jax.Array:
    """(K, 2r+1, 2r+1) patches centered at rc, clamped to the image."""
    size = 2 * radius + 1
    h, w = img.shape
    if h < size or w < size:  # tiny top pyramid levels: edge-pad up
        img = jnp.pad(img, ((0, max(size - h, 0)), (0, max(size - w, 0))),
                      mode="edge")
        h, w = img.shape
    r0 = jnp.clip(rc[:, 0] - radius, 0, h - size)
    c0 = jnp.clip(rc[:, 1] - radius, 0, w - size)
    return jax.vmap(
        lambda r, c: jax.lax.dynamic_slice(img, (r, c), (size, size))
    )(r0, c0)


def _ic_constants():
    """Host-side numpy constants for the IC-angle moments (safe to close
    over inside jit — never cache traced arrays in module globals)."""
    mask = _circular_mask(PATCH_RADIUS)
    ys, xs = np.mgrid[-PATCH_RADIUS : PATCH_RADIUS + 1,
                      -PATCH_RADIUS : PATCH_RADIUS + 1]
    return (np.asarray(xs * mask, np.float32),
            np.asarray(ys * mask, np.float32))


_IC_XS, _IC_YS = _ic_constants()


def _ic_angle(patches: jax.Array) -> jax.Array:
    """Intensity-centroid angle over the circular radius-15 patch
    (IC_Angle, ORBextractor.cc:70-97).  ``patches``: (K, 41, 41) — the
    central 31x31 region is used."""
    d = GATHER_RADIUS - PATCH_RADIUS
    sz = 2 * PATCH_RADIUS + 1
    central = patches[:, d : d + sz, d : d + sz]
    m10 = jnp.sum(central * jnp.asarray(_IC_XS), axis=(-2, -1))
    m01 = jnp.sum(central * jnp.asarray(_IC_YS), axis=(-2, -1))
    return jnp.arctan2(m01, m10)


def _steered_brief(
    patches: jax.Array, angles: jax.Array, pattern: jax.Array
) -> jax.Array:
    """Packed 256-bit descriptors from rotated pattern samples.

    ``patches``: (K, 41, 41) blurred; ``pattern``: (256, 4) offsets.
    Nearest-neighbour sampling of the rotated pattern, like the reference's
    GET_VALUE macro (ORBextractor.cc:computeOrbDescriptor).
    """
    ca, sa = jnp.cos(angles), jnp.sin(angles)  # (K,)
    px1, py1, px2, py2 = (pattern[:, 0], pattern[:, 1], pattern[:, 2],
                          pattern[:, 3])

    def rot_rc(px, py):
        # rotate (x, y) by angle; convert to (row, col) patch indices
        x = ca[:, None] * px[None, :] - sa[:, None] * py[None, :]
        y = sa[:, None] * px[None, :] + ca[:, None] * py[None, :]
        r = jnp.clip(jnp.round(y) + GATHER_RADIUS, 0, 2 * GATHER_RADIUS)
        c = jnp.clip(jnp.round(x) + GATHER_RADIUS, 0, 2 * GATHER_RADIUS)
        return r.astype(jnp.int32), c.astype(jnp.int32)

    r1, c1 = rot_rc(px1, py1)
    r2, c2 = rot_rc(px2, py2)
    flat = patches.reshape(patches.shape[0], -1)  # (K, 41*41)
    wdt = 2 * GATHER_RADIUS + 1
    v1 = jnp.take_along_axis(flat, r1 * wdt + c1, axis=1)
    v2 = jnp.take_along_axis(flat, r2 * wdt + c2, axis=1)
    bits = (v1 < v2).astype(jnp.uint8)  # (K, 256)
    weights = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8)
    return jnp.sum(bits.reshape(-1, 32, 8) * weights[None, None, :], axis=-1,
                   dtype=jnp.uint8)


def extract_orb(img: jax.Array, params: OrbParams = OrbParams()) -> Keypoints:
    """Full ORB extraction on a grayscale image (H, W) float32 [0, 255].

    Static output capacity ``params.n_features`` with a validity mask —
    the per-frame hot path of the whole system (SURVEY §3 hot loop #1).
    """
    pattern = jnp.asarray(_brief_pattern(params.pattern_seed), jnp.float32)
    levels = build_pyramid(img, params.n_levels, params.scale)
    budgets = level_budgets(params)

    all_uv, all_resp, all_level, all_angle, all_valid, all_desc = (
        [], [], [], [], [], []
    )
    for lv, (level_img, budget) in enumerate(zip(levels, budgets)):
        if budget <= 0:
            continue
        score = nms3x3(fast_score(level_img))
        rc, resp, valid = _detect_level(score, budget, params)
        blurred = gaussian_blur(level_img)
        patches = _gather_patches(blurred, rc, GATHER_RADIUS)
        angle = _ic_angle(patches)
        desc = _steered_brief(patches, angle, pattern)
        scale_f = params.scale**lv
        uv = jnp.stack(
            [rc[:, 1].astype(jnp.float32), rc[:, 0].astype(jnp.float32)],
            axis=-1,
        ) * scale_f
        all_uv.append(uv)
        all_resp.append(resp)
        all_level.append(jnp.full((budget,), lv, jnp.int32))
        all_angle.append(angle)
        all_valid.append(valid)
        all_desc.append(desc)

    return Keypoints(
        uv=jnp.concatenate(all_uv),
        response=jnp.concatenate(all_resp),
        level=jnp.concatenate(all_level),
        angle=jnp.concatenate(all_angle),
        valid=jnp.concatenate(all_valid),
        desc=jnp.concatenate(all_desc),
    )

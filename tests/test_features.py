"""Tests for the ORB feature pipeline: FAST, extraction, matching."""

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.features import (
    OrbParams,
    extract_orb,
    fast_score,
    hamming_matrix,
    match_nn_ratio,
    match_window,
)
from visual_sgraphs.features.orb import level_budgets


def square_grid(h=96, w=128, sq=10, pitch=24):
    """Isolated bright squares on dark ground — square corners are FAST-9
    corners (a 12-pixel dark arc), unlike checkerboard intersections."""
    img = np.full((h, w), 20.0, np.float32)
    for r in range(8, h - sq - 8, pitch):
        for c in range(8, w - sq - 8, pitch):
            img[r : r + sq, c : c + sq] = 220.0
    return img


def textured_image(rng, h=240, w=320, n_blobs=60):
    """Random blobby texture with reproducible corners."""
    img = np.full((h, w), 120.0, np.float32)
    for _ in range(n_blobs):
        r, c = rng.integers(20, h - 20), rng.integers(20, w - 20)
        sz = rng.integers(4, 12)
        img[r : r + sz, c : c + sz] += rng.uniform(-90, 90)
    # per-pixel noise: perfectly flat patches make BRIEF comparisons of
    # exactly-equal values, which flip arbitrarily under float reassociation
    img += rng.uniform(-3, 3, size=img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


def test_fast_detects_corners():
    img = jnp.asarray(square_grid())
    score = np.asarray(fast_score(img))
    assert score[12, 12] == 0.0  # flat interior of a square
    strong = score > 20
    assert strong.sum() >= 4  # square corners respond
    # every strong response sits within 2px of a square corner
    corners = [(r + dr, c + dc)
               for r in range(8, 96 - 18, 24) for c in range(8, 128 - 18, 24)
               for dr in (0, 9) for dc in (0, 9)]
    ys, xs = np.nonzero(strong)
    for y, x in zip(ys, xs):
        assert min(abs(y - r) + abs(x - c) for r, c in corners) <= 2


def test_fast_uniform_image_zero():
    img = jnp.full((64, 64), 100.0)
    assert float(fast_score(img).max()) == 0.0


def test_level_budgets_sum():
    p = OrbParams(n_features=1000)
    b = level_budgets(p)
    assert sum(b) == 1000
    assert all(x >= 0 for x in b)
    assert b[0] > b[1] > b[-1]


def test_extract_orb_basic(rng):
    img = jnp.asarray(textured_image(rng))
    p = OrbParams(n_features=500)
    kp = extract_orb(img, p)
    n = int(kp.count)
    assert kp.uv.shape == (500, 2)
    assert kp.desc.shape == (500, 32)
    assert n > 100  # textured image yields plenty of corners
    uv = np.asarray(kp.uv)[np.asarray(kp.valid)]
    assert uv[:, 0].max() < 320 and uv[:, 1].max() < 240
    # descriptors vary between keypoints
    d = np.asarray(kp.desc)[np.asarray(kp.valid)]
    assert len(np.unique(d, axis=0)) > 0.5 * n


def test_orb_match_under_shift(rng):
    """Features must re-match between an image and its translated copy."""
    base = textured_image(rng, h=256, w=320)
    shifted = np.roll(base, (7, 13), axis=(0, 1))
    p = OrbParams(n_features=400)
    kp1 = extract_orb(jnp.asarray(base), p)
    kp2 = extract_orb(jnp.asarray(shifted), p)
    matches, dist = match_nn_ratio(
        kp1.desc, kp1.valid, kp2.desc, kp2.valid,
        angle_a=kp1.angle, angle_b=kp2.angle,
    )
    m = np.asarray(matches)
    good = m >= 0
    assert good.sum() > 50
    # matched displacement must equal the known shift for the vast majority
    duv = np.asarray(kp2.uv)[m[good]] - np.asarray(kp1.uv)[good]
    err = np.abs(duv - np.array([13, 7])).max(axis=1)
    assert (err < 2.0).mean() > 0.8


def test_orb_match_under_rotation(rng):
    """Steered BRIEF must survive an in-plane rotation (90 deg exact)."""
    base = textured_image(rng, h=256, w=256)
    rot = np.rot90(base).copy()
    p = OrbParams(n_features=400)
    kp1 = extract_orb(jnp.asarray(base), p)
    kp2 = extract_orb(jnp.asarray(rot), p)
    matches, _ = match_nn_ratio(
        kp1.desc, kp1.valid, kp2.desc, kp2.valid,
        angle_a=kp1.angle, angle_b=kp2.angle,
    )
    m = np.asarray(matches)
    good = m >= 0
    assert good.sum() > 40
    # rot90: (x, y) -> (y, H-1-x) for counterclockwise numpy rot90
    uv1 = np.asarray(kp1.uv)[good]
    uv2 = np.asarray(kp2.uv)[m[good]]
    pred = np.stack([uv1[:, 1], 256 - 1 - uv1[:, 0]], axis=1)
    err = np.abs(uv2 - pred).max(axis=1)
    assert (err < 3.0).mean() > 0.7


def test_hamming_matrix_exact():
    a = jnp.asarray([[0xFF] + [0] * 31, [0x0F] + [0] * 31], jnp.uint8)
    b = jnp.asarray([[0xFF] + [0] * 31, [0] * 32], jnp.uint8)
    d = np.asarray(hamming_matrix(a, b))
    assert d[0, 0] == 0 and d[0, 1] == 8
    assert d[1, 0] == 4 and d[1, 1] == 4


def test_match_window_restricts(rng):
    n = 64
    desc = jnp.asarray(rng.integers(0, 256, size=(n, 32)), jnp.uint8)
    uv = jnp.asarray(rng.uniform(0, 300, size=(n, 2)), jnp.float32)
    valid = jnp.ones(n, bool)
    # same descriptors, same predicted positions: identity matching
    matches, dist = match_window(desc, uv, valid, desc, uv, valid, radius=5.0)
    np.testing.assert_array_equal(np.asarray(matches), np.arange(n))
    # zero radius off-position: no matches
    matches2, _ = match_window(desc, uv + 50.0, valid, desc, uv, valid,
                               radius=5.0)
    assert (np.asarray(matches2) == -1).all()


def test_extract_jit_consistency(rng):
    img = jnp.asarray(textured_image(rng))
    p = OrbParams(n_features=300)
    kp_eager = extract_orb(img, p)
    kp_jit = jax.jit(lambda im: extract_orb(im, p))(img)
    np.testing.assert_allclose(np.asarray(kp_eager.uv),
                               np.asarray(kp_jit.uv), atol=1e-5)
    # eager/jit fusion reorders float reductions, which may flip BRIEF bits
    # at near-tie comparisons — require near-identical descriptors, not
    # bit-exact ones
    d = hamming_matrix(kp_eager.desc, kp_jit.desc)
    self_d = np.asarray(jnp.diagonal(d))[np.asarray(kp_eager.valid)]
    # a handful of keypoints sit at angle near-ties where a tiny float diff
    # rotates the whole sampling pattern — judge the bulk, not the tail
    assert np.median(self_d) == 0
    assert self_d.mean() < 16.0
    assert (self_d <= 2).mean() > 0.75

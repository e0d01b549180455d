"""Batched binary-descriptor matching (the ORBmatcher replacement).

The reference's ``ORBmatcher`` (orb_slam3/src/ORBmatcher.cc, 2.1k LoC) walks
per-feature candidate lists with early-outs; here every variant is one dense
masked reduction:

- ``hamming_matrix``: all-pairs Hamming distance.  Descriptors are unpacked
  to {0,1} and fed to one float matmul (exact: {0,1} products summed in
  float32):
  ``d(a, b) = popcount(a) + popcount(b) - 2 * <bits_a, bits_b>``.
- ``match_nn_ratio``: brute-force NN with Lowe ratio + mutual-best +
  rotation-histogram consistency (SearchByBoW / SearchForInitialization
  semantics).
- ``match_window``: NN restricted to a projection window and pyramid-level
  band (SearchByProjection semantics).

All functions take validity masks and fixed-capacity inputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TH_LOW = 50  # reference ORBmatcher::TH_LOW
TH_HIGH = 100  # reference ORBmatcher::TH_HIGH
HISTO_BINS = 30


def unpack_bits(desc: jax.Array) -> jax.Array:
    """(N, 32) uint8 -> (N, 256) float32 in {0, 1}."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(desc.shape[0], 256).astype(jnp.float32)


def hamming_matrix(desc_a: jax.Array, desc_b: jax.Array) -> jax.Array:
    """(Na, Nb) int32 Hamming distances via one matmul."""
    a = unpack_bits(desc_a)
    b = unpack_bits(desc_b)
    pa = jnp.sum(a, axis=1, keepdims=True)
    pb = jnp.sum(b, axis=1, keepdims=True)
    inner = jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    return (pa + pb.T - 2.0 * inner).astype(jnp.int32)


def _rotation_consistency(angle_a, angle_b, matches, ok):
    """Keep only matches whose angle difference falls in the 3 most popular
    of 30 histogram bins (ORBmatcher.cc rotation histogram)."""
    da = angle_a - angle_b[jnp.clip(matches, 0, angle_b.shape[0] - 1)]
    bins = jnp.floor(
        (da % (2 * jnp.pi)) / (2 * jnp.pi) * HISTO_BINS
    ).astype(jnp.int32) % HISTO_BINS
    counts = jnp.zeros(HISTO_BINS, jnp.int32).at[bins].add(ok.astype(jnp.int32))
    top3 = jax.lax.top_k(counts, 3)[0]
    thresh = top3[2]
    keep_bin = counts[bins] >= jnp.maximum(thresh, 1)
    return ok & keep_bin


def match_nn_ratio(
    desc_a,
    valid_a,
    desc_b,
    valid_b,
    ratio: float = 0.75,
    max_dist: int = TH_LOW,
    angle_a=None,
    angle_b=None,
    mutual: bool = True,
    pair_mask=None,
):
    """Brute-force nearest neighbour with Lowe ratio test.

    ``pair_mask``: optional (Na, Nb) bool — candidate pairs outside the
    mask are excluded from the search entirely (the reference's epipolar-
    band restriction in SearchForTriangulation, ORBmatcher.h:72: the NN
    search runs over the admissible band, so a better-scoring wrong match
    elsewhere cannot shadow the true correspondence).
    Returns (matches (Na,) int32 — index into b or -1, dist (Na,) int32).
    """
    BIG = 10_000
    d = hamming_matrix(desc_a, desc_b)
    d = jnp.where(valid_b[None, :], d, BIG)
    d = jnp.where(valid_a[:, None], d, BIG)
    if pair_mask is not None:
        d = jnp.where(pair_mask, d, BIG)
    neg = -d
    best2, idx2 = jax.lax.top_k(neg, 2)
    best, second = -best2[:, 0], -best2[:, 1]
    nn = idx2[:, 0]
    ok = (best <= max_dist) & (best.astype(jnp.float32)
                               <= ratio * second.astype(jnp.float32))
    ok = ok & valid_a
    if mutual:
        back = jnp.argmin(jnp.where(valid_a[:, None], d, BIG).T, axis=1)  # (Nb,)
        ok = ok & (back[nn] == jnp.arange(desc_a.shape[0]))
    if angle_a is not None and angle_b is not None:
        ok = _rotation_consistency(angle_a, angle_b, nn, ok)
    return jnp.where(ok, nn, -1), jnp.where(ok, best, BIG)


def match_window(
    desc_a,
    uv_pred_a,
    valid_a,
    desc_b,
    uv_b,
    valid_b,
    radius: float,
    level_a=None,
    level_b=None,
    level_slack: int = 1,
    ratio: float = 0.9,
    max_dist: int = TH_HIGH,
):
    """NN matching restricted to a spatial window around predicted positions
    (SearchByProjection: a's features carry predicted pixel locations in b's
    image; candidates are b's keypoints within ``radius`` px and within
    ``level_slack`` pyramid levels).

    Returns (matches (Na,) int32 into b or -1, dist (Na,)).
    """
    BIG = 10_000
    d = hamming_matrix(desc_a, desc_b)
    du = uv_pred_a[:, None, 0] - uv_b[None, :, 0]
    dv = uv_pred_a[:, None, 1] - uv_b[None, :, 1]
    in_win = (du * du + dv * dv) <= radius * radius
    mask = in_win & valid_a[:, None] & valid_b[None, :]
    if level_a is not None and level_b is not None:
        dl = jnp.abs(level_a[:, None] - level_b[None, :])
        mask = mask & (dl <= level_slack)
    d = jnp.where(mask, d, BIG)
    best2, idx2 = jax.lax.top_k(-d, 2)
    best, second = -best2[:, 0], -best2[:, 1]
    nn = idx2[:, 0]
    ok = (best <= max_dist) & (
        best.astype(jnp.float32) <= ratio * second.astype(jnp.float32)
    )
    # resolve duplicate targets: keep the lowest-distance claimant
    n_b = desc_b.shape[0]
    claimed_best = jnp.full((n_b,), BIG, best.dtype).at[
        jnp.where(ok, nn, n_b - 1)
    ].min(jnp.where(ok, best, BIG))
    ok = ok & (best <= claimed_best[nn])
    return jnp.where(ok, nn, -1), jnp.where(ok, best, BIG)

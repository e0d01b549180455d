"""Keyframe place-recognition database (the KeyFrameDatabase replacement).

The reference keeps a DBoW2 inverted file (word -> keyframe list) and walks
it with per-word accumulators (orb_slam3/src/KeyFrameDatabase.cc:33-41,
DetectNBestCandidates).  Fixed-capacity design: the database is a dense
(Kmax, W) float32 BoW matrix; a query is ONE L1-overlap reduction

    score(q, k) = sum_w min(q_w, bow[k, w])

over all keyframes at once — dense instead of pointer chasing.
At Kmax=512, W=4096 the table is 8 MB of device memory.

Candidate gating mirrors DetectNBestCandidates: exclude the query's
covisibility neighbourhood, require a minimum shared-word count, and keep
candidates above ``min_score_ratio`` x the best covisible score.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class PlaceDB(NamedTuple):
    bow: jax.Array  # (Kmax, W) float32 L1-normalized tf-idf
    has_word: jax.Array  # (Kmax, W) bool occupancy (for common-word counts)
    valid: jax.Array  # (Kmax,) bool


def empty_db(max_keyframes: int, n_words: int) -> PlaceDB:
    return PlaceDB(
        bow=jnp.zeros((max_keyframes, n_words), jnp.float32),
        has_word=jnp.zeros((max_keyframes, n_words), bool),
        valid=jnp.zeros((max_keyframes,), bool),
    )


@jax.jit
def add_keyframe(db: PlaceDB, kf_id: jax.Array, bow: jax.Array) -> PlaceDB:
    return PlaceDB(
        bow=db.bow.at[kf_id].set(bow),
        has_word=db.has_word.at[kf_id].set(bow > 0),
        valid=db.valid.at[kf_id].set(True),
    )


@jax.jit
def remove_keyframe(db: PlaceDB, kf_id: jax.Array) -> PlaceDB:
    return db._replace(valid=db.valid.at[kf_id].set(False))


@jax.jit
def build_db(bows: jax.Array, valid: jax.Array) -> PlaceDB:
    """Whole-database (re)build in ONE dispatch: ``bows`` (Kmax, W) stacked
    BoW rows, ``valid`` (Kmax,) slot occupancy.  Replaces the per-keyframe
    ``add_keyframe`` host loop of a vocabulary (re)train or Atlas-merge
    backfill (KeyFrameDatabase.cc:33-41 rebuilds its inverted file KF by
    KF; dense rows make the whole thing a masked write)."""
    bows = jnp.where(valid[:, None], bows, 0.0)
    return PlaceDB(bow=bows, has_word=bows > 0, valid=valid)


@jax.jit
def l1_scores(db: PlaceDB, query_bow: jax.Array) -> jax.Array:
    """(Kmax,) DBoW2 L1 similarity of the query against every stored KF:
    s = 2*sum min(q, v) (monotone in sum-min; the 2x is dropped)."""
    s = jnp.sum(jnp.minimum(db.bow, query_bow[None, :]), axis=1)
    return jnp.where(db.valid, s, 0.0)


@partial(jax.jit, static_argnames=("top_n",))
def detect_candidates(
    db: PlaceDB,
    query_bow: jax.Array,
    exclude: jax.Array,
    min_common_ratio: float = 0.8,
    top_n: int = 3,
):
    """Loop/merge/reloc candidate retrieval (DetectNBestCandidates,
    KeyFrameDatabase.h:68-76).

    ``exclude``: (Kmax,) bool — the query's covisible neighbourhood plus
    recency window.  Keeps KFs sharing >= min_common_ratio x the maximum
    shared-word count, scores them by L1 overlap, returns
    (ids (top_n,), scores (top_n,)); empty slots are id -1 / score 0.
    """
    q_words = query_bow > 0
    common = jnp.sum(db.has_word & q_words[None, :], axis=1)
    common = jnp.where(db.valid & ~exclude, common, 0)
    max_common = jnp.max(common)
    ok = common >= jnp.maximum(
        (min_common_ratio * max_common).astype(common.dtype), 1
    )
    scores = jnp.where(ok, l1_scores(db, query_bow), 0.0)
    top_scores, top_ids = jax.lax.top_k(scores, top_n)
    good = top_scores > 0
    return jnp.where(good, top_ids, -1), top_scores


@jax.jit
def best_covisible_score(db: PlaceDB, query_bow: jax.Array,
                         covis: jax.Array) -> jax.Array:
    """Minimum-acceptance reference score: the best BoW score within the
    query's own covisible neighbourhood (the reference computes minScore
    over covisible KFs before querying, LoopClosing.cc:NewDetectCommonRegions
    via DetectNBestCandidates' covisibility gating)."""
    s = l1_scores(db, query_bow)
    return jnp.max(jnp.where(covis, s, 0.0))

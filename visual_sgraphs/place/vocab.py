"""Binary bag-of-words vocabulary: DBoW2's TemplatedVocabulary, in JAX.

The reference loads a pre-trained k-means tree of ORB descriptors and walks
it per descriptor with scalar Hamming comparisons
(Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1478 loadFromBinFile,
``transform`` descent).  Here the tree is a stack of per-level center tables
and the descent over *all* descriptors of a frame happens as L batched
gather + popcount-argmin steps — no per-descriptor control flow, one fused
program.

Training (``fit_vocab``) is host-side binary k-majority clustering (numpy):
vocabularies are built once per sensor domain from sampled descriptors, the
same workflow as DBoW2's offline k-means training.  A trained tree is a
small pytree that serializes with ``numpy.savez``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class VocabTree(NamedTuple):
    """K-ary tree of binary centers.

    ``centers[l]`` has shape (K**(l+1), 32) uint8: the children of node ``n``
    of level ``l-1`` are rows ``n*K + c``.  ``idf`` has shape (W,) float32
    with W = K**levels words (the leaves).
    """

    centers: tuple[jax.Array, ...]
    idf: jax.Array

    @property
    def branching(self) -> int:
        return self.centers[0].shape[0]

    @property
    def n_words(self) -> int:
        return self.idf.shape[0]


# ------------------------------------------------------------------ training


def _popcount_np(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x, axis=-1).sum(-1)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(Na, Nb) Hamming distances between uint8 descriptor rows."""
    return _popcount_np(a[:, None, :] ^ b[None, :, :])


def _kmajority(desc: np.ndarray, k: int, rng: np.random.Generator,
               iters: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Binary k-means ("k-majority"): centers are per-bit majority votes.

    Returns (centers (k, 32) uint8, assignment (N,) int)."""
    n = desc.shape[0]
    if n == 0:
        return rng.integers(0, 256, (k, 32), dtype=np.uint8), np.zeros(0, int)
    centers = desc[rng.choice(n, size=min(k, n), replace=False)]
    if centers.shape[0] < k:  # pad with random picks (duplicates are fine)
        centers = np.concatenate(
            [centers, desc[rng.integers(0, n, k - centers.shape[0])]]
        )
    assign = np.zeros(n, int)
    for _ in range(iters):
        d = _hamming_np(desc, centers)
        assign = d.argmin(1)
        bits = np.unpackbits(desc, axis=1)  # (N, 256)
        for c in range(k):
            sel = bits[assign == c]
            if sel.shape[0] == 0:
                centers[c] = desc[rng.integers(0, n)]
            else:
                maj = (sel.mean(0) >= 0.5).astype(np.uint8)
                centers[c] = np.packbits(maj)
    return centers, assign


def fit_vocab(desc: np.ndarray, branching: int = 8, levels: int = 4,
              seed: int = 0) -> VocabTree:
    """Train a branching**levels-word vocabulary from (N, 32) uint8 ORB
    descriptors (the offline half of DBoW2's k-means tree)."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(desc, np.uint8)
    K = branching
    level_centers: list[np.ndarray] = []
    # groups[l][node] = descriptor subset for that node
    groups = [desc]
    for lvl in range(levels):
        centers = np.zeros((K ** (lvl + 1), 32), np.uint8)
        next_groups: list[np.ndarray] = []
        for node, g in enumerate(groups):
            c, a = _kmajority(g, K, rng)
            centers[node * K:(node + 1) * K] = c
            for ch in range(K):
                next_groups.append(g[a == ch] if g.shape[0] else g)
        level_centers.append(centers)
        groups = next_groups
    # idf from training occupancy: rare words are informative
    # (DBoW2 TF_IDF weighting)
    counts = np.array([max(g.shape[0], 1) for g in groups], np.float64)
    idf = np.log(desc.shape[0] / counts).astype(np.float32)
    idf = np.maximum(idf, 0.0)
    return VocabTree(
        centers=tuple(jnp.asarray(c) for c in level_centers),
        idf=jnp.asarray(idf),
    )


def save_vocab(tree: VocabTree, path: str) -> None:
    np.savez(
        path,
        idf=np.asarray(tree.idf),
        n_levels=len(tree.centers),
        **{f"level_{i}": np.asarray(c) for i, c in enumerate(tree.centers)},
    )


def load_vocab(path: str) -> VocabTree:
    z = np.load(path)
    n = int(z["n_levels"])
    return VocabTree(
        centers=tuple(jnp.asarray(z[f"level_{i}"]) for i in range(n)),
        idf=jnp.asarray(z["idf"]),
    )


# ------------------------------------------------------------------- descent


def descend(tree: VocabTree, desc: jax.Array) -> jax.Array:
    """(N, 32) uint8 descriptors -> (N,) int32 word ids.

    Batched tree walk: at each level gather the K child centers of every
    descriptor's current node and take the Hamming argmin.  The whole
    vocabulary transform of a frame is L gathers + popcounts (DBoW2 walks
    node-by-node per descriptor, TemplatedVocabulary.h ``transform``).
    """
    K = tree.branching
    node = jnp.zeros(desc.shape[0], jnp.int32)
    for C in tree.centers:
        child_idx = node[:, None] * K + jnp.arange(K, dtype=jnp.int32)[None]
        children = C[child_idx]  # (N, K, 32)
        ham = jnp.sum(
            jnp.bitwise_count(children ^ desc[:, None, :]).astype(jnp.int32),
            axis=-1,
        )
        node = child_idx[jnp.arange(desc.shape[0]), jnp.argmin(ham, axis=1)]
    return node


def bow_vector(tree: VocabTree, desc: jax.Array,
               valid: jax.Array) -> jax.Array:
    """L1-normalized tf-idf bag-of-words vector (W,) float32 for one frame's
    descriptor set (BowVector of DBoW2, L1-normed as in TF_IDF scoring)."""
    words = descend(tree, desc)
    W = tree.n_words
    tf = jnp.zeros((W,), jnp.float32).at[
        jnp.where(valid, words, 0)
    ].add(valid.astype(jnp.float32))
    v = tf * tree.idf
    return v / jnp.maximum(jnp.sum(v), 1e-12)

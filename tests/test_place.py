"""Place recognition: vocabulary, database, Sim3 RANSAC, pose-graph, loop
closing end-to-end on a synthetic drifting loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from visual_sgraphs.core import lie
from visual_sgraphs.place import (
    add_keyframe,
    bow_vector,
    descend,
    detect_candidates,
    empty_db,
    fit_vocab,
    optimize_essential_graph,
    ransac_sim3,
)
from visual_sgraphs.place.pgo import EssentialEdges, correct_map


def _random_desc(rng, n):
    return rng.integers(0, 256, size=(n, 32), dtype=np.uint8)


def _perturb_desc(rng, desc, n_bits=8):
    """Flip n_bits random bits per descriptor (viewpoint noise)."""
    out = desc.copy()
    for i in range(out.shape[0]):
        for b in rng.integers(0, 256, size=n_bits):
            out[i, b // 8] ^= np.uint8(1 << (b % 8))
    return out


class TestVocab:
    def test_descend_deterministic_and_in_range(self, rng):
        train = _random_desc(rng, 2000)
        tree = fit_vocab(train, branching=4, levels=3)
        words = np.asarray(descend(tree, jnp.asarray(train[:100])))
        assert words.min() >= 0 and words.max() < 4**3
        again = np.asarray(descend(tree, jnp.asarray(train[:100])))
        np.testing.assert_array_equal(words, again)

    def test_similar_descriptors_share_words(self, rng):
        train = _random_desc(rng, 4000)
        tree = fit_vocab(train, branching=4, levels=3)
        base = train[:200]
        noisy = _perturb_desc(rng, base, n_bits=4)
        w_base = np.asarray(descend(tree, jnp.asarray(base)))
        w_noisy = np.asarray(descend(tree, jnp.asarray(noisy)))
        # small perturbations mostly keep the word assignment
        assert (w_base == w_noisy).mean() > 0.5

    def test_bow_self_similarity(self, rng):
        train = _random_desc(rng, 8000)
        tree = fit_vocab(train, branching=8, levels=3)
        a = train[:100]
        a_noisy = _perturb_desc(rng, a, n_bits=4)
        b = _random_desc(rng, 100)
        valid = jnp.ones(100, bool)
        va = bow_vector(tree, jnp.asarray(a), valid)
        van = bow_vector(tree, jnp.asarray(a_noisy), valid)
        vb = bow_vector(tree, jnp.asarray(b), valid)
        s_same = float(jnp.sum(jnp.minimum(va, van)))
        s_diff = float(jnp.sum(jnp.minimum(va, vb)))
        assert s_same > 2.0 * s_diff


class TestDatabase:
    def test_query_finds_revisit(self, rng):
        train = _random_desc(rng, 4000)
        tree = fit_vocab(train, branching=4, levels=3)
        valid = jnp.ones(200, bool)
        db = empty_db(16, tree.n_words)
        frames = [_random_desc(rng, 200) for _ in range(8)]
        for k, d in enumerate(frames):
            db = add_keyframe(db, jnp.asarray(k),
                              bow_vector(tree, jnp.asarray(d), valid))
        # query = noisy view of frame 2
        q = bow_vector(
            tree, jnp.asarray(_perturb_desc(rng, frames[2], 4)), valid
        )
        exclude = jnp.zeros(16, bool)
        ids, scores = detect_candidates(db, q, exclude, top_n=3)
        assert int(ids[0]) == 2
        assert float(scores[0]) > 0


class TestSim3Ransac:
    def test_recovers_known_sim3_with_outliers(self, rng):
        M = 200
        p_a = jnp.asarray(rng.normal(size=(M, 3)) * 2.0)
        S_true = lie.sim3_from_rts(
            lie.quat_normalize(jnp.asarray([0.9, 0.1, -0.2, 0.3])),
            jnp.asarray([1.0, -2.0, 0.5]),
            jnp.asarray(1.3),
        )
        p_b = lie.sim3_apply(S_true, p_a)
        # 30% outliers
        n_out = M // 3
        p_b = p_b.at[:n_out].add(
            jnp.asarray(rng.normal(size=(n_out, 3)) * 3.0 + 5.0)
        )
        valid = jnp.ones(M, bool)
        res = ransac_sim3(p_a, p_b, valid, jax.random.PRNGKey(0),
                          inlier_thresh=0.05)
        assert int(res.n_inliers) >= M - n_out - 5
        err = lie.sim3_apply(res.S_ab, p_a[n_out:]) - p_b[n_out:]
        assert float(jnp.max(jnp.linalg.norm(err, axis=-1))) < 0.05

    def test_fix_scale(self, rng):
        M = 100
        p_a = jnp.asarray(rng.normal(size=(M, 3)))
        T = lie.se3_exp(jnp.asarray([0.1, -0.2, 0.3, 0.5, -0.1, 0.2]))
        p_b = lie.se3_apply(T, p_a)
        res = ransac_sim3(p_a, p_b, jnp.ones(M, bool), jax.random.PRNGKey(1),
                          inlier_thresh=0.02, fix_scale=True)
        assert abs(float(res.S_ab[7]) - 1.0) < 1e-5
        assert int(res.n_inliers) > M - 5


class TestEssentialGraph:
    def test_loop_edge_removes_drift(self, rng):
        """Keyframes on a circle with accumulated odometry drift: the loop
        edge between last and first KF should pull the chain closed."""
        K = 32
        # ground-truth poses on a circle
        angles = np.linspace(0, 2 * np.pi, K, endpoint=False)
        gt = []
        for a in angles:
            t = jnp.asarray([np.cos(a) * 5, np.sin(a) * 5, 0.0], jnp.float64)
            q = lie.quat_normalize(
                jnp.asarray([np.cos(a / 2), 0, 0, np.sin(a / 2)], jnp.float64)
            )
            gt.append(lie.se3_from_rt(q, t))
        gt = jnp.stack(gt)

        # drifted chain: integrate noisy relative poses
        drift = [gt[0]]
        for i in range(1, K):
            rel = lie.se3_multiply(gt[i], lie.se3_inverse(gt[i - 1]))
            noise = lie.se3_exp(
                jnp.asarray(rng.normal(size=6) * 0.01, jnp.float64)
            )
            drift.append(
                lie.se3_normalize(
                    lie.se3_multiply(lie.se3_multiply(noise, rel), drift[-1])
                )
            )
        drift = jnp.stack(drift)

        # edges: consecutive only, measured from the drifted chain itself
        ei = jnp.arange(K - 1, dtype=jnp.int32)
        edges = EssentialEdges(
            idx=jnp.stack([ei, ei + 1], axis=1),
            valid=jnp.ones(K - 1, bool),
        )
        # loop edge: true relative Sim3 between KF0 and KF K-1
        S0 = lie.sim3_from_se3(gt[0])
        SK = lie.sim3_from_se3(gt[K - 1])
        S_loop = lie.sim3_multiply(SK, lie.sim3_inverse(S0))

        fixed = jnp.zeros(K, bool).at[0].set(True)
        res = optimize_essential_graph(
            drift, jnp.ones(K, bool), edges,
            loop_i=jnp.asarray(0), loop_j=jnp.asarray(K - 1),
            S_loop_ji=S_loop, fixed=fixed, iters=30,
        )
        # endpoint error before/after
        def endpoint_err(poses):
            rel = lie.se3_multiply(poses[K - 1], lie.se3_inverse(poses[0]))
            rel_gt = lie.se3_multiply(gt[K - 1], lie.se3_inverse(gt[0]))
            return float(jnp.linalg.norm(
                lie.se3_log(lie.se3_multiply(rel, lie.se3_inverse(rel_gt)))
            ))

        assert res.cost < res.cost0
        assert endpoint_err(res.kf_pose) < 0.5 * endpoint_err(drift)


@pytest.mark.slow
class TestLoopClosingE2E:
    def test_loop_closes_on_synthetic_revisit(self):
        """RGB-D stream around a loop; verify a loop closure fires and the
        trajectory improves (LoopClosing::CorrectLoop end-to-end)."""
        from visual_sgraphs.config import (
            CapacityConfig,
            OrbConfig,
            PlaceConfig,
            Sensor,
            SystemConfig,
        )
        from visual_sgraphs.io.synthetic import SyntheticScene
        from visual_sgraphs.slam import SlamSystem

        from visual_sgraphs.core import geometry

        scene = SyntheticScene()  # 240x320: enough texture to stay locked
        cfg = SystemConfig(
            sensor=Sensor.RGBD,
            camera=scene.cam,
            orb=OrbConfig(n_features=512),
            capacity=CapacityConfig(max_keyframes=64, max_points=16384),
            loop_closing=True,
            place=PlaceConfig(
                vocab_min_keyframes=4, consistency=1, min_gap=8,
                loop_min_inliers=15, gba_after_loop=False,
            ),
        )
        system = SlamSystem(cfg)
        gt = []
        for gray, depth, T_wc, ts in scene.frames(80, kind="orbit"):
            system.track_rgbd(gray, depth, ts)
            gt.append(np.asarray(T_wc)[4:7])
        system.flush()  # resolve the pipelined loop-detection queue
        lc = system.loop_closer
        assert lc.vocab is not None
        assert int(jnp.sum(lc.db.valid)) > 5
        assert lc.n_loops_closed >= 1, "revisit did not close a loop"
        est = system.positions()
        rmse, _ = geometry.ate_rmse(jnp.asarray(est),
                                    jnp.asarray(np.stack(gt)))
        assert float(rmse) < 0.15, f"post-loop ATE {float(rmse):.3f}"


class TestPnPReloc:
    def test_pnp_recovers_large_viewpoint_change(self, rng):
        """Reloc must succeed when the query pose differs from the
        candidate keyframe by >30 deg (the MLPnP role the warm-start hack
        could not fill)."""
        from visual_sgraphs.core import cameras
        from visual_sgraphs.place.pnp import ransac_pnp

        M = 150
        xw = jnp.asarray(
            rng.uniform(-2, 2, (M, 3)).astype(np.float32) + [0, 0, 5]
        )
        T_true = lie.se3_exp(jnp.asarray(
            [0.4, 0.5, 0.1, 0.8, -0.2, 0.3], jnp.float32
        ))  # ~37 deg rotation
        cam_K = jnp.asarray([260.0, 260.0, 160.0, 120.0], jnp.float32)
        p = lie.se3_apply(T_true, xw)
        uv = cameras.project_pinhole(cam_K, p)
        uv = uv + jnp.asarray(
            rng.normal(size=uv.shape).astype(np.float32)
        ) * 0.5
        n_out = M // 4
        uv = uv.at[:n_out].add(jnp.asarray(
            rng.uniform(-100, 100, (n_out, 2)).astype(np.float32)
        ))
        res = ransac_pnp(xw, uv, jnp.ones((M,), bool), cam_K,
                         jax.random.PRNGKey(3))
        assert int(res.n_inliers) >= M - n_out - 10
        err = lie.se3_log(lie.se3_multiply(
            res.T_cw, lie.se3_inverse(T_true.astype(res.T_cw.dtype))
        ))
        assert float(jnp.linalg.norm(err)) < 0.02

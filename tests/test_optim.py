"""Tests for the batched LM factor-graph engine (the g2o replacement)."""

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.core import cameras, lie, plane as plane_mod
from visual_sgraphs.optim import (
    FactorBatch,
    GraphProblem,
    factors,
    optimize,
    optimize_rounds,
    plane_family,
    point_family,
    se3_family,
)

CAM = jnp.asarray([500.0, 500.0, 320.0, 240.0])


def make_scene(rng, n_kf=6, n_pt=60, noise_px=1.0):
    """Ground-truth scene: poses on an arc looking at a point cloud."""
    pts = rng.normal(size=(n_pt, 3)) * [2.0, 1.5, 0.5] + [0, 0, 6.0]
    poses = []
    for k in range(n_kf):
        xi = np.concatenate([rng.normal(size=3) * 0.1 + [0.3 * k, 0, 0],
                             rng.normal(size=3) * 0.05])
        poses.append(lie.se3_exp(jnp.asarray(xi)))
    T_cw = jnp.stack(poses)
    X = jnp.asarray(pts)
    # every kf observes every point
    kf_idx, pt_idx = np.meshgrid(np.arange(n_kf), np.arange(n_pt), indexing="ij")
    kf_idx, pt_idx = kf_idx.ravel(), pt_idx.ravel()
    p_cam = lie.se3_apply(T_cw[kf_idx], X[pt_idx])
    uv = cameras.project_pinhole(CAM, p_cam)
    uv = uv + jnp.asarray(rng.normal(size=uv.shape) * noise_px)
    return T_cw, X, jnp.asarray(kf_idx), jnp.asarray(pt_idx), uv


def reproj_batch(kf_idx, pt_idx, uv, info=1.0, huber=None, gate=None,
                 valid=None):
    m = uv.shape[0]
    if valid is None:
        valid = jnp.ones(m, bool)
    return FactorBatch(
        families=("kf", "pt"),
        residual_fn=factors.reproj_mono,
        res_dim=2,
        var_idx=jnp.stack([kf_idx, pt_idx], axis=1).astype(jnp.int32),
        const={"uv": uv, "cam": jnp.broadcast_to(CAM, (m, 4))},
        info=jnp.full((m,), float(info)),
        valid=valid,
        huber=huber,
        chi2_gate=gate,
    )


def test_pose_only_optimization(rng):
    """Motion-only solve must recover a perturbed camera pose (the per-frame
    PoseOptimization hot path)."""
    T_gt = lie.se3_exp(jnp.asarray([0.1, -0.2, 0.05, 0.02, -0.03, 0.01]))
    X = jnp.asarray(rng.normal(size=(80, 3)) + [0, 0, 5.0])
    uv = cameras.project_pinhole(CAM, lie.se3_apply(T_gt, X))
    T0 = lie.se3_multiply(
        lie.se3_exp(jnp.asarray([0.05, 0.04, -0.06, 0.02, 0.01, -0.02])), T_gt
    )
    m = X.shape[0]
    batch = FactorBatch(
        families=("kf",),
        residual_fn=factors.reproj_mono_pose_only,
        res_dim=2,
        var_idx=jnp.zeros((m, 1), jnp.int32),
        const={"uv": uv, "xw": X, "cam": jnp.broadcast_to(CAM, (m, 4))},
        info=jnp.ones(m),
        valid=jnp.ones(m, bool),
        huber=np.sqrt(5.991),
    )
    problem = GraphProblem(
        families={"kf": se3_family(T0[None])}, factors=[batch]
    )
    res = optimize(problem, iters=10)
    err = lie.se3_log(
        lie.se3_multiply(res.values["kf"][0], lie.se3_inverse(T_gt))
    )
    assert float(jnp.abs(err).max()) < 1e-6
    assert float(res.cost) < float(res.initial_cost) * 1e-6


def test_bundle_adjustment_converges(rng):
    """Full BA with Schur-eliminated landmarks: perturbed init -> GT."""
    T_gt, X_gt, kf_idx, pt_idx, uv = make_scene(rng, noise_px=0.0)
    n_kf, n_pt = T_gt.shape[0], X_gt.shape[0]
    # perturb everything except the two gauge-fixing keyframes
    T0 = jnp.concatenate(
        [
            T_gt[:2],
            jax.vmap(lie.se3_boxplus)(
                T_gt[2:], jnp.asarray(rng.normal(size=(n_kf - 2, 6)) * 0.03)
            ),
        ]
    )
    X0 = X_gt + jnp.asarray(rng.normal(size=X_gt.shape) * 0.05)
    fixed = jnp.asarray([True, True] + [False] * (n_kf - 2))
    problem = GraphProblem(
        families={
            "kf": se3_family(T0, fixed),
            "pt": point_family(X0),
        },
        factors=[reproj_batch(kf_idx, pt_idx, uv)],
        eliminated="pt",
    )
    res = optimize(problem, iters=15)
    assert float(res.cost) < 1e-10 * max(1.0, float(res.initial_cost))
    pose_err = jax.vmap(
        lambda a, b: lie.se3_log(lie.se3_multiply(a, lie.se3_inverse(b)))
    )(res.values["kf"], T_gt)
    assert float(jnp.abs(pose_err).max()) < 1e-5
    assert float(jnp.abs(res.values["pt"] - X_gt).max()) < 1e-4


def test_ba_noise_floor(rng):
    """With 1px observation noise BA should reach the statistical floor:
    mean reprojection error ~ noise, poses within a few millimetres."""
    T_gt, X_gt, kf_idx, pt_idx, uv = make_scene(rng, noise_px=1.0)
    n_kf = T_gt.shape[0]
    T0 = jax.vmap(lie.se3_boxplus)(
        T_gt, jnp.concatenate([jnp.zeros((2, 6)),
                               jnp.asarray(rng.normal(size=(n_kf - 2, 6)) * 0.02)])
    )
    X0 = X_gt + jnp.asarray(rng.normal(size=X_gt.shape) * 0.03)
    fixed = jnp.asarray([True, True] + [False] * (n_kf - 2))
    problem = GraphProblem(
        families={"kf": se3_family(T0, fixed), "pt": point_family(X0)},
        factors=[reproj_batch(kf_idx, pt_idx, uv)],
        eliminated="pt",
    )
    res = optimize(problem, iters=15)
    m = kf_idx.shape[0]
    mean_px2 = float(res.cost) / m
    assert mean_px2 < 2.5  # ~2 * sigma^2 per 2-dof residual


def test_ba_outlier_gating(rng):
    """Gross outliers must be suppressed by Huber + chi2 gate (the
    reference's inlier/outlier marking in LBA, Optimizer.cc:2290-2380)."""
    T_gt, X_gt, kf_idx, pt_idx, uv = make_scene(rng, noise_px=0.5)
    m = uv.shape[0]
    n_out = m // 10
    out_sel = rng.choice(m, size=n_out, replace=False)
    uv_bad = np.array(uv)
    # unambiguous gross outliers: 20-100 px shifts in random directions
    ang = rng.uniform(0, 2 * np.pi, size=n_out)
    mag = rng.uniform(20, 100, size=n_out)
    uv_bad[out_sel] += (mag[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1))
    uv_bad = jnp.asarray(uv_bad)
    n_kf = T_gt.shape[0]
    T0 = jax.vmap(lie.se3_boxplus)(
        T_gt, jnp.concatenate([jnp.zeros((2, 6)),
                               jnp.asarray(rng.normal(size=(n_kf - 2, 6)) * 0.01)])
    )
    X0 = X_gt + jnp.asarray(rng.normal(size=X_gt.shape) * 0.02)
    fixed = jnp.asarray([True, True] + [False] * (n_kf - 2))
    problem = GraphProblem(
        families={"kf": se3_family(T0, fixed), "pt": point_family(X0)},
        factors=[
            reproj_batch(kf_idx, pt_idx, uv_bad, huber=np.sqrt(5.991),
                         gate=5.991 * 9.0)
        ],
        eliminated="pt",
    )
    res, masks = optimize_rounds(problem, rounds=3, iters=10)
    pose_err = jax.vmap(
        lambda a, b: lie.se3_log(lie.se3_multiply(a, lie.se3_inverse(b)))
    )(res.values["kf"], T_gt)
    # statistical floor of this scene (0.5px noise, 6m depth) is ~0.014;
    # unbounded outlier influence would be 10x that
    assert float(jnp.abs(pose_err).max()) < 2e-2
    # the gate must have identified essentially all injected outliers
    inlier_mask = np.asarray(masks[0])
    assert inlier_mask[out_sel].mean() < 0.05
    true_inliers = np.setdiff1d(np.arange(m), out_sel)
    assert inlier_mask[true_inliers].mean() > 0.97


def test_pose_graph_se3(rng):
    """Chain + loop-closure relative-pose graph converges (essential-graph
    analog on SE3)."""
    n = 12
    T_gt = [lie.se3_identity(jnp.float64)]
    for k in range(1, n):
        step = lie.se3_exp(jnp.asarray([0.5, 0.0, 0.0, 0.0, 0.0, 0.5]))
        T_gt.append(lie.se3_multiply(step, T_gt[-1]))
    T_gt = jnp.stack(T_gt)
    # odometry edges + one loop edge, all exact; drifted initialization
    edges_i = list(range(n - 1)) + [0]
    edges_j = list(range(1, n)) + [n - 1]
    T_ji = jnp.stack(
        [
            lie.se3_multiply(T_gt[j], lie.se3_inverse(T_gt[i]))
            for i, j in zip(edges_i, edges_j)
        ]
    )
    drift = jnp.asarray(rng.normal(size=(n, 6)) * 0.05).at[0].set(0.0)
    T0 = jax.vmap(lie.se3_boxplus)(T_gt, drift)
    fixed = jnp.asarray([True] + [False] * (n - 1))
    m = len(edges_i)
    batch = FactorBatch(
        families=("kf", "kf"),
        residual_fn=factors.relative_se3,
        res_dim=6,
        var_idx=jnp.asarray(np.stack([edges_i, edges_j], 1), jnp.int32),
        const={"T_ji": T_ji},
        info=jnp.ones(m),
        valid=jnp.ones(m, bool),
    )
    problem = GraphProblem(families={"kf": se3_family(T0, fixed)},
                           factors=[batch])
    res = optimize(problem, iters=30)
    err = jax.vmap(
        lambda a, b: lie.se3_log(lie.se3_multiply(a, lie.se3_inverse(b)))
    )(res.values["kf"], T_gt)
    assert float(jnp.abs(err).max()) < 1e-5


def test_plane_kf_factor(rng):
    """A noisy world plane observed from several keyframes is refined to the
    consensus of its per-KF observations."""
    pi_gt = plane_mod.normalize(jnp.asarray([0.2, -0.1, 0.97, -2.0]))
    n_kf = 5
    T = jax.vmap(lie.se3_exp)(jnp.asarray(rng.normal(size=(n_kf, 6)) * 0.3))
    pi_obs = jax.vmap(lambda t: plane_mod.transform(t, pi_gt))(T)
    pi0 = plane_mod.oplus(pi_gt, jnp.asarray([0.05, -0.08, 0.3]))
    batch = FactorBatch(
        families=("kf", "pl"),
        residual_fn=factors.plane_kf,
        res_dim=3,
        var_idx=jnp.stack(
            [jnp.arange(n_kf), jnp.zeros(n_kf, jnp.int32)], axis=1
        ).astype(jnp.int32),
        const={"pi_obs": pi_obs},
        info=jnp.ones(n_kf),
        valid=jnp.ones(n_kf, bool),
    )
    problem = GraphProblem(
        families={
            "kf": se3_family(T, jnp.ones(n_kf, bool)),  # poses fixed
            "pl": plane_family(pi0[None]),
        },
        factors=[batch],
    )
    res = optimize(problem, iters=10)
    d = plane_mod.ominus(res.values["pl"][0], pi_gt)
    assert float(jnp.abs(d).max()) < 1e-8


def test_point_on_plane_factor(rng):
    """Points pulled onto a fixed plane by the point-plane factor."""
    pi = plane_mod.normalize(jnp.asarray([0.0, 0.0, 1.0, -1.0]))
    X0 = jnp.asarray(rng.normal(size=(20, 3)))
    m = 20
    batch = FactorBatch(
        families=("pl", "pt"),
        residual_fn=factors.point_on_plane,
        res_dim=1,
        var_idx=jnp.stack([jnp.zeros(m, jnp.int32), jnp.arange(m, dtype=jnp.int32)], 1),
        const={},
        info=jnp.ones(m),
        valid=jnp.ones(m, bool),
    )
    problem = GraphProblem(
        families={
            "pl": plane_family(pi[None], jnp.ones(1, bool)),
            "pt": point_family(X0),
        },
        factors=[batch],
    )
    res = optimize(problem, iters=5)
    dist = plane_mod.point_plane_distance(pi, res.values["pt"])
    assert float(jnp.abs(dist).max()) < 1e-9


def test_optimize_is_jittable(rng):
    """The whole solve must jit cleanly (one compile per shape bucket)."""
    T_gt, X_gt, kf_idx, pt_idx, uv = make_scene(rng, n_kf=3, n_pt=20,
                                                noise_px=0.0)
    fixed = jnp.asarray([True, False, False])
    problem = GraphProblem(
        families={"kf": se3_family(T_gt, fixed), "pt": point_family(X_gt)},
        factors=[reproj_batch(kf_idx, pt_idx, uv)],
        eliminated="pt",
    )
    jitted = jax.jit(lambda p: optimize(p, iters=3).cost)
    c1 = jitted(problem)
    assert np.isfinite(float(c1))

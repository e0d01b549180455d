"""Scene-graph correction on loop closure + migration on Atlas merge.

The reference corrects map points through per-keyframe Sim3s on loop
closure (LoopClosing.cc:1010-1035) and migrates Planes/Rooms/Doors/Markers
between maps in MergeLocal (LoopClosing.cc:1552-1683).  These tests pin the
equivalents here: place/pgo.correct_scenegraph and
slam/atlas.merge_scenegraphs.
"""

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.config import CapacityConfig, OrbConfig
from visual_sgraphs.core import lie
from visual_sgraphs.core import plane as plane_mod
from visual_sgraphs.place import pgo
from visual_sgraphs.scenegraph.state import empty_scenegraph
from visual_sgraphs.slam import atlas as atlas_mod
from visual_sgraphs.slam.map_state import empty_map


def _cap():
    return CapacityConfig(max_keyframes=16, max_points=256, max_planes=16)


def test_loop_correction_moves_planes_with_their_reference_kf():
    """Drifted planes snap back to ground truth when the pose graph does.

    Construction: keyframe k's world is displaced by drift D_k; a plane
    first observed by k therefore carries the drifted equation
    transform(D_k, pi_gt).  correct_scenegraph applies the same
    S_new^-1 . S_old correction that moves the map points, so the corrected
    plane must match pi_gt."""
    rng = np.random.default_rng(0)
    K = 8
    cap = _cap()
    m = empty_map(cap, OrbConfig(n_features=64))

    # ground-truth keyframe poses on an arc
    T_gt = []
    for k in range(K):
        xi = jnp.asarray([0.3 * k, 0.1 * k, 0.0, 0.0, 0.0, 0.05 * k])
        T_gt.append(lie.se3_exp(xi))
    T_gt = jnp.stack(T_gt)

    # per-keyframe drift, growing along the trajectory (like loop drift)
    drifts = []
    for k in range(K):
        mag = 0.08 * k
        xi = jnp.asarray(rng.normal(size=6) * [0.02, 0.02, 0.02, 1, 1, 1])
        xi = xi * mag
        drifts.append(lie.se3_exp(xi))
    D = jnp.stack(drifts)  # D_k: GT world -> drifted world (points)

    T_drift = jax.vmap(
        lambda Tg, d: lie.se3_normalize(
            lie.se3_multiply(Tg, lie.se3_inverse(d))
        )
    )(T_gt, D)
    m = m._replace(
        kf_pose=m.kf_pose.at[:K].set(T_drift),
        kf_valid=m.kf_valid.at[:K].set(True),
        n_kf=jnp.asarray(K, jnp.int32),
    )

    # 6 GT wall planes; plane i first observed by keyframe (i + 2)
    gt_planes = jnp.asarray(
        [
            [1.0, 0.0, 0.0, -2.0],
            [-1.0, 0.0, 0.0, -2.0],
            [0.0, 1.0, 0.0, -3.0],
            [0.0, -1.0, 0.0, -3.0],
            [0.0, 0.0, 1.0, 0.0],
            [0.707, 0.707, 0.0, -1.5],
        ]
    )
    gt_planes = jax.vmap(plane_mod.normalize)(gt_planes)
    sg = empty_scenegraph(cap, max_obs=32)
    for i in range(6):
        ref = i + 2
        drifted = plane_mod.transform(D[ref], gt_planes[i])
        sg = sg._replace(
            pl_coeffs=sg.pl_coeffs.at[i].set(drifted),
            pl_valid=sg.pl_valid.at[i].set(True),
            pl_centroid=sg.pl_centroid.at[i].set(
                lie.se3_apply(D[ref], gt_planes[i, :3] * 2.0)
            ),
            ob_kf=sg.ob_kf.at[i].set(ref),
            ob_plane=sg.ob_plane.at[i].set(i),
            ob_valid=sg.ob_valid.at[i].set(True),
        )
    sg = sg._replace(
        n_planes=jnp.asarray(6, jnp.int32), n_obs=jnp.asarray(6, jnp.int32)
    )

    # the "PGO result": optimized poses == ground truth (full-size
    # tables, like optimize_essential_graph returns)
    pose_old_full = m.kf_pose
    pose_new_full = m.kf_pose.at[:K].set(T_gt)
    result = pgo.PgoResult(
        kf_pose=pose_new_full,
        S_old=jax.vmap(lie.sim3_from_se3)(pose_old_full),
        S_new=jax.vmap(lie.sim3_from_se3)(pose_new_full),
        cost0=jnp.asarray(0.0),
        cost=jnp.asarray(0.0),
    )

    def plane_err(coeffs):
        d = jax.vmap(plane_mod.ominus)(gt_planes, coeffs[:6])
        return np.asarray(jnp.linalg.norm(d, axis=-1))

    err_before = plane_err(sg.pl_coeffs)
    m_corr = m._replace(kf_pose=m.kf_pose.at[:K].set(T_gt))
    sg2 = pgo.correct_scenegraph(sg, result, m_corr)
    err_after = plane_err(sg2.pl_coeffs)
    assert err_before.max() > 0.05, "construction produced no drift"
    assert (err_after < 1e-4).all(), (
        f"planes not corrected: before={err_before}, after={err_after}"
    )


def test_loop_correction_moves_rooms_and_doors():
    cap = _cap()
    K = 4
    m = empty_map(cap, OrbConfig(n_features=64))
    T_gt = jnp.stack([lie.se3_identity() for _ in range(K)])
    D = lie.se3_exp(jnp.asarray([0.0, 0.0, 0.3, 0.5, -0.2, 0.1]))
    T_drift = jnp.stack(
        [lie.se3_multiply(T_gt[k], lie.se3_inverse(D)) for k in range(K)]
    )
    m = m._replace(
        kf_pose=m.kf_pose.at[:K].set(T_drift),
        kf_valid=m.kf_valid.at[:K].set(True),
        n_kf=jnp.asarray(K, jnp.int32),
    )
    sg = empty_scenegraph(cap, max_obs=32)
    gt_center = jnp.asarray([1.0, 2.0, 0.0])
    gt_door_t = jnp.asarray([0.5, 0.2, 1.0])
    wall = plane_mod.normalize(jnp.asarray([1.0, 0.0, 0.0, -1.0]))
    sg = sg._replace(
        pl_coeffs=sg.pl_coeffs.at[0].set(plane_mod.transform(D, wall)),
        pl_valid=sg.pl_valid.at[0].set(True),
        n_planes=jnp.asarray(1, jnp.int32),
        ob_kf=sg.ob_kf.at[0].set(1),
        ob_plane=sg.ob_plane.at[0].set(0),
        ob_valid=sg.ob_valid.at[0].set(True),
        n_obs=jnp.asarray(1, jnp.int32),
        room_center=sg.room_center.at[0].set(lie.se3_apply(D, gt_center)),
        room_walls=sg.room_walls.at[0, 0].set(0),
        room_valid=sg.room_valid.at[0].set(True),
        n_rooms=jnp.asarray(1, jnp.int32),
        door_pose=sg.door_pose.at[0].set(
            lie.se3_multiply(D, lie.se3_from_rt(lie.quat_identity(),
                                                gt_door_t))
        ),
        door_valid=sg.door_valid.at[0].set(True),
        n_doors=jnp.asarray(1, jnp.int32),
    )
    pose_old_full = m.kf_pose
    pose_new_full = m.kf_pose.at[:K].set(T_gt)
    result = pgo.PgoResult(
        kf_pose=pose_new_full,
        S_old=jax.vmap(lie.sim3_from_se3)(pose_old_full),
        S_new=jax.vmap(lie.sim3_from_se3)(pose_new_full),
        cost0=jnp.asarray(0.0),
        cost=jnp.asarray(0.0),
    )
    sg2 = pgo.correct_scenegraph(sg, result, m._replace(kf_pose=pose_new_full))
    assert np.allclose(np.asarray(sg2.room_center[0]), np.asarray(gt_center),
                       atol=1e-4)
    assert np.allclose(np.asarray(sg2.door_pose[0, 4:7]),
                       np.asarray(gt_door_t), atol=1e-4)


def test_merge_scenegraphs_migrates_and_remaps():
    cap = _cap()
    dst = empty_scenegraph(cap, max_obs=32)
    src = empty_scenegraph(cap, max_obs=32)

    # dst already holds one plane + one observation
    dst = dst._replace(
        pl_coeffs=dst.pl_coeffs.at[0].set(
            jnp.asarray([0.0, 0.0, 1.0, -1.0])
        ),
        pl_valid=dst.pl_valid.at[0].set(True),
        n_planes=jnp.asarray(1, jnp.int32),
        ob_kf=dst.ob_kf.at[0].set(0),
        ob_plane=dst.ob_plane.at[0].set(0),
        ob_valid=dst.ob_valid.at[0].set(True),
        n_obs=jnp.asarray(1, jnp.int32),
    )

    # src: two planes, two observations (KFs 0 and 1), one room over both
    wall_a = plane_mod.normalize(jnp.asarray([1.0, 0.0, 0.0, -4.0]))
    wall_b = plane_mod.normalize(jnp.asarray([-1.0, 0.0, 0.0, -4.0]))
    src = src._replace(
        pl_coeffs=src.pl_coeffs.at[0].set(wall_a).at[1].set(wall_b),
        pl_valid=src.pl_valid.at[:2].set(True),
        pl_centroid=src.pl_centroid.at[0].set(jnp.asarray([4.0, 0.0, 0.0])),
        n_planes=jnp.asarray(2, jnp.int32),
        ob_kf=src.ob_kf.at[0].set(0).at[1].set(1),
        ob_plane=src.ob_plane.at[0].set(0).at[1].set(1),
        ob_valid=src.ob_valid.at[:2].set(True),
        n_obs=jnp.asarray(2, jnp.int32),
        room_center=src.room_center.at[0].set(jnp.asarray([0.0, 0.0, 0.0])),
        room_walls=src.room_walls.at[0, 0].set(0).at[0, 1].set(1),
        room_valid=src.room_valid.at[0].set(True),
        n_rooms=jnp.asarray(1, jnp.int32),
    )

    # welding transform: translate src world by +10 in y; src KFs 0,1 land
    # in dst slots 5,6 (KF 2+ dropped)
    A = lie.se3_from_rt(lie.quat_identity(), jnp.asarray([0.0, 10.0, 0.0]))
    kf_new = jnp.full((16,), -1, jnp.int32).at[0].set(5).at[1].set(6)
    merged, stats = atlas_mod.merge_scenegraphs(dst, src, A, kf_new)

    assert int(stats.n_planes_moved) == 2
    assert int(stats.n_obs_moved) == 2
    assert int(stats.n_rooms_moved) == 1
    # src plane 0 landed in dst slot 1 (after dst's existing plane)
    got = np.asarray(merged.pl_coeffs[1])
    want = np.asarray(plane_mod.transform(A, wall_a))
    assert np.allclose(got, want, atol=1e-5)
    # centroid moved with the weld
    assert np.allclose(
        np.asarray(merged.pl_centroid[1]), [4.0, 10.0, 0.0], atol=1e-5
    )
    # observations remapped: ob row 1 -> kf 5, plane 1; row 2 -> kf 6, plane 2
    assert int(merged.ob_kf[1]) == 5 and int(merged.ob_plane[1]) == 1
    assert int(merged.ob_kf[2]) == 6 and int(merged.ob_plane[2]) == 2
    # room migrated with remapped wall ids + transformed center
    assert bool(merged.room_valid[0])
    assert list(np.asarray(merged.room_walls[0, :2])) == [1, 2]
    assert np.allclose(
        np.asarray(merged.room_center[0]), [0.0, 10.0, 0.0], atol=1e-5
    )


def test_merge_scenegraphs_drops_obs_of_dropped_keyframes():
    cap = _cap()
    dst = empty_scenegraph(cap, max_obs=32)
    src = empty_scenegraph(cap, max_obs=32)
    src = src._replace(
        pl_coeffs=src.pl_coeffs.at[0].set(
            jnp.asarray([0.0, 0.0, 1.0, -1.0])
        ),
        pl_valid=src.pl_valid.at[0].set(True),
        n_planes=jnp.asarray(1, jnp.int32),
        ob_kf=src.ob_kf.at[0].set(0).at[1].set(3),
        ob_plane=src.ob_plane.at[:2].set(0),
        ob_valid=src.ob_valid.at[:2].set(True),
        n_obs=jnp.asarray(2, jnp.int32),
    )
    kf_new = jnp.full((16,), -1, jnp.int32).at[0].set(2)  # KF 3 dropped
    merged, stats = atlas_mod.merge_scenegraphs(
        dst, src, lie.se3_identity(), kf_new
    )
    assert int(stats.n_obs_moved) == 1
    assert int(merged.ob_kf[0]) == 2
    assert not bool(merged.ob_valid[1])

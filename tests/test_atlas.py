"""Atlas multi-map: world-frame transform, merge with observation remap,
and elastic recovery end-to-end (loss -> fresh map -> merge on revisit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from visual_sgraphs.config import CapacityConfig, OrbConfig
from visual_sgraphs.core import lie
from visual_sgraphs.slam.atlas import merge_maps, transform_map
from visual_sgraphs.slam.map_state import empty_map


def _mini_map(rng, n_kf, n_pt, cap=None, orb=None, offset=0.0):
    cap = cap or CapacityConfig(max_keyframes=16, max_points=256)
    orb = orb or OrbConfig(n_features=32)
    m = empty_map(cap, orb)
    F = orb.n_features
    poses = jax.vmap(lie.se3_exp)(
        jnp.asarray(rng.normal(size=(n_kf, 6)) * 0.1, jnp.float32)
        + jnp.asarray([0, 0, 0, offset, 0, 0], jnp.float32)
    )
    pts = jnp.asarray(rng.normal(size=(n_pt, 3)) + [0, 0, 4], jnp.float32)
    desc = jnp.asarray(rng.integers(0, 256, (n_kf, F, 32)), jnp.uint8)
    obs = jnp.tile(jnp.arange(F, dtype=jnp.int32)[None], (n_kf, 1))
    obs = jnp.where(obs < n_pt, obs, -1)
    m = m._replace(
        kf_pose=m.kf_pose.at[:n_kf].set(poses),
        kf_valid=m.kf_valid.at[:n_kf].set(True),
        kf_desc=m.kf_desc.at[:n_kf].set(desc),
        kf_kp_valid=m.kf_kp_valid.at[:n_kf].set(True),
        kf_obs_pt=m.kf_obs_pt.at[:n_kf].set(obs),
        kf_seq=m.kf_seq.at[:n_kf].set(
            jnp.arange(n_kf, dtype=jnp.int32)
        ),
        pt_pos=m.pt_pos.at[:n_pt].set(pts),
        pt_valid=m.pt_valid.at[:n_pt].set(True),
        pt_first_kf=m.pt_first_kf.at[:n_pt].set(0),
        pt_first_seq=m.pt_first_seq.at[:n_pt].set(0),
        n_kf=jnp.asarray(n_kf, jnp.int32),
        n_pt=jnp.asarray(n_pt, jnp.int32),
    )
    return m


def test_transform_map_preserves_camera_geometry(rng):
    m = _mini_map(rng, 4, 100)
    T = lie.se3_exp(jnp.asarray([0.2, -0.1, 0.3, 1.0, 2.0, -0.5],
                                jnp.float32))
    m2 = transform_map(m, T)
    # camera-frame coordinates of any (kf, point) pair are invariant
    xc = lie.se3_apply(m.kf_pose[2], m.pt_pos[7])
    xc2 = lie.se3_apply(m2.kf_pose[2], m2.pt_pos[7])
    np.testing.assert_allclose(np.asarray(xc2), np.asarray(xc),
                               rtol=1e-4, atol=1e-4)


def test_merge_moves_everything_and_remaps_obs(rng):
    dst = _mini_map(rng, 3, 50)
    src = _mini_map(rng, 4, 60, offset=0.5)
    A = lie.se3_exp(jnp.asarray([0, 0.1, 0, 2.0, 0, 1.0], jnp.float32))
    merged, stats = merge_maps(dst, src, A)
    assert int(stats.n_kf_moved) == 4
    assert int(stats.n_pt_moved) == 60
    assert int(merged.n_kf) == 7
    assert int(merged.n_pt) == 110
    # src KF 1 landed in slot 3+1=4; its camera geometry is preserved
    src_t = transform_map(src, A)
    np.testing.assert_allclose(
        np.asarray(merged.kf_pose[4]), np.asarray(src_t.kf_pose[1]),
        atol=1e-6,
    )
    # observation remap: merged KF 4's obs k points at merged point 50+k
    obs = np.asarray(merged.kf_obs_pt[4])
    assert obs[0] == 50 and obs[10] == 60
    # point positions moved with the weld transform
    np.testing.assert_allclose(
        np.asarray(merged.pt_pos[50]), np.asarray(src_t.pt_pos[0]),
        atol=1e-6,
    )
    # first-kf remap
    assert int(merged.pt_first_kf[50]) == 3


def test_merge_respects_capacity(rng):
    cap = CapacityConfig(max_keyframes=8, max_points=80)
    dst = _mini_map(rng, 6, 70, cap=cap)
    src = _mini_map(rng, 4, 40, cap=cap)
    merged, stats = merge_maps(dst, src, lie.se3_identity())
    # n_kf/n_pt are monotone creation counters; VALID counts clamp at
    # capacity (overflow entities are dropped and reported in the stats)
    assert int(jnp.sum(merged.kf_valid)) == 8
    assert int(stats.n_kf_moved) == 2
    assert int(jnp.sum(merged.pt_valid)) == 80
    assert int(stats.n_pt_moved) == 10
    # the two moved keyframes are src's two OLDEST (sequence order)
    kf_new = np.asarray(stats.kf_new)
    assert (kf_new[:2] >= 0).all() and (kf_new[2:4] < 0).all()


@pytest.mark.slow
def test_elastic_recovery_and_merge():
    """Blind the camera mid-orbit: tracking dies, a fresh map starts, and
    the revisit merges the young map back into the stashed one."""
    from visual_sgraphs.config import (
        PlaceConfig, Sensor, SystemConfig, TrackingConfig,
    )
    from visual_sgraphs.io.synthetic import SyntheticScene
    from visual_sgraphs.slam import SlamSystem

    scene = SyntheticScene()
    cfg = SystemConfig(
        sensor=Sensor.RGBD, camera=scene.cam,
        orb=OrbConfig(n_features=512),
        capacity=CapacityConfig(max_keyframes=96, max_points=24576),
        loop_closing=True,
        tracking=TrackingConfig(recently_lost_budget=0.2),
        place=PlaceConfig(vocab_min_keyframes=4, consistency=1,
                          min_gap=8, gba_after_loop=False),
    )
    system = SlamSystem(cfg)
    frames = list(scene.frames(110, kind="orbit"))
    for i, (gray, depth, T_wc, ts) in enumerate(frames):
        if 34 <= i < 44:  # blind segment: zero image, no depth
            gray = jnp.zeros_like(gray)
            depth = jnp.zeros_like(depth)
        system.track_rgbd(gray, depth, ts)
    # a new map was created during the blackout...
    assert system.atlas.n_maps_created >= 2, "no new map was spawned"
    # ...and the revisit merged (or resumed) back: single active map left
    assert len(system.atlas.stashed) == 0, (
        f"{len(system.atlas.stashed)} maps never merged back"
    )
    assert system.epoch == 0  # the old map is the base again
    assert int(system.map.n_kf) > 12  # holds keyframes from both maps

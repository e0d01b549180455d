"""The repository's standard runs, shared by ``bench.py``, ``chip_smoke.py``
and ``__graft_entry__.py`` so that each states a configuration once.

- The headline: RGB-D SLAM on the synthetic ``orbit2`` stream (640x480,
  1000 ORB features, the TUM1.yaml budget), the B=8 cycle program, loop
  closing with a global BA after every accepted loop, and the scene graph
  with plane covisibility and semantic map-point refinement on.
- The inertial row: RGB-D + IMU on the synthetic ``orbit`` stream through
  the serial per-frame visual-inertial solve.
- The global-BA problem: K keyframes, N landmarks, O observations per
  landmark, laid out as the landmark-sharded solver takes it.

Every function takes its sizes as arguments and defaults to the full
widths, so tests run the same code at tiny ones.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.config import (
    CapacityConfig,
    ImuConfig,
    MappingConfig,
    OrbConfig,
    PlaceConfig,
    Sensor,
    SystemConfig,
    TrackingConfig,
)
from visual_sgraphs.core import cameras, geometry, lie
from visual_sgraphs.io.synthetic import SyntheticScene
from visual_sgraphs.scenegraph.manager import SceneGraphManager
from visual_sgraphs.slam import SlamSystem

HEADLINE_FRAMES = 192
HEADLINE_WARMUP = 64  # frames that pay compilation before the timed window


def headline_config(cam, n_features: int = 1000, max_keyframes: int = 128,
                    max_points: int = 32768,
                    pipeline_depth: int = 8) -> SystemConfig:
    cfg = SystemConfig(
        sensor=Sensor.RGBD,
        camera=cam,
        orb=OrbConfig(n_features=n_features),
        capacity=CapacityConfig(max_keyframes=max_keyframes,
                                max_points=max_points),
        tracking=TrackingConfig(pipeline_depth=pipeline_depth),
        # real-time operating point: the reference's LBA is aborted under
        # load (mbAbortBA); BA every 2nd keyframe at 6 LM iterations
        mapping=MappingConfig(lba_iters=6, lba_interval=2, cull_interval=2),
        loop_closing=True,
        # a full global BA follows every accepted loop closure (the
        # reference spawns its GBA thread likewise, LoopClosing.cc:1173)
        place=PlaceConfig(vocab_min_keyframes=4, consistency=1, min_gap=8,
                          gba_after_loop=True),
        profile=True,
    )
    # the two vS-Graphs behaviours the reference ships off by default
    # (SystemParams.h:76-80) run on, so the headline exercises them
    return dataclasses.replace(cfg, scenegraph=dataclasses.replace(
        cfg.scenegraph, plane_covis_enabled=True, refine_map_points=True))


class HeadlineResult(NamedTuple):
    system: SlamSystem
    ate_rmse_m: float
    warmup_s: float  # wall time of the first ``warmup`` frames
    steady_fps: float  # frames/s over the frames after ``warmup``
    tracked_frames: int
    events: dict  # event kind -> count


def run_headline(n_frames: int = HEADLINE_FRAMES,
                 warmup: int = HEADLINE_WARMUP, h: int = 480, w: int = 640,
                 n_features: int = 1000, max_keyframes: int = 128,
                 max_points: int = 32768,
                 pipeline_depth: int = 8) -> HeadlineResult:
    """Drive ``SlamSystem.track_rgbd`` over the headline stream.  Frames
    are uploaded before the clock starts; stage timers are reset after the
    warm-up so ``system.timers`` covers the steady window only."""
    scene = SyntheticScene(h=h, w=w)
    cfg = headline_config(scene.cam, n_features, max_keyframes, max_points,
                          pipeline_depth)
    system = SlamSystem(cfg)
    system.scenegraph = SceneGraphManager(cfg.scenegraph, cfg.capacity)
    frames = [
        (jax.block_until_ready(jnp.asarray(g)),
         jax.block_until_ready(jnp.asarray(d)), s, T, ts)
        for g, d, s, T, ts in scene.frames_with_semantics(
            n_frames, kind="orbit2")
    ]
    gt = []
    t0 = time.perf_counter()
    warmup_s = None
    for i, (gray, depth, sem, T_wc, ts) in enumerate(frames):
        if i == warmup:
            system.flush()
            warmup_s = time.perf_counter() - t0
            system.timers.reset()
            t0 = time.perf_counter()
        system.scenegraph.provide_semantics(ts, sem)
        system.track_rgbd(gray, depth, ts)
        gt.append(np.asarray(T_wc)[4:7])
    system.flush()
    steady_s = time.perf_counter() - t0
    rmse, _ = geometry.ate_rmse(jnp.asarray(system.positions()),
                                jnp.asarray(np.stack(gt)))
    return HeadlineResult(
        system=system,
        ate_rmse_m=float(rmse),
        warmup_s=warmup_s,
        steady_fps=(n_frames - warmup) / steady_s,
        tracked_frames=int(system.tracked_mask().sum()),
        events=dict(Counter(k for _, k, _ in system.events.records)),
    )


def run_inertial(n_frames: int = 128, warmup: int = 48, h: int = 480,
                 w: int = 640, n_features: int = 1000,
                 max_keyframes: int = 64, max_points: int = 16384) -> dict:
    """RGB-D + IMU through the exact per-frame visual-inertial solve
    (PoseInertialOptimizationLastFrame equivalent, serial ``_track``)."""
    scene = SyntheticScene(h=h, w=w)
    cfg = SystemConfig(
        sensor=Sensor.IMU_RGBD,
        camera=scene.cam,
        orb=OrbConfig(n_features=n_features),
        capacity=CapacityConfig(max_keyframes=max_keyframes,
                                max_points=max_points),
        imu=ImuConfig(),
        mapping=MappingConfig(lba_iters=6, lba_interval=2, cull_interval=2),
    )
    system = SlamSystem(cfg)
    gt = []
    t0 = time.perf_counter()
    for i, (g, d, T_wc, ts, samples) in enumerate(
            scene.frames_with_imu(n_frames, kind="orbit")):
        if i == warmup:
            system.flush()
            t0 = time.perf_counter()
        system.track_rgbd(jnp.asarray(g), jnp.asarray(d), ts, imu=samples)
        gt.append(np.asarray(T_wc)[4:7])
    system.flush()
    steady_s = time.perf_counter() - t0
    rmse, _ = geometry.ate_rmse(jnp.asarray(system.positions()),
                                jnp.asarray(np.stack(gt)))
    return {
        "fps": (n_frames - warmup) / steady_s,
        "ate_rmse_m": float(rmse),
        "imu_initialized": bool(system.imu.initialized),
        "n_keyframes": int(system.map.n_kf),
        "tracked_frames": int(system.tracked_mask().sum()),
    }


def gba_problem(n_kf: int = 128, n_pt: int = 32768, n_obs: int = 8,
                seed: int = 0) -> dict:
    """A seeded global-BA problem in the solver's grouped layout: each
    landmark seen by ``n_obs`` consecutive keyframes (covisibility-
    contiguous, the order the map's creation sequence gives), poses and
    points perturbed from the truth, the first two keyframes fixed.
    Returns the keyword arguments of ``sharded_ba_grouped`` minus the
    mesh."""
    rng = np.random.default_rng(seed)
    cam = jnp.asarray([300.0, 300.0, 320.0, 240.0], jnp.float32)
    pts = jnp.asarray(
        rng.normal(size=(n_pt, 3)) * [4, 2, 1] + [0, 0, 8.0], jnp.float32)
    T = jax.vmap(lie.se3_exp)(
        jnp.asarray(rng.normal(size=(n_kf, 6)) * 0.03, jnp.float32))
    base = (np.arange(n_pt) * n_kf // n_pt).clip(0, n_kf - n_obs)
    kf_tab = jnp.asarray(base[:, None] + np.arange(n_obs)[None, :],
                         jnp.int32)
    p_cam = jax.vmap(lambda ks, X: lie.se3_apply(T[ks], X))(kf_tab, pts)
    uv = jax.vmap(lambda pc: cameras.project_pinhole(cam, pc))(p_cam)
    uvr = jnp.concatenate(
        [uv, jnp.full(uv.shape[:-1] + (1,), -1.0, jnp.float32)], axis=-1)
    T0 = jax.vmap(lie.se3_boxplus)(
        T, jnp.asarray(rng.normal(size=(n_kf, 6)) * 0.005, jnp.float32))
    X0 = pts + jnp.asarray(rng.normal(size=pts.shape) * 0.02, jnp.float32)
    return {
        "kf_pose": T0, "pt_pos": X0, "kf_tab": kf_tab, "uvr_tab": uvr,
        "val_tab": p_cam[..., 2] > 0.1, "cam_K": cam,
        "fixed_kf": jnp.zeros((n_kf,), bool).at[:2].set(True),
        "valid_pt": jnp.ones(n_pt, bool),
    }

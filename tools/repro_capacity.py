"""Capacity-wall repro: run the bench config with a tiny keyframe budget so
eviction + slot reuse + ledger rebase are exercised.

Usage: python tools/repro_capacity.py [max_kf] [depth] [n_frames]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np


def main():
    max_kf = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    depth = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    n_frames = int(sys.argv[3]) if len(sys.argv) > 3 else 192

    from collections import Counter

    from visual_sgraphs.config import (
        CameraConfig,
        CapacityConfig,
        MappingConfig,
        OrbConfig,
        PlaceConfig,
        Sensor,
        SystemConfig,
        TrackingConfig,
    )
    from visual_sgraphs.core import geometry
    from visual_sgraphs.io.synthetic import SyntheticScene
    from visual_sgraphs.slam import SlamSystem

    h, w = 240, 320
    cam = CameraConfig(
        fx=517.3 * w / 640, fy=516.5 * h / 480,
        cx=318.6 * w / 640, cy=255.3 * h / 480,
        width=w, height=h,
    )
    scene = SyntheticScene(cam=cam, h=h, w=w)
    cfg = SystemConfig(
        sensor=Sensor.RGBD,
        camera=scene.cam,
        orb=OrbConfig(n_features=600),
        capacity=CapacityConfig(max_keyframes=max_kf, max_points=16384),
        tracking=TrackingConfig(pipeline_depth=depth),
        mapping=MappingConfig(lba_iters=6, lba_interval=2, cull_interval=2),
        loop_closing=True,
        place=PlaceConfig(vocab_min_keyframes=4, consistency=1, min_gap=8,
                          gba_after_loop=False),
        strict_slot_check=True,
    )
    system = SlamSystem(cfg)

    gt = []
    t0 = time.time()
    for gray, depth_img, sem, T_wc, ts in scene.frames_with_semantics(
        n_frames, kind="orbit2"
    ):
        system.track_rgbd(jnp.asarray(gray), jnp.asarray(depth_img), ts)
        gt.append(np.asarray(T_wc)[4:7])
    system.flush()
    elapsed = time.time() - t0

    est = system.positions()
    rmse, _ = geometry.ate_rmse(jnp.asarray(est), jnp.asarray(np.stack(gt)))
    mask = system.tracked_mask()
    ev = Counter(k for _, k, _ in system.events.records)
    print(
        f"K={max_kf} depth={depth} ate={float(rmse):.4f} "
        f"tracked={int(mask.sum())}/{len(mask)} "
        f"rows={len(system.trajectory)} "
        f"n_kf_created={system.n_kf_host} "
        f"kf_valid={int(jnp.sum(system.map.kf_valid))} "
        f"led_n={int(system.map.led_n)} "
        f"loops={system.loop_closer.n_loops_closed} "
        f"wall={elapsed:.1f}s events={dict(ev)}"
    )


if __name__ == "__main__":
    main()

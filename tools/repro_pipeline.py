"""CPU repro harness for the pipelined-tracking regression (VERDICT r3).

Runs the bench configuration (orbit2 scene, loop closing + scene graph on,
lba_interval=2) at a reduced scale on the CPU backend, at a given
pipeline_depth, and prints ATE / KF / loop stats.

Usage: python tools/repro_pipeline.py [depth] [h] [w] [nfeat] [nframes]
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
    depth = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    h = int(sys.argv[2]) if len(sys.argv) > 2 else 240
    w = int(sys.argv[3]) if len(sys.argv) > 3 else 320
    nfeat = int(sys.argv[4]) if len(sys.argv) > 4 else 600
    n_frames = int(sys.argv[5]) if len(sys.argv) > 5 else 192

    import os as _os
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
    from visual_sgraphs.scenegraph.manager import SceneGraphManager
    from visual_sgraphs.slam import SlamSystem

    cam = CameraConfig(
        fx=517.3 * w / 640, fy=516.5 * h / 480,
        cx=318.6 * w / 640, cy=255.3 * h / 480,
        width=w, height=h,
    )
    scene = SyntheticScene(cam=cam, h=h, w=w)
    cfg = SystemConfig(
        sensor=Sensor.RGBD,
        camera=scene.cam,
        orb=OrbConfig(n_features=nfeat),
        capacity=CapacityConfig(max_keyframes=128, max_points=32768),
        tracking=TrackingConfig(pipeline_depth=depth),
        mapping=MappingConfig(lba_iters=6, lba_interval=2, cull_interval=2),
        loop_closing=True,
        place=PlaceConfig(vocab_min_keyframes=4, consistency=1, min_gap=8,
                          # the 20/40 double gate is calibrated for the
                          # 1000-feature bench budget; scale guided
                          # support with the feature count
                          loop_min_guided=max(12, nfeat * 40 // 1000),
                          gba_after_loop=False),
    )
    import dataclasses as _dc
    sg_kw = {}
    if _os.environ.get("NO_PLANE_COVIS"):
        sg_kw["plane_covis_enabled"] = False
    if _os.environ.get("NO_REFINE"):
        sg_kw["refine_map_points"] = False
    if sg_kw:
        cfg = _dc.replace(cfg, scenegraph=_dc.replace(cfg.scenegraph, **sg_kw))
    system = SlamSystem(cfg)
    system.scenegraph = SceneGraphManager(cfg.scenegraph, cfg.capacity)

    gt = []
    t0 = time.time()
    for gray, depth_img, sem, T_wc, ts in scene.frames_with_semantics(
        n_frames, kind="orbit2"
    ):
        system.scenegraph.provide_semantics(ts, sem)
        system.track_rgbd(jnp.asarray(gray), jnp.asarray(depth_img), ts)
        gt.append(np.asarray(T_wc)[4:7])
    system.flush()
    elapsed = time.time() - t0

    est = system.positions()
    rmse, _ = geometry.ate_rmse(jnp.asarray(est), jnp.asarray(np.stack(gt)))
    mask = system.tracked_mask()
    from collections import Counter

    ev = Counter(k for _, k, _ in system.events.records)
    # ATE over tracked frames only (untracked frames hold the last pose)
    rmse_tr, _ = geometry.ate_rmse(
        jnp.asarray(est[mask]), jnp.asarray(np.stack(gt)[mask])
    )
    # per-frame aligned error profile: where along the stream is the error?
    from visual_sgraphs.core import geometry as _geo
    from visual_sgraphs.core import lie as _lie

    gt_arr = jnp.asarray(np.stack(gt))
    est_arr = jnp.asarray(est)
    S = _geo.horn_sim3(est_arr, gt_arr, fix_scale=True)
    err = np.asarray(jnp.linalg.norm(
        _lie.sim3_apply(S, est_arr) - gt_arr, axis=-1
    ))
    q = np.quantile(err, [0.5, 0.9, 1.0])
    blocks = [round(float(np.sqrt(np.mean(e**2))), 3)
              for e in np.array_split(err, 8)]
    worst = np.argsort(err)[-8:][::-1]
    refs = [r[2] for r in system.trajectory]
    print(f"err med/p90/max = {q[0]:.3f}/{q[1]:.3f}/{q[2]:.3f} "
          f"rmse_by_8th={blocks} argmax={int(np.argmax(err))}")
    print("worst frames:",
          [(int(i), round(float(err[i]), 3), refs[i]) for i in worst])
    if os.environ.get("REPRO_EVENTS"):
        for _, k, pay in system.events.records:
            print(" ", k, pay)
    print(
        f"depth={depth} ate={float(rmse):.4f} "
        f"ate_tracked={float(rmse_tr):.4f} "
        f"tracked={int(mask.sum())}/{len(mask)} "
        f"n_kf={int(system.map.n_kf)} "
        f"kf_valid={int(jnp.sum(system.map.kf_valid))} "
        f"n_pt={int(system.map.n_pt)} "
        f"loops={system.loop_closer.n_loops_closed} "
        f"planes={int(jnp.sum(system.scenegraph.state.pl_valid))} "
        f"wall={elapsed:.1f}s events={dict(ev)}"
    )


if __name__ == "__main__":
    main()

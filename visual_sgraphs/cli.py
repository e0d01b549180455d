"""Command-line dataset runner — the launch-layer replacement.

The reference is driven by roslaunch files wiring topics into the node
mains (launch/*.launch, src/ros_*.cc) or by the non-ROS example mains
(orb_slam3/Examples/*).  Here one CLI runs a dataset directory end-to-end:

    python -m visual_sgraphs run --dataset tum --path <dir> \
        --out traj.txt [--eval] [--ply map.ply] [--profile]
    python -m visual_sgraphs run --dataset synthetic --frames 120 \
        --kind orbit --loop-closing --scenegraph --eval

Sensors: tum = RGB-D, euroc = stereo, kitti = stereo, synthetic = RGB-D.
``--eval`` Horn-aligns against the dataset ground truth and prints the ATE
RMSE (the evaluate_ate_scale.py harness, SURVEY §4/Le).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="visual_sgraphs")
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="run SLAM over a dataset directory")
    r.add_argument("--dataset", required=True,
                   choices=("tum", "euroc", "kitti", "synthetic"))
    r.add_argument("--path", default=None, help="dataset root directory")
    r.add_argument("--out", default=None, help="trajectory output file")
    r.add_argument("--format", default="tum",
                   choices=("tum", "euroc", "kitti"))
    r.add_argument("--n-features", type=int, default=1000)
    r.add_argument("--max-keyframes", type=int, default=256)
    r.add_argument("--max-points", type=int, default=65536)
    r.add_argument("--loop-closing", action="store_true")
    r.add_argument("--scenegraph", action="store_true")
    r.add_argument("--localization-only", action="store_true")
    r.add_argument("--load", default=None, help="checkpoint to resume from")
    r.add_argument("--save", default=None, help="checkpoint to write at end")
    r.add_argument("--ply", default=None, help="export map PLY here")
    r.add_argument("--sg-json", default=None, help="export scene-graph JSON")
    r.add_argument("--eval", action="store_true",
                   help="ATE RMSE vs dataset ground truth")
    r.add_argument("--profile", action="store_true",
                   help="per-stage timing report at exit")
    r.add_argument("--max-frames", type=int, default=0)
    # synthetic-only knobs
    r.add_argument("--frames", type=int, default=120)
    r.add_argument("--kind", default="arc",
                   choices=("arc", "forward", "orbit"))
    return p


def _make_system(args, cam, sensor):
    from visual_sgraphs.config import (
        CapacityConfig,
        OrbConfig,
        PlaceConfig,
        SystemConfig,
    )
    from visual_sgraphs.slam import SlamSystem

    cfg = SystemConfig(
        sensor=sensor,
        camera=cam,
        orb=OrbConfig(n_features=args.n_features),
        capacity=CapacityConfig(
            max_keyframes=args.max_keyframes, max_points=args.max_points
        ),
        loop_closing=args.loop_closing,
        localization_only=args.localization_only,
        profile=args.profile,
        place=PlaceConfig(),
    )
    system = SlamSystem(cfg)
    if args.scenegraph:
        from visual_sgraphs.scenegraph.manager import SceneGraphManager

        system.scenegraph = SceneGraphManager(cfg.scenegraph, cfg.capacity)
    return system


def cmd_run(args) -> int:
    from visual_sgraphs.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import numpy as np

    from visual_sgraphs.config import CameraConfig, Sensor

    gt = None
    if args.dataset == "synthetic":
        from visual_sgraphs.io.synthetic import SyntheticScene

        scene = SyntheticScene(h=480, w=640)
        system = _make_system(args, scene.cam, Sensor.RGBD)
        gt_list = []

        def frames():
            if args.scenegraph:
                for g, d, sem, T_wc, ts in scene.frames_with_semantics(
                    args.frames, kind=args.kind
                ):
                    system.scenegraph.provide_semantics(ts, sem)
                    gt_list.append(np.asarray(T_wc)[4:7])
                    yield ("rgbd", g, d, ts)
            else:
                for g, d, T_wc, ts in scene.frames(args.frames,
                                                   kind=args.kind):
                    gt_list.append(np.asarray(T_wc)[4:7])
                    yield ("rgbd", g, d, ts)

        stream = frames()
    elif args.dataset == "tum":
        from visual_sgraphs.io.tum import TumRgbdDataset

        ds = TumRgbdDataset(args.path)
        system = _make_system(args, CameraConfig(), Sensor.RGBD)
        gt = ds.gt_positions() if ds.groundtruth else None
        stream = (("rgbd", g, d, ts) for g, d, ts in ds)
    elif args.dataset == "euroc":
        from visual_sgraphs.io.euroc import EurocDataset

        ds = EurocDataset(args.path)
        cam = getattr(ds, "camera", None) or CameraConfig(
            fx=435.2, fy=435.2, cx=367.4, cy=252.2, width=752, height=480,
            bf=47.9,
        )
        system = _make_system(args, cam, Sensor.STEREO)
        gt = ds.gt_positions() if getattr(ds, "groundtruth", None) else None
        stream = (("stereo", l, r, ts) for l, r, ts in ds)
    else:  # kitti
        from visual_sgraphs.io.euroc import KittiOdometryDataset

        ds = KittiOdometryDataset(args.path)
        cam = getattr(ds, "camera", None) or CameraConfig(
            fx=718.9, fy=718.9, cx=607.2, cy=185.2, width=1241, height=376,
            bf=386.1,
        )
        system = _make_system(args, cam, Sensor.STEREO)
        gt = ds.gt_positions() if getattr(ds, "groundtruth", None) else None
        stream = (("stereo", l, r, ts) for l, r, ts in ds)

    if args.load:
        from visual_sgraphs.io.checkpoint import load_checkpoint

        load_checkpoint(args.load, system)
        print(f"resumed from {args.load}", file=sys.stderr)

    t0 = time.time()
    n = 0
    for kind, a, b, ts in stream:
        if kind == "rgbd":
            system.track_rgbd(a, b, ts)
        else:
            system.track_stereo(a, b, ts)
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
    system.flush()
    elapsed = time.time() - t0

    if args.out:
        fmt = {
            "tum": system.trajectory_tum,
            "euroc": system.trajectory_euroc,
            "kitti": system.trajectory_kitti,
        }[args.format]
        with open(args.out, "w") as f:
            f.write(fmt())
    if args.ply:
        system.export_ply(args.ply)
    if args.sg_json and system.scenegraph is not None:
        from visual_sgraphs.io.viz import export_scenegraph_json

        export_scenegraph_json(args.sg_json, system.scenegraph)
    if args.save:
        from visual_sgraphs.io.checkpoint import save_checkpoint

        save_checkpoint(args.save, system)

    report = {
        "frames": n,
        "fps": round(n / max(elapsed, 1e-9), 2),
        "n_keyframes": int(system.map.n_kf),
        "n_points": int(system.map.n_pt),
        "n_maps": len(system.atlas),
    }
    if system.loop_closer is not None:
        report["loops_closed"] = system.loop_closer.n_loops_closed
    if args.dataset == "synthetic":
        gt = np.stack(gt_list)
    if args.eval and gt is not None:
        import jax.numpy as jnp

        from visual_sgraphs.core import geometry

        est = system.positions()
        mask = system.tracked_mask()
        if args.dataset != "synthetic":
            # dataset GT is associated by order only when lengths match;
            # otherwise evaluate the tracked prefix
            k = min(len(est), len(gt))
            est, gtv, mask = est[:k], gt[:k], mask[:k]
        else:
            gtv = gt
        rmse, _ = geometry.ate_rmse(
            jnp.asarray(est[mask]), jnp.asarray(gtv[mask]),
            with_scale=system.cfg.sensor_is_monocular(),
        )
        report["ate_rmse_m"] = round(float(rmse), 4)
    print(json.dumps(report))
    if args.profile:
        print(system.timers.report(), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())

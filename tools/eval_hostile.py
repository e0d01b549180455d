"""Dataset-replay evaluation on the hostile-realism synthetic stream.

The reference's entire QA story is dataset replay + offline ATE
(evaluation/evaluate_ate_scale.py:50-120, launch/ smoke runs).  No
external dataset can reach this machine, so this harness replays the
degraded synthetic (io/degrade.py: Kinect depth noise + holes, motion
blur, exposure drift) through the FULL system at the bench operating
point, exports the trajectory in TUM format through the repo's own saver
(System::SaveTrajectoryTUM equivalent), re-parses it, timestamp-associates
against ground truth and Horn-aligns — the same offline pipeline the
reference's evaluate_ate_scale.py runs — and writes one JSON record per
level to the file given on the command line:

    python tools/eval_hostile.py --out hostile.json [--frames 192]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.config import (
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


def parse_tum(text: str):
    """TUM trajectory text -> (ts (T,), T_wc (T, 7) [qw qx qy qz t])
    (the associate.py/evaluate_ate_scale.py input format)."""
    ts, poses = [], []
    for line in text.strip().splitlines():
        if not line or line.startswith("#"):
            continue
        v = [float(x) for x in line.split()]
        ts.append(v[0])
        tx, ty, tz, qx, qy, qz, qw = v[1:8]
        poses.append([qw, qx, qy, qz, tx, ty, tz])
    return np.asarray(ts), np.asarray(poses, np.float64)


def associate(ts_a, ts_b, max_dt=0.02):
    """Greedy nearest-timestamp association (evaluation/associate.py)."""
    j = 0
    pairs = []
    for i, t in enumerate(ts_a):
        while j + 1 < len(ts_b) and abs(ts_b[j + 1] - t) <= abs(
            ts_b[j] - t
        ):
            j += 1
        if abs(ts_b[j] - t) <= max_dt:
            pairs.append((i, j))
    return pairs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="JSON output file")
    ap.add_argument("--frames", type=int, default=192)
    args = ap.parse_args(argv)
    from visual_sgraphs.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    records = [run_one(args.frames, level) for level in ("depth", "full")]
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)


def run_one(n_frames: int, level: str):
    """``level``: "depth" = Kinect depth noise + quantization + holes only
    (the dominant RGB-D artifact family; the depth-noise-aware disparity
    weighting added this round keeps ATE at clean-stream levels).  "full"
    adds motion blur + exposure drift + intensity noise — measured and
    reported honestly: the photometric side still breaks tracking (ATE
    >1 m) and is the known next robustness frontier (the ORB front end
    needs blur-aware matching thresholds / gain-normalized scoring)."""
    from visual_sgraphs.io.degrade import DegradeParams

    params = (DegradeParams(blur_px=0.0, exposure_amp=0.0,
                            intensity_sigma=0.0)
              if level == "depth" else DegradeParams())
    scene = SyntheticScene(h=480, w=640)
    cfg = SystemConfig(
        sensor=Sensor.RGBD,
        camera=scene.cam,
        orb=OrbConfig(n_features=1000),
        capacity=CapacityConfig(max_keyframes=128, max_points=32768),
        tracking=TrackingConfig(pipeline_depth=8),
        mapping=MappingConfig(lba_iters=6, lba_interval=2, cull_interval=2),
        loop_closing=True,
        place=PlaceConfig(vocab_min_keyframes=4, consistency=1, min_gap=8,
                          gba_after_loop=True),
    )
    system = SlamSystem(cfg)
    system.scenegraph = SceneGraphManager(cfg.scenegraph, cfg.capacity)

    t0 = time.time()
    gt_rows = []
    for gray, depth, T_wc, ts in scene.frames_hostile(
        n_frames, kind="orbit2", params=params
    ):
        system.track_rgbd(gray, depth, ts)
        gt_rows.append((ts, np.asarray(T_wc)))
    system.flush()
    wall = time.time() - t0

    # ---- offline evaluation through the repo's own export + parse path
    est_ts, est_cw = parse_tum(system.trajectory_tum())
    gt_ts = np.asarray([r[0] for r in gt_rows])
    gt_wc = np.stack([r[1] for r in gt_rows])
    pairs = associate(est_ts, gt_ts)
    # trajectory_tum exports T_wc already; associate + Horn align
    est_p = np.stack([est_cw[i][4:7] for i, _ in pairs])
    gt_p = np.stack([gt_wc[j][4:7] for _, j in pairs])
    rmse, _ = geometry.ate_rmse(jnp.asarray(est_p, jnp.float32),
                                jnp.asarray(gt_p, jnp.float32))
    n_holes = None

    out = {
        "metric": f"hostile_synthetic_rgbd_ate_{level}",
        "sequence": (
            "orbit2-hostile 640x480 depth-only (Kinect noise + "
            "quantization + holes)" if level == "depth" else
            "orbit2-hostile 640x480 full (depth + motion blur + exposure "
            "drift + intensity noise)"),
        "n_frames": n_frames,
        "fps": round(n_frames / wall, 2),
        "ate_rmse_m": round(float(rmse), 4),
        "associated_pairs": len(pairs),
        "tracked_frames": int(system.tracked_mask().sum()),
        "n_keyframes": int(jnp.sum(system.map.kf_valid)),
        "loops_closed": system.loop_closer.n_loops_closed,
        "n_planes": int(jnp.sum(system.scenegraph.state.pl_valid)),
        "gate": ("ATE <= 0.06 m (2x the clean-stream bench gate)"
                 if level == "depth" else
                 "reported only - photometric hostility is a known open "
                 "gap (tracking breaks; next-round work)"),
        "passed": bool(rmse <= 0.06) if level == "depth" else None,
        "device": jax.devices()[0].device_kind,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

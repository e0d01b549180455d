"""Long-stream harness: loop closure across a multi-hundred-keyframe gap.

Demonstrates place recognition at range — K >= 512 live
keyframes, a loop verified across a >= 300-keyframe sequence gap, no
capacity eviction (the reference never evicts for capacity; it only culls
redundant KFs, LocalMapping.cc:898).  Runs one 1.25-lap "bigloop" pass
through the 24x20 m synthetic hall (io/synthetic.py) on the default
backend and writes its JSON record to the file given on the command line:

    python tools/long_range_loop.py --out longrun.json [--frames 1600]
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
from visual_sgraphs.slam import SlamSystem


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="JSON output file")
    ap.add_argument("--frames", type=int, default=1600)
    args = ap.parse_args(argv)
    from visual_sgraphs.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    n_frames = args.frames
    scene = SyntheticScene(h=240, w=320, room="hall")
    cfg = SystemConfig(
        sensor=Sensor.RGBD,
        camera=scene.cam,
        orb=OrbConfig(n_features=600),
        capacity=CapacityConfig(max_keyframes=512, max_points=65536,
                                max_retired=4096),
        # force a keyframe at least every 4 frames: one 1.25-lap pass then
        # holds >= 300 keyframes per lap, so the closure spans the target
        # multi-hundred-KF gap (without forcing, confident tracking spaces
        # keyframes ~8 frames apart and the lap holds only ~150)
        tracking=TrackingConfig(pipeline_depth=8, kf_max_interval=4),
        mapping=MappingConfig(lba_iters=6, lba_interval=2, cull_interval=4),
        loop_closing=True,
        # train the vocabulary late (24 KFs ~ 14k descriptors) so the
        # data-driven depth rule grants the full 8^4 tree — at 400+ live
        # keyframes the deeper tree's retrieval discrimination is what
        # keeps the multi-hundred-KF-gap query sharp
        place=PlaceConfig(vocab_min_keyframes=24, consistency=1, min_gap=40,
                          gba_after_loop=False, loop_local_ba=True),
    )
    system = SlamSystem(cfg)
    t0 = time.time()
    gt = []
    for i, (gray, depth, T_wc, ts) in enumerate(
        scene.frames(n_frames, kind="bigloop")
    ):
        system.track_rgbd(jnp.asarray(gray), jnp.asarray(depth), ts)
        gt.append(np.asarray(T_wc)[4:7])
    system.flush()
    wall = time.time() - t0

    est = system.positions()
    rmse, _ = geometry.ate_rmse(jnp.asarray(est),
                                jnp.asarray(np.stack(gt)))
    kf_seq = np.asarray(system.map.kf_seq)
    evts = [(k, p) for _, k, p in system.events.records]
    verified = [p for k, p in evts if k == "loop_verified"]
    closed = [p for k, p in evts if k == "loop_closed"]
    evictions = sum(1 for k, _ in evts if k == "capacity_evict")
    gaps = []
    for p in verified:
        kf, cand = p["kf"], p["cand"]
        if kf < len(kf_seq) and cand < len(kf_seq):
            gaps.append(int(abs(kf_seq[kf] - kf_seq[cand])))
    out = {
        "metric": "long_range_loop_closure",
        "n_frames": n_frames,
        "wall_s": round(wall, 1),
        "fps": round(n_frames / wall, 2),
        "ate_rmse_m": round(float(rmse), 4),
        "n_keyframes_live": int(jnp.sum(system.map.kf_valid)),
        "n_keyframes_created": int(system.map.n_kf),
        "capacity_evictions": evictions,
        "loops_verified": len(verified),
        "loops_closed": len(closed),
        "loop_gaps_kf_seq": sorted(gaps, reverse=True)[:8],
        "max_gap": max(gaps) if gaps else 0,
        "tracked_frames": int(system.tracked_mask().sum()),
        "device": jax.devices()[0].device_kind,
    }
    print(json.dumps(out))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()

"""Benchmark: end-to-end RGB-D SLAM frames/sec on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

The reference's real-time operating point is 30 fps on a desktop CPU
(BASELINE.md: TUM camera rate, tracking designed to keep up).
``vs_baseline`` is therefore measured fps / 30.  The run covers the FULL
system — ORB extraction, local-map tracking (B-frame pipelined device
scans), keyframe insertion, local BA with scene-graph plane/room factors,
plane detection + association + semantic voting, place recognition with
loop closure and global BA — on the headline stream of
``visual_sgraphs.workloads``: a synthetic 640x480 RGB-D orbit with 1000
features (TUM1.yaml budget) that revisits its start.  Beside it: the
RGB-D + IMU row and the global-BA time per iteration.  It needs a GPU and
fails without one.
"""

from __future__ import annotations

import json
import sys
import time


def main() -> int:
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        print("bench: no GPU; this benchmark measures the card only",
              file=sys.stderr)
        return 1

    from visual_sgraphs.parallel import make_mesh, sharded_ba_grouped
    from visual_sgraphs.utils.card import card_lines
    from visual_sgraphs.utils.compile_cache import enable_compile_cache
    from visual_sgraphs.workloads import gba_problem, run_headline, run_inertial

    enable_compile_cache()
    head = run_headline()
    system = head.system

    # per-card BA throughput (BASELINE.md metric "BA ms/iter per chip"):
    # the landmark-sharded GN engine on a KITTI-scale problem (K=128,
    # N=32768, 8 obs/landmark), 10 post-compile iterations
    prob = gba_problem()
    mesh = make_mesh(1)

    def ba_run():
        return jax.block_until_ready(
            sharded_ba_grouped(**prob, mesh=mesh, iters=10))

    ba_run()  # compile
    t0 = time.perf_counter()
    ba_run()
    ba_ms_per_iter = 1e3 * (time.perf_counter() - t0) / 10

    inertial = run_inertial()
    d = jax.devices()
    print(json.dumps({
        "metric": "rgbd_slam_fps_640x480_1000feat_loop_sg",
        "value": head.steady_fps,
        "unit": "frames/s",
        "vs_baseline": head.steady_fps / 30.0,
        "ate_rmse_m": head.ate_rmse_m,
        "n_keyframes": int(system.map.n_kf),
        "n_points": int(system.map.n_pt),
        "n_planes": int(jnp.sum(system.scenegraph.state.pl_valid)),
        "loops_closed": system.loop_closer.n_loops_closed,
        "tracked_frames": head.tracked_frames,
        "warmup_s_incl_compile": head.warmup_s,
        "ba_ms_per_iter_card": ba_ms_per_iter,
        "inertial": {"metric": "rgbd_inertial_fps_640x480_1000feat",
                     **inertial},
        "events": head.events,
        "stages": system.timers.summary(),
        "device": {"platform": d[0].platform, "kind": d[0].device_kind,
                   "count": len(d), "cards": card_lines()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

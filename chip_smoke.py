"""Smoke test of the SLAM main path on one NVIDIA GPU.

    python chip_smoke.py           # every phase, one card
    python chip_smoke.py --four    # only the sharded global BA, 4 cards vs 1

The phases run in one process, so they share one compile cache and one
card (a second JAX process on the card fails for want of memory):

1. device     - the default JAX device is a GPU; its name, power limit and
                memory.  Without a GPU the script stops here, non-zero.
2. headline   - ``SlamSystem.track_rgbd`` over the headline stream
                (``visual_sgraphs.workloads``): 192 frames of 640x480
                RGB-D, 1000 features, the B=8 cycle program, loop closing
                with global BA, the scene graph.
3. inertial   - the RGB-D + IMU row through the serial per-frame solve.
4. cli        - the dataset runner (``visual_sgraphs.cli``) in-process, on
                the default ``pipeline_depth=1`` fused path.
5. precision  - each geometric op on the GPU at default matmul precision
                and at "highest", against the CPU backend in float32.
6. gba        - the landmark-sharded global BA on a one-card mesh.

Each phase prints one line labelled with the card's name and power limit,
its measurements and its gates (value, limit, ok).  The last line,
``{"ok": true, "device": {...}}``, is printed only when every gate of every
phase passed; otherwise the exit code is 1.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import sys
import time
import traceback

import numpy as np

PHASES = ("headline", "inertial", "cli", "precision", "gba")

# ---- gates, each with its reason
HEADLINE_ATE_M = 0.05  # the bench gate (tests/test_pipeline.py)
ROW_ATE_M = 0.10  # inertial and cli rows: 2x the headline gate
# descriptors match at <= 50 of 256 differing bits (ORBmatcher TH_LOW), so
# 1 % of keypoints or of descriptor bits changing leaves matching intact
ORB_SHARE = 0.99
# pose_only_gn: 1e-4 rad is 0.05 px at fx=520; 1e-4 m is 1/500 of the
# headline ATE gate
POSE_RAD = 1e-4
POSE_M = 1e-4
# BA and PGO: relative final-cost difference; a TF32 contraction (about
# three decimal digits) shows up above it
COST_REL = 1e-3
# LBA and PGO keyframe positions: 1 mm, 1/50 of the headline ATE gate
KF_POS_M = 1e-3
# GBA on 4 cards against 1: only the order of the psum's float32 sums
# differs.  Poses: quaternion components and metres.  Points: distance
# relative to the point's range; a landmark 8 m away seen over a few cm of
# baseline is ill-conditioned in depth, and on a 4-device CPU mesh the
# reordering moves it by up to 1.2e-4 of its range, so 1e-3 leaves margin
MESH_POSE = 1e-4
MESH_POINT_REL = 1e-3


class NoAccelerator(RuntimeError):
    pass


def _gate(value, limit, ok) -> dict:
    return {"value": value, "limit": limit, "ok": bool(ok)}


def phase_device() -> dict:
    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoAccelerator(
            f"default JAX device is {devs[0].platform!r}, not a GPU")
    x = jnp.arange(4.0)
    x.copy_to_host_async()  # the cycle program's readback prefetch
    np.asarray(x)
    stats = devs[0].memory_stats() or {}
    return {
        "metrics": {
            "device_kind": devs[0].device_kind,
            "count": len(devs),
            "jax": jax.__version__,
            "memory": {k: stats[k] for k in (
                "bytes_limit", "bytes_in_use", "peak_bytes_in_use")
                if k in stats},
        },
        "gates": {},
    }


def phase_headline(**sizes) -> tuple[dict, object]:
    """``sizes``: keyword arguments of ``workloads.run_headline``."""
    import jax.numpy as jnp

    from visual_sgraphs.workloads import run_headline

    r = run_headline(**sizes)
    s = r.system
    n_frames = len(s.trajectory)
    metrics = {
        "ate_rmse_m": r.ate_rmse_m,
        "tracked_frames": r.tracked_frames,
        "frames": n_frames,
        "loops_closed": s.loop_closer.n_loops_closed,
        "n_keyframes": int(s.map.n_kf),
        "n_points": int(s.map.n_pt),
        "n_planes": int(jnp.sum(s.scenegraph.state.pl_valid)),
        "warmup_s_incl_compile": r.warmup_s,
        "steady_fps": r.steady_fps,
        "events": r.events,
        "stages": s.timers.summary(),
    }
    gates = {
        "all_frames_tracked": _gate(r.tracked_frames, n_frames,
                                    r.tracked_frames == n_frames),
        "loops_closed": _gate(metrics["loops_closed"], 1,
                              metrics["loops_closed"] >= 1),
        "global_ba_events": _gate(r.events.get("global_ba", 0), 1,
                                  r.events.get("global_ba", 0) >= 1),
        "ate_rmse_m": _gate(r.ate_rmse_m, HEADLINE_ATE_M,
                            r.ate_rmse_m <= HEADLINE_ATE_M),
    }
    return {"metrics": metrics, "gates": gates}, s


def phase_inertial(**sizes) -> dict:
    """``sizes``: keyword arguments of ``workloads.run_inertial``."""
    from visual_sgraphs.workloads import run_inertial

    r = run_inertial(**sizes)
    return {
        "metrics": r,
        "gates": {
            "imu_initialized": _gate(r["imu_initialized"], True,
                                     r["imu_initialized"]),
            "ate_rmse_m": _gate(r["ate_rmse_m"], ROW_ATE_M,
                                r["ate_rmse_m"] <= ROW_ATE_M),
        },
    }


def phase_cli(frames: int = 120, n_features: int = 1000) -> dict:
    from visual_sgraphs import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["run", "--dataset", "synthetic", "--frames",
                       str(frames), "--kind", "orbit", "--loop-closing",
                       "--scenegraph", "--eval",
                       "--n-features", str(n_features)])
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    ate = report["ate_rmse_m"]
    return {
        "metrics": report,
        "gates": {
            "exit_code": _gate(rc, 0, rc == 0),
            "ate_rmse_m": _gate(ate, ROW_ATE_M, ate <= ROW_ATE_M),
        },
    }


# ---------------------------------------------------------------- precision


def _run_on(device, fn, *args, highest: bool = False):
    """``fn(*args)`` with its inputs on ``device``, results as numpy."""
    import jax

    args = jax.device_put(args, device)
    prec = (jax.default_matmul_precision("highest") if highest
            else contextlib.nullcontext())
    with jax.default_device(device), prec:
        out = jax.block_until_ready(fn(*args))
    return jax.tree.map(np.asarray, out)


def _three_ways(dev, ref, fn, *args):
    """(device at default precision, device at highest, reference)."""
    return (_run_on(dev, fn, *args), _run_on(dev, fn, *args, highest=True),
            _run_on(ref, fn, *args, highest=True))


def _compare(runs, metric, limit) -> tuple[dict, dict]:
    """Metrics and gate of one comparison: ``metric(out, ref)`` for the
    default- and highest-precision runs; the gate holds the library's own
    (default) configuration to ``limit``."""
    d, h, r = runs
    md, mh = metric(d, r), metric(h, r)
    return ({"default": md, "highest": mh, "limit": limit},
            _gate(md, limit, md <= limit))


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def _quat_angle(qa, qb) -> float:
    """Rotation angle (rad) between unit quaternions [w, x, y, z]."""
    qa = np.asarray(qa, np.float64)
    qb = np.asarray(qb, np.float64)
    d = abs(float(np.dot(qa / np.linalg.norm(qa), qb / np.linalg.norm(qb))))
    return float(2.0 * np.arccos(min(d, 1.0)))


def _centres(T_cw):
    """Camera centres -Rᵀt (K, 3) of T_cw poses [qw qx qy qz t], float64."""
    T = np.asarray(T_cw, np.float64)
    q = T[:, :4] / np.linalg.norm(T[:, :4], axis=1, keepdims=True)
    w, v, t = q[:, :1], q[:, 1:], T[:, 4:7]
    # Rᵀt rotates t by the conjugate quaternion
    uv = np.cross(-v, t)
    return -(t + 2.0 * (w * uv + np.cross(-v, uv)))


def _orb_agreement(a, b) -> tuple[float, float]:
    """(share of keypoints found by both, share of equal descriptor bits
    over the shared keypoints)."""
    def table(kp):
        ok = kp.valid
        keys = zip(np.round(kp.uv[ok] * 8).astype(int).tolist(),
                   kp.level[ok].tolist())
        return {(tuple(uv), lv): d for (uv, lv), d in zip(keys, kp.desc[ok])}

    ta, tb = table(a), table(b)
    common = ta.keys() & tb.keys()
    kp_share = len(common) / max(len(ta), len(tb), 1)
    if not common:
        return kp_share, 0.0
    x = np.stack([ta[k] ^ tb[k] for k in common])
    bits = np.unpackbits(x, axis=1).sum()
    return kp_share, 1.0 - bits / (256.0 * len(common))


def phase_precision(system, m_obs: int = 1000, n_desc: tuple = (1000, 4096),
                    gba_sizes: tuple = (128, 32768, 8), orb_hw=(480, 640),
                    device=None, ref_device=None, seed: int = 0) -> dict:
    """GPU results at default and at highest matmul precision against the
    CPU backend (float32, highest) at real widths.  ``system`` is a
    finished headline run: its map gives the local-BA and PGO inputs."""
    import jax
    import jax.numpy as jnp

    from visual_sgraphs.core import lie
    from visual_sgraphs.features import OrbParams, extract_orb
    from visual_sgraphs.features.match import hamming_matrix
    from visual_sgraphs.io.synthetic import SyntheticScene
    from visual_sgraphs.optim.fast_ba import fast_local_ba
    from visual_sgraphs.parallel.dist_ba import AXIS, sharded_ba_grouped
    from visual_sgraphs.place import pgo
    from visual_sgraphs.slam.tracking import pose_only_gn
    from visual_sgraphs.workloads import gba_problem

    dev = device or jax.devices()[0]
    ref = ref_device or jax.devices("cpu")[0]
    rng = np.random.default_rng(seed)
    metrics, gates = {}, {}

    def record(name, runs, metric, limit):
        metrics[name], gates[name] = _compare(runs, metric, limit)

    # hamming_matrix: {0,1} operands and integer sums are exact in TF32
    da = rng.integers(0, 256, (n_desc[0], 32), dtype=np.uint8)
    db = rng.integers(0, 256, (n_desc[1], 32), dtype=np.uint8)
    record("hamming_max_abs", _three_ways(dev, ref, jax.jit(hamming_matrix),
                                          da, db),
           lambda o, r: int(np.max(np.abs(o.astype(np.int64) - r))), 0)

    # extract_orb on one headline frame
    scene = SyntheticScene(h=orb_hw[0], w=orb_hw[1])
    gray = next(iter(scene.frames(2, kind="orbit2")))[0]
    orb = jax.jit(functools.partial(extract_orb, params=OrbParams(
        n_features=system.cfg.orb.n_features)))
    runs = _three_ways(dev, ref, orb, np.asarray(gray, np.float32))
    metrics["orb_shares"] = {
        "default": _orb_agreement(runs[0], runs[2]),
        "highest": _orb_agreement(runs[1], runs[2]),
        "limit": ORB_SHARE,
    }
    kp_share, bit_share = metrics["orb_shares"]["default"]
    gates["orb_keypoint_share"] = _gate(kp_share, ORB_SHARE,
                                        kp_share >= ORB_SHARE)
    gates["orb_descriptor_bit_share"] = _gate(bit_share, ORB_SHARE,
                                              bit_share >= ORB_SHARE)

    # pose_only_gn at M observations, RGB-D rows, 10 % outliers
    cam_K = np.asarray(system.cam_K, np.float32)
    bf = np.asarray(system.cam_bf, np.float32)
    xw = rng.uniform([-3.0, -2.0, 1.5], [3.0, 2.0, 6.0], (m_obs, 3))
    T_true = np.asarray(lie.se3_exp(jnp.asarray(
        rng.normal(size=6) * 0.05, jnp.float32)))
    p = np.asarray(lie.se3_apply(jnp.asarray(T_true), jnp.asarray(
        xw, jnp.float32)))
    uv = np.stack([cam_K[0] * p[:, 0] / p[:, 2] + cam_K[2],
                   cam_K[1] * p[:, 1] / p[:, 2] + cam_K[3]], axis=1)
    uv = uv + rng.normal(size=uv.shape) * 0.5
    out = rng.random(m_obs) < 0.1
    uv[out] += rng.normal(size=(int(out.sum()), 2)) * 40.0
    T_init = np.asarray(lie.se3_boxplus(jnp.asarray(T_true), jnp.asarray(
        rng.normal(size=6) * [0.01, 0.01, 0.01, 0.005, 0.005, 0.005],
        jnp.float32)))

    @jax.jit
    def gn(T, xw, uv, valid, cam_K, depth, bf):
        return pose_only_gn(T, xw, uv, valid, cam_K, iters=12,
                            gate0=(2.0 * 15.0) ** 2, depth=depth, bf=bf)

    runs = _three_ways(dev, ref, gn, T_init, xw.astype(np.float32),
                       uv.astype(np.float32), np.ones(m_obs, bool), cam_K,
                       p[:, 2].astype(np.float32), bf)
    record("pose_only_gn_rot_rad", runs,
           lambda o, r: _quat_angle(o[0][:4], r[0][:4]), POSE_RAD)
    record("pose_only_gn_trans_m", runs,
           lambda o, r: float(np.linalg.norm(o[0][4:7] - r[0][4:7])),
           POSE_M)

    # fast_local_ba on the headline's final map, newest keyframe
    m = system.map
    seq = np.where(np.asarray(m.kf_valid), np.asarray(m.kf_seq), -1)
    kf_new, kf_old = int(np.argmax(seq)), int(np.argmin(
        np.where(seq >= 0, seq, np.iinfo(np.int64).max)))
    mcfg = system.cfg.mapping
    lba = jax.jit(functools.partial(fast_local_ba, n_window=mcfg.local_window,
                                    iters=mcfg.lba_iters))
    runs = _three_ways(dev, ref, lba, m, np.int32(kf_new), cam_K, bf)
    record("local_ba_cost_rel", runs, lambda o, r: _rel(o[1], r[1]),
           COST_REL)
    record("local_ba_kf_pos_m", runs, lambda o, r: float(np.max(
        np.linalg.norm(_centres(o[0].kf_pose) - _centres(r[0].kf_pose),
                       axis=1))), KF_POS_M)

    # optimize_essential_graph over the headline's keyframes: a loop edge
    # newest -> oldest carrying a 2 cm / 0.3 degree drift correction
    pcfg = system.cfg.place

    @jax.jit
    def essential_graph(m, i, j, drift):
        S = jax.vmap(lie.sim3_from_se3)(m.kf_pose)
        S_ji = lie.sim3_multiply(
            lie.sim3_from_se3(lie.se3_exp(drift)),
            lie.sim3_multiply(S[j], lie.sim3_inverse(S[i])))
        edges = pgo.build_covis_edges(
            m, min_weight=pcfg.essential_min_weight,
            max_edges=min(pcfg.essential_max_edges, m.K * m.K))
        fixed = jnp.zeros((m.K,), bool).at[i].set(True)
        return pgo.optimize_essential_graph(
            m.kf_pose, m.kf_valid, edges, loop_i=i, loop_j=j,
            S_loop_ji=S_ji, fixed=fixed, iters=pcfg.pgo_iters,
            fix_scale=True)

    drift = np.asarray([0.02, 0.0, 0.0, 0.0, 0.005, 0.0], np.float32)
    runs = _three_ways(dev, ref, essential_graph, m, np.int32(kf_old),
                       np.int32(kf_new), drift)
    valid = np.asarray(m.kf_valid)
    # the converged graph's final cost is rounding noise near zero, so the
    # difference is measured against the initial cost the solve removes
    record("essential_graph_cost_rel", runs,
           lambda o, r: abs(float(o.cost) - float(r.cost))
           / max(float(r.cost0), 1e-30), COST_REL)
    record("essential_graph_kf_pos_m", runs, lambda o, r: float(np.max(
        np.linalg.norm(_centres(o.kf_pose) - _centres(r.kf_pose),
                       axis=1)[valid])), KF_POS_M)

    # sharded_ba_grouped on a one-device mesh at the GBA problem
    from jax.sharding import Mesh

    prob = gba_problem(*gba_sizes, seed=seed)

    def gba(device):
        mesh = Mesh(np.asarray([device]), (AXIS,))
        return lambda kw: sharded_ba_grouped(**kw, mesh=mesh, iters=10)

    runs = (_run_on(dev, gba(dev), prob),
            _run_on(dev, gba(dev), prob, highest=True),
            _run_on(ref, gba(ref), prob, highest=True))
    record("gba_cost_rel", runs, lambda o, r: _rel(o[2][-1], r[2][-1]),
           COST_REL)
    return {"metrics": metrics, "gates": gates}


# ---------------------------------------------------------------------- GBA


def _time_gba(prob, mesh, iters: int, repeats: int):
    """(poses, points, costs) of one solve and the median seconds per
    iteration over ``repeats`` solves after the compiling one."""
    import jax

    from visual_sgraphs.parallel import sharded_ba_grouped

    def run():
        return jax.block_until_ready(
            sharded_ba_grouped(**prob, mesh=mesh, iters=iters))

    out = run()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) / iters)
    return [np.asarray(x) for x in out], float(np.median(times))


def phase_gba(n_kf: int = 128, n_pt: int = 32768, n_obs: int = 8,
              iters: int = 10, repeats: int = 3) -> dict:
    from visual_sgraphs.parallel import make_mesh
    from visual_sgraphs.workloads import gba_problem

    (_, _, costs), s_iter = _time_gba(gba_problem(n_kf, n_pt, n_obs),
                                      make_mesh(1), iters, repeats)
    return {
        "metrics": {"K": n_kf, "N": n_pt, "O": n_obs, "iters": iters,
                    "ms_per_iter": 1e3 * s_iter,
                    "cost_first": float(costs[0]),
                    "cost_last": float(costs[-1])},
        "gates": {
            "costs_finite": _gate(bool(np.all(np.isfinite(costs))), True,
                                  np.all(np.isfinite(costs))),
            "cost_decreases": _gate(float(costs[-1]), float(costs[0]),
                                    costs[-1] < costs[0]),
        },
    }


def phase_four(n_kf: int = 128, n_pt: int = 32768, n_obs: int = 8,
               iters: int = 10, repeats: int = 3, n_dev: int = 4) -> dict:
    """The landmark-sharded GBA on an ``n_dev``-card mesh against the
    one-card mesh, in one process."""
    import jax

    from visual_sgraphs.parallel import make_mesh
    from visual_sgraphs.workloads import gba_problem

    devs = jax.devices()[:n_dev]
    n_distinct = len({d.id for d in devs})
    prob = gba_problem(n_kf, n_pt, n_obs)
    (p1, x1, c1), s1 = _time_gba(prob, make_mesh(1), iters, repeats)
    (pn, xn, cn), sn = _time_gba(prob, make_mesh(n_dev), iters, repeats)
    d_pose = float(np.max(np.abs(pn - p1)))
    d_pt = float(np.max(np.linalg.norm(xn - x1, axis=1)
                        / np.maximum(np.linalg.norm(x1, axis=1), 1e-6)))
    d_cost = _rel(cn[-1], c1[-1])
    return {
        "metrics": {"K": n_kf, "N": n_pt, "O": n_obs, "iters": iters,
                    "devices": [str(d) for d in devs],
                    "ms_per_iter_1": 1e3 * s1,
                    f"ms_per_iter_{n_dev}": 1e3 * sn},
        "gates": {
            "distinct_cards": _gate(n_distinct, n_dev, n_distinct == n_dev),
            "pose_max_abs": _gate(d_pose, MESH_POSE, d_pose <= MESH_POSE),
            "point_max_rel": _gate(d_pt, MESH_POINT_REL,
                                   d_pt <= MESH_POINT_REL),
            "cost_rel": _gate(d_cost, COST_REL, d_cost <= COST_REL),
        },
    }


# --------------------------------------------------------------------- main


def _report(label: str, name: str, result: dict) -> bool:
    ok = all(g["ok"] for g in result["gates"].values())
    print(f"[{label}] {name} {'PASS' if ok else 'FAIL'} "
          f"{json.dumps(result, default=str)}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded GBA against 1 card")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    try:
        device = phase_device()
    except NoAccelerator as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    import jax

    from visual_sgraphs.utils.card import card_lines
    from visual_sgraphs.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cards = card_lines()
    label = cards[0]
    for line in cards:
        print(f"card: {line}", flush=True)
    ok = _report(label, "device", device)

    if args.four:
        runs = [("four", phase_four)]
    else:
        state = {}

        def headline():
            result, state["system"] = phase_headline()
            return result

        def precision():
            if "system" not in state:
                raise RuntimeError("precision needs the headline phase")
            return phase_precision(state["system"])

        table = {"headline": headline, "inertial": phase_inertial,
                 "cli": phase_cli, "precision": precision,
                 "gba": phase_gba}
        runs = [(p, table[p]) for p in PHASES if p in phases]

    for name, fn in runs:
        print(f"[{label}] {name} start", flush=True)
        t0 = time.perf_counter()
        try:
            result = fn()
        except Exception:  # a failed phase fails the run; the next still runs
            traceback.print_exc()
            print(f"[{label}] {name} FAIL raised", flush=True)
            ok = False
            continue
        result["metrics"]["phase_s"] = time.perf_counter() - t0
        ok = _report(label, name, result) and ok

    if not ok:
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

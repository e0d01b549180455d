"""Joint scene-graph bundle adjustment: keyframes + points + planes +
rooms + doors.

The vS-Graphs extension of local BA (Optimizer::LocalBundleAdjustment with
plane/room/door vertices and factors, Optimizer.cc:1454-2455): plane
vertices use the minimal azimuth/elevation/distance chart (g2o VertexPlane
equivalent), and the full factor set couples them to the visual graph:

- plane-KF observation factors ``(T_kf · π_world) ⊖ π_measured`` weighted by
  observation confidence (EdgeVertexPlaneProjectSE3KF,
  OptimizableTypes.h:336-374, added at Optimizer.cc:2087-2101);
- plane-point quadric factors ``e = πᵀ_local G_ij π_local`` with the Gij
  point quadric accumulated per observation (EdgeSE3KFPointToPlane,
  OptimizableTypes.h:296-330, added at Optimizer.cc:2112-2127;
  accumulation GeoSemHelpers.cc:24-35) — gated by the
  ``plane_point_factor`` config (SystemParams optimization.plane_point);
- point-on-plane factors tying map points near a plane to its surface
  (EdgeVertexPlaneProjectPointXYZ, OptimizableTypes.h:379-399, added at
  Optimizer.cc:2049-2059) — gated by ``plane_map_point_factor``;
- room-center factors: corridor-center-from-2-walls and
  room-center-from-4-walls (EdgeVertex2/4PlaneProjectSE3Room,
  OptimizableTypes.h:452-557, added at Optimizer.cc:2184-2215) with room
  centers as free 3-dof vertices;
- door-room rigidity factors (EdgeSE3DoorProjectSE3Room,
  OptimizableTypes.h:266-290, Optimizer.cc:461-498) keeping each door at
  its build-time offset from its nearest room center.

Outlier handling matches the reference's chi2 erasure after the solve
(Optimizer.cc:2290-2380): plane observations whose plane-KF chi2 exceeds
the gate are invalidated in the observation table.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.config import SceneGraphConfig
from visual_sgraphs.core import plane as plane_mod
from visual_sgraphs.optim import (
    FactorBatch,
    GraphProblem,
    factors,
    optimize,
    plane_family,
    point_family,
    se3_family,
)
from visual_sgraphs.optim.graph import batch_chi2
from visual_sgraphs.scenegraph.state import SceneGraphState
from visual_sgraphs.slam.map_state import MapState, covisibility_counts

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
CHI2_PLANE = 7.815  # plane-KF gate (Optimizer.cc:2344)
CHI2_PLANE_POINT = 3.841  # plane-point gate (Optimizer.cc:2357)


@functools.partial(jax.jit, static_argnames=("n_window", "n_local_pts",
                                             "iters", "config"))
def scenegraph_local_ba(
    m: MapState,
    sg: SceneGraphState,
    kf_id: jax.Array,
    cam_K: jax.Array,
    cam_bf: jax.Array,
    plane_info: jax.Array = None,  # () weight multiplier for plane factors
    n_window: int = 10,
    n_local_pts: int = 8192,
    iters: int = 10,
    config: SceneGraphConfig = SceneGraphConfig(),
) -> tuple[MapState, SceneGraphState, jax.Array]:
    """Local BA with plane/room/door vertices and the vS-Graphs factor set.

    Returns (map, scenegraph, final_cost).  Planes observed by local
    keyframes are free variables; others fixed.  Writes back keyframe poses,
    point positions, plane equations, room centers and door poses
    (Optimizer.cc:2416-2454), and erases plane observations that fail the
    chi2 gate (:2344-2370).
    """
    if plane_info is None:
        plane_info = jnp.asarray(1.0, jnp.float32)

    counts = covisibility_counts(m, kf_id)
    top_counts, top_kfs = jax.lax.top_k(counts, n_window)
    kf_ids = jnp.concatenate([kf_id[None], top_kfs])
    kf_mask = jnp.concatenate([jnp.ones((1,), bool), top_counts > 0])
    kf_mask = kf_mask & m.kf_valid[kf_ids]
    L = kf_ids.shape[0]

    # ---- visual part (same assembly as mapping.local_ba)
    obs = m.kf_obs_pt[kf_ids]
    obs_ok = m.kf_kp_valid[kf_ids] & kf_mask[:, None] & (obs >= 0)
    obs_safe = jnp.maximum(obs, 0)
    obs_ok = obs_ok & m.pt_valid[obs_safe]
    member = jnp.zeros((m.N + 1,), bool).at[
        jnp.where(obs_ok, obs, -1).reshape(-1) + 1
    ].set(True).at[0].set(False)
    (local_pt,) = jnp.nonzero(member[1:], size=n_local_pts, fill_value=-1)
    pt_ok = local_pt >= 0
    safe_pt = jnp.maximum(local_pt, 0)
    inv = jnp.full((m.N + 1,), -1, jnp.int32).at[safe_pt + 1].set(
        jnp.where(pt_ok, jnp.arange(n_local_pts, dtype=jnp.int32), -1)
    )
    pt_local_idx = inv[obs_safe + 1]
    use = obs_ok & (pt_local_idx >= 0)

    kf_rows = jnp.broadcast_to(jnp.arange(L)[:, None], obs.shape)
    var_idx = jnp.stack(
        [kf_rows.reshape(-1), jnp.maximum(pt_local_idx, 0).reshape(-1)],
        axis=1,
    ).astype(jnp.int32)
    uv = m.kf_uv[kf_ids].reshape(-1, 2)
    depth = m.kf_depth[kf_ids].reshape(-1)
    mtot = var_idx.shape[0]
    use_flat = use.reshape(-1)
    has_depth = depth > 0
    z = jnp.maximum(depth, 1e-3)
    uv_ur = jnp.concatenate([uv, (uv[:, :1] - cam_bf / z[:, None])], axis=1)
    batches = [
        FactorBatch(
            families=("kf", "pt"),
            residual_fn=factors.reproj_mono,
            res_dim=2,
            var_idx=var_idx,
            const={"uv": uv, "cam": jnp.broadcast_to(cam_K, (mtot, 4))},
            info=jnp.ones((mtot,), jnp.float32),
            valid=use_flat & ~has_depth,
            huber=float(np.sqrt(CHI2_MONO)),
            chi2_gate=CHI2_MONO * 2,
        ),
        FactorBatch(
            families=("kf", "pt"),
            residual_fn=factors.reproj_stereo,
            res_dim=3,
            var_idx=var_idx,
            const={
                "uv_ur": uv_ur,
                "cam": jnp.broadcast_to(cam_K, (mtot, 4)),
                "bf": jnp.broadcast_to(cam_bf, (mtot,)),
            },
            info=jnp.ones((mtot,), jnp.float32),
            valid=use_flat & has_depth,
            huber=float(np.sqrt(CHI2_STEREO)),
            chi2_gate=CHI2_STEREO * 2,
        ),
    ]

    # ---- plane-KF observation factors over the *local* keyframes
    # map each observation's kf id to its local row (or -1)
    kf_inv = jnp.full((m.K,), -1, jnp.int32).at[kf_ids].set(
        jnp.where(kf_mask, jnp.arange(L, dtype=jnp.int32), -1)
    )
    ob_local_kf = kf_inv[jnp.clip(sg.ob_kf, 0, m.K - 1)]
    ob_use = sg.ob_valid & (sg.ob_plane >= 0) & (ob_local_kf >= 0)
    plane_var_idx = jnp.stack(
        [jnp.maximum(ob_local_kf, 0),
         jnp.maximum(sg.ob_plane, 0)], axis=1
    ).astype(jnp.int32)
    plane_kf_batch = None
    if config.plane_kf_factor:
        plane_kf_batch = FactorBatch(
            families=("kf", "plane"),
            residual_fn=factors.plane_kf,
            res_dim=3,
            var_idx=plane_var_idx,
            const={"pi_obs": sg.ob_coeffs},
            info=plane_info * jnp.maximum(sg.ob_conf, 0.1),
            valid=ob_use,
            huber=float(np.sqrt(CHI2_PLANE)),
            chi2_gate=CHI2_PLANE,
        )
        batches.append(plane_kf_batch)

    # ---- plane-point quadric factors (Gij), one per observation
    if config.plane_point_factor:
        # info scales with the observation's supporting mass through the
        # normalized quadric trace; the config gain balances px² vs m² units
        batches.append(FactorBatch(
            families=("kf", "plane"),
            residual_fn=factors.plane_quadric,
            res_dim=1,
            var_idx=plane_var_idx,
            const={"G": sg.ob_quadric},
            info=plane_info * jnp.full(
                (sg.ob_kf.shape[0],), config.plane_point_info, jnp.float32
            ),
            valid=ob_use & (jnp.einsum("qii->q", sg.ob_quadric) > 1e-6),
            huber=float(np.sqrt(CHI2_PLANE_POINT)),
            chi2_gate=CHI2_PLANE_POINT,
        ))

    # ---- point-on-plane factors: local map points lying on a valid plane
    # (octree membership Plane.cc:81-140 approximated by distance-to-plane
    # plus centroid radius)
    if config.plane_map_point_factor:
        p_local = m.pt_pos[safe_pt]  # (n_local_pts, 3)
        pd = jnp.abs(
            jnp.einsum("pi,ni->pn", sg.pl_coeffs[:, :3], p_local)
            + sg.pl_coeffs[:, 3:4]
        )  # (P, n_local_pts)
        cd = jnp.linalg.norm(
            p_local[None, :, :] - sg.pl_centroid[:, None, :], axis=-1
        )
        onpl = (pd < config.plane_map_point_dist) & (cd < 3.0) & \
            sg.pl_valid[:, None]
        best_plane = jnp.argmin(
            jnp.where(onpl, pd, jnp.inf), axis=0
        ).astype(jnp.int32)
        pt_on = pt_ok & jnp.any(onpl, axis=0)
        pp_var_idx = jnp.stack(
            [best_plane, jnp.arange(n_local_pts, dtype=jnp.int32)], axis=1
        )
        batches.append(FactorBatch(
            families=("plane", "pt"),
            residual_fn=factors.point_on_plane,
            res_dim=1,
            var_idx=pp_var_idx,
            const={},
            info=plane_info * jnp.full(
                (n_local_pts,), config.plane_map_point_info, jnp.float32
            ),
            valid=pt_on,
            huber=float(np.sqrt(CHI2_PLANE_POINT)),
            chi2_gate=CHI2_PLANE_POINT,
        ))

    # planes observed by a local KF are free; everything else fixed
    plane_seen = jnp.zeros((sg.P,), bool).at[
        jnp.where(ob_use, sg.ob_plane, sg.P - 1)
    ].set(ob_use, mode="drop")
    plane_fixed = ~(plane_seen & sg.pl_valid)

    # ---- room-center factors (2-wall corridor / 4-wall room)
    R = sg.room_valid.shape[0]
    rw = jnp.clip(sg.room_walls, 0, sg.P - 1)
    walls_ok = sg.room_walls >= 0
    is4 = sg.room_valid & jnp.all(walls_ok, axis=1)
    is2 = sg.room_valid & walls_ok[:, 0] & walls_ok[:, 1] & ~is4
    room_idx = jnp.arange(R, dtype=jnp.int32)
    if config.room_factor:
        batches.append(FactorBatch(
            families=("room", "plane", "plane", "plane", "plane"),
            residual_fn=factors.room_4wall,
            res_dim=3,
            var_idx=jnp.concatenate([room_idx[:, None], rw], axis=1),
            const={},
            info=jnp.full((R,), config.room_info, jnp.float32),
            valid=is4,
            huber=1.0,
        ))
        batches.append(FactorBatch(
            families=("room", "plane", "plane"),
            residual_fn=factors.room_2wall,
            res_dim=3,
            var_idx=jnp.concatenate([room_idx[:, None], rw[:, :2]], axis=1),
            const={},
            info=jnp.full((R,), config.room_info, jnp.float32),
            valid=is2,
            huber=1.0,
        ))
    room_fixed = ~(sg.room_valid & (is2 | is4))

    # ---- door-room rigidity factors
    D = sg.door_valid.shape[0]
    door_fixed = ~sg.door_valid
    if config.door_factor:
        # nearest valid room per door (the reference iterates room->doors;
        # the env-database room assignment reduces to proximity here)
        ddist = jnp.linalg.norm(
            sg.door_pose[:, None, 4:7] - sg.room_center[None, :, :], axis=-1
        )
        ddist = jnp.where(sg.room_valid[None, :], ddist, jnp.inf)
        door_room_idx = jnp.argmin(ddist, axis=1).astype(jnp.int32)
        has_room = jnp.isfinite(jnp.min(ddist, axis=1))
        rel = sg.door_pose[:, 4:7] - sg.room_center[door_room_idx]
        batches.append(FactorBatch(
            families=("door", "room"),
            residual_fn=factors.door_room,
            res_dim=3,
            var_idx=jnp.stack(
                [jnp.arange(D, dtype=jnp.int32), door_room_idx], axis=1
            ),
            const={"rel": rel},
            info=jnp.full((D,), 1.0, jnp.float32),
            valid=sg.door_valid & has_room,
            huber=1.0,
        ))

    min_id = jnp.min(jnp.where(kf_mask, kf_ids, m.K))
    kf_fixed = (~kf_mask) | (kf_ids == min_id) | (kf_ids == 0)
    problem = GraphProblem(
        families={
            "kf": se3_family(m.kf_pose[kf_ids], kf_fixed),
            "pt": point_family(m.pt_pos[safe_pt], ~pt_ok),
            "plane": plane_family(sg.pl_coeffs, plane_fixed),
            "room": point_family(sg.room_center, room_fixed),
            "door": se3_family(sg.door_pose, door_fixed),
        },
        factors=batches,
        eliminated="pt",
    )
    res = optimize(problem, iters=iters)

    new_kf_pose = m.kf_pose.at[kf_ids].set(
        jnp.where(kf_mask[:, None], res.values["kf"], m.kf_pose[kf_ids])
    )
    new_pt_pos = m.pt_pos.at[safe_pt].set(
        jnp.where(pt_ok[:, None], res.values["pt"], m.pt_pos[safe_pt])
    )
    new_planes = jnp.where(plane_fixed[:, None], sg.pl_coeffs,
                           res.values["plane"])
    # renormalize plane equations ([n; d] with |n| = 1)
    nrm = jnp.linalg.norm(new_planes[:, :3], axis=-1, keepdims=True)
    new_planes = new_planes / jnp.maximum(nrm, 1e-9)
    new_rooms = jnp.where(room_fixed[:, None], sg.room_center,
                          res.values["room"])
    new_doors = jnp.where(door_fixed[:, None], sg.door_pose,
                          res.values["door"])

    # ---- chi2 erasure of outlier plane observations (Optimizer.cc:2344)
    new_ob_valid = sg.ob_valid
    if config.plane_kf_factor:
        fams = {
            "kf": se3_family(new_kf_pose[kf_ids], kf_fixed),
            "plane": plane_family(new_planes, plane_fixed),
        }
        chi2 = batch_chi2(plane_kf_batch, fams)
        new_ob_valid = sg.ob_valid & jnp.where(
            ob_use, chi2 <= CHI2_PLANE * 4.0, True
        )

    return (
        m._replace(kf_pose=new_kf_pose, pt_pos=new_pt_pos),
        sg._replace(pl_coeffs=new_planes, room_center=new_rooms,
                    door_pose=new_doors, ob_valid=new_ob_valid),
        res.cost,
    )

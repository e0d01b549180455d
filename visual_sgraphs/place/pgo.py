"""Essential-graph (Sim3 pose-graph) optimization and loop-closure map
correction.

Replaces ``Optimizer::OptimizeEssentialGraph`` (orb_slam3/src/Optimizer.cc:
2456-2735) and the correction/propagation half of ``LoopClosing::CorrectLoop``
(LoopClosing.cc:949-1180).  The reference walks spanning-tree + covisibility
+ loop edges per keyframe into a g2o Sim3 graph; here the edge set is a
fixed-capacity batch mined from the covisibility matrix in one masked top-k,
and the solve is the shared batched LM engine over a ``sim3`` family.

Map-point correction follows CorrectLoop's rule: a point is moved with its
reference keyframe's correction, X_w' = S_new_k^-1 . S_old_k . X_w
(LoopClosing.cc:1010-1035).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from visual_sgraphs.core import lie
from visual_sgraphs.optim import factors
from visual_sgraphs.optim.graph import (
    FactorBatch,
    GraphProblem,
    sim3_family,
)
from visual_sgraphs.optim.solve import optimize
from visual_sgraphs.slam.map_state import MapState


class EssentialEdges(NamedTuple):
    idx: jax.Array  # (E, 2) int32 keyframe pairs (i < j)
    valid: jax.Array  # (E,) bool


@partial(jax.jit, static_argnames=("max_edges",))
def build_covis_edges(m: MapState, min_weight: int = 30,
                      max_edges: int = 512,
                      sg=None, plane_score: float = 10.0,
                      plane_min_votes: float = 3.0,
                      plane_undefined_factor: float = 0.2
                      ) -> EssentialEdges:
    """Mine the essential-graph edge set: covisibility pairs above
    ``min_weight`` shared points (Optimizer.cc:2559 uses weight>=100 for
    covisibility edges) plus consecutive-keyframe links standing in for the
    spanning tree.  One one-hot matmul yields the full covisibility matrix;
    top-k over the upper triangle keeps the strongest ``max_edges`` pairs.

    ``sg``: optional scene-graph state — shared planes add
    ``plane_score`` per plane to each pair's weight before thresholding,
    the reference's plane-based covisibility (KeyFrame.cc:486-523) carried
    into the essential graph.
    """
    K, N = m.K, m.N
    obs = jnp.where(m.kf_kp_valid & m.kf_valid[:, None], m.kf_obs_pt, -1)
    member = jnp.zeros((K, N + 1), jnp.float32).at[
        jnp.arange(K)[:, None], obs + 1
    ].set(1.0)[:, 1:]  # (K, N) one-hot membership
    # culled-point slots must not bridge unrelated keyframes (slot reuse)
    member = member * m.pt_valid.astype(jnp.float32)[None, :]
    covis = jax.lax.dot_general(
        member, member, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (K, K) shared-point counts
    if sg is not None:
        from visual_sgraphs.scenegraph.manager import plane_semantics

        sem = plane_semantics(sg, plane_min_votes)
        P = sg.pl_coeffs.shape[0]
        ob_ok = sg.ob_valid & (sg.ob_plane >= 0) & (sg.ob_kf >= 0) & \
            (sg.ob_kf < K)
        pmem = jnp.zeros((K, P), jnp.int32).at[
            jnp.clip(sg.ob_kf, 0, K - 1), jnp.maximum(sg.ob_plane, 0)
        ].max(ob_ok.astype(jnp.int32)).astype(jnp.float32)
        w = jnp.where(sem != -1, plane_score,
                      plane_score * plane_undefined_factor)
        w = jnp.where(sg.pl_valid, w, 0.0)
        covis = covis + jax.lax.dot_general(
            pmem * w[None, :], pmem, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )

    i_idx = jax.lax.broadcasted_iota(jnp.int32, (K, K), 0)
    j_idx = jax.lax.broadcasted_iota(jnp.int32, (K, K), 1)
    upper = j_idx > i_idx
    # temporal-predecessor edges (spanning-tree stand-in) keyed on the
    # insertion SEQUENCE — slot index no longer encodes age once slots
    # are reused: pred[j] = valid KF with the largest seq below seq[j]
    seq = jnp.where(m.kf_valid, m.kf_seq, -1)
    cand = jnp.where(
        (seq[:, None] < seq[None, :]) & (seq[:, None] >= 0),
        seq[:, None], -1,
    )  # (K, K): candidate predecessor seq of column j
    pred = jnp.argmax(cand, axis=0)  # (K,) slot of j's predecessor
    has_pred = (jnp.max(cand, axis=0) >= 0) & (seq >= 0)
    consecutive = (i_idx == pred[None, :]) & has_pred[None, :] & \
        m.kf_valid[None, :] & m.kf_valid[:, None]
    strong = upper & (covis >= min_weight)
    # consecutive edges get a large pseudo-weight so top-k always keeps them
    score = jnp.where(strong, covis, 0.0) + jnp.where(consecutive, 1e6, 0.0)
    flat = score.reshape(-1)
    top_vals, top_flat = jax.lax.top_k(flat, max_edges)
    ei = top_flat // K
    ej = top_flat % K
    ok = top_vals > 0
    return EssentialEdges(
        idx=jnp.stack([ei, ej], axis=1).astype(jnp.int32),
        valid=ok,
    )


class PgoResult(NamedTuple):
    kf_pose: jax.Array  # (K, 7) corrected T_cw
    S_old: jax.Array  # (K, 8) pre-correction Sim3 (scale-1 embed of T_cw)
    S_new: jax.Array  # (K, 8) optimized Sim3 poses
    cost0: jax.Array
    cost: jax.Array


@partial(jax.jit, static_argnames=("iters", "fix_scale"))
def optimize_essential_graph(
    kf_pose: jax.Array,
    kf_valid: jax.Array,
    edges: EssentialEdges,
    loop_i: jax.Array,
    loop_j: jax.Array,
    S_loop_ji: jax.Array,
    fixed: jax.Array,
    iters: int = 20,
    fix_scale: bool = False,
) -> PgoResult:
    """Sim3 pose-graph solve.

    Non-loop edges measure the *current* relative pose (they anchor local
    shape); the loop edge carries the Sim3 from geometric verification.  The
    reference's schedule is 20 iterations (Optimizer.cc:2682-2684).
    ``fixed``: (K,) bool gauge keyframes (the loop-candidate side).
    ``fix_scale``: stereo/RGB-D sensors observe scale directly, so the
    per-keyframe scale DoF is frozen (the reference's bFixScale template
    parameter of OptimizeEssentialGraph).
    """
    K = kf_pose.shape[0]
    S_old = jax.vmap(lie.sim3_from_se3)(kf_pose)  # (K, 8), scale 1

    ei, ej = edges.idx[:, 0], edges.idx[:, 1]
    rel = jax.vmap(
        lambda i, j: lie.sim3_multiply(S_old[j], lie.sim3_inverse(S_old[i]))
    )(ei, ej)
    e_valid = edges.valid & kf_valid[ei] & kf_valid[ej]

    # append the loop edge with a higher information weight
    var_idx = jnp.concatenate(
        [edges.idx, jnp.stack([loop_i, loop_j])[None].astype(jnp.int32)]
    )
    rel_all = jnp.concatenate([rel, S_loop_ji[None]])
    valid_all = jnp.concatenate([e_valid, jnp.ones((1,), bool)])
    info = jnp.concatenate(
        [jnp.ones(ei.shape[0], jnp.float32),
         jnp.full((1,), 100.0, jnp.float32)]
    )

    batch = FactorBatch(
        families=("kf", "kf"),
        residual_fn=factors.relative_sim3,
        res_dim=7,
        var_idx=var_idx,
        const={"S_ji": rel_all},
        info=info,
        valid=valid_all,
    )
    fam = sim3_family(S_old, fixed=fixed | ~kf_valid)
    if fix_scale:
        # zero the scale component of every tangent update (bFixScale)
        import dataclasses as _dc

        fam = _dc.replace(
            fam,
            retract=lambda v, d: lie.sim3_boxplus(v, d.at[..., 6].set(0.0)),
        )
    problem = GraphProblem(families={"kf": fam}, factors=[batch])
    res = optimize(problem, iters=iters)
    S_new = jax.vmap(lie.sim3_normalize)(res.values["kf"])
    # Sim3 -> SE3 as [R, t/s]: the optimized Siw acts on world points as
    # s·R·X + t, so the camera centre (and hence the SE3 pose) carries t/s
    # (Optimizer.cc OptimizeEssentialGraph CorrectedSiw -> Tiw conversion).
    kf_new = jnp.concatenate(
        [S_new[:, :4], S_new[:, 4:7] / S_new[:, 7:8]], axis=1
    )
    kf_new = jnp.where(kf_valid[:, None], kf_new, kf_pose)
    return PgoResult(kf_pose=kf_new, S_old=S_old, S_new=S_new,
                     cost0=res.initial_cost, cost=res.cost)


@jax.jit
def correct_map(m: MapState, pgo: PgoResult) -> MapState:
    """Apply the pose-graph correction to keyframe poses and map points.

    Points move with their reference keyframe: X_w' = S_new^-1(S_old(X_w))
    — exactly LoopClosing::CorrectLoop's eigP3Dw correction
    (LoopClosing.cc:1010-1035), with pt_first_kf as the reference KF.
    """
    ref = jnp.clip(m.pt_first_kf, 0, m.K - 1)
    S_corr = jax.vmap(
        lambda a, b: lie.sim3_multiply(lie.sim3_inverse(a), b)
    )(pgo.S_new, pgo.S_old)  # (K, 8) world-space correction per KF
    new_pos = jax.vmap(lie.sim3_apply)(S_corr[ref], m.pt_pos)
    new_pos = jnp.where(m.pt_valid[:, None], new_pos, m.pt_pos)
    return m._replace(kf_pose=pgo.kf_pose, pt_pos=new_pos)


@jax.jit
def correct_scenegraph(sg, pgo: PgoResult, m: MapState):
    """Carry the loop-closure Sim3 correction into the scene graph.

    The reference corrects map points through each one's reference
    keyframe's Sim3 (LoopClosing.cc:1010-1035) and stages plane corrections
    through the GBA writeback (Optimizer.cc:621-638); without the
    equivalent, plane equations, centroids, room centers and door/marker
    poses stay in the pre-correction world after the map rotates.

    Reference-keyframe policy: each plane uses the earliest keyframe that
    observed it (its creating keyframe, like MapPoint::mpRefKF); rooms use
    their first wall's reference; doors/markers use the spatially nearest
    keyframe (their observing keyframe is not tracked in the table).
    """
    from visual_sgraphs.core import plane as plane_mod

    K = m.K
    S_corr = jax.vmap(
        lambda a, b: lie.sim3_multiply(lie.sim3_inverse(a), b)
    )(pgo.S_new, pgo.S_old)  # (K, 8) world-space correction per KF

    # --- per-plane reference keyframe: min observing KF from the obs table
    P = sg.pl_coeffs.shape[0]
    ob_pl = jnp.where(sg.ob_valid & (sg.ob_plane >= 0), sg.ob_plane, P)
    pl_ref = jnp.full((P + 1,), K, jnp.int32).at[ob_pl].min(
        jnp.clip(sg.ob_kf, 0, K - 1)
    )[:P]
    pl_has_ref = pl_ref < K
    pl_ref = jnp.clip(pl_ref, 0, K - 1)
    S_pl = S_corr[pl_ref]
    new_coeffs = jax.vmap(plane_mod.transform_sim3)(S_pl, sg.pl_coeffs)
    new_centroid = jax.vmap(lie.sim3_apply)(S_pl, sg.pl_centroid)
    upd_pl = sg.pl_valid & pl_has_ref
    new_coeffs = jnp.where(upd_pl[:, None], new_coeffs, sg.pl_coeffs)
    new_centroid = jnp.where(upd_pl[:, None], new_centroid, sg.pl_centroid)

    # --- rooms follow their first wall's reference keyframe
    w0 = jnp.clip(sg.room_walls[:, 0], 0, P - 1)
    room_ref = pl_ref[w0]
    room_ok = sg.room_valid & (sg.room_walls[:, 0] >= 0) & pl_has_ref[w0]
    new_rc = jax.vmap(lie.sim3_apply)(S_corr[room_ref], sg.room_center)
    new_rc = jnp.where(room_ok[:, None], new_rc, sg.room_center)

    # --- doors / markers: nearest keyframe by camera-centre distance
    cam_c = jax.vmap(lambda T: lie.se3_inverse(T)[4:7])(m.kf_pose)  # (K,3)

    def nearest_kf(p):
        d2 = jnp.sum((cam_c - p[None, :]) ** 2, axis=-1)
        return jnp.argmin(jnp.where(m.kf_valid, d2, jnp.inf)).astype(
            jnp.int32
        )

    def corr_pose(T_we, S):
        # T_we' carries the corrected rotation and similarity-mapped centre
        R_new = lie.quat_multiply(S[:4], T_we[:4])
        t_new = lie.sim3_apply(S, T_we[4:7])
        return lie.se3_normalize(jnp.concatenate([R_new, t_new]))

    door_ref = jax.vmap(nearest_kf)(sg.door_pose[:, 4:7])
    new_door = jax.vmap(corr_pose)(sg.door_pose, S_corr[door_ref])
    new_door = jnp.where(sg.door_valid[:, None], new_door, sg.door_pose)
    mk_ref = jax.vmap(nearest_kf)(sg.marker_pose[:, 4:7])
    new_mk = jax.vmap(corr_pose)(sg.marker_pose, S_corr[mk_ref])
    new_mk = jnp.where(sg.marker_valid[:, None], new_mk, sg.marker_pose)

    return sg._replace(
        pl_coeffs=new_coeffs,
        pl_centroid=new_centroid,
        room_center=new_rc,
        door_pose=new_door,
        marker_pose=new_mk,
    )


def _retract_4dof(v, d):
    """4-dof retract: world-frame translation + yaw about the gravity-
    aligned world z axis (VertexPose4DoF, G2oTypes.h:861 — roll/pitch are
    observable from gravity once IMU-initialized and stay fixed)."""
    xi_w = jnp.concatenate([d[..., :3], jnp.zeros_like(d[..., :2]),
                            d[..., 3:4]], axis=-1)
    T_w = lie.se3_exp(xi_w)
    return lie.se3_normalize(lie.se3_multiply(v, lie.se3_inverse(T_w)))


@partial(jax.jit, static_argnames=("iters",))
def optimize_essential_graph_4dof(
    kf_pose: jax.Array,
    kf_valid: jax.Array,
    edges: EssentialEdges,
    loop_i: jax.Array,
    loop_j: jax.Array,
    T_loop_ji: jax.Array,
    fixed: jax.Array,
    iters: int = 20,
) -> PgoResult:
    """4-dof essential-graph solve for visual-inertial loops
    (Optimizer::OptimizeEssentialGraph4DoF, Optimizer.cc:6412): each
    keyframe optimizes translation + yaw only; gravity-observable roll and
    pitch stay fixed.  Scale is rigid (inertial anchors it)."""
    from visual_sgraphs.optim.graph import VarFamily
    import dataclasses as _dc

    K = kf_pose.shape[0]
    ei, ej = edges.idx[:, 0], edges.idx[:, 1]
    rel = jax.vmap(
        lambda i, j: lie.se3_multiply(kf_pose[j], lie.se3_inverse(kf_pose[i]))
    )(ei, ej)
    e_valid = edges.valid & kf_valid[ei] & kf_valid[ej]

    var_idx = jnp.concatenate(
        [edges.idx, jnp.stack([loop_i, loop_j])[None].astype(jnp.int32)]
    )
    rel_all = jnp.concatenate([rel, T_loop_ji[None]])
    valid_all = jnp.concatenate([e_valid, jnp.ones((1,), bool)])
    info = jnp.concatenate(
        [jnp.ones(ei.shape[0], jnp.float32),
         jnp.full((1,), 100.0, jnp.float32)]
    )
    batch = FactorBatch(
        families=("kf", "kf"),
        residual_fn=factors.relative_se3,
        res_dim=6,
        var_idx=var_idx,
        const={"T_ji": rel_all},
        info=info,
        valid=valid_all,
    )
    fam = VarFamily(values=kf_pose, fixed=fixed | ~kf_valid,
                    tangent_dim=4, retract=_retract_4dof)
    problem = GraphProblem(families={"kf": fam}, factors=[batch])
    res = optimize(problem, iters=iters)
    kf_new = jax.vmap(lie.se3_normalize)(res.values["kf"])
    kf_new = jnp.where(kf_valid[:, None], kf_new, kf_pose)
    S_old = jax.vmap(lie.sim3_from_se3)(kf_pose)
    S_new = jax.vmap(lie.sim3_from_se3)(kf_new)
    return PgoResult(kf_pose=kf_new, S_old=S_old, S_new=S_new,
                     cost0=res.initial_cost, cost=res.cost)

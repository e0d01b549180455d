"""Visual-inertial local BA over a temporal keyframe window.

Replaces ``Optimizer::LocalInertialBA`` (orb_slam3/src/Optimizer.cc:3531):
the last W keyframes with their velocities and biases, reprojection factors
to the local points (Schur-eliminated), preintegration factors chaining
consecutive keyframes, and bias random-walk factors.  The window boundary
keyframe is the gauge anchor (the reference fixes the out-of-window
covisible keyframes instead; a fixed boundary KF plays the same role with
static shapes).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.core import lie
from visual_sgraphs.inertial import factors as ifac
from visual_sgraphs.inertial.init import _sqrt_info
from visual_sgraphs.inertial.preintegration import Preintegrated
from visual_sgraphs.optim import factors as vfac
from visual_sgraphs.optim.graph import (
    FactorBatch,
    GraphProblem,
    point_family,
    se3_family,
)
from visual_sgraphs.optim.solve import optimize
from visual_sgraphs.slam.map_state import MapState

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class ImuKfState(NamedTuple):
    """Per-keyframe inertial state tables (fixed capacity K) — the
    reference stores these on the KeyFrame (mVw, mImuBias) plus the
    preintegration to the previous KF (mpImuPreintegrated)."""

    vel: jax.Array  # (K, 3)
    bias_g: jax.Array  # (K, 3)
    bias_a: jax.Array  # (K, 3)
    preint: Preintegrated  # stacked (K, ...) — row k: KF k-1 -> KF k
    preint_valid: jax.Array  # (K,)


def empty_imu_state(max_keyframes: int, dtype=jnp.float32) -> ImuKfState:
    K = max_keyframes
    from visual_sgraphs.inertial.preintegration import identity_preint

    one = identity_preint(dtype=dtype)
    stacked = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (K,) + a.shape), one
    )
    return ImuKfState(
        vel=jnp.zeros((K, 3), dtype),
        bias_g=jnp.zeros((K, 3), dtype),
        bias_a=jnp.zeros((K, 3), dtype),
        preint=stacked,
        preint_valid=jnp.zeros((K,), bool),
    )


@jax.jit
def set_kf_imu(s: ImuKfState, kf: jax.Array, vel: jax.Array,
               bias_g: jax.Array, bias_a: jax.Array,
               preint: Preintegrated, preint_valid) -> ImuKfState:
    return ImuKfState(
        vel=s.vel.at[kf].set(vel),
        bias_g=s.bias_g.at[kf].set(bias_g),
        bias_a=s.bias_a.at[kf].set(bias_a),
        preint=jax.tree.map(
            lambda tab, row: tab.at[kf].set(row), s.preint, preint
        ),
        preint_valid=s.preint_valid.at[kf].set(preint_valid),
    )


@functools.partial(
    jax.jit, static_argnames=("n_window", "n_local_pts", "iters")
)
def vi_local_ba(
    m: MapState,
    imu: ImuKfState,
    kf_id: jax.Array,
    cam_K: jax.Array,
    cam_bf: jax.Array,
    T_bc: jax.Array,
    walk_gyro: float = 1.9e-5,
    walk_acc: float = 3.0e-3,
    n_window: int = 10,
    n_local_pts: int = 4096,
    iters: int = 8,
) -> tuple[MapState, ImuKfState, jax.Array]:
    """Joint solve of the last ``n_window`` keyframes' poses, velocities and
    biases plus their local points.  Returns (map, imu_state, final_cost)."""
    W = n_window
    kf_ids = kf_id - W + 1 + jnp.arange(W, dtype=jnp.int32)  # temporal
    in_range = kf_ids >= 0
    kf_ids = jnp.maximum(kf_ids, 0)
    kf_mask = in_range & m.kf_valid[kf_ids]

    # ---- local points (everything the window observes)
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

    kf_rows = jnp.broadcast_to(jnp.arange(W)[:, None], obs.shape)
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
            residual_fn=vfac.reproj_mono,
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
            residual_fn=vfac.reproj_stereo,
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

    # ---- IMU chain: preint row of KF j connects (j-1, j)
    E = W - 1
    e_i = jnp.arange(E, dtype=jnp.int32)
    e_j = e_i + 1
    pre = jax.tree.map(lambda a: a[kf_ids[e_j]], imu.preint)
    sqrt_info = jax.vmap(_sqrt_info)(pre.cov)
    imu_valid = (
        imu.preint_valid[kf_ids[e_j]] & kf_mask[e_i] & kf_mask[e_j]
        & (pre.dt > 1e-4)
    )
    g_w = jnp.asarray([0.0, 0.0, -ifac.GRAVITY], jnp.float32)
    batches.append(
        FactorBatch(
            families=("kf", "kf", "vel", "vel", "bg", "ba"),
            residual_fn=ifac.imu_factor,
            res_dim=9,
            var_idx=jnp.stack([e_i, e_j, e_i, e_j, e_j, e_j], axis=1),
            const={
                "dR": pre.dR, "dV": pre.dV, "dP": pre.dP,
                "JRg": pre.JRg, "JVg": pre.JVg, "JVa": pre.JVa,
                "JPg": pre.JPg, "JPa": pre.JPa,
                "dt": pre.dt,
                "bias_g": pre.bias_g, "bias_a": pre.bias_a,
                "sqrt_info": sqrt_info,
                "T_bc": jnp.broadcast_to(T_bc, (E, 7)),
                "g_w": jnp.broadcast_to(g_w, (E, 3)),
            },
            info=jnp.ones((E,), jnp.float32),
            valid=imu_valid,
            huber=9.0,
        )
    )
    # bias random walks between consecutive window KFs
    dtv = jnp.maximum(pre.dt, 1e-3)
    for fam, walk in (("bg", walk_gyro), ("ba", walk_acc)):
        batches.append(
            FactorBatch(
                families=(fam, fam),
                residual_fn=ifac.bias_walk,
                res_dim=3,
                var_idx=jnp.stack([e_i, e_j], axis=1),
                const={},
                info=1.0 / (walk * walk * dtv),
                valid=imu_valid,
            )
        )

    first = jnp.argmax(kf_mask)  # oldest valid window slot: gauge anchor
    slot_fixed = (~kf_mask) | (jnp.arange(W) == first)
    problem = GraphProblem(
        families={
            "kf": se3_family(m.kf_pose[kf_ids], slot_fixed),
            "vel": point_family(imu.vel[kf_ids], slot_fixed),
            "bg": point_family(imu.bias_g[kf_ids], slot_fixed),
            "ba": point_family(imu.bias_a[kf_ids], slot_fixed),
            "pt": point_family(m.pt_pos[safe_pt], ~pt_ok),
        },
        factors=batches,
        eliminated="pt",
    )
    res = optimize(problem, iters=iters)

    upd = kf_mask[:, None]
    new_m = m._replace(
        kf_pose=m.kf_pose.at[kf_ids].set(
            jnp.where(upd, res.values["kf"], m.kf_pose[kf_ids])
        ),
        pt_pos=m.pt_pos.at[safe_pt].set(
            jnp.where(pt_ok[:, None], res.values["pt"], m.pt_pos[safe_pt])
        ),
    )
    new_imu = imu._replace(
        vel=imu.vel.at[kf_ids].set(
            jnp.where(upd, res.values["vel"], imu.vel[kf_ids])
        ),
        bias_g=imu.bias_g.at[kf_ids].set(
            jnp.where(upd, res.values["bg"], imu.bias_g[kf_ids])
        ),
        bias_a=imu.bias_a.at[kf_ids].set(
            jnp.where(upd, res.values["ba"], imu.bias_a[kf_ids])
        ),
    )
    return new_m, new_imu, res.cost

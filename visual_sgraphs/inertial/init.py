"""Visual-inertial initialization: gravity direction, scale, velocities,
biases from keyframe poses + preintegrated IMU.

Replaces ``Optimizer::InertialOptimization`` (orb_slam3/src/Optimizer.cc:
4185/4365/4525) and the map-rescaling half of ``LocalMapping::InitializeIMU``
/ ``ScaleRefinement`` (LocalMapping.cc:1164/1426): visual keyframe poses are
held fixed, and a small graph over {gravity quaternion (2-dof), scale
(1-dof), per-KF velocity, shared gyro/acc bias} is solved with the batched
LM engine using the EdgeInertialGS-equivalent factor.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from visual_sgraphs.core import lie
from visual_sgraphs.inertial import factors as ifac
from visual_sgraphs.inertial.preintegration import Preintegrated
from visual_sgraphs.optim.graph import (
    FactorBatch,
    GraphProblem,
    VarFamily,
    point_family,
    se3_family,
)
from visual_sgraphs.optim.solve import optimize
from visual_sgraphs.slam.map_state import MapState


class InertialInitResult(NamedTuple):
    q_wg: jax.Array  # (4,) gravity rotation: g_w = R_wg (0,0,-9.81)
    scale: jax.Array  # ()
    vel: jax.Array  # (n, 3) per-keyframe body velocities
    bias_g: jax.Array  # (3,)
    bias_a: jax.Array  # (3,)
    cost0: jax.Array
    cost: jax.Array


def _sqrt_info(cov: jax.Array) -> jax.Array:
    """Lower-Cholesky inverse of a (9,9) covariance, guarded for padding."""
    eye = jnp.eye(9, dtype=cov.dtype)
    covr = cov + eye * 1e-8
    L = jnp.linalg.cholesky(covr)
    W = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    return jnp.where(jnp.all(jnp.isfinite(W)), W, eye)


@partial(jax.jit, static_argnames=("iters", "fix_scale"))
def inertial_init(
    kf_pose: jax.Array,  # (n, 7) T_cw of consecutive keyframes
    kf_valid: jax.Array,  # (n,)
    preint: Preintegrated,  # stacked (n,) — preint[i]: KF i-1 -> KF i
    preint_valid: jax.Array,  # (n,)
    T_bc: jax.Array,  # (7,)
    prior_bias_info: float = 1e4,
    iters: int = 30,
    fix_scale: bool = False,
) -> InertialInitResult:
    """Solve gravity/scale/velocity/bias with poses fixed.

    ``preint`` row i preintegrates KF ``i-1`` -> ``i`` (row 0 unused).
    ``fix_scale``: True for stereo/RGB-D (metric visual map).
    """
    n = kf_pose.shape[0]
    dtype = kf_pose.dtype
    T_bc = T_bc.astype(dtype)
    preint = jax.tree.map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating)
        else a,
        preint,
    )

    # initial velocity guess: finite differences of body positions
    T_wb = jax.vmap(
        lambda T: lie.se3_inverse(lie.se3_multiply(T_bc, T))
    )(kf_pose)
    p = T_wb[:, 4:7]
    dts = jnp.maximum(preint.dt, 1e-3)
    v0 = jnp.zeros((n, 3), dtype)
    v0 = v0.at[1:].set((p[1:] - p[:-1]) / dts[1:, None])
    v0 = v0.at[0].set(v0[1])

    families = {
        "pose": se3_family(kf_pose, fixed=jnp.ones((n,), bool)),
        "vel": point_family(v0),
        "bg": point_family(jnp.zeros((1, 3), dtype)),
        "ba": point_family(jnp.zeros((1, 3), dtype)),
        "gdir": VarFamily(
            values=lie.quat_identity(dtype)[None],
            fixed=jnp.zeros((1,), bool),
            tangent_dim=2,
            retract=ifac.gdir_retract,
        ),
        "scale": VarFamily(
            values=jnp.ones((1, 1), dtype),
            fixed=jnp.full((1,), fix_scale),
            tangent_dim=1,
            retract=ifac.scale_retract,
        ),
    }

    m = n - 1
    idx_i = jnp.arange(m, dtype=jnp.int32)
    idx_j = idx_i + 1
    zeros = jnp.zeros((m,), jnp.int32)
    var_idx = jnp.stack(
        [idx_i, idx_j, idx_i, idx_j, zeros, zeros, zeros, zeros], axis=1
    )
    pre_j = jax.tree.map(lambda a: a[1:], preint)
    sqrt_info = jax.vmap(_sqrt_info)(pre_j.cov)
    valid = (
        preint_valid[1:] & kf_valid[idx_i] & kf_valid[idx_j]
        & (pre_j.dt > 1e-4)
    )
    imu_batch = FactorBatch(
        families=("pose", "pose", "vel", "vel", "bg", "ba", "gdir", "scale"),
        residual_fn=ifac.imu_factor_gs,
        res_dim=9,
        var_idx=var_idx,
        const={
            "dR": pre_j.dR, "dV": pre_j.dV, "dP": pre_j.dP,
            "JRg": pre_j.JRg, "JVg": pre_j.JVg, "JVa": pre_j.JVa,
            "JPg": pre_j.JPg, "JPa": pre_j.JPa,
            "dt": pre_j.dt,
            "bias_g": pre_j.bias_g, "bias_a": pre_j.bias_a,
            "sqrt_info": sqrt_info,
            "T_bc": jnp.broadcast_to(T_bc, (m, 7)),
        },
        info=jnp.ones((m,), dtype),
        valid=valid,
        huber=None,
    )
    prior_bg = FactorBatch(
        families=("bg",),
        residual_fn=ifac.prior_3,
        res_dim=3,
        var_idx=jnp.zeros((1, 1), jnp.int32),
        const={"mean": jnp.zeros((1, 3), dtype)},
        info=jnp.full((1,), prior_bias_info, dtype),
        valid=jnp.ones((1,), bool),
    )
    prior_ba = FactorBatch(
        families=("ba",),
        residual_fn=ifac.prior_3,
        res_dim=3,
        var_idx=jnp.zeros((1, 1), jnp.int32),
        const={"mean": jnp.zeros((1, 3), dtype)},
        info=jnp.full((1,), prior_bias_info, dtype),
        valid=jnp.ones((1,), bool),
    )
    problem = GraphProblem(
        families=families,
        factors=[imu_batch, prior_bg, prior_ba],
    )
    res = optimize(problem, iters=iters)
    return InertialInitResult(
        q_wg=lie.quat_normalize(res.values["gdir"][0]),
        scale=res.values["scale"][0, 0],
        vel=res.values["vel"],
        bias_g=res.values["bg"][0],
        bias_a=res.values["ba"][0],
        cost0=res.initial_cost,
        cost=res.cost,
    )


@jax.jit
def apply_scaled_rotation(m: MapState, q_wg: jax.Array,
                          scale: jax.Array) -> MapState:
    """Re-express the map in a gravity-aligned, metric world frame
    (Map::ApplyScaledRotation, called from InitializeIMU,
    LocalMapping.cc:1164+): X' = s·R_gw·X, R_cw' = R_cw·R_gwᵀ,
    t_cw' = s·t_cw.  Afterwards gravity is exactly (0, 0, -9.81)."""
    q_gw = lie.quat_conjugate(q_wg)
    R_gw = lie.quat_to_matrix(q_gw)

    def fix_pose(T):
        q, t = T[:4], T[4:7]
        q_new = lie.quat_normalize(lie.quat_multiply(q, q_wg))
        return jnp.concatenate([q_new, scale * t])

    new_pose = jax.vmap(fix_pose)(m.kf_pose)
    new_pts = scale * (m.pt_pos @ R_gw.T)
    return m._replace(
        kf_pose=jnp.where(m.kf_valid[:, None], new_pose, m.kf_pose),
        pt_pos=jnp.where(m.pt_valid[:, None], new_pts, m.pt_pos),
    )


@jax.jit
def rotate_velocities(vel: jax.Array, q_wg: jax.Array,
                      scale: jax.Array) -> jax.Array:
    """Velocities transform with the same scaled rotation."""
    R_gw = lie.quat_to_matrix(lie.quat_conjugate(q_wg))
    return scale * (vel @ R_gw.T)

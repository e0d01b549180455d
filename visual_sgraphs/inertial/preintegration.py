"""IMU preintegration à la Forster et al. — ``lax.scan`` over measurements.

Replaces the reference's ``IMU::Preintegrated`` (orb_slam3/src/ImuTypes.cc:
~180-240, decl ImuTypes.h:140-186): per-sample update of (ΔR, ΔV, ΔP), the
9x9 covariance propagation A Σ Aᵀ + B Ση Bᵀ and the five bias Jacobians
JRg/JVg/JVa/JPg/JPa.  The reference integrates in float32 — identical
precision to this float32 path, so parity carries over directly.

State convention: body (IMU) frame b; world-frame gravity enters only in
the *factor* (factors.py), never in the preintegration.  ΔR is stored as a
quaternion.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from visual_sgraphs.core import lie

GRAVITY = 9.81


class Preintegrated(NamedTuple):
    """Preintegrated IMU measurements between two frames/keyframes."""

    dR: jax.Array  # (4,) quaternion ΔR_ij (body i -> body j rotation)
    dV: jax.Array  # (3,)
    dP: jax.Array  # (3,)
    # bias Jacobians (∂Δ·/∂bias at the linearization bias)
    JRg: jax.Array  # (3, 3)
    JVg: jax.Array  # (3, 3)
    JVa: jax.Array  # (3, 3)
    JPg: jax.Array  # (3, 3)
    JPa: jax.Array  # (3, 3)
    cov: jax.Array  # (9, 9) covariance of (r_R, r_V, r_P)
    dt: jax.Array  # () total integration time
    bias_g: jax.Array  # (3,) linearization gyro bias
    bias_a: jax.Array  # (3,) linearization accel bias


def identity_preint(bias_g=None, bias_a=None, dtype=jnp.float32):
    z3 = jnp.zeros((3,), dtype)
    return Preintegrated(
        dR=lie.quat_identity(dtype),
        dV=z3,
        dP=z3,
        JRg=jnp.zeros((3, 3), dtype),
        JVg=jnp.zeros((3, 3), dtype),
        JVa=jnp.zeros((3, 3), dtype),
        JPg=jnp.zeros((3, 3), dtype),
        JPa=jnp.zeros((3, 3), dtype),
        cov=jnp.zeros((9, 9), dtype),
        dt=jnp.zeros((), dtype),
        bias_g=bias_g if bias_g is not None else z3,
        bias_a=bias_a if bias_a is not None else z3,
    )


def _step(state: Preintegrated, meas, noise_gyro2: float, noise_acc2: float):
    """One IntegrateNewMeasurement step (ImuTypes.cc): position/velocity with
    the *current* ΔR, then covariance + Jacobian propagation, then the
    rotation update."""
    omega, acc, dt, valid = meas
    w = omega - state.bias_g
    a = acc - state.bias_a
    dtv = jnp.where(valid, dt, 0.0)

    R = lie.quat_to_matrix(state.dR)  # ΔR_ik
    Ra = R @ a
    # measurement update (order matters: P uses old V and R)
    dP = state.dP + state.dV * dtv + 0.5 * Ra * dtv * dtv
    dV = state.dV + Ra * dtv

    # covariance propagation: x = (φ, v, p), A/B as in ImuTypes.cc:~200
    ahat = lie.hat(a)
    dRk = lie.so3_exp(w * dtv)
    Rk = lie.quat_to_matrix(dRk)
    I3 = jnp.eye(3, dtype=dP.dtype)
    A = jnp.zeros((9, 9), dP.dtype)
    A = A.at[0:3, 0:3].set(Rk.T)
    A = A.at[3:6, 0:3].set(-R @ ahat * dtv)
    A = A.at[3:6, 3:6].set(I3)
    A = A.at[6:9, 0:3].set(-0.5 * R @ ahat * dtv * dtv)
    A = A.at[6:9, 3:6].set(I3 * dtv)
    A = A.at[6:9, 6:9].set(I3)
    # right Jacobian of the incremental rotation
    Jr = lie.so3_left_jacobian(-w * dtv)  # Jr(θ) = Jl(-θ)
    B = jnp.zeros((9, 6), dP.dtype)
    B = B.at[0:3, 0:3].set(Jr * dtv)
    B = B.at[3:6, 3:6].set(R * dtv)
    B = B.at[6:9, 3:6].set(0.5 * R * dtv * dtv)
    Sn = jnp.diag(
        jnp.concatenate([jnp.full((3,), noise_gyro2, dP.dtype),
                         jnp.full((3,), noise_acc2, dP.dtype)])
    )
    # noise is white: scale by 1/dt (discrete-time density)
    inv_dt = jnp.where(dtv > 0, 1.0 / jnp.maximum(dtv, 1e-9), 0.0)
    cov = A @ state.cov @ A.T + B @ Sn @ B.T * inv_dt
    cov = jnp.where(valid, cov, state.cov)

    # bias Jacobian propagation (ImuTypes.cc JPa/JPg/JVa/JVg/JRg updates)
    JPa = state.JPa + state.JVa * dtv - 0.5 * R * dtv * dtv
    JPg = state.JPg + state.JVg * dtv - 0.5 * R @ ahat @ state.JRg * dtv * dtv
    JVa = state.JVa - R * dtv
    JVg = state.JVg - R @ ahat @ state.JRg * dtv
    JRg = Rk.T @ state.JRg - Jr * dtv

    dR = lie.quat_normalize(lie.quat_multiply(state.dR, dRk))

    new = Preintegrated(
        dR=dR, dV=dV, dP=dP,
        JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
        cov=cov, dt=state.dt + dtv,
        bias_g=state.bias_g, bias_a=state.bias_a,
    )
    # masked samples (padding) leave the state untouched
    return jax.tree.map(
        lambda n, o: jnp.where(valid, n, o), new, state
    ), None


def preintegrate(
    omega: jax.Array,
    acc: jax.Array,
    dt: jax.Array,
    valid: jax.Array,
    bias_g: jax.Array,
    bias_a: jax.Array,
    noise_gyro: float = 1.7e-4,
    noise_acc: float = 2.0e-3,
) -> Preintegrated:
    """Integrate a fixed-capacity batch of IMU samples.

    ``omega``/``acc``: (T, 3); ``dt``: (T,) per-sample intervals; ``valid``:
    (T,) padding mask.  One ``lax.scan`` — the whole inter-keyframe window
    integrates as a single fused device program.
    """
    dtype = acc.dtype
    omega = omega.astype(dtype)
    dt = dt.astype(dtype)
    init = identity_preint(bias_g.astype(dtype), bias_a.astype(dtype),
                           dtype=dtype)

    def step(s, m):
        return _step(s, m, noise_gyro * noise_gyro, noise_acc * noise_acc)

    out, _ = jax.lax.scan(step, init, (omega, acc, dt, valid))
    return out


def bias_corrected_delta(pre: Preintegrated, bias_g: jax.Array,
                         bias_a: jax.Array):
    """First-order bias-corrected (ΔR, ΔV, ΔP) at a new bias
    (Preintegrated::GetDeltaRotation/Velocity/Position, ImuTypes.cc)."""
    dbg = bias_g - pre.bias_g
    dba = bias_a - pre.bias_a
    dR = lie.quat_multiply(pre.dR, lie.so3_exp(pre.JRg @ dbg))
    dV = pre.dV + pre.JVg @ dbg + pre.JVa @ dba
    dP = pre.dP + pre.JPg @ dbg + pre.JPa @ dba
    return dR, dV, dP


def merge(a: Preintegrated, b: Preintegrated) -> Preintegrated:
    """Concatenate two preintegrations (same linearization bias): the
    reference's MergePrevious/reintegration helper.  Covariances compose by
    the same A/B propagation collapsed over the second window — here the
    first-order approximation Σ = A Σ_a Aᵀ + Σ_b with A the relative-state
    transition."""
    Ra = lie.quat_to_matrix(a.dR)
    dP = a.dP + a.dV * b.dt + Ra @ b.dP
    dV = a.dV + Ra @ b.dV
    dR = lie.quat_normalize(lie.quat_multiply(a.dR, b.dR))
    Rb = lie.quat_to_matrix(b.dR)
    A = jnp.zeros((9, 9), a.dP.dtype)
    A = A.at[0:3, 0:3].set(Rb.T)
    A = A.at[3:6, 3:6].set(jnp.eye(3, dtype=a.dP.dtype))
    A = A.at[6:9, 3:6].set(jnp.eye(3, dtype=a.dP.dtype) * b.dt)
    A = A.at[6:9, 6:9].set(jnp.eye(3, dtype=a.dP.dtype))
    cov = A @ a.cov @ A.T + b.cov
    JRg = Rb.T @ a.JRg + b.JRg
    JVg = a.JVg + Ra @ b.JVg  # cross terms to first order
    JVa = a.JVa + Ra @ b.JVa
    JPg = a.JPg + a.JVg * b.dt + Ra @ b.JPg
    JPa = a.JPa + a.JVa * b.dt + Ra @ b.JPa
    return Preintegrated(
        dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
        cov=cov, dt=a.dt + b.dt, bias_g=a.bias_g, bias_a=a.bias_a,
    )

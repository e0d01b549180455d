"""SO(3) / SE(3) / Sim(3) Lie groups as pure-JAX functions.

JAX equivalent of the reference's vendored Sophus
(orb_slam3/Thirdparty/Sophus) used throughout Tracking /
Optimizer / LoopClosing.  Representation choices:

- SO(3): unit quaternion ``[w, x, y, z]`` (shape ``(..., 4)``).
- SE(3): ``[qw, qx, qy, qz, tx, ty, tz]`` (shape ``(..., 7)``).
- Sim(3): ``[qw, qx, qy, qz, tx, ty, tz, s]`` (shape ``(..., 8)``), scale > 0.

Tangent conventions (matching Sophus):

- so3: rotation vector ``omega`` (3,).
- se3: ``[rho, omega]`` i.e. translation part first? — **No**: we follow
  Sophus/g2o ordering ``[omega, upsilon]``? — Neither is universal; here we
  fix ``se3 tangent = [rho(3), omega(3)]`` with ``exp([rho, omega]) =
  (exp(omega), V(omega) @ rho)`` (Sophus convention: translation first).
- sim3: ``[rho(3), omega(3), sigma(1)]`` with scale ``s = exp(sigma)``.

All functions broadcast over leading batch dimensions, contain no
data-dependent Python control flow (small-angle branches are `jnp.where` over
Taylor expansions), and are differentiable (the `where` branches are guarded
against NaN gradients with the double-where trick).
"""

from __future__ import annotations

import jax.numpy as jnp

# Small-angle crossover. Below this squared-angle we use 4th-order Taylor
# series, whose truncation error is below f32 epsilon at this threshold.
_EPS2 = 1e-8


def _safe(x2):
    """Replace near-zero values by 1 so the 'large' branch of a where() never
    produces NaN gradients (double-where trick)."""
    return jnp.where(x2 < _EPS2, jnp.ones_like(x2), x2)


# ---------------------------------------------------------------------------
# quaternion primitives ([w, x, y, z], Hamilton convention)
# ---------------------------------------------------------------------------


def quat_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_multiply(q, p):
    qw, qx, qy, qz = jnp.moveaxis(q, -1, 0)
    pw, px, py, pz = jnp.moveaxis(p, -1, 0)
    return jnp.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        axis=-1,
    )


def quat_conjugate(q):
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q):
    n2 = jnp.sum(q * q, axis=-1, keepdims=True)
    return q * jnp.sqrt(1.0 / jnp.maximum(n2, jnp.finfo(q.dtype).tiny))


def quat_rotate(q, v):
    """Rotate vector(s) v by unit quaternion(s) q.  O(30) flops, no matrix."""
    qvec = q[..., 1:]
    uv = 2.0 * jnp.cross(qvec, v)
    return v + q[..., :1] * uv + jnp.cross(qvec, uv)


def quat_to_matrix(q):
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix -> unit quaternion, branch-free (Shepperd / BarItzhack).

    Builds all four candidate quaternions and selects the one with the largest
    pivot — numerically stable for every rotation, vmap-safe.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidates, each scaled by its own 4*q_i^2 = pivot
    qw = jnp.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], axis=-1)

    pivots = jnp.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                        1 - m00 - m11 + m22], axis=-1)
    best = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4 candidates, 4)
    q = jnp.take_along_axis(cands, best[..., None, None].astype(jnp.int32),
                            axis=-2)[..., 0, :]
    q = quat_normalize(q)
    # canonicalize sign (w >= 0) so round-trips are deterministic
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def hat(v):
    """Skew-symmetric matrix of (..., 3)."""
    x, y, z = jnp.moveaxis(v, -1, 0)
    zero = jnp.zeros_like(x)
    m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def vee(m):
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------


def so3_exp(omega):
    """Rotation vector -> unit quaternion."""
    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)
    theta = jnp.sqrt(_safe(theta2))
    half = 0.5 * theta
    small = theta2 < _EPS2
    # sin(θ/2)/θ and cos(θ/2); Taylor: 1/2 - θ²/48, 1 - θ²/8
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    w = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return quat_normalize(jnp.concatenate([w, k * omega], axis=-1))


def so3_log(q):
    """Unit quaternion -> rotation vector (angle in [0, pi])."""
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)  # w >= 0 → shortest arc
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    vn2 = jnp.sum(q[..., 1:] * q[..., 1:], axis=-1, keepdims=True)
    vn = jnp.sqrt(_safe(vn2))
    theta = 2.0 * jnp.arctan2(vn, w)
    small = vn2 < _EPS2
    # θ/sin(θ/2) ≈ 2/w · (1 + vn²/(6w²)) for small vn  (θ ≈ 2 vn / w)
    k = jnp.where(small, 2.0 / jnp.maximum(w, 0.5) * (1.0 + vn2 / 6.0),
                  theta / vn)
    return k * q[..., 1:]


def _so3_left_jacobian_terms(omega):
    """Coefficients (a, b) with V = I + a [ω]× + b [ω]×² (left Jacobian)."""
    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)
    theta = jnp.sqrt(_safe(theta2))
    small = theta2 < _EPS2
    a = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / _safe(theta2))
    b = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                  (theta - jnp.sin(theta)) / _safe(theta2 * theta))
    return a, b


def so3_left_jacobian(omega):
    a, b = _so3_left_jacobian_terms(omega)
    W = hat(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)
    return eye + a[..., None] * W + b[..., None] * (W @ W)


def so3_left_jacobian_inv(omega):
    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)
    theta = jnp.sqrt(_safe(theta2))
    small = theta2 < _EPS2
    half = 0.5 * theta
    # c = (1 - θ/2 · cot(θ/2)) / θ²;  Taylor 1/12 + θ²/720
    cot_term = half * jnp.cos(half) / jnp.where(small, jnp.ones_like(half),
                                                jnp.sin(half))
    c = jnp.where(small, 1.0 / 12.0 + theta2 / 720.0,
                  (1.0 - cot_term) / _safe(theta2))
    W = hat(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)
    return eye - 0.5 * W + c[..., None] * (W @ W)


# ---------------------------------------------------------------------------
# SE(3)  —  [qw qx qy qz tx ty tz]
# ---------------------------------------------------------------------------


def se3_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype)


def se3_from_rt(q, t):
    return jnp.concatenate([q, t], axis=-1)


def se3_rotation(T):
    return T[..., :4]


def se3_translation(T):
    return T[..., 4:7]


def se3_from_matrix(M):
    return se3_from_rt(matrix_to_quat(M[..., :3, :3]), M[..., :3, 3])


def se3_to_matrix(T):
    """(..., 7) -> (..., 4, 4) homogeneous matrix."""
    R = quat_to_matrix(T[..., :4])
    t = T[..., 4:7]
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=T.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def se3_multiply(A, B):
    q = quat_multiply(A[..., :4], B[..., :4])
    t = quat_rotate(A[..., :4], B[..., 4:7]) + A[..., 4:7]
    return se3_from_rt(q, t)


def se3_inverse(T):
    qinv = quat_conjugate(T[..., :4])
    return se3_from_rt(qinv, -quat_rotate(qinv, T[..., 4:7]))


def se3_apply(T, p):
    """Transform point(s) p (..., 3) by T (..., 7)."""
    return quat_rotate(T[..., :4], p) + T[..., 4:7]


def se3_exp(xi):
    """Tangent [rho(3), omega(3)] -> SE3 (Sophus convention: t = V(ω) ρ)."""
    rho, omega = xi[..., :3], xi[..., 3:6]
    q = so3_exp(omega)
    V = so3_left_jacobian(omega)
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return se3_from_rt(q, t)


def se3_log(T):
    omega = so3_log(T[..., :4])
    Vinv = so3_left_jacobian_inv(omega)
    rho = jnp.einsum("...ij,...j->...i", Vinv, T[..., 4:7])
    return jnp.concatenate([rho, omega], axis=-1)


def se3_adjoint(T):
    """Adjoint matrix (6, 6) acting on [rho, omega] tangents."""
    R = quat_to_matrix(T[..., :4])
    tR = hat(T[..., 4:7]) @ R
    Z = jnp.zeros_like(R)
    top = jnp.concatenate([R, tR], axis=-1)
    bot = jnp.concatenate([Z, R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def se3_boxplus(T, xi):
    """Left-multiplicative update exp(xi) * T — the optimizer's retraction."""
    return se3_multiply(se3_exp(xi), T)


def se3_normalize(T):
    return se3_from_rt(quat_normalize(T[..., :4]), T[..., 4:7])


# ---------------------------------------------------------------------------
# Sim(3)  —  [qw qx qy qz tx ty tz s]
# ---------------------------------------------------------------------------


def sim3_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0, 0, 0, 0, 0, 0, 1.0], dtype=dtype)


def sim3_from_rts(q, t, s):
    return jnp.concatenate([q, t, s[..., None] if s.ndim < q.ndim else s], axis=-1)


def sim3_scale(S):
    return S[..., 7]


def sim3_multiply(A, B):
    q = quat_multiply(A[..., :4], B[..., :4])
    t = A[..., 7:8] * quat_rotate(A[..., :4], B[..., 4:7]) + A[..., 4:7]
    s = A[..., 7:8] * B[..., 7:8]
    return jnp.concatenate([q, t, s], axis=-1)


def sim3_inverse(S):
    qinv = quat_conjugate(S[..., :4])
    sinv = 1.0 / S[..., 7:8]
    t = -sinv * quat_rotate(qinv, S[..., 4:7])
    return jnp.concatenate([qinv, t, sinv], axis=-1)


def sim3_apply(S, p):
    return S[..., 7:8] * quat_rotate(S[..., :4], p) + S[..., 4:7]


def sim3_from_se3(T, s=None):
    s = jnp.ones(T.shape[:-1] + (1,), T.dtype) if s is None else s
    return jnp.concatenate([T, jnp.broadcast_to(s, T.shape[:-1] + (1,))], axis=-1)


def sim3_to_se3(S):
    """Drop scale (absorbing it into nothing — caller decides semantics)."""
    return S[..., :7]


def _sim3_W_terms(omega, sigma):
    """Coefficients (A, B, C): W = A [ω]× + B [ω]×² + C I  (Sophus Sim3 exp)."""
    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)
    theta = jnp.sqrt(_safe(theta2))
    s2 = sigma * sigma
    scale = jnp.exp(sigma)
    small_s = jnp.abs(sigma) < 1e-4
    small_t = theta2 < _EPS2

    C = jnp.where(small_s, 1.0 + sigma / 2.0 + s2 / 6.0, (scale - 1.0) /
                  jnp.where(small_s, jnp.ones_like(sigma), sigma))

    cos_t, sin_t = jnp.cos(theta), jnp.sin(theta)
    sig_safe = jnp.where(small_s, jnp.ones_like(sigma), sigma)
    th_safe = jnp.sqrt(_safe(theta2))

    # generic case
    a_big = scale * sin_t
    b_big = scale * cos_t
    denom = s2 + theta2
    denom = jnp.where(denom < 1e-12, jnp.ones_like(denom), denom)
    A_gen = (a_big * sigma + (1.0 - b_big) * th_safe) / (th_safe * denom)
    B_gen = (C - ((b_big - 1.0) * sigma + a_big * th_safe) / denom) / _safe(theta2)
    # sigma ≈ 0
    A_s0 = (1.0 - cos_t) / _safe(theta2)
    B_s0 = (th_safe - sin_t) / _safe(theta2 * th_safe)
    # theta ≈ 0 (any sigma)
    A_t0 = jnp.where(small_s, 0.5 + sigma / 6.0,
                     ((sigma - 1.0) * scale + 1.0) / jnp.where(small_s, jnp.ones_like(s2), s2))
    B_t0 = jnp.where(small_s, 1.0 / 6.0 + sigma / 24.0,
                     (scale * 0.5 * s2 + scale - 1.0 - sigma * scale) /
                     jnp.where(small_s, jnp.ones_like(s2), s2 * sig_safe))

    A = jnp.where(small_t, A_t0, jnp.where(small_s, A_s0, A_gen))
    B = jnp.where(small_t, B_t0, jnp.where(small_s, B_s0, B_gen))
    return A, B, C


def sim3_exp(xi):
    """Tangent [rho(3), omega(3), sigma(1)] -> Sim3."""
    rho, omega, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    q = so3_exp(omega)
    A, B, C = _sim3_W_terms(omega, sigma)
    W_ = hat(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W_.shape)
    W = A[..., None] * W_ + B[..., None] * (W_ @ W_) + C[..., None] * eye
    t = jnp.einsum("...ij,...j->...i", W, rho)
    return jnp.concatenate([q, t, jnp.exp(sigma)], axis=-1)


def sim3_log(S):
    omega = so3_log(S[..., :4])
    sigma = jnp.log(S[..., 7:8])
    A, B, C = _sim3_W_terms(omega, sigma)
    W_ = hat(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=S.dtype), W_.shape)
    W = A[..., None] * W_ + B[..., None] * (W_ @ W_) + C[..., None] * eye
    rho = jnp.linalg.solve(W, S[..., 4:7][..., None])[..., 0]
    return jnp.concatenate([rho, omega, sigma], axis=-1)


def sim3_boxplus(S, xi):
    return sim3_multiply(sim3_exp(xi), S)


def sim3_normalize(S):
    return jnp.concatenate(
        [quat_normalize(S[..., :4]), S[..., 4:7], jnp.abs(S[..., 7:8])], axis=-1
    )

"""Unit tests for the Lie-group substrate (SO3/SE3/Sim3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from visual_sgraphs.core import lie


def random_quat(rng, n=None):
    shape = (4,) if n is None else (n, 4)
    q = rng.normal(size=shape)
    return jnp.asarray(q / np.linalg.norm(q, axis=-1, keepdims=True))


def test_quat_rotate_matches_matrix(rng):
    q = random_quat(rng, 16)
    v = jnp.asarray(rng.normal(size=(16, 3)))
    out1 = lie.quat_rotate(q, v)
    out2 = jnp.einsum("nij,nj->ni", lie.quat_to_matrix(q), v)
    np.testing.assert_allclose(out1, out2, atol=1e-12)


def test_matrix_quat_roundtrip(rng):
    q = random_quat(rng, 64)
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    q2 = lie.matrix_to_quat(lie.quat_to_matrix(q))
    np.testing.assert_allclose(q, q2, atol=1e-10)


def test_matrix_quat_degenerate_cases():
    # 180-degree rotations around each axis hit every Shepperd pivot branch
    for axis in range(3):
        w = np.zeros(3)
        w[axis] = np.pi
        q = lie.so3_exp(jnp.asarray(w))
        R = lie.quat_to_matrix(q)
        q2 = lie.matrix_to_quat(R)
        np.testing.assert_allclose(lie.quat_to_matrix(q2), R, atol=1e-10)


def test_so3_exp_log_roundtrip(rng):
    w = jnp.asarray(rng.normal(size=(32, 3)))
    np.testing.assert_allclose(lie.so3_log(lie.so3_exp(w)), w, atol=1e-9)


def test_so3_exp_log_small_angles():
    for scale in [1e-3, 1e-6, 1e-10, 0.0]:
        w = jnp.asarray([1.0, -2.0, 0.5]) * scale
        np.testing.assert_allclose(lie.so3_log(lie.so3_exp(w)), w, atol=1e-12)


def test_so3_exp_matches_rodrigues(rng):
    w = jnp.asarray(rng.normal(size=3))
    theta = float(jnp.linalg.norm(w))
    K = np.asarray(lie.hat(w / theta))
    R_rod = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K
    np.testing.assert_allclose(lie.quat_to_matrix(lie.so3_exp(w)), R_rod,
                               atol=1e-12)


def test_left_jacobian_inverse(rng):
    w = jnp.asarray(rng.normal(size=(8, 3)))
    V = lie.so3_left_jacobian(w)
    Vinv = lie.so3_left_jacobian_inv(w)
    eye = jnp.broadcast_to(jnp.eye(3), V.shape)
    np.testing.assert_allclose(V @ Vinv, eye, atol=1e-9)


def test_se3_exp_log_roundtrip(rng):
    xi = jnp.asarray(rng.normal(size=(32, 6)))
    np.testing.assert_allclose(lie.se3_log(lie.se3_exp(xi)), xi, atol=1e-9)


def test_se3_group_ops(rng):
    xi1 = jnp.asarray(rng.normal(size=6))
    xi2 = jnp.asarray(rng.normal(size=6))
    A, B = lie.se3_exp(xi1), lie.se3_exp(xi2)
    p = jnp.asarray(rng.normal(size=(5, 3)))
    # composition vs matrix composition
    M = lie.se3_to_matrix(lie.se3_multiply(A, B))
    np.testing.assert_allclose(M, lie.se3_to_matrix(A) @ lie.se3_to_matrix(B),
                               atol=1e-12)
    # inverse
    I = lie.se3_multiply(A, lie.se3_inverse(A))
    np.testing.assert_allclose(I[:4], [1, 0, 0, 0], atol=1e-12)
    np.testing.assert_allclose(I[4:], 0, atol=1e-12)
    # action
    ph = jnp.concatenate([p, jnp.ones((5, 1))], axis=-1)
    np.testing.assert_allclose(
        lie.se3_apply(A, p), (ph @ lie.se3_to_matrix(A).T)[:, :3], atol=1e-12
    )


def test_se3_matrix_roundtrip(rng):
    T = lie.se3_exp(jnp.asarray(rng.normal(size=(7, 6))))
    T2 = lie.se3_from_matrix(lie.se3_to_matrix(T))
    np.testing.assert_allclose(
        lie.se3_to_matrix(T2), lie.se3_to_matrix(T), atol=1e-10
    )


def test_se3_adjoint(rng):
    """Adj(T) xi must satisfy exp(Adj(T) xi) = T exp(xi) T^-1."""
    T = lie.se3_exp(jnp.asarray(rng.normal(size=6)))
    xi = jnp.asarray(rng.normal(size=6) * 0.1)
    lhs = lie.se3_exp(lie.se3_adjoint(T) @ xi)
    rhs = lie.se3_multiply(lie.se3_multiply(T, lie.se3_exp(xi)), lie.se3_inverse(T))
    np.testing.assert_allclose(lie.se3_to_matrix(lhs), lie.se3_to_matrix(rhs),
                               atol=1e-9)


def test_sim3_exp_log_roundtrip(rng):
    xi = jnp.asarray(rng.normal(size=(32, 7)))
    np.testing.assert_allclose(lie.sim3_log(lie.sim3_exp(xi)), xi, atol=1e-8)


def test_sim3_exp_log_edge_cases():
    # sigma=0 (pure SE3), theta=0 (pure scale+trans), both zero
    cases = [
        [0.3, -0.2, 0.1, 0.5, -0.4, 0.2, 0.0],
        [0.3, -0.2, 0.1, 0.0, 0.0, 0.0, 0.7],
        [0.3, -0.2, 0.1, 0.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [0.3, -0.2, 0.1, 1e-7, 0.0, 0.0, 1e-7],
    ]
    for c in cases:
        xi = jnp.asarray(c)
        np.testing.assert_allclose(lie.sim3_log(lie.sim3_exp(xi)), xi,
                                   atol=1e-7, err_msg=str(c))


def test_sim3_group_ops(rng):
    A = lie.sim3_exp(jnp.asarray(rng.normal(size=7)))
    B = lie.sim3_exp(jnp.asarray(rng.normal(size=7)))
    p = jnp.asarray(rng.normal(size=(4, 3)))
    np.testing.assert_allclose(
        lie.sim3_apply(lie.sim3_multiply(A, B), p),
        lie.sim3_apply(A, lie.sim3_apply(B, p)),
        atol=1e-9,
    )
    I = lie.sim3_multiply(A, lie.sim3_inverse(A))
    np.testing.assert_allclose(I, lie.sim3_identity(I.dtype), atol=1e-10)


def test_vmap_and_jit_safety(rng):
    xi = jnp.asarray(rng.normal(size=(10, 6)))
    out = jax.jit(jax.vmap(lambda x: lie.se3_log(lie.se3_exp(x))))(xi)
    np.testing.assert_allclose(out, xi, atol=1e-9)


def test_gradients_finite_at_identity():
    """The double-where guards must keep gradients NaN-free at theta=0."""
    g = jax.grad(lambda w: jnp.sum(lie.so3_exp(w)))(jnp.zeros(3))
    assert np.all(np.isfinite(g))
    g = jax.grad(lambda x: jnp.sum(lie.se3_exp(x)))(jnp.zeros(6))
    assert np.all(np.isfinite(g))
    g = jax.grad(lambda x: jnp.sum(lie.sim3_exp(x)))(jnp.zeros(7))
    assert np.all(np.isfinite(g))

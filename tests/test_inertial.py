"""Inertial subsystem: preintegration correctness, bias Jacobians, factor
residuals, gravity/scale initialization, VI local BA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from visual_sgraphs.core import lie
from visual_sgraphs.inertial import (
    apply_scaled_rotation,
    bias_corrected_delta,
    inertial_init,
    identity_preint,
    merge,
    predict_state,
    preintegrate,
)
from visual_sgraphs.inertial import factors as ifac
from visual_sgraphs.inertial.preintegration import GRAVITY

T_BC_IDENTITY = jnp.asarray([1.0, 0, 0, 0, 0, 0, 0])


def _simulate(omega_fn, acc_fn, n, dt):
    """Ground-truth body trajectory by fine integration (world frame,
    no gravity: acc_fn returns true body acceleration)."""
    q = lie.quat_identity(jnp.float64)
    v = jnp.zeros(3, jnp.float64)
    p = jnp.zeros(3, jnp.float64)
    qs, vs, ps, ws, fs = [q], [v], [p], [], []
    for k in range(n):
        w = jnp.asarray(omega_fn(k * dt), jnp.float64)
        a_b = jnp.asarray(acc_fn(k * dt), jnp.float64)  # body-frame accel
        R = lie.quat_to_matrix(q)
        a_w = R @ a_b
        p = p + v * dt + 0.5 * a_w * dt * dt
        v = v + a_w * dt
        q = lie.quat_normalize(lie.quat_multiply(q, lie.so3_exp(w * dt)))
        qs.append(q), vs.append(v), ps.append(p)
        ws.append(w), fs.append(a_b)
    return qs, vs, ps, jnp.stack(ws), jnp.stack(fs)


class TestPreintegration:
    def test_matches_dead_reckoning(self):
        """ΔR/ΔV/ΔP must reproduce gravity-free dead reckoning."""
        n, dt = 50, 0.005
        om = lambda t: [0.3 * np.sin(t * 3), 0.2, -0.1 * np.cos(t * 2)]
        ac = lambda t: [0.5, -0.3 * np.sin(t), 0.8]
        qs, vs, ps, ws, fs = _simulate(om, ac, n, dt)
        pre = preintegrate(
            ws.astype(jnp.float32), fs.astype(jnp.float32),
            jnp.full((n,), dt, jnp.float32), jnp.ones((n,), bool),
            jnp.zeros(3), jnp.zeros(3), 1e-4, 1e-3,
        )
        # ΔR == R_end (identity start); ΔV == v_end; ΔP == p_end
        err_R = lie.so3_log(
            lie.quat_multiply(lie.quat_conjugate(pre.dR),
                              qs[-1].astype(jnp.float32))
        )
        assert float(jnp.linalg.norm(err_R)) < 1e-3
        np.testing.assert_allclose(np.asarray(pre.dV),
                                   np.asarray(vs[-1]), atol=2e-3)
        np.testing.assert_allclose(np.asarray(pre.dP),
                                   np.asarray(ps[-1]), atol=2e-3)
        assert abs(float(pre.dt) - n * dt) < 1e-6
        # covariance is PSD and grows with time
        eig = np.linalg.eigvalsh(np.asarray(pre.cov))
        assert eig.min() > -1e-10

    def test_bias_jacobians_match_reintegration(self):
        """First-order bias correction must match re-integrating with the
        perturbed bias (Preintegrated::GetDelta* linearization)."""
        n, dt = 40, 0.005
        om = lambda t: [0.4, -0.2 * np.sin(t * 4), 0.15]
        ac = lambda t: [0.3 * np.cos(t * 2), 0.5, -0.4]
        _, _, _, ws, fs = _simulate(om, ac, n, dt)
        ws32, fs32 = ws.astype(jnp.float32), fs.astype(jnp.float32)
        dts = jnp.full((n,), dt, jnp.float32)
        ok = jnp.ones((n,), bool)
        b0 = jnp.zeros(3)
        pre = preintegrate(ws32, fs32, dts, ok, b0, b0, 1e-4, 1e-3)
        dbg = jnp.asarray([0.005, -0.003, 0.002])
        dba = jnp.asarray([0.01, 0.02, -0.015])
        dR_lin, dV_lin, dP_lin = bias_corrected_delta(pre, dbg, dba)
        pre2 = preintegrate(ws32, fs32, dts, ok, dbg, dba, 1e-4, 1e-3)
        err_R = lie.so3_log(
            lie.quat_multiply(lie.quat_conjugate(dR_lin), pre2.dR)
        )
        assert float(jnp.linalg.norm(err_R)) < 2e-4
        np.testing.assert_allclose(np.asarray(dV_lin), np.asarray(pre2.dV),
                                   atol=2e-3)
        np.testing.assert_allclose(np.asarray(dP_lin), np.asarray(pre2.dP),
                                   atol=2e-3)

    def test_merge_composes(self):
        n, dt = 30, 0.005
        om = lambda t: [0.2, 0.3, -0.25]
        ac = lambda t: [0.1, -0.6, 0.9]
        _, _, _, ws, fs = _simulate(om, ac, 2 * n, dt)
        ws32, fs32 = ws.astype(jnp.float32), fs.astype(jnp.float32)
        dts = jnp.full((2 * n,), dt, jnp.float32)
        ok = jnp.ones((2 * n,), bool)
        b0 = jnp.zeros(3)
        full = preintegrate(ws32, fs32, dts, ok, b0, b0)
        a = preintegrate(ws32[:n], fs32[:n], dts[:n], ok[:n], b0, b0)
        b = preintegrate(ws32[n:], fs32[n:], dts[n:], ok[n:], b0, b0)
        m = merge(a, b)
        np.testing.assert_allclose(np.asarray(m.dP), np.asarray(full.dP),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(m.dV), np.asarray(full.dV),
                                   atol=1e-4)
        err_R = lie.so3_log(
            lie.quat_multiply(lie.quat_conjugate(m.dR), full.dR)
        )
        assert float(jnp.linalg.norm(err_R)) < 1e-5


class TestImuFactor:
    def _make_states(self, g_w):
        """Two body states consistent with a constant-rate window under
        gravity g_w; returns (T_i, T_j, v_i, v_j, pre)."""
        n, dt = 40, 0.005
        om = lambda t: [0.1, -0.2, 0.3]
        ac = lambda t: [0.4, 0.1, -0.2]  # true body acceleration
        qs, vs, ps, ws, fs = _simulate(om, ac, n, dt)
        # accelerometer measures specific force: f = a_b - R^T g
        R_list = [lie.quat_to_matrix(q) for q in qs[:-1]]
        f_meas = jnp.stack([
            fs[k] - R_list[k].T @ g_w.astype(jnp.float64)
            for k in range(n)
        ]).astype(jnp.float32)
        pre = preintegrate(
            ws.astype(jnp.float32), f_meas,
            jnp.full((n,), dt, jnp.float32), jnp.ones((n,), bool),
            jnp.zeros(3), jnp.zeros(3),
        )
        def Tcw(q, p):  # body == camera (T_bc = I); pose stored as T_cw
            T_wb = lie.se3_from_rt(q.astype(jnp.float32),
                                   p.astype(jnp.float32))
            return lie.se3_inverse(T_wb)
        return (Tcw(qs[0], ps[0]), Tcw(qs[-1], ps[-1]),
                vs[0].astype(jnp.float32), vs[-1].astype(jnp.float32), pre)

    def test_zero_residual_on_perfect_data(self):
        g_w = jnp.asarray([0.0, 0.0, -GRAVITY])
        T_i, T_j, v_i, v_j, pre = self._make_states(g_w)
        const = {
            "dR": pre.dR, "dV": pre.dV, "dP": pre.dP,
            "JRg": pre.JRg, "JVg": pre.JVg, "JVa": pre.JVa,
            "JPg": pre.JPg, "JPa": pre.JPa, "dt": pre.dt,
            "bias_g": pre.bias_g, "bias_a": pre.bias_a,
            "sqrt_info": jnp.eye(9), "T_bc": T_BC_IDENTITY, "g_w": g_w,
        }
        r = ifac.imu_factor(
            (T_i, T_j, v_i, v_j, jnp.zeros(3), jnp.zeros(3)), const
        )
        assert float(jnp.linalg.norm(r)) < 5e-3

    def test_residual_sensitive_to_wrong_velocity(self):
        g_w = jnp.asarray([0.0, 0.0, -GRAVITY])
        T_i, T_j, v_i, v_j, pre = self._make_states(g_w)
        const = {
            "dR": pre.dR, "dV": pre.dV, "dP": pre.dP,
            "JRg": pre.JRg, "JVg": pre.JVg, "JVa": pre.JVa,
            "JPg": pre.JPg, "JPa": pre.JPa, "dt": pre.dt,
            "bias_g": pre.bias_g, "bias_a": pre.bias_a,
            "sqrt_info": jnp.eye(9), "T_bc": T_BC_IDENTITY, "g_w": g_w,
        }
        r = ifac.imu_factor(
            (T_i, T_j, v_i + 1.0, v_j, jnp.zeros(3), jnp.zeros(3)), const
        )
        assert float(jnp.linalg.norm(r)) > 0.1


class TestInertialInit:
    def test_recovers_gravity_and_velocity(self):
        """Keyframes from the synthetic IMU generator: init must find the
        true gravity direction (y-down world) and sane velocities."""
        from visual_sgraphs.io.synthetic import SyntheticScene
        from visual_sgraphs.inertial.pipeline import ImuPipeline
        from visual_sgraphs.config import ImuConfig

        scene = SyntheticScene(h=64, w=64)  # images unused; tiny render
        pipe = ImuPipeline(ImuConfig(), max_keyframes=32, fix_scale=True)
        poses = []
        k = 0
        for gray, depth, T_wc, ts, samples in scene.frames_with_imu(
            30, kind="arc", fps=30.0, imu_rate=240.0
        ):
            pipe.add_samples(*samples)
            pipe.preintegrate_frame(ts)
            # every 3rd frame becomes a "keyframe" with GT pose
            if int(ts * 30 + 0.5) % 3 == 0:
                poses.append(np.asarray(lie.se3_inverse(jnp.asarray(T_wc))))
                pipe.on_keyframe(k)
                k += 1
        kf_pose = jnp.asarray(np.stack(poses))
        n = kf_pose.shape[0]
        res = inertial_init(
            kf_pose, jnp.ones((n,), bool),
            jax.tree.map(lambda a: a[:n], pipe.state.preint),
            pipe.state.preint_valid[:n],
            T_BC_IDENTITY, fix_scale=True, iters=40,
        )
        assert float(res.cost) < float(res.cost0)
        g_est = np.asarray(ifac.gravity_from_quat(res.q_wg))
        g_true = np.array([0.0, GRAVITY, 0.0])  # y-down world
        cos = g_est @ g_true / (np.linalg.norm(g_est) * GRAVITY)
        assert cos > 0.99, f"gravity direction off: {g_est}"
        assert float(jnp.max(jnp.abs(res.bias_g))) < 0.02

    def test_apply_scaled_rotation_aligns_gravity(self, rng):
        from visual_sgraphs.slam.map_state import empty_map
        from visual_sgraphs.config import CapacityConfig, OrbConfig

        m = empty_map(CapacityConfig(max_keyframes=8, max_points=64),
                      OrbConfig(n_features=16))
        T = jax.vmap(lie.se3_exp)(
            jnp.asarray(rng.normal(size=(8, 6)) * 0.2, jnp.float32)
        )
        pts = jnp.asarray(rng.normal(size=(64, 3)), jnp.float32)
        m = m._replace(kf_pose=T, kf_valid=jnp.ones(8, bool),
                       pt_pos=pts, pt_valid=jnp.ones(64, bool))
        q_wg = lie.quat_normalize(jnp.asarray([0.9, 0.3, -0.2, 0.1]))
        s = jnp.asarray(2.0)
        m2 = apply_scaled_rotation(m, q_wg, s)
        # camera-frame geometry must be preserved up to scale:
        # x_c' = s * x_c for any world point
        xc = lie.se3_apply(m.kf_pose[3], m.pt_pos[10])
        R_gw = lie.quat_to_matrix(lie.quat_conjugate(q_wg))
        xw2 = s * (R_gw @ m.pt_pos[10])
        xc2 = lie.se3_apply(m2.kf_pose[3], xw2)
        np.testing.assert_allclose(np.asarray(xc2), np.asarray(s * xc),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.slow
class TestVisualInertialE2E:
    def test_rgbd_inertial_tracks_and_initializes(self):
        from visual_sgraphs.config import (
            CapacityConfig, OrbConfig, Sensor, SystemConfig,
        )
        from visual_sgraphs.io.synthetic import SyntheticScene
        from visual_sgraphs.slam import SlamSystem
        from visual_sgraphs.core import geometry

        scene = SyntheticScene()
        cfg = SystemConfig(
            sensor=Sensor.IMU_RGBD, camera=scene.cam,
            orb=OrbConfig(n_features=512),
            capacity=CapacityConfig(max_keyframes=64, max_points=16384),
        )
        system = SlamSystem(cfg)
        gt = []
        for gray, depth, T_wc, ts, samples in scene.frames_with_imu(
            60, kind="arc", imu_rate=240.0,
            noise_gyro=1e-4, noise_acc=1e-3,
        ):
            system.track_rgbd(gray, depth, ts, imu=samples)
            gt.append(np.asarray(T_wc)[4:7])
        assert system.imu.initialized, "IMU never initialized"
        est = system.positions()
        rmse, _ = geometry.ate_rmse(jnp.asarray(est),
                                    jnp.asarray(np.stack(gt)))
        assert float(rmse) < 0.08, f"VI ATE {float(rmse):.4f}"

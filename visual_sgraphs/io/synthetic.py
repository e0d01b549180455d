"""Synthetic RGB-D sequence renderer: textured plane-world with exact GT.

A batched ray-cast renderer over a small set of textured planes (floor,
walls, ceiling) — every pixel is one ray/plane intersection, the texture is
a procedural multi-scale 3D cell pattern (piecewise-constant => strong FAST
corners), and depth comes out exact.  This gives the test/bench harness a
TUM-like RGB-D stream with perfect ground truth and, later, perfect
plane/semantic labels for the scene-graph layer — replacing the external
datasets the reference replays over ROS (launch/*.launch).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from visual_sgraphs.config import CameraConfig
from visual_sgraphs.core import lie


def _hash3(p: jax.Array) -> jax.Array:
    """Deterministic lattice hash -> [0, 1) (shader-style, batched)."""
    k = jnp.asarray([127.1, 311.7, 74.7], p.dtype)
    h = jnp.sin(jnp.sum(p * k, axis=-1)) * 43758.5453
    return h - jnp.floor(h)


def cell_texture(p: jax.Array) -> jax.Array:
    """Multi-scale piecewise-constant 3D texture in [0, 255]."""
    c1 = _hash3(jnp.floor(p * 2.5))
    c2 = _hash3(jnp.floor(p * 7.0))
    c3 = _hash3(jnp.floor(p * 19.0))
    return (0.55 * c1 + 0.3 * c2 + 0.15 * c3) * 235.0 + 10.0


class PlaneSet(NamedTuple):
    coeffs: jax.Array  # (P, 4) world planes, |n| = 1, n·x + c = 0
    semantic: jax.Array  # (P,) 0 ground / 1 wall / 2 ceiling (scene-graph GT)


def room_planes(half_x=2.5, half_y=1.6, z_back=7.0, z_front=-3.0) -> PlaneSet:
    """A rectangular room: floor (y=+half_y, camera convention y-down),
    ceiling, two side walls, front and back walls."""
    planes = np.array(
        [
            [0.0, -1.0, 0.0, half_y],   # floor   (y = +half_y)
            [0.0, 1.0, 0.0, half_y],    # ceiling (y = -half_y)
            [1.0, 0.0, 0.0, half_x],    # left wall (x = -half_x)
            [-1.0, 0.0, 0.0, half_x],   # right wall (x = +half_x)
            [0.0, 0.0, -1.0, z_back],   # back wall (z = z_back)
            [0.0, 0.0, 1.0, -z_front],  # behind-camera wall
        ],
        np.float32,
    )
    sem = np.array([0, 2, 1, 1, 1, 1], np.int32)
    return PlaneSet(jnp.asarray(planes), jnp.asarray(sem))


@functools.partial(jax.jit, static_argnames=("h", "w"))
def render(T_wc: jax.Array, planes: PlaneSet, cam_K: jax.Array,
           h: int = 480, w: int = 640):
    """Render (gray (h,w), depth (h,w), sem (h,w)) from camera pose T_wc.

    Rays are (x, y, 1) in camera frame, so the intersection parameter t is
    exactly the z-depth (matching TUM depth-map semantics).
    """
    fx, fy, cx, cy = cam_K[0], cam_K[1], cam_K[2], cam_K[3]
    us = (jnp.arange(w, dtype=jnp.float32) - cx) / fx
    vs = (jnp.arange(h, dtype=jnp.float32) - cy) / fy
    dirs_cam = jnp.stack(
        [
            jnp.broadcast_to(us[None, :], (h, w)),
            jnp.broadcast_to(vs[:, None], (h, w)),
            jnp.ones((h, w), jnp.float32),
        ],
        axis=-1,
    )
    R = lie.quat_to_matrix(T_wc[:4])
    origin = T_wc[4:7]
    dirs = jnp.einsum("ij,hwj->hwi", R, dirs_cam)

    n = planes.coeffs[:, :3]  # (P, 3)
    c4 = planes.coeffs[:, 3]
    denom = jnp.einsum("hwi,pi->hwp", dirs, n)
    num = -(jnp.einsum("i,pi->p", origin, n) + c4)
    t = num[None, None, :] / jnp.where(jnp.abs(denom) < 1e-6, 1e-6, denom)
    t = jnp.where((t > 0.2) & (jnp.abs(denom) > 1e-6), t, jnp.inf)
    tmin = jnp.min(t, axis=-1)
    pidx = jnp.argmin(t, axis=-1)
    hit = jnp.isfinite(tmin)
    tsafe = jnp.where(hit, tmin, 1.0)
    pts = origin[None, None, :] + tsafe[..., None] * dirs
    gray = cell_texture(pts)
    depth = jnp.where(hit, tsafe, 0.0)
    sem = jnp.where(hit, planes.semantic[pidx], -1)
    return jnp.where(hit, gray, 0.0), depth, sem


def _on_cpu():
    """Context placing computations on the CPU backend.

    The synthetic sensor data is made there wherever the system runs: the
    texture hash multiplies ``sin`` by 43758, so a last-bit difference
    between backends, or a TF32 ray product on a GPU (which moves texture
    edges from frame to frame), renders another world."""
    return jax.default_device(jax.devices("cpu")[0])


class SyntheticScene:
    """A room + trajectory; yields (gray, depth, T_wc_gt, timestamp) as
    numpy arrays computed on the CPU backend.

    ``room="hall"`` renders a 24x20 m hall instead of the default small
    room — the long-stream harness for loop closure across hundreds of
    keyframes (a KITTI-00-style gap on indoor RGB-D scales)."""

    def __init__(self, cam: CameraConfig | None = None, seed: int = 0,
                 h: int = 240, w: int = 320, room: str = "room"):
        self.cam = cam or CameraConfig(
            fx=260.0, fy=260.0, cx=w / 2 - 0.5, cy=h / 2 - 0.5,
            width=w, height=h, k1=0.0, k2=0.0, k3=0.0,
            bf=0.08 * 260.0,
        )
        self.h, self.w = h, w
        if room == "hall":
            self.planes = room_planes(half_x=12.0, half_y=2.0,
                                      z_back=16.0, z_front=-4.0)
        else:
            self.planes = room_planes()
        self.cam_K = jnp.asarray(self.cam.K)

    def trajectory(self, n_frames: int, kind: str = "arc") -> np.ndarray:
        """(T, 7) ground-truth T_wc poses (one vmapped exp, not T eager ones)."""
        s = np.arange(n_frames) / max(n_frames - 1, 1)
        if kind == "arc":
            xi = np.stack(
                [
                    0.8 * np.sin(s * 2.0),       # x sweep
                    0.15 * np.sin(s * 6.0),      # small y bob
                    1.5 * s,                     # forward
                    0.08 * np.sin(s * 5.0),      # pitch wobble
                    -0.35 * s,                   # slow yaw
                    0.04 * np.sin(s * 7.0),
                ],
                axis=-1,
            )
        elif kind == "forward":
            xi = np.stack([0 * s, 0 * s, 2.5 * s, 0 * s, 0 * s, 0 * s], -1)
        elif kind in ("orbit", "orbit2"):
            # closed loop: the camera circles inside the room with yaw
            # following the tangent, returning exactly to the start pose —
            # the loop-closure test trajectory ("orbit2": two laps, so the
            # revisit happens mid-stream)
            laps = 2.0 if kind == "orbit2" else 1.0
            a = laps * 2.0 * np.pi * s
            r = 0.9
            q = np.stack(
                [np.cos(a / 2), 0 * a, np.sin(a / 2), 0 * a], axis=-1
            )  # yaw about y
            t = np.stack(
                [r * np.sin(a), 0.05 * np.sin(3 * a), r * (1 - np.cos(a))],
                axis=-1,
            )
            return np.concatenate([q, t], axis=-1).astype(np.float32)
        elif kind == "bigloop":
            # ONE slow large-radius lap plus a 25% revisit segment inside
            # the hall: hundreds of keyframes elapse between mapping a
            # wall section and seeing it again, so the eventual closure
            # spans a multi-hundred-KF gap (the KITTI-00 loop structure
            # at indoor scale)
            laps = 1.25
            a = laps * 2.0 * np.pi * s
            r = 7.0
            q = np.stack(
                [np.cos(a / 2), 0 * a, np.sin(a / 2), 0 * a], axis=-1
            )  # yaw about y follows the tangent
            t = np.stack(
                [r * np.sin(a), 0.05 * np.sin(3 * a),
                 -1.0 + r * (1 - np.cos(a))],
                axis=-1,
            )
            return np.concatenate([q, t], axis=-1).astype(np.float32)
        else:
            raise ValueError(kind)
        with _on_cpu():
            return np.asarray(jax.jit(jax.vmap(lie.se3_exp))(
                jnp.asarray(xi, jnp.float32)))

    def _render(self, T_wc):
        """(gray, depth, sem) numpy images seen from ``T_wc``."""
        cpu = jax.devices("cpu")[0]
        args = jax.device_put((np.asarray(T_wc), self.planes, self.cam_K),
                              cpu)
        with _on_cpu():
            out = render(*args, self.h, self.w)
        return tuple(np.asarray(x) for x in out)

    def frames(self, n_frames: int, kind: str = "arc", fps: float = 30.0):
        traj = self.trajectory(n_frames, kind)
        for i, T_wc in enumerate(traj):
            gray, depth, _ = self._render(T_wc)
            yield gray, depth, T_wc, i / fps

    def frames_hostile(self, n_frames: int, kind: str = "arc",
                       fps: float = 30.0, seed: int = 0, params=None):
        """The same stream through the hostile-sensor model (io/degrade.py):
        Kinect depth noise + holes, motion blur, exposure drift — the
        dataset-replay stand-in for real-sensor gates."""
        from visual_sgraphs.io.degrade import DegradeParams, degrade_rgbd

        params = params or DegradeParams()
        traj = self.trajectory(n_frames, kind)
        key = jax.random.PRNGKey(seed)
        fx = self.cam.fx
        prev = None
        for i, T_wc in enumerate(traj):
            gray, depth, _ = self._render(T_wc)
            # apparent image motion from the GT pose delta (px/frame)
            if prev is None:
                flow = jnp.zeros((2,), jnp.float32)
            else:
                d = np.asarray(T_wc[4:7]) - np.asarray(prev[4:7])
                z_mid = 3.0
                flow = jnp.asarray(
                    [fx * d[0] / z_mid, fx * d[1] / z_mid], jnp.float32
                )
            prev = T_wc
            key, sub = jax.random.split(key)
            with _on_cpu():
                g2, d2 = degrade_rgbd(
                    gray, depth, sub, jnp.float32(i / fps), flow, params
                )
            yield np.asarray(g2), np.asarray(d2), T_wc, i / fps

    def frames_with_imu(self, n_frames: int, kind: str = "arc",
                        fps: float = 30.0, imu_rate: float = 200.0,
                        g_world=(0.0, 9.81, 0.0), seed: int = 0,
                        noise_gyro: float = 0.0, noise_acc: float = 0.0):
        """Yield (gray, depth, T_wc, ts, (omega, acc, t)) — ideal IMU
        samples between consecutive frames, derived from a densely sampled
        version of the same trajectory.

        ``g_world``: true gravity in the synthetic world frame (the camera
        convention is y-down, so gravity default is +y).  Gyro is the body
        rate ω_b = log(R_iᵀR_{i+1})/δt; the accelerometer returns specific
        force f_b = R_wbᵀ(a_w − g_w).
        """
        sub = max(int(round(imu_rate / fps)), 1)
        dense_n = (n_frames - 1) * sub + 1
        # dense trajectory with matching endpoints: reuse the same param s
        dense = self.trajectory(dense_n, kind)  # (D, 7) T_wc
        dt = 1.0 / (fps * sub)
        q = dense[:, :4]
        p = dense[:, 4:7]
        # body rates by finite differences
        with _on_cpu():
            q_j = jnp.asarray(q)
            rel = jax.vmap(
                lambda a, b: lie.so3_log(
                    lie.quat_multiply(lie.quat_conjugate(a), b)
                )
            )(q_j[:-1], q_j[1:])
            R = np.asarray(jax.vmap(lie.quat_to_matrix)(q_j))  # R_wb
        omega = np.asarray(rel) / dt  # (D-1, 3) body frame
        a_w = np.zeros_like(p)
        a_w[1:-1] = (p[2:] - 2 * p[1:-1] + p[:-2]) / (dt * dt)
        a_w[0], a_w[-1] = a_w[1], a_w[-2]
        g = np.asarray(g_world, np.float32)
        f_b = np.einsum("dij,dj->di", R.transpose(0, 2, 1), a_w - g[None])
        rng = np.random.default_rng(seed)
        if noise_gyro:
            omega = omega + rng.normal(size=omega.shape) * noise_gyro
        if noise_acc:
            f_b = f_b + rng.normal(size=f_b.shape) * noise_acc

        traj = dense[::sub]
        for i, T_wc in enumerate(traj):
            gray, depth, _ = self._render(T_wc)
            ts = i / fps
            if i == 0:
                samples = (np.zeros((0, 3)), np.zeros((0, 3)),
                           np.zeros((0,)))
            else:
                lo, hi = (i - 1) * sub, i * sub
                t_s = (np.arange(lo, hi) + 1) * dt
                samples = (omega[lo:hi], f_b[lo:hi], t_s)
            yield gray, depth, T_wc, ts, samples

    def frames_with_semantics(self, n_frames: int, kind: str = "arc",
                              fps: float = 30.0):
        traj = self.trajectory(n_frames, kind)
        for i, T_wc in enumerate(traj):
            gray, depth, sem = self._render(T_wc)
            yield gray, depth, sem, T_wc, i / fps

"""Per-frame observations: ORB keypoints + depth, ready for tracking.

Equivalent of the reference's ``Frame`` construction (Frame.cc:314-415 for
RGB-D): ORB extraction, undistortion, and depth lookup happen here, once per
camera frame, entirely on device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from visual_sgraphs.config import CameraConfig, OrbConfig
from visual_sgraphs.core import cameras
from visual_sgraphs.features import OrbParams, extract_orb


class FrameObs(NamedTuple):
    """One frame's fixed-capacity observation set (F keypoints)."""

    uv: jax.Array  # (F, 2) undistorted pixel coords
    depth: jax.Array  # (F,) metric depth, <=0 unknown
    level: jax.Array  # (F,) int32
    angle: jax.Array  # (F,)
    desc: jax.Array  # (F, 32) uint8
    valid: jax.Array  # (F,)
    timestamp: jax.Array  # ()


def _orb_params(orb: OrbConfig) -> OrbParams:
    return OrbParams(
        n_features=orb.n_features,
        n_levels=orb.n_levels,
        scale=orb.scale_factor,
        ini_thresh=orb.ini_fast_thresh,
        min_thresh=orb.min_fast_thresh,
    )


@functools.lru_cache(maxsize=None)
def _jit_frame_obs(cam: CameraConfig, orb: OrbConfig, has_depth: bool):
    """One fused device program for the whole Frame construction — the
    per-frame hot path must be a single dispatch, not hundreds of eager
    ops each dispatched on its own."""
    params = _orb_params(orb)
    is_kb8 = getattr(cam, "model", "pinhole") == "kb8"
    undistort = is_kb8 or any(
        abs(d) > 0 for d in (cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)
    )

    def fn(gray, depth_img, timestamp):
        kp = extract_orb(gray, params)
        uv = kp.uv
        if is_kb8:
            # Kannala-Brandt fisheye: unproject raw keypoints through the
            # kb8 model onto virtual-pinhole pixels (KannalaBrandt8.cpp's
            # unprojection; downstream tracking/BA use the calibrated
            # pinhole geometry)
            kb = jnp.asarray([cam.fx, cam.fy, cam.cx, cam.cy,
                              cam.k1, cam.k2, cam.k3, cam.k4], jnp.float32)
            rays = cameras.unproject_kb8(kb, uv)
            z = jnp.maximum(rays[:, 2], 1e-6)
            uv = jnp.stack(
                [rays[:, 0] / z * cam.fx + cam.cx,
                 rays[:, 1] / z * cam.fy + cam.cy], -1
            )
        elif undistort:
            # undistort keypoints (Frame::UndistortKeyPoints)
            dist = jnp.asarray(cam.dist)
            xy = jnp.stack(
                [(uv[:, 0] - cam.cx) / cam.fx,
                 (uv[:, 1] - cam.cy) / cam.fy], -1
            )
            xyu = cameras.undistort_radtan(dist, xy)
            uv = jnp.stack(
                [xyu[:, 0] * cam.fx + cam.cx,
                 xyu[:, 1] * cam.fy + cam.cy], -1
            )
        if has_depth:
            # nearest-pixel depth at the *raw* keypoint location
            r = jnp.clip(jnp.round(kp.uv[:, 1]).astype(jnp.int32), 0,
                         depth_img.shape[0] - 1)
            c = jnp.clip(jnp.round(kp.uv[:, 0]).astype(jnp.int32), 0,
                         depth_img.shape[1] - 1)
            depth = depth_img[r, c]
            depth = jnp.where(depth > 0, depth, -1.0)
        else:
            depth = jnp.full((uv.shape[0],), -1.0, jnp.float32)
        return FrameObs(
            uv=uv,
            depth=depth,
            level=kp.level,
            angle=kp.angle,
            desc=kp.desc,
            valid=kp.valid,
            timestamp=timestamp.astype(jnp.float32),
        )

    return jax.jit(fn)


def make_frame_obs(
    gray: jax.Array,
    depth_img: jax.Array | None,
    timestamp,
    cam: CameraConfig,
    orb: OrbConfig,
) -> FrameObs:
    """Extract ORB + look up depth at keypoints — ONE jitted program per
    (camera, orb, shape) bucket (Frame ctor, Frame.cc:314-415).

    ``gray``: (H, W) float32 [0,255]; ``depth_img``: (H, W) metric depth or
    None for monocular.
    """
    has_depth = depth_img is not None
    fn = _jit_frame_obs(cam, orb, has_depth)
    if not has_depth:
        depth_img = jnp.zeros((1, 1), jnp.float32)
    return fn(gray, depth_img, jnp.asarray(timestamp, jnp.float32))


@functools.lru_cache(maxsize=None)
def _jit_frame_obs_stereo(cam: CameraConfig, orb: OrbConfig,
                          max_row_diff: float):
    from visual_sgraphs.features.match import match_window

    params = _orb_params(orb)

    def fn(gray_l, gray_r, timestamp):
        kl = extract_orb(gray_l, params)
        kr = extract_orb(gray_r, params)
        # match left keypoints against right ones on (almost) the same row:
        # reuse the window matcher with the row as the only free coordinate
        # by predicting each left keypoint at its own (u, v) and allowing a
        # wide horizontal radius — then gate the row difference explicitly
        match, _ = match_window(
            kl.desc, kl.uv, kl.valid, kr.desc, kr.uv, kr.valid,
            radius=float(cam.width) * 0.3,
            level_a=kl.level, level_b=kr.level, level_slack=1,
        )
        ok = match >= 0
        slot = jnp.maximum(match, 0)
        row_ok = jnp.abs(kl.uv[:, 1] - kr.uv[slot, 1]) <= max_row_diff
        disp = kl.uv[:, 0] - kr.uv[slot, 0]
        good = ok & row_ok & (disp > 0.5)
        depth = jnp.where(good, cam.bf / jnp.maximum(disp, 0.5), -1.0)
        return FrameObs(
            uv=kl.uv,
            depth=depth,
            level=kl.level,
            angle=kl.angle,
            desc=kl.desc,
            valid=kl.valid,
            timestamp=timestamp.astype(jnp.float32),
        )

    return jax.jit(fn)


def make_frame_obs_stereo(
    gray_l: jax.Array,
    gray_r: jax.Array,
    timestamp,
    cam: CameraConfig,
    orb: OrbConfig,
    max_row_diff: float = 2.0,
) -> FrameObs:
    """Rectified stereo frame: ORB in both images, epipolar-row descriptor
    match, disparity -> depth (Frame::ComputeStereoMatches, Frame.cc — the
    reference's row-banded search + SAD subpixel refine becomes one masked
    window match; depth = bf / disparity).  One jitted program."""
    fn = _jit_frame_obs_stereo(cam, orb, max_row_diff)
    return fn(gray_l, gray_r, jnp.asarray(timestamp, jnp.float32))

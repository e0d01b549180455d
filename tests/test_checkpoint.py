"""Checkpoint / resume: full-session save -> load -> continue tracking.

SURVEY §5.4: the rebuild's checkpoint must be strictly more complete than
the reference's .osa archive (System::SaveAtlas, System.cc:1161) — it also
covers stashed Atlas maps, the scene graph, the place database and all
host-side tracking counters."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from visual_sgraphs.config import (
    CapacityConfig,
    OrbConfig,
    PlaceConfig,
    Sensor,
    SystemConfig,
)
from visual_sgraphs.io.checkpoint import (
    FORMAT_VERSION,
    load_checkpoint,
    save_checkpoint,
)
from visual_sgraphs.io.synthetic import SyntheticScene
from visual_sgraphs.slam import SlamSystem


def _cfg(scene):
    return SystemConfig(
        sensor=Sensor.RGBD, camera=scene.cam,
        orb=OrbConfig(n_features=400),
        capacity=CapacityConfig(max_keyframes=32, max_points=8192),
        loop_closing=True,
        place=PlaceConfig(vocab_min_keyframes=4, consistency=1, min_gap=8,
                          gba_after_loop=False),
    )


@pytest.mark.slow
def test_checkpoint_roundtrip_continue(tmp_path):
    scene = SyntheticScene(h=240, w=320)
    frames = list(scene.frames(40, kind="arc"))

    a = SlamSystem(_cfg(scene))
    for gray, depth, T_wc, ts in frames[:25]:
        a.track_rgbd(gray, depth, ts)
    a.flush()
    path = os.path.join(tmp_path, "session.ckpt")
    md5 = save_checkpoint(path, a)
    assert isinstance(md5, str) and len(md5) == 32

    # resume into a fresh system and verify the restored state reproduces
    # the saved trajectory exactly
    b = SlamSystem(_cfg(scene))
    manifest = load_checkpoint(path, b)
    assert manifest["version"] == FORMAT_VERSION
    np.testing.assert_allclose(
        np.asarray(b.frame_poses()), np.asarray(a.frame_poses()), atol=1e-6
    )
    assert b.n_kf_host == a.n_kf_host
    assert b.epoch == a.epoch

    # both continue over the same frames; resumed system keeps tracking
    for gray, depth, T_wc, ts in frames[25:]:
        a.track_rgbd(gray, depth, ts)
        b.track_rgbd(gray, depth, ts)
    a.flush()
    b.flush()
    assert int(jnp.sum(b.map.kf_valid)) >= int(jnp.sum(a.map.kf_valid)) - 1
    mask_b = b.tracked_mask()
    assert mask_b[25:].mean() > 0.8, "resumed session lost tracking"


def test_checkpoint_md5_detects_corruption(tmp_path):
    scene = SyntheticScene(h=240, w=320)
    a = SlamSystem(_cfg(scene))
    for gray, depth, T_wc, ts in list(scene.frames(8, kind="arc")):
        a.track_rgbd(gray, depth, ts)
    a.flush()
    path = os.path.join(tmp_path, "c.ckpt")
    save_checkpoint(path, a)
    raw = bytearray(open(path, "rb").read())
    raw[-100] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    b = SlamSystem(_cfg(scene))
    with pytest.raises(ValueError, match="MD5"):
        load_checkpoint(path, b)

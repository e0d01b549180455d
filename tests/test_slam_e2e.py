"""End-to-end SLAM slice: synthetic RGB-D sequence -> trajectory ATE gate.

The TUM-harness analog of the reference's dataset smoke runs (SURVEY §4):
render a textured room with exact ground truth, track it, Horn-align the
estimated trajectory, and gate the ATE.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from visual_sgraphs.config import (
    CapacityConfig,
    OrbConfig,
    Sensor,
    SystemConfig,
)
from visual_sgraphs.core import geometry
from visual_sgraphs.io.synthetic import SyntheticScene
from visual_sgraphs.slam import SlamSystem


def small_config(scene, sensor=Sensor.RGBD):
    return SystemConfig(
        sensor=sensor,
        camera=scene.cam,
        orb=OrbConfig(n_features=600),
        capacity=CapacityConfig(max_keyframes=64, max_points=16384),
    )


@pytest.mark.slow
def test_rgbd_tracking_ate():
    scene = SyntheticScene(h=240, w=320)
    n = 60
    sys = SlamSystem(small_config(scene))
    gt = []
    for gray, depth, T_wc, ts in scene.frames(n, kind="arc"):
        sys.track_rgbd(gray, depth, ts)
        gt.append(np.asarray(T_wc)[4:7])
    gt = np.stack(gt)
    est = sys.positions()
    assert est.shape[0] == n
    assert int(sys.map.n_kf) >= 2
    rmse, _ = geometry.ate_rmse(jnp.asarray(est), jnp.asarray(gt))
    # room is ~5 m across; a healthy track on exact-depth synthetic data
    # stays well under 5 cm ATE
    assert float(rmse) < 0.05, f"ATE {float(rmse):.4f} m"


@pytest.mark.slow
def test_rgbd_forward_motion():
    scene = SyntheticScene(h=240, w=320)
    n = 40
    sys = SlamSystem(small_config(scene))
    gt = []
    for gray, depth, T_wc, ts in scene.frames(n, kind="forward"):
        sys.track_rgbd(gray, depth, ts)
        gt.append(np.asarray(T_wc)[4:7])
    est = sys.positions()
    rmse, _ = geometry.ate_rmse(jnp.asarray(est), jnp.asarray(np.stack(gt)))
    assert float(rmse) < 0.05, f"ATE {float(rmse):.4f} m"


@pytest.mark.slow
def test_mono_tracking_ate():
    scene = SyntheticScene(h=240, w=320)
    n = 50
    sys = SlamSystem(small_config(scene, Sensor.MONOCULAR))
    gt = []
    for gray, depth, T_wc, ts in scene.frames(n, kind="arc"):
        sys.track_mono(gray, ts)
        gt.append(np.asarray(T_wc)[4:7])
    gt = np.stack(gt)
    est = sys.positions()
    # mono has gauge freedom: align with scale correction; evaluate only
    # frames with a real estimate (initialization needs parallax to build,
    # so the first ~15 frames carry no pose — the reference emits nothing
    # for them and evaluate_ate_scale.py associates by timestamp)
    assert int(sys.map.n_kf) >= 2, "monocular init never succeeded"
    mask = sys.tracked_mask()
    assert mask.sum() >= 25, f"only {mask.sum()} tracked frames"
    rmse, _ = geometry.ate_rmse(
        jnp.asarray(est[mask]), jnp.asarray(gt[mask]), with_scale=True
    )
    assert float(rmse) < 0.08, f"mono ATE {float(rmse):.4f}"

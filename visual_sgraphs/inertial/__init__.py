"""Visual-inertial subsystem: Forster preintegration as ``lax.scan``,
inertial factors for the batched LM engine, gravity/scale initialization,
VI local BA, and the host pipeline.

JAX rebuild of the reference's ImuTypes.cc + G2oTypes.cc inertial
stack and the Tracking/LocalMapping IMU schedule (SURVEY §2.5, §7.2 step 6).
"""

from visual_sgraphs.inertial.init import (
    apply_scaled_rotation,
    inertial_init,
    rotate_velocities,
)
from visual_sgraphs.inertial.pipeline import ImuPipeline, predict_state
from visual_sgraphs.inertial.preintegration import (
    Preintegrated,
    bias_corrected_delta,
    identity_preint,
    merge,
    preintegrate,
)
from visual_sgraphs.inertial.vi_ba import (
    ImuKfState,
    empty_imu_state,
    set_kf_imu,
    vi_local_ba,
)

__all__ = [
    "apply_scaled_rotation",
    "inertial_init",
    "rotate_velocities",
    "ImuPipeline",
    "predict_state",
    "Preintegrated",
    "bias_corrected_delta",
    "identity_preint",
    "merge",
    "preintegrate",
    "ImuKfState",
    "empty_imu_state",
    "set_kf_imu",
    "vi_local_ba",
]

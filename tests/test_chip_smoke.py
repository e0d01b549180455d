"""``chip_smoke.py`` on the CPU: it refuses to run without a GPU, and each
phase's plumbing works at tiny widths (the gates themselves are for the
full widths on the card)."""

from __future__ import annotations

import jax
import numpy as np
import pytest

import chip_smoke as cs
from visual_sgraphs.core import lie


def _gate_shape(result):
    assert set(result) >= {"metrics", "gates"}
    for g in result["gates"].values():
        assert set(g) == {"value", "limit", "ok"}


def test_main_without_gpu_exits_nonzero_and_prints_no_ok(capsys):
    assert cs.main([]) != 0
    assert cs.main(["--four"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_main_rejects_unknown_phase():
    with pytest.raises(SystemExit):
        cs.main(["--phases", "headline,nonsense"])


@pytest.fixture(scope="module")
def tiny_headline():
    return cs.phase_headline(n_frames=16, warmup=8, h=240, w=320,
                             n_features=400, max_keyframes=32,
                             max_points=2048)


def test_headline_phase_plumbing(tiny_headline):
    result, system = tiny_headline
    _gate_shape(result)
    assert set(result["gates"]) == {"all_frames_tracked", "loops_closed",
                                    "global_ba_events", "ate_rmse_m"}
    m = result["metrics"]
    assert m["frames"] == 16 == len(system.trajectory)
    assert np.isfinite(m["ate_rmse_m"]) and m["warmup_s_incl_compile"] > 0
    assert isinstance(m["stages"], dict) and m["n_keyframes"] >= 1


def test_precision_phase_passes_against_its_own_backend(tiny_headline):
    """Device and reference on the same backend: every comparison is
    (near) exact, so every gate passes and every metric carries both
    precisions and its limit."""
    _, system = tiny_headline
    d = jax.devices()
    result = cs.phase_precision(system, m_obs=64, n_desc=(32, 64),
                                gba_sizes=(8, 256, 4), orb_hw=(120, 160),
                                device=d[0], ref_device=d[1])
    _gate_shape(result)
    assert all(g["ok"] for g in result["gates"].values()), result["gates"]
    for name, m in result["metrics"].items():
        assert set(m) == {"default", "highest", "limit"}, name
    assert result["metrics"]["hamming_max_abs"]["default"] == 0


def test_inertial_phase_plumbing():
    result = cs.phase_inertial(n_frames=12, warmup=4, h=120, w=160,
                               n_features=200, max_keyframes=16,
                               max_points=2048)
    _gate_shape(result)
    assert set(result["gates"]) == {"imu_initialized", "ate_rmse_m"}
    assert result["metrics"]["tracked_frames"] >= 1


def test_cli_phase_runs_the_runner_in_process():
    result = cs.phase_cli(frames=8, n_features=200)
    _gate_shape(result)
    assert result["gates"]["exit_code"]["ok"]
    assert result["metrics"]["frames"] == 8


@pytest.mark.parametrize("phase", ["gba", "four"])
def test_gba_phases_on_virtual_devices(phase):
    fn = cs.phase_gba if phase == "gba" else cs.phase_four
    result = fn(8, 256, 4, iters=3, repeats=1)
    _gate_shape(result)
    assert all(g["ok"] for g in result["gates"].values()), result["gates"]


def test_orb_agreement_counts_keypoints_and_bits():
    kp = type("Kp", (), {})()
    kp.uv = np.asarray([[1.0, 2.0], [3.0, 4.0]])
    kp.level = np.asarray([0, 1])
    kp.valid = np.asarray([True, True])
    kp.desc = np.zeros((2, 32), np.uint8)
    assert cs._orb_agreement(kp, kp) == (1.0, 1.0)
    other = type("Kp", (), {})()
    other.uv, other.level, other.valid = kp.uv, kp.level, kp.valid
    other.desc = kp.desc.copy()
    other.desc[0, 0] = 0b11  # 2 of 512 bits differ
    share, bits = cs._orb_agreement(kp, other)
    assert share == 1.0 and bits == pytest.approx(1 - 2 / 512)


def test_centres_and_quat_angle_match_lie(rng):
    T = np.asarray(jax.vmap(lie.se3_exp)(rng.normal(size=(5, 6)) * 0.5))
    inv = np.asarray(jax.vmap(lie.se3_inverse)(T))
    np.testing.assert_allclose(cs._centres(T), inv[:, 4:7], atol=1e-9)
    q = np.asarray(lie.so3_exp(np.asarray([0.0, 0.0, 0.3])))
    assert cs._quat_angle(q, np.asarray([1.0, 0, 0, 0])) == pytest.approx(0.3)

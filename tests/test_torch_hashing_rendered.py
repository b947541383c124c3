"""The port's hashed local maps end to end on the rendered loop circuit of
tests/test_hashing_rendered.py — all `slow` (full-size tracking on the CPU
takes many minutes; chip_smoke.py's phase `hashing` drives the same run on
the card).

The circuit (140 frames, 800 features) is tracked with hashing on and
`local_map_mode=COMBINED`, loop closing off, through `track_stereo`: the map
crosses the 2000-point trigger, the hash tables served more than 20
queries, online table selection kept `n_active` tables, and the ATE stays
within max(1.2 × c, c + 0.02) of the covisibility-only arm's c. The gates
are the JAX test's own.
"""
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu_torch import config as tconfig
from gf_orb_slam2_tpu_torch.io.evaluation import ate_rmse
from gf_orb_slam2_tpu_torch.system import System
from tests.test_torch_loop_rendered import BASELINE, CX, CY, FX, FY, _circuit

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def circuit():
    return _circuit()


def _run(circuit, mode, hashing):
    poses, frames = circuit
    cam = tconfig.CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=FX * BASELINE, th_depth=40.0)
    cfg = tconfig.SystemConfig(
        sensor=tconfig.Sensor.STEREO, camera=cam, orb=tconfig.ORBConfig(n_features=800),
        capacity=tconfig.CapacityConfig(max_keypoints=1024, max_map_points=30000,
                                        max_keyframes=160, max_local_points=2048),
        tracking=tconfig.TrackingConfig(local_map_mode=mode),
        hashing=tconfig.HashingConfig(enabled=hashing),
        loop=tconfig.LoopClosingConfig(enabled=False))
    slam = System(cfg, device="cpu")
    gt, est = [], []
    for i, ((R_cw, t_cw), (left, right)) in enumerate(zip(poses, frames)):
        T = slam.track_stereo(left, right, i / 20.0)
        est.append(-T[:3, :3].T @ T[:3, 3])
        gt.append(-R_cw.T @ t_cw)
    slam.shutdown()
    return ate_rmse(np.stack(est), np.stack(gt)), slam


@pytest.mark.slow
def test_hash_local_map_active_and_accurate(circuit):
    """tests/test_hashing_rendered.py::test_hash_local_map_active_and_accurate."""
    ate_h, slam = _run(circuit, tconfig.LocalMapMode.COMBINED, hashing=True)
    mih = slam.tracker.mih
    assert slam.store.n_points > 2000, f"map too small to trigger hashing: {slam.store.n_points}"
    assert mih is not None and mih is slam.mapper.mih
    assert mih.n_queries > 20, mih.n_queries
    assert len(mih.active_tables) == mih.n_active
    ate_c, _ = _run(circuit, tconfig.LocalMapMode.COVIS_ONLY, hashing=False)
    assert ate_h < max(ate_c * 1.2, ate_c + 0.02), (
        f"hash-combined ATE {ate_h:.3f} vs covis {ate_c:.3f}")

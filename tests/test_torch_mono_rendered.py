"""Monocular end to end on the rendered circuit, on the port — `slow`
(full-size tracking on the CPU takes many minutes; chip_smoke.py's phase
`mono` drives the same protocol on the card).

tests/test_mono_rendered.py's protocol and gates: the 140-frame circuit
tracked MONOCULAR (init from parallax, keyframe mapping, loop closure with
a free scale), ATE after Sim3 alignment, loop closing on against off.
"""
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu_torch import config as tconfig
from gf_orb_slam2_tpu_torch.io.evaluation import ate_rmse
from gf_orb_slam2_tpu_torch.io.trajectory import recompose_trajectory
from gf_orb_slam2_tpu_torch.system import System
from tests.test_torch_loop_rendered import CX, CY, FX, FY, circuit  # noqa: F401  (fixture)

torch.set_num_threads(1)


def _run_mono(circuit, loop_enabled):
    poses, frames = circuit
    cam = tconfig.CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=0.0, th_depth=0.0)
    cfg = tconfig.SystemConfig(
        sensor=tconfig.Sensor.MONOCULAR, camera=cam, orb=tconfig.ORBConfig(n_features=800),
        capacity=tconfig.CapacityConfig(max_keypoints=1024, max_map_points=30000,
                                        max_keyframes=160, max_local_points=2048),
        loop=tconfig.LoopClosingConfig(enabled=loop_enabled, synchronous_gba=True))
    slam = System(cfg, device="cpu")
    gt = {}
    for i, ((R_cw, t_cw), (left, _)) in enumerate(zip(poses, frames)):
        slam.track_monocular(left, i / 20.0)
        gt[i / 20.0] = -R_cw.T @ t_cw
    slam.shutdown()
    est, g = [], []
    for ts, T in recompose_trajectory(slam.tracker.relative_poses, slam.store):
        est.append(-T[:3, :3].T @ T[:3, 3])
        g.append(gt[ts])
    assert len(est) >= 100, f"mono tracked only {len(est)} of 140 frames"
    return ate_rmse(np.stack(est), np.stack(g), with_scale=True), slam


@pytest.mark.slow
def test_mono_circuit_loop_closure(circuit):
    ate_on, slam = _run_mono(circuit, True)
    corrected = [s for s in slam.loop_closer.stats if s.corrected]
    assert corrected, "no mono loop closure fired on the circuit revisit"
    assert slam.loop_closer.fix_scale is False
    assert ate_on < 0.15, f"mono ATE (Sim3-aligned) {ate_on:.3f} m"
    ate_off, _ = _run_mono(circuit, False)
    assert ate_on < max(1.5 * ate_off, 0.12), f"on={ate_on:.3f} off={ate_off:.3f}"

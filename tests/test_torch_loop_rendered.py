"""The port's loop closing end to end, on the scenes of the JAX package's
loop gates — all `slow` (full-size tracking on the CPU takes many minutes;
chip_smoke.py's phase `loop` drives the rendered circuit on the card):

- the 330-frame synthetic revisit of tests/test_loop_closing.py through
  `System.track_frame`;
- the 140-frame rendered circuit of tests/test_loop_rendered.py through
  `System.track_stereo`, loop closing on against off;
- the analogue of its async headline gate (bench.py's configuration:
  `track_stereo_pipelined`, the mapping worker, the loop worker, the
  detached GBA). Its workers are throttled by EVENTS — after every call
  that completed a keyframe the test waits until both workers are idle —
  never by the timing of their threads.

The gates are the JAX tests' own.
"""
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu_torch import config as tconfig, convert
from gf_orb_slam2_tpu_torch.io.evaluation import ate_rmse
from gf_orb_slam2_tpu_torch.io.trajectory import recompose_trajectory
from gf_orb_slam2_tpu_torch.system import System
from tests.rendered_world import RoomWorld, trajectory_loop
from tests.synthetic import SyntheticWorld, ate_rmse as synthetic_ate, make_frame
from tests.test_loop_closing import loop_trajectory

torch.set_num_threads(1)

FX = FY = 450.0
CX, CY = 320.0, 240.0
BASELINE = 0.1
N_FRAMES = 140
FRAME_FIELDS = ("frame_id", "timestamp", "uv", "octave", "angle", "desc", "response",
                "u_right", "depth", "valid")


@pytest.mark.slow
def test_synthetic_loop_detected_and_corrected():
    """tests/test_loop_closing.py::TestLoopClosingE2E on the port."""
    n_kp = 512
    cam = tconfig.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0, th_depth=40.0)
    cfg = tconfig.SystemConfig(
        sensor=tconfig.Sensor.STEREO, camera=cam, orb=tconfig.ORBConfig(n_features=n_kp),
        capacity=tconfig.CapacityConfig(max_keypoints=n_kp, max_map_points=40000,
                                        max_keyframes=300, max_local_points=2048),
        loop=tconfig.LoopClosingConfig(synchronous_gba=True))
    slam = System(cfg, device="cpu")
    world = SyntheticWorld(12000, seed=13, extent=(1.0, 1.0, 1.0))
    rng = np.random.default_rng(13)
    n_pts = world.points.shape[0]
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    r = rng.uniform(9, 16, n_pts)
    world.points = np.stack([r * np.sin(ang), rng.uniform(-3, 3, n_pts),
                             12.0 - r * np.cos(ang)], -1).astype(np.float32)
    world.d0 = np.maximum(2.0, rng.uniform(4, 12, n_pts)).astype(np.float32)
    gt = loop_trajectory(330, loops=1.27)
    states, est = [], []
    for i, (R, t) in enumerate(gt):
        f = make_frame(world, R, t, cfg.camera, i, n_kp=n_kp, max_z=30.0)
        pf = convert.frame_from_arrays({k: getattr(f, k) for k in FRAME_FIELDS})
        slam.track_frame(pf)
        states.append(slam.state.name)
        est.append((pf.R.copy(), pf.t.copy()))
    slam.shutdown()
    assert states.count("OK") / len(states) > 0.95, states
    corrected = [s for s in slam.loop_closer.stats if s.corrected]
    assert corrected, "no loop closure fired on a circular revisit"
    assert corrected[0].n_sim3_inliers >= 20
    assert sum(s.n_fused for s in corrected) > 0, "no landmarks fused"
    ate_tail = synthetic_ate(est[-40:], gt[-40:])
    assert ate_tail < 0.5, f"post-loop tail ATE {ate_tail:.3f} m"


def _circuit():
    poses = trajectory_loop(N_FRAMES, radius=2.2, center=(0.0, 0.0, 7.0), loops=1.27)
    world = RoomWorld(width=9.0, height=5.0, length=14.0)
    frames = [world.render_stereo(R, t, baseline=BASELINE, fx=FX, fy=FY, cx=CX, cy=CY)
              for R, t in poses]
    return poses, frames


@pytest.fixture(scope="module")
def circuit():
    return _circuit()


def _config(loop_enabled, **tracking):
    cam = tconfig.CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=FX * BASELINE, th_depth=40.0)
    return tconfig.SystemConfig(
        sensor=tconfig.Sensor.STEREO, camera=cam, orb=tconfig.ORBConfig(n_features=800),
        capacity=tconfig.CapacityConfig(max_keypoints=1024, max_map_points=30000,
                                        max_keyframes=160, max_local_points=2048),
        tracking=tconfig.TrackingConfig(**tracking),
        loop=tconfig.LoopClosingConfig(enabled=loop_enabled,
                                       synchronous_gba=not tracking.get("async_mapping")))


def _recomposed_ate(slam, poses):
    gt = {i / 20.0: -R.T @ t for i, (R, t) in enumerate(poses)}
    est, ref = [], []
    for ts, T in recompose_trajectory(slam.tracker.relative_poses, slam.store):
        est.append(-T[:3, :3].T @ T[:3, 3])
        ref.append(gt[ts])
    return ate_rmse(np.stack(est), np.stack(ref))


def _run(circuit, loop_enabled):
    poses, frames = circuit
    slam = System(_config(loop_enabled), device="cpu")
    for i, (left, right) in enumerate(frames):
        slam.track_stereo(left, right, i / 20.0)
    slam.shutdown()
    return _recomposed_ate(slam, poses), slam


@pytest.mark.slow
def test_rendered_loop_detected_fused_and_consistent(circuit):
    """tests/test_loop_rendered.py::test_loop_detected_fused_and_consistent."""
    ate_on, slam = _run(circuit, True)
    corrected = [s for s in slam.loop_closer.stats if s.corrected]
    assert corrected, "no loop closure fired on a closed circular revisit"
    assert sum(s.n_fused for s in corrected) > 0, "no landmarks fused"
    assert ate_on < 0.15, f"ATE with loop closing {ate_on:.3f} m"
    ate_off, _ = _run(circuit, False)
    assert ate_on < 0.75 * ate_off, f"on={ate_on:.3f} off={ate_off:.3f}"


@pytest.mark.slow
def test_async_headline_config_throttled_by_events(circuit):
    """tests/test_loop_rendered.py::test_async_headline_config on the port:
    bench.py's configuration (pipelined tracking, mapping worker, loop
    worker, detached GBA)."""
    poses, frames = circuit
    slam = System(_config(True, async_mapping=True), device="cpu")
    n_kf = 0
    for i, (left, right) in enumerate(frames):
        slam.track_stereo_pipelined(left, right, i / 20.0)
        created = sum(bool(s.created_kf) for s in slam.tracker.stats)
        if created > n_kf:  # a keyframe event: let both workers finish it
            n_kf = created
            for w in (slam._map_worker, slam._loop_worker):
                if w is not None:
                    w.wait_idle()
    slam.flush_pipeline()
    mw, lw = slam._map_worker, slam._loop_worker
    slam.shutdown()
    ate = _recomposed_ate(slam, poses)
    assert ate < 0.25, f"headline-config ATE {ate:.3f} m"
    assert mw.n_ba_runs + mw.n_ba_merged == mw.n_kf_events == n_kf
    assert mw.n_ba_runs > 0
    assert lw.n_events == mw.n_kf_events

"""Parity of the port's global BA (optim/global_ba.py) with the JAX package
on the CPU: the analogue of tests/test_global_ba.py through the port's new
`System.track_frame` (a synthetic corridor tracked with mapping, then noise
injected into every non-anchor pose and point), and of
tests/test_global_ba_windows.py (a corridor map written straight into a
store, solved in overlapping windows and as one window, and an aborted
solve) at 40 keyframes instead of 130 with windows of 24 (two windows, as
there).

Both packages solve the same store (carried over with convert.py).
Tolerances: poses 1e-3 and points 2e-3 absolute against the JAX solve — 20
LM iterations in f32 of the same problem, summed in another order; the
quality gates are those of the JAX tests.
"""
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu import config as jconfig
from gf_orb_slam2_tpu.optim import global_ba as jgba
from gf_orb_slam2_tpu.slammap.store import MapStore as JMapStore
from gf_orb_slam2_tpu_torch import convert
from gf_orb_slam2_tpu_torch.optim import global_ba as tgba
from gf_orb_slam2_tpu_torch.system import System
from gf_orb_slam2_tpu_torch.tracking.tracker import TrackState
import tests.test_global_ba_windows as windows
from tests.synthetic import SyntheticWorld, forward_trajectory, make_frame

torch.set_num_threads(1)

POSE_TOL, POINT_TOL = 1e-3, 2e-3
N_KP = 512
FRAME_FIELDS = ("frame_id", "timestamp", "uv", "octave", "angle", "desc", "response",
                "u_right", "depth", "valid")


def port_frame(jframe):
    return convert.frame_from_arrays({k: getattr(jframe, k) for k in FRAME_FIELDS})


def carried(store_j):
    """The JAX store's state in a port store."""
    return convert.store_from_arrays(convert.config_from_reference(store_j.cap),
                                     store_j.kf_uv.shape[1], convert.store_arrays(store_j))


def jax_store(store_t, cap_j):
    """The port store's state in a JAX store (convert.py's carry, reversed)."""
    s = JMapStore(cap_j, store_t.kf_uv.shape[1])
    for k, v in convert.store_arrays(store_t).items():
        setattr(s, k, v)
    return s


def assert_same_solve(ts, js):
    n = js.n_keyframes
    np.testing.assert_allclose(ts.kf_R[:n], js.kf_R[:n], atol=POSE_TOL)
    np.testing.assert_allclose(ts.kf_t[:n], js.kf_t[:n], atol=POSE_TOL)
    np.testing.assert_array_equal(ts.point_valid, js.point_valid)
    v = js.point_valid
    np.testing.assert_allclose(ts.point_pos[v], js.point_pos[v], atol=POINT_TOL)
    assert ts.big_change_idx == js.big_change_idx


# ------------------------------------------- tests/test_global_ba.py analogue
def test_reduces_injected_noise_after_track_frame():
    jcfg = jconfig.SystemConfig(
        sensor=jconfig.Sensor.STEREO,
        camera=jconfig.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0,
                                    th_depth=35.0),
        capacity=jconfig.CapacityConfig(max_keypoints=N_KP, max_map_points=20000,
                                        max_keyframes=200, max_local_points=2048),
        orb=jconfig.ORBConfig(n_features=N_KP))
    cfg = convert.config_from_reference(jcfg)  # loop closing on, as make_system
    slam = System(cfg, device="cpu")
    assert slam.loop_closer is not None
    world = SyntheticWorld(6000, seed=17)
    for i, (R, t) in enumerate(forward_trajectory(90, step=0.12)):
        pose = slam.track_frame(port_frame(make_frame(world, R, t, cfg.camera, i, n_kp=N_KP)))
        assert pose.shape == (4, 4)
    assert slam.state == TrackState.OK
    s = slam.store
    kfs = s.valid_kf_ids()
    assert kfs.size >= 3
    assert len(slam.loop_closer.stats) == len(slam.mapper.stats)  # every KF reached it
    rng = np.random.default_rng(0)
    clean_t = s.kf_t[kfs].copy()
    for k in kfs[1:]:
        s.kf_t[k] += rng.normal(0, 0.03, 3).astype(np.float32)
    pts = s.valid_point_ids()
    clean_pts = s.point_pos[pts].copy()
    s.point_pos[pts] += rng.normal(0, 0.03, (pts.size, 3)).astype(np.float32)
    err_before = np.linalg.norm(s.kf_t[kfs] - clean_t, axis=-1).max()
    js = jax_store(s, jcfg.capacity)  # the JAX package solves the same perturbed store
    assert jgba.global_bundle_adjustment(js, jcfg)
    assert tgba.global_bundle_adjustment(s, cfg, device="cpu")
    err_after = np.linalg.norm(s.kf_t[kfs] - clean_t, axis=-1).max()
    assert err_after < 0.5 * err_before, (err_before, err_after)
    assert np.median(np.linalg.norm(s.point_pos[pts] - clean_pts, axis=-1)) < 0.03
    assert_same_solve(s, js)
    slam.shutdown()


# -------------------------------- tests/test_global_ba_windows.py analogues
@pytest.fixture
def corridor(monkeypatch):
    """The windows test's corridor map at 40 KFs (its builder reads K)."""
    monkeypatch.setattr(windows, "K", 40)

    def make(seed_perturb):
        js, gt_R, gt_t, pt_ids, gt_pts = windows.build_corridor()
        windows.perturb(js, np.random.default_rng(seed_perturb))
        jcfg = jconfig.SystemConfig(camera=jconfig.CameraConfig(
            fx=windows.FX, fy=windows.FY, cx=windows.CX, cy=windows.CY, bf=windows.BF))
        tcfg = convert.config_from_reference(jcfg)
        return js, carried(js), jcfg, tcfg, gt_t, pt_ids, gt_pts

    return make


def test_two_windows_match_the_jax_solve_and_dense_quality(corridor):
    js, ts, jcfg, tcfg, gt_t, pt_ids, gt_pts = corridor(1)
    err0 = windows.kf_err(ts, gt_t).max()
    jr = jgba.GlobalBARunner(js, jcfg, iters=20, window_kfs=24)
    tr = tgba.GlobalBARunner(ts, tcfg, iters=20, window_kfs=24, device="cpu")
    assert jr.build() and tr.build()
    assert len(tr._windows) == len(jr._windows) >= 2, "must exercise > 1 window"
    for (jk, jp, jf, _), (tk, tp, tf, _) in zip(jr._windows, tr._windows):
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tf, jf[: tk.size])
    assert jr.solve() and tr.solve()
    assert tr.n_segments == 4 * len(tr._windows) and len(tr.window_ms) == len(tr._windows)
    jr.write_back()
    tr.write_back()
    assert_same_solve(ts, js)
    err_win = windows.kf_err(ts, gt_t)
    assert err_win.max() < 0.34 * err0, (err_win.max(), err0)
    perr = np.linalg.norm(ts.point_pos[pt_ids] - gt_pts, axis=-1)
    assert np.median(perr) < 0.02
    # one dense window from the same perturbation
    _, ts2, _, tcfg2, _, _, _ = corridor(1)
    tr2 = tgba.GlobalBARunner(ts2, tcfg2, iters=20, window_kfs=48, device="cpu")
    assert tr2.build() and len(tr2._windows) == 1
    assert tr2.solve()
    tr2.write_back()
    err_dense = windows.kf_err(ts2, gt_t)
    assert err_win.max() < max(2.0 * err_dense.max(), 0.25 * err0)


def test_abort_mid_windows_leaves_map_consistent(corridor):
    _, ts, _, tcfg, _, _, _ = corridor(2)
    snap_t = ts.kf_t.copy()
    snap_pts = ts.point_pos.copy()
    runner = tgba.GlobalBARunner(ts, tcfg, iters=20, window_kfs=24, device="cpu")
    assert runner.build()
    calls = [0]

    def abort_after_two():
        calls[0] += 1
        return calls[0] > 2

    assert runner.solve(abort_after_two) is False
    assert runner.aborted and runner.n_segments == 2
    np.testing.assert_array_equal(ts.kf_t, snap_t)  # an aborted solve writes NOTHING
    np.testing.assert_array_equal(ts.point_pos, snap_pts)


def test_write_back_superseded_by_a_correction_is_dropped(corridor):
    """A loop correction (big_change_idx bump) between the snapshot and the
    write-back: the write-back must not clobber it."""
    _, ts, _, tcfg, _, _, _ = corridor(3)
    runner = tgba.GlobalBARunner(ts, tcfg, iters=5, window_kfs=48, device="cpu")
    assert runner.build() and runner.solve()
    snap_t = ts.kf_t.copy()
    ts.big_change_idx += 1
    runner.write_back()
    assert runner.aborted
    np.testing.assert_array_equal(ts.kf_t, snap_t)

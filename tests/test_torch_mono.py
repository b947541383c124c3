"""The port's monocular path on the CPU against the JAX package's:
tests/test_mono_tracking.py's lateral synthetic sequence through both
Systems' `track_frame` (the same frames, carried over by
`convert.frame_from_arrays`), with `Tracker.init_draws` returning the JAX
package's own two-view draws (PRNGKey(frame_id)), then the monocular hard
reset of a tracker lost with ≤ 5 keyframes.

Both run with synchronous local mapping, loop closing off and the budgeted
local-map matching in its deterministic LONG_LIVED mode (the good-feature
mode's lazier-greedy subsets come from each package's own random stream).

Tolerances: the initialization frame, the states frame by frame and the KF
counts equal; the two-KF map's point ids exact and positions rtol 1e-3;
camera poses 1e-3.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu import config as jc
from gf_orb_slam2_tpu_torch import convert
from gf_orb_slam2_tpu_torch.system import System as TSystem
from tests.synthetic import SyntheticWorld, make_frame
from tests.test_mono_tracking import lateral_trajectory

torch.set_num_threads(1)

N_KP = 512
N_FRAMES = 12
POSE_TOL = 1e-3
HOST = ("uv", "octave", "angle", "desc", "response", "u_right", "depth", "valid")


def _config():
    cam = jc.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=0.0)
    return jc.SystemConfig(
        sensor=jc.Sensor.MONOCULAR, camera=cam, orb=jc.ORBConfig(n_features=N_KP),
        capacity=jc.CapacityConfig(max_keypoints=N_KP, max_map_points=20000,
                                   max_keyframes=200, max_local_points=2048),
        good_feature=jc.GoodFeatureConfig(matching_mode=jc.GFMatchingMode.LONG_LIVED),
        tracking=jc.TrackingConfig(async_mapping=False),
        loop=jc.LoopClosingConfig(enabled=False), vocabulary_path="")


def _jax_system(cfg):
    from gf_orb_slam2_tpu.system import System as JSystem

    saved = os.environ.get("GF_SLAM_NO_PREWARM")
    os.environ["GF_SLAM_NO_PREWARM"] = "1"
    try:
        return JSystem(cfg)
    finally:
        if saved is None:
            del os.environ["GF_SLAM_NO_PREWARM"]
        else:
            os.environ["GF_SLAM_NO_PREWARM"] = saved


def jax_init_draws(frame_id, n_valid):
    """The JAX package's two-view draws (tracker.py:1283 → initializer.py:235)."""
    n = int(n_valid)
    d = jax.random.randint(jax.random.PRNGKey(frame_id), (256, 8), 0, jnp.maximum(n, 8))
    return torch.from_numpy(np.asarray(d).astype(np.int64))


def _frames(cam):
    world = SyntheticWorld(6000, seed=11)
    out = []
    for i, (R, t) in enumerate(lateral_trajectory(N_FRAMES)):
        f = make_frame(world, R, t, cam, i, n_kp=N_KP)
        f.u_right[:] = -1.0
        f.depth[:] = -1.0
        out.append(dict({k: np.array(getattr(f, k)) for k in HOST},
                        frame_id=f.frame_id, timestamp=f.timestamp))
    return out


def _jframe(arrays):
    from gf_orb_slam2_tpu.tracking.frame import Frame as JFrame

    return JFrame(frame_id=arrays["frame_id"], timestamp=arrays["timestamp"],
                  **{k: np.array(arrays[k]) for k in HOST})


@pytest.fixture(scope="module")
def runs():
    jcfg = _config()
    js = _jax_system(jcfg)
    ts = TSystem(convert.config_from_reference(jcfg), device="cpu")
    ts.tracker.init_draws = jax_init_draws
    out = {"jax": [], "torch": [], "maps": {}}
    for arrays in _frames(jcfg.camera):
        for name, slam, frame in (("jax", js, _jframe(arrays)),
                                  ("torch", ts, convert.frame_from_arrays(arrays))):
            T = slam.track_frame(frame)
            out[name].append(dict(T=np.asarray(T), state=slam.tracker.stats[-1].state,
                                  n_kfs=slam.store.n_keyframes))
            if slam.store.n_keyframes == 2 and name not in out["maps"]:
                s = slam.store
                ids = np.asarray(s.valid_point_ids())
                out["maps"][name] = dict(ids=ids, pos=np.array(s.point_pos[ids]),
                                         kf_t=np.array(s.kf_t[:2]), kf_R=np.array(s.kf_R[:2]))
    out["systems"] = (js, ts)
    return out


def test_initializes_on_the_same_frame_with_the_same_two_kf_map(runs):
    j, t = runs["jax"], runs["torch"]
    first = [r["state"] for r in j].index("OK")
    assert first <= 3
    assert [r["state"] for r in t].index("OK") == first
    mj, mt = runs["maps"]["jax"], runs["maps"]["torch"]
    np.testing.assert_array_equal(mt["ids"], mj["ids"])
    assert mt["ids"].size > 100
    np.testing.assert_allclose(mt["pos"], mj["pos"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(mt["kf_R"], mj["kf_R"], atol=POSE_TOL)
    np.testing.assert_allclose(mt["kf_t"], mj["kf_t"], atol=POSE_TOL)
    init = runs["systems"][1].tracker.init_stats
    assert init and init[-1]["ok"] and init[-1]["frame_id"] == first


def test_states_keyframes_and_poses_frame_by_frame(runs):
    j, t = runs["jax"], runs["torch"]
    assert [r["state"] for r in t] == [r["state"] for r in j]
    assert [r["n_kfs"] for r in t] == [r["n_kfs"] for r in j]
    first = [r["state"] for r in t].index("OK")
    assert all(r["state"] == "OK" for r in t[first:])
    for i, (a, b) in enumerate(zip(t, j)):
        np.testing.assert_allclose(a["T"], b["T"], atol=POSE_TOL, err_msg=f"frame {i}")


def test_dominantly_x_span(runs):
    """tests/test_mono_tracking.py's shape check, in both packages."""
    for slam in runs["systems"]:
        s = slam.store
        centers = np.stack([s.kf_center(int(k)) for k in s.valid_kf_ids()])
        span = centers[-1] - centers[0]
        assert abs(span[0]) > 5 * (abs(span[1]) + 1e-9)
        assert abs(span[0]) > 5 * (abs(span[2]) + 1e-9)
        assert s.n_points > 100


def test_lost_with_few_keyframes_hard_resets(runs):
    """Blank frames right after the initialization: both trackers go LOST
    with ≤ 5 KFs and both Systems reset (reference: Tracking.cc:813)."""
    js, ts = runs["systems"]
    assert js.store.n_keyframes <= 5 and ts.store.n_keyframes <= 5
    blank = _frames(_config().camera)[0]
    blank["valid"][:] = False
    blank["frame_id"] = N_FRAMES
    for name, slam, frame in (("jax", js, _jframe(blank)),
                              ("torch", ts, convert.frame_from_arrays(blank))):
        slam.track_frame(frame)
        assert slam.tracker.stats[-1].state == "LOST", name
        assert slam.state.name == "NO_IMAGES_YET", name
        assert slam.store.n_keyframes == 0 and slam.store.n_points == 0, name
    ts.shutdown()

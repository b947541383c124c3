"""The port's RGB-D path on the CPU against the JAX package's: the depth-map
frontend's `depth_to_disparity` (exact on the same inputs), and
tests/test_rgbd.py's rendered slanted-plane sequence at 320x240 (the camera
scaled with it) through both Systems' `track_rgbd`, synchronous local
mapping on, loop closing off, the budgeted local-map matching in its
deterministic LONG_LIVED mode (the good-feature mode's lazier-greedy
subsets come from each package's own random stream).

Tolerances: `u_right`/`depth` exact; states and KF counts equal frame by
frame; camera poses 1e-3 on the same keypoints (f32 pose LM and local BA in
another order), 5e-3 on each package's own frontend.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu import config as jc
from gf_orb_slam2_tpu.matching import stereo as jstereo
from gf_orb_slam2_tpu_torch import convert
from gf_orb_slam2_tpu_torch.matching import stereo as tstereo
from gf_orb_slam2_tpu_torch.system import System as TSystem
from tests.test_rgbd import render_rgbd

torch.set_num_threads(1)

H, W, F = 240, 320, 225.0
N_FRAMES = 14
POSE_TOL = 1e-3


@pytest.mark.parametrize("factor", (1.0, 1.0 / 5000.0))
def test_depth_to_disparity_exact(factor):
    rng = np.random.default_rng(0)
    n = 700
    uv = np.stack([rng.uniform(-3, W + 3, n), rng.uniform(-3, H + 3, n)], -1).astype(np.float32)
    uv[:20] = np.round(uv[:20]) + 0.5  # ties: half to even in both
    valid = rng.random(n) > 0.1
    depth = rng.uniform(0.5, 8.0, (H, W)).astype(np.float32) / factor
    depth[rng.random((H, W)) < 0.1] = 0.0  # holes
    want = jstereo.depth_to_disparity(jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(depth),
                                      F * 0.1, factor)
    got = tstereo.depth_to_disparity(torch.from_numpy(uv), torch.from_numpy(valid),
                                     torch.from_numpy(depth), F * 0.1, factor)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0.5 < float(got.valid.float().mean()) < 0.95


def _config():
    cam = jc.CameraConfig(width=W, height=H, fx=F, fy=F, cx=W / 2, cy=H / 2, bf=F * 0.1,
                          th_depth=60.0, depth_map_factor=5000.0)
    # stereo-style initialization needs 500 keypoints, hence 600 features
    return jc.SystemConfig(
        sensor=jc.Sensor.RGBD, camera=cam, orb=jc.ORBConfig(n_features=600),
        capacity=jc.CapacityConfig(max_keypoints=640, max_map_points=8000,
                                   max_keyframes=40, max_local_points=1024),
        # the budgeted matching without random subsets: lazier-greedy draws
        # from jax.random in one package and torch in the other
        good_feature=jc.GoodFeatureConfig(matching_mode=jc.GFMatchingMode.LONG_LIVED),
        tracking=jc.TrackingConfig(async_mapping=False),
        loop=jc.LoopClosingConfig(enabled=False), vocabulary_path="")


HOST = ("uv", "octave", "angle", "desc", "response", "u_right", "depth", "valid")


@pytest.fixture(scope="module")
def runs():
    """Three runs over the same frames: the JAX package (`track_rgbd`'s
    frame builder, then `track_frame`), the port through `track_rgbd` on its
    own frontend, and the port through `track_frame` on the JAX frontend's
    keypoints (carried over by `convert.frame_from_arrays`)."""
    from gf_orb_slam2_tpu.system import System as JSystem

    jcfg = _config()
    saved = os.environ.get("GF_SLAM_NO_PREWARM")
    os.environ["GF_SLAM_NO_PREWARM"] = "1"
    try:
        js = JSystem(jcfg)
    finally:
        if saved is None:
            del os.environ["GF_SLAM_NO_PREWARM"]
        else:
            os.environ["GF_SLAM_NO_PREWARM"] = saved
    tcfg = convert.config_from_reference(jcfg)
    ts, tj = TSystem(tcfg, device="cpu"), TSystem(tcfg, device="cpu")
    out = {"jax": [], "torch": [], "torch_on_jax_frontend": [], "kp_moved": []}

    def note(name, slam, T):
        st = slam.tracker.stats[-1]
        out[name].append(dict(T=np.asarray(T), state=st.state, n_kfs=slam.store.n_keyframes,
                              n_kp=st.n_features))

    for i, (img, depth) in enumerate(render_rgbd(N_FRAMES, h=H, w=W, fx=F)):
        jf = js._build_rgbd_frame(img, depth, i / 20.0)
        jf.ensure_host()
        arrays = dict({k: np.array(getattr(jf, k)) for k in HOST},
                      frame_id=jf.frame_id, timestamp=jf.timestamp)
        note("jax", js, js.track_frame(jf))
        note("torch", ts, ts.track_rgbd(img, depth, i / 20.0))
        own = ts.tracker.last_frame
        out["kp_moved"].append(int((np.abs(own.uv - arrays["uv"]).max(1) > 0).sum()))
        note("torch_on_jax_frontend", tj, tj.track_frame(convert.frame_from_arrays(arrays)))
    ts.shutdown()
    tj.shutdown()
    return out


def test_rgbd_states_and_keyframes_equal(runs):
    j = runs["jax"]
    for name in ("torch", "torch_on_jax_frontend"):
        t = runs[name]
        assert [r["state"] for r in t] == [r["state"] for r in j]
        assert [r["n_kfs"] for r in t] == [r["n_kfs"] for r in j]
        assert [r["n_kp"] for r in t] == [r["n_kp"] for r in j]
    t = runs["torch"]
    assert t[0]["state"] == "OK" and t[0]["n_kp"] >= 500  # initialized as stereo does
    assert sum(r["state"] == "OK" for r in t) >= N_FRAMES - 2


def test_rgbd_poses_match(runs):
    """On the same keypoints the poses agree to 1e-3 frame by frame. On each
    package's own frontend they agree to 5e-3: the two extractors place a
    keypoint differently now and then (the pyramids' f32 rounding; here
    one keypoint of ~600, on one frame), and the plane 5 m away leaves the
    pose a few millimetres of play along the optical axis."""
    assert sum(runs["kp_moved"]) <= 3, runs["kp_moved"]
    for i, (a, b, c) in enumerate(zip(runs["torch_on_jax_frontend"], runs["jax"],
                                      runs["torch"])):
        np.testing.assert_allclose(a["T"], b["T"], atol=POSE_TOL, err_msg=f"frame {i}")
        np.testing.assert_allclose(c["T"], b["T"], atol=5 * POSE_TOL, err_msg=f"frame {i}")
    # the plane is 5 m away and the camera moves 2 cm a frame along x
    x = [-(r["T"][:3, :3].T @ r["T"][:3, 3])[0] for r in runs["torch"]]
    assert abs(x[-1] - 0.02 * (N_FRAMES - 1)) < 0.05, x[-1]


def test_track_rgbd_frontend_uses_the_depth_map():
    """The RGB-D frontend's right coordinates come from the depth map (one
    upload of the uint8 image and the depth): depth = map / factor at the
    rounded keypoint, u_right = u - bf / depth."""
    cfg = convert.config_from_reference(_config())
    slam = TSystem(cfg, device="cpu")
    img, depth = render_rgbd(1, h=H, w=W, fx=F)[0]
    frame = slam._build_rgbd_frame(img, depth, 0.0)
    frame.ensure_host()
    v = frame.valid & (frame.depth > 0)
    assert v.sum() >= 500
    x = np.round(frame.uv[v, 0]).astype(int)
    y = np.round(frame.uv[v, 1]).astype(int)
    np.testing.assert_allclose(frame.depth[v], depth[y, x] / 5000.0, rtol=1e-6)
    np.testing.assert_allclose(frame.u_right[v], frame.uv[v, 0] - cfg.camera.bf / frame.depth[v],
                               rtol=1e-5)
    slam.shutdown()

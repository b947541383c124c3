"""The port's relocalization on the CPU against the JAX package's.

- `reloc_step` (match_all → EPnP RANSAC → LM polish) against the JAX
  package's `_reloc_step_impl` on one candidate KF of one JAX store carried
  over by `convert`, with the JAX package's draws (PRNGKey(frame_id));
- both Systems on tests/synthetic.py's stereo frames through `track_frame`:
  `force_reloc`, then the next frame relocalizes in both, on the same
  candidate KF with the same map-point associations; then both track on.

Both run with synchronous local mapping, loop closing off (the candidates
are the 5 newest KFs, newest first, in both) and the budgeted local-map
matching in its deterministic LONG_LIVED mode.

Tolerances: `kp_row`, `ok` and the inlier masks exact; poses 1e-3.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu import config as jc
from gf_orb_slam2_tpu_torch import convert
from gf_orb_slam2_tpu_torch.system import System as TSystem
from gf_orb_slam2_tpu_torch.tracking.tracker import TrackState, reloc_step
from gf_orb_slam2_tpu_torch.utils.transfer import to_device
from tests.synthetic import SyntheticWorld, forward_trajectory, make_frame

torch.set_num_threads(1)

N_KP = 512
N_FRAMES = 14
POSE_TOL = 1e-3
HOST = ("uv", "octave", "angle", "desc", "response", "u_right", "depth", "valid")


def _config():
    cam = jc.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0, th_depth=35.0)
    return jc.SystemConfig(
        sensor=jc.Sensor.STEREO, camera=cam, orb=jc.ORBConfig(n_features=N_KP),
        capacity=jc.CapacityConfig(max_keypoints=N_KP, max_map_points=20000,
                                   max_keyframes=200, max_local_points=2048),
        good_feature=jc.GoodFeatureConfig(matching_mode=jc.GFMatchingMode.LONG_LIVED),
        # a keyframe every 4 frames: a few candidates for the fallback
        tracking=jc.TrackingConfig(async_mapping=False, max_frames_between_kf=4),
        loop=jc.LoopClosingConfig(enabled=False), vocabulary_path="")


def jax_reloc_draws(frame_id, n_valid):
    """The JAX package's EPnP draws (tracker.py:1177 → pnp.py:157)."""
    d = jax.random.randint(jax.random.PRNGKey(frame_id), (256, 6), 0,
                           jnp.maximum(int(n_valid), 6))
    return torch.from_numpy(np.asarray(d).astype(np.int64))


def _jframe(arrays):
    from gf_orb_slam2_tpu.tracking.frame import Frame as JFrame

    return JFrame(frame_id=arrays["frame_id"], timestamp=arrays["timestamp"],
                  **{k: np.array(arrays[k]) for k in HOST})


def _capture(tracker):
    """Record what each successful `_relocalize` left on the frame."""
    got = []
    orig = tracker._relocalize

    def run(frame, st):
        ok = orig(frame, st)
        if ok:
            got.append(dict(kf=int(tracker.ref_kf), mp_ids=np.array(frame.mp_ids),
                            R=np.array(frame.R), t=np.array(frame.t)))
        return ok

    tracker._relocalize = run
    return got


@pytest.fixture(scope="module")
def runs():
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
    ts = TSystem(convert.config_from_reference(jcfg), device="cpu")
    ts.tracker.reloc_draws = jax_reloc_draws
    world = SyntheticWorld(6000, seed=5)
    frames = []
    for i, (R, t) in enumerate(forward_trajectory(N_FRAMES + 4, step=0.12)):
        f = make_frame(world, R, t, jcfg.camera, i, n_kp=N_KP)
        frames.append(dict({k: np.array(getattr(f, k)) for k in HOST},
                           frame_id=i, timestamp=f.timestamp))
    for arrays in frames[:N_FRAMES]:
        js.track_frame(_jframe(arrays))
        ts.track_frame(convert.frame_from_arrays(arrays))
    return dict(js=js, ts=ts, frames=frames, jcfg=jcfg)


def test_reloc_step_matches_on_a_carried_store(runs):
    js, frames = runs["js"], runs["frames"]
    s = js.store
    store = convert.store_from_arrays(convert.config_from_reference(s.cap), N_KP,
                                      convert.store_arrays(s))
    k = int(s.valid_kf_ids()[-1])
    f = frames[N_FRAMES]
    fid = f["frame_id"]
    ref_ids = s.resolve_replaced(s.kf_point[k])
    rows = ref_ids >= 0
    assert rows.sum() >= 15
    pt_pos = np.zeros((N_KP, 3), np.float32)
    pt_pos[rows] = s.point_pos[ref_ids[rows]]
    jres, jrow, jok = js.tracker._jit_reloc(
        jnp.asarray(s.kf_desc[k]), jnp.asarray(rows & s.kf_kp_valid[k]), jnp.asarray(pt_pos),
        jnp.asarray(f["uv"]), jnp.asarray(f["octave"]), jnp.asarray(f["u_right"]),
        jnp.asarray(f["valid"]), jnp.asarray(f["desc"]), jax.random.PRNGKey(fid))
    # the port reads the same rows from its own copy of the store
    t_ids = store.resolve_replaced(store.kf_point[k])
    np.testing.assert_array_equal(t_ids, ref_ids)
    d = to_device(dict(desc=store.kf_desc[k], valid=rows & store.kf_kp_valid[k],
                       pos=store.point_pos[np.maximum(t_ids, 0)] * rows[:, None],
                       uv=f["uv"], octave=f["octave"], u_right=f["u_right"],
                       kvalid=f["valid"], kdesc=f["desc"]), "cpu")
    scales = torch.tensor(js.tracker.level_scales)
    cfg = convert.config_from_reference(runs["jcfg"])
    res, kp_row, res_p = reloc_step(cfg, scales, d["desc"], d["valid"], d["pos"],
                                    d["uv"], d["octave"], d["u_right"], d["kvalid"], d["kdesc"],
                                    lambda n: jax_reloc_draws(fid, n))
    np.testing.assert_array_equal(kp_row.numpy(), np.asarray(jrow))
    assert bool(res_p.ok) == bool(jok) and bool(jok)
    np.testing.assert_array_equal(res.inliers.numpy(), np.asarray(jres.inliers))
    assert int(res.n_inliers) == int(jres.n_inliers) >= 15
    np.testing.assert_allclose(res.R.numpy(), np.asarray(jres.R), atol=POSE_TOL)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(jres.t), atol=POSE_TOL)


def test_force_reloc_then_both_relocalize_alike(runs):
    js, ts, frames = runs["js"], runs["ts"], runs["frames"]
    assert js.store.n_keyframes == ts.store.n_keyframes >= 2
    got_j, got_t = _capture(js.tracker), _capture(ts.tracker)
    js.force_reloc()
    ts.force_reloc()
    assert ts.state == TrackState.LOST and ts.tracker.velocity is None
    for arrays in frames[N_FRAMES:]:
        Tj = js.track_frame(_jframe(arrays))
        Tt = ts.track_frame(convert.frame_from_arrays(arrays))
        assert js.tracker.stats[-1].state == ts.tracker.stats[-1].state == "OK"
        np.testing.assert_allclose(Tt, Tj, atol=POSE_TOL)
    assert len(got_j) == len(got_t) == 1
    a, b = got_t[0], got_j[0]
    assert a["kf"] == b["kf"]
    np.testing.assert_array_equal(a["mp_ids"], b["mp_ids"])
    np.testing.assert_allclose(a["R"], b["R"], atol=POSE_TOL)
    np.testing.assert_allclose(a["t"], b["t"], atol=POSE_TOL)
    rec = ts.tracker.reloc_stats[-1]
    assert rec.source == "recent" and rec.kf == a["kf"] and rec.n_inliers >= 15
    assert ts.tracker.stats[N_FRAMES].path == "reloc"
    # the raised inlier gate after a relocalization is the JAX package's too
    assert ts.tracker._min_inliers(N_FRAMES + 1) == js.cfg.tracking.min_inliers_after_reloc


def test_reloc_disabled_stays_lost(runs):
    """`tracking.enable_reloc=False`: a LOST tracker stays LOST."""
    cfg = convert.config_from_reference(runs["jcfg"])
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, enable_reloc=False))
    slam = TSystem(cfg, device="cpu")
    for arrays in runs["frames"][:3]:
        slam.track_frame(convert.frame_from_arrays(arrays))
    assert slam.state == TrackState.OK
    slam.force_reloc()
    slam.track_frame(convert.frame_from_arrays(runs["frames"][3]))
    assert slam.state == TrackState.LOST and slam.tracker.reloc_stats == []
    slam.force_reinit()
    assert slam.state == TrackState.NO_IMAGES_YET and slam.store.n_keyframes == 0
    slam.shutdown()

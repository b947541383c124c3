"""The port's map checkpoints on the CPU against the JAX package's.

- Format: a map the JAX System saves loads into the port's store with every
  array and counter equal, and the port's save of it is the same file
  (arrays, `__meta__`, the vocabulary sidecar); a map the port saves loads
  into the JAX package's store equal to the port's.
- tests/test_map_io.py's round trip on the port: 20 synthetic frames
  tracked, saved, loaded into a fresh System in localization mode, then 10
  frames (from frame 18 on) relocalized and tracked against the loaded map:
  ≥ 8 OK, each within 0.1 m, no keyframe added; save → load → save equal.
- The KF database after `load_map`, in both packages, with loop closing on
  (built at construction, left empty by the load: relocalization falls back
  to the newest KFs) and off (built by the load from the sidecar vocabulary:
  every loaded KF but the last).
- The keypoint YAML export: the same text from both packages, and its load.

Both Systems run with synchronous local mapping and a keyframe at least
every 5 frames; the port's on the CPU.
"""
import json
import os

import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu import config as jc
from gf_orb_slam2_tpu.io import keypoints as jkeypoints, map_io as jmap_io
from gf_orb_slam2_tpu.slammap.store import MapStore as JMapStore
from gf_orb_slam2_tpu_torch import convert
from gf_orb_slam2_tpu_torch.io import keypoints as tkeypoints, map_io as tmap_io
from gf_orb_slam2_tpu_torch.slammap.store import MapStore as TMapStore
from gf_orb_slam2_tpu_torch.system import System as TSystem
from gf_orb_slam2_tpu_torch.tracking.tracker import TrackState
from tests.synthetic import SyntheticWorld, forward_trajectory, make_frame

torch.set_num_threads(1)

N_KP = 512
HOST = ("uv", "octave", "angle", "desc", "response", "u_right", "depth", "valid")


def _config(loop=False):
    cam = jc.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0, th_depth=35.0)
    return jc.SystemConfig(
        sensor=jc.Sensor.STEREO, camera=cam, orb=jc.ORBConfig(n_features=N_KP),
        capacity=jc.CapacityConfig(max_keypoints=N_KP, max_map_points=20000,
                                   max_keyframes=200, max_local_points=2048),
        # a keyframe at least every 5 frames: a map of several KFs to index
        tracking=jc.TrackingConfig(async_mapping=False, max_frames_between_kf=5),
        loop=jc.LoopClosingConfig(enabled=loop))


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


def _frames(cfg):
    world = SyntheticWorld(6000, seed=21)
    gt = forward_trajectory(30, step=0.1)
    out = []
    for i, (R, t) in enumerate(gt[:20]):
        out.append((i, R, t))
    for i, (R, t) in enumerate(gt[18:28], start=100):
        out.append((i, R, t))
    frames = []
    for i, R, t in out:
        f = make_frame(world, R, t, cfg.camera, i, n_kp=N_KP)
        frames.append(dict({k: np.array(getattr(f, k)) for k in HOST},
                           frame_id=i, timestamp=f.timestamp, R_gt=R, t_gt=t))
    return frames


def _jframe(arrays):
    from gf_orb_slam2_tpu.tracking.frame import Frame as JFrame

    return JFrame(frame_id=arrays["frame_id"], timestamp=arrays["timestamp"],
                  **{k: np.array(arrays[k]) for k in HOST})


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    """Each package's System over the first 20 frames, its map saved."""
    d = tmp_path_factory.mktemp("maps")
    jcfg = _config()
    frames = _frames(jcfg)
    js = _jax_system(jcfg)
    ts = TSystem(convert.config_from_reference(jcfg), device="cpu")
    for arrays in frames[:20]:
        js.track_frame(_jframe(arrays))
        ts.track_frame(convert.frame_from_arrays(arrays))
    assert js.state.name == ts.state.name == "OK"
    js.save_map(d / "jax.npz")
    ts.save_map(d / "port.npz")
    out = dict(js=js, ts=ts, frames=frames, jcfg=jcfg, dir=d)
    yield out
    js.shutdown()
    ts.shutdown()


def _assert_stores_equal(got, want):
    a, b = convert.store_arrays(got), convert.store_arrays(want)
    for k in ("_free", "_free_head", "_n_free"):  # the free ring is rebuilt on load
        a.pop(k), b.pop(k)
    assert set(a) == set(b)
    for k, v in b.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(a[k], v, err_msg=k)
        else:
            assert a[k] == v, k


def _npz(path):
    z = np.load(path, allow_pickle=False)
    return {k: z[k] for k in z.files}


def _assert_files_equal(pa, pb):
    a, b = _npz(pa), _npz(pb)
    assert set(a) == set(b)
    if "__meta__" in b:
        assert json.loads(str(a.pop("__meta__"))) == json.loads(str(b.pop("__meta__")))
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_jax_map_loads_into_the_port_and_saves_back_the_same(maps, tmp_path):
    js, d = maps["js"], maps["dir"]
    store = TMapStore(convert.config_from_reference(js.store.cap), N_KP)
    tmap_io.load_map(d / "jax.npz", store)
    _assert_stores_equal(store, js.store)
    np.testing.assert_array_equal(store._free[: store._n_free],  # rebuilt by the load
                                  np.nonzero(~js.store.point_valid)[0])
    tmap_io.save_map(tmp_path / "again.npz", store)
    _assert_files_equal(tmp_path / "again.npz", d / "jax.npz")
    # the System saves the vocabulary beside it, as the JAX System does
    assert os.path.exists(str(d / "jax.npz") + ".voc.npz")
    assert os.path.exists(str(d / "port.npz") + ".voc.npz")
    _assert_files_equal(str(d / "port.npz") + ".voc.npz", str(d / "jax.npz") + ".voc.npz")


def test_port_map_loads_into_jax(maps, tmp_path):
    ts, d = maps["ts"], maps["dir"]
    store = JMapStore(maps["jcfg"].capacity, N_KP)
    jmap_io.load_map(d / "port.npz", store)
    _assert_stores_equal(store, ts.store)
    jmap_io.save_map(tmp_path / "again.npz", store)
    _assert_files_equal(tmp_path / "again.npz", d / "port.npz")


def test_capacity_prefix_copy_agrees(maps):
    """A store of another capacity takes the overlapping prefix, as the JAX
    package's loader does."""
    d = maps["dir"]
    cap = maps["jcfg"].capacity
    small = jc.CapacityConfig(max_keypoints=N_KP, max_map_points=15000,
                              max_keyframes=150, max_local_points=2048)
    assert small.max_map_points != cap.max_map_points
    j = jmap_io.load_map(d / "jax.npz", JMapStore(small, N_KP))
    t = tmap_io.load_map(d / "jax.npz", TMapStore(convert.config_from_reference(small), N_KP))
    _assert_stores_equal(t, j)


def test_roundtrip_and_localization(maps, tmp_path):
    """tests/test_map_io.py::TestMapIO on the port."""
    ts, frames = maps["ts"], maps["frames"]
    n_pts, n_kfs = ts.store.n_points, ts.store.n_keyframes
    path = tmp_path / "map.npz"
    ts.save_map(path)
    sys2 = TSystem(ts.cfg, device="cpu")
    sys2.load_map(path)
    sys2.activate_localization_mode()
    assert sys2.store.n_points == n_pts and sys2.store.n_keyframes == n_kfs
    np.testing.assert_array_equal(sys2.store.kf_R, ts.store.kf_R)
    sys2.save_map(tmp_path / "again.npz")
    _assert_files_equal(tmp_path / "again.npz", path)
    ok = 0
    for arrays in frames[20:]:
        f = convert.frame_from_arrays(arrays)
        sys2.track_frame(f)
        if sys2.state == TrackState.OK:
            ok += 1
            R, t = arrays["R_gt"], arrays["t_gt"]
            terr = np.linalg.norm((-f.R.T @ f.t) - (-R.T @ t))
            assert terr < 0.1, terr
    assert ok >= 8
    assert sys2.store.n_keyframes == n_kfs  # localization mode adds no KFs
    assert not sys2.mapper.stats
    assert sys2.tracker.reloc_stats and sys2.tracker.reloc_stats[0].kf >= 0
    sys2.deactivate_localization_mode()
    assert not sys2.cfg.localization_only and not sys2.tracker.cfg.localization_only
    sys2.shutdown()


def _kfdb_contents(kfdb):
    if kfdb is None:
        return None
    present = np.nonzero(kfdb.present)[0].tolist()
    words = {k: np.asarray(kfdb._kf_words[k]).tolist() for k in present}
    weights = {k: np.asarray(kfdb._kf_weights[k]) for k in present}
    postings = {int(w): list(p[0]) for w, p in kfdb._postings.items() if p[0]}
    return present, words, weights, postings


@pytest.mark.parametrize("loop", [True, False], ids=["loop_on", "loop_off"])
def test_kf_database_after_load_matches_jax(maps, loop):
    path = maps["dir"] / "jax.npz"
    jcfg = _config(loop=loop)
    js = _jax_system(jcfg)
    ts = TSystem(convert.config_from_reference(jcfg), device="cpu")
    js.load_map(path)
    ts.load_map(path)
    assert ts.state == TrackState.LOST and ts.tracker.ref_kf == js.tracker.ref_kf
    assert (ts.kfdb is None) == (js.kfdb is None) is False
    assert (ts.loop_closer is None) == (js.loop_closer is None)
    assert ts.tracker.kfdb is ts.kfdb
    want, got = _kfdb_contents(js.kfdb), _kfdb_contents(ts.kfdb)
    assert got[0] == want[0]
    if loop:  # built at construction: the load indexes nothing
        assert got[0] == []
    else:  # built by the load: every loaded KF but the last
        assert got[0] == js.store.valid_kf_ids()[:-1].tolist() and got[0]
    assert got[1] == want[1] and got[3] == want[3]
    for k in got[0]:
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=1e-6)
    js.shutdown()
    ts.shutdown()


def test_keypoint_yaml_same_text(tmp_path):
    """tests/test_map_io.py::test_keypoint_yaml_roundtrip on both packages,
    plus a frame with invalid slots and no timestamp."""

    class F:
        frame_id = 7
        timestamp = 1.25
        uv = np.asarray([[10.5, 20.25], [30.0, 40.0], [1.0, 2.0]], np.float32)
        octave = np.asarray([0, 2, 1], np.int32)
        angle = np.asarray([0.1, -1.2, 3.0], np.float32)
        response = np.asarray([12.0, 9.5, 1.0], np.float32)
        u_right = np.asarray([8.0, -1.0, 0.5], np.float32)
        depth = np.asarray([5.5, -1.0, 2.0], np.float32)
        valid = np.asarray([True, True, False])

    class G(F):
        timestamp = None
        response = None

    for frame in (F, G):
        tkeypoints.save_keypoints_yaml(tmp_path / "t.yaml", frame)
        jkeypoints.save_keypoints_yaml(tmp_path / "j.yaml", frame)
        text = (tmp_path / "t.yaml").read_text()
        assert text == (tmp_path / "j.yaml").read_text()
        got = tkeypoints.load_keypoints_yaml(tmp_path / "t.yaml")
        want = jkeypoints.load_keypoints_yaml(tmp_path / "j.yaml")
        assert set(got) == set(want) and got["frame_id"] == 7
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_allclose(got["uv"], F.uv[:2], atol=1e-3)
    assert (got["octave"] == F.octave[:2]).all()

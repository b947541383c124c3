"""The rest of the port's System facade and its host modules on the CPU,
held against the JAX package's on the same inputs.

- io/settings.py on examples/euroc_stereo.yaml: the same SystemConfig;
- io/dataset.py on small EuRoC, TUM RGB-D and KITTI trees written here: the
  same images and timestamps;
- tracking/kinematics.py: predict, PWLS, pose_of, state_from_poses (1e-5),
  `process_jacobian` against `jax.jacfwd` (1e-5), the closed-form
  invariants of tests/test_kinematics.py, and OdometryBuffer;
- planner odometry: `Tracker._predict_pose(ts)` equal to the JAX tracker's
  with and without a buffer, and `System.buffer_odometry` feeding a run;
- the 13-state selection: `info_matrices_13` and `som_matrices` at rtol 1e-4
  of the matrix scale, `logdet_psd` at D = 13 at rtol 1e-4 (against the JAX
  package; against float64 within the float32 bound its conditioning sets),
  the exact greedy's selections and the local step with `info_mat_size=13`
  (statistically: picks swap at float32 near-ties, as in the 7-state step);
- the ChArUco pose and the stereo-initialization anchor (OpenCV);
- viz: the frame overlay and the PLY text equal to the JAX writer's on the
  same store, the map render written;
- the log savers: the same JSON keys as the JAX Systems' on the same frames,
  and the same realtime stream lines (poses to 1e-3);
- runtime controls: `set_constr_per_frame` on the next frame,
  `set_budget_per_frame` through `estimate_kf_budget`, localization mode.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu import config as jc
from gf_orb_slam2_tpu.io import dataset as jdataset, settings as jsettings
from gf_orb_slam2_tpu.selection import good_feature as jgf, observability as jobs
from gf_orb_slam2_tpu.tracking import kinematics as jkin
from gf_orb_slam2_tpu_torch import config as tc, convert
from gf_orb_slam2_tpu_torch.io import dataset as tdataset, settings as tsettings
from gf_orb_slam2_tpu_torch.selection import good_feature as tgf, observability as tobs
from gf_orb_slam2_tpu_torch.slammap.store import MapStore as TMapStore
from gf_orb_slam2_tpu_torch.system import System as TSystem
from gf_orb_slam2_tpu_torch.tracking import kinematics as tkin, tracker as ttracker
from gf_orb_slam2_tpu_torch.viz import visualizer as tviz
from tests.synthetic import SyntheticWorld, forward_trajectory, make_frame
from tests.test_torch_tracking_step import BF, FX, FY, J, T, _info_inputs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_KP = 512
HOST = ("uv", "octave", "angle", "desc", "response", "u_right", "depth", "valid")
MAT_RTOL = 1e-4  # of the matrix scale (entries span ~1e2..1e6)


def _assert_same(got, want, path="cfg"):
    """Dataclasses field by field (enums by name, arrays exactly)."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            _assert_same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif hasattr(want, "name") and hasattr(want, "value"):
        assert (type(got).__name__, got.name) == (type(want).__name__, want.name), path
    else:
        assert got == want, path


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


def _jframe(arrays):
    from gf_orb_slam2_tpu.tracking.frame import Frame as JFrame

    return JFrame(frame_id=arrays["frame_id"], timestamp=arrays["timestamp"],
                  **{k: np.array(arrays[k]) for k in HOST})


def _frames(n, seed=41, step=0.1):
    cam = jc.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0, th_depth=35.0)
    world = SyntheticWorld(6000, seed=seed)
    out = []
    for i, (R, t) in enumerate(forward_trajectory(n, step=step)):
        f = make_frame(world, R, t, cam, i, n_kp=N_KP)
        out.append(dict({k: np.array(getattr(f, k)) for k in HOST}, frame_id=i,
                        timestamp=f.timestamp, R_gt=R, t_gt=t))
    return out


def _config(**kw):
    cam = jc.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0, th_depth=35.0)
    base = dict(
        sensor=jc.Sensor.STEREO, camera=cam, orb=jc.ORBConfig(n_features=N_KP),
        capacity=jc.CapacityConfig(max_keypoints=N_KP, max_map_points=20000,
                                   max_keyframes=200, max_local_points=2048),
        good_feature=jc.GoodFeatureConfig(matching_mode=jc.GFMatchingMode.LONG_LIVED),
        tracking=jc.TrackingConfig(async_mapping=False, max_frames_between_kf=4),
        loop=jc.LoopClosingConfig(enabled=False), vocabulary_path="")
    base.update(kw)
    return jc.SystemConfig(**base)


# ---------------------------------------------------------------- settings
@pytest.mark.parametrize("sensor", [None, "RGBD"])
def test_load_settings_euroc(sensor):
    path = os.path.join(ROOT, "examples", "euroc_stereo.yaml")
    want = jsettings.load_settings(path, None if sensor is None else jc.Sensor[sensor])
    got = tsettings.load_settings(path, None if sensor is None else tc.Sensor[sensor])
    assert isinstance(got, tc.SystemConfig)
    _assert_same(got, convert.config_from_reference(want))
    _assert_same(got, want)
    assert got.camera.left_K is not None and got.capacity.max_keypoints == 1024


def test_load_settings_opencv_header_and_gf_section(tmp_path):
    text = ("%YAML:1.0\nCamera.fx: 500.0\nCamera.fy: 501.0\nCamera.cx: 320.0\n"
            "Camera.cy: 240.0\nCamera.k1: 0.1\nORBextractor.nFeatures: 300\n"
            "DepthMapFactor: 1000.0\nSensor: RGBD\nK: !!opencv-matrix\n  rows: 1\n"
            "  cols: 1\n  data: [1.0]\n"
            "gf:\n  good_feature: false\n  constr_per_frame: 90\n  hashing: true\n"
            "  local_map_mode: COMBINED\n  subgraph_size: 9\n")
    p = tmp_path / "s.yaml"
    p.write_text(text)
    _assert_same(tsettings.load_settings(p), jsettings.load_settings(p))


# ----------------------------------------------------------------- dataset
def _write_trees(root):
    import cv2

    rng = np.random.default_rng(0)

    def img(path, dtype=np.uint8, hi=255):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cv2.imwrite(str(path), rng.integers(0, hi, (12, 16)).astype(dtype))

    euroc = root / "euroc"
    rows = ["#timestamp [ns],filename"]
    for k, ts in enumerate((1403636579763555584, 1403636579813555456, 1403636579863555584)):
        name = f"{ts}.png"
        rows.append(f"{ts},{name}")
        img(euroc / "mav0" / "cam0" / "data" / name)
        if k != 1:  # a pair without its right image is skipped
            img(euroc / "mav0" / "cam1" / "data" / name)
    (euroc / "mav0" / "cam0" / "data.csv").write_text("\n".join(rows) + "\n")

    tum = root / "tum"
    rgb, depth = ["# color images", "# file"], ["# depth maps"]
    for k, (tr, td) in enumerate(((1.0, 1.005), (1.1, 1.2), (1.2, 1.21))):
        rgb.append(f"{tr:.6f} rgb/{k}.png")
        depth.append(f"{td:.6f} depth/{k}.png")
        img(tum / "rgb" / f"{k}.png")
        img(tum / "depth" / f"{k}.png", np.uint16, 60000)
    (tum / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (tum / "depth.txt").write_text("\n".join(depth) + "\n")

    kitti = root / "kitti" / "sequences" / "03"
    kitti.mkdir(parents=True)
    (kitti / "times.txt").write_text("0.000000e+00\n1.036690e-01\n2.072460e-01\n")
    for i in range(3):
        img(kitti / "image_0" / f"{i:06d}.png")
        img(kitti / "image_1" / f"{i:06d}.png")


def test_dataset_readers_agree(tmp_path):
    pytest.importorskip("cv2")
    _write_trees(tmp_path)
    pairs = [(tdataset.EurocStereo(str(tmp_path / "euroc")),
              jdataset.EurocStereo(str(tmp_path / "euroc"))),
             (tdataset.TumRgbd(str(tmp_path / "tum")), jdataset.TumRgbd(str(tmp_path / "tum"))),
             (tdataset.KittiStereo(str(tmp_path / "kitti"), "03"),
              jdataset.KittiStereo(str(tmp_path / "kitti"), "03"))]
    lens = []
    for got, want in pairs:
        assert len(got) == len(want)
        lens.append(len(got))
        for a, b in zip(got, want, strict=True):
            assert len(a) == len(b) == 3
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[1].dtype == b[1].dtype
            assert a[2] == b[2]
    assert lens == [2, 2, 3]  # the lone left image and the far depth are dropped


# -------------------------------------------------------------- kinematics
def _state(rng):
    from gf_orb_slam2_tpu.geometry import lie as jlie

    q = np.asarray(jlie.rot_to_quat(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.4, 3), jnp.float32))))
    return (rng.normal(0, 1, 3).astype(np.float32), q.astype(np.float32),
            rng.normal(0, 0.5, 3).astype(np.float32), rng.normal(0, 0.3, 3).astype(np.float32))


def _both(arrays):
    return (jkin.KineState(*(jnp.asarray(a) for a in arrays)),
            tkin.KineState(*(torch.from_numpy(a) for a in arrays)))


@pytest.mark.parametrize("seed", range(4))
def test_kinematics_parity(seed):
    rng = np.random.default_rng(seed)
    js, ts = _both(_state(rng))
    for dt in (0.0, 0.05, 0.25):
        np.testing.assert_allclose(tkin.predict(ts, dt).vector().numpy(),
                                   np.asarray(jkin.predict(js, dt).vector()), atol=1e-5)
        J = np.asarray(jax.jacfwd(lambda x: jkin.predict(jkin.KineState.from_vector(x), dt)
                                  .vector())(js.vector()))
        got = tkin.process_jacobian(ts, dt)
        assert got.shape == (13, 13) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), J, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(jkin.process_jacobian(js, dt)),
                                   atol=1e-5)
    np.testing.assert_allclose(tkin.predict_pwls(ts, [0.1, 0.2, 0.05]).vector().numpy(),
                               np.asarray(jkin.predict_pwls(js, [0.1, 0.2, 0.05]).vector()),
                               atol=1e-5)
    for a, b in zip(tkin.pose_of(ts), jkin.pose_of(js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    R1, t1 = (np.asarray(a) for a in jkin.pose_of(js))
    R2, t2 = (np.asarray(a) for a in jkin.pose_of(jkin.predict(js, 0.1)))
    got = tkin.state_from_poses(R1, t1, R2, t2, 0.1)
    want = jkin.state_from_poses(R1, t1, R2, t2, 0.1)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_kinematics_invariants():
    """tests/test_kinematics.py's closed-form checks on the port."""
    _, s = _both(_state(np.random.default_rng(0)))
    np.testing.assert_allclose(tkin.predict(s, 0.0).vector().numpy(), s.vector().numpy(), atol=1e-6)
    s1 = s._replace(w=torch.zeros(3))
    s2 = tkin.predict(s1, 0.5)
    np.testing.assert_allclose(s2.p.numpy(), (s1.p + 0.5 * s1.v).numpy(), atol=1e-6)
    np.testing.assert_allclose(s2.q.numpy(), s1.q.numpy(), atol=1e-6)
    np.testing.assert_allclose(tkin.predict(s, 0.4).vector().numpy(),
                               tkin.predict_pwls(s, [0.2, 0.2]).vector().numpy(), atol=1e-5)
    J = tkin.process_jacobian(s, 0.25).numpy()
    np.testing.assert_allclose(J[0:3, 0:3], np.eye(3), atol=1e-5)
    np.testing.assert_allclose(J[0:3, 7:10], 0.25 * np.eye(3), atol=1e-5)
    np.testing.assert_allclose(J[7:13, 0:7], 0.0, atol=1e-6)
    np.testing.assert_allclose(J[7:13, 7:13], np.eye(6), atol=1e-6)
    s2 = tkin.predict(s, 0.1)
    R1, t1 = (a.numpy() for a in tkin.pose_of(s))
    R2, t2 = (a.numpy() for a in tkin.pose_of(s2))
    s3 = tkin.predict(tkin.state_from_poses(R1, t1, R2, t2, 0.1), 0.1)
    np.testing.assert_allclose(tkin.pose_of(s3)[1].numpy(),
                               tkin.pose_of(tkin.predict(s2, 0.1))[1].numpy(), atol=2e-2)


def test_odometry_buffer_parity():
    a, b = tkin.OdometryBuffer(horizon=5), jkin.OdometryBuffer(horizon=5)
    assert a.predict_at(0.0) is None and b.predict_at(0.0) is None
    rng = np.random.default_rng(1)
    for i in range(9):  # past the horizon: the oldest go
        R = np.asarray(jax.device_get(jnp.eye(3)), np.float32)
        t = rng.normal(0, 1, 3).astype(np.float32)
        a.push(i * 0.1, R, t)
        b.push(i * 0.1, R, t)
    for ts in (0.0, 0.35, 0.52, 0.8, 1.2, 1.31, 99.0):
        ga, gb = a.predict_at(ts), b.predict_at(ts)
        assert (ga is None) == (gb is None), ts
        if ga is not None:
            np.testing.assert_array_equal(ga[1], gb[1])
    for t0, t1 in ((0.4, 0.5), (0.5, 0.8), (0.1, 0.5), (0.6, 5.0)):
        ra, rb = a.relative_motion(t0, t1), b.relative_motion(t0, t1)
        assert (ra is None) == (rb is None)
        if ra is not None:
            np.testing.assert_array_equal(ra, rb)
    a.clear()
    assert a.predict_at(0.5) is None


# ----------------------------------------------------------- odometry in use
def _pose(rng):
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec(rng.normal(0, 0.2, 3)).as_matrix().astype(np.float32)
    return R, rng.normal(0, 1, 3).astype(np.float32)


def test_predict_pose_matches_jax_with_and_without_odometry():
    from gf_orb_slam2_tpu.slammap.store import MapStore as JMapStore
    from gf_orb_slam2_tpu.tracking.frame import Frame as JFrame
    from gf_orb_slam2_tpu.tracking.tracker import Tracker as JTracker

    jcfg = _config()
    scales = (1.2 ** np.arange(8)).astype(np.float32)
    jtr = JTracker(jcfg, JMapStore(jcfg.capacity, N_KP), N_KP, scales)
    tcfg = convert.config_from_reference(jcfg)
    ttr = ttracker.Tracker(tcfg, TMapStore(tcfg.capacity, N_KP), N_KP, scales, device="cpu")
    rng = np.random.default_rng(3)
    R, t = _pose(rng)
    V = np.eye(4, dtype=np.float32)
    V[:3, :3], V[:3, 3] = _pose(rng)[0], [0.01, 0.0, 0.1]
    z = np.zeros(1, np.float32)
    jtr.last_frame = JFrame(frame_id=4, timestamp=0.2, uv=z, octave=z, angle=z, desc=z,
                            response=z, u_right=z, depth=z, valid=z, R=R, t=t)
    ttr.last_frame = convert.frame_from_arrays(dict(
        frame_id=4, timestamp=0.2, uv=z, octave=z, angle=z, desc=z, response=z, u_right=z,
        depth=z, valid=z, R=R, t=t))
    jtr.velocity, ttr.velocity = V.copy(), V.copy()
    for a, b in zip(ttr._predict_pose(0.25), jtr._predict_pose(0.25)):  # no buffer
        np.testing.assert_array_equal(a, b)
    assert ttr.n_odom_predictions == 0
    for ts in (0.2, 0.25):
        Ro, to = _pose(rng)
        jtr.odom.push(ts, Ro, to)
        ttr.odom.push(ts, Ro, to)
    got, want = ttr._predict_pose(0.25), jtr._predict_pose(0.25)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert ttr.n_odom_predictions == 1
    assert not np.allclose(got[1], (V @ ttr.last_frame.pose_matrix())[:3, 3])
    for a, b in zip(ttr._predict_pose(None), jtr._predict_pose(None)):  # no timestamp
        np.testing.assert_array_equal(a, b)


def test_buffer_odometry_drives_the_prediction():
    """Ground-truth poses buffered before each frame: every frame that
    predicts a search window (the motion model or the fused step) predicts it
    from the buffer; tracking stays OK."""
    cfg = convert.config_from_reference(_config())
    slam = TSystem(cfg, device="cpu")
    for arrays in _frames(8):
        slam.buffer_odometry(arrays["timestamp"], arrays["R_gt"], arrays["t_gt"])
        slam.track_frame(convert.frame_from_arrays(arrays))
    stats = slam.tracker.stats
    assert all(st.state == "OK" for st in stats)
    predicted = sum(st.path in ("fused", "motion") for st in stats)
    assert predicted >= 6 and slam.tracker.n_odom_predictions == predicted
    slam.shutdown()


# ------------------------------------------------------ the 13-state half
def test_info_matrices_13_and_som_parity():
    q, p, pos, stereo, inv2, valid = _info_inputs(np.random.default_rng(5))
    for prior in (1e2, 0.0):
        want = np.asarray(jobs.info_matrices_13(J(q), J(p), J(pos), FX, FY, BF, J(stereo),
                                                J(inv2), J(valid), kine_prior=prior))
        got = tobs.info_matrices_13(T(q), T(p), T(pos), FX, FY, BF, T(stereo), T(inv2),
                                    T(valid), kine_prior=prior).numpy()
        assert got.shape == (pos.shape[0], 13, 13)
        scale = np.abs(want).max((1, 2), keepdims=True) + 1e-6
        assert (np.abs(got - want) / scale).max() < MAT_RTOL
        np.testing.assert_array_equal(got[:, 7:, 7:], prior * np.eye(6)[None].repeat(len(pos), 0))
    Hw, pcw = jobs.measurement_jacobians_13(J(q), J(p), J(pos), FX, FY, BF, J(stereo))
    Hg, pcg = tobs.measurement_jacobians_13(T(q), T(p), T(pos), FX, FY, BF, T(stereo))
    assert not Hg[..., 7:].any()
    hs = np.abs(np.asarray(Hw)).max() + 1e-6
    assert np.abs(Hg.numpy() - np.asarray(Hw)).max() / hs < MAT_RTOL
    rng = np.random.default_rng(6)
    v, w = rng.normal(0, 0.5, 3).astype(np.float32), rng.normal(0, 0.3, 3).astype(np.float32)
    dts = [0.05, 0.1, 0.2]
    want = np.asarray(jobs.som_matrices(J(q), J(p), J(v), J(w), dts, J(pos), FX, FY, BF, J(stereo)))
    got = tobs.som_matrices(T(q), T(p), T(v), T(w), dts, T(pos), FX, FY, BF, T(stereo)).numpy()
    assert got.shape == want.shape == (pos.shape[0], 9, 13)
    scale = np.abs(want).max((1, 2), keepdims=True) + 1e-6
    assert (np.abs(got - want) / scale).max() < MAT_RTOL
    assert np.abs(got[:, 3:, 7:]).max() > 0  # the velocity block gains rank downstream


def _trial_13(seed):
    """The matrices the 13-state selection takes logdets of: a matched set's
    information (no prior) + one candidate's (with the prior) + eps·I."""
    q, p, pos, stereo, inv2, valid = _info_inputs(np.random.default_rng(seed))
    M = np.asarray(jobs.info_matrices_13(J(q), J(p), J(pos), FX, FY, BF, J(stereo),
                                         J(inv2), J(valid)))
    base = np.asarray(jobs.info_matrices_13(J(q), J(p), J(pos[:40]), FX, FY, BF,
                                            J(stereo[:40]), J(np.ones(40, np.float32)),
                                            J(valid[:40]), kine_prior=0.0)).sum(0)
    return M, base, valid


def _logdet_f64(M):
    """logdet_psd's definition (diagonal scaling, +1e-5·I) in float64."""
    M = M.astype(np.float64)
    d = np.sqrt(np.maximum(np.diagonal(M, axis1=-2, axis2=-1), 1e-3))
    Mn = M / (d[..., :, None] * d[..., None, :]) + 1e-5 * np.eye(M.shape[-1])
    return np.linalg.slogdet(Mn)[1] + 2 * np.log(d).sum(-1), Mn


def test_logdet_psd_at_13_parity():
    """test_torch_tracking_step.py::test_logdet_psd_parity's construction at
    D = 13: rtol 1e-4 against the JAX package (float64: the test below)."""
    q, p, pos, stereo, inv2, valid = _info_inputs(np.random.default_rng(6))
    M = np.asarray(jobs.info_matrices_13(J(q), J(p), J(pos), FX, FY, BF, J(stereo),
                                         J(inv2), J(valid)))
    M = M + M[valid].sum(0) * 0.01 + 1e-3 * np.eye(13, dtype=np.float32)
    want = np.asarray(jobs.logdet_psd(J(M)))
    got = tobs.logdet_psd(T(M)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    # the 6 kinematic dims are decoupled: the 13-state logdet is the pose
    # block's plus theirs
    np.testing.assert_allclose(got, tobs.logdet_psd(T(np.ascontiguousarray(M[:, :7, :7]))).numpy()
                               + tobs.logdet_psd(T(np.ascontiguousarray(M[:, 7:, 7:]))).numpy(),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("seed", [7, 8])
def test_logdet_psd_at_13_on_selection_trials(seed):
    """The matrices the 13-state selection scores (matched set + one
    candidate + eps·I). Every pose block has the quaternion gauge's null
    direction (the tangent projection removes it from every point's
    Jacobian), so its normalized matrix has an eigenvalue at the 1e-5
    regularizer and a condition number κ ≈ 3e5: in float32 the Cholesky's
    last pivot loses about κ·ε₃₂ of itself — both packages alike, and the
    same at D = 7. The bound is that, from the dtype and the measured κ."""
    M, base, valid = _trial_13(seed)
    trial = (base[None] + M + 1e-3 * np.eye(13, dtype=np.float32)).astype(np.float32)
    ref, Mn = _logdet_f64(trial)
    ev = np.linalg.eigvalsh(Mn)
    kappa = float((ev[:, -1] / ev[:, 0]).max())
    assert 1e4 < kappa < 1e6
    bound = 2 * kappa * np.finfo(np.float32).eps
    want = np.asarray(jobs.logdet_psd(J(trial)))
    got = tobs.logdet_psd(T(trial)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(want - ref).max() <= bound  # the JAX package's own error
    assert np.abs(got - ref).max() <= bound
    assert np.abs(got - want).max() <= bound
    # the same error on the 7-state pose block alone
    ref7 = _logdet_f64(trial[:, :7, :7])[0]
    got7 = tobs.logdet_psd(T(np.ascontiguousarray(trial[:, :7, :7]))).numpy()
    assert np.abs(got7 - ref7).max() <= bound


def test_exact_greedy_on_13_state_matrices():
    """Exact greedy (no randomness) on the 13-state matrices: candidate
    scores a few 1e-2 apart sit inside the float32 error of the test above,
    so single picks may swap between the packages; the selections agree in
    size, in ≥ 90 % of their members and in their float64 logdet (1e-4)."""
    M, base, valid = _trial_13(9)
    wsel, _ = jgf.lazier_greedy_select(J(M), J(valid), 40, jax.random.PRNGKey(0),
                                       lazier_factor=1, base_mat=J(base))
    gsel, gord = tgf.lazier_greedy_select(T(M), T(valid), 40, None, lazier_factor=1,
                                          base_mat=T(base))
    wsel, gsel = np.asarray(wsel), gsel.numpy()
    assert gsel.sum() == wsel.sum() == 40 and not (gsel & ~valid).any()
    assert (gsel & wsel).sum() >= 36
    ld = [_logdet_f64(base + M[s].sum(0))[0] for s in (gsel, wsel)]
    assert abs(ld[0] - ld[1]) <= 1e-4 * abs(ld[1])
    assert sorted(gord.tolist()) == np.nonzero(gsel)[0].tolist()


def test_local_step_13_state_parity():
    """The local step's 13-state branch (good-feature selection on the
    hybrid matrices, exact greedy) on a synthetic frame and pool. Held as
    test_torch_tracking_step.py::test_fused_step_good_feature_branch holds the
    7-state branch — picks can swap at float32 near-ties (the logdet tests
    above): the same visible count, the budget respected, local and leftover
    match counts within 15 %, inliers within 5 %, the pose to 2e-3."""
    from gf_orb_slam2_tpu.slammap.store import MapStore as JMapStore
    from gf_orb_slam2_tpu.tracking.tracker import Tracker as JTracker

    jcfg = _config(good_feature=jc.GoodFeatureConfig(
        info_mat_size=13, lazier_factor=1, constr_per_frame=60, min_pool=50))
    tcfg = convert.config_from_reference(jcfg)
    world = SyntheticWorld(6000, seed=12)
    R, t = forward_trajectory(4, step=0.1)[3]
    f = make_frame(world, R, t, jcfg.camera, 0, n_kp=N_KP)
    rng = np.random.default_rng(12)
    L = jcfg.capacity.max_local_points
    gt = f.gt_ids
    seen = np.unique(gt[gt >= 0])
    extra = rng.choice(np.setdiff1d(np.arange(len(world.points)), seen), 400, replace=False)
    pool = np.concatenate([seen, extra])
    n = pool.size
    pad = L - n
    cw = -R.T @ t
    normal = world.points[pool] - cw
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    matched = (gt >= 0) & (rng.random(N_KP) < 0.3)
    # scale bounds of the synthetic octave model (octave = log_1.2(d0 / z))
    maxd = world.d0[pool]
    loc = dict(
        pos=np.concatenate([world.points[pool], np.zeros((pad, 3), np.float32)]),
        normal=np.concatenate([normal, np.zeros((pad, 3))]).astype(np.float32),
        mind=np.concatenate([maxd / 1.2 ** 7, np.zeros(pad)]).astype(np.float32),
        maxd=np.concatenate([maxd, np.ones(pad)]).astype(np.float32),
        desc=np.concatenate([world.desc[pool], np.zeros((pad, 8), np.uint32)]),
        valid=np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
        life=np.concatenate([rng.integers(1, 20, n), np.zeros(pad)]).astype(np.float32),
        already=np.concatenate([np.isin(pool, gt[matched]), np.zeros(pad, bool)]))
    kp_mp_pos = np.where(matched[:, None], world.points[np.maximum(gt, 0)], 0).astype(np.float32)
    from scipy.spatial.transform import Rotation

    R0 = (Rotation.from_rotvec([0.001, -0.0008, 0.0005]).as_matrix() @ R).astype(np.float32)
    t0 = (t + np.array([0.004, -0.002, 0.006])).astype(np.float32)
    keys = ("pos", "normal", "mind", "maxd", "desc", "valid", "life", "already")
    scales = (1.2 ** np.arange(8)).astype(np.float32)
    jtr = JTracker(jcfg, JMapStore(jcfg.capacity, N_KP), N_KP, scales)
    w_res, w_row, w_add, _, w_vis = jtr._jit_local(
        J(R0), J(t0), *(J(loc[k]) for k in keys),
        J(f.uv), J(f.octave), J(f.u_right), J(f.valid), J(f.desc),
        J(kp_mp_pos), J(matched), jnp.float32(1.0), jax.random.PRNGKey(0))
    g_res, g_row, g_add, _, g_vis = ttracker.local_step(
        tcfg, T(scales), T(R0), T(t0), *(T(loc[k]) for k in keys),
        T(f.uv), T(f.octave), T(f.u_right), T(f.valid), T(f.desc),
        T(kp_mp_pos), T(matched), 1.0, None)
    assert int(g_vis) == int(w_vis) > jcfg.good_feature.min_pool  # the selection ran
    n_w, n_g = int((np.asarray(w_row) >= 0).sum()), int((g_row >= 0).sum())
    a_w, a_g = int((np.asarray(w_add) >= 0).sum()), int((g_add >= 0).sum())
    i_w, i_g = int(w_res.n_inliers), int(g_res.n_inliers)
    print(f"local {n_w}/{n_g} leftover {a_w}/{a_g} inliers {i_w}/{i_g}")
    assert 20 < n_g <= 60 and abs(n_g - n_w) <= 0.15 * n_w + 3
    assert a_g > 0 and abs(a_g - a_w) <= 0.15 * a_w + 3
    assert not ((g_row >= 0) & (g_add >= 0)).any()
    assert abs(i_g - i_w) <= 0.05 * i_w + 2
    agree = (g_row.numpy() == np.asarray(w_row)).mean()
    assert agree >= 0.9, agree
    np.testing.assert_allclose(g_res.R.numpy(), np.asarray(w_res.R), atol=2e-3)
    np.testing.assert_allclose(g_res.t.numpy(), np.asarray(w_res.t), atol=2e-3)


# ------------------------------------------------------------------ charuco
def _board_frame(board_cls, h=480, w=640):
    cv2 = pytest.importorskip("cv2")
    board = board_cls()
    b, _ = board.build()
    img = b.generateImage((600, 840))
    frame = np.full((h, w), 128, np.uint8)
    frame[30:450, 170:470] = cv2.resize(img, (300, 420))
    return board, frame


def test_charuco_pose_and_stereo_init_anchor():
    pytest.importorskip("cv2")
    from gf_orb_slam2_tpu.io import charuco as jcharuco
    from gf_orb_slam2_tpu_torch.io import charuco as tcharuco

    board, img = _board_frame(tcharuco.CharucoBoard)
    K = np.array([[450.0, 0, 320], [0, 450, 240], [0, 0, 1]])
    got = tcharuco.detect_board_pose(img, board, K, np.zeros(5))
    want = jcharuco.detect_board_pose(img, jcharuco.CharucoBoard(), K, np.zeros(5))
    assert got is not None and want is not None
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    R_ref, t_ref = got
    assert np.linalg.norm(t_ref) > 0.05 and t_ref[2] > 0
    assert tcharuco.detect_board_pose(np.full_like(img, 128), board, K, np.zeros(5)) is None

    cfg = tc.SystemConfig(
        sensor=tc.Sensor.STEREO,
        camera=tc.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0),
        orb=tc.ORBConfig(n_features=800),
        capacity=tc.CapacityConfig(max_keypoints=1024, max_map_points=4000,
                                   max_keyframes=10, max_local_points=512),
        charuco=tc.CharucoConfig(enabled=True))
    n_kp = 1024
    rng = np.random.default_rng(0)
    frame = convert.frame_from_arrays(dict(
        frame_id=0, timestamp=0.0, uv=rng.uniform(50, 400, (n_kp, 2)),
        octave=np.zeros(n_kp), angle=np.zeros(n_kp),
        desc=rng.integers(0, 2 ** 32, (n_kp, 8), dtype=np.uint32),
        response=np.ones(n_kp), valid=np.ones(n_kp, bool),
        u_right=rng.uniform(40, 390, n_kp), depth=rng.uniform(2, 10, n_kp)))
    frame._raw_img = img
    tr = ttracker.Tracker(cfg, TMapStore(cfg.capacity, n_kp), n_kp,
                          (1.2 ** np.arange(8)).astype(np.float32), device="cpu")
    assert tr._stereo_initialization(frame)
    np.testing.assert_allclose(frame.R, R_ref, atol=1e-4)
    np.testing.assert_allclose(frame.t, t_ref, atol=1e-4)
    s = tr.store
    np.testing.assert_array_equal(s.kf_R[0], frame.R)
    # the first map points sit where the anchored camera sees them
    ids = frame.mp_ids[frame.mp_ids >= 0]
    pc = s.point_pos[ids] @ frame.R.T + frame.t
    np.testing.assert_allclose(pc[:, 2], frame.depth[frame.mp_ids >= 0], rtol=1e-4)


def test_raw_image_kept_only_until_initialization():
    W, H = 320, 240
    cfg = tc.SystemConfig(
        sensor=tc.Sensor.STEREO,
        camera=tc.CameraConfig(width=W, height=H, fx=225.0, fy=225.0, cx=160.0, cy=120.0,
                               bf=22.5),
        orb=tc.ORBConfig(n_features=600),
        capacity=tc.CapacityConfig(max_keypoints=640, max_map_points=4000,
                                   max_keyframes=10, max_local_points=512),
        loop=tc.LoopClosingConfig(enabled=False), charuco=tc.CharucoConfig(enabled=True))
    slam = TSystem(cfg, device="cpu")
    img = np.random.default_rng(0).integers(0, 255, (H, W)).astype(np.uint8)
    f = slam._build_stereo_frame(img, img, 0.0)
    np.testing.assert_array_equal(f._raw_img, img)
    slam.tracker.state = ttracker.TrackState.OK
    assert getattr(slam._build_stereo_frame(img, img, 0.05), "_raw_img", None) is None
    off = TSystem(cfg.replace(charuco=tc.CharucoConfig(enabled=False)), device="cpu")
    assert getattr(off._build_stereo_frame(img, img, 0.0), "_raw_img", None) is None


# ------------------------------------------------- runs of both Systems
@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """Both Systems over 10 synthetic frames with loop closing on (the logs
    of every saver are non-empty), each writing its realtime stream."""
    d = tmp_path_factory.mktemp("runs")
    jcfg = _config(loop=jc.LoopClosingConfig(enabled=True), vocabulary_path=None)
    js = _jax_system(jcfg)
    ts = TSystem(convert.config_from_reference(jcfg), device="cpu")
    js.set_realtime_stream(d / "jax_rt.txt")
    ts.set_realtime_stream(d / "port_rt.txt")
    frames = _frames(10)
    for arrays in frames:
        js.track_frame(_jframe(arrays))
        ts.track_frame(convert.frame_from_arrays(arrays))
    assert js.state.name == ts.state.name == "OK"
    yield dict(js=js, ts=ts, dir=d, frames=frames)
    js.shutdown()
    ts.shutdown()


@pytest.mark.parametrize("saver", ["save_tracking_log", "save_mapping_log",
                                   "save_loop_log", "save_lmk_log"])
def test_log_savers_write_the_jax_keys(both_runs, saver):
    js, ts, d = both_runs["js"], both_runs["ts"], both_runs["dir"]
    getattr(js, saver)(d / f"j_{saver}.jsonl")
    getattr(ts, saver)(d / f"t_{saver}.jsonl")
    want = [json.loads(x) for x in (d / f"j_{saver}.jsonl").read_text().splitlines()]
    got = [json.loads(x) for x in (d / f"t_{saver}.jsonl").read_text().splitlines()]
    assert got and want
    assert [list(r) for r in got][:1] == [list(r) for r in want][:1]  # same keys, same order
    assert all(set(r) == set(want[0]) for r in got + want)
    if saver == "save_tracking_log":
        assert [r["frame_id"] for r in got] == [r["frame_id"] for r in want]
        assert [r["state"] for r in got] == [r["state"] for r in want]
    if saver in ("save_mapping_log", "save_loop_log"):
        assert [r["kf"] for r in got] == [r["kf"] for r in want]


def test_realtime_stream_lines_match_jax(both_runs):
    ts, d = both_runs["ts"], both_runs["dir"]
    ts._rt_stream.flush()
    got = (d / "port_rt.txt").read_text().splitlines()
    want = (d / "jax_rt.txt").read_text().splitlines()
    assert len(got) == len(want) == len(both_runs["frames"])
    for a, b in zip(got, want):
        fa, fb = a.split(), b.split()
        assert len(fa) == len(fb) == 8 and fa[0] == fb[0]
        assert [len(x.split(".")[1]) for x in fa] == [len(x.split(".")[1]) for x in fb]
        np.testing.assert_allclose(np.float64(fa[1:]), np.float64(fb[1:]), atol=1e-3)


def test_viz_outputs_match_jax(both_runs, tmp_path):
    pytest.importorskip("cv2")
    from gf_orb_slam2_tpu.viz import visualizer as jviz

    ts = both_runs["ts"]
    f = ts.tracker.last_frame
    img = np.random.default_rng(0).integers(0, 255, (480, 640)).astype(np.uint8)
    out = tviz.draw_frame(img, f)
    assert out.shape == (480, 640, 3) and out.any()
    np.testing.assert_array_equal(out, jviz.draw_frame(img, f))
    tviz.export_ply(ts.store, tmp_path / "t.ply")
    jviz.export_ply(ts.store, tmp_path / "j.ply")
    text = (tmp_path / "t.ply").read_text()
    assert text == (tmp_path / "j.ply").read_text()
    head = text.splitlines()
    assert head[0] == "ply" and int(head[2].split()[-1]) > 100
    png = tmp_path / "map.png"
    tviz.plot_map(ts.store, png)
    assert png.exists() and png.stat().st_size > 1000


# ---------------------------------------------------------- runtime controls
def test_runtime_controls(monkeypatch):
    from gf_orb_slam2_tpu.selection.good_graph import estimate_kf_budget as jbudget

    budgets = []  # (frame, budget) of every selection the local step ran
    select = ttracker.good_feature.long_lived_select

    def spy(life, pool, n_select):
        budgets.append((len(slam.tracker.stats), n_select))
        return select(life, pool, n_select)

    monkeypatch.setattr(ttracker.good_feature, "long_lived_select", spy)
    cfg = convert.config_from_reference(_config())
    slam = TSystem(cfg, device="cpu")
    frames = _frames(14, seed=43)
    for arrays in frames[:7]:
        slam.track_frame(convert.frame_from_arrays(arrays))
    assert budgets and {n for _, n in budgets} == {cfg.good_feature.constr_per_frame}
    slam.set_constr_per_frame(25)  # the next frame's step selects 25
    assert slam.tracker.cfg.good_feature.constr_per_frame == 25
    assert slam.cfg.good_feature.constr_per_frame == 25
    n_before = len(budgets)
    for arrays in frames[7:10]:
        slam.track_frame(convert.frame_from_arrays(arrays))
    after = budgets[n_before:]
    assert len(after) >= 3 and {n for _, n in after} == {25}
    assert all(st.state == "OK" for st in slam.tracker.stats[7:])
    for ms in (5.0, 20.0, 80.0):
        slam.set_budget_per_frame(ms)
        assert slam.mapper.cfg.good_graph.subgraph_size == jbudget(ms)
    slam.activate_localization_mode()
    n_kf = slam.store.n_keyframes
    for arrays in frames[10:]:
        slam.track_frame(convert.frame_from_arrays(arrays))
    assert slam.store.n_keyframes == n_kf and slam.state.name == "OK"
    assert slam.tracker.cfg.localization_only
    slam.deactivate_localization_mode()
    assert not slam.tracker.cfg.localization_only
    slam.shutdown()

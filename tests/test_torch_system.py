"""The port's slice as a whole on the CPU at a small size — synchronous
stereo tracking with local mapping on every keyframe event — plus the
host-side copies (config, store, evaluation, trajectory IO, convert) held
against the JAX package's.

End-to-end gates check against the renderer's ground truth, not against the
JAX trajectory. The ATE bound (0.08 m over 12 frames at 320x240, focal 225)
is 1.5x what the JAX package measures on the same frames with its mapper on
(0.052 m, tools/port_small_sequence_cpu.py; the port measures 0.048 m).
"""
import dataclasses
import enum
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu import config as jconfig
from gf_orb_slam2_tpu.io import evaluation as jeval, trajectory as jtraj
from gf_orb_slam2_tpu.slammap.store import MapStore as JMapStore
from gf_orb_slam2_tpu_torch import config as tconfig, convert
from gf_orb_slam2_tpu_torch.io import evaluation as teval, trajectory as ttraj
from gf_orb_slam2_tpu_torch.loopclosing.loop_closer import LoopCloser
from gf_orb_slam2_tpu_torch.slammap.store import MapStore as TMapStore
from gf_orb_slam2_tpu_torch.system import System
from gf_orb_slam2_tpu_torch.tracking.tracker import TrackState
from tests.rendered_world import RoomWorld, trajectory_tour

torch.set_num_threads(1)

H, W, F = 240, 320, 225.0
N_FRAMES = 12


def _small_config():
    cam = tconfig.CameraConfig(width=W, height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
                               bf=F * 0.1, th_depth=40.0)
    # stereo initialization needs 500 keypoints, hence 600 features
    return tconfig.SystemConfig(
        sensor=tconfig.Sensor.STEREO, camera=cam,
        orb=tconfig.ORBConfig(n_features=600),
        capacity=tconfig.CapacityConfig(max_keypoints=640, max_map_points=8000,
                                        max_keyframes=40, max_local_points=1024),
        tracking=tconfig.TrackingConfig(async_mapping=False),
        loop=tconfig.LoopClosingConfig(enabled=False))


@pytest.fixture(scope="module")
def run():
    world = RoomWorld(width=9.0, height=5.5, length=13.0)
    poses = trajectory_tour(300)[:N_FRAMES]
    gt = np.stack([-R.T @ t for R, t in poses])
    slam = System(_small_config(), device="cpu")
    Ts, imgs = [], []
    for i, (R, t) in enumerate(poses):
        pair = world.render_stereo(R, t, baseline=0.1, fx=F, fy=F, cx=W / 2,
                                   cy=H / 2, w=W, h=H)
        imgs.append(pair)
        Ts.append(slam.track_stereo(pair[0], pair[1], i / 20.0))
    return dict(slam=slam, Ts=np.stack(Ts), gt=gt, imgs=imgs)


def test_slice_never_lost_and_fused_path_serves(run):
    stats = run["slam"].tracker.stats
    assert [s.state for s in stats] == ["OK"] * N_FRAMES
    assert stats[0].path == "init" and stats[0].created_kf
    assert sum(s.path == "fused" for s in stats) >= N_FRAMES - 3
    assert min(s.n_inliers for s in stats[1:]) >= 30


def test_slice_keyframes_and_map_grow(run):
    slam = run["slam"]
    assert slam.store.n_keyframes >= 2  # ≥ 1 KF after the initial one
    assert slam.store.n_points > 300
    # every keyframe event went through the mapper, in order
    assert [st.kf for st in slam.mapper.stats] == list(range(slam.store.n_keyframes))


def test_slice_mapping_triangulates_fuses_and_adjusts(run):
    """The mapper did real work on the way: new points from triangulation,
    fused duplicates, and a local BA with a finite cost on every event that
    had a window (all but the first)."""
    stats = run["slam"].mapper.stats
    assert sum(st.n_new_points for st in stats) > 0
    assert sum(st.n_fused for st in stats) > 0
    ba = stats[1:]
    assert ba and all(st.ba_kfs >= 2 and st.ba_points > 100 for st in ba)
    assert all(np.isfinite(st.ba_cost) and st.ba_cost > 0 for st in ba)
    assert len(run["slam"].mapper.event_ms) == len(stats)


def test_slice_ate_against_ground_truth(run):
    Ts = run["Ts"]
    assert np.isfinite(Ts).all() and Ts.shape == (N_FRAMES, 4, 4)
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    ate = teval.ate_rmse(est, run["gt"])
    print(f"ATE {ate:.4f} m over {N_FRAMES} frames")
    assert ate < 0.08
    for T in Ts:  # proper rotations
        np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-4)


def test_recomposed_trajectory_matches_returned_poses(run, tmp_path):
    """Each frame is recomposed as its pose relative to its reference KF
    times that KF's pose now (local BA has moved the KFs since); the frames
    whose reference KF was not adjusted after them come back as returned."""
    slam = run["slam"]
    rec = ttraj.recompose_trajectory(slam.tracker.relative_poses, slam.store)
    assert len(rec) == N_FRAMES
    s = slam.store
    n_same = 0
    for (ts, T), want, (_, _, T_rel, ref, _) in zip(rec, run["Ts"], slam.tracker.relative_poses):
        T_ref = np.eye(4, dtype=np.float32)
        T_ref[:3, :3], T_ref[:3, 3] = s.kf_R[ref], s.kf_t[ref]
        np.testing.assert_allclose(T, T_rel @ T_ref, atol=1e-5)
        n_same += bool(np.allclose(T, want, atol=1e-4))
    assert n_same >= 1
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for _, T in rec])
    assert teval.ate_rmse(est, run["gt"]) < 0.08
    # the TUM writer agrees with the JAX package's on the same state
    slam.save_trajectory_tum(tmp_path / "t.txt")
    jtraj.save_trajectory_tum(tmp_path / "j.txt", slam.tracker.relative_poses, slam.store)
    got = np.loadtxt(tmp_path / "t.txt")
    want = np.loadtxt(tmp_path / "j.txt")
    np.testing.assert_allclose(got, want, atol=2e-6)
    slam.save_keyframe_trajectory_tum(tmp_path / "k.txt")
    assert np.loadtxt(tmp_path / "k.txt").shape == (slam.store.n_keyframes, 8)
    slam.save_trajectory_kitti(tmp_path / "kitti.txt")
    assert np.loadtxt(tmp_path / "kitti.txt").shape == (N_FRAMES, 12)


def test_lost_stays_lost_then_reset_reinitialises(run):
    """Runs last on the shared system: blank frames lose tracking; each LOST
    frame tries to relocalize (no keypoints: no candidate is solved) and
    stays LOST; reset restarts."""
    slam = run["slam"]
    blank = np.zeros((H, W), np.uint8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(3):
            slam.track_stereo(blank, blank, (N_FRAMES + i) / 20.0)
    assert slam.state == TrackState.LOST and slam.tracker.n_lost == 3
    assert [s.state for s in slam.tracker.stats[-3:]] == ["LOST"] * 3
    assert [s.path for s in slam.tracker.stats[-2:]] == ["reloc"] * 2
    assert [r.kf for r in slam.tracker.reloc_stats] == [-1, -1]
    assert not any("relocalization" in str(w.message) for w in caught)
    slam.reset()
    assert slam.state == TrackState.NO_IMAGES_YET
    assert slam.store.n_keyframes == 0 and slam.store.n_points == 0
    left, right = run["imgs"][0]
    slam.track_stereo(left, right, 0.0)
    assert slam.state == TrackState.OK and slam.store.n_keyframes == 1
    slam.shutdown()


# ------------------------------------------------------- construction rules
def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device constructs")
    with pytest.raises(RuntimeError, match="CUDA"):
        System(_small_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        System(_small_config().replace(tracking=tconfig.TrackingConfig(async_mapping=True)))


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    """In a fresh interpreter, importing the port (the mapping, loop
    closing, relocalization, hashing, host IO and distributed-BA slices'
    modules named one by one, the collective audit, the three CLI scripts,
    bench_torch.py and the two offline tools) adds no jax module and
    nothing of the JAX package to sys.modules (compared against what the
    interpreter's own start-up had already loaded); once torch is loaded,
    the port brings in nothing but its own modules and the standard
    library. It also pins full-f32 matmul."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import torch, numpy\n"
        "with_torch = set(sys.modules)\n"
        "import gf_orb_slam2_tpu_torch, gf_orb_slam2_tpu_torch.system, "
        "gf_orb_slam2_tpu_torch.convert\n"
        "import gf_orb_slam2_tpu_torch.mapping.local_mapping, "
        "gf_orb_slam2_tpu_torch.mapping.batch_ops, gf_orb_slam2_tpu_torch.optim.local_ba, "
        "gf_orb_slam2_tpu_torch.selection.good_graph, "
        "gf_orb_slam2_tpu_torch.selection.anticipation, "
        "gf_orb_slam2_tpu_torch.geometry.triangulate, gf_orb_slam2_tpu_torch.utils.linalg3, "
        "gf_orb_slam2_tpu_torch.slammap.device_mirror\n"
        "import gf_orb_slam2_tpu_torch.place.vocabulary, gf_orb_slam2_tpu_torch.place.keyframe_db, "
        "gf_orb_slam2_tpu_torch.loopclosing.sim3solver, "
        "gf_orb_slam2_tpu_torch.loopclosing.loop_closer, gf_orb_slam2_tpu_torch.optim.pose_graph, "
        "gf_orb_slam2_tpu_torch.optim.global_ba, gf_orb_slam2_tpu_torch.utils.autodiff\n"
        "import gf_orb_slam2_tpu_torch.tracking.pnp, gf_orb_slam2_tpu_torch.tracking.initializer\n"
        "import gf_orb_slam2_tpu_torch.hashing.mih, gf_orb_slam2_tpu_torch.io.map_io, "
        "gf_orb_slam2_tpu_torch.io.settings, gf_orb_slam2_tpu_torch.io.dataset, "
        "gf_orb_slam2_tpu_torch.io.keypoints, gf_orb_slam2_tpu_torch.io.charuco, "
        "gf_orb_slam2_tpu_torch.tracking.kinematics, gf_orb_slam2_tpu_torch.viz.visualizer\n"
        "import gf_orb_slam2_tpu_torch.parallel.mesh, gf_orb_slam2_tpu_torch.parallel.dist_ba, "
        "gf_orb_slam2_tpu_torch.parallel.launch, gf_orb_slam2_tpu_torch.parallel.scaling_bench\n"
        "import tools.collective_audit_torch, importlib.util\n"
        "for path in ('examples/run_stereo_torch.py', 'examples/batch_sweep_torch.py',\n"
        "             'examples/eval_ate_torch.py', 'bench_torch.py',\n"
        "             'tools/train_vocabulary_torch.py', 'tools/charuco_tools_torch.py'):\n"
        "    spec = importlib.util.spec_from_file_location(path.split('/')[-1][:-3], path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "new = set(sys.modules) - before\n"
        "bad = [m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'gf_orb_slam2_tpu')]\n"
        "assert not bad, bad\n"
        "extra = {m.split('.')[0] for m in set(sys.modules) - with_torch}\n"
        "extra -= set(sys.stdlib_module_names) | {'gf_orb_slam2_tpu_torch', 'tools'}\n"
        "assert not extra, extra\n"
        "assert 'gf_orb_slam2_tpu' not in sys.modules\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(_repo_root()))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
    # the entry points import the port inside main(): no import statement of
    # theirs, at any depth, names JAX or the JAX package
    import ast

    for rel in ("examples/run_stereo_torch.py", "examples/batch_sweep_torch.py",
                "examples/eval_ate_torch.py", "tools/collective_audit_torch.py"):
        tree = ast.parse((_repo_root() / rel).read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "gf_orb_slam2_tpu")]
        assert not bad, (rel, bad)


def _repo_root():
    import pathlib

    return pathlib.Path(__file__).resolve().parent.parent


def test_unported_options_raise_instead_of_misbehaving():
    """Every option of the JAX package's System is ported and constructs:
    hashing (one multi-index hash shared by the tracker and the mapper),
    asynchronous mapping and loop closing (the loop closer at once, with the
    shipped vocabulary; the workers with the first keyframe event); a
    tracking entry of another sensor still refuses."""
    cfg = _small_config()
    slam = System(cfg.replace(hashing=tconfig.HashingConfig(enabled=True)), device="cpu")
    assert slam.tracker.mih is not None and slam.tracker.mih is slam.mapper.mih
    assert System(cfg, device="cpu").tracker.mih is None  # hashing off
    for tracking in (tconfig.TrackingConfig(async_mapping=False),
                     tconfig.TrackingConfig(async_mapping=True)):
        slam = System(cfg.replace(loop=tconfig.LoopClosingConfig(), tracking=tracking),
                      device="cpu")
        assert isinstance(slam.loop_closer, LoopCloser) and slam.kfdb is not None
        assert slam.voc.V == 100000 and slam._loop_worker is None
        slam.shutdown()
    assert System(cfg, device="cpu").loop_closer is None  # loop closing off
    slam = System(cfg.replace(tracking=tconfig.TrackingConfig(async_mapping=True)), device="cpu")
    assert slam.cfg.tracking.async_mapping and slam._map_worker is None
    slam.shutdown()
    with pytest.raises(AssertionError):
        System(cfg.replace(sensor=tconfig.Sensor.MONOCULAR), device="cpu").track_stereo(
            np.zeros((H, W), np.uint8), np.zeros((H, W), np.uint8), 0.0)


# ------------------------------------------------------------ host copies
def _fields(cls):
    return [(f.name, str(f.type), _plain(f.default),
             _plain(f.default_factory()) if f.default_factory is not dataclasses.MISSING else None)
            for f in dataclasses.fields(cls)]


def _plain(v):
    if v is dataclasses.MISSING:
        return "<missing>"
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.name, v.value)
    if dataclasses.is_dataclass(v):
        return (type(v).__name__, [(f.name, _plain(getattr(v, f.name)))
                                   for f in dataclasses.fields(v)])
    return v


_CONFIG_CLASSES = [n for n, c in vars(jconfig).items()
                   if isinstance(c, type) and dataclasses.is_dataclass(c)]
_ENUM_CLASSES = [n for n, c in vars(jconfig).items()
                 if isinstance(c, type) and issubclass(c, enum.Enum) and c is not enum.Enum]


@pytest.mark.parametrize("name", _CONFIG_CLASSES)
def test_config_dataclasses_agree_field_for_field(name):
    assert _fields(getattr(tconfig, name)) == _fields(getattr(jconfig, name))


@pytest.mark.parametrize("name", _ENUM_CLASSES)
def test_config_enums_agree(name):
    want = {m.name: m.value for m in getattr(jconfig, name)}
    assert {m.name: m.value for m in getattr(tconfig, name)} == want


def test_config_from_reference_roundtrip():
    jcfg = jconfig.SystemConfig(
        sensor=jconfig.Sensor.STEREO,
        camera=jconfig.CameraConfig(fx=450.0, bf=45.0, dist=(0.1, 0, 0, 0, 0)),
        good_feature=jconfig.GoodFeatureConfig(
            matching_mode=jconfig.GFMatchingMode.BUCKETING, constr_per_frame=99),
        tracking=jconfig.TrackingConfig(local_map_mode=jconfig.LocalMapMode.COMBINED))
    tcfg = convert.config_from_reference(jcfg)
    assert isinstance(tcfg, tconfig.SystemConfig)
    assert isinstance(tcfg.good_feature.matching_mode, tconfig.GFMatchingMode)
    assert _plain(tcfg) == _plain(jcfg)


def _exercise_store(store_cls, cap, rng):
    """The same scripted life on either package's store."""
    n = 32
    s = store_cls(cap, n)

    def kf(i):
        return s.add_keyframe(
            np.eye(3, dtype=np.float32), np.array([0.1 * i, 0, 0], np.float32),
            rng.random((n, 2)).astype(np.float32) * 100,
            rng.integers(0, 8, n).astype(np.int32), rng.random(n).astype(np.float32),
            rng.integers(0, 2**32, (n, 8), dtype=np.uint32),
            rng.random(n).astype(np.float32), rng.random(n).astype(np.float32) + 1,
            np.ones(n, bool), frame_id=i, timestamp=i / 20.0)

    scales = (1.2 ** np.arange(8)).astype(np.float32)
    k0 = kf(0)
    ids = s.add_points_batch(rng.normal(0, 1, (20, 3)).astype(np.float32) + [0, 0, 5],
                             rng.integers(0, 2**32, (20, 8), dtype=np.uint32), k0, k0,
                             np.arange(20))
    s.update_normals_batch(ids, scales)
    s.update_connections(k0)
    k1 = kf(1)
    s.add_observations_batch(ids[:16], k1, np.arange(16))
    ids2 = s.add_points_batch(rng.normal(0, 1, (8, 3)).astype(np.float32) + [0, 0, 4],
                              rng.integers(0, 2**32, (8, 8), dtype=np.uint32), k1, k1,
                              np.arange(16, 24))
    s.update_normals_batch(ids2, scales)
    s.update_connections(k1)
    s.replace_point(int(ids[0]), int(ids[1]))
    s.erase_point(int(ids[2]))
    s.distinctive_descriptor(int(ids[3]))
    s.update_normal_and_depth(int(ids[3]), scales)
    return s, ids


def test_map_store_copy_behaves_like_the_reference():
    cap_j = jconfig.CapacityConfig(max_map_points=64, max_keyframes=8, max_obs_per_point=4)
    cap_t = convert.config_from_reference(cap_j)
    js, jids = _exercise_store(JMapStore, cap_j, np.random.default_rng(0))
    ts, tids = _exercise_store(TMapStore, cap_t, np.random.default_rng(0))
    np.testing.assert_array_equal(tids, jids)
    want, got = convert.store_arrays(js), convert.store_arrays(ts)
    assert set(want) == set(got)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k
    np.testing.assert_array_equal(ts.resolve_replaced(tids), js.resolve_replaced(jids))
    np.testing.assert_array_equal(ts.covisible_kfs(0), js.covisible_kfs(0))
    # and carried over through convert.py it is the same store again
    back = convert.store_from_arrays(cap_t, 32, want)
    for k, v in convert.store_arrays(back).items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert back.add_point(np.zeros(3), np.zeros(8, np.uint32)) == ts.add_point(
        np.zeros(3), np.zeros(8, np.uint32))


def test_evaluation_copy_matches_reference():
    rng = np.random.default_rng(1)
    gt = np.cumsum(rng.normal(0, 0.1, (50, 3)), 0)
    Rz = np.array([[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1]])
    est = (gt @ Rz.T) * 1.1 + [1, 2, 3] + rng.normal(0, 0.01, gt.shape)
    for with_scale in (False, True):
        assert teval.ate_rmse(est, gt, with_scale) == jeval.ate_rmse(est, gt, with_scale)
    assert teval.ate_rmse(est, gt, True) < 0.02
    assert teval.rpe_stats(est, gt) == jeval.rpe_stats(est, gt)

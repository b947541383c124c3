"""The port's multi-index hashing on the CPU against the JAX package's.

- `MultiIndexHashing` through both packages' native libraries on the
  problems of tests/test_hashing.py and on random lives of insert, erase,
  query and online table selection: query outputs element for element,
  table sizes, the OTS active tables and the candidate budget's trajectory,
  all exact (integers);
- the port's library is built from its own source into its own `_build/`
  (named by a hash of source and flags), also when several builders race;
- both Systems on the sequence of
  tests/test_hashing.py::test_tracking_with_hash_local_map (hashing past 100
  points, COMBINED local maps, budgeted matching in its deterministic
  LONG_LIVED mode) assemble the same local pool ids frame by frame;
- with the mapping worker on, every native call holds the store's lock:
  the worker's inserts and table selections, the tracker's queries.
"""
import os
import threading

import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu import config as jc
from gf_orb_slam2_tpu.hashing import mih as jmih
from gf_orb_slam2_tpu_torch import convert
from gf_orb_slam2_tpu_torch.hashing import mih as tmih
from gf_orb_slam2_tpu_torch.system import MAPPING_THREAD, System as TSystem
from tests.synthetic import SyntheticWorld, forward_trajectory, make_frame
from tests.test_hashing import flip_bits

torch.set_num_threads(1)

N_KP = 512
HOST = ("uv", "octave", "angle", "desc", "response", "u_right", "depth", "valid")


def _pair(max_points=10000, **kw):
    jcfg = jc.HashingConfig(enabled=True, **kw)
    return (jmih.MultiIndexHashing(jcfg, max_points),
            tmih.MultiIndexHashing(convert.config_from_reference(jcfg), max_points))


def _jax_table_sizes(m):
    import ctypes

    sizes = np.empty(m.cfg.n_tables, np.int64)
    m._lib.mih_table_sizes(m._h, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return sizes


def _same_state(j, t):
    np.testing.assert_array_equal(t.table_sizes(), _jax_table_sizes(j))
    np.testing.assert_array_equal(t.active_tables, j.active_tables)
    np.testing.assert_array_equal(t.table_utility, j.table_utility)
    assert t.candidate_budget == j.candidate_budget
    assert t.n_queries == getattr(j, "n_queries", 0)


def _query_both(j, t, desc, max_out=None):
    a, b = j.query(desc, max_out), t.query(desc, max_out)
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(b, a)
    return b


# --------------------------------------------------- tests/test_hashing.py
def _exact(j, t, rng):
    desc = rng.integers(0, 2**32, (500, 8), dtype=np.uint32)
    for m in (j, t):
        m.insert(desc, np.arange(500, dtype=np.int32))
    got = _query_both(j, t, desc[:50])
    assert np.isin(np.arange(50), got).all()


def _bit_noise(j, t, rng):
    desc = rng.integers(0, 2**32, (500, 8), dtype=np.uint32)
    for m in (j, t):
        m.insert(desc, np.arange(500, dtype=np.int32))
    got = _query_both(j, t, flip_bits(rng, desc[:100], 4))
    assert np.isin(np.arange(100), got).mean() > 0.85


def _erase(j, t, rng):
    desc = rng.integers(0, 2**32, (10, 8), dtype=np.uint32)
    for m in (j, t):
        m.insert(desc, np.arange(10, dtype=np.int32))
        m.erase(3)
    assert 3 not in _query_both(j, t, desc)


def _bucket_bound(j, t, rng):
    desc = np.zeros((100, 8), np.uint32)  # every table, one bucket
    for m in (j, t):
        m.insert(desc, np.arange(100, dtype=np.int32))
    got = _query_both(j, t, desc[:1], max_out=1000)
    assert len(got) <= 5 * t.n_active
    np.testing.assert_array_equal(got, np.arange(95, 100))  # the newest 5, oldest first


def _budget(j, t, rng):
    for used in (4096, 10, 10, 10, 10, 10, 100000, 0, 3000, 2048, 2049):
        for m in (j, t):
            m.update_dynamics(used)
        assert t.candidate_budget == j.candidate_budget


def _ots_large_map(j, t, rng):
    P = 4096
    desc = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    q = desc[:256].copy()
    q.view(np.uint8).reshape(256, 32)[:, 4:] = rng.integers(0, 256, (256, 28), dtype=np.uint8)
    for m in (j, t):
        m.insert(desc, np.arange(P, dtype=np.int32))
        for _ in range(5):
            m.update_query_scores(q, desc[:256])
        m.update_table_selection()
    assert set(range(4)) <= set(int(x) for x in t.active_tables)
    _same_state(j, t)
    assert _query_both(j, t, desc[:64]).size > 0


PROBLEMS = {"insert_query_exact": (_exact, {}), "query_with_bit_noise": (_bit_noise, {}),
            "erase": (_erase, {}), "bucket_bound": (_bucket_bound, {"max_bucket_size": 5}),
            "candidate_budget_controller": (_budget, {}),
            "ots_utility_selection_large_map": (_ots_large_map, {})}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_test_hashing_problems_agree(name):
    fn, kw = PROBLEMS[name]
    j, t = _pair(**kw)
    fn(j, t, np.random.default_rng(sorted(PROBLEMS).index(name)))
    _same_state(j, t)


@pytest.mark.parametrize("geometry", [(32, 8, 20, 8), (16, 8, 3, 4), (24, 6, 4, 6), (20, 12, 2, 5)])
def test_random_lives_agree(geometry):
    """Random interleavings of insert (ids repeating, so the latest-entry
    dedup and the oldest eviction both fire), erase, query with and without
    a cap, utility updates (skipped by both unless 8-bit substrings) and
    table re-selection, on several table geometries."""
    n_tables, bits, bucket, n_active = geometry
    j, t = _pair(max_points=600, n_tables=n_tables, bits_per_substring=bits,
                 max_bucket_size=bucket, n_active_tables=n_active)
    rng = np.random.default_rng(n_tables * 100 + bits)
    # a small pool of descriptors whose words collide often
    pool = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    pool[32:] = pool[:32] ^ (rng.integers(0, 4, (32, 8)) << rng.integers(0, 30, (32, 8))).astype(np.uint32)
    for step in range(120):
        op = rng.integers(0, 5)
        if op == 0:
            n = int(rng.integers(1, 40))
            rows = rng.integers(0, 64, n)
            ids = rng.integers(-3, 620, n).astype(np.int32)  # out-of-range ids too
            for m in (j, t):
                m.insert(pool[rows], ids)
        elif op == 1:
            pid = int(rng.integers(0, 600))
            for m in (j, t):
                m.erase(pid)
        elif op == 2:
            rows = rng.integers(0, 64, int(rng.integers(1, 20)))
            cap = None if rng.random() < 0.5 else int(rng.integers(1, 50))
            _query_both(j, t, pool[rows], cap)
        elif op == 3:
            rows, other = rng.integers(0, 64, 30), rng.integers(0, 64, 30)
            used = int(rng.integers(0, 5000))
            for m in (j, t):
                m.update_query_scores(pool[rows], pool[other])
                m.update_dynamics(used)
        else:
            for m in (j, t):
                m.update_table_selection()
        _same_state(j, t)
    for m in (j, t):
        m.clear()
    assert _query_both(j, t, pool).size == 0
    _same_state(j, t)


def test_library_is_built_in_the_port_build_dir():
    path = tmih.build()
    here = os.path.dirname(os.path.abspath(tmih.__file__))
    assert os.path.dirname(path) == os.path.join(os.path.dirname(here), "_build")
    assert os.path.basename(path).startswith("libgfslam_mih_") and path.endswith(".so")
    assert tmih.load()._name == path
    assert tmih.SOURCE.endswith(os.path.join("gf_orb_slam2_tpu_torch", "csrc", "mih.cpp"))


def test_concurrent_builders_leave_one_library(tmp_path, monkeypatch):
    """Builders racing on an empty build directory (xdist workers, threads)
    each compile to a name of their own and rename into place: all return
    the same loadable library and leave no temporary file."""
    import ctypes

    monkeypatch.setattr(tmih, "BUILD_DIR", str(tmp_path))
    paths, errors = [], []

    def run():
        try:
            paths.append(tmih.build())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert not errors, errors
    assert len(set(paths)) == 1 and os.listdir(tmp_path) == [os.path.basename(paths[0])]
    assert ctypes.CDLL(paths[0]).mih_create


# ------------------------------------------------------------- the Systems
def _config(async_mapping=False):
    cam = jc.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0)
    return jc.SystemConfig(
        sensor=jc.Sensor.STEREO, camera=cam,
        capacity=jc.CapacityConfig(max_keypoints=N_KP, max_map_points=20000,
                                   max_keyframes=200, max_local_points=2048),
        orb=jc.ORBConfig(n_features=N_KP),
        hashing=jc.HashingConfig(enabled=True, map_size_trigger=100),
        # the mapping worker's run: a keyframe at least every 4 frames
        tracking=jc.TrackingConfig(local_map_mode=jc.LocalMapMode.COMBINED,
                                   async_mapping=async_mapping,
                                   max_frames_between_kf=4 if async_mapping else 30),
        good_feature=jc.GoodFeatureConfig(matching_mode=jc.GFMatchingMode.LONG_LIVED),
        loop=jc.LoopClosingConfig(enabled=False), vocabulary_path="")


def _frames(cfg, n=25):
    world = SyntheticWorld(6000, seed=31)
    out = []
    for i, (R, t) in enumerate(forward_trajectory(n, step=0.1)):
        f = make_frame(world, R, t, cfg.camera, i, n_kp=N_KP)
        out.append(dict({k: np.array(getattr(f, k)) for k in HOST},
                        frame_id=i, timestamp=f.timestamp))
    return out


def _record_pools(tracker):
    got = []
    orig = tracker._gather_local_map

    def run(frame):
        pts = orig(frame)
        got.append((frame.frame_id, None if pts is None else np.array(pts)))
        return pts

    tracker._gather_local_map = run
    return got


def test_systems_assemble_the_same_hashed_pools():
    from gf_orb_slam2_tpu.system import System as JSystem
    from gf_orb_slam2_tpu.tracking.frame import Frame as JFrame

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
    assert ts.tracker.mih is ts.mapper.mih is not None
    jpools, tpools = _record_pools(js.tracker), _record_pools(ts.tracker)
    budgets = []
    for arrays in _frames(jcfg):
        js.track_frame(JFrame(frame_id=arrays["frame_id"], timestamp=arrays["timestamp"],
                              **{k: np.array(arrays[k]) for k in HOST}))
        ts.track_frame(convert.frame_from_arrays(arrays))
        assert ts.state.name == js.state.name
        budgets.append((ts.tracker.mih.candidate_budget, js.tracker.mih.candidate_budget))
    jm, tm = js.tracker.mih, ts.tracker.mih
    assert tm.n_queries > 5, "the hashed assembly never ran"
    assert [f for f, _ in tpools] == [f for f, _ in jpools]
    for (fid, a), (_, b) in zip(jpools, tpools):
        assert (a is None) == (b is None), fid
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=f"frame {fid}")
    assert all(a == b for a, b in budgets), budgets
    np.testing.assert_array_equal(tm.table_sizes(), _jax_table_sizes(jm))
    np.testing.assert_array_equal(tm.active_tables, jm.active_tables)
    np.testing.assert_allclose(tm.table_utility, jm.table_utility, rtol=0, atol=0)
    states = [s.state for s in ts.tracker.stats]
    assert states[1:].count("OK") >= 23, states
    ts.shutdown()
    js.shutdown()


class _LockChecked:
    """The native library seen through a proxy that records, for every
    call, the calling thread's name and whether it held the store's lock."""

    def __init__(self, lib, store, calls):
        self._lib, self._store, self._calls = lib, store, calls

    def __getattr__(self, name):
        fn = getattr(self._lib, name)

        def call(*a):
            self._calls.append((name, threading.current_thread().name,
                                self._store.lock._is_owned()))
            return fn(*a)
        return call


def test_mapping_worker_and_tracker_hold_the_store_lock():
    cfg = convert.config_from_reference(_config(async_mapping=True))
    slam = TSystem(cfg, device="cpu")
    mih = slam.tracker.mih
    calls = []
    mih._lib = _LockChecked(mih._lib, slam.store, calls)
    for arrays in _frames(_config(), n=14):
        slam.track_frame(convert.frame_from_arrays(arrays))
    slam.flush_pipeline()
    assert slam._map_worker is not None and slam._map_worker.n_kf_events >= 2
    by = {(name, th) for name, th, _ in calls}
    assert ("mih_insert", MAPPING_THREAD) in by
    assert ("mih_table_sizes", MAPPING_THREAD) in by
    assert ("mih_query", threading.main_thread().name) in by
    unlocked = [c for c in calls if not c[2]]
    assert not unlocked, unlocked[:5]
    assert all(st.state == "OK" for st in slam.tracker.stats[1:])
    slam.shutdown()
    mih._lib = mih._lib._lib

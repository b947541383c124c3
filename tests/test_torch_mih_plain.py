"""The port's multi-index hash against the plain one (tests/plain_mih.py, a
copy of slambench/reference/mih.py), on the CPU.

- `MultiIndexHashing` (the native tables of csrc/mih.cpp) and the plain
  hash through seeded random lives of insert (ids repeating, so that the
  latest-entry dedup and the oldest-first eviction both fire), erase, query
  (with the online table selection's tables and with none, capped and not),
  table selection and clear: every query's ordered ids, every insert's
  eviction count and the table sizes exactly equal, on three geometries;
- a `System` on a short rendered RGB-D sequence with hashing on and COMBINED
  local maps past a lowered trigger: every native call recorded
  (tools/mih_replay_torch.py) and replayed through the plain hash gives the
  same results, and each frame's hashed pool is its covisibility pool joined
  with the plain hash's answer to that frame's query, less the invalid
  points.
"""
import ctypes
import os

import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu_torch import config as tc
from gf_orb_slam2_tpu_torch.hashing.mih import MultiIndexHashing
from gf_orb_slam2_tpu_torch.system import System
from tests.plain_mih import PlainMIH
from tools.mih_replay_torch import recording, replay

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, F = 240, 320, 225.0


def test_both_copies_of_the_plain_hash_are_one():
    with open(os.path.join(ROOT, "tests", "plain_mih.py")) as a, \
            open(os.path.join(ROOT, "slambench", "reference", "mih.py")) as b:
        assert a.read() == b.read()


def _query_unselected(m, desc, max_out, seen_size):
    """The native query with no table selection (tables 0 .. n_active - 1)."""
    desc = np.ascontiguousarray(desc, np.uint32)
    out = np.empty(max(max_out, 1), np.int32)
    seen = np.zeros(seen_size, np.uint8)
    n = m._lib.mih_query(m._h, desc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(desc),
                         None, m.n_active, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                         max_out, seen.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), seen_size)
    return out[:n].tolist()


@pytest.mark.parametrize("geometry", [(32, 8, 20, 8), (16, 8, 3, 4), (20, 12, 2, 5)])
def test_plain_hash_equals_the_native_one(geometry):
    n_tables, bits, bucket, n_active = geometry
    max_points = 600
    m = MultiIndexHashing(tc.HashingConfig(enabled=True, n_tables=n_tables,
                                           bits_per_substring=bits, max_bucket_size=bucket,
                                           n_active_tables=n_active), max_points)
    ref = PlainMIH(n_tables, bits, bucket)
    rng = np.random.default_rng(n_tables * 100 + bits)
    # a pool of descriptors whose substrings collide often: each bucket fills
    pool = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    pool[32:] = pool[:32] ^ (rng.integers(0, 4, (32, 8))
                             << rng.integers(0, 30, (32, 8))).astype(np.uint32)
    evicted = deduped = queried = 0
    for step in range(160):
        op = rng.integers(0, 6)
        if op <= 1:
            n = int(rng.integers(1, 60))
            rows = rng.integers(0, 64, n)
            ids = rng.integers(-3, 620, n).astype(np.int32)  # out-of-range ids too
            if op == 1:  # the same point again: the latest-entry dedup
                rows[n // 2:], ids[n // 2:] = rows[0], ids[0]
                deduped += n - n // 2
            got = m.insert(pool[rows], ids)
            assert got == ref.insert(pool[rows], ids), step
            evicted += got
        elif op == 2:
            pid = int(rng.integers(0, 600))
            m.erase(pid)
            ref.erase(pid)
        elif op == 3:
            rows = rng.integers(0, 64, int(rng.integers(1, 20)))
            cap = None if rng.random() < 0.5 else int(rng.integers(1, 50))
            got = m.query(pool[rows], cap).tolist()
            want = ref.query(pool[rows], m.active_tables, m.n_active,
                             cap or m.candidate_budget, max_points)
            assert got == want, step
            queried += bool(got)
        elif op == 4:
            rows = rng.integers(0, 64, int(rng.integers(1, 20)))
            cap = int(rng.integers(1, 80))
            assert _query_unselected(m, pool[rows], cap, max_points) == ref.query(
                pool[rows], None, m.n_active, cap, max_points), step
        else:
            rows, other = rng.integers(0, 64, 30), rng.integers(0, 64, 30)
            m.update_query_scores(pool[rows], pool[other])
            m.update_table_selection()
        assert m.table_sizes().tolist() == ref.table_sizes(), step
    assert evicted > 0 and deduped > 0 and queried > 0
    m.clear()
    ref.clear()
    assert m.table_sizes().tolist() == ref.table_sizes() == [0] * n_tables
    assert m.query(pool).size == 0 and ref.query(pool, None, n_active, 100, max_points) == []


# ---------------------------------------------------------- a System's run
def sideways_rgbd_frames(n, shift=48, z=5.0):
    """A long textured slanted plane and its 16-bit depth, the camera moving
    sideways `shift` pixels a frame (tests/test_torch_tracing.py's sequence,
    wider): after a few frames the first keyframes' points are out of view."""
    rng = np.random.default_rng(0)
    tw = W + n * shift
    tex = np.kron(rng.uniform(0, 255, (H // 4, tw // 4 + 1)), np.ones((4, 4)))[:, :tw]
    tex += np.kron(rng.uniform(-40, 40, (H // 2, tw // 2 + 1)), np.ones((2, 2)))[:, :tw]
    tex = np.clip(tex, 0, 255).astype(np.float32)
    depth = ((z + 0.002 * (np.arange(H)[:, None] - H / 2)) * np.ones((H, W))) * 5000.0
    return [(tex[:, i * shift:i * shift + W].copy(), depth.astype(np.uint16)) for i in range(n)]


def hashed_rgbd_config(async_mapping, trigger=300, bucket=3):
    """RGB-D at 320x240 with hashing on (buckets of `bucket`, so that they
    fill on a short run) and COMBINED local maps past `trigger` points; the
    covisibility keyframes stop at the best one's neighbours
    (`max_local_kfs` 3), so that the hash's own points show on a short run."""
    cam = tc.CameraConfig(width=W, height=H, fx=F, fy=F, cx=W / 2, cy=H / 2, bf=F * 0.1,
                          th_depth=60.0, depth_map_factor=5000.0)
    return tc.SystemConfig(
        sensor=tc.Sensor.RGBD, camera=cam, orb=tc.ORBConfig(n_features=600),
        capacity=tc.CapacityConfig(max_keypoints=640, max_map_points=8000, max_keyframes=40,
                                   max_local_kfs=3, max_local_points=4096),
        hashing=tc.HashingConfig(enabled=True, map_size_trigger=trigger, max_bucket_size=bucket),
        tracking=tc.TrackingConfig(local_map_mode=tc.LocalMapMode.COMBINED,
                                   async_mapping=async_mapping, max_frames_between_kf=2),
        loop=tc.LoopClosingConfig(enabled=False), vocabulary_path="")


def test_system_pools_are_covisibility_and_the_plain_hash():
    """Synchronous mapping, so nothing moves the map between a frame's two
    gatherings: the covisibility pool (the same call with the hash taken
    away) and the hashed one."""
    pools = []
    with recording() as made:
        slam = System(hashed_rgbd_config(async_mapping=False), device="cpu")
    tracker = slam.tracker
    gather = tracker._gather_local_map

    def both(frame):
        mih, tracker.mih = tracker.mih, None
        try:
            cov = gather(frame)
        finally:
            tracker.mih = mih
        n_queries = mih.n_queries
        pts = gather(frame)
        if mih.n_queries > n_queries:
            pools.append((frame.frame_id, cov, pts, slam.store.point_valid.copy()))
        return pts

    tracker._gather_local_map = both
    for i, (im, depth) in enumerate(sideways_rgbd_frames(12)):
        slam.track_rgbd(im, depth, i / 30.0)
    slam.shutdown()
    assert all(st.state == "OK" for st in tracker.stats)
    (mih, calls), = made
    assert replay(PlainMIH, mih.cfg, calls)["mismatches"] == 0
    # the plain hash's answer to each query, in order
    ref = PlainMIH(mih.cfg.n_tables, mih.cfg.bits_per_substring, mih.cfg.max_bucket_size)
    answers = []
    for call in calls:
        if call[0] == "insert":
            ref.insert(call[1], call[2])
        elif call[0] == "query":
            answers.append(ref.query(*call[1:6]))
    assert len(answers) == len(pools) >= 5
    assert sum(c[3] for c in calls if c[0] == "insert") > 0  # the buckets filled
    for (fid, cov, pts, valid), ids in zip(pools, answers):
        ids = np.asarray(ids, np.int64)
        ids = ids[(ids >= 0) & (ids < valid.size)]
        want = np.union1d(cov, ids[valid[ids]])
        assert want.size < 4096  # no cap on the pool
        np.testing.assert_array_equal(pts, want, err_msg=f"frame {fid}")
    # the hash added points once the first keyframes left the view
    assert sum(np.setdiff1d(pts, cov).size > 0 for _, cov, pts, _ in pools) >= 3

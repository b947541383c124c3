"""The port's pipelined driver on the CPU: the device map mirror against the
store, the mapping worker's batch accounting, and `track_stereo_pipelined`
with and without the asynchronous mapper — against the port's synchronous
run, through a flush in mid-stream and through a reset with frames in
flight.

Scene: the rendered room tour at 320x240, 600 features, sampled at 900
frames over the tour (a third of the headline tour's motion per frame). At
the 300-frame spacing the JAX package's own pipelined run departs from its
synchronous run by up to 0.108 m on the first 16 frames (the port: 0.101 m;
both on the CPU), because the pipelined step reads a pool gathered three
frames earlier. At the 900-frame spacing the port's pipelined run stays
within 0.039 m of its synchronous run (the JAX package's within 0.060 m), so
the check of the JAX package's tests/test_streaming.py — camera centres
within 0.05 m — is applied there.
"""
import threading

import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu_torch import config as tconfig
from gf_orb_slam2_tpu_torch.io.evaluation import ate_rmse
from gf_orb_slam2_tpu_torch.slammap.device_mirror import DeviceMapMirror
from gf_orb_slam2_tpu_torch.slammap.store import MapStore
from gf_orb_slam2_tpu_torch.system import System, _MappingWorker
from gf_orb_slam2_tpu_torch.tracking import tracker as ttracker
from tests.rendered_world import RoomWorld, trajectory_tour

torch.set_num_threads(1)

H, W, F = 240, 320, 225.0
N_FRAMES = 16
TOUR = 900


# ------------------------------------------------------------------ mirror
def _mirror_equals_store(mirror, store):
    host = dict(pos=store.point_pos, normal=store.point_normal,
                mind=store.point_min_dist, maxd=store.point_max_dist,
                desc=store.point_desc.view(np.int32))
    for k, a in host.items():
        np.testing.assert_array_equal(mirror.arrays[k].numpy(), a, err_msg=k)


def _keyframe(s, rng, i, n):
    return s.add_keyframe(
        np.eye(3, dtype=np.float32), np.array([0.2 * i, 0, 0], np.float32),
        (rng.random((n, 2)) * 300).astype(np.float32),
        rng.integers(0, 8, n).astype(np.int32), rng.random(n).astype(np.float32),
        rng.integers(0, 2**32, (n, 8), dtype=np.uint32),
        rng.random(n).astype(np.float32), rng.random(n).astype(np.float32) + 1,
        np.ones(n, bool), frame_id=i, timestamp=i / 20.0)


def test_mirror_equals_store_after_every_kind_of_write():
    """Adds, batch adds, descriptor and normal/depth refreshes (one point and
    batched) and a BA-style write-back of positions, each followed by a
    sync: the mirror equals the store on every row, the last slot included."""
    from gf_orb_slam2_tpu_torch.mapping.batch_ops import refresh_points_batch

    rng = np.random.default_rng(0)
    cap = tconfig.CapacityConfig(max_map_points=48, max_keyframes=4, max_obs_per_point=4)
    s = MapStore(cap, 32)
    scales = (1.2 ** np.arange(8)).astype(np.float32)
    k0 = _keyframe(s, rng, 0, 32)
    with s.lock:
        s.mirror = DeviceMapMirror(s, "cpu")
    m = s.mirror
    _mirror_equals_store(m, s)

    ids = s.add_points_batch(rng.normal(0, 1, (30, 3)).astype(np.float32) + [0, 0, 5],
                             rng.integers(0, 2**32, (30, 8), dtype=np.uint32), k0, k0,
                             np.arange(30))
    assert m.dirty[ids].all()
    m.sync()
    assert not m.dirty.any()
    _mirror_equals_store(m, s)

    k1 = _keyframe(s, rng, 1, 32)
    s.add_observations_batch(ids[:20], k1, np.arange(20))
    s.update_normals_batch(ids, scales)
    m.sync()
    _mirror_equals_store(m, s)

    # single adds up to the last slot of the store
    last = [s.add_point(rng.normal(0, 1, 3), rng.integers(0, 2**32, 8, dtype=np.uint32),
                        first_kf=k1) for _ in range(18)]
    assert cap.max_map_points - 1 in last
    m.sync()
    _mirror_equals_store(m, s)

    s.distinctive_descriptor(int(ids[3]))
    s.update_normal_and_depth(int(ids[3]), scales)
    refresh_points_batch(s, ids[:20], scales)
    m.sync()
    _mirror_equals_store(m, s)

    # a BA-style write-back: positions moved under the lock, then marked
    with s.lock:
        s.point_pos[ids[5:15]] += 0.25
        s.mark_dirty(ids[5:15])
    m.sync()
    _mirror_equals_store(m, s)
    m.sync()  # nothing dirty: a no-op
    _mirror_equals_store(m, s)


def test_mirror_sync_racing_writers_loses_no_row():
    """Writer threads (more than cores) move points and mark them while
    syncs run on other threads, with a short switch interval: after a last
    sync the mirror equals the store, so no write was lost between a sync's
    gather and its clearing of the dirty bits."""
    import os
    import sys

    rng = np.random.default_rng(1)
    cap = tconfig.CapacityConfig(max_map_points=256, max_keyframes=2, max_obs_per_point=2)
    s = MapStore(cap, 8)
    with s.lock:
        s.mirror = DeviceMapMirror(s, "cpu")
    n_writers = (os.cpu_count() or 1) + 2
    stop = threading.Event()

    def write(seed):
        r = np.random.default_rng(seed)
        for _ in range(200):
            ids = r.integers(0, 256, 16)
            with s.lock:
                s.point_pos[ids] = r.normal(0, 1, (16, 3)).astype(np.float32)
                s.point_desc[ids] = r.integers(0, 2**32, (16, 8), dtype=np.uint32)
                s.mark_dirty(ids)

    def sync():
        while not stop.is_set():
            s.mirror.sync()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        syncers = [threading.Thread(target=sync) for _ in range(2)]
        writers = [threading.Thread(target=write, args=(int(rng.integers(1 << 30)),))
                   for _ in range(n_writers)]
        for t in syncers + writers:
            t.start()
        for t in writers:
            t.join(120)
        stop.set()
        for t in syncers:
            t.join(120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in syncers + writers)
    s.mirror.sync()
    _mirror_equals_store(s.mirror, s)


def test_pool_gather_of_an_empty_slot_is_invalid_and_never_the_last_row():
    arrays = {"pos": torch.arange(12, dtype=torch.float32).reshape(4, 3),
              "desc": torch.arange(32, dtype=torch.int32).reshape(4, 8)}
    rows, valid = ttracker.gather_pool(arrays, torch.tensor([3, -1, 0, -1]))
    assert valid.tolist() == [True, False, True, False]
    assert torch.equal(rows["pos"][1], arrays["pos"][0])
    assert not torch.equal(rows["pos"][1], arrays["pos"][3])
    assert torch.equal(rows["desc"][0], arrays["desc"][3])


# ------------------------------------------------------------------ worker
class _StubSystem:
    """What the worker needs of a System: a device and `_on_keyframe`."""

    def __init__(self, on_keyframe):
        self.device = torch.device("cpu")
        self._on_keyframe = on_keyframe


def test_worker_merges_a_backlog_into_one_batch():
    """The first KF blocks the worker until three more are queued; those
    three then run as one batch with the window BA on the newest only."""
    calls, started, go = [], threading.Event(), threading.Event()

    def on_keyframe(k, skip_ba=False):
        calls.append((k, skip_ba))
        if k == 0:
            started.set()
            assert go.wait(60)

    worker = _MappingWorker(_StubSystem(on_keyframe))
    worker.submit(0)
    assert started.wait(60)  # KF 0 is being processed …
    for k in (1, 2, 3):
        worker.submit(k)
    assert worker.queue_depth() == 3  # … while 1-3 wait
    go.set()
    worker.wait_idle()
    assert calls == [(0, False), (1, True), (2, True), (3, False)]
    assert worker.max_batch == 3
    assert worker.n_kf_events == 4
    assert (worker.n_ba_runs, worker.n_ba_merged) == (2, 2)
    assert worker.n_ba_runs + worker.n_ba_merged == worker.n_kf_events
    worker.stop()


def test_worker_error_surfaces_at_wait_idle():
    def on_keyframe(k, skip_ba=False):
        raise ValueError(f"mapping failed on KF {k}")

    worker = _MappingWorker(_StubSystem(on_keyframe))
    worker.submit(7)
    with pytest.raises(ValueError, match="KF 7"):
        worker.wait_idle()
    worker.wait_idle()  # reported once
    worker.stop()


# ------------------------------------------------------------------ system
def _config(async_mapping):
    cam = tconfig.CameraConfig(width=W, height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
                               bf=F * 0.1, th_depth=40.0)
    return tconfig.SystemConfig(
        sensor=tconfig.Sensor.STEREO, camera=cam,
        orb=tconfig.ORBConfig(n_features=600),
        capacity=tconfig.CapacityConfig(max_keypoints=640, max_map_points=8000,
                                        max_keyframes=40, max_local_points=1024),
        tracking=tconfig.TrackingConfig(async_mapping=async_mapping, pipeline_depth=3),
        loop=tconfig.LoopClosingConfig(enabled=False))


@pytest.fixture(scope="module")
def frames():
    world = RoomWorld(width=9.0, height=5.5, length=13.0)
    poses = trajectory_tour(TOUR)[:N_FRAMES]
    imgs = [world.render_stereo(R, t, baseline=0.1, fx=F, fy=F, cx=W / 2, cy=H / 2,
                                w=W, h=H) for R, t in poses]
    return imgs, np.stack([-R.T @ t for R, t in poses])


def _center(T):
    return -T[:3, :3].T @ T[:3, 3]


def _pipelined(slam, imgs, start, results):
    for i, (left, right) in enumerate(imgs, start=start):
        for fid, T in slam.track_stereo_pipelined(left, right, i / 20.0):
            assert fid not in results, f"frame {fid} returned twice"
            results[fid] = T


def _flush(slam, results):
    for fid, T in slam.flush_pipeline():
        assert fid not in results, f"frame {fid} returned twice"
        results[fid] = T


def test_pipelined_matches_the_synchronous_run(frames):
    """Every frame id comes back exactly once, the stream path serves the
    frames after the two synchronous ones, and every camera centre is within
    0.05 m of the synchronous run's."""
    imgs, gt = frames
    sync = System(_config(False), device="cpu")
    want = [sync.track_stereo(left, right, i / 20.0) for i, (left, right) in enumerate(imgs)]
    slam = System(_config(False), device="cpu")
    got = {}
    _pipelined(slam, imgs, 0, got)
    _flush(slam, got)
    assert sorted(got) == list(range(N_FRAMES))
    stats = slam.tracker.stats
    assert [s.state for s in stats] == ["OK"] * N_FRAMES
    assert sum(s.path == "stream" for s in stats) >= N_FRAMES - 3
    assert slam.n_stream_fallbacks == 0
    dc = [np.linalg.norm(_center(got[i]) - _center(want[i])) for i in range(N_FRAMES)]
    print("centre differences", np.round(dc, 4))
    assert max(dc[2:]) < 0.05
    # every keyframe event of the pipelined run went through the mapper
    assert [st.kf for st in slam.mapper.stats] == list(range(slam.store.n_keyframes))
    slam.shutdown()
    sync.shutdown()


def test_async_flush_midstream_then_continue(frames):
    """Asynchronous mapping: a flush after 8 frames returns the frames in
    flight and leaves the mirror equal to the store; streaming then
    re-bootstraps and every frame id comes back exactly once. The worker's
    events are the tracker's keyframes, each BA run or merged."""
    imgs, gt = frames
    slam = System(_config(True), device="cpu")
    got = {}
    _pipelined(slam, imgs[:8], 0, got)
    _flush(slam, got)
    assert sorted(got) == list(range(8))
    slam.store.mirror.sync()
    _mirror_equals_store(slam.store.mirror, slam.store)
    _pipelined(slam, imgs[8:14], 8, got)
    _flush(slam, got)
    assert sorted(got) == list(range(14))
    assert [s.state for s in slam.tracker.stats] == ["OK"] * 14
    n_kf = sum(bool(s.created_kf) for s in slam.tracker.stats)
    w = slam._map_worker  # every keyframe went through it, the first included
    assert w.n_kf_events == n_kf == len(slam.mapper.stats) > 2
    assert w.n_ba_runs + w.n_ba_merged == w.n_kf_events
    est = np.stack([_center(got[i]) for i in range(14)])
    assert np.isfinite(est).all() and ate_rmse(est, gt[:14]) < 0.08
    slam.shutdown()
    assert slam._map_worker is None


def test_async_reset_with_frames_in_flight(frames):
    """A reset while frames are in flight and keyframes may be queued: the
    tracker restarts, every later frame has a finite pose and the map
    rebuilds with finite poses and points."""
    imgs, _ = frames
    slam = System(_config(True), device="cpu")
    got = {}
    _pipelined(slam, imgs[:7], 0, got)
    assert slam._inflight  # frames still in flight
    slam.reset()
    assert slam.store.n_keyframes == 0 and not slam._inflight
    assert slam.store.mirror is None
    post = {}
    _pipelined(slam, imgs[7:14], 7, post)
    _flush(slam, post)
    assert sorted(post) == list(range(7, 14))
    assert all(np.isfinite(T).all() for T in post.values())
    s = slam.store
    kfs = s.valid_kf_ids()
    assert kfs.size >= 1
    assert np.isfinite(s.kf_R[kfs]).all() and np.isfinite(s.kf_t[kfs]).all()
    assert np.isfinite(s.point_pos[s.point_valid]).all()
    assert sum(st.path == "stream" for st in slam.tracker.stats[-7:]) >= 4
    slam.shutdown()

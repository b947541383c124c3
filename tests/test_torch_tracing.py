"""The port's tracer (gf_orb_slam2_tpu_torch/utils/tracing.py) on the CPU.

Spans nest on their own thread and inherit the frame id; off, nothing is
recorded and no profiler range is entered; on through `enable()` or while a
torch profiler records, whose ranges lie inside the spans on one clock; the
buffer keeps the newest spans and counts the dropped. The counters: the
transfers of utils/transfer.py (one blocking download on a fused frame of a
short RGB-D System run, upload bytes as packed) and the hand kernels'
launches under their old names. The mapper's and the loop closer's
`event_ms` are their spans' durations.
"""
import contextlib
import sys
import threading

import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu_torch import config as tc
from gf_orb_slam2_tpu_torch.loopclosing.loop_closer import STAGES, LoopCloser
from gf_orb_slam2_tpu_torch.ops import cuda_lib, hamming_cuda
from gf_orb_slam2_tpu_torch.place.keyframe_db import KeyFrameDatabase
from gf_orb_slam2_tpu_torch.place.vocabulary import Vocabulary
from gf_orb_slam2_tpu_torch.slammap.store import MapStore
from gf_orb_slam2_tpu_torch.system import MAPPING_THREAD, VOCAB_DIR, System
from gf_orb_slam2_tpu_torch.utils import tracing, transfer

torch.set_num_threads(1)

H, W, F = 240, 320, 225.0


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


# ------------------------------------------------------------------ spans
def test_nesting_parents_and_frame_ids_on_each_thread():
    tracing.enable()

    def work(frame):
        with tracing.span("outer", frame=frame) as o:
            with tracing.span("mid"):
                with tracing.span("inner", kf=frame + 100):
                    pass
            with tracing.span("sibling", frame=-1):
                pass
        return o

    outer = work(3)
    box = {}
    worker = threading.Thread(target=lambda: box.update(o=work(7)), name="worker")
    worker.start()
    worker.join()
    tracing.disable()
    sp = tracing.spans()
    assert len(sp) == 8
    for thread, o, frame in (("MainThread", outer, 3), ("worker", box["o"], 7)):
        mine = by_name([s for s in sp if s.thread == thread])
        (mid,), (inner,), (sib,) = mine["mid"], mine["inner"], mine["sibling"]
        assert mine["outer"] == [o] and o.parent is None and o.attrs == {"frame": frame}
        assert mid.parent == o.id and inner.parent == mid.id and sib.parent == o.id
        # inherited from the span around, unless given
        assert mid.attrs == {"frame": frame}
        assert inner.attrs == {"frame": frame, "kf": frame + 100}
        assert sib.attrs == {"frame": -1}
        assert o.start_ns <= mid.start_ns <= inner.start_ns <= inner.end_ns <= mid.end_ns
        assert mid.end_ns <= sib.start_ns <= sib.end_ns <= o.end_ns
        assert o.child_ns == (mid.end_ns - mid.start_ns) + (sib.end_ns - sib.start_ns)
    assert len({s.id for s in sp}) == 8


def counting_ranges(monkeypatch):
    """Count the profiler ranges the tracer opens."""
    calls = []
    real = torch._C._profiler._RecordFunctionFast

    def rf(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", rf)
    return calls


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    calls = counting_ranges(monkeypatch)
    assert not tracing.is_on()
    with tracing.span("a", frame=1) as a, tracing.entry("frame", frame=1) as e:
        pass
    assert a is e  # one shared do-nothing span: nothing allocated per call
    with tracing.timed("t") as t:
        with tracing.timed("child"):
            pass
    tracing.record("q", 0, 1)
    assert tracing.spans() == [] and calls == []
    # a timed span measures all the same, with its children
    assert t.ms >= t.child_ms > 0 and set(t.kids) == {"child"} and t.id is None


def test_on_through_enable_records_without_ranges(monkeypatch):
    calls = counting_ranges(monkeypatch)
    tracing.enable()
    with tracing.span("a"):
        with tracing.timed("b"):
            pass
    tracing.record("q", 5, 9, kf=2)
    tracing.disable()
    sp = tracing.spans()
    assert [s.name for s in sp] == ["b", "a", "q"] and calls == []
    assert (sp[2].start_ns, sp[2].end_ns, sp[2].attrs, sp[2].parent) == (5, 9, {"kf": 2}, None)
    with tracing.span("after"):
        pass
    assert len(tracing.spans()) == 3


def test_a_recording_profiler_turns_spans_on_and_shares_their_clock(monkeypatch):
    calls = counting_ranges(monkeypatch)
    with tracing.span("warm"):  # off: not recorded
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch._C._profiler._RecordFunctionFast("warm-up"):  # the first call
            pass
        for i in range(5):
            with tracing.span(f"s{i}"):
                with tracing.span(f"c{i}"):
                    torch.ones(256).sum()
    assert not tracing.is_on()
    sp = {s.name: s for s in tracing.spans()}
    assert set(sp) == {f"{p}{i}" for p in "sc" for i in range(5)}
    assert sorted(calls) == sorted([*sp, "warm-up"])
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name() in sp}
    assert set(events) == set(sp)
    for name, s in sp.items():
        e = events[name]
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        # a host range (not a user annotation, which the profiler mirrors
        # onto the device's timeline), inside its span, each end within
        # 200 µs of it
        assert not e.is_user_annotation()
        assert s.start_ns <= start <= end <= s.end_ns, name
        assert start - s.start_ns < 200_000 and s.end_ns - end < 200_000, name


def test_the_buffer_keeps_the_newest_and_counts_the_dropped():
    tracing.enable()
    n = tracing.MAX_SPANS + 10
    for i in range(n):
        with tracing.span("s", i=i):
            pass
    sp = tracing.spans()
    assert len(sp) == tracing.MAX_SPANS and tracing.dropped() == 10
    assert sp[0].attrs["i"] == 10 and sp[-1].attrs["i"] == n - 1
    sp.clear()  # a copy
    assert len(tracing.spans()) == tracing.MAX_SPANS
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_threads_lose_no_span_and_no_count():
    """More threads than cores, switching often: every span is recorded
    once and every count lands."""
    n_threads, n = 16, 400
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tracing.enable()
    try:
        def work():
            for i in range(n):
                with tracing.span("s", i=i):
                    tracing.count("stress")
                    tracing.count("stress.bytes", 3)

        threads = [threading.Thread(target=work, name="stress") for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        tracing.disable()
    sp = tracing.spans()
    assert len(sp) == n_threads * n and len({s.id for s in sp}) == n_threads * n
    c = tracing.counters("stress")
    assert c["stress"] == n_threads * n and c["stress.bytes"] == 3 * n_threads * n
    tracing.reset_counters("stress")
    assert "stress" not in tracing.counters("stress")


# --------------------------------------------------------------- counters
def padded(*arrays):
    return sum(-(-np.asarray(a).nbytes // 16) * 16 for a in arrays)


def test_transfer_counters():
    me = threading.current_thread().name
    before = tracing.counters(me)
    a = np.arange(7, dtype=np.float32)
    b = np.ones((3, 5), np.uint8)
    d = transfer.to_device(dict(a=a, b=b), "cpu")
    transfer.upload(np.zeros(3, np.int64), "cpu")
    host = transfer.to_host(d)
    after = tracing.counters(me)
    delta = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    assert delta == {"h2d.copies": 2, "h2d.bytes": padded(a, b) + 24,
                     "d2h.syncs": 1, "d2h.bytes": a.nbytes + b.nbytes}
    np.testing.assert_array_equal(host["b"], b)
    # other threads count apart
    worker = threading.Thread(target=lambda: transfer.to_host(d), name="counting")
    worker.start()
    worker.join()
    assert tracing.counters("counting")["d2h.syncs"] == 1
    assert tracing.counters(me)["d2h.syncs"] == after["d2h.syncs"]


def test_launch_counts_keep_their_names(monkeypatch):
    names = ["hamming_distance_matrix", "hamming_masked_best2", "pose_lm", "greedy_select",
             "obs_info"]
    assert hamming_cuda.launch_counts is cuda_lib.launch_counts
    assert hamming_cuda.reset_launch_counts is cuda_lib.reset_launch_counts
    cuda_lib.reset_launch_counts()
    assert list(cuda_lib.launch_counts) == names
    assert cuda_lib.launch_counts == dict.fromkeys(names, 0)
    assert cuda_lib.thread_launch_counts("nobody") == dict.fromkeys(names, 0)

    class Lib:
        def pose_lm_launch(self, *args):
            return 0

    class Stream:
        cuda_stream = 0

    # `launch` without a card: the library, device and stream stood in for
    monkeypatch.setattr(cuda_lib, "load", Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    cuda_lib.launch("pose_lm", "pose_lm_launch", "cuda")
    worker = threading.Thread(target=lambda: cuda_lib.launch("pose_lm", "pose_lm_launch", "cuda"),
                              name=MAPPING_THREAD)
    worker.start()
    worker.join()
    assert cuda_lib.launch_counts["pose_lm"] == 2 and dict(cuda_lib.launch_counts)["pose_lm"] == 2
    assert cuda_lib.thread_launch_counts(MAPPING_THREAD)["pose_lm"] == 1
    me = threading.current_thread().name
    assert cuda_lib.thread_launch_counts(me) == dict(dict.fromkeys(names, 0), pose_lm=1)
    cuda_lib.reset_launch_counts()
    assert cuda_lib.launch_counts == dict.fromkeys(names, 0)
    assert cuda_lib.thread_launch_counts(MAPPING_THREAD)["pose_lm"] == 0


def test_frame_spans_count_the_selection_kernels_launches(monkeypatch):
    """A `frame` span's `obs_info_launches` delta counts the launches of the
    selection's information-matrix kernel inside it, apart from the other
    kernels' (`launches` counts them all; a stand-in library and stream)."""
    class Lib:
        def obs_info_launch(self, *args):
            return 0

        def pose_lm_launch(self, *args):
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(cuda_lib, "load", Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    tracing.enable()
    with tracing.entry("frame", frame=0):
        cuda_lib.launch("obs_info", "obs_info_launch", "cuda")
        cuda_lib.launch("pose_lm", "pose_lm_launch", "cuda")
    with tracing.entry("frame", frame=1):
        cuda_lib.launch("pose_lm", "pose_lm_launch", "cuda")
    tracing.disable()
    frames = [s for s in tracing.spans() if s.name == "frame"]
    assert [(f.attrs["obs_info_launches"], f.attrs["launches"]) for f in frames] == [(1, 2),
                                                                                      (0, 1)]
    cuda_lib.reset_launch_counts()


# ------------------------------------------------------- a short System run
def rgbd_frames(n, step=0.02, z=5.0):
    """A textured slanted plane and its 16-bit depth, the camera moving
    sideways (tests/test_rgbd.py's sequence, without OpenCV)."""
    rng = np.random.default_rng(0)
    tex = np.kron(rng.uniform(0, 255, (H // 4, (W + 120) // 4)), np.ones((4, 4)))
    tex += np.kron(rng.uniform(-40, 40, (H // 2, (W + 120) // 2)), np.ones((2, 2)))
    tex = np.clip(tex, 0, 255).astype(np.float32)
    depth = ((z + 0.002 * (np.arange(H)[:, None] - H / 2)) * np.ones((H, W))) * 5000.0
    return [(tex[:, round(F * i * step / z):][:, :W].copy(), depth.astype(np.uint16))
            for i in range(n)]


@pytest.fixture(scope="module")
def traced_rgbd():
    """Eight RGB-D frames through `track_rgbd`, a KF every two frames mapped
    on the mapping worker, with tracing on."""
    cam = tc.CameraConfig(width=W, height=H, fx=F, fy=F, cx=W / 2, cy=H / 2, bf=F * 0.1,
                          th_depth=60.0, depth_map_factor=5000.0)
    cfg = tc.SystemConfig(
        sensor=tc.Sensor.RGBD, camera=cam, orb=tc.ORBConfig(n_features=600),
        capacity=tc.CapacityConfig(max_keypoints=640, max_map_points=8000, max_keyframes=40,
                                   max_local_points=1024),
        tracking=tc.TrackingConfig(async_mapping=True, max_frames_between_kf=2),
        loop=tc.LoopClosingConfig(enabled=False), vocabulary_path="")
    frames = rgbd_frames(8)
    slam = System(cfg, device="cpu")
    tracing.clear()
    tracing.enable()
    try:
        for i, (im, depth) in enumerate(frames):
            slam.track_rgbd(im, depth, i / 30.0)
        slam.flush_pipeline()
    finally:
        tracing.disable()
    sp = tracing.spans()
    slam.shutdown()
    return slam, frames, sp


def test_frame_spans_count_one_sync_a_fused_frame(traced_rgbd):
    slam, frames, sp = traced_rgbd
    entries = [s for s in sp if s.name == "frame"]
    assert [s.attrs["frame"] for s in entries] == list(range(len(frames)))
    paths = [st.path for st in slam.tracker.stats]
    assert paths.count("fused") >= 4
    im, depth = frames[0]
    for e, path in zip(entries, paths):
        if path == "fused":
            assert e.attrs["syncs"] == 1 and e.attrs["launches"] == 0
            assert e.attrs["obs_info_launches"] == 0
            # the frame's packed upload, the pool's and the step's own arrays
            assert e.attrs["uploads"] == 10
        assert e.attrs["upload_bytes"] >= padded(im.astype(np.uint8), depth.astype(np.float32))
    # the init frame uploads the image and the depth map in one copy, and
    # downloads the frontend's arrays once
    assert entries[0].attrs["uploads"] == 1 and entries[0].attrs["syncs"] == 1
    assert entries[0].attrs["upload_bytes"] == padded(im.astype(np.uint8),
                                                      depth.astype(np.float32))
    # the tracking step's children, each inside its frame and inheriting its id
    ids = {s.id: s for s in sp}
    for s in sp:
        if s.name.startswith(("track.", "frontend.")):
            top = s
            while top.parent is not None:
                top = ids[top.parent]
            assert top.name == "frame" and s.attrs["frame"] == top.attrs["frame"], s
    steps = [s for s in sp if s.name == "track.step"]
    assert len(steps) == len(frames)
    names = {s.name for s in sp}
    assert {"track.prepare", "track.dispatch", "track.select", "track.fetch",
            "track.associate", "track.local_pool", "track.keyframe", "frontend.upload",
            "frontend.extract", "track.init"} <= names


def test_worker_spans_carry_their_keyframe(traced_rgbd):
    slam, frames, sp = traced_rgbd
    events = [s for s in sp if s.name == "map.event"]
    assert len(events) == len(slam.mapper.event_ms) >= 3
    s = slam.store
    queued = {q.attrs["kf"]: q for q in sp if q.name == "map.queued"}
    for ev in events:
        kf = ev.attrs["kf"]
        assert ev.thread == MAPPING_THREAD and ev.parent is None
        assert ev.attrs["frame"] == s.kf_frame_id[kf] and ev.attrs["skip_ba"] in (True, False)
        q = queued[kf]
        assert q.thread == MAPPING_THREAD and q.start_ns <= q.end_ns <= ev.start_ns
    stages = [x for x in sp if x.name.startswith("map.") and x.name not in ("map.event",
                                                                              "map.queued")]
    ids = {x.id: x for x in sp}
    for x in stages:
        assert x.thread == MAPPING_THREAD and "kf" in x.attrs and "frame" in x.attrs
        up = ids[x.parent]
        assert up.name in ("map.event", "map.triangulate_fuse", "map.local_ba")
    assert any(x.name == "map.writeback" for x in stages)


def test_mapper_event_ms_is_its_spans_durations(traced_rgbd):
    slam, frames, sp = traced_rgbd
    events = [s for s in sp if s.name == "map.event"]
    ids = {s.id: s for s in sp}
    for ev, row in zip(events, slam.mapper.event_ms):
        assert set(row) == {"refresh", "triangulate_fuse", "local_ba", "writeback", "cull",
                            "hash"}
        kids = {s.name: s for s in sp if s.parent == ev.id}
        assert set(kids) == {"map.refresh", "map.triangulate_fuse", "map.local_ba",
                             "map.cull", "map.hash"}
        wb = [s for s in sp if s.name == "map.writeback" and ids[s.parent].parent == ev.id]
        assert row["refresh"] == kids["map.refresh"].ms
        assert row["cull"] == kids["map.cull"].ms and row["hash"] == kids["map.hash"].ms
        assert row["triangulate_fuse"] == kids["map.triangulate_fuse"].self_ms
        assert row["local_ba"] == kids["map.local_ba"].self_ms
        assert row["writeback"] == pytest.approx(sum(s.ms for s in wb), abs=1e-9)
    assert any(row["writeback"] > 0 for row in slam.mapper.event_ms)


def test_loop_closer_event_ms_is_its_spans_durations():
    from tests.test_torch_loop_closing import N_KF, N_KP, build_loop_store

    cam = tc.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0, th_depth=40.0)
    cap = tc.CapacityConfig(max_keypoints=N_KP, max_map_points=20000, max_keyframes=48,
                            max_local_points=2048)
    cfg = tc.SystemConfig(camera=cam, capacity=cap, orb=tc.ORBConfig(n_features=N_KP),
                          loop=tc.LoopClosingConfig(synchronous_gba=True))
    store, _ = build_loop_store(MapStore, cap, cam)
    lc = LoopCloser(cfg, store, KeyFrameDatabase(Vocabulary.load(f"{VOCAB_DIR}/vocab10k.npz"),
                                                 store), device="cpu")
    tracing.enable()
    for k in range(N_KF):
        lc.process_keyframe(k)
    tracing.disable()
    sp = tracing.spans()
    events = [s for s in sp if s.name == "loop.event"]
    assert len(events) == len(lc.event_ms) == N_KF
    assert any(st.corrected for st in lc.stats)
    for ev, row, st in zip(events, lc.event_ms, lc.stats):
        assert set(row) == set(STAGES)
        assert ev.attrs == {"kf": st.kf, "frame": store.kf_frame_id[st.kf]}
        kids = [s for s in sp if s.parent == ev.id]
        for stage in STAGES:
            mine = [s.end_ns - s.start_ns for s in kids if s.name == "loop." + stage]
            assert row[stage] == sum(mine) / 1e6, stage
        if st.corrected:
            assert all(row[k] > 0 for k in STAGES)
            assert any(s.name == "gba.run" and s.attrs["kf"] == st.kf for s in sp)


# ------------------------------------------------------ the hashed local map
@pytest.fixture(scope="module")
def traced_hashed_rgbd():
    """tests/test_torch_mih_plain.py's hashed RGB-D run (COMBINED past 300
    points, buckets of 3) through `track_rgbd` with the mapping worker on,
    tracing on and the hash's native calls recorded."""
    from tests.test_torch_mih_plain import hashed_rgbd_config, sideways_rgbd_frames
    from tools.mih_replay_torch import recording

    with recording() as made:
        slam = System(hashed_rgbd_config(async_mapping=True), device="cpu")
    tracing.clear()
    tracing.enable()
    try:
        for i, (im, depth) in enumerate(sideways_rgbd_frames(12)):
            slam.track_rgbd(im, depth, i / 30.0)
        slam.flush_pipeline()
    finally:
        tracing.disable()
    sp = tracing.spans()
    slam.shutdown()
    (mih, calls), = made
    return slam, sp, mih, calls


def test_hash_spans_on_every_frame_past_the_trigger(traced_hashed_rgbd):
    slam, sp, mih, calls = traced_hashed_rgbd
    ids = {s.id: s for s in sp}
    frames = [s for s in sp if s.name == "frame"]
    hashed = [s for s in sp if s.name == "track.hash"]
    scores = [s for s in sp if s.name == "track.hash_scores"]
    assert len(hashed) == mih.n_queries == sum(c[0] == "query" for c in calls)
    by_frame = {}
    for s in hashed + scores:
        top = s
        while top.parent is not None:
            top = ids[top.parent]
        assert top.name == "frame" and top.attrs["frame"] == s.attrs["frame"]
        by_frame.setdefault(s.name, []).append(s.attrs["frame"])
    # from the first frame past the trigger on, each frame queries and scores
    first = min(by_frame["track.hash"])
    later = [f.attrs["frame"] for f in frames if f.attrs["frame"] >= first]
    assert len(later) >= 10
    assert set(by_frame["track.hash"]) == set(by_frame["track.hash_scores"]) == set(later)
    queries = [c for c in calls if c[0] == "query"]
    for s, q in zip(hashed, queries):
        assert set(s.attrs) == {"frame", "queried", "candidates", "added", "budget"}
        assert s.attrs["queried"] == len(q[1]) and s.attrs["budget"] == q[4]
        assert s.attrs["candidates"] == len(q[6])
        assert ids[s.parent].name in ("track.local_pool", "track.local_map")
    assert sum(s.attrs["added"] > 0 for s in hashed) >= 3


def test_frame_spans_carry_the_hash_counters(traced_hashed_rgbd):
    slam, sp, mih, calls = traced_hashed_rgbd
    ids = {s.id: s for s in sp}
    want = {}
    for s in sp:
        if s.name == "track.hash":
            top = s
            while top.parent is not None:
                top = ids[top.parent]
            got = want.setdefault(top.id, [0, 0])
            got[0] += s.attrs["candidates"]
            got[1] += s.attrs["added"]
    for f in (s for s in sp if s.name == "frame"):
        assert [f.attrs["hash_candidates"], f.attrs["hash_added"]] == want.get(f.id, [0, 0])
    assert sum(f.attrs["hash_added"] for f in sp if f.name == "frame") > 0


def test_map_hash_carries_the_plain_hashs_counts(traced_hashed_rgbd):
    from tests.plain_mih import PlainMIH

    slam, sp, mih, calls = traced_hashed_rgbd
    events = [s for s in sp if s.name == "map.hash"]
    assert len(events) == len(slam.mapper.event_ms) >= 3
    assert all(s.thread == MAPPING_THREAD for s in events)
    ref = PlainMIH(mih.cfg.n_tables, mih.cfg.bits_per_substring, mih.cfg.max_bucket_size)
    plain = [(len(c[2]), ref.insert(c[1], c[2])) for c in calls if c[0] == "insert"]
    # the mapper is the only inserter, one insert an event with points
    assert [(s.attrs["inserted"], s.attrs["evicted"]) for s in events
            if s.attrs["inserted"]] == plain
    assert sum(e for _, e in plain) > 0


def test_no_hash_spans_or_counts_with_hashing_off(traced_rgbd):
    slam, frames, sp = traced_rgbd
    assert slam.tracker.mih is None
    assert not [s for s in sp if s.name in ("track.hash", "track.hash_scores")]
    for f in (s for s in sp if s.name == "frame"):
        assert f.attrs["hash_candidates"] == f.attrs["hash_added"] == 0
    hashes = [s for s in sp if s.name == "map.hash"]
    assert hashes and all("inserted" not in s.attrs and "evicted" not in s.attrs
                          for s in hashes)

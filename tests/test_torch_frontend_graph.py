"""The frontend's captured CUDA graphs (gf_orb_slam2_tpu_torch/utils/cuda_graph.py)
against the eager frontend.

On the card (marked `cuda`, skipped without a CUDA device): RGB-D, mono and
stereo frames rendered by tests/rendered_world.py at 640x480 with TUM1's
distortion and 1,000 features go through the System's frame builders, whose
one upload lands in the graph's input buffer. Every HOST_FIELDS tensor of
every frame equals the eager body's on the same frame bit for bit; the
tensors a call returned are unchanged after the later calls' replays; one
capture per signature, one replay per later call, one host→device copy a
frame of the same bytes; the stereo matching's hand-kernel launch counts one
a frame, replayed or not, and a profiler trace of one replay holds exactly
the hand kernels that the replay counts. `track_stereo_pipelined` with the
mapping worker (its synchronous frames replay the graph, its streamed ones
run the eager body while frames are in flight): every frame's frontend
outputs, read after the run, equal the eager body's on its images bit for
bit.

On the CPU: the frontend is the eager body, no graph is captured and the
counters stay 0; `to_device` lands in a given buffer with the packed layout
and `GraphCache.upload` in a new one, each counted as one copy.
"""
import dataclasses
import importlib.util
import os
import threading

import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu_torch import config as tc
from gf_orb_slam2_tpu_torch.system import System
from gf_orb_slam2_tpu_torch.tracking.frame import HOST_FIELDS
from gf_orb_slam2_tpu_torch.utils import tracing, transfer
from gf_orb_slam2_tpu_torch.utils.cuda_graph import GraphCache

torch.set_num_threads(1)

TUM1 = dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
            dist=(0.262383, -0.953104, -0.005358, 0.002628, 1.163314))
MODES = ("rgbd", "mono", "stereo")
SENSOR = {"rgbd": tc.Sensor.RGBD, "mono": tc.Sensor.MONOCULAR, "stereo": tc.Sensor.STEREO}
BASELINE = 0.08
# each hand kernel's launch counter (ops/cuda_lib.py) and its CUDA function
HAND_KERNELS = {"hamming_masked_best2": "hamming_best2_kernel",
                "hamming_distance_matrix": "hamming_matrix_kernel",
                "pose_lm": "pose_lm_kernel", "greedy_select": "greedy_select_kernel"}


def _rendered_world():
    """tests/rendered_world.py by its path (no `tests` package needed)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rendered_world.py")
    spec = importlib.util.spec_from_file_location("rendered_world_frontend_graph", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames(n, w, h, cam, tour=300):
    """n (left, right, depth) frames of a room tour sampled at `tour` frames:
    uint8 images, and a slanted depth surface with holes in TUM's 16-bit
    units (metres × 5000)."""
    rw = _rendered_world()
    world = rw.RoomWorld(width=9.0, height=5.5, length=13.0, tex_size=512)
    out = []
    for R, t in rw.trajectory_tour(tour)[:n]:
        kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, w=w, h=h)
        left, right = world.render_stereo(R, t, baseline=BASELINE, **kw)
        # only the keypoint lookup reads the depth map
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        depth = (2.0 + 0.002 * xs + 0.001 * ys + 0.1 * np.sin(t[0])) * 5000.0
        depth[::7, ::5] = 0  # holes read as no depth
        out.append((np.clip(left, 0, 255).astype(np.uint8),
                    np.clip(right, 0, 255).astype(np.uint8), depth.astype(np.uint16)))
    return out


def _config(mode, w, h, n_features, tracking=tc.TrackingConfig()):
    s = w / 640.0
    cam = tc.CameraConfig(width=w, height=h, fx=TUM1["fx"] * s, fy=TUM1["fy"] * s,
                          cx=TUM1["cx"] * s, cy=TUM1["cy"] * s, dist=TUM1["dist"],
                          bf=TUM1["fx"] * s * BASELINE, th_depth=40.0,
                          depth_map_factor=5000.0)
    return tc.SystemConfig(
        sensor=SENSOR[mode], camera=cam, orb=tc.ORBConfig(n_features=n_features),
        capacity=tc.CapacityConfig(max_keypoints=-(-n_features // 64) * 64),
        tracking=tracking, loop=tc.LoopClosingConfig(enabled=False), vocabulary_path="")


def _build(slam, mode, frame, i):
    left, right, depth = frame
    if mode == "rgbd":
        return slam._build_rgbd_frame(left, depth, i / 30.0)
    if mode == "mono":
        return slam._build_mono_frame(left, i / 30.0)
    return slam._build_stereo_frame(left, right, i / 30.0)


def _eager(slam, mode, frame):
    """The frontend's eager body on a fresh upload of the frame."""
    left, right, depth = frame
    if mode == "rgbd":
        return slam._frontend_mono_body(torch.from_numpy(left).to(slam.device),
                                        torch.from_numpy(depth.astype(np.float32)).to(slam.device))
    if mode == "mono":
        return slam._frontend_mono_body(torch.from_numpy(left).to(slam.device), None)
    return slam._frontend_stereo_body(torch.from_numpy(np.stack([left, right])).to(slam.device))


def _bits(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _assert_same(got, want):
    assert set(got) == set(HOST_FIELDS) == set(want)
    for k in HOST_FIELDS:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


def _arrays(mode, frame):
    """The frame's host arrays in the frontend body's argument order."""
    left, right, depth = frame
    return {"rgbd": (left, depth.astype(np.float32)), "mono": (left, None),
            "stereo": (np.stack([left, right]),)}[mode]


def _name(mode):
    return "stereo" if mode == "stereo" else "mono"


def _counts():
    return tracing.counters(threading.current_thread().name)


def _delta(before, after, name):
    return after.get(name, 0) - before.get(name, 0)


# ------------------------------------------------------------------ the card
def _hand_kernels_traced(fn):
    """Run `fn` under the CUDA profiler: the hand kernels that ran on the
    device by launch counter name, and how many kernels ran in all."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    found = {k: sum(fn_name in name for name in kernels)
             for k, fn_name in HAND_KERNELS.items()}
    return {k: n for k, n in found.items() if n}, len(kernels)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_replayed_frontend_equals_eager_and_frames_own_their_tensors(mode):
    dev = _cuda_or_skip()
    w, h, n = 640, 480, 7
    slam = System(_config(mode, w, h, 1000), device=dev)
    frames = _frames(n, w, h, slam.cfg.camera)
    before = _counts()
    outs, kept = [], []
    for i, fr in enumerate(frames):
        c0 = _counts()
        got = _build(slam, mode, fr, i).dev
        c1 = _counts()
        # the frame's one upload, of the bytes it always had
        assert _delta(c0, c1, "h2d.copies") == 1
        left, _, depth = fr
        size = {"rgbd": transfer.packed_offsets([left.nbytes, 4 * depth.size])[1],
                "mono": left.nbytes, "stereo": 2 * left.nbytes}[mode]
        assert _delta(c0, c1, "h2d.bytes") == size
        if mode == "stereo":
            assert _delta(c0, c1, "launch.hamming_masked_best2") == 1
        outs.append(got)
        kept.append({k: v.clone() for k, v in got.items()})
        _assert_same(got, _eager(slam, mode, fr))
    after = _counts()
    assert _delta(before, after, "frontend.graph_captures") == 1
    assert _delta(before, after, "frontend.graph_replays") == n - 1
    # after the capture the upload lands in the graph's input buffer
    (g,) = slam._frontend_graphs._graphs.values()
    ups = slam._frontend_graphs.upload(_name(mode), dev, *_arrays(mode, frames[-1]))
    assert ups[0].data_ptr() == g.flat_in.data_ptr()
    # the replay's hand-kernel counts are the kernels a trace of it holds
    want = {k[len("launch."):]: n for k, n in g.launches.items()}
    assert want == ({"hamming_masked_best2": 1} if mode == "stereo" else {})
    c0 = _counts()
    traced, n_kernels = _hand_kernels_traced(lambda: _build(slam, mode, frames[-1], n))
    assert n_kernels > 100  # the trace sees the kernels inside the graph
    assert traced == want
    assert {k: _delta(c0, _counts(), "launch." + k) for k in want} == want
    # call n's tensors are unchanged by calls n+1, n+2, ...
    for got, snap in zip(outs, kept):
        _assert_same(got, snap)
    assert int(outs[-1]["valid"].sum()) > 300
    slam.shutdown()


@pytest.mark.cuda
def test_signatures_capture_once_each_and_direct_calls_replay():
    """Mono with and without a depth map are two signatures of one body; a
    caller whose input is not the graph's buffer (a direct call) is copied
    in and replayed."""
    dev = _cuda_or_skip()
    w, h = 640, 480
    slam = System(_config("rgbd", w, h, 1000), device=dev)
    frames = _frames(4, w, h, slam.cfg.camera)
    before = _counts()
    for fr in frames:
        left, _, depth = fr
        im = torch.from_numpy(left).to(dev)
        d = torch.from_numpy(depth.astype(np.float32)).to(dev)
        _assert_same(slam._frontend_mono_impl(im, d), _eager(slam, "rgbd", fr))
        _assert_same(slam._frontend_mono_impl(im), _eager(slam, "mono", fr))
    after = _counts()
    assert _delta(before, after, "frontend.graph_captures") == 2
    assert _delta(before, after, "frontend.graph_replays") == 2 * (len(frames) - 1)
    slam.shutdown()


@pytest.mark.cuda
def test_pipelined_driver_frontend_bit_for_bit():
    """`track_stereo_pipelined` with the mapping worker: its synchronous
    frames replay the graph, its streamed frames run the eager body while
    earlier frames are in flight. Every frame's frontend outputs, read after
    the run, equal the eager body's on that frame's images bit for bit."""
    dev = _cuda_or_skip()
    w, h, n = 640, 480, 40
    slam = System(_config("stereo", w, h, 1000, tc.TrackingConfig(
        async_mapping=True, pipeline_depth=3)), device=dev)
    frames = _frames(n, w, h, slam.cfg.camera, tour=900)
    synced, streamed = [], []  # (the images, the frontend outputs) a frame
    impl, dispatch = slam._frontend_stereo_impl, slam.tracker.stream_dispatch

    def recording(imgs):
        synced.append((imgs.clone(), impl(imgs)))
        return synced[-1][1]

    def streaming(out, d, fid):
        streamed.append((d["imgs"].clone(), out))
        return dispatch(out, d, fid)

    slam._frontend_stereo_impl = recording
    slam.tracker.stream_dispatch = streaming
    before = _counts()
    got = {}
    for i, (left, right, _) in enumerate(frames):
        for fid, T in slam.track_stereo_pipelined(left, right, i / 30.0):
            got[fid] = T
    for fid, T in slam.flush_pipeline():
        got[fid] = T
    after = _counts()
    assert sorted(got) == list(range(n))
    assert len(synced) + len(streamed) == n
    assert len(streamed) == sum(s.path == "stream" for s in slam.tracker.stats) >= n // 2
    assert _delta(before, after, "frontend.graph_captures") == 1
    assert _delta(before, after, "frontend.graph_replays") == len(synced) - 1
    for imgs, out in synced + streamed:
        _assert_same(out, slam._frontend_stereo_body(imgs))
    slam.shutdown()


# ------------------------------------------------------------------ the CPU
@pytest.mark.parametrize("mode", MODES)
def test_cpu_frontend_is_the_eager_body(mode):
    w, h = 320, 240
    slam = System(_config(mode, w, h, 300), device="cpu")
    frames = _frames(2, w, h, slam.cfg.camera)
    before = _counts()
    for i, fr in enumerate(frames):
        _assert_same(_build(slam, mode, fr, i).dev, _eager(slam, mode, fr))
    after = _counts()
    assert _delta(before, after, "frontend.graph_captures") == 0
    assert _delta(before, after, "frontend.graph_replays") == 0
    assert _delta(before, after, "h2d.copies") == len(frames)
    assert not slam._frontend_graphs._graphs


def test_to_device_and_upload_land_in_a_given_buffer():
    """`to_device(..., out=)` packs into the given buffer; `GraphCache.upload`
    off CUDA packs into a new one (no graph to land in), keeps an absent
    input None, and each counts one copy of the packed bytes."""
    rng = np.random.default_rng(3)
    arrays = dict(im=rng.integers(0, 256, (7, 9), dtype=np.uint8),
                  depth=rng.random((7, 9), dtype=np.float32),
                  words=rng.integers(0, 2**32, (5, 8), dtype=np.uint32))
    offsets, total = transfer.packed_offsets(a.nbytes for a in arrays.values())
    assert offsets == [0, 64, 320] and total == 480
    out = torch.zeros(total + 32, dtype=torch.uint8)
    before = _counts()
    d = transfer.to_device(arrays, "cpu", out=out)
    after = _counts()
    assert _delta(before, after, "h2d.copies") == 1
    assert _delta(before, after, "h2d.bytes") == total
    for (k, a), off in zip(arrays.items(), offsets):
        assert d[k].data_ptr() == out.data_ptr() + off
        assert d[k].dtype == transfer.torch_dtype(a.dtype)
        np.testing.assert_array_equal(d[k].numpy().view(a.dtype), a)
    im = rng.integers(0, 256, (2, 5, 6), dtype=np.uint8)
    cache = GraphCache("test")
    got, absent, depth = cache.upload("x", "cpu", im, None, arrays["depth"])
    assert absent is None and got.shape == im.shape and got.dtype == torch.uint8
    assert depth.data_ptr() == got.data_ptr() + 64
    np.testing.assert_array_equal(got.numpy(), im)
    np.testing.assert_array_equal(depth.numpy(), arrays["depth"])
    now = _counts()
    assert _delta(after, now, "h2d.copies") == 1
    assert _delta(after, now, "h2d.bytes") == transfer.packed_offsets(
        [im.nbytes, arrays["depth"].nbytes])[1]

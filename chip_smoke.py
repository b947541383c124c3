#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for Hopper).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from gf_orb_slam2_tpu_torch/csrc (the
Hamming distance matrix on the tensor cores, and the masked best-2 search
that never writes the matrix), holds each against its plain PyTorch version
on the card, then drives the port's main path — synchronous stereo tracking
through `System.track_stereo` at the headline configuration (640x480, 800 ORB
features, 4096-point local pool, good-feature selection on) with synchronous
local mapping on every keyframe event (triangulation, fusion, local BA, KF
culling) — over 150 rendered frames, checks the trajectory against the
renderer's ground truth, that every keyframe event went through the mapper
and that both kernels were launched by the run (the mapper's launches of the
best-2 kernel counted apart). Then it drives the other entry point of the
same system on the same frames, as bench.py does: 16 frames through
`track_stereo`, the rest through `track_stereo_pipelined` with the
asynchronous mapping worker, then `flush_pipeline()` — and checks that every
frame comes back once and OK, the trajectory, the worker's BA accounting,
that the streaming step served the frames and launched the best-2 kernel
(by thread: tracking and mapping worker), that the device map mirror equals
the store, and that dispatching a streamed frame never synchronizes with the
device. Last, it times the best-2 kernel on the masks of the synchronous
run's last frame and of its last keyframe event's triangulation and fusion
searches, and solves that event's local BA problem on the card against the
same problem on the CPU, plainly and through good-graph selection. Each phase
prints one JSON line; any failed phase ends the run with a non-zero exit
code. The last line is {"ok": true, "device": {...}} and is printed only if
every phase passed.

Needs a CUDA device and `nvcc`; imports torch and numpy (and OpenCV through
the renderer), never JAX.
"""
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from gf_orb_slam2_tpu_torch.config import (  # noqa: E402
    CameraConfig, CapacityConfig, GFMatchingMode, GoodFeatureConfig,
    LoopClosingConfig, ORBConfig, Sensor, SystemConfig, TrackingConfig,
)
from gf_orb_slam2_tpu_torch.io.evaluation import ate_rmse  # noqa: E402
from gf_orb_slam2_tpu_torch.mapping import local_mapping  # noqa: E402
from gf_orb_slam2_tpu_torch.matching import hamming as hamming_mod  # noqa: E402
from gf_orb_slam2_tpu_torch.ops import hamming_cuda  # noqa: E402
from gf_orb_slam2_tpu_torch.optim.local_ba import (  # noqa: E402
    LocalBAProblem, local_bundle_adjustment,
)
from gf_orb_slam2_tpu_torch.slammap.device_mirror import DeviceMapMirror  # noqa: E402
from gf_orb_slam2_tpu_torch.system import MAPPING_THREAD, System  # noqa: E402
from gf_orb_slam2_tpu_torch.utils.transfer import to_device  # noqa: E402


def _load_renderer():
    """tests/rendered_world.py (numpy + OpenCV ray-cast room), loaded by path:
    `tests` is not a package and the name may be taken on the import path."""
    path = os.path.join(ROOT, "tests", "rendered_world.py")
    spec = importlib.util.spec_from_file_location("rendered_world", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_renderer = _load_renderer()
RoomWorld, trajectory_tour = _renderer.RoomWorld, _renderer.trajectory_tour

# scene of the JAX package's headline benchmark (bench.py)
FX = FY = 450.0
CX, CY = 320.0, 240.0
WIDTH, HEIGHT = 640, 480
BASELINE_M = 0.1
BF = FX * BASELINE_M
N_FRAMES = 150
TOUR_FRAMES = 300
ATE_BOUND_M = 0.05  # the JAX package's synchronous gate with mapping on (tests/test_rendered_ate.py)
PIPELINED_ATE_BOUND_M = 0.20  # the JAX package's limit for its pipelined driver (bench.py)
SYNC_FRAMES = 16  # bench.py: synchronous frames before the pipelined ones
BENCH_WARM = 40   # bench.py: per-call times from this frame on
GUARDED = 3       # last dispatches checked for host synchronization
DEVICE = "cuda"
BA_POSE_TOL, BA_COST_RTOL = 1e-3, 1e-3  # card against CPU, same BA problem

# published peaks of one H100 SXM (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12  # the data sheet lists no 1-bit rate; int8 is the nearest
POPC_PER_CLOCK_PER_SM = 16       # NVIDIA's CUDA C++ programming manual, arithmetic throughput, cc 9.0

MATRIX, BEST2 = "hamming_distance_matrix", "hamming_masked_best2"
SOURCES = {MATRIX: "gf_orb_slam2_tpu_torch/csrc/hamming.cu",
           BEST2: "gf_orb_slam2_tpu_torch/csrc/hamming_best2.cu"}
REPLACES = "gf_orb_slam2_tpu/ops/pallas_hamming.py:23"
PATH_SHAPES = ((4096, 1024), (1024, 1024))  # (local + leftover search), (stereo + motion search)
CHECK_SHAPES = ((1024, 1024), (4096, 1024), (1000, 777), (1, 1), (0, 5))
BEST2_CHECK_SHAPES = CHECK_SHAPES + ((5, 1), (5, 0))
MASK_DENSITIES = (0.02, 0.4, 1.0)


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def random_desc(gen, n, device):
    return torch.randint(-2**31, 2**31, (n, 8), generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32)


def time_cuda(fn, samples, inner):
    """Median over `samples` of the mean time of `inner` back-to-back calls
    (CUDA events), in milliseconds."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def time_cuda_graph(fn, samples, inner):
    """Device time of one call: `inner` back-to-back calls are captured into
    a CUDA graph and the replay is timed with CUDA events, so the host's
    launch path (Python, ctypes, allocator) is not in the number. Median over
    `samples`, in milliseconds."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def popc_per_s():
    """Peak rate of the population-count pipe of this card: 16 results per
    clock per SM at the highest SM clock `nvidia-smi` reports."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return POPC_PER_CLOCK_PER_SM * sms * mhz * 1e6


def matrix_bound_ms(n, m):
    """Least time for the [n,8]x[m,8] → [n,m] int32 matrix: inputs read once,
    output written once, against two 1-bit AND+POPC products of depth 256 per
    output on the tensor cores. Also returns what a kernel that counts bits
    with 8 POPC per output could reach at best (`popc_pipe_ms`)."""
    bytes_ms = ((n + m) * 32 + n * m * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = (n * m * 2 * 2 * 256) / INT8_TENSOR_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "tensor_ops_ms": ops_ms,
            "popc_pipe_ms": n * m * 8 / popc_per_s() * 1e3}


def best2_bound_ms(n, m, n_set):
    """Least time for the masked best-2 search: descriptors and the mask's
    n*m bytes read once, 16 bytes of results per row written, against 8 POPC
    for each of the `n_set` entries the mask lets through."""
    bytes_ms = ((n + m) * 32 + n * m + n * 16) / HBM_BYTES_PER_S * 1e3
    ops_ms = n_set * 8 / popc_per_s() * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "popc_pipe_ms": ops_ms}


def search_like_mask(gen, n, m, dev):
    """A mask with the structure of a projection search at 640x480: a disc of
    7 px x level scale around a random point per row, +-1 octave, 40 % of the
    rows empty."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    size = torch.tensor([640.0, 480.0], device=dev)
    uv_r, uv_c = rand(n, 2) * size, rand(m, 2) * size
    oct_r, oct_c = (rand(n) ** 2 * 8).long(), (rand(m) ** 2 * 8).long()
    radius = 7.0 * 1.2 ** oct_r.float()
    near = ((uv_r[:, None] - uv_c[None]) ** 2).sum(-1) <= radius[:, None] ** 2
    return (near & ((oct_r[:, None] - oct_c[None]).abs() <= 1)
            & (rand(n) < 0.6)[:, None]).contiguous()


# ------------------------------------------------------------------ phases
def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvidia_smi": smi})
    return smi


def phase_build():
    t0 = time.perf_counter()
    hamming_cuda.load(verbose=True)
    emit({"phase": "build", "sources": sorted(SOURCES.values()),
          "arch": "sm_90a", "seconds": round(time.perf_counter() - t0, 2)})


class Tally:
    """Mismatches of a kernel against its plain version (tolerance 0)."""

    def __init__(self):
        self.mismatches = 0
        self.max_abs_err = 0
        self.cases = 0

    def hold(self, got, want, what):
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"{what}: kernel gave {tuple(g.shape)} {g.dtype}, "
                     f"plain version {tuple(w.shape)} {w.dtype}")
            if g.numel():
                diff = (g - w).abs()
                self.mismatches += int((diff != 0).sum())
                self.max_abs_err = max(self.max_abs_err, int(diff.max()))
        self.cases += 1


def check_matrix(gen, dev):
    tally = Tally()
    for n, m in CHECK_SHAPES:
        da, db = random_desc(gen, n, dev), random_desc(gen, m, dev)
        got = hamming_cuda.hamming_distance_matrix(da, db)
        tally.hold([got], [hamming_cuda.hamming_distance_matrix_ref(da, db)], f"matrix {(n, m)}")
    # all-zeros against all-ones: 0 on equal rows, 256 across
    zo = torch.cat([torch.zeros((3, 8), dtype=torch.int32, device=dev),
                    torch.full((2, 8), -1, dtype=torch.int32, device=dev)])
    want = torch.zeros((5, 5), dtype=torch.int32, device=dev)
    want[:3, 3:] = 256
    want[3:, :3] = 256
    tally.hold([hamming_cuda.hamming_distance_matrix(zo, zo)], [want], "matrix 0/256")
    return tally, zo


def check_best2(gen, dev, zo):
    tally = Tally()

    def hold(da, db, mask, what):
        tally.hold(hamming_cuda.hamming_masked_best2(da, db, mask),
                   hamming_cuda.hamming_masked_best2_ref(da, db, mask), what)

    for n, m in BEST2_CHECK_SHAPES:
        da, db = random_desc(gen, n, dev), random_desc(gen, m, dev)
        for density in MASK_DENSITIES:
            mask = torch.rand((n, m), generator=gen, device=dev) < density
            hold(da, db, mask, f"best2 {(n, m)} at {density}")
            mask[::3] = False  # every third row fully masked
            hold(da, db, mask, f"best2 {(n, m)} at {density}, rows masked")
    # duplicate descriptors: distances from a tiny set, so ties and second == best occur
    pool = random_desc(gen, 6, dev)
    for m in (208, 200):  # 16-byte and bytewise mask reads
        da = pool[torch.randint(0, 6, (300,), generator=gen, device=dev)]
        db = pool[torch.randint(0, 4, (m,), generator=gen, device=dev)]
        for density in (0.4, 1.0):
            mask = torch.rand((300, m), generator=gen, device=dev) < density
            got = hamming_cuda.hamming_masked_best2(da, db, mask)
            if not bool((got[1] == got[2]).any()):
                fail("the duplicate-descriptor case produced no second == best")
            hold(da, db, mask, f"best2 duplicates {(300, m)} at {density}")
    # an unmasked distance of 256 ties with the masked-out entries
    hold(zo, zo, torch.ones((5, 5), dtype=torch.bool, device=dev), "best2 0/256")
    hold(zo, zo, torch.eye(5, dtype=torch.bool, device=dev).flip(0), "best2 0/256 antidiagonal")
    return tally


def time_best2(da, db, mask):
    """Times of the best-2 kernel on one input, beside its plain version, the
    pair it replaces on the path (matrix kernel + `masked_best2`: the
    yardstick `library_ms` on the device, `library_call_ms` called eagerly)
    and its bound for this mask."""
    n, m = mask.shape
    n_set = int(mask.sum())

    def pair():
        return hamming_cuda.masked_best2(hamming_cuda.hamming_distance_matrix(da, db), mask)

    rec = {"n": n, "m": m, "mask_density": n_set / max(n * m, 1),
           "ms": time_cuda_graph(lambda: hamming_cuda.hamming_masked_best2(da, db, mask), 30, 20),
           "call_ms": time_cuda(lambda: hamming_cuda.hamming_masked_best2(da, db, mask), 30, 20),
           "plain_ms": time_cuda(lambda: hamming_cuda.hamming_masked_best2_ref(da, db, mask), 5, 2),
           "library_ms": time_cuda_graph(pair, 10, 5), "library_call_ms": time_cuda(pair, 10, 5)}
    rec.update(best2_bound_ms(n, m, n_set))
    return rec


def kernel_record(name, tally, shapes, library_ms):
    head = shapes[0]  # the larger path shape
    return {
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES,
        "ok": tally.mismatches == 0, "mismatches": tally.mismatches,
        "max_abs_err": tally.max_abs_err, "cases": tally.cases, "tolerance": 0,
        "ms": head["ms"], "call_ms": head["call_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": library_ms, "shapes": shapes,
    }


def phase_kernels():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20240)
    matrix_tally, zo = check_matrix(gen, dev)
    best2_tally = check_best2(gen, dev, zo)
    torch.cuda.synchronize()

    empty_ms = time_cuda_graph(hamming_cuda.launch_empty_kernel, 30, 20)
    matrix_shapes, best2_shapes = [], []
    for n, m in PATH_SHAPES:
        da, db = random_desc(gen, n, dev), random_desc(gen, m, dev)

        def kernel():
            return hamming_cuda.hamming_distance_matrix(da, db)

        rec = {"n": n, "m": m,
               "ms": time_cuda_graph(kernel, 30, 20),   # the kernel on the device
               "call_ms": time_cuda(kernel, 30, 20),    # eager calls: host launch path included
               "plain_ms": time_cuda(lambda: hamming_cuda.hamming_distance_matrix_ref(da, db), 5, 2)}
        rec.update(matrix_bound_ms(n, m))
        matrix_shapes.append(rec)
        for label, mask in (("search_like", search_like_mask(gen, n, m, dev)),
                            ("all_true", torch.ones((n, m), dtype=torch.bool, device=dev))):
            best2_shapes.append(dict(time_best2(da, db, mask), mask=label))
    # PyTorch has no popcount operator, so no library call computes the matrix
    records = {MATRIX: kernel_record(MATRIX, matrix_tally, matrix_shapes, None),
               BEST2: kernel_record(BEST2, best2_tally, best2_shapes,
                                    best2_shapes[0]["library_ms"])}
    emit({"phase": "kernels", "empty_kernel_replay_ms": empty_ms,
          "popc_per_s": popc_per_s(), "checked": list(records.values())})
    for rec in records.values():
        if not rec["ok"]:
            fail(f"{rec['name']} disagrees with its plain version: "
                 f"{rec['mismatches']} mismatches")
    return records


def headline_config(async_mapping=False):
    """bench.py's configuration; `async_mapping` selects its pipelined
    driver's mapping worker (pipeline depth 3, the default)."""
    cam = CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, th_depth=40.0)
    return SystemConfig(
        sensor=Sensor.STEREO, camera=cam,
        orb=ORBConfig(n_features=800),
        capacity=CapacityConfig(max_keypoints=1024, max_map_points=40000,
                                max_keyframes=300, max_local_points=4096),
        good_feature=GoodFeatureConfig(
            enabled=True, matching_mode=GFMatchingMode.GOOD_FEATURE,
            constr_per_frame=160, lazier_factor=10, search_additional=True,
            info_mat_size=7),
        tracking=TrackingConfig(pose_opt_rounds=3, pose_opt_iters=8,
                                async_mapping=async_mapping, pipeline_depth=3),
        loop=LoopClosingConfig(enabled=False),
    )


class Capture:
    """Copies of the best-2 inputs on their way to the kernel: the tracking
    calls of the run's last frame, and the triangulation and fusion calls of
    its last keyframe event (the mapper's stages are wrapped to label them).
    Also counts the mapper's own kernel launches and keeps the last event's
    local BA problem."""

    def __init__(self, slam):
        self.slam = slam
        self.label = None            # "tracking", "triangulation", "fusion" or None
        self.calls = []              # (label, da, db, mask) of the last frame / event
        self.mapper_launches = dict.fromkeys(hamming_cuda.launch_counts, 0)
        self.ba_problem = None
        self._best2 = hamming_mod.distance_best2
        self._tri, self._fuse = local_mapping.triangulate_pairs, local_mapping.fuse_pairs
        mapper = slam.mapper
        self._process, self._assemble = mapper.process_keyframe, mapper.ba_assemble

    def __enter__(self):
        def best2(da, db, mask):
            if self.label is not None:
                self.calls.append((self.label, da.clone(), db.clone(), mask.clone()))
            return self._best2(da, db, mask)

        def labelled(fn, label):
            def run(*a, **k):
                self.label = label
                try:
                    return fn(*a, **k)
                finally:
                    self.label = None
            return run

        def process(kf, *a, **k):
            self.calls = [c for c in self.calls if c[0] == "tracking"]
            before = dict(hamming_cuda.launch_counts)
            try:
                return self._process(kf, *a, **k)
            finally:
                for name, n in hamming_cuda.launch_counts.items():
                    self.mapper_launches[name] += n - before[name]

        def assemble(kf):
            out = self._assemble(kf)
            if out is not None:
                self.ba_problem = out
            return out

        hamming_mod.distance_best2 = best2
        local_mapping.triangulate_pairs = labelled(self._tri, "triangulation")
        local_mapping.fuse_pairs = labelled(self._fuse, "fusion")
        self.slam.mapper.process_keyframe = process
        self.slam.mapper.ba_assemble = assemble
        return self

    def __exit__(self, *exc):
        hamming_mod.distance_best2 = self._best2
        local_mapping.triangulate_pairs, local_mapping.fuse_pairs = self._tri, self._fuse
        del self.slam.mapper.process_keyframe, self.slam.mapper.ba_assemble


def spread(values):
    return {"median": statistics.median(values), "max": max(values)} if values else None


def render_tour():
    """The first N_FRAMES stereo pairs of the room tour and the ground-truth
    camera centres."""
    world = RoomWorld(width=9.0, height=5.5, length=13.0)
    poses = trajectory_tour(TOUR_FRAMES)[:N_FRAMES]
    gt = np.stack([-R.T @ t for R, t in poses])
    imgs = []
    for R_cw, t_cw in poses:
        left, right = world.render_stereo(R_cw, t_cw, baseline=BASELINE_M, fx=FX, fy=FY,
                                          cx=CX, cy=CY, w=WIDTH, h=HEIGHT)
        imgs.append((np.clip(left, 0, 255).astype(np.uint8),
                     np.clip(right, 0, 255).astype(np.uint8)))
    return imgs, gt


def phase_main_path(imgs, gt, render_s):

    slam = System(headline_config(), device=DEVICE)  # the card: no CPU fallback
    est, frame_ms = [], []
    with Capture(slam) as cap:
        hamming_cuda.reset_launch_counts()
        for i, (left, right) in enumerate(imgs):
            if i == N_FRAMES - 1:  # the last frame's tracking calls
                cap.label = "tracking"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T = slam.track_stereo(left, right, i / 20.0)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            cap.label = None
            est.append(-T[:3, :3].T @ T[:3, 3])
        launches = dict(hamming_cuda.launch_counts)

    stats = slam.tracker.stats
    states = [s.state for s in stats]
    n_fused = sum(s.path == "fused" for s in stats)
    n_kf_events = sum(bool(s.created_kf) for s in stats)
    mstats = slam.mapper.stats
    ba_costs = [st.ba_cost for st in mstats if st.ba_kfs > 0]
    event_ms = slam.mapper.event_ms
    est = np.stack(est)
    ate = ate_rmse(est, gt)
    steady = sorted(frame_ms[5:])
    tracking_best2 = launches[BEST2] - cap.mapper_launches[BEST2]
    rec = {
        "phase": "main_path", "frames": N_FRAMES, "render_s": round(render_s, 1),
        "init_keypoints": stats[0].n_features, "states_ok": states.count("OK"),
        "fused_frames": n_fused, "keyframe_events": n_kf_events,
        "mapper_events": len(mstats), "keyframes_valid": int(slam.store.kf_valid.sum()),
        "map_points": int(slam.store.n_points),
        "points_triangulated": sum(st.n_new_points for st in mstats),
        "points_fused": sum(st.n_fused for st in mstats),
        "points_culled": sum(st.n_culled_points for st in mstats),
        "keyframes_culled": sum(st.n_culled_kfs for st in mstats),
        "ba_runs": len(ba_costs), "ba_cost_last": ba_costs[-1] if ba_costs else None,
        "ba_window_kfs_max": max((st.ba_kfs for st in mstats), default=0),
        "ate_rmse_m": ate, "ate_bound_m": ATE_BOUND_M,
        "frame_ms_median": statistics.median(steady),
        "frame_ms_p90": steady[int(0.9 * (len(steady) - 1))],
        "frame_ms_first": frame_ms[0],
        "mapper_ms_per_event": {
            stage: spread([e[stage] for e in event_ms[1:]])
            for stage in ("refresh", "triangulate_fuse", "local_ba", "writeback", "cull")},
        "mapper_ms_total_per_event": spread([sum(e.values()) for e in event_ms[1:]]),
        "kernel_launches": launches,
        "kernel_launches_mapping": cap.mapper_launches,
        "median_inliers": statistics.median(s.n_inliers for s in stats[1:]),
    }

    # frontend share of a frame: the extraction + stereo stage alone, timed
    # on the last image pair (host clock around a synchronized device)
    pair = torch.from_numpy(np.stack(imgs[-1])).to(DEVICE)
    fe = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slam._frontend_stereo_impl(pair)
        torch.cuda.synchronize()
        fe.append((time.perf_counter() - t0) * 1e3)
    rec["frontend_ms_median"] = statistics.median(fe)
    rec["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    emit(rec)
    slam.shutdown()

    if stats[0].state != "OK" or stats[0].n_features < 500:
        fail(f"frame 0 did not initialise: {stats[0]}")
    if any(s != "OK" for s in states):
        fail(f"tracking left OK: {[(s.frame_id, s.state) for s in stats if s.state != 'OK']}")
    if n_fused < N_FRAMES * 2 // 3:
        fail(f"fused path served {n_fused} of {N_FRAMES} frames (< 2/3)")
    if len(mstats) != n_kf_events or [st.kf for st in mstats] != sorted(set(st.kf for st in mstats)):
        fail(f"{len(mstats)} mapper runs for {n_kf_events} keyframe events")
    if n_kf_events < 3:
        fail(f"{n_kf_events} keyframe events (< 3)")
    if rec["points_triangulated"] <= 0:
        fail("the mapper triangulated no point")
    if not ba_costs or not all(np.isfinite(c) for c in ba_costs):
        fail(f"local BA: {len(ba_costs)} runs, costs {ba_costs}")
    if tracking_best2 < 4 * n_fused:
        fail(f"{tracking_best2} launches of {BEST2} by tracking for {n_fused} fused frames "
             "(< 4 per frame)")
    if cap.mapper_launches[BEST2] < 1:
        fail(f"the mapper launched {BEST2} no time")
    if launches[MATRIX] < 1:
        fail(f"{MATRIX} was not launched on the main path")
    if not (np.isfinite(est).all() and est.shape == (N_FRAMES, 3)):
        fail("trajectory is not finite")
    if not ate < ATE_BOUND_M:
        fail(f"ATE {ate:.4f} m >= {ATE_BOUND_M} m")
    if cap.ba_problem is None:
        fail("no local BA problem was assembled")
    return rec, cap.calls, cap.ba_problem


def _mirror_stale_rows(store):
    """Valid points whose mirrored row differs from the store (exact)."""
    m = store.mirror
    m.sync()
    v = np.nonzero(store.point_valid)[0]
    host = dict(pos=store.point_pos, normal=store.point_normal,
                mind=store.point_min_dist, maxd=store.point_max_dist,
                desc=store.point_desc.view(np.int32))
    stale = np.zeros(v.size, bool)
    for k, a in host.items():
        got = m.arrays[k].cpu().numpy()[v]
        stale |= (got != a[v]).reshape(v.size, -1).any(1)
    return int(stale.sum()), int(v.size)


def phase_pipelined(imgs, gt, sync_ate):
    """bench.py's driver on the card: frames 0-15 through `track_stereo`,
    16-149 through `track_stereo_pipelined` with the mapping worker
    (`tracking.async_mapping`, pipeline depth 3), then `flush_pipeline()`.
    Per-call host ms over frames 40 onward (bench.py's window), as bench.py
    takes it: the call returns without waiting for the device. The last
    GUARDED dispatches run under `torch.cuda.set_sync_debug_mode("error")`
    with the worker idle (the mode is process-wide): any host
    synchronization in the upload, mirror sync, frontend, stream step or
    download enqueue raises. Kernel launches are counted by thread."""
    slam = System(headline_config(async_mapping=True), device=DEVICE)
    timers = {"mirror_sync": [], "dispatch": [], "complete": []}
    queue_depth, checked, guarded, sync_errors = [], [], [], []

    def timed(fn, key):
        def run(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                timers[key].append((time.perf_counter() - t0) * 1e3)
        return run

    dispatch = timed(slam._dispatch_stream, "dispatch")

    def dispatch_checked(*a):
        if slam.frame_id < N_FRAMES - GUARDED:
            return dispatch(*a)
        if slam._map_worker is not None:
            slam._map_worker.wait_idle()
        fid = slam.frame_id
        checked.append(fid)
        torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch(*a)
        except RuntimeError:
            # a failed dispatch leaves no state behind (the chain advances
            # and the frame is queued only at its end): record the failure,
            # dispatch the frame again unguarded, fail after the record
            sync_errors.append(traceback.format_exc())
        else:
            guarded.append(fid)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if slam.frame_id == fid:
            dispatch(*a)

    orig_sync = DeviceMapMirror.sync
    DeviceMapMirror.sync = timed(orig_sync, "mirror_sync")
    slam._dispatch_stream = dispatch_checked
    slam._complete_one = timed(slam._complete_one, "complete")
    est, sync_ms, call_ms = {}, [], []

    def note(fid, T):
        if fid in est:
            fail(f"frame {fid} was returned twice")
        est[fid] = -T[:3, :3].T @ T[:3, 3]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hamming_cuda.reset_launch_counts()
    try:
        for i in range(SYNC_FRAMES):
            t0 = time.perf_counter()
            note(i, slam.track_stereo(imgs[i][0], imgs[i][1], i / 20.0))
            if i >= 10:
                sync_ms.append((time.perf_counter() - t0) * 1e3)
        for i in range(SYNC_FRAMES, N_FRAMES):
            t0 = time.perf_counter()
            for fid, T in slam.track_stereo_pipelined(imgs[i][0], imgs[i][1], i / 20.0):
                note(fid, T)
            call_ms.append((i, (time.perf_counter() - t0) * 1e3))
            if slam._map_worker is not None:
                queue_depth.append(slam._map_worker.queue_depth())
        for fid, T in slam.flush_pipeline():
            note(fid, T)
        torch.cuda.synchronize()
        launches = {"tracking": hamming_cuda.thread_launch_counts("MainThread"),
                    "mapping": hamming_cuda.thread_launch_counts(MAPPING_THREAD)}
        stale, n_valid = _mirror_stale_rows(slam.store)
    finally:
        DeviceMapMirror.sync = orig_sync

    stats = slam.tracker.stats
    n_stream = sum(s.path == "stream" and s.frame_id >= SYNC_FRAMES for s in stats)
    n_kf = sum(bool(s.created_kf) for s in stats)
    w = slam._map_worker
    times = [ms for i, ms in call_ms if i >= BENCH_WARM and i not in checked]
    common = sorted(est)
    ate = ate_rmse(np.stack([est[i] for i in common]), gt[common]) if common else float("nan")
    rec = {
        "phase": "pipelined", "frames": N_FRAMES, "sync_frames": SYNC_FRAMES,
        "metric": "stereo_tracking_ms_per_frame_mean", "mean": statistics.fmean(times),
        "unit": "ms/frame", "median_ms": statistics.median(times),
        "p90_ms": float(np.percentile(times, 90)),
        "sync_latency_ms": statistics.median(sync_ms),
        "n_frames_measured": len(times), "n_keyframes": int(slam.store.n_keyframes),
        "n_stream_fallbacks": slam.n_stream_fallbacks, "ate_m": ate,
        "ate_sync_main_path_m": sync_ate, "ate_bound_m": PIPELINED_ATE_BOUND_M,
        "n_ba_runs": w.n_ba_runs if w else 0, "n_ba_merged": w.n_ba_merged if w else 0,
        "n_kf_events": w.n_kf_events if w else 0, "keyframes_created": n_kf,
        "stream_frames": n_stream, "states_ok": sum(s.state == "OK" for s in stats),
        "frames_returned": len(est), "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
        "kernel_launches": launches,
        "best2_tracking_per_stream_frame": launches["tracking"][BEST2] / max(n_stream, 1),
        "driver_ms": {k: spread(v) for k, v in timers.items()},
        "worker_queue_depth_max": max(queue_depth, default=0),
        "worker_max_batch": w.max_batch if w else 0,
        "mapper_ms_total_per_event": spread([sum(e.values()) for e in slam.mapper.event_ms[1:]]),
        "guarded_dispatches": guarded, "guarded_dispatches_that_synchronized": len(sync_errors),
        "mirror_stale_rows": stale, "mirror_valid_rows": n_valid,
    }
    emit(rec)
    slam.shutdown()
    if sorted(est) != list(range(N_FRAMES)):
        fail(f"frames returned: {len(est)} of {N_FRAMES}, missing "
             f"{sorted(set(range(N_FRAMES)) - set(est))[:10]}")
    if any(s.state != "OK" for s in stats):
        fail(f"tracking left OK: {[(s.frame_id, s.state) for s in stats if s.state != 'OK'][:10]}")
    if not (np.isfinite(ate) and ate < PIPELINED_ATE_BOUND_M):
        fail(f"pipelined ATE {ate} m >= {PIPELINED_ATE_BOUND_M} m")
    if not (w and w.n_ba_runs + w.n_ba_merged == w.n_kf_events == n_kf):
        fail(f"BA accounting: runs {rec['n_ba_runs']} + merged {rec['n_ba_merged']}, "
             f"events {rec['n_kf_events']}, keyframes created {n_kf}")
    if n_stream < (N_FRAMES - SYNC_FRAMES) * 2 // 3:
        fail(f"the stream path served {n_stream} of {N_FRAMES - SYNC_FRAMES} frames (< 2/3)")
    if launches["tracking"][BEST2] < 4 * n_stream:
        fail(f"tracking launched {BEST2} {launches['tracking'][BEST2]} times for "
             f"{n_stream} streamed frames (< 4 per frame)")
    if launches["mapping"][BEST2] < 1:
        fail(f"the mapping worker launched {BEST2} no time")
    if launches["tracking"][MATRIX] + launches["mapping"][MATRIX] < 1:
        fail(f"{MATRIX} was not launched in the pipelined run")
    if stale:
        fail(f"{stale} of {n_valid} valid points differ between the mirror and the store")
    if sync_errors:
        fail(f"{len(sync_errors)} of {len(checked)} guarded dispatches synchronized with the "
             f"device; the first:\n{sync_errors[0]}")
    if len(guarded) != GUARDED:
        fail(f"{len(guarded)} of the last {GUARDED} frames were dispatched on the stream path")
    return rec


def phase_path_masks(captured):
    """The best-2 kernel checked (tolerance 0) and timed on the inputs of the
    last frame's tracking calls (stereo, motion search, local search,
    leftover search) and of the last keyframe event's triangulation and
    fusion searches, beside the pair it replaces (1a + `masked_best2`)."""
    if not any(label == "tracking" for label, *_ in captured):
        fail("no best-2 call was captured on the last frame")
    if not any(label == "triangulation" for label, *_ in captured):
        fail("no triangulation search was captured on the last keyframe event")
    calls = []
    for label, da, db, mask in captured:
        got = hamming_cuda.hamming_masked_best2(da, db, mask)
        want = hamming_cuda.hamming_masked_best2_ref(da, db, mask)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"best-2 kernel disagrees with its plain version on a {label} mask "
                 f"{tuple(mask.shape)}")
        calls.append(dict(time_best2(da, db, mask), mask="path", caller=label,
                          rows_with_candidates=int(mask.any(1).sum())))
    by_caller = {}
    for label in ("tracking", "triangulation", "fusion"):
        mine = [c for c in calls if c["caller"] == label]
        if mine:
            by_caller[label] = {
                "calls": len(mine),
                "mask_density": spread([c["mask_density"] for c in mine]),
                "ms": spread([c["ms"] for c in mine]),
                "pair_ms": spread([c["library_ms"] for c in mine]),
                "kernel_slower_than_pair": sum(c["ms"] > c["library_ms"] for c in mine)}
    emit({"phase": "path_masks", "by_caller": by_caller, "calls": calls})
    return calls


def phase_local_ba(assembled):
    """The last keyframe event's local BA problem: solved on the card against
    the same problem solved by the port on the CPU, then through the
    good-graph path (pose Schur blocks → Max-logDet selection → BA)."""
    cfg = headline_config()
    host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in assembled["prob"].items()}
    cpu = LocalBAProblem(**host)
    card = LocalBAProblem(**to_device(assembled["prob"], DEVICE))
    free_cap = assembled["free_cap"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, _ = local_mapping.ba_solve(card, cfg, free_cap)
    cost = float(res.final_cost)  # synchronizes
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref, _ = local_mapping.ba_solve(cpu, cfg, free_cap)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    dR = float((res.kf_R.cpu() - ref.kf_R).abs().max())
    dt = float((res.kf_t.cpu() - ref.kf_t).abs().max())
    cost_rel = abs(cost - float(ref.final_cost)) / max(abs(float(ref.final_cost)), 1e-12)

    free = ~card.kf_fixed & card.kf_valid
    n_free = int(free.sum())
    n_sel = min(cfg.good_graph.subgraph_size, n_free - 1)
    cam = cfg.camera
    start = float(local_bundle_adjustment(card, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                                          iters_first=0, iters_second=0).final_cost)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gres, sel = local_mapping.ba_solve(card, cfg, free_cap, n_sel, gen)
    g_cost = float(gres.final_cost)
    gg_ms = (time.perf_counter() - t0) * 1e3
    n_picked = int(sel.sum())
    rec = {"phase": "local_ba", "kfs": int(card.kf_R.shape[0]), "free_kfs": n_free,
           "points": int(card.pt_pos.shape[0]), "obs": int(card.obs_valid.sum()),
           "free_cap": free_cap, "cost": cost, "cpu_cost": float(ref.final_cost),
           "max_abs_dR": dR, "max_abs_dt": dt, "cost_rel_diff": cost_rel,
           "tolerance": {"pose": BA_POSE_TOL, "cost_rtol": BA_COST_RTOL},
           "card_ms": card_ms, "cpu_ms": cpu_ms,
           "good_graph": {"n_sel": n_sel, "selected": n_picked, "keeps_new_kf": bool(sel[0]),
                          "start_cost": start, "cost": g_cost, "card_ms": gg_ms}}
    emit(rec)
    if not (np.isfinite(cost) and dR <= BA_POSE_TOL and dt <= BA_POSE_TOL
            and cost_rel <= BA_COST_RTOL):
        fail(f"local BA on the card disagrees with the CPU: dR {dR}, dt {dt}, cost {cost_rel}")
    if n_sel < 1 or n_picked != n_sel or not bool(sel[0]):
        fail(f"good-graph selection picked {n_picked} of {n_sel} requested")
    if not (np.isfinite(g_cost) and g_cost <= start):
        fail(f"good-graph BA cost {g_cost} (start {start})")
    return rec


def main():
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    t0 = time.perf_counter()
    imgs, gt = render_tour()
    render_s = time.perf_counter() - t0
    run, captured, ba_problem = phase_main_path(imgs, gt, render_s)
    pipelined = phase_pipelined(imgs, gt, run["ate_rmse_m"])
    path_calls = phase_path_masks(captured)
    phase_local_ba(ba_problem)
    # the best-2 kernel's headline numbers are those on the path's own masks,
    # largest shape first; the synthetic masks of phase `kernels` follow
    best2 = kernels[BEST2]
    shapes = sorted(path_calls, key=lambda c: -c["n"]) + best2["shapes"]
    head = shapes[0]
    best2.update({k: head[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}, shapes=shapes)
    pl = pipelined["kernel_launches"]
    emit({"kernels": [dict(rec, launches=run["kernel_launches"][name],
                           launches_mapping=run["kernel_launches_mapping"][name],
                           launches_pipelined_tracking=pl["tracking"][name],
                           launches_pipelined_mapping=pl["mapping"][name])
                      for name, rec in kernels.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for Hopper).

    python3 chip_smoke.py

Builds the four hand-written CUDA kernels from gf_orb_slam2_tpu_torch/csrc
(1a the Hamming distance matrix on the tensor cores, 1b the masked best-2
search that never writes the matrix, 2 the whole pose LM of a frame in one
launch, 3 the whole lazier-greedy good-feature selection in one launch),
holds 1a and 1b against their plain PyTorch versions on the card, then
drives the port's main path — synchronous stereo tracking
through `System.track_stereo` at the headline configuration (640x480, 800 ORB
features, 4096-point local pool, good-feature selection on) with synchronous
local mapping on every keyframe event (triangulation, fusion, local BA, KF
culling) — over 150 rendered frames, checks the trajectory against the
renderer's ground truth, that every keyframe event went through the mapper
and that every kernel was launched by the run (two pose LMs and one
selection a fused frame; the mapper's launches of the best-2 kernel counted
apart). Then it drives the other entry point of the same system on the same
150 frames, as bench.py does: 16 frames through
`track_stereo`, the rest through `track_stereo_pipelined` with the
asynchronous mapping worker, then `flush_pipeline()` — and checks that every
frame comes back once and OK, the trajectory, the worker's BA accounting,
that the streaming step served the frames and launched the best-2 kernel
(by thread: tracking and mapping worker), that the device map mirror equals
the store, and that dispatching a streamed frame never synchronizes with the
device. Last, it times the best-2 kernel on the masks of the synchronous
run's last frame and of its last keyframe event's triangulation and fusion
searches, and solves that event's local BA problem on the card against the
same problem on the CPU, plainly and through good-graph selection. The
pipelined run uses bench.py's whole configuration: loop closing on, with its
own loop worker thread and the detached global BA.

Phase `loop` drives loop closing on the rendered loop circuit of the JAX
package's gate (tests/test_loop_rendered.py: 140 frames, 1.27 turns, the
synchronous entry with the global BA inline) once with loop closing and once
without: a loop must be corrected and fused, the recomposed trajectory must
beat 0.15 m and 0.75 of the loop-off run, and the loop closer must have
launched both kernels. Its Sim3 guided search and search-and-fuse masks join
phase `path_masks`; phase `loop_solvers` solves its last essential graph and
global BA window on the card against the same problems on the CPU.

Phases `reloc`, `mono` and `rgbd` drive the other entry points with the
JAX package's gates: relocalization after a 6-frame blackout on the loop
circuit (tests/test_reloc_rendered.py: LOST in the blackout, OK within 10
frames, no reset, the tail's ATE), `track_monocular` on the same circuit
with loop closing on and off (tests/test_mono_rendered.py: the two-view
initializer, a loop corrected with a free scale, the Sim3-aligned ATE), and
`track_rgbd` on the room tour's first 150 frames with the renderer's own ray
depth (every frame OK from frame 0, ATE). Their best-2 masks (the monocular
initializer's window search, a monocular and an RGB-D tracking search) and
the relocalization's matrix inputs join phase `path_masks`.

Phases `hashing`, `map_io` and `hybrid` drive the rest of the System
facade: hashed local maps on the loop circuit (tests/test_hashing_rendered.py:
the multi-index hash past its 2000-point trigger, COMBINED local maps, the
ATE against phase `loop`'s loop-off run; its search masks join
`path_masks`), the main path's map saved, loaded into a fresh System in
localization mode and relocalized against, then tracked through both
drivers (tests/test_map_io.py's gates: the store equal after the load, OK
within 5 frames and on 80 % of them, camera centres within 0.1 m, no
keyframe added, the device map mirror equal to the store), and the room
tour's first 150 frames with the 13-state (hybrid) good-feature selection and planner
odometry fed the ground-truth poses (every predicting frame predicted from
the buffer, ATE < 0.10 m; the selection's ms and kernels beside the main
path's). The `build` phase compiles the hash's host library (g++) beside
the CUDA kernels.

Phases `cli` and `dist_ba` drive the last two entry points. `cli` writes
tests/test_examples_cli.py's rendered 36-frame arc in EuRoC layout, runs
`examples/run_stereo_torch.py` on it as a subprocess with the default
device and `examples/eval_ate_torch.py` on its trajectory (36 frames, a
keyframe, the files, ATE < 0.25 m: that test's gates), then
`batch_sweep_torch.run_one` in this process at budgets 80 and 160, whose
kernel launches join the `kernels` line. `dist_ba` solves the JAX dry run's
problem (__graft_entry__.py: K = 32, P = 32768, 8 LM iterations) through
`parallel.dist_ba.distributed_ba` in both layouts on an NCCL world of one
rank (this process): a 4x pose-error reduction, the same result as a
4-rank gloo world on the CPU started by `parallel/launch.py`, and the
collectives per LM iteration equal to the formula
(tools/collective_audit_torch.py); it records ms, kernel launches and
device-busy share per LM iteration and the ablated step. The card holds one
GPU, so no multi-GPU scaling is measured here.

Phase `bench` (first after `kernels`) is bench.py's headline run on the port
over the tour's full 300 frames (rendered once for the whole script, through
bench_torch.render_sequence, whose cache file the subprocess then reads):
`bench_torch.run` in this process, then `python3 bench_torch.py` as a
subprocess with its default device on the tour's first 60 frames (the
script's time limit leaves no room for a second full run). Both must print
bench.py's keys, 260 (20) measured frames and an ATE below 0.20 m; every
frame must come back once and OK, BA runs + merged must equal the worker's
KF events and the KFs created, and the tracking thread must launch 1b at
least 4 times a streamed frame and 1a at least once (the System's
construction launches, the loop closer's warm-up, are counted apart). It
records the loops closed, the largest local BA window and whether the
good-graph trigger (a window above `good_graph.kf_thres` KFs) fired, the
per-call mean, median and p90, and `prewarm_s`, beside the card's nvidia-smi
name and power limit.

Phase `lm_select` holds kernels 2, 3 and 4 against their plain versions on
the inputs the paths gave them: the main path's last motion-model and
local-map solves and the accepted relocalization's LM polish (R and t within
1e-2 — the measured level of an LM step taken differently at a cost plateau,
with headroom —, inliers exact; no valid point, every point behind the camera, a
non-finite point), the main path's last selection (D = 7) and the hybrid
phase's (D = 13) on the same uniforms (the same picks, or near-ties within
0.02 and the objective within 1e-3), and a synthetic pool at the selection
kernel's cap on P (16,384 slots) at D = 7 and 13; and kernel 4, the
selection's information matrices, on the main path's last 8 selections'
inputs (the pool's matrices and the base bit for bit the plain version's, a
rerun bit for bit, the same picks on both sets), timed beside the plain
chain's device time, device kernels and
host enqueue. Every path is gated on its own
kernels having launched: the pose LM on every tracking path and once per
solved relocalization candidate, the selection on every good-feature path,
kernel 4 on every fused frame of the main path.

Each phase prints one JSON line; any failed phase ends the run with a
non-zero exit code. The last line is {"ok": true, "device": {...}} and is
printed only if every phase passed.

Needs a CUDA device, `nvcc` and `g++`; imports torch and numpy (and OpenCV
through the renderer), never JAX.
"""
import argparse
import collections
import concurrent.futures
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from gf_orb_slam2_tpu_torch.config import (  # noqa: E402
    CameraConfig, CapacityConfig, GFMatchingMode, GoodFeatureConfig, HashingConfig,
    LocalMapMode, LoopClosingConfig, ORBConfig, Sensor, SystemConfig, TrackingConfig,
)
from gf_orb_slam2_tpu_torch.hashing import mih as mih_mod  # noqa: E402
from gf_orb_slam2_tpu_torch.io.evaluation import ate_rmse, umeyama_align  # noqa: E402
from gf_orb_slam2_tpu_torch.io.trajectory import recompose_trajectory  # noqa: E402
from gf_orb_slam2_tpu_torch.loopclosing.loop_closer import GBA_THREAD, STAGES  # noqa: E402
from gf_orb_slam2_tpu_torch.loopclosing.sim3solver import optimize_sim3, solve_sim3  # noqa: E402
from gf_orb_slam2_tpu_torch.mapping import local_mapping  # noqa: E402
from gf_orb_slam2_tpu_torch.matching import hamming as hamming_mod, matcher  # noqa: E402
from gf_orb_slam2_tpu_torch.ops import cuda_lib, greedy_select_cuda, hamming_cuda  # noqa: E402
from gf_orb_slam2_tpu_torch.ops import obs_info_cuda, pose_lm_cuda  # noqa: E402
from gf_orb_slam2_tpu_torch.optim import global_ba  # noqa: E402
from gf_orb_slam2_tpu_torch.optim.local_ba import (  # noqa: E402
    LocalBAProblem, local_bundle_adjustment,
)
from gf_orb_slam2_tpu_torch.optim import pose_opt  # noqa: E402
from gf_orb_slam2_tpu_torch.optim.pose_graph import PoseGraphProblem, optimize_pose_graph  # noqa: E402
from gf_orb_slam2_tpu_torch.selection import good_feature, observability  # noqa: E402
from gf_orb_slam2_tpu_torch.slammap.device_mirror import DeviceMapMirror  # noqa: E402
from gf_orb_slam2_tpu_torch.system import LOOP_THREAD, MAPPING_THREAD, System  # noqa: E402
from gf_orb_slam2_tpu_torch.tracking import pnp, tracker as tracker_mod  # noqa: E402
from gf_orb_slam2_tpu_torch.utils.transfer import to_device  # noqa: E402


def _load_by_path(name, rel):
    """A file of the repo loaded as module `name` by its path: `tests`,
    `tools` and `examples` are not packages, and their names may be taken on
    the import path."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# numpy + OpenCV ray-cast room
_renderer = _load_by_path("rendered_world", "tests/rendered_world.py")
bench_torch = _load_by_path("bench_torch", "bench_torch.py")
RoomWorld, trajectory_tour = _renderer.RoomWorld, _renderer.trajectory_tour
trajectory_loop = _renderer.trajectory_loop

# scene of the JAX package's headline benchmark (bench.py)
FX = FY = 450.0
CX, CY = 320.0, 240.0
WIDTH, HEIGHT = 640, 480
BASELINE_M = 0.1
BF = FX * BASELINE_M
N_FRAMES = 150
PIPELINED_FRAMES = 150
HYBRID_FRAMES = 150
RGBD_FRAMES = 150
BENCH_SUBPROCESS_FRAMES = 60  # the subprocess form: its first 60 frames
TOUR_FRAMES = 300
ATE_BOUND_M = 0.05  # the JAX package's synchronous gate with mapping on (tests/test_rendered_ate.py)
PIPELINED_ATE_BOUND_M = 0.20  # the JAX package's limit for its pipelined driver (bench.py)
SYNC_FRAMES = 16  # bench.py: synchronous frames before the pipelined ones
BENCH_WARM = 40   # bench.py: per-call times from this frame on
GUARDED = 3       # last dispatches checked for host synchronization
DEVICE = "cuda"
BA_POSE_TOL, BA_COST_RTOL = 1e-3, 1e-3  # card against CPU, same BA problem
# the JAX package's rendered loop gate (tests/test_loop_rendered.py)
LOOP_FRAMES = 140
LOOP_ATE_BOUND_M = 0.15
LOOP_ATE_RATIO = 0.75  # loop on against loop off, same frames
SIM3_TOL = 1e-4        # the Sim3 stage, card against CPU (tests/test_torch_sim3.py)
# the JAX package's relocalization gate (tests/test_reloc_rendered.py)
RELOC_FRAMES = 110
BLACKOUT = range(70, 76)
REWIND = 16            # the camera reopens 16 frames back, inside the map
RELOC_TAIL_ATE_M = 0.25
# the JAX package's monocular gate (tests/test_mono_rendered.py)
MONO_MIN_FRAMES = 100
MONO_ATE_BOUND_M = 0.15
# RGB-D on the room tour: no JAX figure exists on this scene; twice the
# synchronous stereo gate, as bench.py's pipelined bound is twice its gate
RGBD_ATE_BOUND_M = 0.10

# published peaks of one H100 SXM (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12         # outside the tensor cores
INT8_TENSOR_OPS_PER_S = 1979e12  # the data sheet lists no 1-bit rate; int8 is the nearest
POPC_PER_CLOCK_PER_SM = 16       # NVIDIA's CUDA C++ programming manual, arithmetic throughput, cc 9.0

MATRIX, BEST2 = "hamming_distance_matrix", "hamming_masked_best2"
POSE_LM, GREEDY, OBS_INFO = "pose_lm", "greedy_select", "obs_info"
SOURCES = {MATRIX: "gf_orb_slam2_tpu_torch/csrc/hamming.cu",
           BEST2: "gf_orb_slam2_tpu_torch/csrc/hamming_best2.cu",
           POSE_LM: "gf_orb_slam2_tpu_torch/csrc/pose_lm.cu",
           GREEDY: "gf_orb_slam2_tpu_torch/csrc/greedy_select.cu",
           OBS_INFO: "gf_orb_slam2_tpu_torch/csrc/obs_info.cu"}
REPLACES = {MATRIX: "gf_orb_slam2_tpu/ops/pallas_hamming.py:23",
            BEST2: "gf_orb_slam2_tpu/ops/pallas_hamming.py:23",
            POSE_LM: "gf_orb_slam2_tpu/optim/pose_opt.py:81",
            GREEDY: "gf_orb_slam2_tpu/selection/good_feature.py:32",
            OBS_INFO: "gf_orb_slam2_tpu/selection/observability.py:90"}
PATH_SHAPES = ((4096, 1024), (1024, 1024))  # (local + leftover search), (stereo + motion search)
CHECK_SHAPES = ((1024, 1024), (4096, 1024), (1000, 777), (1, 1), (0, 5))
BEST2_CHECK_SHAPES = CHECK_SHAPES + ((5, 1), (5, 0))
MASK_DENSITIES = (0.02, 0.4, 1.0)


_T0 = time.perf_counter()


def emit(obj):
    if "phase" in obj:  # when the phase ended, in seconds since the start
        obj = dict(obj, t_s=round(time.perf_counter() - _T0, 1))
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
    """The CUDA kernels (nvcc, one process per source) and, beside them on a
    thread of its own, the multi-index hash's host library (g++)."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(mih_mod.build)
        cuda_lib.load(verbose=True)  # every csrc/*.cu, -Xptxas -v printed
        mih_path = host.result()  # raises what the g++ build raised
    mih_mod.load()
    built = sorted(os.path.relpath(src, ROOT) for src in cuda_lib.SOURCES)
    if built != sorted(SOURCES.values()):
        fail(f"the build compiled {built}, the smoke checks {sorted(SOURCES.values())}")
    emit({"phase": "build", "sources": built,
          "arch": "sm_90a", "host_library": os.path.relpath(mih_path, ROOT),
          "host_source": os.path.relpath(mih_mod.SOURCE, ROOT),
          "seconds": round(time.perf_counter() - t0, 2)})


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
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
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


def headline_config(async_mapping=False, loop=False):
    """bench.py's configuration; `async_mapping` selects its pipelined
    driver's mapping worker (pipeline depth 3, the default), `loop` its
    loop closing (bench.py's default: on, with the detached global BA)."""
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
        loop=LoopClosingConfig(enabled=loop),
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


class KeepLast:
    """Around `module.name`: keeps clones of the tensor arguments (and the
    keyword arguments) of its last `keep` calls; `args` is the last."""

    def __init__(self, module, name, keep=1):
        self.module, self.name = module, name
        self.calls = collections.deque(maxlen=keep)

    @property
    def args(self):
        return self.calls[-1] if self.calls else None

    def __enter__(self):
        self._fn = fn = getattr(self.module, self.name)

        def run(*a, **k):
            self.calls.append(([x.clone() if torch.is_tensor(x) else x for x in a], dict(k)))
            return fn(*a, **k)

        setattr(self.module, self.name, run)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._fn)


def profiled(fn, repeats=5):
    """Host ms of `fn` to a synchronized result (median of `repeats` after a
    warm-up call), and the device kernels and device-busy ms of one call
    under torch.profiler. With `repeats=0` the one profiled call is all:
    its host ms (profiler on) and its result are returned."""
    from torch.profiler import ProfilerActivity, profile

    ms = []
    if repeats:
        fn()
        torch.cuda.synchronize()
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    profiled_ms = (time.perf_counter() - t0) * 1e3
    ka = [e for e in prof.key_averages()
          if "cuda" in str(getattr(e, "device_type", "")).lower()
          and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0) for e in ka)
    out = {"ms": statistics.median(ms) if ms else profiled_ms,
           "device_kernels": sum(e.count for e in ka), "device_busy_ms": dev_us / 1e3}
    return dict(out, result=result) if not repeats else out


def selection_cost(kept):
    """The lazier-greedy good-feature selection of a run's last frame, on its
    own inputs, timed and profiled on the card (its draws are taken again)."""
    (obs_mats, valid, n_select, gen), kw = kept.args
    gen = torch.Generator(device=obs_mats.device)
    gen.manual_seed(0)
    out = profiled(lambda: good_feature.lazier_greedy_select(obs_mats, valid, n_select, gen, **kw))
    return dict(out, D=int(obs_mats.shape[-1]), candidates=int(valid.sum()),
                pool_slots=int(valid.shape[0]), n_select=int(n_select))


def render_tour():
    """The room tour's TOUR_FRAMES stereo pairs [n,2,H,W] uint8 and
    ground-truth camera centres, rendered once for the whole script through
    bench_torch.render_sequence (bench.py's scene and cache file, which the
    bench subprocess then reads); the other tour phases take the first
    N_FRAMES."""
    return bench_torch.render_sequence(TOUR_FRAMES)


def phase_main_path(imgs, gt, render_s):

    slam = System(headline_config(), device=DEVICE)  # the card: no CPU fallback
    est, frame_ms = [], []
    with Capture(slam) as cap, KeepLast(good_feature, "lazier_greedy_select") as sel, \
            KeepLast(pose_opt, "pose_optimization", keep=2) as solves, \
            KeepLast(observability, "pose_info_for_selection", keep=OBS_INFO_KEEP) as info:
        hamming_cuda.reset_launch_counts()
        for i, (left, right) in enumerate(imgs):
            if i == N_FRAMES - 1:  # the last frame's tracking calls
                cap.label = "tracking"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == N_FRAMES - 1:  # the last frame's device kernels, profiled
                last = profiled(lambda: slam.track_stereo(left, right, i / 20.0), repeats=0)
                T = last.pop("result")
            else:
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
        "pose_lm_per_fused_frame": launches[POSE_LM] / max(n_fused, 1),
        "greedy_select_per_fused_frame": launches[GREEDY] / max(n_fused, 1),
        "obs_info_per_fused_frame": launches[OBS_INFO] / max(n_fused, 1),
        "last_frame_device_kernels": last["device_kernels"],
        "last_frame_device_busy_ms": last["device_busy_ms"],
        "last_frame_ms_profiled": last["ms"],
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
    rec["selection_last_frame"] = selection_cost(sel)
    rec["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    emit(rec)
    print(f"main_path ATE {float(ate)!r} m (gate {ATE_BOUND_M} m)", flush=True)
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
    if launches[POSE_LM] < 2 * n_fused:
        fail(f"{POSE_LM} launched {launches[POSE_LM]} times for {n_fused} fused frames "
             "(< 2 per frame: the motion-model and the local-map solves)")
    if launches[GREEDY] < n_fused:
        fail(f"{GREEDY} launched {launches[GREEDY]} times for {n_fused} fused frames "
             "(< 1 per frame: the local step's budgeted selection)")
    if launches[OBS_INFO] < n_fused:
        fail(f"{OBS_INFO} launched {launches[OBS_INFO]} times for {n_fused} fused frames "
             "(< 1 per frame: the selection's information matrices)")
    if not (np.isfinite(est).all() and est.shape == (N_FRAMES, 3)):
        fail("trajectory is not finite")
    if not ate < ATE_BOUND_M:
        fail(f"ATE {ate!r} m >= {ATE_BOUND_M} m")
    if cap.ba_problem is None:
        fail("no local BA problem was assembled")
    if len(solves.calls) != 2 or sel.args is None or info.args is None:
        fail("the last frame's two pose solves and its selection were not captured")
    inputs = {"pose": list(zip(("motion_model", "local_map"), solves.calls)),
              "select": [("main_path_d7", sel.args)],
              "info": [(f"main_path_{i}", kept) for i, kept in enumerate(info.calls)]}
    return rec, cap.calls, cap.ba_problem, dict(system=slam, est=est), inputs


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
    """bench.py's driver on the card, with bench.py's whole configuration:
    frames 0-15 through `track_stereo`, 16 to PIPELINED_FRAMES - 1 through
    `track_stereo_pipelined` with the mapping worker
    (`tracking.async_mapping`, pipeline depth 3) and loop closing on (the
    loop worker, the detached global BA), then `flush_pipeline()`.
    Per-call host ms over frames 40 onward (bench.py's window), as bench.py
    takes it: the call returns without waiting for the device. The last
    GUARDED dispatches run under `torch.cuda.set_sync_debug_mode("error")`
    with the workers and the GBA idle (the mode is process-wide): any host
    synchronization in the upload, mirror sync, frontend, stream step or
    download enqueue raises. Kernel launches are counted by thread."""
    n = len(imgs)
    slam = System(headline_config(async_mapping=True, loop=True), device=DEVICE)
    if slam.loop_closer is None:
        fail("bench.py's configuration built no loop closer")
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
        if slam.frame_id < n - GUARDED:
            return dispatch(*a)
        if slam._map_worker is not None:
            slam._map_worker.wait_idle()
        if slam._loop_worker is not None:
            slam._loop_worker.wait_idle()
        slam.loop_closer.wait_gba()
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
        for i in range(SYNC_FRAMES, n):
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
                    "mapping": hamming_cuda.thread_launch_counts(MAPPING_THREAD),
                    "loop": hamming_cuda.thread_launch_counts(LOOP_THREAD),
                    "gba": hamming_cuda.thread_launch_counts(GBA_THREAD)}
        stale, n_valid = _mirror_stale_rows(slam.store)
    finally:
        DeviceMapMirror.sync = orig_sync

    stats = slam.tracker.stats
    n_stream = sum(s.path == "stream" and s.frame_id >= SYNC_FRAMES for s in stats)
    n_kf = sum(bool(s.created_kf) for s in stats)
    w = slam._map_worker
    lw = slam._loop_worker
    lstats = slam.loop_closer.stats
    times = [ms for i, ms in call_ms if i >= BENCH_WARM and i not in checked]
    common = sorted(est)
    ate = ate_rmse(np.stack([est[i] for i in common]), gt[common]) if common else float("nan")
    rec = {
        "phase": "pipelined", "frames": n, "sync_frames": SYNC_FRAMES,
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
        "pose_lm_tracking_per_stream_frame": launches["tracking"][POSE_LM] / max(n_stream, 1),
        "greedy_select_tracking_per_stream_frame":
            launches["tracking"][GREEDY] / max(n_stream, 1),
        "driver_ms": {k: spread(v) for k, v in timers.items()},
        "worker_queue_depth_max": max(queue_depth, default=0),
        "worker_max_batch": w.max_batch if w else 0,
        "mapper_ms_total_per_event": spread([sum(e.values()) for e in slam.mapper.event_ms[1:]]),
        "guarded_dispatches": guarded, "guarded_dispatches_that_synchronized": len(sync_errors),
        "mirror_stale_rows": stale, "mirror_valid_rows": n_valid,
        "loop_worker_events": lw.n_events if lw else 0, "loop_events": len(lstats),
        "loop_warm_up_ms": slam.loop_warm_up_ms,
        "loop_candidates": sum(st.n_candidates for st in lstats),
        "loops_corrected": sum(st.corrected for st in lstats),
        "loop_ms_per_event": {stage: spread([e[stage] for e in slam.loop_closer.event_ms])
                              for stage in STAGES},
    }
    emit(rec)
    slam.shutdown()
    if sorted(est) != list(range(n)):
        fail(f"frames returned: {len(est)} of {n}, missing "
             f"{sorted(set(range(n)) - set(est))[:10]}")
    if any(s.state != "OK" for s in stats):
        fail(f"tracking left OK: {[(s.frame_id, s.state) for s in stats if s.state != 'OK'][:10]}")
    if not (np.isfinite(ate) and ate < PIPELINED_ATE_BOUND_M):
        fail(f"pipelined ATE {ate} m >= {PIPELINED_ATE_BOUND_M} m")
    if not (w and w.n_ba_runs + w.n_ba_merged == w.n_kf_events == n_kf):
        fail(f"BA accounting: runs {rec['n_ba_runs']} + merged {rec['n_ba_merged']}, "
             f"events {rec['n_kf_events']}, keyframes created {n_kf}")
    if not (lw and lw.n_events == len(lstats) == w.n_kf_events):
        fail(f"the loop worker processed {rec['loop_worker_events']} events "
             f"({len(lstats)} in the loop closer's log) of {w.n_kf_events} KF events")
    if n_stream < (n - SYNC_FRAMES) * 2 // 3:
        fail(f"the stream path served {n_stream} of {n - SYNC_FRAMES} frames (< 2/3)")
    if launches["tracking"][BEST2] < 4 * n_stream:
        fail(f"tracking launched {BEST2} {launches['tracking'][BEST2]} times for "
             f"{n_stream} streamed frames (< 4 per frame)")
    if launches["mapping"][BEST2] < 1:
        fail(f"the mapping worker launched {BEST2} no time")
    if launches["tracking"][MATRIX] + launches["mapping"][MATRIX] < 1:
        fail(f"{MATRIX} was not launched in the pipelined run")
    if launches["tracking"][POSE_LM] < 2 * n_stream or launches["tracking"][GREEDY] < n_stream:
        fail(f"tracking launched {POSE_LM} {launches['tracking'][POSE_LM]} and {GREEDY} "
             f"{launches['tracking'][GREEDY]} times for {n_stream} streamed frames "
             "(< 2 and < 1 per frame)")
    if stale:
        fail(f"{stale} of {n_valid} valid points differ between the mirror and the store")
    if sync_errors:
        fail(f"{len(sync_errors)} of {len(checked)} guarded dispatches synchronized with the "
             f"device; the first:\n{sync_errors[0]}")
    if len(guarded) != GUARDED:
        fail(f"{len(guarded)} of the last {GUARDED} frames were dispatched on the stream path")
    return rec


def bench_py_keys():
    """The keys of the dict literal that bench.py prints (read from its
    source, never imported: it is the JAX package's)."""
    import ast

    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    fail("bench.py prints no dict literal")


def phase_bench(tour, tour_gt, smi):
    """bench.py's headline run on the port, on the tour's full 300 frames:
    `bench_torch.run` in this process (kernel launches counted by thread,
    the local BA windows and the good-graph trigger recorded at assembly),
    then `python3 bench_torch.py --frames 60` as a subprocess with its
    default device, which reads the frames from the cache this script's
    render wrote (the first 60: the full run is the in-process one, and the
    script's time limit has no room for a second). Fails unless both print
    bench.py's keys, 260 (subprocess: 20) measured frames and an ATE below
    0.20 m (the subprocess with exit code 0), every frame comes back
    once and OK, BA runs + merged = worker events = KFs created, 1b is
    launched ≥ 4 times per streamed frame by the tracking thread and 1a at
    least once by it. The System's construction launches both kernels
    once (`LoopCloser.warm_up`): those launches are read when it returns,
    kept apart as `launches_construction`, and the counts are set to 0
    again before the first frame."""
    windows = []
    orig_assemble = local_mapping.LocalMapper.ba_assemble
    construction = {}

    def assemble(mapper, kf):
        a = orig_assemble(mapper, kf)
        if a is not None:
            windows.append((a["n_window"], a["n_sel"]))
        return a

    def build_system(*args, **kwargs):
        slam = System(*args, **kwargs)
        torch.cuda.synchronize()
        construction.update(hamming_cuda.launch_counts)
        hamming_cuda.reset_launch_counts()
        return slam

    details = {}
    local_mapping.LocalMapper.ba_assemble = assemble
    bench_torch.System = build_system
    torch.cuda.synchronize()
    hamming_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = bench_torch.run(tour, tour_gt, DEVICE, details=details)
        torch.cuda.synchronize()
    finally:
        local_mapping.LocalMapper.ba_assemble = orig_assemble
        bench_torch.System = System
    run_s = time.perf_counter() - t0
    launches = dict(hamming_cuda.launch_counts)
    by_thread = {"tracking": hamming_cuda.thread_launch_counts("MainThread"),
                 "mapping": hamming_cuda.thread_launch_counts(MAPPING_THREAD),
                 "loop": hamming_cuda.thread_launch_counts(LOOP_THREAD),
                 "gba": hamming_cuda.thread_launch_counts(GBA_THREAD)}
    slam = details["system"]
    stats = slam.tracker.stats
    n_frames = len(tour)
    n_stream = sum(s.path == "stream" and s.frame_id >= bench_torch.SYNC_FRAMES for s in stats)
    n_kf = sum(bool(s.created_kf) for s in stats)
    lstats = slam.loop_closer.stats
    returned, n_kf_events = details["returned"], details["n_kf_events"]
    construct_s = details["construct_s"]
    del details
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"),
                        "--frames", str(BENCH_SUBPROCESS_FRAMES)], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    sub_s = time.perf_counter() - t0
    try:
        sub = json.loads(p.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        sub = None
    keys = bench_py_keys()
    rec = {
        "phase": "bench", "frames": n_frames, "card": smi, "in_process": res,
        "in_process_s": run_s, "subprocess": sub, "subprocess_rc": p.returncode,
        "subprocess_s": sub_s, "subprocess_frames": BENCH_SUBPROCESS_FRAMES,
        "mean_ms": res["value"], "median_ms": res["median_ms"], "p90_ms": res["p90_ms"],
        "prewarm_s": res["prewarm_s"], "system_construct_s": construct_s,
        "loop_warm_up_ms": slam.loop_warm_up_ms,
        "states_ok": sum(s.state == "OK" for s in stats), "stream_frames": n_stream,
        "keyframes_created": n_kf, "n_kf_events": n_kf_events,
        "loop_events": len(lstats), "loop_candidates": sum(st.n_candidates for st in lstats),
        "loops_corrected": sum(st.corrected for st in lstats),
        "loop_detect_ms": spread([e["detect"] for e in slam.loop_closer.event_ms]),
        "loop_candidate_event_ms": [{k: round(v, 1) for k, v in e.items()}
                                    for e in slam.loop_closer.event_ms if e["sim3"] > 0],
        "ba_window_kfs_max": max((w for w, _ in windows), default=0),
        "ba_windows": len(windows),
        "good_graph_trigger_kfs": slam.cfg.good_graph.kf_thres,
        "good_graph_selections": [[w, n] for w, n in windows if n is not None],
        "good_graph_fired": any(n is not None for _, n in windows),
        "launches_construction": construction,
        "launches_run": launches, "launches_by_thread": by_thread,
        "best2_tracking_per_stream_frame": by_thread["tracking"][BEST2] / max(n_stream, 1),
        "pose_lm_tracking_per_stream_frame": by_thread["tracking"][POSE_LM] / max(n_stream, 1),
        "greedy_select_tracking_per_stream_frame":
            by_thread["tracking"][GREEDY] / max(n_stream, 1),
    }
    emit(rec)
    if sub is None or p.returncode != 0:
        fail(f"bench_torch.py exited {p.returncode}:\n" + p.stdout[-2000:] + p.stderr[-3000:])
    for label, r, frames in (("in process", res, n_frames),
                             ("subprocess", sub, BENCH_SUBPROCESS_FRAMES)):
        if list(r) != keys:
            fail(f"bench ({label}): keys {list(r)} are not bench.py's {keys}")
        if r["n_frames_measured"] != frames - bench_torch.WARM:
            fail(f"bench ({label}): {r['n_frames_measured']} frames measured, "
                 f"not {frames - bench_torch.WARM}")
        if not (np.isfinite(r["ate_m"]) and r["ate_m"] < bench_torch.ATE_LIMIT):
            fail(f"bench ({label}): ATE {r['ate_m']} m (bound {bench_torch.ATE_LIMIT} m)")
    if returned != list(range(n_frames)):
        fail(f"bench: frames came back as {len(returned)} ids, "
             f"{len(set(returned))} distinct, of {n_frames}")
    if rec["states_ok"] != n_frames:
        fail(f"bench: tracking left OK: "
             f"{[(s.frame_id, s.state) for s in stats if s.state != 'OK'][:10]}")
    if not res["n_ba_runs"] + res["n_ba_merged"] == rec["n_kf_events"] == n_kf:
        fail(f"bench: BA runs {res['n_ba_runs']} + merged {res['n_ba_merged']}, "
             f"worker events {rec['n_kf_events']}, keyframes created {n_kf}")
    if by_thread["tracking"][BEST2] < 4 * n_stream:
        fail(f"bench: tracking launched {BEST2} {by_thread['tracking'][BEST2]} times for "
             f"{n_stream} streamed frames (< 4 per frame)")
    if by_thread["tracking"][MATRIX] < 1:
        fail(f"bench: the tracking thread did not launch {MATRIX}")
    if by_thread["tracking"][POSE_LM] < 2 * n_stream or by_thread["tracking"][GREEDY] < n_stream:
        fail(f"bench: tracking launched {POSE_LM} {by_thread['tracking'][POSE_LM]} and {GREEDY} "
             f"{by_thread['tracking'][GREEDY]} times for {n_stream} streamed frames "
             "(< 2 and < 1 per frame)")
    return rec


def phase_path_masks(captured):
    """The best-2 kernel checked (tolerance 0) and timed on the inputs of the
    last frame's tracking calls (stereo, motion search, local search,
    leftover search), of the last keyframe event's triangulation and fusion
    searches, of the last corrected loop event's guided Sim3 search and
    search-and-fuse, of the monocular initializer's window search, the last
    monocular, RGB-D and hashed-local-map frames' tracking searches, beside
    the pair it replaces (1a + `masked_best2`)."""
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
    for label in ("sim3_guided", "loop_fuse", "mono_init", "mono_tracking", "rgbd_tracking",
                  "hashing_tracking"):
        if not any(c[0] == label for c in captured):
            fail(f"no {label} search was captured")
    by_caller = {}
    for label in ("tracking", "triangulation", "fusion", "sim3_guided", "loop_fuse",
                  "mono_init", "mono_tracking", "rgbd_tracking", "hashing_tracking"):
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


def loop_config(enabled):
    """The configuration of the JAX package's rendered loop gate
    (tests/test_loop_rendered.py:80-92): the synchronous entry, the global
    BA inline."""
    cam = CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, th_depth=40.0)
    return SystemConfig(
        sensor=Sensor.STEREO, camera=cam, orb=ORBConfig(n_features=800),
        capacity=CapacityConfig(max_keypoints=1024, max_map_points=30000,
                                max_keyframes=160, max_local_points=2048),
        loop=LoopClosingConfig(enabled=enabled, synchronous_gba=True))


def render_loop():
    """The loop circuit of tests/test_loop_rendered.py: 140 frames on 1.27
    turns of a 2.2 m circle in a 9 x 5 x 14 m room."""
    world = RoomWorld(width=9.0, height=5.0, length=14.0)
    poses = trajectory_loop(LOOP_FRAMES, radius=2.2, center=(0.0, 0.0, 7.0), loops=1.27)
    imgs = []
    for R_cw, t_cw in poses:
        left, right = world.render_stereo(R_cw, t_cw, baseline=BASELINE_M, fx=FX, fy=FY,
                                          cx=CX, cy=CY, w=WIDTH, h=HEIGHT)
        imgs.append((np.clip(left, 0, 255).astype(np.uint8),
                     np.clip(right, 0, 255).astype(np.uint8)))
    return imgs, poses


class LoopCapture:
    """Around the loop closer of one System: its own kernel launches (the
    launches made inside `process_keyframe`), the best-2 inputs of its
    guided Sim3 search and search-and-fuse on the last corrected event, and
    each global BA solve's device time and peak memory."""

    def __init__(self, slam):
        self.lc = slam.loop_closer
        self.launches = dict.fromkeys(hamming_cuda.launch_counts, 0)
        self.label, self.event_calls, self.calls = None, [], []
        self.gba = []  # per solve: windows, segments, ms, peak MiB
        self.sim3 = None  # the last Sim3 problem evaluated: kf, c, pc1, pc2, val

    def __enter__(self):
        lc = self.lc
        self._best2 = hamming_mod.distance_best2
        self._process, self._guided, self._fuse = (lc.process_keyframe, lc._guided_refine,
                                                    lc._search_and_fuse)
        self._solve = global_ba.GlobalBARunner.solve

        def best2(da, db, mask):
            if self.label is not None:
                self.event_calls.append((self.label, da.clone(), db.clone(), mask.clone()))
            return self._best2(da, db, mask)

        def labelled(fn, label):
            def run(*a, **k):
                self.label = label
                try:
                    return fn(*a, **k)
                finally:
                    self.label = None
            return run

        def process(kf):
            self.event_calls = []
            before = dict(hamming_cuda.launch_counts)
            try:
                st = self._process(kf)
            finally:
                for name, n in hamming_cuda.launch_counts.items():
                    self.launches[name] += n - before[name]
            if st.corrected:
                self.calls = self.event_calls
            return st

        solve = self._solve
        records = self.gba

        def solve_measured(runner, *a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            ok = solve(runner, *a, **k)
            torch.cuda.synchronize()
            records.append({"windows": len(runner._windows), "segments": runner.n_segments,
                            "kfs": [int(w[0].size) for w in runner._windows],
                            "points": [int(w[1].size) for w in runner._windows],
                            "ms": (time.perf_counter() - t0) * 1e3,
                            "window_ms": runner.window_ms,
                            "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                            "peak_over_base_mib": (torch.cuda.max_memory_allocated() - base) / 2**20})
            return ok

        def keep_sim3(**kw):
            self.sim3 = {k: kw[k] for k in ("kf", "c", "pc1", "pc2", "val")}

        hamming_mod.distance_best2 = best2
        lc.sim3_debug_hook = keep_sim3
        lc.process_keyframe = process
        lc._guided_refine = labelled(self._guided, "sim3_guided")
        lc._search_and_fuse = labelled(self._fuse, "loop_fuse")
        global_ba.GlobalBARunner.solve = solve_measured
        return self

    def __exit__(self, *exc):
        hamming_mod.distance_best2 = self._best2
        global_ba.GlobalBARunner.solve = self._solve
        del self.lc.process_keyframe, self.lc._guided_refine, self.lc._search_and_fuse
        self.lc.sim3_debug_hook = None


def run_loop_circuit(imgs, poses, enabled):
    """One run of the circuit: returns (system, recomposed-trajectory ATE,
    host ms per frame, LoopCapture or None)."""
    slam = System(loop_config(enabled), device=DEVICE)
    cap = LoopCapture(slam) if enabled else None
    frame_ms = []
    if cap is not None:
        cap.__enter__()
    try:
        for i, (left, right) in enumerate(imgs):
            t0 = time.perf_counter()
            slam.track_stereo(left, right, i / 20.0)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        slam.shutdown()
    finally:
        if cap is not None:
            cap.__exit__()
    return slam, recomposed_ate(slam, poses), frame_ms, cap


def recomposed_ate(slam, poses):
    """ATE of the trajectory recomposed from the KFs (frames at i / 20 s)."""
    gt = {i / 20.0: -R.T @ t for i, (R, t) in enumerate(poses)}
    est, ref = [], []
    for ts, T in recompose_trajectory(slam.tracker.relative_poses, slam.store):
        est.append(-T[:3, :3].T @ T[:3, 3])
        ref.append(gt[ts])
    return ate_rmse(np.stack(est), np.stack(ref))


def phase_loop(circuit, render_s):
    """Loop closing on the card, with the JAX package's gate
    (tests/test_loop_rendered.py): the circuit with loop closing off, then on
    (kernel launch counts set to 0 just before, read just after)."""
    imgs, poses = circuit
    _, ate_off, off_ms, _ = run_loop_circuit(imgs, poses, enabled=False)
    hamming_cuda.reset_launch_counts()
    slam, ate_on, on_ms, cap = run_loop_circuit(imgs, poses, enabled=True)
    launches = dict(hamming_cuda.launch_counts)
    lc = slam.loop_closer
    corrected = [(st, ms) for st, ms in zip(lc.stats, lc.event_ms) if st.corrected]
    rec = {
        "phase": "loop", "frames": LOOP_FRAMES, "render_s": render_s,
        "states_ok": sum(st.state == "OK" for st in slam.tracker.stats),
        "keyframes": int(slam.store.n_keyframes), "loop_events": len(lc.stats),
        "events_with_candidates": sum(st.n_candidates > 0 for st in lc.stats),
        "corrected": [dataclasses.asdict(st) for st, _ in corrected],
        "n_fused": sum(st.n_fused for st, _ in corrected),
        "ate_loop_on_m": ate_on, "ate_loop_off_m": ate_off,
        "ate_bound_m": LOOP_ATE_BOUND_M, "ate_ratio_bound": LOOP_ATE_RATIO,
        "loop_ms_per_corrected_event": [ms for _, ms in corrected],
        "loop_ms_per_event": {stage: spread([e[stage] for e in lc.event_ms]) for stage in STAGES},
        "gba": cap.gba,
        "launches_loop": cap.launches, "launches_run": launches,
        "loop_warm_up_ms": slam.loop_warm_up_ms,
        "frame_ms_median_on": statistics.median(on_ms), "frame_ms_median_off": statistics.median(off_ms),
        "frame_ms_max_on": max(on_ms),
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
    }
    emit(rec)
    if not corrected:
        fail("no loop was corrected on the loop circuit")
    if rec["n_fused"] <= 0:
        fail("the loop correction fused no point")
    if not (np.isfinite(ate_on) and ate_on < LOOP_ATE_BOUND_M):
        fail(f"loop-on ATE {ate_on} m >= {LOOP_ATE_BOUND_M} m")
    if not ate_on < LOOP_ATE_RATIO * ate_off:
        fail(f"loop closing must cut drift: on {ate_on} m, off {ate_off} m")
    if cap.launches[MATRIX] < 1 or cap.launches[BEST2] < 1:
        fail(f"the loop closer launched {MATRIX} {cap.launches[MATRIX]} and {BEST2} "
             f"{cap.launches[BEST2]} times")
    if launches[POSE_LM] < 1 or launches[GREEDY] < 1:
        fail(f"the loop circuit's tracking launched {POSE_LM} / {GREEDY} "
             f"{launches[POSE_LM]} / {launches[GREEDY]} times")
    if lc.last_pose_graph is None or lc.last_gba is None:
        fail("no essential graph or global BA was built")
    sim3 = dict(cap.sim3, draws=np.asarray(lc.sim3_draws(cap.sim3["kf"], cap.sim3["c"],
                                                        int(cap.sim3["val"].sum()))))
    return rec, cap.calls, lc.last_pose_graph, lc.last_gba._windows[-1][3], sim3


def solve_and_polish(sim3, device, fix_scale=True):
    """The loop closer's Sim3 stage on one problem: RANSAC on the given draws,
    then the GN polish. Returns (inliers, s, R, t, polished inliers)."""
    cam = loop_config(True).camera
    d = to_device({k: sim3[k] for k in ("pc1", "pc2", "val", "draws")}, device)
    res = solve_sim3(d["pc1"], d["pc2"], d["val"], cam.fx, cam.fy, cam.cx, cam.cy,
                     draws=d["draws"], fix_scale=fix_scale)
    s_o, R_o, t_o, inl_o = optimize_sim3(res.s, res.R, res.t, d["pc1"], d["pc2"], res.inliers,
                                         cam.fx, cam.fy, cam.cx, cam.cy, fix_scale=fix_scale)
    return [x.cpu().numpy() for x in (res.inliers, s_o, R_o, t_o, inl_o)]


def phase_loop_solvers(pg, gba_window, sim3):
    """The last loop event's Sim3 problem (with its own draws), essential
    graph and its global BA's last window, solved on the card and on the
    CPU: inliers exact, Sim3 1e-4, poses 1e-3, cost rtol 1e-3. The card's
    solves are timed cold (the run's first) and warm."""
    sim3_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = solve_and_polish(sim3, DEVICE)
        sim3_ms.append((time.perf_counter() - t0) * 1e3)
    want = solve_and_polish(sim3, "cpu")
    sim3_rec = {"points": int(sim3["val"].sum()), "card_ms_first_then_warm": sim3_ms,
                "inliers_equal": bool((got[0] == want[0]).all() and (got[4] == want[4]).all()),
                "max_abs_d_sRt": max(float(np.abs(g - w).max()) for g, w in zip(got[1:4], want[1:4]))}
    fix_scale = pg["fix_scale"]
    arrays = {k: v for k, v in pg.items() if k != "fix_scale"}
    card = PoseGraphProblem(**to_device(arrays, DEVICE), fix_scale=fix_scale)
    host = PoseGraphProblem(**{k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in arrays.items()}, fix_scale=fix_scale)
    pg_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = optimize_pose_graph(card, iters=15)
        g_cost = float(got[3])
        pg_ms.append((time.perf_counter() - t0) * 1e3)
    want = optimize_pose_graph(host, iters=15)
    pg_rec = {"kfs": int(card.s.shape[0]), "edges": int(card.e_i.shape[0]),
              "cost": g_cost, "cpu_cost": float(want[3]), "card_ms_twice": pg_ms,
              "max_abs_dR": float((got[1].cpu() - want[1]).abs().max()),
              "max_abs_dt": float((got[2].cpu() - want[2]).abs().max()),
              "max_abs_ds": float((got[0].cpu() - want[0]).abs().max())}
    pg_rec["cost_rel_diff"] = abs(g_cost - pg_rec["cpu_cost"]) / max(abs(pg_rec["cpu_cost"]), 1e-12)
    cam = loop_config(True).camera
    prob_c = LocalBAProblem(**to_device(gba_window, DEVICE))
    prob_h = LocalBAProblem(**{k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in gba_window.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    seg_ms = []

    def stop():
        torch.cuda.synchronize()
        seg_ms.append(time.perf_counter())
        return False

    res = global_ba.solve_segments(prob_c, cam, 4, 5, stop)
    stop()
    b_cost = float(res.final_cost)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    ref = global_ba.solve_segments(prob_h, cam, 4, 5)
    gba_rec = {"kfs": int(prob_c.kf_R.shape[0]), "points": int(prob_c.pt_pos.shape[0]),
               "obs": int(prob_c.obs_valid.sum()), "cost": b_cost,
               "cpu_cost": float(ref.final_cost),
               "segment_ms": [(b - a) * 1e3 for a, b in zip(seg_ms, seg_ms[1:])],
               "peak_over_base_mib": peak,
               "max_abs_dR": float((res.kf_R.cpu() - ref.kf_R).abs().max()),
               "max_abs_dt": float((res.kf_t.cpu() - ref.kf_t).abs().max()),
               "max_abs_dX": float((res.pt_pos.cpu() - ref.pt_pos).abs().max())}
    gba_rec["cost_rel_diff"] = abs(b_cost - gba_rec["cpu_cost"]) / max(abs(gba_rec["cpu_cost"]), 1e-12)
    emit({"phase": "loop_solvers", "tolerance": {"pose": BA_POSE_TOL, "cost_rtol": BA_COST_RTOL,
                                                  "sim3": SIM3_TOL},
          "sim3": sim3_rec, "essential_graph": pg_rec, "gba_window": gba_rec})
    if not (sim3_rec["inliers_equal"] and sim3_rec["max_abs_d_sRt"] <= SIM3_TOL):
        fail(f"the Sim3 stage on the card disagrees with the CPU: {sim3_rec}")
    for what, r in (("essential graph", pg_rec), ("GBA window", gba_rec)):
        if not (np.isfinite(r["cost"]) and r["max_abs_dR"] <= BA_POSE_TOL
                and r["max_abs_dt"] <= BA_POSE_TOL and r["cost_rel_diff"] <= BA_COST_RTOL):
            fail(f"{what} on the card disagrees with the CPU: {r}")


# ------------------------------------------- relocalization, mono, RGB-D
class Probe:
    """Around one System's methods (obj, name, label): attributes each
    launch of the four kernels (the two Hamming kernels, the pose LM, the
    greedy selection) to the innermost labelled method it was made in
    ("other" outside them), and keeps copies of the last `keep` inputs per
    label of each Hamming kernel — the best-2 kernel's (da, db, mask), the
    matrix kernel's (da, db) — for the labels in `record`."""

    def __init__(self, targets, keep=4):
        self.targets = targets
        labels = [label for _, _, label in targets] + ["other"]
        self.launches = {lb: dict.fromkeys(hamming_cuda.launch_counts, 0) for lb in labels}
        self.best2 = {lb: collections.deque(maxlen=keep) for lb in labels}
        self.matrix = {lb: collections.deque(maxlen=keep) for lb in labels}
        self.record = set()
        self._stack = []

    def __enter__(self):
        self._b2, self._mx = hamming_mod.distance_best2, hamming_mod.distance_matrix
        self._lm, self._sel = pose_opt.pose_optimization, good_feature.lazier_greedy_select

        def counted(fn, kept=None, n_in=0):
            def run(*a, **k):
                label = self._stack[-1] if self._stack else "other"
                if kept is not None and label in self.record:
                    kept[label].append(tuple(x.clone() for x in a[:n_in]))
                before = dict(hamming_cuda.launch_counts)
                out = fn(*a, **k)
                for name, n in hamming_cuda.launch_counts.items():
                    self.launches[label][name] += n - before[name]
                return out
            return run

        def labelled(fn, label):
            def run(*a, **k):
                self._stack.append(label)
                try:
                    return fn(*a, **k)
                finally:
                    self._stack.pop()
            return run

        hamming_mod.distance_best2 = counted(self._b2, self.best2, 3)
        hamming_mod.distance_matrix = counted(self._mx, self.matrix, 2)
        pose_opt.pose_optimization = counted(self._lm)
        good_feature.lazier_greedy_select = counted(self._sel)
        for obj, name, label in self.targets:
            setattr(obj, name, labelled(getattr(obj, name), label))
        return self

    def __exit__(self, *exc):
        hamming_mod.distance_best2, hamming_mod.distance_matrix = self._b2, self._mx
        pose_opt.pose_optimization, good_feature.lazier_greedy_select = self._lm, self._sel
        for obj, name, _ in self.targets:
            delattr(obj, name)  # the instance attribute: the class's method again

    def calls(self, label, caller, last=None):
        """The kept best-2 inputs of `label` as path_masks calls."""
        kept = list(self.best2[label])
        return [(caller, *c) for c in (kept if last is None else kept[-last:])]


def system_targets(slam):
    targets = [(slam.tracker, "process_frame", "tracking"),
               (slam.tracker, "_relocalize", "reloc"),
               (slam.tracker, "_monocular_initialization", "mono_init"),
               (slam.mapper, "process_keyframe", "mapping")]
    if slam.loop_closer is not None:
        targets.append((slam.loop_closer, "process_keyframe", "loop"))
    return targets


def phase_reloc(circuit):
    """tests/test_reloc_rendered.py on the card: the loop circuit (800
    features, loop closing on — the KF database is the candidate source —
    with the global BA inline), frames 70-75 black, the camera reopening 16
    frames back; LOST in the blackout (or the frame after it), OK again
    within 10 frames, no reset, and the tail frames' ATE."""
    imgs, poses = circuit
    slam = System(loop_config(True), device=DEVICE)
    black = np.zeros((HEIGHT, WIDTH), np.uint8)
    probe = Probe(system_targets(slam), keep=1)
    probe.record = {"reloc"}
    states, kfs, frame_ms, est, gt = [], [], [], {}, {}
    kf_before = 0
    step_args = []  # the inputs of the last `reloc_step` call: the accepted candidate's
    reloc_step = tracker_mod.reloc_step

    def keep_step(*a):
        step_args[:] = a
        return reloc_step(*a)

    tracker_mod.reloc_step = keep_step
    hamming_cuda.reset_launch_counts()
    with probe:
        for i in range(RELOC_FRAMES):
            src = i if i < BLACKOUT[0] else max(i - REWIND, 0)
            if i == BLACKOUT[0]:
                kf_before = slam.store.n_keyframes
            left, right = (black, black) if i in BLACKOUT else imgs[src]
            t0 = time.perf_counter()
            T = slam.track_stereo(left, right, i / 20.0)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            states.append(slam.state.name)
            kfs.append(slam.store.n_keyframes)
            if i not in BLACKOUT and slam.state.name == "OK":
                R_cw, t_cw = poses[src]
                est[i] = -T[:3, :3].T @ T[:3, 3]
                gt[i] = -R_cw.T @ t_cw
        slam.shutdown()
    tracker_mod.reloc_step = reloc_step
    launches = dict(hamming_cuda.launch_counts)
    attempts = slam.tracker.reloc_stats
    ok_after = [i for i in range(BLACKOUT[-1] + 1, RELOC_FRAMES) if states[i] == "OK"]
    tail = [i for i in est if i > BLACKOUT[-1] + 4]
    ate_tail = (ate_rmse(np.stack([est[i] for i in tail]), np.stack([gt[i] for i in tail]))
                if len(tail) >= 3 else float("nan"))
    accepted = [a for a in attempts if a.kf >= 0]
    n_solved = sum(a.n_solved for a in attempts)
    stages, polish = reloc_stages(step_args) if step_args else (None, None)
    rec = {
        "phase": "reloc", "frames": RELOC_FRAMES, "blackout": [BLACKOUT[0], BLACKOUT[-1]],
        "rewind": REWIND, "lost_frames": [i for i, st in enumerate(states) if st == "LOST"],
        "frames_to_recover": (ok_after[0] - BLACKOUT[-1]) if ok_after else None,
        "keyframes_at_blackout": kf_before, "keyframes_min_after": min(kfs[BLACKOUT[0]:]),
        "attempts": [dataclasses.asdict(a) for a in attempts],
        "candidates_per_lost_frame": [a.n_candidates for a in attempts],
        "candidate_source": [a.source for a in attempts],
        "accepted": [dataclasses.asdict(a) for a in accepted],
        "reloc_ms_per_lost_frame": spread([a.ms for a in attempts]),
        "reloc_ms_per_success": spread([a.ms for a in accepted]),
        "tail_frames": len(tail), "ate_tail_m": ate_tail, "ate_tail_bound_m": RELOC_TAIL_ATE_M,
        "launches_run": launches, "launches_by_caller": probe.launches,
        "candidates_solved": n_solved,
        "frame_ms_median": statistics.median(frame_ms),
        "accepted_candidate_by_stage": stages,
    }
    emit(rec)
    if "LOST" not in states[BLACKOUT[0]:BLACKOUT[-1] + 2]:
        fail("the blackout did not make the tracker LOST")
    if not ok_after or ok_after[0] > BLACKOUT[-1] + 10:
        fail(f"no relocalization within 10 frames: {states[BLACKOUT[-1] + 1:BLACKOUT[-1] + 11]}")
    if rec["keyframes_min_after"] < kf_before:
        fail("the system reset instead of relocalizing")
    if not accepted:
        fail("no relocalization attempt was accepted")
    if not (len(tail) >= 25 and ate_tail < RELOC_TAIL_ATE_M):
        fail(f"post-relocalization tail: {len(tail)} frames, ATE {ate_tail} m")
    if probe.launches["reloc"][MATRIX] < 1:
        fail(f"relocalization launched {MATRIX} no time")
    if probe.launches["reloc"][POSE_LM] != n_solved:
        fail(f"relocalization launched {POSE_LM} {probe.launches['reloc'][POSE_LM]} times for "
             f"{n_solved} solved candidates (one LM polish each)")
    if probe.launches["tracking"][POSE_LM] < 1 or probe.launches["tracking"][GREEDY] < 1:
        fail(f"tracking on the circuit launched {POSE_LM} / {GREEDY} "
             f"{probe.launches['tracking'][POSE_LM]} / {probe.launches['tracking'][GREEDY]} times")
    return rec, list(probe.matrix["reloc"]), polish


def reloc_stages(args):
    """One relocalization candidate's `reloc_step` on its own inputs, whole
    and by stage (1a `match_all`, the EPnP RANSAC, the LM polish): host ms
    to a synchronized result (median of 5 after a warm-up call), and the
    device kernels and device-busy ms of one call under torch.profiler.
    Also returns the LM polish's inputs (the pose LM's call, 4 × 10)."""
    cfg, scales, ref_desc, ref_valid, pt_pos, kp_uv, kp_oct, kp_ur, kp_valid, kp_desc, draws = args
    cam = cfg.camera

    def match():
        return matcher.match_all(ref_desc, ref_valid, kp_desc, kp_valid,
                                 th=matcher.TH_LOW, nn_ratio=0.75, mutual=False)

    m = match()
    kp_row = tracker_mod._scatter_matches(
        m.idx, m.valid, torch.arange(ref_desc.shape[0], device=ref_desc.device), kp_uv.shape[0])
    valid, pos = kp_row >= 0, tracker_mod._rows_of(kp_row, pt_pos)
    d = draws(valid.sum())

    def ransac():
        return pnp.pnp_ransac(pos, kp_uv, valid, cam.fx, cam.fy, cam.cx, cam.cy, draws=d)

    res_p = ransac()

    polish_args = ([res_p.R, res_p.t, pos, kp_uv, torch.where(valid, kp_ur, -1.0),
                    tracker_mod._inv_sigma2(scales, kp_oct), valid,
                    cam.fx, cam.fy, cam.cx, cam.cy, cam.bf], {})

    def polish():
        return pose_opt.pose_optimization(*polish_args[0])

    out = {"matches": int(valid.sum())}
    for name, fn in (("reloc_step", lambda: tracker_mod.reloc_step(*args)),
                     ("match_all", match), ("epnp_ransac", ransac), ("pose_lm", polish)):
        out[name] = profiled(fn)
    return out, polish_args


def mono_config(enabled):
    """The configuration of the JAX package's monocular gate
    (tests/test_mono_rendered.py): the loop circuit's camera without a
    baseline, 800 features, the global BA inline."""
    cam = CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=0.0, th_depth=0.0)
    return SystemConfig(
        sensor=Sensor.MONOCULAR, camera=cam, orb=ORBConfig(n_features=800),
        capacity=CapacityConfig(max_keypoints=1024, max_map_points=30000,
                                max_keyframes=160, max_local_points=2048),
        loop=LoopClosingConfig(enabled=enabled, synchronous_gba=True))


def run_mono(circuit, enabled):
    """One monocular run of the circuit's left images: returns (system,
    Sim3-aligned ATE of the recomposed trajectory, frames in it, host ms per
    frame, Probe)."""
    imgs, poses = circuit
    slam = System(mono_config(enabled), device=DEVICE)
    probe = Probe(system_targets(slam), keep=4)
    probe.record = {"mono_init"}
    frame_ms = []
    with probe:
        for i, (left, _) in enumerate(imgs):
            if i == len(imgs) - 1:
                probe.record.add("tracking")  # the last frame's searches
            t0 = time.perf_counter()
            slam.track_monocular(left, i / 20.0)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        slam.shutdown()
    gt = {i / 20.0: -R.T @ t for i, (R, t) in enumerate(poses)}
    est, ref = [], []
    for ts, T in recompose_trajectory(slam.tracker.relative_poses, slam.store):
        est.append(-T[:3, :3].T @ T[:3, 3])
        ref.append(gt[ts])
    ate = ate_rmse(np.stack(est), np.stack(ref), with_scale=True) if len(est) >= 3 else float("nan")
    return slam, ate, len(est), frame_ms, probe


def phase_mono(circuit):
    """tests/test_mono_rendered.py on the card: `track_monocular` on the loop
    circuit, loop closing on (kernel launch counts set to 0 just before, read
    just after), then off; ≥ 100 of 140 frames in the recomposed trajectory,
    a loop corrected with a free scale, the Sim3-aligned ATE below 0.15 m
    and below max(1.5 × loop off, 0.12 m)."""
    hamming_cuda.reset_launch_counts()
    slam, ate_on, n_on, on_ms, probe = run_mono(circuit, True)
    launches = dict(hamming_cuda.launch_counts)
    _, ate_off, n_off, off_ms, _ = run_mono(circuit, False)
    lc = slam.loop_closer
    corrected = [(st, ms) for st, ms in zip(lc.stats, lc.event_ms) if st.corrected]
    inits = slam.tracker.init_stats
    init = next((a for a in inits if a["ok"]), None)
    steady = sorted(on_ms[5:])
    rec = {
        "phase": "mono", "frames": LOOP_FRAMES, "frames_in_trajectory_on": n_on,
        "frames_in_trajectory_off": n_off,
        "states_ok": sum(st.state == "OK" for st in slam.tracker.stats),
        "init_frame": init["frame_id"] if init else None,
        "init_model": ("H" if init["used_h"] else "F") if init else None,
        "init_attempts": inits, "init_ms": spread([a["ms"] for a in inits]),
        "keyframes": int(slam.store.n_keyframes), "map_points": int(slam.store.n_points),
        "fix_scale": lc.fix_scale, "loop_events": len(lc.stats),
        "corrected": [dataclasses.asdict(st) for st, _ in corrected],
        "loop_ms_per_corrected_event": [ms for _, ms in corrected],
        "ate_sim3_loop_on_m": ate_on, "ate_sim3_loop_off_m": ate_off,
        "ate_bound_m": MONO_ATE_BOUND_M, "no_harm_bound_m": max(1.5 * ate_off, 0.12),
        "frame_ms_median": statistics.median(steady),
        "frame_ms_p90": steady[int(0.9 * (len(steady) - 1))],
        "frame_ms_median_off": statistics.median(off_ms[5:]),
        "launches_run": launches, "launches_by_caller": probe.launches,
    }
    emit(rec)
    if n_on < MONO_MIN_FRAMES or n_off < MONO_MIN_FRAMES:
        fail(f"mono tracked {n_on} (loop on) / {n_off} (off) of {LOOP_FRAMES} frames")
    if init is None:
        fail("the monocular tracker never initialized")
    if not corrected or lc.fix_scale is not False:
        fail(f"{len(corrected)} mono loops corrected, fix_scale {lc.fix_scale}")
    if not (np.isfinite(ate_on) and ate_on < MONO_ATE_BOUND_M):
        fail(f"mono ATE (Sim3-aligned) {ate_on} m >= {MONO_ATE_BOUND_M} m")
    if not ate_on < max(1.5 * ate_off, 0.12):
        fail(f"mono loop closing degraded ATE: on {ate_on} m, off {ate_off} m")
    if probe.launches["mono_init"][BEST2] < 1 or probe.launches["tracking"][BEST2] < 1:
        fail(f"mono initialization / tracking launched {BEST2} "
             f"{probe.launches['mono_init'][BEST2]} / {probe.launches['tracking'][BEST2]} times")
    if probe.launches["tracking"][POSE_LM] < 1 or probe.launches["tracking"][GREEDY] < 1:
        fail(f"mono tracking launched {POSE_LM} / {GREEDY} {probe.launches['tracking'][POSE_LM]}"
             f" / {probe.launches['tracking'][GREEDY]} times")
    calls = probe.calls("mono_init", "mono_init", last=1) + probe.calls("tracking", "mono_tracking")
    return rec, calls


def room_depth(R_cw, t_cw, world, w=WIDTH, h=HEIGHT):
    """The renderer's own ray depth of one view, in metres: for every pixel
    the nearest of the room's six faces along its ray, intersected as
    tests/rendered_world.py's RoomWorld.render does. Its rays have camera
    z = 1, so the ray parameter of the hit is the depth; 0 where no face is
    hit."""
    R_wc, o = R_cw.T, -R_cw.T @ t_cw
    us, vs = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    d = np.stack([(us - CX) / FX, (vs - CY) / FY, np.ones_like(us)], -1).reshape(-1, 3) @ R_wc.T
    best = np.full(d.shape[0], np.inf, np.float32)
    W2, H2, L = world.W / 2, world.H / 2, world.L
    planes = [(2, L, (0, -W2, W2), (1, -H2, H2)), (2, 0.0, (0, -W2, W2), (1, -H2, H2)),
              (0, -W2, (2, 0.0, L), (1, -H2, H2)), (0, W2, (2, 0.0, L), (1, -H2, H2)),
              (1, H2, (0, -W2, W2), (2, 0.0, L)), (1, -H2, (0, -W2, W2), (2, 0.0, L))]
    for ax, val, (ua, ulo, uhi), (va, vlo, vhi) in planes:
        dz = d[:, ax]
        with np.errstate(divide="ignore", invalid="ignore"):
            t_hit = (val - o[ax]) / dz
            pu = o[ua] + t_hit * d[:, ua]
            pv = o[va] + t_hit * d[:, va]
        ok = ((np.abs(dz) > 1e-9) & (t_hit > 0.05) & (t_hit < best)
              & (pu >= ulo) & (pu <= uhi) & (pv >= vlo) & (pv <= vhi))
        best[ok] = t_hit[ok]
    return np.where(np.isfinite(best), best, 0.0).astype(np.float32).reshape(h, w)


def phase_rgbd(imgs, gt, stereo_ate):
    """`track_rgbd` on the room tour's first RGBD_FRAMES frames at the headline
    configuration (synchronous local mapping) with `Sensor.RGBD`: the left
    images and the renderer's ray depth in metres (depth_map_factor 1). No
    JAX figure exists on this scene: the gate is every frame OK from frame 0 and
    ATE < 0.10 m, twice the synchronous stereo gate."""
    base = headline_config()
    cfg = base.replace(sensor=Sensor.RGBD,
                       camera=dataclasses.replace(base.camera, depth_map_factor=1.0))
    world = RoomWorld(width=9.0, height=5.5, length=13.0)
    n = len(imgs)
    poses = trajectory_tour(TOUR_FRAMES)[:n]
    t0 = time.perf_counter()
    depths = [room_depth(R, t, world) for R, t in poses]
    depth_s = time.perf_counter() - t0
    slam = System(cfg, device=DEVICE)
    probe = Probe(system_targets(slam), keep=4)
    est, frame_ms = [], []
    hamming_cuda.reset_launch_counts()
    with probe:
        for i, ((left, _), depth) in enumerate(zip(imgs, depths)):
            if i == n - 1:
                probe.record = {"tracking"}
            t0 = time.perf_counter()
            T = slam.track_rgbd(left, depth, i / 20.0)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            est.append(-T[:3, :3].T @ T[:3, 3])
        slam.shutdown()
    launches = dict(hamming_cuda.launch_counts)
    stats = slam.tracker.stats
    est = np.stack(est)
    ate = ate_rmse(est, gt)
    steady = sorted(frame_ms[5:])
    rec = {
        "phase": "rgbd", "frames": n, "depth_render_s": depth_s,
        "init_keypoints": stats[0].n_features, "states_ok": sum(st.state == "OK" for st in stats),
        "fused_frames": sum(st.path == "fused" for st in stats),
        "keyframe_events": sum(bool(st.created_kf) for st in stats),
        "mapper_events": len(slam.mapper.stats), "map_points": int(slam.store.n_points),
        "ate_rmse_m": ate, "ate_bound_m": RGBD_ATE_BOUND_M, "ate_stereo_main_path_m": stereo_ate,
        "frame_ms_median": statistics.median(steady),
        "frame_ms_p90": steady[int(0.9 * (len(steady) - 1))],
        "launches_run": launches, "launches_by_caller": probe.launches,
    }
    emit(rec)
    if stats[0].state != "OK":
        fail(f"RGB-D frame 0 did not initialise: {stats[0]}")
    if any(st.state != "OK" for st in stats):
        fail(f"RGB-D tracking left OK: {[(st.frame_id, st.state) for st in stats if st.state != 'OK'][:10]}")
    if not (np.isfinite(est).all() and ate < RGBD_ATE_BOUND_M):
        fail(f"RGB-D ATE {ate} m >= {RGBD_ATE_BOUND_M} m")
    if probe.launches["tracking"][BEST2] < 1 or probe.launches["mapping"][BEST2] < 1:
        fail(f"RGB-D tracking / mapping launched {BEST2} {probe.launches['tracking'][BEST2]} / "
             f"{probe.launches['mapping'][BEST2]} times")
    if probe.launches["tracking"][POSE_LM] < 1 or probe.launches["tracking"][GREEDY] < 1:
        fail(f"RGB-D tracking launched {POSE_LM} / {GREEDY} {probe.launches['tracking'][POSE_LM]}"
             f" / {probe.launches['tracking'][GREEDY]} times")
    return rec, probe.calls("tracking", "rgbd_tracking")


# ------------------------------------------- hashing, map IO, hybrid state
HASH_MIN_POINTS = 2000   # tests/test_hashing_rendered.py: the map crosses the trigger
HASH_MIN_QUERIES = 20
MAP_IO_SYNC = range(100, 125)       # tour frames replayed through track_stereo
MAP_IO_PIPELINED = range(125, 150)  # then through track_stereo_pipelined
MAP_IO_OK_SHARE = 0.8
MAP_IO_FIRST_OK = 5       # OK within this many frames of the first
MAP_IO_CENTRE_M = 0.1     # tests/test_map_io.py: camera-centre error of an OK frame
HYBRID_ATE_BOUND_M = 0.10  # no JAX figure for this mode: twice the synchronous gate


def hashing_config():
    """tests/test_hashing_rendered.py:36-46: the loop circuit's configuration
    with hashing on, COMBINED local maps, loop closing off."""
    return loop_config(False).replace(
        hashing=HashingConfig(enabled=True),
        tracking=TrackingConfig(local_map_mode=LocalMapMode.COMBINED))


def phase_hashing(circuit, ate_covis):
    """Hashed local maps on the loop circuit (tests/test_hashing_rendered.py):
    the map crosses the 2000-point trigger, the tables serve > 20 queries,
    online table selection keeps `n_active` tables, and the recomposed ATE
    stays within max(1.2 c, c + 0.02) of phase `loop`'s loop-off run c (the
    same configuration without hashing: the JAX test's covisibility arm)."""
    imgs, poses = circuit
    slam = System(hashing_config(), device=DEVICE)
    mih = slam.tracker.mih
    if mih is None or mih is not slam.mapper.mih:
        fail("hashing on built no multi-index hash shared by the tracker and the mapper")
    queries, budgets = [], [mih.candidate_budget]  # (frame, host ms, candidates)
    query, dynamics = mih.query, mih.update_dynamics

    def timed_query(desc, max_out=None):
        t0 = time.perf_counter()
        out = query(desc, max_out)
        queries.append((slam.frame_id, (time.perf_counter() - t0) * 1e3, int(out.size)))
        return out

    def kept_dynamics(n, *a, **k):
        dynamics(n, *a, **k)
        budgets.append(mih.candidate_budget)

    mih.query, mih.update_dynamics = timed_query, kept_dynamics
    probe = Probe(system_targets(slam), keep=4)
    frame_ms = []
    hamming_cuda.reset_launch_counts()
    with probe:
        for i, (left, right) in enumerate(imgs):
            if i == LOOP_FRAMES - 1:  # the last frame's searches join path_masks
                probe.record = {"tracking"}
            t0 = time.perf_counter()
            slam.track_stereo(left, right, i / 20.0)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        slam.shutdown()
    launches = dict(hamming_cuda.launch_counts)
    del mih.query, mih.update_dynamics
    ate = recomposed_ate(slam, poses)
    stats = slam.tracker.stats
    served = sorted({f for f, _, _ in queries})
    per_frame_ms = collections.defaultdict(float)
    for f, ms, _ in queries:
        per_frame_ms[f] += ms
    bound = max(1.2 * ate_covis, ate_covis + 0.02)
    rec = {
        "phase": "hashing", "frames": LOOP_FRAMES,
        "states_ok": sum(st.state == "OK" for st in stats),
        "map_points": int(slam.store.n_points), "keyframes": int(slam.store.n_keyframes),
        "trigger": slam.cfg.hashing.map_size_trigger, "n_queries": mih.n_queries,
        "frames_served_by_hashing": len(served),
        "first_hashed_frame": served[0] if served else None,
        "candidates_per_query": spread([n for _, _, n in queries]),
        "candidate_budget_range": [min(budgets), max(budgets)],
        "pool_size_per_frame": spread([st.n_local_points for st in stats[1:]]),
        "query_host_ms_per_frame": spread(list(per_frame_ms.values())),
        "insert_and_table_selection_host_ms_per_kf_event":
            spread([e["hash"] for e in slam.mapper.event_ms]),
        "active_tables": mih.active_tables.tolist(), "n_active": mih.n_active,
        "table_sizes": mih.table_sizes().tolist(),
        "ate_m": ate, "ate_covisibility_m": ate_covis, "ate_bound_m": bound,
        "frame_ms_median": statistics.median(frame_ms),
        "launches_run": launches, "launches_by_caller": probe.launches,
    }
    emit(rec)
    if slam.store.n_points <= HASH_MIN_POINTS:
        fail(f"map too small to trigger hashing: {slam.store.n_points} points")
    if mih.n_queries <= HASH_MIN_QUERIES:
        fail(f"the hash tables served {mih.n_queries} queries (<= {HASH_MIN_QUERIES})")
    if len(mih.active_tables) != mih.n_active:
        fail(f"{len(mih.active_tables)} active tables, {mih.n_active} asked for")
    if not (np.isfinite(ate) and ate < bound):
        fail(f"hash-combined ATE {ate} m, covisibility {ate_covis} m (bound {bound} m)")
    if probe.launches["tracking"][BEST2] < 1:
        fail(f"hashed tracking launched {BEST2} no time")
    if probe.launches["tracking"][POSE_LM] < 1 or probe.launches["tracking"][GREEDY] < 1:
        fail(f"hashed tracking launched {POSE_LM} / {GREEDY} "
             f"{probe.launches['tracking'][POSE_LM]} / {probe.launches['tracking'][GREEDY]} times")
    return rec, probe.calls("tracking", "hashing_tracking")


def _npz_arrays(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def phase_map_io(imgs, gt, main):
    """tests/test_map_io.py on the card, on the main path's map: saved,
    loaded into a fresh System of the same configuration in localization
    mode, then tour frames 100-124 through `track_stereo` and 125-149
    through `track_stereo_pipelined` + `flush_pipeline()`. The centre error
    of a replayed frame is taken in the ground truth's frame through the
    main path's own alignment (its ATE fit)."""
    src = main["system"]
    with tempfile.TemporaryDirectory() as d:
        path, again = os.path.join(d, "tour.npz"), os.path.join(d, "again.npz")
        t0 = time.perf_counter()
        src.save_map(path)
        save_ms = (time.perf_counter() - t0) * 1e3
        slam = System(headline_config(), device=DEVICE)
        t0 = time.perf_counter()
        slam.load_map(path)
        load_ms = (time.perf_counter() - t0) * 1e3
        slam.activate_localization_mode()
        s, r = slam.store, src.store
        loaded_equal = (s.n_points == r.n_points and s.n_keyframes == r.n_keyframes
                        and np.array_equal(s.kf_R, r.kf_R) and np.array_equal(s.point_pos, r.point_pos))
        slam.save_map(again)
        a, b = _npz_arrays(path), _npz_arrays(again)
        roundtrip_equal = a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        n_kf = s.n_keyframes
        kfdb_size = int(slam.kfdb.present.sum()) if slam.kfdb is not None else 0
        probe = Probe(system_targets(slam), keep=1)
        sync_ms, call_ms, poses = [], [], {}
        hamming_cuda.reset_launch_counts()
        with probe:
            for i in MAP_IO_SYNC:
                t0 = time.perf_counter()
                poses[i] = slam.track_stereo(imgs[i][0], imgs[i][1], i / 20.0)
                torch.cuda.synchronize()
                sync_ms.append((time.perf_counter() - t0) * 1e3)
            first = MAP_IO_SYNC[0]  # the fresh System counts its frames from 0
            for i in MAP_IO_PIPELINED:
                t0 = time.perf_counter()
                done = slam.track_stereo_pipelined(imgs[i][0], imgs[i][1], i / 20.0)
                call_ms.append((time.perf_counter() - t0) * 1e3)
                poses.update({first + fid: T for fid, T in done})
            poses.update({first + fid: T for fid, T in slam.flush_pipeline()})
        launches = dict(hamming_cuda.launch_counts)
        mirror = slam.store.mirror
        stale, n_valid = _mirror_stale_rows(slam.store) if mirror is not None else (None, 0)
        slam.shutdown()
    stats = slam.tracker.stats
    replayed = list(MAP_IO_SYNC) + list(MAP_IO_PIPELINED)
    states = {MAP_IO_SYNC[0] + st.frame_id: st.state for st in stats}
    ok = [i for i in replayed if states.get(i) == "OK"]
    # the main path's alignment of its estimate onto the ground truth
    sc, Ra, ta = umeyama_align(main["est"], gt)
    err = {}
    for i in ok:
        T = poses[i]
        c = sc * Ra @ (-T[:3, :3].T @ T[:3, 3]) + ta
        err[i] = float(np.linalg.norm(c - gt[i]))
    attempts = slam.tracker.reloc_stats
    rec = {
        "phase": "map_io", "map_keyframes": n_kf, "map_points": int(r.n_points),
        "save_ms": save_ms, "load_ms": load_ms, "kfdb_after_load": kfdb_size,
        "loaded_equal": bool(loaded_equal), "save_load_save_equal": bool(roundtrip_equal),
        "replayed": [replayed[0], replayed[-1]], "states_ok": len(ok),
        "first_ok": ok[0] if ok else None,
        "centre_error_m": spread(list(err.values())), "centre_bound_m": MAP_IO_CENTRE_M,
        "keyframes_after": int(slam.store.n_keyframes), "mapper_events": len(slam.mapper.stats),
        "streamed_frames": sum(st.path == "stream" for st in stats),
        "stream_fallbacks": slam.n_stream_fallbacks,
        "mirror_stale_rows": stale, "mirror_valid_rows": n_valid,
        "reloc_attempts": [dataclasses.asdict(x) for x in attempts],
        "reloc_host_ms": [x.ms for x in attempts],
        "reloc_launches": probe.launches["reloc"],
        "frame_ms_median_sync": statistics.median(sync_ms),
        "call_ms_median_pipelined": statistics.median(call_ms),
        "launches_run": launches, "launches_by_caller": probe.launches,
    }
    emit(rec)
    if not loaded_equal:
        fail("the loaded store differs from the saved one (counts, kf_R or points)")
    if not roundtrip_equal:
        fail("save -> load -> save changed the map file's arrays")
    if not ok or ok[0] >= replayed[0] + MAP_IO_FIRST_OK:
        fail(f"not OK within {MAP_IO_FIRST_OK} frames of the first: "
             f"{[states.get(i) for i in replayed[:MAP_IO_FIRST_OK]]}")
    if len(ok) < MAP_IO_OK_SHARE * len(replayed):
        fail(f"{len(ok)} of {len(replayed)} replayed frames OK (< {MAP_IO_OK_SHARE:.0%})")
    if max(err.values()) >= MAP_IO_CENTRE_M:
        fail(f"camera-centre error up to {max(err.values())} m on an OK frame")
    if slam.store.n_keyframes != n_kf or slam.mapper.stats:
        fail("localization mode added a keyframe or mapped one")
    if stale != 0:
        fail(f"device map mirror: {stale} of {n_valid} valid rows differ from the store")
    if probe.launches["reloc"][MATRIX] < 1:
        fail(f"relocalization against the loaded map launched {MATRIX} no time")
    if probe.launches["reloc"][POSE_LM] < 1 or launches[GREEDY] < 1:
        fail(f"on the loaded map {POSE_LM} was launched {probe.launches['reloc'][POSE_LM]} "
             f"times by relocalization, {GREEDY} {launches[GREEDY]} times")
    return rec


def phase_hybrid(imgs, gt, main_rec):
    """The headline room tour with the 13-state (hybrid) good-feature
    selection and planner odometry: each frame's ground-truth pose is
    buffered before the frame (`buffer_odometry`), through `track_stereo`
    with synchronous mapping. Every frame OK; every frame that predicts a
    search window (all but the initial one and the next, which matches
    against the reference KF without a velocity) predicts it from the
    buffer; ATE < 0.10 m."""
    n = len(imgs)
    poses = trajectory_tour(TOUR_FRAMES)[:n]
    base = headline_config()
    cfg = base.replace(good_feature=dataclasses.replace(base.good_feature, info_mat_size=13))
    slam = System(cfg, device=DEVICE)
    probe = Probe(system_targets(slam), keep=1)
    est, frame_ms = [], []
    hamming_cuda.reset_launch_counts()
    with probe, KeepLast(good_feature, "lazier_greedy_select") as sel:
        for i, (left, right) in enumerate(imgs):
            R_cw, t_cw = poses[i]
            slam.buffer_odometry(i / 20.0, R_cw, t_cw)
            t0 = time.perf_counter()
            T = slam.track_stereo(left, right, i / 20.0)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            est.append(-T[:3, :3].T @ T[:3, 3])
        slam.shutdown()
    launches = dict(hamming_cuda.launch_counts)
    stats = slam.tracker.stats
    est = np.stack(est)
    ate = ate_rmse(est, gt)
    predicting = sum(st.path in ("fused", "motion") for st in stats)
    steady = sorted(frame_ms[5:])
    rec = {
        "phase": "hybrid", "frames": n, "info_mat_size": 13,
        "states_ok": sum(st.state == "OK" for st in stats),
        "fused_frames": sum(st.path == "fused" for st in stats),
        "predicting_frames": predicting, "odometry_predictions": slam.tracker.n_odom_predictions,
        "keyframe_events": sum(bool(st.created_kf) for st in stats),
        "mapper_events": len(slam.mapper.stats),
        "ate_rmse_m": ate, "ate_bound_m": HYBRID_ATE_BOUND_M,
        "ate_main_path_m": main_rec["ate_rmse_m"],
        "frame_ms_median": statistics.median(steady),
        "frame_ms_p90": steady[int(0.9 * (len(steady) - 1))],
        "frame_ms_median_main_path": main_rec["frame_ms_median"],
        "selection_last_frame": selection_cost(sel) if sel.args else None,
        "selection_last_frame_main_path": main_rec["selection_last_frame"],
        "launches_run": launches, "launches_by_caller": probe.launches,
    }
    emit(rec)
    if any(st.state != "OK" for st in stats):
        fail(f"hybrid tracking left OK: {[(st.frame_id, st.state) for st in stats if st.state != 'OK'][:10]}")
    if predicting < n - 2 or slam.tracker.n_odom_predictions != predicting:
        fail(f"{slam.tracker.n_odom_predictions} buffer predictions for {predicting} predicting "
             f"frames of {n}")
    if not (np.isfinite(est).all() and ate < HYBRID_ATE_BOUND_M):
        fail(f"hybrid ATE {ate} m >= {HYBRID_ATE_BOUND_M} m")
    if sel.args is None or sel.args[0][0].shape[-1] != 13:
        fail("the 13-state selection did not run")
    if probe.launches["tracking"][BEST2] < 1:
        fail(f"hybrid tracking launched {BEST2} no time")
    if probe.launches["tracking"][POSE_LM] < 1 or probe.launches["tracking"][GREEDY] < 1:
        fail(f"hybrid tracking launched {POSE_LM} / {GREEDY} {probe.launches['tracking'][POSE_LM]}"
             f" / {probe.launches['tracking'][GREEDY]} times")
    return rec, ("hybrid_d13", sel.args)


# ----------------------------------- the pose LM and the greedy selection
# R, t: the pose LM kernel against its plain version. The two sum H, b and
# the costs in other orders and solve by Cholesky / LU, so at a cost plateau
# they can take an LM step differently: measured over all 298 solves of the
# main path (tools/kernel_vs_plain_torch.py on an H100) up to 7.1e-3 m
# in t and 8.0e-4 in R on one solve, which the two end one inlier apart
# (on the kernel's inliers its pose scores the lower robust cost), and
# below 5.5e-4 m on every other; 1e-2 holds that level with headroom.
# Inliers and n_inliers are held exactly on the held inputs.
POSE_TOL = 1e-2
SELECT_TIE = 0.02      # a swapped pick's plain scores: the float32 logdet near-tie band
SELECT_OBJ_RTOL = 1e-3  # the selection's logdet where picks differ
# float32 operations a point, counted from csrc/pose_lm.cu's arithmetic: the
# Jacobian pass (projection 36, Huber 6, Jacobian 38, normal equations 180)
# and the candidate's cost pass (42) of a step; the first cost pass and the
# final gate (78) once
POSE_FLOPS_STEP, POSE_FLOPS_ONCE = 302, 78
# the selection's information matrices: the pool's and the base bit for bit
# the plain version's (the kernel rounds as cuBLAS and torch's launches do on
# the card; tests/test_torch_obs_info.py), on the main path's last
# OBS_INFO_KEEP calls
OBS_INFO_KEEP = 8
# float32 operations a row, counted from csrc/obs_info.cu's arithmetic:
# d and p_c 18, the depth's clamp and inverse 3, the projection derivative
# 12, -R(q)ᵀ 9, the quaternion derivative 105 and its tangent 84, H 105,
# the weight 4, (H w)ᵀ H 392; the keypoints' sum 49 a row
OBS_FLOPS_ROW, OBS_FLOPS_BASE_ROW = 732, 49


def logdet_flops(d):
    """float32 operations of one candidate's logdet in csrc/greedy_select.cu:
    the scaling (3 a diagonal entry, 4 a lower entry), the Cholesky and the
    logs."""
    chol = sum(2 * j + 5 + (d - 1 - j) * (2 * j + 1) for j in range(d))
    return 3 * d + 4 * d * (d + 1) // 2 + chol + 2 * d + 2


def bound(bytes_, flops):
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def pose_call(kept):
    """A kept `pose_optimization` call → (contiguous tensors, camera,
    rounds, iters, damping)."""
    a, kw = kept
    tensors = [x.contiguous() for x in a[:7]]
    rest = dict(zip(("rounds", "iters", "damping"), a[12:]), **kw)
    return (tensors, [float(x) for x in a[7:12]], rest.get("rounds", 4),
            rest.get("iters", 10), rest.get("damping", 1e-5))


def hold_pose(label, tensors, cam, rounds, iters, damping):
    got = pose_lm_cuda.pose_lm(*tensors, *cam, rounds, iters, damping)
    want = pose_opt.pose_optimization_ref(*tensors, *cam, rounds, iters, damping)
    err = max(float((got[0] - want.R).abs().max()), float((got[1] - want.t).abs().max()))
    return {"case": label, "n": int(tensors[2].shape[0]), "valid": int(tensors[6].sum()),
            "rounds": rounds, "iters": iters, "max_abs_err": err,
            "inliers_equal": bool(torch.equal(got[2], want.inliers)),
            "n_inliers": int(got[3]), "n_inliers_plain": int(want.n_inliers),
            "ok": err <= POSE_TOL and bool(torch.equal(got[2], want.inliers))
                  and int(got[3]) == int(want.n_inliers)}, got, want


def time_pose(tensors, cam, rounds, iters, damping):
    def kernel():
        return pose_lm_cuda.pose_lm(*tensors, *cam, rounds, iters, damping)

    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        kernel()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    plain = profiled(lambda: pose_opt.pose_optimization_ref(*tensors, *cam, rounds, iters,
                                                            damping), repeats=3)
    n = int(tensors[2].shape[0])
    steps = rounds * iters
    rec = {"ms": time_cuda_graph(kernel, 20, 10), "call_ms": time_cuda(kernel, 20, 10),
           "host_ms": statistics.median(host), "plain_ms": plain["ms"],
           "plain_device_kernels": plain["device_kernels"],
           "plain_device_busy_ms": plain["device_busy_ms"]}
    # inputs read once (R0, t0, 29 bytes a point), outputs written once
    rec.update(bound(48 + 29 * n + 48 + 5 * n + 8,
                     n * (POSE_FLOPS_STEP * steps + POSE_FLOPS_ONCE)))
    return rec


def select_call(kept):
    """A kept `lazier_greedy_select` call → its tensors and options."""
    (obs_mats, valid, n_select, _gen), kw = kept
    return (obs_mats.contiguous(), valid.contiguous(), int(n_select),
            kw.get("lazier_factor", 10), kw.get("base_mat"), kw.get("eps", 1e-3),
            kw.get("batch", 8))


def plain_round_scores(M, valid, cur, selected, u_k, inv_l, eps):
    """The plain version's scores of one round (selection/good_feature.py
    `lazier_greedy_select_ref`'s round body), for the near-tie check."""
    from gf_orb_slam2_tpu_torch.selection.observability import logdet_psd

    D = M.shape[-1]
    cand = valid & ~selected
    sampled = cand if u_k is None else cand & (u_k < inv_l)
    sampled = torch.where(sampled.any(), sampled, cand)
    ld = logdet_psd(cur[None] + M + eps * torch.eye(D, device=M.device)[None], eps)
    score = torch.where(sampled, ld, float("-inf"))
    fb = torch.where(cand, torch.einsum("pii->p", M) - 1e12, float("-inf"))
    return torch.maximum(score, fb), sampled


def hold_select(label, M, valid, n_select, lazier, base, eps, batch, u):
    """The kernel against the plain version on the same uniforms: the same
    picks in the same order, or where they part, each differing pick of the
    first round that parts scored within SELECT_TIE of the one it displaced
    (plain scores), and the selection's logdet within SELECT_OBJ_RTOL."""
    got = greedy_select_cuda.greedy_select(M, valid, n_select, batch, lazier, eps, base, u)
    want = good_feature.lazier_greedy_select_ref(M, valid, n_select, None, lazier, base, eps,
                                                 batch, uniforms=u)
    B = max(1, min(batch, n_select))
    inv_l = 1.0 / max(lazier, 1)
    g, w = got[1].tolist(), want[1].tolist()
    cur = torch.zeros_like(M[0]) if base is None else base.clone()
    selected = torch.zeros_like(valid)
    sampled_total = cand_total = 0
    first, gap = None, 0.0
    for k in range(-(-n_select // B)):
        u_k = None if u is None else u[k]
        score, sampled = plain_round_scores(M, valid, cur, selected, u_k, inv_l, eps)
        sampled_total += int(sampled.sum())
        cand_total += int((valid & ~selected).sum())
        rows = range(k * B, min((k + 1) * B, n_select))
        if first is None and any(g[i] != w[i] for i in rows):
            first = k
            for i in rows:
                if g[i] != w[i]:
                    if min(g[i], w[i]) < 0:
                        gap = float("inf")
                    else:
                        gap = max(gap, abs(float(score[g[i]]) - float(score[w[i]])))
        picks = [p for p in (w[i] for i in rows) if p >= 0]
        if picks:
            selected[picks] = True
            cur = cur + M[picks].sum(0)
    obj_got = float(good_feature.selection_logdet(M, got[0], base, eps))
    obj_want = float(good_feature.selection_logdet(M, want[0], base, eps))
    same = g == w and bool(torch.equal(got[0], want[0]))
    rec = {"case": label, "P": int(M.shape[0]), "D": int(M.shape[-1]),
           "candidates": int(valid.sum()), "n_select": n_select, "lazier_factor": lazier,
           "same": same, "picks_differing": sum(a != b for a, b in zip(g, w)),
           "first_round_parting": first, "tie_gap": gap,
           "objective": obj_got, "objective_plain": obj_want,
           "max_abs_err": abs(obj_got - obj_want),
           "sampled_total": sampled_total, "candidates_total": cand_total}
    rec["ok"] = same or (gap <= SELECT_TIE
                         and abs(obj_got - obj_want) <= SELECT_OBJ_RTOL * abs(obj_want))
    return rec


def time_select(M, valid, n_select, lazier, base, eps, batch, u, hold):
    def kernel():
        return greedy_select_cuda.greedy_select(M, valid, n_select, batch, lazier, eps, base, u)

    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        kernel()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    plain = profiled(lambda: good_feature.lazier_greedy_select_ref(
        M, valid, n_select, None, lazier, base, eps, batch, uniforms=u), repeats=3)
    P, D = M.shape[0], M.shape[-1]
    B = max(1, min(batch, n_select))
    rounds = -(-n_select // B)
    rec = {"ms": time_cuda_graph(kernel, 20, 5), "call_ms": time_cuda(kernel, 20, 5),
           "host_ms": statistics.median(host), "plain_ms": plain["ms"],
           "plain_device_kernels": plain["device_kernels"],
           "plain_device_busy_ms": plain["device_busy_ms"]}
    # obs_mats, valid, base and the uniforms read once; selected and order
    # written once; the logdets of this run's sampled candidates and a trace
    # and a compare for every candidate of every round
    rec.update(bound(P * D * D * 4 + P + D * D * 4 + (0 if u is None else u.numel() * 4)
                     + P + rounds * B * 8,
                     hold["sampled_total"] * logdet_flops(D) + hold["candidates_total"] * (D + 1)))
    return rec


def cap_problem(P, D):
    """P random information-like matrices (PSD, condition ~10, scales 0.5-2),
    85 % of them valid, and the first five's sum as the base, from a seed."""
    gen = torch.Generator(device=DEVICE).manual_seed(15 + D)
    A = torch.randn((P, D, D), generator=gen, device=DEVICE)
    M = A @ A.transpose(1, 2) / D + torch.eye(D, device=DEVICE)
    M = M * (0.5 + 1.5 * torch.rand((P, 1, 1), generator=gen, device=DEVICE))
    valid = torch.rand(P, generator=gen, device=DEVICE) < 0.85
    return M.contiguous(), valid, M[:5].sum(0).contiguous()


def pose_edge_cases(tensors, cam):
    """No valid point (the pose bit for bit), every point behind the camera
    (no NaN), a non-finite point (every step rejected by both)."""
    R0, t0, X, uv, ur, inv2, valid = tensors
    out = []
    for label, case in (("no_valid", [R0, t0, X, uv, ur, inv2, torch.zeros_like(valid)]),
                        ("behind_camera", [R0, t0, -X, uv, ur, inv2, torch.ones_like(valid)]),
                        ("non_finite_point", [R0, t0, torch.where(
                            torch.arange(X.shape[0], device=X.device)[:, None] == 0,
                            float("nan"), X).contiguous(), uv, ur, inv2, valid])):
        rec, got, _ = hold_pose(label, case, cam, 3, 8, 1e-5)
        finite = all(bool(torch.isfinite(x).all()) for x in got[:2])
        if label == "no_valid":
            rec["ok"] &= bool(torch.equal(got[0], R0) and torch.equal(got[1], t0))
        if label == "behind_camera":
            rec["ok"] &= int(got[3]) == 0
        rec["ok"] &= finite
        out.append(rec)
    return out


def hold_obs_info(label, kept, gen):
    """The information-matrix kernel against its plain version on one kept
    call, bit for bit, a rerun bit for bit, and the greedy selection (kernel
    3, the same uniforms) on both sets."""
    a, _ = kept
    tensors, cam, stereo = [x.contiguous() for x in a[:8]], a[8:11], a[11]
    pos, valid, kp_pos, kp_valid = tensors[2], tensors[4], tensors[6], tensors[7]
    obs, base = obs_info_cuda.obs_info(*tensors, *cam, stereo)
    again = obs_info_cuda.obs_info(*tensors, *cam, stereo)
    want = observability.pose_info_for_selection_ref(*tensors, *cam, stereo)
    n_select = min(160, pos.shape[0])
    gen.manual_seed(16)
    u = good_feature.lazier_uniforms(obs, n_select, gen, 10)
    sets = [good_feature.lazier_greedy_select(M, valid, n_select, None, 10, b, uniforms=u)[0]
            for M, b in ((obs, base), want)]
    rec = {"case": label, "P": int(pos.shape[0]), "n": int(kp_pos.shape[0]),
           "rows_weighted": int(want[0].flatten(1).any(1).sum()), "matched": int(kp_valid.sum()),
           "stereo": bool(stereo),
           "matrices_differing": int((obs != want[0]).flatten(1).any(1).sum()),
           "base_equal": bool(torch.equal(base, want[1])),
           "max_abs_err": float(max((obs - want[0]).abs().max(), (base - want[1]).abs().max())),
           "rerun_bit_for_bit": bool(torch.equal(obs, again[0]) and torch.equal(base, again[1])),
           "selection_same": bool(torch.equal(sets[0], sets[1])),
           "picks_differing": int((sets[0] ^ sets[1]).sum())}
    rec["ok"] = (rec["matrices_differing"] == 0 and rec["base_equal"]
                 and rec["rerun_bit_for_bit"] and rec["selection_same"])
    return rec, tensors, cam, stereo


def time_obs_info(tensors, cam, stereo):
    """Kernel 4 at the path's shapes: device time by CUDA-graph replay, the
    eager call, the host enqueue of each form; the plain version's ms,
    device kernels and device-busy ms; the bound."""
    def kernel():
        return obs_info_cuda.obs_info(*tensors, *cam, stereo)

    def plain():
        return observability.pose_info_for_selection_ref(*tensors, *cam, stereo)

    def enqueue_ms(fn):
        host = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        return statistics.median(host)

    rec = {"ms": time_cuda_graph(kernel, 20, 10), "call_ms": time_cuda(kernel, 20, 10),
           "host_ms": enqueue_ms(kernel), "plain_host_ms": enqueue_ms(plain)}
    prof = profiled(plain, repeats=3)
    rec.update(plain_ms=prof["ms"], plain_device_kernels=prof["device_kernels"],
               plain_device_busy_ms=prof["device_busy_ms"])
    P, n, L = tensors[2].shape[0], tensors[6].shape[0], tensors[5].shape[0]
    # R, t and the rows read once (pos 12, octave 8, valid 1 a pool row;
    # 13 a keypoint row; the levels), every row's matrix written once, the
    # keypoints' read again by the sum, the base written
    rec.update(bound(48 + 21 * P + 13 * n + 4 * L + 196 * (P + 2 * n + 1),
                     OBS_FLOPS_ROW * (P + n) + OBS_FLOPS_BASE_ROW * n))
    return rec


def phase_lm_select(pose_inputs, select_inputs, info_inputs):
    """Kernels 2 (`pose_lm`) and 3 (`greedy_select`) on the card against
    their plain PyTorch versions, on the inputs the paths gave them: the
    main path's last motion-model and local-map solves (3 × 8) and the
    accepted relocalization's LM polish (4 × 10), plus the edge cases (R
    and t within POSE_TOL, inliers and n_inliers exact); the
    main path's last selection (D = 7) and the hybrid phase's (D = 13), each
    on the same uniforms for both, as drawn and exact greedy. Kernel 4
    (`obs_info`) against its plain version on the main path's last
    OBS_INFO_KEEP selections' inputs (bit for bit; the selection on both
    sets equal). Device time by
    CUDA-graph replay, host ms a call, the plain version's ms and device
    kernels a call, the bound from this run's inputs."""
    pose_cases, pose_shapes = [], []
    for label, kept in pose_inputs:
        tensors, cam, rounds, iters, damping = pose_call(kept)
        rec, _, _ = hold_pose(label, tensors, cam, rounds, iters, damping)
        pose_cases.append(rec)
        pose_shapes.append(dict(rec, **time_pose(tensors, cam, rounds, iters, damping)))
        if label == "motion_model":
            pose_cases += pose_edge_cases(tensors, cam)
    sel_cases, sel_shapes = [], []
    gen = torch.Generator(device=DEVICE)
    for label, kept in select_inputs:
        M, valid, n_select, lazier, base, eps, batch = select_call(kept)
        gen.manual_seed(13)
        u = good_feature.lazier_uniforms(M, n_select, gen, lazier, batch)
        for lz, uu in ((lazier, u), (1, None)):
            rec = hold_select(f"{label}_lazier{lz}", M, valid, n_select, lz, base, eps, batch, uu)
            sel_cases.append(rec)
            if lz == lazier:
                sel_shapes.append(dict(rec, **time_select(M, valid, n_select, lz, base, eps,
                                                          batch, uu, rec)))
        rec = hold_select(f"{label}_no_base", M, valid, n_select, 1, None, eps, batch, None)
        sel_cases.append(rec)
    # the kernel's cap on P (4x the largest pool any path passes), both widths
    P = greedy_select_cuda.MAX_SLOTS
    for D in greedy_select_cuda.DIMS:
        M, valid, base = cap_problem(P, D)
        gen.manual_seed(14)
        u = good_feature.lazier_uniforms(M, 160, gen, 10)
        rec = hold_select(f"cap_p{P}_d{D}_lazier10", M, valid, 160, 10, base, 1e-3, 8, u)
        sel_cases.append(rec)
        sel_shapes.append(dict(rec, **time_select(M, valid, 160, 10, base, 1e-3, 8, u, rec)))
    info_cases, info_shapes = [], []
    for label, kept in info_inputs:
        rec, tensors, cam, stereo = hold_obs_info(label, kept, gen)
        info_cases.append(rec)
        if label == info_inputs[-1][0]:  # the last frame's
            info_shapes.append(dict(rec, case="main_path_last", **time_obs_info(tensors, cam,
                                                                                  stereo)))
    torch.cuda.synchronize()
    records = {}
    for name, cases, shapes, tol in ((POSE_LM, pose_cases, pose_shapes,
                                      {"R_t_abs": POSE_TOL, "inliers": "exact"}),
                                     (GREEDY, sel_cases, sel_shapes,
                                      {"tie_gap": SELECT_TIE, "objective_rtol": SELECT_OBJ_RTOL}),
                                     (OBS_INFO, info_cases, info_shapes,
                                      {"matrices": "exact", "selection": "exact"})):
        # the headline shape: the main path's local-map solve, its D = 7
        # selection, its last information matrices
        head = next(s for s in shapes if s["case"] in ("local_map", "main_path_d7_lazier10",
                                                       "main_path_last"))
        records[name] = {
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "ok": all(c["ok"] for c in cases), "cases": len(cases),
            "max_abs_err": max(c["max_abs_err"] for c in cases), "tolerance": tol,
            "ms": head["ms"], "call_ms": head["call_ms"], "host_ms": head["host_ms"],
            "plain_ms": head["plain_ms"], "plain_device_kernels": head["plain_device_kernels"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "shapes": shapes, "checked": cases}
    records[OBS_INFO].update(plain_host_ms=info_shapes[0]["plain_host_ms"],
                             selections_equal=sum(c["selection_same"] for c in info_cases))
    emit({"phase": "lm_select", "pose_lm": records[POSE_LM], "greedy_select": records[GREEDY],
          "obs_info": records[OBS_INFO]})
    for name, rec in records.items():
        bad = [c for c in rec["checked"] if not c["ok"]]
        if bad:
            fail(f"{name} disagrees with its plain version: {bad}")
    # no PyTorch call computes a masked Huber LM, a greedy logdet selection
    # or the selection's information matrices
    return records


def phase_reloc_matrix(captured):
    """The matrix kernel checked (tolerance 0) and timed on the inputs of the
    accepted relocalization's `match_all`, beside its plain version."""
    if not captured:
        fail("no matrix input was captured on the relocalization")
    out = []
    for da, db in captured:
        got = hamming_cuda.hamming_distance_matrix(da, db)
        if not torch.equal(got, hamming_cuda.hamming_distance_matrix_ref(da, db)):
            fail(f"{MATRIX} disagrees with its plain version on the relocalization's inputs")
        n, m = da.shape[0], db.shape[0]
        rec = {"n": n, "m": m, "caller": "reloc", "mask": "path",
               "ms": time_cuda_graph(lambda: hamming_cuda.hamming_distance_matrix(da, db), 30, 20),
               "call_ms": time_cuda(lambda: hamming_cuda.hamming_distance_matrix(da, db), 30, 20),
               "plain_ms": time_cuda(lambda: hamming_cuda.hamming_distance_matrix_ref(da, db), 5, 2)}
        rec.update(matrix_bound_ms(n, m))
        out.append(rec)
    emit({"phase": "reloc_matrix", "tolerance": 0, "calls": out})
    return out


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


# ------------------------------------------------- distributed BA and the CLI
DIST_K, DIST_P, DIST_O = 32, 32768, 6   # __graft_entry__.py dryrun_multichip's problem
DIST_ITERS = 8
DIST_CPU_RANKS = 4
DIST_POSE_GAIN = 0.25   # pose error after / before: the dry run's own assertion
DIST_KF_T_ATOL, DIST_PT_ATOL = 1e-3, 5e-3  # tests/test_dist_ba.py's 1-vs-8-device bounds
DIST_TIMEOUT_S = 600.0
CLI_FRAMES = 36          # tests/test_examples_cli.py's rendered arc
CLI_ATE_BOUND_M = 0.25   # its gate
CLI_BUDGETS = (80, 160)
CLI_SCRIPTS = {"run": "examples/run_stereo_torch.py", "eval": "examples/eval_ate_torch.py",
               "sweep": "examples/batch_sweep_torch.py"}


def dist_problem():
    """The dry run's problem (__graft_entry__.py `dryrun_multichip`): K = 32
    poses on a lateral-dominant path, P = 32768 points, each seen by O = 6
    distinct KFs at 0.3 px noise, stereo; poses perturbed by twists of
    sigma 0.01 (KF 0 fixed), points by 5 cm. Built with the port's se3_exp,
    in the dry run's draw order. Returns (arrays in LocalBAProblem field
    order, true kf_t, the initial pose error)."""
    from gf_orb_slam2_tpu_torch.geometry import lie

    rng = np.random.default_rng(0)
    K, O, P = DIST_K, DIST_O, DIST_P
    gt_pts = np.stack([rng.uniform(-4, 4, P), rng.uniform(-3, 3, P),
                       rng.uniform(4, 15, P)], -1).astype(np.float32)
    xi = np.zeros((K, 6), np.float32)
    xi[:, 0] = 0.15 * np.arange(K)
    xi[:, 2] = 0.02 * np.arange(K)
    xi[:, 4] = 0.005 * np.arange(K)
    R, t = lie.se3_exp(torch.from_numpy(xi))
    kf_R, kf_t = R.numpy(), t.numpy()
    obs_kf = np.stack([rng.choice(K, O, replace=False) for _ in range(P)]).astype(np.int32)
    pc = np.einsum("kij,pj->pki", kf_R, gt_pts) + kf_t[None]
    u = FX * pc[..., 0] / pc[..., 2] + CX + rng.normal(0, 0.3, (P, K))
    v = FY * pc[..., 1] / pc[..., 2] + CY + rng.normal(0, 0.3, (P, K))
    r_idx = np.arange(P)[:, None]
    obs_uv = np.stack([u[r_idx, obs_kf], v[r_idx, obs_kf]], -1).astype(np.float32)
    obs_ur = (u[r_idx, obs_kf] - BF / pc[r_idx, obs_kf, 2]).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    init_R, init_t = kf_R.copy(), kf_t.copy()
    for k in range(1, K):
        dR, dt = lie.se3_exp(torch.from_numpy(rng.normal(0, 0.01, 6).astype(np.float32)))
        init_R[k] = dR.numpy() @ kf_R[k]
        init_t[k] = dR.numpy() @ kf_t[k] + dt.numpy()
    pts = gt_pts + rng.normal(0, 0.05, (P, 3)).astype(np.float32)
    arrays = [init_R, init_t, fixed, np.ones(K, bool), pts, np.ones(P, bool), obs_kf,
              obs_uv, obs_ur, np.ones((P, O), np.float32), np.ones((P, O), bool)]
    return arrays, kf_t, float(np.linalg.norm(init_t - kf_t, axis=-1)[1:].max())


def phase_dist_ba():
    """Both distributed-BA layouts through `distributed_ba` on an NCCL world
    of one rank (this process, the card), held against ground truth (the dry
    run's 4x pose-error reduction), against the same problem on a 4-rank gloo
    world on the CPU (started by parallel/launch.py), and their collectives
    per LM iteration against the formula (tools/collective_audit_torch.py).
    Records ms per LM iteration (median of 3, each to a synchronize), kernel
    launches and device-busy share per iteration (torch.profiler), and the
    ablated point-sharded step."""
    from gf_orb_slam2_tpu_torch.convert import ba_problem_from_arrays
    from gf_orb_slam2_tpu_torch.parallel import dist_ba, launch, mesh as pmesh

    audit = _load_by_path("collective_audit_torch", "tools/collective_audit_torch.py")
    arrays, true_t, init_terr = dist_problem()
    cam = (FX, FY, CX, CY, BF)
    layouts = {"point_sharded": False, "kf_sharded_pcg": True}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        t_cpu = time.perf_counter()
        cpu_world = pool.submit(
            launch.launch, launch.run_all,
            ([(dist_ba.solve_arrays, (arrays, cam, DIST_ITERS, None, kf, None, "cpu"))
              for kf in layouts.values()],),
            world_size=DIST_CPU_RANKS, device="cpu", timeout=DIST_TIMEOUT_S)
        store = os.path.join(tempfile.mkdtemp(prefix="gfslam_nccl_"), "store")
        pmesh.init_world(DEVICE, 0, 1, f"file://{store}", timeout=DIST_TIMEOUT_S)
        card = {}
        try:
            mesh = pmesh.make_mesh(device=DEVICE)
            prob = ba_problem_from_arrays(arrays, DEVICE)
            local = dist_ba.local_problem(mesh, prob)
            lam = torch.tensor(dist_ba.LAM0, dtype=torch.float32, device=DEVICE)
            for name, kf in layouts.items():
                t0 = time.perf_counter()
                out = dist_ba.distributed_ba(mesh, prob, *cam, iters=DIST_ITERS, kf_sharded=kf)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
                kf_t, pt_pos, cost = (t.cpu().numpy() for t in out[1:])
                step = (dist_ba.build_pcg_ba_step(mesh, *cam) if kf
                        else dist_ba.build_distributed_ba_step(mesh, *cam))
                prof = profiled(lambda: step(local, lam), repeats=3)
                counted = audit.audit_step(mesh, prob, kf)
                rec = {"kf_t": kf_t, "pt_pos": pt_pos, "cost": float(cost),
                       "pose_err": float(np.linalg.norm(kf_t - true_t, axis=-1)[1:].max()),
                       "first_run_s": run_s, "ms_per_iter": prof["ms"],
                       "launches_per_iter": prof["device_kernels"],
                       "device_busy_ms_per_iter": prof["device_busy_ms"],
                       "device_busy_share": prof["device_busy_ms"] / prof["ms"],
                       "collectives_per_iter": counted["measured"],
                       "collectives_expected": counted["expected"]}
                if not kf:
                    ablated = dist_ba.build_distributed_ba_step(mesh, *cam, ablate_collectives=True)
                    rec["ablated_ms_per_iter"] = profiled(lambda: ablated(local, lam), 3)["ms"]
                card[name] = rec
            peak_mb = torch.cuda.max_memory_allocated() / 2**20
        finally:
            torch.distributed.destroy_process_group()
        cpu = cpu_world.result()
        cpu_s = time.perf_counter() - t_cpu
    out = {"phase": "dist_ba", "K": DIST_K, "P": DIST_P, "O": DIST_O, "iters": DIST_ITERS,
           "card_world": 1, "backend": "nccl", "cpu_ranks": DIST_CPU_RANKS,
           "cpu_world_s": cpu_s, "init_pose_err": init_terr, "peak_allocated_mb": peak_mb,
           "tolerance": {"kf_t": DIST_KF_T_ATOL, "pt_pos": DIST_PT_ATOL,
                         "cost_rtol": BA_COST_RTOL, "pose_gain": DIST_POSE_GAIN},
           "layouts": {}}
    bad = []
    for (name, rec), ref in zip(card.items(), cpu):
        d_t = float(np.abs(rec["kf_t"] - ref[1]).max())
        d_p = float(np.abs(rec["pt_pos"] - ref[2]).max())
        d_c = abs(rec["cost"] - float(ref[3])) / max(abs(float(ref[3])), 1e-12)
        row = {k: v for k, v in rec.items() if k not in ("kf_t", "pt_pos")}
        row.update(cpu_cost=float(ref[3]), max_abs_dkf_t=d_t, max_abs_dpt=d_p, cost_rel_diff=d_c)
        out["layouts"][name] = row
        if not (np.isfinite(rec["cost"]) and rec["pose_err"] < DIST_POSE_GAIN * init_terr):
            bad.append(f"{name}: pose error {rec['pose_err']} from {init_terr}, cost {rec['cost']}")
        if not (d_t <= DIST_KF_T_ATOL and d_p <= DIST_PT_ATOL and d_c <= BA_COST_RTOL):
            bad.append(f"{name}: card against the gloo world: kf_t {d_t}, pt_pos {d_p}, cost {d_c}")
        if rec["collectives_per_iter"] != rec["collectives_expected"]:
            bad.append(f"{name}: collectives {rec['collectives_per_iter']} against the formula "
                       f"{rec['collectives_expected']}")
    emit(out)
    if bad:
        fail("dist_ba: " + "; ".join(bad))
    return out


def write_euroc_arc(root):
    """tests/test_examples_cli.py's scene in EuRoC ASL layout: the rendered
    36-frame arc at 640x480, ground truth as state_groundtruth_estimate0 CSV,
    and its settings YAML. Returns (sequence dir, settings, ground truth)."""
    import cv2

    world = RoomWorld(width=9.0, height=5.0, length=13.0)
    poses = _renderer.trajectory_arc(CLI_FRAMES, radius=0.8, advance=1.5)
    seq = os.path.join(root, "seq", "mav0")
    cams = [os.path.join(seq, c) for c in ("cam0", "cam1")]
    gt_dir = os.path.join(seq, "state_groundtruth_estimate0")
    for d in [os.path.join(c, "data") for c in cams] + [gt_dir]:
        os.makedirs(d)
    rows, gt_rows = [], []
    for i, (R_cw, t_cw) in enumerate(poses):
        views = world.render_stereo(R_cw, t_cw, baseline=BASELINE_M, fx=FX, fy=FY, cx=CX, cy=CY)
        ts_ns = int((1.0 + i / 20.0) * 1e9)
        name = f"{ts_ns}.png"
        for cam, im in zip(cams, views):
            cv2.imwrite(os.path.join(cam, "data", name), np.clip(im, 0, 255).astype(np.uint8))
        rows.append(f"{ts_ns},{name}")
        c = -R_cw.T @ t_cw
        q = _quat_wxyz(R_cw.T)
        gt_rows.append(f"{ts_ns},{c[0]},{c[1]},{c[2]},{q[0]},{q[1]},{q[2]},{q[3]}"
                       ",0,0,0,0,0,0,0,0,0")
    for cam in cams:
        with open(os.path.join(cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
    gt = os.path.join(gt_dir, "data.csv")
    with open(gt, "w") as f:
        f.write("#timestamp, p_RS_R_x [m], ...\n" + "\n".join(gt_rows) + "\n")
    settings = os.path.join(root, "rendered.yaml")
    with open(settings, "w") as f:
        f.write("Sensor: STEREO\n"
                f"Camera.fx: {FX}\nCamera.fy: {FY}\nCamera.cx: {CX}\nCamera.cy: {CY}\n"
                f"Camera.width: {WIDTH}\nCamera.height: {HEIGHT}\n"
                f"Camera.bf: {BF}\nCamera.fps: 20.0\nThDepth: 40.0\n"
                "ORBextractor.nFeatures: 500\n")
    return os.path.dirname(seq), settings, gt


def _quat_wxyz(R):
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w < 1e-8:
        return np.array([1.0, 0, 0, 0])
    return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)])


def phase_cli():
    """The user's offline chain on the card (tests/test_examples_cli.py's
    gates): `run_stereo_torch.py --format euroc` as a subprocess with the
    default device, `eval_ate_torch.py` on its trajectory, then
    `batch_sweep_torch.run_one` in this process at two budgets, whose
    launches of both kernels are counted."""
    root = tempfile.mkdtemp(prefix="gfslam_cli_")
    t0 = time.perf_counter()
    seq, settings, gt = write_euroc_arc(root)
    render_s = time.perf_counter() - t0
    out_dir = os.path.join(root, "out")

    def run(script, *args, timeout=600):
        t = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.join(ROOT, CLI_SCRIPTS[script]), *args],
                           capture_output=True, text=True, cwd=ROOT, timeout=timeout)
        if p.returncode != 0:
            fail(f"cli: {CLI_SCRIPTS[script]} exited {p.returncode}:\n"
                 + p.stdout[-2000:] + p.stderr[-3000:])
        return json.loads(p.stdout.strip().splitlines()[-1]), time.perf_counter() - t

    summary, run_s = run("run", "--format", "euroc", "--data", seq, "--settings", settings,
                         "--out", out_dir)
    traj = os.path.join(out_dir, "trajectory_tum.txt")
    metrics, eval_s = run("eval", traj, gt, "--max-dt", "0.03")
    files = {n: os.path.exists(os.path.join(out_dir, n)) for n in
             ("trajectory_tum.txt", "trajectory_kitti.txt", "tracking_log.jsonl")}

    sweep = _load_by_path("batch_sweep_torch", CLI_SCRIPTS["sweep"])
    args = argparse.Namespace(format="euroc", data=seq, sequence="00", settings=settings,
                              out=os.path.join(root, "sweep"), max_frames=0, device=DEVICE)
    hamming_cuda.reset_launch_counts()
    rows = [sweep.run_one(args, b) for b in CLI_BUDGETS]
    launches = dict(hamming_cuda.launch_counts)
    rec = {"phase": "cli", "frames": CLI_FRAMES, "render_s": render_s,
           "run_stereo": dict(summary, seconds=run_s), "eval_ate": dict(metrics, seconds=eval_s),
           "files": files, "batch_sweep": rows, "launches_run": launches,
           "ate_bound_m": CLI_ATE_BOUND_M}
    emit(rec)
    if not (summary["frames"] == CLI_FRAMES and summary["keyframes"] >= 1 and all(files.values())):
        fail(f"cli: run_stereo_torch summary {summary}, files {files}")
    if not (np.isfinite(metrics.get("ate_rmse", np.nan))
            and metrics["ate_rmse"] < CLI_ATE_BOUND_M):
        fail(f"cli: ATE {metrics.get('ate_rmse')} (bound {CLI_ATE_BOUND_M} m)")
    if any(r["frames"] != CLI_FRAMES for r in rows):
        fail(f"cli: batch sweep rows {rows}")
    if not all(launches[k] > 0 for k in (MATRIX, BEST2, POSE_LM, GREEDY)):
        fail(f"cli: the batch sweep launched {launches}")
    return rec


def main():
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    t0 = time.perf_counter()
    tour, tour_gt = render_tour()
    render_s = time.perf_counter() - t0
    # the headline run first: its process has run nothing else yet
    bench = phase_bench(tour, tour_gt, smi)
    imgs, gt = tour[:N_FRAMES], tour_gt[:N_FRAMES]
    run, captured, ba_problem, main, lm_inputs = phase_main_path(imgs, gt, render_s)
    pipelined = phase_pipelined(imgs[:PIPELINED_FRAMES], gt[:PIPELINED_FRAMES],
                                run["ate_rmse_m"])
    t0 = time.perf_counter()
    circuit = render_loop()
    circuit_render_s = time.perf_counter() - t0
    loop, loop_calls, pose_graph, gba_window, sim3 = phase_loop(circuit, circuit_render_s)
    reloc, reloc_matrix, polish = phase_reloc(circuit)
    mono, mono_calls = phase_mono(circuit)
    rgbd, rgbd_calls = phase_rgbd(imgs[:RGBD_FRAMES], gt[:RGBD_FRAMES], run["ate_rmse_m"])
    hashing, hashing_calls = phase_hashing(circuit, loop["ate_loop_off_m"])
    map_io = phase_map_io(imgs, gt, main)
    del main
    hybrid, hybrid_select = phase_hybrid(imgs[:HYBRID_FRAMES], gt[:HYBRID_FRAMES], run)
    kernels.update(phase_lm_select(lm_inputs["pose"] + [("reloc_polish", polish)],
                                   lm_inputs["select"] + [hybrid_select], lm_inputs["info"]))
    path_calls = phase_path_masks(captured + loop_calls + mono_calls + rgbd_calls + hashing_calls)
    matrix_calls = phase_reloc_matrix(reloc_matrix)
    phase_local_ba(ba_problem)
    phase_loop_solvers(pose_graph, gba_window, sim3)
    cli = phase_cli()
    phase_dist_ba()
    # the best-2 kernel's headline numbers are those on the path's own masks,
    # largest shape first; the synthetic masks of phase `kernels` follow
    best2 = kernels[BEST2]
    shapes = sorted(path_calls, key=lambda c: -c["n"]) + best2["shapes"]
    head = shapes[0]
    best2.update({k: head[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}, shapes=shapes)
    kernels[MATRIX]["shapes"] = kernels[MATRIX]["shapes"] + matrix_calls
    pl = pipelined["kernel_launches"]
    emit({"kernels": [dict(rec, launches=run["kernel_launches"][name],
                           launches_mapping=run["kernel_launches_mapping"][name],
                           launches_pipelined_tracking=pl["tracking"][name],
                           launches_pipelined_mapping=pl["mapping"][name],
                           launches_pipelined_loop=pl["loop"][name] + pl["gba"][name],
                           launches_loop_path=loop["launches_run"][name],
                           launches_loop_closer=loop["launches_loop"][name],
                           launches_reloc_path=reloc["launches_run"][name],
                           launches_reloc=reloc["launches_by_caller"]["reloc"][name],
                           launches_mono_path=mono["launches_run"][name],
                           launches_mono_by_caller={c: n[name] for c, n in
                                                    mono["launches_by_caller"].items()},
                           launches_rgbd_path=rgbd["launches_run"][name],
                           launches_hashing_path=hashing["launches_run"][name],
                           launches_map_io_path={c: n[name] for c, n in
                                                 map_io["launches_by_caller"].items()},
                           launches_hybrid_path=hybrid["launches_run"][name],
                           launches_cli_path=cli["launches_run"][name],
                           launches_bench=bench["launches_run"][name],
                           launches_bench_by_thread={t: n[name] for t, n in
                                                     bench["launches_by_thread"].items()},
                           launches_bench_construction=bench["launches_construction"][name])
                      for name, rec in kernels.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

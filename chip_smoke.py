#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for Hopper).

    python3 chip_smoke.py

Builds the hand-written CUDA kernel from gf_orb_slam2_tpu_torch/csrc, holds
it against its plain PyTorch version on the card, then drives the port's main
path — synchronous stereo tracking through `System.track_stereo` at the
headline configuration (640x480, 800 ORB features, 4096-point local pool,
good-feature selection on) — over 60 rendered frames and checks the
trajectory against the renderer's ground truth. Each phase prints one JSON
line; any failed phase ends the run with a non-zero exit code. The last line
is {"ok": true, "device": {...}} and is printed only if every phase passed.

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

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from gf_orb_slam2_tpu_torch.config import (  # noqa: E402
    CameraConfig, CapacityConfig, GFMatchingMode, GoodFeatureConfig,
    LoopClosingConfig, ORBConfig, Sensor, SystemConfig, TrackingConfig,
)
from gf_orb_slam2_tpu_torch.io.evaluation import ate_rmse  # noqa: E402
from gf_orb_slam2_tpu_torch.ops import hamming_cuda  # noqa: E402
from gf_orb_slam2_tpu_torch.system import System  # noqa: E402


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
BASELINE_M = 0.1
BF = FX * BASELINE_M
N_FRAMES = 60
TOUR_FRAMES = 300
ATE_BOUND_M = 0.15

# published peaks of one H100 SXM (NVIDIA data sheet) used for the bound
HBM_BYTES_PER_S = 3.35e12
FP32_CORE_OPS_PER_S = 67e12  # non-tensor float32 rate, taken for the integer ALU work

KERNEL_NAME = "hamming_distance_matrix"
PATH_SHAPES = ((4096, 1024), (1024, 1024))  # (local + leftover search), (stereo + motion search)
CHECK_SHAPES = ((1024, 1024), (4096, 1024), (1000, 777), (1, 1), (0, 5))


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


def hamming_bound_ms(n, m):
    """Least time for the [n,8]x[m,8] → [n,m] int32 matrix: inputs read once,
    output written once, against 8 XOR + 8 POPC + 7 ADD per output."""
    bytes_ms = ((n + m) * 32 + n * m * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = (n * m * 23) / FP32_CORE_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


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
    emit({"phase": "build", "source": "gf_orb_slam2_tpu_torch/csrc/hamming.cu",
          "arch": "sm_90a", "seconds": round(time.perf_counter() - t0, 2)})


def phase_kernels():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20240)
    mismatches = 0
    max_abs_err = 0
    for n, m in CHECK_SHAPES:
        da, db = random_desc(gen, n, dev), random_desc(gen, m, dev)
        got = hamming_cuda.hamming_distance_matrix(da, db)
        ref = hamming_cuda.hamming_distance_matrix_ref(da, db)
        torch.cuda.synchronize()
        if got.shape != (n, m) or got.dtype != torch.int32:
            fail(f"kernel output {tuple(got.shape)} {got.dtype} at {(n, m)}")
        if got.numel():
            diff = (got - ref).abs()
            mismatches += int((diff != 0).sum())
            max_abs_err = max(max_abs_err, int(diff.max()))
    # all-zeros against all-ones: 0 on equal rows, 256 across
    z = torch.zeros((3, 8), dtype=torch.int32, device=dev)
    o = torch.full((2, 8), -1, dtype=torch.int32, device=dev)
    ext = hamming_cuda.hamming_distance_matrix(torch.cat([z, o]), torch.cat([z, o]))
    want = torch.zeros((5, 5), dtype=torch.int32, device=dev)
    want[:3, 3:] = 256
    want[3:, :3] = 256
    mismatches += int((ext != want).sum())
    max_abs_err = max(max_abs_err, int((ext - want).abs().max()))

    shapes = []
    for n, m in PATH_SHAPES:
        da, db = random_desc(gen, n, dev), random_desc(gen, m, dev)
        def kernel():
            return hamming_cuda.hamming_distance_matrix(da, db)

        ms = time_cuda_graph(kernel, 30, 20)   # the kernel on the device
        call_ms = time_cuda(kernel, 30, 20)    # eager calls: host launch path included
        plain_ms = time_cuda(lambda: hamming_cuda.hamming_distance_matrix_ref(da, db), 5, 2)
        bound_ms, bound_by = hamming_bound_ms(n, m)
        shapes.append({"n": n, "m": m, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by})
    ok = mismatches == 0
    rec = {
        "name": KERNEL_NAME, "route": "cuda",
        "source": "gf_orb_slam2_tpu_torch/csrc/hamming.cu",
        "replaces": "gf_orb_slam2_tpu/ops/pallas_hamming.py:23",
        "ok": ok, "mismatches": mismatches, "max_abs_err": max_abs_err,
        "tolerance": 0,
        # headline numbers at the larger path shape (two launches per frame)
        "ms": shapes[0]["ms"], "call_ms": shapes[0]["call_ms"],
        "plain_ms": shapes[0]["plain_ms"],
        "bound_ms": shapes[0]["bound_ms"], "bound_by": shapes[0]["bound_by"],
        "library_ms": None,  # PyTorch has no popcount operator
        "us_4096x1024": shapes[0]["ms"] * 1e3,
        "us_1024x1024": shapes[1]["ms"] * 1e3,
        "shapes": shapes,
    }
    emit({"phase": "kernels", "checked": [rec]})
    if not ok:
        fail(f"CUDA kernel disagrees with its plain version: {mismatches} mismatches")
    return rec


def headline_config():
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
                                async_mapping=False),
        loop=LoopClosingConfig(enabled=False),
    )


def phase_main_path():
    world = RoomWorld(width=9.0, height=5.5, length=13.0)
    poses = trajectory_tour(TOUR_FRAMES)[:N_FRAMES]
    gt = np.stack([-R.T @ t for R, t in poses])
    t0 = time.perf_counter()
    imgs = []
    for R_cw, t_cw in poses:
        left, right = world.render_stereo(R_cw, t_cw, baseline=BASELINE_M,
                                          fx=FX, fy=FY, cx=CX, cy=CY)
        imgs.append((np.clip(left, 0, 255).astype(np.uint8),
                     np.clip(right, 0, 255).astype(np.uint8)))
    render_s = time.perf_counter() - t0

    slam = System(headline_config())  # default device: cuda
    hamming_cuda.reset_launch_counts()
    est, frame_ms = [], []
    for i, (left, right) in enumerate(imgs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T = slam.track_stereo(left, right, i / 20.0)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        est.append(-T[:3, :3].T @ T[:3, 3])
    launches = hamming_cuda.launch_counts[KERNEL_NAME]

    stats = slam.tracker.stats
    states = [s.state for s in stats]
    n_fused = sum(s.path == "fused" for s in stats)
    n_kf = int(slam.store.n_keyframes)
    est = np.stack(est)
    ate = ate_rmse(est, gt)
    steady = sorted(frame_ms[5:])
    rec = {
        "phase": "main_path", "frames": N_FRAMES, "render_s": round(render_s, 1),
        "init_keypoints": stats[0].n_features, "states_ok": states.count("OK"),
        "fused_frames": n_fused, "keyframes": n_kf,
        "pending_keyframe_events": len(slam.pending_keyframes),
        "map_points": int(slam.store.n_points),
        "ate_rmse_m": ate, "ate_bound_m": ATE_BOUND_M,
        "frame_ms_median": statistics.median(steady),
        "frame_ms_p90": steady[int(0.9 * (len(steady) - 1))],
        "frame_ms_first": frame_ms[0],
        "kernel_launches": launches,
        "median_inliers": statistics.median(s.n_inliers for s in stats[1:]),
    }

    # frontend share of a frame: the extraction + stereo stage alone, timed
    # on the last image pair (host clock around a synchronized device)
    pair = torch.from_numpy(np.stack(imgs[-1])).cuda()
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
    if n_fused < 40:
        fail(f"fused path served {n_fused} frames (< 40)")
    if n_kf < 2:
        fail(f"{n_kf} keyframes (< 2)")
    if launches == 0 or launches < 4 * n_fused:
        fail(f"{launches} kernel launches for {n_fused} fused frames (< 4 per frame)")
    if not (np.isfinite(est).all() and est.shape == (N_FRAMES, 3)):
        fail("trajectory is not finite")
    if not ate < ATE_BOUND_M:
        fail(f"ATE {ate:.4f} m >= {ATE_BOUND_M} m")
    return rec


def main():
    smi = phase_device()
    phase_build()
    kernel = phase_kernels()
    run = phase_main_path()
    kernel = dict(kernel, launches=run["kernel_launches"])
    emit({"kernels": [kernel]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

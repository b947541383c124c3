#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: end-to-end stereo SLAM
latency on one NVIDIA GPU, 6-DoF scene — bench.py's run on the port.

    python3 bench_torch.py [--device cuda] [--frames 300]

The same scene, schedule, configuration and output as bench.py: the
rendered 300-frame room tour (tests/rendered_world.py, loaded by its path:
a ray-cast textured box room — the reference repo's test images where they
are on disk, fractal noise where not —, continuous yaw/pitch/roll), 16
frames through `System.track_stereo`, the rest through
`System.track_stereo_pipelined` with the asynchronous mapping worker and
loop closing on (bench.py's configuration: 800 ORB features, 1024 keypoint
slots, 4096-point local pool, good-feature selection, `LoopClosingConfig()`),
then `flush_pipeline()`. The per-call host time is taken over frames 40
onward (the call returns with its frame still in flight, as bench.py times
it); the trajectory's ATE against the renderer's ground truth is printed in
the same line, and an ATE that is not finite or above 0.20 m fails the run
(exit code 1, "BENCH FAILED" on stderr).

Prints ONE JSON line with bench.py's keys. `prewarm_s` is the time of
`System.wait_prewarm()`: the set-up still pending after construction (the
CUDA kernels' nvcc build or load; with loop closing on, the construction's
loop-closer warm-up has already done it). Rendering takes ~0.3 s a frame
on the host, so the frames are cached in
~/.cache/gf_slam_rendered/tour6dof_v2.npz, bench.py's cache file, with its
ground-truth guard. With BENCH_TRACE set, the per-call trace and the
mapper's per-event stage ms are written to BENCH_TRACE_torch.json.

`run(imgs, gt, device)` is the benchmark on given frames, for callers that
render them themselves. Imports the port (torch and numpy) and, through the
renderer, OpenCV — never JAX.
"""
import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from gf_orb_slam2_tpu_torch.config import (  # noqa: E402
    CameraConfig, CapacityConfig, ORBConfig, Sensor, SystemConfig, TrackingConfig,
)
from gf_orb_slam2_tpu_torch.io.evaluation import ate_rmse  # noqa: E402
from gf_orb_slam2_tpu_torch.system import System  # noqa: E402

BASELINE_MS = 19.1  # the reference's tracking time a frame (BASELINE.md)
N_FRAMES = 300
SYNC_FRAMES = 16  # synchronous frames before the pipelined ones
WARM = 40  # frames excluded from the steady-state window
FX = FY = 450.0
CX, CY = 320.0, 240.0
BASELINE_M = 0.1
BF = FX * BASELINE_M
ATE_LIMIT = 0.20  # bench.py's: twice the rendered synchronous gate
TRACE_FILE = "BENCH_TRACE_torch.json"
SCENE = "rendered 6-DoF room tour (real textures), 300 frames"

_CACHE = os.path.join(os.path.expanduser("~"), ".cache", "gf_slam_rendered",
                      "tour6dof_v2.npz")


def _renderer():
    """tests/rendered_world.py by its path: `tests` is not a package, and the
    name may be taken on the import path."""
    spec = importlib.util.spec_from_file_location(
        "rendered_world", os.path.join(ROOT, "tests", "rendered_world.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tour_poses(r=None):
    """The tour's N_FRAMES world-to-camera poses (R, t) and ground-truth
    camera centres [N_FRAMES,3]."""
    poses = (r or _renderer()).trajectory_tour(N_FRAMES)
    return poses, np.stack([-R.T @ t for R, t in poses])


def render(poses, r=None):
    """Stereo pairs [n,2,480,640] uint8 of the scene seen from `poses`."""
    world = (r or _renderer()).RoomWorld(width=9.0, height=5.5, length=13.0)
    imgs = np.empty((len(poses), 2, 480, 640), np.uint8)
    for i, (R_cw, t_cw) in enumerate(poses):
        left, right = world.render_stereo(R_cw, t_cw, baseline=BASELINE_M,
                                          fx=FX, fy=FY, cx=CX, cy=CY)
        imgs[i, 0] = np.clip(left, 0, 255).astype(np.uint8)
        imgs[i, 1] = np.clip(right, 0, 255).astype(np.uint8)
    return imgs


def render_sequence(n_frames=N_FRAMES):
    """The tour's first `n_frames` stereo pairs [n,2,480,640] uint8 and the
    ground-truth camera centres [n,3], as bench.py's render_sequence serves
    them: the whole tour is read from (or, on a miss, rendered into)
    bench.py's cache file, whose images count only if their ground truth
    equals the one computed now. A copy of bench.py's, not a call into it:
    bench.py is the JAX package's benchmark and imports it, so the port keeps
    its own; tests/test_torch_bench.py holds the two to the same constants
    and cache format."""
    r = _renderer()
    assert n_frames <= N_FRAMES, "render_sequence serves prefixes of the tour"
    poses, gt = tour_poses(r)
    if os.path.exists(_CACHE):
        z = np.load(_CACHE)
        if (z["imgs"].shape[0] == N_FRAMES and "gt" in z.files
                and z["gt"].shape == gt.shape
                and np.allclose(z["gt"], gt, atol=1e-6)):
            return z["imgs"][:n_frames], gt[:n_frames]
    imgs = render(poses, r)
    os.makedirs(os.path.dirname(_CACHE), exist_ok=True)
    np.savez(_CACHE, imgs=imgs, gt=gt)
    return imgs[:n_frames], gt[:n_frames]


def bench_config():
    """bench.py's configuration, in the port's config classes."""
    cam = CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, th_depth=40.0)
    return SystemConfig(
        sensor=Sensor.STEREO,
        camera=cam,
        orb=ORBConfig(n_features=800),
        capacity=CapacityConfig(max_keypoints=1024, max_map_points=40000,
                                max_keyframes=300, max_local_points=4096),
        # mapping and loop closing on their worker threads (the reference's
        # LocalMapping/LoopClosing threads, System.cc:113-124)
        tracking=TrackingConfig(async_mapping=True),
    )


def run(imgs, gt, device="cuda", details=None) -> dict:
    """bench.py's measurement on `imgs` [n,2,H,W] uint8 with ground-truth
    centres `gt` [n,3], on `device` (taken as given: "cuda" without a GPU
    raises). Returns bench.py's result dict; the timed window is frames
    WARM onward, so a run on WARM frames or fewer measures none (its
    times are NaN). If `details` is a dict, it receives
    the shut-down System, the frame ids in the order they came back, the
    per-call trace and times, the mapping worker's KF event count, and the
    System's construction time (`construct_s`: with loop closing on it
    includes `LoopCloser.warm_up`, whose first kernel launch builds the
    CUDA kernels, so `prewarm_s` then has nothing left to wait for)."""
    n = len(imgs)
    t_construct0 = time.perf_counter()
    sys_ = System(bench_config(), device=device)
    t_warm0 = time.perf_counter()
    sys_.wait_prewarm()
    prewarm_s = time.perf_counter() - t_warm0
    est, returned = {}, []

    def note(fid, T):
        returned.append(fid)
        est[fid] = -T[:3, :3].T @ T[:3, 3]

    sync_times = []
    for i in range(min(SYNC_FRAMES, n)):
        t0 = time.perf_counter()
        note(i, sys_.track_stereo(imgs[i, 0], imgs[i, 1], i / 20.0))
        dt = (time.perf_counter() - t0) * 1e3
        if i >= 10:
            sync_times.append(dt)
    times = []
    trace = []  # (frame, ms, keyframes so far)
    for i in range(SYNC_FRAMES, n):
        t0 = time.perf_counter()
        for fid, T in sys_.track_stereo_pipelined(imgs[i, 0], imgs[i, 1], i / 20.0):
            note(fid, T)
        dt = (time.perf_counter() - t0) * 1e3
        trace.append((i, round(dt, 2), int(sys_.store.n_keyframes)))
        if i >= WARM:
            times.append(dt)
    for fid, T in sys_.flush_pipeline():
        note(fid, T)
    n_kf = sys_.store.n_keyframes
    mw = sys_._map_worker
    ba_runs = mw.n_ba_runs if mw is not None else 0
    ba_merged = mw.n_ba_merged if mw is not None else 0
    kf_events = mw.n_kf_events if mw is not None else 0
    sys_.shutdown()
    common = sorted(est)
    ate = float(ate_rmse(np.stack([est[i] for i in common]), gt[common]))
    mean = float(np.mean(times)) if times else float("nan")
    if details is not None:
        details.update(system=sys_, returned=returned, trace=trace, times=times,
                       sync_times=sync_times, n_kf_events=kf_events,
                       construct_s=t_warm0 - t_construct0)
    # headline = the MEAN, as bench.py: the sustained time a robot sees
    return {
        "metric": "stereo_tracking_ms_per_frame_mean",
        "value": round(mean, 3),
        "unit": "ms/frame",
        "vs_baseline": round(BASELINE_MS / mean, 3),
        "median_ms": round(float(np.median(times)) if times else float("nan"), 3),
        "p90_ms": round(float(np.percentile(times, 90)) if times else float("nan"), 3),
        "sync_latency_ms": round(float(np.median(sync_times)) if sync_times else float("nan"), 3),
        "n_frames_measured": len(times),
        "n_keyframes": int(n_kf),
        "n_stream_fallbacks": int(sys_.n_stream_fallbacks),
        "ate_m": round(ate, 4),
        "n_ba_runs": int(ba_runs),
        "n_ba_merged": int(ba_merged),
        "prewarm_s": round(prewarm_s, 1),
        "scene": SCENE,
    }


def check(result) -> int:
    """bench.py's accuracy gate: a latency from a diverged trajectory is
    meaningless. Returns the exit code (1 on failure, with "BENCH FAILED" on
    stderr)."""
    ate = result["ate_m"]
    if not np.isfinite(ate) or ate > ATE_LIMIT:
        print(f"BENCH FAILED: ate_m={ate:.4f} exceeds {ATE_LIMIT}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; nothing falls back)")
    ap.add_argument("--frames", type=int, default=N_FRAMES,
                    help=f"run on the tour's first N frames (default: all {N_FRAMES}, "
                         "bench.py's run; fewer is a quick check)")
    args = ap.parse_args(argv)
    if not WARM < args.frames <= N_FRAMES:
        ap.error(f"--frames must be in ({WARM}, {N_FRAMES}]: the timed window "
                 f"starts at frame {WARM}")
    imgs, gt = render_sequence(args.frames)
    details = {}
    result = run(imgs, gt, args.device, details=details)
    print(json.dumps(result), flush=True)
    if os.environ.get("BENCH_TRACE"):
        event_ms = details["system"].mapper.event_ms
        with open(TRACE_FILE, "w") as f:
            json.dump({"trace": details["trace"],
                       "mapper_device_ms": {
                           k: [round(e[k], 1) for e in event_ms]
                           for k in (event_ms[0] if event_ms else {})}}, f)
    return check(result)


if __name__ == "__main__":
    raise SystemExit(main())

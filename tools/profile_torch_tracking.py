#!/usr/bin/env python3
"""Where a frame's time goes in the PyTorch/CUDA port (one NVIDIA GPU).

    python3 tools/profile_torch_tracking.py [--frames 30] [--map-frames 60]
                                            [--pipelined 24] [--loop 140] [--out DIR]

Drives `System.track_stereo` at the headline stereo configuration on the
rendered room tour (the scene of chip_smoke.py), local mapping on, and
reports, for the steady frames after the warm-up:

- per-stage milliseconds (host clock around a synchronized device) for the
  frontend and the parts of the fused tracking step, by wrapping the stage
  functions — synchronizing at every stage boundary slows the frame a little,
  so the per-frame total is also measured without the wrappers;
- a `torch.profiler` window: kernels launched per frame, device-busy share of
  the wall time, and the top operators by device and by host time;
- then, over the next `--map-frames` frames, the mapper's stages per keyframe
  event (map.refresh, map.triangulate_fuse, map.local_ba, map.cull): each
  stage call runs under its own `torch.profiler` window, giving its wall
  milliseconds, its device kernels and its device-busy share;
- with `--pipelined N` (N > 0), bench.py's driver on a second System with
  bench.py's whole configuration (the asynchronous mapping worker, loop
  closing on its own worker, the detached global BA): frames 0-15 through
  `track_stereo`, then `track_stereo_pipelined` up to frame 40, then a
  `torch.profiler` window over the next N calls — host ms per call,
  device-busy share, device kernels and kernel launches per call by thread
  (tracking thread, mapping worker), the Hamming launches by thread (the
  loop worker's too), and the driver's mirror sync, dispatch and
  completion ms;
- with `--loop N` (N > 0), the first N frames of the loop circuit of
  chip_smoke.py's phase `loop` (loop closing on, the global BA inline)
  through `track_stereo`, with each loop-closer stage call under its own
  `torch.profiler` window — loop.detect (BoW database), loop.sim3 (per
  candidate: the Hamming matrix kernel + both reductions, RANSAC, GN
  polish, and the guided search + second polish, which the closer's own
  `event_ms` splits apart), loop.fuse (search-and-fuse), loop.essential_graph,
  loop.gba (the whole global BA, inline) — giving per call its wall ms,
  device kernels and device-busy share, plus the closer's host ms per stage
  of each corrected event and the Hamming launches by the loop closer.

Prints one JSON object (also written to <out>/profile_torch_tracking.json)
with the card's name and power limit beside the numbers.
"""
import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (scene, configuration and renderer loader)
from gf_orb_slam2_tpu_torch.features import extractor as extractor_mod  # noqa: E402
from gf_orb_slam2_tpu_torch.loopclosing.loop_closer import LoopCloser  # noqa: E402
from gf_orb_slam2_tpu_torch.mapping.local_mapping import LocalMapper  # noqa: E402
from gf_orb_slam2_tpu_torch.matching import matcher, stereo  # noqa: E402
from gf_orb_slam2_tpu_torch.ops import hamming_cuda  # noqa: E402
from gf_orb_slam2_tpu_torch.optim import pose_opt  # noqa: E402
from gf_orb_slam2_tpu_torch.selection import good_feature, observability  # noqa: E402
from gf_orb_slam2_tpu_torch.system import System  # noqa: E402

STAGES = (
    (extractor_mod.ORBExtractor, "extract_batch", "frontend.extract"),
    (stereo, "match_stereo", "frontend.stereo_match"),
    (matcher, "search_by_projection", "track.search_by_projection"),
    (pose_opt, "pose_optimization", "track.pose_optimization"),
    (observability, "info_matrices", "track.info_matrices"),
    (good_feature, "lazier_greedy_select", "track.lazier_greedy_select"),
)
MAP_STAGES = (
    ("refresh", "map.refresh"),
    ("create_and_fuse", "map.triangulate_fuse"),
    ("run_local_ba", "map.local_ba"),
    ("cull_keyframes", "map.cull"),
)
LOOP_STAGES = (
    ("_detect_loop", "loop.detect"),
    ("_compute_sim3", "loop.sim3"),
    ("_search_and_fuse", "loop.fuse"),
    ("_optimize_essential_graph", "loop.essential_graph"),
    ("_launch_global_ba", "loop.gba"),
)


def render(n):
    world = chip_smoke.RoomWorld(width=9.0, height=5.5, length=13.0)
    out = []
    for R_cw, t_cw in chip_smoke.trajectory_tour(chip_smoke.TOUR_FRAMES)[:n]:
        left, right = world.render_stereo(
            R_cw, t_cw, baseline=chip_smoke.BASELINE_M, fx=chip_smoke.FX,
            fy=chip_smoke.FY, cx=chip_smoke.CX, cy=chip_smoke.CY,
            w=chip_smoke.WIDTH, h=chip_smoke.HEIGHT)
        out.append((np.clip(left, 0, 255).astype(np.uint8),
                    np.clip(right, 0, 255).astype(np.uint8)))
    return out


def track(slam, imgs, start, stop):
    ms = []
    for i in range(start, stop):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slam.track_stereo(imgs[i][0], imgs[i][1], i / 20.0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def _device_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _is_kernel(e):
    """A device activity (kernel, copy, set) — not a host operator, whose
    device time repeats its kernels', nor a user annotation's span."""
    return ("cuda" in str(getattr(e, "device_type", "")).lower()
            and not getattr(e, "is_user_annotation", False))


def _device_ms(events):
    """Device-busy milliseconds of a profiler window, as torch's own table
    totals them: the device activities only."""
    return sum(_device_us(e) for e in events if _is_kernel(e)) / 1e3


def _stage_profilers(owner, stages, records):
    """Wrap each stage method of `owner` so that every call runs under its
    own profiler window and appends {ms, kernels, device_ms} to
    records[label]. Returns the (name, original) pairs to put back."""
    from torch.profiler import ProfilerActivity, profile

    originals = []
    for name, label in stages:
        fn = getattr(owner, name)
        originals.append((name, fn))

        def timed(self, *aa, _fn=fn, _label=label, **kw):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = _fn(self, *aa, **kw)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            ka = prof.key_averages()
            dev = _device_ms(ka)
            records[_label].append({"ms": wall, "kernels": sum(e.count for e in ka if _is_kernel(e)),
                                    "device_ms": dev})
            return out

        setattr(owner, name, timed)
    return originals


def _stage_summary(records, n_events):
    out = {}
    for label, recs in records.items():
        ms = [r["ms"] for r in recs]
        out[label] = {
            "calls_per_event": len(recs) / max(n_events, 1),
            "ms_per_event_median": statistics.median(ms), "ms_per_event_max": max(ms),
            "kernels_per_event_median": statistics.median(r["kernels"] for r in recs),
            "device_busy_share": sum(r["device_ms"] for r in recs) / sum(ms)}
    return out


def profile_mapper_stages(slam, imgs, start, stop):
    """Track frames [start, stop) with every mapper stage call run under its
    own profiler window; returns per-stage records per keyframe event."""
    records = collections.defaultdict(list)
    originals = _stage_profilers(LocalMapper, MAP_STAGES, records)
    n_events0 = len(slam.mapper.stats)
    try:
        track(slam, imgs, start, stop)
    finally:
        for name, fn in originals:
            setattr(LocalMapper, name, fn)
    n_events = len(slam.mapper.stats) - n_events0
    return dict({"frames": stop - start, "keyframe_events": n_events},
                **_stage_summary(records, n_events))


def profile_loop(n_frames):
    """The loop circuit with each loop-closer stage call under its own
    profiler window."""
    from gf_orb_slam2_tpu_torch.loopclosing.loop_closer import STAGES

    imgs, _ = chip_smoke.render_loop()
    slam = System(chip_smoke.loop_config(True))
    records = collections.defaultdict(list)
    originals = _stage_profilers(LoopCloser, LOOP_STAGES, records)
    lc = slam.loop_closer
    launches = dict.fromkeys(hamming_cuda.launch_counts, 0)
    process = lc.process_keyframe

    def counted(kf):
        before = dict(hamming_cuda.launch_counts)
        try:
            return process(kf)
        finally:
            for k, v in hamming_cuda.launch_counts.items():
                launches[k] += v - before[k]

    lc.process_keyframe = counted
    try:
        track(slam, imgs, 0, min(n_frames, len(imgs)))
    finally:
        for name, fn in originals:
            setattr(LoopCloser, name, fn)
    slam.shutdown()
    n_events = len(lc.stats)
    corrected = [(st, ms) for st, ms in zip(lc.stats, lc.event_ms) if st.corrected]
    return dict({"frames": min(n_frames, len(imgs)), "keyframe_events": n_events,
                 "corrected": len(corrected),
                 "host_ms_per_corrected_event": [ms for _, ms in corrected],
                 "host_ms_per_event_median": {
                     s: statistics.median(e[s] for e in lc.event_ms) for s in STAGES},
                 "hamming_launches_by_loop_closer": launches,
                 "gba_window_ms": lc.last_gba.window_ms if lc.last_gba else None},
                **_stage_summary(records, n_events))


def profile_pipelined(imgs, n_calls):
    """bench.py's driver with the mapping worker; a profiler window over
    `n_calls` pipelined calls from frame 40 on."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from gf_orb_slam2_tpu_torch.slammap.device_mirror import DeviceMapMirror
    from gf_orb_slam2_tpu_torch.system import LOOP_THREAD, MAPPING_THREAD

    slam = System(chip_smoke.headline_config(async_mapping=True, loop=True))
    for i in range(16):
        slam.track_stereo(imgs[i][0], imgs[i][1], i / 20.0)
    start = 40
    for i in range(16, start):
        slam.track_stereo_pipelined(imgs[i][0], imgs[i][1], i / 20.0)
    timers = collections.defaultdict(list)

    def labelled(fn, label):
        def run(*a, **k):
            with record_function(label):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    timers[label].append((time.perf_counter() - t0) * 1e3)
        return run

    orig_sync, orig_event = DeviceMapMirror.sync, LocalMapper.process_keyframe
    DeviceMapMirror.sync = labelled(orig_sync, "driver.mirror_sync")
    LocalMapper.process_keyframe = labelled(orig_event, "mapping.event")
    slam._dispatch_stream = labelled(slam._dispatch_stream, "driver.dispatch")
    slam._complete_one = labelled(slam._complete_one, "driver.complete")
    stop = start + n_calls
    hamming_cuda.reset_launch_counts()
    n_events0 = len(slam.mapper.stats)
    call_ms = []
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(start, stop):
                t1 = time.perf_counter()
                slam.track_stereo_pipelined(imgs[i][0], imgs[i][1], i / 20.0)
                call_ms.append((time.perf_counter() - t1) * 1e3)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        DeviceMapMirror.sync, LocalMapper.process_keyframe = orig_sync, orig_event
    launches = {"tracking": hamming_cuda.thread_launch_counts("MainThread"),
                "mapping": hamming_cuda.thread_launch_counts(MAPPING_THREAD),
                "loop": hamming_cuda.thread_launch_counts(LOOP_THREAD)}
    events = prof.events()
    thread_of = {}
    for e in events:
        if e.name in ("driver.dispatch", "mapping.event"):
            thread_of.setdefault(e.name, e.thread)
    by_thread = collections.Counter(e.thread for e in events
                                    if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                  "cudaLaunchKernelExC"))
    tracking = by_thread.get(thread_of.get("driver.dispatch"), 0)
    ka = prof.key_averages()
    device_ms = _device_ms(ka)
    n_kernels = sum(e.count for e in ka if _is_kernel(e))
    slam.flush_pipeline()
    w = slam._map_worker
    out = {
        "calls": n_calls, "first_frame": start,
        "keyframe_events": len(slam.mapper.stats) - n_events0,
        "call_ms_median": statistics.median(call_ms), "call_ms_mean": statistics.fmean(call_ms),
        "wall_ms_per_call": wall_ms / n_calls,
        "device_busy_ms_per_call": device_ms / n_calls,
        "device_busy_share": device_ms / wall_ms,
        "device_kernels_per_call": n_kernels / n_calls,
        # the profiler may record host-side events of the tracking thread
        # only: the mapping worker's launches are then the device kernels
        # the tracking thread did not launch
        "kernel_launches_per_call_by_thread": {
            "tracking": tracking / n_calls,
            "mapping": (by_thread[thread_of["mapping.event"]] if "mapping.event" in thread_of
                        else n_kernels - tracking) / n_calls,
            "mapping_counted_from": "host events" if "mapping.event" in thread_of
            else "device kernels not launched by the tracking thread"},
        "hamming_launches_per_call": {t: {k: v / n_calls for k, v in c.items()}
                                      for t, c in launches.items()},
        "driver_ms": {k: {"median": statistics.median(v), "max": max(v), "n": len(v)}
                      for k, v in sorted(timers.items())},
        "n_ba_runs": w.n_ba_runs if w else 0, "n_ba_merged": w.n_ba_merged if w else 0,
        "top_by_device_time": [
            {"name": e.key[:60], "calls_per_call": e.count / n_calls,
             "device_ms_per_call": _device_us(e) / 1e3 / n_calls}
            for e in sorted((e for e in ka if _is_kernel(e)), key=_device_us, reverse=True)[:12]],
    }
    slam.shutdown()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--map-frames", type=int, default=60)
    ap.add_argument("--pipelined", type=int, default=24,
                    help="pipelined calls in the profiler window (0: skip)")
    ap.add_argument("--loop", type=int, default=140,
                    help="frames of the loop circuit with the loop closer profiled (0: skip)")
    ap.add_argument("--out", default=os.path.join(ROOT, "profile_out"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    n = max(args.frames, 24)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    hamming_cuda.load()
    imgs = render(max(n + args.map_frames, 40 + args.pipelined))
    slam = System(chip_smoke.headline_config())
    third = (n - 8) // 3
    a, b, c = 8, 8 + third, 8 + 2 * third
    track(slam, imgs, 0, a)  # init + warm-up
    plain_ms = track(slam, imgs, a, b)

    # ---- stage timers
    totals = collections.defaultdict(list)
    originals = []
    for owner, name, label in STAGES:
        fn = getattr(owner, name)
        originals.append((owner, name, fn))

        def timed(*aa, _fn=fn, _label=label, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*aa, **kw)
            torch.cuda.synchronize()
            totals[_label].append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(owner, name, timed)
    staged_ms = track(slam, imgs, b, c)
    for owner, name, fn in originals:
        setattr(owner, name, fn)
    n_staged = c - b
    stages = {k: {"calls_per_frame": len(v) / n_staged,
                  "ms_per_frame": sum(v) / n_staged,
                  "ms_per_call_median": statistics.median(v)}
              for k, v in sorted(totals.items())}

    # ---- profiler window
    from torch.profiler import ProfilerActivity, profile

    hamming_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        track(slam, imgs, c, n)
    wall_ms = (time.perf_counter() - t0) * 1e3
    n_prof = n - c
    ka = prof.key_averages()

    dev_us = _device_us
    kernels = [e for e in ka if _is_kernel(e)]
    device_ms = _device_ms(ka)
    n_kernels = sum(e.count for e in kernels)
    top_dev = sorted(kernels, key=dev_us, reverse=True)[:12]
    top_cpu = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    mapping = profile_mapper_stages(slam, imgs, n, n + args.map_frames)
    out = {
        "card": smi, "torch": torch.__version__, "frames": n,
        "frame_ms_median_plain": statistics.median(plain_ms),
        "frame_ms_median_with_stage_syncs": statistics.median(staged_ms),
        "stages": stages,
        "profiler": {
            "frames": n_prof, "wall_ms_per_frame": wall_ms / n_prof,
            "device_busy_ms_per_frame": device_ms / n_prof,
            "device_busy_share": device_ms / wall_ms,
            # the profiler slows the host several times over: the share of an
            # unprofiled frame is the one a user's frame has
            "device_busy_share_of_plain_frame": device_ms / n_prof / statistics.median(plain_ms),
            "device_kernels_per_frame": n_kernels / n_prof,
            "hamming_launches_per_frame":
                {k: v / n_prof for k, v in hamming_cuda.launch_counts.items()},
            "top_by_device_time": [
                {"name": e.key[:60], "calls_per_frame": e.count / n_prof,
                 "device_ms_per_frame": dev_us(e) / 1e3 / n_prof} for e in top_dev],
            "top_by_host_time": [
                {"name": e.key[:60], "calls_per_frame": e.count / n_prof,
                 "host_ms_per_frame": e.self_cpu_time_total / 1e3 / n_prof} for e in top_cpu],
        },
        "mapping": mapping,
        "pipelined": profile_pipelined(imgs, args.pipelined) if args.pipelined > 0 else None,
        "loop": profile_loop(args.loop) if args.loop > 0 else None,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_torch_tracking.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

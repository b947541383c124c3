"""One run of one cell: set-up, the measured window, the metrics, the check.

Everything a cell is made of is found by name: the cell's entry in
BENCHMARK.json names its configuration (`configs/<config>.json`, through
the entry's `file`) and its traffic mix (`traffic/<traffic>.json`); its
limits are `limits/<cell>.json`; each metric is read by
`metrics/<metric>.py`'s `read(run)`. So a later cell, mix or metric is a
set of new files and entries, and this module does not change.

The port is the only program run: this module imports torch, numpy and
`gf_orb_slam2_tpu_torch`, never JAX or the JAX package, and fails the run if
either is loaded once the window has closed.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # slambench/
ROOT = os.path.dirname(HERE)                                        # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "gf_orb_slam2_tpu")
DEADLINE_S = 60.0       # a frame not back this long after the window's close never came
RENDER_BATCH = 8
CONTROL_SCALE = 1.05    # the control's error of metric scale


def process_start_wall():
    """Wall-clock time at which this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


class Cell:
    """A cell's entries and files, found by name."""

    def __init__(self, workload):
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        entries = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in entries:
            raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                             f"{sorted(entries)}")
        self.name = workload
        self.entry = entries[workload]
        conf = {c["name"]: c for c in self.spec["configs"]}[self.entry["config"]]
        with open(os.path.join(ROOT, conf["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(HERE, "traffic", self.entry["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        with open(os.path.join(HERE, "limits", workload + ".json")) as f:
            self.limits = {k: v["limit"] for k, v in json.load(f).items()}

    def metrics(self, kind):
        """The cell's metrics of `kind` ("end_to_end" or "per_layer")."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def reader(name):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("slambench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What one run measured; the metric readers read it."""

    def __init__(self):
        self.frames = []          # window frames: dict(i, due, start, end)
        self.returned = {}        # frame id -> 4x4 T_cw
        self.lost = set()         # frame ids tracked LOST
        self.attempted = 0
        self.window_s = 0.0
        self.setup_s = 0.0
        self.setup_stages = {}
        self.spans = None         # trace.Spans, traced runs
        self.trace = None         # trace.DeviceTrace, traced runs
        self.mapper_events = []   # LocalMapper.event_ms entries of the window
        self.trace_read_s = 0.0
        self.events_before = 0
        self.loops_before = 0


def render(cell, n, seed, device):
    """n frames of the cell's traffic from the seed, rendered on `device`
    and copied into (pinned) host memory as a camera hands them over:
    stereo pairs [n,2,h,w] or images [n,1,h,w] uint8, and for RGB-D the
    depth [n,h,w] in 1/DepthMapFactor m (int32 holding 16-bit values).
    Also returns the ground truth: R_wc [n,3,3], centres [n,3], the box."""
    import numpy as np
    import torch

    from slambench.scene import hall as hall_mod, motion

    y, tr = cell.config, cell.traffic
    fps = float(y["Camera.fps"])
    w, h = int(y["Camera.width"]), int(y["Camera.height"])
    fx, fy, cx, cy = (float(y[k]) for k in ("Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy"))
    dist = tuple(float(y.get(k, 0.0)) for k in
                 ("Camera.k1", "Camera.k2", "Camera.p1", "Camera.p2", "Camera.k3"))
    R_wc, C = motion.trajectory(tr["motion"], n, fps, seed)
    sc = tr["scene"]
    length = motion.hall_length(tr["motion"], n, fps, sc["ahead_m"])
    world = hall_mod.Hall(sc["width_m"], sc["height_m"], length, seed, device,
                          texture_px=sc["texture_px"], tile_m=sc["tile_m"])
    rays = hall_mod.pinhole_rays(w, h, fx, fy, cx, cy, device, dist)
    stereo, rgbd = y["Sensor"] == "STEREO", y["Sensor"] == "RGBD"
    pin = torch.device(device).type == "cuda"
    imgs = torch.empty((n, 2 if stereo else 1, h, w), dtype=torch.uint8, pin_memory=pin)
    depth = torch.empty((n, h, w), dtype=torch.int32, pin_memory=pin) if rgbd else None
    baseline = float(y.get("Camera.bf", 0.0)) / fx
    dmf = float(y.get("DepthMapFactor", 5000.0))
    for i0 in range(0, n, RENDER_BATCH):
        i1 = min(n, i0 + RENDER_BATCH)
        R = torch.from_numpy(R_wc[i0:i1]).to(device, torch.float32)
        o = torch.from_numpy(C[i0:i1]).to(device, torch.float32)
        img, z = world.render(R, o, rays, fx)
        imgs[i0:i1, 0].copy_(img.clamp(0, 255).to(torch.uint8).reshape(-1, h, w))
        if stereo:
            # the right camera: the left centre moved by the baseline along
            # the camera's x axis (R_wc's first column)
            img_r, _ = world.render(R, o + baseline * R[:, :, 0], rays, fx)
            imgs[i0:i1, 1].copy_(img_r.clamp(0, 255).to(torch.uint8).reshape(-1, h, w))
        if rgbd:
            q = torch.round(z * dmf)
            q = torch.where(q > 65535, torch.zeros_like(q), q)
            depth[i0:i1].copy_(q.to(torch.int32).reshape(-1, h, w))
    del world, rays
    return imgs, depth, {"R_wc": R_wc, "C": C, "fps": fps,
                         "box": (float(sc["width_m"]), float(sc["height_m"]), length)}


def feed(system, entry, imgs, depth, i, fps):
    """Offer frame i through the cell's entry; returns [(frame id, T_cw)]."""
    ts = i / fps
    if entry == "track_stereo":
        return [(i, system.track_stereo(imgs[i, 0].numpy(), imgs[i, 1].numpy(), ts))]
    if entry == "track_rgbd":
        return [(i, system.track_rgbd(imgs[i, 0].numpy(), depth[i].numpy(), ts))]
    raise ValueError(f"unknown entry {entry!r}")


def instrument(system, spans):
    """The benchmark's spans around the port's calls (traced runs)."""
    from gf_orb_slam2_tpu_torch import system as system_mod
    from gf_orb_slam2_tpu_torch.optim import pose_opt
    from gf_orb_slam2_tpu_torch.selection import good_feature
    from gf_orb_slam2_tpu_torch.tracking import tracker as tracker_mod

    from slambench.core import trace

    spans.wrap(system_mod.System, "_frontend_stereo_impl", "slambench.frontend")
    spans.wrap(system_mod.System, "_frontend_mono_impl", "slambench.frontend")
    spans.wrap(system_mod.System, "_wait_workers", trace.WAIT)
    spans.wrap(tracker_mod.Tracker, "process_frame", "slambench.track_step")
    spans.wrap(pose_opt, "pose_lm", "slambench.pose_lm", keep=trace.pose_lm_call)
    spans.wrap(good_feature, "greedy_select", "slambench.greedy_select",
               keep=trace.greedy_select_call)


def run_cell(cell, seed, seconds, traced, device="cuda", control=None, t_process=None):
    """One run of `cell` (a Cell); returns the result line's dict, the
    check lines for stderr, and the forbidden modules found loaded.
    `control="scale"` is the check's control, not a benchmark run: the
    configuration's metric scale (Camera.bf, or DepthMapFactor for RGB-D)
    is handed to the System 5 % off, so its poses and map are 5 % out of
    scale."""
    t_process = time.time() if t_process is None else t_process
    stages = {"python_torch_s": time.time() - t_process}
    t = time.time()
    import dataclasses

    import numpy as np
    import torch

    from gf_orb_slam2_tpu_torch.system import System
    from gf_orb_slam2_tpu_torch.tracking.tracker import TrackState

    from slambench.core import settings, trace
    from slambench.reference import check

    stages["import_s"] = time.time() - t
    cuda = torch.device(device).type == "cuda"
    cfg = settings.system_config(cell.config)
    if control == "scale":
        cam = cfg.camera
        cfg = cfg.replace(camera=dataclasses.replace(
            cam, bf=cam.bf * CONTROL_SCALE, depth_map_factor=cam.depth_map_factor * CONTROL_SCALE))
    elif control is not None:
        raise ValueError(f"control {control!r}")
    tr = cell.traffic
    fps = float(cell.config["Camera.fps"])       # the camera's: the frames' timestamps
    rate = float(tr.get("rate_hz", fps))         # offered
    entry, warm = tr["entry"], int(tr["warmup_frames"])
    n_window = int(np.ceil(rate * seconds))

    t = time.time()
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
    stages["device_init_s"] = time.time() - t
    t = time.time()
    imgs, depth, truth = render(cell, warm + n_window, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    stages["render_s"] = time.time() - t

    run = Run()
    run.setup_stages = stages
    t = time.time()
    system = System(cfg, device=device)
    try:
        system.wait_prewarm()
        stages["system_s"] = time.time() - t
        if traced:
            run.spans = trace.Spans()
            instrument(system, run.spans)
        t = time.time()
        for i in range(warm):
            feed(system, entry, imgs, depth, i, fps)
        system.flush_pipeline()
        if cuda:
            torch.cuda.synchronize()
        stages["warmup_frames_s"] = time.time() - t
        never, returned = window(run, system, entry, imgs, depth, warm, n_window, fps, rate,
                                 seconds, t_process)
        if cuda:
            torch.cuda.synchronize()
            dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                        "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
        else:
            dev_info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
        run.mapper_events = system.mapper.event_ms[run.events_before:]
        window_ids = {f["i"] for f in run.frames}
        state = {st.frame_id: st.state for st in system.tracker.stats}
        run.lost = {i for i in window_ids if state.get(i) != TrackState.OK.name}
        run.returned = {i: np.asarray(T) for i, T in returned.items() if i in window_ids}
        # the map at the window's close, then the program's state is freed
        s = system.store
        with s.lock:
            kf = np.nonzero(s.kf_valid)[0]
            kf_ids = s.kf_frame_id[kf].copy()
            kf_T = np.tile(np.eye(4), (len(kf), 1, 1))
            kf_T[:, :3, :3] = s.kf_R[kf]
            kf_T[:, :3, 3] = s.kf_t[kf]
            points = s.point_pos[s.point_valid].copy()
        lc = system.loop_closer
        loops = lc.stats[run.loops_before:] if lc is not None else []
        mw = system._map_worker
        ba_ms = [e["local_ba"] for e in run.mapper_events]
        info = {"rate_hz": rate, "window_s": run.window_s, "kf_events": len(run.mapper_events),
                "local_ba_ms_per_kf": sum(ba_ms) / len(ba_ms) if ba_ms else None,
                "ba_merged": mw.n_ba_merged if mw is not None else 0,
                "keyframes": int(len(kf)), "map_points": int(len(points)),
                "loop_candidates": sum(st.n_candidates > 0 for st in loops),
                "loops_corrected": sum(st.corrected for st in loops),
                "lost": len(run.lost), "trace_read_s": run.trace_read_s}
    finally:
        system.shutdown()
        if run.spans is not None:
            run.spans.unwrap()
    not_back = never + len(window_ids - set(run.returned))
    failed = not_back + len(run.lost & set(run.returned))
    metrics = {}
    for m in cell.metrics("per_layer" if traced else "end_to_end"):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    del system, imgs, depth
    if cuda:
        torch.cuda.empty_cache()

    verdict = check.judge(
        {"T_cw": {i: T for i, T in run.returned.items() if i not in run.lost},
         "attempted": run.attempted, "kf_ids": kf_ids, "kf_T_cw": kf_T, "points": points},
        truth, cell.limits)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    result = {"correct": verdict["correct"] and not_back == 0, "attempted": run.attempted,
              "failed": failed, "metrics": metrics, "device": dev_info}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown(
            [trace.FRAME, trace.WAIT, "slambench.frontend", "slambench.track_step"])
    result["setup_stages"] = run.setup_stages
    result["info"] = info
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in verdict["numbers"].items()}
    checks["frames_never_back"] = {"value": not_back, "limit": 0}
    for v in checks.values():
        if not np.isfinite(v["value"]):
            v["value"] = None  # no number to compare: the check failed
    result["checks"] = checks  # last in the line
    lines = [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    if verdict["why"]:
        lines.append("check failed: " + verdict["why"])
    return result, lines, loaded


def window(run, system, entry, imgs, depth, warm, n_window, fps, rate, seconds, t_process):
    """The measured window: frames `warm`.. offered at `rate`, open loop,
    each due at its slot, never dropped. Traced, the profiler covers the
    first TRACE_SECONDS. Returns (frames that never came back, {frame id:
    T_cw})."""
    import torch

    from slambench.core import trace

    run.events_before = len(system.mapper.event_ms)
    run.loops_before = len(system.loop_closer.stats) if system.loop_closer is not None else 0
    returned = {}
    prof = None
    if run.spans is not None:
        run.spans.on = True
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    run.setup_s = time.time() - t_process
    if prof is not None:
        prof.start()
        run.spans.profiling = True
        prof_t0 = time.time_ns()

    def frame(k, due):
        i = warm + k
        start = time.perf_counter()
        if prof is not None:
            with torch.profiler.record_function(trace.FRAME):
                out = feed(system, entry, imgs, depth, i, fps)
        else:
            out = feed(system, entry, imgs, depth, i, fps)
        returned.update(out)
        run.frames.append({"i": i, "due": due, "start": start, "end": time.perf_counter()})

    def stop_profiler(always=False):
        nonlocal prof
        if prof is None or not (always or time.perf_counter() - t0 >= trace.TRACE_SECONDS):
            return
        run.spans.profiling = False
        t1 = time.time_ns()
        prof.stop()
        tr0 = time.perf_counter()
        run.trace = trace.DeviceTrace(prof.profiler.kineto_results.events(), prof_t0, t1)
        run.trace_read_s = time.perf_counter() - tr0
        prof = None

    never = 0
    run.attempted = n_window
    for k in range(n_window):
        due = t0 + k / rate
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
        elif now > t0 + seconds + DEADLINE_S:
            never = n_window - k
            break
        frame(k, due)
        stop_profiler()
    run.window_s = time.perf_counter() - t0
    system.flush_pipeline()
    stop_profiler(always=True)
    if run.spans is not None:
        run.spans.on = False
    return never, returned


def main(argv=None):
    import argparse

    t_process = process_start_wall()
    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("scale",), default=None,
                    help="run the check's control (not a benchmark run): the configuration's "
                         "metric scale handed to the System 5 %% off")
    args = ap.parse_args(argv)
    import torch

    cell = Cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines, loaded = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                     args.control, t_process=t_process)
    if loaded:
        print(f"slambench: the process loaded {loaded} (jax or the JAX package)",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

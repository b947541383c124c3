#!/usr/bin/env python3
"""Where a frame's time goes, read from the port's own spans: one traced run
of a benchmark cell, span by span (one NVIDIA GPU).

    python3 tools/span_report_torch.py [--workload tum_rgbd_gf.camera_rate]
        [--seed N] [--seconds 51] [--out profile_out/span_report.json] [--span-cost]

Runs the cell in process as `slambench/run.py --trace 1` does, prints its
result line, and writes a JSON report over the traced part of the window
(the profiler's first seconds), from the program's spans
(gf_orb_slam2_tpu_torch/utils/tracing.py) and the profiler's events:

- `spans_ms_per_frame`: each span name's ms and self ms (less its child
  spans) a traced frame, on the frames' thread, and the worker threads'
  spans (mapping, loop, GBA) in the traced part, by name;
- `idle_by_span`: the device's idle time inside the calls by the innermost
  span (slambench/core/program.py);
- `self_share`: the self time of `frame` and `track.step` over their time;
- `checks`: each `track.step` span against the benchmark's
  `slambench.track_step` range and each `frame` inside its `slambench.frame`
  range (ns), and dispatch + fetch + host against the step;
- `owners`: the costliest device operations, each split by the span that
  launched it (the kernel's launch call, found by its correlation id, under
  the innermost profiler range open on the launching thread);
- `frame_counters`: the counter deltas each `frame` span carries (uploads,
  bytes, syncs, the frontend's graph replays, hand-kernel launches), per
  frame; `graph_counters`: the process's `frontend.graph_captures` and
  `frontend.graph_replays` (utils/cuda_graph.py) at the run's end;
- `hash` (a cell with hashing on): the frames with a `track.hash` span, the
  queries and their attributes (descriptors queried, candidates the tables
  returned, pool points only the hash gave, the candidate budget) a frame,
  `track.hash` / `track.hash_scores` ms a frame, and the mapping worker's
  `map.hash` events (count, mean ms, points inserted, entries evicted);
- `select`: the frames with a `track.select` span (the local step's
  budgeted selection), its ms a frame, and the launches of the selection's
  information-matrix kernel a frame (`launch.obs_info`, the `frame` span's
  `obs_info_launches` delta) and the frames with one.

`--trace 0` runs the cell without the profiler, with the spans on through
`tracing.enable()` for the whole run, and reports the window's frames span
by span (host ms as an untraced run spends them). `--span-cost` adds the
host µs of one span: off, on through `enable()`, and under a recording
profiler.
"""
import argparse
import bisect
import json
import os
import statistics
import sys
import threading
import time
from collections import defaultdict
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")  # as slambench/run.py holds them


def per_frame(spans, frames, thread):
    """{name: [ms, self ms]} a frame of the spans inside the frames."""
    from slambench.core import program

    kids = defaultdict(int)
    for s in spans:
        if s.parent is not None:
            kids[s.parent] += s.end_ns - s.start_ns
    out = {}
    for name in sorted({s.name for s in spans if s.thread == thread}):
        mine = frames if name == program.FRAME else program.inside(frames, spans, name)
        if mine:
            tot = sum(s.end_ns - s.start_ns for s in mine)
            own = tot - sum(kids[s.id] for s in mine)
            out[name] = [tot / 1e6 / len(frames), own / 1e6 / len(frames)]
    return out


def workers(spans, t0, t1, main):
    """{thread: {name: [count, mean ms]}} of the other threads' spans."""
    acc = defaultdict(lambda: defaultdict(list))
    for s in spans:
        if s.thread != main and t0 <= s.start_ns and s.end_ns <= t1:
            acc[s.thread][s.name].append((s.end_ns - s.start_ns) / 1e6)
    return {t: {n: [len(v), sum(v) / len(v)] for n, v in d.items()} for t, d in acc.items()}


def hash_summary(spans, frames, t0, t1):
    """The hashed local map over the frames, and the mapper's `map.hash`
    events ending in [t0, t1]; None where no frame queried the hash."""
    from slambench.core import program

    queries = program.inside(frames, spans, "track.hash")
    if not queries:
        return None
    scores = program.inside(frames, spans, "track.hash_scores")
    starts = sorted(f.start_ns for f in frames)
    hashed = {starts[max(0, bisect.bisect_right(starts, q.start_ns) - 1)] for q in queries}
    n = len(frames)
    out = {"frames": n, "frames_with_query": len(hashed), "queries_per_frame": len(queries) / n,
           "ms_per_frame": {name: sum(x.end_ns - x.start_ns for x in mine) / 1e6 / n
                            for name, mine in (("track.hash", queries),
                                               ("track.hash_scores", scores))}}
    for k in ("queried", "candidates", "added", "budget"):
        out[k + "_per_query"] = sum(q.attrs[k] for q in queries) / len(queries)
    events = [s for s in spans if s.name == "map.hash" and t0 <= s.end_ns <= t1]
    out["map_hash"] = {"events": len(events)}
    if events:
        out["map_hash"].update(
            ms_mean=sum(e.end_ns - e.start_ns for e in events) / 1e6 / len(events),
            inserted=sum(e.attrs.get("inserted", 0) for e in events),
            evicted=sum(e.attrs.get("evicted", 0) for e in events))
    return out


def select_summary(spans, frames):
    """The local step's selection over the frames: `track.select` ms, and
    the `obs_info` launches each `frame` span counted; None where no frame
    selected."""
    from slambench.core import program

    selects = program.inside(frames, spans, "track.select")
    if not selects:
        return None
    starts = sorted(f.start_ns for f in frames)
    selecting = {starts[max(0, bisect.bisect_right(starts, x.start_ns) - 1)] for x in selects}
    n = len(frames)
    launched = [f.attrs.get("obs_info_launches", 0) for f in frames]
    return {"frames": n, "frames_with_select": len(selecting),
            "frames_with_obs_info": sum(k > 0 for k in launched),
            "selects_per_frame": len(selects) / n,
            "track_select_ms_per_frame": sum(x.end_ns - x.start_ns for x in selects) / 1e6 / n,
            "obs_info_per_frame": sum(launched) / n}


def match_ranges(mine, ranges, inside_only=False):
    """Each span against the benchmark range nearest its start: the largest
    |start - start| and |end - end| (ns), or for `inside_only` how many spans
    lie inside their range."""
    ranges = sorted(ranges)
    starts = [r[0] for r in ranges]
    d_start = d_end = n_in = 0
    for s in mine:
        i = bisect.bisect_left(starts, s.start_ns)
        cands = [ranges[j] for j in (i - 1, i) if 0 <= j < len(ranges)]
        r = min(cands, key=lambda r: abs(r[0] - s.start_ns))
        d_start = max(d_start, abs(r[0] - s.start_ns))
        d_end = max(d_end, abs(r[1] - s.end_ns))
        n_in += r[0] <= s.start_ns and s.end_ns <= r[1]
    return {"spans": len(mine), "ranges": len(ranges), "inside": n_in} if inside_only else {
        "spans": len(mine), "ranges": len(ranges), "max_start_ns": d_start, "max_end_ns": d_end}


def owners(events, range_names, top=12):
    """The `top` device operations by summed time, each split by the
    innermost profiler range (of `range_names`) around its launch call:
    [{op, s, by_range: {range: s}}]."""
    from torch.autograd import DeviceType

    from slambench.core import program, trace

    launch_of, ranges = {}, defaultdict(list)
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        if e.name() in trace.LAUNCH_NAMES:
            launch_of[e.correlation_id()] = e
        elif e.name() in range_names:
            ranges[e.start_thread_id()].append(SimpleNamespace(
                name=e.name(), start_ns=e.start_ns(), end_ns=e.start_ns() + e.duration_ns()))
    cut = {tid: program.innermost(r) for tid, r in ranges.items()}

    def owner(k):
        la = launch_of.get(k.correlation_id())
        if la is None or la.start_thread_id() not in cut:
            return "unknown"
        cuts, labels = cut[la.start_thread_id()]
        i = bisect.bisect_right(cuts, la.start_ns()) - 1
        return (labels[i] if 0 <= i < len(labels) else None) or "outside"

    by_op = defaultdict(lambda: defaultdict(int))
    for e in events:
        if e.device_type() == DeviceType.CUDA and e.name() not in range_names:
            by_op[e.name()][owner(e)] += e.duration_ns()
    costly = sorted(by_op.items(), key=lambda kv: -sum(kv[1].values()))[:top]
    return [{"op": op, "s": sum(o.values()) / 1e9,
             "by_range": dict(sorted(((k, v / 1e9) for k, v in o.items()),
                                     key=lambda kv: -kv[1]))} for op, o in costly]


def span_cost(n=200_000):
    """Host µs of one span with nothing inside, and of the empty loop."""
    import contextlib

    import torch

    from gf_orb_slam2_tpu_torch.utils import tracing

    def us(make, k):
        t = time.perf_counter()
        for _ in range(k):
            with make():
                pass
        return (time.perf_counter() - t) / k * 1e6

    out = {"empty_loop_us": us(contextlib.nullcontext, n),
           "off_span_us": us(lambda: tracing.span("x", frame=1), n),
           "off_timed_us": us(lambda: tracing.timed("x"), n)}
    tracing.enable()
    out["on_span_us"] = us(lambda: tracing.span("x", frame=1), n // 4)
    tracing.disable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        out["profiled_span_us"] = us(lambda: tracing.span("x", frame=1), n // 20)
    tracing.clear()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="tum_rgbd_gf.camera_rate")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 16)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("profile_out", "span_report.json"))
    ap.add_argument("--span-cost", action="store_true")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1,
                    help="0: no profiler, the spans on through tracing.enable() for the run")
    args = ap.parse_args(argv)

    from gf_orb_slam2_tpu_torch.utils import tracing
    from slambench.core import bench, program, trace

    kept = {}

    class KeptRun(bench.Run):
        def __init__(self):
            super().__init__()
            kept["run"] = self

    class KeptTrace(trace.DeviceTrace):
        def __init__(self, events, t0_ns, t1_ns):
            kept["events"] = list(events)
            super().__init__(kept["events"], t0_ns, t1_ns)

    bench.Run, trace.DeviceTrace = KeptRun, KeptTrace
    cell = bench.Cell(args.workload)
    if not args.trace:
        tracing.enable()
    result, lines, loaded = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                           args.device)
    tracing.disable()
    print(json.dumps(result), flush=True)
    run, spans = kept["run"], tracing.spans()
    # latency over the window, and over its first TRACE_SECONDS (the traced
    # part of a traced run): a traced and an untraced run of one seed compare
    lat = [(f["end"] - f["due"]) * 1e3 for f in run.frames]
    head = lat[:int(cell.traffic.get("rate_hz", 10) * trace.TRACE_SECONDS)]
    report = {"device": result["device"], "seed": args.seed, "trace": args.trace,
              "latency": {"p50_ms": statistics.median(lat),
                          "p50_ms_first_trace_seconds": statistics.median(head),
                          "frames": len(lat), "frames_first": len(head)},
              "spans_dropped": tracing.dropped(), "checks_lines": lines}
    t = run.trace
    if t is not None:
        frames = program.frames(run, spans)
        t0, t1 = t.t0_ns, t.t1_ns
    else:  # every frame of the window (the warm-up's are left out)
        me = threading.current_thread().name
        warm = int(cell.traffic["warmup_frames"])
        frames = sorted((s for s in spans if s.name == program.FRAME and s.thread == me
                         and s.attrs["frame"] >= warm), key=lambda s: s.start_ns)
        t0, t1 = frames[0].start_ns, frames[-1].end_ns
    main_thread = frames[0].thread
    table = per_frame(spans, frames, main_thread)
    report.update({
        "frames_spanned": len(frames),
        "spans_ms_per_frame": table,
        "workers": workers(spans, t0, t1, main_thread),
        "self_share": {n: table[n][1] / table[n][0] for n in ("frame", "track.step")},
        "frame_counters": {k: sum(f.attrs[k] for f in frames) / len(frames)
                           for k in sorted(frames[0].attrs) if k != "frame"
                           and all(k in f.attrs for f in frames)},
        "graph_counters": {k: v for k, v in sorted(tracing.counters().items())
                           if k.startswith("frontend.graph")},
        "hash": hash_summary(spans, frames, t0, t1),
        "select": select_summary(spans, frames),
    })
    if t is not None:
        steps = program.inside(frames, spans, "track.step")
        report["idle_by_span"] = program.idle_by_span(t, spans, main_thread)
        report["checks"] = {
            "track_step_vs_benchmark_range": match_ranges(
                steps, [r[:2] for r in t.ranges.get("slambench.track_step", [])]),
            "frame_inside_benchmark_range": match_ranges(
                frames, [r[:2] for r in t.ranges.get(trace.FRAME, [])], inside_only=True),
            "dispatch_fetch_host_vs_step_ms": [
                result["metrics"].get(m, {}).get("value") for m in (
                    "track_dispatch_ms_per_frame.rt", "track_fetch_ms_per_frame.rt",
                    "track_host_ms_per_frame.rt")] + [table["track.step"][0]],
        }
        report["owners"] = owners(kept["events"], {s.name for s in spans} | set(t.ranges))
    if args.span_cost:
        report["span_cost"] = span_cost()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: report.get(k) for k in (
        "frames_spanned", "latency", "self_share", "frame_counters", "graph_counters", "hash",
        "select", "checks", "idle_by_span", "span_cost")}),
        flush=True)
    return 0 if result["correct"] and not loaded else 1


if __name__ == "__main__":
    raise SystemExit(main())

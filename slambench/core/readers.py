"""Arithmetic the metric readers share. Each returns None when the run has
nothing for it to read."""
from __future__ import annotations

import numpy as np

from slambench.core import trace


def latencies_ms(run):
    """(return - due) of the window's frames that came back."""
    return [(f["end"] - f["due"]) * 1e3 for f in run.frames if f["i"] in run.returned]


def latency_percentile_ms(run, q):
    lat = latencies_ms(run)
    return float(np.percentile(lat, q)) if lat else None


def span_ms_per_frame(run, name):
    if run.spans is None or not run.frames or not run.spans.ms.get(name):
        return None
    return float(sum(run.spans.ms[name]) / len(run.frames))


def launches_per_frame(run):
    """Launch calls of the thread that makes the frames' calls, inside them
    and outside their waits for the workers, per call."""
    t = run.trace
    if t is None or not t.ranges.get(trace.FRAME) or not t.launches:
        return None
    frames = t.ranges[trace.FRAME]
    tid = frames[0][2]
    own = [(s, th) for s, th in t.launches if th == tid]
    if not own:
        return None
    return t.launches_in(frames, t.ranges.get(trace.WAIT, []), own) / len(frames)


def idle_in_frames_pct(run):
    t = run.trace
    if t is None or not t.ranges.get(trace.FRAME) or not t.ops:
        return None
    total = busy = 0
    for s, e, _ in t.ranges[trace.FRAME]:
        total += e - s
        busy += t.busy_s(s, e) * 1e9
    return 100.0 * (1.0 - busy / total) if total > 0 else None


def roofline_share(run, span, kernel, least_s):
    """Summed least time of the traced calls over their kernels' device
    time, in %."""
    t = run.trace
    calls = run.spans.calls.get(span) if run.spans is not None else None
    if t is None or not calls:
        return None
    dev = t.op_seconds(kernel)
    if dev <= 0:
        return None
    return 100.0 * sum(least_s(c) for c in calls) / dev


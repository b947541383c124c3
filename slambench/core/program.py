"""The program's own spans, read by the per-layer metrics.

The port records spans and counters of its own (gf_orb_slam2_tpu_torch/
utils/tracing.py) while a torch profiler records, so a traced run holds them
for the part of the window that the device trace covers, on the profiler's
clock (Unix-epoch ns). The readers here take the program's `frame` spans
(one per entry call) that lie inside the traced part, `[run.trace.t0_ns,
run.trace.t1_ns]`, on the calling thread, and divide by their number. Each
returns None when the program has no spans: a program without the tracer
(an older checkout) leaves these metrics out of the line.
"""
from __future__ import annotations

import bisect
import threading
from collections import defaultdict

FRAME = "frame"


def program_spans():
    """The program's finished spans, or None where it has no tracer."""
    try:
        from gf_orb_slam2_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans()


def frames(run, spans):
    """The `frame` spans of the calling thread inside the traced part, by
    start."""
    t = run.trace
    if t is None or not spans:
        return []
    me = threading.current_thread().name
    return sorted((s for s in spans if s.name == FRAME and s.thread == me
                   and t.t0_ns <= s.start_ns and s.end_ns <= t.t1_ns),
                  key=lambda s: s.start_ns)


def inside(frame_spans, spans, name):
    """The spans called `name` on the frames' thread that lie inside one of
    `frame_spans` (sorted by start)."""
    if not frame_spans:
        return []
    me = frame_spans[0].thread
    starts = [f.start_ns for f in frame_spans]
    out = []
    for s in spans:
        if s.name != name or s.thread != me:
            continue
        i = bisect.bisect_right(starts, s.start_ns) - 1
        if i >= 0 and s.end_ns <= frame_spans[i].end_ns:
            out.append(s)
    return out


def span_ms_per_frame(run, *names, minus=()):
    """Summed ms of the spans called `names` inside the traced frames, less
    those called `minus`, per frame."""
    spans = program_spans()
    fr = frames(run, spans)
    if not fr:
        return None

    def ms(ns):
        return sum(s.end_ns - s.start_ns for n in ns for s in inside(fr, spans, n)) / 1e6

    return (ms(names) - ms(minus)) / len(fr)


def frame_attr_per_frame(run, attr, scale=1.0):
    """A counter delta that each traced `frame` span carries (`syncs`,
    `upload_bytes`, ...), summed, times `scale`, per frame."""
    fr = frames(run, program_spans())
    if not fr or any(attr not in f.attrs for f in fr):
        return None
    return scale * sum(f.attrs[attr] for f in fr) / len(fr)


def idle_by_span(trace, spans, thread=None):
    """The device's idle time inside the calls, in seconds, summed by the
    innermost program span open on the frames' thread (`thread`, by default
    the calling one): the gaps between `trace.busy_intervals()` inside the
    traced `frame` spans, each piece put down to the span around it. Returns
    {span name: s}, largest first."""
    thread = threading.current_thread().name if thread is None else thread
    mine = [s for s in spans or () if s.thread == thread
            and trace.t0_ns <= s.start_ns and s.end_ns <= trace.t1_ns]
    fr = sorted((s for s in mine if s.name == FRAME), key=lambda s: s.start_ns)
    mine = [s for s in mine if s.name == FRAME or inside(fr, [s], s.name)]
    cuts, labels = innermost(mine)
    out = defaultdict(int)
    i = 0
    prev = trace.t0_ns
    for s, e in list(trace.busy_intervals()) + [[trace.t1_ns, trace.t1_ns]]:
        lo, hi = prev, s
        prev = max(prev, e)
        # the idle gap [lo, hi], shared out over the pieces it spans
        while i + 1 < len(cuts) and cuts[i + 1] <= lo:
            i += 1
        j = i
        while lo < hi and j + 1 < len(cuts):
            a, b = max(lo, cuts[j]), min(hi, cuts[j + 1])
            if b > a and labels[j] is not None:
                out[labels[j]] += b - a
            if cuts[j + 1] >= hi:
                break
            j += 1
    return dict(sorted(((n, v / 1e9) for n, v in out.items()), key=lambda kv: -kv[1]))


def innermost(spans):
    """Cut the timeline at every span's ends; label each piece with the
    innermost span open over it (None where none is). Spans of one thread
    nest, so a stack ordered by start holds the innermost on top."""
    cuts = sorted({t for s in spans for t in (s.start_ns, s.end_ns)})
    order = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    labels, stack, k = [], [], 0
    for a in cuts[:-1]:
        while stack and stack[-1].end_ns <= a:
            stack.pop()
        while k < len(order) and order[k].start_ns <= a:
            if order[k].end_ns > a:
                stack.append(order[k])
            k += 1
        labels.append(stack[-1].name if stack else None)
    return cuts, labels

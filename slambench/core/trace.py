"""What a traced run records: host spans around the port's calls, the
profiler's device trace of part of the window, and the calls of the two hand
kernels whose rooflines are read.

Spans are `torch.profiler.record_function` ranges that the benchmark puts
around the port's methods by wrapping them at run time (the program is not
edited); each also records its host time on the benchmark's clock, for
every call in the window. The profiler runs over the first
`TRACE_SECONDS` of the window only: a whole window holds millions of host
and device events, more than a run can read inside its time limit.
"""
from __future__ import annotations

import bisect
import functools
import time
from collections import defaultdict

TRACE_SECONDS = 6.0
FRAME = "slambench.frame"   # the range around one entry call
WAIT = "slambench.wait"     # System._wait_workers inside a call
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaLaunchCooperativeKernel")


class Spans:
    """Host ms per span name, for the calls made while `on` is set; the
    wrappers are installed on the port's classes and modules by `wrap` and
    removed by `unwrap`."""

    def __init__(self):
        self.on = False
        self.ms = defaultdict(list)
        self.calls = defaultdict(list)   # hand-kernel calls while profiling
        self.profiling = False
        self._undo = []

    def wrap(self, owner, attr, span, keep=None):
        import torch

        fn = getattr(owner, attr)
        spans = self

        @functools.wraps(fn)
        def run(*a, **k):
            if not spans.on:
                return fn(*a, **k)
            t0 = time.perf_counter()
            with torch.profiler.record_function(span):
                out = fn(*a, **k)
            spans.ms[span].append((time.perf_counter() - t0) * 1e3)
            if keep is not None and spans.profiling:
                spans.calls[span].append(keep(a, k, out))
            return out

        setattr(owner, attr, run)
        self._undo.append((owner, attr, fn))

    def unwrap(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


def pose_lm_call(a, k, out):
    """N, rounds and iters of one `pose_lm` call."""
    return {"n": int(a[2].shape[0]), "rounds": int(a[12]), "iters": int(a[13])}


def greedy_select_call(a, k, out):
    """What the selection's bound needs: its sizes, options, the valid mask,
    the uniforms and the picks (copied; read after the window)."""
    obs, valid, n_select, batch, lazier, eps = a[:6]
    base = a[6] if len(a) > 6 else k.get("base_mat")
    u = a[7] if len(a) > 7 else k.get("uniforms")
    return {"P": int(obs.shape[0]), "D": int(obs.shape[1]), "n_select": int(n_select),
            "batch": int(batch), "lazier": int(lazier), "base": base is not None,
            "valid": valid.detach().clone(), "uniforms": None if u is None else u.detach().clone(),
            "order": out[1].detach().clone()}


class DeviceTrace:
    """The profiler's events of the traced part of the window, on one clock
    (ns since the epoch): device operations, launch calls and the
    benchmark's own ranges."""

    def __init__(self, events, t0_ns, t1_ns):
        from torch.autograd import DeviceType

        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        self.ops = []          # (start, end, name) of device operations
        self.launches = []     # (start, thread) of launch calls
        self.ranges = defaultdict(list)  # name -> [(start, end, thread)]
        self._busy = self._starts = None
        for e in events:
            # by the device and the name: older torch has no activity_type()
            name, s = e.name(), e.start_ns()
            ours = name.startswith("slambench.")
            if e.device_type() == DeviceType.CUDA:
                if not ours:  # (the device's copy of our ranges is no work)
                    self.ops.append((s, s + e.duration_ns(), name))
            elif name in LAUNCH_NAMES:
                self.launches.append((s, e.start_thread_id()))
            elif ours:
                self.ranges[name].append((s, s + e.duration_ns(), e.start_thread_id()))
        self.ops.sort()
        self.launches.sort()

    @property
    def window_s(self):
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_intervals(self):
        """The union of the device operations' intervals, inside the traced
        part of the window."""
        if self._busy is None:
            out = []
            for s, e, _ in self.ops:
                s, e = max(s, self.t0_ns), min(e, self.t1_ns)
                if e <= s:
                    continue
                if out and s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], e)
                else:
                    out.append([s, e])
            self._busy = out
        return self._busy

    def busy_s(self, lo=None, hi=None):
        """Seconds in which some operation ran on the device, in [lo, hi]
        (by default the whole traced part)."""
        busy = self.busy_intervals()
        if lo is None:
            return sum(e - s for s, e in busy) / 1e9
        i = max(bisect.bisect_right(self._busy_starts(), lo) - 1, 0)
        total = 0
        for s, e in busy[i:]:
            if s >= hi:
                break
            total += max(0, min(e, hi) - max(s, lo))
        return total / 1e9

    def _busy_starts(self):
        if self._starts is None:
            self._starts = [s for s, _ in self.busy_intervals()]
        return self._starts

    def op_seconds(self, match):
        """Summed device seconds of the operations whose name contains
        `match`."""
        return sum(e - s for s, e, n in self.ops if match in n) / 1e9

    @staticmethod
    def launches_in(intervals, minus, launches):
        """How many of `launches` [(start, thread)] lie inside one of
        `intervals` and outside all of `minus`."""
        starts = [s for s, _ in launches]
        inside = set()
        for lo, hi, *_ in intervals:
            inside.update(range(bisect.bisect_left(starts, lo), bisect.bisect_right(starts, hi)))
        for lo, hi, *_ in minus:
            inside.difference_update(range(bisect.bisect_left(starts, lo),
                                           bisect.bisect_right(starts, hi)))
        return len(inside)

    def breakdown(self, host_names):
        """The device operations that took most time, and the idle time of
        the device summed by what the host was inside (the innermost of
        the benchmark's ranges on the main thread; "outside" between
        calls), each the 10 largest."""
        by_op = defaultdict(int)
        for s, e, n in self.ops:
            by_op[n] += e - s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        ranges = [(s, e, n) for n in host_names for s, e, _ in self.ranges.get(n, ())]
        cuts, labels = _segments(ranges)
        gaps = defaultdict(int)
        prev = self.t0_ns
        for s, e in self.busy_intervals() + [[self.t1_ns, self.t1_ns]]:
            if s > prev:  # an idle gap [prev, s], shared out over the pieces it spans
                i = bisect.bisect_right(cuts, prev) - 1
                lo = prev
                while lo < s:
                    hi = min(s, cuts[i + 1]) if i + 1 < len(cuts) else s
                    gaps[labels[i] if 0 <= i < len(labels) else "outside"] += hi - lo
                    lo, i = hi, i + 1
            prev = max(prev, e)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, v / 1e9] for n, v in ops],
                "idle_gaps": [[n, v / 1e9] for n, v in idle]}


def _segments(ranges):
    """Cut the timeline at every range's ends; label each piece with the
    shortest range that covers it ("outside" where none does). Returns the
    cut times and the label of the piece that starts at each."""
    cuts = sorted({t for s, e, _ in ranges for t in (s, e)})
    labels = []
    for a, b in zip(cuts, cuts[1:]):
        best = None
        for s, e, n in ranges:
            if s <= a and b <= e and (best is None or e - s < best[0]):
                best = (e - s, n)
        labels.append(best[1] if best else "outside")
    return cuts, labels

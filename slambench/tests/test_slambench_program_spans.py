"""The readers of the program's own spans (slambench/core/program.py) on
spans and a device trace made up here: the traced part of the window and
the calling thread pick the frames, the per-frame arithmetic of the six
metrics, nothing read where the program has no spans, and the device's idle
time inside the calls put down to the innermost span."""
import threading
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from slambench.core import bench, program, trace

METRICS = ("track_dispatch_ms_per_frame.rt", "track_fetch_ms_per_frame.rt",
           "track_host_ms_per_frame.rt", "worker_wait_ms_per_frame.rt",
           "host_syncs_per_frame.rt", "h2d_kb_per_frame.rt")


class Ev:
    def __init__(self, name, s, d):
        self.n, self.s, self.d = name, s, d

    def device_type(self):
        return DeviceType.CUDA

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def start_thread_id(self):
        return 1


def made_trace():
    """Kernels over [0, 1000]: inside the first frame's dispatch and fetch,
    the second frame's wait and fetch, and outside the calls."""
    ev = [Ev("k", 35, 10), Ev("k", 65, 5), Ev("k", 120, 30), Ev("k", 210, 10),
          Ev("k", 280, 20), Ev("k", 500, 50)]
    return trace.DeviceTrace(ev, 0, 1000)


def sp(name, s, e, thread=None, **attrs):
    return SimpleNamespace(name=name, start_ns=s, end_ns=e, attrs=attrs,
                           thread=thread or threading.current_thread().name)


def made_spans():
    return [
        # frame A [0, 100]
        sp("frame.wait_workers", 0, 10), sp("track.dispatch", 30, 50),
        sp("track.fetch", 60, 80), sp("track.step", 20, 90),
        sp("frame", 0, 100, frame=7, syncs=1, upload_bytes=2000),
        # frame B [200, 300]
        sp("frame.wait_workers", 200, 230), sp("track.dispatch", 250, 260),
        sp("track.fetch", 270, 290), sp("track.step", 240, 300),
        sp("frame", 200, 300, frame=8, syncs=3, upload_bytes=4000),
        # a worker's event between the calls, and another thread's frame
        sp("map.event", 120, 180, thread="mapping"),
        sp("track.dispatch", 510, 520, thread="other"),
        sp("frame", 500, 600, thread="other", syncs=9, upload_bytes=9),
        # a frame past the traced part
        sp("track.dispatch", 1110, 1150),
        sp("frame", 1100, 1200, frame=9, syncs=9, upload_bytes=9),
    ]


@pytest.fixture
def traced_run(monkeypatch):
    monkeypatch.setattr(program, "program_spans", made_spans)
    run = bench.Run()
    run.trace = made_trace()
    return run


def test_frames_of_the_traced_part_on_the_calling_thread(traced_run):
    fr = program.frames(traced_run, made_spans())
    assert [f.attrs["frame"] for f in fr] == [7, 8]
    assert [s.start_ns for s in program.inside(fr, made_spans(), "track.dispatch")] == [30, 250]


def test_per_frame_arithmetic(traced_run):
    got = {m: bench.reader(m)(traced_run) for m in METRICS}
    assert got["track_dispatch_ms_per_frame.rt"] == pytest.approx((20 + 10) / 2 / 1e6)
    assert got["track_fetch_ms_per_frame.rt"] == pytest.approx((20 + 20) / 2 / 1e6)
    # the step less its dispatch and fetch
    assert got["track_host_ms_per_frame.rt"] == pytest.approx((70 + 60 - 30 - 40) / 2 / 1e6)
    assert got["worker_wait_ms_per_frame.rt"] == pytest.approx((10 + 30) / 2 / 1e6)
    assert got["host_syncs_per_frame.rt"] == pytest.approx(2.0)
    assert got["h2d_kb_per_frame.rt"] == pytest.approx(3.0)
    assert (got["track_dispatch_ms_per_frame.rt"] + got["track_fetch_ms_per_frame.rt"]
            + got["track_host_ms_per_frame.rt"]) == pytest.approx(
        program.span_ms_per_frame(traced_run, "track.step"))


def test_nothing_read_without_program_spans(monkeypatch):
    run = bench.Run()
    run.trace = made_trace()
    for spans in (lambda: None, lambda: [], lambda: [s for s in made_spans()
                                                      if s.name != "frame"]):
        monkeypatch.setattr(program, "program_spans", spans)
        assert all(bench.reader(m)(run) is None for m in METRICS)
    monkeypatch.setattr(program, "program_spans", made_spans)
    run.trace = None  # an untraced run
    assert all(bench.reader(m)(run) is None for m in METRICS)
    # frames without the counters' deltas: the counter metrics read nothing
    run.trace = made_trace()
    monkeypatch.setattr(program, "program_spans", lambda: [
        sp("frame", 0, 100), sp("track.step", 20, 90)])
    assert bench.reader("host_syncs_per_frame.rt")(run) is None
    assert bench.reader("track_host_ms_per_frame.rt")(run) == pytest.approx(70 / 1e6)


def test_idle_by_span():
    idle = program.idle_by_span(made_trace(), made_spans())
    want = {"track.step": 10 + 10 + 10 + 10 + 10, "frame": 20 + 10,
            "frame.wait_workers": 10 + 20, "track.fetch": 15 + 10, "track.dispatch": 10 + 10}
    assert set(idle) == set(want)
    for k, v in want.items():
        assert idle[k] == pytest.approx(v / 1e9), k
    assert list(idle) == sorted(idle, key=lambda k: -idle[k])
    # the other thread's call
    # (its dispatch [510, 520] lies under a kernel [500, 550])
    assert program.idle_by_span(made_trace(), made_spans(), thread="other") == pytest.approx(
        {"frame": 50 / 1e9})
    assert program.idle_by_span(made_trace(), []) == {}

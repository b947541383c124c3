"""The port's spans and counters: one tracer for the frame path and the
worker threads.

Spans. `span(name, **attrs)` is a context manager around a stage of the
program (`spanned(name)` makes each call of a function one). While tracing
is on it records the finished span — its name, start and end, the thread's
name, the id of the span open around it on the same thread and its
attributes — into a bounded buffer (the newest `MAX_SPANS`; `dropped()`
counts the rest), and while a `torch.profiler` records it also opens a
profiler range of its name, so the profiler's trace ties each kernel to the
span that launched it. The range is of function scope
(`torch._C._profiler._RecordFunctionFast`): a `record_function` range is a
user annotation, which the profiler also lays on the device's timeline,
where a trace that sums device events would count it as device work.
Tracing is on after `enable()` until `disable()`, and while a torch profiler
records. Off, a span costs one flag check and records nothing.

`timed(name, **attrs)` is a span that measures its duration (`ms`) and the
part its child spans leave (`self_ms`) even while tracing is off: it feeds
the always-on records (`LocalMapper.event_ms`, `LoopCloser.event_ms`,
`RelocStats.ms`, `Tracker.init_stats`). Its `kids` sums its direct
children's nanoseconds by name. `entry(name, **attrs)` is the span of a
public entry: it also stores the calling thread's counter deltas over the
call (`uploads`, `upload_bytes`, `syncs`, `download_bytes`, `graph_replays`,
`launches`, of which `obs_info_launches` are the selection's
information-matrix kernel's, and the hashed local map's `hash_candidates`
and `hash_added`).
`set(**attrs)` adds attributes known only at a span's end (off, it does
nothing).

The clock is torch.profiler's: Unix-epoch nanoseconds (`time.time_ns()`),
so a span lies directly over the profiler's device events. A span inherits
`frame` and `kf` from the span open around it on its thread.

Counters. `count(name, n)` adds to an integer counter of the calling
thread's name; they are always on. The port counts host→device copies
(`h2d.copies`, `h2d.bytes`: utils/transfer.py), blocking downloads
(`d2h.syncs`, `d2h.bytes`), hand-kernel launches (`launch.<kernel>`:
ops/cuda_lib.py; a replayed CUDA graph adds the launches of its capture),
the frontend's CUDA graphs (`frontend.graph_captures`,
`frontend.graph_replays`: utils/cuda_graph.py) and the hashed local map's
work (`hash.candidates`, the ids the tables returned, and `hash.added`, the
pool points only the hash gave: tracking/tracker.py).

Read the spans with `spans()` (a copy) and empty the buffer with `clear()`.
"""
from __future__ import annotations

import collections
import functools
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1 << 17
INHERITED = ("frame", "kf")   # attributes a span takes from the span around it

_enabled = False
_buf = collections.deque(maxlen=MAX_SPANS)
_buf_lock = threading.Lock()
_n_dropped = 0
_ids = itertools.count(1)
_local = threading.local()
_counts = {}                  # thread name -> {counter: int}
_count_lock = threading.Lock()


def enable():
    """Record spans until `disable()`."""
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def is_on() -> bool:
    """Whether spans are recorded now: after `enable()`, or while a torch
    profiler records."""
    return _enabled or _autograd_profiler._is_profiler_enabled


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """One span: a context manager while open, a record once closed.
    `start_ns` / `end_ns` are Unix-epoch ns; `parent` is the id of the span
    open around it on the same thread (None at the top)."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "thread", "id", "parent", "child_ns",
                 "kids", "_rec", "_rf", "_counts")

    def __init__(self, name, attrs, kids=None, entry=False):
        self.name = name
        self.attrs = attrs
        self.kids = kids
        self.child_ns = 0
        self.id = self.parent = self.thread = None
        self._counts = {} if entry else None  # an entry's counters at its start

    def __enter__(self):
        st = _stack()
        up = st[-1] if st else None
        self._rec = is_on()
        if self._rec:
            self.id = next(_ids)
            self.parent = up.id if up is not None and up._rec else None
            self.thread = threading.current_thread().name
            if up is not None:
                for k in INHERITED:
                    if k not in self.attrs and k in up.attrs:
                        self.attrs[k] = up.attrs[k]
            if self._counts is not None:
                self._counts = counters(self.thread)
        st.append(self)
        self._rf = None
        # the profiler's range lies inside the span
        self.start_ns = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self.end_ns = time.time_ns()
        st = _stack()
        st.pop()
        d = self.end_ns - self.start_ns
        if st:
            up = st[-1]
            up.child_ns += d
            if up.kids is not None:
                up.kids[self.name] = up.kids.get(self.name, 0) + d
        if self._rec:
            if self._counts is not None:
                self.attrs.update(_deltas(self._counts, counters(self.thread)))
                self._counts = None
            _record(self)
        return False

    def set(self, **attrs):
        """Add attributes known only at the span's end."""
        self.attrs.update(attrs)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def self_ms(self) -> float:
        """The span's time outside its child spans."""
        return (self.end_ns - self.start_ns - self.child_ns) / 1e6

    @property
    def child_ms(self) -> float:
        return self.child_ns / 1e6

    def __repr__(self):
        return f"Span({self.name!r}, {self.ms:.3f} ms, {self.thread}, {self.attrs})"


class _Off:
    """The span of a stage while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


def span(name: str, **attrs):
    """A stage of the program: recorded while tracing is on, else nothing."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return Span(name, attrs)


def timed(name: str, **attrs) -> Span:
    """A span measured whether or not tracing is on (recorded only while it
    is); `kids` sums its direct children by name."""
    return Span(name, attrs, kids={})


def spanned(name: str):
    """Make every call of the decorated function a span of `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not (_enabled or _autograd_profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with Span(name, {}):
                return fn(*args, **kwargs)
        return run
    return wrap


def entry(name: str, **attrs):
    """The span of a public entry: with tracing on it also stores the calling
    thread's counter deltas over the call."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return Span(name, attrs, entry=True)


def record(name: str, start_ns: int, end_ns: int, **attrs):
    """Record a span that has already happened (e.g. a queue wait that began
    on another thread) on the calling thread, while tracing is on."""
    if not is_on():
        return
    sp = Span(name, attrs)
    st = _stack()
    up = st[-1] if st else None
    sp.id = next(_ids)
    sp.parent = up.id if up is not None and up._rec else None
    sp.thread = threading.current_thread().name
    sp.start_ns, sp.end_ns = start_ns, end_ns
    _record(sp)


def _record(sp):
    global _n_dropped
    with _buf_lock:
        if len(_buf) == MAX_SPANS:
            _n_dropped += 1
        _buf.append(sp)


def spans() -> list:
    """The finished spans in the buffer, oldest first (a copy)."""
    with _buf_lock:
        return list(_buf)


def dropped() -> int:
    """Spans pushed out of the full buffer since the last `clear()`."""
    return _n_dropped


def clear():
    global _n_dropped
    with _buf_lock:
        _buf.clear()
        _n_dropped = 0


# ------------------------------------------------------------------ counters
_DELTAS = (("uploads", "h2d.copies"), ("upload_bytes", "h2d.bytes"),
           ("syncs", "d2h.syncs"), ("download_bytes", "d2h.bytes"),
           ("graph_replays", "frontend.graph_replays"),
           ("obs_info_launches", "launch.obs_info"),
           ("hash_candidates", "hash.candidates"), ("hash_added", "hash.added"))


def count(name: str, n: int = 1):
    """Add n to the calling thread's counter `name`."""
    thread = threading.current_thread().name
    with _count_lock:
        mine = _counts.get(thread)
        if mine is None:
            mine = _counts[thread] = {}
        mine[name] = mine.get(name, 0) + n


def counters(thread: str = None) -> dict:
    """The counters of the threads of that name, or of all threads summed."""
    with _count_lock:
        if thread is not None:
            return dict(_counts.get(thread, ()))
        out = {}
        for mine in _counts.values():
            for k, v in mine.items():
                out[k] = out.get(k, 0) + v
        return out


def reset_counters(prefix: str = ""):
    """Set the counters whose names start with `prefix` to 0, in every
    thread."""
    with _count_lock:
        for mine in _counts.values():
            for k in [k for k in mine if k.startswith(prefix)]:
                del mine[k]


def _deltas(before: dict, after: dict) -> dict:
    out = {a: after.get(c, 0) - before.get(c, 0) for a, c in _DELTAS}
    out["launches"] = sum(v - before.get(k, 0) for k, v in after.items()
                          if k.startswith("launch."))
    return out

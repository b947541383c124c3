"""Replay a pure function of fixed-shape CUDA tensors as one captured CUDA
graph per input signature.

`GraphCache.run(name, fn, *inputs)` returns `fn(*inputs)`, a dict of
tensors; an input may be None. On CPU tensors it is the plain call. On CUDA
tensors the signature is (name, device, each input's shape and dtype, or
None). The first call with a signature runs `fn` eagerly on a side stream
(its result is that call's result) and then captures `fn` on the same stream
into a `torch.cuda.CUDAGraph` that reads static input buffers and packs every
output into one static buffer. A later call with the signature copies in any
input that is not already its static buffer (a caller that did not upload
through `GraphCache.upload`), replays the graph and clones
the packed buffer once: it returns views of that clone, with the dtypes and
shapes `fn` gives, so no later replay overwrites what an earlier call
returned.

The static inputs are views of one flat uint8 buffer laid out as
`utils/transfer.py` packs a dict of arrays (`packed_offsets`), in argument
order. `GraphCache.upload(name, device, *arrays)` makes a frame's one
host→device copy of its host arrays (`to_device`): straight into that
buffer once the arrays' signature is captured, so the replay copies nothing
in. Both calls take the signature from `_signature`.

`fn` must be pure, draw no random numbers and never wait for the device: a
replay runs the kernels its capture enqueued, not its Python. Python
numbers and the tensors it reads besides its inputs are taken as they were
at the capture.

Counters (utils/tracing.py, on the calling thread): `<prefix>.graph_captures`
and `<prefix>.graph_replays`. The hand kernels' `launch.<kernel>` counts
that the capture made are taken back and added again at each replay, which
runs those kernels; tests/test_torch_frontend_graph.py holds them against
the hand kernels in a profiler trace of a replay.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from gf_orb_slam2_tpu_torch.utils import tracing
from gf_orb_slam2_tpu_torch.utils.transfer import packed_offsets, to_device, torch_dtype

LAUNCH_PREFIX = "launch."


def _device(device) -> torch.device:
    """A CUDA device with its index ("cuda" is the current device)."""
    device = torch.device(device)
    if device.index is None:
        return torch.device(device.type, torch.cuda.current_device())
    return device


def _signature(inputs) -> tuple:
    """Each input's shape and dtype on the device, or None: a tensor's own, a
    numpy array's as `to_device` lands it."""
    return tuple(None if x is None else
                 (tuple(x.shape),
                  torch_dtype(x.dtype) if isinstance(x, np.ndarray) else x.dtype)
                 for x in inputs)


def _launch_counts() -> dict:
    me = threading.current_thread().name
    return {k: v for k, v in tracing.counters(me).items() if k.startswith(LAUNCH_PREFIX)}


class _Graph:
    """One signature's captured graph. Made by the signature's first call,
    whose result (the eager run's) is `first` until taken."""

    def __init__(self, fn, inputs, device, prefix):
        self.prefix = prefix
        specs = [x for x in inputs if x is not None]
        offsets, total = packed_offsets(x.nbytes for x in specs)
        self.flat_in = torch.empty(total, dtype=torch.uint8, device=device)
        views = iter(self.flat_in[off:off + x.nbytes].view(x.dtype).view(x.shape)
                     for off, x in zip(offsets, specs))
        self.static_in = [None if x is None else next(views) for x in inputs]

        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.first = fn(*inputs)
        cur.wait_stream(side)
        for t in self.first.values():
            t.record_stream(cur)

        # the outputs' packed layout, as `to_device` packs arrays
        outs = self.first
        offsets, total = packed_offsets(t.nbytes for t in outs.values())
        self.layout = [(k, off, t.nbytes, t.dtype, t.shape)
                       for (k, t), off in zip(outs.items(), offsets)]
        self.flat_out = torch.empty(total, dtype=torch.uint8, device=device)
        # the zero bytes from each output's end to the next one's offset
        self._pads = [torch.zeros(nxt - off - n, dtype=torch.uint8, device=device)
                      for (_, off, n, _, _), nxt in zip(self.layout, offsets[1:] + [total])]

        before = _launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
            res = fn(*self.static_in)
            segs = []
            for (k, _, _, _, _), pad in zip(self.layout, self._pads):
                segs += [res[k].reshape(-1).view(torch.uint8), pad]
            torch.cat(segs, out=self.flat_out)
        after = _launch_counts()
        self.launches = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}
        for k, n in self.launches.items():  # the capture ran nothing
            tracing.count(k, -n)
        tracing.count(prefix + ".graph_captures")

    def replay(self, inputs) -> dict:
        for x, s in zip(inputs, self.static_in):
            if x is not None and (x.data_ptr() != s.data_ptr() or x.stride() != s.stride()):
                s.copy_(x)
        self.graph.replay()
        flat = self.flat_out.clone()
        for k, n in self.launches.items():
            tracing.count(k, n)
        tracing.count(self.prefix + ".graph_replays")
        return {k: flat[off:off + n].view(dtype).view(shape)
                for k, off, n, dtype, shape in self.layout}


class GraphCache:
    """Captured graphs by signature, for one owner (a System's frontend);
    the counters are named `<prefix>.graph_*`. Use from one thread."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._graphs = {}

    def _key(self, name, device, inputs):
        return (name, _device(device), _signature(inputs))

    def upload(self, name, device, *arrays) -> tuple:
        """Host arrays (numpy, or None for an absent input) → tensors on
        `device` in one counted copy (`to_device`), in the inputs of the graph
        that `run(name, ...)` replays for them once it is captured, else in a
        new buffer; None stays None."""
        g = (self._graphs.get(self._key(name, device, arrays))
             if torch.device(device).type == "cuda" else None)
        d = to_device({str(i): a for i, a in enumerate(arrays) if a is not None}, device,
                      out=None if g is None else g.flat_in)
        return tuple(None if a is None else d[str(i)] for i, a in enumerate(arrays))

    def run(self, name, fn, *inputs) -> dict:
        """`fn(*inputs)`: replayed from the signature's graph on CUDA."""
        x0 = next(x for x in inputs if x is not None)
        if not x0.is_cuda:
            return fn(*inputs)
        key = self._key(name, x0.device, inputs)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = _Graph(fn, inputs, key[1], self.prefix)
            first, g.first = g.first, None
            return first
        return g.replay(inputs)

"""Host↔device transfer helpers: one synchronization per batch of tensors.

Every copy made here is counted on the calling thread (utils/tracing.py):
`h2d.copies` / `h2d.bytes` for each host→device copy, `d2h.syncs` /
`d2h.bytes` for each blocking download (`PendingHost.wait`), on any device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gf_orb_slam2_tpu_torch.utils import tracing


class PendingHost:
    """Downloads enqueued by `to_host_async`: `wait()` blocks until they have
    landed and returns the numpy arrays."""

    def __init__(self, bufs: Dict[str, torch.Tensor], event):
        self._bufs = bufs
        self._event = event

    def wait(self) -> Dict[str, np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        tracing.count("d2h.syncs")
        tracing.count("d2h.bytes", sum(v.nbytes for v in self._bufs.values()))
        return {k: v.numpy() for k, v in self._bufs.items()}


def to_host_async(tensors: Dict[str, torch.Tensor]) -> PendingHost:
    """Enqueue the download of a dict of tensors without waiting for it: CUDA
    tensors are copied non-blocking into pinned buffers on the current stream
    and one CUDA event is recorded after the copies (the stream's later work
    does not delay them). CPU tensors are viewed in place."""
    bufs = {}
    for k, v in tensors.items():
        v = v.detach()
        if v.is_cuda:
            bufs[k] = torch.empty(v.shape, dtype=v.dtype, device="cpu", pin_memory=True)
            bufs[k].copy_(v, non_blocking=True)
        else:
            bufs[k] = v
    event = None
    if any(v.is_cuda for v in tensors.values()):
        event = torch.cuda.Event()
        event.record()
    return PendingHost(bufs, event)


def to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Download a dict of tensors as numpy arrays with ONE wait for the
    whole batch (`to_host_async` + `wait`); CPU tensors are viewed in place."""
    return to_host_async(tensors).wait()


_TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
                np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
                np.dtype(np.uint32): torch.int32, np.dtype(bool): torch.bool,
                np.dtype(np.uint8): torch.uint8}


def torch_dtype(dtype) -> torch.dtype:
    """The dtype a host array of numpy `dtype` has on the device after
    `to_device` (uint32 words as int32 with the same bits)."""
    return _TORCH_DTYPE[np.dtype(dtype)]


def packed_offsets(nbytes):
    """Byte offsets of buffers of `nbytes` each packed one after another at
    16-byte alignment, and the packed total: the layout of `to_device`."""
    offsets, total = [], 0
    for n in nbytes:
        offsets.append(total)
        total += -(-n // 16) * 16
    return offsets, total


def to_device(arrays: Dict[str, np.ndarray], device, out=None) -> Dict[str, torch.Tensor]:
    """Upload a dict of numpy arrays in ONE host→device copy: they are packed
    (`packed_offsets`) into one buffer — pinned when the target is a CUDA
    device — copied asynchronously, and viewed on the device as tensors of
    their own dtype and shape (uint32 words as int32 with the same bits).
    `out`, a flat uint8 device buffer of at least the packed size, receives
    the copy instead of a new buffer."""
    device = torch.device(device)
    arrays = {k: np.ascontiguousarray(a).reshape(np.shape(a))  # 0-d arrays stay 0-d
              for k, a in arrays.items()}
    offsets, total = packed_offsets(a.nbytes for a in arrays.values())
    host = torch.empty(total, dtype=torch.uint8, pin_memory=device.type == "cuda")
    flat = host.numpy()
    for off, a in zip(offsets, arrays.values()):
        flat[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    if out is None:
        dev = host.to(device, non_blocking=True)
    else:
        dev = out[:total].copy_(host, non_blocking=True)
    tracing.count("h2d.copies")
    tracing.count("h2d.bytes", total)
    return {k: dev[off:off + a.nbytes].view(torch_dtype(a.dtype)).reshape(a.shape)
            for off, (k, a) in zip(offsets, arrays.items())}


def upload(a, device) -> torch.Tensor:
    """One host array (numpy or a CPU tensor) → a tensor on `device`, in one
    counted copy."""
    t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    tracing.count("h2d.copies")
    tracing.count("h2d.bytes", t.nbytes)
    return t.to(device)


def desc_to_torch(desc: np.ndarray, device) -> torch.Tensor:
    """Host descriptors (numpy uint32 words) → int32 tensor with the same
    bits on `device`."""
    return upload(np.ascontiguousarray(desc).view(np.int32), device)


def desc_to_numpy(desc: np.ndarray) -> np.ndarray:
    """Downloaded int32 descriptor words → the host's uint32 view."""
    return np.ascontiguousarray(desc).view(np.uint32)

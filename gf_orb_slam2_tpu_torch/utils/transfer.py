"""Host↔device transfer helpers: one synchronization per batch of tensors."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Download a dict of tensors as numpy arrays. CUDA tensors are copied
    asynchronously into pinned buffers and the stream is synchronized ONCE
    for the whole batch; CPU tensors are viewed in place."""
    out = {}
    pending = False
    for k, v in tensors.items():
        v = v.detach()
        if v.is_cuda:
            buf = torch.empty(v.shape, dtype=v.dtype, device="cpu", pin_memory=True)
            buf.copy_(v, non_blocking=True)
            out[k] = buf
            pending = True
        else:
            out[k] = v
    if pending:
        torch.cuda.current_stream().synchronize()
    return {k: v.numpy() for k, v in out.items()}


_TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
                np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
                np.dtype(np.uint32): torch.int32, np.dtype(bool): torch.bool,
                np.dtype(np.uint8): torch.uint8}


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Upload a dict of numpy arrays in ONE host→device copy: they are packed
    (16-byte aligned) into one buffer — pinned when the target is a CUDA
    device — copied asynchronously, and viewed on the device as tensors of
    their own dtype and shape (uint32 words as int32 with the same bits)."""
    device = torch.device(device)
    offsets, total = {}, 0
    for k, a in arrays.items():
        a = np.ascontiguousarray(a)
        offsets[k] = (total, a)
        total += -(-a.nbytes // 16) * 16
    host = torch.empty(total, dtype=torch.uint8, pin_memory=device.type == "cuda")
    flat = host.numpy()
    for off, a in offsets.values():
        flat[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    return {k: dev[off:off + a.nbytes].view(_TORCH_DTYPE[a.dtype]).reshape(a.shape)
            for k, (off, a) in offsets.items()}


def desc_to_torch(desc: np.ndarray, device) -> torch.Tensor:
    """Host descriptors (numpy uint32 words) → int32 tensor with the same
    bits on `device`."""
    return torch.from_numpy(np.ascontiguousarray(desc).view(np.int32)).to(device)


def desc_to_numpy(desc: np.ndarray) -> np.ndarray:
    """Downloaded int32 descriptor words → the host's uint32 view."""
    return np.ascontiguousarray(desc).view(np.uint32)

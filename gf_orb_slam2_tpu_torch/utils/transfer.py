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


def desc_to_torch(desc: np.ndarray, device) -> torch.Tensor:
    """Host descriptors (numpy uint32 words) → int32 tensor with the same
    bits on `device`."""
    return torch.from_numpy(np.ascontiguousarray(desc).view(np.int32)).to(device)


def desc_to_numpy(desc: np.ndarray) -> np.ndarray:
    """Downloaded int32 descriptor words → the host's uint32 view."""
    return np.ascontiguousarray(desc).view(np.uint32)

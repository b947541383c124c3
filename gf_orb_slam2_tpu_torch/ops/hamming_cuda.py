"""Hand-written CUDA kernels for 256-bit Hamming matching.

Two kernels, both replacing the JAX package's Pallas kernel
(gf_orb_slam2_tpu/ops/pallas_hamming.py):

- `hamming_distance_matrix(da, db)` launches csrc/hamming.cu: the full [N,M]
  matrix, bit-counted on the tensor cores (binary `mma.sync ... and.popc`).
  Bound by the bytes of its output; measured on an H100 at 6.2 µs for
  4096×1024 (byte bound 5.06 µs; the SIMT `__popc` version before it took
  11 µs) and 3.0 µs for 1024×1024, where an empty kernel takes 1.2 µs;
- `hamming_masked_best2(da, db, mask)` launches csrc/hamming_best2.cu: the
  same distances reduced in the kernel to best column / best / second best
  per row under a mask, without writing the matrix. This is the form the
  matching calls use. A warp per row visits only the entries the mask lets
  through, so it is bound by the bytes of the mask (1.32 µs at 4096×1024);
  measured at 3-4 µs on the sparse masks of the tracking path — launch plus
  dependent trips to memory, not bytes — where the matrix kernel followed by
  `masked_best2` takes 130 µs on the device. A dense mask puts it on the
  POPC pipe: 36 µs on an all-true mask at 4096×1024.

`hamming_distance_matrix_ref` and `hamming_masked_best2_ref` are the plain
PyTorch versions of the same functions (XOR → parallel bit-count in tensor
arithmetic → sum; composite-key minimum), used for CPU tensors and to hold
the kernels against on the card. There is no fallback between them: a CUDA
tensor launches the kernel or raises.

The sources are built and loaded at first use by `ops/cuda_lib.py`, which
also keeps the launch counts (re-exported here) — importing this module
needs neither nvcc nor a GPU.

Descriptors are int32 tensors carrying the 256 bits as 8 words (torch has no
shifts on uint32); the kernels treat the words as unsigned.
"""
from __future__ import annotations

import torch

from gf_orb_slam2_tpu_torch.ops import cuda_lib
from gf_orb_slam2_tpu_torch.ops.cuda_lib import (  # noqa: F401  (public names)
    build, launch_counts, launch_empty_kernel, load, reset_launch_counts,
    thread_launch_counts,
)

MAX_DIST = 256
MAX_COLUMNS = 1 << 22  # the best-2 key d*M + column must fit 32 bits

_ROW_CHUNK = 256  # rows per step of the plain version (bounds its scratch)


def _check(name, d):
    if d.dim() != 2 or d.shape[1] != 8:
        raise ValueError(f"{name}: expected shape [*, 8], got {tuple(d.shape)}")
    if d.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"{name}: expected a 4-byte integer dtype, got {d.dtype}")


def _check_on_card(fname, da, db):
    if not (da.is_cuda and db.is_cuda):
        raise ValueError(f"{fname} launches a CUDA kernel: the inputs must be "
                         f"CUDA tensors (use {fname}_ref for CPU tensors)")
    if da.device != db.device:
        raise ValueError(f"inputs on different devices: {da.device} vs {db.device}")
    if not (da.is_contiguous() and db.is_contiguous()):
        raise ValueError("inputs must be contiguous")


def hamming_distance_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """da [N,8], db [M,8] 32-bit words on one CUDA device → [N,M] int32.

    Launches the CUDA kernel on the current stream without synchronizing.
    """
    _check("da", da)
    _check("db", db)
    _check_on_card("hamming_distance_matrix", da, db)
    n, m = da.shape[0], db.shape[0]
    out = torch.empty((n, m), dtype=torch.int32, device=da.device)
    if n == 0 or m == 0:
        return out
    if da.data_ptr() % 16 or db.data_ptr() % 16:
        raise ValueError("inputs must be 16-byte aligned")
    cuda_lib.launch("hamming_distance_matrix", "hamming_distance_matrix_launch", da.device,
            da.data_ptr(), db.data_ptr(), out.data_ptr(), n, m)
    return out


def _check_mask(mask, n, m):
    if mask.dtype != torch.bool:
        raise TypeError(f"mask: expected torch.bool, got {mask.dtype}")
    if tuple(mask.shape) != (n, m):
        raise ValueError(f"mask: expected shape {(n, m)}, got {tuple(mask.shape)}")
    if m >= MAX_COLUMNS:
        raise ValueError(f"M = {m}: the best-2 key needs M < {MAX_COLUMNS}")


def hamming_masked_best2(da: torch.Tensor, db: torch.Tensor, mask: torch.Tensor):
    """Best and second-best Hamming match per row under a mask, without the
    matrix: da [N,8], db [M,8] 32-bit words, mask [N,M] bool, all on one CUDA
    device → (best_idx [N] int64, best [N] int32, second [N] int32), equal to
    `masked_best2(hamming_distance_matrix(da, db), mask)`.

    Launches the CUDA kernel on the current stream without synchronizing.
    """
    _check("da", da)
    _check("db", db)
    n, m = da.shape[0], db.shape[0]
    _check_mask(mask, n, m)
    _check_on_card("hamming_masked_best2", da, db)
    if mask.device != da.device:
        raise ValueError(f"mask on {mask.device}, descriptors on {da.device}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    if m == 0:
        return _all_masked(n, da.device)
    best_idx = torch.empty(n, dtype=torch.int64, device=da.device)
    best = torch.empty(n, dtype=torch.int32, device=da.device)
    second = torch.empty(n, dtype=torch.int32, device=da.device)
    if n == 0:
        return best_idx, best, second
    if da.data_ptr() % 16 or db.data_ptr() % 16:
        raise ValueError("inputs must be 16-byte aligned")
    cuda_lib.launch("hamming_masked_best2", "hamming_masked_best2_launch", da.device,
            da.data_ptr(), db.data_ptr(), mask.data_ptr(),
            best_idx.data_ptr(), best.data_ptr(), second.data_ptr(), n, m)
    return best_idx, best, second


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Sum of set bits over the last dim of int32 words: [...,W] → [...] int32.

    Plain tensor arithmetic (the parallel bit-count): torch has no popcount
    operator. The words are int32, so `>>` is an arithmetic shift; every
    shifted value is masked with a constant whose top bits are zero, which
    makes it the logical shift the bit-count needs."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) >> 24) & 0xFF
    return x.sum(-1, dtype=torch.int32)


def hamming_distance_matrix_ref(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `hamming_distance_matrix` (any device)."""
    _check("da", da)
    _check("db", db)
    da = da.view(torch.int32) if da.dtype != torch.int32 else da
    db = db.view(torch.int32) if db.dtype != torch.int32 else db
    n, m = da.shape[0], db.shape[0]
    out = torch.empty((n, m), dtype=torch.int32, device=da.device)
    for r0 in range(0, n, _ROW_CHUNK):
        x = da[r0:r0 + _ROW_CHUNK, None, :] ^ db[None, :, :]
        out[r0:r0 + _ROW_CHUNK] = popcount_words(x)
    return out


def _all_masked(n, device, dtype=torch.int32):
    full = torch.full((n,), MAX_DIST, dtype=dtype, device=device)
    return torch.zeros(n, dtype=torch.int64, device=device), full, full.clone()


def masked_best2(dist: torch.Tensor, mask: torch.Tensor):
    """Best and second-best per row under mask (plain PyTorch, any device).

    dist: [N,M] int32; mask: [N,M] bool.
    Returns (best_idx [N] int64, best [N], second [N]); masked-out rows get
    best = MAX_DIST and best_idx = 0. Ties go to the lowest column: the
    argmin is taken over the composite key d·M + column, which is unique per
    row, so CPU and CUDA agree.
    """
    n, m = dist.shape
    if m == 0:
        return _all_masked(n, dist.device, dist.dtype)
    d = torch.where(mask, dist, MAX_DIST)
    cols = torch.arange(m, device=dist.device, dtype=torch.int64)
    key = (d.to(torch.int64) * m + cols).min(dim=1).values
    best_idx = key % m
    best = (key // m).to(dist.dtype)
    d2 = d.scatter(1, best_idx[:, None], MAX_DIST)
    second = d2.min(dim=1).values
    return best_idx, best, second


def hamming_masked_best2_ref(da: torch.Tensor, db: torch.Tensor, mask: torch.Tensor):
    """Plain PyTorch version of `hamming_masked_best2` (any device)."""
    dist = hamming_distance_matrix_ref(da, db)
    _check_mask(mask, *dist.shape)
    return masked_best2(dist, mask)

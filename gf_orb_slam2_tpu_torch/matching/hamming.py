"""Hamming distance over 256-bit binary descriptors (int32[...,8] words).

Replaces ORBmatcher::DescriptorDistance (reference: src/ORBmatcher.cc:1768)
with whole-matrix distances: one [N,M] matrix per call. On CUDA tensors the
matrix comes from the hand-written kernel (ops/hamming_cuda.py), always; on
CPU tensors from its plain version.
"""
from __future__ import annotations

import torch

from gf_orb_slam2_tpu_torch.ops import hamming_cuda

MAX_DIST = 256


def distance_matrix(da, db):
    """da: [N,8], db: [M,8] int32 words → [N,M] int32 Hamming distances."""
    if da.is_cuda:
        return hamming_cuda.hamming_distance_matrix(da, db)
    return hamming_cuda.hamming_distance_matrix_ref(da, db)


def distance_pairs(da, db):
    """Row-wise distances for aligned pairs: [N,8] × [N,8] → [N]."""
    return hamming_cuda.popcount_words(da ^ db)


def masked_best2(dist, mask):
    """Best and second-best per row under mask.

    dist: [N,M] int32; mask: [N,M] bool.
    Returns (best_idx [N] int64, best [N], second [N]); masked-out rows get
    best = MAX_DIST and best_idx = 0. Ties go to the lowest column: the
    argmin is taken over the composite key d·M + column, which is unique per
    row, so CPU and CUDA agree.
    """
    n, m = dist.shape
    d = torch.where(mask, dist, MAX_DIST)
    if m == 0:
        z = torch.zeros(n, dtype=torch.int64, device=dist.device)
        full = torch.full((n,), MAX_DIST, dtype=dist.dtype, device=dist.device)
        return z, full, full.clone()
    cols = torch.arange(m, device=dist.device, dtype=torch.int64)
    key = (d.to(torch.int64) * m + cols).min(dim=1).values
    best_idx = key % m
    best = (key // m).to(dist.dtype)
    d2 = d.scatter(1, best_idx[:, None], MAX_DIST)
    second = d2.min(dim=1).values
    return best_idx, best, second


def resolve_duplicates(best_idx, best, accept, n_cols: int):
    """Enforce one-to-one: if several rows claim the same column, keep the row
    with the smallest distance (reference keeps best per keypoint slot,
    ORBmatcher.cc:155 region bestDist bookkeeping); equal distances go to the
    first row. Returns the updated accept mask.
    """
    big = MAX_DIST + 1
    best_idx = best_idx.to(torch.int64)
    col_min = torch.full((n_cols,), big, dtype=best.dtype, device=best.device)
    col_min = col_min.scatter_reduce(
        0, best_idx, torch.where(accept, best, big), "amin", include_self=True)
    keep = accept & (best <= col_min[best_idx])
    n_rows = best.shape[0]
    order = torch.arange(n_rows, device=best.device)
    col_first = torch.full((n_cols,), n_rows, dtype=order.dtype, device=best.device)
    col_first = col_first.scatter_reduce(
        0, best_idx, torch.where(keep, order, n_rows), "amin", include_self=True)
    return keep & (order == col_first[best_idx])

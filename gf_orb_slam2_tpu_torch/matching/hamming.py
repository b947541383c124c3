"""Hamming distance over 256-bit binary descriptors (int32[...,8] words).

Replaces ORBmatcher::DescriptorDistance (reference: src/ORBmatcher.cc:1768)
with whole-matrix distances. Callers that only want the best two matches per
row use `distance_best2`, which never forms the [N,M] matrix on the card;
`distance_matrix` + `masked_best2` serve the caller that also reduces down
the columns. On CUDA tensors both come from the hand-written kernels
(ops/hamming_cuda.py), always; on CPU tensors from their plain versions.
"""
from __future__ import annotations

import torch

from gf_orb_slam2_tpu_torch.ops import hamming_cuda

MAX_DIST = hamming_cuda.MAX_DIST
masked_best2 = hamming_cuda.masked_best2


def distance_matrix(da, db):
    """da: [N,8], db: [M,8] int32 words → [N,M] int32 Hamming distances."""
    if da.is_cuda:
        return hamming_cuda.hamming_distance_matrix(da, db)
    return hamming_cuda.hamming_distance_matrix_ref(da, db)


def distance_best2(da, db, mask):
    """`masked_best2(distance_matrix(da, db), mask)` in one step: da [N,8],
    db [M,8] int32 words, mask [N,M] bool → (best_idx [N] int64, best [N],
    second [N])."""
    if da.is_cuda:
        return hamming_cuda.hamming_masked_best2(da, db, mask)
    return hamming_cuda.hamming_masked_best2_ref(da, db, mask)


def distance_pairs(da, db):
    """Row-wise distances for aligned pairs: [N,8] × [N,8] → [N]."""
    return hamming_cuda.popcount_words(da ^ db)


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

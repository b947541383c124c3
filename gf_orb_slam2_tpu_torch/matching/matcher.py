"""Descriptor matching: projection search, frame↔frame, rotation consistency.

Replacement for ORBmatcher (reference: src/ORBmatcher.cc). The reference
prunes candidates through a 64x48 per-frame grid (Frame::GetFeaturesInArea,
src/Frame.cc:593) then loops per point; here the FULL masked [P,N] Hamming
search is evaluated in one shot.

Covered reference entry points:
- SearchByProjection (map→frame, ORBmatcher.cc:155) → `search_by_projection`
- SearchByProjection (last-frame→frame, :1440)      → same fn, caller preps
- SearchForInitialization (:520)                    → `match_window`
- SearchByBoW (:270/:635)                           → `match_all`
- rotation-histogram filter ComputeThreeMaxima (:1723) → `rotation_consistency`
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam2_tpu_torch.matching import hamming
from gf_orb_slam2_tpu_torch.ops.select import topk_stable

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30


class Matches(NamedTuple):
    """Row i (query) matched to col idx[i] (train); -1 if unmatched."""

    idx: torch.Tensor   # [P] int64
    dist: torch.Tensor  # [P] int32
    valid: torch.Tensor  # [P] bool


def _ratio_ok(best, second, nn_ratio):
    return best.to(torch.float32) <= nn_ratio * second.to(torch.float32)


def _matches(best_idx, best, accept):
    return Matches(torch.where(accept, best_idx, -1), best, accept)


def search_by_projection(
    pred_uv, pred_octave, pred_valid, point_desc,
    kp_uv, kp_octave, kp_valid, kp_desc,
    radius, level_scales, th=TH_HIGH, nn_ratio=None, octave_window=1,
):
    """Match map points (projected into the frame) against frame keypoints.

    pred_uv: [P,2] predicted pixel positions; pred_octave: [P] predicted
    pyramid level (reference MapPoint::PredictScale src/MapPoint.cc:542);
    radius: [P] or scalar base search radius in level-0 px (reference
    r=2.5/4.0 × level scale, ORBmatcher.cc:155); level_scales: [L].
    Returns Matches over P rows into keypoint columns (one-to-one).
    """
    N = kp_uv.shape[0]
    pred_octave = pred_octave.to(torch.int64)
    kp_octave = kp_octave.to(torch.int64)
    r = radius * level_scales[torch.clamp(pred_octave, 0, level_scales.shape[0] - 1)]
    d2 = torch.sum((pred_uv[:, None, :] - kp_uv[None, :, :]) ** 2, -1)  # [P,N]
    in_window = d2 <= (r[:, None] ** 2)
    oct_ok = torch.abs(kp_octave[None, :] - pred_octave[:, None]) <= octave_window
    mask = in_window & oct_ok & pred_valid[:, None] & kp_valid[None, :]
    best_idx, best, second = hamming.distance_best2(point_desc, kp_desc, mask)
    accept = best <= th
    if nn_ratio is not None:
        accept = accept & _ratio_ok(best, second, nn_ratio)
    accept = hamming.resolve_duplicates(best_idx, best, accept, N)
    return _matches(best_idx, best, accept)


def match_all(
    desc_a, valid_a, desc_b, valid_b,
    th=TH_LOW, nn_ratio=0.9, mutual=True,
):
    """Brute-force best match a→b with ratio test (and optional mutual check).
    Replaces SearchByBoW's vocabulary-node-pruned loops (ORBmatcher.cc:270)."""
    mask = valid_a[:, None] & valid_b[None, :]
    dist = hamming.distance_matrix(desc_a, desc_b)
    best_idx, best, second = hamming.masked_best2(dist, mask)
    accept = (best <= th) & _ratio_ok(best, second, nn_ratio)
    if mutual:
        bi_b, _, _ = hamming.masked_best2(dist.T, mask.T)
        accept = accept & (bi_b[best_idx] == torch.arange(desc_a.shape[0], device=dist.device))
    accept = accept & hamming.resolve_duplicates(best_idx, best, accept, desc_b.shape[0])
    return _matches(best_idx, best, accept)


def match_window(
    uv_a, desc_a, valid_a, uv_b, desc_b, valid_b,
    window=100.0, th=TH_LOW, nn_ratio=0.9,
):
    """Window-constrained matching for monocular initialization
    (reference: SearchForInitialization ORBmatcher.cc:520, window=100px)."""
    d2 = torch.sum((uv_a[:, None, :] - uv_b[None, :, :]) ** 2, -1)
    mask = (d2 <= window * window) & valid_a[:, None] & valid_b[None, :]
    best_idx, best, second = hamming.distance_best2(desc_a, desc_b, mask)
    accept = (best <= th) & _ratio_ok(best, second, nn_ratio)
    accept = hamming.resolve_duplicates(best_idx, best, accept, desc_b.shape[0])
    return _matches(best_idx, best, accept)


def rotation_consistency(angle_a, angle_b, matches: Matches, n_keep_bins=3):
    """Keep only matches whose angle difference falls in the 3 dominant
    histogram bins (reference: ComputeThreeMaxima ORBmatcher.cc:1723 +
    mbCheckOrientation loops; 30 bins over 360°).

    angle_a: [P] query angles (radians); angle_b: [N] train angles.
    """
    idx = torch.clamp(matches.idx, 0, angle_b.shape[0] - 1)
    rot = angle_a - angle_b[idx]
    deg = torch.remainder(torch.rad2deg(rot), 360.0)
    bins = torch.clamp((deg / (360.0 / HISTO_LENGTH)).to(torch.int64), 0, HISTO_LENGTH - 1)
    counts = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=bins.device)
    counts = counts.index_add(0, bins, matches.valid.to(torch.int32))
    top_vals, top_bins = topk_stable(counts, n_keep_bins)
    # reference drops bins 2/3 when much smaller than bin 1 (<0.1×max)
    floor = torch.clamp((0.1 * top_vals[0]).to(torch.int32), min=1)
    keep_bin = top_vals >= floor
    in_top = torch.any((bins[:, None] == top_bins[None, :]) & keep_bin[None, :], -1)
    valid = matches.valid & in_top
    return Matches(torch.where(valid, matches.idx, -1), matches.dist, valid)

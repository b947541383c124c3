"""Rectified stereo matching: row-band descriptor match + SAD subpixel refine.

Replacement for Frame::ComputeStereoMatches (reference: src/Frame.cc:889).
The whole frame's [N_l, N_r] masked Hamming matrix plus a batched SAD
refinement runs at once for all features.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam2_tpu_torch.matching import hamming

SAD_HALF = 5     # 11x11 SAD window (reference w=5)
SAD_RANGE = 5    # ±5 px sliding search (reference L=5)


class StereoMatches(NamedTuple):
    u_right: torch.Tensor    # [N] float32; <0 if unmatched (reference mvuRight)
    depth: torch.Tensor      # [N] float32; <0 if unmatched (reference mvDepth)
    valid: torch.Tensor      # [N] bool


def argmin_first(x):
    """argmin along the last dim, first occurrence among equals (written out
    because CUDA's argmin does not promise it)."""
    n = x.shape[-1]
    cols = torch.arange(n, device=x.device)
    is_min = x <= x.min(-1, keepdim=True).values
    return torch.where(is_min, cols, n).min(-1).values


def match_stereo(
    kp_l_uv, kp_l_oct, kp_l_desc, kp_l_valid,
    kp_r_uv, kp_r_oct, kp_r_desc, kp_r_valid,
    img_l, img_r, level_scales, bf,
    min_z=0.1, th_desc=(hamming.MAX_DIST + 2 * 75) // 3,
):
    """Full-frame stereo matching on rectified pairs.

    img_l/img_r: [H,W] float32 level-0 images for SAD.
    Returns StereoMatches aligned with left keypoints.
    """
    n_l = kp_l_uv.shape[0]
    max_d = bf / min_z
    kp_l_oct = kp_l_oct.to(torch.int64)
    kp_r_oct = kp_r_oct.to(torch.int64)
    scale_l = level_scales[torch.clamp(kp_l_oct, 0, level_scales.shape[0] - 1)]

    dv = torch.abs(kp_l_uv[:, None, 1] - kp_r_uv[None, :, 1])
    row_ok = dv <= 2.0 * scale_l[:, None]
    disp = kp_l_uv[:, None, 0] - kp_r_uv[None, :, 0]
    disp_ok = (disp >= -1.0) & (disp <= max_d)
    oct_ok = torch.abs(kp_l_oct[:, None] - kp_r_oct[None, :]) <= 1
    mask = row_ok & disp_ok & oct_ok & kp_l_valid[:, None] & kp_r_valid[None, :]

    best_idx, best, _ = hamming.distance_best2(kp_l_desc, kp_r_desc, mask)
    accept = best < th_desc

    # ---- SAD subpixel refinement around the matched right keypoint column
    u_r0 = kp_r_uv[best_idx, 0]
    v_r0 = kp_r_uv[best_idx, 1]
    sads = _sad_curve(img_l, img_r, kp_l_uv, torch.stack([u_r0, v_r0], -1))
    k = argmin_first(sads)  # [N], in [0, 2*SAD_RANGE]
    smin = sads.min(-1).values
    # parabola fit over (k-1, k, k+1)
    km = torch.clamp(k - 1, 0, 2 * SAD_RANGE)
    kp_ = torch.clamp(k + 1, 0, 2 * SAD_RANGE)
    s_m = torch.gather(sads, 1, km[:, None])[:, 0]
    s_p = torch.gather(sads, 1, kp_[:, None])[:, 0]
    denom = s_m + s_p - 2.0 * smin
    delta = torch.where(denom > 1e-6, (s_m - s_p) / (2.0 * torch.clamp(denom, min=1e-6)), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    interior = (k > 0) & (k < 2 * SAD_RANGE)
    delta = torch.where(interior, delta, 0.0)
    u_r = u_r0 + (k.to(torch.float32) - SAD_RANGE) + delta

    disparity = kp_l_uv[:, 0] - u_r
    accept = accept & (disparity > 0.01) & (disparity <= max_d)
    # MAD-style outlier rejection on SAD values (reference: median*1.5*1.4826,
    # Frame.cc:1030 region)
    sad_sorted = torch.sort(torch.where(accept, smin, float("inf"))).values
    n_ok = accept.sum()
    # a one-element index tensor, not a 0-dim one: indexing with a 0-dim
    # tensor reads its value on the host, which waits for the device
    med = sad_sorted.index_select(0, torch.clamp(n_ok // 2, 0, n_l - 1).reshape(1))[0]
    accept = accept & (smin <= 1.5 * 1.4826 * torch.clamp(med, min=1e-3) + 1e-3)

    accept = hamming.resolve_duplicates(best_idx, best, accept, kp_r_uv.shape[0])
    depth = torch.where(accept, bf / torch.clamp(disparity, min=1e-6), -1.0)
    return StereoMatches(
        u_right=torch.where(accept, u_r, -1.0),
        depth=depth,
        valid=accept,
    )


def _sad_curve(img_l, img_r, uv_l, uv_r):
    """SAD of 11x11 patches at uv_l (left) vs sliding window ±SAD_RANGE around
    uv_r (right). Returns [N, 2*SAD_RANGE+1]."""
    h, w = img_l.shape
    W = SAD_HALF
    dev = img_l.device

    def patch(img, yc, xc, half_w):
        ys = torch.clamp(yc[:, None] + torch.arange(-W, W + 1, device=dev), 0, h - 1)
        xs = torch.clamp(xc[:, None] + torch.arange(-half_w, half_w + 1, device=dev), 0, w - 1)
        return img[ys[:, :, None], xs[:, None, :]]  # [N, 11, 2*half_w+1]

    yl = torch.round(uv_l[:, 1]).to(torch.int64)
    xl = torch.round(uv_l[:, 0]).to(torch.int64)
    yr = torch.round(uv_r[:, 1]).to(torch.int64)
    xr = torch.round(uv_r[:, 0]).to(torch.int64)
    pl = patch(img_l, yl, xl, W)  # [N,11,11]
    strip = patch(img_r, yr, xr, W + SAD_RANGE)  # [N,11,11+2*R]
    # mean-normalize like the reference's IL - center offset trick
    pl = pl - pl[:, W : W + 1, W : W + 1]
    win = strip.unfold(2, 2 * W + 1, 1)  # [N,11,2R+1,11] sliding windows
    win = win - win[:, W : W + 1, :, W : W + 1]
    return torch.abs(pl[:, :, None, :] - win).sum((1, 3))

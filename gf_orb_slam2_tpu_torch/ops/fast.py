"""FAST-9/16 corner detection as dense elementwise tensor ops.

Replacement for the reference's FAST backends (src/ORBextractor.cc:767
ComputeKeyPointsOctTree, the CUDA tiled kernel `tileCalcKeypoints_kernel`
src/cuda/Fast_gpu.cu:284). The segment test is evaluated for EVERY pixel of
EVERY (padded) pyramid level at once.

The per-pixel score is the OpenCV-compatible "max threshold for which the
pixel stays a corner" (V-score), so NMS ordering matches the reference's
cornerScore semantics. The circular min-over-9-consecutive test runs on the
16 ring differences stacked along a leading axis: windows of 2, 4, 8 and
then 9 ring positions are built by pairwise min/max of shifted views (min
and max are exact, so the result equals the 16×9 unrolled form bit for bit)
— a dozen large kernels instead of a few hundred small ones.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 — the standard FAST-16 ring, clockwise from
# 12 o'clock. (dy, dx) offsets.
CIRCLE16 = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

_PAD = 3


def _shifted(padded, dy, dx, h, w):
    """Static slice of the (+3)-padded image ≡ neighbor at offset (dy, dx)."""
    return padded[..., _PAD + dy : _PAD + dy + h, _PAD + dx : _PAD + dx + w]


def _window9(d24, op):
    """d24: ring diffs at positions 0..23 (16 + the first 8 again) on dim 0.
    Returns op over the 9 consecutive positions s..s+8 for s = 0..15."""
    m2 = op(d24[0:23], d24[1:24])
    m4 = op(m2[0:21], m2[2:23])
    m8 = op(m4[0:17], m4[4:21])
    return op(m8[0:16], d24[8:24])


def fast_score(img):
    """Per-pixel FAST-9/16 corner V-score.

    img: [..., H, W] float32; leading dims batched (whole pyramid at once).
    Returns score [..., H, W]: the largest threshold t for which the pixel
    passes the segment test; <= 0 means not a corner.
    """
    h, w = img.shape[-2:]
    padded = F.pad(img, (_PAD, _PAD, _PAD, _PAD))
    ring = [CIRCLE16[s % 16] for s in range(24)]
    d24 = torch.stack([_shifted(padded, dy, dx, h, w) for dy, dx in ring]) - img
    # brighter arc: max over starts of (min over 9 consecutive diffs);
    # darker arc: the same on negated diffs = -(min over starts of max over 9)
    v_bright = _window9(d24, torch.minimum).max(0).values
    v_dark = -_window9(d24, torch.maximum).min(0).values
    return torch.maximum(v_bright, v_dark)


def nms3(score):
    """3x3 non-maximum suppression via padded static slices; ties broken
    toward the raster-order-first pixel so plateaus yield one winner."""
    h, w = score.shape[-2:]
    padded = F.pad(score, (_PAD, _PAD, _PAD, _PAD), value=float("-inf"))
    nmax = None
    pmax = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = _shifted(padded, dy, dx, h, w)
            nmax = nb if nmax is None else torch.maximum(nmax, nb)
            if (dy, dx) in ((-1, -1), (-1, 0), (-1, 1), (0, -1)):
                pmax = nb if pmax is None else torch.maximum(pmax, nb)
    return (score >= nmax) & (score > pmax)


def detect(img, threshold, border, hw_valid=None):
    """Scores + NMS + border/threshold mask.

    img: [..., H, W]; hw_valid: optional ([...], [...]) per-level valid
    heights/widths for padded pyramid stacks (broadcast against the leading
    dims of img). Returns (score, keep).
    """
    s = fast_score(img)
    h, w = img.shape[-2:]
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    if hw_valid is None:
        hl, wl = h, w
    else:
        hl, wl = hw_valid
        hl = hl[..., None, None]
        wl = wl[..., None, None]
    in_border = (
        (ys >= border) & (ys < hl - border) & (xs >= border) & (xs < wl - border)
    )
    keep = nms3(s) & (s > threshold) & in_border
    return s, keep

"""ORB orientation (intensity centroid) and rBRIEF descriptors, batched.

Replacement for the reference's IC_Angle / computeOrbDescriptor
(src/ORBextractor.cc:76/:107) and their CUDA twins `IC_Angle_kernel`
(src/cuda/Fast_gpu.cu:403) and `calcOrb_kernel` (src/cuda/Orb_gpu.cu:67).

One [n,37,37] raw patch per selected keypoint feeds both stages:
- IC angle: circular-mask first moments of the central 31x31;
- rBRIEF: the 256-pair pattern is OUR OWN (seeded Gaussian pairs, not the
  OpenCV learned table) and the orientation is quantized into 32 bins with a
  per-bin table of rotated sample coordinates (the ORB paper's own lookup
  design). The patch is rounded to bf16, blurred with the bf16-rounded 7x7
  Gaussian taps in f32, and read at the 512 sample points of the keypoint's
  bin. That is the arithmetic of the JAX package's lookup-matrix matmul
  (`_sample_matrix`, bf16 operands, f32 accumulation) for the one bin that
  is used, so the descriptors agree bit for bit up to f32 summation order.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

PATCH = 31
HALF = PATCH // 2  # 15
PATCH_R = 18  # 37x37 raw patch: 15 (moments) + blur margin 3
N_ANGLE_BINS = 32  # rotation quantization for the descriptor lookup table


@functools.lru_cache()
def _ic_kernels():
    """31x31 circular-mask moment kernels (x*mask, y*mask) as numpy."""
    ys, xs = np.mgrid[-HALF : HALF + 1, -HALF : HALF + 1]
    # per-row circular extent, as in the reference's u_max table
    # (src/ORBextractor.cc ctor): points within radius HALF
    mask = (xs * xs + ys * ys) <= HALF * HALF
    kx = (xs * mask).astype(np.float32)
    ky = (ys * mask).astype(np.float32)
    return kx, ky


@functools.lru_cache()
def brief_pattern(n_pairs=256, seed=7, sigma=None):
    """Our rBRIEF sampling pattern: n_pairs of (p, q) offsets in the patch.

    Gaussian-distributed around the center (BRIEF's G(0, S^2/25) recipe),
    clamped to the disc so rotations up to 45° stay inside a 31x31 patch.
    Fixed seed → identical descriptors across runs/devices.
    """
    if sigma is None:
        sigma = PATCH / 5.0
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, sigma, size=(n_pairs, 2, 2))
    lim = HALF - 2  # leave room for rotation + nearest rounding
    r = np.sqrt((pts**2).sum(-1, keepdims=True))
    scale = np.minimum(1.0, lim / np.maximum(r, 1e-9))
    pts = pts * scale
    return pts.astype(np.float32)  # [256, 2(p/q), 2(dy,dx)]


@functools.lru_cache()
def _gauss_kernel(ksize=7, sigma=2.0):
    ax = np.arange(ksize) - ksize // 2
    g = np.exp(-(ax**2) / (2 * sigma**2))
    g = (g / g.sum()).astype(np.float32)
    return g


@functools.lru_cache()
def _sample_coords(n_bins=N_ANGLE_BINS):
    """Rotated-pattern sample coordinates (py, px) [n_bins,512] int64 in the
    31x31 blurred patch, nearest rounding, one row per quantized rotation."""
    pat = brief_pattern()  # [256,2,2]
    th = 2 * np.pi * np.arange(n_bins) / n_bins
    c, s = np.cos(th)[:, None], np.sin(th)[:, None]
    dy = pat[:, :, 0].reshape(-1)[None]  # [1,512]
    dx = pat[:, :, 1].reshape(-1)[None]
    py = np.clip(np.round(15.0 + dx * s + dy * c), 0, 30).astype(np.int64)
    px = np.clip(np.round(15.0 + dx * c - dy * s), 0, 30).astype(np.int64)
    return py, px


@functools.lru_cache()
def _sample_matrix(n_bins=N_ANGLE_BINS):
    """Descriptor sampling matrix S [37*37, n_bins*512] (numpy f32): the
    7x7 Gaussian blur AND the rotated-pattern sampling folded into one
    linear map from the raw 37x37 patch (blurred (a,b) ≡ raw (a+3, b+3)).
    The port samples through `_sample_coords` instead; this dense form is
    kept as the definition the coordinates are held against."""
    g = _gauss_kernel()
    G = np.outer(g, g)  # [7,7] separable blur taps
    py, px = _sample_coords(n_bins)
    S = np.zeros((37 * 37, n_bins * 512), np.float32)
    col = (np.arange(n_bins)[:, None] * 512 + np.arange(512)[None]).reshape(-1)
    for u in range(7):
        for v in range(7):
            row = ((py + u) * 37 + (px + v)).reshape(-1)
            np.add.at(S, (row, col), G[u, v])
    return S


# ------------------------------------------------- standalone dense operators
# The image-wide forms of the two stages (dense moment maps, a blurred level
# image, rBRIEF read from it at continuous angles): the reference's own
# formulation, kept for users and tools; the extractor runs the fused patch
# path below. Tables are made on the input's device.
def moment_maps(img):
    """Dense m10/m01 maps via two 31x31 convolutions (zero padding).

    img: [..., H, W] f32 — leading dims (pyramid levels) are the conv batch.
    The sums run in float64 and are rounded to f32 once: a moment of 0-255
    pixels reaches 3e5, and torch's f32 CPU convolution loses up to 0.6 of
    it (0.12 for XLA's), which turns a weak corner's angle by 1e-3 rad."""
    kx, ky = _ic_kernels()
    k = torch.from_numpy(np.stack([kx, ky], 0)[:, None]).to(img.device, torch.float64)
    batch = img.shape[:-2]
    h, w = img.shape[-2:]
    out = F.conv2d(img.reshape(-1, 1, h, w).to(torch.float64), k, padding=HALF)
    out = out.to(torch.float32).reshape(batch + (2, h, w))
    return out[..., 0, :, :], out[..., 1, :, :]  # m10, m01


def ic_angles(img, yx):
    """Orientation (radians) for keypoints yx [N,2] (row, col) on one level."""
    m10, m01 = moment_maps(img)
    y = yx[..., 0].to(torch.int64)
    x = yx[..., 1].to(torch.int64)
    return torch.atan2(m01[y, x], m10[y, x])


def ic_angles_batched(imgs, yx):
    """Batched orientation: imgs [L,H,W], yx [L,N,2] → [L,N]."""
    m10, m01 = moment_maps(imgs)  # [L,H,W] each
    li = torch.arange(imgs.shape[0], device=imgs.device)[:, None]
    y = yx[..., 0].to(torch.int64)
    x = yx[..., 1].to(torch.int64)
    return torch.atan2(m01[li, y, x], m10[li, y, x])


def gaussian_blur(img, ksize=7, sigma=2.0):
    """Separable Gaussian blur, zero padding (reference blurs each level
    before rBRIEF, src/ORBextractor.cc:1148 GaussianBlur(…,7,7,2,2)).
    Batched over leading dims."""
    g = torch.from_numpy(_gauss_kernel(ksize, sigma)).to(img.device)
    batch = img.shape[:-2]
    h, w = img.shape[-2:]
    x = img.reshape(-1, 1, h, w)
    x = F.conv2d(x, g.reshape(1, 1, 1, ksize), padding=(0, ksize // 2))
    x = F.conv2d(x, g.reshape(1, 1, ksize, 1), padding=(ksize // 2, 0))
    return x.reshape(batch + (h, w))


def _brief_sample_coords(yx, angles, h, w):
    """The rotated pattern's nearest sample pixels (py, px) [...,256,2]
    around keypoints yx [...,2] at `angles` [...], clamped to the image."""
    pat = torch.from_numpy(brief_pattern()).to(yx.device)  # [256,2,2] (dy,dx)
    c, s = torch.cos(angles)[..., None, None], torch.sin(angles)[..., None, None]
    dy, dx = pat[..., 0], pat[..., 1]
    # rotate offsets: dy' = dx*s + dy*c ; dx' = dx*c - dy*s (image coords)
    ry = dx * s + dy * c
    rx = dx * c - dy * s
    py = torch.round(yx[..., None, None, 0] + ry).to(torch.int64)
    px = torch.round(yx[..., None, None, 1] + rx).to(torch.int64)
    return torch.clamp(py, 0, h - 1), torch.clamp(px, 0, w - 1)


def brief_descriptors(img_blur, yx, angles):
    """256-bit rBRIEF → int32 words [N, 8] (the uint32 bit patterns).

    img_blur: [H,W] f32 Gaussian-blurred level image.
    yx: [N,2] float (row, col) keypoint positions in level coords.
    angles: [N] radians.
    """
    py, px = _brief_sample_coords(yx, angles, *img_blur.shape)
    vals = img_blur[py, px]  # [N,256,2]
    return pack_bits(vals[..., 0] < vals[..., 1])


def brief_descriptors_batched(imgs_blur, yx, angles):
    """Batched rBRIEF: imgs_blur [L,H,W], yx [L,N,2], angles [L,N] →
    int32 words [L,N,8] (one gather for the whole pyramid)."""
    py, px = _brief_sample_coords(yx, angles, *imgs_blur.shape[-2:])
    li = torch.arange(imgs_blur.shape[0], device=imgs_blur.device)[:, None, None, None]
    vals = imgs_blur[li, py, px]  # [L,N,256,2]
    return pack_bits(vals[..., 0] < vals[..., 1])


class OrbTables:
    """Constant device buffers of the descriptor stage."""

    def __init__(self, device):
        kx, ky = _ic_kernels()
        self.kx = torch.from_numpy(kx).to(device)
        self.ky = torch.from_numpy(ky).to(device)
        g = _gauss_kernel()
        G = torch.from_numpy(np.outer(g, g).astype(np.float32))
        # taps rounded to bf16 and held as f32: products with bf16-rounded
        # pixels are then exact in f32, as in a bf16×bf16→f32 contraction
        self.blur = G.to(torch.bfloat16).to(torch.float32).reshape(1, 1, 7, 7).to(device)
        py, px = _sample_coords()
        self.sample_idx = torch.from_numpy(py * PATCH + px).to(device)  # [32,512]
        self.d = torch.arange(-PATCH_R, PATCH_R + 1, device=device)


def patches_at_flat(stack, li, yx, d):
    """Extract [...,n,37,37] raw patches for keypoints with per-item level li.

    stack: [...,L,H,W]; li: [...,n] int64; yx: [...,n,2] (row, col); d: the
    offsets -18..18. Coordinates are clamped to the level array's edge.
    """
    h, w = stack.shape[-2:]
    y = torch.clamp(yx[..., 0:1].to(torch.int64) + d, 0, h - 1)  # [...,n,37]
    x = torch.clamp(yx[..., 1:2].to(torch.int64) + d, 0, w - 1)
    if stack.dim() == 3:
        return stack[li[:, None, None], y[:, :, None], x[:, None, :]]
    b = torch.arange(stack.shape[0], device=stack.device)[:, None, None, None]
    return stack[b, li[..., None, None], y[..., :, None], x[..., None, :]]


def pack_bits(bits):
    """[...,256] bool → [...,8] int32 words (bit k of word w = bits[32w+k])."""
    w = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device)
    words = (bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64) * w).sum(-1)
    # keep the low 32 bits: values ≥ 2^31 wrap to the negative int32 that
    # carries the same bit pattern
    return ((words + 2**31) % 2**32 - 2**31).to(torch.int32)


def angles_and_descriptors_flat(stack, li, yx, tables: OrbTables):
    """Fused IC-angle + rBRIEF for a FLAT selected keypoint set.

    stack: [...,L,H,W] pyramid; li: [...,n] level index; yx: [...,n,2]
    (row, col) in level coords. Returns (angles [...,n], desc int32 [...,n,8]).
    """
    patch = patches_at_flat(stack, li, yx, tables.d)  # [...,n,37,37]
    center31 = patch[..., 3:34, 3:34]
    m10 = (center31 * tables.kx).sum((-1, -2))
    m01 = (center31 * tables.ky).sum((-1, -2))
    angles = torch.atan2(m01, m10)

    lead = angles.shape
    p = patch.reshape(-1, 1, 37, 37).to(torch.bfloat16).to(torch.float32)
    blurred = F.conv2d(p, tables.blur).reshape(-1, PATCH * PATCH)  # [n,961]
    A = N_ANGLE_BINS
    bins = torch.remainder(
        torch.round(angles.reshape(-1) / (2 * math.pi / A)).to(torch.int64), A)
    vals = torch.gather(blurred, 1, tables.sample_idx[bins])  # [n,512]
    vals = vals.reshape(-1, 256, 2)
    desc = pack_bits(vals[..., 0] < vals[..., 1])
    return angles, desc.reshape(lead + (8,))

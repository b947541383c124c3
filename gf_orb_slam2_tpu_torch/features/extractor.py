"""ORB pyramid feature extraction — the whole front-end as batched tensor ops.

Replacement for ORBextractor (reference: src/ORBextractor.cc:982 CUDA
operator() / :1112 CPU operator(), include/ORBextractor.h).

Pipeline (all static shapes, every pyramid level and every image of the
batch at once):
  resize → FAST score+NMS (ops/fast.py) → per-cell top-K + ranked top-N
  (ops/select.py, replaces DistributeOctTree) → fused IC-angle + rBRIEF on
  the selected keypoints' patches (ops/orb.py) → scale to level-0.

Outputs are fixed-capacity masked SoA tensors (SURVEY.md §7.1).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gf_orb_slam2_tpu_torch.config import ORBConfig
from gf_orb_slam2_tpu_torch.ops import fast, orb, select


class Features(NamedTuple):
    """Per-frame keypoint set (SoA, fixed capacity N, masked by `valid`)."""

    uv: torch.Tensor        # [N,2] float32 — (x, y) in level-0 pixel coords
    response: torch.Tensor  # [N] float32 FAST V-score
    octave: torch.Tensor    # [N] int32 pyramid level
    angle: torch.Tensor     # [N] float32 radians
    desc: torch.Tensor      # [N,8] int32 words — 256-bit rBRIEF
    valid: torch.Tensor     # [N] bool

    @property
    def n(self):
        """Valid keypoints: a 0-dim int32 tensor on the features' device."""
        return self.valid.to(torch.int32).sum(dtype=torch.int32)


def level_sizes(h: int, w: int, n_levels: int, scale: float) -> Tuple[Tuple[int, int], ...]:
    out = []
    for lv in range(n_levels):
        f = scale ** lv
        out.append((max(32, int(round(h / f))), max(32, int(round(w / f)))))
    return tuple(out)


def features_per_level(n: int, n_levels: int, scale: float) -> Tuple[int, ...]:
    """Geometric distribution of the feature budget over levels
    (reference: ORBextractor ctor, src/ORBextractor.cc:~450)."""
    inv = 1.0 / scale
    base = n * (1 - inv) / (1 - inv ** n_levels)
    counts = [int(round(base * inv ** lv)) for lv in range(n_levels - 1)]
    counts.append(max(0, n - sum(counts)))
    return tuple(counts)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32 weights of an antialiased linear resize with
    half-pixel centres: a triangle filter widened by the downscale factor,
    each output's weights normalized to sum 1 (the weights `jax.image.resize`
    uses for "linear")."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    wts = np.maximum(np.float32(0.0), np.float32(1.0) - x).astype(np.float32)
    total = wts.sum(0, keepdims=True, dtype=np.float32)
    wts = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                   wts / np.where(total != 0, total, 1), 0).astype(np.float32)
    in_range = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(in_range[None, :], wts, 0).astype(np.float32)


class ORBExtractor:
    """Extractor for one image size: constant buffers (resize weights, level
    scales, descriptor tables) live on `device`; `__call__` is pure."""

    def __init__(self, cfg: ORBConfig, height: int, width: int, device="cuda"):
        self.cfg = cfg
        self.height = height
        self.width = width
        self.device = torch.device(device)
        self.sizes = level_sizes(height, width, cfg.n_levels, cfg.scale_factor)
        self.counts = features_per_level(cfg.n_features, cfg.n_levels, cfg.scale_factor)
        self.n_total = sum(self.counts)
        self.scales = tuple(cfg.scale_factor ** lv for lv in range(cfg.n_levels))
        dev = self.device
        self._wy = [torch.from_numpy(resize_weights(height, h).T.copy()).to(dev)
                    for h, _ in self.sizes[1:]]  # [h, H]
        self._wx = [torch.from_numpy(resize_weights(width, w)).to(dev)
                    for _, w in self.sizes[1:]]  # [W, w]
        self._hl = torch.tensor([h for h, w in self.sizes], device=dev)
        self._wl = torch.tensor([w for h, w in self.sizes], device=dev)
        self._scales = torch.tensor(self.scales, dtype=torch.float32, device=dev)
        n_cap = max(self.counts)
        self._quota = (torch.tensor(self.counts, device=dev)[:, None]
                       > torch.arange(n_cap, device=dev)[None, :])
        self._tables = orb.OrbTables(dev)

    def __call__(self, img) -> Features:
        """img: [H,W] uint8 or float32 grayscale → Features."""
        f = self.extract_batch(img[None])
        return Features(*(a[0] for a in f))

    @functools.cached_property
    def sigma2(self) -> np.ndarray:
        """Per-octave measurement variance (scale^2l), reference
        ORBextractor mvLevelSigma2."""
        return np.asarray([s * s for s in self.scales], np.float32)

    @functools.cached_property
    def inv_sigma2(self) -> np.ndarray:
        return 1.0 / self.sigma2

    def pyramid(self, imgs):
        """imgs [B,H,W] f32 → zero-padded level stack [B,L,H0,W0]. Every
        level is resized directly from level 0 (no compounding)."""
        H0, W0 = self.sizes[0]
        levels = [imgs]
        for (h, w), wy, wx in zip(self.sizes[1:], self._wy, self._wx):
            lv = wy @ imgs @ wx
            levels.append(F.pad(lv, (0, W0 - w, 0, H0 - h)))
        return torch.stack(levels, 1)

    def extract_batch(self, imgs) -> Features:
        """imgs: [B,H,W] (e.g. the left/right pair) → Features with a leading
        batch dim on every field."""
        cfg = self.cfg
        imgs = imgs.to(self.device, torch.float32)
        B = imgs.shape[0]
        border = cfg.edge_threshold - 3  # reference: EDGE_THRESHOLD-3 = 16
        L = cfg.n_levels
        H0, W0 = self.sizes[0]
        stack = self.pyramid(imgs)

        score, keep = fast.detect(stack, float(cfg.min_th_fast), border,
                                  (self._hl, self._wl))
        if cfg.ini_th_fast > cfg.min_th_fast:
            # two-tier threshold (reference: iniThFAST per 30x30 cell with
            # minThFAST fallback, ORBextractor.cc:767): cells holding a
            # strong corner keep ONLY strong corners; weak ones fill cells
            # with none. The V-score ≥ t test IS the corner-at-t test.
            cs = cfg.cell_size
            strong = keep & (score >= float(cfg.ini_th_fast))
            Hp = -(-H0 // cs) * cs
            Wp = -(-W0 // cs) * cs
            sp = F.pad(strong, (0, Wp - W0, 0, Hp - H0))
            cells = sp.reshape(B, L, Hp // cs, cs, Wp // cs, cs).any(5).any(3)
            cell_any = cells[:, :, :, None, :, None].expand(
                B, L, Hp // cs, cs, Wp // cs, cs
            ).reshape(B, L, Hp, Wp)[:, :, :H0, :W0]
            keep = keep & (strong | ~cell_any)
        vals, ys, xs, rank = select.cell_topk(score, keep, cfg.cell_size, cfg.per_cell_k)
        n_cap = max(self.counts)
        ys_l, xs_l, sc_l, valid_l = select.ranked_topn(vals, ys, xs, rank, n_cap)
        valid_l = valid_l & self._quota  # each [B, L, n_cap]

        scales = self._scales[:, None]
        uv = torch.stack([xs_l.to(torch.float32) * scales,
                          ys_l.to(torch.float32) * scales], -1)
        octv = torch.arange(L, device=self.device)[:, None].expand(B, L, n_cap)
        resp = torch.where(valid_l, sc_l, 0.0)

        # flatten and keep exactly n_total slots (valid first, index order
        # within each group) BEFORE the patch gather — only selected
        # keypoints pay for a descriptor
        validf = valid_l.reshape(B, L * n_cap)
        _, order = torch.sort((~validf).to(torch.int8), dim=1, stable=True)
        sel = order[:, : self.n_total]

        def take(a):
            a = a.reshape((B, L * n_cap) + a.shape[3:])
            idx = sel.reshape(sel.shape + (1,) * (a.dim() - 2)).expand(
                sel.shape + a.shape[2:])
            return torch.gather(a, 1, idx)

        li = take(octv)
        yx_sel = torch.stack([take(ys_l), take(xs_l)], -1).to(torch.float32)
        ang, desc = orb.angles_and_descriptors_flat(stack, li, yx_sel, self._tables)
        return Features(
            uv=take(uv),
            response=take(resp),
            octave=li.to(torch.int32),
            angle=ang,
            desc=desc,
            valid=take(valid_l),
        )

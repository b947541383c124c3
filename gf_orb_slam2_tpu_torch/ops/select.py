"""Spatially-uniform keypoint selection: per-cell top-K + ranked global top-N.

Replacement for the reference's recursive quadtree redistribution
(src/ORBextractor.cc DistributeOctTree, called from ComputeKeyPointsOctTree
:767) and the per-30px-cell FAST with threshold fallback 20→7. The quadtree
is inherently sequential; instead we:

1. split the score map into fixed cells and take the top-K responses per cell
   (one reshape + one sort — fully parallel);
2. rank candidates by (rank-within-cell, -score) so every cell contributes
   its best corner before any cell contributes its second — the same spatial
   uniformity the quadtree buys — and take the global top-N.

FAST V-scores are integer-valued on integer images, so ties are the norm:
every top-k here is a STABLE descending sort, which puts the lowest index
first among equals on every device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def topk_stable(x, k: int):
    """Top-k along the last dim, lowest index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def cell_topk(score, keep_mask, cell: int, k: int):
    """Per-cell top-K.

    score: [...,H,W] f32; keep_mask: [...,H,W] bool (NMS+threshold+border).
    Returns (scores [...,C*k], ys [...,C*k], xs [...,C*k], rank [...,C*k])
    where C is the number of cells; invalid entries have score = -inf.
    """
    lead = score.shape[:-2]
    h, w = score.shape[-2:]
    gh, gw = -(-h // cell), -(-w // cell)
    ph, pw = gh * cell - h, gw * cell - w
    s = torch.where(keep_mask, score, float("-inf"))
    s = F.pad(s, (0, pw, 0, ph), value=float("-inf"))
    # [gh, cell, gw, cell] -> [gh*gw, cell*cell]
    s = s.reshape(lead + (gh, cell, gw, cell)).transpose(-3, -2)
    s = s.reshape(lead + (gh * gw, cell * cell))
    vals, idx = topk_stable(s, k)  # [..., C, k]
    c = torch.arange(gh * gw, device=score.device)
    cy = c // gw
    cx = c % gw
    ys = cy[:, None] * cell + idx // cell
    xs = cx[:, None] * cell + idx % cell
    rank = torch.arange(k, device=score.device).expand(vals.shape)
    flat = lead + (gh * gw * k,)
    return vals.reshape(flat), ys.reshape(flat), xs.reshape(flat), rank.reshape(flat)


def ranked_topn(scores, ys, xs, rank, n: int, max_score: float = 512.0):
    """Global top-N by (cell-rank asc, score desc) along the last dim.

    Returns (ys [...,n], xs [...,n], scores [...,n], valid [...,n]).
    """
    valid = torch.isfinite(scores)
    # priority: higher is better. rank dominates; score breaks ties.
    prio = torch.where(
        valid, -rank.to(torch.float32) * (2.0 * max_score) + scores, float("-inf"))
    top, idx = topk_stable(prio, n)
    return (torch.gather(ys, -1, idx), torch.gather(xs, -1, idx),
            torch.gather(scores, -1, idx), torch.isfinite(top))

"""Vectorized host-side map maintenance (numpy, no Python-per-point loops).

The port's own copy of the JAX package's `mapping/batch_ops.py`: the same
batched numpy over the SoA store that replaces the reference's per-MapPoint
work (MapPoint::ComputeDistinctiveDescriptors src/MapPoint.cc:397,
MapPoint::UpdateNormalAndDepth src/MapPoint.cc:485,
LocalMapping::KeyFrameCulling src/LocalMapping.cc:820). Refreshed points are
marked dirty for the device map mirror.
"""
from __future__ import annotations

import numpy as np

# set bits of every byte value: popcount through a table, so the module does
# not depend on the numpy version having np.bitwise_count
_POPC8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def refresh_points_batch(store, pts: np.ndarray, level_scales: np.ndarray):
    """Batched distinctive-descriptor + normal/depth refresh for point ids
    `pts` (invalid ids ignored)."""
    s = store
    pts = np.asarray(pts)
    pts = pts[pts >= 0]
    pts = np.unique(pts)
    pts = pts[s.point_valid[pts]]
    if pts.size == 0:
        return
    okf = s.obs_kf[pts]            # [P,O_store]
    oidx = s.obs_idx[pts]          # [P,O_store]
    valid = okf >= 0
    # compact valid observations to the front and slice to the realized max
    # count: most store slots are empty, and the pairwise Hamming tensor
    # below is O(P*O^2*8)
    order = np.argsort(~valid, axis=1, kind="stable")
    M = max(int(valid.sum(1).max(initial=1)), 1)
    order = order[:, :M]
    okf = np.take_along_axis(okf, order, 1)
    oidx = np.take_along_axis(oidx, order, 1)
    valid = np.take_along_axis(valid, order, 1)
    O = M
    okf_c = np.maximum(okf, 0)
    oidx_c = np.maximum(oidx, 0)

    # ---- distinctive descriptor: min median Hamming over observations
    descs = s.kf_desc[okf_c, oidx_c]                     # [P,O,8] u32
    x = descs[:, :, None, :] ^ descs[:, None, :, :]       # [P,O,O,8]
    d = _POPC8[x.view(np.uint8)].sum(-1, dtype=np.int32).astype(np.float32)  # [P,O,O]
    pair_ok = valid[:, :, None] & valid[:, None, :]
    # median over the valid columns only: sort with +inf fill, index (n-1)//2
    d = np.where(pair_ok, d, np.inf)
    d.sort(axis=2)
    nv = np.maximum(valid.sum(1), 1)                      # [P]
    med = np.take_along_axis(
        d, ((nv - 1) // 2)[:, None, None].astype(np.int64), axis=2
    )[:, :, 0]                                            # [P,O]
    med[~valid] = np.inf
    best = np.argmin(med, axis=1)                         # [P]
    s.point_desc[pts] = descs[np.arange(pts.size), best]

    # ---- mean viewing normal + scale-invariance distance range
    centers = s.kf_center(okf_c.reshape(-1)).reshape(pts.size, O, 3)
    v = s.point_pos[pts][:, None, :] - centers            # [P,O,3]
    n = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
    n = np.where(valid[:, :, None], n, 0.0)
    cnt = np.maximum(valid.sum(1, keepdims=True), 1)
    s.point_normal[pts] = (n.sum(1) / cnt).astype(np.float32)
    # reference KF = first observation slot
    first = np.argmax(valid, axis=1)
    ar = np.arange(pts.size)
    ref_kf = okf_c[ar, first]
    dist = np.linalg.norm(s.point_pos[pts] - s.kf_center(ref_kf), axis=-1)
    oct_ = s.kf_octave[ref_kf, oidx_c[ar, first]]
    sf = level_scales[np.clip(oct_, 0, len(level_scales) - 1)]
    maxd = (dist * sf).astype(np.float32)
    s.point_max_dist[pts] = maxd
    s.point_min_dist[pts] = maxd / level_scales[-1]
    s.mark_dirty(pts)


def redundant_keyframes(store, candidates, min_better: int = 3,
                        redundancy: float = 0.9):
    """Return the subset of candidate KFs whose valid points are >=90%
    observed by >=min_better OTHER KFs at the same or finer scale
    (reference: KeyFrameCulling LocalMapping.cc:820)."""
    s = store
    out = []
    for k in candidates:
        k = int(k)
        if k == 0 or not s.kf_valid[k]:
            continue
        pts = s.kf_point[k]
        slots = np.nonzero(pts >= 0)[0]
        if slots.size == 0:
            continue
        p = pts[slots]
        live = s.point_valid[p]
        p, slots = p[live], slots[live]
        if p.size == 0:
            continue
        scale_k = s.kf_octave[k, slots]                   # [M]
        okf = s.obs_kf[p]                                  # [M,O]
        oidx = s.obs_idx[p]
        ov = (okf >= 0) & (okf != k)
        oct_obs = s.kf_octave[np.maximum(okf, 0), np.maximum(oidx, 0)]
        better = ov & (oct_obs <= scale_k[:, None] + 1)
        n_red = (better.sum(1) >= min_better).sum()
        if n_red > redundancy * slots.size:
            out.append(k)
    return out

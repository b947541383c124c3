"""Front-end tracking: per-frame pose estimation + keyframe policy.

Replacement for the Tracking class (reference: src/Tracking.cc:594 Track,
include/Tracking.h). The reference's per-frame flow — motion-model matching,
reference-KF fallback, local-map tracking, KF decision — is kept; each stage
is a plain function over fixed-capacity masked tensors that runs wherever
its inputs live, and host code only gathers map snapshots and applies the
results (SURVEY.md §7.1 "host orchestration").

Stage → reference mapping:
- `motion_step`    ← TrackWithMotionModel (Tracking.cc:1495): project last
  frame's points under the constant-velocity prediction, windowed descriptor
  match, motion-only BA.
- `refkf_step`     ← TrackReferenceKeyFrame (Tracking.cc:1331): brute-force
  descriptor match vs the reference KF (replaces SearchByBoW pruning), BA.
- `local_step`     ← TrackLocalMap + SearchLocalPoints (Tracking.cc:1572/2174):
  frustum-check the local-map candidate pool, projection-match the unmatched
  keypoints, re-optimize, final inlier gate.
- `fused_track`    = motion_step + local_step chained without a host visit.
- `stream_step`    = fused_track with the pose prediction and the last
  frame's matches chained on the device from the previous step, and the
  candidate pool gathered by id from the device map mirror (the pipelined
  driver, System.track_stereo_pipelined).
- `reloc_step`     ← Relocalization (Tracking.cc:2615): brute-force
  descriptor match vs one candidate KF, EPnP RANSAC (tracking/pnp.py), LM
  polish; `Tracker._relocalize` tries the KF database's candidates.
- KF policy        ← NeedNewKeyFrame/CreateNewKeyFrame (Tracking.cc:1914/2008).
- Stereo bootstrap ← StereoInitialization (Tracking.cc:1078).
- Mono bootstrap   ← MonocularInitialization + CreateInitialMapMonocular
  (Tracking.cc:1141/1206): window matching, the batched H/F RANSAC of
  tracking/initializer.py, the two-KF map at unit median depth.
- Velocity model   ← mVelocity update (Tracking.cc:796); planner odometry
  (`odom`, reference PredictRelMotionFromBuffer Tracking.cc:1448) replaces it
  for the search-window prediction where it covers both timestamps.
- Local map        ← UpdateLocalKeyFrames/UpdateLocalPoints, or the hashed
  assembly past MAP_SIZE_TRIGGER_HASHING (UpdateLocalPointsByHashing
  Tracking.cc:2895) through the host multi-index hash (hashing/mih.py).
- World anchor     ← INIT_WITH_ARUCHO: a ChArUco board in the first stereo
  frame gives its pose (io/charuco.py, host OpenCV).
"""
from __future__ import annotations

import dataclasses
import enum
import math
import time
import warnings
from typing import Optional

import numpy as np
import torch

from gf_orb_slam2_tpu_torch.config import GFMatchingMode, LocalMapMode, Sensor, SystemConfig
from gf_orb_slam2_tpu_torch.geometry import lie
from gf_orb_slam2_tpu_torch.io import charuco
from gf_orb_slam2_tpu_torch.matching import matcher
from gf_orb_slam2_tpu_torch.optim import pose_opt
from gf_orb_slam2_tpu_torch.selection import good_feature, observability
from gf_orb_slam2_tpu_torch.slammap.store import MapStore
from gf_orb_slam2_tpu_torch.tracking import initializer, pnp, projection
from gf_orb_slam2_tpu_torch.tracking.kinematics import OdometryBuffer
from gf_orb_slam2_tpu_torch.tracking.frame import HOST_FIELDS, Frame
from gf_orb_slam2_tpu_torch.utils.transfer import desc_to_torch, to_device, to_host


class TrackState(enum.Enum):
    """Reference: Tracking.h:189-195 eTrackingState."""

    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclasses.dataclass
class TrackStats:
    """Per-frame tracking log (reference: TrackingLog Util.hpp:187-280)."""

    frame_id: int = 0
    state: str = "OK"
    n_features: int = 0
    n_motion_matches: int = 0
    n_local_points: int = 0
    n_local_matches: int = 0
    n_inliers: int = 0
    created_kf: bool = False
    path: str = ""  # which tracking path served the frame (init/fused/…)


@dataclasses.dataclass
class RelocStats:
    """One relocalization attempt (a LOST frame): where its candidates came
    from ("kfdb" or "recent"), how many were solved (a candidate with < 15
    map points is skipped unsolved), the accepted KF (-1: none), its EPnP and
    LM inliers, and the host ms of the attempt."""

    frame_id: int
    source: str
    n_candidates: int
    n_solved: int = 0
    kf: int = -1
    n_pnp_inliers: int = 0
    n_inliers: int = 0
    ms: float = 0.0


# ====================================================== device-side steps
def _scatter_matches(m_idx, m_valid, src_rows, n_cols):
    """Per-keypoint view of row→col matches: for each col (keypoint), the
    matching row index or -1. Unmatched rows are routed to a dummy slot past
    the end (never wrapped to the last keypoint)."""
    cols = torch.where(m_valid, m_idx, n_cols)
    out = torch.full((n_cols + 1,), -1, dtype=torch.int64, device=m_idx.device)
    out[cols] = torch.where(m_valid, src_rows, -1)
    return out[:n_cols]


def _inv_sigma2(scales, kp_oct):
    return 1.0 / scales[torch.clamp(kp_oct.to(torch.int64), 0, scales.shape[0] - 1)] ** 2


def _rows_of(kp_row, pos):
    """Positions of the rows matched per keypoint (zeros where unmatched)."""
    return torch.where((kp_row >= 0)[:, None], pos[torch.clamp(kp_row, min=0)], 0.0)


def motion_step(
    cfg: SystemConfig, scales, R0, t0, R_init, t_init,
    pt_pos, pt_oct, pt_valid, pt_desc,
    kp_uv, kp_oct, kp_ur, kp_valid, kp_desc, radius,
):
    """(R0,t0): extrapolated prediction — used ONLY to center the search
    windows. (R_init,t_init): last frame's pose — the optimizer start.
    Initializing the solve from the extrapolation compounds the weakly
    observable lateral↔yaw valley error frame over frame; the last pose
    carries it unamplified."""
    cam = cfg.camera
    pc = lie.transform(R0, t0, pt_pos)
    z = torch.where(torch.abs(pc[..., 2]) < 1e-8, 1e-8, pc[..., 2])
    uv = torch.stack([cam.fx * pc[..., 0] / z + cam.cx,
                      cam.fy * pc[..., 1] / z + cam.cy], -1)
    m = matcher.search_by_projection(
        uv, pt_oct, pt_valid & (pc[..., 2] > 0), pt_desc,
        kp_uv, kp_oct, kp_valid, kp_desc,
        radius=radius, level_scales=scales,
    )
    n = kp_uv.shape[0]
    rows = torch.arange(pt_pos.shape[0], device=pt_pos.device)
    kp_row = _scatter_matches(m.idx, m.valid, rows, n)
    kp_mp_valid = kp_row >= 0
    res = pose_opt.pose_optimization(
        R_init, t_init, _rows_of(kp_row, pt_pos), kp_uv,
        torch.where(kp_mp_valid, kp_ur, -1.0),
        _inv_sigma2(scales, kp_oct), kp_mp_valid,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
        rounds=cfg.tracking.pose_opt_rounds,
        iters=cfg.tracking.pose_opt_iters,
    )
    return res, kp_row, kp_mp_valid


def refkf_step(
    cfg: SystemConfig, scales, R0, t0, ref_desc, ref_valid, ref_angle,
    pt_pos, pt_valid,
    kp_uv, kp_oct, kp_ur, kp_valid, kp_desc, kp_angle,
):
    """ref rows (KF keypoints with map points) → current keypoints."""
    cam = cfg.camera
    m = matcher.match_all(ref_desc, ref_valid & pt_valid, kp_desc, kp_valid,
                          th=matcher.TH_LOW, nn_ratio=0.7, mutual=False)
    m = matcher.rotation_consistency(ref_angle, kp_angle, m)
    n = kp_uv.shape[0]
    rows = torch.arange(ref_desc.shape[0], device=ref_desc.device)
    kp_row = _scatter_matches(m.idx, m.valid, rows, n)
    kp_mp_valid = kp_row >= 0
    res = pose_opt.pose_optimization(
        R0, t0, _rows_of(kp_row, pt_pos), kp_uv,
        torch.where(kp_mp_valid, kp_ur, -1.0),
        _inv_sigma2(scales, kp_oct), kp_mp_valid,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
    )
    return res, kp_row, kp_mp_valid


def local_step(
    cfg: SystemConfig, scales, R0, t0,
    loc_pos, loc_normal, loc_mind, loc_maxd, loc_desc, loc_valid,
    loc_life, loc_already,
    kp_uv, kp_oct, kp_ur, kp_valid, kp_desc,
    kp_mp_pos, kp_mp_valid, extra_radius, generator=None,
):
    """Local-map step. Returns (res, kp_row, kp_row_add, new_valid, n_visible)."""
    cam = cfg.camera
    fx, fy, cx, cy, bf = cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
    n_levels = scales.shape[0]
    proj = projection.project_points(
        R0, t0, loc_pos, loc_normal, loc_mind, loc_maxd, loc_valid,
        fx, fy, cx, cy, cam.width, cam.height,
        n_levels=n_levels, log_scale=math.log(cfg.orb.scale_factor),
    )
    pool = proj.visible & ~loc_already
    full_pool = pool
    gf_cfg = cfg.good_feature
    mode = gf_cfg.matching_mode
    budgeted = gf_cfg.enabled and mode != GFMatchingMode.ALL
    if budgeted:
        if mode == GFMatchingMode.GOOD_FEATURE:
            # GOOD FEATURE branch (reference: Tracking.cc:2348-2377 →
            # Observability::runActiveMapMatching): restrict the search
            # to the Max-logDet subset when the pool is large.
            R_wc = R0.T
            q_wc = lie.rot_to_quat(R_wc)
            center = -(R_wc @ t0)
            inv2_pt = 1.0 / scales[torch.clamp(proj.pred_octave, 0, n_levels - 1)] ** 2
            is_stereo_sensor = cfg.sensor != Sensor.MONOCULAR
            dev = loc_pos.device
            stereo_mask = torch.full((loc_pos.shape[0],), is_stereo_sensor, device=dev)
            n = kp_mp_pos.shape[0]
            kp_stereo = torch.full((n,), is_stereo_sensor, device=dev)
            ones = torch.ones(n, dtype=loc_pos.dtype, device=dev)
            if gf_cfg.info_mat_size == 13:
                # hybrid full-state mode (reference: Tracking.cc:271-274
                # USE_HYBRID_INFO_MATRIX → 13x13 over [p,q,v,ω])
                obs_mats = observability.info_matrices_13(
                    q_wc, center, loc_pos, fx, fy, bf, stereo_mask, inv2_pt, pool)
                base = observability.info_matrices_13(
                    q_wc, center, kp_mp_pos, fx, fy, bf, kp_stereo, ones,
                    kp_mp_valid, kine_prior=0.0).sum(0)
            else:
                obs_mats = observability.info_matrices(
                    q_wc, center, loc_pos, fx, fy, bf, stereo_mask, inv2_pt, pool)
                base = observability.pose_info_from_frame(
                    q_wc, center, kp_mp_pos, fx, fy, bf, kp_stereo, ones, kp_mp_valid)
            sel, _ = good_feature.lazier_greedy_select(
                obs_mats, pool, gf_cfg.constr_per_frame, generator,
                lazier_factor=gf_cfg.lazier_factor, base_mat=base)
        elif mode == GFMatchingMode.RANDOM:
            sel, _ = good_feature.random_select(
                pool, gf_cfg.constr_per_frame, generator)
        elif mode == GFMatchingMode.LONG_LIVED:
            sel, _ = good_feature.long_lived_select(
                loc_life, pool, gf_cfg.constr_per_frame)
        else:  # BUCKETING
            sel, _ = good_feature.bucketing_select(
                proj.uv, loc_life, pool, gf_cfg.constr_per_frame,
                float(cam.width), float(cam.height))
        use_sel = pool.sum() >= gf_cfg.min_pool
        pool = torch.where(use_sel, pool & sel, pool)
    radius = torch.where(proj.view_cos > 0.998, 2.5, 4.0) * extra_radius
    m = matcher.search_by_projection(
        proj.uv, proj.pred_octave, pool, loc_desc,
        kp_uv, kp_oct, kp_valid & ~kp_mp_valid, kp_desc,
        radius=radius, level_scales=scales,
        th=matcher.TH_HIGH, nn_ratio=0.8,
    )
    n = kp_uv.shape[0]
    loc_rows = torch.arange(loc_pos.shape[0], device=loc_pos.device)
    kp_row = _scatter_matches(m.idx, m.valid, loc_rows, n)
    new_valid = kp_mp_valid | (kp_row >= 0)
    new_pos = torch.where(
        (kp_row >= 0)[:, None], loc_pos[torch.clamp(kp_row, min=0)], kp_mp_pos)
    inv_sigma2 = _inv_sigma2(scales, kp_oct)
    res = pose_opt.pose_optimization(
        R0, t0, new_pos, kp_uv, torch.where(new_valid, kp_ur, -1.0),
        inv_sigma2, new_valid, fx, fy, cx, cy, bf,
        rounds=cfg.tracking.pose_opt_rounds,
        iters=cfg.tracking.pose_opt_iters,
    )
    kp_row_add = torch.full((n,), -1, dtype=torch.int64, device=kp_uv.device)
    if budgeted and gf_cfg.search_additional:
        # Reference: Tracking::SearchAdditionalMatchesInFrame
        # (src/Tracking.cc:2119) — after the pose solve, match the
        # LEFTOVER (unselected) candidates to still-free keypoints. In
        # the reference this runs AFTER the keyframe decision, so the
        # extra matches only enrich the next frame's motion model — they
        # are returned SEPARATELY here and merged host-side post-KF-policy
        # (merging early inflates n_tracked and starves KF creation).
        leftover = full_pool & ~pool
        # reference searches at HALF the usual window (th=0.5,
        # Tracking.cc:2160): the refined pose is trusted and a tight
        # window keeps aliased associations out of the map
        m2 = matcher.search_by_projection(
            proj.uv, proj.pred_octave, leftover, loc_desc,
            kp_uv, kp_oct, kp_valid & ~new_valid & ~kp_mp_valid, kp_desc,
            radius=radius * 0.5, level_scales=scales,
            th=matcher.TH_HIGH, nn_ratio=0.8,
        )
        kp_row2 = _scatter_matches(m2.idx, m2.valid, loc_rows, n)
        add = (kp_row < 0) & ~kp_mp_valid & (kp_row2 >= 0)
        pos2 = loc_pos[torch.clamp(kp_row2, min=0)]
        pc = lie.transform(res.R, res.t, pos2)
        z = torch.clamp(pc[..., 2], min=1e-8)
        du = fx * pc[..., 0] / z + cx - kp_uv[:, 0]
        dv = fy * pc[..., 1] / z + cy - kp_uv[:, 1]
        chi2 = (du * du + dv * dv) * inv_sigma2
        add = add & (chi2 <= 5.991) & (pc[..., 2] > 1e-4)
        kp_row_add = torch.where(add, kp_row2, -1)
    return res, kp_row, kp_row_add, new_valid, proj.visible.sum()


def fused_track(
    cfg: SystemConfig, scales, R0, t0, R_init, t_init,
    pt_pos, pt_oct, pt_valid, pt_desc,
    loc_pos, loc_normal, loc_mind, loc_maxd, loc_desc, loc_valid, loc_life,
    kp_uv, kp_oct, kp_ur, kp_valid, kp_desc, radius, extra_radius,
    generator=None,
):
    """Motion-model step + local-map step chained without a host visit.

    The local candidate pool is the one gathered after the PREVIOUS frame
    (one frame stale — at tracking frame rates the covisible set barely
    moves), so the whole frame needs one upload and one download.
    Returns (res_m, kp_row_m, res_l, kp_row_l, kp_row_add, n_visible).
    """
    res_m, kp_row_m, kp_mp_valid_m = motion_step(
        cfg, scales, R0, t0, R_init, t_init, pt_pos, pt_oct, pt_valid, pt_desc,
        kp_uv, kp_oct, kp_ur, kp_valid, kp_desc, radius,
    )
    kp_mp_pos = _rows_of(kp_row_m, pt_pos)
    kp_mp_valid = kp_mp_valid_m & res_m.inliers
    loc_already = torch.zeros(loc_pos.shape[0], dtype=torch.bool, device=loc_pos.device)
    res_l, kp_row_l, kp_row_add, _, n_vis = local_step(
        cfg, scales, res_m.R, res_m.t,
        loc_pos, loc_normal, loc_mind, loc_maxd, loc_desc, loc_valid,
        loc_life, loc_already,
        kp_uv, kp_oct, kp_ur, kp_valid, kp_desc,
        kp_mp_pos, kp_mp_valid, extra_radius, generator,
    )
    return res_m, kp_row_m, res_l, kp_row_l, kp_row_add, n_vis


def reloc_step(
    cfg: SystemConfig, scales, ref_desc, ref_valid, pt_pos,
    kp_uv, kp_oct, kp_ur, kp_valid, kp_desc, draws,
):
    """Relocalization against one candidate KF: descriptor match → EPnP
    RANSAC → LM polish (reference: Relocalization Tracking.cc:2615 —
    SearchByBoW + PnPsolver::iterate + PoseOptimization). `draws`: the
    RANSAC's [256,6] draws, or a callable that makes them from the match
    count (a 0-dim tensor, on the device: nothing is read back). Returns
    (res, kp_row, pnp result)."""
    cam = cfg.camera
    m = matcher.match_all(ref_desc, ref_valid, kp_desc, kp_valid,
                          th=matcher.TH_LOW, nn_ratio=0.75, mutual=False)
    rows = torch.arange(ref_desc.shape[0], device=ref_desc.device)
    kp_row = _scatter_matches(m.idx, m.valid, rows, kp_uv.shape[0])
    kp_mp_valid = kp_row >= 0
    kp_mp_pos = _rows_of(kp_row, pt_pos)
    if callable(draws):
        draws = draws(kp_mp_valid.sum())
    res_p = pnp.pnp_ransac(kp_mp_pos, kp_uv, kp_mp_valid,
                           cam.fx, cam.fy, cam.cx, cam.cy, draws=draws)
    res = pose_opt.pose_optimization(
        res_p.R, res_p.t, kp_mp_pos, kp_uv, torch.where(kp_mp_valid, kp_ur, -1.0),
        _inv_sigma2(scales, kp_oct), kp_mp_valid,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
    )
    return res, kp_row, res_p


def _search_radius(cfg: SystemConfig) -> float:
    return 7.0 if cfg.sensor != Sensor.MONOCULAR else 15.0


def chain_to_device(host: dict, device) -> dict:
    """A chain of host arrays (R1/t1: pose of the last frame, R2/t2: of the
    one before; per keypoint of the last frame: its map point's position,
    octave, validity, descriptor words and id, -1 where none) → the
    tensors `stream_step` takes, in one upload."""
    arrays = dict(
        R1=np.asarray(host["R1"], np.float32), t1=np.asarray(host["t1"], np.float32),
        R2=np.asarray(host["R2"], np.float32), t2=np.asarray(host["t2"], np.float32),
        pt_pos=np.asarray(host["pt_pos"], np.float32),
        pt_oct=np.asarray(host["pt_oct"], np.int32),
        pt_valid=np.asarray(host["pt_valid"], bool),
        pt_desc=np.asarray(host["pt_desc"], np.uint32),
        pt_ids=np.asarray(host["pt_ids"], np.int64))
    return to_device(arrays, device)


def _first_claim(claimed_ids, ids):
    """Of `ids` (-1 = none), those not already in `claimed_ids` (-1 = none):
    a sort of the claimed ids and a binary search, all on the device. The
    empty slots sort last as the largest int64, never as -1."""
    big = torch.iinfo(torch.int64).max
    claimed = torch.sort(torch.where(claimed_ids >= 0, claimed_ids, big)).values
    j = torch.clamp(torch.searchsorted(claimed, ids), max=claimed.shape[0] - 1)
    return (ids >= 0) & (claimed[j] != ids)


def gather_pool(mirror: dict, pool_ids):
    """Candidate-pool rows from the device map mirror by point id: pool_ids
    [L] int64, -1 for an empty slot. Returns (dict of [L,...] rows keyed by
    the mirror's fields, valid [L]). An empty slot reads row 0 — the index
    is clamped, never wrapped to the last row — and is invalid."""
    c = torch.clamp(pool_ids, min=0)
    return {k: v[c] for k, v in mirror.items()}, pool_ids >= 0


def stream_step(cfg: SystemConfig, scales, upload, frontend_out, chain, mirror,
                generator=None):
    """One pipelined tracking step, with nothing read back to the host.

    The pose prediction and the previous frame's matches arrive as the
    `chain` the previous step returned, so consecutive frames' steps queue
    on the device while the host completes results a few frames behind (the
    reference overlaps its tracking thread's stages instead, Tracking.cc:594).
    The local candidate pool comes from the device `mirror` (fields of
    slammap/device_mirror.py) by id: `upload["pool_ids"]` [L] int64 with -1
    for an empty slot, and `upload["loc_life"]` [L] their lifetimes.
    `frontend_out` holds the frame's tensors keyed by tracking.frame.HOST_FIELDS.

    Returns (out, next_chain): `out` holds the frontend tensors, the motion
    and local matches (`kp_row_m`, `kp_row_l`) and inlier masks, the combined
    per-keypoint map ids `mp` (motion matches first, then local matches not
    already claimed, outliers cleared), the leftover-search ids `mp_extra`
    that only the next frame's motion model uses, the pose `R`, `t`,
    `n_inliers` and `n_vis`.
    """
    pool_ids = upload["pool_ids"]
    loc, pool_ok = gather_pool(mirror, pool_ids)
    R1, t1, R2, t2 = chain["R1"], chain["t1"], chain["R2"], chain["t2"]
    # constant velocity: V = T1·T2⁻¹, prediction V·T1 (Tracker._predict_pose)
    Rv = R1 @ R2.T
    tv = t1 - Rv @ t2
    R0 = Rv @ R1
    t0 = Rv @ t1 + tv
    f = frontend_out
    res_m, kp_row_m, res_l, kp_row_l, kp_row_add, n_vis = fused_track(
        cfg, scales, R0, t0, R1, t1,
        chain["pt_pos"], chain["pt_oct"], chain["pt_valid"], chain["pt_desc"],
        loc["pos"], loc["normal"], loc["mind"], loc["maxd"], loc["desc"], pool_ok,
        upload["loc_life"],
        f["uv"], f["octave"], f["u_right"], f["valid"], f["desc"],
        _search_radius(cfg), 1.0, generator,
    )
    # association combine (the host _track_fused's, on the device)
    ids_m = torch.where((kp_row_m >= 0) & res_m.inliers,
                        chain["pt_ids"][torch.clamp(kp_row_m, min=0)], -1)
    loc_g = torch.where(kp_row_l >= 0, pool_ids[torch.clamp(kp_row_l, min=0)], -1)
    fill = (ids_m < 0) & _first_claim(ids_m, loc_g)
    mp = torch.where(fill, loc_g, ids_m)
    mp = torch.where((mp >= 0) & ~res_l.inliers, -1, mp)
    # leftover-search matches enter the chain only (the host merges them
    # after its keyframe decision)
    add_g = torch.where(kp_row_add >= 0, pool_ids[torch.clamp(kp_row_add, min=0)], -1)
    use_a = (mp < 0) & _first_claim(mp, add_g)
    mp_chain = torch.where(use_a, add_g, mp)

    def pick(from_chain, from_pool):
        """Each keypoint's row from where its chained id came from."""
        return torch.where(use_a[:, None], from_pool[torch.clamp(kp_row_add, min=0)],
                           torch.where(fill[:, None], from_pool[torch.clamp(kp_row_l, min=0)],
                                       from_chain[torch.clamp(kp_row_m, min=0)]))

    next_chain = dict(
        R1=res_l.R, t1=res_l.t, R2=R1, t2=t1,
        pt_pos=pick(chain["pt_pos"], loc["pos"]), pt_oct=f["octave"],
        pt_valid=mp_chain >= 0, pt_desc=pick(chain["pt_desc"], loc["desc"]),
        pt_ids=mp_chain)
    out = dict(f, kp_row_m=kp_row_m, m_inl=res_m.inliers, kp_row_l=kp_row_l,
               l_inl=res_l.inliers, mp=mp, mp_extra=torch.where(use_a, add_g, -1),
               R=res_l.R, t=res_l.t, n_inliers=res_l.n_inliers, n_vis=n_vis)
    return out, next_chain


# ====================================================== host orchestration
class Tracker:
    def __init__(self, cfg: SystemConfig, store: MapStore, n_kp: int,
                 level_scales, device="cuda"):
        self.cfg = cfg
        self.store = store
        self.n_kp = n_kp
        self.device = torch.device(device)
        self.level_scales = np.asarray(level_scales, np.float32)
        self._scales_dev = torch.from_numpy(self.level_scales).to(self.device)
        self._generator = torch.Generator(device=self.device)
        self.state = TrackState.NO_IMAGES_YET
        self.last_frame: Optional[Frame] = None
        self.velocity: Optional[np.ndarray] = None  # 4x4 Tcl
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = -1
        self.n_lost = 0
        self.relative_poses: list = []  # (frame_id, ts, T_c_refkf, ref_kf, state)
        self.stats: list = []
        self._cached_pool = None  # (ids, host pool arrays) for the fused paths
        self._pool_stale_frames = 0
        self._chain = None  # device chain of the pipelined path (stream_step)
        # a rigid move of the map around the tracker, waiting to be applied
        # (notify_map_rebase / apply_pending_rebase)
        self.pending_map_rebase = None
        self.kfdb = None  # set by System once place recognition is up
        self._last_reloc_frame = -10 ** 9
        self.reloc_stats: list = []  # RelocStats per LOST frame
        self._mono_init_frame: Optional[Frame] = None  # held reference view
        self.init_stats: list = []  # per two-view attempt: frame, matches, ok, H?, ms
        self._draw_gen = torch.Generator(device=self.device)
        self.mih = None  # the multi-index hash, set by System when hashing is on
        self.odom = OdometryBuffer()  # planner-predicted motion (opt-in)
        self.n_odom_predictions = 0  # search windows predicted from `odom`

    # ---------------------------------------------------------- transfers
    def _up(self, a):
        """numpy → tensor on the tracker's device (uint32 words as int32)."""
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            return desc_to_torch(a, self.device)
        return torch.from_numpy(a).to(self.device)

    def _frame_dev(self, frame: Frame) -> dict:
        """Per-frame device tensors: the frontend's own outputs when the
        frame came from images, else one upload of the host arrays."""
        if frame.dev is None:
            frame.dev = {k: self._up(getattr(frame, k)) for k in HOST_FIELDS}
        return frame.dev

    def _seeded(self, frame_id: int):
        """The per-frame random stream of the lazier-greedy sampling."""
        self._generator.manual_seed(int(frame_id))
        return self._generator

    def reloc_draws(self, frame_id: int, n_valid):
        """The EPnP RANSAC's [256,6] draws for a LOST frame: indices in
        [0, max(n_valid, 6)) into the candidate's matches in their order.
        `n_valid` is a 0-dim tensor on the tracker's device. The default
        draws from a generator seeded by the frame id, the same for every
        candidate of a frame (as the JAX package's PRNGKey(frame_id));
        override it to feed other draws."""
        self._draw_gen.manual_seed(int(frame_id))
        return pnp.draw_hypotheses(n_valid, self._draw_gen)

    def init_draws(self, frame_id: int, n_valid):
        """The two-view RANSAC's [256,8] draws (see `reloc_draws`)."""
        self._draw_gen.manual_seed(int(frame_id))
        return pnp.draw_hypotheses(n_valid, self._draw_gen, initializer.N_HYP,
                                   initializer.SAMPLE)

    def _min_inliers(self, frame_id: int) -> int:
        """The local-map inlier gate, raised for a while after a
        relocalization (reference: Tracking.cc:2087 mnLastRelocFrameId)."""
        tcfg = self.cfg.tracking
        if frame_id - self._last_reloc_frame < tcfg.max_frames_between_kf:
            return tcfg.min_inliers_after_reloc
        return tcfg.min_inliers_local_map

    def _fetch(self, frame: Frame, results: dict) -> dict:
        """ONE download per step: the step's results and, for a frame that
        came from images, its not-yet-fetched host arrays."""
        if frame.uv is None:
            results = dict(results, **{k: frame.dev[k] for k in HOST_FIELDS})
            host = to_host(results)
            frame.fill_host(host)
            return host
        return to_host(results)

    # ------------------------------------------------- map-rebase protocol
    def notify_map_rebase(self, R_D, t_D):
        """Record that the map around the tracker moved rigidly:
        X_new = R_D·X_old + t_D (callers: the loop correction, the essential
        graph and the GBA write-back, all with store.lock held). Deltas
        compose until `apply_pending_rebase` applies them."""
        R_D = np.asarray(R_D, np.float32)
        t_D = np.asarray(t_D, np.float32)
        if self.pending_map_rebase is None:
            self.pending_map_rebase = (R_D.copy(), t_D.copy())
        else:
            R0, t0 = self.pending_map_rebase
            self.pending_map_rebase = (R_D @ R0, R_D @ t0 + t_D)

    def apply_pending_rebase(self):
        """Apply a pending rigid rebase to the tracking state (store.lock
        held): the last frame's pose (T ← T∘D⁻¹), in streaming mode the
        chain's two poses and its cached point positions (on the device), and
        the host pool's positions and normals. The pipelined step reads point
        data from the device map mirror by id, which the correction marked."""
        pend = self.pending_map_rebase
        if pend is None:
            return
        self.pending_map_rebase = None
        R_D, t_D = pend
        lf = self.last_frame
        if lf is not None and lf.R is not None:
            R_new = (lf.R @ R_D.T).astype(np.float32)
            lf.t = (lf.t - R_new @ t_D).astype(np.float32)
            lf.R = R_new
        if self._chain is not None:
            ch = self._chain
            d = to_device(dict(R=R_D, t=t_D), self.device)
            out = dict(ch)
            for k in ("1", "2"):
                Rn = ch["R" + k] @ d["R"].T
                out["R" + k] = Rn
                out["t" + k] = ch["t" + k] - Rn @ d["t"]
            out["pt_pos"] = ch["pt_pos"] @ d["R"].T + d["t"]
            self._chain = out
        if self._cached_pool is not None:
            pts, loc = self._cached_pool
            loc = ((loc[0] @ R_D.T + t_D).astype(np.float32),
                   (loc[1] @ R_D.T).astype(np.float32)) + tuple(loc[2:])
            self._cached_pool = (pts, loc)

    # ------------------------------------------------------------ per frame
    def process_frame(self, frame: Frame) -> TrackStats:
        fusable = (
            self.state == TrackState.OK and self.velocity is not None
            and self._cached_pool is not None
        )
        if not fusable:
            frame.ensure_host()
        st = TrackStats(frame_id=frame.frame_id)
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            self.state = TrackState.NOT_INITIALIZED
            if self.cfg.sensor in (Sensor.STEREO, Sensor.RGBD):
                initialized = self._stereo_initialization(frame)
            else:
                initialized = self._monocular_initialization(frame)
            if initialized:
                self.state = TrackState.OK
                st.created_kf = True
            st.state = self.state.name
            st.path = "init"
            st.n_features = frame.n_kp
            self._finish_frame(frame, st)
            return st

        ok = False
        used_fused = False
        if self.state == TrackState.OK:
            if fusable:
                ok = self._track_fused(frame, st)
                used_fused = ok
                st.path = "fused"
            if not ok and self.velocity is not None:
                ok = self._track_with_motion_model(frame, st)
                st.path = "motion"
                if not ok:
                    ok = self._track_reference_kf(frame, st)
                    st.path = "refkf"
            elif not ok:
                ok = self._track_reference_kf(frame, st)
                st.path = "refkf"
        else:  # LOST
            ok = self._relocalize(frame, st)
            st.path = "reloc"

        if ok and not used_fused:
            ok = self._track_local_map(frame, st)
        if ok:
            self._refresh_cached_pool(frame)

        if ok:
            self.state = TrackState.OK
            self.n_lost = 0
            if self.last_frame is not None:
                self._update_velocity(frame)
            if self._need_new_keyframe(frame):
                self._create_keyframe(frame)
                st.created_kf = True
            self._merge_additional_matches(frame)
        else:
            self.state = TrackState.LOST
            self.n_lost += 1
            self.velocity = None
        st.state = self.state.name
        st.n_features = frame.n_kp
        st.n_inliers = frame.n_matched
        self._finish_frame(frame, st)
        return st

    def _feed_ots(self, frame: Frame):
        """Per-table retrieval-utility update from this frame's matches
        (reference OTS: Tracking::UpdateQueryNumByHashTable Tracking.cc:3111)."""
        if self.mih is None:
            return
        has = frame.mp_ids >= 0
        if not has.any():
            return
        with self.store.lock:
            self.mih.update_query_scores(
                frame.desc[has], self.store.point_desc[frame.mp_ids[has]])

    def _merge_additional_matches(self, frame: Frame):
        """Merge the leftover-candidate matches into the frame AFTER the KF
        policy ran (reference order: SearchAdditionalMatchesInFrame is called
        after CreateNewKeyFrame, Tracking.cc:878-969 → 2119 — the extra
        matches feed the next frame's motion model, not the KF decision)."""
        extra = getattr(frame, "_extra_assign", None)
        if extra is None:
            return
        claimed = set(frame.mp_ids[frame.mp_ids >= 0].tolist())
        fill = (frame.mp_ids < 0) & (extra >= 0)
        for j in np.nonzero(fill)[0]:
            e = int(extra[j])
            if e in claimed:
                continue
            frame.mp_ids[j] = e
            claimed.add(e)
        frame._extra_assign = None

    # ---------------------------------------------------------- stages
    def _predict_pose(self, ts: Optional[float] = None):
        """Search-window prediction: planner odometry when buffered for both
        the last frame's timestamp and `ts` (reference:
        ENABLE_PLANNER_PREDICTION README.md:87-101 + PredictRelMotionFromBuffer
        Tracking.cc:1448), else constant velocity."""
        T_last = self.last_frame.pose_matrix()
        rel = None
        if ts is not None and self.last_frame.timestamp is not None:
            rel = self.odom.relative_motion(self.last_frame.timestamp, ts)
        if rel is not None:
            self.n_odom_predictions += 1
        T_pred = (rel if rel is not None else self.velocity) @ T_last
        return T_pred[:3, :3].copy(), T_pred[:3, 3].copy()

    def _last_frame_points(self):
        """Map points tracked by the last frame, as per-keypoint rows."""
        lf = self.last_frame
        ids = self.store.resolve_replaced(lf.mp_ids)
        rows = ids >= 0
        pt_pos = np.zeros((self.n_kp, 3), np.float32)
        pt_desc = np.zeros((self.n_kp, 8), np.uint32)
        pt_pos[rows] = self.store.point_pos[ids[rows]]
        pt_desc[rows] = self.store.point_desc[ids[rows]]
        return ids, rows, pt_pos, pt_desc, lf.octave.astype(np.int32)

    @property
    def _search_radius(self) -> float:
        return _search_radius(self.cfg)

    def _track_with_motion_model(self, frame: Frame, st: TrackStats) -> bool:
        lf = self.last_frame
        ids, rows, pt_pos, pt_desc, pt_oct = self._last_frame_points()
        R0, t0 = self._predict_pose(frame.timestamp)
        kp = self._frame_dev(frame)
        res, kp_row, _ = motion_step(
            self.cfg, self._scales_dev,
            self._up(R0), self._up(t0), self._up(lf.R), self._up(lf.t),
            self._up(pt_pos), self._up(pt_oct), self._up(rows), self._up(pt_desc),
            kp["uv"], kp["octave"], kp["u_right"], kp["valid"], kp["desc"],
            self._search_radius,
        )
        h = self._fetch(frame, dict(kp_row=kp_row, inl=res.inliers, R=res.R,
                                    t=res.t, n_inl=res.n_inliers))
        kp_row, inl = h["kp_row"], h["inl"]
        frame.mp_ids = np.where(kp_row >= 0, ids[np.maximum(kp_row, 0)], -1).astype(np.int32)
        frame.mp_ids[~inl] = -1
        frame.R = h["R"]
        frame.t = h["t"]
        st.n_motion_matches = int((kp_row >= 0).sum())
        return int(h["n_inl"]) >= 20

    def _track_reference_kf(self, frame: Frame, st: TrackStats) -> bool:
        if self.ref_kf < 0:
            return False
        k = self.ref_kf
        s = self.store
        ref_ids = s.resolve_replaced(s.kf_point[k])
        rows = ref_ids >= 0
        pt_pos = np.zeros((self.n_kp, 3), np.float32)
        pt_pos[rows] = s.point_pos[ref_ids[rows]]
        R0 = self.last_frame.R if self.last_frame is not None else np.eye(3, dtype=np.float32)
        t0 = self.last_frame.t if self.last_frame is not None else np.zeros(3, np.float32)
        kp = self._frame_dev(frame)
        rows_d = self._up(rows)
        res, kp_row, _ = refkf_step(
            self.cfg, self._scales_dev, self._up(R0), self._up(t0),
            self._up(s.kf_desc[k]), rows_d, self._up(s.kf_angle[k]),
            self._up(pt_pos), rows_d,
            kp["uv"], kp["octave"], kp["u_right"], kp["valid"], kp["desc"],
            kp["angle"],
        )
        h = self._fetch(frame, dict(kp_row=kp_row, inl=res.inliers, R=res.R,
                                    t=res.t, n_inl=res.n_inliers))
        kp_row, inl = h["kp_row"], h["inl"]
        frame.mp_ids = np.where(kp_row >= 0, ref_ids[np.maximum(kp_row, 0)], -1).astype(np.int32)
        frame.mp_ids[~inl] = -1
        frame.R = h["R"]
        frame.t = h["t"]
        return int(h["n_inl"]) >= 15

    def _pool_arrays(self, pts):
        """Fixed-capacity candidate-pool arrays for point ids `pts`:
        (pos, normal, min_dist, max_dist, desc, valid, lifetime)."""
        s = self.store
        L = self.cfg.capacity.max_local_points
        n_loc = pts.size
        pad = L - n_loc
        return (
            np.concatenate([s.point_pos[pts], np.zeros((pad, 3), np.float32)]),
            np.concatenate([s.point_normal[pts], np.zeros((pad, 3), np.float32)]),
            np.concatenate([s.point_min_dist[pts], np.zeros(pad, np.float32)]),
            np.concatenate([s.point_max_dist[pts], np.ones(pad, np.float32)]),
            np.concatenate([s.point_desc[pts], np.zeros((pad, 8), np.uint32)]),
            np.concatenate([np.ones(n_loc, bool), np.zeros(pad, bool)]),
            np.concatenate([s.point_found[pts].astype(np.float32),
                            np.zeros(pad, np.float32)]),
        )

    def _refresh_cached_pool(self, frame: Frame):
        """Build next frame's local-map candidate pool from this frame's
        matches and upload it (the fused tracking step consumes it — one
        frame stale by design)."""
        pts = self._gather_local_map(frame)
        if pts is None or pts.size == 0:
            # transient empty gather (post-KF bookkeeping can momentarily
            # orphan the frame's matches): KEEP the previous pool for up to
            # two frames — its ids are re-resolved against the live store
            # anyway. A PERSISTENTLY empty gather means the track is
            # genuinely failing: drop the pool so tracking falls back to its
            # robust paths.
            self._pool_stale_frames += 1
            if self._pool_stale_frames > 2:
                self._cached_pool = None
            return
        self._pool_stale_frames = 0
        pts = pts[: self.cfg.capacity.max_local_points]
        # kept on the host: the synchronous fused step uploads it in one
        # copy, the pipelined step uploads only its ids and lifetimes
        self._cached_pool = (pts, self._pool_arrays(pts))

    def _track_fused(self, frame: Frame, st: TrackStats) -> bool:
        """One-synchronization tracking: motion + local map chained on the
        device against the cached (previous-frame) candidate pool."""
        s = self.store
        lf = self.last_frame
        pool_ids, loc = self._cached_pool
        ids, rows, pt_pos, pt_desc, pt_oct = self._last_frame_points()
        R0, t0 = self._predict_pose(frame.timestamp)
        kp = self._frame_dev(frame)
        loc = to_device(dict(enumerate(loc)), self.device).values()
        res_m, kp_row_m, res_l, kp_row_l, kp_row_add, _ = fused_track(
            self.cfg, self._scales_dev,
            self._up(R0), self._up(t0), self._up(lf.R), self._up(lf.t),
            self._up(pt_pos), self._up(pt_oct), self._up(rows), self._up(pt_desc),
            *loc,
            kp["uv"], kp["octave"], kp["u_right"], kp["valid"], kp["desc"],
            self._search_radius, 1.0, self._seeded(frame.frame_id),
        )
        d = self._fetch(frame, dict(
            kp_row_m=kp_row_m, m_inl=res_m.inliers, kp_row_l=kp_row_l,
            kp_row_add=kp_row_add, l_inl=res_l.inliers,
            R=res_l.R, t=res_l.t, n_inliers=res_l.n_inliers))
        kp_row_m, m_inl = d["kp_row_m"], d["m_inl"]
        kp_row_l, kp_row_add, l_inl = d["kp_row_l"], d["kp_row_add"], d["l_inl"]
        st.n_motion_matches = int((kp_row_m >= 0).sum())
        # combine associations: motion first, then local fills the rest
        mp = np.where(kp_row_m >= 0, ids[np.maximum(kp_row_m, 0)], -1).astype(np.int32)
        mp[~m_inl] = -1
        L = self.cfg.capacity.max_local_points
        pool_pad = np.full(L, -1, np.int64)
        pool_pad[: pool_ids.size] = pool_ids
        loc_assign = np.where(kp_row_l >= 0, pool_pad[np.maximum(kp_row_l, 0)], -1)
        fill = (mp < 0) & (loc_assign >= 0)
        # drop duplicate map ids already claimed via the motion step
        claimed = set(mp[mp >= 0].tolist())
        for j in np.nonzero(fill)[0]:
            if loc_assign[j] in claimed:
                fill[j] = False
        mp[fill] = loc_assign[fill]
        frame.mp_ids = mp
        frame.is_outlier = (frame.mp_ids >= 0) & ~l_inl
        frame.mp_ids[frame.is_outlier] = -1
        # additional (leftover) matches: merged only AFTER the KF policy
        frame._extra_assign = np.where(
            kp_row_add >= 0, pool_pad[np.maximum(kp_row_add, 0)], -1
        )
        frame.R = d["R"]
        frame.t = d["t"]
        st.n_local_points = int(pool_ids.size)
        st.n_local_matches = int((kp_row_l >= 0).sum())
        tracked = frame.mp_ids[frame.mp_ids >= 0]
        s.point_found[tracked] += 1
        s.point_visible[pool_ids] += 1
        self._feed_ots(frame)
        return int(d["n_inliers"]) >= self._min_inliers(frame.frame_id)

    # ---------------------------------------------------- pipelined path
    def stream_ready(self) -> bool:
        """Streaming needs an OK track, a velocity estimate, a pool and a
        last frame with host arrays."""
        return (self.state == TrackState.OK and self.velocity is not None
                and self._cached_pool is not None
                and self.last_frame is not None
                and self.last_frame.uv is not None)

    def stream_prepare_upload(self, frame_id: int):
        """The host part of a streamed frame's upload: the (one frame stale)
        pool's ids, -1 past its end, and lifetimes — point data comes from
        the device mirror. Returns (arrays, pool_ids)."""
        pool_ids, loc = self._cached_pool
        ids = np.full(self.cfg.capacity.max_local_points, -1, np.int64)
        ids[: pool_ids.size] = pool_ids
        return dict(pool_ids=ids, loc_life=loc[6]), pool_ids

    def stream_bootstrap_chain(self) -> dict:
        """The device chain from the last synchronously tracked frame, in one
        upload; afterwards the chain never visits the host."""
        lf = self.last_frame
        s = self.store
        with s.lock:
            ids = s.resolve_replaced(lf.mp_ids)
            rows = ids >= 0
            pt_pos = np.zeros((self.n_kp, 3), np.float32)
            pt_desc = np.zeros((self.n_kp, 8), np.uint32)
            pt_pos[rows] = s.point_pos[ids[rows]]
            pt_desc[rows] = s.point_desc[ids[rows]]
        T1 = lf.pose_matrix()
        V = self.velocity
        Vinv = np.eye(4, dtype=np.float32)
        Vinv[:3, :3] = V[:3, :3].T
        Vinv[:3, 3] = -V[:3, :3].T @ V[:3, 3]
        T2 = (Vinv @ T1).astype(np.float32)
        return chain_to_device(dict(
            R1=T1[:3, :3], t1=T1[:3, 3], R2=T2[:3, :3], t2=T2[:3, 3],
            pt_pos=pt_pos, pt_oct=lf.octave, pt_valid=rows, pt_desc=pt_desc,
            pt_ids=np.where(rows, ids, -1)), self.device)

    def stream_dispatch(self, frontend_out: dict, upload: dict, frame_id: int) -> dict:
        """Enqueue one streaming step against the store's device mirror and
        advance the chain; returns the step's output tensors."""
        out, self._chain = stream_step(
            self.cfg, self._scales_dev, upload, frontend_out, self._chain,
            self.store.mirror.arrays, self._seeded(frame_id))
        return out

    def stream_complete(self, frame: Frame, d: dict, pool_ids) -> TrackStats:
        """Host bookkeeping of a streamed frame from its downloaded results
        (`_track_fused`'s part after the download plus `process_frame`'s OK
        branch). Runs under store.lock: it races the mapping worker."""
        with self.store.lock:
            return self._stream_complete_locked(frame, d, pool_ids)

    def _stream_complete_locked(self, frame: Frame, d: dict, pool_ids) -> TrackStats:
        s = self.store
        st = TrackStats(frame_id=frame.frame_id, path="stream")
        if frame.uv is None:
            frame.fill_host(d)
        # ids from the device may be stale (points replaced or culled since
        # the pool was gathered): resolve them against the store now
        mp = s.resolve_replaced(d["mp"])
        frame.mp_ids = mp.astype(np.int32)
        frame.is_outlier = np.zeros(self.n_kp, bool)
        frame.R = d["R"]
        frame.t = d["t"]
        st.n_motion_matches = int((d["kp_row_m"] >= 0).sum())
        st.n_local_points = int(pool_ids.size)
        st.n_local_matches = int((d["kp_row_l"] >= 0).sum())
        tracked = frame.mp_ids[frame.mp_ids >= 0]
        s.point_found[tracked] += 1
        s.point_visible[pool_ids] += 1
        self._feed_ots(frame)
        if int(d["n_inliers"]) >= self._min_inliers(frame.frame_id):
            self.state = TrackState.OK
            self.n_lost = 0
            self._refresh_cached_pool(frame)
            self._update_velocity(frame)
            if self._need_new_keyframe(frame):
                self._create_keyframe(frame)
                st.created_kf = True
            frame._extra_assign = s.resolve_replaced(d["mp_extra"])
            self._merge_additional_matches(frame)
        else:
            self.state = TrackState.LOST
            self.n_lost += 1
            self.velocity = None
            self._chain = None
        st.state = self.state.name
        st.n_features = frame.n_kp
        st.n_inliers = frame.n_matched
        self._finish_frame(frame, st)
        return st

    def _gather_local_map(self, frame: Frame):
        """Local map = KFs sharing points with the frame (K1) + their best
        covisible neighbors (K2), then their points
        (reference: UpdateLocalKeyFrames/UpdateLocalPoints Tracking.cc:2513/2485)."""
        s = self.store
        matched = frame.mp_ids[frame.mp_ids >= 0]
        if matched.size == 0:
            return None
        obs = s.obs_kf[matched]  # [M,O]
        flat = obs[obs >= 0]
        if flat.size == 0:
            return None
        counts = np.bincount(flat, minlength=s.cap.max_keyframes)
        k1 = np.nonzero(counts)[0]
        # K2: neighbors of K1 in covisibility (cap 10 each, reference cap 80 total)
        k2 = set(k1.tolist())
        for k in k1[np.argsort(-counts[k1])][:20]:
            for nb in s.covisible_kfs(int(k), 10):
                k2.add(int(nb))
            if len(k2) >= self.cfg.capacity.max_local_kfs:
                break
        kfs = np.fromiter(k2, int)
        kfs = kfs[s.kf_valid[kfs]]
        # reference keyframe := max-covis KF (Tracking.cc:2601)
        self.ref_kf = int(k1[np.argmax(counts[k1])])
        # local-map assembly: covisibility traversal, hash retrieval, or both
        # (reference: UpdateLocalPointsByHashing Tracking.cc:2895, modes
        # CovisOnly/HashOnly/Combined Tracking.h:197-201, trigger
        # MAP_SIZE_TRIGGER_HASHING Tracking.h:66)
        mode = self.cfg.tracking.local_map_mode
        use_hash = (
            self.mih is not None
            and s.n_points > self.cfg.hashing.map_size_trigger
            and mode in (LocalMapMode.HASH_ONLY, LocalMapMode.COMBINED)
        )
        if use_hash:
            with s.lock:  # the mapping worker inserts into the same tables
                hpts = self.mih.query(frame.desc[frame.valid])
                hpts = hpts[(hpts >= 0) & (hpts < s.point_valid.shape[0])]
                hpts = hpts[s.point_valid[hpts]]
                self.mih.update_dynamics(len(hpts))
            if mode == LocalMapMode.HASH_ONLY:
                pts = np.unique(hpts)
            else:
                cpts = np.unique(s.kf_point[kfs])
                pts = np.unique(np.concatenate([cpts[cpts >= 0], hpts]))
        else:
            pts = np.unique(s.kf_point[kfs])
        pts = pts[pts >= 0]
        pts = pts[s.point_valid[pts]]
        L = self.cfg.capacity.max_local_points
        if pts.size > L:
            # keep the most-observed points
            order = np.argsort(-s.point_nobs[pts], kind="stable")
            pts = pts[order[:L]]
        return pts

    def _track_local_map(self, frame: Frame, st: TrackStats) -> bool:
        s = self.store
        pts = self._gather_local_map(frame)
        if pts is None:
            return False
        L = self.cfg.capacity.max_local_points
        n_loc = pts.size
        st.n_local_points = int(n_loc)
        pad = L - n_loc
        loc = self._pool_arrays(pts)
        already = np.concatenate(
            [np.isin(pts, frame.mp_ids[frame.mp_ids >= 0]), np.zeros(pad, bool)])
        kp_mp_pos = np.zeros((self.n_kp, 3), np.float32)
        has = frame.mp_ids >= 0
        kp_mp_pos[has] = s.point_pos[frame.mp_ids[has]]
        extra_r = 2.0 if self.state == TrackState.LOST else 1.0
        kp = self._frame_dev(frame)
        res, kp_row, kp_row_add, _, _ = local_step(
            self.cfg, self._scales_dev, self._up(frame.R), self._up(frame.t),
            *(self._up(a) for a in loc), self._up(already),
            kp["uv"], kp["octave"], kp["u_right"], kp["valid"], kp["desc"],
            self._up(kp_mp_pos), self._up(has), extra_r,
            self._seeded(frame.frame_id),
        )
        h = self._fetch(frame, dict(kp_row=kp_row, kp_row_add=kp_row_add,
                                    inl=res.inliers, R=res.R, t=res.t,
                                    n_inl=res.n_inliers))
        kp_row, kp_row_add, inl = h["kp_row"], h["kp_row_add"], h["inl"]
        pts_pad = np.concatenate([pts, np.full(pad, -1, np.int64)])
        new_ids = np.where(kp_row >= 0, pts_pad[np.maximum(kp_row, 0)], frame.mp_ids)
        frame.mp_ids = new_ids.astype(np.int32)
        frame.is_outlier = (frame.mp_ids >= 0) & ~inl
        frame.mp_ids[frame.is_outlier] = -1
        frame._extra_assign = np.where(
            kp_row_add >= 0, pts_pad[np.maximum(kp_row_add, 0)], -1
        )
        frame.R = h["R"]
        frame.t = h["t"]
        st.n_local_matches = int((kp_row >= 0).sum())
        # found/visible counters (reference IncreaseFound, Tracking.cc:1600)
        tracked = frame.mp_ids[frame.mp_ids >= 0]
        s.point_found[tracked] += 1
        s.point_visible[pts] += 1
        self._feed_ots(frame)
        return int(h["n_inl"]) >= self._min_inliers(frame.frame_id)

    def _relocalize(self, frame: Frame, st: TrackStats) -> bool:
        """Relocalization (reference: Tracking.cc:2615): KF-database BoW
        candidates (when place recognition is up), else the 5 newest KFs,
        newest first; per candidate one upload, `reloc_step` and one
        download. A candidate with < 15 map points is skipped; the first
        with ≥ 15 LM inliers after a successful EPnP RANSAC is taken."""
        if not self.cfg.tracking.enable_reloc:
            return False
        t0 = time.perf_counter()
        cands = []
        if self.kfdb is not None:
            cands = self.kfdb.detect_reloc_candidates(frame.desc, frame.valid)
        rec = RelocStats(frame.frame_id, "kfdb" if cands else "recent", 0)
        if not cands:
            cands = list(reversed(self.store.valid_kf_ids()[-5:].tolist()))
        rec.n_candidates = len(cands)
        self.reloc_stats.append(rec)
        s = self.store
        kp = self._frame_dev(frame)
        ok = False
        for k in cands:
            k = int(k)
            ref_ids = s.resolve_replaced(s.kf_point[k])
            rows = ref_ids >= 0
            if rows.sum() < 15:
                continue
            pt_pos = np.zeros((self.n_kp, 3), np.float32)
            pt_pos[rows] = s.point_pos[ref_ids[rows]]
            d = to_device(dict(desc=s.kf_desc[k], valid=rows & s.kf_kp_valid[k],
                               pos=pt_pos), self.device)
            res, kp_row, res_p = reloc_step(
                self.cfg, self._scales_dev, d["desc"], d["valid"], d["pos"],
                kp["uv"], kp["octave"], kp["u_right"], kp["valid"], kp["desc"],
                lambda n: self.reloc_draws(frame.frame_id, n))
            h = self._fetch(frame, dict(
                kp_row=kp_row, inl=res.inliers, R=res.R, t=res.t,
                n_inl=res.n_inliers, pnp_ok=res_p.ok, n_pnp=res_p.n_inliers))
            rec.n_solved += 1
            if not bool(h["pnp_ok"]) or int(h["n_inl"]) < 15:
                continue
            kp_row, inl = h["kp_row"], h["inl"]
            frame.mp_ids = np.where(kp_row >= 0, ref_ids[np.maximum(kp_row, 0)], -1).astype(np.int32)
            frame.mp_ids[~inl] = -1
            frame.R = h["R"]
            frame.t = h["t"]
            self.ref_kf = k
            self._last_reloc_frame = frame.frame_id
            rec.kf, rec.n_pnp_inliers, rec.n_inliers = k, int(h["n_pnp"]), int(h["n_inl"])
            ok = True
            break
        rec.ms = (time.perf_counter() - t0) * 1e3
        return ok

    # ---------------------------------------------------------- lifecycle
    def _charuco_anchor(self, frame: Frame):
        """World-frame anchor from a ChArUco board in the first frame
        (reference: INIT_WITH_ARUCHO — Tracking uses ChArUco::process to
        set the initial pose instead of the identity, src/ChArUco.cc:92).
        Reads the frame's raw left image (host numpy, `frame._raw_img`, kept
        by System only until initialization). Returns (R_cw, t_cw) or None."""
        if not self.cfg.charuco.enabled:
            return None
        raw = getattr(frame, "_raw_img", None)
        if raw is None:
            return None
        cc = self.cfg.charuco
        cam = self.cfg.camera
        K = np.asarray([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]],
                       np.float64)
        board = charuco.CharucoBoard(cc.squares_x, cc.squares_y, cc.square_len,
                                     cc.marker_len, cc.dictionary)
        try:
            return charuco.detect_board_pose(np.asarray(raw), board, K, np.zeros(5))
        except Exception as e:  # no OpenCV, or it refused the image
            warnings.warn(f"ChArUco detection failed ({e!r}): the first pose is the identity")
            return None

    def _stereo_initialization(self, frame: Frame) -> bool:
        if frame.n_kp < 500:
            return False
        s = self.store
        anchor = self._charuco_anchor(frame)
        if anchor is not None:
            frame.R, frame.t = anchor
        else:
            frame.R = np.eye(3, dtype=np.float32)
            frame.t = np.zeros(3, np.float32)
        k = s.add_keyframe(
            frame.R, frame.t, frame.uv, frame.octave, frame.angle, frame.desc,
            frame.u_right, frame.depth, frame.valid, frame.frame_id, frame.timestamp,
        )
        cam = self.cfg.camera
        good = frame.valid & (frame.depth > 0)
        idxs = np.nonzero(good)[0]
        z = frame.depth[idxs]
        pc = np.stack([
            (frame.uv[idxs, 0] - cam.cx) * z / cam.fx,
            (frame.uv[idxs, 1] - cam.cy) * z / cam.fy,
            z,
        ], -1).astype(np.float32)
        # camera → world through the (possibly board-anchored) first pose
        pts = (pc - frame.t) @ frame.R
        ids = s.add_points_batch(pts, frame.desc[idxs], k, k, idxs)
        frame.mp_ids[idxs] = ids
        s.update_normals_batch(ids, self.level_scales)
        s.update_connections(k)
        self.ref_kf = k
        self.last_kf_frame_id = frame.frame_id
        return True

    def _monocular_initialization(self, frame: Frame) -> bool:
        """Reference: MonocularInitialization + CreateInitialMapMonocular
        (Tracking.cc:1141/1206): hold a reference frame, window-match (kernel
        1b through `match_window`), run the batched H/F RANSAC bootstrap, build
        the two-KF map and normalize the scale to unit median depth. One
        upload of the held frame and one download per attempt: the RANSAC
        runs whatever the match count, whose check waits for the download."""
        f0 = self._mono_init_frame
        if f0 is None or f0.n_kp < 100:
            self._mono_init_frame = frame if frame.n_kp >= 100 else None
            return False
        t0 = time.perf_counter()
        kp = self._frame_dev(frame)
        cam = self.cfg.camera
        K = np.asarray([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)
        d = to_device(dict(uv=f0.uv, desc=f0.desc, valid=f0.valid, K=K), self.device)
        m = matcher.match_window(d["uv"], d["desc"], d["valid"],
                                 kp["uv"], kp["desc"], kp["valid"], window=100.0)
        uv2 = kp["uv"][torch.clamp(m.idx, min=0)]
        res = initializer.initialize(
            d["uv"], uv2, m.valid, d["K"],
            draws=self.init_draws(frame.frame_id, m.valid.sum()))
        h = self._fetch(frame, dict(idx=m.idx, mval=m.valid, ok=res.ok, R=res.R, t=res.t,
                                    points=res.points, inl=res.is_inlier,
                                    used_h=res.used_h))
        self.init_stats.append(dict(
            frame_id=frame.frame_id, ref_frame_id=f0.frame_id,
            n_matches=int(h["mval"].sum()), ok=bool(h["ok"]), used_h=bool(h["used_h"]),
            ms=(time.perf_counter() - t0) * 1e3))
        if int(h["mval"].sum()) < 100:
            self._mono_init_frame = frame if frame.n_kp >= 100 else None
            return False
        if not bool(h["ok"]):
            return False
        # ---- build the initial map
        s = self.store
        idx, inl, X = h["idx"], h["inl"], h["points"]
        # scale: unit median depth (reference: ComputeSceneMedianDepth → 1)
        med = float(np.median(X[inl][:, 2]))
        if med <= 0:
            return False
        X = X / med
        R2, t2 = h["R"], (h["t"] / med).astype(np.float32)
        k0 = s.add_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            f0.uv, f0.octave, f0.angle, f0.desc, f0.u_right, f0.depth,
            f0.valid, f0.frame_id, f0.timestamp,
        )
        k1 = s.add_keyframe(
            R2, t2, frame.uv, frame.octave, frame.angle, frame.desc,
            frame.u_right, frame.depth, frame.valid, frame.frame_id,
            frame.timestamp,
        )
        rows = np.nonzero(inl)[0]
        cols = idx[rows].astype(np.int64)
        ids = s.add_points_batch(X[rows].astype(np.float32), frame.desc[cols], k0, k0, rows)
        s.add_observations_batch(ids, k1, cols)
        s.update_normals_batch(ids, self.level_scales)
        frame.mp_ids[cols] = ids
        s.update_connections(k0)
        s.update_connections(k1)
        frame.R, frame.t = R2, t2
        self.ref_kf = k1
        self.last_kf_frame_id = frame.frame_id
        self._mono_init_frame = None
        return True

    def _update_velocity(self, frame: Frame):
        T_cur = frame.pose_matrix()
        T_last = self.last_frame.pose_matrix()
        T_last_inv = np.eye(4, dtype=np.float32)
        T_last_inv[:3, :3] = T_last[:3, :3].T
        T_last_inv[:3, 3] = -T_last[:3, :3].T @ T_last[:3, 3]
        self.velocity = T_cur @ T_last_inv

    def _need_new_keyframe(self, frame: Frame) -> bool:
        """Reference: Tracking.cc:1914. Conditions adapted: covisibility
        ratio vs reference KF, close-point bookkeeping for stereo, frame gap."""
        tcfg = self.cfg.tracking
        if self.cfg.localization_only:
            return False
        n_kfs = len(self.store.valid_kf_ids())
        # tracked points in reference KF (min obs 2/3)
        s = self.store
        min_obs = 3 if n_kfs > 2 else 2
        ref_pts = s.kf_point[self.ref_kf]
        ref_pts = ref_pts[ref_pts >= 0]
        n_ref = int((s.point_nobs[ref_pts] >= min_obs).sum()) if ref_pts.size else 0
        if n_ref == 0:
            # degenerate early-map case (single KF: all nobs==1): fall back to
            # the ref KF's full point count so the overlap-ratio clause works
            n_ref = int(ref_pts.size)
        n_tracked = frame.n_matched
        frames_since_kf = frame.frame_id - self.last_kf_frame_id
        if self.cfg.sensor != Sensor.MONOCULAR:
            close_ok = (frame.depth > 0) & (frame.depth < self.close_depth_th)
            tracked_close = int((close_ok & (frame.mp_ids >= 0)).sum())
            untracked_close = int((close_ok & (frame.mp_ids < 0) & frame.valid).sum())
            # reference thresholds 100/70 assume ~1000-feature budgets
            # (Tracking.cc:1914); scale with the configured budget
            n_feat = self.cfg.orb.n_features
            need_close = (
                tracked_close < max(40, int(0.1 * n_feat))
                and untracked_close > max(25, int(0.07 * n_feat))
            )
        else:
            need_close = False
        ratio = 0.75 if n_kfs > 2 else 0.4
        if self.cfg.sensor == Sensor.MONOCULAR:
            ratio = 0.9
        c1a = frames_since_kf >= tcfg.max_frames_between_kf
        c1b = frames_since_kf >= tcfg.min_frames_between_kf
        # c1c (reference Tracking.cc:1984): tracking is weak — insert now
        c1c = (self.cfg.sensor != Sensor.MONOCULAR
               and n_tracked < n_ref * 0.25)
        # Starvation guard: on sweeping/yaw-dominant motion with few close
        # points, n_ref (nobs>=3 points of the ref KF) can be so small that
        # 0.75*n_ref sits BELOW the LOST threshold — tracking dies before c2
        # ever fires. The reference leans on bNeedToInsertClose for exactly
        # this (Tracking.cc:1952-1960), but that clause needs close-depth
        # geometry; this floor generalizes it: insert a KF before the inlier
        # count decays to the LOST floor.
        starving = n_tracked < 2 * tcfg.min_inliers_local_map
        c2 = (n_tracked < n_ref * ratio or need_close) and n_tracked > 15
        return bool((c1a or (c1b and c2) or c1c or need_close or starving)
                    and n_tracked > 15)

    @property
    def close_depth_th(self) -> float:
        cam = self.cfg.camera
        return cam.th_depth * cam.baseline if cam.bf > 0 else 1e9

    def _create_keyframe(self, frame: Frame):
        """Reference: CreateNewKeyFrame Tracking.cc:2008 — register KF, bind
        tracked points, spawn new close stereo points (≤100 nearest)."""
        s = self.store
        k = s.add_keyframe(
            frame.R, frame.t, frame.uv, frame.octave, frame.angle, frame.desc,
            frame.u_right, frame.depth, frame.valid, frame.frame_id, frame.timestamp,
        )
        has = np.nonzero(frame.mp_ids >= 0)[0]
        s.add_observations_batch(frame.mp_ids[has], k, has)
        if self.cfg.sensor != Sensor.MONOCULAR:
            cand = np.nonzero(frame.valid & (frame.depth > 0) & (frame.mp_ids < 0))[0]
            if cand.size:
                order = cand[np.argsort(frame.depth[cand])]
                z = frame.depth[order]
                # reference: create ALL close points, plus the 100 nearest
                # beyond the close threshold (depth-sorted loop with break)
                keep = (z <= self.close_depth_th) | (np.arange(order.size) < 100)
                order, z = order[keep], z[keep]
                Rwc = frame.R.T
                tw = frame.center()
                cam = self.cfg.camera
                pc = np.stack([
                    (frame.uv[order, 0] - cam.cx) * z / cam.fx,
                    (frame.uv[order, 1] - cam.cy) * z / cam.fy,
                    z,
                ], -1).astype(np.float32)
                pw = pc @ Rwc.T + tw
                ids = s.add_points_batch(pw, frame.desc[order], k, k, order)
                s.update_normals_batch(ids, self.level_scales)
                frame.mp_ids[order] = ids
        s.update_connections(k)
        self.ref_kf = k
        self.last_kf_frame_id = frame.frame_id

    def _finish_frame(self, frame: Frame, st: TrackStats):
        # store relative pose to reference KF for trajectory recomposition
        # (reference: Tracking.cc:1029-1053)
        if self.ref_kf >= 0 and frame.R is not None and self.state == TrackState.OK:
            s = self.store
            T_ref = np.eye(4, dtype=np.float32)
            T_ref[:3, :3] = s.kf_R[self.ref_kf]
            T_ref[:3, 3] = s.kf_t[self.ref_kf]
            T_ref_inv = np.eye(4, dtype=np.float32)
            T_ref_inv[:3, :3] = T_ref[:3, :3].T
            T_ref_inv[:3, 3] = -T_ref[:3, :3].T @ T_ref[:3, 3]
            T_rel = frame.pose_matrix() @ T_ref_inv
            self.relative_poses.append(
                (frame.frame_id, frame.timestamp, T_rel, self.ref_kf, self.state.name)
            )
        self.stats.append(st)
        frame.dev = None  # release the frontend's device tensors
        self.last_frame = frame

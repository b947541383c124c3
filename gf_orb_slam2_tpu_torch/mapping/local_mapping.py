"""Local mapping: per-keyframe map maintenance + local BA.

Replacement for the LocalMapping thread (reference: src/LocalMapping.cc:120
Run loop), run per inserted keyframe — before the next frame on the
synchronous path, or on the System's mapping worker thread on its own CUDA
stream when `tracking.async_mapping` is set: host bookkeeping on the numpy
store, the heavy math on the device.

Stage → reference:
- `refresh`            ← ProcessNewKeyFrame (:272) + MapPointCulling (:325):
  distinctive descriptors, normals, covisibility; found-ratio and
  observation-count culling of recently created points.
- `create_and_fuse`    ← CreateNewMapPoints (:370) + SearchInNeighbors (:634):
  epipolar-guided matching against the covisible KFs, DLT triangulation and
  acceptance gates, then project-and-fuse duplicates in both directions
  (each half alone: `create_new_points`, `fuse_neighbors`).
- `run_local_ba`       ← Optimizer::LocalBundleAdjustment (Optimizer.cc:618)
  via optim/local_ba.py, with good-graph KF selection (selection/good_graph).
- `cull_keyframes`     ← KeyFrameCulling (:820): ≥90 % redundancy rule.

Transfers: each device stage gathers what it needs from the store on the
host (the event's KF rows, point rows and observation tables), uploads it in
one copy (utils/transfer.to_device) and downloads its results in one
synchronization (utils/transfer.to_host).

The matching of both device stages goes through `hamming.distance_best2`
(the fused masked best-2 kernel on CUDA tensors), one call per KF pair: the
[N,M] distance matrix is never formed.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from gf_orb_slam2_tpu_torch.config import Sensor, SystemConfig
from gf_orb_slam2_tpu_torch.geometry import lie, triangulate
from gf_orb_slam2_tpu_torch.mapping.batch_ops import refresh_points_batch, redundant_keyframes
from gf_orb_slam2_tpu_torch.matching import hamming, matcher
from gf_orb_slam2_tpu_torch.optim.local_ba import (
    LocalBAProblem, local_bundle_adjustment, pose_schur_blocks,
)
from gf_orb_slam2_tpu_torch.selection.anticipation import anticipated_subgraph_size
from gf_orb_slam2_tpu_torch.selection.good_graph import select_subgraph
from gf_orb_slam2_tpu_torch.slammap.store import MapStore
from gf_orb_slam2_tpu_torch.utils import tracing
from gf_orb_slam2_tpu_torch.utils.transfer import to_device, to_host

O_CAP = 12  # observation slots per point in the BA problem


@dataclasses.dataclass
class MappingStats:
    """Per-KF mapping log (reference: MappingLog Util.hpp:282)."""

    kf: int = -1
    n_culled_points: int = 0
    n_new_points: int = 0
    n_fused: int = 0
    n_culled_kfs: int = 0
    ba_cost: float = 0.0
    ba_kfs: int = 0
    ba_points: int = 0
    ba_discarded: bool = False  # solved, then dropped: the world moved meanwhile


def _inverse_intrinsics(K):
    """K⁻¹ of the upper-triangular intrinsics K [3,3], in closed form."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    one, zero = torch.ones_like(fx), torch.zeros_like(fx)
    Kinv = torch.stack([torch.stack([1.0 / fx, zero, -cx / fx]),
                        torch.stack([zero, 1.0 / fy, -cy / fy]),
                        torch.stack([zero, zero, one])])
    return Kinv


def triangulate_pairs(K, level_scales, R, t, uv, octave, desc, free):
    """Epipolar-guided matching + DLT for keyframe 0 of the stack against
    each of the others (reference: SearchForTriangulation ORBmatcher.cc:770
    + the gates of CreateNewMapPoints LocalMapping.cc:450-560).

    K [3,3]; level_scales [L]; R [1+B,3,3], t [1+B,3], uv [1+B,N,2],
    octave [1+B,N], desc [1+B,N,8] int32 words, free [1+B,N] bool (slots
    without a map point). Returns Xw [B,N,3], the matched slot in the
    neighbour best_idx [B,N] and the accept mask [B,N].
    """
    n_lvl = level_scales.shape[0]
    R1, t1, R2, t2 = R[0], t[0], R[1:], t[1:]
    uv1, uv2 = uv[0], uv[1:]
    # fundamental matrix F12 = K^-T [t12]x R12 K^-1, relative pose 1→2
    R12 = R1 @ R2.mT
    t12 = t1 - (R12 @ t2[..., None])[..., 0]
    Kinv = _inverse_intrinsics(K)
    F = Kinv.T @ (lie.hat(t12) @ R12) @ Kinv                    # [B,3,3]
    ones1 = torch.cat([uv1, torch.ones_like(uv1[:, :1])], -1)   # [N,3]
    l2 = torch.einsum("ni,bij->bnj", ones1, F)                  # [B,N,3] lines in image 2
    # epipolar distance of every kp2 to every line, written out per term (no
    # [B,N,N,3] intermediate)
    x2, y2 = uv2[:, None, :, 0], uv2[:, None, :, 1]
    num = torch.abs(l2[..., 0, None] * x2 + l2[..., 1, None] * y2 + l2[..., 2, None])
    den = torch.sqrt(l2[..., 0, None] ** 2 + l2[..., 1, None] ** 2 + 1e-12)
    sigma2 = level_scales[torch.clamp(octave[1:].long(), 0, n_lvl - 1)] ** 2   # [B,N]
    epi_ok = num / den < 3.84 * torch.sqrt(sigma2)[:, None, :]
    # the kernel takes a contiguous mask: broadcasting may hand back other strides
    mask = (epi_ok & free[0][None, :, None] & free[1:][:, None, :]).contiguous()
    best_idx, accept = [], []
    for b in range(R2.shape[0]):  # one fused best-2 search per KF pair
        bi, best, _ = hamming.distance_best2(desc[0], desc[1 + b], mask[b])
        acc = best <= matcher.TH_LOW
        best_idx.append(bi)
        accept.append(hamming.resolve_duplicates(bi, best, acc, uv2.shape[1]))
    best_idx, accept = torch.stack(best_idx), torch.stack(accept)
    P1 = triangulate.projection_matrix(K, R1, t1)
    P2 = triangulate.projection_matrix(K, R2, t2)[:, None]       # [B,1,3,4]
    uv2m = torch.gather(uv2, 1, best_idx[..., None].expand(-1, -1, 2))
    Xw = triangulate.triangulate_dlt(P1, P2, uv1, uv2m)
    s1 = level_scales[torch.clamp(octave[0].long(), 0, n_lvl - 1)] ** 2
    s2m = torch.gather(sigma2, 1, best_idx)
    ok = triangulate.triangulation_checks(
        Xw, R1, t1, R2[:, None], t2[:, None], uv1, uv2m, K, s1, s2m)
    return Xw, best_idx, accept & ok


def fuse_pairs(cam, level_scales, R, t, pt_pos, pt_valid, pt_desc,
               kp_uv, kp_oct, kp_valid, kp_desc):
    """Project each pair's points into its destination KF and find fusion
    candidates (reference: ORBmatcher::Fuse ORBmatcher.cc:937, radius 3.0,
    octave hint 0).

    R [B,3,3], t [B,3]; pt_* [B,P,..]; kp_* [B,N,..]. Returns the matched
    keypoint slot idx [B,P] (-1 none) and valid [B,P].
    """
    pc = lie.transform(R[:, None], t[:, None], pt_pos)          # [B,P,3]
    z = torch.where(torch.abs(pc[..., 2]) < 1e-8, 1e-8, pc[..., 2])
    uv = torch.stack([cam.fx * pc[..., 0] / z + cam.cx, cam.fy * pc[..., 1] / z + cam.cy], -1)
    in_img = ((uv[..., 0] >= 0) & (uv[..., 0] < cam.width)
              & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height) & (pc[..., 2] > 0))
    oct_hint = torch.zeros(pt_valid.shape[1], dtype=torch.int64, device=pt_valid.device)
    idx, valid = [], []
    for b in range(R.shape[0]):
        m = matcher.search_by_projection(
            uv[b], oct_hint, pt_valid[b] & in_img[b], pt_desc[b],
            kp_uv[b], kp_oct[b], kp_valid[b], kp_desc[b],
            radius=3.0, level_scales=level_scales, th=matcher.TH_LOW)
        idx.append(m.idx)
        valid.append(m.valid)
    return torch.stack(idx), torch.stack(valid)


def ba_solve(prob: LocalBAProblem, cfg: SystemConfig, free_cap: int,
             n_sel: int = None, generator=None, uniforms=None):
    """Local BA of `prob`; with `n_sel`, the good-graph path first: pose
    Schur blocks → Max-logDet selection of `n_sel` free KFs (slot 0, the new
    KF, kept first) → the unselected free KFs are held fixed for the solve.
    Returns (LocalBAResult, selected mask [K] or None)."""
    cam, lb, gg = cfg.camera, cfg.local_ba, cfg.good_graph
    args = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    sel = None
    if n_sel is not None:
        S = pose_schur_blocks(prob, *args)
        free = ~prob.kf_fixed & prob.kf_valid
        keep = torch.zeros_like(free)
        keep[0] = True
        sel = select_subgraph(S, free, n_sel, generator, lazier_factor=gg.lazier_factor,
                              always_keep=keep, n_max=int(gg.max_pool), uniforms=uniforms)
        prob = prob._replace(kf_fixed=prob.kf_fixed | (~sel & free))
    res = local_bundle_adjustment(prob, *args, iters_first=lb.iters_first,
                                  iters_second=lb.iters_second, free_cap=free_cap)
    return res, sel


class LocalMapper:
    TRI_BATCH = 10   # covisible KFs triangulated against per event
    FUSE_BATCH = 20  # (src, dst) fusion pairs per event

    def __init__(self, cfg: SystemConfig, store: MapStore, n_kp: int, level_scales,
                 device="cuda"):
        self.cfg = cfg
        self.store = store
        self.n_kp = n_kp
        self.device = torch.device(device)
        self.level_scales = np.asarray(level_scales, np.float32)
        self._scales_dev = torch.from_numpy(self.level_scales).to(self.device)
        cam = cfg.camera
        self._K = torch.tensor([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]],
                               dtype=torch.float32, device=self.device)
        self._generator = torch.Generator(device=self.device)
        self.recent_points: List[tuple] = []  # (point_id, birth_kf)
        self.stats: List[MappingStats] = []
        # host ms of each stage per event, from its span: refresh,
        # triangulate_fuse and local_ba (host gathering + upload + device +
        # download: each stage's time outside its write-back), writeback (both
        # stages' store updates), cull, hash (the MIH insert and table
        # selection; ~0 with hashing off)
        self.event_ms: List[dict] = []
        self.velocity_provider = None  # () -> 4x4 velocity or None (anticipation)
        self.mih = None  # the multi-index hash, set by System when hashing is on

    # ------------------------------------------------------------- pipeline
    def process_keyframe(self, kf: int, skip_ba: bool = False) -> MappingStats:
        """One keyframe through the mapping stages (reference:
        LocalMapping::Run LocalMapping.cc:120). Each stage takes store.lock
        around its host work and releases it across its device work, so this
        can run on the asynchronous mapping worker while tracking goes on.
        `skip_ba` is the reference's BA abort when more KFs are queued
        (LocalMapping.cc mbAbortBA): the worker sets it on the older KFs of a
        batch, whose covisibility window the newest KF's BA covers."""
        st = MappingStats(kf=kf)
        frame = int(self.store.kf_frame_id[kf])
        with tracing.timed("map.event", kf=kf, frame=frame, skip_ba=skip_ba):
            with tracing.timed("map.refresh") as refresh:
                st.n_culled_points = self.refresh(kf)
            with tracing.timed("map.triangulate_fuse") as tri:
                st.n_new_points, st.n_fused = self.create_and_fuse(kf)
            with tracing.timed("map.local_ba") as ba:
                if not skip_ba:
                    self.run_local_ba(kf, st)
            with tracing.timed("map.cull") as cull:
                st.n_culled_kfs = self.cull_keyframes(kf)
            with tracing.timed("map.hash") as hashing:
                if self.mih is not None:
                    inserted, evicted = self.update_hash_tables(kf)
                    hashing.set(inserted=inserted, evicted=evicted)
        # a stage's own time leaves out its write-back (its one child span)
        self.event_ms.append({
            "refresh": refresh.ms, "triangulate_fuse": tri.self_ms, "local_ba": ba.self_ms,
            "writeback": tri.child_ms + ba.child_ms, "cull": cull.ms, "hash": hashing.ms})
        self.stats.append(st)
        return st

    def refresh(self, kf: int) -> int:
        """Refresh the new KF's points and covisibility, then cull recently
        created points. Returns the number culled."""
        s = self.store
        with s.lock:
            refresh_points_batch(s, s.kf_point[kf], self.level_scales)
            s.update_connections(kf)
            return self.cull_recent_points(kf)

    # -------------------------------------------------------------- culling
    def cull_recent_points(self, kf: int) -> int:
        """Reference: MapPointCulling (LocalMapping.cc:325): recently created
        points must keep found/visible ≥ 0.25 and reach ≥3 observations
        within 2-3 KFs of creation."""
        s = self.store
        n_culled = 0
        keep = []
        for p, birth in self.recent_points:
            if not s.point_valid[p]:
                continue
            age = kf - birth
            ratio = s.point_found[p] / max(1, s.point_visible[p])
            if ratio < 0.25:
                s.erase_point(p)
                n_culled += 1
            elif age >= 2 and s.point_nobs[p] <= 2:
                s.erase_point(p)
                n_culled += 1
            elif age >= 3:
                pass  # graduated
            else:
                keep.append((p, birth))
        self.recent_points = keep
        return n_culled

    # ---------------------------------------------- triangulation + fusion
    def _tri_prepare(self, kf: int):
        """Covisible neighbours to triangulate against (baseline-checked for
        stereo, reference LocalMapping.cc:410) and the free-slot masks."""
        s = self.store
        neighbors = [int(k) for k in s.covisible_kfs(kf, self.TRI_BATCH)]
        if self.cfg.sensor != Sensor.MONOCULAR:
            neighbors = [kn for kn in neighbors
                         if np.linalg.norm(s.kf_center(kf) - s.kf_center(kn))
                         >= self.cfg.camera.baseline]
        free_k = (s.kf_point[kf] < 0) & s.kf_kp_valid[kf]
        if not neighbors or free_k.sum() == 0:
            return None
        free = np.stack([free_k] + [(s.kf_point[kn] < 0) & s.kf_kp_valid[kn]
                                    for kn in neighbors])
        return neighbors, free

    def _fuse_prepare(self, kf: int):
        """Fusion pairs kf→neighbour and neighbour→kf with each source KF's
        live points (at most n_kp per pair)."""
        s = self.store
        neighbors = [int(k) for k in s.covisible_kfs(kf, self.FUSE_BATCH // 2)]
        if not neighbors:
            return None
        pairs = ([(kf, kn) for kn in neighbors] + [(kn, kf) for kn in neighbors])
        pairs = pairs[: self.FUSE_BATCH]
        src_ids = np.full((len(pairs), self.n_kp), -1, np.int64)
        pts_list = []
        for bi, (src, _) in enumerate(pairs):
            pts = s.kf_point[src]
            pts = np.unique(pts[pts >= 0])
            pts = pts[s.point_valid[pts]][: self.n_kp]
            pts_list.append(pts)
            src_ids[bi, : pts.size] = pts
        return [dst for _, dst in pairs], src_ids, pts_list

    def create_and_fuse(self, kf: int):
        """Triangulation against the covisible KFs and neighbour fusion in
        one device stage: one upload, one download. The fusion pass covers
        the map as of this KF's insertion; points triangulated in this same
        call are fused at the NEXT KF event (the reference fuses them at
        once, LocalMapping.cc:634 — a one-KF delay postpones duplicate
        merging, it never loses it). Returns (created, fused)."""
        return self._triangulate_and_fuse(kf, True, True)

    def create_new_points(self, kf: int) -> int:
        """Triangulation alone (reference: CreateNewMapPoints
        LocalMapping.cc:370): the first half of `create_and_fuse`, one
        upload and one download. Returns the points created."""
        return self._triangulate_and_fuse(kf, True, False)[0]

    def fuse_neighbors(self, kf: int) -> int:
        """Neighbour fusion alone (reference: SearchInNeighbors
        LocalMapping.cc:634): kf's points projected into its covisible KFs
        and theirs into kf, duplicates merged. Returns the points fused."""
        return self._triangulate_and_fuse(kf, False, True)[1]

    def _triangulate_and_fuse(self, kf: int, do_tri: bool, do_fuse: bool):
        """The device stage of `create_and_fuse` with either half left out.
        Returns (created, fused)."""
        s = self.store
        with s.lock:
            # world version at assembly: a loop correction while the device
            # works moves the map, and the write-backs then discard
            v0 = s.big_change_idx
            tri = self._tri_prepare(kf) if do_tri else None
            fuse = self._fuse_prepare(kf) if do_fuse else None
            if tri is None and fuse is None:
                return 0, 0
            # one table of the event's KFs; both stages index into it
            kf_ids = sorted({kf, *(tri[0] if tri else []), *(fuse[0] if fuse else [])})
            row = {k: i for i, k in enumerate(kf_ids)}
            up = dict(R=s.kf_R[kf_ids], t=s.kf_t[kf_ids], uv=s.kf_uv[kf_ids],
                      oct=s.kf_octave[kf_ids], desc=s.kf_desc[kf_ids],
                      kpv=s.kf_kp_valid[kf_ids])
            if tri is not None:
                up["tri_rows"] = np.asarray([row[k] for k in [kf] + tri[0]], np.int64)
                up["tri_free"] = tri[1]
            if fuse is not None:
                dsts, src_ids, _ = fuse
                live = src_ids >= 0
                up["fuse_rows"] = np.asarray([row[k] for k in dsts], np.int64)
                up["pt_pos"] = s.point_pos[np.maximum(src_ids, 0)]
                up["pt_desc"] = s.point_desc[np.maximum(src_ids, 0)]
                up["pt_valid"] = live
        d = to_device(up, self.device)
        out = {}
        if tri is not None:
            r = d["tri_rows"]
            out["Xw"], out["tri_idx"], out["tri_ok"] = triangulate_pairs(
                self._K, self._scales_dev, d["R"][r], d["t"][r], d["uv"][r],
                d["oct"][r], d["desc"][r], d["tri_free"])
        if fuse is not None:
            r = d["fuse_rows"]
            out["fuse_idx"], out["fuse_ok"] = fuse_pairs(
                self.cfg.camera, self._scales_dev, d["R"][r], d["t"][r],
                d["pt_pos"], d["pt_valid"], d["pt_desc"],
                d["uv"][r], d["oct"][r], d["kpv"][r], d["desc"][r])
        h = to_host(out)
        created = fused = 0
        with tracing.timed("map.writeback"):
            if tri is not None:
                created = self._tri_writeback(kf, tri[0], h["Xw"], h["tri_idx"], h["tri_ok"], v0)
            if fuse is not None:
                dsts, _, pts_list = fuse
                fused = self._fuse_writeback(kf, pts_list, dsts, h["fuse_idx"], h["fuse_ok"], v0)
        return created, fused

    def _tri_writeback(self, kf, kns, Xw_b, idx2_b, ok_b, v0: int) -> int:
        s = self.store
        created = 0
        new_ids: List[int] = []
        with s.lock:
            if s.big_change_idx != v0:
                return 0  # the world moved while the device worked: discard
            for b, kn in enumerate(kns):
                i1s = np.nonzero(ok_b[b])[0]
                if i1s.size == 0:
                    continue
                i2s = idx2_b[b, i1s].astype(np.int64)
                # skip slots claimed by an earlier pair this round (or before)
                keep = (s.kf_point[kf, i1s] < 0) & (s.kf_point[kn, i2s] < 0)
                i1s, i2s = i1s[keep], i2s[keep]
                if i1s.size == 0:
                    continue
                ids = s.add_points_batch(Xw_b[b, i1s], s.kf_desc[kf, i1s], kf, kf, i1s)
                s.add_observations_batch(ids, kn, i2s)
                self.recent_points.extend((int(p), kf) for p in ids)
                new_ids.extend(int(p) for p in ids)
                created += int(i1s.size)
            if created:
                # one batched descriptor + normal/depth refresh for all new
                # points (reference: ComputeDistinctiveDescriptors +
                # UpdateNormalAndDepth per point, LocalMapping.cc:370)
                refresh_points_batch(s, np.asarray(new_ids), self.level_scales)
                s.update_connections(kf)
        return created

    def _fuse_writeback(self, kf, pts_list, dst_list, idx_b, ok_b, v0: int) -> int:
        s = self.store
        fused = 0
        with s.lock:
            if s.big_change_idx != v0:
                return 0  # the world moved while the device worked: discard
            for bi, (pts, dst) in enumerate(zip(pts_list, dst_list)):
                for r in np.nonzero(ok_b[bi])[0]:
                    p = int(pts[r]) if r < pts.size else -1
                    if p < 0 or not s.point_valid[p]:
                        continue
                    j = int(idx_b[bi, r])
                    q = int(s.kf_point[dst, j])
                    if q >= 0 and s.point_valid[q]:
                        if q != p:
                            # keep the more-observed point (reference Fuse)
                            if s.point_nobs[p] >= s.point_nobs[q]:
                                s.replace_point(q, p)
                            else:
                                s.replace_point(p, q)
                            fused += 1
                    else:
                        s.add_observation(p, dst, j)
            s.update_connections(kf)
        return fused

    # ------------------------------------------------------------ local BA
    def ba_assemble(self, kf: int):
        """The covisibility-window BA problem of `kf` as host arrays
        (reference: Optimizer::LocalBundleAdjustment Optimizer.cc:618 —
        window = kf + covisible KFs; fixed = other KFs observing the window's
        points). Returns None when there is nothing to adjust, else a dict
        with the LocalBAProblem fields (numpy), the KF and point ids, the
        window size, `free_cap` and `n_sel` (None unless the good-graph
        path applies)."""
        s = self.store
        # reference pool parity: up to 60 covisible KFs (Optimizer.h:45)
        K_CAP = min(max(self.cfg.good_graph.max_pool, 8), 60)
        window = [kf] + [int(k) for k in s.covisible_kfs(kf, K_CAP - 1)]
        window = window[:K_CAP]
        pts = np.unique(s.kf_point[window])
        pts = pts[pts >= 0]
        pts = pts[s.point_valid[pts]]
        P_CAP = min(self.cfg.capacity.max_local_points, self.cfg.local_ba.max_points)
        if pts.size > P_CAP:
            order = np.argsort(-s.point_nobs[pts], kind="stable")
            pts = pts[order[:P_CAP]]
        if pts.size == 0 or len(window) < 2:
            return None
        obs_kfs = s.obs_kf[pts]
        all_kfs = np.unique(obs_kfs[obs_kfs >= 0])
        in_window = set(window)
        fixed_kfs = [int(k) for k in all_kfs if k not in in_window][:K_CAP]
        kfs = window + fixed_kfs
        K = len(kfs)
        # observation table: global KF id → local index through a lookup
        # table, valid entries stable-compacted to the front, capped at O_CAP
        lut = np.full(int(s.obs_kf[pts].max(initial=0)) + 2, -1, np.int64)
        lut[np.asarray(kfs, np.int64)] = np.arange(K)
        okf_all = s.obs_kf[pts]                                     # [P,O_store]
        ki_all = np.where(okf_all >= 0, lut[np.maximum(okf_all, 0)], -1)
        in_win = ki_all >= 0
        order = np.argsort(~in_win, axis=1, kind="stable")[:, :O_CAP]
        obs_kf = np.take_along_axis(ki_all, order, 1)
        obs_valid = np.take_along_axis(in_win, order, 1)
        obs_slot = np.take_along_axis(s.obs_idx[pts], order, 1)
        obs_kf[~obs_valid] = -1
        obs_slot[~obs_valid] = -1
        okf_g = np.asarray(kfs, np.int64)[np.maximum(obs_kf, 0)]   # [P,O] global ids
        slot = np.maximum(obs_slot, 0)
        n_lvl = len(self.level_scales)
        inv_sig = 1.0 / self.level_scales ** 2
        oct_ = np.clip(s.kf_octave[okf_g, slot], 0, n_lvl - 1)
        kf_fixed = np.zeros(K, bool)
        kf_fixed[len(window):] = True
        if 0 in window:
            kf_fixed[window.index(0)] = True  # reference: KF 0 is always fixed
        gg = self.cfg.good_graph
        n_sel = None
        if gg.enabled and len(window) > gg.kf_thres:
            n_sel = gg.subgraph_size
            if gg.anticipation:
                vel = self.velocity_provider() if self.velocity_provider else None
                n_sel = anticipated_subgraph_size(s, self.cfg, s.kf_R[kf], s.kf_t[kf], vel)
        # free poses ⊆ window, so the compaction cap follows the window size
        free_cap = 32 if len(window) <= 32 else ((K_CAP + 4 + 7) // 8) * 8
        assert len(window) <= free_cap
        prob = dict(
            kf_R=s.kf_R[kfs], kf_t=s.kf_t[kfs], kf_fixed=kf_fixed, kf_valid=np.ones(K, bool),
            pt_pos=s.point_pos[pts], pt_valid=np.ones(pts.size, bool), obs_kf=obs_kf,
            obs_uv=np.where(obs_valid[..., None], s.kf_uv[okf_g, slot], 0.0).astype(np.float32),
            obs_ur=np.where(obs_valid, s.kf_u_right[okf_g, slot], -1.0).astype(np.float32),
            obs_inv_sigma2=np.where(obs_valid, inv_sig[oct_], 1.0).astype(np.float32),
            obs_valid=obs_valid)
        return dict(prob=prob, kfs=kfs, pts=pts, n_window=len(window),
                    free_cap=free_cap, n_sel=n_sel)

    def run_local_ba(self, kf: int, st: MappingStats):
        """Assemble the window's BA problem on the host, solve it on the
        device (good-graph selection first on windows above `kf_thres`), and
        write poses, points and outlier removals back."""
        s = self.store
        with s.lock:
            v0 = s.big_change_idx
            a = self.ba_assemble(kf)
        if a is None:
            return
        prob = LocalBAProblem(**to_device(a["prob"], self.device))
        generator = None
        if a["n_sel"] is not None:
            generator = self._generator
            generator.manual_seed(int(kf))
        res, sel = ba_solve(prob, self.cfg, a["free_cap"], a["n_sel"], generator)
        out = dict(kf_R=res.kf_R, kf_t=res.kf_t, pt_pos=res.pt_pos,
                   obs_inlier=res.obs_inlier, cost=res.final_cost)
        if sel is not None:
            out["sel"] = sel
        h = to_host(out)
        kfs, pts = a["kfs"], a["pts"]
        fixed = a["prob"]["kf_fixed"]
        if sel is not None:
            fixed = fixed | ~h["sel"]
            st.ba_kfs = int((~fixed).sum())
        else:
            st.ba_kfs = a["n_window"]
        obs_valid, obs_kf = a["prob"]["obs_valid"], a["prob"]["obs_kf"]
        with tracing.timed("map.writeback"), s.lock:
            if s.big_change_idx != v0:
                # a loop correction moved the map during the solve: writing
                # pre-correction poses back would undo it (the reference
                # aborts the BA, LocalMapping mbAbortBA)
                st.ba_discarded = True
                return
            for i, k in enumerate(kfs):
                if not fixed[i]:
                    s.set_kf_pose(k, h["kf_R"][i], h["kf_t"][i])
            live = s.point_valid[pts]  # points culled meanwhile stay dead
            s.point_pos[pts[live]] = h["pt_pos"][live]
            s.mark_dirty(pts[live])
            # outlier observation removal (reference: Optimizer.cc:1490-1520)
            bad_p, bad_o = np.nonzero(obs_valid & ~h["obs_inlier"] & live[:, None])
            for pi, o in zip(bad_p, bad_o):
                s.remove_observation(int(pts[pi]), int(kfs[obs_kf[pi, o]]))
        st.ba_cost = float(h["cost"])
        st.ba_points = int(pts.size)

    # --------------------------------------------------------- KF culling
    def cull_keyframes(self, kf: int) -> int:
        """Reference: KeyFrameCulling (LocalMapping.cc:910) — erase local KFs
        whose points are ≥90 % observed by ≥3 other KFs at same/finer scale."""
        s = self.store
        with s.lock:
            victims = redundant_keyframes(s, s.covisible_kfs(kf))
            for k in victims:
                s.erase_keyframe(k)
        return len(victims)

    def update_hash_tables(self, kf: int):
        """Insert this KF's (possibly new/updated) points into the MIH tables,
        then re-select the active tables (reference: UpdateHashTables
        LocalMapping.cc:948). Runs with store.lock held: tracking queries the
        same tables. Returns (points inserted, bucket entries evicted)."""
        mih = self.mih
        s = self.store
        evicted = 0
        with s.lock:
            pts = s.kf_point[kf]
            pts = np.unique(pts[pts >= 0])
            pts = pts[s.point_valid[pts]]
            if pts.size:
                evicted = mih.insert(s.point_desc[pts], pts.astype(np.int32))
            if self.cfg.hashing.online_table_selection:
                mih.update_table_selection()
        return int(pts.size), evicted

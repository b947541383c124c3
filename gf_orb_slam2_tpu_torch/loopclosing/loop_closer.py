"""Loop closing: detection, Sim3 verification, loop correction.

Replacement for the LoopClosing thread (reference: src/LoopClosing.cc:65
Run): BoW candidate retrieval with covisibility consistency over 3
consecutive KFs (DetectLoop :125), Sim3 RANSAC + guided verification
(ComputeSim3 :253), and loop correction — pose propagation over the
covisible neighbourhood, point fusion, essential-graph Sim3 optimization and
a detached, abortable global BA (CorrectLoop :424,
RunGlobalBundleAdjustment :667). One host pipeline stage per keyframe with
device stages for matching, Sim3 and the pose graph:

- `_compute_sim3`: per candidate, `match_all` (the Hamming matrix kernel 1a
  and both reductions, since the match is mutual), then Sim3 RANSAC on the
  draws of `sim3_draws` and its GN polish — one upload, one download;
- `_guided_refine`: `search_by_sim3` (the fused best-2 kernel 1b) over all
  mapped keypoints of both KFs, then a second GN polish;
- `_search_and_fuse`: the ≤ 20 destination KF rows and the loop side's
  point rows are gathered under the lock and sent up in one copy; one
  projection search (kernel 1b) per destination;
- `_optimize_essential_graph`: optim/pose_graph.py on the device;
- `_launch_global_ba`: optim/global_ba.py, inline or on a thread of its own.

Locking: host reads and writes hold `store.lock` (always `with`); device work
and downloads run without it, so tracking's bookkeeping goes on. A point's
id and its row are read in the same lock hold. Each device stage runs on the
calling thread's current CUDA stream (the System's loop worker has its own;
the detached GBA thread makes its own).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from gf_orb_slam2_tpu_torch.config import Sensor, SystemConfig
from gf_orb_slam2_tpu_torch.geometry import lie
from gf_orb_slam2_tpu_torch.loopclosing.sim3solver import draw_hypotheses, optimize_sim3, solve_sim3
from gf_orb_slam2_tpu_torch.matching import matcher
from gf_orb_slam2_tpu_torch.optim.global_ba import GlobalBARunner
from gf_orb_slam2_tpu_torch.optim.pose_graph import PoseGraphProblem, optimize_pose_graph
from gf_orb_slam2_tpu_torch.place.keyframe_db import KeyFrameDatabase
from gf_orb_slam2_tpu_torch.slammap.store import MapStore
from gf_orb_slam2_tpu_torch.utils import tracing
from gf_orb_slam2_tpu_torch.utils.transfer import to_device, to_host

GBA_THREAD = "gba"   # name of the detached global BA's thread
SIM3_POINTS = 256    # matched points per Sim3 problem
N_HYP = 128          # RANSAC hypotheses
FUSE_DSTS = 20       # destination KFs of one search-and-fuse
STAGES = ("detect", "sim3", "guided", "correct", "fuse", "essential_graph", "gba")


def _np_sim3_inv(s, R, t):
    """(s,R,t)⁻¹ = (1/s, Rᵀ, -(1/s)·Rᵀt) in numpy float32."""
    si = 1.0 / s
    Ri = R.T
    return si, Ri, (-si * (Ri @ t)).astype(np.float32)


def _np_sim3_compose(s1, R1, t1, s2, R2, t2):
    """(s1,R1,t1)∘(s2,R2,t2): x ↦ s1·R1(s2·R2 x + t2) + t1."""
    return (float(s1 * s2), (R1 @ R2).astype(np.float32),
            (s1 * (R1 @ t2) + t1).astype(np.float32))


@dataclasses.dataclass
class LoopStats:
    kf: int = -1
    n_candidates: int = 0
    loop_kf: int = -1
    n_sim3_inliers: int = 0
    corrected: bool = False
    pg_cost: float = 0.0
    n_fused: int = 0


class LoopCloser:
    def __init__(self, cfg: SystemConfig, store: MapStore, kfdb: KeyFrameDatabase,
                 device="cuda"):
        self.cfg = cfg
        self.store = store
        self.kfdb = kfdb
        self.device = torch.device(device)
        # consistency groups: (set of KFs, count) (reference:
        # mvConsistentGroups LoopClosing.cc:216)
        self._consistent: List[Tuple[Set[int], int]] = []
        self.last_loop_kf: int = -1
        self.fix_scale = cfg.sensor != Sensor.MONOCULAR
        cam = cfg.camera
        self._scales_dev = torch.tensor([cfg.orb.scale_factor ** i for i in range(cfg.orb.n_levels)],
                                        dtype=torch.float32, device=self.device)
        self._cam = (cam.fx, cam.fy, cam.cx, cam.cy)
        self.stats: List[LoopStats] = []
        self.event_ms: List[Dict[str, float]] = []  # host ms per stage of each event
        # detached global BA (reference: LoopClosing.cc:601 spawns a thread;
        # mbStopGBA aborts it when a new loop arrives)
        self._gba_thread = None
        self._gba_abort = False
        self.gba_error = None
        self.last_gba = None         # the last GlobalBARunner built
        self.last_pose_graph = None  # the last essential graph, as host arrays
        # RANSAC draws of candidate c for keyframe kf: (kf, c, n_valid) →
        # [N_HYP,3] indices into the valid points; by default from a torch
        # generator seeded kf·1000 + c (the JAX package seeds its PRNG key so)
        self.sim3_draws = self._seeded_draws
        self._draw_gen = torch.Generator()
        # diagnostics: called with the Sim3 stage inputs/outputs of each
        # candidate evaluation; None in production
        self.sim3_debug_hook = None
        # set by System: tracker.notify_map_rebase (called with store.lock
        # held) — live tracking learns that the world around it moved
        self.map_rebase_cb = None
        self.gba_writeback_cb = None
        # set by System with async mapping: pause/resume the mapping worker
        # around a correction (reference: LocalMapping::RequestStop/Release,
        # LoopClosing.cc:439/604)
        self.pause_mapping_cb = None
        self.resume_mapping_cb = None

    def warm_up(self) -> float:
        """Run each device stage once on a tiny made-up problem, so that the
        first real loop event does not pay the device's one-time set-up
        (solver libraries, the forward-mode autodiff machinery) in the middle
        of a sequence — the analogue of the reference starting its
        LoopClosing thread at construction (System.cc:117). Changes no
        state. Returns its host milliseconds."""
        t0 = time.perf_counter()
        fx, fy, cx, cy = self._cam
        gen = torch.Generator().manual_seed(0)
        n = 16
        pc1 = torch.rand((n, 3), generator=gen) + torch.tensor([0.0, 0.0, 4.0])
        desc = torch.randint(-2**31, 2**31 - 1, (n, 8), generator=gen, dtype=torch.int64)
        d = to_device(dict(pc1=pc1.numpy(), desc=desc.to(torch.int32).numpy(),
                           valid=np.ones(n, bool), draws=self._seeded_draws(0, 0, n).numpy()),
                      self.device)
        pc2 = d["pc1"] + 0.01
        m = matcher.match_all(d["desc"], d["valid"], d["desc"], d["valid"], nn_ratio=0.75)
        res = solve_sim3(d["pc1"], pc2, d["valid"], fx, fy, cx, cy, draws=d["draws"],
                         fix_scale=self.fix_scale, n_hyp=N_HYP)
        s_o, R_o, t_o, _ = optimize_sim3(res.s, res.R, res.t, d["pc1"], pc2, res.inliers,
                                         fx, fy, cx, cy, fix_scale=self.fix_scale, iters=1)
        g = matcher.search_by_sim3(s_o, R_o, t_o, d["pc1"], pc2, d["desc"], d["desc"],
                                   d["valid"], d["valid"], self._project)
        eye = torch.eye(3, device=self.device).expand(2, 3, 3)
        two = torch.ones(2, device=self.device)
        one = torch.ones(1, device=self.device)
        pg = PoseGraphProblem(
            s=two, R=eye, t=torch.zeros((2, 3), device=self.device),
            fixed=torch.tensor([True, False], device=self.device), valid=two > 0,
            e_i=torch.zeros(1, dtype=torch.int64, device=self.device),
            e_j=torch.ones(1, dtype=torch.int64, device=self.device), e_s=one, e_R=eye[:1],
            e_t=torch.full((1, 3), 0.1, device=self.device), e_w=one,
            fix_scale=self.fix_scale)
        to_host(dict(m=m.idx, g=g.idx, pg=optimize_pose_graph(pg, iters=1)[3]))
        return (time.perf_counter() - t0) * 1e3

    def _seeded_draws(self, kf: int, c: int, n_valid: int):
        self._draw_gen.manual_seed(int(kf) * 1000 + int(c))
        return draw_hypotheses(n_valid, self._draw_gen, N_HYP)

    def _project(self, p):
        fx, fy, cx, cy = self._cam
        z = torch.clamp(p[..., 2], min=1e-6)
        return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], -1), p[..., 2]

    # ------------------------------------------------------------- pipeline
    def process_keyframe(self, kf: int) -> LoopStats:
        """One keyframe through detection and, on a verified loop, the
        correction. Takes store.lock itself, in phases; callers must not hold
        it (the mapper's current batch may need it to finish)."""
        st = LoopStats(kf=kf)
        self.stats.append(st)
        ms = dict.fromkeys(STAGES, 0.0)
        self.event_ms.append(ms)
        with tracing.timed("loop.event", kf=kf, frame=int(self.store.kf_frame_id[kf])) as ev:
            with tracing.timed("loop.detect"), self.store.lock:
                cands = self._detect_loop(kf, st)
                self.kfdb.add(kf)
            hit = self._compute_sim3(kf, cands, st) if cands else None
            if hit is not None:
                loop_kf, s12, R12, t12, n_inl = hit
                st.loop_kf = loop_kf
                st.n_sim3_inliers = n_inl
                self._correct_loop(kf, loop_kf, s12, R12, t12, st)
        # each stage's time summed over the event's child spans of its name
        for name, ns in ev.kids.items():
            ms[name[len("loop."):]] = ns / 1e6
        return st

    # ------------------------------------------------------------ detection
    def _detect_loop(self, kf: int, st: LoopStats) -> List[int]:
        s = self.store
        if kf < 10 or (self.last_loop_kf >= 0 and kf - self.last_loop_kf < 10):
            return []
        min_score = self.kfdb.min_covis_score(kf)
        cands = self.kfdb.detect_loop_candidates(kf, max(min_score, 1e-3))
        # temporal exclusion (LoopClosingConfig.min_frame_gap): a loop partner
        # must be genuinely old, not a weakly covisible neighbour
        gap = self.cfg.loop.min_frame_gap
        cands = [c for c in cands if s.kf_frame_id[kf] - s.kf_frame_id[c] >= gap]
        st.n_candidates = len(cands)
        if not cands:
            self._consistent = []
            return []
        # covisibility consistency over consecutive detections (reference:
        # LoopClosing.cc:160-250, threshold 3)
        th = self.cfg.loop.covisibility_consistency_th
        enough: List[int] = []
        new_groups: List[Tuple[Set[int], int]] = []
        for c in cands:
            group = set(int(x) for x in s.covisible_kfs(c))
            group.add(c)
            matched = False
            for prev_group, count in self._consistent:
                if group & prev_group:
                    new_groups.append((group, count + 1))
                    matched = True
                    if count + 1 >= th:
                        enough.append(c)
                    break
            if not matched:
                new_groups.append((group, 1))
        self._consistent = new_groups
        return enough

    # ------------------------------------------------------ sim3 computation
    def _kf_snapshot(self, k: int) -> dict:
        """A KF's descriptors, keypoint validity, point ids AND their rows
        (validity, position) plus its pose, read in one lock hold."""
        s = self.store
        ids = s.kf_point[k].copy()
        has = ids >= 0
        idc = np.maximum(ids, 0)
        return dict(desc=s.kf_desc[k].copy(), val=has & s.kf_kp_valid[k], ids=ids,
                    pt_valid=has & s.point_valid[idc], pos=s.point_pos[idc],
                    R=s.kf_R[k].copy(), t=s.kf_t[k].copy())

    def _compute_sim3(self, kf: int, cands: List[int], st: LoopStats):
        s = self.store
        lc = self.cfg.loop
        fx, fy, cx, cy = self._cam
        for c in cands:
            with tracing.timed("loop.sim3", cand=c):
                with s.lock:
                    a, b = self._kf_snapshot(kf), self._kf_snapshot(c)
                # descriptor matches between map-point-bearing keypoints
                d = to_device(dict(da=a["desc"], va=a["val"], db=b["desc"], vb=b["val"]),
                              self.device)
                m = matcher.match_all(d["da"], d["va"], d["db"], d["vb"],
                                      th=matcher.TH_LOW, nn_ratio=0.75, mutual=True)
                h = to_host(dict(idx=m.idx, ok=m.valid))
                idx = h["idx"]
                rows = np.nonzero(h["ok"])[0]
                if rows.size < lc.min_sim3_inliers:
                    continue
                good = a["pt_valid"][rows] & b["pt_valid"][idx[rows]]
                rows = rows[good]
                if rows.size < lc.min_sim3_inliers:
                    continue
                n = min(rows.size, SIM3_POINTS)
                pc1 = np.zeros((SIM3_POINTS, 3), np.float32)
                pc2 = np.zeros((SIM3_POINTS, 3), np.float32)
                val = np.zeros(SIM3_POINTS, bool)
                pc1[:n] = a["pos"][rows[:n]] @ a["R"].T + a["t"]
                pc2[:n] = b["pos"][idx[rows[:n]]] @ b["R"].T + b["t"]
                val[:n] = True
                draws = np.asarray(self.sim3_draws(kf, c, n), np.int64)
                d = to_device(dict(pc1=pc1, pc2=pc2, val=val, draws=draws), self.device)
                res = solve_sim3(d["pc1"], d["pc2"], d["val"], fx, fy, cx, cy, draws=d["draws"],
                                 fix_scale=self.fix_scale, n_hyp=N_HYP,
                                 min_inliers=lc.min_sim3_inliers)
                # GN polish (reference: OptimizeSim3 between RANSAC and the guided
                # verification, LoopClosing.cc:380), always computed
                s_o, R_o, t_o, inl_o = optimize_sim3(res.s, res.R, res.t, d["pc1"], d["pc2"],
                                                     res.inliers, fx, fy, cx, cy,
                                                     fix_scale=self.fix_scale)
                h = to_host(dict(ok=res.ok, s=s_o, R=R_o, t=t_o, inl=inl_o))
            if not bool(h["ok"]):
                continue
            n_o = int(h["inl"].sum())
            if n_o < lc.min_sim3_inliers:
                continue
            # guided cross-projection verification over ALL mapped keypoints
            # + a second GN polish on that match set (reference: SearchBySim3
            # + OptimizeSim3 + the ≥ 40 matches gate, LoopClosing.cc:380-422)
            with tracing.timed("loop.guided", cand=c):
                n_total, s_r, R_r, t_r, n_inl2 = self._guided_refine(kf, c, h["s"], h["R"],
                                                                     h["t"])
            if self.sim3_debug_hook is not None:
                self.sim3_debug_hook(
                    kf=kf, c=c, pc1=pc1, pc2=pc2, val=val,
                    ransac=(float(h["s"]), h["R"], h["t"], h["inl"]),
                    refined=(s_r, R_r, t_r, n_inl2, n_total))
            if n_total < lc.min_total_matches:
                continue
            # the Sim3 maps kf-camera coords → candidate-camera coords
            return c, s_r, R_r, t_r, max(n_o, n_inl2)
        return None

    def _guided_refine(self, kf: int, c: int, s12, R12, t12):
        """Guided two-way Sim3 matching over all mapped keypoints + GN
        refinement on the match set (reference: ORBmatcher::SearchBySim3
        ORBmatcher.cc:406 + the second OptimizeSim3, LoopClosing.cc:389-399).
        Returns (n_matches, s, R, t, n_refine_inliers)."""
        s = self.store
        fx, fy, cx, cy = self._cam

        def kf_points(k):
            slots = s.kf_point[k]
            ids = np.maximum(slots, 0)
            valid = (slots >= 0) & s.kf_kp_valid[k] & s.point_valid[ids]
            pc = s.point_pos[ids] @ s.kf_R[k].T + s.kf_t[k]
            return pc.astype(np.float32), s.kf_desc[k].copy(), valid

        with s.lock:
            pc1, d1, v1 = kf_points(kf)
            pc2, d2, v2 = kf_points(c)
        d = to_device(dict(s=np.float32(s12), R=np.asarray(R12, np.float32),
                           t=np.asarray(t12, np.float32), pc1=pc1, pc2=pc2, d1=d1, d2=d2,
                           v1=v1, v2=v2), self.device)
        m = matcher.search_by_sim3(d["s"], d["R"], d["t"], d["pc1"], d["pc2"], d["d1"], d["d2"],
                                   d["v1"], d["v2"], self._project)
        p2m = d["pc2"][torch.clamp(m.idx, min=0)]
        s_r, R_r, t_r, inl = optimize_sim3(d["s"], d["R"], d["t"], d["pc1"], p2m, m.valid,
                                           fx, fy, cx, cy, fix_scale=self.fix_scale)
        h = to_host(dict(n=m.valid.sum(), s=s_r, R=R_r, t=t_r, n_inl=inl.sum()))
        return int(h["n"]), float(h["s"]), h["R"], h["t"], int(h["n_inl"])

    # ----------------------------------------------------- loop correction
    def _correct_loop(self, kf: int, loop_kf: int, s12, R12, t12, st: LoopStats):
        """Reference: CorrectLoop (LoopClosing.cc:424) + OptimizeEssentialGraph.

        Convention (pinned by tests/test_torch_sim3.py, as the JAX package's
        tests/test_sim3.py::test_correct_loop_convention): (s12, R12, t12)
        maps CURRENT-KF camera coords into LOOP-KF camera coords, so the
        corrected world→camera Sim3 of the current KF is
        S_cw(kf) = S12⁻¹ ∘ T_cw(loop_kf) (the reference's
        mScw = gScm · T_cw(matched), LoopClosing.cc:300-420)."""
        # a running detached GBA solves against the pre-correction map: abort
        # it FIRST (reference: mbStopGBA, LoopClosing.cc:437), outside the
        # lock — its write-back may be waiting for the lock
        self.abort_gba()
        # stop mapping for the correction (without store.lock: the mapper's
        # current batch needs it to finish)
        paused = self.pause_mapping_cb is not None
        if paused:
            self.pause_mapping_cb()
        try:
            self._correct_loop_impl(kf, loop_kf, s12, R12, t12, st)
        finally:
            if paused and self.resume_mapping_cb is not None:
                self.resume_mapping_cb()

    def _correct_loop_impl(self, kf, loop_kf, s12, R12, t12, st):
        s = self.store
        with tracing.timed("loop.correct"), s.lock:
            # pre-correction pose snapshot: the essential graph measures its
            # edges on the poses as they were (reference: NonCorrectedSim3,
            # Optimizer.cc:2338)
            snap_R = s.kf_R.copy()
            snap_t = s.kf_t.copy()
            si, Ri, ti = _np_sim3_inv(float(s12), np.asarray(R12), np.asarray(t12))
            s_corr, R_corr, t_corr = _np_sim3_compose(si, Ri, ti, 1.0, s.kf_R[loop_kf],
                                                      s.kf_t[loop_kf])
            # propagate the correction over the covisible neighbourhood
            neighborhood = [kf] + [int(x) for x in s.covisible_kfs(kf)]
            old_R = {k: s.kf_R[k].copy() for k in neighborhood}
            old_t = {k: s.kf_t[k].copy() for k in neighborhood}
            corr_s: Dict[int, float] = {}
            moved_mask = np.zeros(s.cap.max_map_points, bool)
            for k in neighborhood:
                # pose relative to kf before the correction: T_k ∘ T_kf⁻¹
                R_rel = old_R[k] @ old_R[kf].T
                t_rel = old_t[k] - R_rel @ old_t[kf]
                sk, Rk, tk = _np_sim3_compose(1.0, R_rel, t_rel, s_corr, R_corr, t_corr)
                corr_s[k] = sk
                # this KF's points: X_new = S_new⁻¹(T_old(X))
                pts = s.kf_point[k]
                pts = np.unique(pts[pts >= 0])
                pts = pts[s.point_valid[pts] & ~moved_mask[pts]]
                if pts.size:
                    pc = s.point_pos[pts] @ old_R[k].T + old_t[k]
                    s_inv, R_inv, t_inv = _np_sim3_inv(sk, Rk, tk)
                    s.point_pos[pts] = s_inv * (pc @ R_inv.T) + t_inv
                    s.mark_dirty(pts)
                    moved_mask[pts] = True
                s.set_kf_pose(k, Rk, tk / sk)
            s.kf_loop_edges.setdefault(kf, set()).add(loop_kf)
            s.kf_loop_edges.setdefault(loop_kf, set()).add(kf)
            # invalidate in-flight solves assembled against the old world (the
            # mapper's write-backs compare this version: the reference's
            # mbAbortBA)
            s.big_change_idx += 1
            # rebase live tracking in the SAME lock hold: the tracker must
            # never see moved points with an un-rebased state
            if self.map_rebase_cb is not None:
                R_old, t_old = snap_R[kf], snap_t[kf]
                R_new, t_new = s.kf_R[kf], s.kf_t[kf]
                self.map_rebase_cb(R_new.T @ R_old, R_new.T @ (t_old - t_new))
        # project the loop side's points into the corrected neighbourhood and
        # fuse duplicates (reference: SearchAndFuse LoopClosing.cc:609)
        with tracing.timed("loop.fuse"):
            st.n_fused = self._search_and_fuse(kf, loop_kf, neighborhood)
        with tracing.timed("loop.essential_graph"):
            self._optimize_essential_graph(kf, loop_kf, corr_s, st, snap_R, snap_t,
                                           (float(s12), np.asarray(R12), np.asarray(t12)))
        # full BA, detached and abortable (reference: LoopClosing.cc:601),
        # launched OUTSIDE the store lock: abort_gba joins the previous GBA
        # thread, which may be waiting for the lock in its write-back
        with tracing.timed("loop.gba"):
            self._launch_global_ba()
        self.last_loop_kf = kf
        st.corrected = True

    # --------------------------------------------------------- search & fuse
    def _search_and_fuse(self, kf: int, loop_kf: int, neighborhood: List[int]) -> int:
        """Project the loop side's map points into each corrected
        neighbourhood KF and merge duplicates, keeping the LOOP point
        (reference: SearchAndFuse LoopClosing.cc:609 → ORBmatcher::Fuse,
        ORBmatcher.cc:1089, pRep->Replace(pLoopMP))."""
        s = self.store
        cam = self.cfg.camera
        with s.lock:
            # loop-side point pool: the loop KF + its covisible neighbourhood
            loop_side = [loop_kf] + [int(x) for x in s.covisible_kfs(loop_kf, 10)]
            pts = np.unique(s.kf_point[loop_side])
            pts = pts[pts >= 0]
            pts = pts[s.point_valid[pts]]
            if pts.size == 0:
                return 0
            if pts.size > s.n_kp:
                order = np.argsort(-s.point_nobs[pts], kind="stable")
                pts = np.sort(pts[order[: s.n_kp]])
            dsts = list(neighborhood)[:FUSE_DSTS]
            up = dict(R=s.kf_R[dsts], t=s.kf_t[dsts], uv=s.kf_uv[dsts], oct=s.kf_octave[dsts],
                      kpv=s.kf_kp_valid[dsts], desc=s.kf_desc[dsts],
                      pos=s.point_pos[pts], pdesc=s.point_desc[pts])
        d = to_device(up, self.device)
        pc = lie.transform(d["R"][:, None], d["t"][:, None], d["pos"])      # [B,P,3]
        z = torch.where(torch.abs(pc[..., 2]) < 1e-8, 1e-8, pc[..., 2])
        uv = torch.stack([cam.fx * pc[..., 0] / z + cam.cx, cam.fy * pc[..., 1] / z + cam.cy], -1)
        in_img = ((uv[..., 0] >= 0) & (uv[..., 0] < cam.width)
                  & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height) & (pc[..., 2] > 0))
        oct_hint = torch.zeros(pts.size, dtype=torch.int64, device=self.device)
        idx, ok = [], []
        for b in range(len(dsts)):  # one fused best-2 search per destination
            m = matcher.search_by_projection(
                uv[b], oct_hint, in_img[b], d["pdesc"], d["uv"][b], d["oct"][b], d["kpv"][b],
                d["desc"][b], radius=4.0, level_scales=self._scales_dev, th=matcher.TH_LOW)
            idx.append(m.idx)
            ok.append(m.valid)
        h = to_host(dict(idx=torch.stack(idx), ok=torch.stack(ok)))
        fused = 0
        with s.lock:
            for bi, dst in enumerate(dsts):
                for r in np.nonzero(h["ok"][bi])[0]:
                    p = int(pts[r])
                    if not s.point_valid[p]:
                        continue
                    j = int(h["idx"][bi, r])
                    q = int(s.kf_point[dst, j])
                    if q >= 0 and s.point_valid[q]:
                        if q != p:
                            s.replace_point(q, p)  # the reference keeps the loop point
                            fused += 1
                    else:
                        s.add_observation(p, dst, j)
            for k in neighborhood:
                s.update_connections(k)
        return fused

    # ----------------------------------------------------------- global BA
    def _launch_global_ba(self):
        """Detached abortable full-map BA (reference: LoopClosing.cc:601);
        inline with `loop.synchronous_gba`."""
        self.abort_gba()  # a new loop supersedes a running GBA
        runner = GlobalBARunner(self.store, self.cfg, device=self.device)
        if not runner.build():
            return
        self.last_gba = runner
        self._gba_abort = False

        def run():
            with tracing.span("gba.run"):
                if runner.solve(lambda: self._gba_abort):
                    runner.write_back(post_cb=self.gba_writeback_cb)

        if self.cfg.loop.synchronous_gba:
            run()
            return

        def detached():
            try:
                if self.device.type == "cuda":
                    with torch.cuda.stream(torch.cuda.Stream(self.device)):
                        run()
                else:
                    run()
            except Exception as e:  # raised by the next wait_gba()
                self.gba_error = e

        self._gba_thread = threading.Thread(target=detached, name=GBA_THREAD, daemon=True)
        self._gba_thread.start()

    def abort_gba(self):
        if self._gba_thread is not None and self._gba_thread.is_alive():
            self._gba_abort = True
            self._gba_thread.join()
        self._gba_thread = None

    def wait_gba(self):
        """Join a running detached GBA; raise what failed in it."""
        if self._gba_thread is not None:
            self._gba_thread.join()
            self._gba_thread = None
        if self.gba_error is not None:
            e, self.gba_error = self.gba_error, None
            raise e

    # ------------------------------------------------------- essential graph
    def _essential_graph(self, kf, loop_kf, corr_s, snap_R, snap_t, loop_sim3):
        """The essential graph over all valid KFs as host arrays (store.lock
        held), or None: vertices at the current (corrected) poses, edges
        measured on the pre-correction snapshot; returns (problem, kfs)."""
        s = self.store
        kfs = np.asarray(s.valid_kf_ids(), np.int64)
        K = int(kfs.size)
        if K < 2:
            return None
        # dense vertex ids: vertex v ← kfs[v]
        lut = np.full(int(kfs.max()) + 2, -1, np.int64)
        lut[kfs] = np.arange(K)
        e_i, e_j, e_R, e_t, e_s, e_w = [], [], [], [], [], []

        def add_edge(i, j, w=1.0, meas=None):
            """meas = (s_rel, R_rel, t_rel), the Sim3 i←j; default: from the
            snapshot."""
            if meas is None:
                R_rel = snap_R[i] @ snap_R[j].T
                meas = (1.0, R_rel, snap_t[i] - R_rel @ snap_t[j])
            e_i.append(lut[i])
            e_j.append(lut[j])
            e_s.append(meas[0])
            e_R.append(meas[1])
            e_t.append(meas[2])
            e_w.append(w)

        seen = {(min(kf, loop_kf), max(kf, loop_kf))}
        # the new loop edge S_kf ∘ S_loop⁻¹ = S12⁻¹, measured by the Sim3
        # solver, scale included
        add_edge(kf, loop_kf, 5.0, meas=_np_sim3_inv(*loop_sim3))
        min_w = self.cfg.loop.essential_graph_min_weight
        for k in kfs:
            k = int(k)
            parent = int(s.kf_parent[k])
            if parent >= 0 and s.kf_valid[parent]:
                if (min(k, parent), max(k, parent)) not in seen:
                    add_edge(k, parent, 1.0)
                    seen.add((min(k, parent), max(k, parent)))
            for nb in s.covisible_kfs(k):
                nb = int(nb)
                if s.covis[k, nb] >= min_w and (min(k, nb), max(k, nb)) not in seen:
                    add_edge(k, nb, 1.0)
                    seen.add((min(k, nb), max(k, nb)))
            for le in s.kf_loop_edges.get(k, ()):  # loop edges, strong weight
                if (min(k, le), max(k, le)) not in seen and s.kf_valid[le]:
                    add_edge(k, le, 5.0)
                    seen.add((min(k, le), max(k, le)))
        fixed = np.zeros(K, bool)
        fixed[lut[loop_kf]] = True  # the reference fixes the loop KF
        s_init = np.ones(K, np.float32)
        t_init = s.kf_t[kfs].copy()
        if not self.fix_scale:
            # CorrectedSim3 seed: a corrected KF's stored SE3 is (R, t/s_k),
            # its Sim3 vertex (s_k, R, t)
            for k, sk in corr_s.items():
                v = lut[k] if k < lut.size else -1
                if v >= 0:
                    s_init[v] = np.float32(sk)
                    t_init[v] = s.kf_t[k] * np.float32(sk)
        prob = dict(s=s_init, R=s.kf_R[kfs].copy(), t=t_init, fixed=fixed,
                    valid=np.ones(K, bool), e_i=np.asarray(e_i, np.int64),
                    e_j=np.asarray(e_j, np.int64), e_s=np.asarray(e_s, np.float32),
                    e_R=np.stack(e_R).astype(np.float32), e_t=np.stack(e_t).astype(np.float32),
                    e_w=np.asarray(e_w, np.float32))
        return prob, kfs

    def _optimize_essential_graph(self, kf: int, loop_kf: int, corr_s, st: LoopStats,
                                  snap_R, snap_t, loop_sim3):
        """Sim3 essential-graph optimization (reference:
        Optimizer::OptimizeEssentialGraph Optimizer.cc:2338, from CorrectLoop
        LoopClosing.cc:532): edge measurements from the PRE-correction
        snapshot (NonCorrectedSim3), vertices at the corrected poses (the
        corrected neighbourhood seeded with its scale, inert with fixed
        scale), the new loop edge from the Sim3 solver, the loop KF fixed.
        Built under the lock, solved without it, written back under it."""
        s = self.store
        with s.lock:
            built = self._essential_graph(kf, loop_kf, corr_s, snap_R, snap_t, loop_sim3)
        if built is None:
            return
        host, kfs = built
        self.last_pose_graph = dict(host, fix_scale=self.fix_scale)
        prob = PoseGraphProblem(**to_device(host, self.device), fix_scale=self.fix_scale)
        s_d, R_d, t_d, cost = optimize_pose_graph(prob, iters=15)
        h = to_host(dict(s=s_d, R=R_d, t=t_d, cost=cost))
        with s.lock:
            st.pg_cost = float(h["cost"])
            pre_R_kf = s.kf_R[kf].copy()
            pre_t_kf = s.kf_t[kf].copy()
            # points move with their first corrected KF
            moved_mask = np.zeros(s.cap.max_map_points, bool)
            for v, k in enumerate(kfs):
                k = int(k)
                if not s.kf_valid[k]:
                    continue  # culled while the solve ran
                R_old, t_old = s.kf_R[k].copy(), s.kf_t[k].copy()
                R_new, t_new = h["R"][v], h["t"][v] / max(h["s"][v], 1e-9)
                pts = s.kf_point[k]
                pts = np.unique(pts[pts >= 0])
                pts = pts[s.point_valid[pts] & ~moved_mask[pts]]
                if pts.size:
                    pc = s.point_pos[pts] @ R_old.T + t_old
                    s.point_pos[pts] = (pc - t_new) @ R_new
                    s.mark_dirty(pts)
                    moved_mask[pts] = True
                s.set_kf_pose(k, R_new, t_new)
            s.big_change_idx += 1  # invalidate in-flight solves (mbAbortBA)
            # the essential graph moved the anchor KF a little further: tell
            # tracking the delta on top of the rigid correction
            if self.map_rebase_cb is not None:
                R_new, t_new = s.kf_R[kf], s.kf_t[kf]
                self.map_rebase_cb(R_new.T @ pre_R_kf, R_new.T @ (pre_t_kf - t_new))

"""Full-map (global) bundle adjustment — abortable, all keyframes.

Replacement for Optimizer::GlobalBundleAdjustemnt / BundleAdjustment
(reference: src/Optimizer.cc:51/:58) and the post-loop
RunGlobalBundleAdjustment thread (src/LoopClosing.cc:601,667-780):

- covers ALL keyframes: when the map exceeds the dense-solve window, the
  trajectory is cut into overlapping windows solved in turn (poses shared
  with an already solved window enter fixed — a domain decomposition of the
  pose graph; the reference solves one large sparse system instead);
- abortable between device segments (reference: mbStopGBA checked inside
  the g2o iterations): `solve(should_abort)` runs each window as short LM
  segments of optim/local_ba.py and stops between them;
- snapshot / write-back: `build()` snapshots the windows' problems under the
  store lock, `solve()` runs WITHOUT the lock (tracking and mapping go on),
  `write_back()` takes the lock again and re-anchors keyframes created
  during the solve through the spanning tree and unsolved points through
  their keyframes (LoopClosing.cc:720-780).

Each window's problem has its exact sizes (K keyframes, P points; the JAX
package pads both to compile fewer programs) and goes up in one copy; its
results come down in one synchronization after its last segment.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from gf_orb_slam2_tpu_torch.optim.local_ba import LocalBAProblem, local_bundle_adjustment
from gf_orb_slam2_tpu_torch.slammap.store import MapStore
from gf_orb_slam2_tpu_torch.utils.transfer import to_device, to_host


def solve_segments(prob: LocalBAProblem, cam, n_seg: int, segment_iters: int,
                   should_stop=None):
    """One window's schedule: `n_seg` LM segments of `segment_iters`
    iterations (the first before the outlier gate, the rest after it), each
    starting from the last; `should_stop()` is asked before each segment.
    Returns the last LocalBAResult, or None if stopped."""
    res = None
    for seg in range(n_seg):
        if should_stop is not None and should_stop():
            return None
        first, second = (segment_iters, 0) if seg == 0 else (0, segment_iters)
        res = local_bundle_adjustment(prob, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                                      iters_first=first, iters_second=second)
        prob = prob._replace(kf_R=res.kf_R, kf_t=res.kf_t, pt_pos=res.pt_pos)
    return res


class GlobalBARunner:
    def __init__(self, store: MapStore, cfg, iters: int = 20,
                 window_kfs: int = 96, max_points: int = 24576,
                 obs_cap: int = 12, segment_iters: int = 5, device="cuda"):
        self.store = store
        self.cfg = cfg
        self.iters = iters
        self.window_kfs = window_kfs
        self.max_points = max_points
        self.obs_cap = obs_cap
        self.segment_iters = segment_iters
        self.device = device
        self.aborted = False
        self._windows = []      # (kfs, pts, fixed, problem as numpy arrays)
        self._results = {}      # kf id → (R, t)
        self._pt_results = {}   # point id → position
        self.window_ms = []     # host ms per solved window (upload → download)
        self.n_segments = 0

    # ------------------------------------------------------------------ build
    def build(self) -> bool:
        """Snapshot the map (under store.lock) and cut the keyframes into
        overlapping windows."""
        s = self.store
        with s.lock:
            # world version at snapshot: a loop correction landing while this
            # solve runs must not be overwritten by its write-back
            self._build_version = s.big_change_idx
            kfs_all = s.valid_kf_ids()
            if kfs_all.size < 2:
                return False
            W = self.window_kfs
            if kfs_all.size <= W:
                chunks = [kfs_all]
            else:
                # 25 % overlap: each window after the first holds its leading
                # overlap fixed to stitch
                step = max(1, int(W * 0.75))
                chunks = [kfs_all[i: i + W] for i in range(0, kfs_all.size - W // 4, step)]
            windows = [self._build_window(np.asarray(c)) for c in chunks]
        self._windows = [w for w in windows if w is not None]
        return bool(self._windows)

    def _build_window(self, kfs):
        s = self.store
        K = len(kfs)
        pts = np.unique(s.kf_point[kfs])
        pts = pts[pts >= 0]
        pts = pts[s.point_valid[pts]]
        if pts.size > self.max_points:
            order = np.argsort(-s.point_nobs[pts], kind="stable")
            pts = np.sort(pts[order[: self.max_points]])
        if pts.size == 0:
            return None
        O = self.obs_cap
        # global KF id → window index through a lookup table, observations in
        # the window stable-compacted to the front, capped at O
        lut = np.full(s.cap.max_keyframes, -1, np.int64)
        lut[kfs] = np.arange(K)
        okf_all = s.obs_kf[pts]
        ki_all = np.where(okf_all >= 0, lut[np.maximum(okf_all, 0)], -1)
        in_win = ki_all >= 0
        order = np.argsort(~in_win, axis=1, kind="stable")[:, :O]
        obs_kf = np.take_along_axis(ki_all, order, 1)
        obs_valid = np.take_along_axis(in_win, order, 1)
        okf_sel = np.maximum(np.take_along_axis(okf_all, order, 1), 0)
        oidx_sel = np.maximum(np.take_along_axis(s.obs_idx[pts], order, 1), 0)
        obs_kf[~obs_valid] = -1
        orb = self.cfg.orb
        inv_sig = 1.0 / np.asarray([orb.scale_factor ** (2 * i) for i in range(orb.n_levels)],
                                   np.float32)
        obs_uv = s.kf_uv[okf_sel, oidx_sel].astype(np.float32)
        obs_ur = np.where(obs_valid, s.kf_u_right[okf_sel, oidx_sel], -1.0).astype(np.float32)
        obs_inv2 = inv_sig[np.clip(s.kf_octave[okf_sel, oidx_sel], 0, len(inv_sig) - 1)]
        obs_uv[~obs_valid] = 0.0
        obs_inv2 = np.where(obs_valid, obs_inv2, 1.0).astype(np.float32)
        fixed = np.zeros(K, bool)
        fixed[kfs == 0] = True  # anchor KF 0 (the reference fixes id 0)
        prob = dict(
            kf_R=s.kf_R[kfs], kf_t=s.kf_t[kfs], kf_fixed=fixed, kf_valid=np.ones(K, bool),
            pt_pos=s.point_pos[pts], pt_valid=np.ones(pts.size, bool), obs_kf=obs_kf,
            obs_uv=obs_uv, obs_ur=obs_ur, obs_inv_sigma2=obs_inv2, obs_valid=obs_valid)
        return kfs, pts, fixed, prob

    # ------------------------------------------------------------------ solve
    def solve(self, should_abort: Optional[callable] = None) -> bool:
        """Every window as short LM segments, aborting between segments
        (reference: mbStopGBA). Returns False if aborted."""
        cam = self.cfg.camera
        for kfs, pts, fixed, host in self._windows:
            host = dict(host)
            # poses solved by earlier windows enter fixed (overlap stitching)
            solved = np.asarray([int(k) in self._results for k in kfs], bool)
            if solved.any():
                host["kf_fixed"] = host["kf_fixed"] | solved
                host["kf_R"], host["kf_t"] = host["kf_R"].copy(), host["kf_t"].copy()
                for i in np.nonzero(solved)[0]:
                    host["kf_R"][i], host["kf_t"][i] = self._results[int(kfs[i])]
            t0 = time.perf_counter()
            prob = LocalBAProblem(**to_device(host, self.device))
            n_seg = max(1, self.iters // self.segment_iters)

            def should_stop():
                stop = should_abort is not None and should_abort()
                self.n_segments += not stop
                return stop

            res = solve_segments(prob, cam, n_seg, self.segment_iters, should_stop)
            if res is None:
                self.aborted = True
                return False
            h = to_host(dict(kf_R=res.kf_R, kf_t=res.kf_t, pt_pos=res.pt_pos))
            self.window_ms.append((time.perf_counter() - t0) * 1e3)
            for i, k in enumerate(kfs):
                if not fixed[i] and int(k) not in self._results:
                    self._results[int(k)] = (h["kf_R"][i], h["kf_t"][i])
            for i, p in enumerate(pts):
                self._pt_results[int(p)] = h["pt_pos"][i]
        return True

    # ------------------------------------------------------------- write back
    def write_back(self, post_cb=None):
        """Apply the results under the store lock; keyframes and points
        created during the solve are carried along through the spanning tree
        and their keyframes (reference: LoopClosing.cc:720-780).
        `post_cb(before_R, before_t)` runs at the end with the lock held —
        System rebases live tracking with it."""
        s = self.store
        with s.lock:
            if s.big_change_idx != self._build_version:
                self.aborted = True
                return  # superseded by a loop correction during the solve
            kfs_now = s.valid_kf_ids()
            # poses as they stand NOW (reference: mTcwBefGBA): child→parent
            # relatives must come from the current poses, since a parent may
            # have been created or moved by local BA during the solve
            before_R = s.kf_R.copy()
            before_t = s.kf_t.copy()
            optimized = set()
            for k in kfs_now:
                k = int(k)
                if k in self._results:
                    R, t = self._results[k]
                    s.set_kf_pose(k, R, t)
                    optimized.add(k)
            # new / unsolved KFs: child = T_child_parent(before) ∘ parent(new),
            # walking the spanning tree to the nearest solved KF
            for k in kfs_now:
                k = int(k)
                if k in optimized:
                    continue
                parent = int(s.kf_parent[k])
                hops = 0
                while parent >= 0 and parent not in optimized and hops < 64:
                    parent = int(s.kf_parent[parent])
                    hops += 1
                if parent < 0 or parent not in optimized:
                    continue
                R_rel = before_R[k] @ before_R[parent].T
                t_rel = before_t[k] - R_rel @ before_t[parent]
                s.set_kf_pose(k, R_rel @ s.kf_R[parent], R_rel @ s.kf_t[parent] + t_rel)
                optimized.add(k)
            # points: solved ones take their BA positions, the others move
            # with the first optimized KF that observes them
            moved = np.zeros(s.cap.max_map_points, bool)
            solved_ids = np.asarray([p for p in self._pt_results if s.point_valid[p]], np.int64)
            if solved_ids.size:
                s.point_pos[solved_ids] = np.stack([self._pt_results[int(p)] for p in solved_ids])
                s.mark_dirty(solved_ids)
                moved[solved_ids] = True
            for k in kfs_now:
                k = int(k)
                if k not in optimized:
                    continue
                p_list = s.kf_point[k]
                p_list = np.unique(p_list[p_list >= 0])
                p_list = p_list[s.point_valid[p_list] & ~moved[p_list]]
                if not p_list.size:
                    continue
                pc = s.point_pos[p_list] @ before_R[k].T + before_t[k]
                s.point_pos[p_list] = (pc - s.kf_t[k]) @ s.kf_R[k]
                s.mark_dirty(p_list)
                moved[p_list] = True
            s.big_change_idx += 1
            if post_cb is not None:
                post_cb(before_R, before_t)


def global_bundle_adjustment(store: MapStore, cfg, iters: int = 20,
                             should_abort=None, device="cuda", **kw) -> bool:
    """build → solve → write_back in one call (tests, small maps). Returns
    True if it ran to completion."""
    runner = GlobalBARunner(store, cfg, iters=iters, device=device, **kw)
    if not runner.build():
        return False
    if not runner.solve(should_abort):
        return False
    runner.write_back()
    return True

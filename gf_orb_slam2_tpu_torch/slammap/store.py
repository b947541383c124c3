"""The SLAM map as fixed-capacity SoA arrays with a host coordinator.

Array-based replacement for the reference's L2 pointer data model — Map,
KeyFrame, MapPoint, and their per-object mutexes (reference: src/Map.cc,
src/KeyFrame.cc, src/MapPoint.cc; locks described in SURVEY.md §5). Instead
of heap objects + fine-grained locks shared by three threads, ALL map state
lives in preallocated numpy SoA arrays owned by one host coordinator;
device programs receive immutable array snapshots (SURVEY.md §7.1 P8:
"versioned snapshots instead of locks").

Capability parity map:
- MapPoint world pos / descriptor / normal / scale range / found-visible
  counters / observations / Replace lifecycle (MapPoint.cc:306/:332/:397/:485)
  → point_* arrays + add_observation/erase_point/replace_point/
    distinctive_descriptor/update_normal_and_depth.
- KeyFrame covisibility graph (weighted ≥15 edges, KeyFrame.cc:596
  UpdateConnections / :418 UpdateBestCovisibles) → dense int32 covis matrix
  updated incrementally; spanning tree (KeyFrame.cc:688) → parent array.
- Map container ops (Map.cc) → trivial array ops + `clear`.
- KeyFrame grid search (KeyFrame.cc:877) is unnecessary: device-side masked
  matrices replace grid candidate pruning (see matching/matcher.py).

Host state only: descriptors are numpy uint32 here and cross to torch as
int32 views of the same bits (see convert.py). The pipelined tracker reads
point data from a device copy (slammap/device_mirror.py): every write of
point position, normal, distance range or descriptor marks the point dirty
through `mark_dirty`, and the mirror ships the marked rows at its next sync.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gf_orb_slam2_tpu_torch.config import CapacityConfig


def _locked(fn):
    """Store mutators self-lock (RLock — reentrant under callers that already
    hold it), so a later background mapper can share the store with the
    tracking thread."""
    import functools

    @functools.wraps(fn)
    def wrap(self, *a, **k):
        with self.lock:
            return fn(self, *a, **k)

    return wrap


@dataclasses.dataclass
class MapStore:
    cap: CapacityConfig
    n_kp: int  # keypoint capacity per keyframe

    # ---- map points
    point_pos: np.ndarray = None          # [P,3] f32
    point_desc: np.ndarray = None         # [P,8] u32
    point_normal: np.ndarray = None       # [P,3] f32
    point_min_dist: np.ndarray = None     # [P] f32
    point_max_dist: np.ndarray = None     # [P] f32
    point_valid: np.ndarray = None        # [P] bool
    point_nobs: np.ndarray = None         # [P] i32
    point_visible: np.ndarray = None      # [P] i32 (reference mnVisible)
    point_found: np.ndarray = None        # [P] i32 (reference mnFound)
    point_first_kf: np.ndarray = None     # [P] i32
    point_replaced_by: np.ndarray = None  # [P] i32 (-1)
    obs_kf: np.ndarray = None             # [P,O] i32 (-1 = empty slot)
    obs_idx: np.ndarray = None            # [P,O] i32 keypoint slot in that KF

    # ---- keyframes
    kf_R: np.ndarray = None               # [K,3,3] f32 (world→cam)
    kf_t: np.ndarray = None               # [K,3] f32
    kf_valid: np.ndarray = None           # [K] bool
    kf_frame_id: np.ndarray = None        # [K] i64 source frame id
    kf_timestamp: np.ndarray = None       # [K] f64
    kf_uv: np.ndarray = None              # [K,N,2] f32 (undistorted/rectified)
    kf_octave: np.ndarray = None          # [K,N] i32
    kf_angle: np.ndarray = None           # [K,N] f32
    kf_desc: np.ndarray = None            # [K,N,8] u32
    kf_u_right: np.ndarray = None         # [K,N] f32 (<0 mono)
    kf_depth: np.ndarray = None           # [K,N] f32 (<0 unknown)
    kf_kp_valid: np.ndarray = None        # [K,N] bool
    kf_point: np.ndarray = None           # [K,N] i32 → point id (-1 none)
    covis: np.ndarray = None              # [K,K] i32 shared-point weights
    kf_parent: np.ndarray = None          # [K] i32 spanning-tree parent (-1 root)
    kf_loop_edges: dict = dataclasses.field(default_factory=dict)  # kf → set(kf)

    n_points: int = 0
    n_keyframes: int = 0
    next_point: int = 0
    big_change_idx: int = 0  # reference Map::InformNewBigChange

    COVIS_TH: int = 15  # reference KeyFrame::UpdateConnections threshold

    def __post_init__(self):
        P, K, N, O = (
            self.cap.max_map_points,
            self.cap.max_keyframes,
            self.n_kp,
            self.cap.max_obs_per_point,
        )
        self.point_pos = np.zeros((P, 3), np.float32)
        self.point_desc = np.zeros((P, 8), np.uint32)
        self.point_normal = np.zeros((P, 3), np.float32)
        self.point_min_dist = np.zeros(P, np.float32)
        self.point_max_dist = np.full(P, 1e9, np.float32)
        self.point_valid = np.zeros(P, bool)
        self.point_nobs = np.zeros(P, np.int32)
        self.point_visible = np.ones(P, np.int32)
        self.point_found = np.ones(P, np.int32)
        self.point_first_kf = np.full(P, -1, np.int32)
        self.point_replaced_by = np.full(P, -1, np.int32)
        self.obs_kf = np.full((P, O), -1, np.int32)
        self.obs_idx = np.full((P, O), -1, np.int32)
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_valid = np.zeros(K, bool)
        self.kf_frame_id = np.zeros(K, np.int64)
        self.kf_timestamp = np.zeros(K, np.float64)
        self.kf_uv = np.zeros((K, N, 2), np.float32)
        self.kf_octave = np.zeros((K, N), np.int32)
        self.kf_angle = np.zeros((K, N), np.float32)
        self.kf_desc = np.zeros((K, N, 8), np.uint32)
        self.kf_u_right = np.full((K, N), -1.0, np.float32)
        self.kf_depth = np.full((K, N), -1.0, np.float32)
        self.kf_kp_valid = np.zeros((K, N), bool)
        self.kf_point = np.full((K, N), -1, np.int32)
        self.covis = np.zeros((K, K), np.int32)
        self.kf_parent = np.full(K, -1, np.int32)
        # free-slot RING for point allocation: pop at head, push at tail.
        # FIFO reuse delays recycling of freed slots as long as possible, so
        # stale ids held by in-flight frames/devices keep resolving correctly.
        self._free = np.arange(P, dtype=np.int32)
        self._free_head = 0
        self._n_free = P
        # coarse map lock shared by the tracking thread and the async
        # mapping/loop worker (reference: Map::mMutexMapUpdate). Host-side
        # critical sections only — device waits happen OUTSIDE it.
        import threading

        self.lock = threading.RLock()
        self.mirror = None  # DeviceMapMirror while the pipelined path is live

    # ------------------------------------------------------------ keyframes
    @_locked
    def add_keyframe(
        self, R, t, uv, octave, angle, desc, u_right, depth, kp_valid,
        frame_id=0, timestamp=0.0,
    ) -> int:
        k = self.n_keyframes
        if k >= self.cap.max_keyframes:
            # reuse the oldest culled slot if any, else refuse gracefully
            free = np.nonzero(~self.kf_valid[: self.n_keyframes])[0]
            if free.size == 0:
                raise RuntimeError(
                    "keyframe capacity exceeded — raise CapacityConfig.max_keyframes"
                )
            k = int(free[0])
            self.n_keyframes -= 1  # will be re-incremented below
        self.kf_R[k] = R
        self.kf_t[k] = t
        self.kf_uv[k] = uv
        self.kf_octave[k] = octave
        self.kf_angle[k] = angle
        self.kf_desc[k] = desc
        self.kf_u_right[k] = u_right
        self.kf_depth[k] = depth
        self.kf_kp_valid[k] = kp_valid
        self.kf_frame_id[k] = frame_id
        self.kf_timestamp[k] = timestamp
        self.kf_valid[k] = True
        self.n_keyframes += 1
        return k

    @_locked
    def set_kf_pose(self, k, R, t):
        self.kf_R[k] = R
        self.kf_t[k] = t

    def kf_center(self, k):
        """Camera center(s) in world: -Rᵀ t. k may be an index or array."""
        R = self.kf_R[k]
        t = self.kf_t[k]
        return -np.einsum("...ji,...j->...i", R, t)

    @_locked
    def erase_keyframe(self, k: int):
        """KeyFrame::SetBadFlag (reference: src/KeyFrame.cc:761): detach all
        observations, reconnect children to the best-covisible parent."""
        if not self.kf_valid[k]:
            return
        pts = self.kf_point[k]
        for slot, p in enumerate(pts):
            if p >= 0:
                self.remove_observation(int(p), k)
        self.kf_point[k] = -1
        # children adoption: any KF whose parent is k gets k's parent
        children = np.nonzero(self.kf_parent[: self.n_keyframes] == k)[0]
        self.kf_parent[children] = self.kf_parent[k]
        self.covis[k, :] = 0
        self.covis[:, k] = 0
        self.kf_valid[k] = False

    # ----------------------------------------------------------- map points
    def _alloc_points(self, m: int) -> np.ndarray:
        """Pop m free slot ids from the free stack; under capacity pressure
        cull the globally worst-tracked points and reuse their slots (the
        reference grows unbounded and relies on culling; a fixed-capacity
        store must reclaim here)."""
        short = m - self._n_free
        if short > 0:
            live = self.valid_point_ids()
            ratios = self.found_ratio(live)
            victims = live[np.argsort(ratios, kind="stable")[:short]]
            for v in victims:
                self.erase_point(int(v))
        P = self.cap.max_map_points
        h = self._free_head
        idx = (h + np.arange(m)) % P
        ids = self._free[idx].copy()
        self._free_head = (h + m) % P
        self._n_free -= m
        return ids

    def _free_point(self, p: int):
        P = self.cap.max_map_points
        tail = (self._free_head + self._n_free) % P
        self._free[tail] = p
        self._n_free += 1

    @_locked
    def add_point(self, pos, desc, first_kf=-1, normal=None, min_dist=0.1, max_dist=100.0) -> int:
        p = int(self._alloc_points(1)[0])
        self.point_pos[p] = pos
        self.point_desc[p] = desc
        self.point_normal[p] = normal if normal is not None else [0, 0, 1]
        self.point_min_dist[p] = min_dist
        self.point_max_dist[p] = max_dist
        self.point_valid[p] = True
        self.point_nobs[p] = 0
        self.point_visible[p] = 1
        self.point_found[p] = 1
        self.point_first_kf[p] = first_kf
        self.point_replaced_by[p] = -1
        self.obs_kf[p] = -1
        self.obs_idx[p] = -1
        self.n_points += 1
        self.next_point = p + 1
        self.mark_dirty(p)
        return p

    @_locked
    def mark_dirty(self, ids):
        """Record point-data changes for the device map mirror, if one is
        attached (slammap/device_mirror.py)."""
        if self.mirror is not None:
            self.mirror.mark(np.atleast_1d(ids))

    @_locked
    def add_points_batch(self, pos, desc, first_kf, kf_ids, kp_idx) -> np.ndarray:
        """Vectorized creation of M points each observed by (kf_ids[m], kp_idx[m]).
        One fancy-indexed write per array — no per-point Python (the per-frame
        and per-KF host paths must stay O(1) in Python ops)."""
        m = len(pos)
        if m == 0:
            return np.empty(0, np.int32)
        ids = self._alloc_points(m)
        self.point_pos[ids] = pos
        self.point_desc[ids] = desc
        self.point_normal[ids] = [0, 0, 1]
        self.point_min_dist[ids] = 0.1
        self.point_max_dist[ids] = 100.0
        self.point_valid[ids] = True
        self.point_nobs[ids] = 1
        self.point_visible[ids] = 1
        self.point_found[ids] = 1
        self.point_first_kf[ids] = first_kf
        self.point_replaced_by[ids] = -1
        self.obs_kf[ids] = -1
        self.obs_idx[ids] = -1
        kf_ids = np.broadcast_to(np.asarray(kf_ids, np.int32), (m,))
        kp_idx = np.asarray(kp_idx, np.int32)
        self.obs_kf[ids, 0] = kf_ids
        self.obs_idx[ids, 0] = kp_idx
        self.kf_point[kf_ids, kp_idx] = ids
        self.n_points += m
        self.mark_dirty(ids)
        return ids

    @_locked
    def add_observations_batch(self, p_ids, kf: int, idxs):
        """Vectorized add_observation for M (point, keypoint-slot) pairs all
        observed by ONE keyframe `kf` (the per-KF binding loop of
        CreateNewKeyFrame / stereo init). Falls back to the scalar path for
        the rare rows that need eviction or already observe `kf`."""
        p_ids = np.asarray(p_ids, np.int64)
        idxs = np.asarray(idxs, np.int64)
        if p_ids.size == 0:
            return
        rows = self.obs_kf[p_ids]                       # [M,O]
        has_kf = (rows == kf).any(axis=1)
        slot = np.argmax(rows < 0, axis=1)              # first free slot
        has_free = rows[np.arange(len(p_ids)), slot] < 0
        fast = ~has_kf & has_free
        self.obs_kf[p_ids[fast], slot[fast]] = kf
        self.obs_idx[p_ids[fast], slot[fast]] = idxs[fast]
        self.point_nobs[p_ids[fast]] += 1
        self.kf_point[kf, idxs[fast]] = p_ids[fast]
        for j in np.nonzero(~fast)[0]:
            self.add_observation(int(p_ids[j]), kf, int(idxs[j]))

    @_locked
    def add_observation(self, p: int, kf: int, idx: int):
        slots = self.obs_kf[p]
        existing = np.nonzero(slots == kf)[0]
        if existing.size:
            old = self.obs_idx[p, existing[0]]
            if old >= 0 and old != idx and self.kf_point[kf, old] == p:
                self.kf_point[kf, old] = -1
            self.obs_idx[p, existing[0]] = idx
        else:
            free = np.nonzero(slots < 0)[0]
            if free.size:
                s = free[0]
                self.point_nobs[p] += 1
            else:
                # slots full: evict the observation whose camera center is
                # CLOSEST to the incoming KF's — keeps the widest-baseline
                # (typically earliest) observations that anchor BA, unlike
                # oldest-first eviction (the reference never drops
                # observations; with bounded slots this loses the least)
                centers = self.kf_center(slots)          # [O,3]
                d = np.linalg.norm(centers - self.kf_center(kf), axis=-1)
                s = int(np.argmin(d))
                old_kf, old_idx = slots[s], self.obs_idx[p, s]
                if old_idx >= 0 and self.kf_point[old_kf, old_idx] == p:
                    self.kf_point[old_kf, old_idx] = -1
            self.obs_kf[p, s] = kf
            self.obs_idx[p, s] = idx
        self.kf_point[kf, idx] = p

    @_locked
    def remove_observation(self, p: int, kf: int):
        slots = np.nonzero(self.obs_kf[p] == kf)[0]
        if not slots.size:
            return
        s = slots[0]
        idx = self.obs_idx[p, s]
        if idx >= 0 and self.kf_point[kf, idx] == p:
            self.kf_point[kf, idx] = -1
        self.obs_kf[p, s] = -1
        self.obs_idx[p, s] = -1
        self.point_nobs[p] -= 1
        # reference: SetBadFlag when stereo obs count <= 2 — approximated by
        # total obs; culling policy lives in mapping/local_mapping.py
        if self.point_nobs[p] <= 0:
            self.erase_point(p)

    @_locked
    def erase_point(self, p: int):
        if not self.point_valid[p]:
            return
        kfs, idxs = self.obs_kf[p], self.obs_idx[p]
        m = (kfs >= 0) & (idxs >= 0)
        m[m] &= self.kf_point[kfs[m], idxs[m]] == p
        self.kf_point[kfs[m], idxs[m]] = -1
        self.obs_kf[p] = -1
        self.obs_idx[p] = -1
        self.point_valid[p] = False
        self.point_nobs[p] = 0
        self.n_points -= 1
        self._free_point(p)

    @_locked
    def replace_point(self, p_old: int, p_new: int):
        """MapPoint::Replace (reference: src/MapPoint.cc:306): transfer
        observations, merge counters, tombstone the old id."""
        if p_old == p_new or not self.point_valid[p_old]:
            return
        for s in range(self.obs_kf.shape[1]):
            kf = self.obs_kf[p_old, s]
            if kf < 0:
                continue
            idx = self.obs_idx[p_old, s]
            # only transfer if the new point isn't already seen by this KF
            if not (self.obs_kf[p_new] == kf).any():
                self.obs_kf[p_old, s] = -1  # prevent erase-side effects
                self.add_observation(p_new, int(kf), int(idx))
            elif idx >= 0 and self.kf_point[kf, idx] == p_old:
                self.kf_point[kf, idx] = -1
        self.point_found[p_new] += self.point_found[p_old]
        self.point_visible[p_new] += self.point_visible[p_old]
        self.point_replaced_by[p_old] = p_new
        self.obs_kf[p_old] = -1
        self.point_valid[p_old] = False
        self.n_points -= 1
        self._free_point(p_old)

    def resolve_replaced(self, ids: np.ndarray) -> np.ndarray:
        """Follow Replace chains (reference: Tracking::CheckReplacedInLastFrame
        src/Tracking.cc:1307)."""
        ids = ids.copy()
        for _ in range(4):
            live = ids >= 0
            rep = np.where(live, self.point_replaced_by[np.maximum(ids, 0)], -1)
            upd = rep >= 0
            if not upd.any():
                break
            ids = np.where(upd, rep, ids)
        # invalidate ids that are dead and unreplaced
        dead = (ids >= 0) & ~self.point_valid[np.maximum(ids, 0)]
        ids[dead] = -1
        return ids

    # ------------------------------------------------- descriptors / normals
    def distinctive_descriptor(self, p: int):
        """Min-median-Hamming descriptor over observations (reference:
        MapPoint::ComputeDistinctiveDescriptors src/MapPoint.cc:397)."""
        kfs = self.obs_kf[p]
        mask = kfs >= 0
        if mask.sum() == 0:
            return
        descs = self.kf_desc[kfs[mask], self.obs_idx[p][mask]]  # [M,8]
        x = descs[:, None, :] ^ descs[None, :, :]
        d = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)  # [M,M]
        med = np.median(d, axis=1)
        self.point_desc[p] = descs[np.argmin(med)]
        self.mark_dirty(p)

    def update_normal_and_depth(self, p: int, level_scales: np.ndarray, ref_octave: Optional[int] = None):
        """Mean viewing direction + scale-invariance range (reference:
        MapPoint::UpdateNormalAndDepth src/MapPoint.cc:485)."""
        kfs = self.obs_kf[p]
        mask = kfs >= 0
        if mask.sum() == 0:
            return
        kf_ids = kfs[mask]
        centers = self.kf_center(kf_ids)
        v = self.point_pos[p][None] - centers
        n = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        self.point_normal[p] = n.mean(0)
        # reference uses the *reference KF* (first obs) for the range
        ref_i = 0
        dist = np.linalg.norm(self.point_pos[p] - centers[ref_i])
        oct_ = self.kf_octave[kf_ids[ref_i], self.obs_idx[p][mask][ref_i]] if ref_octave is None else ref_octave
        sf = level_scales[int(oct_)]
        n_levels = len(level_scales)
        self.point_max_dist[p] = dist * sf
        self.point_min_dist[p] = self.point_max_dist[p] / level_scales[n_levels - 1]
        self.mark_dirty(p)

    def update_normals_batch(self, ids, level_scales: np.ndarray):
        """Vectorized update_normal_and_depth over M points (one fancy-indexed
        pass instead of M Python calls — used on the KF-creation and
        triangulation paths)."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return
        kfs = self.obs_kf[ids]                            # [M,O]
        mask = kfs >= 0
        any_obs = mask.any(axis=1)
        ids, kfs, mask = ids[any_obs], kfs[any_obs], mask[any_obs]
        if ids.size == 0:
            return
        centers = self.kf_center(np.maximum(kfs, 0))      # [M,O,3]
        v = self.point_pos[ids][:, None] - centers
        n = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        n = np.where(mask[..., None], n, 0.0)
        self.point_normal[ids] = n.sum(1) / np.maximum(
            mask.sum(1, keepdims=True), 1)
        ref = np.argmax(mask, axis=1)                     # first live slot
        r = np.arange(len(ids))
        dist = np.linalg.norm(self.point_pos[ids] - centers[r, ref], axis=-1)
        oct_ = self.kf_octave[kfs[r, ref], self.obs_idx[ids, ref]]
        sf = level_scales[np.clip(oct_, 0, len(level_scales) - 1)]
        self.point_max_dist[ids] = dist * sf
        self.point_min_dist[ids] = self.point_max_dist[ids] / level_scales[-1]
        self.mark_dirty(ids)

    # --------------------------------------------------------- covisibility
    def update_connections(self, k: int):
        """Recompute covis row/col for KF k from shared map points and refresh
        the spanning-tree parent (reference: KeyFrame::UpdateConnections
        src/KeyFrame.cc:596)."""
        pts = self.kf_point[k]
        pts = pts[pts >= 0]
        w = np.zeros(self.cap.max_keyframes, np.int32)
        if pts.size:
            kfs = self.obs_kf[pts]  # [M,O]
            flat = kfs[kfs >= 0]
            if flat.size:
                counts = np.bincount(flat, minlength=self.cap.max_keyframes)
                w = counts.astype(np.int32)
        w[k] = 0
        # threshold 15, but always keep the single best edge (reference :632)
        w_th = np.where(w >= self.COVIS_TH, w, 0)
        if w.max() > 0 and w_th.max() == 0:
            w_th[np.argmax(w)] = w.max()
        self.covis[k, :] = w_th
        self.covis[:, k] = w_th
        # spanning tree: parent = best covisible KF with smaller id
        if k > 0:
            earlier = w[:k]
            if earlier.max() > 0:
                self.kf_parent[k] = int(np.argmax(earlier))

    def covisible_kfs(self, k: int, n: Optional[int] = None) -> np.ndarray:
        """Best covisible KFs ordered by weight (reference:
        GetBestCovisibilityKeyFrames KeyFrame.cc:~470)."""
        w = self.covis[k, : self.n_keyframes].copy()
        w[~self.kf_valid[: self.n_keyframes]] = 0
        order = np.argsort(-w, kind="stable")
        order = order[w[order] > 0]
        return order[:n] if n is not None else order

    def rebuild_free_list(self):
        """Recompute the free-slot ring from point_valid (after load_map or
        any bulk overwrite of the point arrays)."""
        free = np.nonzero(~self.point_valid)[0].astype(np.int32)
        P = self.cap.max_map_points
        self._free = np.zeros(P, np.int32)
        self._free[: free.size] = free
        self._free_head = 0
        self._n_free = int(free.size)

    # -------------------------------------------------------------- queries
    def valid_point_ids(self) -> np.ndarray:
        return np.nonzero(self.point_valid)[0]

    def valid_kf_ids(self) -> np.ndarray:
        return np.nonzero(self.kf_valid[: self.n_keyframes])[0]

    def found_ratio(self, ids) -> np.ndarray:
        return self.point_found[ids] / np.maximum(self.point_visible[ids], 1)

    def clear(self):
        """Full reset (reference: Map::clear + Tracking::Reset
        src/Tracking.cc:2803)."""
        self.__post_init__()
        self.n_points = 0
        self.n_keyframes = 0
        self.next_point = 0

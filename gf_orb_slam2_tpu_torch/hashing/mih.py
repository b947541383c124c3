"""Multi-index hashing of the local map — ctypes binding + OTS controller.

Replacement for MultiIndexHashing (reference: src/Hashing.cc,
include/Hashing.h — 32 tables × 256 buckets over 256-bit descriptors,
bounded buckets of 20, NUM_ACTIVE_HASHTABLES=8 with online table selection
and a latency feedback controller `updateDynamics` against the
MAX_TRACK_LOCALMAP_TIME=20ms target, Hashing.h:74-79). The tables are native
C++ on the host (csrc/mih.cpp: hash mutation is pointer chasing); the
candidates they return are re-ranked on the GPU by the projection search
(kernel csrc/hamming_best2.cu).

The wall-clock feedback controller becomes a candidate-count controller
(SURVEY.md §7.3: time budgets → count budgets): `update_dynamics` grows or
shrinks the per-query candidate budget toward its target.

The library is compiled with g++ at first use into `<package>/_build/`,
named by a hash of its source and flags; each process builds to a name of
its own and renames it into place, so processes that build at once never
load a half-written file. A failed build raises: nothing falls back to the
covisibility-only local map.

The native tables have no lock of their own. Callers serialize every call:
the tracker and the local mapper hold the map store's lock around each one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "mih.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB = None
_LIB_LOCK = threading.Lock()


def build() -> str:
    """Compile csrc/mih.cpp into the build directory (skipped when a library
    built from the same source and flags is there). Returns its path; raises
    on a compiler failure."""
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libgfslam_mih_{h.hexdigest()[:12]}.so")
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            out = subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed ({out.returncode}) on {SOURCE}:\n"
                                   f"{out.stdout}{out.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return lib_path


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; idempotent."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build())
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        u32p, s32p = ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32)
        lib.mih_create.restype = vp
        lib.mih_create.argtypes = [i32] * 3
        lib.mih_destroy.restype = None
        lib.mih_destroy.argtypes = [vp]
        lib.mih_clear.restype = None
        lib.mih_clear.argtypes = [vp]
        lib.mih_insert.restype = None
        lib.mih_insert.argtypes = [vp, u32p, s32p, i32]
        lib.mih_erase.restype = None
        lib.mih_erase.argtypes = [vp, ctypes.c_int32]
        lib.mih_query.restype = i32
        lib.mih_query.argtypes = [vp, u32p, i32, s32p, i32, s32p, i32,
                                  ctypes.POINTER(ctypes.c_uint8), i32]
        lib.mih_table_sizes.restype = None
        lib.mih_table_sizes.argtypes = [vp, ctypes.POINTER(ctypes.c_int64)]
        _LIB = lib
        return lib


def _u32ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _i32ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _descriptors(desc) -> np.ndarray:
    d = np.ascontiguousarray(desc, np.uint32)
    if d.ndim != 2 or d.shape[1] != 8:
        raise ValueError(f"descriptors must be [N, 8] words, got {d.shape}")
    return d


class MultiIndexHashing:
    def __init__(self, cfg, max_points: int):
        self.cfg = cfg
        self.max_points = max_points
        self._lib = load()
        self._h = self._lib.mih_create(cfg.n_tables, cfg.bits_per_substring,
                                       cfg.max_bucket_size)
        self.n_active = cfg.n_active_tables
        self.active_tables = np.arange(cfg.n_tables, dtype=np.int32)[: self.n_active]
        self.n_queries = 0
        # candidate budget controller (replaces the 20 ms time controller)
        self.candidate_budget = 2048
        # per-table retrieval-utility EMA (reference: per-point
        # mnQueriedScore/mvbActiveHashTables accumulated into table scores,
        # Tracking::UpdateQueryNumByHashTable Tracking.cc:3111)
        self.table_utility = np.zeros(cfg.n_tables, np.float64)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.mih_destroy(h)

    def insert(self, desc: np.ndarray, ids: np.ndarray):
        desc = _descriptors(desc)
        ids = np.ascontiguousarray(ids, np.int32)
        if ids.shape != (len(desc),):
            raise ValueError(f"{len(desc)} descriptors but ids of shape {ids.shape}")
        self._lib.mih_insert(self._h, _u32ptr(desc), _i32ptr(ids), len(ids))

    def erase(self, point_id: int):
        self._lib.mih_erase(self._h, int(point_id))

    def clear(self):
        self._lib.mih_clear(self._h)

    def table_sizes(self) -> np.ndarray:
        """Entries per table [n_tables] int64."""
        sizes = np.empty(self.cfg.n_tables, np.int64)
        self._lib.mih_table_sizes(self._h, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return sizes

    def query(self, desc: np.ndarray, max_out: Optional[int] = None) -> np.ndarray:
        """Candidate map-point ids for frame descriptors [N,8]: for each
        descriptor in turn, each active table in `active_tables` order, each
        bucket entry oldest first — the first appearance of an id in
        [0, max_points) is kept, until `max_out` (default: the candidate
        budget) ids are out."""
        self.n_queries += 1
        desc = _descriptors(desc)
        max_out = max_out or self.candidate_budget
        out = np.empty(max_out, np.int32)
        seen = np.zeros(self.max_points, np.uint8)
        tbl = np.ascontiguousarray(self.active_tables, np.int32)
        n = self._lib.mih_query(
            self._h, _u32ptr(desc), len(desc), _i32ptr(tbl), len(tbl),
            _i32ptr(out), max_out,
            seen.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), self.max_points,
        )
        return out[:n]

    # ------------------------------------------------ online table selection
    def update_query_scores(self, kp_desc: np.ndarray, pt_desc: np.ndarray,
                            ema: float = 0.9):
        """Accumulate per-table retrieval utility from ACTUAL matches
        (reference: Tracking::UpdateQueryNumByHashTable Tracking.cc:3111 —
        tables that would have retrieved the matched landmarks score up).

        Table t retrieves point p for query q iff their t-th 8-bit substring
        agrees; with [M,8]-u32 descriptors that is a bytewise comparison —
        which only matches the native substring() extraction (mih.cpp) when
        bits_per_substring == 8, so other geometries skip the utility update
        (OTS then falls back to load-based table selection)."""
        if len(kp_desc) == 0 or self.cfg.bits_per_substring != 8:
            return
        qa = np.ascontiguousarray(kp_desc, np.uint32).view(np.uint8)
        pa = np.ascontiguousarray(pt_desc, np.uint32).view(np.uint8)
        hits = (qa == pa).reshape(len(kp_desc), -1)  # [M, 32] per-substring
        util = hits[:, : self.cfg.n_tables].sum(0).astype(np.float64)
        self.table_utility = ema * self.table_utility + (1.0 - ema) * util

    def update_table_selection(self):
        """Activate the `n_active` highest-utility tables; load (table size)
        breaks ties / drives the cold start (reference OTS:
        Tracking.cc:3111 + Hashing.h NUM_ACTIVE_HASHTABLES)."""
        sizes = self.table_sizes()
        if self.table_utility.max() > 0:
            # utility first; prefer lighter tables among equals
            key = self.table_utility - 1e-9 * sizes
            self.active_tables = np.argsort(-key)[: self.n_active].astype(np.int32)
        else:
            self.active_tables = np.argsort(sizes)[: self.n_active].astype(np.int32)

    def update_dynamics(self, n_candidates_used: int, target: int = 2048):
        """Feedback controller on the candidate budget (reference:
        updateDynamics vs MAX_TRACK_LOCALMAP_TIME, Hashing.h:78): 0.9× when
        more than `target` candidates were used, else 1.1×, within
        [512, 8192]."""
        if n_candidates_used > target:
            self.candidate_budget = max(512, int(self.candidate_budget * 0.9))
        else:
            self.candidate_budget = min(8192, int(self.candidate_budget * 1.1))

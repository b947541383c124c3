"""Map checkpoint save/load.

Replaces the reference's ENABLE_MAP_IO path (reference: System::SaveMap
src/System.cc:1315 / LoadMap :907 — a directory of per-KeyFrame and
per-MapPoint YAML files with covisibility weights, spanning tree, loop
edges, observations, rebuilt object-by-object through FileStorage ctors).
Here the whole map IS arrays (slammap/store.py), so a checkpoint is one
compressed .npz + the vocabulary sidecar — save/load is a single pass, and
localization-only mode runs against the loaded map exactly like the
reference's workflow (README.md:383-390). The layout (array names, the
`__meta__` JSON, the capacity-prefix copy) is the JAX package's: a map that
either package saves loads in the other.
"""
from __future__ import annotations

import json

import numpy as np

from gf_orb_slam2_tpu_torch.slammap.store import MapStore

_ARRAYS = [
    "point_pos", "point_desc", "point_normal", "point_min_dist",
    "point_max_dist", "point_valid", "point_nobs", "point_visible",
    "point_found", "point_first_kf", "point_replaced_by", "obs_kf", "obs_idx",
    "kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_timestamp", "kf_uv",
    "kf_octave", "kf_angle", "kf_desc", "kf_u_right", "kf_depth",
    "kf_kp_valid", "kf_point", "covis", "kf_parent",
]
_SCALARS = ["n_points", "n_keyframes", "next_point", "big_change_idx"]


def save_map(path, store: MapStore):
    """Write the store to `path` (.npz; numpy appends the suffix if absent)
    as a snapshot taken under the store's lock."""
    with store.lock:
        data = {name: getattr(store, name).copy() for name in _ARRAYS}
        meta = {name: int(getattr(store, name)) for name in _SCALARS}
        meta["loop_edges"] = {str(k): sorted(v) for k, v in store.kf_loop_edges.items()}
    np.savez_compressed(path, __meta__=json.dumps(meta), **data)


def load_map(path, store: MapStore) -> MapStore:
    """Load into an existing (capacity-compatible) store, in place, under its
    lock. A device map mirror attached to the store is detached (as
    `MapStore.clear` does): its rows no longer hold the store's points, and
    the pipelined driver builds a new one from the loaded store."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["__meta__"]))
    with store.lock:
        for name in _ARRAYS:
            arr = z[name]
            dst = getattr(store, name)
            if dst.shape != arr.shape:
                # capacity mismatch: copy the overlapping prefix
                sl = tuple(slice(0, min(a, b)) for a, b in zip(dst.shape, arr.shape))
                dst[...] = 0
                dst[sl] = arr[sl]
            else:
                dst[...] = arr
        for name in _SCALARS:
            setattr(store, name, meta[name])
        store.kf_loop_edges = {int(k): set(v) for k, v in meta["loop_edges"].items()}
        store.rebuild_free_list()
        store.mirror = None
    return store

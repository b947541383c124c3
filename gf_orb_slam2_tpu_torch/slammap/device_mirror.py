"""Device-resident copy of the map-point arrays the pipelined tracker reads.

The streaming tracking step (tracking/tracker.py `stream_step`) gathers its
local candidate pool by point id from this mirror, so a streamed frame
uploads only the pool's ids and lifetimes, never point data. The fields
`pos`, `normal`, `mind`, `maxd` and `desc` stay on the device at the store's
full capacity (about 2.6 MB at 40,000 points).

Host writes of point data mark the point dirty (`MapStore.mark_dirty`).
`sync()` gathers the dirty rows under the store lock, uploads them in one
pinned non-blocking copy (utils/transfer.to_device) and writes them with
`index_copy_` at their exact ids — no padding, so no negative index ever
reaches the device (torch would wrap it to the last row). Both run on the
current stream of the thread that calls `sync`, which must be the thread
that dispatches the stream steps: stream order then gives each step the
snapshot it was dispatched against — a step enqueued before a sync reads the
old rows, a step enqueued after it the new ones.

Every point written is marked, so after `sync()` the mirror equals the store
on every row.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from gf_orb_slam2_tpu_torch.utils.transfer import to_device

FIELDS = ("pos", "normal", "mind", "maxd", "desc")


def _host_rows(store, ids=None) -> dict:
    """The mirrored fields of rows `ids` (all rows when None), as numpy."""
    sel = slice(None) if ids is None else ids
    return dict(pos=store.point_pos[sel], normal=store.point_normal[sel],
                mind=store.point_min_dist[sel], maxd=store.point_max_dist[sel],
                desc=store.point_desc[sel])


class DeviceMapMirror:
    def __init__(self, store, device):
        """Copy the store's point arrays to `device`. Attach the mirror with
        `store.mirror = ...` inside the same `store.lock` section, so that no
        write lands between the copy and the first mark."""
        self.store = store
        self.device = torch.device(device)
        self.dirty = np.zeros(store.cap.max_map_points, bool)
        # serialises whole syncs: two interleaved read-clear-write sequences
        # would let a later one overwrite a row with older data after the
        # earlier one cleared its dirty bit
        self._sync_lock = threading.Lock()
        with store.lock:
            self.arrays = to_device(_host_rows(store), self.device)

    def mark(self, ids):
        ids = np.asarray(ids)
        if ids.size:
            self.dirty[ids[ids >= 0]] = True

    def sync(self):
        """Ship the dirty rows to the device (nothing when none is dirty)."""
        if not self.dirty.any():
            return
        s = self.store
        with self._sync_lock:
            with s.lock:
                ids = np.nonzero(self.dirty)[0]
                if ids.size == 0:
                    return
                self.dirty[ids] = False
                host = dict(ids=ids.astype(np.int64), **_host_rows(s, ids))
            d = to_device(host, self.device)
            for k in FIELDS:
                self.arrays[k].index_copy_(0, d["ids"], d[k])

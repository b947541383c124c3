"""Per-frame container (host-side view of device feature tensors).

Replaces the reference's Frame class (src/Frame.cc, include/Frame.h:92-425)
minus the compute: extraction/undistortion/stereo live in features/ and
matching/; the 64x48 feature grid (Frame.h:92) is unnecessary (masked
matrices replace grid pruning). This is a plain record: SoA keypoint arrays
(numpy, descriptors as uint32 words), pose, and the keypoint→map-point
association vector. A frame built from images also carries the frontend's
device tensors (`dev`), so the tracking step reads them where they are and
the host copy is fetched together with the step's results.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gf_orb_slam2_tpu_torch.utils.transfer import desc_to_numpy, to_host

HOST_FIELDS = ("uv", "octave", "angle", "desc", "response", "valid",
               "u_right", "depth")


@dataclasses.dataclass
class Frame:
    frame_id: int
    timestamp: float
    uv: np.ndarray        # [N,2] f32 rectified/undistorted pixel coords
    octave: np.ndarray    # [N] i32
    angle: np.ndarray     # [N] f32
    desc: np.ndarray      # [N,8] u32
    response: np.ndarray  # [N] f32
    u_right: np.ndarray   # [N] f32 (<0 mono)
    depth: np.ndarray     # [N] f32 (<0 unknown)
    valid: np.ndarray     # [N] bool
    R: np.ndarray = None  # [3,3] world→cam
    t: np.ndarray = None  # [3]
    mp_ids: np.ndarray = None  # [N] i32 map point per keypoint (-1)
    is_outlier: np.ndarray = None  # [N] bool (pose-opt gating)
    dev: Optional[dict] = None  # frontend device tensors keyed by HOST_FIELDS

    def __post_init__(self):
        if self.R is None:
            self.R = np.eye(3, dtype=np.float32)
        if self.t is None:
            self.t = np.zeros(3, np.float32)
        if self.uv is not None:
            self._init_assoc()

    def _init_assoc(self):
        n = self.uv.shape[0]
        if self.mp_ids is None:
            self.mp_ids = np.full(n, -1, np.int32)
        if self.is_outlier is None:
            self.is_outlier = np.zeros(n, bool)

    @staticmethod
    def deferred(frame_id, timestamp, dev: dict) -> "Frame":
        """Frame whose host arrays are fetched lazily — the tracker batches
        the fetch with its own result transfer (one device sync per frame)."""
        f = Frame(frame_id=frame_id, timestamp=timestamp, uv=None, octave=None,
                  angle=None, desc=None, response=None, u_right=None,
                  depth=None, valid=None)
        f.dev = dev
        return f

    def fill_host(self, host: dict):
        """Install fetched host arrays (a dict holding HOST_FIELDS)."""
        for k in HOST_FIELDS:
            setattr(self, k, host[k])
        self.desc = desc_to_numpy(self.desc)
        self._init_assoc()

    def ensure_host(self):
        if self.uv is None and self.dev is not None:
            self.fill_host(to_host({k: self.dev[k] for k in HOST_FIELDS}))

    @property
    def n_kp(self) -> int:
        return int(self.valid.sum())

    @property
    def n_matched(self) -> int:
        return int(((self.mp_ids >= 0) & ~self.is_outlier).sum())

    def center(self) -> np.ndarray:
        return -self.R.T @ self.t

    def pose_matrix(self) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = self.R
        T[:3, 3] = self.t
        return T

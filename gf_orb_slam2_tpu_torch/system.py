"""System facade: the user-facing SLAM engine API.

Replacement for ORB_SLAM2::System (reference: include/System.h:69,
src/System.cc:43): constructs the map and the tracker, exposes per-frame
TrackStereo, reset and trajectory savers. The pipeline is an explicit
host-side sequence per frame: the frontend and the tracking step run on the
device, the keyframe policy and map bookkeeping on the host.

This package covers synchronous stereo tracking with synchronous local
mapping: the tracker inserts keyframes and their close stereo points, and
every keyframe event then runs the local mapper (triangulation, fusion,
local bundle adjustment with good-graph selection, KF culling) before the
next frame. Loop closing, relocalization, the pipelined/asynchronous drivers
and the mono/RGB-D sensors are not part of it yet; the options that would
ask for them raise instead of being ignored.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gf_orb_slam2_tpu_torch.config import Sensor, SystemConfig
from gf_orb_slam2_tpu_torch.features.extractor import ORBExtractor
from gf_orb_slam2_tpu_torch.geometry import camera as cam_mod
from gf_orb_slam2_tpu_torch.io import trajectory as traj_io
from gf_orb_slam2_tpu_torch.mapping.local_mapping import LocalMapper
from gf_orb_slam2_tpu_torch.matching import stereo as stereo_mod
from gf_orb_slam2_tpu_torch.slammap.store import MapStore
from gf_orb_slam2_tpu_torch.tracking.frame import HOST_FIELDS, Frame
from gf_orb_slam2_tpu_torch.tracking.tracker import Tracker, TrackState


def _to_u8(im) -> np.ndarray:
    """Grayscale image → uint8 (uploads 4x smaller than f32; intensities are
    0-255 integers in the reference pipeline anyway)."""
    im = np.asarray(im)
    if im.dtype == np.uint8:
        return im
    return np.clip(im, 0, 255).astype(np.uint8)


class System:
    def __init__(self, cfg: SystemConfig, device="cuda"):
        """`device` is taken as given: with the default and no CUDA device
        present, construction raises (nothing falls back to the CPU)."""
        if cfg.loop.enabled:
            raise NotImplementedError(
                "loop closing is not part of this package yet: pass "
                "loop=LoopClosingConfig(enabled=False)")
        if cfg.tracking.async_mapping:
            raise NotImplementedError(
                "asynchronous mapping is not part of this package yet: pass "
                "tracking=TrackingConfig(async_mapping=False)")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"System(device={device!r}): no CUDA device is available; "
                "pass device='cpu' explicitly to run on the CPU")
        cam = cfg.camera
        n_kp = cfg.capacity.max_keypoints
        self.extractor = ORBExtractor(cfg.orb, cam.height, cam.width, self.device)
        # pad feature capacity to the configured keypoint capacity
        assert self.extractor.n_total <= n_kp, "orb.n_features > capacity.max_keypoints"
        self.n_kp = n_kp
        self.store = MapStore(cfg.capacity, n_kp)
        scales = np.asarray(self.extractor.scales, np.float32)
        self._scales_dev = torch.from_numpy(scales).to(self.device)
        self.tracker = Tracker(cfg, self.store, n_kp, scales, self.device)
        self.mapper = LocalMapper(cfg, self.store, n_kp, scales, self.device)
        # anticipation budgeting reads the tracker's motion model
        self.mapper.velocity_provider = lambda: self.tracker.velocity
        self.frame_id = 0
        self._rectify_left: Optional[cam_mod.RectifyMap] = None
        self._rectify_right: Optional[cam_mod.RectifyMap] = None
        if cam.left_K is not None:
            self._rectify_left = cam_mod.RectifyMap.from_np(
                cam.left_K, cam.left_D, cam.left_R, cam.left_P, cam.fisheye,
                self.device)
            self._rectify_right = cam_mod.RectifyMap.from_np(
                cam.right_K, cam.right_D, cam.right_R, cam.right_P, cam.fisheye,
                self.device)
        self._pin = cam_mod.PinholeCamera.from_config(cam, self.device)

    # ------------------------------------------------------------ tracking
    def track_stereo(self, im_left, im_right, timestamp: float) -> np.ndarray:
        """Reference: System::TrackStereo (System.cc:144) → 4x4 Tcw."""
        assert self.cfg.sensor == Sensor.STEREO
        frame = self._build_stereo_frame(im_left, im_right, timestamp)
        return self._track(frame)

    def _track(self, frame: Frame) -> np.ndarray:
        st = self.tracker.process_frame(frame)
        # hard reset when lost far too long (reference: System.cc:195-209)
        if self.tracker.state == TrackState.LOST and not self.cfg.localization_only:
            if self.tracker.n_lost > self.cfg.tracking.max_lost_frames:
                self.reset()
        if st.created_kf and not self.cfg.localization_only:
            self._on_keyframe(self.tracker.ref_kf)
        self.frame_id += 1
        return frame.pose_matrix()

    def _on_keyframe(self, kf: int):
        """KF post-processing: the local mapping stages, synchronously
        (reference: LocalMapping::Run, run here before the next frame)."""
        self.mapper.process_keyframe(kf)

    # ------------------------------------------------------- frame builders
    def _pad_feats(self, f):
        """Pad the extractor's n_total slots to the keypoint capacity."""
        pad = self.n_kp - self.extractor.n_total

        def p(a, fill=0):
            if pad == 0:
                return a
            shape = (a.shape[0], pad) + a.shape[2:]
            return torch.cat([a, torch.full(shape, fill, dtype=a.dtype, device=a.device)], 1)

        return (p(f.uv), p(f.octave), p(f.angle), p(f.desc), p(f.response),
                p(f.valid, False))

    def _frontend_stereo_impl(self, imgs):
        """imgs: [2,H,W] stacked (left, right) on the device → dict of the
        left frame's tensors keyed by tracking.frame.HOST_FIELDS. Both images
        go through ONE batched extraction."""
        imgs = imgs.to(torch.float32)
        uv, octv, ang, desc, resp, val = self._pad_feats(self.extractor.extract_batch(imgs))
        if self._rectify_left is not None:
            uv = torch.stack([cam_mod.rectify_keypoints(self._rectify_left, uv[0]),
                              cam_mod.rectify_keypoints(self._rectify_right, uv[1])])
        elif any(self.cfg.camera.dist):
            uv = cam_mod.undistort_keypoints(self._pin, uv)
        sm = stereo_mod.match_stereo(
            uv[0], octv[0], desc[0], val[0], uv[1], octv[1], desc[1], val[1],
            imgs[0], imgs[1], self._scales_dev, self.cfg.camera.bf,
        )
        out = dict(uv=uv[0], octave=octv[0], angle=ang[0], desc=desc[0],
                   response=resp[0], valid=val[0], u_right=sm.u_right,
                   depth=sm.depth)
        assert set(out) == set(HOST_FIELDS)
        return out

    def _build_stereo_frame(self, im_left, im_right, ts) -> Frame:
        # ONE upload for the image pair, as uint8 (cast on the device). The
        # frame's host arrays are fetched inside the tracker together with
        # the tracking results: one blocking sync per frame.
        imgs = torch.from_numpy(np.stack([_to_u8(im_left), _to_u8(im_right)]))
        out = self._frontend_stereo_impl(imgs.to(self.device))
        return Frame.deferred(self.frame_id, ts, out)

    # ------------------------------------------------------------ lifecycle
    @property
    def state(self) -> TrackState:
        return self.tracker.state

    def reset(self):
        """Reference: System::Reset (System.cc:376) → Tracking::Reset."""
        self.store.clear()
        tr = self.tracker
        tr.state = TrackState.NO_IMAGES_YET
        tr.last_frame = None
        tr.velocity = None
        tr.ref_kf = -1
        tr.n_lost = 0
        tr._cached_pool = None
        tr.relative_poses.clear()
        self.mapper.recent_points.clear()

    def shutdown(self):
        """Reference: System::Shutdown (System.cc:382). This slice starts no
        worker thread; waits for the device to finish what was enqueued."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ----------------------------------------------------------- trajectory
    def save_trajectory_tum(self, path):
        traj_io.save_trajectory_tum(path, self.tracker.relative_poses, self.store)

    def save_keyframe_trajectory_tum(self, path):
        traj_io.save_keyframe_trajectory_tum(path, self.store)

    def save_trajectory_kitti(self, path):
        traj_io.save_trajectory_kitti(path, self.tracker.relative_poses, self.store)

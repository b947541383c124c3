"""System facade: the user-facing SLAM engine API.

Replacement for ORB_SLAM2::System (reference: include/System.h:69,
src/System.cc:43): constructs the map, the tracker and the local mapper,
exposes per-frame TrackStereo, reset and trajectory savers.

Two drivers:
- `track_stereo`: one frame at a time — the frontend and the tracking step
  run on the device, the keyframe policy and map bookkeeping on the host,
  with one blocking download per frame; every keyframe event runs the local
  mapper (triangulation, fusion, local bundle adjustment with good-graph
  selection, KF culling) before the next frame.
- `track_stereo_pipelined`: frames stream through `Tracker.stream_dispatch`,
  whose pose prediction and match state chain on the device and whose
  candidate pool is gathered from the device map mirror; each frame's
  results download without blocking and are completed `pipeline_depth`
  frames later. With `tracking.async_mapping` the keyframe events go to a
  mapping worker thread (the reference's LocalMapping thread,
  System.cc:113-124) that runs on its own CUDA stream.

Loop closing, relocalization and the mono/RGB-D sensors are not part of this
package yet; the options that would ask for them raise instead of being
ignored.
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Optional

import numpy as np
import torch

from gf_orb_slam2_tpu_torch.config import Sensor, SystemConfig
from gf_orb_slam2_tpu_torch.features.extractor import ORBExtractor
from gf_orb_slam2_tpu_torch.geometry import camera as cam_mod
from gf_orb_slam2_tpu_torch.io import trajectory as traj_io
from gf_orb_slam2_tpu_torch.mapping.local_mapping import LocalMapper
from gf_orb_slam2_tpu_torch.matching import stereo as stereo_mod
from gf_orb_slam2_tpu_torch.slammap.device_mirror import DeviceMapMirror
from gf_orb_slam2_tpu_torch.slammap.store import MapStore
from gf_orb_slam2_tpu_torch.tracking.frame import HOST_FIELDS, Frame
from gf_orb_slam2_tpu_torch.tracking.tracker import Tracker, TrackState
from gf_orb_slam2_tpu_torch.utils.transfer import to_device, to_host_async

MAPPING_THREAD = "mapping"  # name of the mapping worker's thread


def _to_u8(im) -> np.ndarray:
    """Grayscale image → uint8 (uploads 4x smaller than f32; intensities are
    0-255 integers in the reference pipeline anyway)."""
    im = np.asarray(im)
    if im.dtype == np.uint8:
        return im
    return np.clip(im, 0, 255).astype(np.uint8)


class _MappingWorker:
    """The asynchronous local mapper: keyframes queue here from the pipelined
    driver and run through `System._on_keyframe` on a thread of their own
    (the reference's LocalMapping thread, System.cc:113-124). The mapper's
    stages take store.lock around their host work only, so tracking
    bookkeeping interleaves with their device work. On a CUDA device the
    worker enqueues everything on its own stream, created once: the mapper's
    tensors never cross to the tracking stream, and what it produces reaches
    the tracker through the host store and the device map mirror.

    When keyframes pile up, the backlog runs as one batch whose older KFs
    skip the window BA (the reference's mbAbortBA, LocalMapping.cc:155): the
    newest KF's BA window covers them. Accounting: `n_kf_events` =
    `n_ba_runs` + `n_ba_merged`. An exception on the worker is raised by the
    next `wait_idle()`."""

    def __init__(self, system: "System"):
        self.sys = system
        self._q = queue.Queue()
        self._error = None
        self.n_kf_events = 0
        self.n_ba_runs = 0
        self.n_ba_merged = 0
        self.max_batch = 0
        # held while a batch runs; pause() takes it between batches
        self._work_lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, name=MAPPING_THREAD,
                                        daemon=True)
        self._thread.start()

    def pause(self):
        """Block until the current batch finishes; mapping stays paused
        until resume()."""
        self._work_lock.acquire()

    def resume(self):
        self._work_lock.release()

    def submit(self, kf: int):
        self._q.put(kf)

    def queue_depth(self) -> int:
        return self._q.qsize()

    def _run(self):
        device = self.sys.device
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        while True:
            kf = self._q.get()
            if kf is None:
                self._q.task_done()
                return
            batch, stop = [kf], False
            while True:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                batch.append(nxt)
            self.max_batch = max(self.max_batch, len(batch))
            try:
                with self._work_lock:
                    for i, k in enumerate(batch):
                        last = i == len(batch) - 1
                        if stream is None:
                            self.sys._on_keyframe(k, skip_ba=not last)
                        else:
                            with torch.cuda.stream(stream):
                                self.sys._on_keyframe(k, skip_ba=not last)
                        self.n_kf_events += 1
                        if last:
                            self.n_ba_runs += 1
                        else:
                            self.n_ba_merged += 1
            except Exception as e:  # raised at the next wait_idle()
                self._error = e
            finally:
                for _ in batch:
                    self._q.task_done()
                if stop:
                    self._q.task_done()
            if stop:
                return

    def wait_idle(self):
        """Block until every submitted KF is processed; raise what failed."""
        self._q.join()
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def stop(self):
        self._q.put(None)
        self._q.join()
        self._thread.join()


class System:
    def __init__(self, cfg: SystemConfig, device="cuda"):
        """`device` is taken as given: with the default and no CUDA device
        present, construction raises (nothing falls back to the CPU)."""
        if cfg.loop.enabled:
            raise NotImplementedError(
                "loop closing is not part of this package yet: pass "
                "loop=LoopClosingConfig(enabled=False)")
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
        # pipelined driver: (frame, pool ids, pending download) per frame in
        # flight, oldest first
        self._inflight = deque()
        self._pipeline_depth = cfg.tracking.pipeline_depth
        self._map_worker: Optional[_MappingWorker] = None
        self.n_stream_fallbacks = 0  # streamed frames tracked synchronously
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

    def track_stereo_pipelined(self, im_left, im_right, timestamp: float):
        """Streaming stereo tracking: submit this frame and return the list
        of (frame_id, Tcw) results completed by THIS call — normally one,
        `pipeline_depth` frames behind; none while the pipeline fills. Call
        `flush_pipeline()` at the end of a sequence.

        The frame's images and the pool's ids and lifetimes go up in one
        copy; the frontend and the streaming step (Tracker.stream_dispatch)
        are enqueued, then the download of their results, into pinned
        buffers behind a CUDA event: dispatching a frame waits for nothing
        on the device. A frame that cannot stream (no velocity or pool yet,
        or the track was lost) is tracked synchronously after the pipeline
        drains, and counted in `n_stream_fallbacks`.

        Left out: the JAX package's rebase of the chain after a loop
        correction moves the map (`pending_map_rebase`): only its loop
        closer sets it, and loop closing is not part of this package.
        """
        assert self.cfg.sensor == Sensor.STEREO
        tr = self.tracker
        if not tr.stream_ready():
            done = self.flush_pipeline()
            pose = self.track_stereo(im_left, im_right, timestamp)
            return done + [(self.frame_id - 1, pose)]
        if self.store.mirror is None:
            with self.store.lock:
                self.store.mirror = DeviceMapMirror(self.store, self.device)
        if tr._chain is None:
            tr._chain = tr.stream_bootstrap_chain()
        # complete the oldest frames first, so that their bookkeeping (pool,
        # keyframes) feeds this dispatch
        done = []
        while len(self._inflight) >= self._pipeline_depth:
            done.append(self._complete_one())
        if not tr.stream_ready():  # a completion lost the track or its pool
            self.n_stream_fallbacks += 1
            done += self.flush_pipeline()
            pose = self.track_stereo(im_left, im_right, timestamp)
            return done + [(self.frame_id - 1, pose)]
        self._dispatch_stream(im_left, im_right, timestamp)
        return done

    def _dispatch_stream(self, im_left, im_right, timestamp: float):
        """Enqueue one streamed frame: mirror sync, the one upload, frontend,
        streaming step and the download of its results."""
        tr = self.tracker
        # after the completions: points their keyframes created or moved are
        # on the device before this step reads them
        self.store.mirror.sync()
        upload, pool_ids = tr.stream_prepare_upload(self.frame_id)
        d = to_device(dict(imgs=np.stack([_to_u8(im_left), _to_u8(im_right)]), **upload),
                      self.device)
        out = self._frontend_stereo_impl(d["imgs"])
        res = tr.stream_dispatch(out, d, self.frame_id)
        frame = Frame.deferred(self.frame_id, timestamp, out)
        self._inflight.append((frame, pool_ids, to_host_async(res)))
        self.frame_id += 1

    def _complete_one(self):
        frame, pool_ids, pending = self._inflight.popleft()
        st = self.tracker.stream_complete(frame, pending.wait(), pool_ids)
        if st.created_kf and not self.cfg.localization_only:
            self._keyframe_event(self.tracker.ref_kf)
        return frame.frame_id, frame.pose_matrix()

    def _keyframe_event(self, kf: int):
        """Map a new keyframe: on the mapping worker with
        `tracking.async_mapping`, else before the next frame."""
        if self.cfg.tracking.async_mapping:
            if self._map_worker is None:
                self._map_worker = _MappingWorker(self)
            self._map_worker.submit(kf)
        else:
            self._on_keyframe(kf)

    def flush_pipeline(self):
        """Complete every frame in flight and wait for the mapping worker;
        returns [(frame_id, Tcw), ...]. A mapping failure is raised here."""
        done = []
        while self._inflight:
            done.append(self._complete_one())
        self.tracker._chain = None
        if self._map_worker is not None:
            self._map_worker.wait_idle()
        return done

    def _track(self, frame: Frame) -> np.ndarray:
        if self._map_worker is not None:
            # the synchronous path reads the store without the worker's
            # locking discipline: settle the map first
            self._map_worker.wait_idle()
        st = self.tracker.process_frame(frame)
        # hard reset when lost far too long (reference: System.cc:195-209)
        if self.tracker.state == TrackState.LOST and not self.cfg.localization_only:
            if self.tracker.n_lost > self.cfg.tracking.max_lost_frames:
                self.reset()
        if st.created_kf and not self.cfg.localization_only:
            self._keyframe_event(self.tracker.ref_kf)
        self.frame_id += 1
        return frame.pose_matrix()

    def _on_keyframe(self, kf: int, skip_ba: bool = False):
        """KF post-processing: the local mapping stages (reference:
        LocalMapping::Run) — before the next frame on the synchronous path,
        on the mapping worker with `tracking.async_mapping`."""
        self.mapper.process_keyframe(kf, skip_ba=skip_ba)

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
        """Reference: System::Reset (System.cc:376) → Tracking::Reset. Waits
        for the mapping worker and drops the frames in flight."""
        if self._map_worker is not None:
            self._map_worker.wait_idle()
        self._inflight.clear()
        self.tracker._chain = None
        self.store.clear()  # detaches the device mirror too
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
        """Reference: System::Shutdown (System.cc:382): completes the frames
        in flight, stops and joins the mapping worker, and waits for the
        device to finish what was enqueued."""
        try:
            self.flush_pipeline()
        finally:
            if self._map_worker is not None:
                self._map_worker.stop()
                self._map_worker = None
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    # ----------------------------------------------------------- trajectory
    def save_trajectory_tum(self, path):
        traj_io.save_trajectory_tum(path, self.tracker.relative_poses, self.store)

    def save_keyframe_trajectory_tum(self, path):
        traj_io.save_keyframe_trajectory_tum(path, self.store)

    def save_trajectory_kitti(self, path):
        traj_io.save_trajectory_kitti(path, self.tracker.relative_poses, self.store)

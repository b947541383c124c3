"""System facade: the user-facing SLAM engine API.

Replacement for ORB_SLAM2::System (reference: include/System.h:69,
src/System.cc:43): constructs the map, the tracker and the local mapper,
exposes per-frame TrackStereo / TrackRGBD / TrackMonocular, forced
relocalization and re-initialization, reset and trajectory savers.

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

With `loop.enabled` (the default) every mapped keyframe then goes through
place recognition and loop closing (loopclosing/loop_closer.py): before the
next frame on the synchronous path, on a loop worker thread of its own (the
reference's LoopClosing thread) with async mapping. A correction moves the
map; live tracking learns it through `Tracker.notify_map_rebase` and applies
it before its next frame. The global BA after a correction runs on a
detached thread unless `loop.synchronous_gba`.

`track_rgbd` and `track_monocular` are synchronous entries of their own:
an RGB-D frame samples its depth map at the keypoints and initializes as a
stereo frame does; a monocular tracker bootstraps from two views
(tracking/initializer.py) and closes loops with a free scale. A LOST
tracker relocalizes against the keyframe database's candidates.

With `hashing.enabled` one multi-index hash (hashing/mih.py, host C++) is
shared by the tracker, which assembles its local map from it past
`hashing.map_size_trigger` points, and the local mapper, which inserts every
mapped keyframe's points; each call holds the store's lock.

The rest of the reference's facade: map save/load (io/map_io.py, the JAX
package's .npz layout) with localization-only mode, planner odometry
(`buffer_odometry`), the ChArUco world anchor at stereo initialization, the
per-frame TUM stream (`set_realtime_stream`), the tracking, mapping, loop and
landmark logs, and the runtime budgets (`set_constr_per_frame`,
`set_budget_per_frame`), each taking effect at the next dispatch.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from gf_orb_slam2_tpu_torch.config import Sensor, SystemConfig
from gf_orb_slam2_tpu_torch.features.extractor import ORBExtractor
from gf_orb_slam2_tpu_torch.geometry import camera as cam_mod
from gf_orb_slam2_tpu_torch.hashing.mih import MultiIndexHashing
from gf_orb_slam2_tpu_torch.io import map_io, trajectory as traj_io
from gf_orb_slam2_tpu_torch.loopclosing.loop_closer import LoopCloser
from gf_orb_slam2_tpu_torch.mapping.local_mapping import LocalMapper
from gf_orb_slam2_tpu_torch.matching import stereo as stereo_mod
from gf_orb_slam2_tpu_torch.ops import hamming_cuda
from gf_orb_slam2_tpu_torch.place.keyframe_db import KeyFrameDatabase
from gf_orb_slam2_tpu_torch.place.vocabulary import Vocabulary
from gf_orb_slam2_tpu_torch.selection.good_graph import estimate_kf_budget
from gf_orb_slam2_tpu_torch.slammap.device_mirror import DeviceMapMirror
from gf_orb_slam2_tpu_torch.slammap.store import MapStore
from gf_orb_slam2_tpu_torch.tracking.frame import HOST_FIELDS, Frame
from gf_orb_slam2_tpu_torch.tracking.tracker import Tracker, TrackState
from gf_orb_slam2_tpu_torch.utils import tracing
from gf_orb_slam2_tpu_torch.utils.cuda_graph import GraphCache
from gf_orb_slam2_tpu_torch.utils.transfer import to_device, to_host_async

MAPPING_THREAD = "mapping"  # name of the mapping worker's thread
LOOP_THREAD = "loop"        # name of the loop worker's thread
# the vocabularies shipped with the JAX package, read as data (never
# imported): the largest first, as that package picks them
VOCAB_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "gf_orb_slam2_tpu", "assets")
VOCAB_FILES = ("vocab100k.npz", "vocab10k.npz")
# fields of the port's stats records that the JAX package's records lack:
# the log savers leave them out, so both packages write the same keys
_PORT_ONLY_LOG_FIELDS = frozenset({"path", "ba_discarded"})


def _save_stats_log(path, stats):
    """One JSON object per stats record (dataclass), plain Python values."""
    with open(path, "w") as f:
        for st in stats:
            row = {k: (v.item() if hasattr(v, "item") else v)
                   for k, v in dataclasses.asdict(st).items()
                   if k not in _PORT_ONLY_LOG_FIELDS}
            f.write(json.dumps(row) + "\n")


def _to_u8(im) -> np.ndarray:
    """Grayscale image → uint8 (uploads 4x smaller than f32; intensities are
    0-255 integers in the reference pipeline anyway)."""
    im = np.asarray(im)
    if im.dtype == np.uint8:
        return im
    return np.clip(im, 0, 255).astype(np.uint8)


class _Worker:
    """A thread fed keyframe ids through a queue (None stops it). Subclasses
    give `_run`; an exception on the thread is raised by the next
    `wait_idle()`."""

    def __init__(self, system: "System", name: str):
        self.sys = system
        self._q = queue.Queue()
        self._error = None
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)

    def _stream(self):
        """The thread's own CUDA stream (None on the CPU)."""
        device = self.sys.device
        return torch.cuda.Stream(device) if device.type == "cuda" else None

    def submit(self, kf: int):
        # the submit time travels with the KF: its wait in the queue is a span
        self._q.put((kf, time.time_ns()))

    def queue_depth(self) -> int:
        return self._q.qsize()

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


class _MappingWorker(_Worker):
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
        super().__init__(system, MAPPING_THREAD)
        self.n_kf_events = 0
        self.n_ba_runs = 0
        self.n_ba_merged = 0
        self.max_batch = 0
        # held while a batch runs; pause() takes it between batches
        self._work_lock = threading.Lock()
        self._thread.start()

    def pause(self):
        """Block until the current batch finishes; mapping stays paused
        until resume()."""
        self._work_lock.acquire()

    def resume(self):
        self._work_lock.release()

    def _run(self):
        stream = self._stream()
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            batch, stop = [item], False
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
            start = time.time_ns()
            for k, t_submit in batch:
                tracing.record("map.queued", t_submit, start, kf=k)
            try:
                with self._work_lock:
                    for i, (k, _) in enumerate(batch):
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


class _LoopWorker(_Worker):
    """The loop closer on a thread of its own (reference: System.cc:117
    spawns LoopClosing apart from LocalMapping): detection and Sim3 never
    delay the next keyframe's mapping. Keyframes queue here from the mapping
    worker; on a CUDA device the thread enqueues on its own stream."""

    def __init__(self, system: "System"):
        super().__init__(system, LOOP_THREAD)
        self.n_events = 0
        self._thread.start()

    def _run(self):
        stream = self._stream()
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            kf, t_submit = item
            tracing.record("loop.queued", t_submit, time.time_ns(), kf=kf)
            try:
                if stream is None:
                    self.sys.loop_closer.process_keyframe(kf)
                else:
                    with torch.cuda.stream(stream):
                        self.sys.loop_closer.process_keyframe(kf)
                self.n_events += 1
            except Exception as e:  # raised at the next wait_idle()
                self._error = e
            finally:
                self._q.task_done()


class System:
    def __init__(self, cfg: SystemConfig, device="cuda"):
        """`device` is taken as given: with the default and no CUDA device
        present, construction raises (nothing falls back to the CPU)."""
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
        if cfg.hashing.enabled:
            # one set of tables: the mapper inserts, the tracker queries
            mih = MultiIndexHashing(cfg.hashing, cfg.capacity.max_map_points)
            self.tracker.mih = mih
            self.mapper.mih = mih
        self.frame_id = 0
        self._rt_stream = None  # the per-frame TUM pose stream, when set
        # pipelined driver: (frame, pool ids, pending download) per frame in
        # flight, oldest first
        self._inflight = deque()
        self._pipeline_depth = cfg.tracking.pipeline_depth
        self._map_worker: Optional[_MappingWorker] = None
        self._loop_worker: Optional[_LoopWorker] = None
        self.n_stream_fallbacks = 0  # streamed frames tracked synchronously
        # place recognition and loop closing (reference wiring:
        # System.cc:78-118): the vocabulary is loaded up front; without one
        # (`vocabulary_path=""`) a vocabulary is trained from the first
        # keyframes' descriptors once there are enough of them
        self.voc = None
        self.kfdb = None
        self.loop_closer = None
        self._vocab_min_kfs = 8
        if cfg.loop.enabled:
            self._load_vocabulary()
            if self.voc is not None:
                self._ensure_place_recognition()
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
        # the frontend's captured CUDA graphs, one per input signature
        self._frontend_graphs = GraphCache("frontend")

    # ------------------------------------------------------------ tracking
    def track_stereo(self, im_left, im_right, timestamp: float) -> np.ndarray:
        """Reference: System::TrackStereo (System.cc:144) → 4x4 Tcw."""
        assert self.cfg.sensor == Sensor.STEREO
        with tracing.entry("frame", frame=self.frame_id):
            return self._track(self._build_stereo_frame(im_left, im_right, timestamp))

    def track_rgbd(self, im, depth_map, timestamp: float) -> np.ndarray:
        """Reference: System::TrackRGBD (System.cc:214) → 4x4 Tcw. The depth
        map is in the units of `camera.depth_map_factor` (raw sensor values
        divided by it give metres; a factor of 0 or 1 takes them as metres)."""
        assert self.cfg.sensor == Sensor.RGBD
        with tracing.entry("frame", frame=self.frame_id):
            return self._track(self._build_rgbd_frame(im, depth_map, timestamp))

    def track_monocular(self, im, timestamp: float) -> np.ndarray:
        """Reference: System::TrackMonocular (System.cc:282) → 4x4 Tcw."""
        assert self.cfg.sensor == Sensor.MONOCULAR
        with tracing.entry("frame", frame=self.frame_id):
            return self._track(self._build_mono_frame(im, timestamp))

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

        A loop correction (or a GBA write-back) that moved the map is
        applied here before the next dispatch: the frames still in flight
        were dispatched in the old world and complete first, then the chain,
        the last pose and the pool are rebased (`apply_pending_rebase`).
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
            return done + self._stream_fallback(im_left, im_right, timestamp)
        if tr.pending_map_rebase is not None:
            while self._inflight:
                done.append(self._complete_one())
            with self.store.lock:
                tr.apply_pending_rebase()
            if not tr.stream_ready():
                return done + self._stream_fallback(im_left, im_right, timestamp)
        self._dispatch_stream(im_left, im_right, timestamp)
        return done

    def _stream_fallback(self, im_left, im_right, timestamp: float):
        """Track a frame that cannot stream synchronously, after draining."""
        self.n_stream_fallbacks += 1
        done = self.flush_pipeline()
        pose = self.track_stereo(im_left, im_right, timestamp)
        return done + [(self.frame_id - 1, pose)]

    def _dispatch_stream(self, im_left, im_right, timestamp: float):
        """Enqueue one streamed frame: mirror sync, the one upload, frontend,
        streaming step and the download of its results."""
        tr = self.tracker
        with tracing.span("stream.dispatch", frame=self.frame_id):
            # after the completions: points their keyframes created or moved
            # are on the device before this step reads them
            self.store.mirror.sync()
            host, pool_ids = tr.stream_prepare_upload(self.frame_id)
            d = to_device(dict(imgs=np.stack([_to_u8(im_left), _to_u8(im_right)]), **host),
                          self.device)
            # the eager body, not the frontend's graph: with frames in flight
            # this driver's pace is not its enqueue, and the graph here left
            # the mapping worker further behind the stream (PERF.md §6, §7)
            with tracing.span("frontend.extract"):
                out = self._frontend_stereo_body(d["imgs"])
            res = tr.stream_dispatch(out, d, self.frame_id)
            frame = Frame.deferred(self.frame_id, timestamp, out)
            self._inflight.append((frame, pool_ids, to_host_async(res)))
        self.frame_id += 1

    def _complete_one(self):
        frame, pool_ids, pending = self._inflight.popleft()
        with tracing.span("stream.complete", frame=frame.frame_id):
            st = self.tracker.stream_complete(frame, pending.wait(), pool_ids)
            self._stream_pose(frame)
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
        """Complete every frame in flight and wait for the mapping worker,
        the loop worker and a detached GBA; returns [(frame_id, Tcw), ...].
        A failure on any of them is raised here."""
        done = []
        while self._inflight:
            done.append(self._complete_one())
        self.tracker._chain = None
        self._wait_workers()
        if self.loop_closer is not None:
            self.loop_closer.wait_gba()
        return done

    @tracing.spanned("frame.wait_workers")
    def _wait_workers(self):
        if self._map_worker is not None:
            self._map_worker.wait_idle()
        if self._loop_worker is not None:
            self._loop_worker.wait_idle()

    def track_frame(self, frame: Frame) -> np.ndarray:
        """Feature-level entry (synthetic data, tests): a host Frame with its
        keypoint arrays filled, tracked as `track_stereo` tracks an image
        pair's frame. Returns its 4x4 Tcw."""
        with tracing.entry("frame", frame=frame.frame_id):
            return self._track(frame)

    def _track(self, frame: Frame) -> np.ndarray:
        # the synchronous path reads the store without the workers' locking
        # discipline: settle the map first
        self._wait_workers()
        # a correction that landed before or DURING those waits is applied
        # now, before this frame reads the map
        with self.store.lock:
            self.tracker.apply_pending_rebase()
        st = self.tracker.process_frame(frame)
        # hard reset when lost right after a monocular initialization
        # (reference: Tracking.cc:813 — lost with ≤ 5 KFs → System::Reset) or
        # lost far too long (System.cc:195-209)
        if self.tracker.state == TrackState.LOST and not self.cfg.localization_only:
            if self.store.n_keyframes <= 5 and self.cfg.sensor == Sensor.MONOCULAR:
                self.reset()
            elif self.tracker.n_lost > self.cfg.tracking.max_lost_frames:
                self.reset()
        self._stream_pose(frame)
        if st.created_kf and not self.cfg.localization_only:
            self._keyframe_event(self.tracker.ref_kf)
        self.frame_id += 1
        return frame.pose_matrix()

    def _stream_pose(self, frame: Frame):
        """Append the frame's pose to the realtime stream, if one is set."""
        if self._rt_stream is not None and frame.R is not None:
            self._rt_stream.write(traj_io.tum_line(frame.timestamp, frame.pose_matrix()))
            self._rt_stream.flush()

    def _on_keyframe(self, kf: int, skip_ba: bool = False):
        """KF post-processing: the local mapping stages (reference:
        LocalMapping::Run), then loop closing — before the next frame on the
        synchronous path; with `tracking.async_mapping` on the mapping worker,
        which hands the KF on to the loop worker."""
        self.mapper.process_keyframe(kf, skip_ba=skip_ba)
        if not self.cfg.loop.enabled:
            return
        self._ensure_place_recognition()
        if self.loop_closer is None:
            return
        if self.cfg.tracking.async_mapping:
            if self._loop_worker is None:
                self._loop_worker = _LoopWorker(self)
            self._loop_worker.submit(kf)
        else:
            self.loop_closer.process_keyframe(kf)

    # -------------------------------------------------- place recognition
    def _load_vocabulary(self):
        """The BoW vocabulary (reference: System.cc:78-84).
        `cfg.vocabulary_path`: None → the repo's shipped vocabulary (the
        largest found); "" → none (trained lazily from the map); a path →
        that .npz."""
        path = self.cfg.vocabulary_path
        if path == "":
            return
        if path is None:
            path = next((p for p in (os.path.join(VOCAB_DIR, n) for n in VOCAB_FILES)
                         if os.path.exists(p)), None)
            if path is None:
                return
        self.voc = Vocabulary.load(path)

    def _ensure_place_recognition(self):
        """Stand up the KF database and the loop closer once a vocabulary
        exists (reference wiring: System.cc:96-118). Without a loaded one, a
        vocabulary is trained from the valid KFs' descriptors once there are
        `_vocab_min_kfs` KFs and 512 descriptors (a 20,000-descriptor sample
        drawn with `default_rng(0)`, as the JAX package draws it)."""
        if self.kfdb is not None:
            return
        if self.voc is None:
            if self.store.n_keyframes < self._vocab_min_kfs:
                return
            s = self.store
            with s.lock:  # snapshot descriptors; training runs unlocked
                data = np.concatenate([s.kf_desc[k][s.kf_kp_valid[k]]
                                       for k in s.valid_kf_ids()], 0)
            if len(data) < 512:
                return
            if len(data) > 20000:
                data = data[np.random.default_rng(0).choice(len(data), 20000, replace=False)]
            self.voc = Vocabulary.train(data, k=8, levels=3, iters=4)
        self.kfdb = KeyFrameDatabase(self.voc, self.store)
        for k in self.store.valid_kf_ids()[:-1]:
            self.kfdb.add(int(k))
        lc = LoopCloser(self.cfg, self.store, self.kfdb, self.device)
        lc.map_rebase_cb = self.tracker.notify_map_rebase
        lc.gba_writeback_cb = self._on_gba_writeback
        lc.pause_mapping_cb = self._pause_mapping
        lc.resume_mapping_cb = self._resume_mapping
        self.tracker.kfdb = self.kfdb
        # the device's one-time set-up for the loop stages, now rather than
        # in the first loop event
        self.loop_warm_up_ms = lc.warm_up()
        self.loop_closer = lc

    def _pause_mapping(self):
        if self._map_worker is not None:
            self._map_worker.pause()

    def _resume_mapping(self):
        if self._map_worker is not None:
            self._map_worker.resume()

    def _on_gba_writeback(self, before_R, before_t):
        """A GBA write-back rebases live tracking by its reference KF's pose
        change (store.lock held; see Tracker.notify_map_rebase)."""
        k = self.tracker.ref_kf
        s = self.store
        if k is None or k < 0 or not s.kf_valid[k]:
            return
        R_D = s.kf_R[k].T @ before_R[k]
        t_D = s.kf_R[k].T @ (before_t[k] - s.kf_t[k])
        ang = float(np.arccos(np.clip((np.trace(R_D) - 1) / 2, -1.0, 1.0)))
        if ang > 1e-4 or float(np.linalg.norm(t_D)) > 1e-4:
            self.tracker.notify_map_rebase(R_D, t_D)

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

    @tracing.spanned("frontend.extract")
    def _frontend_stereo_impl(self, imgs):
        """imgs: [2,H,W] stacked (left, right) on the device → dict of the
        left frame's tensors keyed by tracking.frame.HOST_FIELDS. Both images
        go through ONE batched extraction. On a CUDA device each input
        signature's first call is captured and later calls replay it
        (utils/cuda_graph.py): the same kernels in one launch."""
        return self._frontend_graphs.run("stereo", self._frontend_stereo_body, imgs)

    def _frontend_stereo_body(self, imgs):
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

    @tracing.spanned("frontend.extract")
    def _frontend_mono_impl(self, im, depth_map=None):
        """im: [H,W] on the device (uint8 or float); depth_map: [H,W] or None
        → dict keyed by HOST_FIELDS. Without a depth map a keypoint has no
        right coordinate and no depth (-1); with one, both come from the depth
        at the rounded keypoint (matching/stereo.depth_to_disparity). Captured
        and replayed on a CUDA device as `_frontend_stereo_impl` is."""
        return self._frontend_graphs.run("mono", self._frontend_mono_body, im, depth_map)

    def _frontend_mono_body(self, im, depth_map):
        f = self._pad_feats(self.extractor.extract_batch(im[None]))
        uv, octv, ang, desc, resp, valid = (a[0] for a in f)
        if any(self.cfg.camera.dist):
            uv = cam_mod.undistort_keypoints(self._pin, uv)
        if depth_map is None:
            ur = torch.full((self.n_kp,), -1.0, device=uv.device)
            dep = torch.full((self.n_kp,), -1.0, device=uv.device)
        else:
            dmf = self.cfg.camera.depth_map_factor
            factor = 1.0 / dmf if dmf not in (0, 1) else 1.0
            sm = stereo_mod.depth_to_disparity(uv, valid, depth_map.to(torch.float32),
                                               self.cfg.camera.bf, factor)
            ur, dep = sm.u_right, sm.depth
        return dict(uv=uv, octave=octv, angle=ang, desc=desc, response=resp,
                    valid=valid, u_right=ur, depth=dep)

    def _build_rgbd_frame(self, im, depth_map, ts) -> Frame:
        # ONE upload: the uint8 image and the depth map, straight into the
        # frontend graph's inputs once its signature is captured
        with tracing.span("frontend.upload"):
            im, depth = self._frontend_graphs.upload(
                "mono", self.device, _to_u8(im), np.asarray(depth_map, np.float32))
        return Frame.deferred(self.frame_id, ts, self._frontend_mono_impl(im, depth))

    def _build_mono_frame(self, im, ts) -> Frame:
        with tracing.span("frontend.upload"):
            im, _ = self._frontend_graphs.upload("mono", self.device, _to_u8(im), None)
        return Frame.deferred(self.frame_id, ts, self._frontend_mono_impl(im))

    def _build_stereo_frame(self, im_left, im_right, ts) -> Frame:
        # ONE upload for the image pair, as uint8 (cast on the device). The
        # frame's host arrays are fetched inside the tracker together with
        # the tracking results: one blocking sync per frame.
        with tracing.span("frontend.upload"):
            imgs, = self._frontend_graphs.upload(
                "stereo", self.device, np.stack([_to_u8(im_left), _to_u8(im_right)]))
        out = self._frontend_stereo_impl(imgs)
        frame = Frame.deferred(self.frame_id, ts, out)
        if self.cfg.charuco.enabled and self.state in (TrackState.NO_IMAGES_YET,
                                                       TrackState.NOT_INITIALIZED):
            # the ChArUco anchor's input (host only, until initialization)
            frame._raw_img = np.asarray(im_left)
        return frame

    # ------------------------------------------------------------ lifecycle
    @property
    def state(self) -> TrackState:
        return self.tracker.state

    def set_realtime_stream(self, path):
        """Per-frame TUM-format pose stream appended as tracking runs
        (reference: System::SetRealTimeFileStream System.cc:415); closed by
        `shutdown` or by setting another."""
        if self._rt_stream is not None:
            self._rt_stream.close()
        self._rt_stream = open(path, "w")

    def buffer_odometry(self, timestamp: float, R, t):
        """Push a planner-predicted world→cam pose for `timestamp`
        (reference: System/Tracking BufferingOdom Tracking.cc:503, fed from
        the /desired_path topic in ros_stereo.cc:171). When the buffer covers
        the tracked timestamps, the motion-model prediction uses it instead
        of constant velocity (PredictRelMotionFromBuffer Tracking.cc:1448)."""
        self.tracker.odom.push(timestamp, np.asarray(R, np.float32),
                               np.asarray(t, np.float32))

    def set_constr_per_frame(self, n: int):
        """Good-feature budget: number of actively matched constraints/frame
        (reference: System::SetConstrPerFrame System.cc:444). Every tracking
        step reads the budget from the tracker's configuration: the next
        dispatch, synchronous or streamed, uses it."""
        gf = dataclasses.replace(self.cfg.good_feature, constr_per_frame=int(n))
        self.cfg = self.cfg.replace(good_feature=gf)
        self.tracker.cfg = self.cfg

    def set_budget_per_frame(self, budget_ms: float):
        """Map good-graph time budget → subgraph size via the cubic model
        (reference: System::SetBudgetPerFrame System.cc:433 +
        estimateKFNum Optimizer.cc:566); the next keyframe event uses it."""
        gg = dataclasses.replace(self.cfg.good_graph,
                                 subgraph_size=estimate_kf_budget(budget_ms))
        self.cfg = self.cfg.replace(good_graph=gg)
        self.mapper.cfg = self.cfg

    def activate_localization_mode(self):
        """Reference: System::ActivateLocalizationMode (System.cc:~340): no
        keyframe is created and none is mapped."""
        self.cfg = self.cfg.replace(localization_only=True)
        self.tracker.cfg = self.cfg

    def deactivate_localization_mode(self):
        self.cfg = self.cfg.replace(localization_only=False)
        self.tracker.cfg = self.cfg

    def force_reloc(self):
        """Reference: System::ForceRelocTracker (System.cc:798): the next
        frame goes through relocalization."""
        self.tracker.state = TrackState.LOST
        self.tracker.velocity = None

    def force_reinit(self):
        """Reference: System::ForceInitTracker (System.cc:802): a full reset,
        then initialization from scratch."""
        self.reset()

    def reset(self):
        """Reference: System::Reset (System.cc:376) → Tracking::Reset. Waits
        for the workers, aborts a running GBA (it must not write old-map
        poses onto the slots of the new map) and drops the frames in
        flight."""
        self._wait_workers()
        if self.loop_closer is not None:
            self.loop_closer.abort_gba()
            self.loop_closer._consistent.clear()
            self.loop_closer.last_loop_kf = -1
        if self.kfdb is not None:
            self.kfdb.clear()
        self._inflight.clear()
        self.tracker._chain = None
        self.tracker.pending_map_rebase = None
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

    def wait_prewarm(self, timeout=None):
        """Finish the device's set-up before a timed run, as the JAX
        package's `wait_prewarm` joins its compile threads: on CUDA, build
        (nvcc) or load the CUDA kernels (all of `csrc/*.cu`, one library),
        which the first frame would otherwise pay. The rest of the set-up already ran at construction
        (`LoopCloser.warm_up`, whose first launch builds the kernels when
        loop closing is on; the hash's host library). Nothing of it runs in
        the background, so this returns when the build is done and
        `timeout` (the JAX signature's) bounds nothing; a failed build
        raises. On the CPU nothing is pending."""
        if self.device.type == "cuda":
            hamming_cuda.load()

    def shutdown(self):
        """Reference: System::Shutdown (System.cc:382): completes the frames
        in flight, stops and joins the mapping and loop workers, joins a
        running GBA, and waits for the device to finish what was enqueued."""
        try:
            self.flush_pipeline()
        finally:
            if self._map_worker is not None:
                self._map_worker.stop()
                self._map_worker = None
            if self._loop_worker is not None:
                self._loop_worker.stop()
                self._loop_worker = None
            if self.loop_closer is not None:
                self.loop_closer.abort_gba()
            if self._rt_stream is not None:
                self._rt_stream.close()
                self._rt_stream = None
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    # ----------------------------------------------------------- map io
    def save_map(self, path):
        """Reference: System::SaveMap (System.cc:1315): the store as one .npz
        (io/map_io.py) and the vocabulary beside it as `<path>.voc.npz`. The
        shipped vocabulary is read for the sidecar when loop closing is off
        (the JAX package loads it at construction either way)."""
        map_io.save_map(path, self.store)
        if self.voc is None:
            self._load_vocabulary()
        if self.voc is not None:
            self.voc.save(str(path) + ".voc.npz")

    def load_map(self, path):
        """Reference: System::LoadMap (System.cc:907), typically followed by
        `activate_localization_mode()`. The frames in flight and the workers'
        events complete first; the store is overwritten in place (detaching
        the device map mirror) and tracking restarts LOST, so the next frame
        relocalizes against the loaded map. As in the JAX package, a sidecar
        vocabulary sets up the KF database only if none exists yet (loop
        closing off): with loop closing on, the database built at
        construction stays empty and relocalization tries the newest KFs.
        The hash tables are not rebuilt from the loaded points."""
        self.flush_pipeline()
        map_io.load_map(path, self.store)
        voc_path = str(path) + ".voc.npz"
        if os.path.exists(voc_path):
            self.voc = Vocabulary.load(voc_path)
            self._ensure_place_recognition()
        self.tracker.state = TrackState.LOST
        if self.store.n_keyframes:
            self.tracker.ref_kf = int(self.store.valid_kf_ids()[-1])

    # ----------------------------------------------------------- trajectory
    def save_trajectory_tum(self, path):
        traj_io.save_trajectory_tum(path, self.tracker.relative_poses, self.store)

    def save_keyframe_trajectory_tum(self, path):
        traj_io.save_keyframe_trajectory_tum(path, self.store)

    def save_trajectory_kitti(self, path):
        traj_io.save_trajectory_kitti(path, self.tracker.relative_poses, self.store)

    # ----------------------------------------------------------------- logs
    def save_tracking_log(self, path):
        """Reference: System::SaveTrackingLog (System.cc:501): one JSON line
        per frame."""
        _save_stats_log(path, self.tracker.stats)

    def save_loop_log(self, path):
        """Per-KF loop-closing log (detection/sim3/correction stats)."""
        _save_stats_log(path, self.loop_closer.stats if self.loop_closer is not None else [])

    def save_mapping_log(self, path):
        """Reference: System::SaveMappingLog (System.cc:542) — per-KF BA
        stage log (MappingLog Util.hpp:282)."""
        _save_stats_log(path, self.mapper.stats)

    def save_lmk_log(self, path):
        """Landmark-lifetime log (reference: System::SaveLmkLog System.cc:479,
        LmkLog Util.hpp:384): per-landmark visible/found counters, observation
        count, and first keyframe."""
        s = self.store
        with open(path, "w") as f:
            for p in s.valid_point_ids():
                f.write(json.dumps({
                    "id": int(p),
                    "first_kf": int(s.point_first_kf[p]),
                    "n_obs": int(s.point_nobs[p]),
                    "visible": int(s.point_visible[p]),
                    "found": int(s.point_found[p]),
                }) + "\n")

"""Typed runtime configuration (the port's own copy of the reference
package's config tree; tests hold the two field for field).

Replaces the reference's two-tier config (runtime YAML via cv::FileStorage +
compile-time macro matrix, see SURVEY.md §5 "Config / flag system";
reference: include/Tracking.h:59-104, include/Frame.h:38-73,
include/Optimizer.h:36-57, include/Hashing.h:56-79) with one typed, immutable
config tree. Wall-clock time budgets of the reference become iteration/count
budgets so every device step has a fixed shape (SURVEY.md §7.3).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np


class Sensor(enum.Enum):
    """Sensor modes (reference: include/System.h eSensor MONOCULAR/STEREO/RGBD)."""

    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


class LocalMapMode(enum.Enum):
    """Local-map assembly strategy (reference: include/Tracking.h:197-201)."""

    COVIS_ONLY = 0
    HASH_ONLY = 1
    COMBINED = 2


class GFMatchingMode(enum.Enum):
    """Map-matching strategy under a per-frame budget (reference macro matrix
    include/Tracking.h:59-104: GOOD_FEATURE_MAP_MATCHING vs the
    RANDOM/LONGLIVED/BUCKETING baselines of
    Observability::runBaselineMapMatching src/Observability.cc:1171 and
    Tracking::BucketingMatches/LongLivedMatches src/Tracking.cc:1666/1771,
    plus the unbudgeted ORB_SLAM_BASELINE path)."""

    GOOD_FEATURE = 0  # Max-logDet lazier greedy (IROS18/TRO20)
    RANDOM = 1        # random subset of the candidate pool
    LONG_LIVED = 2    # longest-tracked landmarks first
    BUCKETING = 3     # spatially-bucketed round-robin by track length
    ALL = 4           # no budget: match the whole pool (ORB_SLAM_BASELINE)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera intrinsics/extrinsics (reference YAML keys, src/Tracking.cc:64-262).

    For stereo, either plain (fx..k3 shared + bf) for pre-rectified input, or
    the full LEFT./RIGHT. K/D/R/P rectification set
    (reference: src/Tracking.cc:138-207).
    """

    width: int = 640
    height: int = 480
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    # radial-tangential distortion [k1, k2, p1, p2, k3]
    dist: Tuple[float, float, float, float, float] = (0.0, 0.0, 0.0, 0.0, 0.0)
    fisheye: bool = False  # equidistant KB4 model (reference: Frame.h:43 USE_FISHEYE_DISTORTION)
    fps: float = 30.0
    bf: float = 0.0  # stereo baseline × fx (reference: "Camera.bf")
    th_depth: float = 35.0  # close/far stereo point threshold (reference: "ThDepth")
    depth_map_factor: float = 5000.0  # RGB-D depth scaling (reference: "DepthMapFactor")
    rgb_order: bool = True
    # Full stereo rectification (optional): per-cam K, D, R(3x3), P(3x4)
    left_K: Optional[np.ndarray] = None
    left_D: Optional[np.ndarray] = None
    left_R: Optional[np.ndarray] = None
    left_P: Optional[np.ndarray] = None
    right_K: Optional[np.ndarray] = None
    right_D: Optional[np.ndarray] = None
    right_R: Optional[np.ndarray] = None
    right_P: Optional[np.ndarray] = None

    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.fx else 0.0

    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float32
        )


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """ORB extraction (reference: ORBextractor.{nFeatures,...}, Tracking.cc:219-236)."""

    n_features: int = 800
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    cell_size: int = 32  # spatial-binning cell (replaces 30px FAST cell + quadtree)
    per_cell_k: int = 4  # top-K corners kept per cell before global top-N
    patch_size: int = 31
    edge_threshold: int = 19


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching thresholds (reference: include/ORBmatcher.h:294-296)."""

    th_low: int = 50
    th_high: int = 100
    nn_ratio: float = 0.9
    check_orientation: bool = True
    hist_length: int = 30  # rotation-consistency histogram bins (ORBmatcher.h HISTO_LENGTH)


@dataclasses.dataclass(frozen=True)
class GoodFeatureConfig:
    """Good-feature active matching (reference: include/Tracking.h:59-104,
    src/Observability.cc:830 runActiveMapMatching)."""

    enabled: bool = True
    # Max-logDet greedy budget: number of map points to actively match per frame
    # (reference: constraints-per-frame CLI arg, ros_stereo.cc:99 & System.cc:444).
    constr_per_frame: int = 160
    # Lazier-greedy subset factor: each round scores ~N/k random candidates
    # (reference: Observability.cc:902).
    lazier_factor: int = 10
    # Trigger: active matching only when candidate pool exceeds this
    # (reference: Tracking.cc:2348 — good-feature branch at >=400 candidates).
    min_pool: int = 400
    # Info-matrix size: 7 = pose-only (p,q), 13 = hybrid full kinematic state
    # (reference: Tracking.cc:271-274).
    info_mat_size: int = 7
    max_rounds: int = 200  # bounded greedy rounds (replaces wall-clock budget)
    # Budgeted matching strategy (GOOD_FEATURE, or a baseline for ablation)
    matching_mode: GFMatchingMode = GFMatchingMode.GOOD_FEATURE
    # After the pose solve, match leftover (unselected) candidates to free
    # keypoints to densify map associations (reference:
    # Tracking::SearchAdditionalMatchesInFrame src/Tracking.cc:2119).
    search_additional: bool = True


@dataclasses.dataclass(frozen=True)
class GoodGraphConfig:
    """Good-graph local-BA subgraph selection (reference: include/Optimizer.h:36-57,
    Thirdparty/SLAM++ NonlinearSolver_GoodGraph.h)."""

    enabled: bool = True
    # reference parity: trigger 30 / pool 60 (Optimizer.h:44-45 KF_THRES/
    # MAXSZ). The incremental-Cholesky selection (selection/good_graph.py)
    # makes the 60-KF pool tractable on device.
    kf_thres: int = 30
    max_pool: int = 60
    lazier_factor: int = 4
    # budget → subgraph size via cubic model (reference: Optimizer.cc:566 estimateKFNum);
    # here a direct size knob plus optional anticipation scaling.
    subgraph_size: int = 15
    # anticipation: derive the per-KF local-BA time budget from predicted
    # future visibility (virtual future KFs from the motion model/odometry —
    # reference: Optimizer.cc:648-1131, budget range :1021-1024)
    anticipation: bool = True
    anticipation_horizon: int = 3      # virtual future KFs
    anticipation_dt: float = 0.4       # seconds between virtual KFs
    budget_ms_min: float = 100.0       # reference: Optimizer.cc:1021-1024
    budget_ms_max: float = 800.0


@dataclasses.dataclass(frozen=True)
class HashingConfig:
    """Multi-index hashing of the local map (reference: include/Hashing.h:56-79)."""

    enabled: bool = False
    n_tables: int = 32
    bits_per_substring: int = 8  # 256/32 (Hashing.cc:470-485)
    n_active_tables: int = 8  # NUM_ACTIVE_HASHTABLES (Hashing.h:63)
    max_bucket_size: int = 20  # MAX_BUCKET_SIZE (Hashing.h)
    map_size_trigger: int = 2000  # MAP_SIZE_TRIGGER_HASHING (Tracking.h:66)
    online_table_selection: bool = True


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Front-end tracking policy (reference: src/Tracking.cc)."""

    local_map_mode: LocalMapMode = LocalMapMode.COVIS_ONLY
    # KF decision (reference: Tracking.cc:1914 NeedNewKeyFrame)
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30
    # inlier gates (reference: Tracking.cc:1600-1633)
    min_inliers_track: int = 30
    min_inliers_after_reloc: int = 50
    min_inliers_local_map: int = 30
    # motion-model search radius (reference: ORBmatcher SearchByProjection th=7/15)
    proj_search_radius: float = 7.0
    # pose optimizer: rounds × iters with chi2 gating. Reference runs 4×10
    # (Optimizer.cc:248); with LM step acceptance the solve converges well
    # inside 3×8 (ATE-validated on the rendered real-texture sequences —
    # the loop length is pure per-frame device latency, 2 solves/frame)
    pose_opt_rounds: int = 3
    pose_opt_iters: int = 8
    # relocalization enabled (reference: Tracking.h DISABLE_RELOC)
    enable_reloc: bool = True
    # max consecutive lost frames before hard reset (reference: System.cc:195-209)
    max_lost_frames: int = 150
    # streaming pipeline depth for track_stereo_pipelined: how many frames
    # ride in flight before the host fetches results (device-chained state;
    # higher = more overlap and jitter absorption, staler host bookkeeping)
    pipeline_depth: int = 3
    # run local mapping + loop closing on a background worker (reference
    # architecture: LocalMapping and LoopClosing threads, System.cc:113-124);
    # synchronous track_* calls always settle the map first. Smooths the
    # worst-case (KF-frame) latency; on a single shared device the mapper's
    # programs contend with every tracking frame — default off
    async_mapping: bool = False


@dataclasses.dataclass(frozen=True)
class LocalBAConfig:
    """Local BA solve (reference: Optimizer.cc:1248-1545 — g2o LM 5+10
    iters). A shorter 3+5 schedule doubles closed-circle drift on the
    rendered loop gate — the reference schedule stays the default."""

    iters_first: int = 5
    iters_second: int = 10
    # BA problem point cap: the window's points are ranked by observation
    # count and truncated — beyond ~2k the tail is 2-obs points that add
    # einsum cost [P,O,...] linearly but almost no pose information
    max_points: int = 2048
    huber_mono: float = 2.4477  # sqrt(5.991)
    huber_stereo: float = 2.7955  # sqrt(7.815)
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815


@dataclasses.dataclass(frozen=True)
class LoopClosingConfig:
    """Loop detection + correction (reference: src/LoopClosing.cc)."""

    enabled: bool = True
    covisibility_consistency_th: int = 3  # LoopClosing.cc:44
    min_sim3_inliers: int = 20
    min_total_matches: int = 40  # LoopClosing.cc post-opt gate
    essential_graph_min_weight: int = 100
    # Temporal exclusion: a loop candidate must be at least this many FRAMES
    # older than the current KF. The reference relies on covisibility alone
    # to exclude neighbors (KeyFrameDatabase.cc:84), which works when
    # consecutive KFs share >15 points; starvation-triggered KFs can share
    # fewer, letting a near-adjacent KF pose as a "loop". Frame ids are used
    # (not KF slot ids, which the free-slot ring reuses after culling).
    min_frame_gap: int = 60
    # Run the post-correction full BA inline instead of in a detached thread
    # (reference spawns a thread, LoopClosing.cc:601). Inline makes results
    # independent of host load — which KFs exist when the solve snapshot and
    # write-back happen is then deterministic. TEST/GATE-ONLY: combined with
    # tracking.async_mapping the inline solve runs while the mapping worker
    # may hold the store lock, stalling tracking for the whole GBA (System
    # warns at construction; ADVICE r3).
    synchronous_gba: bool = False


@dataclasses.dataclass(frozen=True)
class CharucoConfig:
    """ChArUco-board absolute pose initialization (reference:
    INIT_WITH_ARUCHO + src/ChArUco.cc — anchors the world frame to a
    calibration board seen in the first frame instead of the identity)."""

    enabled: bool = False
    squares_x: int = 5
    squares_y: int = 7
    square_len: float = 0.04
    marker_len: float = 0.02
    dictionary: str = "DICT_4X4_50"


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Fixed capacities for the SoA device map state (SURVEY.md §7.1).

    All device steps are shaped by these; overflow is handled host-side by
    compaction/culling.
    """

    max_keypoints: int = 1024  # per frame (>= ORBConfig.n_features)
    max_map_points: int = 40000
    max_keyframes: int = 1200
    max_local_points: int = 4096  # local-map candidate pool per frame
    max_local_kfs: int = 80
    max_obs_per_point: int = 48


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """Root config — one object replaces the reference's YAML + macro matrix."""

    sensor: Sensor = Sensor.STEREO
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: ORBConfig = dataclasses.field(default_factory=ORBConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    good_feature: GoodFeatureConfig = dataclasses.field(default_factory=GoodFeatureConfig)
    good_graph: GoodGraphConfig = dataclasses.field(default_factory=GoodGraphConfig)
    hashing: HashingConfig = dataclasses.field(default_factory=HashingConfig)
    local_ba: LocalBAConfig = dataclasses.field(default_factory=LocalBAConfig)
    loop: LoopClosingConfig = dataclasses.field(default_factory=LoopClosingConfig)
    capacity: CapacityConfig = dataclasses.field(default_factory=CapacityConfig)
    charuco: CharucoConfig = dataclasses.field(default_factory=CharucoConfig)
    use_viewer: bool = False
    localization_only: bool = False  # reference: ActivateLocalizationMode
    # BoW vocabulary (reference: System(vocFile,...) System.cc:78-84).
    # None → the shipped vocabulary asset; "" → disable (falls back to lazy
    # self-training); or a path to a .npz. Unused until place recognition
    # is part of this package.
    vocabulary_path: "str | None" = None

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)

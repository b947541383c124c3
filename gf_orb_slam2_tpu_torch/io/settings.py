"""YAML settings loader → typed SystemConfig.

Replaces the reference's cv::FileStorage parsing in the Tracking ctor
(reference: src/Tracking.cc:64-262 — Camera.fx..k3, Camera.bf/fps/RGB,
ThDepth, DepthMapFactor, ORBextractor.{nFeatures,scaleFactor,nLevels,
iniThFAST,minThFAST}, and the stereo LEFT./RIGHT. K,D,R,P rectification
block :138-207). Accepts the reference's YAML key names so existing
calibration files work unchanged, plus a `gf:` section for the knobs that
were compile-time macros in the reference (SURVEY.md §5 config matrix).
"""
from __future__ import annotations

import numpy as np

from gf_orb_slam2_tpu_torch.config import (
    CameraConfig, CapacityConfig, GoodFeatureConfig, GoodGraphConfig,
    HashingConfig, LocalMapMode, ORBConfig, Sensor, SystemConfig,
    TrackingConfig,
)


def _mat(node) -> np.ndarray:
    """cv::FileStorage matrix node {rows, cols, data} or plain list."""
    if isinstance(node, dict):
        return np.asarray(node["data"], np.float64).reshape(node["rows"], node["cols"])
    return np.asarray(node, np.float64)


def load_settings(path, sensor: Sensor | None = None) -> SystemConfig:
    import yaml  # read only here: importing the package needs no YAML parser

    with open(path) as f:
        text = f.read()
    if text.startswith("%YAML"):  # OpenCV header line
        text = text.split("\n", 1)[1].replace("!!opencv-matrix", "")
    y = yaml.safe_load(text)

    g = lambda k, d=None: y.get(k, d)
    sensor = sensor or Sensor[g("Sensor", "STEREO").upper()]
    cam_kw = dict(
        fx=float(g("Camera.fx", 458.0)), fy=float(g("Camera.fy", 458.0)),
        cx=float(g("Camera.cx", 367.0)), cy=float(g("Camera.cy", 248.0)),
        dist=(
            float(g("Camera.k1", 0.0)), float(g("Camera.k2", 0.0)),
            float(g("Camera.p1", 0.0)), float(g("Camera.p2", 0.0)),
            float(g("Camera.k3", 0.0)),
        ),
        fps=float(g("Camera.fps", 30.0)),
        bf=float(g("Camera.bf", 0.0)),
        th_depth=float(g("ThDepth", 35.0)),
        depth_map_factor=float(g("DepthMapFactor", 5000.0)),
        rgb_order=bool(g("Camera.RGB", 1)),
        width=int(g("Camera.width", 752)),
        height=int(g("Camera.height", 480)),
    )
    # full stereo rectification block (reference: Tracking.cc:138-207)
    if "LEFT.K" in y:
        cam_kw.update(
            left_K=_mat(y["LEFT.K"]), left_D=_mat(y["LEFT.D"]),
            left_R=_mat(y["LEFT.R"]), left_P=_mat(y["LEFT.P"]),
            right_K=_mat(y["RIGHT.K"]), right_D=_mat(y["RIGHT.D"]),
            right_R=_mat(y["RIGHT.R"]), right_P=_mat(y["RIGHT.P"]),
        )
        # rectified intrinsics come from P
        P = _mat(y["LEFT.P"])
        cam_kw.update(fx=float(P[0, 0]), fy=float(P[1, 1]),
                      cx=float(P[0, 2]), cy=float(P[1, 2]),
                      dist=(0.0, 0.0, 0.0, 0.0, 0.0))
    camera = CameraConfig(**cam_kw)

    orb = ORBConfig(
        n_features=int(g("ORBextractor.nFeatures", 800)),
        scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(g("ORBextractor.minThFAST", 7)),
    )
    gf = y.get("gf", {}) or {}
    good_feature = GoodFeatureConfig(
        enabled=bool(gf.get("good_feature", True)),
        constr_per_frame=int(gf.get("constr_per_frame", 160)),
        lazier_factor=int(gf.get("lazier_factor", 10)),
    )
    good_graph = GoodGraphConfig(
        enabled=bool(gf.get("good_graph", True)),
        subgraph_size=int(gf.get("subgraph_size", 15)),
    )
    hashing = HashingConfig(enabled=bool(gf.get("hashing", False)))
    tracking = TrackingConfig(
        local_map_mode=LocalMapMode[gf.get("local_map_mode", "COVIS_ONLY")],
        max_frames_between_kf=int(g("Camera.fps", 30)),
    )
    n_kp = 1 << int(np.ceil(np.log2(max(orb.n_features, 256))))
    capacity = CapacityConfig(max_keypoints=n_kp)
    return SystemConfig(
        sensor=sensor, camera=camera, orb=orb, tracking=tracking,
        good_feature=good_feature, good_graph=good_graph, hashing=hashing,
        capacity=capacity,
    )

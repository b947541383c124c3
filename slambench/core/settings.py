"""A configuration file (the upstream settings' key names, as JSON) → the
port's SystemConfig.

The key mapping is a copy of the port's `io/settings.load_settings`, which
reads the same keys from YAML; the benchmark keeps its own so that it needs
no YAML parser and so that a change to the loader does not move the
yardstick. Keys the upstream settings lack are in the file's `runtime`
group: the switches that the upstream example programs set in
code.
"""
from __future__ import annotations

import json

import numpy as np


def load(path) -> dict:
    with open(path) as f:
        return json.load(f)


def system_config(y: dict):
    """The SystemConfig the file describes."""
    from gf_orb_slam2_tpu_torch.config import (
        CameraConfig, CapacityConfig, GoodFeatureConfig, GoodGraphConfig, HashingConfig,
        LocalMapMode, LoopClosingConfig, ORBConfig, Sensor, SystemConfig, TrackingConfig,
    )

    camera = CameraConfig(
        width=int(y["Camera.width"]), height=int(y["Camera.height"]),
        fx=float(y["Camera.fx"]), fy=float(y["Camera.fy"]),
        cx=float(y["Camera.cx"]), cy=float(y["Camera.cy"]),
        dist=tuple(float(y.get(k, 0.0)) for k in
                   ("Camera.k1", "Camera.k2", "Camera.p1", "Camera.p2", "Camera.k3")),
        fps=float(y["Camera.fps"]), bf=float(y.get("Camera.bf", 0.0)),
        th_depth=float(y.get("ThDepth", 35.0)),
        depth_map_factor=float(y.get("DepthMapFactor", 5000.0)),
        rgb_order=bool(y.get("Camera.RGB", 1)),
    )
    orb = ORBConfig(
        n_features=int(y["ORBextractor.nFeatures"]),
        scale_factor=float(y["ORBextractor.scaleFactor"]),
        n_levels=int(y["ORBextractor.nLevels"]),
        ini_th_fast=int(y["ORBextractor.iniThFAST"]),
        min_th_fast=int(y["ORBextractor.minThFAST"]),
    )
    gf = y["gf"]
    run = y["runtime"]
    n_kp = 1 << int(np.ceil(np.log2(max(orb.n_features, 256))))
    return SystemConfig(
        sensor=Sensor[y["Sensor"]], camera=camera, orb=orb,
        tracking=TrackingConfig(
            local_map_mode=LocalMapMode[gf["local_map_mode"]],
            max_frames_between_kf=int(y["Camera.fps"]),
            async_mapping=bool(run["async_mapping"])),
        good_feature=GoodFeatureConfig(enabled=bool(gf["good_feature"]),
                                       constr_per_frame=int(gf["constr_per_frame"])),
        good_graph=GoodGraphConfig(enabled=bool(gf["good_graph"]),
                                   subgraph_size=int(gf["subgraph_size"])),
        hashing=HashingConfig(enabled=bool(gf["hashing"])),
        loop=LoopClosingConfig(enabled=bool(run["loop_closing"])),
        capacity=CapacityConfig(max_keypoints=n_kp),
    )

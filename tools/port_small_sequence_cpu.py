#!/usr/bin/env python3
"""Both packages on the same small rendered stereo sequence, on the CPU.

    JAX_PLATFORMS=cpu python tools/port_small_sequence_cpu.py [--frames 12]

Tracks the first frames of the rendered room tour at 320x240 (600 features,
1024-point local pool) with the PyTorch port (`device="cpu"`, one thread)
and with the JAX package, both with synchronous local mapping on
(triangulation, fusion, local BA, KF culling) and loop closing off. The JAX
mapper's background compile warm-up is switched off (GF_SLAM_NO_PREWARM): it
compiles at first use instead. Prints the per-frame statistics side by side,
each package's mapping log per keyframe event, and both ATE RMSE figures
against the renderer's ground truth. Accuracy and counts only: a CPU run
says nothing about speed on the GPU.
"""
import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

H, W, F = 240, 320, 225.0


def configs():
    from gf_orb_slam2_tpu import config as jc
    from gf_orb_slam2_tpu_torch import convert

    cam = jc.CameraConfig(width=W, height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
                          bf=F * 0.1, th_depth=40.0)
    jcfg = jc.SystemConfig(
        sensor=jc.Sensor.STEREO, camera=cam, orb=jc.ORBConfig(n_features=600),
        capacity=jc.CapacityConfig(max_keypoints=640, max_map_points=8000,
                                   max_keyframes=40, max_local_points=1024),
        tracking=jc.TrackingConfig(async_mapping=False),
        loop=jc.LoopClosingConfig(enabled=False), vocabulary_path="")
    return jcfg, convert.config_from_reference(jcfg)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    args = ap.parse_args()
    os.environ["GF_SLAM_NO_PREWARM"] = "1"
    import torch

    torch.set_num_threads(1)
    from rendered_world import RoomWorld, trajectory_tour

    from gf_orb_slam2_tpu.system import System as JSystem
    from gf_orb_slam2_tpu_torch.io.evaluation import ate_rmse
    from gf_orb_slam2_tpu_torch.system import System as TSystem

    jcfg, tcfg = configs()
    world = RoomWorld(width=9.0, height=5.5, length=13.0)
    poses = trajectory_tour(300)[: args.frames]
    gt = np.stack([-R.T @ t for R, t in poses])
    js = JSystem(jcfg)
    ts = TSystem(tcfg, device="cpu")
    est = {"jax": [], "torch": []}
    for i, (R, t) in enumerate(poses):
        left, right = world.render_stereo(R, t, baseline=0.1, fx=F, fy=F,
                                          cx=W / 2, cy=H / 2, w=W, h=H)
        row = {"frame": i}
        for name, slam in (("jax", js), ("torch", ts)):
            T = slam.track_stereo(left, right, i / 20.0)
            est[name].append(-T[:3, :3].T @ T[:3, 3])
            st = slam.tracker.stats[-1]
            row[name] = [st.state, st.n_motion_matches, st.n_local_points,
                         st.n_local_matches, st.n_inliers, st.created_kf]
        print(json.dumps(row), flush=True)
    for name, slam in (("jax", js), ("torch", ts)):
        for st in slam.mapper.stats:
            print(json.dumps({"mapping": name, **dataclasses.asdict(st)}))
    print(json.dumps({
        "frames": args.frames,
        "ate_rmse_m": {k: ate_rmse(np.stack(v), gt) for k, v in est.items()},
        "keyframes": {"jax": int(js.store.n_keyframes), "torch": int(ts.store.n_keyframes)},
        "map_points": {"jax": int(js.store.n_points), "torch": int(ts.store.n_points)},
    }))
    js.shutdown()
    ts.shutdown()


if __name__ == "__main__":
    main()

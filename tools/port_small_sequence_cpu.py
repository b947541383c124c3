#!/usr/bin/env python3
"""Both packages on the same small rendered stereo sequence, on the CPU.

    JAX_PLATFORMS=cpu python tools/port_small_sequence_cpu.py [--frames 12]

Tracks the first frames of the rendered room tour at 320x240 (600 features,
1024-point local pool) with the PyTorch port (`device="cpu"`, one thread)
and with the JAX package whose mapper is switched off on the instance
(`mapper.process_keyframe` replaced by a no-op — no file of that package
changes), i.e. in the state this slice of the port is in: tracking inserts
keyframes and stereo points, nothing runs bundle adjustment. Prints the
per-frame statistics side by side and both ATE RMSE figures against the
renderer's ground truth. Accuracy and counts only: a CPU run says nothing
about speed on the GPU.
"""
import argparse
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
        loop=jc.LoopClosingConfig(enabled=False), vocabulary_path="")
    return jcfg, convert.config_from_reference(jcfg)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    args = ap.parse_args()
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
    js.mapper.process_keyframe = lambda *a, **k: None  # mapping off
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
    print(json.dumps({
        "frames": args.frames,
        "ate_rmse_m": {k: ate_rmse(np.stack(v), gt) for k, v in est.items()},
        "keyframes": {"jax": int(js.store.n_keyframes), "torch": int(ts.store.n_keyframes)},
    }))
    js.shutdown()
    ts.shutdown()


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Both packages on the same small rendered stereo sequence, on the CPU,
diffed frame by frame.

    JAX_PLATFORMS=cpu python tools/port_small_sequence_cpu.py [--frames 12] [--loop]
        [--same-frontend] [--matching-mode GOOD_FEATURE|LONG_LIVED|ALL] [--quiet]

Tracks the first frames of the rendered room tour at 320x240 (600 features,
1024-point local pool) with the PyTorch port (`device="cpu"`, one thread)
and with the JAX package, both with synchronous local mapping on
(triangulation, fusion, local BA, KF culling) and loop closing off — or,
with `--loop`, on in both (the shipped vocabulary, the global BA inline),
and then each package's loop-closing log per keyframe event is printed too.
The JAX mapper's background compile warm-up is switched off
(GF_SLAM_NO_PREWARM): it compiles at first use instead.

Each frame prints one line with both packages' state, tracking path,
matches, inliers, whether a keyframe was created, and the difference of the
two poses (camera centre in metres, rotation in radians); with its
frontend diff: how many keypoints the two extractors placed differently on
that frame. `--same-frontend` feeds the JAX extractor's keypoints to both
trackers (`track_frame`; the port's copy is carried over by
`convert.frame_from_arrays`), so only tracking and mapping are compared.
`--matching-mode` picks the budgeted local-map matching: GOOD_FEATURE (the
default) draws its lazier-greedy subsets from each package's own random
stream (jax.random against torch), LONG_LIVED and ALL draw nothing.

The last lines name the first frame where the two part — the first whose
state, path, KF decision or inlier count differ, or whose poses differ by
more than 1e-4 m or rad — with its stage, then each package's mapping log
per keyframe event and both ATE RMSE figures against the renderer's ground
truth. Accuracy and counts only: a CPU run says nothing about speed on the
GPU.
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
PART_TOL = 1e-4
HOST = ("uv", "octave", "angle", "desc", "response", "u_right", "depth", "valid")


def configs(loop: bool, matching_mode: str):
    from gf_orb_slam2_tpu import config as jc
    from gf_orb_slam2_tpu_torch import convert

    cam = jc.CameraConfig(width=W, height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
                          bf=F * 0.1, th_depth=40.0)
    jcfg = jc.SystemConfig(
        sensor=jc.Sensor.STEREO, camera=cam, orb=jc.ORBConfig(n_features=600),
        capacity=jc.CapacityConfig(max_keypoints=640, max_map_points=8000,
                                   max_keyframes=40, max_local_points=1024),
        good_feature=jc.GoodFeatureConfig(matching_mode=jc.GFMatchingMode[matching_mode]),
        tracking=jc.TrackingConfig(async_mapping=False),
        loop=jc.LoopClosingConfig(enabled=loop, synchronous_gba=True),
        vocabulary_path=None if loop else "")
    return jcfg, convert.config_from_reference(jcfg)


def pose_diff(Ta, Tb):
    """(camera-centre distance in metres, rotation angle in radians). The
    angle comes from atan2 of the skew and symmetric parts of Ra·Rbᵀ: an
    arccos of the trace would floor at ~2e-4 rad on f32 rotations."""
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    ca = -Ta[:3, :3].T @ Ta[:3, 3]
    cb = -Tb[:3, :3].T @ Tb[:3, 3]
    M = Ta[:3, :3] @ Tb[:3, :3].T
    skew = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]) / 2
    return float(np.linalg.norm(ca - cb)), float(np.arctan2(np.linalg.norm(skew),
                                                            (np.trace(M) - 1) / 2))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--loop", action="store_true", help="loop closing on in both packages")
    ap.add_argument("--same-frontend", action="store_true",
                    help="feed the JAX extractor's keypoints to both trackers")
    ap.add_argument("--matching-mode", default="GOOD_FEATURE",
                    choices=("GOOD_FEATURE", "LONG_LIVED", "ALL"))
    ap.add_argument("--quiet", action="store_true", help="no per-frame lines")
    args = ap.parse_args()
    os.environ["GF_SLAM_NO_PREWARM"] = "1"
    import torch

    torch.set_num_threads(1)
    from rendered_world import RoomWorld, trajectory_tour

    from gf_orb_slam2_tpu.system import System as JSystem
    from gf_orb_slam2_tpu_torch import convert
    from gf_orb_slam2_tpu_torch.io.evaluation import ate_rmse
    from gf_orb_slam2_tpu_torch.system import System as TSystem

    jcfg, tcfg = configs(args.loop, args.matching_mode)
    world = RoomWorld(width=9.0, height=5.5, length=13.0)
    poses = trajectory_tour(300)[: args.frames]
    gt = np.stack([-R.T @ t for R, t in poses])
    js = JSystem(jcfg)
    ts = TSystem(tcfg, device="cpu")
    est = {"jax": [], "torch": []}
    first_part = None
    worst = (0.0, 0.0)
    for i, (R, t) in enumerate(poses):
        left, right = world.render_stereo(R, t, baseline=0.1, fx=F, fy=F,
                                          cx=W / 2, cy=H / 2, w=W, h=H)
        jf = js._build_stereo_frame(left, right, i / 20.0)
        jf.ensure_host()
        arrays = dict({k: np.array(getattr(jf, k)) for k in HOST},
                      frame_id=jf.frame_id, timestamp=jf.timestamp)
        Tj = js.track_frame(jf)
        if args.same_frontend:
            Tt = ts.track_frame(convert.frame_from_arrays(arrays))
            moved = 0
        else:
            Tt = ts.track_stereo(left, right, i / 20.0)
            own = ts.tracker.last_frame
            moved = int(((np.abs(own.uv - arrays["uv"]).max(1) > 0)
                         | (own.valid != arrays["valid"])
                         | (own.desc != arrays["desc"]).any(1)).sum())
        sj, st = js.tracker.stats[-1], ts.tracker.stats[-1]
        dc, dr = pose_diff(Tj, Tt)
        worst = (max(worst[0], dc), max(worst[1], dr))
        for name, T in (("jax", Tj), ("torch", Tt)):
            est[name].append(-T[:3, :3].T @ T[:3, 3])
        jpath = "init" if i == 0 else ("fused" if sj.n_local_points and sj.n_motion_matches
                                       else "other")
        row = {"frame": i, "keypoints_moved": moved,
               "jax": [sj.state, sj.n_motion_matches, sj.n_local_matches, sj.n_inliers,
                       sj.created_kf],
               "torch": [st.state, st.path, st.n_motion_matches, st.n_local_matches,
                         st.n_inliers, st.created_kf],
               "d_centre_m": dc, "d_rot_rad": dr}
        if not args.quiet:
            print(json.dumps(row), flush=True)
        parted = (sj.state != st.state or sj.created_kf != st.created_kf
                  or sj.n_inliers != st.n_inliers or sj.n_motion_matches != st.n_motion_matches
                  or sj.n_local_matches != st.n_local_matches
                  or dc > PART_TOL or dr > PART_TOL)
        if parted and first_part is None:
            if moved:
                stage = "frontend (the extractors' keypoints differ on this frame)"
            elif sj.n_motion_matches != st.n_motion_matches:
                stage = f"tracking, motion search (path {st.path}, JAX's {jpath})"
            elif sj.n_local_matches != st.n_local_matches:
                stage = f"tracking, local-map search (path {st.path})"
            else:
                stage = f"tracking, pose solve (path {st.path})"
            first_part = dict(stage=stage, **row)
    for name, slam in (("jax", js), ("torch", ts)):
        for st in slam.mapper.stats:
            print(json.dumps({"mapping": name, **dataclasses.asdict(st)}))
        for st in slam.loop_closer.stats if slam.loop_closer is not None else ():
            print(json.dumps({"loop": name, **dataclasses.asdict(st)}))
    print(json.dumps({"first_parting": first_part}))
    print(json.dumps({
        "frames": args.frames, "same_frontend": args.same_frontend,
        "matching_mode": args.matching_mode,
        "ate_rmse_m": {k: ate_rmse(np.stack(v), gt) for k, v in est.items()},
        "max_pose_diff": {"centre_m": worst[0], "rot_rad": worst[1]},
        "keyframes": {"jax": int(js.store.n_keyframes), "torch": int(ts.store.n_keyframes)},
        "map_points": {"jax": int(js.store.n_points), "torch": int(ts.store.n_points)},
    }))
    js.shutdown()
    ts.shutdown()


if __name__ == "__main__":
    main()

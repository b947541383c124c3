#!/usr/bin/env python
"""Offline stereo SLAM driver for EuRoC / KITTI sequences, on the PyTorch port.

The counterpart of examples/run_stereo.py for gf_orb_slam2_tpu_torch, with
the same arguments, outputs and last JSON line, plus `--device` (default
`cuda`; nothing falls back to the CPU): reads a dataset directory, runs the
port's System per frame, writes TUM/KITTI trajectories and the tracking log.

Usage:
  python examples/run_stereo_torch.py --format euroc --data /path/MH_01 \
      --settings examples/euroc_stereo.yaml --out /tmp/run1 \
      --constr-per-frame 240 --budget-ms 400
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--format", choices=["euroc", "kitti"], required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--sequence", default="00", help="KITTI sequence id")
    ap.add_argument("--settings", required=True, help="YAML camera settings")
    ap.add_argument("--out", required=True)
    ap.add_argument("--constr-per-frame", type=int, default=0,
                    help="good-feature budget (0 = disabled)")
    ap.add_argument("--budget-ms", type=float, default=0.0,
                    help="good-graph local BA budget (0 = default)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--save-map", default="")
    ap.add_argument("--load-map", default="")
    ap.add_argument("--localization", action="store_true")
    ap.add_argument("--pipelined", action="store_true",
                    help="streaming pipelined tracking (device-chained "
                    "state; best sustained throughput)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()

    from gf_orb_slam2_tpu_torch.io.dataset import EurocStereo, KittiStereo
    from gf_orb_slam2_tpu_torch.io.settings import load_settings
    from gf_orb_slam2_tpu_torch.system import System

    cfg = load_settings(args.settings)
    sys_ = System(cfg, device=args.device)
    if args.load_map:
        sys_.load_map(args.load_map)
    if args.localization:
        sys_.activate_localization_mode()
    if args.constr_per_frame:
        sys_.set_constr_per_frame(args.constr_per_frame)
    if args.budget_ms:
        sys_.set_budget_per_frame(args.budget_ms)

    ds = (EurocStereo(args.data) if args.format == "euroc"
          else KittiStereo(args.data, args.sequence))
    os.makedirs(args.out, exist_ok=True)
    times = []
    for i, (left, right, ts) in enumerate(ds):
        if args.max_frames and i >= args.max_frames:
            break
        t0 = time.perf_counter()
        if args.pipelined:
            sys_.track_stereo_pipelined(left, right, ts)
        else:
            sys_.track_stereo(left, right, ts)
        times.append((time.perf_counter() - t0) * 1e3)
        if i % 100 == 0:
            print(f"frame {i}/{len(ds)} state={sys_.state.name} "
                  f"med={np.median(times[10:] or times):.1f}ms", flush=True)
    if args.pipelined:
        sys_.flush_pipeline()
    sys_.shutdown()  # joins the mapping and loop workers before interpreter exit

    sys_.save_trajectory_tum(os.path.join(args.out, "trajectory_tum.txt"))
    sys_.save_keyframe_trajectory_tum(os.path.join(args.out, "kf_trajectory_tum.txt"))
    sys_.save_trajectory_kitti(os.path.join(args.out, "trajectory_kitti.txt"))
    sys_.save_tracking_log(os.path.join(args.out, "tracking_log.jsonl"))
    if args.save_map:
        sys_.save_map(args.save_map)
    print(json.dumps({
        "frames": len(times),
        "median_ms": float(np.median(times[10:] or times)),
        "keyframes": int(sys_.store.n_keyframes),
        "points": int(sys_.store.n_points),
    }))


if __name__ == "__main__":
    main()

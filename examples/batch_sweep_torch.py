#!/usr/bin/env python
"""Budget-sweep batch evaluation, on the PyTorch port.

The counterpart of examples/batch_sweep.py for gf_orb_slam2_tpu_torch, with
the same arguments and rows plus `--device` (default `cuda`): an in-process
sweep over good-feature budgets × repeats on one sequence, one results row
per run (latency stats + trajectory file for evo).

  python examples/batch_sweep_torch.py --format euroc --data /data/MH_01 \
      --settings examples/euroc_stereo.yaml --out /tmp/sweep \
      --budgets 80 160 240 480
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_one(args, budget):
    from gf_orb_slam2_tpu_torch.io.dataset import EurocStereo, KittiStereo
    from gf_orb_slam2_tpu_torch.io.settings import load_settings
    from gf_orb_slam2_tpu_torch.system import System

    cfg = load_settings(args.settings)
    sys_ = System(cfg, device=args.device)
    if budget:
        sys_.set_constr_per_frame(budget)
    ds = (EurocStereo(args.data) if args.format == "euroc"
          else KittiStereo(args.data, args.sequence))
    times = []
    for i, (left, right, ts) in enumerate(ds):
        if args.max_frames and i >= args.max_frames:
            break
        t0 = time.perf_counter()
        sys_.track_stereo(left, right, ts)
        times.append((time.perf_counter() - t0) * 1e3)
    sys_.shutdown()  # joins the mapping and loop workers before interpreter exit
    out_dir = os.path.join(args.out, f"budget_{budget}")
    os.makedirs(out_dir, exist_ok=True)
    sys_.save_trajectory_tum(os.path.join(out_dir, "trajectory_tum.txt"))
    sys_.save_tracking_log(os.path.join(out_dir, "tracking_log.jsonl"))
    return {
        "budget": budget,
        "frames": len(times),
        "median_ms": float(np.median(times[10:] or times)),
        "p90_ms": float(np.percentile(times[10:] or times, 90)),
        "keyframes": int(sys_.store.n_keyframes),
        "points": int(sys_.store.n_points),
        "lost_frames": sum(1 for s in sys_.tracker.stats if s.state == "LOST"),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--format", choices=["euroc", "kitti"], required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--sequence", default="00")
    ap.add_argument("--settings", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--budgets", type=int, nargs="+", default=[80, 160, 240, 480])
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    rows = []
    for budget in args.budgets:
        for rep in range(args.repeats):
            row = run_one(args, budget)
            row["repeat"] = rep
            rows.append(row)
            print(json.dumps(row), flush=True)
    with open(os.path.join(args.out, "sweep.jsonl"), "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()

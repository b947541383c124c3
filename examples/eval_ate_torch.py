#!/usr/bin/env python
"""Evaluate an estimated TUM trajectory against ground truth (ATE/RPE), with
the PyTorch port's evaluator.

The counterpart of examples/eval_ate.py for gf_orb_slam2_tpu_torch, with the
same arguments and JSON line. Evaluation is host numpy in both packages, so
it takes no device:

  python examples/eval_ate_torch.py est_traj.txt groundtruth.txt [--scale]

Prints one JSON line with ate_rmse (meters) and RPE statistics.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def maybe_convert_euroc_csv(path: str) -> str:
    """Accept EuRoC ground-truth CSV directly (timestamp_ns, p_RS_R_* ...)."""
    if not path.endswith(".csv"):
        return path
    out = path + ".tum.txt"
    with open(path) as f, open(out, "w") as g:
        for line in f:
            if line.startswith("#"):
                continue
            v = line.strip().split(",")
            if len(v) < 8:
                continue
            t = float(v[0]) * 1e-9
            px, py, pz = v[1:4]
            qw, qx, qy, qz = v[4:8]
            g.write(f"{t:.6f} {px} {py} {pz} {qx} {qy} {qz} {qw}\n")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("est", help="estimated trajectory (TUM format)")
    ap.add_argument("gt", help="ground truth (TUM format or EuRoC CSV)")
    ap.add_argument("--scale", action="store_true",
                    help="Sim3 alignment (monocular)")
    ap.add_argument("--max-dt", type=float, default=0.02)
    args = ap.parse_args()

    from gf_orb_slam2_tpu_torch.io.evaluation import evaluate_tum_files

    gt = maybe_convert_euroc_csv(args.gt)
    out = evaluate_tum_files(args.est, gt, max_dt=args.max_dt,
                             with_scale=args.scale)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

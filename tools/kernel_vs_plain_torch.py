#!/usr/bin/env python3
"""The main path with the pose LM and selection kernels against the same
frames with their plain PyTorch versions patched in (one NVIDIA GPU).

    python3 tools/kernel_vs_plain_torch.py [--frames 150] [--out DIR]

Renders chip_smoke.py's room tour and runs its first `--frames` frames
through `System.track_stereo` at the headline configuration (synchronous
local mapping) three times in this process:

- `kernel`: as shipped, `pose_optimization` and `lazier_greedy_select`
  launching kernels 2 and 3 (csrc/pose_lm.cu, csrc/greedy_select.cu);
- `plain`: both replaced by `pose_optimization_ref` and
  `lazier_greedy_select_ref` (the lazier draws taken from the same
  generator the same way);
- `shadow`: the kernels again, each call also computed by its plain version
  on the same inputs and uniforms (the kernel's result is the one used),
  recording per call the largest pose difference, the inliers that differ,
  the robust costs of both poses, and the picks and objective of the
  selection.

Reports each run's ATE and keyframes, the first frame where the `kernel`
and `plain` trajectories part (beyond 0, 1e-6, 1e-4 and 1e-3 m), and the
per-call differences of the shadow run. Prints one JSON object (also
written to <out>/kernel_vs_plain_torch.json) with the card's name and power
limit. The patching lives in this process only; the package has no switch.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (scene, configuration and renderer loader)
from gf_orb_slam2_tpu_torch.io.evaluation import ate_rmse  # noqa: E402
from gf_orb_slam2_tpu_torch.optim import pose_opt  # noqa: E402
from gf_orb_slam2_tpu_torch.selection import good_feature as gf  # noqa: E402
from gf_orb_slam2_tpu_torch.system import System  # noqa: E402

KERNEL_LM, KERNEL_SEL = pose_opt.pose_optimization, gf.lazier_greedy_select


def plain_select(obs, valid, n, gen=None, lazier_factor=10, base_mat=None, eps=1e-3, batch=8,
                 uniforms=None):
    return gf.lazier_greedy_select_ref(obs, valid, n, gen, lazier_factor, base_mat, eps, batch,
                                       uniforms)


def robust_cost(res, args):
    """Σ Huber ρ(chi2) over the result's inliers at its pose (the LM's
    objective at the end of the solve)."""
    Xw, uv, ur, inv2 = args[2:6]
    stereo = ur >= 0
    r, _, _ = pose_opt._project(res.R, res.t, Xw, uv, ur, stereo, *args[7:12])
    c2 = pose_opt._chi2(r, inv2, stereo)
    delta = torch.where(stereo, pose_opt.HUBER_STEREO, pose_opt.HUBER_MONO)
    e = torch.sqrt(torch.clamp(c2, min=1e-12))
    rho = torch.where(e <= delta, c2, 2.0 * delta * e - delta * delta)
    return float(torch.where(res.inliers, rho, 0.0).sum())


class Shadow:
    """The kernels, each call also computed by its plain version."""

    def __init__(self):
        self.lm, self.sel, self.slam = [], [], None

    def pose(self, *a, **k):
        got = KERNEL_LM(*a, **k)
        want = pose_opt.pose_optimization_ref(*a, **k)
        self.lm.append({
            "frame": self.slam.frame_id,
            "dR": float((got.R - want.R).abs().max()), "dt": float((got.t - want.t).abs().max()),
            "inliers_differing": int((got.inliers != want.inliers).sum()),
            "n_inliers": [int(got.n_inliers), int(want.n_inliers)],
            "cost": [robust_cost(got, a), robust_cost(want, a)]})
        return got

    def select(self, obs, valid, n, gen=None, lazier_factor=10, base_mat=None, eps=1e-3,
               batch=8, uniforms=None):
        if uniforms is None:
            uniforms = gf.lazier_uniforms(obs, n, gen, lazier_factor, batch)
        got = KERNEL_SEL(obs, valid, n, None, lazier_factor, base_mat, eps, batch, uniforms)
        want = gf.lazier_greedy_select_ref(obs, valid, n, None, lazier_factor, base_mat, eps,
                                           batch, uniforms)
        g, w = got[1].tolist(), want[1].tolist()
        self.sel.append({
            "frame": self.slam.frame_id, "picks_differing": sum(a != b for a, b in zip(g, w)),
            "objective_diff": float(gf.selection_logdet(obs, got[0], base_mat, eps))
            - float(gf.selection_logdet(obs, want[0], base_mat, eps))})
        return got


def run(imgs, gt, lm, sel, shadow=None):
    pose_opt.pose_optimization, gf.lazier_greedy_select = lm, sel
    try:
        slam = System(chip_smoke.headline_config(), device="cuda")
        if shadow is not None:
            shadow.slam = slam
        est = []
        t0 = time.perf_counter()
        for i, (left, right) in enumerate(imgs):
            T = slam.track_stereo(left, right, i / 20.0)
            est.append(-T[:3, :3].T @ T[:3, 3])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        kfs = [st.frame_id for st in slam.tracker.stats if st.created_kf]
        slam.shutdown()
    finally:
        pose_opt.pose_optimization, gf.lazier_greedy_select = KERNEL_LM, KERNEL_SEL
    est = np.stack(est)
    return est, {"ate_m": ate_rmse(est, gt), "keyframes": kfs, "seconds": seconds}


def first_parting(a, b, tol):
    d = np.abs(a - b).max(1)
    idx = np.nonzero(d > tol)[0]
    return int(idx[0]) if idx.size else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=chip_smoke.N_FRAMES)
    ap.add_argument("--out", default=os.path.join(ROOT, "profile_out"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    tour, tour_gt = chip_smoke.render_tour()
    imgs, gt = tour[:args.frames], tour_gt[:args.frames]
    shadow = Shadow()
    est, runs = {}, {}
    for name, lm, sel, sh in (("kernel", KERNEL_LM, KERNEL_SEL, None),
                              ("plain", pose_opt.pose_optimization_ref, plain_select, None),
                              ("shadow", shadow.pose, shadow.select, shadow)):
        est[name], runs[name] = run(imgs, gt, lm, sel, sh)
    worst = sorted(shadow.lm, key=lambda c: -max(c["dR"], c["dt"]))
    out = {
        "card": smi, "torch": torch.__version__, "frames": args.frames, "runs": runs,
        "kernel_parts_from_plain_at_frame": {
            str(tol): first_parting(est["kernel"], est["plain"], tol)
            for tol in (0.0, 1e-6, 1e-4, 1e-3)},
        "shadow_equals_kernel": bool(np.array_equal(est["shadow"], est["kernel"])),
        "pose_lm": {"calls": len(shadow.lm),
                    "max_dR": max((c["dR"] for c in shadow.lm), default=0.0),
                    "max_dt": max((c["dt"] for c in shadow.lm), default=0.0),
                    "calls_with_inliers_differing":
                        sum(c["inliers_differing"] > 0 for c in shadow.lm),
                    "first_over_1e-5": next((c for c in shadow.lm
                                             if max(c["dR"], c["dt"]) > 1e-5), None),
                    "worst": worst[:5]},
        "greedy_select": {"calls": len(shadow.sel),
                          "calls_differing": sum(c["picks_differing"] > 0 for c in shadow.sel),
                          "first_differing": next((c for c in shadow.sel
                                                   if c["picks_differing"]), None),
                          "max_objective_diff": max((abs(c["objective_diff"])
                                                     for c in shadow.sel), default=0.0)},
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "kernel_vs_plain_torch.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The main path with the pose LM and selection kernels against the same
frames with their plain PyTorch versions patched in (one NVIDIA GPU).

    python3 tools/kernel_vs_plain_torch.py [--frames 150] [--out DIR] [--against SRC]

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

With `--against SRC` (a directory of csrc/*.cu sources, e.g. an earlier
commit's, from `git archive <commit> gf_orb_slam2_tpu_torch/csrc`), every
call of the shadow run is also computed by the kernels built from SRC and
the outputs compared bit for bit; so are synthetic cases beyond the main
path (the relocalization polish's 4 x 10, the hybrid's D = 13, exact greedy,
no base, the selection kernel's cap on P, the pose LM's edge cases) and the
main path's last solve and selection, both builds timed on those by
CUDA-graph replay in this one process.

Reports each run's ATE and keyframes, the first frame where the `kernel`
and `plain` trajectories part (beyond 0, 1e-6, 1e-4 and 1e-3 m), and the
per-call differences of the shadow run. Prints one JSON object (also
written to <out>/kernel_vs_plain_torch.json) with the card's name and power
limit. The patching lives in this process only; the package has no switch.
"""
import argparse
import glob
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
from gf_orb_slam2_tpu_torch.geometry import lie  # noqa: E402
from gf_orb_slam2_tpu_torch.io.evaluation import ate_rmse  # noqa: E402
from gf_orb_slam2_tpu_torch.ops import cuda_lib, greedy_select_cuda  # noqa: E402
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


def same_bits(a, b):
    """Equal bit for bit, NaN payloads included."""
    if a.dtype.is_floating_point:
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return a.shape == b.shape and torch.equal(a.view(as_int), b.view(as_int))
    return torch.equal(a, b)


def equal_against(call, got, lib_path):
    """`call()` launched from the library at `lib_path`: every output equal
    to `got` bit for bit (None without a library)."""
    if lib_path is None:
        return None
    with cuda_lib.using(lib_path):
        other = call()
    return all(same_bits(a, b) for a, b in zip(got, other))


class Shadow:
    """The kernels, each call also computed by its plain version (and by the
    kernels of another build, the library at `against`, when given)."""

    def __init__(self, against=None):
        self.lm, self.sel, self.slam, self.against = [], [], None, against
        self.last = {}

    def pose(self, *a, **k):
        self.last["pose_lm"] = lambda: KERNEL_LM(*a, **k)
        got = self.last["pose_lm"]()
        want = pose_opt.pose_optimization_ref(*a, **k)
        self.lm.append({
            "frame": self.slam.frame_id,
            "dR": float((got.R - want.R).abs().max()), "dt": float((got.t - want.t).abs().max()),
            "inliers_differing": int((got.inliers != want.inliers).sum()),
            "n_inliers": [int(got.n_inliers), int(want.n_inliers)],
            "cost": [robust_cost(got, a), robust_cost(want, a)],
            "bits_equal_against": equal_against(self.last["pose_lm"], got, self.against)})
        return got

    def select(self, obs, valid, n, gen=None, lazier_factor=10, base_mat=None, eps=1e-3,
               batch=8, uniforms=None):
        if uniforms is None:
            uniforms = gf.lazier_uniforms(obs, n, gen, lazier_factor, batch)
        self.last["greedy_select"] = lambda: KERNEL_SEL(obs, valid, n, None, lazier_factor,
                                                        base_mat, eps, batch, uniforms)
        got = self.last["greedy_select"]()
        want = gf.lazier_greedy_select_ref(obs, valid, n, None, lazier_factor, base_mat, eps,
                                           batch, uniforms)
        g, w = got[1].tolist(), want[1].tolist()
        self.sel.append({
            "frame": self.slam.frame_id, "picks_differing": sum(a != b for a, b in zip(g, w)),
            "objective_diff": float(gf.selection_logdet(obs, got[0], base_mat, eps))
            - float(gf.selection_logdet(obs, want[0], base_mat, eps)),
            "bits_equal_against": equal_against(self.last["greedy_select"], got,
                                                self.against)})
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


FX, FY, CX, CY, BF = 450.0, 450.0, 320.0, 240.0, 45.0


def pose_problem(seed, n, mono=False):
    """tests/test_torch_pose_lm.py's kind of problem on the card: n points,
    30 % of them outliers, 10 % not valid."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(2, 10, n)], -1)
    R = lie.so3_exp(torch.from_numpy(rng.normal(0, 0.05, 3).astype(np.float32))).numpy()
    t = rng.normal(0, 0.2, 3)
    pc = X @ R.T + t
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1)
    uv += rng.normal(0, 0.7, (n, 2))
    ur = uv[:, 0] - BF / pc[:, 2] + rng.normal(0, 0.7, n)
    ur[mono | (rng.random(n) < 0.3)] = -1.0
    bad = rng.random(n) < 0.3
    uv[bad] += rng.normal(0, 25, (int(bad.sum()), 2))
    inv2 = 1.0 / 1.2 ** (2 * rng.integers(0, 4, n))
    valid = rng.random(n) < 0.9
    dR = lie.so3_exp(torch.from_numpy(rng.normal(0, 0.02, 3).astype(np.float32))).numpy()
    arrs = [np.asarray(a, np.float32) for a in (dR @ R, t + rng.normal(0, 0.1, 3), X, uv, ur, inv2)]
    return [torch.from_numpy(a).cuda() for a in arrs] + [torch.from_numpy(valid).cuda()]


def select_problem(seed, P, D, n_valid=None, lazier=10):
    """P information-like matrices (chip_smoke.py's cap pool when `seed` is
    None), n_valid of them candidates (85 % if None), the first five's sum
    as the base, and the lazier uniforms (as phase lm_select draws the cap
    pool's)."""
    if seed is None:
        M, valid, base = chip_smoke.cap_problem(P, D)
    else:
        g = torch.Generator(device="cuda").manual_seed(seed)
        A = torch.randn((P, D, D), generator=g, device="cuda")
        M = A @ A.transpose(1, 2) / D + torch.eye(D, device="cuda")
        M = (M * (0.5 + 1.5 * torch.rand((P, 1, 1), generator=g, device="cuda"))).contiguous()
        valid = torch.rand(P, generator=g, device="cuda") < 0.85
        base = M[:5].sum(0).contiguous()
    if n_valid is not None:
        order = torch.randperm(P, generator=torch.Generator().manual_seed(P + D)).cuda()
        valid = (torch.arange(P, device="cuda") < n_valid)[order]
    u = gf.lazier_uniforms(M, 160, torch.Generator(device="cuda").manual_seed(14), lazier)
    return M, valid, base, u


def synthetic_against(lib_path):
    """The kernels against the library at `lib_path`, bit for bit, on
    synthetic problems: the pose LM at 3 x 8, 4 x 10 and 1 x 5 on 0-2,000
    points, stereo and mono, each also with no valid point, every point
    behind the camera and a non-finite point; the selection at D = 7 and
    13, lazier 10, 100, 1,000 and exact greedy, with and without a base, on
    pools of 300 and 4,096 and at the kernel's cap. Both builds timed by
    CUDA-graph replay at the main path's shapes and the cap."""
    cases = []
    for seed, n, mono, sched in ((31, 1024, False, (3, 8)), (32, 1000, True, (4, 10)),
                                 (33, 37, False, (3, 8)), (34, 0, False, (3, 8)),
                                 (35, 2000, False, (3, 8)), (36, 1024, True, (3, 8)),
                                 (37, 1025, False, (4, 10)), (38, 256, False, (1, 5))):
        ts = pose_problem(seed, n, mono)
        variants = [("as_drawn", ts)]
        if n:
            nan_X = ts[2].clone()
            nan_X[0] = float("nan")
            variants += [("no_valid", ts[:6] + [torch.zeros_like(ts[6])]),
                         ("behind_camera", ts[:2] + [-ts[2]] + ts[3:6] + [torch.ones_like(ts[6])]),
                         ("non_finite_point", ts[:2] + [nan_X] + ts[3:])]
        for label, tensors in variants:
            def call(tensors=tensors):
                return KERNEL_LM(*tensors, FX, FY, CX, CY, BF, *sched, 1e-5)
            rec = {"kernel": "pose_lm", "n": n, "mono": mono, "schedule": sched, "case": label,
                   "bits_equal": equal_against(call, call(), lib_path)}
            if label == "as_drawn" and n >= 1000:
                rec.update(timed(call, lib_path, 10))
            cases.append(rec)
    cap = greedy_select_cuda.MAX_SLOTS
    for seed, P, D, n_valid, lazier in ((60, 4096, 7, None, 10), (64, 4096, 7, 500, 10),
                                        (64, 4096, 13, 500, 10), (61, 300, 7, None, 1),
                                        (61, 300, 13, None, 1), (66, 4096, 7, 500, 100),
                                        (67, 4096, 13, 300, 1000), (None, cap, 7, None, 10),
                                        (None, cap, 13, None, 10)):
        M, valid, base, u = select_problem(seed, P, D, n_valid, lazier)
        for b in (base, None):
            def call(b=b):
                return KERNEL_SEL(M, valid, 160, None, lazier, b, uniforms=u)
            rec = {"kernel": "greedy_select", "P": P, "D": D, "candidates": int(valid.sum()),
                   "lazier": lazier, "base": b is not None,
                   "bits_equal": equal_against(call, call(), lib_path)}
            if b is not None and (n_valid == 500 or seed is None):
                rec.update(timed(call, lib_path, 5))
            cases.append(rec)
    return cases


def timed(call, lib_path, inner):
    """Device ms of `call` by CUDA-graph replay, from this build and from
    the library at `lib_path`, alternating twice."""
    ms, ms_against = [], []
    for _ in range(2):
        ms.append(chip_smoke.time_cuda_graph(call, 20, inner))
        with cuda_lib.using(lib_path):
            ms_against.append(chip_smoke.time_cuda_graph(call, 20, inner))
    return {"ms": ms, "ms_against": ms_against}


def first_parting(a, b, tol):
    d = np.abs(a - b).max(1)
    idx = np.nonzero(d > tol)[0]
    return int(idx[0]) if idx.size else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=chip_smoke.N_FRAMES)
    ap.add_argument("--out", default=os.path.join(ROOT, "profile_out"))
    ap.add_argument("--against", metavar="SRC",
                    help="also hold every kernel call against the kernels built from SRC/*.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    tour, tour_gt = chip_smoke.render_tour()
    imgs, gt = tour[:args.frames], tour_gt[:args.frames]
    against = None
    if args.against:
        sources = tuple(sorted(glob.glob(os.path.join(args.against, "*.cu"))))
        if not sources:
            sys.exit(f"--against {args.against}: no *.cu there")
        against = cuda_lib.build(sources=sources)
    shadow = Shadow(against)
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
    if against:
        synthetic = synthetic_against(against)
        out["against"] = {
            "src": args.against,
            **{f"{name}_calls_bits_equal": [sum(bool(c["bits_equal_against"]) for c in calls),
                                            len(calls)]
               for name, calls in (("pose_lm", shadow.lm), ("greedy_select", shadow.sel))},
            "main_path_last_call": {name: timed(call, against, 10 if name == "pose_lm" else 5)
                                    for name, call in shadow.last.items()},
            "synthetic_bits_equal": [sum(bool(c["bits_equal"]) for c in synthetic),
                                     len(synthetic)],
            "synthetic": synthetic}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "kernel_vs_plain_torch.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

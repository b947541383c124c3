"""Distributed-BA scaling harness (the port of
`gf_orb_slam2_tpu/parallel/scaling_bench.py`).

Times one LM iteration of the point-sharded BA (parallel/dist_ba.py) for
each world size: a world of D ranks is started by parallel/launch.py, one
process per device — D <= the GPU count on `cuda` (NCCL), D <= the core
count on `cpu` (gloo; numbers then measure the harness on shared cores,
not hardware scaling, but the collective program runs at every size).

  python -m gf_orb_slam2_tpu_torch.parallel.scaling_bench --devices 1 2 4 8 \
      --points 16384                 # strong scaling (fixed problem)
  python -m gf_orb_slam2_tpu_torch.parallel.scaling_bench --devices 1 2 4 8 \
      --points-per-device 4096       # weak scaling
  ... --device cpu                   # gloo ranks on the CPU

One JSON row per world size, as the JAX harness prints, plus the device.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

CAM = (450.0, 450.0, 320.0, 240.0, 45.0)


def build_problem(P, K=32, O=8, seed=0):
    """The JAX harness's problem: K poses along x, P points, O observations
    per point in random KFs with 0.3 px noise, translations and points
    perturbed, KF 0 fixed. The port's LocalBAProblem on the CPU."""
    from gf_orb_slam2_tpu_torch.geometry import lie
    from gf_orb_slam2_tpu_torch.optim.local_ba import LocalBAProblem

    rng = np.random.default_rng(seed)
    gt_pts = np.stack(
        [rng.uniform(-10, 10, P), rng.uniform(-5, 5, P), rng.uniform(4, 40, P)], -1
    ).astype(np.float32)
    xi = np.zeros((K, 6), np.float32)
    xi[:, 0] = 0.5 * np.arange(K)
    xi[:, 4] = 0.002 * np.arange(K)
    R, t = lie.se3_exp(torch.from_numpy(xi))
    kf_R, kf_t = R.numpy(), t.numpy()
    obs_kf = rng.integers(0, K, (P, O)).astype(np.int32)
    pck = np.einsum("poij,poj->poi", kf_R[obs_kf],
                    np.broadcast_to(gt_pts[:, None, :], (P, O, 3))) + kf_t[obs_kf]
    z = np.maximum(pck[..., 2], 0.5)
    u = 450.0 * pck[..., 0] / z + 320.0 + rng.normal(0, 0.3, (P, O))
    v = 450.0 * pck[..., 1] / z + 240.0 + rng.normal(0, 0.3, (P, O))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    kf_t = kf_t + rng.normal(0, 0.02, (K, 3)).astype(np.float32) * ~fixed[:, None]
    pts = gt_pts + rng.normal(0, 0.05, (P, 3)).astype(np.float32)
    arrays = (kf_R, kf_t, fixed, np.ones(K, bool), pts, np.ones(P, bool), obs_kf,
              np.stack([u, v], -1).astype(np.float32), (u - 45.0 / z).astype(np.float32),
              np.ones((P, O), np.float32), pck[..., 2] > 0.5)
    return LocalBAProblem(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))


def time_rank(P, iters, ablate_collectives, device):
    """Rank target: one warm iteration, then `iters` timed ones (ending in a
    device synchronize on `cuda`); rank 0's (ms per iteration, cost)."""
    from gf_orb_slam2_tpu_torch.parallel.dist_ba import distributed_ba
    from gf_orb_slam2_tpu_torch.parallel.mesh import make_mesh

    prob = build_problem(P)
    mesh = make_mesh(device=device)

    def run(n):
        out = distributed_ba(mesh, prob, *CAM, iters=n, ablate_collectives=ablate_collectives)
        if device == "cuda":
            torch.cuda.synchronize()
        return out

    run(1)
    t0 = time.perf_counter()
    out = run(iters)
    return (time.perf_counter() - t0) / iters * 1e3, float(out[3])


def available(device: str) -> int:
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs a CUDA device; none is available")
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def device_name(device: str) -> str:
    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def main(argv=None):
    from gf_orb_slam2_tpu_torch.parallel.launch import launch
    # the ranks import the target by its module name, not as __main__
    from gf_orb_slam2_tpu_torch.parallel.scaling_bench import time_rank

    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--points-per-device", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--ablate-collectives", action="store_true",
                    help="run identical per-rank compute with the cross-rank "
                         "reductions removed (timing-only; separates collective "
                         "cost from oversubscribed host cores)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    n_avail = available(args.device)
    base = None
    for n_dev in args.devices:
        if n_dev > n_avail:
            print(f"# skipping {n_dev} devices ({n_avail} available)")
            continue
        P = (args.points_per_device * n_dev if args.points_per_device
             else args.points)
        P = ((P + n_dev - 1) // n_dev) * n_dev
        dt, cost = launch(time_rank, (P, args.iters, args.ablate_collectives, args.device),
                          world_size=n_dev, device=args.device, timeout=900)
        row = {"devices": n_dev, "points": P, "ms_per_iter": round(dt, 2),
               "cost": round(cost, 2), "device": device_name(args.device)}
        if base is None:
            base = dt
        if args.points_per_device:
            row["weak_efficiency"] = round(base / dt, 3)
        else:
            row["strong_speedup"] = round(base / dt, 3)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()

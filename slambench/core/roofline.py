"""Peaks of the chip and the least time of the two hand kernels' calls.

A frozen copy of `chip_smoke.py`'s counts (its `bound`, `logdet_flops`,
`POSE_FLOPS_STEP` / `POSE_FLOPS_ONCE` and the bytes `time_pose` and
`time_select` count), so that a change to the program cannot move the
yardstick. A call's least time is the larger of its bytes over the memory
bandwidth and its float32 operations over the float32 rate outside the
tensor cores; inputs are counted read once and outputs written once.
"""
from __future__ import annotations

import numpy as np

# one NVIDIA H100 SXM, NVIDIA's data sheet, at its full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# float32 operations a point in csrc/pose_lm.cu: a step's Jacobian pass
# (projection 36, Huber 6, Jacobian 38, normal equations 180) and its
# candidate's cost pass (42); the first cost pass and the final gate once
POSE_FLOPS_STEP, POSE_FLOPS_ONCE = 302, 78


def least_s(bytes_, flops):
    return max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def pose_lm_least_s(n, rounds, iters):
    """R0, t0 and 29 bytes a point read; R, t, the inlier count and 5 bytes
    a point written."""
    return least_s(48 + 29 * n + 48 + 5 * n + 8,
                   n * (POSE_FLOPS_STEP * rounds * iters + POSE_FLOPS_ONCE))


def logdet_flops(d):
    """float32 operations of one candidate's logdet in csrc/greedy_select.cu:
    the scaling (3 a diagonal entry, 4 a lower entry), the Cholesky and the
    logs."""
    chol = sum(2 * j + 5 + (d - 1 - j) * (2 * j + 1) for j in range(d))
    return 3 * d + 4 * d * (d + 1) // 2 + chol + 2 * d + 2


def greedy_select_least_s(call):
    """One selection: its matrices, mask, base and uniforms read once, its
    mask and order written once; the logdets of the candidates this call's
    lazier sample scored and a trace and a compare for every candidate of
    every round, replayed from its mask, uniforms and picks."""
    P, D = call["P"], call["D"]
    B = max(1, min(call["batch"], call["n_select"]))
    rounds = -(-call["n_select"] // B)
    valid = call["valid"].cpu().numpy()
    order = call["order"].cpu().numpy()
    u = None if call["uniforms"] is None else call["uniforms"].cpu().numpy()
    inv_l = 1.0 / max(call["lazier"], 1)
    selected = np.zeros(P, bool)
    sampled_total = cand_total = 0
    for k in range(rounds):
        cand = valid & ~selected
        cand_total += int(cand.sum())
        sampled = cand if (u is None or inv_l >= 1.0) else cand & (u[k] < inv_l)
        if not sampled.any():
            sampled = cand
        sampled_total += int(sampled.sum())
        picks = [p for p in order[k * B:(k + 1) * B] if p >= 0]
        selected[picks] = True
    n_u = 0 if u is None else u.size
    bytes_ = P * D * D * 4 + P + (D * D * 4 if call["base"] else 0) + n_u * 4 + P + rounds * B * 8
    return least_s(bytes_, sampled_total * logdet_flops(D) + cand_total * (D + 1))

"""The motion-only pose LM as one hand-written CUDA kernel (csrc/pose_lm.cu).

`pose_lm` enqueues the whole rounds × iters Levenberg-Marquardt solve of one
frame as one launch on the current stream: it replaces the JAX package's XLA
program `gf_orb_slam2_tpu/optim/pose_opt.py:81` `pose_optimization` (a
`lax.scan`). Its plain PyTorch version is `optim/pose_opt.py`
`pose_optimization_ref`; `optim/pose_opt.py` `pose_optimization` picks
between the two by the tensors' device. The source is built at first use by
`ops/cuda_lib.py`.
"""
from __future__ import annotations

import torch

from gf_orb_slam2_tpu_torch.ops import cuda_lib

NAME = "pose_lm"


def pose_lm(R0, t0, Xw, uv, u_right, inv_sigma2, valid, fx, fy, cx, cy, bf,
            rounds: int, iters: int, damping: float):
    """The solve on the card: float32 CUDA tensors R0 [3,3], t0 [3], Xw
    [N,3], uv [N,2], u_right [N], inv_sigma2 [N] and bool valid [N], all
    contiguous on one device; the camera as numbers. Returns (R, t,
    inliers, n_inliers, chi2) without synchronizing. Raises TypeError on
    another dtype, ValueError on a CPU or non-contiguous tensor or a shape
    that does not fit — both before anything is built."""
    f32 = torch.float32
    cuda_lib.check_on_card(NAME, dict(R0=R0, t0=t0, Xw=Xw, uv=uv, u_right=u_right,
                                      inv_sigma2=inv_sigma2, valid=valid),
                           dict(R0=f32, t0=f32, Xw=f32, uv=f32, u_right=f32,
                                inv_sigma2=f32, valid=torch.bool))
    n = Xw.shape[0]
    shapes = {"R0": (R0, (3, 3)), "t0": (t0, (3,)), "Xw": (Xw, (n, 3)), "uv": (uv, (n, 2)),
              "u_right": (u_right, (n,)), "inv_sigma2": (inv_sigma2, (n,)),
              "valid": (valid, (n,))}
    for name, (x, want) in shapes.items():
        if tuple(x.shape) != want:
            raise ValueError(f"{NAME}: {name} has shape {tuple(x.shape)}, expected {want}")
    if rounds < 0 or iters < 0 or n >= 2 ** 24:
        raise ValueError(f"{NAME}: rounds {rounds}, iters {iters}, N {n} out of range")
    dev = Xw.device
    R = torch.empty((3, 3), dtype=f32, device=dev)
    t = torch.empty(3, dtype=f32, device=dev)
    inliers = torch.empty(n, dtype=torch.bool, device=dev)
    n_inliers = torch.empty((), dtype=torch.int64, device=dev)
    chi2 = torch.empty(n, dtype=f32, device=dev)
    cuda_lib.launch(NAME, "pose_lm_launch", dev,
                    R0.data_ptr(), t0.data_ptr(), Xw.data_ptr(), uv.data_ptr(),
                    u_right.data_ptr(), inv_sigma2.data_ptr(), valid.data_ptr(), n,
                    float(fx), float(fy), float(cx), float(cy), float(bf),
                    int(rounds), int(iters), float(damping),
                    R.data_ptr(), t.data_ptr(), inliers.data_ptr(), n_inliers.data_ptr(),
                    chi2.data_ptr())
    return R, t, inliers, n_inliers, chi2

"""The lazier-greedy Max-logDet selection as one hand-written CUDA kernel
(csrc/greedy_select.cu).

`greedy_select` enqueues every round of one selection as one launch on the
current stream: it replaces the JAX package's XLA program
`gf_orb_slam2_tpu/selection/good_feature.py:32` `lazier_greedy_select` (a
`lax.scan`). Its plain PyTorch version is `selection/good_feature.py`
`lazier_greedy_select_ref`; `selection/good_feature.py`
`lazier_greedy_select` picks between the two by the tensors' device and
draws the lazier sample's uniforms for both the same way. The source is
built at first use by `ops/cuda_lib.py`.
"""
from __future__ import annotations

import torch

from gf_orb_slam2_tpu_torch.ops import cuda_lib

NAME = "greedy_select"
DIMS = (7, 13)      # the kernel's template instances: the 7-dof pose and the 13-state hybrid
MAX_BATCH = 64
MAX_SLOTS = 16384   # shared memory: 13 bytes a slot (the largest pool of any path: 4096)


def greedy_select(obs_mats, valid, n_select: int, batch: int, lazier_factor: int,
                  eps: float, base_mat=None, uniforms=None):
    """The selection on the card: float32 CUDA tensors obs_mats [P,D,D]
    (D = 7 or 13), bool valid [P], optional base_mat [D,D] and, when
    `lazier_factor` > 1, the [rounds,P] uniforms of the lazier sample; all
    contiguous on one device. Returns (selected [P] bool, order [n_select]
    int64, -1 padding) without synchronizing. Raises TypeError on another
    dtype, ValueError on a CPU or non-contiguous tensor or a shape the kernel
    does not take — all before anything is built."""
    f32 = torch.float32
    P = obs_mats.shape[0]
    B = max(1, min(batch, n_select))
    rounds = -(-n_select // B)
    inv_l = 1.0 / max(lazier_factor, 1)
    tensors, dtypes = dict(obs_mats=obs_mats, valid=valid), dict(obs_mats=f32, valid=torch.bool)
    if base_mat is not None:
        tensors["base_mat"], dtypes["base_mat"] = base_mat, f32
    if inv_l < 1.0:
        if uniforms is None:
            raise ValueError(f"{NAME}: lazier_factor {lazier_factor} needs the uniforms")
        tensors["uniforms"], dtypes["uniforms"] = uniforms, f32
    cuda_lib.check_on_card(NAME, tensors, dtypes)
    if obs_mats.dim() != 3 or obs_mats.shape[1] != obs_mats.shape[2] or obs_mats.shape[1] not in DIMS:
        raise ValueError(f"{NAME}: obs_mats must be [P,D,D] with D in {DIMS}, "
                         f"got {tuple(obs_mats.shape)}")
    D = obs_mats.shape[1]
    if tuple(valid.shape) != (P,):
        raise ValueError(f"{NAME}: valid has shape {tuple(valid.shape)}, expected {(P,)}")
    if base_mat is not None and tuple(base_mat.shape) != (D, D):
        raise ValueError(f"{NAME}: base_mat has shape {tuple(base_mat.shape)}, expected {(D, D)}")
    if inv_l < 1.0 and tuple(uniforms.shape) != (rounds, P):
        raise ValueError(f"{NAME}: uniforms have shape {tuple(uniforms.shape)}, "
                         f"expected {(rounds, P)}")
    if n_select < 1 or B > MAX_BATCH or not B <= P <= MAX_SLOTS:
        raise ValueError(f"{NAME}: n_select {n_select}, batch {B}, P {P}: the kernel takes "
                         f"1 <= batch <= {MAX_BATCH} and batch <= P <= {MAX_SLOTS}")
    dev = obs_mats.device
    selected = torch.empty(P, dtype=torch.bool, device=dev)
    order = torch.empty(rounds * B, dtype=torch.int64, device=dev)
    cuda_lib.launch(NAME, "greedy_select_launch", dev,
                    obs_mats.data_ptr(), valid.data_ptr(),
                    None if base_mat is None else base_mat.data_ptr(),
                    uniforms.data_ptr() if inv_l < 1.0 else None,
                    P, D, int(n_select), B, rounds, float(inv_l), float(eps),
                    selected.data_ptr(), order.data_ptr())
    return selected, order[:n_select]

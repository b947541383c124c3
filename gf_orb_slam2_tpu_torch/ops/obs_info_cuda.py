"""The good-feature selection's information matrices as one hand-written CUDA
kernel (csrc/obs_info.cu).

`obs_info` enqueues, as one launch of the kernel and one torch sum on the
current stream, what the local step's Max-logDet selection takes: each pool row's [7,7] information matrix
and the matched set's [7,7] sum, from the pose, bit for bit as the plain
version computes them on the card. It replaces the torch form
of the JAX package's jnp code in its local step
(`gf_orb_slam2_tpu/selection/observability.py` `info_matrices` /
`pose_info_from_frame`, `gf_orb_slam2_tpu/geometry/lie.py` `rot_to_quat`).
Its plain PyTorch version is `selection/observability.py`
`pose_info_for_selection_ref`; `selection/observability.py`
`pose_info_for_selection` picks between the two by the tensors' device. The
source is built at first use by `ops/cuda_lib.py`.
"""
from __future__ import annotations

import torch

from gf_orb_slam2_tpu_torch.ops import cuda_lib

NAME = "obs_info"


def obs_info(R0, t0, pos, pred_octave, valid, scales, kp_mp_pos, kp_mp_valid,
             fx, fy, bf, stereo: bool):
    """The matrices on the card: float32 CUDA tensors R0 [3,3] and t0 [3]
    (the pose, world → camera), pos [P,3], scales [L] and kp_mp_pos [n,3],
    int64 pred_octave [P], bool valid [P] and kp_mp_valid [n], all contiguous
    on one device; the camera and the sensor's stereo flag as numbers.
    Returns (obs [P,7,7], base [7,7]) without synchronizing: one launch of
    the kernel, which also writes the keypoints' [n,7,7], then their sum
    over the rows (torch's, as the plain version sums them). Raises
    TypeError on another dtype, ValueError on a CPU or non-contiguous tensor
    or a shape the kernel does not take — all before anything is built."""
    f32 = torch.float32
    tensors = dict(R0=R0, t0=t0, pos=pos, pred_octave=pred_octave, valid=valid,
                   scales=scales, kp_mp_pos=kp_mp_pos, kp_mp_valid=kp_mp_valid)
    cuda_lib.check_on_card(NAME, tensors, dict(
        R0=f32, t0=f32, pos=f32, pred_octave=torch.int64, valid=torch.bool, scales=f32,
        kp_mp_pos=f32, kp_mp_valid=torch.bool))
    P, n, L = pos.shape[0], kp_mp_pos.shape[0], scales.shape[0]
    shapes = dict(R0=(3, 3), t0=(3,), pos=(P, 3), pred_octave=(P,), valid=(P,), scales=(L,),
                  kp_mp_pos=(n, 3), kp_mp_valid=(n,))
    for name, want in shapes.items():
        if tuple(tensors[name].shape) != want:
            raise ValueError(f"{NAME}: {name} has shape {tuple(tensors[name].shape)}, "
                             f"expected {want}")
    if L < 1:
        raise ValueError(f"{NAME}: scales has no level")
    dev = pos.device
    obs = torch.empty((P, 7, 7), dtype=f32, device=dev)
    kp_obs = torch.empty((n, 7, 7), dtype=f32, device=dev)
    cuda_lib.launch(NAME, "obs_info_launch", dev,
                    R0.data_ptr(), t0.data_ptr(), pos.data_ptr(), pred_octave.data_ptr(),
                    valid.data_ptr(), scales.data_ptr(), kp_mp_pos.data_ptr(),
                    kp_mp_valid.data_ptr(), P, n, L, float(fx), float(fy), float(bf),
                    int(bool(stereo)), obs.data_ptr(), kp_obs.data_ptr())
    return obs, kp_obs.sum(0)

"""Full-f32 matmul pin for small-matrix geometry/optimization code.

Reduced-precision matmul passes are catastrophic for 3x3/4x4 pose math and
normal equations (the JAX package measured 0.045 m triangulation error with
them against 1e-3 at full precision); TF32 on Hopper keeps about three
decimal digits and is the same trap. Importing this module pins every
float32 matmul and convolution of the process to full precision.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

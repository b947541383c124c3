"""PyTorch/CUDA port of the good-feature visual SLAM engine.

Second package beside the JAX one, written for one NVIDIA Hopper GPU. It
covers synchronous stereo tracking — ORB extraction, stereo matching,
motion-model + local-map tracking with good-feature selection and pose
optimization, the keyframe policy and stereo keyframe creation
(`System.track_stereo`) — and synchronous local mapping on every keyframe
event: triangulation, fusion, local BA with good-graph selection, keyframe
culling. It imports torch and numpy only.

Entry points take an explicit `device` and default to "cuda"; nothing picks
the CPU because no GPU was found. The hand-written Hamming kernels
(csrc/hamming.cu, csrc/hamming_best2.cu) are built at first use, never at
import.
"""

__version__ = "0.1.0"

from gf_orb_slam2_tpu_torch.utils import precision as _precision  # noqa: F401  (pins full-f32 matmul)
from gf_orb_slam2_tpu_torch.config import (  # noqa: F401
    CameraConfig,
    ORBConfig,
    TrackingConfig,
    GoodFeatureConfig,
    GoodGraphConfig,
    HashingConfig,
    SystemConfig,
    Sensor,
)

"""PyTorch/CUDA port of the good-feature visual SLAM engine.

Second package beside the JAX one, written for one NVIDIA Hopper GPU, and
doing all that the JAX package does: stereo, monocular and RGB-D tracking
(`System.track_stereo`, the pipelined `track_stereo_pipelined` with an
asynchronous mapping worker, `track_monocular` with the two-view
initializer, `track_rgbd`) — ORB extraction, stereo matching, motion-model
and local-map tracking with good-feature (Max-logDet) selection and pose
optimization, the keyframe policy —, relocalization (EPnP RANSAC), local
mapping on every keyframe event (triangulation, fusion, local BA with
good-graph selection, keyframe culling), place recognition with loop closing
(BoW keyframe database, Sim3 RANSAC, loop correction with search-and-fuse,
the essential graph and the global BA), hashed local maps (MIH), map and
trajectory IO with localization mode, distributed bundle adjustment over
torch.distributed (`parallel/`: point-sharded and KF-sharded layouts,
`parallel.launch` starting one process per device), the offline CLI and
tools (examples/*_torch.py, tools/*_torch.py) and bench.py's headline run
(bench_torch.py at the repository root). It imports torch and numpy only;
the BoW vocabulary is read as data from the JAX package's assets directory.

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

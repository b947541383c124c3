"""Build, load and count the port's hand-written CUDA kernels.

Every `csrc/*.cu` source is compiled at first use with `nvcc` for sm_90a
(one compiler process per source, started together, then one link) into
one shared library with a plain C interface under `<package>/_build/`
(content-hashed name), and loaded with ctypes: importing this module needs
neither nvcc nor a GPU. The kernels' wrappers (`ops/hamming_cuda.py`,
`ops/pose_lm_cuda.py`, `ops/greedy_select_cuda.py`, `ops/obs_info_cuda.py`) enqueue through
`launch`, which counts each launch by kernel and by the launching thread's
name (the pipelined System's workers are the threads named "mapping" and
"loop") on the port's counters (utils/tracing.py, `launch.<kernel>`); the
plain PyTorch versions never count.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from collections.abc import Mapping

import torch

from gf_orb_slam2_tpu_torch.utils import tracing

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(sorted(glob.glob(os.path.join(_PKG_DIR, "csrc", "*.cu"))))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# -fmad=false: no FMA contraction, so the float kernels round every product
# and sum on their own, as the plain versions' elementwise launches do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

# the C entry points: name → argument types after the stream (which is last)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRIES = {
    "hamming_distance_matrix_launch": [_P, _P, _P, _I, _I],
    "hamming_masked_best2_launch": [_P, _P, _P, _P, _P, _P, _I, _I],
    "empty_kernel_launch": [],
    "pose_lm_launch": [_P] * 7 + [_I] + [_F] * 5 + [_I, _I, _F] + [_P] * 5,
    "greedy_select_launch": [_P] * 4 + [_I] * 5 + [_F, _F, _P, _P],
    "obs_info_launch": [_P] * 8 + [_I] * 3 + [_F] * 3 + [_I] + [_P] * 2,
}

KERNELS = ("hamming_distance_matrix", "hamming_masked_best2", "pose_lm", "greedy_select",
           "obs_info")
_load_lock = threading.Lock()
_lib = None


class _LaunchCounts(Mapping):
    """Launches of each CUDA kernel by this process since the last reset: a
    read-only view of the counters `launch.<kernel>` summed over threads."""

    def __getitem__(self, name):
        if name not in KERNELS:
            raise KeyError(name)
        return tracing.counters().get("launch." + name, 0)

    def __iter__(self):
        return iter(KERNELS)

    def __len__(self):
        return len(KERNELS)

    def __repr__(self):
        return repr(dict(self))


launch_counts = _LaunchCounts()


def reset_launch_counts():
    tracing.reset_counters("launch.")


def thread_launch_counts(thread_name: str) -> dict:
    """Launches of each kernel by the threads of that name since the last
    reset."""
    mine = tracing.counters(thread_name)
    return {k: mine.get("launch." + k, 0) for k in KERNELS}


def _find_nvcc() -> str:
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, $PATH, /usr/local/cuda/bin): "
        "the CUDA kernels are compiled from csrc/*.cu at first use")


def _run_all(cmds, verbose):
    """Start every command at once, wait for all, raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if verbose and out:
            print(out, flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")


def build(verbose: bool = False, sources=SOURCES) -> str:
    """Compile csrc/*.cu (or other `sources` defining the same C entries)
    into one shared library in the build directory (skipped when a library
    built from the same sources and flags is already there). Returns the
    library path. Raises on any compiler failure. `verbose` prints the
    compiler's output (`-Xptxas -v`: registers, shared memory and spills of
    every kernel)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libgfslam_kernels_{tag}.so")
    if not os.path.exists(lib_path):
        nvcc = _find_nvcc()
        stem = f"{lib_path}.{os.getpid()}.{threading.get_ident()}"
        objs = [f"{stem}.{i}.o" for i in range(len(sources))]
        extra = ["-Xptxas", "-v"] if verbose else []
        try:
            _run_all([[nvcc, *NVCC_FLAGS, *extra, "-c", "-o", obj, src]
                      for src, obj in zip(sources, objs)], verbose)
            _run_all([[nvcc, "-shared", "-o", f"{stem}.tmp", *objs]], verbose)
            os.replace(f"{stem}.tmp", lib_path)
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
    return lib_path


def load(verbose: bool = False):
    """Build (if needed) and load the kernel library; idempotent and safe to
    call from several threads at once."""
    global _lib
    with _load_lock:
        if _lib is None:
            _lib = _open(build(verbose))
    return _lib


@functools.lru_cache(maxsize=None)
def _open(path):
    lib = ctypes.CDLL(path)
    for name, args in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = [*args, _P]
        fn.restype = _I
    return lib


@contextlib.contextmanager
def using(lib_path):
    """Inside the block every wrapper, in every thread, launches from the
    kernel library at `lib_path` (built by `build` from other sources, e.g.
    an earlier commit's csrc/*.cu) instead of this package's; launches count
    as usual. For holding two builds of the kernels against each other."""
    global _lib
    own, other = load(), _open(lib_path)
    with _load_lock:
        _lib = other
    try:
        yield
    finally:
        with _load_lock:
            _lib = own


def launch(name, entry, device, *args):
    """Enqueue kernel `name` through C entry `entry` on `device`'s current
    stream (never synchronizing) and count it. Raises if the launch was
    refused (the entry returns `cudaGetLastError()`)."""
    lib = load()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    tracing.count("launch." + name)


def launch_empty_kernel():
    """Enqueue a kernel that does nothing on the current stream: its time is
    the floor under any kernel timed the same way. Counts as no launch."""
    err = load().empty_kernel_launch(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def check_on_card(fname, tensors, dtypes):
    """The checks every kernel entry point makes before anything is built:
    each named tensor of the right dtype (TypeError), then all on one CUDA
    device and contiguous (ValueError). `tensors`: {name: tensor};
    `dtypes`: {name: dtype}."""
    for name, t in tensors.items():
        if t.dtype != dtypes[name]:
            raise TypeError(f"{fname}: {name} must be {dtypes[name]}, got {t.dtype}")
    devices = {t.device for t in tensors.values()}
    if not all(t.is_cuda for t in tensors.values()):
        raise ValueError(f"{fname} launches a CUDA kernel: the inputs must be CUDA "
                         f"tensors (got {sorted(map(str, devices))}; the plain version "
                         f"takes CPU tensors)")
    if len(devices) != 1:
        raise ValueError(f"{fname}: inputs on different devices {sorted(map(str, devices))}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{fname}: {name} must be contiguous")

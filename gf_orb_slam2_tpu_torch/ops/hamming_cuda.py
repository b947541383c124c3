"""Hand-written CUDA kernel for the 256-bit Hamming distance matrix.

`hamming_distance_matrix(da, db)` launches csrc/hamming.cu on CUDA tensors;
`hamming_distance_matrix_ref(da, db)` is the plain PyTorch version of the
same function (XOR → parallel bit-count in tensor arithmetic → sum), used for CPU
tensors and to hold the kernel against on the card. There is no fallback
between them: a CUDA tensor launches the kernel or raises.

The kernel replaces the JAX package's Pallas kernel
(gf_orb_slam2_tpu/ops/pallas_hamming.py). It is built at first use with
`nvcc` for sm_90a into `<package>/_build/` as a shared library with a plain
C interface and loaded with ctypes — importing this module needs neither
nvcc nor a GPU.

Descriptors are int32 tensors carrying the 256 bits as 8 words (torch has no
shifts on uint32); the kernel treats the words as unsigned.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "hamming.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# launches of the CUDA kernel by this process (the plain version never counts)
launch_counts = {"hamming_distance_matrix": 0}

_lib = None
_ROW_CHUNK = 256  # rows per step of the plain version (bounds its scratch)


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


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
        "the Hamming kernel is compiled from csrc/hamming.cu at first use")


def build(verbose: bool = False) -> str:
    """Compile csrc/hamming.cu into the build directory (skipped when a
    library built from the same source and flags is already there).
    Returns the library path. Raises on any compiler failure."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libgfslam_hamming_{tag}.so")
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_find_nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if verbose and (proc.stdout or proc.stderr):
            print(proc.stdout + proc.stderr, flush=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
    return lib_path


def load(verbose: bool = False):
    """Build (if needed) and load the kernel library; idempotent."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build(verbose))
        fn = lib.hamming_distance_matrix_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, d):
    if d.dim() != 2 or d.shape[1] != 8:
        raise ValueError(f"{name}: expected shape [*, 8], got {tuple(d.shape)}")
    if d.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"{name}: expected a 4-byte integer dtype, got {d.dtype}")


def hamming_distance_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """da [N,8], db [M,8] 32-bit words on one CUDA device → [N,M] int32.

    Launches the CUDA kernel on the current stream without synchronizing.
    """
    _check("da", da)
    _check("db", db)
    if not (da.is_cuda and db.is_cuda):
        raise ValueError("hamming_distance_matrix launches a CUDA kernel: both "
                         "inputs must be CUDA tensors (use "
                         "hamming_distance_matrix_ref for CPU tensors)")
    if da.device != db.device:
        raise ValueError(f"inputs on different devices: {da.device} vs {db.device}")
    if not (da.is_contiguous() and db.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    n, m = da.shape[0], db.shape[0]
    out = torch.empty((n, m), dtype=torch.int32, device=da.device)
    if n == 0 or m == 0:
        return out
    if da.data_ptr() % 16 or db.data_ptr() % 16:
        raise ValueError("inputs must be 16-byte aligned")
    lib = load()
    with torch.cuda.device(da.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hamming_distance_matrix_launch(
            da.data_ptr(), db.data_ptr(), out.data_ptr(), n, m, stream)
    if err != 0:
        raise RuntimeError(f"hamming kernel launch failed: CUDA error {err}")
    launch_counts["hamming_distance_matrix"] += 1
    return out


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Sum of set bits over the last dim of int32 words: [...,W] → [...] int32.

    Plain tensor arithmetic (the parallel bit-count): torch has no popcount
    operator. The words are int32, so `>>` is an arithmetic shift; every
    shifted value is masked with a constant whose top bits are zero, which
    makes it the logical shift the bit-count needs."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) >> 24) & 0xFF
    return x.sum(-1, dtype=torch.int32)


def hamming_distance_matrix_ref(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `hamming_distance_matrix` (any device)."""
    _check("da", da)
    _check("db", db)
    da = da.view(torch.int32) if da.dtype != torch.int32 else da
    db = db.view(torch.int32) if db.dtype != torch.int32 else db
    n, m = da.shape[0], db.shape[0]
    out = torch.empty((n, m), dtype=torch.int32, device=da.device)
    for r0 in range(0, n, _ROW_CHUNK):
        x = da[r0:r0 + _ROW_CHUNK, None, :] ^ db[None, :, :]
        out[r0:r0 + _ROW_CHUNK] = popcount_words(x)
    return out

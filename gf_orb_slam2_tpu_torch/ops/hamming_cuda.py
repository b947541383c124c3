"""Hand-written CUDA kernels for 256-bit Hamming matching.

Two kernels, both replacing the JAX package's Pallas kernel
(gf_orb_slam2_tpu/ops/pallas_hamming.py):

- `hamming_distance_matrix(da, db)` launches csrc/hamming.cu: the full [N,M]
  matrix, bit-counted on the tensor cores (binary `mma.sync ... and.popc`).
  Bound by the bytes of its output; measured on an H100 at 6.2 µs for
  4096×1024 (byte bound 5.06 µs; the SIMT `__popc` version before it took
  11 µs) and 3.0 µs for 1024×1024, where an empty kernel takes 1.2 µs;
- `hamming_masked_best2(da, db, mask)` launches csrc/hamming_best2.cu: the
  same distances reduced in the kernel to best column / best / second best
  per row under a mask, without writing the matrix. This is the form the
  matching calls use. A warp per row visits only the entries the mask lets
  through, so it is bound by the bytes of the mask (1.32 µs at 4096×1024);
  measured at 3-4 µs on the sparse masks of the tracking path — launch plus
  dependent trips to memory, not bytes — where the matrix kernel followed by
  `masked_best2` takes 130 µs on the device. A dense mask puts it on the
  POPC pipe: 36 µs on an all-true mask at 4096×1024.

`hamming_distance_matrix_ref` and `hamming_masked_best2_ref` are the plain
PyTorch versions of the same functions (XOR → parallel bit-count in tensor
arithmetic → sum; composite-key minimum), used for CPU tensors and to hold
the kernels against on the card. There is no fallback between them: a CUDA
tensor launches the kernel or raises.

The sources are built at first use with `nvcc` for sm_90a (one compiler
process per source, started together, then one link) into
`<package>/_build/` as a shared library with a plain C interface and loaded
with ctypes — importing this module needs neither nvcc nor a GPU.

Descriptors are int32 tensors carrying the 256 bits as 8 words (torch has no
shifts on uint32); the kernels treat the words as unsigned.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = (os.path.join(_PKG_DIR, "csrc", "hamming.cu"),
           os.path.join(_PKG_DIR, "csrc", "hamming_best2.cu"))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

MAX_DIST = 256
MAX_COLUMNS = 1 << 22  # the best-2 key d*M + column must fit 32 bits

# launches of each CUDA kernel by this process (the plain versions never
# count), in all and by the name of the launching thread (the pipelined
# System's mapping worker is the thread named "mapping")
launch_counts = {"hamming_distance_matrix": 0, "hamming_masked_best2": 0}
launch_counts_by_thread = {}
_count_lock = threading.Lock()

_lib = None
_ROW_CHUNK = 256  # rows per step of the plain version (bounds its scratch)


def reset_launch_counts():
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0
        launch_counts_by_thread.clear()


def thread_launch_counts(thread_name: str) -> dict:
    """Launches of each kernel by the threads of that name since the last
    reset."""
    with _count_lock:
        return dict(launch_counts_by_thread.get(thread_name, dict.fromkeys(launch_counts, 0)))


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
        "the Hamming kernels are compiled from csrc/*.cu at first use")


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


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into one shared library in the build directory
    (skipped when a library built from the same sources and flags is already
    there). Returns the library path. Raises on any compiler failure."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libgfslam_hamming_{tag}.so")
    if not os.path.exists(lib_path):
        nvcc = _find_nvcc()
        stem = f"{lib_path}.{os.getpid()}"
        objs = [f"{stem}.{i}.o" for i in range(len(SOURCES))]
        extra = ["-Xptxas", "-v"] if verbose else []
        try:
            _run_all([[nvcc, *NVCC_FLAGS, *extra, "-c", "-o", obj, src]
                      for src, obj in zip(SOURCES, objs)], verbose)
            _run_all([[nvcc, "-shared", "-o", f"{stem}.tmp", *objs]], verbose)
            os.replace(f"{stem}.tmp", lib_path)
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
    return lib_path


def load(verbose: bool = False):
    """Build (if needed) and load the kernel library; idempotent."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build(verbose))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hamming_distance_matrix_launch.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
    lib.hamming_masked_best2_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.empty_kernel_launch.argtypes = [ptr]
    for fn in (lib.hamming_distance_matrix_launch, lib.hamming_masked_best2_launch,
               lib.empty_kernel_launch):
        fn.restype = i32
    _lib = lib
    return _lib


def _check(name, d):
    if d.dim() != 2 or d.shape[1] != 8:
        raise ValueError(f"{name}: expected shape [*, 8], got {tuple(d.shape)}")
    if d.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"{name}: expected a 4-byte integer dtype, got {d.dtype}")


def _check_on_card(fname, da, db):
    if not (da.is_cuda and db.is_cuda):
        raise ValueError(f"{fname} launches a CUDA kernel: the inputs must be "
                         f"CUDA tensors (use {fname}_ref for CPU tensors)")
    if da.device != db.device:
        raise ValueError(f"inputs on different devices: {da.device} vs {db.device}")
    if not (da.is_contiguous() and db.is_contiguous()):
        raise ValueError("inputs must be contiguous")


def _launch(name, entry, device, *args):
    """Enqueue one kernel on `device`'s current stream and count it."""
    lib = load()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    with _count_lock:
        launch_counts[name] += 1
        mine = launch_counts_by_thread.setdefault(
            threading.current_thread().name, dict.fromkeys(launch_counts, 0))
        mine[name] += 1


def launch_empty_kernel():
    """Enqueue a kernel that does nothing on the current stream: its time is
    the floor under any kernel timed the same way. Counts as no launch."""
    err = load().empty_kernel_launch(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def hamming_distance_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """da [N,8], db [M,8] 32-bit words on one CUDA device → [N,M] int32.

    Launches the CUDA kernel on the current stream without synchronizing.
    """
    _check("da", da)
    _check("db", db)
    _check_on_card("hamming_distance_matrix", da, db)
    n, m = da.shape[0], db.shape[0]
    out = torch.empty((n, m), dtype=torch.int32, device=da.device)
    if n == 0 or m == 0:
        return out
    if da.data_ptr() % 16 or db.data_ptr() % 16:
        raise ValueError("inputs must be 16-byte aligned")
    _launch("hamming_distance_matrix", "hamming_distance_matrix_launch", da.device,
            da.data_ptr(), db.data_ptr(), out.data_ptr(), n, m)
    return out


def _check_mask(mask, n, m):
    if mask.dtype != torch.bool:
        raise TypeError(f"mask: expected torch.bool, got {mask.dtype}")
    if tuple(mask.shape) != (n, m):
        raise ValueError(f"mask: expected shape {(n, m)}, got {tuple(mask.shape)}")
    if m >= MAX_COLUMNS:
        raise ValueError(f"M = {m}: the best-2 key needs M < {MAX_COLUMNS}")


def hamming_masked_best2(da: torch.Tensor, db: torch.Tensor, mask: torch.Tensor):
    """Best and second-best Hamming match per row under a mask, without the
    matrix: da [N,8], db [M,8] 32-bit words, mask [N,M] bool, all on one CUDA
    device → (best_idx [N] int64, best [N] int32, second [N] int32), equal to
    `masked_best2(hamming_distance_matrix(da, db), mask)`.

    Launches the CUDA kernel on the current stream without synchronizing.
    """
    _check("da", da)
    _check("db", db)
    n, m = da.shape[0], db.shape[0]
    _check_mask(mask, n, m)
    _check_on_card("hamming_masked_best2", da, db)
    if mask.device != da.device:
        raise ValueError(f"mask on {mask.device}, descriptors on {da.device}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    if m == 0:
        return _all_masked(n, da.device)
    best_idx = torch.empty(n, dtype=torch.int64, device=da.device)
    best = torch.empty(n, dtype=torch.int32, device=da.device)
    second = torch.empty(n, dtype=torch.int32, device=da.device)
    if n == 0:
        return best_idx, best, second
    if da.data_ptr() % 16 or db.data_ptr() % 16:
        raise ValueError("inputs must be 16-byte aligned")
    _launch("hamming_masked_best2", "hamming_masked_best2_launch", da.device,
            da.data_ptr(), db.data_ptr(), mask.data_ptr(),
            best_idx.data_ptr(), best.data_ptr(), second.data_ptr(), n, m)
    return best_idx, best, second


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


def _all_masked(n, device, dtype=torch.int32):
    full = torch.full((n,), MAX_DIST, dtype=dtype, device=device)
    return torch.zeros(n, dtype=torch.int64, device=device), full, full.clone()


def masked_best2(dist: torch.Tensor, mask: torch.Tensor):
    """Best and second-best per row under mask (plain PyTorch, any device).

    dist: [N,M] int32; mask: [N,M] bool.
    Returns (best_idx [N] int64, best [N], second [N]); masked-out rows get
    best = MAX_DIST and best_idx = 0. Ties go to the lowest column: the
    argmin is taken over the composite key d·M + column, which is unique per
    row, so CPU and CUDA agree.
    """
    n, m = dist.shape
    if m == 0:
        return _all_masked(n, dist.device, dist.dtype)
    d = torch.where(mask, dist, MAX_DIST)
    cols = torch.arange(m, device=dist.device, dtype=torch.int64)
    key = (d.to(torch.int64) * m + cols).min(dim=1).values
    best_idx = key % m
    best = (key // m).to(dist.dtype)
    d2 = d.scatter(1, best_idx[:, None], MAX_DIST)
    second = d2.min(dim=1).values
    return best_idx, best, second


def hamming_masked_best2_ref(da: torch.Tensor, db: torch.Tensor, mask: torch.Tensor):
    """Plain PyTorch version of `hamming_masked_best2` (any device)."""
    dist = hamming_distance_matrix_ref(da, db)
    _check_mask(mask, *dist.shape)
    return masked_best2(dist, mask)

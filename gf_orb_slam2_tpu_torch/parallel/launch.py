"""Start a world of ranks, one process each, and bring back rank 0's result.

Takes the place of the JAX package's virtual device mesh: `launch(target,
args, world_size, device)` starts `world_size` processes of

    python -m gf_orb_slam2_tpu_torch.parallel.launch <dir> <rank>

which meet through a `file://` store in a fresh temporary directory (no TCP
port, so concurrent worlds cannot collide), bring up the default process
group (`mesh.init_world`: gloo on `cpu`, NCCL on `cuda`), run `target(*args)`
with one torch thread each, and return what rank 0's call returned.

Every launch has a hard deadline: the rendezvous and every collective time
out after `timeout` seconds, and the launcher kills every rank and raises
once that time has passed since the launch, so a rank that never joins or a
hung collective fails the caller instead of hanging it. A rank that exits
with an error ends the launch at once, its log's tail in the exception.

`target` is pickled by reference: it must be importable (not defined in a
script run as `__main__`). The ranks see the launcher's `sys.path`.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time

SPEC = "spec.pkl"
RESULT = "result.pkl"
POLL_S = 0.05


def launch(target, args=(), world_size: int = 1, device: str = "cuda",
           timeout: float = 120.0):
    """Run `target(*args)` on every rank of a new world; rank 0's return
    value. Raises TimeoutError past the deadline, RuntimeError when a rank
    fails."""
    if getattr(target, "__module__", None) == "__main__":
        raise ValueError("the target must be importable by the ranks, "
                         "not defined in __main__")
    with tempfile.TemporaryDirectory(prefix="gfslam_world_") as tmp:
        with open(os.path.join(tmp, SPEC), "wb") as f:
            pickle.dump({"target": target, "args": tuple(args), "device": device,
                         "world_size": world_size, "timeout": timeout}, f)
        path = [os.path.abspath(p or os.curdir) for p in sys.path]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(path), OMP_NUM_THREADS="1")
        deadline = time.monotonic() + timeout
        procs = []
        try:
            for rank in range(world_size):
                procs.append(_start_rank(tmp, rank, env))
            _wait(procs, tmp, deadline, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        with open(os.path.join(tmp, RESULT), "rb") as f:
            return pickle.load(f)


def run_all(calls):
    """A target that runs several: `calls` is a list of (function, args);
    returns their results in order."""
    return [fn(*a) for fn, a in calls]


def _log_path(tmp, rank):
    return os.path.join(tmp, f"rank{rank}.log")


def _start_rank(tmp: str, rank: int, env: dict) -> subprocess.Popen:
    with open(_log_path(tmp, rank), "wb") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "gf_orb_slam2_tpu_torch.parallel.launch", tmp, str(rank)],
            stdin=subprocess.DEVNULL, stdout=log, stderr=subprocess.STDOUT, env=env)


def _tail(tmp, rank, n=3000):
    try:
        with open(_log_path(tmp, rank), "rb") as f:
            return f.read()[-n:].decode(errors="replace")
    except OSError:
        return ""


def _wait(procs, tmp, deadline, timeout):
    while True:
        codes = [p.poll() for p in procs]
        for rank, rc in enumerate(codes):
            if rc not in (None, 0):
                raise RuntimeError(f"rank {rank} of {len(procs)} exited with code {rc}:\n"
                                   + _tail(tmp, rank))
        if all(rc == 0 for rc in codes):
            return
        if time.monotonic() > deadline:
            waiting = [r for r, rc in enumerate(codes) if rc is None]
            raise TimeoutError(f"ranks {waiting} of {len(procs)} still running after "
                               f"{timeout} s:\n" + _tail(tmp, waiting[0]))
        time.sleep(POLL_S)


def _rank_main(tmp: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from gf_orb_slam2_tpu_torch.parallel.mesh import init_world

    torch.set_num_threads(1)
    with open(os.path.join(tmp, SPEC), "rb") as f:
        spec = pickle.load(f)
    init_world(spec["device"], rank, spec["world_size"],
               "file://" + os.path.join(tmp, "store"), spec["timeout"])
    try:
        out = spec["target"](*spec["args"])
        if rank == 0:
            part = os.path.join(tmp, RESULT + ".part")
            with open(part, "wb") as f:
                pickle.dump(out, f)
            os.replace(part, os.path.join(tmp, RESULT))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))

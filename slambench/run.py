#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Renders the cell's frames on the card from the seed, builds the port's
System, warms it up, offers the frames for `--seconds` as the cell's
traffic says, checks the returned poses and map against the scene, and
prints one JSON line: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device` and, traced, `breakdown`. Exits non-zero without a line when no
CUDA device is there. See slambench/core/bench.py.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("USE_FLAX", "0")
# one process, few threads: the host's thread pools (torch's intra-op pool,
# OpenMP and BLAS under numpy) are held to one thread each, so the driving
# thread and the port's worker threads do not contend with idle spinners
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")


from slambench.core.bench import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main())

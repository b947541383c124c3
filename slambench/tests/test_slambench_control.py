"""The control comes out not correct, on the card.

The configurations state no numeric precision (TF32 in the port's float32
products was tried and reads like the sound runs, PERF.md §6), so the
control breaks a guarantee they do state, metric scale: `run.py --control
scale` hands System the stereo baseline (or the depth factor) 5 % off. Each
cell at its own size and window, on three seeds (the limits are set for
that window: a shorter flight spreads a 5 % scale error over fewer
metres). Needs the card;
run there with

    python -m pytest --noconftest -m cuda slambench/tests/test_slambench_control.py

(`--noconftest`: the repository's conftest imports JAX, which the harness's
process must not hold).
"""
import json
import os
import subprocess
import sys

import pytest

from slambench.core import bench

SPEC = json.load(open(os.path.join(bench.ROOT, "BENCHMARK.json")))
SEEDS = (2 ** 31 + 901, 2 ** 31 + 902, 2 ** 31 + 903)
SECONDS = SPEC["run_seconds"]


def run(workload, seed):
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload", workload,
                          "--seed", str(seed), "--seconds", str(SECONDS), "--trace", "0",
                          "--control", "scale"],
                         cwd=bench.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_control_is_not_correct(workload, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the harness runs on the card only)")
    r = run(workload, seed)
    print(workload, seed, json.dumps(r["checks"]))
    assert not r["correct"], r["checks"]

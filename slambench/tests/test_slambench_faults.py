"""A run with the timed path broken underneath comes out not correct.

The harness's look for a chip is skipped (run_cell on the CPU); the rest of a
run is the cell's own: its configuration at its size, its traffic with a
short window, the port, and the check. Faults that a SLAM cell can have:
the entry returns its state unchanged (the same pose every frame), and an
answer altered where it is produced (each returned pose moved by 0.2 m a
coordinate, at random). Halving a batch and dropping an exchange between
chips have no place here: a frame is no batch whose mean is taken, and a
cell runs on one chip.

The faults' readings at the cell's own size (the reference's poses put in
the program's place, the fault planted in them) are held here too: they set
the upper reading of the cell's `ate_m`, which the control moves less than
three times (PERF.md §6).
"""
import json
import os

import numpy as np
import pytest
import torch

from slambench.core import bench
from slambench.reference import check
from slambench.scene import motion

SPEC = json.load(open(os.path.join(bench.ROOT, "BENCHMARK.json")))
# the short window: long enough that a pose left unchanged drifts off the
# path by more than the cell's `ate_m` limit (40 frames of the handheld's
# 30 Hz camera at 0.4 m/s, offered at 10 Hz)
SECONDS = {"tum_rgbd_gf.camera_rate": 4.0}
SEED = 2 ** 31 + 101


@pytest.fixture(scope="module", params=sorted(SECONDS))
def cell(request):
    torch.set_num_threads(4)
    # the CPU takes about a second a frame at the cell's size: the window's
    # frames come back long after the deadline a card's run is held to
    deadline = bench.DEADLINE_S
    bench.DEADLINE_S = 900.0
    c = bench.Cell(request.param)
    c.traffic = dict(c.traffic, warmup_frames=8)
    yield c
    bench.DEADLINE_S = deadline


def run(cell):
    # (the test process has JAX loaded by the repo's conftest: what the
    # harness itself loads is held in a fresh interpreter, in
    # test_slambench_harness.py)
    return bench.run_cell(cell, SEED, SECONDS[cell.name], False, device="cpu")[0]


def altered(T, rng):
    T = np.array(T)
    T[:3, 3] += rng.normal(0.0, 0.2, 3)
    return T


@pytest.fixture
def patched(monkeypatch):
    from gf_orb_slam2_tpu_torch.system import System

    def apply(cell, kind):
        entry = cell.traffic["entry"]
        orig = getattr(System, entry)
        first = {}
        rng = np.random.default_rng(0)

        def broken(self, image, other, ts):
            T = np.array(orig(self, image, other, ts))
            if kind == "unchanged":
                return first.setdefault("T", T)
            return altered(T, rng)

        monkeypatch.setattr(System, entry, broken)

    return apply


def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] == int(np.ceil(cell.traffic["rate_hz"] * SECONDS[cell.name]))
    assert r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_broken_path_is_not_correct(cell, patched, kind):
    patched(cell, kind)
    r = run(cell)
    assert not r["correct"], r["checks"]
    assert r["checks"]["ate_m"]["value"] > r["checks"]["ate_m"]["limit"]


def fault_readings(workload, seed):
    """ate_m of the true poses of the cell's window at its own size, with
    each fault planted in them."""
    c = bench.Cell(workload)
    tr = c.traffic
    warm = int(tr["warmup_frames"])
    n = warm + int(np.ceil(tr["rate_hz"] * SPEC["run_seconds"]))
    R_wc, C = motion.trajectory(tr["motion"], n, float(c.config["Camera.fps"]), seed)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = np.transpose(R_wc, (0, 2, 1))
    T[:, :3, 3] = -np.einsum("nji,nj->ni", R_wc, C)
    ids = np.arange(warm, n)
    rng = np.random.default_rng(0)
    out = {"sound": T[ids], "unchanged": np.repeat(T[ids][:1], len(ids), 0),
           "altered": np.stack([altered(t, rng) for t in T[ids]])}
    return {k: check.fit_rmse(v, R_wc[ids], C[ids])[0] for k, v in out.items()}, c.limits


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13])
@pytest.mark.parametrize("workload", sorted(SECONDS))
def test_fault_readings_at_the_cells_size(workload, seed):
    reading, limits = fault_readings(workload, seed)
    print(workload, seed, reading)
    assert reading["sound"] < 1e-9
    # each fault reads well above the limit (PERF.md §6 has the readings)
    assert min(reading["unchanged"], reading["altered"]) > 2 * limits["ate_m"]

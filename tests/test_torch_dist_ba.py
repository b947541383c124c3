"""Parity of the port's distributed BA (gf_orb_slam2_tpu_torch/parallel/)
with the JAX package on the CPU.

The JAX package runs on its 8-device virtual CPU mesh (conftest.py); the
port runs one gloo rank per device, each a process started by
`parallel.launch` (a world of 2 and one of 8, each running all its cases
and returning them to the test), and a world of 1 in this process. The
problems are `tests/test_local_ba.build_problem`'s, as in
`tests/test_dist_ba.py`.

Tolerances: against JAX and between world sizes, kf_t atol 1e-3, pt_pos
atol 5e-3 (the JAX package's own 1-vs-8-device bounds,
tests/test_dist_ba.py) and the cost rtol 1e-3 (sums over shards in another
order); convergence to ground truth with the JAX test's bounds; one PCG
step against the dense step atol 2e-4 (the JAX test's). Collective calls
and bytes per LM iteration exactly equal to the formula
(tools/collective_audit_torch.py).
"""
import functools
import time

import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu.parallel.dist_ba import distributed_ba as jax_distributed_ba
from gf_orb_slam2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gf_orb_slam2_tpu_torch.convert import ba_problem_from_arrays
from gf_orb_slam2_tpu_torch.parallel import dist_ba, launch as launch_mod, mesh as tmesh
from gf_orb_slam2_tpu_torch.parallel.mesh import HOST_AXIS
from tests.test_local_ba import BF, CX, CY, FX, FY, build_problem
from tools import collective_audit_torch as audit

torch.set_num_threads(1)

CAM = (FX, FY, CX, CY, BF)
KF_T_ATOL = 1e-3
PT_ATOL = 5e-3
COST_RTOL = 1e-3
WORLD_TIMEOUT_S = 300.0  # a hang guard: the 8-rank world takes ~10 s alone, more beside other workers


def _problem(seed, **kw):
    prob, gt_R, gt_t, gt_pts = build_problem(np.random.default_rng(seed), **kw)
    return [np.asarray(a) for a in prob], prob, gt_t, gt_pts


PROBLEMS = {
    "converge": dict(seed=0, K=6, P=304, O=6),
    "equal": dict(seed=1, K=6, P=304, O=6),
    "pcg_converge": dict(seed=2, K=16, P=512, O=8),
    "one_step": dict(seed=3, K=8, P=256, O=6),
}


@functools.lru_cache(maxsize=None)
def _arrays(name):
    kw = dict(PROBLEMS[name])
    return _problem(kw.pop("seed"), **kw)


def _solve(name, iters, mesh_shape=None, kf_sharded=False, scatter_axis=None):
    return (dist_ba.solve_arrays, (_arrays(name)[0], CAM, iters, mesh_shape, kf_sharded,
                                   scatter_axis, "cpu"))


def _world_calls():
    """The cases each launched world runs, in order."""
    return {
        2: [_solve("converge", 12)],
        8: [
            _solve("converge", 12),                                   # (b)
            _solve("equal", 6),                                       # (c)
            _solve("pcg_converge", 12, kf_sharded=True),              # (d)
            _solve("one_step", 1),                                    # (d)
            _solve("one_step", 1, kf_sharded=True),                   # (d)
            _solve("pcg_converge", 12, (2, 4), True, HOST_AXIS),      # (e)
            (audit.audit_rank, (_arrays("pcg_converge")[0], audit.LAYOUTS, "cpu")),  # (f)
        ],
    }


@pytest.fixture(scope="module")
def worlds():
    """Both launched worlds' results: {2: [...], 8: [...]}."""
    return {n: launch_mod.launch(launch_mod.run_all, (calls,), world_size=n,
                                 device="cpu", timeout=WORLD_TIMEOUT_S)
            for n, calls in _world_calls().items()}


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo world of one rank in this process."""
    store = tmp_path_factory.mktemp("world1") / "store"
    tmesh.init_world("cpu", 0, 1, f"file://{store}", timeout=WORLD_TIMEOUT_S)
    try:
        yield tmesh.make_mesh(device="cpu")
    finally:
        torch.distributed.destroy_process_group()


def _port(mesh, name, iters, **kw):
    out = dist_ba.distributed_ba(mesh, ba_problem_from_arrays(_arrays(name)[0], "cpu"),
                                 *CAM, iters=iters, **kw)
    return tuple(t.numpy() for t in out)


def _jax(n_dev, name, iters, **kw):
    out = jax_distributed_ba(jax_make_mesh(n_dev), _arrays(name)[1], *CAM, iters=iters, **kw)
    return tuple(np.asarray(a) for a in out)


def _assert_same(got, want):
    np.testing.assert_allclose(got[1], want[1], atol=KF_T_ATOL)
    np.testing.assert_allclose(got[2], want[2], atol=PT_ATOL)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=COST_RTOL)


def _assert_converged(out, name):
    _, _, gt_t, gt_pts = _arrays(name)
    terr = np.linalg.norm(out[1] - gt_t, axis=-1)
    assert terr[1:].max() < 0.02, terr
    assert np.median(np.linalg.norm(out[2] - gt_pts, axis=-1)) < 0.1


@pytest.mark.parametrize("kf_sharded", [False, True], ids=["point_sharded", "kf_sharded_pcg"])
def test_world_of_one_matches_jax(world1, kf_sharded):
    """(a) World size 1 against JAX's one-device mesh, 6 iterations."""
    _assert_same(_port(world1, "equal", 6, kf_sharded=kf_sharded),
                 _jax(1, "equal", 6, kf_sharded=kf_sharded))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_matches_ground_truth(worlds, n_dev):
    """(b) The point-sharded BA converges on 2 and 8 ranks."""
    _assert_converged(worlds[n_dev][0], "converge")


def test_eight_ranks_equal_one_and_jax(world1, worlds):
    """(c) World 8 = world 1 = JAX's 8-device mesh."""
    got8 = worlds[8][1]
    _assert_same(got8, _port(world1, "equal", 6))
    _assert_same(got8, _jax(8, "equal", 6))


def test_kf_sharded_pcg_converges_and_matches_dense(worlds):
    """(d) The KF-sharded PCG BA converges on 8 ranks (and agrees with JAX's
    on its 8-device mesh); one PCG step equals one dense step."""
    _assert_converged(worlds[8][2], "pcg_converge")
    _assert_same(worlds[8][2], _jax(8, "pcg_converge", 12, kf_sharded=True))
    np.testing.assert_allclose(worlds[8][4][1], worlds[8][3][1], atol=2e-4)


def test_host_scatter_mesh_gives_the_same_result(worlds):
    """(e) A 2x4 hosts x devices mesh with the camera-system scatter on the
    host axis gives the 1x8 PCG result."""
    _assert_converged(worlds[8][5], "pcg_converge")
    _assert_same(worlds[8][5], worlds[8][2])


@pytest.mark.parametrize("layout", range(len(audit.LAYOUTS)),
                         ids=["point_1x8", "pcg_1x8", "point_2x4", "pcg_2x4_host"])
def test_collectives_per_iteration_equal_the_formula(worlds, layout):
    """(f) Calls and result bytes per LM iteration of each layout and mesh,
    counted by the audit's wrapper, equal the formula; the PCG's all-gather
    runs 48 times."""
    row = worlds[8][6][layout]
    assert row["measured"] == row["expected"], row
    if row["layout"] == "kf_sharded_pcg":
        gathers = [v for k, v in row["measured"].items() if k.endswith("all_gather_into_tensor")]
        assert [g["calls"] for g in gathers] == [48]


def test_rank_that_never_joins_fails_within_the_deadline(monkeypatch):
    """(g) A world whose rank 1 never reaches the rendezvous: the launcher
    raises within its deadline and leaves no process running."""
    started = []
    real = launch_mod._start_rank

    def start(tmp, rank, env):
        if rank == 1:
            import subprocess
            import sys

            p = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
        else:
            p = real(tmp, rank, env)
        started.append(p)
        return p

    monkeypatch.setattr(launch_mod, "_start_rank", start)
    deadline = 10.0
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        launch_mod.launch(launch_mod.run_all, ([],), world_size=2, device="cpu",
                          timeout=deadline)
    assert time.monotonic() - t0 < deadline + 10.0
    assert len(started) == 2 and all(p.poll() is not None for p in started)

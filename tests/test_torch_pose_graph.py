"""Parity of the port's essential-graph Sim3 pose-graph LM
(optim/pose_graph.py) with the JAX package on the CPU, on the problems of
tests/test_pose_graph.py: drift around a circle closed by one loop edge,
the fixed vertex, and monocular scale drift — plus the quality gates of
that file on the port's own solve.

Tolerances: poses (R, t, s) 1e-4 absolute and cost rtol 1e-3, or 1e-7
absolute where the solve converged to a cost of a few 1e-6 (the f32 floor of
a sum of 20-30 squared 7-vectors) — the same LM on the same f32 problem,
with the Jacobians from forward-mode autodiff on both sides; a near-tie in a
step acceptance would show as a larger gap.
"""
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu.optim.pose_graph import optimize_pose_graph as j_optimize
from gf_orb_slam2_tpu_torch.optim.pose_graph import PoseGraphProblem, optimize_pose_graph
from tests.test_pose_graph import center_err, circle_graph

torch.set_num_threads(1)

POSE_TOL = 1e-4
COST_RTOL = 1e-3
COST_ATOL = 1e-7
CASES = {  # name: (circle_graph kwargs, iterations)
    "drift": (dict(), 20),
    "fixed_vertex": (dict(), 10),
    "scale_drift_mono": (dict(drift=0.02, scale_drift=0.01, fix_scale=False), 25),
    "larger_drift": (dict(K=30, drift=0.05, seed=4), 15),
}


def to_port(prob) -> PoseGraphProblem:
    def conv(x):
        if isinstance(x, bool):
            return x
        a = np.array(x)
        return torch.from_numpy(a.astype(np.float32) if a.dtype == np.float64 else a)

    return PoseGraphProblem(*[conv(x) for x in prob])


@pytest.fixture(scope="module", params=list(CASES))
def solved(request):
    kw, iters = CASES[request.param]
    prob, gt_R, gt_t = circle_graph(**kw)
    want = j_optimize(prob, iters=iters)
    got = optimize_pose_graph(to_port(prob), iters=iters)
    return dict(name=request.param, prob=prob, gt=(gt_R, gt_t), want=[np.asarray(w) for w in want],
                got=[g.numpy() for g in got])


def test_poses_and_cost_match_the_jax_solve(solved):
    for g, w, what in zip(solved["got"][:3], solved["want"][:3], "sRt"):
        np.testing.assert_allclose(g, w, atol=POSE_TOL, err_msg=what)
    np.testing.assert_allclose(solved["got"][3], solved["want"][3], rtol=COST_RTOL,
                               atol=COST_ATOL)


def test_quality_gates_of_the_reference_tests(solved):
    prob, (gt_R, gt_t) = solved["prob"], solved["gt"]
    s, R, t, cost = solved["got"]
    name = solved["name"]
    if name == "drift":  # TestPoseGraph.test_corrects_drift
        err0 = center_err(prob.s, prob.R, prob.t, gt_R, gt_t)
        err1 = center_err(s, R, t, gt_R, gt_t)
        assert err1.max() < 0.25 * err0.max(), (err0.max(), err1.max())
        assert err1.max() < 0.15
    elif name == "fixed_vertex":  # test_fixed_vertex_pinned
        np.testing.assert_allclose(t[0], np.asarray(prob.t)[0], atol=1e-6)
        np.testing.assert_allclose(R[0], np.asarray(prob.R)[0], atol=1e-6)
    elif name == "scale_drift_mono":  # test_sim3_scale_drift_mono
        s0_err = np.abs(np.log(np.asarray(prob.s)))
        assert np.abs(np.log(s)).max() < 0.5 * max(s0_err.max(), 1e-6) + 1e-3
    else:
        err0 = center_err(prob.s, prob.R, prob.t, gt_R, gt_t)
        assert center_err(s, R, t, gt_R, gt_t).max() < 0.5 * err0.max()
    assert np.isfinite(cost)


def test_singular_system_step_is_rejected():
    """Every vertex free and no edge weight: the normal equations are only
    the damping; an all-zero-weight graph must come back unchanged and
    finite (the finiteness guard and the acceptance test)."""
    prob, _, _ = circle_graph(K=6)
    p = to_port(prob)._replace(e_w=torch.zeros(6), fixed=torch.zeros(6, dtype=torch.bool))
    s, R, t, cost = optimize_pose_graph(p, iters=3)
    assert torch.isfinite(R).all() and torch.isfinite(t).all()
    np.testing.assert_allclose(t.numpy(), p.t.numpy(), atol=1e-6)
    assert float(cost) == 0.0

"""Parity of the port's local BA and good-graph selection with the JAX
package on the CPU: the Schur-LM solve on the `tests/test_local_ba.py`
problems (outliers, mono-only, free-pose compaction and its overflow,
rank-deficient, duplicate points, an overflowing step that must be
rejected), the pose Schur blocks, the masked logdet and the incremental
block-Cholesky greedy selection fed the JAX package's own uniforms.

Tolerances: poses 1e-4 after the first five-step stage; after the whole
5 → gate → 10 schedule poses 1e-3, final cost rtol 1e-3 and inlier masks
exact. The looser pose bound is the packages' own f32 spread: near
convergence a step lowers the robust cost by ~1e-6 of its value while the
two sums of ~3000 terms differ by ~4e-6 (summation order), so the last
accept/reject decisions can differ and the poses then part by up to 5e-4
along weakly constrained directions. Schur blocks rtol 1e-4 of the largest
entry; selections exact on well-conditioned S, else by objective (logdet
within 0.1 %).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu.optim import local_ba as jba
from gf_orb_slam2_tpu.selection import anticipation as janti, good_graph as jgg
from gf_orb_slam2_tpu_torch.optim import local_ba as tba
from gf_orb_slam2_tpu_torch.selection import anticipation as tanti, good_graph as tgg
from tests.test_local_ba import BF, CX, CY, FX, FY, build_problem

torch.set_num_threads(1)

CAM = (FX, FY, CX, CY, BF)


def to_port(prob):
    """The JAX LocalBAProblem as the port's (same numpy values)."""
    return tba.LocalBAProblem(*(torch.from_numpy(np.array(a)) for a in prob))


def _outliers(rng):
    return build_problem(rng, outlier_frac=0.05)


def _mono(rng):
    prob = build_problem(rng)[0]
    return prob._replace(obs_ur=jnp.full_like(prob.obs_ur, -1.0)), None


def _rank_deficient(rng):
    prob = build_problem(rng, K=6, n_fixed=1)[0]
    ov = np.asarray(prob.obs_valid) & (np.asarray(prob.obs_kf) != 5)  # orphan pose 5
    return prob._replace(obs_valid=jnp.asarray(ov)), None


def _duplicates(rng):
    prob = build_problem(rng, K=6, P=64)[0]
    pos = np.asarray(prob.pt_pos).copy()
    pos[32:] = pos[:32]
    return prob._replace(pt_pos=jnp.asarray(pos)), None


CASES = {
    "converges": (0, lambda rng: build_problem(rng), None),
    "two_fixed": (1, lambda rng: build_problem(rng, n_fixed=2), None),
    "outliers": (2, _outliers, None),
    "mono_only": (3, _mono, None),
    "free_cap_fits": (4, lambda rng: build_problem(rng, K=8, n_fixed=3), 5),
    "free_cap_overflow": (5, lambda rng: build_problem(rng, K=8, n_fixed=1), 4),
    "rank_deficient": (6, _rank_deficient, None),
    "duplicate_points": (7, _duplicates, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_local_ba_parity(case):
    seed, make, free_cap = CASES[case]
    prob = make(np.random.default_rng(seed))[0]
    tprob = to_port(prob)
    first = dict(iters_first=5, iters_second=0, free_cap=free_cap)
    want = jba.local_bundle_adjustment(prob, *CAM, **first)
    got = tba.local_bundle_adjustment(tprob, *CAM, **first)
    np.testing.assert_allclose(got.kf_R.numpy(), np.asarray(want.kf_R), atol=1e-4)
    np.testing.assert_allclose(got.kf_t.numpy(), np.asarray(want.kf_t), atol=1e-4)
    want = jba.local_bundle_adjustment(prob, *CAM, free_cap=free_cap)
    got = tba.local_bundle_adjustment(tprob, *CAM, free_cap=free_cap)
    for g in got:
        assert torch.isfinite(g.float()).all()
    print(f"{case}: max pose difference {np.abs(got.kf_t.numpy() - np.asarray(want.kf_t)).max():.2e}"
          f" (t), {np.abs(got.kf_R.numpy() - np.asarray(want.kf_R)).max():.2e} (R); cost "
          f"{float(got.final_cost)} vs {float(want.final_cost)}")
    np.testing.assert_allclose(got.kf_R.numpy(), np.asarray(want.kf_R), atol=1e-3)
    np.testing.assert_allclose(got.kf_t.numpy(), np.asarray(want.kf_t), atol=1e-3)
    np.testing.assert_array_equal(got.obs_inlier.numpy(), np.asarray(want.obs_inlier))
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost), rtol=1e-3)
    if case == "free_cap_overflow":  # free poses beyond the cap stay exactly put
        np.testing.assert_array_equal(got.kf_t[5:].numpy(), np.asarray(prob.kf_t[5:]))


def test_non_finite_solve_step_rejected():
    """tests/test_local_ba.py:177 on the port: absurd observation weights
    (1e30) overflow the f32 Schur system. In the port S holds inf/NaN, the
    Cholesky factorization reports it, and every such step is rejected: the
    poses stay finite and do not move while those weights are active. (The
    JAX package's XLA code contracts the 3x3 adjugate to fused multiply-adds
    and keeps S finite, so it takes a large finite step instead — a
    different trajectory through the same test, not a parity case.)"""
    prob = build_problem(np.random.default_rng(8), K=6)[0]
    w = np.asarray(prob.obs_inv_sigma2).copy()
    w[:8] = 1e30
    tprob = to_port(prob._replace(obs_inv_sigma2=jnp.asarray(w)))
    stage1 = tba.local_bundle_adjustment(tprob, *CAM, iters_first=5, iters_second=0)
    assert torch.equal(stage1.kf_R, tprob.kf_R) and torch.equal(stage1.kf_t, tprob.kf_t)
    res = tba.local_bundle_adjustment(tprob, *CAM)
    for g in res:
        assert torch.isfinite(g.float()).all(), "non-finite step accepted"
    start = tba.local_bundle_adjustment(tprob, *CAM, iters_first=0, iters_second=0)
    assert float(res.final_cost) <= float(start.final_cost)


def test_local_ba_converges_to_ground_truth():
    """The micro-gate of tests/test_local_ba.py on the port alone."""
    prob, gt_R, gt_t, gt_pts = build_problem(np.random.default_rng(0))
    res = tba.local_bundle_adjustment(to_port(prob), *CAM)
    terr = np.linalg.norm(res.kf_t.numpy() - gt_t, axis=-1)
    perr = np.linalg.norm(res.pt_pos.numpy() - gt_pts, axis=-1)
    assert terr[1:].max() < 0.01
    assert np.median(perr) < 0.08


def test_one_hot_drops_negative_slots():
    """-1 (and any index outside [0, n)) is a zero row, never the last slot."""
    oh = tba.one_hot(torch.tensor([[-1, 0, 2, 3]]), 3, torch.float32)
    np.testing.assert_array_equal(oh.numpy()[0], [[0, 0, 0], [1, 0, 0], [0, 0, 1], [0, 0, 0]])


def _schur(seed, K, P=200):
    prob = build_problem(np.random.default_rng(seed), K=K, P=P, O=min(8, K))[0]
    return prob, jba.pose_schur_blocks(prob, *CAM)


@pytest.mark.parametrize("K", [6, 10])
def test_pose_schur_blocks_parity(K):
    prob, want = _schur(K, K)
    got = tba.pose_schur_blocks(to_port(prob), *CAM).numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_masked_logdet_parity():
    _, S = _schur(1, 6)
    masks = np.array([[1, 0, 1, 1, 0, 1], [1, 1, 1, 1, 1, 1], [0, 1, 0, 0, 0, 0]], bool)
    want = np.asarray(jgg.masked_logdet(S, jnp.asarray(masks)))
    got = tgg.masked_logdet(torch.from_numpy(np.array(S)), torch.from_numpy(masks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _jax_uniforms(key, n_max, K):
    """The U(0,1) draws select_subgraph makes in each of its rounds."""
    return np.stack([np.asarray(jax.random.uniform(k, (K,)))
                     for k in jax.random.split(key, n_max)])


@pytest.mark.parametrize("K,n_sel,lazier,keep0", [
    (12, 6, 4, True), (12, 12, 4, False), (10, 4, 1, True), (12, 5, 4, False)])
def test_select_subgraph_with_the_jax_uniforms(K, n_sel, lazier, keep0):
    _, S = _schur(2, K)
    free = np.ones(K, bool)
    free[K - 1] = False  # one fixed KF
    keep = np.zeros(K, bool)
    keep[0] = keep0
    key = jax.random.PRNGKey(K + n_sel)
    n_max = K
    want = np.asarray(jgg.select_subgraph(
        S, jnp.asarray(free), n_sel, key, lazier_factor=lazier,
        always_keep=jnp.asarray(keep), n_max=n_max))
    got = tgg.select_subgraph(
        torch.from_numpy(np.array(S)), torch.from_numpy(free), n_sel,
        lazier_factor=lazier, always_keep=torch.from_numpy(keep), n_max=n_max,
        uniforms=torch.from_numpy(_jax_uniforms(key, n_max, K))).numpy()
    assert got.sum() == want.sum() == min(n_sel, free.sum())
    assert not got[K - 1] and (got[0] or not keep0)
    if (got == want).all():
        return
    # a pick swapped at an f32 near-tie: the objective decides
    ld_g = float(jgg.masked_logdet(S, jnp.asarray(got)))
    ld_w = float(jgg.masked_logdet(S, jnp.asarray(want)))
    assert abs(ld_g - ld_w) <= 1e-3 * abs(ld_w)


def test_good_graph_ba_parity():
    """The good-graph path of a BA event (mapping/local_mapping.ba_solve:
    Schur blocks → selection of n_sel free KFs with the new KF first → BA
    with the rest held fixed) against the same composition in the JAX
    package (local_mapping.py:807-823), fed the same uniforms: the same
    selection, poses 1e-3 and cost rtol 1e-3 after the full schedule."""
    from gf_orb_slam2_tpu_torch import config as tconfig
    from gf_orb_slam2_tpu_torch.mapping.local_mapping import ba_solve

    prob = build_problem(np.random.default_rng(9), K=12, P=300, n_fixed=2)[0]
    cfg = tconfig.SystemConfig(camera=tconfig.CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF))
    gg = cfg.good_graph
    K, n_sel, n_max = 12, 6, gg.max_pool
    key = jax.random.PRNGKey(3)
    S = jba.pose_schur_blocks(prob, *CAM)
    free = ~prob.kf_fixed & prob.kf_valid
    keep = jnp.zeros(K, bool).at[2].set(True)
    sel_w = jgg.select_subgraph(S, free, n_sel, key, lazier_factor=gg.lazier_factor,
                                always_keep=keep, n_max=n_max)
    want = jba.local_bundle_adjustment(prob._replace(kf_fixed=prob.kf_fixed | (~sel_w & free)),
                                       *CAM, free_cap=32)
    # ba_solve keeps slot 0 first; put the JAX run's kept KF (slot 2) there
    perm = np.r_[2, 0, 1, 3:K]
    inv = np.argsort(perm)
    tprob = to_port(prob)
    tprob = tprob._replace(kf_R=tprob.kf_R[perm], kf_t=tprob.kf_t[perm],
                           kf_fixed=tprob.kf_fixed[perm], kf_valid=tprob.kf_valid[perm],
                           obs_kf=torch.where(tprob.obs_kf >= 0,
                                              torch.from_numpy(inv)[tprob.obs_kf.clamp(min=0)], -1))
    u = torch.from_numpy(_jax_uniforms(key, n_max, K)[:, perm])
    got, sel_g = ba_solve(tprob, cfg, 32, n_sel, uniforms=u)
    np.testing.assert_array_equal(sel_g.numpy()[inv], np.asarray(sel_w))
    assert int(sel_g.sum()) == n_sel and bool(sel_g[0])
    np.testing.assert_allclose(got.kf_R.numpy()[inv], np.asarray(want.kf_R), atol=1e-3)
    np.testing.assert_allclose(got.kf_t.numpy()[inv], np.asarray(want.kf_t), atol=1e-3)
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost), rtol=1e-3)


def test_select_subgraph_from_a_generator_respects_the_budget():
    _, S = _schur(3, 12)
    St = torch.from_numpy(np.array(S))
    free = torch.ones(12, dtype=torch.bool)
    keep = torch.zeros(12, dtype=torch.bool)
    keep[0] = True
    gen = torch.Generator().manual_seed(7)
    sel = tgg.select_subgraph(St, free, 6, gen, always_keep=keep, n_max=12)
    assert int(sel.sum()) == 6 and bool(sel[0])
    again = tgg.select_subgraph(St, free, 6, torch.Generator().manual_seed(7),
                                always_keep=keep, n_max=12)
    assert torch.equal(sel, again)


def test_budget_and_anticipation_parity():
    for ms in (0.0, 10.0, 100.0, 450.0, 800.0, 1e4):
        assert tgg.estimate_kf_budget(ms) == jgg.estimate_kf_budget(ms)
    R0 = np.eye(3, dtype=np.float32)
    t0 = np.zeros(3, np.float32)
    V = np.eye(4, dtype=np.float32)
    V[:3, 3] = [0.05, 0.0, 0.2]
    want = janti.predict_future_poses(R0, t0, V, 3)
    got = tanti.predict_future_poses(R0, t0, V, 3)
    for (gR, gt), (wR, wt) in zip(got, want):
        np.testing.assert_array_equal(gR, wR)
        np.testing.assert_array_equal(gt, wt)

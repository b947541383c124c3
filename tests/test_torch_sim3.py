"""Parity of the port's Sim3 stage with the JAX package on the CPU: the Sim3
algebra and Horn alignment of geometry/lie.py, the RANSAC `solve_sim3` fed
the JAX package's own draws, the GN polish `optimize_sim3`, the guided
cross-projection search `search_by_sim3` (kernel 1b through its plain
version on CPU tensors), and the analogues of tests/test_sim3.py — including
the pinned composition convention of the loop correction.

Tolerances: integer outputs (inlier masks, match indices, ok flags) exact;
f32 Sim3 parameters to 1e-5 absolute (both sides do the same f32 arithmetic
in another order); the GN polish to 1e-4 (eight steps compound the order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu.geometry import lie as jlie
from gf_orb_slam2_tpu.loopclosing import sim3solver as jsim3
from gf_orb_slam2_tpu.matching import matcher as jmatcher
from gf_orb_slam2_tpu_torch.geometry import lie as tlie
from gf_orb_slam2_tpu_torch.loopclosing import sim3solver as tsim3
from gf_orb_slam2_tpu_torch.matching import matcher as tmatcher

torch.set_num_threads(1)

FX = FY = 450.0
CX, CY = 320.0, 240.0
TOL = 1e-5      # one f32 Sim3 evaluation
TOL_GN = 1e-4   # eight GN steps


def T(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a)


def N(a):
    return np.asarray(a)


def setup(rng, n=120, scale=1.3, outlier_frac=0.2, noise=0.01):
    """tests/test_sim3.py's problem: pc2 = S·pc1 + noise, 20 % outliers."""
    pc1 = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)],
                   -1).astype(np.float32)
    xi = np.concatenate([rng.uniform(-0.3, 0.3, 6), [np.log(scale)]]).astype(np.float32)
    s, R, t = jlie.sim3_exp(jnp.asarray(xi))
    pc2 = np.array(jlie.sim3_apply(jnp.broadcast_to(s, (n,)), R, t, jnp.asarray(pc1)))
    pc2 += rng.normal(0, noise, pc2.shape).astype(np.float32)
    idx = rng.choice(n, int(outlier_frac * n), replace=False)
    pc2[idx] += rng.uniform(0.5, 2.0, (idx.size, 3)).astype(np.float32)
    return pc1, pc2.astype(np.float32), float(s), N(R), N(t)


def jax_draws(key, n_valid, n_hyp=128):
    return N(jax.random.randint(key, (n_hyp, 3), 0, jnp.maximum(n_valid, 3)))


# ----------------------------------------------------------------- algebra
def _twists(rng, n=64):
    xi = rng.uniform(-0.5, 0.5, (n, 7)).astype(np.float32)
    xi[:8, 3:6] *= 1e-4   # small-angle branches
    xi[8:16, 6] *= 1e-4   # small-scale branches
    xi[16:20, 3:7] *= 1e-5
    return xi


def test_sim3_exp_log_apply_inv_compose_parity():
    rng = np.random.default_rng(0)
    xi = _twists(rng)
    js, jR, jt = jlie.sim3_exp(jnp.asarray(xi))
    ts, tR, tt = tlie.sim3_exp(T(xi))
    for g, w in ((ts, js), (tR, jR), (tt, jt)):
        np.testing.assert_allclose(g.numpy(), N(w), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tlie.sim3_log(ts, tR, tt).numpy(),
                               N(jlie.sim3_log(js, jR, jt)), atol=5e-5)
    np.testing.assert_allclose(tlie.sim3_log(ts, tR, tt).numpy(), xi, atol=5e-5)
    pts = rng.normal(0, 2, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(tlie.sim3_apply(ts, tR, tt, T(pts)).numpy(),
                               N(jlie.sim3_apply(js, jR, jt, jnp.asarray(pts))), atol=TOL)
    for g, w in zip(tlie.sim3_inv(ts, tR, tt), jlie.sim3_inv(js, jR, jt)):
        np.testing.assert_allclose(g.numpy(), N(w), atol=TOL, rtol=TOL)
    a, b = slice(0, 32), slice(32, 64)
    got = tlie.sim3_compose(ts[a], tR[a], tt[a], ts[b], tR[b], tt[b])
    want = jlie.sim3_compose(js[a], jR[a], jt[a], js[b], jR[b], jt[b])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), N(w), atol=TOL, rtol=TOL)


def test_horn_and_average_quat_parity():
    """Horn on 3-point (RANSAC) and 40-point sets, both scale modes: R, not
    the SVD's U or V, whose signs may differ."""
    rng = np.random.default_rng(1)
    for n in (3, 40):
        src = rng.normal(0, 2, (16, n, 3)).astype(np.float32) + [0, 0, 6]
        xi = _twists(rng, 16)
        s, R, t = jlie.sim3_exp(jnp.asarray(xi))
        dst = N(jlie.sim3_apply(s[:, None], R[:, None], t[:, None], jnp.asarray(src)))
        dst = dst + rng.normal(0, 0.01, dst.shape).astype(np.float32)
        for fix in (False, True):
            got = tlie.horn_sim3(T(src), T(dst), fix_scale=fix)
            want = jlie.horn_sim3(jnp.asarray(src), jnp.asarray(dst), fix_scale=fix)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), N(w), atol=5e-5)
    q = rng.normal(0, 1, (5, 6, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w = rng.uniform(0.1, 1, (5, 6)).astype(np.float32)
    np.testing.assert_allclose(tlie.average_quat(T(q), T(w)).numpy(),
                               N(jlie.average_quat(jnp.asarray(q), jnp.asarray(w))), atol=1e-5)


# ------------------------------------------------------------------ RANSAC
@pytest.mark.parametrize("seed,scale,fix,drop", [(0, 1.3, False, 0), (1, 1.0, True, 7),
                                                 (2, 0.8, False, 3), (3, 1.0, True, 0)])
def test_solve_sim3_parity_given_jax_draws(seed, scale, fix, drop):
    """The same draws pick the same hypotheses (the valid points first, in
    order: a STABLE argsort); inliers exact, s/R/t to 1e-5."""
    rng = np.random.default_rng(seed)
    pc1, pc2, *_ = setup(rng, scale=scale)
    valid = np.ones(pc1.shape[0], bool)
    if drop:
        valid[::drop] = False
    key = jax.random.PRNGKey(seed)
    want = jsim3.solve_sim3(jnp.asarray(pc1), jnp.asarray(pc2), jnp.asarray(valid),
                            FX, FY, CX, CY, key, fix_scale=fix)
    got = tsim3.solve_sim3(T(pc1), T(pc2), T(valid), FX, FY, CX, CY,
                           draws=T(jax_draws(key, int(valid.sum()))), fix_scale=fix)
    assert bool(got.ok) == bool(want.ok)
    np.testing.assert_array_equal(got.inliers.numpy(), N(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(float(got.s), float(want.s), atol=TOL)
    np.testing.assert_allclose(got.R.numpy(), N(want.R), atol=TOL)
    np.testing.assert_allclose(got.t.numpy(), N(want.t), atol=1e-4)


def test_solve_sim3_with_a_generator_recovers():
    """Without draws, hypotheses come from a torch.Generator (the port's
    own stream): the same problem is still solved."""
    rng = np.random.default_rng(0)
    pc1, pc2, s_true, R_true, t_true = setup(rng)
    gen = torch.Generator().manual_seed(5)
    res = tsim3.solve_sim3(T(pc1), T(pc2), torch.ones(pc1.shape[0], dtype=torch.bool),
                           FX, FY, CX, CY, generator=gen)
    assert bool(res.ok)
    assert abs(float(res.s) - s_true) < 0.05
    assert float(torch.linalg.norm(res.t - T(t_true))) < 0.1
    assert tsim3.draw_hypotheses(2, gen).max() < 3  # at least 3 choices


@pytest.mark.parametrize("fix", [False, True])
def test_optimize_sim3_parity(fix):
    rng = np.random.default_rng(2)
    pc1, pc2, *_ = setup(rng, noise=0.02, scale=1.0 if fix else 1.3)
    key = jax.random.PRNGKey(0)
    r = jsim3.solve_sim3(jnp.asarray(pc1), jnp.asarray(pc2), jnp.ones(120, bool), FX, FY, CX, CY,
                         key, fix_scale=fix)
    want = jsim3.optimize_sim3(r.s, r.R, r.t, jnp.asarray(pc1), jnp.asarray(pc2), r.inliers,
                               FX, FY, CX, CY, fix_scale=fix)
    got = tsim3.optimize_sim3(T(r.s), T(r.R), T(r.t), T(pc1), T(pc2), T(r.inliers),
                              FX, FY, CX, CY, fix_scale=fix)
    np.testing.assert_array_equal(got[3].numpy(), N(want[3]))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), N(w), atol=TOL_GN)
    if fix:
        assert float(got[0]) == 1.0


# ------------------------------------------------------------ guided search
def _two_kfs(rng, n=300):
    """Two KFs seeing one cloud: camera-frame points, descriptors with a few
    flipped bits on the second view, 30 % of keypoints without a point."""
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)],
                 -1).astype(np.float32)
    xi = np.array([0.05, -0.02, 0.1, 0.02, -0.05, 0.01, 0.0], np.float32)
    s, R, t = (N(a) for a in jlie.sim3_exp(jnp.asarray(xi)))
    pc1 = X
    pc2 = (s * X @ R.T + t).astype(np.float32)
    perm = rng.permutation(n)
    pc2 = pc2[perm]
    d1 = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    d2 = d1[perm].copy()
    d2 ^= (rng.integers(0, 2**8, d2.shape, dtype=np.uint32) & np.uint32(0x11))
    v1, v2 = rng.random(n) > 0.3, rng.random(n) > 0.3
    return pc1, pc2, d1, d2, v1, v2, (float(s), R, t), perm


@pytest.mark.parametrize("seed", [0, 1])
def test_search_by_sim3_indices_exact(seed):
    rng = np.random.default_rng(seed)
    pc1, pc2, d1, d2, v1, v2, (s, R, t), perm = _two_kfs(rng)

    def jproj(p):
        z = jnp.maximum(p[..., 2], 1e-6)
        return jnp.stack([FX * p[..., 0] / z + CX, FY * p[..., 1] / z + CY], -1), p[..., 2]

    def tproj(p):
        z = torch.clamp(p[..., 2], min=1e-6)
        return torch.stack([FX * p[..., 0] / z + CX, FY * p[..., 1] / z + CY], -1), p[..., 2]

    want = jmatcher.search_by_sim3(jnp.float32(s), jnp.asarray(R), jnp.asarray(t),
                                   jnp.asarray(pc1), jnp.asarray(pc2), jnp.asarray(d1),
                                   jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2), jproj)
    got = tmatcher.search_by_sim3(T(np.float32(s)), T(R), T(t), T(pc1), T(pc2), T(d1), T(d2),
                                  T(v1), T(v2), tproj)
    np.testing.assert_array_equal(got.valid.numpy(), N(want.valid))
    np.testing.assert_array_equal(got.idx.numpy(), N(want.idx))
    np.testing.assert_array_equal(got.dist.numpy()[N(want.valid)], N(want.dist)[N(want.valid)])
    # and the matches are the true correspondences
    inv = np.argsort(perm)
    ok = got.valid.numpy()
    assert ok.sum() > 100
    np.testing.assert_array_equal(got.idx.numpy()[ok], inv[np.nonzero(ok)[0]])


# ------------------------------------------- analogues of tests/test_sim3.py
def test_ransac_recovers():
    rng = np.random.default_rng(0)
    pc1, pc2, s_true, R_true, t_true = setup(rng)
    res = tsim3.solve_sim3(T(pc1), T(pc2), torch.ones(120, dtype=torch.bool), FX, FY, CX, CY,
                           draws=T(jax_draws(jax.random.PRNGKey(0), 120)))
    assert bool(res.ok)
    assert abs(float(res.s) - s_true) < 0.05
    assert float(torch.linalg.norm(res.t - T(t_true))) < 0.1


def test_fix_scale():
    rng = np.random.default_rng(1)
    pc1, pc2, *_ = setup(rng, scale=1.0)
    res = tsim3.solve_sim3(T(pc1), T(pc2), torch.ones(120, dtype=torch.bool), FX, FY, CX, CY,
                           draws=T(jax_draws(jax.random.PRNGKey(0), 120)), fix_scale=True)
    assert bool(res.ok)
    assert float(res.s) == 1.0


def test_correct_loop_convention():
    """The composition of LoopCloser._correct_loop: with (s12,R12,t12)
    mapping CURRENT-KF camera coords into LOOP-KF camera coords,
    S_cw(kf) = S12⁻¹ ∘ T_cw(loop_kf) recovers kf's true world→cam pose."""
    rng = np.random.default_rng(3)
    xi_k = rng.uniform(-0.4, 0.4, 6).astype(np.float32)
    xi_l = rng.uniform(-0.4, 0.4, 6).astype(np.float32)
    R_k, t_k = tlie.se3_exp(T(xi_k))
    R_l, t_l = tlie.se3_exp(T(xi_l))
    Xw = T(rng.uniform(-2, 2, (50, 3)).astype(np.float32))
    pc_kf = tlie.transform(R_k, t_k, Xw)
    pc_loop = tlie.transform(R_l, t_l, Xw)
    res = tsim3.solve_sim3(pc_kf, pc_loop, torch.ones(50, dtype=torch.bool), FX, FY, CX, CY,
                           draws=T(jax_draws(jax.random.PRNGKey(0), 50)), fix_scale=True)
    assert bool(res.ok)
    si, Ri, ti = tlie.sim3_inv(res.s, res.R, res.t)
    s_c, R_c, t_c = tlie.sim3_compose(si, Ri, ti, torch.tensor(1.0), R_l, t_l)
    np.testing.assert_allclose(R_c.numpy(), R_k.numpy(), atol=1e-3)
    np.testing.assert_allclose((t_c / s_c).numpy(), t_k.numpy(), atol=1e-2)


def test_gn_refinement_improves():
    rng = np.random.default_rng(2)
    pc1, pc2, s_true, R_true, t_true = setup(rng, noise=0.02)
    res = tsim3.solve_sim3(T(pc1), T(pc2), torch.ones(120, dtype=torch.bool), FX, FY, CX, CY,
                           draws=T(jax_draws(jax.random.PRNGKey(0), 120)))
    s_o, R_o, t_o, inl = tsim3.optimize_sim3(res.s, res.R, res.t, T(pc1), T(pc2), res.inliers,
                                             FX, FY, CX, CY)
    err0 = float(torch.linalg.norm(res.t - T(t_true)))
    err1 = float(torch.linalg.norm(t_o - T(t_true)))
    assert err1 <= err0 + 1e-3
    assert abs(float(s_o) - s_true) < 0.03

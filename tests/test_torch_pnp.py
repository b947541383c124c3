"""Parity of the port's EPnP RANSAC (tracking/pnp.py) with the JAX package's
on the CPU, on the problems of tests/test_pnp.py (recover, outliers, planar,
too few), fed the JAX package's own draws.

Tolerances: per-hypothesis poses 1e-4 (R; t also 1e-3 relative: six
points, five GN steps, an eigh and a pseudo-inverse in another library's
order) — on noisy pixels where both packages' control frames agree, on
exact pixels everywhere; `ok` equal; the final
inlier masks exact; the final R and t 1e-3. A rank-deficient sample gives a
finite pose in both. With the port's own generator the assertions of
tests/test_pnp.py hold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu.geometry import lie as jlie
from gf_orb_slam2_tpu.tracking import pnp as jpnp
from gf_orb_slam2_tpu_torch.geometry import lie as tlie
from gf_orb_slam2_tpu_torch.tracking import pnp as tpnp
from gf_orb_slam2_tpu_torch.utils import linalg3

torch.set_num_threads(1)

FX = FY = 450.0
CX, CY = 320.0, 240.0
TOL_HYP = 1e-4
TOL_POSE = 1e-3


def setup(rng, n=150, outlier_frac=0.0, noise=0.5):
    """tests/test_pnp.py's problem."""
    Xw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(3, 15, n)],
                  -1).astype(np.float32)
    xi = rng.uniform(-0.5, 0.5, 6).astype(np.float32)
    R, t = jlie.se3_exp(jnp.asarray(xi))
    R, t = np.asarray(R), np.asarray(t)
    pc = Xw @ R.T + t
    keep = pc[:, 2] > 0.5
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY],
                  -1) + rng.normal(0, noise, (n, 2))
    if outlier_frac:
        k = int(outlier_frac * n)
        idx = rng.choice(n, k, replace=False)
        uv[idx] += rng.uniform(40, 150, (k, 2))
    return Xw, uv.astype(np.float32), keep, R, t


def planar(rng, n=150):
    """tests/test_pnp.py's planar scene (a wall at z = 8 m, 1 mm relief)."""
    Xw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                   np.full(n, 8.0) + rng.normal(0, 1e-3, n)], -1).astype(np.float32)
    xi = np.asarray([0.1, -0.15, 0.05, 0.2, -0.1, 0.3], np.float32)
    R, t = jlie.se3_exp(jnp.asarray(xi))
    R, t = np.asarray(R), np.asarray(t)
    pc = Xw @ R.T + t
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY],
                  -1) + rng.normal(0, 0.3, (n, 2))
    return Xw, uv.astype(np.float32), np.ones(n, bool), R, t


def problem(name):
    if name == "recover":
        return setup(np.random.default_rng(0))
    if name == "outliers":
        return setup(np.random.default_rng(1), outlier_frac=0.3)
    if name == "planar":
        return planar(np.random.default_rng(3))
    Xw, uv, valid, R, t = setup(np.random.default_rng(2), n=30)  # too few
    return Xw, uv, valid & (np.arange(30) < 8), R, t


def jax_draws(key, n_valid, n_hyp=256):
    """pnp_ransac's own draws (tracking/pnp.py:157 of the JAX package)."""
    return np.asarray(jax.random.randint(key, (n_hyp, 6), 0, max(n_valid, 6)))


def T(a):
    return torch.from_numpy(np.array(a))


PROBLEMS = ("recover", "outliers", "planar", "too_few")


def _hypotheses(Xw, uv, valid, draws):
    """Both packages' 256 EPnP poses on the same draws, and per hypothesis
    whether the JAX package's PCA frame of its sample carries the signs the
    port fixes (`tpnp.canonical_signs`)."""
    uv_n = np.stack([(uv[:, 0] - CX) / FX, (uv[:, 1] - CY) / FY], -1)
    samples = jnp.asarray(np.asarray(jnp.argsort(~jnp.asarray(valid)))[draws])
    X = jnp.asarray(Xw)[samples]                                  # [S,6,3]
    A = X - X.sum(1, keepdims=True) / 6.0
    D = np.asarray(jnp.linalg.eigh(jnp.einsum("sni,snj->sij", A, A) / 6.0)[1])
    same_frame = (tpnp.canonical_signs(torch.from_numpy(D.copy())) > 0).all(-1).all(-1).numpy()
    jR, jt = jax.vmap(lambda s: jpnp._epnp_pose(jnp.asarray(Xw)[s], jnp.asarray(uv_n)[s]))(
        samples)
    tR, tt = tpnp.epnp_hypotheses(T(Xw), T(uv), T(valid), FX, FY, CX, CY, T(draws))
    return np.asarray(jR), np.asarray(jt), tR.numpy(), tt.numpy(), same_frame


def _noise_free(name):
    """The problem with its pixels projected exactly (outliers kept out)."""
    Xw, _, valid, R, t = problem(name)
    pc = Xw @ R.T + t
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1)
    return Xw, uv.astype(np.float32), valid


def _hold_poses(tR, tt, jR, jt):
    np.testing.assert_allclose(tR, jR, atol=TOL_HYP)
    np.testing.assert_allclose(tt, jt, atol=TOL_HYP, rtol=10 * TOL_HYP)


@pytest.mark.parametrize("name", ("recover", "outliers"))
def test_per_hypothesis_poses_match(name):
    """The same draws give the same 256 EPnP hypotheses (the valid points
    first, in their order: a stable sort). On noisy pixels a hypothesis
    depends on its control points, so the sign the eigen solver gives each
    PCA axis moves it: there the poses are held on the samples of inliers
    whose JAX control frame carries the signs the port fixes. On exact
    pixels every control frame gives the same pose: all 256 are held. (The
    planar scene's and the too-few case's 6-point samples are degenerate in
    both packages — a 1 mm relief, repeated draws — and only their RANSAC
    result is held, below.)"""
    Xw, uv, valid, R, t = problem(name)
    draws = jax_draws(jax.random.PRNGKey(0), int(valid.sum()))
    jR, jt, tR, tt, same = _hypotheses(Xw, uv, valid, draws)
    assert np.isfinite(tR).all() and np.isfinite(tt).all()
    pc = Xw @ R.T + t
    err = np.hypot(FX * pc[:, 0] / pc[:, 2] + CX - uv[:, 0],
                   FY * pc[:, 1] / pc[:, 2] + CY - uv[:, 1])
    clean = (valid & (err < 5.0))[np.asarray(jnp.argsort(~jnp.asarray(valid)))[draws]].all(1)
    held = same & clean
    assert held.sum() >= 10, held.sum()
    _hold_poses(tR[held], tt[held], jR[held], jt[held])
    Xw, uv, valid = _noise_free(name)
    jR, jt, tR, tt, _ = _hypotheses(Xw, uv, valid, draws)
    _hold_poses(tR, tt, jR, jt)


@pytest.mark.parametrize("name", PROBLEMS)
def test_ransac_matches_given_jax_draws(name):
    Xw, uv, valid, _, _ = problem(name)
    key = jax.random.PRNGKey(0)
    want = jpnp.pnp_ransac(jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(valid),
                           FX, FY, CX, CY, key)
    got = tpnp.pnp_ransac(T(Xw), T(uv), T(valid), FX, FY, CX, CY,
                          draws=T(jax_draws(key, int(valid.sum()))))
    assert bool(got.ok) == bool(want.ok)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)
    if bool(want.ok):
        np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=TOL_POSE)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=TOL_POSE)


def test_rank_deficient_sample_is_finite_in_both():
    """Six copies of one point: the N=2 least squares is rank-deficient
    (L2 = 0), both packages take the minimum-norm answer and stay finite."""
    Xw, uv, _, _, _ = setup(np.random.default_rng(5), n=12)
    Xw[:6] = Xw[0]
    uv[:6] = uv[0]
    uv_n = np.stack([(uv[:, 0] - CX) / FX, (uv[:, 1] - CY) / FY], -1)
    jR, jt = jpnp._epnp_pose(jnp.asarray(Xw[:6]), jnp.asarray(uv_n[:6]))
    tR, tt = tpnp._epnp_pose(T(Xw[None, :6]), T(uv_n[None, :6].astype(np.float32)),
                             torch.ones(1, 6))
    assert np.isfinite(np.asarray(jR)).all() and np.isfinite(np.asarray(jt)).all()
    assert torch.isfinite(tR).all() and torch.isfinite(tt).all()
    L2 = torch.zeros(1, 6, 3)
    sol = tpnp._lstsq_min_norm(L2, torch.ones(1, 6))
    assert torch.equal(sol, torch.zeros(1, 3))
    np.testing.assert_allclose(np.asarray(jnp.linalg.lstsq(jnp.zeros((6, 3)), jnp.ones(6))[0]),
                               sol[0].numpy())


@pytest.mark.parametrize("bad", ("nan_pixel", "inf_point"))
def test_unused_non_finite_point_matches_jax(bad):
    """An unmatched keypoint may carry a NaN pixel or an infinite map point:
    weight 0 times that is NaN in the weighted refit (in MᵀM for the pixel,
    already in the covariance for the point). The JAX package's eigh answers
    NaN there, the refit loses and the winning hypothesis stands; torch's
    eigh raised instead (cuSOLVER: not converged). The port gives JAX's
    answer: its own winning hypothesis, with JAX's inliers."""
    Xw, uv, valid, _, _ = problem("recover")
    valid[0] = False
    if bad == "nan_pixel":
        uv[0] = np.nan
    else:
        Xw[0] = np.inf
    key = jax.random.PRNGKey(0)
    draws = T(jax_draws(key, int(valid.sum())))
    want = jpnp.pnp_ransac(jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(valid),
                           FX, FY, CX, CY, key)
    got = tpnp.pnp_ransac(T(Xw), T(uv), T(valid), FX, FY, CX, CY, draws=draws)
    assert bool(want.ok) and bool(got.ok)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)
    Rs, ts = tpnp.epnp_hypotheses(T(Xw), T(uv), T(valid), FX, FY, CX, CY, draws)
    pc = T(Xw) @ Rs.transpose(-1, -2) + ts[:, None]
    z = torch.clamp(pc[..., 2], min=1e-6)
    e2 = ((FX * pc[..., 0] / z + CX - T(uv)[:, 0]) ** 2
          + (FY * pc[..., 1] / z + CY - T(uv)[:, 1]) ** 2)
    best = torch.argmax((T(valid) & (e2 < 25.0) & (pc[..., 2] > 0)).sum(-1))
    assert torch.equal(got.R, Rs[best]) and torch.equal(got.t, ts[best])


@pytest.mark.parametrize("op", ("eigh", "svd", "pinv"))
def test_decompositions_answer_nan_for_a_non_finite_matrix(op):
    """utils/linalg3's eigh / svd / pinv: torch's own answer for a finite
    matrix, NaN for the one that is not (where torch raises), as
    jnp.linalg's."""
    rng = np.random.default_rng(4)
    A = rng.normal(size=(3, 5, 5)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1)
    A[1, 2, 3] = A[1, 3, 2] = np.inf
    A[2, 0, 0] = np.nan
    fn = {"eigh": linalg3.eigh, "svd": linalg3.svd,
          "pinv": lambda a: (linalg3.pinv(a, 1e-6),)}[op]
    ref = {"eigh": torch.linalg.eigh, "svd": torch.linalg.svd,
           "pinv": lambda a: (torch.linalg.pinv(a, rtol=1e-6),)}[op]
    with pytest.raises(torch.linalg.LinAlgError):
        ref(T(A))
    got = fn(T(A))
    for g, w in zip(got, ref(T(A[:1]))):
        assert torch.equal(g[:1], w)
        assert torch.isnan(g[1:]).all()


def test_too_few_valid_points_clamp_their_draws():
    """Fewer valid points than the sample size: draws past the valid ones
    index invalid points (clamped, never out of range) and `ok` is False."""
    Xw, uv, valid, _, _ = setup(np.random.default_rng(2), n=5)
    valid[:] = False
    valid[:3] = True
    draws = torch.full((256, 6), 40, dtype=torch.int64)  # past the end
    res = tpnp.pnp_ransac(T(Xw), T(uv), T(valid), FX, FY, CX, CY, draws=draws)
    assert not bool(res.ok)


# ------------------------------ tests/test_pnp.py with the port's generator
def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _dR(R_est, R):
    return float(torch.linalg.norm(tlie.so3_log(R_est @ torch.from_numpy(R.T.copy()))))


def test_own_generator_recovers_pose():
    Xw, uv, valid, R, t = problem("recover")
    res = tpnp.pnp_ransac(T(Xw), T(uv), T(valid), FX, FY, CX, CY, generator=_gen())
    assert bool(res.ok)
    assert float(np.linalg.norm(res.t.numpy() - t)) < 0.05
    assert _dR(res.R, R) < 0.02


def test_own_generator_robust_to_outliers():
    Xw, uv, valid, R, t = problem("outliers")
    res = tpnp.pnp_ransac(T(Xw), T(uv), T(valid), FX, FY, CX, CY, generator=_gen())
    assert bool(res.ok)
    assert float(np.linalg.norm(res.t.numpy() - t)) < 0.1


def test_own_generator_planar_scene():
    Xw, uv, valid, R, t = problem("planar")
    res = tpnp.pnp_ransac(T(Xw), T(uv), T(valid), FX, FY, CX, CY, generator=_gen())
    assert bool(res.ok)
    assert float(np.linalg.norm(res.t.numpy() - t)) < 0.1
    assert _dR(res.R, R) < 0.05


def test_own_generator_too_few_matches():
    Xw, uv, valid, _, _ = problem("too_few")
    res = tpnp.pnp_ransac(T(Xw), T(uv), T(valid), FX, FY, CX, CY, generator=_gen())
    assert not bool(res.ok)


def test_device_draws_stay_in_range():
    """The generator's draws for a tensor count: in [0, max(n, 6)), nothing
    read back."""
    g = _gen(3)
    for n in (0, 5, 6, 7, 1000):
        d = tpnp.draw_hypotheses(torch.tensor(n), g)
        assert d.shape == (256, 6) and d.dtype == torch.int64
        assert int(d.min()) >= 0 and int(d.max()) < max(n, 6)

"""Parity of the port's two-view initializer (tracking/initializer.py) with
the JAX package's on the CPU, on the problems of tests/test_initializer.py
(general scene → F, planar scene → H, too few matches, pure rotation), fed
the JAX package's own draws.

Tolerances: per-hypothesis H and the refit H and F up to scale and sign
1e-3 (an eigh of a 9x9 normal matrix in another library's order); `used_h` and `ok` equal; R
1e-3 and the unit t 1e-3; `is_inlier` exact on the well-conditioned
(accepted) cases; the triangulated inlier points rtol 1e-3. With the port's
own generator the assertions of tests/test_initializer.py hold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu.geometry import lie as jlie
from gf_orb_slam2_tpu.tracking import initializer as jinit
from gf_orb_slam2_tpu_torch.geometry import lie as tlie
from gf_orb_slam2_tpu_torch.tracking import initializer as tinit

torch.set_num_threads(1)

K = np.asarray([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]], np.float32)
TOL_MODEL = 1e-3
TOL_POSE = 1e-3


def project(pts, R, t):
    pc = pts @ np.asarray(R).T + np.asarray(t)
    return np.stack([450 * pc[:, 0] / pc[:, 2] + 320, 450 * pc[:, 1] / pc[:, 2] + 240],
                    -1), pc[:, 2]


def setup(rng, planar, n=200, noise=0.4):
    """tests/test_initializer.py's problem."""
    if planar:
        pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                        np.full(n, 6.0) + 0.25 * rng.uniform(-3, 3, n) * 0], -1).astype(np.float32)
    else:
        pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)],
                       -1).astype(np.float32)
    xi = np.array([0.4, 0.05, 0.02, 0.02, -0.06, 0.01], np.float32)
    R, t = jlie.se3_exp(jnp.asarray(xi))
    uv1, z1 = project(pts, np.eye(3), np.zeros(3))
    uv2, z2 = project(pts, np.asarray(R), np.asarray(t))
    ok = ((z1 > 0.5) & (z2 > 0.5) & (np.abs(uv1[:, 0] - 320) < 320)
          & (np.abs(uv2[:, 0] - 320) < 320))
    uv1 += rng.normal(0, noise, uv1.shape)
    uv2 += rng.normal(0, noise, uv2.shape)
    return uv1.astype(np.float32), uv2.astype(np.float32), ok, np.asarray(R), np.asarray(t), pts


def problem(name):
    if name == "general":
        return setup(np.random.default_rng(0), planar=False)[:5]
    if name == "planar":
        return setup(np.random.default_rng(1), planar=True)[:5]
    if name == "too_few":
        uv1, uv2, ok, R, t, _ = setup(np.random.default_rng(2), planar=False, n=60)
        return uv1, uv2, ok & (np.arange(60) < 20), R, t
    rng = np.random.default_rng(3)  # pure rotation
    pts = np.stack([rng.uniform(-3, 3, 200), rng.uniform(-2, 2, 200), rng.uniform(4, 12, 200)],
                   -1).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.05, 0.0])))
    uv1, _ = project(pts, np.eye(3), np.zeros(3))
    uv2, _ = project(pts, R, np.zeros(3))
    uv1 += rng.normal(0, 0.3, uv1.shape)
    uv2 += rng.normal(0, 0.3, uv2.shape)
    return uv1.astype(np.float32), uv2.astype(np.float32), np.ones(200, bool), R, np.zeros(3)


PROBLEMS = ("general", "planar", "too_few", "rotation")


def jax_draws(key, n_valid, n_hyp=256):
    """initialize's own draws (tracking/initializer.py:235 of the JAX package)."""
    return np.asarray(jax.random.randint(key, (n_hyp, 8), 0, max(n_valid, 8)))


def T(a):
    return torch.from_numpy(np.array(a))


def canon(M):
    """Models up to scale and sign: unit Frobenius norm, largest-magnitude
    entry positive."""
    M = M / np.linalg.norm(M, axis=(-2, -1), keepdims=True)
    flat = M.reshape(M.shape[0], -1)
    s = np.sign(flat[np.arange(flat.shape[0]), np.abs(flat).argmax(1)])
    return M * s[:, None, None]


@pytest.mark.parametrize("name", PROBLEMS)
def test_per_hypothesis_models_match(name):
    """The same draws give the same 256 homographies (up to scale and sign,
    in the normalized coordinates both packages solve in), and the same
    weights give the same refit homography and fundamental matrix.
    The 256 eight-point fundamental matrices are not compared one by one:
    eight equations in nine unknowns leave AᵀA a second-smallest eigenvalue
    below 1e-4 of its largest on every sample of these problems, so in f32
    each hypothesis is the solver's rounding in both packages; the refit
    over all matches is well-conditioned where the scene determines F (not on
the plane, not under a pure rotation)."""
    uv1, uv2, valid, _, _ = problem(name)
    draws = jax_draws(jax.random.PRNGKey(0), int(valid.sum()))
    j1, jT1 = jinit._normalize(jnp.asarray(uv1), jnp.asarray(valid))
    j2, jT2 = jinit._normalize(jnp.asarray(uv2), jnp.asarray(valid))
    samples = jnp.asarray(np.asarray(jnp.argsort(~jnp.asarray(valid)))[draws])
    jH = jax.vmap(jinit._dlt_homography)(j1[samples], j2[samples])
    t1, tT1 = tinit._normalize(T(uv1), T(valid))
    t2, tT2 = tinit._normalize(T(uv2), T(valid))
    np.testing.assert_allclose(tT1.numpy(), np.asarray(jT1), rtol=1e-6)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=1e-5, atol=1e-6)
    s = tinit.valid_first(T(valid))[T(draws)]
    tH = tinit._dlt_homography(t1[s], t2[s])
    np.testing.assert_allclose(canon(tH.numpy()), canon(np.asarray(jH)), atol=TOL_MODEL)
    # the refits over weighted matches: every valid match at weight 1
    w = valid.astype(np.float32)
    fits = [(jinit._dlt_homography, tinit._dlt_homography)]
    if name in ("general", "too_few"):  # a plane or a pure rotation leaves F undetermined
        fits.append((jinit._dlt_fundamental, tinit._dlt_fundamental))
    for jfit, tfit in fits:
        want = np.asarray(jfit(j1, j2, jnp.asarray(w)))[None]
        got = tfit(t1, t2, T(w)).numpy()[None]
        np.testing.assert_allclose(canon(got), canon(want), atol=TOL_MODEL)


@pytest.mark.parametrize("name", PROBLEMS)
def test_initialize_matches_given_jax_draws(name):
    uv1, uv2, valid, _, _ = problem(name)
    key = jax.random.PRNGKey(0)
    want = jinit.initialize(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid),
                            jnp.asarray(K), key)
    got = tinit.initialize(T(uv1), T(uv2), T(valid), T(K),
                           draws=T(jax_draws(key, int(valid.sum()))))
    assert bool(got.used_h) == bool(want.used_h)
    assert bool(got.ok) == bool(want.ok)
    if not bool(want.ok):
        return
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=TOL_POSE)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=TOL_POSE)
    inl = np.asarray(want.is_inlier)
    np.testing.assert_array_equal(got.is_inlier.numpy(), inl)
    np.testing.assert_allclose(got.points.numpy()[inl], np.asarray(want.points)[inl],
                               rtol=1e-3, atol=1e-4)


# --------------------- tests/test_initializer.py with the port's generator
def _run(name, seed=0):
    uv1, uv2, valid, R, t = problem(name)
    g = torch.Generator()
    g.manual_seed(seed)
    return tinit.initialize(T(uv1), T(uv2), T(valid), T(K), generator=g), R, t


def _check_pose(res, R_true, t_true):
    assert bool(res.ok)
    R_est, t_est = res.R.numpy(), res.t.numpy()
    cos = abs(np.dot(t_est, t_true) / (np.linalg.norm(t_est) * np.linalg.norm(t_true)))
    assert cos > 0.995, cos
    dR = float(torch.linalg.norm(tlie.so3_log(torch.from_numpy(R_est @ R_true.T))))
    assert dR < 0.02, dR


def test_own_generator_general_scene_uses_f():
    res, R, t = _run("general")
    assert not bool(res.used_h)
    _check_pose(res, R, t)
    assert int(res.is_inlier.sum()) > 100


def test_own_generator_planar_scene_uses_h():
    res, R, t = _run("planar")
    assert bool(res.used_h)
    _check_pose(res, R, t)


def test_own_generator_insufficient_matches_rejected():
    res, _, _ = _run("too_few")
    assert not bool(res.ok)


def test_own_generator_pure_rotation_rejected():
    res, _, _ = _run("rotation")
    assert not bool(res.ok)


def test_decompose_h_candidate_set_is_sign_invariant():
    """H and -H give the same 8 candidates, in some order: the eigen
    solver's sign choice cannot change the vote's winner."""
    uv1, uv2, valid, _, _ = problem("planar")
    t1, tT1 = tinit._normalize(T(uv1), T(valid))
    t2, tT2 = tinit._normalize(T(uv2), T(valid))
    H = torch.linalg.inv(tT2) @ tinit._dlt_homography(t1, t2, T(valid).float()) @ tT1
    Ra, ta = tinit._decompose_H(H, T(K))
    Rb, tb = tinit._decompose_H(-H, T(K))
    a = torch.cat([Ra.flatten(1), ta], 1)
    b = torch.cat([Rb.flatten(1), tb], 1)
    d = torch.cdist(a, b)
    assert float(d.min(1).values.max()) < 1e-4 and float(d.min(0).values.max()) < 1e-4

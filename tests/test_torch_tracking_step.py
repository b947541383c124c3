"""Parity of the port's tracking-step modules with the JAX package on the
CPU: Lie/camera math, projection, observability, good-feature selection,
pose optimization, matching, and the fused tracking step on one map snapshot
carried over through convert.py. Same numpy inputs to both; each tolerance
is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu import config as jconfig
from gf_orb_slam2_tpu.geometry import camera as jcam, lie as jlie
from gf_orb_slam2_tpu.matching import matcher as jmatcher
from gf_orb_slam2_tpu.optim import pose_opt as jpose
from gf_orb_slam2_tpu.selection import good_feature as jgf, observability as jobs
from gf_orb_slam2_tpu.system import System as JSystem
from gf_orb_slam2_tpu.tracking import projection as jproj
from gf_orb_slam2_tpu_torch import convert
from gf_orb_slam2_tpu_torch.geometry import camera as tcam, lie as tlie
from gf_orb_slam2_tpu_torch.matching import matcher as tmatcher
from gf_orb_slam2_tpu_torch.optim import pose_opt as tpose
from gf_orb_slam2_tpu_torch.selection import good_feature as tgf, observability as tobs
from gf_orb_slam2_tpu_torch.tracking import projection as tproj
from gf_orb_slam2_tpu_torch.tracking import tracker as ttracker
from tests.rendered_world import RoomWorld, trajectory_tour

torch.set_num_threads(1)

FX, FY, CX, CY, BF = 450.0, 450.0, 320.0, 240.0, 45.0


def T(a):
    a = np.array(a)  # own, writable copy (JAX hands out read-only views)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def J(a):
    return jnp.asarray(a)


def _rand_pose(rng, rot=0.2, trans=0.5):
    w = rng.normal(0, rot, 3).astype(np.float32)
    R = np.asarray(jlie.so3_exp(J(w)))
    t = rng.normal(0, trans, 3).astype(np.float32)
    return R, t


# ------------------------------------------------------------ Lie / camera
@pytest.mark.parametrize("fn,shape", [
    ("quat_to_rot", (5, 4)), ("so3_exp", (5, 3)), ("hat", (5, 3)),
    ("quat_normalize", (5, 4)), ("quat_conj", (5, 4)),
])
def test_lie_unary_parity(fn, shape):
    """f32 elementwise formulas: 1e-6 absolute."""
    x = np.random.default_rng(0).normal(0, 1, shape).astype(np.float32)
    want = np.asarray(getattr(jlie, fn)(J(x)))
    got = getattr(tlie, fn)(T(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_lie_rotation_roundtrip_and_quat():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 1.0, (20, 3)).astype(np.float32)
    w[0] = 1e-5  # small-angle branch
    R = np.asarray(jlie.so3_exp(J(w)))
    np.testing.assert_allclose(tlie.rot_to_quat(T(R)).numpy(),
                               np.asarray(jlie.rot_to_quat(J(R))), atol=1e-6)
    np.testing.assert_allclose(tlie.so3_log(T(R)).numpy(),
                               np.asarray(jlie.so3_log(J(R))), atol=1e-5)
    q1 = rng.normal(0, 1, (6, 4)).astype(np.float32)
    q2 = rng.normal(0, 1, (6, 4)).astype(np.float32)
    np.testing.assert_allclose(tlie.quat_mul(T(q1), T(q2)).numpy(),
                               np.asarray(jlie.quat_mul(J(q1), J(q2))), atol=1e-6)


def test_se3_parity():
    rng = np.random.default_rng(2)
    xi = rng.normal(0, 0.3, (8, 6)).astype(np.float32)
    xi[0] *= 1e-4
    wR, wt = (np.asarray(a) for a in jlie.se3_exp(J(xi)))
    gR, gt = tlie.se3_exp(T(xi))
    np.testing.assert_allclose(gR.numpy(), wR, atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), wt, atol=1e-6)
    cR, ct = tlie.se3_compose(gR[:4], gt[:4], gR[4:], gt[4:])
    wcR, wct = jlie.se3_compose(J(wR[:4]), J(wt[:4]), J(wR[4:]), J(wt[4:]))
    np.testing.assert_allclose(cR.numpy(), np.asarray(wcR), atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(wct), atol=1e-6)
    iR, it = tlie.se3_inv(gR, gt)
    wiR, wit = jlie.se3_inv(J(wR), J(wt))
    np.testing.assert_allclose(it.numpy(), np.asarray(wit), atol=1e-6)
    pts = rng.normal(0, 2, (8, 3)).astype(np.float32)
    np.testing.assert_allclose(tlie.transform(gR, gt, T(pts)).numpy(),
                               np.asarray(jlie.transform(J(wR), J(wt), J(pts))), atol=1e-5)
    np.testing.assert_allclose(tlie.se3_log(gR, gt).numpy(),
                               np.asarray(jlie.se3_log(J(wR), J(wt))), atol=1e-5)


def test_camera_undistort_and_rectify_parity():
    """Pixel coordinates to 1e-3 px (8 fixed-point iterations in f32)."""
    rng = np.random.default_rng(3)
    ccfg = jconfig.CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY,
                                dist=(-0.28, 0.07, 1e-4, -2e-4, 0.0))
    uv = (rng.random((50, 2)) * [640, 480]).astype(np.float32)
    want = np.asarray(jcam.undistort_keypoints(jcam.PinholeCamera.from_config(ccfg), J(uv)))
    got = tcam.undistort_keypoints(
        tcam.PinholeCamera.from_config(convert.config_from_reference(ccfg), "cpu"), T(uv))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    Rr, _ = _rand_pose(rng, 0.02)
    P = np.array([[440, 0, 330, 0], [0, 440, 235, 0], [0, 0, 1, 0]], np.float32)
    D = [-0.28, 0.07, 1e-4, -2e-4]
    want = np.asarray(jcam.rectify_keypoints(jcam.RectifyMap.from_np(K, D, Rr, P), J(uv)))
    got = tcam.rectify_keypoints(tcam.RectifyMap.from_np(K, D, Rr, P, device="cpu"), T(uv))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


# ----------------------------------------------------- projection / observ.
def _scene(rng, n=300):
    """Points in front of a camera near the origin; each normal is the mean
    viewing direction (camera → point), as the map stores it."""
    pos = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(2, 9, n)], -1).astype(np.float32)
    normal = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    normal = (normal + rng.normal(0, 0.2, (n, 3))).astype(np.float32)
    dist = np.linalg.norm(pos, axis=-1)
    mind = (dist * rng.uniform(0.3, 0.9, n)).astype(np.float32)
    maxd = (dist * rng.uniform(1.1, 3.0, n)).astype(np.float32)
    valid = rng.random(n) < 0.9
    return pos, normal, mind, maxd, valid


def test_project_points_parity():
    """uv to 1e-3 px, depth/view-cos to 1e-5; masks and levels exact."""
    rng = np.random.default_rng(4)
    pos, normal, mind, maxd, valid = _scene(rng)
    R, t = _rand_pose(rng, 0.1, 0.3)
    kw = dict(n_levels=8, log_scale=float(np.log(1.2)))
    want = jproj.project_points(J(R), J(t), J(pos), J(normal), J(mind), J(maxd), J(valid),
                                FX, FY, CX, CY, 640, 480, **kw)
    got = tproj.project_points(T(R), T(t), T(pos), T(normal), T(mind), T(maxd), T(valid),
                               FX, FY, CX, CY, 640, 480, **kw)
    np.testing.assert_allclose(got.uv.numpy(), np.asarray(want.uv), atol=1e-3)
    np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z), atol=1e-5)
    np.testing.assert_allclose(got.view_cos.numpy(), np.asarray(want.view_cos), atol=1e-5)
    np.testing.assert_array_equal(got.visible.numpy(), np.asarray(want.visible))
    np.testing.assert_array_equal(got.pred_octave.numpy(), np.asarray(want.pred_octave))
    assert 50 < got.visible.sum() < 300


def _info_inputs(rng, n=300):
    pos, _, _, _, valid = _scene(rng, n)
    R, t = _rand_pose(rng, 0.1, 0.3)
    q = np.asarray(jlie.rot_to_quat(J(R.T)))
    p = (-R.T @ t).astype(np.float32)
    stereo = rng.random(n) < 0.7
    inv2 = (1.0 / 1.2 ** (2 * rng.integers(0, 8, n))).astype(np.float32)
    return q, p, pos, stereo, inv2, valid


def test_info_matrices_parity():
    """Entries span ~1e2..1e6: rtol 1e-4 against the matrix scale."""
    q, p, pos, stereo, inv2, valid = _info_inputs(np.random.default_rng(5))
    want = np.asarray(jobs.info_matrices(J(q), J(p), J(pos), FX, FY, BF, J(stereo), J(inv2), J(valid)))
    got = tobs.info_matrices(T(q), T(p), T(pos), FX, FY, BF, T(stereo), T(inv2), T(valid)).numpy()
    scale = np.abs(want).max((1, 2), keepdims=True) + 1e-6
    assert (np.abs(got - want) / scale).max() < 1e-4
    assert not got[~valid].any()
    wsum = np.asarray(jobs.pose_info_from_frame(J(q), J(p), J(pos), FX, FY, BF, J(stereo), J(inv2), J(valid)))
    gsum = tobs.pose_info_from_frame(T(q), T(p), T(pos), FX, FY, BF, T(stereo), T(inv2), T(valid)).numpy()
    assert np.abs(gsum - wsum).max() / np.abs(wsum).max() < 1e-4


def test_logdet_psd_parity():
    """rtol 1e-4 on log-determinants of order 10..100."""
    q, p, pos, stereo, inv2, valid = _info_inputs(np.random.default_rng(6))
    M = np.asarray(jobs.info_matrices(J(q), J(p), J(pos), FX, FY, BF, J(stereo), J(inv2), J(valid)))
    M = M + M[valid].sum(0) * 0.01 + 1e-3 * np.eye(7, dtype=np.float32)
    want = np.asarray(jobs.logdet_psd(J(M)))
    got = tobs.logdet_psd(T(M)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tobs._chol_logdet_unrolled(T(M[:5] / 1e3)).numpy(),
                               np.asarray(jobs._chol_logdet_unrolled(J(M[:5] / 1e3))),
                               rtol=1e-4, atol=1e-3)


# -------------------------------------------------------------- selection
def _selection_inputs(seed, n=400):
    q, p, pos, stereo, inv2, valid = _info_inputs(np.random.default_rng(seed), n)
    M = np.asarray(jobs.info_matrices(J(q), J(p), J(pos), FX, FY, BF, J(stereo), J(inv2), J(valid)))
    base = M[:20].sum(0)
    return M, valid, base


def _well_conditioned(seed, n=300, d=7):
    """Random PSD matrices with condition numbers of order 10: the logdet
    scores carry f32 noise of ~1e-6 against gaps of ~1e-2, so both packages
    must take the very same picks."""
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 1, (n, d, d)).astype(np.float32)
    M = (A @ A.transpose(0, 2, 1) / d + np.eye(d, dtype=np.float32)).astype(np.float32)
    M *= rng.uniform(0.5, 2.0, (n, 1, 1)).astype(np.float32)
    valid = rng.random(n) < 0.85
    return M, valid, M[:5].sum(0)


def test_greedy_exact_identical_selection():
    """lazier_factor=1: no randomness — on well-conditioned matrices the
    selected set and its order are identical."""
    M, valid, base = _well_conditioned(7)
    wsel, word = jgf.lazier_greedy_select(J(M), J(valid), 40, jax.random.PRNGKey(0),
                                          lazier_factor=1, base_mat=J(base))
    gsel, gord = tgf.lazier_greedy_select(T(M), T(valid), 40, None,
                                          lazier_factor=1, base_mat=T(base))
    np.testing.assert_array_equal(gsel.numpy(), np.asarray(wsel))
    np.testing.assert_array_equal(gord.numpy(), np.asarray(word))
    assert gsel.sum() == 40
    gsel2, _ = tgf.greedy_select_exact(T(M), T(valid), 40, base_mat=T(base))
    assert torch.equal(gsel, gsel2)


def test_greedy_budget_larger_than_pool_and_partial_last_round():
    """37 picks = 4 full rounds + 5 slots; 30 picks from 12 candidates fills
    what exists and pads the order with -1 — same as the reference."""
    M, valid, base = _well_conditioned(17, n=60)
    for n_sel, v in ((37, valid), (30, np.arange(60) < 12)):
        wsel, word = jgf.lazier_greedy_select(J(M), J(v), n_sel, jax.random.PRNGKey(0),
                                              lazier_factor=1, base_mat=J(base))
        gsel, gord = tgf.lazier_greedy_select(T(M), T(v), n_sel, None,
                                              lazier_factor=1, base_mat=T(base))
        np.testing.assert_array_equal(gord.numpy(), np.asarray(word))
        np.testing.assert_array_equal(gsel.numpy(), np.asarray(wsel))
        assert gsel.sum() == min(n_sel, v.sum())


def test_greedy_exact_on_info_matrices_objective():
    """Real information matrices are ill-conditioned: the f32 logdet scores
    of the two packages differ by ~5e-3 (measured; XLA's own jit and eager
    forms differ as much) while neighbouring candidates lie ~5e-3..5e-1
    apart, so single picks can swap. Compared by what selection is for:
    ≥ 90 % common picks and the selection's logdet within 0.1 %."""
    M, valid, base = _selection_inputs(7)
    wsel, _ = jgf.lazier_greedy_select(J(M), J(valid), 40, jax.random.PRNGKey(0),
                                       lazier_factor=1, base_mat=J(base))
    gsel, _ = tgf.lazier_greedy_select(T(M), T(valid), 40, None,
                                       lazier_factor=1, base_mat=T(base))
    wsel = np.asarray(wsel)
    assert gsel.sum() == 40 and (gsel.numpy() & wsel).sum() >= 36
    want = float(jgf.selection_logdet(J(M), J(wsel), J(base)))
    got = float(tgf.selection_logdet(T(M), gsel, T(base)))
    assert abs(got - want) / abs(want) < 1e-3


def test_lazier_greedy_logdet_gap():
    """lazier_factor=10 draws from different generators (threefry vs torch):
    compared by the objective — logdet of the selection within 2 %."""
    M, valid, base = _selection_inputs(8)
    wsel, _ = jgf.lazier_greedy_select(J(M), J(valid), 40, jax.random.PRNGKey(3),
                                       lazier_factor=10, base_mat=J(base))
    gen = torch.Generator().manual_seed(3)
    gsel, gord = tgf.lazier_greedy_select(T(M), T(valid), 40, gen,
                                          lazier_factor=10, base_mat=T(base))
    assert gsel.sum() == 40 and not gsel[~T(valid)].any()
    assert len(set(gord.tolist())) == 40
    want = float(jgf.selection_logdet(J(M), wsel, J(base)))
    got = float(tgf.selection_logdet(T(M), gsel, T(base)))
    assert abs(got - want) / abs(want) < 0.02
    # and better than a random subset of the same size
    rsel, _ = tgf.random_select(T(valid), 40, torch.Generator().manual_seed(0))
    assert got > float(tgf.selection_logdet(T(M), rsel, T(base)))


def test_lazier_greedy_same_uniforms_same_set():
    """Fed the SAME uniform numbers (well-conditioned matrices) the two agree
    pick for pick, sampling mask included."""
    M, valid, base = _well_conditioned(9, n=200)
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, 3)  # 24 picks / batch 8 = 3 rounds
    u = np.stack([np.asarray(jax.random.uniform(k, (200,))) for k in keys])
    wsel, word = jgf.lazier_greedy_select(J(M), J(valid), 24, key, lazier_factor=4, base_mat=J(base))
    gsel, gord = tgf.lazier_greedy_select(T(M), T(valid), 24, None, lazier_factor=4,
                                          base_mat=T(base), uniforms=T(u))
    np.testing.assert_array_equal(gord.numpy(), np.asarray(word))
    np.testing.assert_array_equal(gsel.numpy(), np.asarray(wsel))


def test_baseline_selectors_parity():
    rng = np.random.default_rng(10)
    n = 300
    valid = rng.random(n) < 0.8
    life = rng.integers(1, 12, n).astype(np.int32)  # many ties
    uv = (rng.random((n, 2)) * [640, 480]).astype(np.float32)
    wm, wi = jgf.long_lived_select(J(life), J(valid), 50)
    gm, gi = tgf.long_lived_select(T(life), T(valid), 50)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    wm, wi = jgf.bucketing_select(J(uv), J(life), J(valid), 50, 640.0, 480.0)
    gm, gi = tgf.bucketing_select(T(uv), T(life), T(valid), 50, 640.0, 480.0)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    rm, ri = tgf.random_select(T(valid), 50, torch.Generator().manual_seed(1))
    assert rm.sum() == 50 and not rm[~T(valid)].any()


# -------------------------------------------------------- pose optimization
def _pnp_problem(rng, n=200, outliers=30, noise=0.5):
    pos, *_ = _scene(rng, n)
    R, t = _rand_pose(rng, 0.05, 0.2)
    pc = pos @ R.T + t
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1)
    uv = (uv + rng.normal(0, noise, uv.shape)).astype(np.float32)
    ur = (uv[:, 0] - BF / pc[:, 2] + rng.normal(0, noise, n)).astype(np.float32)
    ur[rng.random(n) < 0.3] = -1.0  # monocular observations
    uv[:outliers] += rng.normal(0, 30, (outliers, 2)).astype(np.float32)
    inv2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.random(n) < 0.9
    dR, dt = _rand_pose(rng, 0.03, 0.1)
    R0, t0 = (dR @ R).astype(np.float32), (dR @ t + dt).astype(np.float32)
    return (R0, t0, pos, uv, ur, inv2, valid), (R, t)


def test_pose_optimization_parity():
    """Pose to 1e-4 (rotation entries, metres), identical inlier mask."""
    args, (R_true, t_true) = _pnp_problem(np.random.default_rng(11))
    want = jpose.pose_optimization(*(J(a) for a in args), FX, FY, CX, CY, BF, rounds=3, iters=8)
    got = tpose.pose_optimization(*(T(a) for a in args), FX, FY, CX, CY, BF, rounds=3, iters=8)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) > 100
    assert np.abs(got.t.numpy() - t_true).max() < 0.02


def test_pose_optimization_no_valid_points_keeps_pose():
    """An empty or degenerate problem must neither raise nor move the pose."""
    args, _ = _pnp_problem(np.random.default_rng(12), n=50)
    R0, t0, pos, uv, ur, inv2, _ = args
    none = np.zeros(50, bool)
    got = tpose.pose_optimization(T(R0), T(t0), T(pos), T(uv), T(ur), T(inv2), T(none),
                                  FX, FY, CX, CY, BF, rounds=2, iters=4)
    np.testing.assert_array_equal(got.R.numpy(), R0)
    np.testing.assert_array_equal(got.t.numpy(), t0)
    assert int(got.n_inliers) == 0 and torch.isfinite(got.chi2).all()
    # all points behind the camera: every depth gate closes, no NaN escapes
    got = tpose.pose_optimization(T(R0), T(t0), T(-pos), T(uv), T(ur), T(inv2),
                                  T(~none), FX, FY, CX, CY, BF, rounds=2, iters=4)
    assert torch.isfinite(got.R).all() and torch.isfinite(got.t).all()
    assert int(got.n_inliers) == 0


# ------------------------------------------------------------------ matcher
def _match_inputs(rng, p=150, n=120):
    kp_desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    src = rng.integers(0, n, p)
    pt_desc = kp_desc[src].copy()
    flip = rng.integers(0, 2**32, (p, 8), dtype=np.uint32) & rng.integers(
        0, 2**32, (p, 8), dtype=np.uint32) & rng.integers(0, 2**32, (p, 8), dtype=np.uint32)
    pt_desc ^= flip  # ~32 bits flipped
    kp_uv = (rng.random((n, 2)) * [640, 480]).astype(np.float32)
    pred_uv = (kp_uv[src] + rng.normal(0, 2.0, (p, 2))).astype(np.float32)
    kp_oct = rng.integers(0, 8, n).astype(np.int32)
    pred_oct = np.clip(kp_oct[src] + rng.integers(-1, 2, p), 0, 7).astype(np.int32)
    return (pred_uv, pred_oct, rng.random(p) < 0.9, pt_desc,
            kp_uv, kp_oct, rng.random(n) < 0.9, kp_desc)


def test_search_by_projection_parity():
    rng = np.random.default_rng(13)
    args = _match_inputs(rng)
    scales = (1.2 ** np.arange(8)).astype(np.float32)
    radius = rng.choice([2.5, 4.0], 150).astype(np.float32)
    want = jmatcher.search_by_projection(*(J(a) for a in args), radius=J(radius),
                                         level_scales=J(scales), nn_ratio=0.8)
    got = tmatcher.search_by_projection(*(T(a) for a in args), radius=T(radius),
                                        level_scales=T(scales), nn_ratio=0.8)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 30
    mapped = ttracker._scatter_matches(got.idx, got.valid, torch.arange(150), 120).numpy()
    assert (mapped >= 0).sum() == got.valid.sum()  # one-to-one, nothing wrapped


@pytest.mark.parametrize("mutual", [False, True])
def test_match_all_and_rotation_consistency_parity(mutual):
    rng = np.random.default_rng(14)
    _, _, va, da, _, _, vb, db = _match_inputs(rng)
    want = jmatcher.match_all(J(da), J(va), J(db), J(vb), th=100, nn_ratio=0.9, mutual=mutual)
    got = tmatcher.match_all(T(da), T(va), T(db), T(vb), th=100, nn_ratio=0.9, mutual=mutual)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    ang_a = rng.uniform(-np.pi, np.pi, 150).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, 120).astype(np.float32)
    idx = np.asarray(want.idx)
    ok = np.asarray(want.valid)
    ang_a[ok] = ang_b[idx[ok]] + 0.3  # a dominant rotation …
    off = np.nonzero(ok)[0][::3]
    ang_a[off] = rng.uniform(-np.pi, np.pi, off.size)  # … and a scattered minority
    wr = jmatcher.rotation_consistency(J(ang_a), J(ang_b), want)
    gr = tmatcher.rotation_consistency(T(ang_a), T(ang_b), got)
    np.testing.assert_array_equal(gr.valid.numpy(), np.asarray(wr.valid))
    np.testing.assert_array_equal(gr.idx.numpy(), np.asarray(wr.idx))
    assert 0 < gr.valid.sum() < got.valid.sum()


def test_match_window_parity():
    rng = np.random.default_rng(15)
    pred_uv, _, va, da, kp_uv, _, vb, db = _match_inputs(rng)
    want = jmatcher.match_window(J(pred_uv), J(da), J(va), J(kp_uv), J(db), J(vb), window=50.0, th=100)
    got = tmatcher.match_window(T(pred_uv), T(da), T(va), T(kp_uv), T(db), T(vb), window=50.0, th=100)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))


# ------------------------------------------- fused step on a carried-over map
H, W = 240, 320


@pytest.fixture(scope="module")
def carried():
    """The JAX System tracks three small rendered frames (mapping replaced by
    a no-op on the instance). The budgeted matching runs in LONG_LIVED mode,
    whose integer scores make the whole step comparable exactly (Max-logDet
    picks can swap at f32 near-ties, see the selection tests; that branch of
    the local step has its own test below). The map, the last frame and the
    fourth frame's frontend output are carried into the port through
    convert.py."""
    cam = jconfig.CameraConfig(width=W, height=H, fx=225.0, fy=225.0, cx=160.0,
                               cy=120.0, bf=22.5, th_depth=40.0)
    jcfg = jconfig.SystemConfig(
        sensor=jconfig.Sensor.STEREO, camera=cam,
        orb=jconfig.ORBConfig(n_features=600),
        capacity=jconfig.CapacityConfig(max_keypoints=640, max_map_points=6000,
                                        max_keyframes=30, max_local_points=1024),
        good_feature=jconfig.GoodFeatureConfig(
            matching_mode=jconfig.GFMatchingMode.LONG_LIVED, min_pool=100),
        loop=jconfig.LoopClosingConfig(enabled=False), vocabulary_path="")
    world = RoomWorld(width=9.0, height=5.5, length=13.0)
    poses = trajectory_tour(300)[:4]
    imgs = []
    for R, t in poses:
        left, right = world.render_stereo(R, t, baseline=0.1, fx=225.0, fy=225.0,
                                          cx=160.0, cy=120.0, w=W, h=H)
        imgs.append(np.stack([np.clip(left, 0, 255), np.clip(right, 0, 255)]).astype(np.uint8))
    js = JSystem(jcfg)
    js.mapper.process_keyframe = lambda *a, **k: None
    for i in range(3):
        js.track_stereo(imgs[i][0], imgs[i][1], i / 20.0)
    assert js.tracker.state.name == "OK"
    tr = js.tracker
    packed, (ids, pool_ids) = tr.prepare_fused_host_inputs(3 / 20.0, 3)
    inputs = tr._up_layout.unpack_np(packed)
    front = [np.asarray(a) for a in js._get_frontend("stereo")(jnp.asarray(imgs[3]))]
    # the pipelined path's state after the third frame: the bootstrapped
    # chain, the fourth frame's upload, and the map mirrored from the store
    # (the JAX mirror's CPU full-refresh path), taken before a later test
    # moves the JAX system on
    from gf_orb_slam2_tpu.slammap.device_mirror import DeviceMapMirror

    up_packed, _ = tr.stream_prepare_upload(3)
    stream = dict(chain={k: np.asarray(v) for k, v in tr.stream_bootstrap_chain().items()},
                  upload=tr._stream_up_layout.unpack_np(up_packed), up_packed=up_packed,
                  mirror=DeviceMapMirror(js.store).arrays, store=convert.store_arrays(js.store))
    yield dict(js=js, jcfg=jcfg, inputs=inputs, front=front, imgs=imgs, pool_ids=pool_ids,
               stream=stream)
    js.shutdown()


def _port_tracker(carried):
    js = carried["js"]
    tcfg = convert.config_from_reference(carried["jcfg"])
    store = convert.store_from_arrays(tcfg.capacity, 640, convert.store_arrays(js.store))
    scales = np.asarray(js.extractor.scales, np.float32)
    tr = ttracker.Tracker(tcfg, store, 640, scales, device="cpu")
    lf = js.tracker.last_frame
    tr.last_frame = convert.frame_from_arrays(dict(
        frame_id=lf.frame_id, timestamp=lf.timestamp, uv=lf.uv, octave=lf.octave,
        angle=lf.angle, desc=lf.desc, response=lf.response, u_right=lf.u_right,
        depth=lf.depth, valid=lf.valid, R=lf.R, t=lf.t, mp_ids=lf.mp_ids,
        is_outlier=lf.is_outlier))
    tr.velocity = js.tracker.velocity.copy()
    tr.ref_kf = js.tracker.ref_kf
    tr.last_kf_frame_id = js.tracker.last_kf_frame_id
    tr.state = ttracker.TrackState.OK
    return tcfg, tr, scales


def test_fused_step_parity_on_carried_map(carried):
    """kp_row_m / kp_row_l / kp_row_add and both inlier masks equal; pose to
    1e-3 (two chained LM solves in f32)."""
    u, front = carried["inputs"], carried["front"]
    uv, octv, ang, desc, resp, val, ur, dep = front
    js = carried["js"]
    want = js.tracker._jit_fused(
        *(J(u[k]) for k in ("R0", "t0", "R_init", "t_init", "pt_pos", "pt_oct",
                            "pt_valid", "pt_desc", "loc_pos", "loc_normal",
                            "loc_mind", "loc_maxd", "loc_desc", "loc_valid", "loc_life")),
        J(uv), J(octv), J(ur), J(val), J(desc), u["radius"], u["extra"], u["seed"])
    w_res_m, w_row_m, w_res_l, w_row_l, w_row_add, w_nvis = want
    tcfg, _, scales = _port_tracker(carried)
    got = ttracker.fused_track(
        tcfg, T(scales),
        *(T(u[k]) for k in ("R0", "t0", "R_init", "t_init", "pt_pos", "pt_oct",
                            "pt_valid", "pt_desc", "loc_pos", "loc_normal",
                            "loc_mind", "loc_maxd", "loc_desc", "loc_valid", "loc_life")),
        T(uv), T(octv), T(ur), T(val), T(desc), float(u["radius"]), float(u["extra"]),
        torch.Generator().manual_seed(int(u["seed"])))
    g_res_m, g_row_m, g_res_l, g_row_l, g_row_add, g_nvis = got
    assert (np.asarray(w_row_m) >= 0).sum() > 50 and (np.asarray(w_row_l) >= 0).sum() > 10
    np.testing.assert_array_equal(g_row_m.numpy(), np.asarray(w_row_m))
    np.testing.assert_array_equal(g_res_m.inliers.numpy(), np.asarray(w_res_m.inliers))
    np.testing.assert_array_equal(g_row_l.numpy(), np.asarray(w_row_l))
    np.testing.assert_array_equal(g_row_add.numpy(), np.asarray(w_row_add))
    np.testing.assert_array_equal(g_res_l.inliers.numpy(), np.asarray(w_res_l.inliers))
    assert int(g_nvis) == int(w_nvis)
    np.testing.assert_allclose(g_res_l.R.numpy(), np.asarray(w_res_l.R), atol=1e-3)
    np.testing.assert_allclose(g_res_l.t.numpy(), np.asarray(w_res_l.t), atol=1e-3)


def test_process_frame_parity_on_carried_map(carried):
    """The port's host Tracker, started from the carried-over state, gives
    the fourth frame the same map-point associations, keyframe decision and
    (to 1e-3) pose as the JAX Tracker."""
    js, front = carried["js"], carried["front"]
    uv, octv, ang, desc, resp, val, ur, dep = front
    _, tr, _ = _port_tracker(carried)
    # the candidate pool is the one the JAX tracker cached after its third
    # frame (gathered before that frame's keyframe added points)
    u = carried["inputs"]
    tr._cached_pool = (carried["pool_ids"], tuple(
        u[k] for k in ("loc_pos", "loc_normal", "loc_mind", "loc_maxd",
                       "loc_desc", "loc_valid", "loc_life")))
    frame = convert.frame_from_arrays(dict(
        frame_id=3, timestamp=3 / 20.0, uv=uv, octave=octv, angle=ang, desc=desc,
        response=resp, u_right=ur, depth=dep, valid=val))
    st = tr.process_frame(frame)
    js.track_stereo(carried["imgs"][3][0], carried["imgs"][3][1], 3 / 20.0)
    jf, jst = js.tracker.last_frame, js.tracker.stats[-1]
    assert st.state == jst.state == "OK" and st.path == "fused"
    assert st.created_kf == jst.created_kf
    np.testing.assert_array_equal(frame.mp_ids, jf.mp_ids)
    np.testing.assert_allclose(frame.R, jf.R, atol=1e-3)
    np.testing.assert_allclose(frame.t, jf.t, atol=1e-3)
    assert tr.store.n_points == js.store.n_points
    assert tr.store.n_keyframes == js.store.n_keyframes


def _selection_inputs_taken(monkeypatch):
    """Which of observability's functions for the selection's matrices the
    step calls: the dispatch (kernel 4 on the card) or the plain chain."""
    taken = []
    for name in ("pose_info_for_selection", "pose_info_for_selection_ref"):
        real = getattr(tobs, name)
        monkeypatch.setattr(tobs, name, lambda *a, _n=name, _f=real: taken.append(_n) or _f(*a))
    return taken


def test_fused_step_good_feature_branch(carried, monkeypatch):
    """The fused step with Max-logDet selection on (lazier_factor=10, the
    headline setting) on the carried-over map. The motion stage is exact.
    What follows the selection is held statistically — picks can swap at f32
    near-ties and the sampling streams differ by design (threefry vs torch):
    same visibility count, the budget is respected, local/leftover match
    counts within 15 %, inlier counts within 5 %, same pose to 2e-3. Its
    selection's matrices come through the dispatch (kernel 4 on the card)."""
    from gf_orb_slam2_tpu.tracking.tracker import Tracker as JTracker

    taken = _selection_inputs_taken(monkeypatch)

    u, front = carried["inputs"], carried["front"]
    uv, octv, ang, desc, resp, val, ur, dep = front
    js = carried["js"]
    jcfg = carried["jcfg"].replace(good_feature=jconfig.GoodFeatureConfig(
        constr_per_frame=80, min_pool=100))
    scales = np.asarray(js.extractor.scales, np.float32)
    jtr = JTracker(jcfg, js.store, 640, scales)
    keys = ("R0", "t0", "R_init", "t_init", "pt_pos", "pt_oct", "pt_valid",
            "pt_desc", "loc_pos", "loc_normal", "loc_mind", "loc_maxd",
            "loc_desc", "loc_valid", "loc_life")
    w_res_m, w_row_m, w_res_l, w_row_l, w_row_add, w_nvis = jtr._jit_fused(
        *(J(u[k]) for k in keys), J(uv), J(octv), J(ur), J(val), J(desc),
        u["radius"], u["extra"], u["seed"])
    g_res_m, g_row_m, g_res_l, g_row_l, g_row_add, g_nvis = ttracker.fused_track(
        convert.config_from_reference(jcfg), T(scales), *(T(u[k]) for k in keys),
        T(uv), T(octv), T(ur), T(val), T(desc), float(u["radius"]), float(u["extra"]),
        torch.Generator().manual_seed(int(u["seed"])))
    np.testing.assert_array_equal(g_row_m.numpy(), np.asarray(w_row_m))
    np.testing.assert_array_equal(g_res_m.inliers.numpy(), np.asarray(w_res_m.inliers))
    assert int(g_nvis) == int(w_nvis) >= 100  # the selection is active
    n_w, n_g = int((np.asarray(w_row_l) >= 0).sum()), int((g_row_l >= 0).sum())
    a_w, a_g = int((np.asarray(w_row_add) >= 0).sum()), int((g_row_add >= 0).sum())
    i_w, i_g = int(w_res_l.n_inliers), int(g_res_l.n_inliers)
    print(f"local {n_w}/{n_g} leftover {a_w}/{a_g} inliers {i_w}/{i_g}")
    assert 0 < n_g <= 80 and abs(n_g - n_w) <= 0.15 * n_w + 3
    assert a_g > 0 and abs(a_g - a_w) <= 0.15 * a_w + 3
    assert not ((g_row_l >= 0) & (g_row_add >= 0)).any()
    assert abs(i_g - i_w) <= 0.05 * i_w + 2
    np.testing.assert_allclose(g_res_l.R.numpy(), np.asarray(w_res_l.R), atol=2e-3)
    np.testing.assert_allclose(g_res_l.t.numpy(), np.asarray(w_res_l.t), atol=2e-3)
    # the dispatch, which on CPU tensors runs the plain chain in turn
    assert taken == ["pose_info_for_selection", "pose_info_for_selection_ref"]


# ------------------------------------------ streaming step on the carried map
def _jax_stream_step(jtr, carried):
    """The JAX streaming step on the carried state; also returns the local
    stage's inlier mask, which its packed output does not hold."""
    c = carried["stream"]

    def run(upload, front, chain, mirror):
        box = {}
        impl = jtr._fused_track_impl

        def spy(*a):
            out = impl(*a)
            box["l_inl"] = out[2].inliers
            return out

        jtr._fused_track_impl = spy
        try:
            packed, next_chain = jtr._stream_step_impl(upload, *front, chain, mirror)
        finally:
            del jtr._fused_track_impl
        return packed, next_chain, box["l_inl"]

    packed, next_chain, l_inl = jax.jit(run)(
        J(c["up_packed"]), [J(a) for a in carried["front"]],
        {k: J(v) for k, v in c["chain"].items()}, c["mirror"])
    out = jtr._stream_out_layout.unpack_np(np.asarray(packed))
    out["l_inl"] = np.asarray(l_inl)
    return out, {k: np.asarray(v) for k, v in next_chain.items()}


def _port_stream_step(carried, tcfg):
    """The port's stream_step on the same state carried through convert.py:
    the chain from the JAX chain's arrays, the mirror from the store's."""
    c = carried["stream"]
    store = convert.store_with_mirror(tcfg.capacity, 640, c["store"], device="cpu")
    chain = convert.chain_from_arrays(c["chain"], "cpu")
    upload = dict(pool_ids=T(c["upload"]["pool_ids"].astype(np.int64)),
                  loc_life=T(c["upload"]["loc_life"]))
    front = dict(zip(ttracker.HOST_FIELDS, (T(a) for a in carried["front"])))
    scales = np.asarray(carried["js"].extractor.scales, np.float32)
    out, next_chain = ttracker.stream_step(
        tcfg, T(scales), upload, front, chain, store.mirror.arrays,
        torch.Generator().manual_seed(int(c["upload"]["seed"])))
    return ({k: v.numpy() for k, v in out.items()},
            {k: v.numpy() for k, v in next_chain.items()}, chain)


def test_stream_step_parity_on_carried_map(carried):
    """LONG_LIVED budget (integer scores): every integer output and the next
    chain's ids, validity, octaves and descriptors equal; poses to 1e-3; the
    chain's older pose is the carried last pose, bit for bit."""
    js = carried["js"]
    want, w_next = _jax_stream_step(js.tracker, carried)
    tcfg = convert.config_from_reference(carried["jcfg"])
    got, g_next, chain_in = _port_stream_step(carried, tcfg)
    assert (want["mp"] >= 0).sum() > 100 and (want["kp_row_l"] >= 0).sum() > 10
    assert (want["mp_extra"] >= 0).sum() + (want["kp_row_m"] >= 0).sum() > 0
    for k in ("mp", "mp_extra", "kp_row_m", "kp_row_l", "m_inl", "l_inl", "n_inliers", "n_vis"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("pt_ids", "pt_valid", "pt_oct"):
        np.testing.assert_array_equal(g_next[k], w_next[k], err_msg=k)
    np.testing.assert_array_equal(g_next["pt_desc"], w_next["pt_desc"].view(np.int32))
    np.testing.assert_array_equal(g_next["pt_pos"], w_next["pt_pos"])
    for k, w in (("R", want["R"]), ("t", want["t"]), ("R1", w_next["R1"]), ("t1", w_next["t1"])):
        np.testing.assert_allclose(got[k] if k in got else g_next[k], w, atol=1e-3, err_msg=k)
    np.testing.assert_array_equal(g_next["R2"], chain_in["R1"].numpy())
    np.testing.assert_array_equal(g_next["t2"], chain_in["t1"].numpy())
    np.testing.assert_array_equal(g_next["R2"], w_next["R2"])


def test_stream_step_good_feature_branch(carried, monkeypatch):
    """Max-logDet selection on (lazier_factor=10), held as
    test_fused_step_good_feature_branch holds the fused step: the motion
    stage exact, the same visibility count, the budget respected, local and
    leftover match counts within 15 %, inliers within 5 %, pose to 2e-3; the
    chain is consistent with the combined ids. Its selection's matrices come
    from the plain chain, not kernel 4 (tracking/tracker.py `stream_step`)."""
    from gf_orb_slam2_tpu.tracking.tracker import Tracker as JTracker

    taken = _selection_inputs_taken(monkeypatch)

    js = carried["js"]
    jcfg = carried["jcfg"].replace(good_feature=jconfig.GoodFeatureConfig(
        constr_per_frame=80, min_pool=100))
    scales = np.asarray(js.extractor.scales, np.float32)
    want, w_next = _jax_stream_step(JTracker(jcfg, js.store, 640, scales), carried)
    got, g_next, chain_in = _port_stream_step(carried, convert.config_from_reference(jcfg))
    for k in ("kp_row_m", "m_inl"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["n_vis"]) == int(want["n_vis"]) >= 100
    n_w, n_g = int((want["kp_row_l"] >= 0).sum()), int((got["kp_row_l"] >= 0).sum())
    a_w, a_g = int((want["mp_extra"] >= 0).sum()), int((got["mp_extra"] >= 0).sum())
    i_w, i_g = int(want["n_inliers"]), int(got["n_inliers"])
    print(f"local {n_w}/{n_g} leftover-in-chain {a_w}/{a_g} inliers {i_w}/{i_g}")
    assert 0 < n_g <= 80 and abs(n_g - n_w) <= 0.15 * n_w + 3
    assert abs(a_g - a_w) <= 0.15 * a_w + 3
    assert abs(i_g - i_w) <= 0.05 * i_w + 2
    np.testing.assert_allclose(got["R"], want["R"], atol=2e-3)
    np.testing.assert_allclose(got["t"], want["t"], atol=2e-3)
    # the chain carries the combined ids, then the leftover ids, each once
    ids = np.where(got["mp"] >= 0, got["mp"], got["mp_extra"])
    np.testing.assert_array_equal(g_next["pt_ids"], ids)
    np.testing.assert_array_equal(g_next["pt_valid"], ids >= 0)
    live = ids[ids >= 0]
    assert live.size == np.unique(live).size
    assert taken == ["pose_info_for_selection_ref"]
    np.testing.assert_array_equal(g_next["R2"], chain_in["R1"].numpy())
    np.testing.assert_array_equal(g_next["t2"], chain_in["t1"].numpy())

"""The pose LM's plain version (optim/pose_opt.py `pose_optimization_ref`)
against the JAX package's `pose_optimization` on the CPU, and the wrapper
around its CUDA kernel (csrc/pose_lm.cu through ops/pose_lm_cuda.py).

Both packages get the same numpy problem, made from a seed: points in front
of a camera, a pose 0.02 rad / 0.1 m from the truth, pixel noise of 0.7 px,
30 % outliers of 25 px (they cross the chi2 gate between rounds), 10 %
invalid slots, stereo and monocular observations. Tolerances: R and t
within 1e-4 (float32 rounding of two orders of the same sums: measured
≤ 3e-5), inlier masks and n_inliers exact, chi2 within rtol 1e-4 of the
JAX package's chi2 at the port's pose (measured: equal). At the two
packages' own poses the smallest inlier chi2 differ by up to 4.4 %
(measured): 2.7e-5 m moves a residual of a few hundredths of a pixel by
1e-3 px, so chi2 is held where it is a function of the pose alone.

The kernel has no CPU mode: its checks against the plain version are the
`cuda` tests below (`python -m pytest tests/test_torch_pose_lm.py -m cuda`
on a machine with a card) and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu.optim import pose_opt as jpose
from gf_orb_slam2_tpu_torch.geometry import lie as tlie
from gf_orb_slam2_tpu_torch.ops import cuda_lib, pose_lm_cuda
from gf_orb_slam2_tpu_torch.optim import pose_opt as tpose

torch.set_num_threads(1)

FX, FY, CX, CY, BF = 450.0, 450.0, 320.0, 240.0, 45.0


def _problem(seed, n, mono=False, outliers=0.3):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(2, 10, n)], -1)
    R = tlie.so3_exp(torch.from_numpy(rng.normal(0, 0.05, 3).astype(np.float32))).numpy()
    t = rng.normal(0, 0.2, 3)
    pc = X @ R.T + t
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1)
    uv += rng.normal(0, 0.7, (n, 2))
    ur = uv[:, 0] - BF / pc[:, 2] + rng.normal(0, 0.7, n)
    ur[mono | (rng.random(n) < 0.3)] = -1.0  # monocular observations
    bad = rng.random(n) < outliers
    uv[bad] += rng.normal(0, 25, (int(bad.sum()), 2))
    inv2 = 1.0 / 1.2 ** (2 * rng.integers(0, 4, n))
    valid = rng.random(n) < 0.9
    dR = tlie.so3_exp(torch.from_numpy(rng.normal(0, 0.02, 3).astype(np.float32))).numpy()
    R0, t0 = dR @ R, t + rng.normal(0, 0.1, 3)
    f32 = [np.asarray(a, np.float32) for a in (R0, t0, X, uv, ur, inv2)]
    return (*f32, valid), (R, t)


def _both(args, rounds, iters):
    want = jpose.pose_optimization(*(jnp.asarray(a) for a in args), FX, FY, CX, CY, BF,
                                   rounds=rounds, iters=iters)
    got = tpose.pose_optimization_ref(*(torch.from_numpy(a) for a in args), FX, FY, CX, CY, BF,
                                      rounds=rounds, iters=iters)
    return got, want


@pytest.mark.parametrize("mono", [False, True], ids=["mixed", "mono"])
@pytest.mark.parametrize("schedule", [(3, 8), (4, 10)], ids=["3x8", "4x10"])
def test_plain_version_matches_jax(schedule, mono):
    """The main path's 3×8 and the relocalization's 4×10 schedules, N = 1000
    (not a multiple of the kernel's 256 threads)."""
    args, (R_true, t_true) = _problem(21 + mono, 1000, mono=mono)
    got, want = _both(args, *schedule)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) == int(got.inliers.sum())
    r, _, _ = jpose._residuals_jacobians(
        jnp.asarray(got.R.numpy()), jnp.asarray(got.t.numpy()),
        *(jnp.asarray(a) for a in args[2:5]), FX, FY, CX, CY, BF)
    chi2_at_port_pose = jpose._chi2(r, jnp.asarray(args[5]), jnp.asarray(args[4]) >= 0)
    np.testing.assert_allclose(got.chi2.numpy(), np.asarray(chi2_at_port_pose), rtol=1e-4)
    # the outliers were gated out, and the pose converged
    assert int(got.n_inliers) < 0.8 * int(args[-1].sum())
    assert np.abs(got.t.numpy() - t_true).max() < 0.02


def test_outliers_cross_the_gate_between_rounds():
    """Slots that start valid leave the inlier set at the round boundaries:
    one round keeps the valid mask as it is, three rounds gate a fifth of it
    out, in both packages alike."""
    args, _ = _problem(23, 1000)
    valid = args[-1]
    got, want = _both(args, 3, 8)
    gated_out = valid & ~got.inliers.numpy()
    assert gated_out.sum() > 0.2 * valid.sum()
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    one, one_jax = _both(args, 1, 8)
    np.testing.assert_array_equal(one.inliers.numpy(), np.asarray(one_jax.inliers))


def test_dispatch_on_cpu_is_the_plain_version():
    """CPU tensors go to the plain version: the same result, bit for bit."""
    args, _ = _problem(24, 300)
    ts = [torch.from_numpy(a) for a in args]
    got = tpose.pose_optimization(*ts, FX, FY, CX, CY, BF, rounds=3, iters=8)
    want = tpose.pose_optimization_ref(*ts, FX, FY, CX, CY, BF, rounds=3, iters=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _one_pass_schedule(R0, t0, Xw, uv, u_right, inv_sigma2, valid, fx, fy, cx, cy, bf,
                       rounds, iters, damping=1e-5):
    """csrc/pose_lm.cu's step schedule, written in torch from optim/pose_opt.py's
    own helpers: ONE pass a step at the candidate pose, which sums its robust
    cost and its H and b; an accepted candidate's H and b are the next step's,
    a rejected one's are dropped and the kept H and b are solved again with
    the new lambda; the first step and each round's re-gate step make a pass
    of their own at the accepted pose. Returns the result and the passes."""
    dt = Xw.dtype
    is_stereo = u_right >= 0
    chi2_th = torch.where(is_stereo, tpose.CHI2_STEREO, tpose.CHI2_MONO).to(dt)
    delta = torch.where(is_stereo, tpose.HUBER_STEREO, tpose.HUBER_MONO).to(dt)
    d2 = delta * delta
    eye6 = torch.eye(6, dtype=dt)
    passes = 0

    def sweep(R, t, inlier, gate):
        nonlocal passes
        passes += 1
        r, J, depth = tpose._residuals_jacobians(R, t, Xw, uv, u_right, fx, fy, cx, cy, bf)
        c2 = tpose._chi2(r, inv_sigma2, is_stereo)
        e = torch.sqrt(torch.clamp(c2, min=1e-12))
        rho = torch.where(e <= delta, c2, 2.0 * delta * e - d2)
        if gate:
            inlier = valid & (c2 <= chi2_th) & (depth > 1e-4)
            cost = torch.sum(torch.where(inlier, rho, 0.0))
        else:
            cost = torch.sum(torch.where(inlier & (depth > 1e-4), rho, 0.0))
        active = inlier & (depth > 1e-4)
        w = inv_sigma2 * torch.where(e <= delta, 1.0, delta / e) * active.to(dt)
        Jw = J * w[:, None, None]
        return (torch.einsum("nri,nrj->ij", Jw, J), torch.einsum("nri,nr->i", Jw, r), cost,
                inlier)

    R, t = R0, t0
    H, b, cost, inlier = sweep(R, t, valid, gate=False)
    lam0 = torch.full((), 1e-3, dtype=dt)
    lam = lam0.clone()
    steps = rounds * iters
    for step in range(steps):
        xi = -torch.linalg.solve_ex(H + lam * (eye6 * (damping + torch.diagonal(H))), b)[0]
        dR, dtr = tlie.se3_exp(xi)
        R_new, t_new = tlie.se3_compose(dR, dtr, R, t)
        H_new, b_new, cost_new, _ = sweep(R_new, t_new, inlier, gate=False)
        accept = (cost_new < cost) & torch.isfinite(xi).all() & torch.isfinite(cost_new)
        if bool(accept):
            R, t, H, b, cost = R_new, t_new, H_new, b_new, cost_new
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-6, 1e6)
        if step + 1 < steps and (step + 1) % iters == 0:
            H, b, cost, inlier = sweep(R, t, valid, gate=True)
            lam = lam0
    r, pc, _ = tpose._project(R, t, Xw, uv, u_right, is_stereo, fx, fy, cx, cy, bf)
    c2 = tpose._chi2(r, inv_sigma2, is_stereo)
    inliers = valid & (c2 <= chi2_th) & (pc[..., 2] > 1e-4)
    return tpose.PoseOptResult(R, t, inliers, inliers.sum(), c2), passes


@pytest.mark.parametrize("mono", [False, True], ids=["mixed", "mono"])
@pytest.mark.parametrize("schedule", [(3, 8), (4, 10)], ids=["3x8", "4x10"])
def test_one_pass_schedule_equals_plain_version_bit_for_bit(schedule, mono):
    """The kernel's schedule (one pass a step, H and b kept on a rejected
    step, the re-gate step's own pass) computes every value the plain
    version computes, on the same operations: bit for bit, 30 % outliers
    crossing the gate. 3 x 8 takes 28 passes where the plain version takes
    50 (1 + 2 a step + the final gate)."""
    args, _ = _problem(21 + mono, 1000, mono=mono)
    ts = [torch.from_numpy(a) for a in args]
    got, passes = _one_pass_schedule(*ts, FX, FY, CX, CY, BF, *schedule)
    want = tpose.pose_optimization_ref(*ts, FX, FY, CX, CY, BF, *schedule)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rounds, iters = schedule
    assert passes == 1 + rounds * iters + (rounds - 1)
    valid = args[-1]
    assert int(got.n_inliers) < 0.8 * int(valid.sum())  # the gate took the outliers out


def test_one_pass_schedule_edge_cases_bit_for_bit():
    """No valid point (every step rejected, the pose kept bit for bit), every
    point behind the camera, a non-finite point (every step NaN, rejected)."""
    args, _ = _problem(35, 300)
    R0, t0, X, uv, ur, inv2, valid = (torch.from_numpy(a) for a in args)
    nan_X = X.clone()
    nan_X[0] = float("nan")
    for case in ([R0, t0, X, uv, ur, inv2, torch.zeros_like(valid)],
                 [R0, t0, -X, uv, ur, inv2, torch.ones_like(valid)],
                 [R0, t0, nan_X, uv, ur, inv2, valid]):
        got, _ = _one_pass_schedule(*case, FX, FY, CX, CY, BF, 3, 8)
        want = tpose.pose_optimization_ref(*case, FX, FY, CX, CY, BF, 3, 8)
        for g, w in zip(got, want):
            assert torch.equal(g, w) or torch.equal(g.isnan(), w.isnan()) and torch.equal(
                g.nan_to_num(), w.nan_to_num())
    assert torch.equal(got.R, R0) and torch.equal(got.t, t0)


def _no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel library was built before the checks")

    monkeypatch.setattr(cuda_lib, "load", refuse)
    monkeypatch.setattr(cuda_lib, "build", refuse)


def test_kernel_entry_refuses_float64_and_cpu_tensors(monkeypatch):
    """TypeError on float64, ValueError on a float32 CPU tensor — before any
    build, and no launch is counted."""
    _no_build(monkeypatch)
    args, _ = _problem(25, 20)
    ts = [torch.from_numpy(a) for a in args]
    before = dict(cuda_lib.launch_counts)
    with pytest.raises(TypeError):
        pose_lm_cuda.pose_lm(*[t.double() if t.dtype == torch.float32 else t for t in ts],
                             FX, FY, CX, CY, BF, 3, 8, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        pose_lm_cuda.pose_lm(*ts, FX, FY, CX, CY, BF, 3, 8, 1e-5)
    assert cuda_lib.launch_counts == before


# ---- on the card


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", [(3, 8), (4, 10)], ids=["3x8", "4x10"])
def test_kernel_equals_plain_version_on_the_card(schedule):
    """R and t within 1e-4, inliers and n_inliers exact, one launch."""
    dev = _cuda_or_skip()
    for seed, n, mono in ((31, 1024, False), (32, 1000, True), (33, 37, False), (34, 0, False),
                          (36, 1024, True), (37, 2000, False)):
        args, _ = _problem(seed, n, mono=mono)
        ts = [torch.from_numpy(a).to(dev) for a in args]
        before = cuda_lib.launch_counts["pose_lm"]
        got = tpose.pose_optimization(*ts, FX, FY, CX, CY, BF, *schedule)
        assert cuda_lib.launch_counts["pose_lm"] == before + 1
        want = tpose.pose_optimization_ref(*ts, FX, FY, CX, CY, BF, *schedule)
        torch.testing.assert_close(got.R, want.R, atol=1e-4, rtol=0)
        torch.testing.assert_close(got.t, want.t, atol=1e-4, rtol=0)
        assert torch.equal(got.inliers, want.inliers)
        assert int(got.n_inliers) == int(want.n_inliers)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 1024, 2000], ids=["n50", "n1024", "n2000"])
def test_kernel_edge_cases_on_the_card(n):
    """No valid point keeps the pose bit for bit; every point behind the
    camera lets no NaN out; a non-finite point makes every step NaN, all
    rejected: the pose bit for bit. N = 2000 reads the points from memory
    (above the 1024 held in registers)."""
    dev = _cuda_or_skip()
    args, _ = _problem(35, n)
    R0, t0, X, uv, ur, inv2, valid = (torch.from_numpy(a).to(dev) for a in args)
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    for sched in ((2, 4), (3, 8), (4, 10)):
        got = tpose.pose_optimization(R0, t0, X, uv, ur, inv2, none, FX, FY, CX, CY, BF, *sched)
        assert torch.equal(got.R, R0) and torch.equal(got.t, t0) and int(got.n_inliers) == 0
        got = tpose.pose_optimization(R0, t0, -X, uv, ur, inv2, ~none, FX, FY, CX, CY, BF, *sched)
        assert torch.isfinite(got.R).all() and torch.isfinite(got.t).all()
        assert int(got.n_inliers) == 0
        nan_X = X.clone()
        nan_X[0] = float("nan")
        got = tpose.pose_optimization(R0, t0, nan_X, uv, ur, inv2, valid, FX, FY, CX, CY, BF,
                                      *sched)
        want = tpose.pose_optimization_ref(R0, t0, nan_X, uv, ur, inv2, valid, FX, FY, CX, CY,
                                           BF, *sched)
        assert torch.equal(got.R, R0) and torch.equal(got.t, t0)
        assert torch.equal(got.inliers, want.inliers)

"""Distributed bundle adjustment over torch.distributed.

The port of `gf_orb_slam2_tpu/parallel/dist_ba.py`: bundle adjustment
scaled past one device by sharding the map points (and their observation
tables) over a mesh of ranks, one process per device. Per LM iteration:

  each rank: residuals and Jacobians for ITS point shard → local Hpp, bp,
  point-block inverses, T·Hll⁻¹·Tᵀ Schur contributions
  → all-reduce over the mesh (the JAX `psum`) builds the reduced camera
  system S [6K,6K]
  → every rank solves the replicated S and back-substitutes ITS points.

Two layouts, as in the JAX package:
- point-sharded (`build_distributed_ba_step`): S is all-reduced whole and
  solved densely on every rank;
- KF-sharded (`build_pcg_ba_step`): S's block rows are reduce-scattered
  over one mesh axis (the JAX `psum_scatter(tiled=True)`), after an
  all-reduce over the others, and the pose update is solved by 48
  iterations of block-Jacobi PCG whose matvec all-gathers the [K,6] product
  rows (`all_gather_into_tensor`).

The step keeps lam, the accept flag and the cost as device tensors: an LM
iteration enqueues its work and its collectives with no host round trip, as
the JAX step is one jitted program. The collectives are called through the
`torch.distributed` module, so a caller can wrap them to count them
(tools/collective_audit_torch.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from gf_orb_slam2_tpu_torch.geometry import lie
from gf_orb_slam2_tpu_torch.optim.local_ba import (
    HUBER_MONO, HUBER_STEREO, LocalBAProblem, _chi2, _diag_add, _residuals, one_hot,
)
from gf_orb_slam2_tpu_torch.parallel.mesh import axis_group, replicate, shard_points
from gf_orb_slam2_tpu_torch.utils.linalg3 import inv3

PCG_ITERS = 48
LAM0 = 1e-4


def _psum(t, group):
    """All-reduce (sum) of `t` over `group`; returns the reduced tensor."""
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def _identity(t, group):
    return t


class _Local(NamedTuple):
    """One rank's share of the normal equations at the current estimate."""
    Hpp: torch.Tensor       # [K,6,6]
    bp: torch.Tensor        # [K,6]
    S_cross: torch.Tensor   # [K,K,6,6]  Σ_p T_p Hll_p⁻¹ T_pᵀ
    bs_corr: torch.Tensor   # [K,6]
    T1: torch.Tensor        # [P,K,6,3]
    Vinv: torch.Tensor      # [P,3,3]
    bl: torch.Tensor        # [P,3]
    active: torch.Tensor    # [P,O] bool
    delta: torch.Tensor     # [P,O] Huber threshold


def _linearize(prob: LocalBAProblem, lam, cam, damping) -> _Local:
    K = prob.kf_R.shape[0]
    is_stereo = prob.obs_ur >= 0
    delta = torch.where(is_stereo, HUBER_STEREO, HUBER_MONO)
    onehot = one_hot(prob.obs_kf, K, prob.kf_R.dtype)
    opt_mask = ~prob.kf_fixed & prob.kf_valid

    r, J_pose, J_pt, depth = _residuals(prob, prob.kf_R, prob.kf_t, prob.pt_pos, *cam)
    c2 = _chi2(r, prob.obs_inv_sigma2, is_stereo)
    e = torch.sqrt(torch.clamp(c2, min=1e-12))
    w_huber = torch.where(e <= delta, 1.0, delta / e)
    active = prob.obs_valid & (prob.obs_kf >= 0) & prob.pt_valid[:, None] & (depth > 1e-4)
    w = prob.obs_inv_sigma2 * w_huber * active.to(r.dtype)
    pose_on = opt_mask[prob.obs_kf.clamp(min=0)]
    Jp = J_pose * pose_on[..., None, None].to(r.dtype)

    wJp = w[..., None, None] * Jp
    M = torch.einsum("poab,poac->pobc", wJp, Jp)
    Hpp = torch.einsum("pok,pobc->kbc", onehot, M)
    vb = torch.einsum("poab,poa->pob", wJp, r)
    bp = torch.einsum("pok,pob->kb", onehot, vb)
    wJl = w[..., None, None] * J_pt
    Hll = torch.einsum("poab,poac->pbc", wJl, J_pt)
    bl = torch.einsum("poab,poa->pb", wJl, r)
    C = torch.einsum("poab,poac->pobc", wJp, J_pt)
    T1 = torch.einsum("pok,pobc->pkbc", onehot, C)
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    trace = torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1)
    lamHll = Hll + (damping + lam) * eye3 * (1.0 + trace[:, None, None] / 3.0)
    Vinv = inv3(lamHll) * prob.pt_valid[:, None, None]
    T1V = torch.einsum("pkab,pbc->pkac", T1, Vinv)
    S_cross = torch.einsum("pkac,pmdc->kmad", T1V, T1)
    bs_corr = torch.einsum("pkac,pc->ka", T1V, bl)
    return _Local(Hpp, bp, S_cross, bs_corr, T1, Vinv, bl, active, delta)


def _pose_damping(Hpp, lam, damping):
    """The LM damping of the camera blocks, [K,6,6]."""
    trace = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
    eye6 = torch.eye(6, dtype=Hpp.dtype, device=Hpp.device)
    return eye6[None] * (damping + lam + trace[:, None, None] / 6.0 * lam)


def _robust_cost(prob, loc: _Local, kf_R, kf_t, pts, cam, psum, group):
    """Σ of the Huber costs of this rank's active observations, summed over
    the mesh."""
    is_stereo = prob.obs_ur >= 0
    r, _, _, _ = _residuals(prob, kf_R, kf_t, pts, *cam)
    c2 = _chi2(r, prob.obs_inv_sigma2, is_stereo)
    e = torch.sqrt(torch.clamp(c2, min=1e-12))
    d = loc.delta
    rho = torch.where(e <= d, c2, 2.0 * d * e - d * d)
    return psum(torch.where(loc.active, rho, 0.0).sum().reshape(1), group)[0]


def _update(prob, loc: _Local, xi_p, lam, cam, psum, group, cost_of_rejected):
    """Back-substitute the points, apply the step, accept or reject it."""
    rhs_l = loc.bl + torch.einsum("pkab,ka->pb", loc.T1, xi_p)
    dx = -torch.einsum("pbc,pc->pb", loc.Vinv, rhs_l)
    dR, dt = lie.se3_exp(xi_p)
    kf_R_new, kf_t_new = lie.se3_compose(dR, dt, prob.kf_R, prob.kf_t)
    pt_new = prob.pt_pos + dx * prob.pt_valid[:, None].to(dx.dtype)
    cost_old = _robust_cost(prob, loc, prob.kf_R, prob.kf_t, prob.pt_pos, cam, psum, group)
    cost_new = _robust_cost(prob, loc, kf_R_new, kf_t_new, pt_new, cam, psum, group)
    accept = cost_new < cost_old
    kf_R = torch.where(accept, kf_R_new, prob.kf_R)
    kf_t = torch.where(accept, kf_t_new, prob.kf_t)
    pt_pos = torch.where(accept, pt_new, prob.pt_pos)
    lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e6)
    cost = torch.minimum(cost_new, cost_old) if cost_of_rejected else cost_new
    return kf_R, kf_t, pt_pos, lam, cost


def build_distributed_ba_step(mesh, fx, fy, cx, cy, bf, damping=1e-4,
                              ablate_collectives: bool = False):
    """One LM iteration of point-sharded BA: `step(prob, lam) → (kf_R, kf_t,
    pt_pos, lam, cost)` on this rank's shard (`prob` holds the replicated KF
    arrays and this rank's points). The reductions run over every mesh axis.

    `ablate_collectives` replaces the all-reduces by the identity: the same
    per-rank compute without the cross-rank traffic (timing only; the result
    is wrong past one rank)."""
    cam = (fx, fy, cx, cy, bf)
    group = axis_group(mesh, mesh.mesh_dim_names)
    psum = _identity if ablate_collectives else _psum

    def step(prob: LocalBAProblem, lam):
        K = prob.kf_R.shape[0]
        loc = _linearize(prob, lam, cam, damping)
        # the collective: reduce the camera system over the mesh
        Hpp = psum(loc.Hpp, group)
        bp = psum(loc.bp, group)
        S_cross = psum(loc.S_cross, group)
        bs_corr = psum(loc.bs_corr, group)

        S_blocks = _diag_add(-S_cross, Hpp + _pose_damping(Hpp, lam, damping))
        S = S_blocks.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
        bs = (bp - bs_corr).reshape(-1)
        act6 = (~prob.kf_fixed & prob.kf_valid).repeat_interleave(6)
        S = torch.where(act6[:, None] & act6[None, :], S, 0.0)
        S = S + torch.diag(torch.where(act6, 0.0, 1.0))
        bs = torch.where(act6, bs, 0.0)
        xi_p = -torch.linalg.solve_ex(S, bs[:, None])[0].reshape(K, 6)
        return _update(prob, loc, xi_p, lam, cam, psum, group, cost_of_rejected=False)

    return step


def inv3_6(blocks, act):
    """Inverse of SPD 6x6 blocks by a two-level Schur complement on their
    3x3 corners (closed form, utils/linalg3.py); inactive blocks give 0."""
    A = blocks[..., :3, :3]
    B = blocks[..., :3, 3:]
    Ct = blocks[..., 3:, :3]
    Dm = blocks[..., 3:, 3:]
    Ai = inv3(A)
    Sci = inv3(Dm - Ct @ Ai @ B)
    TL = Ai + Ai @ B @ Sci @ Ct @ Ai
    TR = -Ai @ B @ Sci
    BL = -Sci @ Ct @ Ai
    out = torch.cat([torch.cat([TL, TR], -1), torch.cat([BL, Sci], -1)], -2)
    return out * act[:, None, None].to(out.dtype)


def build_pcg_ba_step(mesh, fx, fy, cx, cy, bf, damping=1e-4,
                      pcg_iters: int = PCG_ITERS, scatter_axis: str | None = None):
    """One LM iteration of KF-sharded BA: points sharded as in
    `build_distributed_ba_step`, but the reduced camera system is never
    replicated. After an all-reduce over the other axes, a reduce-scatter
    along `scatter_axis` (default: the mesh's first) hands each rank a ROW
    BLOCK of S [K/n,K,6,6], and the pose update solves S x = b by
    block-Jacobi PCG whose matvec all-gathers the [K,6] product. K must
    divide by the scatter axis's size.

    Collectives per LM iteration: all-reduces of Hpp, bp, bs_corr and the two
    costs over the mesh; one all-reduce of S over the other axes (if any);
    one reduce-scatter of S along the scatter axis; `pcg_iters` all-gathers
    of [K,6]."""
    cam = (fx, fy, cx, cy, bf)
    names = tuple(mesh.mesh_dim_names)
    scatter_axis = names[0] if scatter_axis is None else scatter_axis
    other_axes = tuple(a for a in names if a != scatter_axis)
    world = axis_group(mesh, names)
    scatter_group = mesh.get_group(scatter_axis)
    other_group = axis_group(mesh, other_axes) if other_axes else None
    n_scatter = mesh.shape[names.index(scatter_axis)]
    idx = mesh.get_local_rank(scatter_axis)

    def step(prob: LocalBAProblem, lam):
        K = prob.kf_R.shape[0]
        if K % n_scatter:
            raise ValueError(f"K = {K} does not divide by the scatter axis size {n_scatter}")
        Kb = K // n_scatter
        dev = prob.kf_R.device
        loc = _linearize(prob, lam, cam, damping)
        # small replicated pieces (diagonal, rhs) by all-reduce; the O(K²)
        # body by reduce-scatter, after a reduction over the other axes:
        # each rank along the scatter axis owns a block of rows, ranks that
        # differ only in the other axes hold identical copies
        Hpp = _psum(loc.Hpp, world)
        bp = _psum(loc.bp, world)
        bs_corr = _psum(loc.bs_corr, world)
        S_pre = -loc.S_cross
        if other_group is not None:
            S_pre = _psum(S_pre, other_group)
        S_rows = torch.empty((Kb,) + tuple(S_pre.shape[1:]), dtype=S_pre.dtype, device=dev)
        dist.reduce_scatter_tensor(S_rows, S_pre.contiguous(), group=scatter_group)
        rows = torch.arange(Kb, device=dev)
        row_ids = idx * Kb + rows
        diag_blocks = Hpp + _pose_damping(Hpp, lam, damping)   # [K,6,6] replicated
        act = ~prob.kf_fixed & prob.kf_valid
        S_rows[rows, row_ids] += diag_blocks[row_ids]
        # inactive poses: identity rows (consistent with the dense layout)
        S_rows = S_rows * (act[row_ids][:, None, None, None] & act[None, :, None, None])
        eye6 = torch.eye(6, dtype=S_rows.dtype, device=dev)
        S_rows[rows, row_ids] += eye6[None] * (~act[row_ids])[:, None, None]
        b = (bp - bs_corr) * act[:, None]
        Pre = inv3_6(diag_blocks, act)

        def matvec(x):  # x [K,6] replicated → S x [K,6] replicated
            y = torch.empty_like(x)
            dist.all_gather_into_tensor(
                y, torch.einsum("rkab,kb->ra", S_rows, x).contiguous(), group=scatter_group)
            return y

        # x0 = 0, so r0 = b: the JAX form's matvec of the zero vector is skipped
        x = torch.zeros_like(b)
        rr = b
        z = torch.einsum("kab,kb->ka", Pre, rr)
        p = z
        rz = torch.sum(rr * z)
        for _ in range(pcg_iters):
            Ap = matvec(p)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = torch.einsum("kab,kb->ka", Pre, rr)
            rz_new = torch.sum(rr * z)
            beta = rz_new / torch.clamp(rz, min=1e-20)
            p = z + beta * p
            rz = rz_new
        xi_p = -x * act[:, None]
        return _update(prob, loc, xi_p, lam, cam, _psum, world, cost_of_rejected=True)

    return step


def local_problem(mesh, prob: LocalBAProblem) -> LocalBAProblem:
    """This rank's share of the whole problem: the KF arrays replicated, the
    point-major arrays sharded, all on this rank's device."""
    return LocalBAProblem(*(replicate(mesh, a) for a in prob[:4]),
                          *(shard_points(mesh, a) for a in prob[4:]))


def distributed_ba(mesh, prob: LocalBAProblem, fx, fy, cx, cy, bf, iters=10,
                   kf_sharded: bool = False, scatter_axis: str | None = None,
                   ablate_collectives: bool = False):
    """Run `iters` distributed LM iterations on every rank of the mesh, each
    rank holding the whole problem; returns (kf_R, kf_t, pt_pos, cost) on this
    rank's device, pt_pos gathered whole once after the loop. `kf_sharded`
    uses the reduce-scatter + PCG camera solve (K must divide by the scatter
    axis's size); on a hosts × devices mesh pass scatter_axis=HOST_AXIS to lay
    the camera-system scatter on the host axis."""
    step = (build_pcg_ba_step(mesh, fx, fy, cx, cy, bf, scatter_axis=scatter_axis)
            if kf_sharded else
            build_distributed_ba_step(mesh, fx, fy, cx, cy, bf,
                                      ablate_collectives=ablate_collectives))
    local = local_problem(mesh, prob)
    dev = local.kf_R.device
    lam = torch.tensor(LAM0, dtype=torch.float32, device=dev)
    cost = torch.tensor(0.0, dtype=torch.float32, device=dev)
    for _ in range(iters):
        kf_R, kf_t, pt_pos, lam, cost = step(local, lam)
        local = local._replace(kf_R=kf_R, kf_t=kf_t, pt_pos=pt_pos)
    pt_all = torch.empty((prob.pt_pos.shape[0], 3), dtype=local.pt_pos.dtype, device=dev)
    dist.all_gather_into_tensor(pt_all, local.pt_pos.contiguous(),
                                group=axis_group(mesh, mesh.mesh_dim_names))
    return local.kf_R, local.kf_t, pt_all, cost


def solve_arrays(arrays, cam, iters, mesh_shape=None, kf_sharded=False,
                 scatter_axis=None, device="cuda"):
    """Rank target for `parallel.launch`: `distributed_ba` on a problem given
    as numpy arrays (`convert.ba_problem_from_arrays`), over a one-axis mesh
    of the world or, with `mesh_shape` = (hosts, devices), a two-axis one.
    Returns (kf_R, kf_t, pt_pos, cost) as numpy."""
    from gf_orb_slam2_tpu_torch.convert import ba_problem_from_arrays
    from gf_orb_slam2_tpu_torch.parallel.mesh import make_mesh, make_mesh2d

    mesh = (make_mesh(device=device) if mesh_shape is None
            else make_mesh2d(*mesh_shape, device=device))
    out = distributed_ba(mesh, ba_problem_from_arrays(arrays, "cpu"), *cam, iters=iters,
                         kf_sharded=kf_sharded, scatter_axis=scatter_axis)
    return tuple(t.cpu().numpy() for t in out)

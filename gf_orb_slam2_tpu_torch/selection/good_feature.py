"""Good-feature selection: lazier-greedy Max-logDet active matching.

Replacement for Observability::runActiveMapMatching (reference:
src/Observability.cc:830, IROS18/TRO20 "Good Feature Matching"): instead of
matching every local map point, actively pick the subset that maximizes the
log-determinant of the pose information matrix, under a per-frame budget
(reference: constraints-per-frame, System::SetConstrPerFrame System.cc:444).

Reference mechanics → this design:
- per-round random subset of size ~P/k (lazier greedy, Observability.cc:902)
  → masked uniform sampling from an explicit torch.Generator;
- per-candidate logDet(curMat + ObsMat_i) scoring on 7x7 matrices (:956)
  → one batched logdet over all candidates per round;
- match-then-update sequencing (:982-1025) → selection runs fully on the
  device over predicted info matrices; the selected subset is then matched
  in ONE batched projection search. The wall-clock budget becomes the fixed
  round count (SURVEY.md §7.3).

The greedy round loop is sequential by nature (each pick conditions the next
score). The JAX package runs it as one XLA program (a `lax.scan`,
gf_orb_slam2_tpu/selection/good_feature.py:32); here CUDA tensors go to one
hand-written kernel launch for all rounds (csrc/greedy_select.cu through
ops/greedy_select_cuda.py) and CPU tensors to `lazier_greedy_select_ref`,
the plain PyTorch version: a Python loop whose every decision stays a
tensor. Neither waits for the host. Both take the lazier sample's uniforms
from `lazier_uniforms`, so a seeded generator's stream is consumed the same
way on either path.
"""
from __future__ import annotations

import torch

from gf_orb_slam2_tpu_torch.ops.greedy_select_cuda import greedy_select
from gf_orb_slam2_tpu_torch.ops.select import topk_stable
from gf_orb_slam2_tpu_torch.selection.observability import logdet_psd


def _rounds(n_select: int, batch: int):
    B = max(1, min(batch, n_select))
    return B, -(-n_select // B)


def lazier_uniforms(obs_mats, n_select: int, generator, lazier_factor: int = 10,
                    batch: int = 8):
    """The [rounds,P] U(0,1) draws of the lazier sample, taken from
    `generator` on obs_mats' device and dtype; None for exact greedy
    (lazier_factor <= 1), which draws nothing."""
    if lazier_factor <= 1:
        return None
    _, rounds = _rounds(n_select, batch)
    return torch.rand((rounds, obs_mats.shape[0]), generator=generator,
                      device=obs_mats.device, dtype=obs_mats.dtype)


def lazier_greedy_select(
    obs_mats, valid, n_select: int, generator=None, lazier_factor: int = 10,
    base_mat=None, eps: float = 1e-3, batch: int = 8, uniforms=None,
):
    """Select `n_select` landmarks maximizing logdet(Σ selected ObsMat)
    (arguments and result: `lazier_greedy_select_ref`). CUDA tensors launch
    the selection kernel once (float32, D = 7 or 13: anything else raises);
    CPU tensors run the plain version. The uniforms are drawn here for both,
    by `lazier_uniforms`."""
    if uniforms is None:
        uniforms = lazier_uniforms(obs_mats, n_select, generator, lazier_factor, batch)
    if obs_mats.is_cuda:
        return greedy_select(
            obs_mats.contiguous(), valid.contiguous(), n_select, batch, lazier_factor, eps,
            None if base_mat is None else base_mat.contiguous(),
            None if uniforms is None or lazier_factor <= 1 else uniforms.contiguous())
    return lazier_greedy_select_ref(obs_mats, valid, n_select, generator, lazier_factor,
                                    base_mat, eps, batch, uniforms)


def lazier_greedy_select_ref(
    obs_mats, valid, n_select: int, generator=None, lazier_factor: int = 10,
    base_mat=None, eps: float = 1e-3, batch: int = 8, uniforms=None,
):
    """Plain PyTorch version of the selection (any device): select
    `n_select` landmarks maximizing logdet(Σ selected ObsMat).

    obs_mats: [P,D,D] per-landmark info matrices; valid: [P] candidate mask;
    base_mat: optional [D,D] prior information (current matched set);
    generator: torch.Generator on obs_mats' device for the lazier sampling
    (not needed when lazier_factor <= 1); uniforms: optional [rounds,P]
    pre-drawn U(0,1) numbers used instead of the generator (tests).
    Returns (selected_mask [P] bool, order [n_select] int64 — -1 padding).

    BATCHED greedy: each round scores a random candidate subset once and
    takes the top-`batch` picks before re-conditioning; batching cuts the
    sequential rounds 8x for a negligible logdet gap (the reference's lazier
    subsampling is already an approximation of the same submodular
    objective, Observability.cc:902).
    """
    P, D, _ = obs_mats.shape
    dev, dt = obs_mats.device, obs_mats.dtype
    if base_mat is None:
        base_mat = torch.zeros((D, D), dtype=dt, device=dev)
    eye = torch.eye(D, dtype=dt, device=dev)
    B, rounds = _rounds(n_select, batch)
    inv_l = 1.0 / max(lazier_factor, 1)
    if uniforms is None:
        uniforms = lazier_uniforms(obs_mats, n_select, generator, lazier_factor, batch)

    # cheap fallback score tier; this sum and the one into `cur` run left to
    # right, as the selection kernel (csrc/greedy_select.cu) runs them
    diag = torch.diagonal(obs_mats, dim1=-2, dim2=-1)
    traces = diag[:, 0]
    for i in range(1, D):
        traces = traces + diag[:, i]
    # per-round slot activity: exactly n_select picks across all rounds
    slot_active = (torch.arange(rounds * B, device=dev) < n_select).reshape(rounds, B)
    neg_inf = float("-inf")

    cur = base_mat
    selected = torch.zeros(P, dtype=torch.bool, device=dev)
    order = []
    for k in range(rounds):
        cand = valid & ~selected
        if inv_l < 1.0:
            # lazier sampling as a MASK; a round whose sample misses every
            # remaining candidate scores them all
            sampled = cand & (uniforms[k] < inv_l)
            sampled = torch.where(sampled.any(), sampled, cand)
        else:
            sampled = cand
        trial = cur[None] + obs_mats + eps * eye[None]
        ld = logdet_psd(trial, eps)
        score = torch.where(sampled, ld, neg_inf)
        # fallback tier: unsampled candidates still fill the budget by trace
        # (strictly below any real score)
        fb = torch.where(cand, traces - 1e12, neg_inf)
        vals, pick = topk_stable(torch.maximum(score, fb), B)
        ok = torch.isfinite(vals) & slot_active[k]
        selected = selected.scatter(0, pick, selected[pick] | ok)  # picks are distinct
        picked = ok.to(dt)[:, None, None] * obs_mats[pick]
        add = picked[0]
        for b in range(1, B):
            add = add + picked[b]
        cur = cur + add
        order.append(torch.where(ok, pick, -1))
    return selected, torch.cat(order)[:n_select]


def greedy_select_exact(obs_mats, valid, n_select: int, base_mat=None, eps=1e-3):
    """Exact greedy (lazier_factor=1): scores ALL candidates every round.
    Baseline for the statistical quality tests (reference:
    test/test_Greedy.cpp runs exact as method 1)."""
    return lazier_greedy_select(
        obs_mats, valid, n_select, None, lazier_factor=1, base_mat=base_mat, eps=eps
    )


def selection_logdet(obs_mats, selected_mask, base_mat=None, eps=1e-3):
    """logdet of the information accumulated by a selection."""
    M = torch.sum(obs_mats * selected_mask[:, None, None], 0)
    if base_mat is not None:
        M = M + base_mat
    return logdet_psd(M, eps)


def _mask_of(idx, valid):
    mask = torch.zeros_like(valid)
    mask[idx] = True
    return mask & valid


def random_select(valid, n_select: int, generator=None):
    """Baseline: random subset (reference: runBaselineMapMatching
    Observability.cc:1171, RANDOM_MAP_MATCHING)."""
    P = valid.shape[0]
    scores = torch.rand(P, generator=generator, device=valid.device) + (~valid) * -1e9
    _, idx = topk_stable(scores, n_select)
    return _mask_of(idx, valid), idx


def long_lived_select(lifetime, valid, n_select: int):
    """Baseline: the n longest-tracked landmarks (reference:
    Tracking::LongLivedMatches src/Tracking.cc:1771 /
    LONGLIVED_MAP_MATCHING). lifetime: [P] found-counter or age."""
    scores = torch.where(valid, lifetime.to(torch.float32), float("-inf"))
    _, idx = topk_stable(scores, n_select)
    return _mask_of(idx, valid), idx


def bucketing_select(
    uv, lifetime, valid, n_select: int, width: float, height: float,
    grid: int = 8,
):
    """Baseline: spatially-bucketed budget fill (reference:
    Tracking::BucketingMatches src/Tracking.cc:1666 / BUCKETING_MAP_MATCHING):
    the image is split into grid×grid buckets and every bucket contributes
    its longest-lived candidate before any bucket contributes a second.

    uv: [P,2] predicted pixel positions. Fully batched: the within-bucket
    rank is one stable sort (bucket-major, lifetime-descending) and a
    segmented position count — no per-bucket loops.
    """
    P = valid.shape[0]
    dev = valid.device
    bx = torch.clamp((uv[:, 0] * grid / width).to(torch.int64), 0, grid - 1)
    by = torch.clamp((uv[:, 1] * grid / height).to(torch.int64), 0, grid - 1)
    bucket = by * grid + bx
    life = torch.clamp(lifetime.to(torch.float32), 0.0, 1e5)
    # sort bucket-major, longest-lived first within a bucket
    skey = bucket.to(torch.float32) * 2e5 - life + (~valid) * 1e9
    order = torch.sort(skey, stable=True).indices
    sb = bucket[order]
    pos = torch.arange(P, device=dev)
    new_grp = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sb[1:] != sb[:-1]])
    grp_start = torch.cummax(torch.where(new_grp, pos, 0), 0).values
    rank = torch.zeros(P, dtype=torch.int64, device=dev)
    rank[order] = pos - grp_start  # in-bucket rank
    prio = torch.where(valid, -rank.to(torch.float32) * 2e5 + life, float("-inf"))
    _, idx = topk_stable(prio, n_select)
    return _mask_of(idx, valid), idx

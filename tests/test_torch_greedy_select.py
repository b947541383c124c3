"""The lazier-greedy selection's plain version (selection/good_feature.py
`lazier_greedy_select_ref`) against the JAX package's `lazier_greedy_select`
on the CPU, and the wrapper around its CUDA kernel (csrc/greedy_select.cu
through ops/greedy_select_cuda.py).

Both packages get the same numpy matrices, made from a seed, with
`lazier_factor=1` (exact greedy: no draws, so JAX's threefry stream plays no
part). The matrices are well separated (random PSD, condition ~10): the
logdet scores carry float32 noise of ~1e-6 against gaps of ~1e-2, so
selections and orders must be identical, as in
tests/test_torch_tracking_step.py::test_greedy_exact_identical_selection.
Duplicated matrices tie exactly within each package: both take the lower
slot first.

The kernel has no CPU mode: its checks against the plain version are the
`cuda` tests below (`python -m pytest tests/test_torch_greedy_select.py -m
cuda` on a machine with a card) and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu.selection import good_feature as jgf
from gf_orb_slam2_tpu_torch.ops import cuda_lib, greedy_select_cuda
from gf_orb_slam2_tpu_torch.selection import good_feature as tgf
from gf_orb_slam2_tpu_torch.selection.observability import logdet_psd

torch.set_num_threads(1)


def _matrices(seed, n, d, duplicate=False):
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 1, (n, d, d)).astype(np.float32)
    M = (A @ A.transpose(0, 2, 1) / d + np.eye(d, dtype=np.float32)).astype(np.float32)
    M *= rng.uniform(0.5, 2.0, (n, 1, 1)).astype(np.float32)
    if duplicate:  # every odd slot a copy of the even slot before it
        M[1::2] = M[0::2][: n // 2]
    valid = rng.random(n) < 0.85
    return M, valid, M[:5].sum(0)


def _both(M, valid, n_select, base):
    want = jgf.lazier_greedy_select(
        jnp.asarray(M), jnp.asarray(valid), n_select, jax.random.PRNGKey(0), lazier_factor=1,
        base_mat=None if base is None else jnp.asarray(base))
    got = tgf.lazier_greedy_select_ref(
        torch.from_numpy(M), torch.from_numpy(valid), n_select, None, lazier_factor=1,
        base_mat=None if base is None else torch.from_numpy(base))
    return got, want


def _equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("with_base", [True, False], ids=["base", "no_base"])
@pytest.mark.parametrize("d", [7, 13])
def test_exact_greedy_matches_jax(d, with_base):
    """D = 7 (the pose) and 13 (the hybrid state), 37 picks: four full
    rounds of 8 and a round with 5 slots."""
    M, valid, base = _matrices(40 + d, 240, d)
    got, want = _both(M, valid, 37, base if with_base else None)
    _equal(got, want)
    assert int(got[0].sum()) == 37 and (got[1] >= 0).all()


def test_duplicated_matrices_take_the_lower_slot_first():
    """Equal scores: the stable top-B of both packages takes the lower slot
    first, so a pair's copy follows its original within a round."""
    M, valid, base = _matrices(47, 200, 7, duplicate=True)
    valid[:] = True
    got, want = _both(M, valid, 40, base)
    _equal(got, want)
    order = got[1].tolist()
    pairs = [p for p in order if p % 2 == 0 and p + 1 in order]
    assert pairs, "no duplicated pair was picked"
    for p in pairs:
        assert order.index(p) < order.index(p + 1)


def test_pool_smaller_than_the_budget():
    """12 candidates for 30 picks: all 12 taken, the rest of the order -1."""
    M, _, base = _matrices(48, 60, 7)
    valid = np.arange(60) < 12
    got, want = _both(M, valid, 30, base)
    _equal(got, want)
    assert int(got[0].sum()) == 12 and int((got[1] == -1).sum()) == 18


THREADS = 512   # csrc/greedy_select.cu's block, at both widths
WARPS = THREADS // 32
RANK_MAX = 128  # lists the kernel ranks at once; longer ones take B warp arg-maxima
SPLIT_MAX = {7: 64, 13: 96}  # lists scored by groups of lanes; longer ones, a lane each


def _key_hi(v):
    """The high half of the kernel's sort key of float32 v."""
    if v != v:
        return 0xFFFFFFFE
    bits = int(np.array([0.0 if v == 0 else v], np.float32).view(np.uint32)[0])
    return (~bits & 0xFFFFFFFF) if bits & 0x80000000 else bits | 0x80000000


def _slot_key(hi, p):
    return (hi << 32) | (0xFFFFFFFF - p)


def _finite(hi):
    bits = (hi & 0x7FFFFFFF) if hi & 0x80000000 else (~hi & 0xFFFFFFFF)
    return bool(np.isfinite(np.array([bits], np.uint32).view(np.float32)[0]))


def _kernel_schedule(M, valid, n_select, lazier, base, uniforms, eps=1e-3, batch=8, seed=0):
    """csrc/greedy_select.cu's rounds, written out on the CPU with its split
    of the work over 512 threads (thread t owns slots t + 512 r).

    At entry, each candidate's fallback key (trace - 1e12). Each round:
    every thread flags its sampled candidates and keeps its largest
    unsampled fallback key (tfb[t]; F is the largest of all); the warps
    append their threads' sampled slots to the list in the order their
    atomics land (drawn from `seed`), every candidate when no thread sampled
    one; a listed slot's key is max(logdet, trace - 1e12)'s. A list of <=
    RANK_MAX ranks its keys, entry j on thread j: rank r < B fills place r,
    and the n_above keys above F settle their places, c = min(n_above, B).
    The places from c to B (all B for a longer list) are warp 0's arg-maxima,
    each below the last: lane l's largest listed key (entries l + 32 i) below
    the bound, or its threads' (l + 32 i) fallback keys, the taken one's
    thread rescanned below it. A pick counts when its value is finite and its
    place within n_select; cur += the counted picks, left to right.

    The scores are the plain version's logdets: this holds the schedule (the
    card's tests hold the arithmetic). Returns selected, order and, per
    round, the branches the kernel took."""
    P, D, _ = M.shape
    B = max(1, min(batch, n_select))
    rounds = -(-n_select // B)
    inv_l = 1.0 / max(lazier, 1)
    rng = np.random.default_rng(seed)
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    traces = diag[:, 0]
    for i in range(1, D):
        traces = traces + diag[:, i]
    fb = traces - 1e12
    fbk = [_key_hi(v) if valid[p] else 0 for p, v in enumerate(fb.tolist())]
    slots = [range(t, P, THREADS) for t in range(THREADS)]
    cur = torch.zeros((D, D)) if base is None else base
    eye = torch.eye(D)
    selected = torch.zeros(P, dtype=torch.bool)
    order, branches = [], []
    ranked = [0] * B  # shared memory: kept from round to round, as on the card

    def thread_fallback(t, sampled, bound):
        return max((_slot_key(fbk[p], p) for p in slots[t]
                    if fbk[p] and not sampled[p] and _slot_key(fbk[p], p) < bound), default=0)

    def compact(u):
        sampled = [fbk[p] != 0 and (u is None or float(u[p]) < inv_l) for p in range(P)]
        tfb = [thread_fallback(t, sampled, 1 << 64) for t in range(THREADS)]
        chunks = [[p for t in range(32 * w, 32 * w + 32) for p in slots[t] if sampled[p]]
                  for w in range(WARPS)]
        return sampled, tfb, [p for w in rng.permutation(WARPS) for p in chunks[w]]

    for k in range(rounds):
        u = None if uniforms is None else uniforms[k]
        sampled, tfb, listed = compact(u)
        if not listed and u is not None:  # the sample missed every candidate
            sampled, tfb, listed = compact(None)
        ld = logdet_psd(cur[None] + M + eps * eye[None], eps)
        score = torch.maximum(ld, fb).tolist()
        lk = [_slot_key(_key_hi(score[p]), p) for p in listed]
        nl = len(lk)
        n_above = 0
        if nl <= RANK_MAX:
            F = max(tfb)
            for key in lk:
                rank = sum(other > key for other in lk)
                if rank < B:
                    ranked[rank] = key
                n_above += key > F
        c = min(n_above, B) if nl <= RANK_MAX else 0
        taken_from_fallback = 0
        if c < B:
            def best_listed(lane, bound):
                return max((lk[j] for j in range(lane, nl, 32) if lk[j] < bound), default=0)

            lm = [best_listed(lane, ranked[c - 1] if c else (1 << 64) - 1) for lane in range(32)]
            fh = [[tfb[lane + 32 * i] for i in range(WARPS)] for lane in range(32)]
            for b in range(c, B):
                w = max(max(lm[lane], *fh[lane]) for lane in range(32))
                ranked[b] = w
                for lane in range(32):
                    if w and lm[lane] == w:
                        lm[lane] = best_listed(lane, w)
                    elif w and max(fh[lane]) == w:
                        taken_from_fallback += 1
                        fh[lane] = [thread_fallback(lane + 32 * i, sampled, w) if f == w else f
                                    for i, f in enumerate(fh[lane])]
        branches.append({"listed": nl, "scored_by_lane": nl > SPLIT_MAX[D],
                         "ranked": nl <= RANK_MAX, "settled": c,
                         "from_fallback": taken_from_fallback})
        add = torch.zeros((D, D))
        for b in range(B):
            key = ranked[b]
            ok = key != 0 and _finite(key >> 32) and k * B + b < n_select
            p = 0xFFFFFFFF - (key & 0xFFFFFFFF)
            order.append(p if ok else -1)
            if ok:
                selected[p] = True
                fbk[p] = 0
                add = add + M[p]
        cur = cur + add
    return selected, torch.tensor(order[:n_select], dtype=torch.int64), branches


def _with_nan_scores(M, slots):
    """Finite matrices whose trial logdet is NaN at the first round: the
    identity with four huge off-diagonal entries (found by a seeded search
    against this case's base) whose Cholesky products overflow to +-inf and
    then meet (inf - inf)."""
    M = M.copy()
    for p in slots:
        M[p] = np.eye(M.shape[-1], dtype=np.float32)
        for i, j, v in ((5, 0, -2.6207638e26), (2, 3, 1.3139513e27), (1, 4, -3.3843261e32),
                        (5, 4, -9.2880854e26)):
            M[p, i, j] = M[p, j, i] = v
    return M


# each case: what the kernel's branches must have done in at least one round
# (settled: places the ranks settled; from_fallback: places the unsampled
# candidates' fallback tier filled)
SCHEDULE_CASES = {
    "d7": lambda r: r["ranked"] and r["settled"] == 8 and r["scored_by_lane"],
    "d13": lambda r: r["ranked"] and r["settled"] == 8 and not r["scored_by_lane"],
    "duplicated": lambda r: r["ranked"] and r["settled"] == 8,
    "small_pool": lambda r: 0 < r["settled"] < 8 and r["from_fallback"] > 0,
    "no_sample": lambda r: r["listed"] == 30,
    "few_sampled": lambda r: 0 < r["settled"] < 8 and r["from_fallback"] > 0,
    "nan_scores": lambda r: not r["ranked"] and r["settled"] == 0,
    "nan_ranked": lambda r: r["ranked"] and r["settled"] == 8,
    "exact": lambda r: not r["ranked"] and r["listed"] > 900,
    "exact_d13": lambda r: not r["ranked"] and r["listed"] > 900,
    "long_lazier": lambda r: not r["ranked"] and r["listed"] < 600,
    "one_thread_fallback": lambda r: r["settled"] == 1 and r["from_fallback"] == 5,
}


def _schedule_case(case, device="cpu"):
    """The inputs of SCHEDULE_CASES' case: matrices, valid, base, n_select,
    lazier, uniforms."""
    d, n, n_select, lazier, dup = 7, 1200, 40, 10, False
    if case in ("d13", "exact_d13"):
        d = 13
    if case == "duplicated":
        dup = True
    M, valid, base = _matrices(70 + len(case), n, d, duplicate=dup)
    if case == "small_pool":
        valid = np.arange(n) < 12
    if case == "no_sample":
        valid, lazier = np.arange(n) < 30, 1000
    if case == "few_sampled":
        lazier = 300
    if case.startswith("nan"):  # exact greedy: the NaN slots are scored every round
        M, lazier = _with_nan_scores(M, [0, 513, 1100]), 1
        if case == "nan_ranked":  # 100 candidates: a list the ranks take
            valid = np.arange(n) < 97
        valid[[0, 513, 1100]] = True
    if case in ("exact", "exact_d13"):
        lazier = 1
    if case == "long_lazier":
        lazier = 2
    if case == "one_thread_fallback":  # 6 candidates on threads 3 and 4, slot 3 sampled
        valid = np.isin(np.arange(n) % THREADS, (3, 4))
    Mt, vt, bt = (torch.from_numpy(a).to(device) for a in (M, valid, base))
    u = tgf.lazier_uniforms(Mt, n_select, torch.Generator(device=device).manual_seed(5), lazier)
    if case == "one_thread_fallback":  # the fallback tier rescans a thread it took from
        u = torch.ones_like(u)
        u[:, 3] = 0.0
    return Mt, vt, bt, n_select, lazier, u


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_compacted_warp_schedule_equals_plain_version(case):
    """The kernel's round schedule picks what the plain version picks, in the
    same order, whatever order the warps' atomics give the list: D = 7 and
    13 at lazier 10 (lists of ~100, ranked; D = 13's scored by lane groups),
    duplicated matrices (the lower slot first), a pool smaller than the
    budget (-1 padding), rounds whose sample misses every candidate (all
    listed), rounds with fewer sampled candidates than picks (n_above < B:
    the fallback tier fills the rest, by trace), NaN scores (first in the
    order, never counted; slot 0 among them) in lists above RANK_MAX and in
    ranked lists, exact greedy at both widths and lazier 2 (lists above
    RANK_MAX: B warp arg-maxima), and five places filled from two threads'
    fallback tiers (each taken key's thread rescanned below it)."""
    Mt, vt, bt, n_select, lazier, u = _schedule_case(case)
    d = Mt.shape[-1]
    want = tgf.lazier_greedy_select_ref(Mt, vt, n_select, None, lazier, bt, uniforms=u)
    for seed in (0, 1):
        sel, order, branches = _kernel_schedule(Mt, vt, n_select, lazier, bt, u, seed=seed)
        assert torch.equal(sel, want[0]) and torch.equal(order, want[1]), (case, seed)
    assert any(SCHEDULE_CASES[case](r) for r in branches), (case, branches)
    if case.startswith("nan"):
        cur = bt + 1e-3 * torch.eye(d)
        assert torch.isnan(logdet_psd(cur[None] + Mt[[0, 513, 1100]], 1e-3)).all()
        assert not {0, 513, 1100} & set(want[1].tolist())
        assert int((want[1] == -1).sum()) >= 3  # the NaN places of round one
    if case in ("small_pool", "no_sample"):
        assert int((want[1] == -1).sum()) == n_select - int(vt.sum()) or case == "no_sample"


def test_dispatch_on_cpu_is_the_plain_version():
    """CPU tensors go to the plain version: the same picks, bit for bit, from
    the same seed (the draws are taken once, by `lazier_uniforms`)."""
    M, valid, base = (torch.from_numpy(a) for a in _matrices(49, 500, 7))
    got = tgf.lazier_greedy_select(M, valid, 40, torch.Generator().manual_seed(3),
                                   lazier_factor=10, base_mat=base)
    want = tgf.lazier_greedy_select_ref(M, valid, 40, torch.Generator().manual_seed(3),
                                        lazier_factor=10, base_mat=base)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_uniform_draws_consume_the_generator_as_before():
    """`lazier_uniforms` draws [rounds, P] from the generator exactly as the
    selection always did (`torch.rand((rounds, P), generator=...)`), so every
    later draw of a run is unchanged; exact greedy draws nothing."""
    M = torch.zeros((300, 7, 7))
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    u = tgf.lazier_uniforms(M, 37, g1, lazier_factor=10)
    assert torch.equal(u, torch.rand((5, 300), generator=g2))
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    assert tgf.lazier_uniforms(M, 37, g1, lazier_factor=1) is None
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    # a whole selection leaves the stream where the old code left it
    M, valid, base = (torch.from_numpy(a) for a in _matrices(50, 300, 7))
    tgf.lazier_greedy_select(M, valid, 37, g1, lazier_factor=10, base_mat=base)
    torch.rand((5, 300), generator=g2)
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))


def test_kernel_entry_refuses_float64_and_cpu_tensors(monkeypatch):
    """TypeError on float64, ValueError on a float32 CPU tensor — before any
    build, and no launch is counted."""
    def refuse(*a, **k):
        raise AssertionError("the kernel library was built before the checks")

    monkeypatch.setattr(cuda_lib, "load", refuse)
    monkeypatch.setattr(cuda_lib, "build", refuse)
    M, valid, base = (torch.from_numpy(a) for a in _matrices(51, 40, 7))
    before = dict(cuda_lib.launch_counts)
    with pytest.raises(TypeError):
        greedy_select_cuda.greedy_select(M.double(), valid, 16, 8, 1, 1e-3, base.double())
    with pytest.raises(ValueError, match="CUDA"):
        greedy_select_cuda.greedy_select(M, valid, 16, 8, 1, 1e-3, base)
    assert cuda_lib.launch_counts == before


# ---- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("d", [7, 13])
def test_kernel_equals_plain_version_on_the_card(d):
    """The kernel against the plain version on the same uniforms, one launch
    each. Small pools (exact greedy, lazier, duplicated slots): the same
    picks in the same order. The main path's 4096 slots at 160 picks, a
    sample too thin for the budget (lazier 100: the fallback tier fills the
    rounds) and the kernel's cap on P: held by ≥ 97 % common picks and the
    objective within 1e-4 (a near-tie a few ulps apart could swap two
    picks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    cap = greedy_select_cuda.MAX_SLOTS  # the kernel's cap: 4x the largest pool any path passes
    for seed, n, n_select, lazier, dup in ((60, 4096, 160, 10, False), (61, 300, 37, 1, False),
                                           (62, 200, 40, 1, True), (63, 60, 30, 4, False),
                                           (64, cap, 160, 10, False), (65, 4096, 160, 100, False)):
        M, valid, base = (torch.from_numpy(a).to(dev) for a in _matrices(seed, n, d, dup))
        u = tgf.lazier_uniforms(M, n_select, torch.Generator(device=dev).manual_seed(seed), lazier)
        before = cuda_lib.launch_counts["greedy_select"]
        got = tgf.lazier_greedy_select(M, valid, n_select, None, lazier, base, uniforms=u)
        assert cuda_lib.launch_counts["greedy_select"] == before + 1
        want = tgf.lazier_greedy_select_ref(M, valid, n_select, None, lazier, base, uniforms=u)
        if n < 4096:
            assert torch.equal(got[0], want[0]), (seed, d)
            assert torch.equal(got[1], want[1]), (seed, d)
            continue
        assert int(got[0].sum()) == int(want[0].sum()) == n_select
        assert int((got[0] & want[0]).sum()) >= 0.97 * n_select
        obj_got = float(tgf.selection_logdet(M, got[0], base))
        obj_want = float(tgf.selection_logdet(M, want[0], base))
        assert abs(obj_got - obj_want) <= 1e-4 * abs(obj_want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nan_scores", "nan_ranked", "one_thread_fallback"])
def test_kernel_schedule_cases_on_the_card(case):
    """The CPU schedule cases whose branches real frames seldom take, on the
    kernel: NaN scores with slot 0's among them, in a list the warp
    arg-maxima take and in one the ranks take (NaN first, never counted),
    and places filled from one thread's fallback tier. The picks and order
    equal the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    M, valid, base, n_select, lazier, u = _schedule_case(case, "cuda")
    got = tgf.lazier_greedy_select(M, valid, n_select, None, lazier, base, uniforms=u)
    want = tgf.lazier_greedy_select_ref(M, valid, n_select, None, lazier, base, uniforms=u)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), case

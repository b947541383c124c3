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
    picks in the same order. The main path's 4096 slots at 160 picks: the
    two sum `cur` in other orders, so a near-tie (scores ~1e-6 apart) can
    swap two picks: held by ≥ 97 % common picks and the objective within
    1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    for seed, n, n_select, lazier, dup in ((60, 4096, 160, 10, False), (61, 300, 37, 1, False),
                                           (62, 200, 40, 1, True), (63, 60, 30, 4, False)):
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

"""Parity of the port's Hamming matching primitives with the JAX package.

All comparisons are exact: the outputs are integers. The JAX Pallas kernel
runs in interpret mode, as in tests/test_pallas_kernels.py; the port runs its
plain PyTorch versions (the CUDA kernels have no CPU mode — they are held
against the plain versions on the card by chip_smoke.py and the `cuda` tests
below).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu.matching import hamming as jham
from gf_orb_slam2_tpu.ops.pallas_hamming import distance_matrix_pallas
from gf_orb_slam2_tpu_torch.matching import hamming as tham
from gf_orb_slam2_tpu_torch.ops import hamming_cuda

torch.set_num_threads(1)


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def _t(d):
    return torch.from_numpy(d.view(np.int32))


def _np_hamming(a, b):
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.int32)


def test_plain_version_matches_pallas_interpret_tiled():
    rng = np.random.default_rng(0)
    a, b = _desc(rng, 256), _desc(rng, 512)
    want = np.asarray(distance_matrix_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = hamming_cuda.hamming_distance_matrix_ref(_t(a), _t(b))
    assert got.dtype == torch.int32 and got.shape == (256, 512)
    np.testing.assert_array_equal(got.numpy(), want)


def test_distance_matrix_matches_reference_ragged():
    rng = np.random.default_rng(1)
    a, b = _desc(rng, 100), _desc(rng, 70)
    want = np.asarray(jham.distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = tham.distance_matrix(_t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,m", [(1, 1), (0, 5), (5, 0), (300, 3), (257, 129)])
def test_plain_version_any_shape(n, m):
    rng = np.random.default_rng(n * 1000 + m)
    a, b = _desc(rng, n), _desc(rng, m)
    got = hamming_cuda.hamming_distance_matrix_ref(_t(a), _t(b))
    assert got.shape == (n, m) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np_hamming(a, b))


def test_extreme_bit_patterns():
    z = np.zeros((2, 8), np.uint32)
    o = np.full((3, 8), 0xFFFFFFFF, np.uint32)
    got = tham.distance_matrix(_t(np.concatenate([z, o])), _t(np.concatenate([z, o]))).numpy()
    want = np.zeros((5, 5), np.int32)
    want[:2, 2:] = 256
    want[2:, :2] = 256
    np.testing.assert_array_equal(got, want)


def test_distance_pairs_matches_reference():
    rng = np.random.default_rng(2)
    a, b = _desc(rng, 64), _desc(rng, 64)
    want = np.asarray(jham.distance_pairs(jnp.asarray(a), jnp.asarray(b)))
    got = tham.distance_pairs(_t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), want)


def _tie_case(rng, n=48, m=40):
    """Distances from a tiny value range (many ties per row), a random mask,
    and three fully masked rows."""
    dist = rng.integers(20, 26, (n, m)).astype(np.int32)
    mask = rng.random((n, m)) < 0.4
    mask[[3, 17, 40]] = False
    return dist, mask


def test_masked_best2_ties_and_masked_rows():
    dist, mask = _tie_case(np.random.default_rng(3))
    wi, wb, ws = (np.asarray(x) for x in jham.masked_best2(jnp.asarray(dist), jnp.asarray(mask)))
    gi, gb, gs = tham.masked_best2(torch.from_numpy(dist), torch.from_numpy(mask))
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(gb.numpy(), wb)
    np.testing.assert_array_equal(gs.numpy(), ws)
    assert (gb.numpy()[[3, 17, 40]] == tham.MAX_DIST).all()


def test_resolve_duplicates_matches_reference():
    rng = np.random.default_rng(4)
    n, m = 60, 12  # many rows per column → many duplicates, equal distances
    best_idx = rng.integers(0, m, n).astype(np.int32)
    best = rng.integers(10, 14, n).astype(np.int32)
    accept = rng.random(n) < 0.8
    want = np.asarray(jham.resolve_duplicates(
        jnp.asarray(best_idx), jnp.asarray(best), jnp.asarray(accept), m))
    got = tham.resolve_duplicates(
        torch.from_numpy(best_idx), torch.from_numpy(best), torch.from_numpy(accept), m)
    np.testing.assert_array_equal(got.numpy(), want)
    # one-to-one: every column is claimed at most once
    cols = best_idx[got.numpy()]
    assert len(set(cols.tolist())) == len(cols)


def test_kernel_wrapper_refuses_cpu_tensors():
    """No silent fallback: the kernel's wrapper launches or raises."""
    a = _t(_desc(np.random.default_rng(5), 4))
    before = dict(hamming_cuda.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        hamming_cuda.hamming_distance_matrix(a, a)
    assert hamming_cuda.launch_counts == before


@pytest.mark.parametrize("bad", [
    torch.zeros((4, 7), dtype=torch.int32),
    torch.zeros((4, 8), dtype=torch.int64),
    torch.zeros((8,), dtype=torch.int32),
])
def test_wrapper_input_checks(bad):
    good = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        hamming_cuda.hamming_distance_matrix(bad, good)
    with pytest.raises((ValueError, TypeError)):
        hamming_cuda.hamming_distance_matrix_ref(good, bad)


def test_cpu_path_never_counts_a_launch():
    rng = np.random.default_rng(6)
    hamming_cuda.reset_launch_counts()
    a, b = _t(_desc(rng, 8)), _t(_desc(rng, 8))
    tham.distance_matrix(a, b)
    tham.distance_best2(a, b, torch.ones((8, 8), dtype=torch.bool))
    # one counter for every kernel of the port (ops/cuda_lib.py)
    assert hamming_cuda.launch_counts == {"hamming_distance_matrix": 0,
                                          "hamming_masked_best2": 0,
                                          "pose_lm": 0, "greedy_select": 0,
                                          "obs_info": 0}


# ---- the fused form: best two matches per row without the matrix

def _jax_best2(a, b, mask, pallas):
    """The JAX pair the fused form replaces; the matrix from the Pallas kernel
    in interpret mode (tiled shapes) or from the XLA path (any shape)."""
    if pallas:
        dist = distance_matrix_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    else:
        dist = jham.distance_matrix(jnp.asarray(a), jnp.asarray(b))
    return [np.asarray(x) for x in jham.masked_best2(dist, jnp.asarray(mask))]


def _mask(rng, kind, n, m):
    if kind == "all_true":
        return np.ones((n, m), bool)
    mask = rng.random((n, m)) < {"sparse": 0.02, "dense": 0.4, "rows_masked": 0.4}[kind]
    if kind == "rows_masked":
        mask[::3] = False
    return mask


def _assert_best2(got, want):
    gi, gb, gs = got
    assert gi.dtype == torch.int64 and gb.dtype == torch.int32 and gs.dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("fn", ["hamming_masked_best2_ref", "distance_best2"])
@pytest.mark.parametrize("kind", ["sparse", "dense", "all_true", "rows_masked"])
@pytest.mark.parametrize("n,m,pallas", [(256, 512, True), (100, 70, False)])
def test_best2_matches_reference_pair(n, m, pallas, kind, fn):
    rng = np.random.default_rng(100 + n)
    a, b = _desc(rng, n), _desc(rng, m)
    mask = _mask(rng, kind, n, m)
    want = _jax_best2(a, b, mask, pallas)
    f = getattr(hamming_cuda, fn, None) or getattr(tham, fn)
    _assert_best2(f(_t(a), _t(b), torch.from_numpy(mask)), want)
    if kind == "rows_masked":
        assert (want[1][::3] == tham.MAX_DIST).all() and (want[0][::3] == 0).all()


@pytest.mark.parametrize("kind", ["dense", "all_true"])
def test_best2_duplicate_descriptors_tie_to_lowest_column(kind):
    """Descriptors drawn from a pool of six: equal distances in a row, so the
    lowest column must win and `second == best` must occur."""
    rng = np.random.default_rng(8)
    pool = _desc(rng, 6)
    a, b = pool[rng.integers(0, 6, 90)], pool[rng.integers(0, 4, 75)]
    mask = _mask(rng, kind, 90, 75)
    want = _jax_best2(a, b, mask, pallas=False)
    assert (want[1] == want[2]).any()
    _assert_best2(tham.distance_best2(_t(a), _t(b), torch.from_numpy(mask)), want)


@pytest.mark.parametrize("n,m", [(7, 1), (5, 0), (0, 5), (1, 1)])
def test_best2_degenerate_shapes(n, m):
    rng = np.random.default_rng(9)
    a, b = _desc(rng, n), _desc(rng, m)
    mask = np.ones((n, m), bool)
    gi, gb, gs = tham.distance_best2(_t(a), _t(b), torch.from_numpy(mask))
    assert gi.shape == gb.shape == gs.shape == (n,)
    assert gi.dtype == torch.int64 and gb.dtype == torch.int32 and gs.dtype == torch.int32
    if m == 0:
        assert (gi == 0).all() and (gb == tham.MAX_DIST).all() and (gs == tham.MAX_DIST).all()
    elif n:
        want = _jax_best2(a, b, mask, pallas=False)
        _assert_best2((gi, gb, gs), want)
        if m == 1:
            assert (gs == tham.MAX_DIST).all()


def test_best2_unmasked_distance_256_ties_with_masked_entries():
    z = np.zeros((2, 8), np.uint32)
    o = np.full((3, 8), 0xFFFFFFFF, np.uint32)
    d = np.concatenate([z, o])
    mask = np.eye(5, dtype=bool)[::-1].copy()  # rows 0,1 see only all-ones columns
    want = _jax_best2(d, d, mask, pallas=False)
    _assert_best2(tham.distance_best2(_t(d), _t(d), torch.from_numpy(mask)), want)
    assert want[1][0] == 256 and want[0][0] == 0


def test_best2_wrapper_refuses_cpu_tensors():
    a = _t(_desc(np.random.default_rng(10), 4))
    before = dict(hamming_cuda.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        hamming_cuda.hamming_masked_best2(a, a, torch.ones((4, 4), dtype=torch.bool))
    assert hamming_cuda.launch_counts == before


@pytest.mark.parametrize("mask,err", [
    (torch.ones((4, 5), dtype=torch.bool), ValueError),
    (torch.ones((4,), dtype=torch.bool), ValueError),
    (torch.ones((4, 4), dtype=torch.uint8), TypeError),
    (torch.ones((4, 4), dtype=torch.int32), TypeError),
])
def test_best2_mask_checks(mask, err):
    a = torch.zeros((4, 8), dtype=torch.int32)
    before = dict(hamming_cuda.launch_counts)
    with pytest.raises(err, match="mask"):
        hamming_cuda.hamming_masked_best2(a, a, mask)
    with pytest.raises(err, match="mask"):
        hamming_cuda.hamming_masked_best2_ref(a, a, mask)
    assert hamming_cuda.launch_counts == before


def test_best2_refuses_too_many_columns():
    """The key d*M + column must fit 32 bits: M < 2**22."""
    m = hamming_cuda.MAX_COLUMNS
    a = torch.zeros((1, 8), dtype=torch.int32)
    b = a.expand(m, 8)  # a view: the shape is refused before anything is read
    before = dict(hamming_cuda.launch_counts)
    with pytest.raises(ValueError, match="M <"):
        hamming_cuda.hamming_masked_best2(a, b, torch.ones((1, m), dtype=torch.bool))
    assert hamming_cuda.launch_counts == before


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_version_on_the_card():
    """Needs an NVIDIA GPU and nvcc; run on the card with
    `python -m pytest tests/test_torch_hamming.py -m cuda`."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    rng = np.random.default_rng(7)
    for n, m in [(1024, 1024), (1000, 777), (1, 1)]:
        a, b = _t(_desc(rng, n)).cuda(), _t(_desc(rng, m)).cuda()
        got = hamming_cuda.hamming_distance_matrix(a, b)
        want = hamming_cuda.hamming_distance_matrix_ref(a, b)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_best2_kernel_equals_plain_version_on_the_card():
    """Needs an NVIDIA GPU and nvcc; run on the card with
    `python -m pytest tests/test_torch_hamming.py -m cuda`."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    rng = np.random.default_rng(11)
    for n, m in [(1024, 1024), (1000, 777), (5, 1), (1, 1)]:
        a, b = _t(_desc(rng, n)).cuda(), _t(_desc(rng, m)).cuda()
        for kind in ("sparse", "dense", "all_true", "rows_masked"):
            mask = torch.from_numpy(_mask(rng, kind, n, m)).cuda()
            got = hamming_cuda.hamming_masked_best2(a, b, mask)
            want = hamming_cuda.hamming_masked_best2_ref(a, b, mask)
            assert all(torch.equal(g, w) for g, w in zip(got, want))

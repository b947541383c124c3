"""Parity of the port's Hamming matching primitives with the JAX package.

All comparisons are exact: the outputs are integers. The JAX Pallas kernel
runs in interpret mode, as in tests/test_pallas_kernels.py; the port runs its
plain PyTorch version (the CUDA kernel has no CPU mode — it is held against
the plain version on the card by chip_smoke.py and the `cuda` test below).
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
    tham.distance_matrix(_t(_desc(rng, 8)), _t(_desc(rng, 8)))
    assert hamming_cuda.launch_counts == {"hamming_distance_matrix": 0}


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

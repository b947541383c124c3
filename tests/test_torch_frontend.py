"""Parity of the port's frontend (FAST, selection, ORB, extractor, stereo
matching) with the JAX package on the CPU, same numpy inputs to both.

Integer outputs (positions, octaves, validity, match masks) are exact.
Tolerances, each stated where it is used: pyramid levels 5e-3 grey levels,
angles 1e-4 rad, descriptors ≥ 99.5 % equal bits, u_right 1e-3 px, depth
1e-3 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu.config import ORBConfig as JORBConfig
from gf_orb_slam2_tpu.features import extractor as jext
from gf_orb_slam2_tpu.matching import stereo as jstereo
from gf_orb_slam2_tpu.ops import fast as jfast, orb as jorb, select as jselect
from gf_orb_slam2_tpu_torch.config import ORBConfig as TORBConfig
from gf_orb_slam2_tpu_torch.features import extractor as text
from gf_orb_slam2_tpu_torch.matching import stereo as tstereo
from gf_orb_slam2_tpu_torch.ops import fast as tfast, orb as torb, select as tselect
from tests.rendered_world import RoomWorld, trajectory_tour

torch.set_num_threads(1)

H, W = 160, 208
FX = 150.0


# ---------------------------------------------------------------- constants
@pytest.mark.parametrize("name", ["brief_pattern", "_gauss_kernel", "_sample_matrix"])
def test_constants_bit_equal(name):
    want, got = getattr(jorb, name)(), getattr(torb, name)()
    assert want.dtype == got.dtype and want.shape == got.shape
    assert np.array_equal(want, got)


def test_ic_kernels_bit_equal():
    for want, got in zip(jorb._ic_kernels(), torb._ic_kernels()):
        assert np.array_equal(want, got)


def test_sample_coords_reproduce_sample_matrix_columns():
    """The coordinates the port samples through are those of the lookup
    matrix: column (bin, s) of S holds the 7x7 taps at (py, px)[bin, s]."""
    S = torb._sample_matrix()
    py, px = torb._sample_coords()
    g = torb._gauss_kernel()
    G = np.outer(g, g)
    rng = np.random.default_rng(0)
    for b, s in zip(rng.integers(0, 32, 20), rng.integers(0, 512, 20)):
        col = S[:, b * 512 + s].reshape(37, 37)
        want = np.zeros((37, 37), np.float32)
        want[py[b, s]:py[b, s] + 7, px[b, s]:px[b, s] + 7] = G
        np.testing.assert_array_equal(col, want)


def test_level_layout_equal():
    for n, lv, sc in [(800, 8, 1.2), (200, 4, 1.2), (1000, 6, 1.5)]:
        assert text.features_per_level(n, lv, sc) == jext.features_per_level(n, lv, sc)
        assert text.level_sizes(480, 640, lv, sc) == jext.level_sizes(480, 640, lv, sc)


def test_pack_bits_matches_uint32_packing():
    rng = np.random.default_rng(1)
    bits = rng.random((50, 256)) < 0.5
    bits[0] = True  # all-ones words: the int32 sign bit carries bit 31
    want = (bits.reshape(50, 8, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    got = torb.pack_bits(torch.from_numpy(bits)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- FAST and selection
def _tie_image(rng, shape=(3, 64, 80)):
    """Integer-valued image from few grey levels: V-scores tie everywhere."""
    return (rng.integers(0, 6, shape) * 40).astype(np.float32)


def test_fast_detect_exact_on_integer_image():
    img = _tie_image(np.random.default_rng(2))
    hl = np.array([64, 50, 40], np.int32)
    wl = np.array([80, 66, 52], np.int32)
    ws, wk = jfast.detect(jnp.asarray(img), 7.0, 16, (jnp.asarray(hl), jnp.asarray(wl)))
    gs, gk = tfast.detect(torch.from_numpy(img), 7.0, 16,
                          (torch.from_numpy(hl), torch.from_numpy(wl)))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    assert gk.any()


def test_cell_topk_and_ranked_topn_exact_with_ties():
    rng = np.random.default_rng(3)
    img = _tie_image(rng, (70, 90))
    score, keep = jfast.detect(jnp.asarray(img), 7.0, 3)
    want = jselect.cell_topk(score, keep, 32, 4)
    got = tselect.cell_topk(torch.from_numpy(np.array(score)),
                            torch.from_numpy(np.array(keep)), 32, 4)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want_n = jselect.ranked_topn(*want, 30)
    got_n = tselect.ranked_topn(*got, 30)
    for w, g in zip(want_n, got_n):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_topk_stable_lowest_index_first():
    x = np.array([1, 3, 3, 0, 3, 2, 3, 3], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 5)
    got_v, got_i = tselect.topk_stable(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_argmin_first_occurrence():
    x = np.array([[3, 1, 1, 2], [5, 5, 5, 5], [2, 3, 0, 0]], np.float32)
    got = tstereo.argmin_first(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argmin(jnp.asarray(x), -1)))


# ------------------------------------------------------ extractor on a scene
@pytest.fixture(scope="module")
def scene():
    """One rendered stereo pair, the JAX extractor (compiled once) and both
    packages' features of both images."""
    world = RoomWorld(width=9.0, height=5.5, length=13.0)
    R, t = trajectory_tour(300)[0]
    left, right = world.render_stereo(R, t, baseline=0.1, fx=FX, fy=FX,
                                      cx=W / 2, cy=H / 2, w=W, h=H)
    imgs = np.stack([np.clip(left, 0, 255), np.clip(right, 0, 255)]).astype(np.uint8)
    je = jext.ORBExtractor(JORBConfig(n_features=200, n_levels=4), H, W)
    te = text.ORBExtractor(TORBConfig(n_features=200, n_levels=4), H, W, device="cpu")
    jf = [jax.tree_util.tree_map(np.asarray, je(jnp.asarray(im))) for im in imgs]
    tf = te.extract_batch(torch.from_numpy(imgs))
    return dict(imgs=imgs, je=je, te=te, jf=jf, tf=tf)


def test_pyramid_matches_antialiased_linear_resize(scene):
    """5e-3 grey levels: both sides place their f32 sample positions with
    ~1e-5 px rounding (×255 grey levels per px of slope); measured 1.7e-3."""
    te, img = scene["te"], scene["imgs"][0].astype(np.float32)
    stack = te.pyramid(torch.from_numpy(img)[None])[0].numpy()
    for lv, (h, w) in enumerate(te.sizes):
        want = img if lv == 0 else np.asarray(
            jax.image.resize(jnp.asarray(img), (h, w), "linear"))
        assert np.abs(stack[lv, :h, :w] - want).max() < 5e-3
        assert not stack[lv, h:].any() and not stack[lv, :, w:].any()


@pytest.mark.parametrize("side", [0, 1])
def test_extractor_positions_octaves_validity_exact(scene, side):
    jf, tf = scene["jf"][side], scene["tf"]
    valid = jf.valid
    assert valid.sum() >= 150
    np.testing.assert_array_equal(tf.valid[side].numpy(), valid)
    np.testing.assert_array_equal(tf.uv[side].numpy()[valid], jf.uv[valid])
    np.testing.assert_array_equal(tf.octave[side].numpy()[valid], jf.octave[valid])
    # FAST scores on resized levels inherit the pyramid's 5e-3 rounding
    np.testing.assert_allclose(tf.response[side].numpy()[valid], jf.response[valid], atol=1e-2)


@pytest.mark.parametrize("side", [0, 1])
def test_extractor_angles_and_descriptors(scene, side):
    """Angles to 1e-4 rad (f32 moment sums in another order). Descriptors:
    ≥ 99.5 % of bits equal — the port reads the blurred patch directly where
    the reference multiplies by a lookup matrix, same bf16 operands and f32
    accumulation, so only summation order differs; measured 100 %."""
    jf, tf = scene["jf"][side], scene["tf"]
    valid = jf.valid
    d_ang = np.abs(tf.angle[side].numpy()[valid] - jf.angle[valid])
    d_ang = np.minimum(d_ang, 2 * np.pi - d_ang)
    assert d_ang.max() < 1e-4
    x = tf.desc[side].numpy().view(np.uint32)[valid] ^ jf.desc[valid]
    n_diff = int(np.unpackbits(x.view(np.uint8), axis=-1).sum())
    frac_equal = 1.0 - n_diff / (valid.sum() * 256)
    print(f"descriptor bits equal: {frac_equal:.6f}")
    assert frac_equal >= 0.995


def test_single_image_call_equals_batch_row(scene):
    te = scene["te"]
    one = te(torch.from_numpy(scene["imgs"][0]))
    for a, b in zip(one, scene["tf"]):
        assert torch.equal(a, b[0])


def test_match_stereo_parity(scene):
    """Same accept mask; u_right to 1e-3 px, depth to 1e-3 relative (the SAD
    sums and the parabola fit run in f32 in another order)."""
    jl, jr = scene["jf"]
    imgs = scene["imgs"].astype(np.float32)
    scales = np.asarray(scene["je"].scales, np.float32)
    bf = FX * 0.1
    want = jstereo.match_stereo(
        *(jnp.asarray(a) for a in (jl.uv, jl.octave, jl.desc, jl.valid,
                                   jr.uv, jr.octave, jr.desc, jr.valid,
                                   imgs[0], imgs[1], scales)), bf)

    def t(a):
        a = np.array(a)  # own, writable copy (JAX hands out read-only views)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)

    got = tstereo.match_stereo(
        *(t(a) for a in (jl.uv, jl.octave, jl.desc, jl.valid,
                         jr.uv, jr.octave, jr.desc, jr.valid,
                         imgs[0], imgs[1], scales)), bf)
    ok = np.asarray(want.valid)
    assert ok.sum() >= 40
    np.testing.assert_array_equal(got.valid.numpy(), ok)
    np.testing.assert_allclose(got.u_right.numpy(), np.asarray(want.u_right), atol=1e-3)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), rtol=1e-3)

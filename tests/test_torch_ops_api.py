"""Parity of the rest of the port's public operators with the JAX package on
the CPU, same seeded numpy inputs to both: `lie.se3_matrix`, the camera
model (`PinholeCamera.K`, `project` with and without distortion,
`backproject`, `stereo_unproject`), the standalone ORB operators
(`moment_maps`, `ic_angles`, `ic_angles_batched`, `gaussian_blur`,
`brief_descriptors`, `brief_descriptors_batched`), `Features.n`,
`ORBExtractor.sigma2` / `inv_sigma2`, and the device BoW transform
`Vocabulary.words` on both vocabularies the repo ships.

Tolerances, each stated where it is used: geometry 1e-5 relative in f32
(of the largest magnitude of the compared array), moment maps the same,
angles 1e-4 rad, the blur 1e-3 grey levels, descriptors ≥ 99.5 % equal
bits given the same angles; integers, `n`, the sigma tables and word ids
exact.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from gf_orb_slam2_tpu.config import ORBConfig as JORBConfig
from gf_orb_slam2_tpu.features import extractor as jext
from gf_orb_slam2_tpu.geometry import camera as jcam, lie as jlie
from gf_orb_slam2_tpu.ops import orb as jorb
from gf_orb_slam2_tpu.place.vocabulary import Vocabulary as JVocabulary
from gf_orb_slam2_tpu_torch.config import ORBConfig as TORBConfig
from gf_orb_slam2_tpu_torch.features import extractor as text
from gf_orb_slam2_tpu_torch.geometry import camera as tcam, lie as tlie
from gf_orb_slam2_tpu_torch.ops import orb as torb
from gf_orb_slam2_tpu_torch.place.vocabulary import Vocabulary as TVocabulary
from gf_orb_slam2_tpu_torch.system import VOCAB_DIR, VOCAB_FILES
from tests.rendered_world import RoomWorld, trajectory_tour

torch.set_num_threads(1)

REL = 1e-5          # geometry and moment maps: relative to the array's largest magnitude
ANGLE_TOL = 1e-4    # rad
BLUR_TOL = 1e-3     # grey levels
BITS_EQUAL = 0.995  # share of equal descriptor bits


def T(a):
    a = np.array(a)  # own, writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def close_rel(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rel * scale, f"max abs error {err:.3e} > {rel} x {scale:.3e}"


def angle_err(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d)


def bits_equal(a, b):
    x = np.asarray(a).view(np.uint32) ^ np.asarray(b).view(np.uint32)
    return 1.0 - np.unpackbits(x.view(np.uint8)).sum() / (x.size * 32)


# ------------------------------------------------------------------ geometry
@pytest.mark.parametrize("batch", [(), (5,), (2, 3)])
def test_se3_matrix_parity(batch):
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.5, batch + (3,)).astype(np.float32)
    t = rng.normal(0, 2.0, batch + (3,)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    want = np.asarray(jlie.se3_matrix(jnp.asarray(R), jnp.asarray(t)))
    got = tlie.se3_matrix(T(R), T(t))
    assert got.dtype == torch.float32 and got.shape == batch + (4, 4)
    np.testing.assert_array_equal(got.numpy(), want)


DISTS = {"radtan": (0.1, -0.05, 0.001, -0.002, 0.01),
         "none": (0.0, 0.0, 0.0, 0.0, 0.0),
         "fisheye": (0.01, -0.002, 0.001, 0.0, 0.0)}


def _cams(kind):
    dist = np.asarray(DISTS[kind], np.float32)
    fisheye = kind == "fisheye"
    j = jcam.PinholeCamera(fx=jnp.float32(450.0), fy=jnp.float32(455.0),
                           cx=jnp.float32(320.0), cy=jnp.float32(240.0),
                           dist=jnp.asarray(dist), width=640, height=480, fisheye=fisheye)
    t = tcam.PinholeCamera(fx=450.0, fy=455.0, cx=320.0, cy=240.0, dist=T(dist),
                           width=640, height=480, fisheye=fisheye)
    return j, t


def _points(seed, n=64):
    rng = np.random.default_rng(seed)
    pc = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pc[:, 2] = rng.uniform(1, 10, n)
    pc[0, 2] = 0.0       # the 1e-8 depth guard
    pc[1, 2] = -2.0      # behind the camera: projected all the same
    return pc


def test_camera_K_parity():
    j, t = _cams("radtan")
    got = t.K()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j.K()))


@pytest.mark.parametrize("kind", list(DISTS))
@pytest.mark.parametrize("apply_distortion", [False, True])
def test_project_parity(kind, apply_distortion):
    j, t = _cams(kind)
    pc = _points(1)
    juv, jz = jcam.project(j, jnp.asarray(pc), apply_distortion=apply_distortion)
    tuv, tz = tcam.project(t, T(pc), apply_distortion=apply_distortion)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    juv, tuv = np.asarray(juv), tuv.numpy()
    # the guarded row overflows through the distortion polynomial: alike
    np.testing.assert_array_equal(np.isfinite(tuv), np.isfinite(juv))
    close_rel(tuv[2:], juv[2:])
    for row in (0, 1):  # the guarded and the behind-the-camera rows
        if np.isfinite(juv[row]).all():
            close_rel(tuv[row], juv[row])


def test_backproject_and_stereo_unproject_parity():
    j, t = _cams("none")
    rng = np.random.default_rng(2)
    uv = rng.uniform(0, 640, (64, 2)).astype(np.float32)
    z = rng.uniform(0.5, 20, 64).astype(np.float32)
    close_rel(tcam.backproject(t, T(uv), T(z)).numpy(),
              np.asarray(jcam.backproject(j, jnp.asarray(uv), jnp.asarray(z))))
    bf = 450.0 * 0.1
    disp = rng.uniform(0.5, 60, 64).astype(np.float32)
    disp[:3] = [0.0, -1.0, 1e-7]  # clamped to 1e-6
    close_rel(tcam.stereo_unproject(t, T(uv), T(disp), bf).numpy(),
              np.asarray(jcam.stereo_unproject(j, jnp.asarray(uv), jnp.asarray(disp), bf)))


def test_project_backproject_roundtrip():
    """tests/test_geometry.py's round trips on the port's functions."""
    _, t = _cams("radtan")
    rng = np.random.default_rng(10)
    pc = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    pc[:, 2] = rng.uniform(1, 10, 40)
    uv, z = tcam.project(t, T(pc))
    np.testing.assert_allclose(tcam.backproject(t, uv, z).numpy(), pc, atol=1e-4)
    _, t0 = _cams("none")
    X = torch.tensor([[0.5, -0.2, 4.0]])
    uv, z = tcam.project(t0, X)
    bf = 450.0 * 0.1
    np.testing.assert_allclose(tcam.stereo_unproject(t0, uv, bf / z, bf).numpy(), X.numpy(),
                               atol=1e-4)


# ----------------------------------------------------------- ORB operators
@pytest.fixture(scope="module")
def level_images():
    """Three rendered level-sized images (the tour's first frame at three
    sizes) and keypoint positions on them, borders included."""
    world = RoomWorld(width=9.0, height=5.5, length=13.0)
    R, t = trajectory_tour(300)[0]
    h, w = 96, 128
    left, _ = world.render_stereo(R, t, baseline=0.1, fx=90.0, fy=90.0, cx=w / 2, cy=h / 2,
                                  w=w, h=h)
    base = np.clip(left, 0, 255).astype(np.float32)
    rng = np.random.default_rng(3)
    imgs = np.stack([base, np.roll(base, 7, axis=1),
                     rng.uniform(0, 255, (h, w)).astype(np.float32)])
    n = 48
    yx = np.stack([rng.integers(0, h, (3, n)), rng.integers(0, w, (3, n))], -1).astype(np.float32)
    yx[:, :4] = [[0, 0], [h - 1, w - 1], [0, w - 1], [h - 1, 0]]
    yx += rng.uniform(0, 0.99, yx.shape).astype(np.float32)  # sub-pixel: truncated
    return imgs, yx


def test_moment_maps_parity(level_images):
    imgs, _ = level_images
    for a, b in [(imgs[0], None), (imgs, None)]:
        jm = jorb.moment_maps(jnp.asarray(a))
        tm = torb.moment_maps(T(a))
        for got, want in zip(tm, jm):
            close_rel(got.numpy(), np.asarray(want))


def test_ic_angles_parity(level_images):
    imgs, yx = level_images
    for i in range(3):
        want = np.asarray(jorb.ic_angles(jnp.asarray(imgs[i]), jnp.asarray(yx[i])))
        got = torb.ic_angles(T(imgs[i]), T(yx[i])).numpy()
        assert angle_err(got, want).max() < ANGLE_TOL
    want = np.asarray(jorb.ic_angles_batched(jnp.asarray(imgs), jnp.asarray(yx)))
    got = torb.ic_angles_batched(T(imgs), T(yx)).numpy()
    assert got.shape == (3, yx.shape[1])
    assert angle_err(got, want).max() < ANGLE_TOL


def test_gaussian_blur_parity(level_images):
    imgs, _ = level_images
    for a in (imgs[0], imgs):
        want = np.asarray(jorb.gaussian_blur(jnp.asarray(a)))
        got = torb.gaussian_blur(T(a)).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() < BLUR_TOL
    want = np.asarray(jorb.gaussian_blur(jnp.asarray(imgs[2]), 5, 1.2))
    assert np.abs(torb.gaussian_blur(T(imgs[2]), 5, 1.2).numpy() - want).max() < BLUR_TOL


def test_brief_descriptors_parity(level_images):
    """Each side blurs with its own operator; both read at JAX's angles."""
    imgs, yx = level_images
    jb = jorb.gaussian_blur(jnp.asarray(imgs))
    tb = torb.gaussian_blur(T(imgs))
    ang = np.asarray(jorb.ic_angles_batched(jnp.asarray(imgs), jnp.asarray(yx)))
    for i in range(3):
        want = np.asarray(jorb.brief_descriptors(jb[i], jnp.asarray(yx[i]), jnp.asarray(ang[i])))
        got = torb.brief_descriptors(tb[i], T(yx[i]), T(ang[i]))
        assert got.dtype == torch.int32 and got.shape == (yx.shape[1], 8)
        assert bits_equal(got.numpy(), want) >= BITS_EQUAL
    want = np.asarray(jorb.brief_descriptors_batched(jb, jnp.asarray(yx), jnp.asarray(ang)))
    got = torb.brief_descriptors_batched(tb, T(yx), T(ang)).numpy()
    assert got.shape == want.shape
    frac = bits_equal(got, want)
    print(f"descriptor bits equal: {frac:.6f}")
    assert frac >= BITS_EQUAL


# tests/test_features.py's properties of the operators, on the port
def _blocks(h=240, w=320, sq=24, fill=12):
    ys, xs = np.mgrid[0:h, 0:w]
    inside = ((ys % sq) < fill) & ((xs % sq) < fill)
    return (inside * 200.0 + 20.0).astype(np.float32)


def _ham(a, b):
    return int(np.unpackbits((a.view(np.uint32) ^ b.view(np.uint32)).view(np.uint8)).sum())


def test_gradient_angle():
    img = np.tile(np.arange(128, dtype=np.float32), (128, 1))
    a = float(torb.ic_angles(T(img), torch.tensor([[64.0, 64.0]]))[0])
    assert abs(a) < 0.1
    a2 = float(torb.ic_angles(T(img.T), torch.tensor([[64.0, 64.0]]))[0])
    assert abs(a2 - np.pi / 2) < 0.1


def test_descriptor_deterministic():
    b = torb.gaussian_blur(T(_blocks()))
    yx = torch.tensor([[50.0, 60.0], [80.0, 100.0]])
    ang = torch.tensor([0.3, -1.0])
    d1 = torb.brief_descriptors(b, yx, ang).numpy()
    d2 = torb.brief_descriptors(b, yx, ang).numpy()
    assert d1.shape == (2, 8)
    np.testing.assert_array_equal(d1, d2)


def test_rotation_invariance():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (201, 201)).astype(np.float32)
    img = torb.gaussian_blur(T(img), 7, 2.0).numpy()
    rot = ndi.rotate(img, -30.0, reshape=False, order=1)
    c = torch.tensor([[100.0, 100.0]])
    d0 = torb.brief_descriptors(T(img), c, torch.tensor([0.0])).numpy()
    d1 = torb.brief_descriptors(T(rot), c, torch.tensor([np.deg2rad(30.0)],
                                                        dtype=torch.float32)).numpy()
    assert _ham(d0, d1) < 80  # well below random (~128)


def test_distinct_patches_distinct_descriptors():
    rng = np.random.default_rng(1)
    b = torb.gaussian_blur(T(rng.uniform(0, 255, (200, 200)).astype(np.float32)))
    d = torb.brief_descriptors(b, torch.tensor([[60.0, 60.0], [140.0, 140.0]]),
                               torch.zeros(2)).numpy()
    assert _ham(d[0], d[1]) > 60


# ----------------------------------------------------------------- extractor
def test_features_n_and_sigma_tables_exact():
    h, w = 160, 208
    world = RoomWorld(width=9.0, height=5.5, length=13.0)
    R, t = trajectory_tour(300)[2]
    left, _ = world.render_stereo(R, t, baseline=0.1, fx=150.0, fy=150.0, cx=w / 2, cy=h / 2,
                                  w=w, h=h)
    img = np.clip(left, 0, 255).astype(np.uint8)
    je = jext.ORBExtractor(JORBConfig(n_features=300), h, w)
    te = text.ORBExtractor(TORBConfig(n_features=300), h, w, device="cpu")
    jf, tf = je(jnp.asarray(img)), te(torch.from_numpy(img))
    n = tf.n
    assert n.dtype == torch.int32 and n.dim() == 0
    assert int(n) == int(jf.n) > 100
    for name in ("sigma2", "inv_sigma2"):
        want, got = getattr(je, name), getattr(te, name)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- vocabulary
@pytest.mark.parametrize("name", VOCAB_FILES)
def test_vocabulary_words_exact(name):
    """The device descent against the JAX `words` and the port's own
    `words_np`, numpy and tensor inputs, repeated descriptors, no rows."""
    path = os.path.join(VOCAB_DIR, name)
    jv, tv = JVocabulary.load(path), TVocabulary.load(path, device="cpu")
    q = np.random.default_rng(4).integers(0, 2**32, (2000, 8), dtype=np.uint32)
    q[1000:1100] = q[:100]
    # descriptors at the tree's own centers: ties between siblings are likely
    q[1500:1600] = tv.centers[-1][np.random.default_rng(5).integers(0, tv.V, 100)]
    want = np.asarray(jv.words(q))
    got = tv.words(q)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tv.words_np(q))
    np.testing.assert_array_equal(tv.words(T(q)).numpy(), want)
    assert tv.words(q[:0]).shape == (0,)


def test_vocabulary_device_is_taken_as_given():
    voc = TVocabulary.load(os.path.join(VOCAB_DIR, VOCAB_FILES[-1]))
    assert voc.device == torch.device("cuda")
    assert voc.to("cpu") is voc and voc.device == torch.device("cpu")

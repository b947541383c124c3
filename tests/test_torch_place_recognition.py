"""Parity of the port's place recognition (place/vocabulary.py,
place/keyframe_db.py) with the JAX package on the CPU: word ids on both
vocabularies the repo ships, BoW vectors, training, the DBoW2 text and
binary round trips of tests/test_loop_closing.py, loop and relocalization
candidates and the covisibility threshold on one store that both packages
hold (the loop scene of tests/test_torch_loop_closing.py), the lazily
trained vocabulary of `System._ensure_place_recognition`, and an analogue of
tests/test_place_recognition.py on rendered views extracted by the port.

Everything here is host numpy on both sides, so every output is compared
exactly except float weights and scores (rtol 1e-6: float32 sums in the same
order).
"""
import os
import types

import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu.place.keyframe_db import KeyFrameDatabase as JKeyFrameDatabase
from gf_orb_slam2_tpu.place.vocabulary import Vocabulary as JVocabulary
from gf_orb_slam2_tpu.system import System as JSystem
from gf_orb_slam2_tpu_torch import convert
from gf_orb_slam2_tpu_torch.config import CapacityConfig, ORBConfig
from gf_orb_slam2_tpu_torch.features.extractor import ORBExtractor
from gf_orb_slam2_tpu_torch.place.keyframe_db import KeyFrameDatabase as TKeyFrameDatabase
from gf_orb_slam2_tpu_torch.place.vocabulary import Vocabulary as TVocabulary
from gf_orb_slam2_tpu_torch.slammap.store import MapStore as TMapStore
from gf_orb_slam2_tpu_torch.system import VOCAB_DIR, VOCAB_FILES, System as TSystem
from tests.rendered_world import RoomWorld, rpy_pose
from tests.test_torch_loop_closing import N_KF, loop_config, shared_stores

torch.set_num_threads(1)

RTOL = 1e-6


def _descs(seed, n):
    return np.random.default_rng(seed).integers(0, 2**32, (n, 8), dtype=np.uint32)


@pytest.fixture(scope="module", params=VOCAB_FILES)
def vocabs(request):
    path = os.path.join(VOCAB_DIR, request.param)
    return JVocabulary.load(path), TVocabulary.load(path)


def test_shipped_vocabulary_words_exact(vocabs):
    jv, tv = vocabs
    assert (tv.k, tv.levels, tv.V) == (jv.k, jv.levels, jv.V)
    q = _descs(0, 3000)
    q[1000:1100] = q[:100]  # repeated descriptors
    np.testing.assert_array_equal(tv.words_np(q), jv.words_np(q))
    np.testing.assert_array_equal(tv.words_np(q[:0]), jv.words_np(q[:0]))
    valid = np.random.default_rng(1).random(3000) > 0.3
    ji, jw = jv.bow_sparse(q, valid)
    ti, tw = tv.bow_sparse(q, valid)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tw, jw, rtol=RTOL)
    np.testing.assert_allclose(tv.bow_vector(q[:500]), jv.bow_vector(q[:500]), rtol=RTOL)


def test_the_default_vocabulary_is_the_largest_shipped():
    """Both packages pick vocab100k.npz first (gf_orb_slam2_tpu/system.py
    `_load_vocabulary`)."""
    assert VOCAB_FILES[0] == "vocab100k.npz"
    cfg = convert.config_from_reference(loop_config())
    slam = TSystem(cfg, device="cpu")
    assert slam.voc.V == 100000 and slam.loop_closer is not None
    assert TSystem(cfg.replace(vocabulary_path=""), device="cpu").voc is None


# ---------------------------------------------------- training and DBoW2
def test_train_matches_and_roundtrips(tmp_path):
    """Analogue of TestVocabulary: the same tree from the same seed, the
    transform, save/load."""
    descs = _descs(0, 2000)
    jv = JVocabulary.train(descs, k=6, levels=2, iters=3)
    tv = TVocabulary.train(descs, k=6, levels=2, iters=3)
    assert tv.V == 36
    for a, b in zip(tv.centers, jv.centers):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tv.idf, jv.idf)
    w = tv.words_np(descs[:100])
    assert w.shape == (100,) and w.max() < 36
    tv.save(tmp_path / "voc.npz")
    np.testing.assert_array_equal(TVocabulary.load(tmp_path / "voc.npz").words_np(descs[:50]),
                                  w[:50])
    # the JAX package reads what the port writes
    np.testing.assert_array_equal(JVocabulary.load(tmp_path / "voc.npz").words_np(descs[:50]),
                                  w[:50])


def test_bow_similarity_ranks_same_scene_higher():
    rng = np.random.default_rng(1)
    base = rng.integers(0, 2**32, (3000, 8), dtype=np.uint32)
    voc = TVocabulary.train(base[:2000], k=8, levels=2, iters=3)
    scene_a = base[:300]
    scene_a2 = scene_a ^ (rng.integers(0, 2**8, scene_a.shape, dtype=np.uint32) & np.uint32(3))
    va, va2, vb = voc.bow_vector(scene_a), voc.bow_vector(scene_a2), voc.bow_vector(base[1000:1300])
    assert va @ va2 > va @ vb + 0.1


def test_dbow2_text_roundtrip_preserves_words(tmp_path):
    rng = np.random.default_rng(5)
    voc = TVocabulary.train(rng.integers(0, 2**32, (3000, 8), dtype=np.uint32), k=4, levels=3,
                            iters=3)
    voc.save_dbow2_text(tmp_path / "t.txt")
    voc2 = TVocabulary.load_dbow2(tmp_path / "t.txt")
    jvoc2 = JVocabulary.load_dbow2(tmp_path / "t.txt")
    assert (voc2.k, voc2.levels) == (voc.k, voc.levels)
    q = rng.integers(0, 2**32, (500, 8), dtype=np.uint32)
    np.testing.assert_array_equal(voc2.words_np(q), voc.words_np(q))
    np.testing.assert_array_equal(voc2.words_np(q), jvoc2.words_np(q))
    np.testing.assert_allclose(voc2.idf, voc.idf, rtol=1e-5)


def test_dbow2_binary_roundtrip(tmp_path):
    import struct

    rng = np.random.default_rng(6)
    voc = TVocabulary.train(rng.integers(0, 2**32, (2000, 8), dtype=np.uint32), k=3, levels=2,
                            iters=3)
    # the fork's binary layout (TemplatedVocabulary.h:1516): parent i32,
    # 32 descriptor bytes, weight f32, leaf u8
    offsets = [1]
    for lvl in range(voc.levels):
        offsets.append(offsets[-1] + voc.centers[lvl].shape[0])
    nodes = []
    for lvl in range(voc.levels):
        leaf = lvl == voc.levels - 1
        for i, c in enumerate(voc.centers[lvl]):
            parent = 0 if lvl == 0 else offsets[lvl - 1] + i // voc.k
            nodes.append(struct.pack("<i", parent) + c.tobytes()
                         + struct.pack("<f", float(voc.idf[i]) if leaf else 0.0)
                         + struct.pack("<B", int(leaf)))
    p = tmp_path / "voc.bin"
    with open(p, "wb") as f:
        f.write(struct.pack("<IIiiii", len(nodes), 41, voc.k, voc.levels, 0, 0))
        f.writelines(nodes)
    q = rng.integers(0, 2**32, (300, 8), dtype=np.uint32)
    np.testing.assert_array_equal(TVocabulary.load_dbow2(str(p)).words_np(q), voc.words_np(q))
    np.testing.assert_array_equal(JVocabulary.load_dbow2(str(p)).words_np(q), voc.words_np(q))


def test_incomplete_tree_with_early_leaf(tmp_path):
    k, L = 2, 2
    d = np.zeros((4, 32), np.uint8)
    d[1, 0] = 0xFF  # node 2: an early leaf (level 1)
    d[2, 0] = 0x03  # node 3: a leaf under node 1, which has one child only
    lines = [f"{k} {L} 0 0",
             "0 0 " + " ".join(map(str, d[0])) + " 0.0",
             "0 1 " + " ".join(map(str, d[1])) + " 2.5",
             "1 1 " + " ".join(map(str, d[2])) + " 1.5"]
    p = tmp_path / "tiny.txt"
    p.write_text("\n".join(lines) + "\n")
    voc = TVocabulary.load_dbow2(str(p))
    jvoc = JVocabulary.load_dbow2(str(p))
    assert voc.V == k ** L
    for a, b in zip(voc.centers, jvoc.centers):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(voc.idf, jvoc.idf)
    q = np.stack([d[1].view(np.uint32), d[2].view(np.uint32)])
    w = voc.words_np(q)
    assert voc.idf[w[0]] == 2.5 and voc.idf[w[1]] == 1.5


# ------------------------------------------------------ keyframe database
@pytest.fixture(scope="module")
def databases():
    _, js, _, ts, _ = shared_stores()
    path = os.path.join(VOCAB_DIR, "vocab10k.npz")
    jdb = JKeyFrameDatabase(JVocabulary.load(path), js)
    tdb = TKeyFrameDatabase(TVocabulary.load(path), ts)
    return jdb, tdb, js, ts


def test_loop_candidates_and_thresholds_exact(databases):
    """Queried as the loop closer queries: each KF against the database of
    the KFs before it."""
    jdb, tdb, js, ts = databases
    n_cands = 0
    for k in range(N_KF):
        jm, tm = jdb.min_covis_score(k), tdb.min_covis_score(k)
        np.testing.assert_allclose(tm, jm, rtol=RTOL)
        jc = jdb.detect_loop_candidates(k, max(jm, 1e-3))
        tc = tdb.detect_loop_candidates(k, max(tm, 1e-3))
        assert tc == jc, k
        n_cands += len(tc)
        np.testing.assert_allclose(tdb.score_query(ts.kf_desc[k], ts.kf_kp_valid[k]),
                                   jdb.score_query(js.kf_desc[k], js.kf_kp_valid[k]), rtol=RTOL)
        for j in range(max(0, k - 3), k):
            np.testing.assert_allclose(tdb.score_pair(k, j), jdb.score_pair(k, j), rtol=RTOL)
        jdb.add(k)
        tdb.add(k)
        assert tdb.present.sum() == jdb.present.sum()
    assert n_cands > 0
    # relocalization candidates of the revisit's views
    for k in (0, N_KF - 1):
        assert (tdb.detect_reloc_candidates(ts.kf_desc[k], ts.kf_kp_valid[k])
                == jdb.detect_reloc_candidates(js.kf_desc[k], js.kf_kp_valid[k]))
    tdb.erase(3)
    jdb.erase(3)
    np.testing.assert_allclose(tdb.score_query(ts.kf_desc[3], ts.kf_kp_valid[3]),
                               jdb.score_query(js.kf_desc[3], js.kf_kp_valid[3]), rtol=RTOL)
    tdb.clear()
    assert not tdb.present.any() and tdb.detect_reloc_candidates(ts.kf_desc[0], None) == []


def test_lazily_trained_vocabulary_is_the_same_tree():
    """`vocabulary_path=""`: both packages' `_ensure_place_recognition`
    train their vocabulary from the same map (a 20,000-descriptor sample of
    `default_rng(0)`, then `Vocabulary.train(k=8, levels=3, iters=4)`), and
    the trees give the same words."""
    jcfg, js, tcfg, ts, _ = shared_stores()

    def host(store, cfg):
        return types.SimpleNamespace(
            cfg=cfg, store=store, voc=None, kfdb=None, loop_closer=None, _vocab_min_kfs=8,
            device=torch.device("cpu"),
            tracker=types.SimpleNamespace(notify_map_rebase=None, kfdb=None),
            _on_gba_writeback=None, _pause_mapping=None, _resume_mapping=None)

    jh, th = host(js, jcfg), host(ts, tcfg.replace(vocabulary_path=""))
    JSystem._ensure_place_recognition(jh)
    TSystem._ensure_place_recognition(th)
    assert th.voc is not None and th.kfdb is not None and th.loop_closer is not None
    for a, b in zip(th.voc.centers, jh.voc.centers):
        np.testing.assert_array_equal(a, b)
    q = _descs(3, 2000)
    np.testing.assert_array_equal(th.voc.words_np(q), jh.voc.words_np(q))
    assert th.kfdb.present.sum() == jh.kfdb.present.sum() == N_KF - 1


# ------------------------- analogue of tests/test_place_recognition.py
def test_revisit_retrieval_precision_on_rendered_views():
    """Eight distinct places — two non-overlapping patches of each wall of
    the rendered room, seen from 2.5 m — each seen again from a nearby pose
    (0.15 m aside, 0.2 m closer, a few degrees of yaw): the port's extractor
    + the default vocabulary + the KF database must retrieve the revisited
    place for nearly every query (one miss allowed, as in the JAX test)."""
    H, W, F = 240, 320, 225.0
    world = RoomWorld(width=9.0, height=5.5, length=13.0)
    ex = ORBExtractor(ORBConfig(n_features=600), H, W, device="cpu")
    n_kp = 640
    rng = np.random.default_rng(7)
    # (yaw, camera position, lateral axis) per wall: front, back, left, right
    walls = [(0.0, np.array([0.0, 0.0, 10.5]), 0), (np.pi, np.array([0.0, 0.0, 2.5]), 0),
             (-np.pi / 2, np.array([-2.0, 0.0, 6.5]), 2), (np.pi / 2, np.array([2.0, 0.0, 6.5]), 2)]
    places = []
    for yaw, centre, lateral in walls:
        fwd = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        for side in (-2.2, 2.2):
            pos = centre.copy()
            pos[lateral] += side
            views = []
            for d_yaw, d_side, d_fwd in ((0.0, 0.0, 0.0), (rng.uniform(-0.08, 0.08), 0.15, 0.2)):
                p = pos.copy()
                p[lateral] += d_side
                R_cw, t_cw = rpy_pose(yaw + d_yaw, 0.0, 0.0, p + d_fwd * fwd)
                left, _ = world.render_stereo(R_cw, t_cw, fx=F, fy=F, cx=W / 2, cy=H / 2,
                                              w=W, h=H)
                f = ex(torch.from_numpy(np.clip(left, 0, 255).astype(np.float32)))
                d = np.zeros((n_kp, 8), np.uint32)
                v = np.zeros(n_kp, bool)
                fv = f.valid.numpy()
                d[: fv.size][fv] = f.desc.numpy().view(np.uint32)[fv]
                v[: fv.size] = fv
                views.append((d, v))
            places.append(views)
    store = TMapStore(CapacityConfig(max_keyframes=16, max_map_points=64), n_kp)
    voc = TVocabulary.load(os.path.join(VOCAB_DIR, VOCAB_FILES[0]))
    db = TKeyFrameDatabase(voc, store)
    jdb = JKeyFrameDatabase(JVocabulary.load(os.path.join(VOCAB_DIR, VOCAB_FILES[0])), store)
    for (d, v), _ in places:
        k = store.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                               np.zeros((n_kp, 2), np.float32), np.zeros(n_kp, np.int32),
                               np.zeros(n_kp, np.float32), d, np.full(n_kp, -1.0, np.float32),
                               np.full(n_kp, -1.0, np.float32), v)
        db.add(k)
        jdb.add(k)
    correct = 0
    for i, (_, (d, v)) in enumerate(places):
        scores = db.score_query(d, v)
        np.testing.assert_allclose(scores, jdb.score_query(d, v), rtol=RTOL)
        correct += int(np.argmax(scores)) == i
    assert correct >= len(places) - 1, f"{correct}/{len(places)} retrieved"

"""Parity of the port's local-mapping slice with the JAX package on the CPU:
3x3 linear algebra, DLT triangulation and its gates, the batched host map
maintenance, the triangulation search and the fusion search on rendered
keyframe pairs, anticipation, and whole keyframe events run by both mappers
from one store snapshot carried across with convert.py.

The snapshots come from the JAX System tracking the first rendered frames of
the room tour at 320x240 with its mapper on (loop closing off; its compile
warm-up thread off, so it compiles at first use): each keyframe event's
store and mapper state are copied just before the JAX mapper processes it,
and its results just after. Kernel 1b goes through its plain version on the
CPU tensors, the JAX side through its XLA path. Tolerances are stated where
they are used.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu import config as jconfig
from gf_orb_slam2_tpu.geometry import triangulate as jtri
from gf_orb_slam2_tpu.mapping import batch_ops as jbatch
from gf_orb_slam2_tpu.selection import anticipation as janti
from gf_orb_slam2_tpu.system import System as JSystem
from gf_orb_slam2_tpu.utils import linalg3 as jl3
from gf_orb_slam2_tpu_torch import convert
from gf_orb_slam2_tpu_torch.geometry import triangulate as ttri
from gf_orb_slam2_tpu_torch.mapping import batch_ops as tbatch, local_mapping as tlm
from gf_orb_slam2_tpu_torch.selection import anticipation as tanti
from gf_orb_slam2_tpu_torch.utils import linalg3 as tl3
from tests.rendered_world import RoomWorld, trajectory_tour

torch.set_num_threads(1)

H, W, F = 240, 320, 225.0
N_KP = 640
N_FRAMES = 7  # keyframe events at frames 0, 1, 2, 3 and 6


def T(a):
    a = np.array(a)  # own, writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


# ---------------------------------------------------------------- linalg3
def test_linalg3_parity():
    """f32, rtol 1e-5 (well-conditioned matrices; the clamp on singular)."""
    rng = np.random.default_rng(0)
    M = (rng.normal(0, 1, (64, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
    b = rng.normal(0, 1, (64, 3)).astype(np.float32)
    for fn in ("adjugate3", "det3", "inv3"):
        np.testing.assert_allclose(getattr(tl3, fn)(T(M)).numpy(),
                                   np.asarray(getattr(jl3, fn)(jnp.asarray(M))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl3.solve3(T(M), T(b)).numpy(),
                               np.asarray(jl3.solve3(jnp.asarray(M), jnp.asarray(b))), rtol=1e-5, atol=1e-6)
    sing = np.zeros((2, 3, 3), np.float32)
    sing[1, 0, 0] = 1.0
    got = tl3.inv3(T(sing)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, np.asarray(jl3.inv3(jnp.asarray(sing))))


# ------------------------------------------------------------ triangulate
def _two_views(rng, n=200):
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(2, 8, n)], -1).astype(np.float32)
    R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    a = 0.05
    R2 = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
    t2 = np.array([-0.3, 0.02, 0.05], np.float32)

    def proj(R, t):
        pc = X @ R.T + t
        return (pc[:, :2] / pc[:, 2:] * F + [W / 2, H / 2]).astype(np.float32)

    uv1 = proj(R1, t1) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    uv2 = proj(R2, t2) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    uv2[:10] += 30.0  # reprojection failures
    return K, R1, t1, R2, t2, uv1, uv2


def test_triangulate_parity():
    """Projection matrices rtol 1e-5; the gate mask exact. DLT points: the
    f32 normal equations of a 0.3 m baseline carry ~1e-4 relative error in
    either package (measured against their float64 solve: JAX 8e-5, the
    port 5e-5), so each is held to the float64 solve at 2e-4 of the point's
    norm and the two to each other at 3e-4."""
    rng = np.random.default_rng(1)
    K, R1, t1, R2, t2, uv1, uv2 = _two_views(rng)
    jP1, jP2 = jtri.projection_matrix(jnp.asarray(K), R1, t1), jtri.projection_matrix(jnp.asarray(K), R2, t2)
    tP1, tP2 = ttri.projection_matrix(T(K), T(R1), T(t1)), ttri.projection_matrix(T(K), T(R2), T(t2))
    np.testing.assert_allclose(tP2.numpy(), np.asarray(jP2), rtol=1e-5, atol=1e-4)
    want = np.asarray(jtri.triangulate_dlt(jP1, jP2, jnp.asarray(uv1), jnp.asarray(uv2)))
    got = ttri.triangulate_dlt(tP1, tP2, T(uv1), T(uv2)).numpy()
    P1, P2 = np.asarray(jP1, np.float64), np.asarray(jP2, np.float64)
    exact = []
    for a, b in zip(uv1.astype(np.float64), uv2.astype(np.float64)):
        A = np.stack([a[0] * P1[2] - P1[0], a[1] * P1[2] - P1[1],
                      b[0] * P2[2] - P2[0], b[1] * P2[2] - P2[1]])
        exact.append(np.linalg.solve(A[:, :3].T @ A[:, :3], -A[:, :3].T @ A[:, 3]))
    scale = np.linalg.norm(np.array(exact), axis=-1)
    err = {name: float((np.linalg.norm(x - y, axis=-1) / scale).max())
           for name, x, y in (("port", got, exact), ("jax", want, exact), ("port-jax", got, want))}
    print("DLT relative error", err)
    assert err["port"] < 2e-4 and err["jax"] < 2e-4 and err["port-jax"] < 3e-4
    s2 = (1.2 ** rng.integers(0, 8, len(uv1)) ** 2).astype(np.float32)
    wok = np.asarray(jtri.triangulation_checks(jnp.asarray(want), R1, t1, R2, t2, uv1, uv2,
                                               jnp.asarray(K), s2, s2))
    gok = ttri.triangulation_checks(T(want), T(R1), T(t1), T(R2), T(t2), T(uv1), T(uv2),
                                    T(K), T(s2), T(s2)).numpy()
    np.testing.assert_array_equal(gok, wok)
    assert 0 < wok.sum() < len(wok)


# ------------------------------------------------- rendered snapshot events
@pytest.fixture(scope="module")
def events():
    cam = jconfig.CameraConfig(width=W, height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
                               bf=F * 0.1, th_depth=40.0)
    jcfg = jconfig.SystemConfig(
        sensor=jconfig.Sensor.STEREO, camera=cam, orb=jconfig.ORBConfig(n_features=600),
        capacity=jconfig.CapacityConfig(max_keypoints=N_KP, max_map_points=8000,
                                        max_keyframes=40, max_local_points=1024),
        tracking=jconfig.TrackingConfig(async_mapping=False),
        loop=jconfig.LoopClosingConfig(enabled=False), vocabulary_path="")
    world = RoomWorld(width=9.0, height=5.5, length=13.0)
    saved = os.environ.get("GF_SLAM_NO_PREWARM")
    os.environ["GF_SLAM_NO_PREWARM"] = "1"
    try:
        js = JSystem(jcfg)
    finally:
        if saved is None:
            del os.environ["GF_SLAM_NO_PREWARM"]
        else:
            os.environ["GF_SLAM_NO_PREWARM"] = saved
    log = []
    process = js.mapper.process_keyframe

    def recorded(kf, skip_ba=False):
        before = dict(store=convert.store_arrays(js.store), mapper=convert.mapper_state(js.mapper))
        st = process(kf, skip_ba)
        log.append(dict(kf=kf, before=before, stats=dataclasses.asdict(st),
                        after=convert.store_arrays(js.store),
                        mapper_after=convert.mapper_state(js.mapper)))
        return st

    js.mapper.process_keyframe = recorded
    for i, (R, t) in enumerate(trajectory_tour(300)[:N_FRAMES]):
        left, right = world.render_stereo(R, t, baseline=0.1, fx=F, fy=F, cx=W / 2,
                                          cy=H / 2, w=W, h=H)
        js.track_stereo(left, right, i / 20.0)
    assert [s.state for s in js.tracker.stats] == ["OK"] * N_FRAMES
    tcfg = convert.config_from_reference(jcfg)
    yield dict(js=js, jcfg=jcfg, tcfg=tcfg, log=log,
               scales=np.asarray(js.extractor.scales, np.float32))
    js.shutdown()


def _carried(events, ev):
    """The port's store and mapper, carried over from just before event
    `ev` through convert.py."""
    tcfg = events["tcfg"]
    store = convert.store_from_arrays(tcfg.capacity, N_KP, ev["before"]["store"])
    mapper = tlm.LocalMapper(tcfg, store, N_KP, events["scales"], device="cpu")
    convert.load_mapper_state(mapper, ev["before"]["mapper"])
    return store, mapper


def _last_event(events):
    ev = events["log"][-1]
    assert ev["stats"]["n_new_points"] > 0, "the last event should triangulate"
    return ev


def test_events_recorded(events):
    assert [e["kf"] for e in events["log"]] == list(range(len(events["log"])))
    assert len(events["log"]) >= 4


def test_triangulation_search_parity_on_keyframe_pairs(events):
    """The last event's KF against each covisible KF, JAX
    `_triangulate_pair_impl` (XLA Hamming matrix + masked best-2) against the
    port's batched `triangulate_pairs` (best-2 through distance_best2):
    best_idx and the accept mask exact. Xw 5e-4 of the point's norm on the
    accepted rows: the f32 DLT normal equations of these short baselines
    are good to ~1e-4 in either package (see test_triangulate_parity), and
    the two differ by up to 3.8e-4 here (a 10 m point, 0.26 m baseline)."""
    ev = _last_event(events)
    store, mapper = _carried(events, ev)
    kf = ev["kf"]
    kns, free = mapper._tri_prepare(kf)
    ids = [kf] + kns
    s = store
    got = tlm.triangulate_pairs(
        mapper._K, mapper._scales_dev, T(s.kf_R[ids]), T(s.kf_t[ids]), T(s.kf_uv[ids]),
        T(s.kf_octave[ids]), T(s.kf_desc[ids]), T(free))
    jm = events["js"].mapper
    n_acc = 0
    for b, kn in enumerate(kns):
        args = [s.kf_R[kf], s.kf_t[kf], s.kf_R[kn], s.kf_t[kn],
                s.kf_uv[kf], s.kf_octave[kf], s.kf_desc[kf], free[0], s.kf_u_right[kf],
                s.kf_uv[kn], s.kf_octave[kn], s.kf_desc[kn], free[1 + b], s.kf_u_right[kn]]
        Xw, idx, ok = (np.asarray(a) for a in jm._jit_triangulate(*(jnp.asarray(a) for a in args)))
        np.testing.assert_array_equal(got[2][b].numpy(), ok, err_msg=f"pair {kf}-{kn}")
        np.testing.assert_array_equal(got[1][b].numpy()[ok], idx[ok])
        np.testing.assert_array_equal(got[1][b].numpy(), idx)
        rel = np.linalg.norm(got[0][b].numpy()[ok] - Xw[ok], axis=-1) / np.linalg.norm(Xw[ok], axis=-1)
        print(f"pair {kf}-{kn}: {int(ok.sum())} accepted, Xw relative difference "
              f"{rel.max(initial=0):.2e}")
        assert (rel <= 5e-4).all()
        n_acc += int(ok.sum())
    assert n_acc > 0


def test_fusion_search_parity_on_keyframe_pairs(events):
    """The last event's fusion pairs: JAX `_fuse_impl` per pair against the
    port's batched `fuse_pairs`: indices and valid exact."""
    ev = _last_event(events)
    store, mapper = _carried(events, ev)
    dsts, src_ids, _ = mapper._fuse_prepare(ev["kf"])
    s = store
    idc = np.maximum(src_ids, 0)
    got_idx, got_ok = tlm.fuse_pairs(
        events["tcfg"].camera, mapper._scales_dev, T(s.kf_R[dsts]), T(s.kf_t[dsts]),
        T(s.point_pos[idc]), T(src_ids >= 0), T(s.point_desc[idc]),
        T(s.kf_uv[dsts]), T(s.kf_octave[dsts]), T(s.kf_kp_valid[dsts]), T(s.kf_desc[dsts]))
    jm = events["js"].mapper
    n_ok = 0
    for b, dst in enumerate(dsts):
        ids = src_ids[b]
        args = [s.kf_R[dst], s.kf_t[dst], s.point_pos[idc[b]], np.zeros(len(ids), np.int32),
                ids >= 0, s.point_desc[idc[b]], s.kf_uv[dst], s.kf_octave[dst],
                s.kf_kp_valid[dst], s.kf_desc[dst]]
        idx, ok = (np.asarray(a) for a in jm._jit_fuse(*(jnp.asarray(a) for a in args)))
        np.testing.assert_array_equal(got_ok[b].numpy(), ok)
        np.testing.assert_array_equal(got_idx[b].numpy(), idx)
        n_ok += int(ok.sum())
    assert n_ok > 0


def test_batch_ops_parity(events):
    """refresh_points_batch and redundant_keyframes on copies of one
    snapshot: every store array exact afterwards, the same victims."""
    ev = _last_event(events)
    cap = events["jcfg"].capacity
    from gf_orb_slam2_tpu.slammap.store import MapStore as JMapStore

    js_store = JMapStore(cap, N_KP)
    for k, v in ev["before"]["store"].items():
        setattr(js_store, k, v.copy() if isinstance(v, np.ndarray) else v)
    ts_store, _ = _carried(events, ev)
    pts = np.unique(ts_store.kf_point[: ts_store.n_keyframes])
    jbatch.refresh_points_batch(js_store, pts, events["scales"])
    tbatch.refresh_points_batch(ts_store, pts, events["scales"])
    want, got = convert.store_arrays(js_store), convert.store_arrays(ts_store)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    cands = list(range(ts_store.n_keyframes))
    assert tbatch.redundant_keyframes(ts_store, cands) == jbatch.redundant_keyframes(js_store, cands)
    assert tbatch.redundant_keyframes(ts_store, cands, redundancy=0.3) == \
        jbatch.redundant_keyframes(js_store, cands, redundancy=0.3)


def test_anticipation_parity(events):
    """Visible fractions exact (same numpy), same subgraph size."""
    ev = _last_event(events)
    store, _ = _carried(events, ev)
    V = np.eye(4, dtype=np.float32)
    V[:3, 3] = [0.0, 0.0, -0.3]
    kf = ev["kf"]
    for vel in (None, V):
        assert tanti.anticipated_subgraph_size(
            store, events["tcfg"], store.kf_R[kf], store.kf_t[kf], vel) == \
            janti.anticipated_subgraph_size(store, events["jcfg"], store.kf_R[kf],
                                            store.kf_t[kf], vel)
    assert tanti.visible_fraction(store, store.kf_R[kf], store.kf_t[kf], events["tcfg"].camera) == \
        janti.visible_fraction(store, store.kf_R[kf], store.kf_t[kf], events["jcfg"].camera)


@pytest.mark.parametrize("which", [-4, -3, -2, -1])
def test_whole_keyframe_event_parity(events, which):
    """One store snapshot through both packages' process_keyframe: culled,
    created and fused counts, culled KFs, BA window sizes exact; BA cost
    rtol 1e-3; every KF pose after BA to 1e-3; the same live points."""
    ev = events["log"][which]
    store, mapper = _carried(events, ev)
    st = dataclasses.asdict(mapper.process_keyframe(ev["kf"]))
    want = ev["stats"]
    print("jax", want, "\nport", st)
    for k in ("kf", "n_culled_points", "n_new_points", "n_fused", "n_culled_kfs",
              "ba_kfs", "ba_points"):
        assert st[k] == want[k], k
    np.testing.assert_allclose(st["ba_cost"], want["ba_cost"], rtol=1e-3)
    after = ev["after"]
    n = store.n_keyframes
    np.testing.assert_array_equal(store.kf_valid[:n], after["kf_valid"][:n])
    np.testing.assert_allclose(store.kf_R[:n], after["kf_R"][:n], atol=1e-3)
    np.testing.assert_allclose(store.kf_t[:n], after["kf_t"][:n], atol=1e-3)
    assert store.n_points == after["n_points"]
    np.testing.assert_array_equal(store.point_valid, after["point_valid"])
    assert convert.mapper_state(mapper) == ev["mapper_after"] | {
        "stats": convert.mapper_state(mapper)["stats"]}


def _jax_carried(events, ev):
    """The JAX package's store and a fresh JAX mapper from just before event
    `ev`, as `_carried` builds the port's."""
    from gf_orb_slam2_tpu.mapping.local_mapping import LocalMapper as JLocalMapper
    from gf_orb_slam2_tpu.slammap.store import MapStore as JMapStore

    store = JMapStore(events["jcfg"].capacity, N_KP)
    for k, v in ev["before"]["store"].items():
        if isinstance(v, np.ndarray):
            setattr(store, k, v.copy())
        elif isinstance(v, dict):
            setattr(store, k, {a: set(b) for a, b in v.items()})
        else:
            setattr(store, k, v)
    mapper = JLocalMapper(events["jcfg"], store, N_KP, events["scales"])
    mapper.recent_points = [tuple(r) for r in ev["before"]["mapper"]["recent_points"]]
    return store, mapper


@pytest.mark.parametrize("stage", ["create_new_points", "fuse_neighbors"])
@pytest.mark.parametrize("which", [-2, -1])
def test_mapper_stage_alone_parity(events, stage, which):
    """`LocalMapper.create_new_points` / `fuse_neighbors` called alone in
    both packages from one carried store (the snapshot before the event,
    refreshed by each package's own refresh and culling first, as
    process_keyframe runs them): the count returned, every integer array
    of the store and the mapper's probation list exact; the positions of
    the points that existed before the stage exact. A point the stage
    triangulates is held at 2.5e-4 of its norm, the measured difference
    with some headroom: 1e-4 does not hold (measured 1.8-1.9e-4 of the
    norm, 1.4e-3 m on a far point of the last event) — both packages solve
    the same f32 normal equations of short baselines, whose rounding moves
    a far point that much in either."""
    ev = events["log"][which]
    kf = ev["kf"]
    ts, tm = _carried(events, ev)
    js, jm = _jax_carried(events, ev)
    with js.lock:
        jm._refresh_point_stats(kf)
        jm.cull_recent_points(kf)
    tm.refresh(kf)
    got, want = getattr(tm, stage)(kf), getattr(jm, stage)(kf)
    print(f"event {kf} {stage}: jax {want}, port {got}")
    assert got == want
    if stage == "create_new_points" and which == -1:
        assert got > 0, "the last event should triangulate"
    tw, jw = convert.store_arrays(ts), convert.store_arrays(js)
    for k, v in jw.items():
        if isinstance(v, np.ndarray) and v.dtype.kind in "biu":
            np.testing.assert_array_equal(tw[k], v, err_msg=k)
        elif not isinstance(v, np.ndarray):
            assert tw[k] == v, k
    live = jw["point_valid"]
    old_pts = ev["before"]["store"]["point_valid"] & live
    np.testing.assert_array_equal(tw["point_pos"][old_pts], jw["point_pos"][old_pts])
    new_pts = live & ~old_pts
    rel = (np.linalg.norm(tw["point_pos"][new_pts] - jw["point_pos"][new_pts], axis=-1)
           / np.linalg.norm(jw["point_pos"][new_pts], axis=-1))
    print(f"{int(new_pts.sum())} new points, relative difference {rel.max(initial=0):.2e}")
    assert (rel <= 2.5e-4).all()
    assert tm.recent_points == jm.recent_points


def test_create_and_fuse_equals_its_two_stages(events):
    """create_and_fuse on one copy of the last event's snapshot against
    create_new_points and fuse_neighbors, each on a copy of its own: the
    same created and fused counts (the combined stage fuses the map as of
    the KF's insertion, before its own triangulation)."""
    ev = _last_event(events)
    kf = ev["kf"]
    a, ma = _carried(events, ev)
    b, mb = _carried(events, ev)
    c, mc = _carried(events, ev)
    for m in (ma, mb, mc):
        m.refresh(kf)
    created, fused = ma.create_and_fuse(kf)
    assert created == mb.create_new_points(kf) > 0
    assert fused == mc.fuse_neighbors(kf)

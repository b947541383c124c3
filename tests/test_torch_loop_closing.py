"""Parity of the port's loop closer with the JAX package on the CPU: whole
loop events on one store that both packages hold, the mapper's discard of
write-backs assembled before a correction, and the rebase of live tracking
after a correction that lands while the synchronous entry waits for its
workers.

The store is built without tracking from tests/synthetic.py: 36 keyframes
on 1.12 turns of a circle looking at a ring of landmarks, each KF pose
carrying an injected drift that grows with the KF index (a slow yaw and a
shift); points are created from the drifted poses and re-observed only for
4 KFs, so the revisit makes duplicates. Both loop closers run every KF in
order from the same snapshot (convert.store_arrays); the JAX package's
RANSAC draws reach the port through `LoopCloser.sim3_draws`, and the GBA
runs inline (`loop.synchronous_gba`). Kernels 1a and 1b go through their
plain versions on CPU tensors.

Tolerances: integer outputs exact (candidates, loop KF, inlier counts and
masks, guided matches, fused pairs); Sim3 parameters 1e-4; poses after the
rigid correction 1e-4, after the essential graph 1e-3, after the GBA 1e-3
(poses) and 2e-3 (points) — f32 LM solves of the same problems, summed in
another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu import config as jconfig
from gf_orb_slam2_tpu.loopclosing.loop_closer import LoopCloser as JLoopCloser
from gf_orb_slam2_tpu.place.keyframe_db import KeyFrameDatabase as JKeyFrameDatabase
from gf_orb_slam2_tpu.place.vocabulary import Vocabulary as JVocabulary
from gf_orb_slam2_tpu.slammap.store import MapStore as JMapStore
from gf_orb_slam2_tpu_torch import convert
from gf_orb_slam2_tpu_torch.loopclosing.loop_closer import LoopCloser as TLoopCloser
from gf_orb_slam2_tpu_torch.mapping import local_mapping
from gf_orb_slam2_tpu_torch.place.keyframe_db import KeyFrameDatabase as TKeyFrameDatabase
from gf_orb_slam2_tpu_torch.place.vocabulary import Vocabulary as TVocabulary
from gf_orb_slam2_tpu_torch.system import VOCAB_DIR, System
from tests.synthetic import SyntheticWorld, make_frame

torch.set_num_threads(1)

N_KP = 400
N_KF = 36
SIM3_TOL = 1e-4
CORRECT_TOL = 1e-4
PG_TOL = 1e-3
GBA_POSE_TOL, GBA_POINT_TOL = 1e-3, 2e-3
VOCAB = f"{VOCAB_DIR}/vocab10k.npz"


# ------------------------------------------------------------------- scene
def circle_poses(n, radius=6.0, loops=1.12):
    """World→camera poses on a circle in the x-z plane."""
    out = []
    for i in range(n):
        a = 2 * np.pi * loops * i / n
        c, s = np.cos(a), np.sin(a)
        Rwc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        C = np.array([radius * s, 0.0, radius * (1 - c)], np.float32)
        out.append((Rwc.T, (-Rwc.T @ C).astype(np.float32)))
    return out


def ring_world(seed=13, n=6000):
    """Landmarks on a ring around the circle (the world of the JAX package's
    synthetic loop test, tests/test_loop_closing.py)."""
    world = SyntheticWorld(n, seed=seed, extent=(1.0, 1.0, 1.0))
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(9, 16, n)
    world.points = np.stack([r * np.sin(ang), rng.uniform(-3, 3, n),
                             12.0 - r * np.cos(ang)], -1).astype(np.float32)
    world.d0 = np.maximum(2.0, rng.uniform(4, 12, n)).astype(np.float32)
    return world


def drift(k):
    """The drift D_k of KF k's stored pose (T_est = T_gt ∘ D_k)."""
    a = 0.004 * k
    c, s = np.cos(a), np.sin(a)
    Rd = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return Rd, np.array([0.006 * k, 0.0, -0.004 * k], np.float32)


def build_loop_store(store_cls, cap, cam, n_kf=N_KF, reobserve=4, seed=13):
    """The drifted circle map, written straight into a store of
    `store_cls` (either package's MapStore). Returns (store, gt poses)."""
    world = ring_world(seed)
    store = store_cls(cap, N_KP)
    gt = circle_poses(n_kf)
    point_of = {}  # world id → (map point, KF that created it)
    for k, (R, t) in enumerate(gt):
        f = make_frame(world, R, t, cam, 10 * k, n_kp=N_KP, max_z=30.0)
        Rd, td = drift(k)
        Re, te = (R @ Rd).astype(np.float32), (R @ td + t).astype(np.float32)
        kf = store.add_keyframe(Re, te, f.uv, f.octave, f.angle, f.desc, f.u_right, f.depth,
                                f.valid, frame_id=10 * k, timestamp=k / 2.0)
        n = int(f.valid.sum())
        old_slots, old_ids, new_slots = [], [], []
        for j, g in enumerate(f.gt_ids[:n].tolist()):
            e = point_of.get(g)
            if (e is not None and k - e[1] <= reobserve and store.point_valid[e[0]]
                    and not (store.obs_kf[e[0]] == kf).any()):
                old_slots.append(j)
                old_ids.append(e[0])
            else:
                new_slots.append(j)
        if old_ids:
            store.add_observations_batch(np.asarray(old_ids), kf, np.asarray(old_slots))
        ns = np.asarray(new_slots[:150], np.int64)
        if ns.size:
            z = f.depth[ns]
            xc = np.stack([(f.uv[ns, 0] - cam.cx) / cam.fx * z,
                           (f.uv[ns, 1] - cam.cy) / cam.fy * z, z], -1)
            ids = store.add_points_batch(((xc - te) @ Re).astype(np.float32), f.desc[ns],
                                         kf, kf, ns)
            for j, p in zip(ns.tolist(), ids.tolist()):
                point_of[int(f.gt_ids[j])] = (int(p), k)
        store.update_connections(kf)
        for kk in store.covisible_kfs(kf):
            store.update_connections(int(kk))
    return store, gt


def loop_config(n_kp=N_KP, **loop_kw):
    cam = jconfig.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0, th_depth=40.0)
    cap = jconfig.CapacityConfig(max_keypoints=n_kp, max_map_points=20000, max_keyframes=48,
                                 max_local_points=2048)
    return jconfig.SystemConfig(camera=cam, capacity=cap, orb=jconfig.ORBConfig(n_features=n_kp),
                                loop=jconfig.LoopClosingConfig(synchronous_gba=True, **loop_kw))


def jax_draws(kf, c, n_valid):
    """The JAX loop closer's RANSAC draws for candidate c of keyframe kf."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(kf * 1000 + c), (128, 3), 0,
                                         jnp.maximum(n_valid, 3)))


def shared_stores(jcfg=None):
    """The loop scene in a JAX store and, carried over, in a port store."""
    jcfg = jcfg or loop_config()
    js, gt = build_loop_store(JMapStore, jcfg.capacity, jcfg.camera)
    tcfg = convert.config_from_reference(jcfg)
    ts = convert.store_from_arrays(tcfg.capacity, N_KP, convert.store_arrays(js))
    return jcfg, js, tcfg, ts, gt


class Recorder:
    """What one loop closer does: the Sim3 stage of each candidate, the
    fused pairs, and the KF poses and points at each phase boundary."""

    def __init__(self, lc):
        self.sim3, self.fused, self.phases = [], [], []
        s = lc.store
        lc.sim3_debug_hook = lambda **kw: self.sim3.append(kw)
        replace = s.replace_point

        def replace_logged(q, p):
            self.fused.append((int(q), int(p)))
            return replace(q, p)

        s.replace_point = replace_logged

        def snap(label):
            self.phases.append((label, dict(R=s.kf_R.copy(), t=s.kf_t.copy(),
                                            pos=s.point_pos.copy(),
                                            valid=s.point_valid.copy())))

        def wrap(name, label):
            fn = getattr(lc, name)

            def run(*a, **k):
                snap(label)
                return fn(*a, **k)
            setattr(lc, name, run)

        wrap("_search_and_fuse", "corrected")
        wrap("_optimize_essential_graph", "fused")
        wrap("_launch_global_ba", "essential_graph")


@pytest.fixture(scope="module")
def loop_run():
    jcfg, js, tcfg, ts, gt = shared_stores()
    jl = JLoopCloser(jcfg, js, JKeyFrameDatabase(JVocabulary.load(VOCAB), js))
    tl = TLoopCloser(tcfg, ts, TKeyFrameDatabase(TVocabulary.load(VOCAB), ts), device="cpu")
    tl.sim3_draws = jax_draws
    jrec, trec = Recorder(jl), Recorder(tl)
    before = dict(R=js.kf_R.copy(), t=js.kf_t.copy())
    for k in range(N_KF):
        jl.process_keyframe(k)
        tl.process_keyframe(k)
    return dict(jl=jl, tl=tl, js=js, ts=ts, jrec=jrec, trec=trec, gt=gt, before=before)


def test_every_event_agrees(loop_run):
    """Per keyframe: candidates, loop KF, inliers, correction and fused count
    exact; essential-graph cost rtol 1e-3."""
    jst, tst = loop_run["jl"].stats, loop_run["tl"].stats
    assert len(jst) == len(tst) == N_KF
    for a, b in zip(jst, tst):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        np.testing.assert_allclose(db.pop("pg_cost"), da.pop("pg_cost"), rtol=1e-3)
        assert db == da
    corrected = [s for s in tst if s.corrected]
    assert len(corrected) == 1, "the revisit must close exactly one loop"
    st = corrected[0]
    assert st.loop_kf < 5 and st.kf > 30 and st.n_sim3_inliers >= 20 and st.n_fused > 0
    assert sum(s.n_candidates > 0 for s in tst) >= 3  # consistency over 3 KFs
    assert len(loop_run["tl"].event_ms) == N_KF


def test_sim3_hit_agrees(loop_run):
    """Every evaluated candidate's RANSAC + polish and guided refinement."""
    ja, ta = loop_run["jrec"].sim3, loop_run["trec"].sim3
    assert len(ja) == len(ta) >= 1
    for a, b in zip(ja, ta):
        assert (a["kf"], a["c"]) == (b["kf"], b["c"])
        np.testing.assert_array_equal(b["val"], a["val"])
        np.testing.assert_array_equal(b["pc1"], a["pc1"])
        np.testing.assert_array_equal(b["pc2"], a["pc2"])
        (js_, jR, jt, jinl), (ts_, tR, tt, tinl) = a["ransac"], b["ransac"]
        np.testing.assert_array_equal(tinl, jinl)
        np.testing.assert_allclose([ts_], [js_], atol=SIM3_TOL)
        np.testing.assert_allclose(tR, jR, atol=SIM3_TOL)
        np.testing.assert_allclose(tt, jt, atol=SIM3_TOL)
        jr, tr = a["refined"], b["refined"]
        assert tr[3:] == jr[3:]  # refinement inliers, guided matches
        np.testing.assert_allclose([tr[0]], [jr[0]], atol=SIM3_TOL)
        np.testing.assert_allclose(tr[1], jr[1], atol=SIM3_TOL)
        np.testing.assert_allclose(tr[2], jr[2], atol=SIM3_TOL)


def test_correction_fusion_graph_and_gba_agree(loop_run):
    jp, tp = loop_run["jrec"].phases, loop_run["trec"].phases
    assert [label for label, _ in tp] == [label for label, _ in jp] == [
        "corrected", "fused", "essential_graph"]
    n = loop_run["js"].n_keyframes
    for (label, a), (_, b) in zip(jp, tp):
        tol = CORRECT_TOL if label in ("corrected", "fused") else PG_TOL
        np.testing.assert_allclose(b["R"][:n], a["R"][:n], atol=tol, err_msg=label)
        np.testing.assert_allclose(b["t"][:n], a["t"][:n], atol=tol, err_msg=label)
        np.testing.assert_array_equal(b["valid"], a["valid"], err_msg=label)
        v = a["valid"]
        np.testing.assert_allclose(b["pos"][v], a["pos"][v], atol=10 * tol, err_msg=label)
    # fused pairs (replaced point → loop point), in order
    assert loop_run["trec"].fused == loop_run["jrec"].fused
    assert len(loop_run["trec"].fused) == sum(s.n_fused for s in loop_run["tl"].stats)
    # after the GBA
    js, ts = loop_run["js"], loop_run["ts"]
    np.testing.assert_allclose(ts.kf_R[:n], js.kf_R[:n], atol=GBA_POSE_TOL)
    np.testing.assert_allclose(ts.kf_t[:n], js.kf_t[:n], atol=GBA_POSE_TOL)
    np.testing.assert_array_equal(ts.point_valid, js.point_valid)
    v = js.point_valid
    np.testing.assert_allclose(ts.point_pos[v], js.point_pos[v], atol=GBA_POINT_TOL)
    assert ts.big_change_idx == js.big_change_idx
    assert ts.kf_loop_edges == js.kf_loop_edges
    assert loop_run["tl"].last_gba is not None and loop_run["tl"].last_gba.n_segments >= 4


def test_the_loop_correction_removes_drift(loop_run):
    """The closing KF's position error against the ground truth, relative
    to the loop KF (whose drift is small), drops below 0.75 of what it was
    (the ratio of the JAX package's rendered loop gate,
    tests/test_loop_rendered.py)."""
    ts, gt, before = loop_run["ts"], loop_run["gt"], loop_run["before"]
    st = next(s for s in loop_run["tl"].stats if s.corrected)

    def rel_err(R, t, k, l):
        c = lambda Rk, tk: -Rk.T @ tk  # noqa: E731
        est = c(R[k], t[k]) - c(R[l], t[l])
        want = c(*gt[k]) - c(*gt[l])
        return float(np.linalg.norm(est - want))

    e0 = rel_err(before["R"], before["t"], st.kf, st.loop_kf)
    e1 = rel_err(ts.kf_R, ts.kf_t, st.kf, st.loop_kf)
    assert e1 < 0.75 * e0, (e0, e1)


# ------------------------------------------------------- mapper: v0 discard
TRACK_KP = 640  # stereo initialization needs 500 keypoints


@pytest.fixture(scope="module")
def mapped():
    """A port System (CPU) that tracked 40 synthetic frames with mapping,
    loop closing off; the tests below use it in file order."""
    cfg = convert.config_from_reference(loop_config(TRACK_KP, enabled=False))
    slam = System(cfg, device="cpu")
    world = ring_world()
    for i, (R, t) in enumerate(circle_poses(41, loops=0.3)[:40]):
        jf = make_frame(world, R, t, cfg.camera, i, n_kp=TRACK_KP, max_z=30.0)
        slam.track_frame(convert.frame_from_arrays(
            {k: getattr(jf, k) for k in ("frame_id", "timestamp", "uv", "octave", "angle",
                                         "desc", "response", "u_right", "depth", "valid")}))
    return slam


def test_mapper_discards_write_backs_assembled_before_a_correction(mapped, monkeypatch):
    """A loop correction (big_change_idx bump) landing while the mapper's
    device work runs: triangulation, fusion and BA results are all dropped,
    and the same calls write back when the world did not move."""
    slam = mapped
    s, mapper = slam.store, slam.mapper
    kf = int(s.valid_kf_ids()[-1])
    assert s.n_keyframes >= 3

    calls = []

    def bump_during(fn):
        def run(*a, **k):
            calls.append(fn.__name__)
            s.big_change_idx += 1  # the correction lands mid-solve
            return fn(*a, **k)
        return run

    # local BA
    R0, t0, P0 = s.kf_R.copy(), s.kf_t.copy(), s.point_pos.copy()
    monkeypatch.setattr(local_mapping, "ba_solve", bump_during(local_mapping.ba_solve))
    st = local_mapping.MappingStats(kf=kf)
    mapper.run_local_ba(kf, st)
    assert st.ba_discarded
    np.testing.assert_array_equal(s.kf_R, R0)
    np.testing.assert_array_equal(s.kf_t, t0)
    np.testing.assert_array_equal(s.point_pos, P0)
    monkeypatch.undo()
    st = local_mapping.MappingStats(kf=kf)
    mapper.run_local_ba(kf, st)
    assert not st.ba_discarded and st.ba_kfs >= 2
    # triangulation + fusion (one device stage)
    n_points = s.n_points
    obs_before = s.obs_kf.copy()
    monkeypatch.setattr(local_mapping, "triangulate_pairs",
                        bump_during(local_mapping.triangulate_pairs))
    monkeypatch.setattr(local_mapping, "fuse_pairs", bump_during(local_mapping.fuse_pairs))
    assert mapper.create_and_fuse(kf) == (0, 0)
    assert calls == ["ba_solve", "triangulate_pairs", "fuse_pairs"]
    assert s.n_points == n_points
    np.testing.assert_array_equal(s.obs_kf, obs_before)


# ------------------------------------------------- rebase after the waits
class _WorkerLandingACorrection:
    """A mapping worker whose wait ends with a loop correction: the
    tracker is told of a rigid move of the map while the entry waits."""

    def __init__(self, slam, R_D, t_D):
        self.slam, self.R_D, self.t_D, self.calls = slam, R_D, t_D, 0

    def wait_idle(self):
        self.calls += 1
        with self.slam.store.lock:
            self.slam.tracker.notify_map_rebase(self.R_D, self.t_D)


def test_correction_landing_during_the_wait_is_applied_before_tracking(mapped):
    """The synchronous entry applies a pending rebase AFTER waiting for its
    workers (the JAX package applies it before, so a correction that lands
    in the wait is missed for that frame)."""
    slam = mapped
    tr = slam.tracker
    lf = tr.last_frame
    R_before, t_before = lf.R.copy(), lf.t.copy()
    a = 0.01
    R_D = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                   np.float32)
    t_D = np.array([0.05, 0.0, -0.02], np.float32)
    slam._map_worker = _WorkerLandingACorrection(slam, R_D, t_D)
    seen = {}
    process = tr.process_frame

    def spy(frame):
        seen["pending"] = tr.pending_map_rebase
        seen["R"], seen["t"] = tr.last_frame.R.copy(), tr.last_frame.t.copy()
        return process(frame)

    tr.process_frame = spy
    world = ring_world()
    R, t = circle_poses(41, loops=0.3)[40]
    jf = make_frame(world, R, t, slam.cfg.camera, 40, n_kp=TRACK_KP, max_z=30.0)
    slam.track_frame(convert.frame_from_arrays(
        {k: getattr(jf, k) for k in ("frame_id", "timestamp", "uv", "octave", "angle", "desc",
                                     "response", "u_right", "depth", "valid")}))
    assert slam._map_worker.calls >= 1
    assert seen["pending"] is None  # applied before the frame was tracked
    R_new = R_before @ R_D.T
    np.testing.assert_allclose(seen["R"], R_new, atol=1e-6)
    np.testing.assert_allclose(seen["t"], t_before - R_new @ t_D, atol=1e-6)
    slam._map_worker = None

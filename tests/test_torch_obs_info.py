"""The good-feature selection's information matrices: the hand-written CUDA
kernel (csrc/obs_info.cu through ops/obs_info_cuda.py) and its dispatch
(selection/observability.py `pose_info_for_selection`).

On the CPU: the dispatch is the plain composition
(`pose_info_for_selection_ref`), bit for bit the functions it composes, on
stereo and mono inputs; the kernel's entry refuses what the kernel does not
take before anything is built; a launch is counted once as `launch.obs_info`
and passes the C entry its arguments in order (a stand-in library).

On the card (marked `cuda`; `python -m pytest --noconftest -m cuda
tests/test_torch_obs_info.py`, JAX-free): the kernel against the plain
version on synthetic inputs (stereo and mono, rows behind the camera and at
z <= 1e-3, invalid rows, octaves past both clamps, P = 4096 and a small P,
no matched keypoint) and on the main path's own inputs (the calls of a
stereo System on rendered frames). Exact: the kernel rounds every product
and sum as the plain version's launches do on the card (its elementwise
ops, cuBLAS's fused multiply-add chains for mm, mv and bmm, torch's
contracted cross product), and the base is torch's sum of the kernel's
keypoint matrices. So the pool's matrices and the base equal the plain
version's bit for bit, two runs of the kernel equal each other, and the
selection (kernel 3, the same uniforms) picks the same set on both. One
exception, outside the path's shapes (P = 4096 pool slots, n = 640 or 1024
keypoint rows): with SMALL_N rows or fewer cuBLAS computes the keypoints'
d @ R(q) with another kernel, in another order, so there the base is held
within BASE_RTOL of its largest entry (a rounding of its terms: ~1e-7).
"""
import contextlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu_torch.geometry import lie
from gf_orb_slam2_tpu_torch.ops import cuda_lib, obs_info_cuda
from gf_orb_slam2_tpu_torch.selection import good_feature, observability

torch.set_num_threads(1)

FX, FY, BF = 517.306408, 516.469215, 40.0
SCALES = 1.2 ** np.arange(8)
SMALL_N = 16       # keypoint rows at which cuBLAS's mm takes another order (seen at 16)
BASE_RTOL = 1e-5   # the base there, of its largest entry


def _inputs(seed, P, n, matched=True, device="cpu"):
    """A pose and a pool of P rows: 80 % in the camera's field of view at
    0.3-8 m, the rest behind the camera, or at z <= 1e-3, or off in the
    plane z = 0; 15 % of the rows invalid; octaves from -2 to 9 (past both
    clamps of the 8 levels). n keypoint rows drawn from the pool's rows in
    view, half of them matched (none with `matched` False)."""
    rng = np.random.default_rng(seed)
    R = lie.so3_exp(torch.from_numpy(rng.normal(0, 1.0, 3).astype(np.float32))).numpy()
    t = rng.normal(0, 1.0, 3).astype(np.float32)
    z = rng.uniform(0.3, 8.0, P)
    pc = np.stack([z * rng.uniform(-0.6, 0.6, P), z * rng.uniform(-0.45, 0.45, P), z], -1)
    kind = rng.integers(0, 20, P)
    pc[kind == 0, 2] *= -1.0                        # behind the camera
    pc[kind == 1, 2] = rng.uniform(-1e-3, 5e-4, (kind == 1).sum())  # at z <= 1e-3
    pc[kind == 2, 2] = 0.0                          # in the camera's plane
    pc[kind == 3] = rng.normal(0, 3.0, ((kind == 3).sum(), 3))
    pc[kind == 3, 2] = -np.abs(pc[kind == 3, 2]) - 0.1  # anywhere behind
    pos = ((pc - t) @ R).astype(np.float32)        # world = Rᵀ (pc - t)
    octave = rng.integers(-2, 10, P)
    valid = rng.random(P) < 0.85
    in_view = np.flatnonzero(kind >= 4)
    rows = rng.choice(in_view, n, replace=n > in_view.size)
    kp_pos = pos[rows]
    kp_valid = (rng.random(n) < 0.5) & matched
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (T(R), T(t), T(pos), T(octave), T(valid), T(SCALES.astype(np.float32)), T(kp_pos),
            T(kp_valid))


def _composed(R0, t0, pos, octave, valid, scales, kp_pos, kp_valid, stereo):
    """observability's functions composed by hand: the selection's state,
    then the pool's matrices and the matched set's sum."""
    q, c, inv2 = observability.selection_state(R0, t0, octave, scales)
    P, n = pos.shape[0], kp_pos.shape[0]
    obs = observability.info_matrices(q, c, pos, FX, FY, BF, torch.full((P,), stereo), inv2,
                                      valid)
    base = observability.pose_info_from_frame(q, c, kp_pos, FX, FY, BF, torch.full((n,), stereo),
                                              torch.ones(n), kp_valid)
    return obs, base


# ---- CPU


@pytest.mark.parametrize("stereo", [True, False], ids=["stereo", "mono"])
@pytest.mark.parametrize("P,n,matched", [(4096, 1024, True), (37, 16, True), (300, 64, False)],
                         ids=["path_shape", "small", "no_match"])
def test_dispatch_on_cpu_is_the_plain_composition(P, n, matched, stereo):
    """CPU tensors run the plain version, the composition of
    `selection_state`, `info_matrices` and `pose_info_from_frame`: the same
    bits. Rows of weight 0 are zeros; with no matched keypoint the base is."""
    args = _inputs(11 + P, P, n, matched)
    got = observability.pose_info_for_selection(*args, FX, FY, BF, stereo)
    want = _composed(*args, stereo)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].shape == (P, 7, 7) and got[1].shape == (7, 7)
    _, _, _, _, valid, _, _, _ = args
    assert not got[0][~valid].any()
    assert bool(got[1].any()) == matched


def _refusing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel library was built before the checks")

    monkeypatch.setattr(cuda_lib, "load", refuse)
    monkeypatch.setattr(cuda_lib, "build", refuse)


BAD = {
    "float64_pos": (2, lambda a: a.double(), TypeError),
    "float64_pose": (0, lambda a: a.double(), TypeError),
    "int32_octave": (3, lambda a: a.int(), TypeError),
    "float_valid": (4, lambda a: a.float(), TypeError),
    "cpu": (None, None, ValueError),
    "non_contiguous_pos": (2, lambda a: a.t().contiguous().t(), ValueError),
    "pos_shape": (2, lambda a: a[:, :2].contiguous(), ValueError),
    "octave_shape": (3, lambda a: a[:-1].contiguous(), ValueError),
    "kp_valid_shape": (7, lambda a: a[:-1].contiguous(), ValueError),
    "pose_shape": (1, lambda a: torch.cat([a, a]), ValueError),
    "no_levels": (5, lambda a: a[:0], ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_kernel_entry_refuses_what_it_does_not_take(case, monkeypatch):
    """TypeError on a dtype the kernel does not read, ValueError on a CPU
    tensor, a non-contiguous one or a shape that does not fit — before the
    library is built, and no launch is counted. (Past the CPU case every
    tensor passes for a CUDA one, so each later check is reached.)"""
    _refusing(monkeypatch)
    args = list(_inputs(5, 40, 12))
    i, make_bad, err = BAD[case]
    if i is not None:
        args[i] = make_bad(args[i])
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    before = dict(cuda_lib.launch_counts)
    with pytest.raises(err, match=None if i is not None else "CUDA"):
        obs_info_cuda.obs_info(*args, FX, FY, BF, True)
    assert cuda_lib.launch_counts == before


def test_launch_is_counted_once_with_its_arguments(monkeypatch):
    """One call, one `launch.obs_info`, and the C entry gets the inputs'
    pointers, the sizes, the camera, the stereo flag and the outputs'
    pointers in its declared order (a stand-in library and stream); the
    base is the sum of the keypoint matrices the kernel wrote."""
    calls = []

    class Lib:
        def obs_info_launch(self, *args):
            calls.append(args)
            return 0

    class Stream:
        cuda_stream = 7

    kept = []
    empty = torch.empty

    def keep_empty(*a, **k):
        kept.append(empty(*a, **k).fill_(0.5))
        return kept[-1]

    monkeypatch.setattr(cuda_lib, "load", Lib)
    monkeypatch.setattr(cuda_lib, "check_on_card", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    args = _inputs(6, 40, 12)
    monkeypatch.setattr(torch, "empty", keep_empty)
    before = cuda_lib.launch_counts["obs_info"]
    obs, base = obs_info_cuda.obs_info(*args, FX, FY, BF, False)
    assert cuda_lib.launch_counts["obs_info"] == before + 1
    (got,) = calls
    assert len(got) == len(cuda_lib.ENTRIES["obs_info_launch"]) + 1  # + the stream
    assert list(got[:8]) == [a.data_ptr() for a in args]
    assert got[8:15] == (40, 12, 8, FX, FY, BF, 0)
    obs_out, kp_out = kept
    assert got[15:] == (obs_out.data_ptr(), kp_out.data_ptr(), 7) and obs is obs_out
    assert obs.shape == (40, 7, 7) and kp_out.shape == (12, 7, 7)
    assert torch.equal(base, torch.full((7, 7), 6.0))
    obs_info_cuda.obs_info(*args, FX, FY, BF, True)
    assert cuda_lib.launch_counts["obs_info"] == before + 2
    assert calls[1][14] == 1


# ---- on the card


def _held(args, cam, stereo, tally):
    """The kernel against the plain version on one call's inputs and camera
    (fx, fy, bf), bit for bit; the selection on both added to `tally`."""
    R0, t0, pos, octave, valid, scales, kp_pos, kp_valid = args
    before = cuda_lib.launch_counts["obs_info"]
    obs, base = obs_info_cuda.obs_info(*args, *cam, stereo)
    assert cuda_lib.launch_counts["obs_info"] == before + 1
    again = obs_info_cuda.obs_info(*args, *cam, stereo)
    assert torch.equal(obs, again[0]) and torch.equal(base, again[1])
    want = observability.pose_info_for_selection_ref(*args, *cam, stereo)
    rows = (obs != want[0]).flatten(1).any(1)
    assert not rows.any(), f"{int(rows.sum())} of {rows.numel()} matrices differ"
    if 0 < kp_pos.shape[0] <= SMALL_N:
        assert (base - want[1]).abs().max() <= BASE_RTOL * want[1].abs().max()
    else:
        assert torch.equal(base, want[1])
    # the selection as the local step runs it, on the same uniforms
    n_select = min(160, P := pos.shape[0])
    u = good_feature.lazier_uniforms(obs, n_select, torch.Generator(device=obs.device)
                                     .manual_seed(P), 10)
    sets = [good_feature.lazier_greedy_select(M, valid, n_select, None, 10, b, uniforms=u)[0]
            for M, b in ((obs, base), want)]
    tally["calls"] += 1
    tally["equal"] += bool(torch.equal(sets[0], sets[1]))


def _selections_hold(tally, label):
    """Print the tally; every call picked the same set on both."""
    print(f"{label}: {tally['calls']} calls, selections equal {tally['equal']}")
    assert tally["equal"] == tally["calls"]


def _tally():
    return {"calls": 0, "equal": 0}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stereo", [True, False], ids=["stereo", "mono"])
def test_kernel_equals_plain_version_on_the_card(stereo):
    """Synthetic pools at the path's shape and small, with and without a
    matched keypoint."""
    dev = _card()
    tally = _tally()
    for seed, P, n, matched in ((70, 4096, 1024, True), (71, 37, 16, True),
                                (72, 300, 64, False), (73, 4096, 1024, True),
                                (74, 129, 1, True), (75, 128, 0, False)):
        _held(_inputs(seed, P, n, matched, dev), (FX, FY, BF), stereo, tally)
    _selections_hold(tally, "synthetic")


def _rendered_world():
    """tests/rendered_world.py by its path (no `tests` package needed)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rendered_world.py")
    spec = importlib.util.spec_from_file_location("rendered_world_obs_info", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_kernel_on_the_main_path_inputs(monkeypatch):
    """A stereo System on 20 rendered frames (320x240, 600 features, the
    pool's 4,096 slots): every call of `pose_info_for_selection` launches the
    kernel once; each call's inputs, kept, hold the kernel against the plain
    version."""
    from gf_orb_slam2_tpu_torch import config as tc
    from gf_orb_slam2_tpu_torch.system import System

    dev = _card()
    f = 225.0
    cam = tc.CameraConfig(width=320, height=240, fx=f, fy=f, cx=160.0, cy=120.0, bf=f * 0.1,
                          th_depth=40.0)
    cfg = tc.SystemConfig(
        sensor=tc.Sensor.STEREO, camera=cam, orb=tc.ORBConfig(n_features=600),
        capacity=tc.CapacityConfig(max_keypoints=640, max_map_points=8000, max_keyframes=40),
        tracking=tc.TrackingConfig(async_mapping=False),
        loop=tc.LoopClosingConfig(enabled=False))
    kept = []
    real = observability.pose_info_for_selection

    def keep(*a):
        kept.append([x.clone() if torch.is_tensor(x) else x for x in a])
        before = cuda_lib.launch_counts["obs_info"]
        out = real(*a)
        assert cuda_lib.launch_counts["obs_info"] == before + 1
        return out

    monkeypatch.setattr(observability, "pose_info_for_selection", keep)
    rw = _rendered_world()
    world = rw.RoomWorld(width=9.0, height=5.5, length=13.0)
    slam = System(cfg, device=dev)
    try:
        for i, (R, t) in enumerate(rw.trajectory_tour(300)[:20]):
            left, right = world.render_stereo(R, t, baseline=0.1, fx=f, fy=f, cx=160.0, cy=120.0,
                                              w=320, h=240)
            slam.track_stereo(np.clip(left, 0, 255).astype(np.uint8),
                              np.clip(right, 0, 255).astype(np.uint8), i / 20.0)
    finally:
        slam.shutdown()
    fused = sum(s.path == "fused" for s in slam.tracker.stats)
    assert len(kept) >= fused >= 15
    tally = _tally()
    for a in kept:
        tensors, cam, stereo = a[:8], a[8:11], a[11]
        assert tensors[2].shape[0] == 4096 and stereo and int(tensors[4].sum()) > 100
        _held(tensors, cam, stereo, tally)
    _selections_hold(tally, "main path")

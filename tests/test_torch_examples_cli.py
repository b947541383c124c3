"""The port's offline CLI (examples/*_torch.py) and its scaling harness, run
as the subprocesses a user starts, modelled on tests/test_examples_cli.py.

Not slow: `eval_ate_torch.py` and the JAX package's `eval_ate.py` print the
same JSON (floats at 1e-9: both evaluate in float64 numpy) on the same
trajectory and ground truth, in TUM and EuRoC-CSV form and with Sim3
alignment; `run_stereo_torch.py --device cpu` on a few rendered frames at
320x240 returns 0 with the summary's keys and writes its files;
`batch_sweep_torch.py` writes one row per budget;
`scaling_bench --device cpu --devices 1 2` prints one row per world size.
Slow: the JAX test's whole chain (36 rendered frames at 640x480 in EuRoC
layout → run_stereo_torch → eval_ate_torch, ATE < 0.25 m).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from tests.rendered_world import RoomWorld, trajectory_arc  # noqa: E402
from tests.test_examples_cli import _quat_wxyz  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
N_ARC = 36


def _run(args, timeout):
    out = subprocess.run([sys.executable] + args, capture_output=True, text=True,
                         env=ENV, cwd=REPO, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out.stdout.strip().splitlines()


def _script(name):
    return os.path.join(REPO, "examples", name)


def write_euroc(root, n_frames, w, h, f):
    """The JAX test's rendered arc (its first `n_frames` poses) in EuRoC ASL
    layout at w x h, focal f, with a settings YAML; returns (sequence dir,
    settings path, ground-truth CSV)."""
    world = RoomWorld(width=9.0, height=5.0, length=13.0)
    poses = trajectory_arc(N_ARC, radius=0.8, advance=1.5)[:n_frames]
    seq = root / "seq"
    cams = [seq / "mav0" / c for c in ("cam0", "cam1")]
    gt_dir = seq / "mav0" / "state_groundtruth_estimate0"
    for d in [c / "data" for c in cams] + [gt_dir]:
        d.mkdir(parents=True)
    rows, gt_rows = [], []
    for i, (R_cw, t_cw) in enumerate(poses):
        views = world.render_stereo(R_cw, t_cw, baseline=0.1, fx=f, fy=f,
                                    cx=w / 2, cy=h / 2, w=w, h=h)
        ts_ns = int((1.0 + i / 20.0) * 1e9)
        name = f"{ts_ns}.png"
        for cam, im in zip(cams, views):
            cv2.imwrite(str(cam / "data" / name), np.clip(im, 0, 255).astype(np.uint8))
        rows.append(f"{ts_ns},{name}")
        c = -R_cw.T @ t_cw
        q = _quat_wxyz(R_cw.T)
        gt_rows.append(f"{ts_ns},{c[0]},{c[1]},{c[2]},{q[0]},{q[1]},{q[2]},{q[3]}"
                       ",0,0,0,0,0,0,0,0,0")
    for cam in cams:
        (cam / "data.csv").write_text("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
    gt = gt_dir / "data.csv"
    gt.write_text("#timestamp, p_RS_R_x [m], ...\n" + "\n".join(gt_rows) + "\n")
    settings = root / "rendered.yaml"
    settings.write_text(
        "Sensor: STEREO\n"
        f"Camera.fx: {f}\nCamera.fy: {f}\nCamera.cx: {w / 2}\nCamera.cy: {h / 2}\n"
        f"Camera.width: {w}\nCamera.height: {h}\n"
        f"Camera.bf: {f * 0.1}\nCamera.fps: 20.0\nThDepth: 40.0\n"
        f"ORBextractor.nFeatures: {500 if w == 640 else 600}\n")
    return seq, settings, gt


def _trajectories(tmp_path):
    """An estimate (the ground truth moved, rotated and jittered, with a
    dropped stamp) in TUM form, its ground truth in TUM and EuRoC-CSV form."""
    rng = np.random.default_rng(0)
    n = 60
    ts = 1.0 + np.arange(n) / 20.0
    pos = np.stack([np.cos(ts), np.sin(2 * ts), 0.1 * ts], -1)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    a = 0.3
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    est = 1.7 * pos @ R.T + [0.5, -0.2, 1.0] + rng.normal(0, 0.01, (n, 3))
    keep = np.arange(n) != 7
    tum = lambda t, p, qq: "".join(
        f"{a:.6f} {b[0]} {b[1]} {b[2]} {c[0]} {c[1]} {c[2]} {c[3]}\n" for a, b, c in zip(t, p, qq))
    est_path = tmp_path / "est.txt"
    est_path.write_text(tum(ts[keep] + 0.003, est[keep], q[keep]))
    gt_tum = tmp_path / "gt.txt"
    gt_tum.write_text(tum(ts, pos, q))
    gt_csv = tmp_path / "gt.csv"
    gt_csv.write_text("#timestamp, p_RS_R_x [m], ...\n" + "".join(
        f"{int(round(t * 1e9))},{p[0]},{p[1]},{p[2]},{qq[3]},{qq[0]},{qq[1]},{qq[2]}\n"
        for t, p, qq in zip(ts, pos, q)))
    return est_path, gt_tum, gt_csv


@pytest.mark.parametrize("gt_form,extra", [("tum", []), ("csv", []), ("csv", ["--scale"])],
                         ids=["tum", "euroc_csv", "euroc_csv_scale"])
def test_eval_ate_prints_what_the_jax_script_prints(tmp_path, gt_form, extra):
    est, gt_tum, gt_csv = _trajectories(tmp_path)
    gt = gt_tum if gt_form == "tum" else gt_csv
    args = [str(est), str(gt), "--max-dt", "0.02"] + extra
    want = json.loads(_run([_script("eval_ate.py")] + args, 300)[-1])
    got = json.loads(_run([_script("eval_ate_torch.py")] + args, 120)[-1])
    assert sorted(got) == sorted(want)
    assert got["n_pairs"] == want["n_pairs"] == 59
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-9, err_msg=k)


def test_run_stereo_and_batch_sweep_on_the_cpu(tmp_path):
    """A few rendered frames at 320x240 through both entry points with
    `--device cpu`."""
    seq, settings, _ = write_euroc(tmp_path, 4, 320, 240, 225.0)
    out = tmp_path / "out"
    lines = _run([_script("run_stereo_torch.py"), "--format", "euroc", "--data", str(seq),
                  "--settings", str(settings), "--out", str(out), "--device", "cpu",
                  "--max-frames", "3", "--constr-per-frame", "120"], 300)
    summary = json.loads(lines[-1])
    assert sorted(summary) == ["frames", "keyframes", "median_ms", "points"]
    assert summary["frames"] == 3 and summary["keyframes"] >= 1 and summary["points"] > 0
    for name in ("trajectory_tum.txt", "kf_trajectory_tum.txt", "trajectory_kitti.txt",
                 "tracking_log.jsonl"):
        assert (out / name).exists(), name
    assert len((out / "trajectory_tum.txt").read_text().splitlines()) == 3

    sweep = tmp_path / "sweep"
    rows = [json.loads(x) for x in _run(
        [_script("batch_sweep_torch.py"), "--format", "euroc", "--data", str(seq),
         "--settings", str(settings), "--out", str(sweep), "--device", "cpu",
         "--max-frames", "2", "--budgets", "80", "160"], 300)]
    assert [r["budget"] for r in rows] == [80, 160]
    assert all(r["frames"] == 2 and r["lost_frames"] == 0 for r in rows)
    assert len((sweep / "sweep.jsonl").read_text().splitlines()) == 2
    assert (sweep / "budget_80" / "trajectory_tum.txt").exists()


def test_scaling_bench_prints_one_row_per_world_size():
    lines = _run(["-m", "gf_orb_slam2_tpu_torch.parallel.scaling_bench", "--device", "cpu",
                  "--devices", "1", "2", "--points", "512", "--iters", "1"], 300)
    rows = [json.loads(x) for x in lines if x.startswith("{")]
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert r["points"] == 512 and r["device"] == "cpu"
        assert np.isfinite(r["ms_per_iter"]) and np.isfinite(r["cost"])
    assert rows[0]["strong_speedup"] == 1.0


@pytest.mark.slow
def test_run_stereo_euroc_then_eval_ate(tmp_path):
    seq, settings, gt = write_euroc(tmp_path, N_ARC, 640, 480, 450.0)
    out = tmp_path / "out"
    summary = json.loads(_run(
        [_script("run_stereo_torch.py"), "--format", "euroc", "--data", str(seq),
         "--settings", str(settings), "--out", str(out), "--device", "cpu"], 3000)[-1])
    assert summary["frames"] == N_ARC
    assert summary["keyframes"] >= 1
    traj = out / "trajectory_tum.txt"
    assert traj.exists() and len(traj.read_text().splitlines()) > N_ARC // 2
    assert (out / "trajectory_kitti.txt").exists()
    assert (out / "tracking_log.jsonl").exists()
    metrics = json.loads(_run([_script("eval_ate_torch.py"), str(traj), str(gt),
                               "--max-dt", "0.03"], 600)[-1])
    assert "ate_rmse" in metrics and np.isfinite(metrics["ate_rmse"])
    assert metrics["ate_rmse"] < 0.25, metrics

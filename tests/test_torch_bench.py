"""bench_torch.py (bench.py on the port) and the port's offline tools, on the
CPU.

`bench_torch.run` drives bench.py's schedule on the tour's first 20 frames
at bench.py's size (640x480), rendered here without the cache, with
device="cpu": the result carries exactly the keys of the dict literal that
bench.py prints (read from bench.py's source with `ast`), every frame comes
back once and OK, and the mapping worker's BA accounting holds. bench.py's
timed window starts at frame 40, past the prefix, so no frame is measured
here; the full 300-frame run is on the card (chip_smoke.py phase `bench`).
bench_torch.py keeps its own copy of bench.py's scene and cache reader,
held here to bench.py's constants and cache format. `main` exits 1 with
bench.py's "BENCH FAILED" line when the ATE is above 0.20 m or not finite.
The tools: both answer --help, a two-image vocabulary trained by
train_vocabulary_torch.py loads back, and charuco_tools_torch.py draws the
JAX tool's board pixel for pixel.
"""
import ast
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import bench_torch
from gf_orb_slam2_tpu_torch.ops import hamming_cuda
from gf_orb_slam2_tpu_torch.place.vocabulary import Vocabulary

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PREFIX = 20


def bench_py():
    """bench.py loaded by its path (its module level imports the standard
    library and numpy only; JAX only inside main, which is never called)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_py_keys():
    """The keys of the dict literal in bench.py's print(json.dumps({...}))."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("bench.py prints no dict literal")


@pytest.fixture(scope="module")
def bench():
    poses, gt = bench_torch.tour_poses()
    imgs, gt = bench_torch.render(poses[:N_PREFIX]), gt[:N_PREFIX]
    details = {}
    res = bench_torch.run(imgs, gt, device="cpu", details=details)
    return dict(imgs=imgs, gt=gt, res=res, details=details)


def test_result_has_exactly_bench_py_keys(bench):
    keys = bench_py_keys()
    assert len(keys) == 15 and keys[0] == "metric"
    assert list(bench["res"]) == keys
    json.dumps(bench["res"])
    assert bench["res"]["scene"] == bench_torch.SCENE


def test_frame_accounting(bench):
    res, d = bench["res"], bench["details"]
    assert d["returned"] == list(range(N_PREFIX)), "every frame once, in order"
    stats = d["system"].tracker.stats
    assert [s.state for s in stats] == ["OK"] * N_PREFIX
    assert res["n_frames_measured"] == 0 == len(d["times"]), "the window starts at 40"
    assert len(d["trace"]) == N_PREFIX - bench_torch.SYNC_FRAMES
    assert len(d["sync_times"]) == bench_torch.SYNC_FRAMES - 10
    assert res["n_stream_fallbacks"] + sum(
        s.path == "stream" for s in stats) == N_PREFIX - bench_torch.SYNC_FRAMES
    assert np.isfinite(res["ate_m"]) and res["ate_m"] < bench_torch.ATE_LIMIT
    assert all(np.isnan(res[k]) for k in ("value", "vs_baseline", "median_ms", "p90_ms"))
    assert res["sync_latency_ms"] > 0
    assert bench_torch.check(res) == 0


def test_ba_accounting(bench):
    res, d = bench["res"], bench["details"]
    created = sum(bool(s.created_kf) for s in d["system"].tracker.stats)
    assert created >= 1
    assert res["n_ba_runs"] + res["n_ba_merged"] == d["n_kf_events"] == created
    assert res["n_keyframes"] >= created


def test_wait_prewarm_on_the_cpu_has_nothing_pending(bench, monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU System built the CUDA kernels")

    monkeypatch.setattr(hamming_cuda, "load", no_build)
    assert bench["details"]["system"].wait_prewarm(timeout=0) is None
    assert bench["res"]["prewarm_s"] == 0.0


def test_scene_and_cache_format_match_bench_py(monkeypatch, tmp_path):
    """bench_torch.py's copy of bench.py's scene constants and cache reader:
    the same values, and the same prefix served from one cache file (its
    images stand-ins of the right count; only the ground truth is real)."""
    bench = bench_py()
    for name in ("BASELINE_MS", "N_FRAMES", "WARM", "FX", "FY", "CX", "CY", "BASELINE_M",
                 "BF", "_CACHE"):
        assert getattr(bench_torch, name) == getattr(bench, name), name
    _, gt = bench_torch.tour_poses()
    cache = tmp_path / "tour.npz"
    imgs = np.random.default_rng(0).integers(0, 256, (bench.N_FRAMES, 2, 3, 4), np.uint8)
    np.savez(cache, imgs=imgs, gt=gt)
    monkeypatch.setattr(bench, "_CACHE", str(cache))
    monkeypatch.setattr(bench_torch, "_CACHE", str(cache))
    want, got = bench.render_sequence(7), bench_torch.render_sequence(7)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], imgs[:7])


@pytest.mark.parametrize("ate", [0.5, float("nan")])
def test_ate_breach_fails_the_run(bench, monkeypatch, capsys, tmp_path, ate):
    """main() on the fixture's frames and result with the ATE forced past the
    limit: the JSON line, then "BENCH FAILED" and exit code 1; BENCH_TRACE
    writes the trace file with the mapper's stage ms."""
    seen = {}

    def fake_run(imgs, gt, device, details):
        seen["device"] = device
        details.update(bench["details"])
        return dict(bench["res"], ate_m=ate)

    def fake_render(n_frames):
        seen["frames"] = n_frames
        return bench["imgs"], bench["gt"]

    monkeypatch.setattr(bench_torch, "render_sequence", fake_render)
    monkeypatch.setattr(bench_torch, "run", fake_run)
    monkeypatch.setenv("BENCH_TRACE", "1")
    monkeypatch.chdir(tmp_path)
    assert bench_torch.main([]) == 1
    assert seen["device"] == "cuda", "the default device is the card"
    assert seen["frames"] == bench_torch.N_FRAMES == 300
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == bench_py_keys()
    assert "BENCH FAILED" in err
    trace = json.load(open(tmp_path / bench_torch.TRACE_FILE))
    assert len(trace["trace"]) == N_PREFIX - bench_torch.SYNC_FRAMES
    stages = trace["mapper_device_ms"]
    assert "local_ba" in stages
    assert len(stages["local_ba"]) == len(bench["details"]["system"].mapper.event_ms)
    assert bench_torch.main(["--device", "cpu", "--frames", "60"]) == 1
    assert seen["device"] == "cpu" and seen["frames"] == 60
    for bad in ("40", "301"):
        with pytest.raises(SystemExit) as e:
            bench_torch.main(["--frames", bad])
        assert e.value.code == 2


# ------------------------------------------------------------------- tools
def _run_tool(*args):
    # the JAX package's tools find it on the path only from the repo root
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=120)


@pytest.mark.parametrize("tool", ["tools/train_vocabulary_torch.py",
                                  "tools/charuco_tools_torch.py"])
def test_tool_help(tool):
    p = _run_tool(tool, "--help")
    assert p.returncode == 0, p.stderr
    assert "usage" in p.stdout


def test_train_vocabulary_on_two_images(bench, tmp_path):
    paths = []
    for i in (0, 10):
        path = tmp_path / f"img{i}.png"
        cv2.imwrite(str(path), bench["imgs"][i, 0][::2, ::2])
        paths.append(str(path))
    out = tmp_path / "voc.npz"
    p = _run_tool("tools/train_vocabulary_torch.py", "--images", *paths, "--out", str(out),
                  "--k", "4", "--levels", "2", "--n-features", "300", "--device", "cpu")
    assert p.returncode == 0, p.stdout + p.stderr
    assert f"saved {out}" in p.stdout
    voc = Vocabulary.load(str(out), device="cpu")
    assert (voc.k, voc.levels, voc.V) == (4, 2, 16)
    assert voc.idf.shape == (16,) and np.isfinite(voc.idf).all()
    n = [int(line.rsplit(": ", 1)[1].split()[0]) for line in p.stdout.splitlines()
         if line.startswith(str(tmp_path))]
    assert len(n) == 2 and min(n) > 100


def test_charuco_create_draws_the_jax_tools_board(tmp_path):
    outs = []
    for tool in ("tools/charuco_tools.py", "tools/charuco_tools_torch.py"):
        out = tmp_path / (os.path.basename(tool) + ".png")
        p = _run_tool(tool, "create", "--out", str(out), "--px-w", "250", "--px-h", "350")
        assert p.returncode == 0, p.stdout + p.stderr
        outs.append(cv2.imread(str(out), cv2.IMREAD_GRAYSCALE))
    assert outs[1] is not None and outs[1].shape == (350, 250)
    np.testing.assert_array_equal(outs[1], outs[0])

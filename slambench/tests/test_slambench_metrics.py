"""The metric arithmetic on runs and traces made up here: percentiles over
all frames, the device trace's intervals and launches, the roofline counts,
and the check's verdicts."""
import numpy as np
import torch
from torch.autograd import DeviceType

from slambench.core import bench, readers, roofline, trace
from slambench.reference import check


def open_loop_run(latencies_ms, returned=None):
    run = bench.Run()
    for k, lat in enumerate(latencies_ms):
        due = 100.0 + k * 0.05
        run.frames.append({"i": k, "due": due, "start": due, "end": due + lat / 1e3})
    run.returned = {k: np.eye(4) for k in (range(len(latencies_ms)) if returned is None
                                           else returned)}
    return run


def test_latency_statistics_take_every_frame():
    lat = [20.0] * 95 + [400.0] * 5 + [1000.0]
    run = open_loop_run(lat)
    assert abs(bench.reader("frame_latency_p50_ms")(run) - 20.0) < 1e-6
    assert abs(readers.latency_percentile_ms(run, 95) - np.percentile(lat, 95)) < 1e-6
    assert readers.latency_percentile_ms(run, 95) > 20.0
    # no chunk medians: one slow frame in twenty moves the tail
    assert readers.latency_percentile_ms(open_loop_run([10.0] * 19 + [500.0]), 95) > 10.0


def test_latency_reads_nothing_without_returned_frames():
    run = open_loop_run([20.0] * 10, returned=[])
    assert bench.reader("frame_latency_p50_ms")(run) is None
    # a frame that never came back is not in the set (it fails the run instead)
    assert abs(readers.latency_percentile_ms(open_loop_run([20.0, 30.0, 900.0],
                                                           returned=[0, 1]), 50) - 25.0) < 1e-9


class Ev:
    def __init__(self, kind, name, s, d, tid=1):
        self.kind, self.n, self.s, self.d, self.tid = kind, name, s, d, tid

    def device_type(self):
        return DeviceType.CUDA if self.kind in ("kernel", "gpu_memcpy") else DeviceType.CPU

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def start_thread_id(self):
        return self.tid


def made_trace():
    ev = [Ev("user_annotation", trace.FRAME, 0, 100), Ev("user_annotation", trace.FRAME, 200, 100),
          Ev("user_annotation", trace.WAIT, 0, 30),
          Ev("kernel", "pose_lm_kernel<4>", 10, 20), Ev("kernel", "other", 20, 30),
          Ev("kernel", "greedy_select_kernel<7,512>", 250, 10), Ev("gpu_memcpy", "Memcpy", 400, 50),
          Ev("kernel", trace.FRAME, 0, 100),  # the device's copy of a range: no work
          Ev("cuda_runtime", "cudaLaunchKernel", 5, 1), Ev("cuda_runtime", "cudaLaunchKernel", 40, 1),
          Ev("cuda_runtime", "cudaLaunchKernel", 60, 1), Ev("cuda_runtime", "cudaLaunchKernel", 210, 1),
          Ev("cuda_runtime", "cudaLaunchKernel", 220, 1, tid=7),
          Ev("cuda_runtime", "cudaMemcpyAsync", 230, 1), Ev("cuda_runtime", "cudaLaunchKernel", 350, 1)]
    return trace.DeviceTrace(ev, 0, 500)


def test_device_trace_intervals_and_launches():
    t = made_trace()
    run = bench.Run()
    run.trace = t
    assert t.window_s == 500e-9
    assert t.busy_s() * 1e9 == 40 + 10 + 50  # [10,50] + [250,260] + [400,450]
    assert t.busy_s(0, 100) * 1e9 == 40 and t.busy_s(200, 300) * 1e9 == 10
    # idle inside the frames' calls: 1 - 50 / 200
    assert abs(readers.idle_in_frames_pct(run) - 75.0) < 1e-9
    assert abs(100 * (1 - t.busy_s() / t.window_s) - 80.0) < 1e-9
    # the frames' thread only, inside the calls; the wait [0,30] taken out
    assert readers.launches_per_frame(run) == 3 / 2
    assert t.op_seconds("pose_lm") * 1e9 == 20
    b = t.breakdown([trace.FRAME, trace.WAIT])
    assert b["device_ops"][0] == ["Memcpy", 50e-9]
    idle = dict(b["idle_gaps"])
    assert abs(idle["outside"] * 1e9 - (100 + 100 + 50)) < 1e-6
    assert abs(idle[trace.WAIT] * 1e9 - 10) < 1e-6
    assert abs(idle[trace.FRAME] * 1e9 - (50 + 50 + 40)) < 1e-6


def test_roofline_counts():
    # chip_smoke.py's counts at the main path's N = 1024, 3 x 8
    n = 1024
    assert roofline.pose_lm_least_s(n, 3, 8) == max(
        (48 + 29 * n + 48 + 5 * n + 8) / 3.35e12, n * (302 * 24 + 78) / 67e12)
    assert roofline.logdet_flops(1) == 3 + 4 + 5 + 2 + 2
    assert roofline.logdet_flops(7) == 21 + 112 + sum(
        2 * j + 5 + (6 - j) * (2 * j + 1) for j in range(7)) + 16
    # a selection of 2 rounds of 2 picks from 5 slots, one invalid; the
    # lazier sample takes the slots whose uniform is under 1/2
    call = {"P": 5, "D": 7, "n_select": 4, "batch": 2, "lazier": 2, "base": False,
            "valid": torch.tensor([True, True, True, True, False]),
            "uniforms": torch.tensor([[0.1, 0.9, 0.2, 0.8, 0.0], [0.9, 0.9, 0.9, 0.9, 0.9]]),
            "order": torch.tensor([0, 2, 1, 3])}
    # round 1: 4 candidates, 2 sampled; round 2: 2 candidates, none under
    # 1/2 so all 2 scored
    flops = 4 * roofline.logdet_flops(7) + 6 * 8
    bytes_ = 5 * 49 * 4 + 5 + 10 * 4 + 5 + 2 * 2 * 8
    assert roofline.greedy_select_least_s(call) == max(bytes_ / 3.35e12, flops / 67e12)


def test_roofline_share_reads_nothing_without_calls():
    run = bench.Run()
    run.trace = made_trace()
    run.spans = trace.Spans()
    assert bench.reader("pose_lm_roofline")(run) is None
    run.spans.calls["slambench.pose_lm"].append({"n": 1024, "rounds": 3, "iters": 8})
    share = bench.reader("pose_lm_roofline")(run)
    assert share == 100.0 * roofline.pose_lm_least_s(1024, 3, 8) / 20e-9


def test_check_on_the_truth_and_off_it():
    R_wc = np.stack([np.eye(3)] * 60)
    C = np.stack([np.zeros(60), np.zeros(60), np.arange(60) * 0.04], -1)
    truth = {"R_wc": R_wc, "C": C, "fps": 20.0, "box": (9.0, 5.5, 30.0)}
    limits = {"ate_m": 0.01, "rpe_p95_m": 0.01, "kf_ate_m": 0.01, "map_err_m": 0.01}

    def T(i, shift=0.0):
        out = np.eye(4)
        out[:3, 3] = -(C[i] - C[0]) - shift  # the world is frame 0's camera
        return out

    pts = np.array([[4.5, 0.0, 3.0], [0.0, 2.75, 7.0], [-4.5, 1.0, 1.0]]) - C[0]
    good = {"T_cw": {i: T(i) for i in range(60)}, "attempted": 60, "kf_ids": [0, 20, 40],
            "kf_T_cw": [T(0), T(20), T(40)], "points": pts}
    v = check.judge(good, truth, limits)
    assert v["correct"], v
    assert v["numbers"]["ate_m"][0] < 1e-9 and v["numbers"]["map_err_m"][0] < 1e-9
    stale = dict(good, T_cw={i: T(0) for i in range(60)})
    assert not check.judge(stale, truth, limits)["correct"]
    few = dict(good, T_cw={i: T(i) for i in range(20)})
    assert not check.judge(few, truth, limits)["correct"]


def test_tracked_share_limit():
    # sound runs track every frame; more than 1 % of the offered frames LOST
    # (or not back) is not correct, whatever the poses read
    R_wc = np.stack([np.eye(3)] * 300)
    C = np.stack([np.zeros(300), np.zeros(300), np.arange(300) * 0.04], -1)
    truth = {"R_wc": R_wc, "C": C, "fps": 20.0, "box": (9.0, 5.5, 30.0)}

    def T(i):
        out = np.eye(4)
        out[:3, 3] = -(C[i] - C[0])
        return out

    out = {"T_cw": {i: T(i) for i in range(300)}, "attempted": 300, "kf_ids": [0, 100, 200],
           "kf_T_cw": [T(0), T(100), T(200)],
           "points": np.array([[4.5, 0.0, 3.0], [-4.5, 1.0, 1.0]]) - C[0]}
    assert check.judge(out, truth, {"ate_m": 0.01})["correct"]
    three_lost = dict(out, T_cw={i: T(i) for i in range(3, 300)})
    v = check.judge(three_lost, truth, {"ate_m": 0.01})
    assert v["correct"] and v["numbers"]["tracked_share"] == (0.99, check.MIN_TRACKED_SHARE)
    four_lost = dict(out, T_cw={i: T(i) for i in range(4, 300)})
    assert not check.judge(four_lost, truth, {"ate_m": 0.01})["correct"]

"""Dataset readers: EuRoC, TUM RGB-D, KITTI odometry directory formats.

The reference consumes data via ROS topics (Examples/ROS/GF_ORB_SLAM2/src/
ros_stereo.cc) or the stock ORB-SLAM2 example loaders; this module provides
the equivalent offline drivers. Zero-egress environments use the synthetic
harness in tests/ instead; these loaders exist for real-dataset runs.
"""
from __future__ import annotations

import csv
import os
from typing import Iterator, Tuple

import numpy as np


def _imread_gray(path):
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img


class EurocStereo:
    """EuRoC ASL format: mav0/cam0/data.csv + data/<ts>.png (and cam1)."""

    def __init__(self, root: str):
        self.root = root
        self.ts, self.left, self.right = [], [], []
        cam0 = os.path.join(root, "mav0", "cam0")
        cam1 = os.path.join(root, "mav0", "cam1")
        with open(os.path.join(cam0, "data.csv")) as f:
            for row in csv.reader(f):
                if row[0].startswith("#"):
                    continue
                ts_ns, name = row[0], row[1].strip()
                l = os.path.join(cam0, "data", name)
                r = os.path.join(cam1, "data", name)
                if os.path.exists(l) and os.path.exists(r):
                    self.ts.append(int(ts_ns) * 1e-9)
                    self.left.append(l)
                    self.right.append(r)

    def __len__(self):
        return len(self.ts)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        for t, l, r in zip(self.ts, self.left, self.right):
            yield _imread_gray(l), _imread_gray(r), t


class TumRgbd:
    """TUM RGB-D format: rgb.txt + depth.txt associated by nearest timestamp."""

    def __init__(self, root: str, max_dt: float = 0.02):
        self.root = root

        def read_list(name):
            out = []
            with open(os.path.join(root, name)) as f:
                for line in f:
                    if line.startswith("#"):
                        continue
                    ts, path = line.strip().split()[:2]
                    out.append((float(ts), os.path.join(root, path)))
            return out

        rgb = read_list("rgb.txt")
        depth = read_list("depth.txt")
        d_ts = np.asarray([t for t, _ in depth])
        self.pairs = []
        for t, rp in rgb:
            i = int(np.argmin(np.abs(d_ts - t)))
            if abs(d_ts[i] - t) < max_dt:
                self.pairs.append((t, rp, depth[i][1]))

    def __len__(self):
        return len(self.pairs)

    def __iter__(self):
        import cv2

        for t, rp, dp in self.pairs:
            rgb = _imread_gray(rp)
            depth = cv2.imread(dp, cv2.IMREAD_UNCHANGED).astype(np.float32)
            yield rgb, depth, t


class KittiStereo:
    """KITTI odometry format: sequences/NN/image_0, image_1, times.txt."""

    def __init__(self, root: str, sequence: str):
        seq = os.path.join(root, "sequences", sequence)
        with open(os.path.join(seq, "times.txt")) as f:
            self.ts = [float(x) for x in f.read().split()]
        self.left = [
            os.path.join(seq, "image_0", f"{i:06d}.png") for i in range(len(self.ts))
        ]
        self.right = [
            os.path.join(seq, "image_1", f"{i:06d}.png") for i in range(len(self.ts))
        ]

    def __len__(self):
        return len(self.ts)

    def __iter__(self):
        for t, l, r in zip(self.ts, self.left, self.right):
            yield _imread_gray(l), _imread_gray(r), t

"""Per-frame keypoint YAML export/import.

Reference parity: Frame::ExportToYML + KeyPointLog (reference:
src/Frame.cc:514, include/Util.hpp:397) — dump a frame's keypoints
(positions, octave, angle, response, stereo u_right/depth) for offline
inspection and cross-run comparisons. Same top-level key names.
"""
from __future__ import annotations

import numpy as np


def save_keypoints_yaml(path, frame):
    """Write one frame's (valid) keypoints to YAML."""
    v = frame.valid
    idx = np.nonzero(v)[0]
    with open(path, "w") as f:
        f.write("%YAML:1.0\n---\n")
        f.write(f"frame_id: {int(frame.frame_id)}\n")
        ts = 0.0 if frame.timestamp is None else float(frame.timestamp)
        f.write(f"timestamp: {ts:.9f}\n")
        f.write(f"n_keypoints: {len(idx)}\n")
        f.write("keypoints:\n")
        for i in idx:
            f.write(
                f"  - {{ x: {float(frame.uv[i, 0]):.3f},"
                f" y: {float(frame.uv[i, 1]):.3f},"
                f" octave: {int(frame.octave[i])},"
                f" angle: {float(frame.angle[i]):.5f},"
                f" response: {float(frame.response[i]) if frame.response is not None else 0.0:.3f},"
                f" u_right: {float(frame.u_right[i]):.3f},"
                f" depth: {float(frame.depth[i]):.4f} }}\n"
            )


def load_keypoints_yaml(path) -> dict:
    """Load a keypoint YAML back into arrays (round-trip of the above)."""
    import re

    meta = {}
    rows = []
    pat = re.compile(
        r"x: ([-\d.]+), y: ([-\d.]+), octave: (\d+), angle: ([-\d.]+), "
        r"response: ([-\d.]+), u_right: ([-\d.]+), depth: ([-\d.]+)")
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("frame_id:"):
                meta["frame_id"] = int(line.split(":")[1])
            elif line.startswith("timestamp:"):
                meta["timestamp"] = float(line.split(":")[1])
            else:
                m = pat.search(line)
                if m:
                    rows.append([float(g) for g in m.groups()])
    arr = np.asarray(rows, np.float64) if rows else np.zeros((0, 7))
    meta.update(
        uv=arr[:, :2].astype(np.float32),
        octave=arr[:, 2].astype(np.int32),
        angle=arr[:, 3].astype(np.float32),
        response=arr[:, 4].astype(np.float32),
        u_right=arr[:, 5].astype(np.float32),
        depth=arr[:, 6].astype(np.float32),
    )
    return meta

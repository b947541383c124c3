"""Offline visualization: frame overlays, map renders, PLY export.

Replaces the reference's Pangolin GUI thread (Viewer/FrameDrawer/MapDrawer,
src/Viewer.cc:55, src/FrameDrawer.cc:38, src/MapDrawer.cc:42-176) and the
ROS rviz marker publisher (src/MapPublisher.cc:116) with offline writers —
a headless GPU host has no GL/ROS, so visual state is rendered to files:
- `draw_frame`: keypoint/match overlay image (FrameDrawer parity);
- `plot_map`: top-down + side map/trajectory/covisibility plot;
- `export_ply`: point cloud + camera frustums for external viewers
  (the MapPublisher's role, minus the transport).
"""
from __future__ import annotations

import numpy as np


def draw_frame(img: np.ndarray, frame) -> np.ndarray:
    """Annotate keypoints: green = tracked map point, blue = unmatched
    (reference: FrameDrawer::DrawFrame state colors)."""
    import cv2

    out = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_GRAY2BGR)
    for i in np.nonzero(frame.valid)[0]:
        u, v = int(frame.uv[i, 0]), int(frame.uv[i, 1])
        if frame.mp_ids[i] >= 0:
            cv2.rectangle(out, (u - 3, v - 3), (u + 3, v + 3), (0, 255, 0), 1)
        else:
            cv2.circle(out, (u, v), 2, (255, 160, 0), 1)
    n_tracked = int((frame.mp_ids >= 0).sum())
    cv2.putText(out, f"tracked: {n_tracked}", (10, 20),
                cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
    return out


def plot_map(store, path, show_covis=True):
    """Top-down (x-z) and side (z-y) map render with KF trajectory and
    covisibility edges (reference: MapDrawer::DrawMapPoints/DrawKeyFrames)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = store.point_pos[store.point_valid]
    kfs = store.valid_kf_ids()
    centers = store.kf_center(kfs) if kfs.size else np.zeros((0, 3))
    fig, axes = plt.subplots(1, 2, figsize=(14, 7))
    for ax, (a, b, la, lb) in zip(axes, [(0, 2, "x", "z"), (2, 1, "z", "y")]):
        if len(pts):
            ax.scatter(pts[:, a], pts[:, b], s=0.5, c="#888888", alpha=0.5)
        if len(centers):
            ax.plot(centers[:, a], centers[:, b], "-o", color="#1f77b4", ms=3)
        if show_covis and kfs.size:
            for i, k in enumerate(kfs):
                for nb in store.covisible_kfs(int(k), 5):
                    j = np.nonzero(kfs == nb)[0]
                    if j.size:
                        ax.plot(
                            [centers[i, a], centers[j[0], a]],
                            [centers[i, b], centers[j[0], b]],
                            color="#2ca02c", lw=0.3, alpha=0.5,
                        )
        ax.set_xlabel(la)
        ax.set_ylabel(lb)
        ax.set_aspect("equal", adjustable="datalim")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def export_ply(store, path):
    """Map points + KF centers as a PLY point cloud."""
    pts = store.point_pos[store.point_valid]
    kfs = store.valid_kf_ids()
    centers = store.kf_center(kfs) if kfs.size else np.zeros((0, 3))
    n = len(pts) + len(centers)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p in pts:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} 160 160 160\n")
        for c in centers:
            f.write(f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f} 30 120 255\n")

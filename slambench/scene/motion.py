"""Camera trajectories through the hall, from a traffic mix's parameters and
a seed.

One general motion: the camera advances along the hall's axis (+z) at a
constant speed and weaves sideways, up and down and in yaw, pitch and roll,
each a sinusoid whose amplitude and period the mix fixes and whose phase the
seed draws. So every seed gives the same speeds and angular rates, and the
same amount of work, along another path. The path never turns back, though
the weave may bring a wall's patch back into view from a keyframe that no
longer shares points with the current one, which place recognition can
take for a loop. A camera may look sideways (`yaw_rad`), at a wall it
passes, instead of down the hall.
"""
from __future__ import annotations

import numpy as np

AXES = ("sway_x", "sway_y", "yaw", "pitch", "roll")


def rotation(yaw, pitch, roll):
    """Camera-to-world rotations [n,3,3]: yaw about y, pitch about x, roll
    about z (rendered_world.py's rpy_pose order, R_wc = Ry Rx Rz)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    n = len(yaw)
    Ry = np.zeros((n, 3, 3))
    Ry[:, 0, 0], Ry[:, 0, 2], Ry[:, 1, 1], Ry[:, 2, 0], Ry[:, 2, 2] = cy, sy, 1, -sy, cy
    Rx = np.zeros((n, 3, 3))
    Rx[:, 0, 0], Rx[:, 1, 1], Rx[:, 1, 2], Rx[:, 2, 1], Rx[:, 2, 2] = 1, cp, -sp, sp, cp
    Rz = np.zeros((n, 3, 3))
    Rz[:, 0, 0], Rz[:, 0, 1], Rz[:, 1, 0], Rz[:, 1, 1], Rz[:, 2, 2] = cr, -sr, sr, cr, 1
    return Ry @ Rx @ Rz


def trajectory(motion: dict, n: int, fps: float, seed: int):
    """n camera-to-world poses at `fps`: (R_wc [n,3,3], centres [n,3]), in
    float64. `motion` holds speed_mps, start_z_m and, for each of AXES, an
    amplitude (m or rad) and a period (s); optionally x_m and yaw_rad, the
    centre of the sideways and the yaw weave (0: down the hall's axis)."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    phase = rng.uniform(0, 2 * np.pi, len(AXES))
    t = np.arange(n) / fps
    w = {k: motion[k] * np.sin(2 * np.pi * t / motion[k + "_period_s"] + p)
         for k, p in zip(AXES, phase)}
    centres = np.stack([motion.get("x_m", 0.0) + w["sway_x"], w["sway_y"],
                        motion["start_z_m"] + motion["speed_mps"] * t], -1)
    return rotation(motion.get("yaw_rad", 0.0) + w["yaw"], w["pitch"], w["roll"]), centres


def hall_length(motion: dict, n: int, fps: float, ahead_m: float) -> float:
    """Length of a hall that holds the whole path and `ahead_m` beyond its
    end."""
    return motion["start_z_m"] + motion["speed_mps"] * n / fps + ahead_m

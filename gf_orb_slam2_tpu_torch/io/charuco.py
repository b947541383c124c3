"""ChArUco-board absolute pose initialization (host-side OpenCV).

Replaces the reference's ChArUco module (reference: src/ChArUco.cc:54-160,
`INIT_WITH_ARUCHO` — detects a calibration board in the first frame and
anchors the world frame to it instead of the identity pose; board-creation/
calibration tools in tools/). Board detection is classic host CV work (it
runs once at startup), so this stays a thin OpenCV wrapper.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CharucoBoard:
    squares_x: int = 5
    squares_y: int = 7
    square_len: float = 0.04   # meters
    marker_len: float = 0.02
    dictionary: str = "DICT_4X4_50"

    def build(self):
        import cv2

        dic = cv2.aruco.getPredefinedDictionary(getattr(cv2.aruco, self.dictionary))
        try:  # OpenCV >= 4.7 API
            return cv2.aruco.CharucoBoard(
                (self.squares_x, self.squares_y), self.square_len, self.marker_len, dic
            ), dic
        except AttributeError:  # legacy API
            return cv2.aruco.CharucoBoard_create(
                self.squares_x, self.squares_y, self.square_len, self.marker_len, dic
            ), dic


def detect_board_pose(
    img: np.ndarray, board_cfg: CharucoBoard, K: np.ndarray, dist: np.ndarray,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Detect the board and return the camera pose (R_cw, t_cw) with the
    world frame on the board (reference: ChArUco::process ChArUco.cc:92).
    Returns None if the board is not confidently visible."""
    import cv2

    board, dic = board_cfg.build()
    if hasattr(cv2.aruco, "CharucoDetector"):  # OpenCV >= 4.8 API
        det = cv2.aruco.CharucoDetector(board)
        ch_corners, ch_ids, mk_corners, mk_ids = det.detectBoard(img)
        if ch_ids is None or len(ch_ids) < 6:
            return None
        obj_pts, img_pts = board.matchImagePoints(ch_corners, ch_ids)
        if obj_pts is None or len(obj_pts) < 6:
            return None
        ok, rvec, tvec = cv2.solvePnP(
            obj_pts, img_pts, K.astype(np.float64),
            np.asarray(dist, np.float64))
    else:  # legacy API
        corners, ids, _ = cv2.aruco.detectMarkers(img, dic)
        if ids is None or len(ids) < 4:
            return None
        ok, ch_corners, ch_ids = cv2.aruco.interpolateCornersCharuco(
            corners, ids, img, board
        )
        if not ok or ch_ids is None or len(ch_ids) < 6:
            return None
        ok, rvec, tvec = cv2.aruco.estimatePoseCharucoBoard(
            ch_corners, ch_ids, board, K.astype(np.float64),
            np.asarray(dist, np.float64), None, None,
        )
    if not ok:
        return None
    R, _ = cv2.Rodrigues(rvec)
    return R.astype(np.float32), tvec.reshape(3).astype(np.float32)

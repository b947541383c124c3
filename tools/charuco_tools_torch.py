#!/usr/bin/env python
"""ChArUco board creation + camera calibration utilities, on the PyTorch/CUDA
port's board definition (tools/charuco_tools.py with
`gf_orb_slam2_tpu_torch.io.charuco`: the same subcommands, arguments and
output files).

Replaces the reference's tools/create_board_charuco.cpp and
tools/calibrate_camera_charuco.cpp. Both subcommands are host OpenCV work
(board rendering, marker detection, calibration): no device is involved, so
there is no --device.

  python tools/charuco_tools_torch.py create --out board.png
  python tools/charuco_tools_torch.py calibrate --images "calib/*.png" --out calib.yaml
"""
import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gf_orb_slam2_tpu_torch.io.charuco import CharucoBoard  # noqa: E402


def _board(args):
    return CharucoBoard(args.squares_x, args.squares_y, args.square_len,
                        args.marker_len).build()


def cmd_create(args):
    import cv2

    board, _ = _board(args)
    try:
        img = board.generateImage((args.px_w, args.px_h))
    except AttributeError:
        img = board.draw((args.px_w, args.px_h))
    cv2.imwrite(args.out, img)
    print(f"wrote {args.out}")


def cmd_calibrate(args):
    import cv2

    board, dic = _board(args)
    all_corners, all_ids, size = [], [], None
    for path in sorted(glob.glob(args.images)):
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            continue
        size = img.shape[::-1]
        corners, ids, _ = cv2.aruco.detectMarkers(img, dic)
        if ids is None or len(ids) < 4:
            continue
        ok, ch_c, ch_i = cv2.aruco.interpolateCornersCharuco(corners, ids, img, board)
        if ok and ch_i is not None and len(ch_i) >= 6:
            all_corners.append(ch_c)
            all_ids.append(ch_i)
    if len(all_corners) < 4:
        raise SystemExit("not enough valid calibration views")
    ret, K, D, _, _ = cv2.aruco.calibrateCameraCharuco(
        all_corners, all_ids, board, size, None, None
    )
    print(f"reprojection error: {ret:.3f}px")
    with open(args.out, "w") as f:
        f.write(f"Camera.fx: {K[0, 0]}\nCamera.fy: {K[1, 1]}\n"
                f"Camera.cx: {K[0, 2]}\nCamera.cy: {K[1, 2]}\n"
                f"Camera.k1: {D[0, 0]}\nCamera.k2: {D[0, 1]}\n"
                f"Camera.p1: {D[0, 2]}\nCamera.p2: {D[0, 3]}\n"
                f"Camera.k3: {D[0, 4] if D.shape[1] > 4 else 0.0}\n"
                f"Camera.width: {size[0]}\nCamera.height: {size[1]}\n")
    print(f"wrote {args.out}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("create")
    c.add_argument("--out", required=True)
    c.add_argument("--squares-x", type=int, default=5)
    c.add_argument("--squares-y", type=int, default=7)
    c.add_argument("--square-len", type=float, default=0.04)
    c.add_argument("--marker-len", type=float, default=0.02)
    c.add_argument("--px-w", type=int, default=1000)
    c.add_argument("--px-h", type=int, default=1400)
    c.set_defaults(fn=cmd_create)
    k = sub.add_parser("calibrate")
    k.add_argument("--images", required=True)
    k.add_argument("--out", required=True)
    k.add_argument("--squares-x", type=int, default=5)
    k.add_argument("--squares-y", type=int, default=7)
    k.add_argument("--square-len", type=float, default=0.04)
    k.add_argument("--marker-len", type=float, default=0.02)
    k.set_defaults(fn=cmd_calibrate)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

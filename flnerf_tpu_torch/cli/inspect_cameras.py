"""Camera sanity tooling: epipolar inspector + frustum visualizer.

Port of ``flnerf_tpu/cli/inspect_cameras.py``.  Reference surfaces:
  * nerf++-ours/camera_inspector/inspect_epipolar_geometry.py — pick
    interest points in one image, draw their epipolar lines in another;
    if the lines pass through the matching content the poses are sane.
    Headless here: writes a PNG instead of a cv2 window.
  * nerf++-ours/camera_visualizer/visualize_cameras.py — frustum plot of
    every camera (open3d there, matplotlib PNG here).
Images are read through ``data/png.py`` (8-bit PNGs by its own codec);
matplotlib is imported only to draw.  The epipolar lines themselves are
``data/pose_tools.inspect_epipolar_geometry`` with no output path.

Usage:
  python -m flnerf_tpu_torch.cli.inspect_cameras epipolar \
      --cam_dict scene/cam_dict_norm.json --img_dir scene/train/rgb \
      --img1 000001.png --img2 000005.png --out epi.png
  python -m flnerf_tpu_torch.cli.inspect_cameras frustums \
      --cam_dict scene/cam_dict_norm.json --out cams.png
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from flnerf_tpu_torch.data.png import imread
from flnerf_tpu_torch.data.pose_tools import inspect_epipolar_geometry, plot_camera_frustums


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", choices=["epipolar", "frustums"])
    p.add_argument("--cam_dict", required=True)
    p.add_argument("--img_dir", default=None)
    p.add_argument("--img1", default=None)
    p.add_argument("--img2", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--n_points", type=int, default=12)
    a = p.parse_args(argv)

    with open(a.cam_dict) as f:
        cam_dict = json.load(f)
    if a.mode == "frustums":
        plot_camera_frustums(cam_dict, a.out)
        print(f"wrote {a.out} ({len(cam_dict)} cameras)")
        return None

    if not (a.img1 and a.img2 and a.img_dir):
        raise SystemExit("epipolar needs --img_dir, --img1 and --img2")
    img1 = imread(os.path.join(a.img_dir, a.img1))
    img2 = imread(os.path.join(a.img_dir, a.img2))
    c1, c2 = cam_dict[a.img1], cam_dict[a.img2]
    lines = inspect_epipolar_geometry(
        img1, np.asarray(c1["K"]).reshape(4, 4), np.asarray(c1["W2C"]).reshape(4, 4),
        img2, np.asarray(c2["K"]).reshape(4, 4), np.asarray(c2["W2C"]).reshape(4, 4),
        out_path=a.out, n_points=a.n_points,
    )
    print(f"wrote {a.out}")
    return lines


if __name__ == "__main__":
    main()

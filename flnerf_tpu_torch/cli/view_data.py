"""Dataset inspector — the plenoxels-ours/opt/scripts/view_data.py analog.

Port of ``flnerf_tpu/cli/view_data.py``.  The reference renders cameras +
images + scene bbox to an interactive nerfvis HTML scene; here the
inspector emits a camera-frustum + bbox PNG (matplotlib, through
``data/pose_tools.plot_camera_frustums``, imported only to plot) plus a text
summary of what view_data prints: dataset type, camera count, image sizes,
pose radius statistics.  ``detect_dataset_type``, ``load_scene`` and
``cam_dict_from_poses`` need no matplotlib.

Usage:
  python -m flnerf_tpu_torch.cli.view_data <data_dir> [--out data_vis.png]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def detect_dataset_type(data_dir: str) -> str:
    """opt/util/dataset.py:7-28 auto-detect order."""
    if data_dir == "synthetic":
        return "synthetic"
    if os.path.exists(os.path.join(data_dir, "transforms_train.json")):
        return "nerf"
    if os.path.exists(os.path.join(data_dir, "transforms.json")):
        return "ngp"
    if os.path.exists(os.path.join(data_dir, "intrinsics.txt")):
        return "nsvf"
    if os.path.exists(os.path.join(data_dir, "poses_bounds.npy")):
        return "llff"
    if os.path.exists(os.path.join(data_dir, "train", "pose")):
        return "nerfpp"
    raise ValueError(f"cannot auto-detect dataset type in {data_dir}")


def load_scene(data_dir: str, dtype: str):
    """-> (poses [N,4,4] c2w, hwf) of the dataset's training split, through
    the package's loaders."""
    if dtype == "synthetic":
        from flnerf_tpu_torch.data.synthetic import load_synthetic_data

        _, poses, _, hwf, _ = load_synthetic_data(n_train=8, n_test=2, H=48, W=48)
        return poses, hwf
    if dtype == "nerf":
        from flnerf_tpu_torch.data.blender import load_blender_data

        _, poses, _, hwf, _ = load_blender_data(data_dir, False, 8)
        return poses, hwf
    if dtype == "nsvf":
        from flnerf_tpu_torch.data.extra_loaders import load_nsvf_data

        _, poses, _, hwf = load_nsvf_data(data_dir, "train", 1.0)
        return poses, hwf
    if dtype == "llff":
        from flnerf_tpu_torch.data.llff import load_llff_data

        _, poses, _, _, _ = load_llff_data(data_dir, factor=8)
        hwf = poses[0, :3, -1]
        p44 = np.tile(np.eye(4, dtype=np.float32)[None], (poses.shape[0], 1, 1))
        p44[:, :3, :4] = poses[:, :3, :4]
        return p44, hwf
    if dtype == "nerfpp":
        from flnerf_tpu_torch.data.nerfpp_dataset import load_nerfpp_split

        root = data_dir.rstrip("/")
        d = load_nerfpp_split(os.path.dirname(root), os.path.basename(root), "train")
        return d["poses"], (d["H"], d["W"], float(d["intrinsics"][0, 0, 0]))
    raise ValueError(dtype)


def cam_dict_from_poses(poses, hwf) -> dict:
    """The cam-dict (``data/pose_tools`` format: K and W2C flattened 4x4,
    img_size) of c2w poses with a centred pinhole of focal hwf[2]."""
    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    K = np.eye(4)
    K[0, 0] = K[1, 1] = focal
    K[0, 2], K[1, 2] = W / 2, H / 2
    cam_dict = {}
    for i, c2w in enumerate(poses):
        c2w4 = np.eye(4)
        c2w4[:3, :4] = np.asarray(c2w)[:3, :4]
        cam_dict[f"{i:04d}"] = {"K": K.reshape(-1).tolist(),
                                "W2C": np.linalg.inv(c2w4).reshape(-1).tolist(),
                                "img_size": [W, H]}
    return cam_dict


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_dir")
    p.add_argument("--out", default="data_vis.png")
    p.add_argument("--dataset_type", default="auto")
    p.add_argument("--bbox_radius", type=float, default=1.5,
                   help="scene bbox half-extent drawn in the plot")
    a = p.parse_args(argv)

    dtype = detect_dataset_type(a.data_dir) if a.dataset_type == "auto" else a.dataset_type
    poses, hwf = load_scene(a.data_dir, dtype)
    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])

    radii = np.linalg.norm(poses[:, :3, 3], axis=-1)
    print(f"dataset type : {dtype}")
    print(f"cameras      : {poses.shape[0]}")
    print(f"image size   : {W} x {H}  focal {focal:.2f}")
    print(f"camera radius: min {radii.min():.3f}  mean {radii.mean():.3f}  "
          f"max {radii.max():.3f}")

    from flnerf_tpu_torch.data.pose_tools import plot_camera_frustums

    r = a.bbox_radius
    plot_camera_frustums(cam_dict_from_poses(poses, hwf), a.out,
                         frustum_depth=0.25 * float(radii.mean()),
                         bbox=((-r,) * 3, (r,) * 3))
    print(f"wrote {a.out}")
    return {"type": dtype, "n_cams": int(poses.shape[0]), "out": a.out}


if __name__ == "__main__":
    main()

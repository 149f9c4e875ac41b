"""Blender synthetic dataset loader (transforms_{train,val,test}.json).

Port of ``flnerf_tpu/data/blender.py`` (numpy, copied; images read through
``data/png.py``).

Parity target: nerf-ours/load_blender.py:37-91 — same split handling,
testskip, white-background compositing hook (done by the caller, as in
run_nerf.py:199-201), half_res area-resize (``data/resize.py``, OpenCV's
INTER_AREA in numpy), and the 40-pose spherical render path.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from flnerf_tpu_torch.data.png import imread
from flnerf_tpu_torch.data.resize import area_resize
from flnerf_tpu_torch.rays.camera import pose_spherical


def load_blender_data(basedir: str, half_res: bool = False, testskip: int = 1):
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json"), "r") as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(imread(fname))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)  # keep RGBA
        poses = np.array(poses).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(metas["test"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    render_poses = np.stack(
        [pose_spherical(angle, -30.0, 4.0) for angle in np.linspace(-180, 180, 41)[:-1]], 0
    )

    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        imgs = np.stack([area_resize(im, (W, H)) for im in imgs], 0).astype(np.float32)

    return imgs, poses, render_poses, [H, W, focal], i_split


def composite_white_bkgd(images: np.ndarray, white_bkgd: bool) -> np.ndarray:
    """RGBA -> RGB with optional white-background compositing
    (run_nerf.py:199-202)."""
    if images.shape[-1] == 4:
        if white_bkgd:
            return images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        return images[..., :3]
    return images

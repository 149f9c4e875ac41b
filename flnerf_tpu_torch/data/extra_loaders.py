"""Additional dataset loaders: DeepVoxels, LINEMOD, NSVF (Tanks&Temples).

Port of ``flnerf_tpu/data/extra_loaders.py`` (numpy; images read through
``data/png.py``, LINEMOD's half_res shrink through ``data/resize.py``, so
neither imageio nor cv2 is needed for PNG scenes).

Parity targets:
  * load_dv_data — nerf-ours/load_deepvoxels.py: intrinsics.txt (f, cx, cy;
    rescaled to 512), per-view flattened-4x4 pose txts, train/val/test dirs.
  * load_LINEMOD_data — nerf-ours/load_LINEMOD.py: transforms_{split}.json
    with per-frame file paths, camera_angle_x per frame and explicit K,
    near/far in the json.
  * NSVFDataset — plenoxels-ours/opt/util/nsvf_dataset.py: {scene}/
    {rgb, pose}/ with split-prefixed filenames (0_train, 1_val, 2_test),
    intrinsics.txt single focal.
"""

from __future__ import annotations

import json
import os

import numpy as np

from flnerf_tpu_torch.data.png import imread
from flnerf_tpu_torch.data.resize import area_resize


def _read_floats(path: str) -> list:
    with open(path) as f:
        return [float(x) for x in f.read().split()]


def load_dv_data(scene: str = "cube", basedir: str = "/data/deepvoxels", testskip: int = 8):
    """DeepVoxels loader: returns (images, poses, render_poses, hwf, i_split)."""
    H = W = 512

    def parse_intrinsics(path, trgt):
        with open(path) as f:
            vals = list(map(float, f.readline().split()))
            focal, cx, cy = vals[:3]
            f.readline()  # grid barycenter
            f.readline()  # near plane
            f.readline()  # scale
            height, width = map(float, f.readline().split())
        cx = cx / width * trgt
        cy = cy / height * trgt
        focal = trgt / height * focal
        return focal, cx, cy

    def load_pose(path):
        return np.array(_read_floats(path), np.float32).reshape(4, 4)

    def load_split(split, skip):
        base = os.path.join(basedir, split, scene)
        pose_dir = os.path.join(base, "pose")
        img_dir = os.path.join(base, "rgb")
        pose_files = sorted(os.listdir(pose_dir))[::skip]
        img_files = sorted(os.listdir(img_dir))[::skip]
        poses = np.stack([load_pose(os.path.join(pose_dir, f)) for f in pose_files], 0)
        imgs = np.stack(
            [imread(os.path.join(img_dir, f)).astype(np.float32) / 255.0 for f in img_files],
            0,
        )
        return imgs[..., :3], poses

    focal, cx, cy = parse_intrinsics(
        os.path.join(basedir, "train", scene, "intrinsics.txt"), H
    )
    splits = [("train", 1), ("validation", testskip), ("test", testskip)]
    all_imgs, all_poses, counts = [], [], [0]
    for split, skip in splits:
        imgs, poses = load_split(split, skip)
        all_imgs.append(imgs)
        all_poses.append(poses)
        counts.append(counts[-1] + imgs.shape[0])
    images = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    render_poses = poses[i_split[2]]
    return images, poses, render_poses, [H, W, focal], i_split


def load_linemod_data(basedir: str, half_res: bool = False, testskip: int = 1):
    """LINEMOD loader: returns (images, poses, render_poses, hwf, K, i_split,
    near, far) — the extended tuple run_nerf.py:204-208 consumes."""
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as f:
            metas[s] = json.load(f)

    all_imgs, all_poses, counts = [], [], [0]
    K = None
    for s in splits:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"])
            imgs.append(imread(fname).astype(np.float32) / 255.0)
            poses.append(np.array(frame["transform_matrix"], np.float32))
        if K is None and "frames" in meta and meta["frames"]:
            if "intrinsic_matrix" in meta["frames"][0]:
                K = np.array(meta["frames"][0]["intrinsic_matrix"], np.float32)
        all_imgs.append(np.stack(imgs, 0))
        all_poses.append(np.stack(poses, 0))
        counts.append(counts[-1] + len(imgs))

    images = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    H, W = images.shape[1:3]
    camera_angle_x = float(metas["train"].get("camera_angle_x", 0.7))
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    if K is None:
        K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)
    near = float(metas["train"].get("near", 0.1))
    far = float(metas["train"].get("far", 2.0))

    if half_res:
        H, W = H // 2, W // 2
        focal /= 2.0
        K = K.copy()
        K[:2, :3] /= 2.0
        images = np.stack([area_resize(im, (W, H)) for im in images], 0)
    render_poses = poses[i_split[2]]
    return images, poses, render_poses, [H, W, focal], K, i_split, near, far


def load_nsvf_data(basedir: str, split: str = "train", scene_scale: float = 1.0):
    """NSVF-format loader (plenoxels T&T scenes): split-prefixed files
    0_*=train, 1_*=val, 2_*=test; intrinsics.txt (fx cx cy or 4x4)."""
    prefix = {"train": "0_", "val": "1_", "test": "2_"}[split]
    img_dir = os.path.join(basedir, "rgb")
    pose_dir = os.path.join(basedir, "pose")
    img_files = sorted(f for f in os.listdir(img_dir) if f.startswith(prefix))
    pose_files = sorted(f for f in os.listdir(pose_dir) if f.startswith(prefix))
    if len(img_files) != len(pose_files) or not img_files:
        raise ValueError(f"{basedir}: {len(img_files)} {prefix}* images and "
                         f"{len(pose_files)} {prefix}* poses")

    images = np.stack(
        [imread(os.path.join(img_dir, f)).astype(np.float32) / 255.0 for f in img_files],
        0,
    )[..., :3]
    poses = np.stack(
        [np.array(_read_floats(os.path.join(pose_dir, f)), np.float32).reshape(4, 4)
         for f in pose_files],
        0,
    )
    poses[:, :3, 3] *= scene_scale

    vals = _read_floats(os.path.join(basedir, "intrinsics.txt"))
    H, W = images.shape[1:3]
    if len(vals) >= 16:
        K = np.array(vals[:16], np.float32).reshape(4, 4)[:3, :3]
    else:
        focal, cx, cy = vals[0], vals[1] if len(vals) > 1 else W / 2, vals[2] if len(vals) > 2 else H / 2
        K = np.array([[focal, 0, cx], [0, focal, cy], [0, 0, 1]], np.float32)
    return images, poses, K, [H, W, float(K[0, 0])]

"""NeRF++ dataset loader: the {scene}/{split}/{intrinsics,pose,rgb} layout.

Port of ``flnerf_tpu/data/nerfpp_dataset.py`` (numpy; images read and
written through ``data/png.py`` and shrunk by ``data/resize.py``, so no
image library is needed for PNG scenes).  Parity targets (nerf++-ours):
  * load_data_split — data_loader_split.py:27-106: sorted per-view
    intrinsics/pose txt files (flattened 4x4), skip subsampling, training
    at resolution_level=2 (:102).
  * get_rays_single_image — nerf_sample_ray_split.py:10-35: OpenCV camera
    (x right, y down, z forward), +0.5 pixel centres, dirs = K^-1 [u v 1]
    rotated by c2w (not normalized: depths are along +z).
  * Cameras must be normalized inside the unit sphere
    (ddp_train_nerf.py:65-66 raises otherwise; the trainer checks).
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np

from flnerf_tpu_torch.data.png import imread, write_png
from flnerf_tpu_torch.data.resize import area_resize


def _find(dirpath: str, exts) -> List[str]:
    out = []
    for e in exts:
        out.extend(glob.glob(os.path.join(dirpath, e)))
    return sorted(out)


def _parse_txt_mat(path: str) -> np.ndarray:
    with open(path) as f:
        nums = f.read().split()
    return np.array([float(x) for x in nums], np.float32).reshape(4, 4)


def get_rays_opencv_np(H: int, W: int, intrinsics: np.ndarray, c2w: np.ndarray):
    """[H, W, 3] origins/dirs for an OpenCV-convention camera."""
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    pixels = np.stack([u + 0.5, v + 0.5, np.ones_like(u)], axis=-1)  # [H, W, 3]
    dirs = pixels @ np.linalg.inv(intrinsics[:3, :3]).T
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def load_nerfpp_split(basedir: str, scene: str, split: str, skip: int = 1,
                      resolution_level: int = 1):
    """Returns dict(images [n,H,W,3], origins, dirs [n,H,W,3], H, W,
    intrinsics [n,4,4], poses [n,4,4])."""
    split_dir = os.path.join(basedir.rstrip("/"), scene, split)
    intr_files = _find(os.path.join(split_dir, "intrinsics"), ["*.txt"])[::skip]
    pose_files = _find(os.path.join(split_dir, "pose"), ["*.txt"])[::skip]
    img_files = _find(os.path.join(split_dir, "rgb"), ["*.png", "*.jpg"])[::skip]
    n = len(pose_files)
    assert n > 0, f"no poses under {split_dir}"
    assert len(intr_files) == n
    # a duplicate (0001.png + 0001.jpg) or missing frame would silently
    # pair every later image with the wrong camera
    assert len(img_files) == n, (
        f"rgb/ has {len(img_files)} files but pose/ has {n} under {split_dir}")

    intrinsics = np.stack([_parse_txt_mat(f) for f in intr_files], 0)
    poses = np.stack([_parse_txt_mat(f) for f in pose_files], 0)

    images, origins, dirs = [], [], []
    H = W = None
    for i in range(n):
        im = imread(img_files[i])[..., :3].astype(np.float32) / 255.0
        intr = intrinsics[i].copy()
        if resolution_level > 1:
            h, w = im.shape[:2]
            im = area_resize(im, (w // resolution_level, h // resolution_level))
            intr[:2, :3] /= resolution_level
            intrinsics[i] = intr
        H, W = im.shape[:2]
        ro, rd = get_rays_opencv_np(H, W, intr, poses[i])
        images.append(im)
        origins.append(ro)
        dirs.append(rd)

    return {
        "images": np.stack(images, 0),
        "origins": np.stack(origins, 0),
        "dirs": np.stack(dirs, 0),
        "intrinsics": intrinsics,
        "poses": poses,
        "H": H,
        "W": W,
    }


def make_synthetic_nerfpp_scene(n_train=6, n_test=2, H=40, W=40, seed=0):
    """Offline stand-in for T&T: cameras inside the unit sphere looking
    outward at spheres both inside (fg) and outside (bg) the unit sphere.
    Returns (train_dict, test_dict) shaped like load_nerfpp_split output."""
    from flnerf_tpu_torch.data.synthetic import render_gt

    focal = 0.9 * W
    intr = np.array(
        [[focal, 0, W / 2, 0], [0, focal, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        np.float32,
    )

    def make(n, phase):
        images, origins, dirs, poses = [], [], [], []
        for i in range(n):
            th = 2 * np.pi * (i + phase) / n
            cam_pos = 0.45 * np.array([np.cos(th), np.sin(th), 0.3], np.float32)
            # look across the scene, so fg and bg both appear
            target = -cam_pos * 2.0
            fwd = target - cam_pos
            fwd = fwd / np.linalg.norm(fwd)
            right = np.cross(fwd, [0, 0, 1.0])
            right = right / np.linalg.norm(right)
            down = np.cross(fwd, right)
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, cam_pos
            ro, rd = get_rays_opencv_np(H, W, intr, c2w)
            images.append(render_gt(ro, rd))
            origins.append(ro)
            dirs.append(rd)
            poses.append(c2w)
        return {
            "images": np.stack(images, 0),
            "origins": np.stack(origins, 0),
            "dirs": np.stack(dirs, 0),
            "intrinsics": np.tile(intr[None], (n, 1, 1)),
            "poses": np.stack(poses, 0),
            "H": H,
            "W": W,
        }

    return make(n_train, 0.0), make(n_test, 0.37)


def write_nerfpp_fixture(basedir, H=96, W=None, n_train=12, n_test=2):
    """Write make_synthetic_nerfpp_scene to disk in the nerf++
    {split}/{intrinsics,pose,rgb} layout that load_nerfpp_split reads
    (reference data_loader_split.py:20-60).  Returns basedir."""
    W = W or H
    train, test = make_synthetic_nerfpp_scene(n_train=n_train, n_test=n_test, H=H, W=W)
    for split, d in (("train", train), ("test", test), ("validation", test)):
        for sub in ("intrinsics", "pose", "rgb"):
            os.makedirs(os.path.join(basedir, split, sub), exist_ok=True)
        for i in range(d["images"].shape[0]):
            stem = f"{i:05d}"
            np.savetxt(os.path.join(basedir, split, "intrinsics", stem + ".txt"),
                       d["intrinsics"][i].reshape(1, -1))
            np.savetxt(os.path.join(basedir, split, "pose", stem + ".txt"),
                       d["poses"][i].reshape(1, -1))
            img = (np.clip(d["images"][i], 0, 1) * 255).astype(np.uint8)
            write_png(os.path.join(basedir, split, "rgb", stem + ".png"), img)
    return basedir

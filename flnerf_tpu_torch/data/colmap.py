"""COLMAP model readers + nerf-format conversion.

Port of ``flnerf_tpu/data/colmap.py`` (numpy, the port's own copy; every
result equals the reference's bit for bit).

Capability parity with the reference's pose tooling:
  * read_write_model.py (nerf++-ours/colmap_runner): cameras/images
    binary+text readers (the public COLMAP sparse-model layout).
  * colmap2nerf.py (ngp-ours/scripts): COLMAP sparse model ->
    transforms.json with the nerf camera convention, centered/scaled poses.
  * llff2nerf.py (ngp-ours/scripts): poses_bounds.npy -> transforms.json.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, NamedTuple

import numpy as np

# COLMAP camera models: id -> (name, num_params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(q) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_ = _CAMERA_MODELS[model_id]
            params = np.array(struct.unpack(f"<{np_}d", f.read(8 * np_)))
            cams[cid] = ColmapCamera(cid, name, w, h, params)
    return cams


def read_images_bin(path: str) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = struct.unpack("<Q", f.read(8))
            f.read(24 * n2d)  # skip 2D points (x, y, point3D_id)
            imgs[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode())
    return imgs


def read_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        lines = f.readlines()
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cams[int(parts[0])] = ColmapCamera(
            int(parts[0]), parts[1], int(parts[2]), int(parts[3]),
            np.array([float(x) for x in parts[4:]]),
        )
    return cams


def read_images_txt(path: str) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.strip().startswith("#")]
    for i in range(0, len(lines), 2):  # every other line is 2D points
        p = lines[i].split()
        imgs[int(p[0])] = ColmapImage(
            int(p[0]),
            np.array([float(x) for x in p[1:5]]),
            np.array([float(x) for x in p[5:8]]),
            int(p[8]),
            p[9],
        )
    return imgs


def load_colmap_model(sparse_dir: str):
    """Load cameras+images from a COLMAP sparse dir (bin preferred)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_bin(os.path.join(sparse_dir, "images.bin"))
    else:
        cams = read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_txt(os.path.join(sparse_dir, "images.txt"))
    return cams, imgs


def colmap_to_transforms(
    sparse_dir: str,
    images_dir: str = "images",
    aabb_scale: int = 4,
    center_and_scale: bool = True,
) -> dict:
    """COLMAP sparse model -> instant-ngp-style transforms dict
    (colmap2nerf.py semantics: w2c inverted, y/z flipped to the nerf
    convention, poses recentered and scaled)."""
    cams, imgs = load_colmap_model(sparse_dir)
    cam = next(iter(cams.values()))
    if cam.model == "SIMPLE_PINHOLE" or cam.model == "SIMPLE_RADIAL":
        fx = fy = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
    else:
        fx, fy, cx, cy = cam.params[:4]

    flip = np.diag([1.0, -1.0, -1.0, 1.0])  # colmap(y down) -> nerf(y up)
    frames = []
    for img in sorted(imgs.values(), key=lambda im: im.name):
        R = qvec2rotmat(img.qvec)
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = img.tvec
        c2w = np.linalg.inv(w2c) @ flip
        frames.append(
            {
                "file_path": os.path.join(images_dir, img.name),
                "transform_matrix": c2w,
            }
        )

    if center_and_scale and frames:
        centers = np.stack([f["transform_matrix"][:3, 3] for f in frames])
        center = centers.mean(0)
        scale = 1.0 / max(float(np.abs(centers - center).max()), 1e-9)
        for f in frames:
            f["transform_matrix"][:3, 3] = (f["transform_matrix"][:3, 3] - center) * scale

    camera_angle_x = 2.0 * np.arctan(cam.width / (2.0 * fx))
    return {
        "camera_angle_x": float(camera_angle_x),
        "fl_x": float(fx), "fl_y": float(fy),
        "cx": float(cx), "cy": float(cy),
        "w": int(cam.width), "h": int(cam.height),
        "aabb_scale": aabb_scale,
        "frames": [
            {**f, "transform_matrix": f["transform_matrix"].tolist()} for f in frames
        ],
    }


def llff_to_transforms(basedir: str, images_dir: str = "images") -> dict:
    """poses_bounds.npy -> transforms dict (llff2nerf.py semantics)."""
    arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = arr[:, :-2].reshape(-1, 3, 5)
    h, w, focal = poses[0, :, 4]
    # [down right back] -> [right up back]
    mats = np.concatenate(
        [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:4]], axis=2
    )
    files = sorted(
        f
        for f in os.listdir(os.path.join(basedir, images_dir))
        if f.lower().endswith(("png", "jpg", "jpeg"))
    )
    frames = []
    for i, m in enumerate(mats):
        c2w = np.eye(4)
        c2w[:3, :4] = m
        name = files[i] if i < len(files) else f"{i:04d}.png"
        frames.append(
            {
                "file_path": os.path.join(images_dir, name),
                "transform_matrix": c2w.tolist(),
            }
        )
    return {
        "camera_angle_x": float(2.0 * np.arctan(w / (2.0 * focal))),
        "fl_x": float(focal), "fl_y": float(focal),
        "cx": float(w / 2), "cy": float(h / 2),
        "w": int(w), "h": int(h),
        "frames": frames,
    }


def write_transforms(transforms: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(transforms, f, indent=2)

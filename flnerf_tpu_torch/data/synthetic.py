"""Procedural synthetic dataset for tests and offline benchmarking.

Port of ``flnerf_tpu/data/synthetic.py`` (numpy, copied unchanged).

No datasets ship with this environment, so tests and the benchmark harness
use an analytically-rendered scene: diffuse emissive spheres in a unit-ish
volume on a white background, rendered by exact ray-sphere intersection.
This gives a blender-like (images, poses, hwf) tuple with real multi-view
consistency, so a NeRF trained on it must actually learn 3D structure.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from flnerf_tpu_torch.rays.camera import get_rays_np, intrinsics_matrix, pose_spherical


# A few fixed spheres: (center xyz, radius, rgb color)
_SPHERES = np.array(
    [
        [0.0, 0.0, 0.0, 0.6, 0.9, 0.2, 0.2],
        [0.5, 0.5, 0.3, 0.3, 0.2, 0.8, 0.3],
        [-0.5, 0.3, -0.2, 0.25, 0.2, 0.3, 0.9],
        [0.1, -0.6, 0.2, 0.3, 0.9, 0.8, 0.1],
    ],
    dtype=np.float32,
)


def _checker(p: np.ndarray, freq: float) -> np.ndarray:
    """View-consistent high-frequency 3-D texture in [0.25, 1]: product-of-
    sines checker at `freq` cycles per unit — the capacity probe (a field
    must spend fine-level table entries to represent it)."""
    s = np.sin(freq * p[:, 0]) * np.sin(freq * p[:, 1] + 1.3) * np.sin(
        freq * p[:, 2] + 2.1)
    return (0.625 + 0.375 * np.sign(s)).astype(np.float32)


def render_gt(rays_o: np.ndarray, rays_d: np.ndarray,
              texture_freq: float = 0.0) -> np.ndarray:
    """Exact render: nearest sphere hit colors the pixel (lambert-ish shade),
    else white background. rays_*: [..., 3].  texture_freq > 0 modulates
    the albedo with a high-frequency 3-D checker (capacity studies)."""
    sh = rays_o.shape[:-1]
    o = rays_o.reshape(-1, 3)
    d = rays_d.reshape(-1, 3)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)

    best_t = np.full(o.shape[0], np.inf, np.float32)
    color = np.ones((o.shape[0], 3), np.float32)  # white background
    for cx, cy, cz, r, cr, cg, cb in _SPHERES:
        c = np.array([cx, cy, cz], np.float32)
        oc = o - c
        b = np.sum(oc * d, -1)
        disc = b * b - (np.sum(oc * oc, -1) - r * r)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        valid = hit & (t > 1e-3) & (t < best_t)
        if valid.any():
            p = o[valid] + t[valid, None] * d[valid]
            n = (p - c) / r
            shade = 0.55 + 0.45 * np.clip(-n @ np.array([0.3, -0.5, 0.8], np.float32), 0, 1)
            if texture_freq > 0:
                shade = shade * _checker(p, texture_freq)
            color[valid] = np.array([cr, cg, cb], np.float32) * shade[:, None]
            best_t[valid] = t[valid]
    return color.reshape(*sh, 3)


def load_synthetic_data(
    n_train: int = 8, n_test: int = 2, H: int = 64, W: int = 64,
    texture_freq: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Blender-loader-shaped output: (images, poses, render_poses, hwf, i_split)."""
    focal = 0.9 * W
    K = intrinsics_matrix(H, W, focal)
    n = n_train + n_test
    thetas = np.linspace(-180, 180, n, endpoint=False)
    poses = np.stack([pose_spherical(t, -25.0, 3.5) for t in thetas], 0)

    images = []
    for i in range(n):
        ro, rd = get_rays_np(H, W, K, poses[i][:3, :4])
        images.append(render_gt(ro, rd, texture_freq))
    images = np.stack(images, 0)

    render_poses = np.stack([pose_spherical(t, -25.0, 3.5) for t in np.linspace(-180, 180, 12, endpoint=False)], 0)
    i_split = [np.arange(n_train), np.arange(n_train, n), np.arange(n_train, n)]
    hwf = [H, W, focal]
    return images, poses, render_poses, hwf, i_split


def write_blender_fixture(basedir: str, H: int = 96, W: int = None,
                          n_train: int = 12, n_val: int = 2,
                          n_test: int = 2, texture_freq: float = 0.0):
    """Write the procedural scene to disk in the nerf_synthetic blender
    layout (transforms_{split}.json + {split}/r_*.png — the exact layout
    load_blender expects, reference load_blender.py:37-91).

    This is the executable stand-in for the real-dataset golden runs
    (VERDICT r4 #7): the full CLI pipeline — loader, trainer, test-split
    eval — runs against it unmodified, so the day a real dataset exists
    the same command works.  Returns basedir."""
    import json
    import os

    import imageio.v2 as imageio

    W = W or H
    focal = 0.9 * W
    camera_angle_x = 2.0 * np.arctan(0.5 * W / focal)
    K = intrinsics_matrix(H, W, focal)
    n = n_train + n_val + n_test
    thetas = np.linspace(-180, 180, n, endpoint=False)
    # INTERLEAVE the splits around the azimuth circle: blender test
    # poses interpolate the train set.  A block split (train first,
    # val/test last) hands eval the one azimuth range training never
    # saw, and every golden band measures extrapolation instead of the
    # pipeline (r5: fixture_ngp scored 12 dB that way).
    splits = ["train"] * n
    held = ["val"] * n_val + ["test"] * n_test
    if held:
        step = n / len(held)
        for j, s in enumerate(held):
            splits[min(int((j + 0.5) * step), n - 1)] = s
    metas = {s: {"camera_angle_x": float(camera_angle_x), "frames": []}
             for s in ("train", "val", "test")}
    for i, (th, s) in enumerate(zip(thetas, splits)):
        pose = pose_spherical(th, -25.0, 3.5)
        ro, rd = get_rays_np(H, W, K, pose[:3, :4])
        img = (np.clip(render_gt(ro, rd, texture_freq), 0, 1)
               * 255).astype(np.uint8)
        os.makedirs(os.path.join(basedir, s), exist_ok=True)
        rel = f"./{s}/r_{i}"
        imageio.imwrite(os.path.join(basedir, f"{rel}.png"), img)
        metas[s]["frames"].append({
            "file_path": rel,
            "transform_matrix": np.asarray(pose, np.float64).tolist()})
    for s, meta in metas.items():
        with open(os.path.join(basedir, f"transforms_{s}.json"), "w") as f:
            json.dump(meta, f)
    return basedir

"""Camera models and ray generation.

Port of ``flnerf_tpu/rays/camera.py``: ``get_rays`` and ``ndc_rays`` in
torch on the caller's device, ``get_rays_np``, ``intrinsics_matrix``,
``pose_spherical`` and ``rand_poses`` in numpy (host precompute for the
quadtree; ``rand_poses`` bit for bit the reference's).

Parity targets:
  * get_rays / get_rays_np — nerf-ours/run_nerf_helpers.py:68-88
    (OpenGL-style camera: +x right, +y up, -z forward; pixel (i, j) maps to
    direction [(i-cx)/fx, -(j-cy)/fy, -1] rotated by c2w).
  * ndc_rays — nerf-ours/run_nerf_helpers.py:91-108 (LLFF forward-facing).
  * pose_spherical — nerf-ours/load_blender.py:29-34 (orbit render path).
  * rand_poses — ngp-ours/nerf/provider.py:58-93 (CLIP guidance's views).
"""

from __future__ import annotations

import numpy as np
import torch


def get_rays(H: int, W: int, K, c2w, device="cpu"):
    """Per-pixel ray origins/directions for one camera.

    Args:
      K: [3,3] intrinsics. c2w: [3,4] (or [4,4]) camera-to-world, numpy or
        tensor; both are moved to ``device`` as float32.
    Returns:
      rays_o, rays_d: [H, W, 3] each.  Index [row, col] = [y-down, x-right],
      matching the reference's transposed meshgrid.
    """
    K = torch.as_tensor(K, dtype=torch.float32, device=device)
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    i = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    j = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    dirs = torch.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -torch.ones_like(i)],
        dim=-1,
    )
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_np(H: int, W: int, K, c2w):
    """numpy twin of get_rays (host-side precompute for the quadtree)."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1], -np.ones_like(i)], -1)
    rays_d = dirs @ np.asarray(c2w)[:3, :3].T
    rays_o = np.broadcast_to(np.asarray(c2w)[:3, -1], rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o, rays_d):
    """Shift rays to the near plane and project into NDC (LLFF scenes).
    Tensors in, tensors out, on their device."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Orbit camera pose (blender render path), [4,4] numpy."""

    def trans_t(t):
        return np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]], dtype=np.float32)

    def rot_phi(p):
        return np.array(
            [[1, 0, 0, 0], [0, np.cos(p), -np.sin(p), 0], [0, np.sin(p), np.cos(p), 0], [0, 0, 0, 1]],
            dtype=np.float32,
        )

    def rot_theta(t):
        return np.array(
            [[np.cos(t), 0, -np.sin(t), 0], [0, 1, 0, 0], [np.sin(t), 0, np.cos(t), 0], [0, 0, 0, 1]],
            dtype=np.float32,
        )

    c2w = trans_t(radius)
    c2w = rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32) @ c2w
    return c2w


def rand_poses(size: int, rng: np.random.Generator, radius: float = 1.0,
               theta_range=(np.pi / 3, 2 * np.pi / 3),
               phi_range=(0.0, 2 * np.pi)) -> np.ndarray:
    """Random orbit-camera poses, [size, 4, 4] c2w — the rand_pose pool
    for text-guided (CLIP) training (ngp-ours/nerf/provider.py:58-93):
    uniform theta/phi on the sphere shell, look-at origin with the
    reference's (0, -1, 0) up convention; columns (right, up, forward)."""
    thetas = rng.random(size) * (theta_range[1] - theta_range[0]) + theta_range[0]
    phis = rng.random(size) * (phi_range[1] - phi_range[0]) + phi_range[0]
    centers = np.stack([
        radius * np.sin(thetas) * np.sin(phis),
        radius * np.cos(thetas),
        radius * np.sin(thetas) * np.cos(phis),
    ], axis=-1).astype(np.float32)

    def norm(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-10)

    fwd = -norm(centers)
    up = np.tile(np.array([0.0, -1.0, 0.0], np.float32), (size, 1))
    right = norm(np.cross(fwd, up))
    up = norm(np.cross(right, fwd))
    poses = np.tile(np.eye(4, dtype=np.float32), (size, 1, 1))
    poses[:, :3, :3] = np.stack((right, up, fwd), axis=-1)
    poses[:, :3, 3] = centers
    return poses


def intrinsics_matrix(H: int, W: int, focal: float) -> np.ndarray:
    """Default pinhole K with the principal point at the image center
    (run_nerf.py:237-242)."""
    return np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], dtype=np.float32
    )

"""The benchmark's scene, made on the device: the procedural spheres of
``flnerf_tpu_torch/data/synthetic.py`` rendered in torch (a frozen copy of
its ``render_gt``, so that a later change to the program cannot move the
ground truth), on an orbit of cameras at 800x800.

The cameras follow ``load_synthetic_data``: azimuths evenly spaced over the
circle, elevation -25 degrees, radius 3.5, focal 0.9 W, principal point at
the image centre (OpenGL convention: +x right, +y up, -z forward).  The last
``n_test`` views are held out.
"""

from __future__ import annotations

import numpy as np
import torch

# (centre xyz, radius, rgb) as data/synthetic.py lays them out
SPHERES = (
    (0.0, 0.0, 0.0, 0.6, 0.9, 0.2, 0.2),
    (0.5, 0.5, 0.3, 0.3, 0.2, 0.8, 0.3),
    (-0.5, 0.3, -0.2, 0.25, 0.2, 0.3, 0.9),
    (0.1, -0.6, 0.2, 0.3, 0.9, 0.8, 0.1),
)
LIGHT = (0.3, -0.5, 0.8)


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """[4, 4] camera-to-world of the blender orbit (load_blender.py:29-34)."""
    def trans_t(t):
        return np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]], np.float32)

    def rot_phi(p):
        return np.array([[1, 0, 0, 0], [0, np.cos(p), -np.sin(p), 0],
                         [0, np.sin(p), np.cos(p), 0], [0, 0, 0, 1]], np.float32)

    def rot_theta(t):
        return np.array([[np.cos(t), 0, -np.sin(t), 0], [0, 1, 0, 0],
                         [np.sin(t), 0, np.cos(t), 0], [0, 0, 0, 1]], np.float32)

    c2w = rot_theta(theta / 180.0 * np.pi) @ (rot_phi(phi / 180.0 * np.pi) @ trans_t(radius))
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    return flip @ c2w


def orbit(n_views: int) -> np.ndarray:
    """[n, 4, 4] poses of ``load_synthetic_data``'s orbit."""
    thetas = np.linspace(-180, 180, n_views, endpoint=False)
    return np.stack([pose_spherical(t, -25.0, 3.5) for t in thetas], 0)


def intrinsics(H: int, W: int) -> np.ndarray:
    focal = 0.9 * W
    return np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)


def rays(H: int, W: int, K: np.ndarray, c2w: np.ndarray, device) -> tuple:
    """[H, W, 3] origins and (unnormalised) directions of one camera."""
    K = torch.as_tensor(K, dtype=torch.float32, device=device)
    c2w = torch.as_tensor(np.asarray(c2w)[:3, :4], dtype=torch.float32, device=device)
    i = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    j = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    d = torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                     -torch.ones_like(i)], -1) @ c2w[:3, :3].T
    return c2w[:3, 3].expand(d.shape).contiguous(), d


def render_gt(rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """The nearest sphere hit colours the pixel (Lambert-like shade), else
    white; the arithmetic of data/synthetic.render_gt in float32."""
    sh = rays_o.shape[:-1]
    o = rays_o.reshape(-1, 3)
    d = rays_d.reshape(-1, 3)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    best_t = torch.full((o.shape[0],), float("inf"), device=o.device)
    color = torch.ones((o.shape[0], 3), device=o.device)
    light = torch.tensor(LIGHT, device=o.device)
    for cx, cy, cz, r, cr, cg, cb in SPHERES:
        c = torch.tensor([cx, cy, cz], device=o.device)
        oc = o - c
        b = torch.sum(oc * d, -1)
        disc = b * b - (torch.sum(oc * oc, -1) - r * r)
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        valid = (disc > 0) & (t > 1e-3) & (t < best_t)
        p = o + t[:, None] * d
        n = (p - c) / r
        shade = 0.55 + 0.45 * torch.clamp(-(n @ light), 0.0, 1.0)
        rgb = torch.tensor([cr, cg, cb], device=o.device) * shade[:, None]
        color = torch.where(valid[:, None], rgb, color)
        best_t = torch.where(valid, t, best_t)
    return color.reshape(*sh, 3)


def make_scene(n_train: int, n_test: int, H: int, W: int, device) -> dict:
    """Poses, intrinsics, and per view the rays and the ground-truth image,
    all [n, H, W, 3] float32 on ``device``."""
    poses = orbit(n_train + n_test)
    K = intrinsics(H, W)
    o, d, img = [], [], []
    for p in poses:
        ro, rd = rays(H, W, K, p, device)
        o.append(ro)
        d.append(rd)
        img.append(render_gt(ro, rd))
    return {"poses": poses, "K": K, "H": H, "W": W, "n_train": n_train,
            "origins": torch.stack(o), "dirs": torch.stack(d), "images": torch.stack(img)}

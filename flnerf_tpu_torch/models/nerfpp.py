"""NeRF++ field backend: foreground MLP + inverted-sphere background MLP.

Port of ``flnerf_tpu/models/nerfpp.py``.  Parity targets (nerf++-ours):
  * MLPNet — nerf_network.py:70-142: D=8 W=256 trunk with the embedded
    input concatenated before layer 5, sigma = |linear(base)| (:134),
    base_remap to 256 (fixed, whatever W is), rgb head Linear(256 +
    viewdir_ch, W // 2) relu Linear(W // 2, 3) sigmoid.
  * depth2pts_outside — ddp_model.py:16-45: background points as (x', y',
    z', 1/r) on the inverted sphere via a Rodrigues rotation.
  * NerfNet.forward — ddp_model.py:74-150: the fg composite keeps its final
    transmittance as bg_lambda; the bg is rendered back to front (depths
    flipped 1 -> 0) and weighted by bg_lambda.
  * intersect_sphere / perturb_samples — ddp_train_nerf.py:54-82.
  * NerfNetWithAutoExpo — ddp_model.py:157-188: a per-image learnable
    (scale, shift) table, initialised to (0.5, 0).

``MLPNet`` keeps the reference's names (``base.{i}``, ``sigma``,
``base_remap``, ``rgb0``, ``rgb1``) as ``nn.Linear`` modules; every product
goes through ``models/nerf_mlp._dense`` (bf16-rounded operands, an f32 GEMM
with TF32 off, the f32 bias added).  Random draws come from a
``torch.Generator`` or are passed in, so a test can feed the reference's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from flnerf_tpu_torch.models.nerf_mlp import _dense, embed_fn, embedder_out_dim
from flnerf_tpu_torch.render.common import CumprodNonzero

TINY = 1e-6
HUGE = 1e10


class NerfPPConfig(NamedTuple):
    netdepth: int = 8
    netwidth: int = 256
    max_freq_log2: int = 10
    max_freq_log2_viewdirs: int = 4
    cascade_samples: Tuple[int, ...] = (64, 64)
    optim_autoexpo: bool = False
    lambda_autoexpo: float = 1.0


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def intersect_sphere(ray_o: torch.Tensor, ray_d: torch.Tensor):
    """Depth where each ray exits the unit sphere (ddp_train_nerf.py:54-70),
    and whether its closest point to the centre lies inside the sphere
    (the trainer refuses rays that miss, on the host)."""
    d1 = -torch.sum(ray_d * ray_o, -1) / torch.sum(ray_d * ray_d, -1)
    p = ray_o + d1[..., None] * ray_d
    ray_d_cos = 1.0 / torch.linalg.norm(ray_d, dim=-1)
    p_norm_sq = torch.sum(p * p, -1)
    inside = p_norm_sq < 1.0
    d2 = torch.sqrt(torch.clamp(1.0 - p_norm_sq, min=1e-10)) * ray_d_cos
    return d1 + d2, inside


def perturb_samples(z_vals: torch.Tensor, t: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Jitter each depth uniformly within its bin: ``t`` [..., S] uniforms,
    or U[0, 1) draws from ``generator``."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], -1)
    lower = torch.cat([z_vals[..., :1], mids], -1)
    if t is None:
        t = torch.rand(z_vals.shape, generator=generator, device=z_vals.device)
    return lower + (upper - lower) * t


def depth2pts_outside(ray_o: torch.Tensor, ray_d: torch.Tensor,
                      depth: torch.Tensor) -> torch.Tensor:
    """Inverted-sphere 4-D background coordinates (ddp_model.py:16-45).
    ``depth`` is 1/r in [0, 1]; returns [..., 4] = (unit point, 1/r)."""
    d1 = -torch.sum(ray_d * ray_o, -1) / torch.sum(ray_d * ray_d, -1)
    p_mid = ray_o + d1[..., None] * ray_d
    p_mid_norm = torch.linalg.norm(p_mid, dim=-1)
    ray_d_cos = 1.0 / torch.linalg.norm(ray_d, dim=-1)
    d2 = torch.sqrt(torch.clamp(1.0 - p_mid_norm ** 2, min=1e-10)) * ray_d_cos
    p_sphere = ray_o + (d1 + d2)[..., None] * ray_d

    rot_axis = torch.linalg.cross(ray_o, p_sphere, dim=-1)
    rot_axis = rot_axis / torch.clamp(torch.linalg.norm(rot_axis, dim=-1, keepdim=True), min=TINY)
    phi = torch.arcsin(torch.clamp(p_mid_norm, -1.0, 1.0))
    theta = torch.arcsin(torch.clamp(p_mid_norm * depth, -1.0, 1.0))
    rot_angle = (phi - theta)[..., None]

    p_new = (
        p_sphere * torch.cos(rot_angle)
        + torch.linalg.cross(rot_axis, p_sphere, dim=-1) * torch.sin(rot_angle)
        + rot_axis * torch.sum(rot_axis * p_sphere, -1, keepdim=True)
        * (1.0 - torch.cos(rot_angle))
    )
    p_new = p_new / torch.clamp(torch.linalg.norm(p_new, dim=-1, keepdim=True), min=TINY)
    return torch.cat([p_new, depth[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------

class MLPNet(nn.Module):
    """``init_mlpnet`` / ``apply_mlpnet``: embedded points and view
    directions -> (rgb [..., 3], sigma [...]).  Weights follow torch's
    ``nn.Linear`` init; tests carry the reference's across."""

    def __init__(self, input_ch: int, input_ch_viewdirs: int, D: int = 8, W: int = 256,
                 compute_dtype=torch.bfloat16, device="cpu"):
        super().__init__()
        self.compute_dtype = compute_dtype
        layers, dim = [], input_ch
        for i in range(D):
            # the skip concat (input prepended) feeds layer 5 (skips={4},
            # applied before base_layers[i + 1] at i == 4)
            layers.append(nn.Linear(W + input_ch if i == 5 else dim, W, device=device))
            dim = W
        self.base = nn.ModuleList(layers)
        self.sigma = nn.Linear(W, 1, device=device)
        self.base_remap = nn.Linear(W, 256, device=device)
        self.rgb0 = nn.Linear(256 + input_ch_viewdirs, W // 2, device=device)
        self.rgb1 = nn.Linear(W // 2, 3, device=device)

    def forward(self, pts_embed: torch.Tensor, view_embed: torch.Tensor):
        cd = self.compute_dtype
        base = pts_embed
        for i, layer in enumerate(self.base):
            if i == 5:
                base = torch.cat([pts_embed, base], -1)
            base = torch.relu(_dense(base, layer, cd))
        sigma = torch.abs(_dense(base, self.sigma, cd))[..., 0]
        remap = _dense(base, self.base_remap, cd)
        h = torch.cat([remap, view_embed.to(remap.dtype)], -1)
        h = torch.relu(_dense(h, self.rgb0, cd))
        rgb = torch.sigmoid(_dense(h, self.rgb1, cd))
        return rgb, sigma


class NerfNet(nn.Module):
    """``init_nerfpp``: the fg and bg ``MLPNet`` of one cascade level, and,
    with ``optim_autoexpo`` and ``n_images > 0``, the per-image exposure
    table [n_images, 2] initialised to (0.5, 0) (ddp_model.py:169)."""

    def __init__(self, cfg: NerfPPConfig, n_images: int = 0,
                 compute_dtype=torch.bfloat16, device="cpu"):
        super().__init__()
        fg_pos_ch = embedder_out_dim(cfg.max_freq_log2, 3)
        bg_pos_ch = embedder_out_dim(cfg.max_freq_log2, 4)
        view_ch = embedder_out_dim(cfg.max_freq_log2_viewdirs, 3)
        self.fg = MLPNet(fg_pos_ch, view_ch, cfg.netdepth, cfg.netwidth, compute_dtype, device)
        self.bg = MLPNet(bg_pos_ch, view_ch, cfg.netdepth, cfg.netwidth, compute_dtype, device)
        self.autoexpo = None
        if cfg.optim_autoexpo and n_images > 0:
            self.autoexpo = nn.Parameter(
                torch.tensor([[0.5, 0.0]], device=device).repeat(n_images, 1))


def _composite(alpha: torch.Tensor) -> torch.Tensor:
    """The transmittance product over 1 - alpha + TINY (never zero)."""
    return CumprodNonzero.apply(1.0 - alpha + TINY)


def nerfpp_render(net: NerfNet, ray_o, ray_d, fg_z_max, fg_z_vals, bg_z_vals,
                  cfg: NerfPPConfig) -> Dict[str, torch.Tensor]:
    """One cascade level's render (NerfNet.forward, ddp_model.py:74-150)."""
    ray_d_norm = torch.linalg.norm(ray_d, dim=-1, keepdim=True)
    viewdirs = ray_d / ray_d_norm
    n_bg = bg_z_vals.shape[-1]
    view_e = embed_fn(viewdirs, cfg.max_freq_log2_viewdirs)[..., None, :]

    # ---- foreground (inside the unit sphere)
    fg_pts = ray_o[..., None, :] + fg_z_vals[..., None] * ray_d[..., None, :]
    fg_pe = embed_fn(fg_pts, cfg.max_freq_log2)
    fg_rgb_s, fg_sigma = net.fg(fg_pe, view_e.expand(fg_pts.shape[:-1] + view_e.shape[-1:]))
    fg_dists = fg_z_vals[..., 1:] - fg_z_vals[..., :-1]
    fg_dists = ray_d_norm * torch.cat([fg_dists, fg_z_max[..., None] - fg_z_vals[..., -1:]], -1)
    fg_alpha = 1.0 - torch.exp(-fg_sigma * fg_dists)
    T = _composite(fg_alpha)
    bg_lambda = T[..., -1]
    T = torch.cat([torch.ones_like(T[..., :1]), T[..., :-1]], -1)
    fg_weights = fg_alpha * T
    fg_rgb = torch.sum(fg_weights[..., None] * fg_rgb_s, -2)
    fg_depth = torch.sum(fg_weights * fg_z_vals, -1)

    # ---- background (inverted sphere, rendered back to front)
    bg_shape = ray_o.shape[:-1] + (n_bg, 3)
    bg_pts = depth2pts_outside(ray_o[..., None, :].expand(bg_shape),
                               ray_d[..., None, :].expand(bg_shape), bg_z_vals)
    # flip to back-to-front (1 -> 0), ddp_model.py:118-121
    bg_pe = torch.flip(embed_fn(bg_pts, cfg.max_freq_log2), [-2])
    bg_z = torch.flip(bg_z_vals, [-1])
    bg_rgb_s, bg_sigma = net.bg(bg_pe, view_e.expand(bg_pts.shape[:-1] + view_e.shape[-1:]))
    bg_dists = bg_z[..., :-1] - bg_z[..., 1:]
    bg_dists = torch.cat([bg_dists, torch.full_like(bg_dists[..., :1], HUGE)], -1)
    bg_alpha = 1.0 - torch.exp(-bg_sigma * bg_dists)
    Tb = _composite(bg_alpha)[..., :-1]
    Tb = torch.cat([torch.ones_like(Tb[..., :1]), Tb], -1)
    bg_weights = bg_alpha * Tb
    bg_rgb = torch.sum(bg_weights[..., None] * bg_rgb_s, -2)
    bg_depth = torch.sum(bg_weights * bg_z, -1)

    rgb = fg_rgb + bg_lambda[..., None] * bg_rgb
    return {
        "rgb": rgb,
        "fg_weights": fg_weights,
        "bg_weights": bg_weights,
        "fg_rgb": fg_rgb,
        "fg_depth": fg_depth,
        "bg_rgb": bg_lambda[..., None] * bg_rgb,
        "bg_depth": bg_lambda * bg_depth,
        "bg_lambda": bg_lambda,
    }

"""Occupancy-grid raymarching renderer for the hash-NGP field.

Port of ``flnerf_tpu/render/ngp.py``.  Reference behavior
(ngp-ours/nerf/renderer.py + raymarching/) as the JAX package re-designed
it, with static shapes:
  1. per ray, S_cand stratified candidate depths in [near, far] (log-spaced
     when dt_gamma > 0);
  2. occupancy of every candidate from the packed bitfield (no field
     evaluation);
  3. compaction of the occupied candidates (stable argsort, or cumsum
     ranks and one-hot contractions) into K kept samples, stratified when
     more than K are occupied (render/ngp.py:360-371);
  4. the field on the [N, K] kept samples, alpha-composited with the depth
     gaps of the kept samples.
The stratified keep is the reference's as it stands, including its fault R1
(ROADMAP.md): the port matches the function, not a fixed version of it.

Randomness: every function that draws takes an optional explicit noise
tensor (``noise`` for the perturbation, ``jitter`` and ``parity`` for the
occupancy refresh); without one it draws from the given
``torch.Generator``.  The tests feed both packages the same numbers.

No host sync on the hot path: the transmittance's cumprod has its own
backward (torch's reads whether any factor is zero back to the host; here
no factor is, by construction) and the partial refresh writes its parity
class back with device index tensors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from flnerf_tpu_torch.rays.camera import get_rays
from flnerf_tpu_torch.render.common import CumprodNonzero, unit_linspace


class NGPRenderConfig(NamedTuple):
    n_candidates: int = 128     # S_cand: occupancy-tested depths per ray
    n_keep: int = 64            # K: field evaluations per ray
    grid_size: int = 128        # occupancy grid resolution per axis
    bound: float = 1.0
    min_near: float = 0.05      # raymarching.py min_near
    density_thresh: float = 0.01
    density_scale: float = 1.0
    decay: float = 0.95         # EMA max decay (renderer.py:521-526)
    bg_color: float = 1.0       # scalar background (white default)
    # > 0: log-spaced candidates (dt proportional to t, raymarching.cu)
    dt_gamma: float = 0.0
    # candidate->keep compaction: 'argsort' (stable [N,S] argsort) or
    # 'onehot' (cumsum ranks + [N,K,S] one-hot contractions; same output)
    compaction: str = "argsort"
    # steady-state partial refresh: one of stride^3 parity classes of cells
    # per update (G^3/stride^3 field evaluations)
    partial_stride: int = 2


class OccupancyState(NamedTuple):
    density: torch.Tensor        # [G, G, G] float32 EMA density
    mean_density: torch.Tensor   # 0-d f32 (mean over clamped positives)
    # packed occupancy bitfield [G^3/32] int32 (raymarching packbits,
    # renderer.py:528-530); None when G^3 is not a multiple of 32
    bits: Optional[torch.Tensor] = None


def pack_occupancy(density: torch.Tensor, mean_density: torch.Tensor,
                   cfg: NGPRenderConfig) -> torch.Tensor:
    """density grid -> packed bitfield at threshold min(mean, thresh); bit
    k of word w is cell 32*w + k (the reference's uint32 words, read as
    int32)."""
    thresh = torch.clamp(mean_density, max=cfg.density_thresh)
    occ = (density.reshape(-1, 32) > thresh).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=density.device) << torch.arange(
        32, device=density.device)
    words = torch.sum(occ * weights, dim=-1)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def init_occupancy(cfg: NGPRenderConfig, device="cpu") -> OccupancyState:
    g = cfg.grid_size
    return OccupancyState(
        density=torch.zeros((g, g, g), device=device),
        mean_density=torch.zeros((), device=device),
        bits=(torch.zeros((g * g * g // 32,), dtype=torch.int32, device=device)
              if (g ** 3) % 32 == 0 else None),
    )


def with_density(occ: OccupancyState, density: torch.Tensor, cfg: NGPRenderConfig,
                 mean_density=None) -> OccupancyState:
    """Replace the density grid consistently (bitfield repacked)."""
    mean = (torch.mean(torch.clamp(density, min=0.0)) if mean_density is None
            else torch.as_tensor(mean_density, dtype=torch.float32, device=density.device))
    return OccupancyState(
        density, mean,
        pack_occupancy(density, mean, cfg) if occ.bits is not None else None)


def near_far_from_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor, bound: float,
                       min_near: float):
    """Slab-method ray/AABB intersection ([-bound, bound]^3), near clamped
    to min_near, far >= near + 1e-6; misses are culled by ``hit``."""
    inv_d = 1.0 / torch.where(torch.abs(rays_d) < 1e-9, 1e-9, rays_d)
    t0 = (-bound - rays_o) * inv_d
    t1 = (bound - rays_o) * inv_d
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    near = torch.clamp(tmin, min=min_near)
    far = torch.maximum(tmax, near + 1e-6)
    hit = tmax > torch.clamp(tmin, min=min_near)
    return near, far, hit


def occupancy_lookup(occ: OccupancyState, xyz: torch.Tensor,
                     cfg: NGPRenderConfig) -> torch.Tensor:
    """Occupied test for world points (the bitfield gather), threshold
    min(mean_density, density_thresh) (renderer.py:528-530)."""
    g = cfg.grid_size
    cell = ((xyz / cfg.bound + 1.0) * 0.5 * g).to(torch.int32)
    cell = torch.clamp(cell, 0, g - 1)
    flat = (cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]
    if occ.bits is not None and (g ** 3) % 32 == 0:
        w = occ.bits[(flat >> 5).long()]
        return ((w >> (flat & 31)) & 1) > 0
    vals = occ.density.reshape(-1)[flat.long()]
    return vals > torch.clamp(occ.mean_density, max=cfg.density_thresh)


def mark_untrained_grid(occ: OccupancyState, poses: np.ndarray, K: np.ndarray,
                        H: int, W: int, cfg: NGPRenderConfig,
                        chunk: int = 1 << 16) -> OccupancyState:
    """Mark grid cells invisible from every training camera as permanently
    empty (renderer.py:380-442): density -1, which the refresh never
    revives.  A cell is trainable iff its center projects inside at least
    one camera's image with positive depth (camera looks along -z).  Runs on
    the host in numpy, as the reference does."""
    g = cfg.grid_size
    idx = np.arange(g)
    gx, gy, gz = np.meshgrid(idx, idx, idx, indexing="ij")
    centers = (np.stack([gx, gy, gz], -1).reshape(-1, 3) + 0.5) / g
    centers = ((centers * 2.0 - 1.0) * cfg.bound).astype(np.float32)

    poses = np.asarray(poses, np.float32)
    K = np.asarray(K)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    visible = np.zeros(centers.shape[0], bool)
    for s in range(0, centers.shape[0], chunk):
        ce = centers[s:s + chunk]
        vis = visible[s:s + chunk]
        for p in poses:
            cam = (ce - p[:3, 3]) @ p[:3, :3]                       # world->cam
            z = -cam[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                u = fx * cam[:, 0] / np.maximum(z, 1e-9) + cx
                v = -fy * cam[:, 1] / np.maximum(z, 1e-9) + cy
            vis |= (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        visible[s:s + chunk] = vis

    density = occ.density.reshape(-1).clone()
    density[torch.from_numpy(~visible).to(density.device)] = -1.0
    density = density.reshape(g, g, g)
    return occ._replace(
        density=density,
        bits=pack_occupancy(density, occ.mean_density, cfg) if occ.bits is not None else None)


def _density_sweep(field, cells: torch.Tensor, jitter: torch.Tensor, g: int,
                   cfg: NGPRenderConfig, chunk: int, time=None) -> torch.Tensor:
    """Field sigma at jittered cell centers, ``chunk`` points per field call
    (the last call takes the remainder).  With ``time`` (one scalar for the
    whole sweep) the field is called as ``density(x, t)``."""
    xyz = ((cells + jitter) / g * 2.0 - 1.0) * cfg.bound
    if time is not None:
        time = torch.as_tensor(time, dtype=torch.float32, device=xyz.device)

    def density(x):
        return field.density(x) if time is None else field.density(x, time.expand(x.shape[:-1]))

    with torch.no_grad():
        sigma = torch.cat([density(xyz[i:i + chunk])[0]
                           for i in range(0, xyz.shape[0], chunk)])
    return sigma * cfg.density_scale


def _cells(n: int, device) -> torch.Tensor:
    idx = torch.arange(n, device=device)
    return torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1).reshape(-1, 3)


def update_occupancy(occ: OccupancyState, field, cfg: NGPRenderConfig,
                     chunk: int = 1 << 16, partial: bool = False, generator=None,
                     jitter: Optional[torch.Tensor] = None,
                     parity: Optional[torch.Tensor] = None, time=None) -> OccupancyState:
    """Refresh the density grid from the field at jittered cell centers, with
    EMA max decay (update_extra_state, renderer.py:445-538).

    partial=False sweeps the full grid; partial=True samples one of the
    stride^3 parity classes of cells while still decaying the whole grid.
    Cells pinned at -1 (mark_untrained_grid) stay pinned.  ``jitter`` (the
    [cells, 3] U(0,1) offsets) and ``parity`` ([3] ints in [0, stride))
    replace the draws from ``generator``; a grid not divisible by the stride
    takes the full sweep.  ``time`` (a float or 0-d tensor) refreshes a
    time-conditioned (D-NeRF) field at that one time for every cell."""
    g = cfg.grid_size
    dev = occ.density.device
    decayed = torch.where(occ.density < 0, occ.density, occ.density * cfg.decay)
    s = max(int(cfg.partial_stride), 2)

    if not partial or g % s:
        cells = _cells(g, dev).to(torch.float32)
        if jitter is None:
            jitter = torch.rand(cells.shape, generator=generator, device=dev)
        sigma = _density_sweep(field, cells, jitter, g, cfg, chunk, time).reshape(g, g, g)
        new_density = torch.where(occ.density < 0, occ.density,
                                  torch.maximum(decayed, sigma))
    else:
        gh = g // s
        if parity is None:
            parity = torch.randint(0, s, (3,), generator=generator, device=dev)
        parity = torch.as_tensor(parity, device=dev)
        cells = (_cells(gh, dev) * s + parity[None, :]).to(torch.float32)
        if jitter is None:
            jitter = torch.rand(cells.shape, generator=generator, device=dev)
        sigma = _density_sweep(field, cells, jitter, g, cfg, chunk, time).reshape(gh, gh, gh)
        # the sampled parity class, written back by device index tensors
        ax = torch.arange(gh, device=dev) * s
        ix = (ax + parity[0])[:, None, None]
        iy = (ax + parity[1])[None, :, None]
        iz = (ax + parity[2])[None, None, :]
        sub = decayed[ix, iy, iz]
        new_density = decayed.clone()
        new_density[ix, iy, iz] = torch.where(sub < 0, sub, torch.maximum(sub, sigma))
    mean = torch.mean(torch.clamp(new_density, min=0.0))
    return OccupancyState(
        new_density, mean,
        pack_occupancy(new_density, mean, cfg) if occ.bits is not None else None)


def march(occ: OccupancyState, rays_o: torch.Tensor, rays_d: torch.Tensor,
          cfg: NGPRenderConfig, perturb: bool = True,
          noise: Optional[torch.Tensor] = None, generator=None):
    """Candidates, occupancy and compaction for [N] rays (unit rays_d).
    Returns (zk [N,K] kept depths, mk [N,K] valid, xyzk [N,K,3] kept points,
    sample_dist [N] tail delta).  ``noise`` [N, S] U(0,1) replaces the
    perturbation draw."""
    S, K = cfg.n_candidates, cfg.n_keep
    dev = rays_o.device
    near, far, hit = near_far_from_aabb(rays_o, rays_d, cfg.bound, cfg.min_near)

    t = unit_linspace(S, dev)
    if cfg.dt_gamma > 0:
        # dt proportional to t: log-uniform depths; local spacing ~ z * g
        ln_n, ln_f = torch.log(near), torch.log(far)
        z = torch.exp(ln_n[:, None] * (1.0 - t)[None, :] + ln_f[:, None] * t[None, :])
        gam = (ln_f - ln_n) / S
        spacing = z * gam[:, None]
        sample_dist = far * gam
    else:
        z = near[:, None] + (far - near)[:, None] * t[None, :]
        sample_dist = (far - near) / S
        spacing = sample_dist[:, None].expand(z.shape)
    if perturb:
        if noise is None:
            noise = torch.rand(z.shape, generator=generator, device=dev)
        z = z + (noise - 0.5) * spacing

    xyz = torch.clamp(rays_o[:, None, :] + rays_d[:, None, :] * z[..., None],
                      -cfg.bound, cfg.bound)
    occ_mask = occupancy_lookup(occ, xyz, cfg) & hit[:, None]       # [N, S]

    # keep K of the occupied candidates, stratified (rank floor((k+0.5) *
    # n_occ / K)) when more than K are occupied
    kidx = torch.arange(K, dtype=torch.float32, device=dev)
    if cfg.compaction == "onehot":
        c_occ = torch.cumsum(occ_mask.to(torch.float32), dim=-1)    # [N, S]
        n_occ = c_occ[:, -1:]
        ranks = torch.where(n_occ > K, torch.floor((kidx[None, :] + 0.5) * n_occ / K),
                            kidx[None, :])                          # [N, K]
        sel = occ_mask[:, None, :] & ((c_occ - 1.0)[:, None, :] == ranks[:, :, None])
        zk = torch.sum(torch.where(sel, z[:, None, :], 0.0), dim=-1)
        mk = kidx[None, :] < n_occ
    else:
        order = torch.argsort((~occ_mask).to(torch.uint8), dim=-1, stable=True)
        n_occ = torch.sum(occ_mask, dim=-1, keepdim=True)
        ranks = torch.where(n_occ > K, torch.floor((kidx[None, :] + 0.5) * n_occ / K),
                            kidx[None, :]).long()
        keep = torch.gather(order, -1, ranks)
        zk = torch.gather(z, -1, keep)
        mk = torch.gather(occ_mask, -1, keep)
    xyzk = torch.clamp(rays_o[:, None, :] + rays_d[:, None, :] * zk[..., None],
                       -cfg.bound, cfg.bound)
    return zk, mk, xyzk, sample_dist


def ngp_render_rays(field, occ: OccupancyState, rays_o: torch.Tensor,
                    rays_d: torch.Tensor, cfg: NGPRenderConfig, perturb: bool = True,
                    bg_color=None, noise: Optional[torch.Tensor] = None,
                    generator=None, times: Optional[torch.Tensor] = None,
                    bg_fn: Optional[Callable] = None):
    """Render [N] rays (unit rays_d) through ``field`` (``density`` and
    ``color``).  Returns dict(rgb, depth, acc), differentiable in the
    field's parameters; the occupancy state is a constant.  ``bg_color`` is
    a scalar or an [N, 3] tensor (default cfg.bg_color); ``bg_fn(rays_o,
    rays_d) -> [N, 3]``, the learned background (``NGPField.background``),
    replaces it when given (renderer.py:232-235).  ``times`` [N] renders a
    time-conditioned (D-NeRF) field, ``density(x, t)``."""
    marched = march(occ, rays_o, rays_d, cfg, perturb, noise, generator)
    if bg_fn is not None:
        bg_color = bg_fn(rays_o, rays_d)
    return render_marched(field, marched, rays_d, cfg, bg_color, times)


def render_marched(field, marched, rays_d: torch.Tensor, cfg: NGPRenderConfig,
                   bg_color=None, times: Optional[torch.Tensor] = None):
    """The field on ``march``'s kept samples, alpha-composited; with
    ``times`` [N] each ray's time is broadcast over its kept samples."""
    zk, mk, xyzk, sample_dist = marched
    if times is None:
        sigma, geo = field.density(xyzk)                            # [N,K], [N,K,F]
    else:
        sigma, geo = field.density(xyzk, times[:, None].expand(zk.shape))
    sigma = torch.where(mk, sigma, 0.0)

    deltas = zk[:, 1:] - zk[:, :-1]
    # the last kept sample integrates over the tail delta (march_rays_train)
    deltas = torch.where(mk[:, 1:], deltas, sample_dist[:, None])
    deltas = torch.cat([deltas, sample_dist[:, None]], dim=-1)
    deltas = torch.where(mk, torch.clamp(deltas, min=0.0), 0.0)

    alpha = 1.0 - torch.exp(-deltas * cfg.density_scale * sigma)   # [N, K]
    shifted = torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-15], dim=-1)
    weights = alpha * CumprodNonzero.apply(shifted)[:, :-1]

    rgb_s = field.color(rays_d[:, None, :].expand(xyzk.shape), geo)  # [N, K, 3]
    acc = torch.sum(weights, dim=-1)
    rgb = torch.sum(weights[..., None] * rgb_s, dim=-2)
    depth = torch.sum(weights * zk, dim=-1)
    if bg_color is None:
        bg_color = cfg.bg_color
    rgb = rgb + (1.0 - acc)[..., None] * bg_color
    return {"rgb": rgb, "depth": depth, "acc": acc}


def ngp_render_image(field, occ: OccupancyState, cfg: NGPRenderConfig, H: int, W: int,
                     K, c2w, chunk: int = 8192, bg_color=None, time: Optional[float] = None,
                     bg_fn: Optional[Callable] = None):
    """Full-image eval render, unperturbed, ``chunk`` rays per field call;
    ``time`` renders a D-NeRF frame at that time; ``bg_fn`` (the learned
    background) takes precedence over ``bg_color``.  Returns (rgb [H, W,
    3], depth [H, W]) as numpy."""
    if bg_color is not None:
        cfg = cfg._replace(bg_color=float(bg_color))
    rays_o, rays_d = get_rays(H, W, K, c2w, field.device)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    n = rays_o.shape[0]
    chunk = min(chunk, (n + 127) // 128 * 128)
    n_pad = (n + chunk - 1) // chunk * chunk
    if n_pad != n:
        # pad by wrap-tiling the real rays (render/ngp.py:467-479), so every
        # field call sees real points
        reps = -(-n_pad // n)
        rays_o = rays_o.repeat(reps, 1)[:n_pad]
        rays_d = rays_d.repeat(reps, 1)[:n_pad]
    times = (None if time is None
             else torch.full((chunk,), float(time), device=rays_o.device))
    rgbs, depths = [], []
    with torch.no_grad():
        for i in range(0, n_pad, chunk):
            out = ngp_render_rays(field, occ, rays_o[i:i + chunk], rays_d[i:i + chunk],
                                  cfg, perturb=False, times=times, bg_fn=bg_fn)
            rgbs.append(out["rgb"])
            depths.append(out["depth"])
    rgb = torch.cat(rgbs, 0)[:n].reshape(H, W, 3)
    depth = torch.cat(depths, 0)[:n].reshape(H, W)
    return rgb.cpu().numpy(), depth.cpu().numpy()

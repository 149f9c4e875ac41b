"""Plenoxels field backend: dense voxel grid (density + spherical harmonics).

Port of ``flnerf_tpu/models/voxel_sh.py`` in torch.  ``voxel_render_rays``
(cuvol marching, closed-form SH) is the plain version of the CUDA kernels in
``flnerf_tpu_torch/ops/voxel_kernel.py``: the CPU path and the reference the
kernels are held against on the card.  Autograd gives its backward.

Parity targets (plenoxels-ours/svox2):
  * SparseGrid — svox2.py:335-536: density + SH-coefficient voxel grid with
    world<->grid transform (radius/center), basis_dim 9 (SH degree 3).
  * Python renderer — svox2.py:659-780 (_volume_render_gradcheck_lerp):
    grid-space marching at ``step_size`` voxel units; trilinear sigma/SH;
    rgb = clamp_min(sum(sh_mult * coeffs) + 0.5, 0);
    log-transmittance accumulation with delta_scale = 1/|grid-space dir|;
    background_brightness fills the remaining light.
  * npz checkpoint layout — svox2.py:1531-1633: radius, center, links int32
    grid, density_data [cap,1], sh_data [cap, 27] fp16.  Files cross between
    this package and the reference package unchanged.

The grid is dense [X,Y,Z](+27) with a bool ``alive`` mask (pruning clears
mask bits); marching is a static budget of ``max_steps`` samples with those
beyond ``tmax`` masked, as in the reference package.

Not ported yet (each raises ``NotImplementedError``): the ``nvol`` and
``svox1`` backends, the MSI background and the learned bases.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flnerf_tpu_torch.ops.sh_encoding import sh_encode

LATER_SLICE = ("is not ported yet; it is queued for a later slice of the "
               "port (ROADMAP.md, Plenoxels backlog)")


class VoxelGridConfig(NamedTuple):
    reso: Tuple[int, int, int] = (128, 128, 128)
    basis_dim: int = 9              # SH degree 3
    radius: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    init_sigma: float = 0.1         # opt.py init_sigma
    step_size: float = 0.5          # RenderOptions.step_size (voxel units)
    sigma_thresh: float = 1e-8
    stop_thresh: float = 1e-7
    background_brightness: float = 1.0
    near_clip: float = 0.0
    max_steps: int = 512            # static marching budget
    # the parts of the reference's configuration not ported yet; any other
    # value than these defaults raises (check_supported)
    backend: str = "cuvol"          # RenderOptions.backend (svox2.py:17)
    background_nlayers: int = 0     # MSI background (svox2.py:498-522)
    basis_type: str = "sh"          # basis type (svox2.py:344)


class VoxelGrid(NamedTuple):
    """Trainable state: dense density + SH data (+ alive mask)."""

    density: torch.Tensor   # [X, Y, Z] f32 (raw sigma)
    sh: torch.Tensor        # [X, Y, Z, 3*basis_dim] f32
    alive: torch.Tensor     # [X, Y, Z] bool — pruning mask (not trained)


def check_supported(cfg: VoxelGridConfig) -> None:
    """Raise for the configuration parts this slice has not ported."""
    if cfg.backend != "cuvol":
        raise NotImplementedError(f"backend={cfg.backend!r} {LATER_SLICE}")
    if cfg.background_nlayers > 0:
        raise NotImplementedError(f"the MSI background {LATER_SLICE}")
    if cfg.basis_type != "sh":
        raise NotImplementedError(
            f"basis_type={cfg.basis_type!r} (learned basis) {LATER_SLICE}")


def init_voxel_grid(cfg: VoxelGridConfig, device="cpu") -> VoxelGrid:
    check_supported(cfg)
    x, y, z = cfg.reso
    return VoxelGrid(
        density=torch.full((x, y, z), cfg.init_sigma, dtype=torch.float32,
                           device=device),
        sh=torch.zeros((x, y, z, 3 * cfg.basis_dim), dtype=torch.float32,
                       device=device),
        alive=torch.ones((x, y, z), dtype=torch.bool, device=device),
    )


def grid_scaling(cfg: VoxelGridConfig, device="cpu") -> torch.Tensor:
    reso = torch.tensor(cfg.reso, dtype=torch.float32, device=device)
    radius = torch.tensor(cfg.radius, dtype=torch.float32, device=device)
    return 0.5 * reso / radius


def world2grid(cfg: VoxelGridConfig, pts: torch.Tensor) -> torch.Tensor:
    """World -> grid coords (svox2.py:1501-1529 semantics: the grid spans
    center +- radius; voxel centers at integer coords 0..reso-1)."""
    reso = torch.tensor(cfg.reso, dtype=torch.float32, device=pts.device)
    center = torch.tensor(cfg.center, dtype=torch.float32, device=pts.device)
    scaling = grid_scaling(cfg, pts.device)
    offset = 0.5 * reso - center * scaling
    return pts * scaling + offset - 0.5


def trilinear_sample(grid: VoxelGrid, pos: torch.Tensor, cfg: VoxelGridConfig):
    """Trilinear density + SH at grid-space positions [..., 3].

    Position is clipped to [0, reso-1] and the floor to [0, reso-2].  Pruned
    (alive=False) cells read as zero and receive zero gradient."""
    hi = torch.tensor([r - 1.0 for r in cfg.reso], device=pos.device)
    pos = torch.minimum(torch.clamp(pos, min=0.0), hi)
    l = torch.floor(pos).long()
    l = torch.minimum(torch.clamp(l, min=0), (hi - 1.0).long())
    frac = pos - l

    density = torch.where(grid.alive, grid.density, 0.0)
    sh = torch.where(grid.alive[..., None], grid.sh, 0.0)

    sig = 0.0
    shv = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix, iy, iz = l[..., 0] + dx, l[..., 1] + dy, l[..., 2] + dz
                w = (
                    (frac[..., 0] if dx else 1 - frac[..., 0])
                    * (frac[..., 1] if dy else 1 - frac[..., 1])
                    * (frac[..., 2] if dz else 1 - frac[..., 2])
                )
                sig = sig + w * density[ix, iy, iz]
                shv = shv + w[..., None] * sh[ix, iy, iz]
    return sig, shv


def grid_ray_setup(cfg: VoxelGridConfig, rays_o: torch.Tensor,
                   rays_d: torch.Tensor):
    """Grid-space ray setup shared by the plain renderer and the kernels.

    Returns (origins, dirs, tmin, tmax, delta_scale, viewdirs): ``dirs``
    unit-length in grid space, ``tmax = tmin - 1`` for rays that provably
    miss (axis-parallel rays starting outside that axis' slab); such a ray
    marches no step."""
    origins = world2grid(cfg, rays_o)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dirs = viewdirs * grid_scaling(cfg, rays_d.device)
    delta_scale = 1.0 / torch.linalg.norm(dirs, dim=-1)
    dirs = dirs * delta_scale[..., None]   # unit-length in grid space

    gsz = torch.tensor(cfg.reso, dtype=torch.float32, device=rays_o.device)
    parallel = torch.abs(dirs) < 1e-9
    safe_dirs = torch.where(parallel, 1e-9, dirs)
    invdirs = 1.0 / safe_dirs
    t1 = (-0.5 - origins) * invdirs
    t2 = (gsz - 0.5 - origins) * invdirs
    tmin = torch.where(parallel, -1e9, torch.minimum(t1, t2)).amax(-1)
    tmin = torch.clamp(tmin, min=cfg.near_clip)
    tmax = torch.where(parallel, 1e9, torch.maximum(t1, t2)).amin(-1)
    inside_slab = (origins >= -0.5) & (origins <= gsz - 0.5)
    miss = torch.any(parallel & ~inside_slab, dim=-1)
    tmax = torch.where(miss, tmin - 1.0, tmax)
    return origins, dirs, tmin, tmax, delta_scale, viewdirs


def voxel_render_rays(grid: VoxelGrid, rays_o: torch.Tensor,
                      rays_d: torch.Tensor, cfg: VoxelGridConfig):
    """Volume-render [N] rays against the grid (cuvol, closed-form SH).

    Returns rgb [N,3], depth [N], acc [N], weights [N, max_steps] and log_t
    [N], the final log-transmittance (channel 4 of the kernels' output).
    The march runs only over the steps some ray of the batch can reach:
    every later sample is masked in the reference too, and contributes
    exactly nothing."""
    check_supported(cfg)
    n = rays_o.shape[0]
    origins, dirs, tmin, tmax, delta_scale, viewdirs = grid_ray_setup(
        cfg, rays_o, rays_d)
    sh_mult = sh_encode(viewdirs, degree=int(np.sqrt(cfg.basis_dim)))  # [N, B]

    steps = torch.arange(cfg.max_steps, device=rays_o.device)
    ts = tmin[:, None] + cfg.step_size * steps[None, :]                 # [N, S]
    valid = ts <= tmax[:, None]
    s = max(int(valid.any(0).sum()), 1)   # each ray's valid steps are a prefix
    ts, valid = ts[:, :s], valid[:, :s]

    pos = origins[:, None, :] + ts[..., None] * dirs[:, None, :]       # [N, S, 3]
    sigma, shv = trilinear_sample(grid, pos, cfg)                      # [N,S],[N,S,27]
    sigma = torch.where(valid, torch.relu(sigma), 0.0)
    sigma = torch.where(sigma >= cfg.sigma_thresh, sigma, 0.0)

    log_att = -cfg.step_size * sigma * delta_scale[:, None]             # [N, S]
    # transmittance entering each sample
    log_T = torch.cat(
        [torch.zeros((n, 1), device=rays_o.device),
         torch.cumsum(log_att[:, :-1], -1)], -1)
    weights = torch.exp(log_T) * (1.0 - torch.exp(log_att))             # [N, S]
    log_t = torch.sum(log_att, -1)
    remaining = torch.exp(log_t)

    rgb_sh = shv.reshape(n, s, 3, cfg.basis_dim)
    rgb = torch.clamp(
        torch.sum(sh_mult[:, None, None, :] * rgb_sh, -1) + 0.5, min=0.0)  # [N, S, 3]

    out_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
    out_rgb = out_rgb + remaining[..., None] * cfg.background_brightness
    depth = torch.sum(weights * ts, -1)
    return {"rgb": out_rgb, "depth": depth, "acc": 1.0 - remaining,
            "weights": F.pad(weights, (0, cfg.max_steps - s)), "log_t": log_t}


# ---------------------------------------------------------------------------
# TV regularizers (loss_kernel.cu analog: dense diffs)
# ---------------------------------------------------------------------------

def tv_loss(field: torch.Tensor, alive: torch.Tensor = None) -> torch.Tensor:
    """Total variation of a [X,Y,Z] or [X,Y,Z,C] field, normalized per cell
    (svox2 tv semantics: mean of squared forward differences).

    ``alive`` applies svox2's sparse-TV rule (loss_kernel.cu tv_grad): a
    forward diff counts only when BOTH cells are alive."""
    if field.ndim == 3:
        field = field[..., None]
    dx = field[1:, :, :] - field[:-1, :, :]
    dy = field[:, 1:, :] - field[:, :-1, :]
    dz = field[:, :, 1:] - field[:, :, :-1]
    if alive is not None:
        dx = torch.where((alive[1:, :, :] & alive[:-1, :, :])[..., None], dx, 0.0)
        dy = torch.where((alive[:, 1:, :] & alive[:, :-1, :])[..., None], dy, 0.0)
        dz = torch.where((alive[:, :, 1:] & alive[:, :, :-1])[..., None], dz, 0.0)
    n = field.shape[0] * field.shape[1] * field.shape[2]
    return (torch.sum(dx ** 2) + torch.sum(dy ** 2) + torch.sum(dz ** 2)) / n


def tv_loss_slab(field: torch.Tensor, z0: int, slab: int,
                 alive: torch.Tensor = None) -> torch.Tensor:
    """Stochastic TV over the contiguous z-slab [z0, z0+slab) — the
    ``tv_grad_sparse`` analog (loss_kernel.cu:179).  The caller draws
    ``z0`` uniformly from [0, Z-slab]; each term is weighted by the inverse
    of its inclusion probability, so the expectation equals ``tv_loss``."""
    if field.ndim == 3:
        field = field[..., None]
    X, Y, Z, _ = field.shape
    S = int(min(slab, Z))
    n_starts = Z - S + 1
    sub = field[:, :, z0:z0 + S]
    dev = field.device
    g = z0 + torch.arange(S, device=dev)                      # global planes
    p_xy = (torch.clamp(g, max=Z - S) - torch.clamp(g - S + 1, min=0)
            + 1.0) / n_starts
    gz = g[:-1]
    p_z = (torch.clamp(gz, max=Z - S) - torch.clamp(gz - S + 2, min=0)
           + 1.0) / n_starts
    dx = sub[1:, :, :] - sub[:-1, :, :]
    dy = sub[:, 1:, :] - sub[:, :-1, :]
    dz = sub[:, :, 1:] - sub[:, :, :-1]
    if alive is not None:
        sa = alive[:, :, z0:z0 + S]
        dx = torch.where((sa[1:] & sa[:-1])[..., None], dx, 0.0)
        dy = torch.where((sa[:, 1:] & sa[:, :-1])[..., None], dy, 0.0)
        dz = torch.where((sa[:, :, 1:] & sa[:, :, :-1])[..., None], dz, 0.0)
    tv_xy = torch.sum(
        (torch.sum(dx ** 2, dim=(0, 1, 3)) + torch.sum(dy ** 2, dim=(0, 1, 3)))
        / p_xy)
    tv_z = torch.sum(torch.sum(dz ** 2, dim=(0, 1, 3)) / p_z)
    return (tv_xy + tv_z) / (X * Y * Z)


# ---------------------------------------------------------------------------
# resample / prune (svox2.py:1224+)
# ---------------------------------------------------------------------------

def upsample_grid(grid: VoxelGrid, new_reso: Tuple[int, int, int]) -> VoxelGrid:
    """Trilinear upsample (grid.resample's resize step), half-pixel centers
    as in ``jax.image.resize``; a cell stays alive where the resized mask is
    positive."""
    def resize(v):  # [X, Y, Z, C] -> [X', Y', Z', C]
        v = v.permute(3, 0, 1, 2)[None]
        v = F.interpolate(v, size=tuple(new_reso), mode="trilinear",
                          align_corners=False)
        return v[0].permute(1, 2, 3, 0)

    density = resize(grid.density[..., None])[..., 0]
    sh = resize(grid.sh)
    alive = resize(grid.alive.float()[..., None])[..., 0] > 0.0
    return VoxelGrid(density.contiguous(), sh.contiguous(), alive.contiguous())


def _dilate(keep: torch.Tensor, dilate: int) -> torch.Tensor:
    for _ in range(dilate):
        k = keep
        for axis in range(3):
            k = k | torch.roll(keep, 1, axis) | torch.roll(keep, -1, axis)
        keep = k
    return keep


def prune_grid(grid: VoxelGrid, sigma_thresh: float = 5.0, dilate: int = 2) -> VoxelGrid:
    """Threshold pruning with morphological dilation (svox2.py:1224-1430
    resample's sigma-threshold + misc_kernel.cu dilate)."""
    keep = _dilate(grid.density > sigma_thresh, dilate)
    return grid._replace(alive=grid.alive & keep)


# ---------------------------------------------------------------------------
# npz checkpoint parity (svox2.py:1531-1633)
# ---------------------------------------------------------------------------

def save_npz(path: str, grid: VoxelGrid, cfg: VoxelGridConfig) -> None:
    """Write the reference's ckpt.npz field layout (links + packed data).
    The alive-select and the fp16 cast run on the grid's device."""
    alive = grid.alive
    n_alive = int(alive.sum())
    links = torch.full(alive.shape, -1, dtype=torch.int32, device=alive.device)
    links[alive] = torch.arange(n_alive, dtype=torch.int32, device=alive.device)
    density_data = grid.density.detach()[alive][:, None].float()
    sh_data = grid.sh.detach()[alive].half()
    np.savez(
        path,
        radius=np.asarray(cfg.radius, np.float32),
        center=np.asarray(cfg.center, np.float32),
        links=links.cpu().numpy(),
        density_data=density_data.cpu().numpy(),
        sh_data=sh_data.cpu().numpy(),
        basis_type=1,
    )


def load_npz(path: str, device="cpu") -> Tuple[VoxelGrid, VoxelGridConfig]:
    """Load a reference-format npz (ours, the reference package's or
    svox2's own), closed-form SH and no background only."""
    z = np.load(path)
    if "background_data" in z and z["background_data"].size:
        raise NotImplementedError(f"the MSI background {LATER_SLICE}")
    if "basis_type" in z and int(z["basis_type"]) != 1:
        raise NotImplementedError(f"learned bases {LATER_SLICE}")
    links = z["links"]
    alive = links >= 0
    density = np.zeros(links.shape, np.float32)
    sh = np.zeros(links.shape + (z["sh_data"].shape[-1],), np.float32)
    density[alive] = z["density_data"][:, 0][links[alive]]
    sh[alive] = z["sh_data"].astype(np.float32)[links[alive]]
    radius = np.atleast_1d(z["radius"])
    cfg = VoxelGridConfig(
        reso=tuple(int(v) for v in links.shape),
        basis_dim=sh.shape[-1] // 3,
        radius=(tuple(float(v) for v in radius[:3]) if radius.size >= 3
                else (float(radius[0]),) * 3),
        center=tuple(float(v) for v in np.atleast_1d(z["center"])[:3]),
    )
    grid = VoxelGrid(
        torch.from_numpy(density).to(device),
        torch.from_numpy(sh).to(device),
        torch.from_numpy(alive).to(device),
    )
    return grid, cfg

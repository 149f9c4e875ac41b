"""Fused cuvol volume render, forward and backward, as CUDA kernels.

Port of ``flnerf_tpu/ops/voxel_pallas.py``.  The TPU kernels there
(``_fwd_kernel`` and ``_bwd_kernel``) become the hand-written CUDA kernels
of ``csrc/voxel_cuvol.cu``: K1 (forward) and K2 (backward), one warp per
ray.  ``render_rays_fused`` is a ``torch.autograd.Function`` whose forward
launches K1 and whose backward launches K2.

Dispatch: on CUDA tensors the kernels launch (or the wrapper raises); on CPU
tensors the plain version, ``models/voxel_sh.voxel_render_rays``, runs and
autograd gives its backward.  Nothing falls back from the card to the plain
version.

``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count the kernel launches, so a run
can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flnerf_tpu_torch.models.voxel_sh import (
    VoxelGrid,
    VoxelGridConfig,
    check_supported,
    grid_ray_setup,
    voxel_render_rays,
)
from flnerf_tpu_torch.ops import _build
from flnerf_tpu_torch.ops.sh_encoding import sh_encode

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_COMMON = [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F]


def reset_launch_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("voxel_cuvol")
    if lib.cuvol_forward.argtypes is None:
        lib.cuvol_forward.restype = ctypes.c_int
        lib.cuvol_forward.argtypes = _COMMON + [_P, _P]
        lib.cuvol_backward.restype = ctypes.c_int
        lib.cuvol_backward.argtypes = _COMMON + [_P, _P, _P, _P, _P]
    return lib


def _common_args(density, sh, alive, origins, dirs, tmin, tmax, dscale, shmult,
                 cfg: VoxelGridConfig):
    """Validate the kernels' inputs and return the C arguments they share."""
    dev = density.device
    if dev.type != "cuda":
        raise ValueError(f"the cuvol kernels take CUDA tensors, got {dev}")
    x, y, z = cfg.reso
    n = origins.shape[0]
    if cfg.basis_dim != 9:
        raise ValueError(f"the cuvol kernels take basis_dim 9, got {cfg.basis_dim}")
    f32 = torch.float32
    for t, name, shape, dtype in (
        (density, "density", (x, y, z), f32),
        (sh, "sh", (x, y, z, 27), f32),
        (alive, "alive", (x, y, z), torch.bool),
        (origins, "origins", (n, 3), f32),
        (dirs, "dirs", (n, 3), f32),
        (tmin, "tmin", (n,), f32),
        (tmax, "tmax", (n,), f32),
        (dscale, "delta_scale", (n,), f32),
        (shmult, "sh_mult", (n, 9), f32),
    ):
        _build.check_tensor(t, name, shape, dtype, dev)
    if n >= 2 ** 31 or cfg.max_steps >= 2 ** 24:
        raise ValueError("ray count or max_steps out of the kernels' range")
    return [density.data_ptr(), sh.data_ptr(), alive.data_ptr(), x, y, z,
            origins.data_ptr(), dirs.data_ptr(), tmin.data_ptr(),
            tmax.data_ptr(), dscale.data_ptr(), shmult.data_ptr(), n,
            cfg.max_steps, cfg.step_size, cfg.sigma_thresh,
            cfg.background_brightness]


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def cuvol_forward(density, sh, alive, origins, dirs, tmin, tmax, dscale,
                  shmult, cfg: VoxelGridConfig) -> torch.Tensor:
    """K1: [N, 8] f32 — rgb (0:3), depth (3), final log-T (4), acc (5)."""
    global FWD_LAUNCHES
    args = _common_args(density, sh, alive, origins, dirs, tmin, tmax, dscale,
                        shmult, cfg)
    n = origins.shape[0]
    out = torch.empty((n, 8), dtype=torch.float32, device=density.device)
    if n == 0:
        return out
    rc = _lib().cuvol_forward(*args, out.data_ptr(), _stream(density.device))
    FWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"cuvol_forward launch failed: cudaError {rc}")
    return out


def cuvol_backward(density, sh, alive, origins, dirs, tmin, tmax, dscale,
                   shmult, out, grad_out, cfg: VoxelGridConfig, grads=None):
    """K2: (grad_density [X,Y,Z], grad_sh [X,Y,Z,27]) from K1's output and
    the upstream gradient [N, 8] (channels 0:3 and 4 are read).

    The gradients are zero-filled here, or, when ``grads`` is given as a
    (grad_density, grad_sh) pair, added into those tensors."""
    global BWD_LAUNCHES
    args = _common_args(density, sh, alive, origins, dirs, tmin, tmax, dscale,
                        shmult, cfg)
    n = origins.shape[0]
    _build.check_tensor(out, "out", (n, 8), torch.float32, density.device)
    _build.check_tensor(grad_out, "grad_out", (n, 8), torch.float32, density.device)
    if grads is None:
        grads = torch.zeros_like(density), torch.zeros_like(sh)
    grad_density, grad_sh = grads
    _build.check_tensor(grad_density, "grad_density", density.shape, torch.float32,
                        density.device)
    _build.check_tensor(grad_sh, "grad_sh", sh.shape, torch.float32, density.device)
    if n == 0:
        return grad_density, grad_sh
    rc = _lib().cuvol_backward(*args, out.data_ptr(), grad_out.data_ptr(),
                               grad_density.data_ptr(), grad_sh.data_ptr(),
                               _stream(density.device))
    BWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"cuvol_backward launch failed: cudaError {rc}")
    return grad_density, grad_sh


class RenderFused(torch.autograd.Function):
    """Forward K1, backward K2; gradients flow to density and sh only."""

    @staticmethod
    def forward(ctx, density, sh, alive, origins, dirs, tmin, tmax, dscale,
                shmult, cfg):
        out = cuvol_forward(density, sh, alive, origins, dirs, tmin, tmax,
                            dscale, shmult, cfg)
        ctx.save_for_backward(density, sh, alive, origins, dirs, tmin, tmax,
                              dscale, shmult, out)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        gd, gs = cuvol_backward(*saved, grad_out.contiguous(), ctx.cfg)
        return (gd, gs) + (None,) * 8


def ray_inputs(cfg: VoxelGridConfig, rays_o, rays_d):
    """The kernels' per-ray inputs, computed in torch as the reference
    computes them outside its kernel: grid-space origins and unit dirs,
    tmin, tmax, delta_scale, and the closed-form SH row."""
    origins, dirs, tmin, tmax, dscale, viewdirs = grid_ray_setup(cfg, rays_o, rays_d)
    shmult = sh_encode(viewdirs, degree=int(np.sqrt(cfg.basis_dim)))
    return [t.contiguous() for t in (origins, dirs, tmin, tmax, dscale, shmult)]


def render_rays_fused(grid: VoxelGrid, rays_o: torch.Tensor,
                      rays_d: torch.Tensor, cfg: VoxelGridConfig) -> torch.Tensor:
    """Fused cuvol render of [N] rays: [N, 8] f32 (rgb, depth, final log-T,
    acc, 0, 0), differentiable in grid.density and grid.sh.

    CUDA tensors launch K1 (and K2 in the backward); CPU tensors take the
    plain version; any other device raises."""
    check_supported(cfg)
    dev = grid.density.device
    if dev.type == "cuda":
        return RenderFused.apply(grid.density, grid.sh, grid.alive,
                                 *ray_inputs(cfg, rays_o, rays_d), cfg)
    if dev.type == "cpu":
        return render_rays_plain(grid, rays_o, rays_d, cfg)
    raise ValueError(f"no cuvol render for device {dev}")


def render_rays_plain(grid: VoxelGrid, rays_o: torch.Tensor,
                      rays_d: torch.Tensor, cfg: VoxelGridConfig) -> torch.Tensor:
    """The kernels' plain version, ``voxel_render_rays``, in their [N, 8]
    output layout; runs on any device."""
    out = voxel_render_rays(grid, rays_o, rays_d, cfg)
    zero = torch.zeros_like(out["depth"])
    return torch.stack(
        [out["rgb"][:, 0], out["rgb"][:, 1], out["rgb"][:, 2], out["depth"],
         out["log_t"], out["acc"], zero, zero], -1)


def voxel_render_rays_fast(grid: VoxelGrid, rays_o, rays_d,
                           cfg: VoxelGridConfig):
    """Drop-in counterpart of ``voxel_sh.voxel_render_rays`` through the
    fused kernels: returns rgb, depth and acc.  Every ray is served; there
    is no ordering requirement and no per-block spread flag."""
    out = render_rays_fused(grid, rays_o, rays_d, cfg)
    return {"rgb": out[:, 0:3], "depth": out[:, 3], "acc": out[:, 5]}


def morton_order(px: np.ndarray, py: np.ndarray, img: np.ndarray) -> np.ndarray:
    """Host-side coherence ordering: argsort by (image, morton(px, py)).
    Neighbouring rays then share grid cells, which helps the L2 cache."""
    def spread(v):
        v = v.astype(np.uint64) & np.uint64(0xFFFF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF)
        v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F)
        v = (v | (v << np.uint64(2))) & np.uint64(0x33333333)
        v = (v | (v << np.uint64(1))) & np.uint64(0x55555555)
        return v

    key = (img.astype(np.uint64) << np.uint64(34)) | (
        spread(px) << np.uint64(1)
    ) | spread(py)
    return np.argsort(key, kind="stable")

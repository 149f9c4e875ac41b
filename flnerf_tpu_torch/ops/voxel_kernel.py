"""Fused cuvol volume render, forward and backward, as CUDA kernels.

Port of ``flnerf_tpu/ops/voxel_pallas.py``.  The TPU kernels there
(``_fwd_kernel`` and ``_bwd_kernel``) become the hand-written CUDA kernels
of ``csrc/voxel_cuvol.cu``: K1 (forward) and K2 (backward), one warp per
ray.  ``render_rays_fused`` is a ``torch.autograd.Function`` whose forward
launches K1 and whose backward launches K2.

K1 and K2 skip empty space, as the TPU kernels do (``occupancy_mip``):
before each forward ``skip_occupancy`` builds, in plain torch ops over the
grid, an occupancy of 8^3 blocks of floor cells (``occupancy_blocks``), and
the kernels jump over the steps whose floor cell lies in an unmarked block;
``RenderFused`` hands the forward's occupancy to the backward.  The skip is
exact: such a step's corners are all dead or <= 0, so its sigma fails the
gate whenever ``sigma_thresh > 0``; with ``sigma_thresh <= 0`` nothing is
skipped.  ``skipped_steps``, ``leave_block`` and ``marched_steps`` are the
plain versions of the kernels' skip predicate, step jump and march, in the
device's f32 arithmetic; ``render_rays_skip_plain`` is the plain render with
the skip, and ``repeated_floor_cells`` counts the kept samples whose adds
a merge in K2 (a variant of ``tools/voxel_probe.py``) would fold into the
previous kept sample's.

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
        lib.cuvol_forward.argtypes = _COMMON + [_P, _P, _P]
        lib.cuvol_backward.restype = ctypes.c_int
        lib.cuvol_backward.argtypes = _COMMON + [_P, _P, _P, _P, _P, _P]
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


def occupancy_shape(reso) -> tuple:
    """The block counts of the kernels' occupancy: 8^3 blocks of the floor
    cells 0 .. reso - 2 of each side."""
    return tuple(max(1, -(-(r - 1) // 8)) for r in reso)


def _pool_axis(occ: torch.Tensor, axis: int) -> torch.Tensor:
    """Along ``axis``: block b of the floor cells 8b .. 8b+7 is marked when
    any of the cells 8b .. 8b+8 is (a floor cell's corners reach one cell
    past it); a last, partial block is padded with unmarked cells."""
    r = occ.shape[axis]
    (nb,) = occupancy_shape((r,))
    if nb * 8 > r:
        pad = list(occ.shape)
        pad[axis] = nb * 8 - r
        occ = torch.cat([occ, occ.new_zeros(pad)], axis)
    shape = list(occ.shape)
    blocks = occ.narrow(axis, 0, nb * 8).reshape(
        shape[:axis] + [nb, 8] + shape[axis + 1:]).any(axis + 1)
    every8 = [slice(None)] * occ.dim()
    every8[axis] = slice(8, None, 8)
    nxt = occ[tuple(every8)]          # the first cell of each next block, a view
    blocks.narrow(axis, 0, nxt.shape[axis]).logical_or_(nxt)
    return blocks


def occupancy_blocks(density: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """The kernels' occupancy, bool [ceil((X-1)/8), ceil((Y-1)/8), ceil((Z-1)/8)]:
    8^3 blocks of floor cells (a sample's floor cell l is clipped to [0,
    reso - 2]; its corners are l + {0,1}^3), block b marked when some floor
    cell in it has a corner that is alive with density > 0.  So a sample
    whose floor cell lies in an unmarked block sums non-negative weights
    times non-positive densities: its sigma is <= 0 in f32.  Plain torch
    ops over the grid, on its device (the TPU path builds its 8^3
    ``occupancy_mip`` the same way, outside its kernel)."""
    occ = alive & (density > 0)
    for axis in range(3):
        occ = _pool_axis(occ, axis)
    return occ


def skips(cfg: VoxelGridConfig) -> bool:
    """Whether K1 and K2 may skip a step: not where ``sigma_thresh <= 0`` (a sigma
    of 0 then passes the gate) or a side of the grid is under 2 cells."""
    return cfg.sigma_thresh > 0 and min(cfg.reso) >= 2


def skip_occupancy(density: torch.Tensor, alive: torch.Tensor, cfg: VoxelGridConfig):
    """The occupancy K1 and K2 skip by, or None where they may skip nothing."""
    return occupancy_blocks(density, alive).contiguous() if skips(cfg) else None


def repeated_floor_cells(cells: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """[N, S] bool: the kept samples whose floor cell equals the previous
    kept sample's of the same ray, from the samples' floor cells [N, S]
    (any integer key of the cell) and the kept mask [N, S], steps in march
    order.  A merge in K2 adds such a sample's gradient to the previous
    one's in registers, so its share bounds the atomics a merge saves."""
    steps = torch.arange(cells.shape[1], device=cells.device)
    last = torch.where(kept, steps, -1).cummax(1).values      # the last kept step up to j
    prev = torch.cat([last.new_full((cells.shape[0], 1), -1), last[:, :-1]], 1)
    same = cells == cells.gather(1, prev.clamp(min=0))
    return kept & (prev >= 0) & same


def _floor_cells(origins, dirs, ts, cfg: VoxelGridConfig) -> torch.Tensor:
    """The floor cells [..., 3] (int64) of the samples at ts [N, ...]:
    position o + t*d (a multiply, then an add), clipped to [0, reso - 1],
    its floor clipped to [0, reso - 2], as K1's axis_lerp computes them."""
    extra = (None,) * (ts.dim() - 1)
    o = origins[(slice(None),) + extra]
    d = dirs[(slice(None),) + extra]
    pos = o + ts[..., None] * d
    hi = torch.tensor([r - 1.0 for r in cfg.reso], device=ts.device)
    pos = torch.minimum(torch.clamp(pos, min=0.0), hi)
    return torch.minimum(torch.clamp(torch.floor(pos), min=0.0), hi - 1.0).long()


def _step_t(tmin, k, cfg: VoxelGridConfig):
    """t_k = tmin + step * k in f32, as K1 and voxel_render_rays compute it."""
    return tmin + cfg.step_size * k.to(torch.float32)


def _marked(occ, cells) -> torch.Tensor:
    b = cells // 8
    return occ[b[..., 0], b[..., 1], b[..., 2]]


def skipped_steps(occ, cfg: VoxelGridConfig, origins, dirs, tmin, tmax) -> torch.Tensor:
    """K1's skip predicate, [N, max_steps] bool: the marched steps (t_j <=
    tmax) whose floor cell lies in a block that ``occ`` leaves unmarked."""
    steps = torch.arange(cfg.max_steps, device=origins.device)
    ts = _step_t(tmin[:, None], steps[None, :], cfg)
    return (ts <= tmax[:, None]) & ~_marked(occ, _floor_cells(origins, dirs, ts, cfg))


def _out_of_block(k, blk, cfg, origins, dirs, tmin, tmax):
    t = _step_t(tmin, k, cfg)
    cells = _floor_cells(origins, dirs, t, cfg)
    return (k >= cfg.max_steps) | (t > tmax) | (cells // 8 != blk).any(-1)


def leave_block(blk, j, cfg: VoxelGridConfig, origins, dirs, tmin, tmax) -> torch.Tensor:
    """K1's step jump (``csrc/voxel_cuvol.cu`` leave_block), one ray a row:
    from step j [M] whose floor cell lies in block blk [M, 3], the first
    later step whose floor cell lies in another block or that is past the
    march.  The same f32 estimate from the block's planes, then the same
    steps back and forth to the exact step."""
    reso = torch.tensor(cfg.reso, device=j.device)
    t_out = tmax.clone()
    for a in range(3):
        d, o, b = dirs[:, a], origins[:, a], blk[:, a]
        up = (d > 0) & (8 * (b + 1) <= reso[a] - 2)
        down = (d < 0) & (b > 0)
        edge = torch.where(up, 8 * (b + 1), 8 * b).to(torch.float32)
        t_a = (edge - o) / d
        t_out = torch.where(up | down, torch.fmin(t_out, t_a), t_out)
    e = torch.floor((t_out - tmin) / cfg.step_size) + 1.0
    e = torch.fmin(torch.fmax(e, (j + 1).to(torch.float32)),
                   torch.tensor(float(cfg.max_steps), device=j.device))
    k = e.long()
    args = (cfg, origins, dirs, tmin, tmax)
    while True:
        back = (k > j + 1) & _out_of_block(k - 1, blk, *args)
        if not bool(back.any()):
            break
        k = k - back.long()
    while True:
        fwd = ~_out_of_block(k, blk, *args)
        if not bool(fwd.any()):
            break
        k = k + fwd.long()
    return k


def marched_steps(occ, cfg: VoxelGridConfig, origins, dirs, tmin, tmax,
                  steps_per_pass: int = 2) -> torch.Tensor:
    """K1's march with the skip, [N, max_steps] bool: the steps whose
    densities it reads.  Passes of ``steps_per_pass`` steps (K1's 2) from
    step 0; a
    pass whose first step lies in an unmarked block jumps (``leave_block``);
    a later step of a pass in an unmarked block is not read."""
    n = origins.shape[0]
    dev = origins.device
    out = torch.zeros((n, cfg.max_steps), dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    j0 = torch.zeros(n, dtype=torch.long, device=dev)
    while True:
        active = (j0 < cfg.max_steps) & (_step_t(tmin, j0, cfg) <= tmax)
        if not bool(active.any()):
            return out
        cells = _floor_cells(origins, dirs, _step_t(tmin, j0, cfg), cfg)
        jump = active & ~_marked(occ, cells)
        blk = cells // 8
        if bool(jump.any()):
            i = rows[jump]
            j0[i] = leave_block(blk[i], j0[i], cfg, origins[i], dirs[i], tmin[i], tmax[i])
        march = active & ~jump
        for s in range(steps_per_pass):
            js = j0 + s
            t = _step_t(tmin, js, cfg)
            ok = march & (js < cfg.max_steps) & (t <= tmax)
            ok &= _marked(occ, _floor_cells(origins, dirs, t, cfg))
            out[rows[ok], js[ok]] = True
        j0 = torch.where(march, j0 + steps_per_pass, j0)


def render_rays_skip_plain(grid: VoxelGrid, rays_o: torch.Tensor, rays_d: torch.Tensor,
                           cfg: VoxelGridConfig):
    """``voxel_render_rays`` with K1's skip: only the steps ``marched_steps``
    reads can add to the render (all of them when ``skip_occupancy`` gives
    no occupancy).  Equal, bit for bit, to the render without the skip."""
    occ = skip_occupancy(grid.density, grid.alive, cfg)
    if occ is None:
        return voxel_render_rays(grid, rays_o, rays_d, cfg)
    origins, dirs, tmin, tmax, _, _ = grid_ray_setup(cfg, rays_o, rays_d)
    keep = marched_steps(occ, cfg, origins, dirs, tmin, tmax)
    return voxel_render_rays(grid, rays_o, rays_d, cfg, keep=keep)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _occupancy_arg(density, alive, cfg: VoxelGridConfig, occ):
    """The occupancy a kernel skips by: ``occ`` when given (checked), else
    built here from the grid (``skip_occupancy``; None: skip nothing)."""
    if occ is None:
        return skip_occupancy(density, alive, cfg)
    if not skips(cfg):
        raise ValueError("an occupancy skips exactly only where sigma_thresh > 0")
    _build.check_tensor(occ, "occ", occupancy_shape(cfg.reso), torch.bool, density.device)
    return occ


def cuvol_forward(density, sh, alive, origins, dirs, tmin, tmax, dscale,
                  shmult, cfg: VoxelGridConfig, occ=None) -> torch.Tensor:
    """K1: [N, 8] f32 — rgb (0:3), depth (3), final log-T (4), acc (5).
    ``occ`` is the occupancy K1 skips by (``skip_occupancy`` of this grid);
    without it the wrapper builds it from the grid before the launch."""
    global FWD_LAUNCHES
    args = _common_args(density, sh, alive, origins, dirs, tmin, tmax, dscale,
                        shmult, cfg)
    n = origins.shape[0]
    out = torch.empty((n, 8), dtype=torch.float32, device=density.device)
    if n == 0:
        return out
    occ = _occupancy_arg(density, alive, cfg, occ)
    rc = _lib().cuvol_forward(*args, None if occ is None else occ.data_ptr(), out.data_ptr(),
                              _stream(density.device))
    FWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"cuvol_forward launch failed: cudaError {rc}")
    return out


def cuvol_backward(density, sh, alive, origins, dirs, tmin, tmax, dscale,
                   shmult, out, grad_out, cfg: VoxelGridConfig, grads=None, occ=None):
    """K2: (grad_density [X,Y,Z], grad_sh [X,Y,Z,27]) from K1's output and
    the upstream gradient [N, 8] (channels 0:3 and 4 are read).

    The gradients are zero-filled here, or, when ``grads`` is given as a
    (grad_density, grad_sh) pair, added into those tensors.  ``occ`` is the
    occupancy the forward skipped by; without it the wrapper builds it by
    the forward's rule (``skip_occupancy``)."""
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
    occ = _occupancy_arg(density, alive, cfg, occ)
    rc = _lib().cuvol_backward(*args, None if occ is None else occ.data_ptr(),
                               out.data_ptr(), grad_out.data_ptr(),
                               grad_density.data_ptr(), grad_sh.data_ptr(),
                               _stream(density.device))
    BWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"cuvol_backward launch failed: cudaError {rc}")
    return grad_density, grad_sh


class RenderFused(torch.autograd.Function):
    """Forward K1, backward K2; gradients flow to density and sh only.  The
    occupancy is built once, in the forward, and the backward skips by the
    same one (the saved density's version counter guards it)."""

    @staticmethod
    def forward(ctx, density, sh, alive, origins, dirs, tmin, tmax, dscale,
                shmult, cfg):
        occ = skip_occupancy(density, alive, cfg)
        out = cuvol_forward(density, sh, alive, origins, dirs, tmin, tmax,
                            dscale, shmult, cfg, occ=occ)
        ctx.save_for_backward(density, sh, alive, origins, dirs, tmin, tmax,
                              dscale, shmult, out, occ)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, grad_out):
        *saved, occ = ctx.saved_tensors
        gd, gs = cuvol_backward(*saved, grad_out.contiguous(), ctx.cfg, occ=occ)
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

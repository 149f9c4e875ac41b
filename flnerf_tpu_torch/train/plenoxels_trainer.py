"""Plenoxels training loop (plenoxels-ours/opt/opt.py).

Port of ``flnerf_tpu/train/plenoxels_trainer.py`` for one device.  Per
epoch the quadtree budgeter's rays cross to the device once; per batch the
step renders through ``ops/voxel_kernel.render_rays_fused`` (the CUDA
kernels on the card, the plain version on the CPU), takes the masked MSE
with ``denom = max(sum(mask), 1) * 3`` plus dense TV (or the random-slab
estimator when ``tv_sparsity < 1``), and applies RMSProp to density and SH
as in-place tensor math (optim_kernel.cu:28 analog).  The per-leaf error
statistic accumulates on the device with ``index_add_`` and crosses to the
host once per epoch, together with the epoch MSE.  Steps that hold only
padding are skipped on the host: they would be no-ops.

The device takes the place of the reference's ``use_kernel``.  On CUDA the
trainer takes the kernel path as the reference's ``use_kernel=True`` does:
the kernels, and the epoch's rays in morton order by (image, pixel) with
their 64-ray blocks shuffled by ``default_rng(seed)``, so that the rays of
one block march through neighbouring cells and share the L2 cache (on one
H100 this order cut K1 and K2 by 10-13% at 48x48 views and by about half
at 800x800: ``chip_smoke.py``).  On the CPU it takes the reference's
``use_kernel=False`` path: the plain render, rays in the budgeter's order.
The reference's re-forming and dropping of blocks that overflow the TPU
kernel's box is not ported: every ray reaches the loss.

Not ported yet (each raises ``NotImplementedError``): the MSI background,
learned bases, the lumisphere TV and the non-cuvol backends.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from flnerf_tpu_torch.core.metrics import compute_ssim, mse2psnr
from flnerf_tpu_torch.models.voxel_sh import (
    LATER_SLICE,
    VoxelGrid,
    VoxelGridConfig,
    check_supported,
    init_voxel_grid,
    prune_grid,
    tv_loss,
    tv_loss_slab,
    upsample_grid,
)
from flnerf_tpu_torch.ops.voxel_kernel import morton_order, render_rays_fused
from flnerf_tpu_torch.rays.camera import get_rays
from flnerf_tpu_torch.rays.quadtree import RayBudgeter, RayEpoch

ORDER_BLOCK = 64   # rays per shuffled block of the kernel path's ray order


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; 'cuda' with no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but no CUDA device is available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return device


def pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def expon_lr(step, lr_init, lr_final, lr_delay_steps, lr_delay_mult, max_steps):
    """Delayed log-lerp LR (opt/util/util.py:78 get_expon_lr_func), in
    float32 as the reference computes it.  Returns a 0-d CPU tensor."""
    f32 = torch.float32
    step = torch.as_tensor(step, dtype=f32)
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(torch.log(torch.tensor(lr_init, dtype=f32)) * (1 - t)
                         + torch.log(torch.tensor(lr_final, dtype=f32)) * t)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    return delay_rate * log_lerp


class PlenoxelsTrainConfig(NamedTuple):
    n_epoch: int = 8
    batch_size: int = 5000
    lr_sigma: float = 3e1            # opt.py defaults (syn.json)
    lr_sigma_final: float = 5e-2
    lr_sigma_delay_steps: int = 15000
    lr_sigma_delay_mult: float = 1e-2
    lr_sh: float = 1e-2
    lr_sh_final: float = 5e-6
    lr_decay_steps: int = 250000
    rms_beta: float = 0.95
    lambda_tv: float = 1e-5
    lambda_tv_sh: float = 1e-3
    # fraction of z-planes whose TV is sampled per step (1.0 = dense)
    tv_sparsity: float = 1.0
    # lumisphere TV: not ported (must stay 0)
    lambda_tv_lumisphere: float = 0.0
    tv_lumisphere_dir_factor: float = 0.0
    # MSI background optimization: not ported (the grid config raises
    # for background_nlayers > 0); kept so configs carry across
    lr_sigma_bg: float = 3e0
    lr_sigma_bg_final: float = 3e-3
    lr_color_bg: float = 1e-1
    lr_color_bg_final: float = 5e-6
    lambda_tv_background_sigma: float = 1e-2
    lambda_tv_background_color: float = 1e-2
    background_density_thresh: float = 1.0
    # learned-basis optimization: not ported (basis_type must be 'sh')
    lr_basis: float = 1e-6
    lr_basis_final: float = 1e-6
    subdivide_every: int = 1
    subdivide_thres: float = 0.015
    prob_sampling: bool = False
    rand_samp_perc: float = 1.0
    steps_per_chunk: int = 8
    upsample_epochs: Tuple[int, ...] = ()
    prune_sigma_thresh: float = 5.0
    seed: int = 0
    # kept so configs carry across; the port takes the kernel path, and its
    # ray order, from the device (see module docstring)
    use_kernel: bool = False


class PlenoxelsState(NamedTuple):
    grid: VoxelGrid
    rms_density: torch.Tensor
    rms_sh: torch.Tensor
    step: int


def coherence_order(px: np.ndarray, py: np.ndarray, img: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
    """The kernel path's ray order: morton order by (image, pixel) cut into
    64-ray blocks whose order ``rng`` shuffles (the tail that fills no block
    stays last)."""
    order = morton_order(px, py, img)
    nb = order.shape[0] // ORDER_BLOCK
    head, tail = order[: nb * ORDER_BLOCK], order[nb * ORDER_BLOCK:]
    body = head.reshape(nb, ORDER_BLOCK)[rng.permutation(nb)].reshape(-1)
    return np.concatenate([body, tail])


def _leaf_buf_size(n: int) -> int:
    size = 1024
    while size < n + 1:
        size *= 2
    return size


class PlenoxelsTrainer:
    def __init__(self, grid_cfg: VoxelGridConfig,
                 train_cfg: PlenoxelsTrainConfig, device="cuda"):
        check_supported(grid_cfg)
        if train_cfg.lambda_tv_lumisphere > 0:
            raise NotImplementedError(f"the lumisphere TV {LATER_SLICE}")
        self.device = resolve_device(device)
        # the kernel path (CUDA) marches rays in coherence order
        self.coherent = self.device.type == "cuda"
        self.gcfg = grid_cfg
        self.cfg = train_cfg
        grid = init_voxel_grid(grid_cfg, self.device)
        self.state = PlenoxelsState(
            grid, torch.zeros_like(grid.density), torch.zeros_like(grid.sh), 0)
        self._tv_rng = np.random.default_rng([train_cfg.seed, 1])
        self._order_rng = np.random.default_rng(train_cfg.seed)
        self.history = []

    # ------------------------------------------------------------------
    def _grid_tv(self, field: torch.Tensor) -> torch.Tensor:
        """Dense TV, or the unbiased random-slab estimator when
        tv_sparsity < 1 (loss_kernel.cu:179 tv_grad_sparse analog)."""
        alive = self.state.grid.alive
        if self.cfg.tv_sparsity >= 1.0:
            return tv_loss(field, alive)
        z = field.shape[2]
        slab = min(max(4, int(round(z * self.cfg.tv_sparsity))), z)
        z0 = int(self._tv_rng.integers(0, z - slab + 1))
        return tv_loss_slab(field, z0, slab, alive)

    def _step(self, origins, dirs, rgb, leaf, mask, err_sum, err_cnt):
        """One RMSProp step on a batch; returns (mse, ray count) tensors."""
        cfg, st = self.cfg, self.state
        density = st.grid.density.detach().requires_grad_(True)
        sh = st.grid.sh.detach().requires_grad_(True)
        out = render_rays_fused(VoxelGrid(density, sh, st.grid.alive),
                                origins, dirs, self.gcfg)
        rgb_out = out[:, 0:3]
        count = torch.sum(mask)
        denom = torch.clamp(count, min=1.0) * 3.0
        mse = torch.sum(mask[:, None] * (rgb_out - rgb) ** 2) / denom
        reg = (cfg.lambda_tv * self._grid_tv(density)
               + cfg.lambda_tv_sh * self._grid_tv(sh))
        g_density, g_sh = torch.autograd.grad(mse + reg, [density, sh])

        lr_sigma = float(expon_lr(st.step, cfg.lr_sigma, cfg.lr_sigma_final,
                                  cfg.lr_sigma_delay_steps,
                                  cfg.lr_sigma_delay_mult, cfg.lr_decay_steps))
        lr_sh = float(expon_lr(st.step, cfg.lr_sh, cfg.lr_sh_final, 0, 1.0,
                               cfg.lr_decay_steps))
        # fused RMSProp (optim_kernel.cu:28 rmsprop_step), in place
        b = cfg.rms_beta
        for param, rms, g, lr in ((st.grid.density, st.rms_density, g_density, lr_sigma),
                                  (st.grid.sh, st.rms_sh, g_sh, lr_sh)):
            rms.mul_(b).addcmul_(g, g, value=1 - b)
            param.addcdiv_(g, rms.sqrt().add_(1e-8), value=-lr)

        per_ray_err = torch.amax(torch.abs(rgb_out.detach() - rgb), -1)
        live = mask > 0
        safe_leaf = torch.where(live, leaf, err_sum.shape[0] - 1)
        err_sum.index_add_(0, safe_leaf, torch.where(live, per_ray_err, 0.0))
        err_cnt.index_add_(0, safe_leaf, mask)
        self.state = st._replace(step=st.step + 1)
        return mse.detach(), count

    def run_epoch_rays(self, epoch: RayEpoch):
        """Train on one epoch's rays; returns (per-leaf mean |error| [M],
        ray-weighted MSE over the last chunk)."""
        cfg = self.cfg
        if self.coherent and epoch.px is not None:
            # the rng persists, so the block order differs across epochs
            order = coherence_order(epoch.px, epoch.py, epoch.img, self._order_rng)
            epoch = epoch._replace(
                origins=epoch.origins[order], dirs=epoch.dirs[order],
                rgb=epoch.rgb[order], leaf_id=epoch.leaf_id[order],
            )
        B, K = cfg.batch_size, cfg.steps_per_chunk
        n = epoch.origins.shape[0]
        n_pad = pad_to_multiple(max(n, 1), B * K)

        def pad(a, fill=0.0):
            out = np.full((n_pad,) + a.shape[1:], fill, a.dtype)
            out[:n] = a
            return out

        dirs = pad(epoch.dirs)
        dirs[n:] = np.array([0, 0, -1.0], np.float32)
        mask = np.zeros(n_pad, np.float32)
        mask[:n] = 1.0
        # the epoch crosses to the device once
        dev = self.device
        origins_d, dirs_d, rgb_d, leaf_d, mask_d = (
            torch.from_numpy(a).to(dev) for a in (
                pad(epoch.origins), dirs, pad(epoch.rgb),
                pad(epoch.leaf_id.astype(np.int64)), mask))

        leaf_buf = _leaf_buf_size(epoch.n_leaves)
        err_sum = torch.zeros(leaf_buf, device=dev)
        err_cnt = torch.zeros(leaf_buf, device=dev)
        zero = torch.zeros((), device=dev)
        n_chunks = n_pad // (B * K)
        last = []
        for ci in range(n_chunks):
            last = []
            for k in range(K):
                sl = slice((ci * K + k) * B, (ci * K + k + 1) * B)
                if mask[sl].any():
                    last.append(self._step(origins_d[sl], dirs_d[sl], rgb_d[sl],
                                           leaf_d[sl], mask_d[sl], err_sum,
                                           err_cnt))
                else:
                    last.append((zero, zero))
        # one device -> host transfer per epoch
        m = epoch.n_leaves
        host = torch.cat([err_sum[:m], err_cnt[:m],
                          torch.stack([t for pair in last for t in pair])]).cpu().numpy()
        s, c = host[:m], host[m:2 * m]
        stat = s / np.maximum(c, 1.0)
        stat[c == 0] = -np.inf
        ms, cs = host[2 * m::2], host[2 * m + 1::2]
        epoch_mse = float((ms * cs).sum() / max(cs.sum(), 1.0))
        return stat, epoch_mse

    def fit(self, budgeter: RayBudgeter, on_epoch_end=None, verbose=True):
        cfg = self.cfg
        t0 = time.time()
        for epoch_id in range(1, cfg.n_epoch + 1):
            te = time.time()
            last = epoch_id == cfg.n_epoch
            epoch = budgeter.gen_rays(
                down_scale=1,
                prob=cfg.prob_sampling and not last,
                rand_samp_perc=cfg.rand_samp_perc,
                last_epoch=last,
            )
            leaf_stat, mse = self.run_epoch_rays(epoch)

            if (
                cfg.subdivide_every > 0
                and epoch_id % cfg.subdivide_every == 0
                and epoch_id < cfg.n_epoch - 1
            ):
                n_split = budgeter.adjust(leaf_stat, cfg.subdivide_thres)
                if verbose:
                    print(f"  subdivided {n_split} -> {budgeter.forest.n_leaves} leaves")

            if epoch_id in cfg.upsample_epochs:
                new_reso = tuple(r * 2 for r in self.gcfg.reso)
                self.resample(new_reso)
                if verbose:
                    print(f"  upsampled grid -> {new_reso}")

            psnr = float(mse2psnr(mse))
            # epoch_s: this epoch's ray generation, steps, subdivision and
            # resampling, ended by the epoch's one host sync; no callback
            self.history.append(
                {"epoch": epoch_id, "wall_s": time.time() - t0, "train_psnr": psnr,
                 "rays": int(epoch.origins.shape[0]), "steps": self.state.step,
                 "epoch_s": time.time() - te}
            )
            if verbose:
                print(
                    f"epoch {epoch_id}/{cfg.n_epoch}: rays {epoch.origins.shape[0]} "
                    f"train-psnr {psnr:.2f} ({time.time()-te:.1f}s)"
                )
            if on_epoch_end is not None:
                on_epoch_end(self, epoch_id)
        return self.state

    # ------------------------------------------------------------------
    def resample(self, new_reso: Tuple[int, int, int], prune: bool = True):
        """Upsample + prune between epochs; RMSProp state restarts."""
        grid = upsample_grid(self.state.grid, new_reso)
        if prune:
            grid = prune_grid(grid, self.cfg.prune_sigma_thresh)
        self.gcfg = self.gcfg._replace(reso=new_reso)
        self.state = PlenoxelsState(grid, torch.zeros_like(grid.density),
                                    torch.zeros_like(grid.sh), self.state.step)

    def render_image(self, H, W, K, c2w, chunk: int = 4096) -> np.ndarray:
        """Render one [H, W, 3] image (numpy), ``chunk`` rays per launch in
        raster order (on one H100 a morton order changed K1 by 1% on a
        48x48 view: ``chip_smoke.py``)."""
        rays_o, rays_d = get_rays(H, W, K, c2w, self.device)
        ro = rays_o.reshape(-1, 3)
        rd = rays_d.reshape(-1, 3)
        with torch.no_grad():
            rgb = torch.cat([render_rays_fused(self.state.grid, ro[i:i + chunk],
                                               rd[i:i + chunk], self.gcfg)[:, 0:3]
                             for i in range(0, ro.shape[0], chunk)], 0)
        return rgb.cpu().numpy().reshape(H, W, 3)

    def eval_images(self, poses, images, H, W, K, chunk: int = 4096):
        """Mean PSNR and SSIM over the given views (metrics on the host)."""
        psnrs, ssims = [], []
        for i in range(poses.shape[0]):
            rgb = self.render_image(H, W, K, poses[i][:3, :4], chunk)
            mse = float(np.mean((rgb - images[i]) ** 2))
            psnrs.append(-10.0 * np.log10(max(mse, 1e-12)))
            ssims.append(float(compute_ssim(torch.from_numpy(np.asarray(images[i], np.float32)),
                                            torch.from_numpy(rgb))))
        return float(np.mean(psnrs)), float(np.mean(ssims))

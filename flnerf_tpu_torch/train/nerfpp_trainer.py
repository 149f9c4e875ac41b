"""NeRF++ cascade trainer (ddp_train_nerf.py) on one device.

Port of ``flnerf_tpu/train/nerfpp_trainer.py``.  Reference flow
(nerf++-ours/ddp_train_nerf.py:187-324, 327-427): per batch, for each
cascade level m, level 0 samples fg depths uniformly to the unit-sphere
exit and bg depths uniformly in [0, 1] (both perturbed); level 1
importance-samples from level 0's weights and concatenates and sorts; each
level has its own Adam and takes its own backward and step per iteration.
The per-leaf mean of ``max |rgb - gt|`` drives the quadtree subdivision
(tree.py:621-622).

Semantics kept from the reference:
  * an epoch is split into steps of ``batch_size`` rays in order; the last
    step may be partial.  The reference pads the epoch to whole chunks and
    makes its padding-only steps no-ops (no Adam update, no ``global_iter``
    increment); here they are not run, so the steps equal the reference's
    real steps.
  * one ``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8)`` a level, over its
    ``NerfNet`` (autoexpo table included): optax ``scale_by_adam`` then
    ``-lr``.  Each step sets both levels' lr to ``lrate * factor **
    (global_iter / decay_steps)`` before ``global_iter`` is incremented.
  * level 0 takes its backward and step first; level 1 samples from level
    0's detached weights, computed before that step.
  * the leaf statistic is summed on the device (``index_add_``) from the
    last level's rgb before the autoexpo correction, and crosses to the
    host once an epoch; the reported mse is the finest level's loss (with
    the autoexpo term) of the epoch's last step.

Random draws: the reference derives them from JAX keys (``fit`` splits
PRNGKey(seed + 1) once an epoch, then per chunk, step, level).  Here they
come from a ``torch.Generator`` seeded with ``seed + 1`` on the step's
device, or from a ``draws`` hook so a test can feed the reference's own:
per (step, level), the fg and bg perturbation uniforms at level 0 and the
fg and bg inverse-CDF uniforms at level 1, [rays, samples], whose first
rows are taken.  Eval perturbs as the reference does, with the same draws
in every chunk: one generator a level seeded with the level's index, anew
for each chunk (the reference's PRNGKey(m) draws other bits from the same
law).  The weights are drawn on the CPU from torch's stream seeded with
``seed`` and then moved to the device.  The reference's data mesh has no
counterpart (ROADMAP M20).
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from flnerf_tpu_torch.core.device import resolve_device
from flnerf_tpu_torch.core.metrics import compute_ssim, mse2psnr
from flnerf_tpu_torch.models.nerfpp import (
    NerfNet,
    NerfPPConfig,
    intersect_sphere,
    nerfpp_render,
    perturb_samples,
)
from flnerf_tpu_torch.rays.quadtree import RayBudgeter, RayEpoch
from flnerf_tpu_torch.render.common import unit_linspace
from flnerf_tpu_torch.render.sampling import sample_pdf

# (step, level) -> (fg, bg) uniforms [>= rays, samples]
StepDraws = Callable[[int, int], Tuple[object, object]]


class NerfPPTrainConfig(NamedTuple):
    n_epoch: int = 6
    batch_size: int = 2880
    lrate: float = 5e-4
    lrate_decay_factor: float = 0.1
    lrate_decay_steps: int = 5000
    subdivide_every: int = 1
    subdivide_thres: float = 0.015
    rand_samp_perc: float = 0.5
    prob_sampling: bool = True      # nerf++ uses sharpness maps (282-284)
    min_depth: float = 1e-4
    seed: int = 777                 # torch.manual_seed(777), :139
    compute_dtype: str = "bfloat16"


def check_inside_unit_sphere(origins: np.ndarray, dirs: np.ndarray) -> None:
    """The reference's hard assert (ddp_train_nerf.py:54-70), on the host:
    every ray's closest point to the centre lies inside the unit sphere."""
    n = origins.shape[0]
    if not n:
        return
    d1 = -np.sum(dirs * origins, -1) / np.maximum(np.sum(dirs * dirs, -1), 1e-12)
    pmid = origins + d1[..., None] * dirs
    n_out = int(np.sum(np.sum(pmid * pmid, -1) >= 1.0))
    if n_out:
        raise ValueError(
            f"{n_out}/{n} rays never enter the unit sphere — nerf++ needs cameras "
            "normalized into it (data/pose_tools.py normalize_cam_dict)")


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative at 0 (+1, where torch's is 0): the
    autoexpo table starts at (0.5, 0), where its regularizer's terms are
    exactly 0."""
    return torch.where(x >= 0, x, -x)


class NerfPPTrainer:
    def __init__(self, model_cfg: NerfPPConfig, train_cfg: NerfPPTrainConfig,
                 n_images: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.mcfg = model_cfg
        self.cfg = train_cfg
        self.dtype = torch.bfloat16 if train_cfg.compute_dtype == "bfloat16" else torch.float32
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(train_cfg.seed)
            # n_images > 0 with optim_autoexpo makes the per-image (scale,
            # shift) table (NerfNetWithAutoExpo, ddp_model.py:158-186)
            self.nets: List[NerfNet] = [
                NerfNet(model_cfg, n_images, self.dtype).to(self.device)
                for _ in model_cfg.cascade_samples]
        self.optimizers = [torch.optim.Adam(net.parameters(), lr=train_cfg.lrate,
                                            betas=(0.9, 0.999), eps=1e-8)
                           for net in self.nets]
        self.global_iter = 0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(train_cfg.seed + 1)
        self.history: list = []

    # ------------------------------------------------------------------
    def _uniforms(self, given, n_rays: int, n_samples: int, generator) -> torch.Tensor:
        if given is None:
            return torch.rand((n_rays, n_samples), generator=generator, device=self.device)
        return torch.as_tensor(np.array(given[:n_rays], np.float32), device=self.device)

    def _depths(self, level: int, ray_o, fg_z_max, prev, draws, generator):
        """Level ``level``'s fg and bg sample depths (``_render_level``)."""
        n_samples = self.mcfg.cascade_samples[level]
        n = ray_o.shape[0]
        fg_u, bg_u = draws if draws is not None else (None, None)
        fg_u = self._uniforms(fg_u, n, n_samples, generator)
        bg_u = self._uniforms(bg_u, n, n_samples, generator)
        if level == 0:
            # the reference's division by a constant, as XLA compiles it: a
            # multiply by the f32 reciprocal (render/common.unit_linspace)
            step = (fg_z_max - self.cfg.min_depth) * float(
                np.float32(1.0) / np.float32(n_samples - 1))
            fg_depth = self.cfg.min_depth + step[..., None] * torch.arange(
                n_samples, dtype=torch.float32, device=ray_o.device)
            fg_depth = perturb_samples(fg_depth, fg_u)
            bg_depth = unit_linspace(n_samples, ray_o.device).expand(n, n_samples)
            bg_depth = perturb_samples(bg_depth, bg_u)
            return fg_depth, bg_depth
        out = []
        for z, w, u in ((prev["fg_depth_vals"], prev["fg_weights"], fg_u),
                        (prev["bg_depth_vals"], prev["bg_weights"], bg_u)):
            mids = 0.5 * (z[..., 1:] + z[..., :-1])
            new = sample_pdf(mids, w[..., 1:-1], n_samples, u=u)
            out.append(torch.sort(torch.cat([z, new], -1), -1).values)
        return tuple(out)

    def _render_level(self, level, ray_o, ray_d, fg_z_max, prev, draws=None, generator=None):
        fg_depth, bg_depth = self._depths(level, ray_o, fg_z_max, prev, draws, generator)
        out = nerfpp_render(self.nets[level], ray_o, ray_d, fg_z_max, fg_depth, bg_depth,
                            self.mcfg)
        out["fg_depth_vals"] = fg_depth
        out["bg_depth_vals"] = bg_depth
        return out

    def _loss(self, net: NerfNet, rgb_pred, rgb, img):
        """Mean squared error over the step's rays, with the autoexpo
        correction and its L1 regularizer (ddp_train_nerf.py:388-396)."""
        n = rgb.shape[0]
        pred = rgb_pred
        if net.autoexpo is not None:
            ae = net.autoexpo[img]
            scale = _abs(ae[:, 0:1]) + 0.5
            shift = ae[:, 1:2]
            pred = (pred - shift) / scale
        loss = torch.sum((pred - rgb) ** 2) / (n * 3.0)
        if net.autoexpo is not None:
            reg = _abs(scale[:, 0] - 1.0) + _abs(shift[:, 0])
            loss = loss + self.mcfg.lambda_autoexpo * torch.sum(reg) / n
        return loss

    def _step(self, o, d, rgb, leaf, img, err_sum, err_cnt, step_draws: Optional[StepDraws],
              step: int) -> torch.Tensor:
        """One step of both levels on a batch of real rays; returns the
        finest level's loss (on the device)."""
        cfg = self.cfg
        lr = cfg.lrate * cfg.lrate_decay_factor ** (self.global_iter / cfg.lrate_decay_steps)
        fg_z_max, _ = intersect_sphere(o, d)
        prev, loss = None, None
        for m, (net, opt) in enumerate(zip(self.nets, self.optimizers)):
            for g in opt.param_groups:
                g["lr"] = lr
            draws = step_draws(step, m) if step_draws is not None else None
            out = self._render_level(m, o, d, fg_z_max, prev, draws, self.generator)
            loss = self._loss(net, out["rgb"], rgb, img)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            prev = {k: v.detach() for k, v in out.items()}
        self.global_iter += 1
        with torch.no_grad():
            err = torch.amax(torch.abs(prev["rgb"] - rgb), dim=-1)
            err_sum.index_add_(0, leaf, err)
            err_cnt.index_add_(0, leaf, torch.ones_like(err))
        return loss.detach()

    def run_epoch_rays(self, epoch: RayEpoch,
                       draws: Optional[StepDraws] = None) -> Tuple[np.ndarray, float]:
        """Train on one epoch's rays; returns (leaf_stat [n_leaves], mse)."""
        B = self.cfg.batch_size
        n = epoch.origins.shape[0]
        check_inside_unit_sphere(epoch.origins, epoch.dirs)
        dev = self.device
        origins, dirs, rgb = (torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
                              for a in (epoch.origins, epoch.dirs, epoch.rgb))
        leaf = torch.as_tensor(np.asarray(epoch.leaf_id, np.int64), device=dev)
        img = (torch.as_tensor(np.asarray(epoch.img, np.int64), device=dev)
               if epoch.img is not None else torch.zeros(n, dtype=torch.int64, device=dev))
        err_sum = torch.zeros(epoch.n_leaves, device=dev)
        err_cnt = torch.zeros(epoch.n_leaves, device=dev)
        last = None
        for step, i in enumerate(range(0, n, B)):
            sl = slice(i, min(i + B, n))
            last = self._step(origins[sl], dirs[sl], rgb[sl], leaf[sl], img[sl],
                              err_sum, err_cnt, draws, step)
        # the one host transfer of the epoch
        s, c = err_sum.cpu().numpy(), err_cnt.cpu().numpy()
        stat = s / np.maximum(c, 1.0)
        stat[c == 0] = -np.inf
        mse = float(last.cpu()) if last is not None else 0.0
        return stat, mse

    def fit(self, budgeter: RayBudgeter, start_epoch: int = 0,
            on_epoch_end: Optional[Callable] = None, verbose: bool = True,
            draws: Optional[Callable[[int, int], StepDraws]] = None):
        """Full training run (ddp_train_nerf.py:187-324).  ``draws(epoch_id,
        n_rays)``, when given, returns the epoch's per-step draws hook."""
        cfg = self.cfg
        t0 = time.time()
        for epoch_id in range(start_epoch + 1, cfg.n_epoch + 1):
            te = time.time()
            last = epoch_id == cfg.n_epoch
            epoch = budgeter.gen_rays(
                down_scale=1,
                prob=cfg.prob_sampling and not last,
                rand_samp_perc=cfg.rand_samp_perc,
                last_epoch=last,
            )
            n_rays = int(epoch.origins.shape[0])
            leaf_stat, mse = self.run_epoch_rays(
                epoch, draws(epoch_id, n_rays) if draws is not None else None)
            epoch_s = time.time() - te

            # mean-loss subdivision (nerf++-ours/tree.py:621-622), with the
            # epoch guard of ddp_train_nerf.py:298-304
            if (cfg.subdivide_every > 0 and epoch_id % cfg.subdivide_every == 0
                    and epoch_id < cfg.n_epoch - 1):
                n_split = budgeter.adjust(leaf_stat, cfg.subdivide_thres)
                if verbose:
                    print(f"  subdivided {n_split} -> {budgeter.forest.n_leaves} leaves")

            psnr = float(mse2psnr(mse))
            self.history.append(
                {"epoch": epoch_id, "wall_s": time.time() - t0, "train_psnr": psnr,
                 "rays": n_rays, "epoch_s": epoch_s,
                 "n_leaves": int(budgeter.forest.n_leaves)})
            if verbose:
                print(f"epoch {epoch_id}/{cfg.n_epoch}: rays {n_rays} "
                      f"train-psnr {psnr:.2f} ({time.time() - te:.1f}s)")
            if on_epoch_end is not None:
                on_epoch_end(self, epoch_id)

    # ------------------------------------------------------------------
    def _eval_rays(self, rays_o: torch.Tensor, rays_d: torch.Tensor, chunk: int = 4096,
                   draws: Optional[Callable[[int], Tuple[object, object]]] = None):
        """Render [N, 3] rays in chunks; ``draws(level)`` (the same for
        every chunk, first rows taken) or one generator a level seeded with
        the level's index, anew for each chunk."""
        outs = []
        with torch.no_grad():
            for i in range(0, rays_o.shape[0], chunk):
                ro, rd = rays_o[i:i + chunk], rays_d[i:i + chunk]
                fg_z_max, _ = intersect_sphere(ro, rd)
                prev = None
                for m in range(len(self.nets)):
                    gen = None
                    if draws is None:
                        gen = torch.Generator(device=self.device)
                        gen.manual_seed(m)
                    prev = self._render_level(m, ro, rd, fg_z_max, prev,
                                              draws(m) if draws is not None else None, gen)
                outs.append(prev["rgb"])
        return torch.cat(outs, 0)

    def render_image(self, H, W, K, c2w, chunk: int = 4096, draws=None) -> np.ndarray:
        """Full-image chunked cascade render (ddp_test_nerf.py:126-227), in
        the OpenCV ray convention of the nerf++ data."""
        from flnerf_tpu_torch.data.nerfpp_dataset import get_rays_opencv_np

        intr4 = np.eye(4, dtype=np.float32)
        intr4[:3, :3] = np.asarray(K)[:3, :3]
        ro, rd = get_rays_opencv_np(H, W, intr4, np.asarray(c2w))
        rgb = self._eval_rays(
            torch.as_tensor(ro.reshape(-1, 3), device=self.device),
            torch.as_tensor(rd.reshape(-1, 3), device=self.device), chunk, draws)
        return rgb.cpu().numpy().reshape(H, W, 3)

    def eval_images(self, poses, images, H, W, K, chunk: int = 4096, draws=None):
        """Mean PSNR and SSIM over held-out views."""
        psnrs, ssims = [], []
        for i in range(poses.shape[0]):
            rgb = self.render_image(H, W, K, poses[i][:3, :4], chunk, draws)
            mse = float(np.mean((rgb - images[i]) ** 2))
            psnrs.append(-10.0 * np.log10(max(mse, 1e-12)))
            ssims.append(float(compute_ssim(torch.as_tensor(images[i]), torch.as_tensor(rgb))))
        return float(np.mean(psnrs)), float(np.mean(ssims))

"""Instant-NGP trainer with probability-map ray selection.

Port of ``flnerf_tpu/train/ngp_trainer.py`` for one device.  Reference
behavior (ngp-ours):
  * Trainer (nerf/utils.py:288-911): Adam betas (0.9, 0.99) eps 1e-15
    (``optax.scale_by_adam``), lr * 0.1**min(step/max_steps, 1), occupancy
    update every chunk of 16 steps (utils.py:837-839), EMA of the weights,
    random background for RGBA data;
  * ray selection (nerf/provider.py + quadtree.py): per-image probability
    map (uniform by default, optionally local-variance based), multinomial
    draw with replacement, per-ray error map, all-pixel switch near the end.

``NGPSampler`` is a numpy port that draws from ``np.random.default_rng(seed)``
in the reference's call order, so its rays equal the reference's bit for
bit.  The step counter and Adam's count live on the host: no device read is
ever needed for them, so the reference's host step mirror and its
invalidation (ADVICE.md item 1) reduce to two integers (equal until
``replace_field`` resets Adam's).  The device
queue is drained once per ``fit`` (the loss history, one stacked transfer),
once per chunk with ``--error_map`` (the per-ray errors, as in the
reference) and at the verbose prints.

The trainer takes an ``NGPConfig`` or any field module (``density``,
``color``, ``device``, ``parameters()``), and ``replace_field`` swaps the
field mid-run: the port of the reference's generic field protocol, which
the TensoRF, CP and CCNeRF CLIs drive.

A field with the background env-map (``NGPField.has_background``, an
``NGPConfig`` with ``bg_radius > 0``) renders with it in place of
``bg_color``, its parameters train with the field's (Adam and the EMA), and
RGBA data is composited on white for its ground truth, not on a random
background (utils.py:469-471); eval renders with it too.

With ``time_dependent`` (D-NeRF) the field's density takes a time,
``density(x, t)``: the sampler gives each ray its frame's time, the step
renders at those times, each occupancy refresh draws one t ~ U(0, 1) (before
the refresh's own draws, as the reference splits its key into (kt, ku)) and
``eval_images`` renders frame i at ``times[i]``.

Data parallelism (the reference's ``shard_map`` branch, ngp_trainer.py:
310-369): with ``group`` of W > 1 ranks and ``batch_rays % W == 0`` each rank
renders its contiguous slice of every batch (through K3/K4, or the big-table
engines) and the loss and gradients are averaged by one all-reduce; the
per-ray losses are gathered for the error map.  Parameters, Adam, the EMA and
the occupancy refreshes stay replicated: every rank samples the same batches
and draws the whole batch's noise from the same seeded generator, keeping its
slice, so W ranks give one rank's step up to the order of the sums.  (The
reference folds each shard's index into its key instead; ``train_step(noise=)``
takes such a shard's noise.)  When the batch does not divide, every rank runs
the whole batch, as GSPMD would.
"""

from __future__ import annotations

import contextlib
import glob
import os
import pickle
import time
from typing import NamedTuple

import numpy as np
import torch

from flnerf_tpu_torch.core.logging_utils import RECORDER
from flnerf_tpu_torch.core.losses import huber_loss
from flnerf_tpu_torch.core.metrics import compute_ssim, mse2psnr
from flnerf_tpu_torch.models.hash_ngp import NGPConfig, NGPField, engine_kind
from flnerf_tpu_torch.parallel import mesh
from flnerf_tpu_torch.rays.camera import get_rays_np
from flnerf_tpu_torch.rays.sharpness import sharp_image
from flnerf_tpu_torch.render.ngp import (
    NGPRenderConfig,
    init_occupancy,
    march,
    ngp_render_image,
    render_marched,
    update_occupancy,
)
from flnerf_tpu_torch.core.device import resolve_device

CKPT_FORMAT = "flnerf_torch_ngp_v1"
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.99, 1e-15


class NGPTrainConfig(NamedTuple):
    max_steps: int = 30000
    batch_rays: int = 4096
    lr: float = 1e-2
    steps_per_chunk: int = 16      # == occupancy update cadence
    occ_update_every: int = 1      # in chunks
    full_refreshes: int = 16       # full-grid updates before partial ones
    use_prob_map: bool = False     # variance-based image probs (quadtree.py:5)
    use_error_map: bool = False    # --error_map: 128x128 EMA maps (utils.py:505-527)
    patch_size: int = 1            # >1: patch-mode draw (utils.py:78-95)
    all_pixel_at: float = 1.0      # fraction of training after which probs
                                   # reset to uniform (change_to_allpixel)
    bg_color: float = 1.0
    ema_decay: float = 0.0         # 0 disables; torch-ngp uses 0.95
    time_dependent: bool = False   # D-NeRF: the field's density takes (x, t)
    loss_type: str = "mse"         # 'mse' | 'huber' (loss.py:18)
    huber_delta: float = 0.1
    seed: int = 0


class NGPSampler:
    """Per-image probability-map pixel sampler (provider.py:236-366).
    ``times`` [n_images] gives each view its D-NeRF time."""

    @RECORDER.spanned("flnerf.budget.sampler_init")
    def __init__(self, images, poses, K, cfg: NGPTrainConfig, seed: int = 0, times=None):
        self.cfg = cfg
        self.times = None if times is None else np.asarray(times, np.float32)
        images = np.ascontiguousarray(images, np.float32)
        # RGBA inputs keep their alpha for random-background compositing
        self.alphas = (images[..., 3:4].reshape(images.shape[0], -1, 1)
                       if images.shape[-1] == 4 else None)
        self.images = images[..., :3]
        self.n_images, self.H, self.W = images.shape[:3]
        self.rng = np.random.default_rng(seed)

        origins, dirs = [], []
        for p in poses:
            o, d = get_rays_np(self.H, self.W, K, p[:3, :4])
            origins.append(o.reshape(-1, 3))
            d = d.reshape(-1, 3)
            dirs.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
        self.origins = np.stack(origins, 0)   # [n, HW, 3]
        self.dirs = np.stack(dirs, 0)
        self.pixels = self.images.reshape(self.n_images, -1, 3)

        if cfg.use_prob_map:
            probs = []
            for im in self.images:
                s = sharp_image(im).reshape(-1).astype(np.float64) + 1e-6
                probs.append(s / s.sum())
            self.image_probs = np.stack(probs, 0)
        else:
            self.image_probs = None

        self.error_map_res = 128
        self.error_map = (np.ones((self.n_images, self.error_map_res ** 2), np.float64)
                          if cfg.use_error_map else None)
        self._img_cursor = 0

    def change_to_allpixel(self):
        """provider.py:363-366 — drop the prob maps near the end."""
        self.image_probs = None
        self.error_map = None

    def _sample_patches(self, batch: int):
        """Patch-mode pixel draw (nerf/utils.py:78-95); overrides the
        prob/error-map sampling."""
        p = self.cfg.patch_size
        n_patch = batch // (p * p)
        ix = self.rng.integers(0, self.H - p, n_patch)
        iy = self.rng.integers(0, self.W - p, n_patch)
        pi, pj = np.meshgrid(np.arange(p), np.arange(p), indexing="ij")
        px = (ix[:, None] + pi.reshape(-1)[None]).reshape(-1)
        py = (iy[:, None] + pj.reshape(-1)[None]).reshape(-1)
        inds = px * self.W + py
        if inds.shape[0] < batch:      # batch not divisible by p^2: pad
            extra = self.rng.integers(0, self.H * self.W, batch - inds.shape[0])
            inds = np.concatenate([inds, extra])
        return inds

    def _sample_error_map(self, i: int, batch: int):
        """2-level error-map draw (nerf/utils.py:113-124)."""
        em = self.error_map[i]
        p = em / em.sum()
        inds_coarse = self.rng.choice(em.shape[0], size=batch, p=p)
        r = self.error_map_res
        ix, iy = inds_coarse // r, inds_coarse % r
        sx, sy = self.H / r, self.W / r
        px = np.minimum((ix * sx + self.rng.random(batch) * sx).astype(np.int64), self.H - 1)
        py = np.minimum((iy * sy + self.rng.random(batch) * sy).astype(np.int64), self.W - 1)
        return px * self.W + py, inds_coarse

    @RECORDER.spanned("flnerf.budget.update_error_map")
    def update_error_map(self, img_ids, inds_coarse, per_ray_err):
        """EMA update at the sampled coarse cells (utils.py:521-527):
        new = 0.1 * old + 0.9 * err."""
        if self.error_map is None:
            return
        for s in range(img_ids.shape[0]):
            em = self.error_map[img_ids[s]]
            em[inds_coarse[s]] = 0.1 * em[inds_coarse[s]] + 0.9 * per_ray_err[s]

    @RECORDER.spanned("flnerf.budget.sample_chunk")
    def sample_chunk(self, n_steps: int, batch: int):
        """[n_steps] training batches, each of ``batch`` rays from one image
        (provider.py:289).  Returns (origins, dirs, rgb [n_steps, batch, 3|4
        — alpha appended for RGBA], img_ids [n_steps], inds_coarse|None)
        and, for a sampler given times, a sixth element: times [n_steps,
        batch], each ray its image's time (no extra draw)."""
        origins = np.empty((n_steps, batch, 3), np.float32)
        dirs = np.empty((n_steps, batch, 3), np.float32)
        rgb = np.empty((n_steps, batch, 3 if self.alphas is None else 4), np.float32)
        img_ids = np.empty(n_steps, np.int64)
        inds_coarse = (np.empty((n_steps, batch), np.int64)
                       if self.error_map is not None and self.cfg.patch_size <= 1 else None)
        hw = self.H * self.W
        for s in range(n_steps):
            i = self._img_cursor % self.n_images
            self._img_cursor += 1
            img_ids[s] = i
            if self.cfg.patch_size > 1:
                inds = self._sample_patches(batch)
            elif self.error_map is not None:
                inds, ic = self._sample_error_map(i, batch)
                inds_coarse[s] = ic
            elif self.image_probs is None:
                inds = self.rng.integers(0, hw, batch)
            else:
                inds = self.rng.choice(hw, size=batch, p=self.image_probs[i])
            origins[s] = self.origins[i, inds]
            dirs[s] = self.dirs[i, inds]
            rgb[s, :, :3] = self.pixels[i, inds]
            if self.alphas is not None:
                rgb[s, :, 3:] = self.alphas[i, inds]
        if self.times is None:
            return origins, dirs, rgb, img_ids, inds_coarse
        times = np.repeat(self.times[img_ids][:, None], batch, axis=1)
        return origins, dirs, rgb, img_ids, inds_coarse, times


class NGPTrainer:
    """Trains a field: an ``NGPField`` built from an ``NGPConfig``, with
    parameters drawn from ``torch.Generator`` seeded with ``train_cfg.seed``,
    or any field module given whole (the reference's generic
    ``(init_fn, density_fn, rgb_fn)`` protocol: TensoRF, CP, CCNeRF).  A
    field has ``density(x) -> (sigma, feat)``, ``color(d, feat) -> rgb``,
    ``device`` and ``parameters()``; the trainer moves it to its device.  The
    per-step noise comes from a second generator seeded with seed + 1.  With
    ``train_cfg.time_dependent`` the field's density is ``density(x, t)``.
    ``group``: the process group the batch is sharded over (None: the
    default group when one is initialised, else one rank)."""

    def __init__(self, field, render_cfg: NGPRenderConfig,
                 train_cfg: NGPTrainConfig, device="cuda",
                 compute_dtype=torch.bfloat16, group=None):
        if train_cfg.loss_type not in ("mse", "huber"):
            raise ValueError(f"unknown loss_type {train_cfg.loss_type!r} (mse|huber)")
        self.device = resolve_device(device)
        self.rcfg = render_cfg
        self.cfg = train_cfg
        self.group = group
        self.world, self.rank = mesh.world(group), mesh.rank(group)
        self.shard_grads = self.world > 1 and train_cfg.batch_rays % self.world == 0
        if isinstance(field, NGPConfig):
            gen = torch.Generator(device=self.device).manual_seed(train_cfg.seed)
            field = NGPField(field, compute_dtype, gen, self.device)
        self.replace_field(field)
        self.step = 0
        self.occ = init_occupancy(render_cfg, self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(train_cfg.seed + 1)
        self.history = []

    def replace_field(self, field):
        """Take ``field``, on the trainer's device, with Adam reset to zero
        moments and count 0 and, with EMA on, an EMA copied from its
        parameters.  Mid-run this is the reference's ``replace_field`` (the
        TensoRF shrink and upsample boundaries, tensoRF/utils.py:112-128:
        'reset optimizer since params changed', :127): the step, and so the
        lr decay over cfg.max_steps, and the occupancy grid carry over."""
        self.field = field.to(self.device)
        # the learned background replaces bg_color (network.py:66-93)
        self.bg_fn = (self.field.background if getattr(self.field, "has_background", False)
                      else None)
        self.params = list(self.field.parameters())
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.ema = ([p.detach().clone() for p in self.params]
                    if self.cfg.ema_decay > 0 else None)

    # ------------------------------------------------------------------
    def lr_at(self, step: int) -> float:
        """LambdaLR 0.1 ** (iter / max_steps), clamped, in float32."""
        e = np.minimum(np.float32(step) / np.float32(self.cfg.max_steps), np.float32(1.0))
        return float(np.float32(self.cfg.lr) * np.float32(0.1) ** e)

    @RECORDER.spanned("flnerf.train.step")
    def train_step(self, origins, dirs, rgb, noise=None, bg_noise=None, times=None):
        """One Adam step on a batch; returns (loss, per-ray loss) as device
        tensors.  ``noise`` [B, S] and ``bg_noise`` [B, 3] (RGBA data only)
        replace the draws from the trainer's generator; ``times`` [B] are the
        rays' times for a time-dependent field.  Sharded over W ranks, the
        batch is the whole one and ``noise``/``bg_noise`` are this rank's
        [B / W] rows."""
        cfg = self.cfg
        n = origins.shape[0]
        RECORDER.count("flnerf.train.steps")
        RECORDER.count("flnerf.train.rays", n)
        rows = mesh.step_rows(n, self.world, self.rank) if self.shard_grads else None
        if rows is not None:
            # this rank's rows of the whole batch's draws
            if rgb.shape[-1] == 4 and bg_noise is None and self.bg_fn is None:
                bg_noise = torch.rand((n, 3), generator=self.gen, device=rgb.device)[rows]
            if noise is None:
                noise = torch.rand((n, self.rcfg.n_candidates), generator=self.gen,
                                   device=origins.device)[rows]
            origins, dirs, rgb = origins[rows], dirs[rows], rgb[rows]
            times = None if times is None else times[rows]
        with torch.enable_grad(), RECORDER.span("flnerf.train.forward"):
            if rgb.shape[-1] == 4 and self.bg_fn is None:
                # pixel-wise random background (utils.py:474-479)
                bg = (torch.rand(rgb[..., :3].shape, generator=self.gen, device=rgb.device)
                      if bg_noise is None else bg_noise)
                gt = rgb[..., :3] * rgb[..., 3:] + bg * (1.0 - rgb[..., 3:])
            elif rgb.shape[-1] == 4:
                # the background model: gt on white (utils.py:469-471)
                bg, gt = None, rgb[..., :3] * rgb[..., 3:] + 1.0 - rgb[..., 3:]
            else:
                bg, gt = cfg.bg_color, rgb
            # ngp_render_rays, with the march's kept samples counted
            marched = march(self.occ, origins, dirs, self.rcfg, True, noise, self.gen)
            RECORDER.count_device("flnerf.ngp.kept_samples", marched[1])
            if self.bg_fn is not None:
                bg = self.bg_fn(origins, dirs)
            out = render_marched(self.field, marched, dirs, self.rcfg, bg, times)
            if cfg.loss_type == "huber":
                per_ray = torch.mean(huber_loss(out["rgb"], gt, cfg.huber_delta,
                                                reduce=False), -1)
            else:
                per_ray = torch.mean((out["rgb"] - gt) ** 2, -1)
            loss = torch.mean(per_ray)
        with torch.enable_grad(), RECORDER.span("flnerf.train.backward"):
            # a parameter the loss does not reach takes a zero gradient, as
            # in the reference: the D-NeRF deform net on the card, where
            # K3/K4 give the encoded points no gradient (ROADMAP.md R7)
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
        loss, per_ray = loss.detach(), per_ray.detach()
        if rows is not None:
            # pmean of the loss and the gradients; the per-ray losses gathered
            loss = loss.reshape(1)
            mesh.all_reduce_([loss] + grads, group=self.group)
            loss = loss[0] / self.world
            for g in grads:
                g.div_(self.world)
            per_ray = mesh.gather_rows(per_ray, self.rank, self.world, self.group)
        self._adam(grads)
        return loss, per_ray

    @RECORDER.spanned("flnerf.train.optimizer")
    @torch.no_grad()
    def _adam(self, grads):
        """optax.scale_by_adam(0.9, 0.99, 1e-15), then -lr * update, then the
        EMA; in place."""
        lr = self.lr_at(self.step)
        count = self.count + 1
        c1 = float(1.0 - np.float32(ADAM_B1) ** count)
        c2 = float(1.0 - np.float32(ADAM_B2) ** count)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            p.add_((m / c1) / (torch.sqrt(v / c2) + ADAM_EPS), alpha=-lr)
        if self.ema is not None:
            d = self.cfg.ema_decay
            for e, p in zip(self.ema, self.params):
                e.mul_(d).add_(p, alpha=1.0 - d)
        self.count = count
        self.step += 1

    @RECORDER.spanned("flnerf.train.refresh")
    def refresh_occupancy(self, partial: bool, time=None):
        """One occupancy refresh.  A time-dependent trainer refreshes at one
        time for the whole grid: ``time``, or t ~ U(0, 1) drawn first."""
        if self.cfg.time_dependent and time is None:
            time = torch.rand((), generator=self.gen, device=self.device)
        self.occ = update_occupancy(self.occ, self.field, self.rcfg, partial=partial,
                                    generator=self.gen, time=time)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            # pinned, so the copy does not wait for the queued steps
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def fit(self, sampler: NGPSampler, verbose: bool = True, n_steps: int = None):
        """Train cfg.max_steps steps (or n_steps, for callers that
        interleave fits while cfg.max_steps stays the total the lr decays
        over), in chunks of steps_per_chunk with an occupancy refresh before
        each: full for the first full_refreshes, then partial."""
        cfg = self.cfg
        if cfg.time_dependent and sampler.times is None:
            raise ValueError("a time-dependent trainer needs a sampler given times")
        spc = cfg.steps_per_chunk
        n_chunks = -((n_steps or cfg.max_steps) // -spc)
        t0 = time.time()
        # "wall_s": seconds from the fit's start to the end of a chunk's last
        # step, on the device's clock: on CUDA from events resolved at the
        # fit's one stacked transfer, on the CPU (which runs each op as it
        # is issued) from the host's
        cuda = self.device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        base_step = self.step
        hist_start = len(self.history)
        # the previous chunk's results, absorbed after the next chunk is
        # queued (the error map lags its rays by one chunk, as in the
        # reference)
        pending = None

        def absorb(p):
            img_ids, inds_coarse, per_ray, losses, step_after, done = p
            if inds_coarse is not None:
                with RECORDER.span("flnerf.io.drain"):
                    err = per_ray.cpu().numpy()
                sampler.update_error_map(img_ids, inds_coarse, err)
            # "loss" is the chunk's last step (the reference's entry);
            # "chunk_loss" the mean over its steps
            self.history.append({"step": step_after, "wall_s": done,
                                 "loss": losses[-1], "chunk_loss": losses.mean()})

        allpixel_step = int(cfg.max_steps * cfg.all_pixel_at)
        for ci in range(n_chunks):
            if (base_step + ci * spc >= allpixel_step) and (
                    sampler.image_probs is not None or sampler.error_map is not None):
                sampler.change_to_allpixel()
                if verbose:
                    print("switched to all-pixel (uniform) sampling")
            if ci % cfg.occ_update_every == 0:
                n_refresh = (base_step + ci * spc) // (cfg.occ_update_every * spc)
                self.refresh_occupancy(partial=n_refresh >= cfg.full_refreshes)

            drawn = sampler.sample_chunk(spc, cfg.batch_rays)
            img_ids, inds_coarse = drawn[3:5]
            with RECORDER.span("flnerf.io.upload"):
                origins, dirs, rgb = (self._to_device(a) for a in drawn[:3])
                times = self._to_device(drawn[5]) if cfg.time_dependent else None
            outs = [self.train_step(origins[k], dirs[k], rgb[k],
                                    times=None if times is None else times[k])
                    for k in range(spc)]
            if cuda:
                done = torch.cuda.Event(enable_timing=True)
                done.record()
            else:
                done = time.time() - t0
            losses = torch.stack([o[0] for o in outs])
            per_ray = torch.stack([o[1] for o in outs])
            if pending is not None:
                absorb(pending)
            pending = (img_ids, inds_coarse, per_ray, losses, base_step + (ci + 1) * spc, done)

            if verbose and (ci % max(1, n_chunks // 20) == 0 or ci == n_chunks - 1):
                if self.history:
                    h = self.history[-1]
                    loss = float(h["loss"])
                    print(f"step {h['step']}/{cfg.max_steps}: loss {loss:.5f} "
                          f"psnr {float(mse2psnr(loss)):.2f} ({time.time() - t0:.0f}s)")
        if pending is not None:
            absorb(pending)
        ent = self.history[hist_start:]
        if ent:
            # one stacked transfer for the whole fit, which also reads the
            # recorder's device counters when there are any
            vals = torch.stack([torch.stack([h["loss"], h["chunk_loss"]]) for h in ent])
            dev = RECORDER.take_device()
            with RECORDER.span("flnerf.io.drain"):
                if dev:
                    n = vals.numel()
                    flat = torch.cat([vals.reshape(-1).double(),
                                      torch.stack(list(dev.values()))]).cpu().numpy()
                    RECORDER.add_counts(dict(zip(dev, flat[n:].tolist())))
                    vals = flat[:n].reshape(len(ent), 2)
                else:
                    vals = vals.cpu().numpy()
            for h, (last, mean) in zip(ent, vals):
                h["loss"], h["chunk_loss"] = float(last), float(mean)
                if cuda:
                    h["wall_s"] = start.elapsed_time(h["wall_s"]) / 1e3
        return self

    # ------------------------------------------------------------------
    def _tree(self, tensors):
        """Parameter-ordered tensors -> the reference's numpy tree: the NGP
        params dict for an ``NGPField``, the D-NeRF variant's tree for a
        D-NeRF field, the TensoRF/CP/CCNeRF dict of arrays and lists of
        arrays for any other field."""
        from flnerf_tpu_torch.core import convert
        from flnerf_tpu_torch.models.dnerf import DNeRFBase

        if isinstance(self.field, NGPField):
            cfg = self.field.cfg
            return convert.ngp_params_to_numpy(
                tensors, cfg.num_layers, engine_kind(self.field.spec),
                cfg.num_layers_bg if self.field.has_background else 0)
        if isinstance(self.field, DNeRFBase):
            return convert.dnerf_params_to_numpy(self.field, tensors)
        return convert.tensorf_params_to_numpy(self.field, tensors)

    def _tensors(self, tree):
        """Inverse of ``_tree``, onto the trainer's device."""
        from flnerf_tpu_torch.core import convert
        from flnerf_tpu_torch.models.dnerf import DNeRFBase

        if isinstance(self.field, NGPField):
            return convert.ngp_params_from_numpy(tree, self.device)
        if isinstance(self.field, DNeRFBase):
            return convert.dnerf_params_from_numpy(self.field, tree, self.device)
        return convert.tensorf_params_from_numpy(self.field, tree, self.device)

    def save_checkpoint(self, workspace: str, name: str = None, max_keep: int = 2) -> str:
        """Trainer.save_checkpoint analog (nerf/utils.py:1014-1074): params,
        EMA, Adam moments, occupancy and step, in the reference's numpy
        layouts, with max_keep rotation."""
        ckpt_dir = os.path.join(workspace, "checkpoints")
        os.makedirs(ckpt_dir, exist_ok=True)
        name = name or f"ngp_ep{self.step:07d}"
        payload = {
            "format": CKPT_FORMAT,
            "step": self.step,
            "params": self._tree(self.params),
            "ema_params": self._tree(self.ema) if self.ema is not None else None,
            "occ_density": self.occ.density.cpu().numpy(),
            "occ_mean": float(self.occ.mean_density),
            "opt_state": {"count": self.count, "mu": self._tree(self.mu),
                          "nu": self._tree(self.nu)},
        }
        path = os.path.join(ckpt_dir, f"{name}.pkl")
        with open(path, "wb") as f:
            pickle.dump(payload, f)
        for old in sorted(glob.glob(os.path.join(ckpt_dir, "ngp_ep*.pkl")))[:-max_keep]:
            os.remove(old)
        return path

    def load_checkpoint(self, path_or_workspace: str) -> str:
        """load_checkpoint analog (utils.py:1076+): a file, or the latest
        checkpoint of a workspace, into the trainer's field (whose shapes
        it must have).  Reads only files this package wrote."""
        from flnerf_tpu_torch.core.convert import occupancy_from_numpy

        path = path_or_workspace
        if os.path.isdir(path_or_workspace):
            ckpts = sorted(glob.glob(os.path.join(path_or_workspace, "checkpoints",
                                                  "ngp_ep*.pkl")))
            if not ckpts:
                raise FileNotFoundError(path_or_workspace)
            path = ckpts[-1]
        with open(path, "rb") as f:
            d = pickle.load(f)
        if d.get("format") != CKPT_FORMAT:
            raise ValueError(f"{path} is not a {CKPT_FORMAT} checkpoint")
        with torch.no_grad():
            for p, v in zip(self.params, self._tensors(d["params"])):
                if p.shape != v.shape:
                    raise ValueError(f"{path}: a parameter of shape {tuple(v.shape)} "
                                     f"for the field's {tuple(p.shape)}")
                p.copy_(v)
        if d["ema_params"] is not None and self.ema is not None:
            self.ema = self._tensors(d["ema_params"])
        self.mu = self._tensors(d["opt_state"]["mu"])
        self.nu = self._tensors(d["opt_state"]["nu"])
        self.count = int(d["opt_state"]["count"])
        self.step = int(d["step"])
        self.occ = occupancy_from_numpy(d["occ_density"], d["occ_mean"], self.rcfg, self.device)
        return path

    @contextlib.contextmanager
    def ema_weights(self, use_ema: bool = True):
        """Within the block the field holds the EMA weights (when the
        trainer keeps them and ``use_ema``); the live weights are restored
        exactly after it (the reference's ema.store/copy_to/restore)."""
        if not (use_ema and self.ema is not None):
            yield
            return
        saved = [p.detach().clone() for p in self.params]
        with torch.no_grad():
            for p, e in zip(self.params, self.ema):
                p.copy_(e)
        try:
            yield
        finally:
            with torch.no_grad():
                for p, s in zip(self.params, saved):
                    p.copy_(s)

    def eval_images(self, poses, images, H, W, K, chunk: int = 8192,
                    use_ema: bool = False, times=None):
        """Mean PSNR and SSIM over the given views (metrics on the host);
        ``times`` renders view i at times[i] (a time-dependent field)."""
        with self.ema_weights(use_ema):
            psnrs, ssims = [], []
            for i in range(poses.shape[0]):
                rgb, _ = ngp_render_image(self.field, self.occ, self.rcfg, H, W, K,
                                          poses[i][:3, :4], chunk=chunk,
                                          time=None if times is None else float(times[i]),
                                          bg_fn=self.bg_fn)
                gt = np.asarray(images[i], np.float32)
                if gt.shape[-1] == 4:
                    # RGBA gt on the eval bg color (utils.py:471)
                    gt = gt[..., :3] * gt[..., 3:] + self.rcfg.bg_color * (1.0 - gt[..., 3:])
                mse = float(np.mean((rgb - gt) ** 2))
                psnrs.append(float(mse2psnr(mse)))
                ssims.append(float(compute_ssim(torch.from_numpy(gt), torch.from_numpy(rgb))))
        return float(np.mean(psnrs)), float(np.mean(ssims))

"""Plenoxels training loop (plenoxels-ours/opt/opt.py).

Port of ``flnerf_tpu/train/plenoxels_trainer.py`` for one device.  Per
epoch the quadtree budgeter's rays cross to the device once; per batch the
step renders through ``ops/voxel_kernel.voxel_render_rays_fast`` (the CUDA
kernels on the card, the plain version on the CPU), takes the masked MSE
with ``denom = max(sum(mask), 1) * 3`` plus dense TV (or the random-slab
estimator when ``tv_sparsity < 1``), and applies RMSProp to density and SH
as in-place tensor math (optim_kernel.cu:28 analog).  On CUDA the dense TV
of density and SH and their RMSProp run instead as one hand-written pass
each (``ops/tv_rmsprop.py``): the TV gradient as a stencil, added to the data
gradient, and RMSProp in the same sweep, which writes the new parameters into
a second buffer that the state then swaps to (``fused_sweep``; the buffer it
replaces is the next step's).  The rule is the trainer's device alone; on
the CPU the autograd ``tv_loss`` and ``_rmsprop`` stay.  The random-slab TV
(``tv_sparsity < 1``) and the lumisphere TV stay in autograd and join the
gradient before the sweep, which runs with the dense TV's weight 0 where the
slab estimator replaces it; the MSI background and a learned basis keep
their own ``_rmsprop``.  The per-leaf error
statistic accumulates on the device with ``index_add_`` and crosses to the
host once per epoch, together with the epoch MSE.  Steps that hold only
padding are skipped on the host: they would be no-ops.

One CUDA graph a chunk.  On the card a chunk of ``steps_per_chunk`` live
steps of the plain configuration (``graph_rule``: the kernel path with the
dense TV in the sweep, no MSI background, no learned basis, no lumisphere
TV, one rank) runs as the replay of a graph that captured the same steps:
the host issues one launch where Python and autograd issued ~60 a step,
and the step runs at the device's pace.  The first such chunk runs step by
step as the warm-up, then the chunk is captured; capture runs nothing, so
the host state is put back and each replay advances it.  The epoch's rays
are padded in page-locked memory and each chunk crosses without a sync
(into the graph's fixed input buffers when it replays), the per-leaf error
sums stay in fixed buffers, and a replayed step reads its learning rates
from a device table of ``expon_lr``'s float32 values (``lr_rows``), so a
replay gives the step-by-step result up to K2's atomic-order noise.  Every
other chunk runs step by step.

The path.  On CUDA the trainer takes the kernel path, as the reference's
``use_kernel=True`` does: the kernels, and the epoch's rays in morton order
by (image, pixel) with their 64-ray blocks shuffled by ``default_rng(seed)``,
so that the rays of one block march through neighbouring cells and share the
L2 cache (on one H100 this order cut K1 and K2 by 10-13% at 48x48 views and
by about half at 800x800: ``chip_smoke.py``).  It takes the plain path, the
reference's ``use_kernel=False`` (``voxel_render_rays``, rays in the
budgeter's order), on the CPU, and on CUDA for the configurations no
kernel computes: a learned basis (``basis_type != 'sh'``) and a backend
other than cuvol.  The lumisphere TV stays on the kernel path: it reads
``grid.sh`` and the closed-form SH basis, not the render, and is added to
the regularizers after it.  (The reference also refuses its kernel for the
lumisphere TV, plenoxels_trainer.py:146-158, because its TPU kernel's table
packs the closed-form SH; K1/K2 read ``grid.sh`` directly.)
``kernel_path`` makes the choice from the configuration alone, and the
trainer keeps it in ``self.use_kernel`` and writes it in each history
entry.  The
reference's re-forming and dropping of blocks that overflow the TPU kernel's
box is not ported: every ray reaches the loss.

The MSI background (``background_nlayers > 0``) trains on both paths, with
its own RMSProp state, lr schedules (``lr_sigma_bg``, ``lr_color_bg``) and
TV, and with the cells ``sparsify_bg`` empties pinned.  On the kernel path
the background is composed on K1's output from its final log-T (channel 4),
as the reference composes it (plenoxels_trainer.py:209-224); the gradient
into the log-T reaches density and SH through K2.  A learned basis trains
with its RMSProp state and ``lr_basis`` schedule.  The lumisphere TV draws
its direction and slabs from a numpy generator seeded with [seed, 2], or
from ``lumisphere_draws(step)`` when set (a test feeds the reference's key
chain through it).

Data parallelism (the reference's ``shard_map`` kernel branch,
plenoxels_trainer.py:184-262): with ``group`` of W > 1 ranks and
``batch_size % (RB * W) == 0`` each rank renders its contiguous slice of the
(coherence-ordered) batch, the squared-error sum and the data term's
gradients (already divided by the whole batch's ray count, which every rank
knows) are summed by one all-reduce, and TV and RMSProp are applied after
it, once, identically on every rank; the per-ray errors are gathered for the
budgeter.  Otherwise every rank runs the whole batch.  The grids stay
replicated, so W ranks all-reduce the whole SH gradient every step (1.8 GB
at 256^3), as the reference's ``psum`` does.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from flnerf_tpu_torch.core.device import resolve_device
from flnerf_tpu_torch.core.logging_utils import RECORDER
from flnerf_tpu_torch.core.metrics import compute_ssim, mse2psnr
from flnerf_tpu_torch.models.voxel_sh import (
    LumisphereDraws,
    VoxelGrid,
    VoxelGridConfig,
    basis_from_leaves,
    basis_leaves,
    draw_lumisphere,
    init_voxel_grid,
    prune_grid,
    sparsify_background,
    tv_loss,
    tv_loss_background,
    tv_loss_lumisphere,
    tv_loss_slab,
    upsample_grid,
    voxel_render_rays,
)
from flnerf_tpu_torch.ops import tv_rmsprop as sweep_ops
from flnerf_tpu_torch.ops import voxel_kernel
from flnerf_tpu_torch.ops.tv_rmsprop import EPS, live_pairs, tv_rmsprop
from flnerf_tpu_torch.ops.voxel_kernel import morton_order, voxel_render_rays_fast
from flnerf_tpu_torch.parallel import mesh
from flnerf_tpu_torch.rays.camera import get_rays
from flnerf_tpu_torch.rays.quadtree import RayBudgeter, RayEpoch

ORDER_BLOCK = 64   # rays per shuffled block of the kernel path's ray order
RB = 64            # rays per block of the reference's kernel (ops/voxel_pallas.py RB)
# the kernel launch counters a graph replay adds for the launches it captured
LAUNCH_COUNTERS = ((voxel_kernel, "FWD_LAUNCHES"), (voxel_kernel, "BWD_LAUNCHES"),
                   (sweep_ops, "SWEEP_LAUNCHES"), (sweep_ops, "PAIRS_LAUNCHES"))


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


def lr_rows(cfg: "PlenoxelsTrainConfig", extra: int) -> torch.Tensor:
    """[T + extra, 2] float32 (CPU): ``expon_lr``'s density and SH rates
    of steps 0 .. T + extra - 1, T = max(lr_decay_steps,
    lr_sigma_delay_steps, 1); from step T on both rates are constant, so
    row min(step, T) + k holds step + k's rates for k < extra.  One call
    over all the steps, which gives each step's float32 value as the call
    for that step alone gives it."""
    steps = torch.arange(max(cfg.lr_decay_steps, cfg.lr_sigma_delay_steps, 1) + extra)
    density = expon_lr(steps, cfg.lr_sigma, cfg.lr_sigma_final, cfg.lr_sigma_delay_steps,
                       cfg.lr_sigma_delay_mult, cfg.lr_decay_steps)
    sh = expon_lr(steps, cfg.lr_sh, cfg.lr_sh_final, 0, 1.0, cfg.lr_decay_steps)
    return torch.stack([density, sh], 1)


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
    # lumisphere TV (loss_kernel.cu:336): spatial TV of the view-dependent
    # radiance at a random per-step direction; plain path only
    lambda_tv_lumisphere: float = 0.0
    tv_lumisphere_dir_factor: float = 0.0
    # MSI background optimization (opt.py:499-500 optim_background_step,
    # argument_parser.py:95-109 lr schedule, 208-211 TV weights); active
    # whenever the grid carries a background (background_nlayers > 0)
    lr_sigma_bg: float = 3e0
    lr_sigma_bg_final: float = 3e-3
    lr_color_bg: float = 1e-1
    lr_color_bg_final: float = 5e-6
    lambda_tv_background_sigma: float = 1e-2
    lambda_tv_background_color: float = 1e-2
    background_density_thresh: float = 1.0  # sparsify_background threshold
    # learned-basis optimization (svox2.py:2091 optim_basis_step,
    # argument_parser.py:113-124 --lr_basis); active with a learned basis
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
    # kept so configs carry across; the port takes its path, and its ray
    # order, from the device and the configuration (see kernel_path)
    use_kernel: bool = False


class PlenoxelsState(NamedTuple):
    grid: VoxelGrid
    rms_density: torch.Tensor
    rms_sh: torch.Tensor
    step: int
    # MSI background optimizer state (svox2.py:2048 background_rms) and the
    # [2R, R] mask of cells sparsify_bg kept (background_links >= 0)
    rms_bg: Optional[torch.Tensor] = None
    bg_alive: Optional[torch.Tensor] = None
    rms_basis: Optional[Any] = None   # svox2.py:2091 basis_rms, like the basis


def kernel_path(grid_cfg: VoxelGridConfig, device) -> bool:
    """Whether a grid on ``device`` renders on the kernel path: on CUDA,
    unless no kernel computes the configuration's render (a learned basis,
    a non-cuvol backend).  No training option enters the rule: every
    regularizer, the lumisphere TV included, runs beside the kernels."""
    return (torch.device(device).type == "cuda" and grid_cfg.basis_type == "sh"
            and grid_cfg.backend == "cuvol")


def graph_rule(device, use_kernel: bool, sweep_tv: bool, background: bool,
               learned_basis: bool, lambda_tv_lumisphere: float, world: int,
               live: Sequence[bool]) -> bool:
    """Whether a chunk of steps runs as one CUDA graph's replay: on CUDA, on
    the kernel path, with the dense TV in the sweep (``sweep_tv``), no MSI
    background, no learned basis, no lumisphere TV, one rank, and every
    step of the chunk live (``live``: a bool a step).  The options left out
    draw host randomness a step or reduce across ranks, and a dead step is
    skipped on the host: such chunks run step by step."""
    return (torch.device(device).type == "cuda" and use_kernel and sweep_tv
            and not background and not learned_basis and lambda_tv_lumisphere == 0.0
            and world == 1 and len(live) > 0 and all(live))


class _ChunkGraph(NamedTuple):
    """A captured chunk: its graph, the [K, 2] (mse, ray count) each step
    writes, the (density, SH, spare density, spare SH) buffers the chunk
    leaves the grid in, the counters a replay adds, and the tensors the
    graph reads and writes, held so that their memory stays theirs."""

    graph: Any
    out: torch.Tensor
    end: tuple
    launches: tuple
    counters: dict
    holds: tuple


def render_grid_image(grid: VoxelGrid, grid_cfg: VoxelGridConfig, H, W, K, c2w,
                      chunk: int = 4096) -> np.ndarray:
    """Render one [H, W, 3] image (numpy) of ``grid`` on its device through
    the path ``kernel_path`` picks (K1 on the card for SH cuvol, with the
    MSI background composed on its final log-T), ``chunk`` rays at a time in
    raster order (on one H100 a morton order changed K1 by 1% on a 48x48
    view: ``chip_smoke.py``).  It needs no trainer, so a loaded grid renders
    without optimizer state."""
    device = grid.density.device
    render = voxel_render_rays_fast if kernel_path(grid_cfg, device) else voxel_render_rays
    rays_o, rays_d = get_rays(H, W, K, c2w, device)
    ro = rays_o.reshape(-1, 3)
    rd = rays_d.reshape(-1, 3)
    with torch.no_grad():
        rgb = torch.cat([render(grid, ro[i:i + chunk], rd[i:i + chunk], grid_cfg)["rgb"]
                         for i in range(0, ro.shape[0], chunk)], 0)
    return rgb.cpu().numpy().reshape(H, W, 3)


@RECORDER.spanned("flnerf.budget.coherence_order")
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
    """``group``: the process group the batch is sharded over (None: the
    default group when one is initialised, else one rank).
    ``lumisphere_draws``: None, or a callable step -> ``LumisphereDraws``
    that replaces the trainer's own draws of the lumisphere TV."""

    def __init__(self, grid_cfg: VoxelGridConfig,
                 train_cfg: PlenoxelsTrainConfig, device="cuda", group=None):
        self.device = resolve_device(device)
        # the kernel path also marches rays in coherence order
        self.use_kernel = kernel_path(grid_cfg, self.device)
        # density's and SH's dense TV and RMSProp through ops/tv_rmsprop;
        # _sweep_tv: the sweep, not autograd, takes the dense TV
        self.fused_sweep = self.device.type == "cuda"
        self._sweep_tv = self.fused_sweep and train_cfg.tv_sparsity >= 1.0
        # the sweep's second buffer of each field, and the live_pairs of the
        # alive mask they were computed from (a new mask recomputes them)
        self._spare = {}
        self._pairs = (None, None)
        # the chunks graph_rule admits replay one CUDA graph each (_replay);
        # the epoch's per-leaf error sums, kept for the graphs to write
        self._graphs = {}
        self._graph_io = None
        self._err = None
        self.gcfg = grid_cfg
        self.cfg = train_cfg
        self.group = group
        self.world, self.rank = mesh.world(group), mesh.rank(group)
        self.shard_kernel = (self.world > 1
                             and train_cfg.batch_size % (RB * self.world) == 0)
        grid = init_voxel_grid(grid_cfg, self.device)
        bg = grid.background
        self.state = PlenoxelsState(
            grid, torch.zeros_like(grid.density), torch.zeros_like(grid.sh), 0,
            rms_bg=None if bg is None else torch.zeros_like(bg),
            bg_alive=(None if bg is None else
                      torch.ones(bg.shape[:2], dtype=torch.bool, device=self.device)),
            rms_basis=basis_from_leaves(
                grid.basis, [torch.zeros_like(t) for t in basis_leaves(grid.basis)]))
        self._tv_rng = np.random.default_rng([train_cfg.seed, 1])
        self._lumi_rng = np.random.default_rng([train_cfg.seed, 2])
        self._order_rng = np.random.default_rng(train_cfg.seed)
        self.lumisphere_draws: Optional[Callable[[int], LumisphereDraws]] = None
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

    def _lumisphere_tv(self, grid: VoxelGrid) -> torch.Tensor:
        """The lumisphere TV term on a slab of min(tv_sparsity, 1/4) of the
        z planes (at least 4), as the reference sizes it."""
        z = grid.sh.shape[2]
        slab = max(4, int(round(z * min(self.cfg.tv_sparsity, 0.25))))
        draws = (self.lumisphere_draws(self.state.step) if self.lumisphere_draws
                 else draw_lumisphere(self._lumi_rng, z, slab, self.device))
        return tv_loss_lumisphere(grid, self.gcfg, draws, slab,
                                  self.cfg.tv_lumisphere_dir_factor)

    def render_rgb(self, grid: VoxelGrid, rays_o: torch.Tensor,
                   rays_d: torch.Tensor) -> torch.Tensor:
        """[N, 3] colour of the trainer's path: K1 (its rgb with the MSI
        background composed on its final log-T) on the kernel path, the
        plain ``voxel_render_rays`` otherwise."""
        render = voxel_render_rays_fast if self.use_kernel else voxel_render_rays
        return render(grid, rays_o, rays_d, self.gcfg)["rgb"]

    def _rmsprop(self, param, rms, g, lr) -> None:
        """Fused RMSProp (optim_kernel.cu:28 rmsprop_step), in place; ``lr``
        a float or a tensor that broadcasts against ``param``."""
        b = self.cfg.rms_beta
        rms.mul_(b).addcmul_(g, g, value=1 - b)
        if isinstance(lr, float):
            param.addcdiv_(g, rms.sqrt().add_(EPS), value=-lr)
        else:
            param.sub_(lr * g / (rms.sqrt() + EPS))

    def _swept(self, name: str, param, rms, grad, pairs, lam: float, lr: float):
        """``param`` after one ``tv_rmsprop`` sweep (TV weight ``lam``),
        written into the spare buffer of ``name``; ``param`` becomes that
        buffer for the next step."""
        out = self._spare.get(name)
        if out is None or out.shape != param.shape:
            out = torch.empty_like(param)
        tv_rmsprop(param, grad.contiguous(), rms, pairs, lam, lr, self.cfg.rms_beta, out=out)
        self._spare[name] = param
        return out

    def _live_pairs(self, alive):
        """``live_pairs(alive)``, computed once for each alive mask (a new
        mask drops the chunk graphs, which read the old one's)."""
        if self._pairs[0] is not alive:
            self._graphs.clear()
            self._pairs = (alive, live_pairs(alive))
        return self._pairs[1]

    @RECORDER.spanned("flnerf.train.step")
    def _step(self, origins, dirs, rgb, leaf, mask, err_sum, err_cnt, lrs=None):
        """One RMSProp step on a batch; returns (mse, ray count) tensors.
        ``lrs``: None (the rates from ``expon_lr`` on the host), or a [2]
        float32 device tensor of the density and SH rates, which the sweep
        reads when it runs (a captured step)."""
        grads, mse, count, per_ray_err = self._grads(origins, dirs, rgb, mask)
        cfg, st = self.cfg, self.state
        step = st.step
        grid = st.grid

        def lr_of(init, final, delay=0, mult=1.0):
            return float(expon_lr(step, init, final, delay, mult, cfg.lr_decay_steps))

        with RECORDER.span("flnerf.train.optimizer"):
            g_density, g_sh = grads[0], grads[1]
            if lrs is None:
                lr_density = lr_of(cfg.lr_sigma, cfg.lr_sigma_final, cfg.lr_sigma_delay_steps,
                                   cfg.lr_sigma_delay_mult)
                lr_sh = lr_of(cfg.lr_sh, cfg.lr_sh_final)
            else:
                lr_density, lr_sh = lrs[0], lrs[1]
            if self.fused_sweep:
                # the dense TV joins here; the slab estimator's is in grads
                dense = self._sweep_tv
                pairs = self._live_pairs(grid.alive) if dense else None
                grid = grid._replace(
                    density=self._swept("density", grid.density, st.rms_density, g_density,
                                        pairs, cfg.lambda_tv if dense else 0.0, lr_density),
                    sh=self._swept("sh", grid.sh, st.rms_sh, g_sh, pairs,
                                   cfg.lambda_tv_sh if dense else 0.0, lr_sh))
                RECORDER.count("flnerf.train.fused_sweeps", 2)
            else:
                self._rmsprop(grid.density, st.rms_density, g_density, lr_density)
                self._rmsprop(grid.sh, st.rms_sh, g_sh, lr_sh)
            i = 2
            if st.grid.background is not None:
                # optim_background_step (svox2.py:2048): lr_color_bg on the rgb
                # channels and lr_sigma_bg on sigma; pinned cells never move
                g_bg = torch.where(st.bg_alive[:, :, None, None], grads[i], 0.0)
                i += 1
                c = lr_of(cfg.lr_color_bg, cfg.lr_color_bg_final)
                lr_bg = torch.tensor([c, c, c, lr_of(cfg.lr_sigma_bg, cfg.lr_sigma_bg_final)],
                                     device=self.device)
                self._rmsprop(st.grid.background, st.rms_bg, g_bg, lr_bg)
            # optim_basis_step (svox2.py:2091): RMSProp over the learned basis
            if st.grid.basis is not None:
                lr_b = lr_of(cfg.lr_basis, cfg.lr_basis_final)
                for p, r, g in zip(basis_leaves(st.grid.basis), basis_leaves(st.rms_basis),
                                   grads[i:]):
                    self._rmsprop(p, r, g, lr_b)

        live = mask > 0
        safe_leaf = torch.where(live, leaf, err_sum.shape[0] - 1)
        err_sum.index_add_(0, safe_leaf, torch.where(live, per_ray_err, 0.0))
        err_cnt.index_add_(0, safe_leaf, mask)
        self.state = st._replace(grid=grid, step=st.step + 1)
        return mse, count

    def _grads(self, origins, dirs, rgb, mask):
        """(gradients of density, SH[, background][, basis leaves], mse, ray
        count, per-ray |error|) of the masked MSE plus the regularizers on
        the batch.  Sharded, this rank renders its slice; the squared-error
        sum and the data term's gradients are summed over the ranks and the
        regularizers' gradients are added after the sum, once
        (plenoxels_trainer.py:184-262).  Every rank holds the whole mask, so
        the ray count needs no reduce."""
        cfg, st = self.cfg, self.state
        rows = (mesh.step_rows(origins.shape[0], self.world, self.rank)
                if self.shard_kernel else None)
        m = mask
        if rows is not None:
            origins, dirs, rgb, m = origins[rows], dirs[rows], rgb[rows], mask[rows]
        g0 = st.grid
        with RECORDER.span("flnerf.train.forward"):
            leaves = [t.detach().requires_grad_(True)
                      for t in [g0.density, g0.sh]
                      + ([] if g0.background is None else [g0.background])
                      + basis_leaves(g0.basis)]
            density, sh = leaves[0], leaves[1]
            bgv = leaves[2] if g0.background is not None else None
            grid = VoxelGrid(density, sh, g0.alive,
                             None if bgv is None else torch.where(
                                 st.bg_alive[:, :, None, None], bgv, 0.0),
                             basis_from_leaves(g0.basis, leaves[2 + (bgv is not None):]))
            rgb_out = self.render_rgb(grid, origins, dirs)
            count = torch.sum(mask)
            denom = torch.clamp(count, min=1.0) * 3.0
            sq = torch.sum(m[:, None] * (rgb_out - rgb) ** 2)
            # the sweep (_sweep_tv) computes the dense TV's gradient itself
            terms = ([] if self._sweep_tv else
                     [cfg.lambda_tv * self._grid_tv(density),
                      cfg.lambda_tv_sh * self._grid_tv(sh)])
            if cfg.lambda_tv_lumisphere > 0.0:
                terms.append(cfg.lambda_tv_lumisphere * self._lumisphere_tv(grid))
            if bgv is not None:
                terms.append(tv_loss_background(bgv, cfg.lambda_tv_background_color,
                                                cfg.lambda_tv_background_sigma))
        # the backward pass, the sharded data term's all-reduce included
        with RECORDER.span("flnerf.train.backward"):
            grads = [torch.zeros_like(t) if g is None else g
                     for g, t in zip(torch.autograd.grad(sq / denom, leaves, allow_unused=True),
                                     leaves)]
            sq = sq.detach().reshape(1)
            per_ray_err = torch.amax(torch.abs(rgb_out.detach() - rgb), -1)
            if rows is not None:
                mesh.all_reduce_([sq] + grads, group=self.group)
                per_ray_err = mesh.gather_rows(per_ray_err, self.rank, self.world, self.group)
            if terms:
                reg_grads = torch.autograd.grad(sum(terms[1:], terms[0]), leaves,
                                                allow_unused=True)
                grads = [g if r is None else g.add_(r) for g, r in zip(grads, reg_grads)]
        return grads, sq[0] / denom, count, per_ray_err

    def run_epoch_rays(self, epoch: RayEpoch):
        """Train on one epoch's rays; returns (per-leaf mean |error| [M],
        ray-weighted MSE over the last chunk)."""
        cfg = self.cfg
        # the rng persists, so the block order differs across epochs
        order = (coherence_order(epoch.px, epoch.py, epoch.img, self._order_rng)
                 if self.use_kernel and epoch.px is not None else None)
        B, K = cfg.batch_size, cfg.steps_per_chunk
        n = epoch.origins.shape[0]
        n_pad = mesh.pad_to_multiple(max(n, 1), B * K)
        dev = self.device
        # on the card the epoch is padded in page-locked memory, and each
        # chunk crosses without holding the host
        pinned = dev.type == "cuda"

        def pad(a, fill=0.0):
            t = torch.empty((n_pad,) + a.shape[1:], pin_memory=pinned,
                            dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype)
            out = t.numpy()
            out[n:] = fill
            if order is None:
                out[:n] = a
            else:   # a gather straight into the page-locked rows (a third of a[order]'s time)
                np.take(a, order, axis=0, out=out[:n])
            return t

        with RECORDER.span("flnerf.io.upload"):
            mask = np.zeros(n_pad, np.float32)
            mask[:n] = 1.0
            rays = (pad(epoch.origins), pad(epoch.dirs, np.array([0, 0, -1.0], np.float32)),
                    pad(epoch.rgb), pad(epoch.leaf_id.astype(np.int64)),
                    torch.from_numpy(mask).pin_memory() if pinned else torch.from_numpy(mask))

        err_sum, err_cnt = self._err_bufs(_leaf_buf_size(epoch.n_leaves))
        zero = None
        n_chunks = n_pad // (B * K)
        last = []
        steps = 0
        for ci in range(n_chunks):
            live = [bool(mask[(ci * K + k) * B:(ci * K + k + 1) * B].any()) for k in range(K)]
            rows = slice(ci * K * B, (ci + 1) * K * B)
            graphed = self._graphs_chunk(live)
            g = self._graphs.get(self._graph_key()) if graphed and self._graphs else None
            if g is not None:
                last = self._replay(g, [t[rows] for t in rays])
                steps += K
                continue
            chunk = [t[rows].to(dev, non_blocking=pinned) for t in rays]
            last = []
            # the first chunk a graph would take runs here as its warm-up,
            # on the stream its capture then uses
            with self._warm_up() if graphed else contextlib.nullcontext():
                for k in range(K):
                    sl = slice(k * B, (k + 1) * B)
                    if live[k]:
                        last.append(self._step(*(t[sl] for t in chunk), err_sum, err_cnt))
                        steps += 1
                    else:
                        zero = torch.zeros((), device=dev) if zero is None else zero
                        last.append((zero, zero))
            if graphed:
                self._capture()
        RECORDER.count("flnerf.train.steps", steps)
        RECORDER.count("flnerf.train.rays", n)
        # one device -> host transfer per epoch
        m = epoch.n_leaves
        with RECORDER.span("flnerf.io.drain"):
            pairs = (last.reshape(-1) if isinstance(last, torch.Tensor)
                     else torch.stack([t for pair in last for t in pair]))
            host = torch.cat([err_sum[:m], err_cnt[:m], pairs]).cpu().numpy()
        s, c = host[:m], host[m:2 * m]
        stat = s / np.maximum(c, 1.0)
        stat[c == 0] = -np.inf
        ms, cs = host[2 * m::2], host[2 * m + 1::2]
        epoch_mse = float((ms * cs).sum() / max(cs.sum(), 1.0))
        return stat, epoch_mse

    def _err_bufs(self, size: int) -> torch.Tensor:
        """[2, size]: the per-leaf error sum and count, zeroed; kept from
        call to call while the size holds, as a captured chunk writes them."""
        if self._err is None or self._err.shape[1] != size:
            self._err = torch.zeros((2, size), device=self.device)
        else:
            self._err.zero_()
        return self._err

    # -- one CUDA graph a chunk ---------------------------------------------
    # A chunk that graph_rule admits runs as the replay of a graph that
    # captured the chunk's K steps: render, loss, K2 through autograd, the two
    # sweeps, the error statistic.  What capture needs: no sync in the step
    # (the grid's constants are cached on the device, models/voxel_sh.py
    # grid_constants), the rates on the device (copied from lr_rows' table
    # before each replay) and fixed buffers for the inputs and the error
    # sums.  The sweep swaps each field's two buffers every step, so a graph
    # holds for the buffers it started from: keyed on them and on everything
    # else it reads and writes, at most two graphs (one per buffer order,
    # sharing one memory pool) serve a grid.
    def _graphs_chunk(self, live) -> bool:
        st = self.state
        return graph_rule(self.device, self.use_kernel, self.fused_sweep and self._sweep_tv,
                          st.grid.background is not None, st.grid.basis is not None,
                          self.cfg.lambda_tv_lumisphere, self.world, live)

    def _graph_key(self):
        """(what both graphs of a grid read and write and the configuration
        they baked in, the grid's two buffer pairs in their order)."""
        st, io = self.state, self._graph_io
        ptrs = lambda ts: tuple(t.data_ptr() for t in ts)
        return ((ptrs((st.rms_density, st.rms_sh, st.grid.alive, self._pairs[1], self._err,
                       *io["ins"], io["lrs"])), self.gcfg, self.cfg),
                ptrs((st.grid.density, st.grid.sh, self._spare["density"], self._spare["sh"])))

    @contextlib.contextmanager
    def _warm_up(self):
        """The block on the capture's side stream, after the work queued so
        far; the current stream then waits for it.  The live pairs and the
        spare buffers are made first, on the current stream, so nothing the
        grid keeps is allocated on the side stream."""
        grid = self.state.grid
        self._live_pairs(grid.alive)
        for name, p in (("density", grid.density), ("sh", grid.sh)):
            if name not in self._spare or self._spare[name].shape != p.shape:
                self._spare[name] = torch.empty_like(p)
        io = self._graph_buffers()
        cur = torch.cuda.current_stream(self.device)
        io["stream"].wait_stream(cur)
        with torch.cuda.stream(io["stream"]):
            yield
        cur.wait_stream(io["stream"])

    def _graph_buffers(self) -> dict:
        """The graphs' fixed buffers, made once per trainer (again if the
        configuration changes): the chunk's 5 inputs, the [K, 2] rates of
        its steps and the [T + K, 2] table they are copied from, the side
        stream and the memory pool."""
        cfg, dev = self.cfg, self.device
        B, K = cfg.batch_size, cfg.steps_per_chunk
        io = self._graph_io
        if io is None or io["cfg"] != cfg:
            rows = lr_rows(cfg, K)
            io = {"cfg": cfg, "rows": rows.to(dev), "last_row": rows.shape[0] - K,
                  "lrs": torch.empty((K, 2), device=dev),
                  "ins": (torch.empty((B * K, 3), device=dev), torch.empty((B * K, 3), device=dev),
                          torch.empty((B * K, 3), device=dev),
                          torch.empty(B * K, dtype=torch.int64, device=dev),
                          torch.empty(B * K, device=dev)),
                  "stream": torch.cuda.Stream(dev),
                  "pool": torch.cuda.graph_pool_handle()}
            self._graphs.clear()
            self._graph_io = io
        return io

    def _capture(self) -> None:
        """Capture the next chunk from the trainer's state as it stands (the
        warm-up chunk has just run), unless a graph for it exists.  Capture
        runs nothing on the device, so the host state (step, buffers, launch
        counters, recorder) is put back as it was; a replay trains the chunk
        and advances them."""
        io = self._graph_buffers()
        key = self._graph_key()
        if key in self._graphs:
            return
        if len(self._graphs) >= 2 or any(k[0] != key[0] for k in self._graphs):
            self._graphs.clear()
        cfg, st, spare = self.cfg, self.state, dict(self._spare)
        B, K = cfg.batch_size, cfg.steps_per_chunk
        launches = tuple(getattr(mod, name) for mod, name in LAUNCH_COUNTERS)
        holds = (st.grid.density, st.grid.sh, spare["density"], spare["sh"], st.rms_density,
                 st.rms_sh, st.grid.alive, self._pairs[1], self._err)
        out = torch.zeros((K, 2), device=self.device)
        graph = torch.cuda.CUDAGraph()
        try:
            with RECORDER.detached() as counters:
                with torch.cuda.graph(graph, pool=io["pool"], stream=io["stream"]):
                    for k in range(K):
                        sl = slice(k * B, (k + 1) * B)
                        mse, count = self._step(*(t[sl] for t in io["ins"]), *self._err,
                                                lrs=io["lrs"][k])
                        out[k, 0].copy_(mse)
                        out[k, 1].copy_(count)
            end = (self.state.grid.density, self.state.grid.sh, self._spare["density"],
                   self._spare["sh"])
            ran = tuple(getattr(mod, name) - n for (mod, name), n in zip(LAUNCH_COUNTERS, launches))
        finally:
            self.state, self._spare = st, spare
            for (mod, name), n in zip(LAUNCH_COUNTERS, launches):
                setattr(mod, name, n)
        self._graphs[key] = _ChunkGraph(graph, out, end, ran, counters, holds)

    def _replay(self, g: _ChunkGraph, chunk):
        """Train a chunk by graph ``g``: its rows (``chunk``, in page-locked
        host memory) and the steps' rates into the graph's buffers (copies
        that hold no one), one replay, then the host state the captured
        steps left; returns the steps' [K, 2] (mse, ray count)."""
        io, st = self._graph_io, self.state
        K = self.cfg.steps_per_chunk
        for dst, src in zip(io["ins"], chunk):
            dst.copy_(src, non_blocking=True)
        row = min(st.step, io["last_row"])
        io["lrs"].copy_(io["rows"][row:row + K], non_blocking=True)
        with RECORDER.span("flnerf.train.graph_replay"):
            g.graph.replay()
        for (mod, name), n in zip(LAUNCH_COUNTERS, g.launches):
            setattr(mod, name, getattr(mod, name) + n)
        for name, n in g.counters.items():
            RECORDER.count(name, n)
        RECORDER.count("flnerf.train.graph_steps", K)
        density, sh, spare_density, spare_sh = g.end
        self._spare = {"density": spare_density, "sh": spare_sh}
        self.state = st._replace(grid=st.grid._replace(density=density, sh=sh), step=st.step + K)
        return g.out

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
                # sparsify the MSI background before resampling, like
                # opt.py:593-594 (early upsample boundaries only)
                if (self.state.grid.background is not None
                        and epoch_id <= min(cfg.upsample_epochs)):
                    n_dead = self.sparsify_bg()
                    if verbose:
                        print(f"  sparsified background: {n_dead} cells off")
                new_reso = tuple(r * 2 for r in self.gcfg.reso)
                self.resample(new_reso)
                if verbose:
                    print(f"  upsampled grid -> {new_reso}")

            psnr = float(mse2psnr(mse))
            # epoch_s: this epoch's ray generation, steps, subdivision and
            # resampling, ended by the epoch's one host sync; no callback.
            # path: "kernel" or "plain" (kernel_path)
            self.history.append(
                {"epoch": epoch_id, "wall_s": time.time() - t0, "train_psnr": psnr,
                 "rays": int(epoch.origins.shape[0]), "steps": self.state.step,
                 "epoch_s": time.time() - te,
                 "path": "kernel" if self.use_kernel else "plain"}
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
        """Upsample + prune between epochs; the density and SH RMSProp state
        restarts, the background's and the basis' carry over."""
        grid = upsample_grid(self.state.grid, new_reso)
        if prune:
            grid = prune_grid(grid, self.cfg.prune_sigma_thresh)
        self.gcfg = self.gcfg._replace(reso=new_reso)
        self._spare.clear()
        self._pairs = (None, None)
        self._graphs.clear()
        self.state = self.state._replace(grid=grid, rms_density=torch.zeros_like(grid.density),
                                         rms_sh=torch.zeros_like(grid.sh))

    def sparsify_bg(self) -> int:
        """svox2.py:1431 sparsify_background at the trainer level: empties
        the background cells below ``background_density_thresh`` in every
        layer (after dilation) and pins them through ``bg_alive``.  Returns
        the number of [2R, R] cells off."""
        st = self.state
        if st.grid.background is None:
            return 0
        bg, keep = sparsify_background(st.grid.background, self.cfg.background_density_thresh)
        keep = keep & st.bg_alive
        bg = torch.where(keep[:, :, None, None], bg, 0.0)
        self.state = st._replace(grid=st.grid._replace(background=bg), bg_alive=keep)
        return int((~keep).sum())

    def render_image(self, H, W, K, c2w, chunk: int = 4096) -> np.ndarray:
        """``render_grid_image`` of the trainer's grid."""
        return render_grid_image(self.state.grid, self.gcfg, H, W, K, c2w, chunk)

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

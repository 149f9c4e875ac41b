"""TensoRF training CLI (ngp-ours/main_tensoRF.py analog).

Port of ``flnerf_tpu/cli/main_tensorf.py``: main_nerf's flags plus the
TensoRF knobs: VM or CP decomposition (``--cp``, main_tensoRF.py:33), the
upsample schedule (``--resolution0``/``--resolution1``,
``--upsample_model_steps``) and the L1 sparsity weight (tensoRF/utils.py:46;
parsed and never read, as in the reference: ROADMAP.md R5), plus
``--device`` (default ``cuda``; with no card it raises unless ``--device
cpu``).  The configs mirror the reference CLI's own, not main_nerf's: the
renderer takes n_candidates, n_keep, grid_size, bound and min_near (so
density_thresh, bg_color and dt_gamma keep their defaults), the trainer no
EMA and no prob map.

VM trains through the shrink and upsample schedule: log-spaced voxel counts
from resolution0^3 to resolution1^3; at each boundary the AABB shrinks to
the occupancy grid's occupied cells, the resolution adapts to the voxel
count over the new AABB, the factors are upsampled and the trainer takes
the new field (Adam reset, step and occupancy kept).  CP takes a plain fit.

Not ported yet: ``--gui`` (raises ``NotImplementedError``; ROADMAP.md M19).

Usage:
  python -m flnerf_tpu_torch.cli.main_tensorf data/nerf/lego -O --bound 1
  python -m flnerf_tpu_torch.cli.main_tensorf synthetic -O --iters 256
  python -m flnerf_tpu_torch.cli.main_tensorf synthetic -O --cp --iters 256
"""

from __future__ import annotations

import os
import time

import numpy as np

from flnerf_tpu_torch.cli.main_nerf import load_ngp_dataset, make_parser

GUI_BACKLOG = "--gui (the interactive viewer) is not ported yet; it is queued as M19 in ROADMAP.md"


def make_tensorf_parser():
    parser = make_parser()
    parser.add_argument("--cp", action="store_true",
                        help="CP decomposition instead of VM (network_cp.py)")
    parser.add_argument("--resolution0", type=int, default=128)
    parser.add_argument("--resolution1", type=int, default=300)
    parser.add_argument("--upsample_model_steps", type=int, nargs="*",
                        default=[2000, 3000, 4000, 5500, 7000])
    parser.add_argument("--l1_reg_weight", type=float, default=1e-4)
    return parser


def parse_o(parser, argv):
    """The parsed flags with -O expanded (fp16 -> bf16, cuda_ray, preload);
    ``--gui`` raises."""
    args = parser.parse_args(argv)
    if args.O:
        args.fp16 = True
        args.cuda_ray = True
        args.preload = True
    if args.gui:
        raise NotImplementedError(GUI_BACKLOG)
    return args


def render_train_configs(args):
    """The reference CLI's renderer and trainer configs (main_tensorf.py:
    68-75, main_ccnerf.py:95-98, :189-192)."""
    from flnerf_tpu_torch.render.ngp import NGPRenderConfig
    from flnerf_tpu_torch.train.ngp_trainer import NGPTrainConfig

    rcfg = NGPRenderConfig(n_candidates=args.n_candidates, n_keep=args.n_keep,
                           grid_size=args.grid_size, bound=args.bound, min_near=args.min_near)
    tcfg = NGPTrainConfig(max_steps=args.iters, batch_rays=args.num_rays, lr=args.lr,
                          steps_per_chunk=args.steps_per_chunk,
                          use_error_map=args.error_map, seed=args.seed)
    return rcfg, tcfg


def adaptive_resolution(cfg, bound: float, n_voxels: float):
    """Per-axis resolution giving ``n_voxels`` cubic voxels over the
    training AABB, at least 8 (tensoRF/utils.py:112-128)."""
    aabb = np.asarray(cfg.aabb if cfg.aabb is not None else (-bound,) * 3 + (bound,) * 3)
    vox = np.cbrt(np.prod(aabb[3:] - aabb[:3]) / n_voxels)
    return tuple(np.maximum(((aabb[3:] - aabb[:3]) / vox).astype(np.int64), 8))


def main(argv=None):
    import torch

    from flnerf_tpu_torch.core.device import resolve_device
    from flnerf_tpu_torch.models.tensorf import (
        TensoRFConfig,
        TensoRFField,
        shrink_tensorf,
        upsample_tensorf,
    )
    from flnerf_tpu_torch.models.tensorf_variants import CPConfig, CPField
    from flnerf_tpu_torch.train.ngp_trainer import NGPSampler, NGPTrainer

    args = parse_o(make_tensorf_parser(), argv)
    device = resolve_device(args.device)
    os.makedirs(args.workspace, exist_ok=True)
    images, poses, hwf, K, i_split = load_ngp_dataset(args)
    H, W, _ = hwf
    i_train, _, i_test = i_split

    compute_dtype = torch.bfloat16 if args.fp16 else torch.float32
    reso = (args.resolution0,) * 3
    gen = torch.Generator().manual_seed(args.seed)
    if args.cp:
        cfg = CPConfig(resolution=reso, bound=args.bound)
        field = CPField(cfg, compute_dtype, gen)
    else:
        cfg = TensoRFConfig(resolution=reso, bound=args.bound)
        field = TensoRFField(cfg, compute_dtype, gen)
    rcfg, tcfg = render_train_configs(args)
    trainer = NGPTrainer(field, rcfg, tcfg, device=device)

    segments = []
    if not args.test:
        sampler = NGPSampler(images[i_train], poses[i_train], K, tcfg, seed=args.seed)
        t0 = time.time()
        ups = [] if args.cp else sorted(
            s for s in (args.upsample_model_steps or []) if 0 < s < args.iters)
        # log-spaced voxel counts after each upsample (main_tensoRF.py:132)
        n_voxels = np.round(np.exp(np.linspace(np.log(args.resolution0 ** 3),
                                               np.log(args.resolution1 ** 3),
                                               len(ups) + 1)))[1:]
        done = 0
        for si, step in enumerate(ups + [args.iters]):
            t_seg = time.time()
            trainer.fit(sampler, n_steps=step - done)     # ends in a host sync
            segments.append({"steps": step - done, "wall_s": time.time() - t_seg})
            done = step
            if step >= args.iters:
                break
            field = shrink_tensorf(trainer.field, trainer.occ.density.cpu().numpy(),
                                   float(trainer.occ.mean_density), rcfg.bound,
                                   rcfg.density_thresh)
            field = upsample_tensorf(field, adaptive_resolution(field.cfg, args.bound,
                                                                n_voxels[si]))
            print(f"[INFO] step {step}: shrink+upsample -> reso {field.cfg.resolution} "
                  f"aabb {field.cfg.aabb}")
            trainer.replace_field(field)
        with open(os.path.join(args.workspace, "time_mins.txt"), "w") as f:
            f.write(f"{(time.time() - t0) / 60:.3f}\n")
        trainer.save_checkpoint(args.workspace)

    psnr, ssim = trainer.eval_images(poses[i_test], images[i_test], H, W, K,
                                     chunk=args.max_ray_batch)
    print(f"test PSNR {psnr:.3f} SSIM {ssim:.4f}")
    with open(os.path.join(args.workspace, "results.txt"), "w") as f:
        f.write(f"mean PSNR: {psnr}\nmean SSIM: {ssim}\n")
    return {"psnr": psnr, "ssim": ssim, "steps": trainer.step, "history": trainer.history,
            "segments": segments, "field_cfg": trainer.field.cfg}


if __name__ == "__main__":
    main()

"""Plenoxels training CLI (plenoxels-ours/opt/opt.py analog).

Port of ``flnerf_tpu/cli/opt.py``: the same flags and JSON config merge
(opt/argument_parser.py:5-229, config_util.py:132), plus ``--device``
(default ``cuda``; with no card it raises unless ``--device cpu``).  Flow:
dataset -> dense grid init -> quadtree budgeter -> epoch loop (tree rays ->
train steps -> subdivision -> ckpt{epoch:02d}.npz + treeDivide_{epoch:04d}.pkl
-> scheduled upsample) -> test-split eval, time_mins.txt and test_psnr.txt.

Usage:
  python -m flnerf_tpu_torch.cli.opt <datadir> -t ckpt_dir -c configs/syn.json
  python -m flnerf_tpu_torch.cli.opt synthetic -t DIR --reso "[[256,256,256]]"
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("data_dir", type=str)
    parser.add_argument("--config", "-c", type=str, default=None,
                        help="JSON config file (merged into the namespace)")
    parser.add_argument("--train_dir", "-t", type=str, default="ckpt")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda or cpu)")

    group = parser.add_argument_group("general")
    group.add_argument("--reso", type=str, default="[[128, 128, 128]]",
                       help="grid resolution schedule (JSON list of [x,y,z])")
    group.add_argument("--upsamp_every", type=int, default=3 * 12800)
    group.add_argument("--init_sigma", type=float, default=0.1)
    group.add_argument("--dataset_type", type=str, default="auto")
    group.add_argument("--scene_scale", type=float, default=None)
    group.add_argument("--basis_dim", type=int, default=9)
    group.add_argument("--background_brightness", type=float, default=1.0)
    group.add_argument("--step_size", type=float, default=0.5)
    group.add_argument("--sigma_thresh", type=float, default=1e-8)
    group.add_argument("--stop_thresh", type=float, default=1e-7)
    group.add_argument("--renderer_backend", "--backend", type=str,
                       default="cuvol", choices=("cuvol", "nvol", "svox1"),
                       help="RenderOptions.backend (svox2.py:17); only cuvol "
                            "is ported")
    group.add_argument("--background_nlayers", type=int, default=0,
                       help="MSI background layers (not ported: must be 0)")
    group.add_argument("--background_reso", type=int, default=512)

    group = parser.add_argument_group("optimization")
    group.add_argument("--n_iters", type=int, default=10 * 12800)
    group.add_argument("--n_epochs", type=int, default=8)
    group.add_argument("--batch_size", type=int, default=5000)
    group.add_argument("--lr_sigma", type=float, default=3e1)
    group.add_argument("--lr_sigma_final", type=float, default=5e-2)
    group.add_argument("--lr_sigma_delay_steps", type=int, default=15000)
    group.add_argument("--lr_sigma_delay_mult", type=float, default=1e-2)
    group.add_argument("--lr_sh", type=float, default=1e-2)
    group.add_argument("--lr_sh_final", type=float, default=5e-6)
    group.add_argument("--rms_beta", type=float, default=0.95)

    group = parser.add_argument_group("losses")
    group.add_argument("--lambda_tv", type=float, default=1e-5)
    group.add_argument("--lambda_tv_sh", type=float, default=1e-3)
    group.add_argument("--lr_sigma_bg", type=float, default=3e0)
    group.add_argument("--lr_sigma_bg_final", type=float, default=3e-3)
    group.add_argument("--lr_color_bg", type=float, default=1e-1)
    group.add_argument("--lr_color_bg_final", type=float, default=5e-6)
    group.add_argument("--lambda_tv_background_sigma", type=float,
                       default=1e-2)
    group.add_argument("--lambda_tv_background_color", type=float,
                       default=1e-2)
    group.add_argument("--background_density_thresh", type=float,
                       default=1.0)
    # autotune hygiene (argument_parser.py:168-171): tune_mode skips the
    # per-epoch checkpoints, tune_nosave also skips the final one
    group.add_argument("--tune_mode", action="store_true")
    group.add_argument("--tune_nosave", action="store_true")

    group = parser.add_argument_group("quadtree")
    group.add_argument("--init_level", type=int, default=2)
    group.add_argument("--subdivide_every", type=int, default=1)
    group.add_argument("--subdivide_thres", type=float, default=0.015)
    group.add_argument("--allPixel_every", type=int, default=0)
    group.add_argument("--randSamp_perc", type=float, default=1.0)
    group.add_argument("--rays_downscale", type=int, default=1)

    group = parser.add_argument_group("misc")
    group.add_argument("--steps_per_chunk", type=int, default=8)
    group.add_argument("--seed", type=int, default=0)
    group.add_argument("--eval_chunk", type=int, default=4096)

    args = parser.parse_args(argv)
    maybe_merge_config_file(args, parser)
    return args


def maybe_merge_config_file(args, parser) -> None:
    """JSON-config merge with validity check (config_util.py:132-143)."""
    if args.config is None:
        return
    with open(args.config, "r") as f:
        conf = json.load(f)
    known = {a.dest for a in parser._actions}
    invalid = set(conf.keys()) - known
    if invalid:
        raise ValueError(f"Invalid config keys: {invalid}")
    for k, v in conf.items():
        setattr(args, k, v)


def main(argv=None):
    from flnerf_tpu_torch.models.voxel_sh import LATER_SLICE, VoxelGridConfig, save_npz
    from flnerf_tpu_torch.rays.camera import get_rays_np, intrinsics_matrix
    from flnerf_tpu_torch.rays.quadtree import RayBudgeter
    from flnerf_tpu_torch.train.plenoxels_trainer import (
        PlenoxelsTrainConfig,
        PlenoxelsTrainer,
        resolve_device,
    )

    args = parse_arguments(argv)
    device = resolve_device(args.device)
    os.makedirs(args.train_dir, exist_ok=True)
    with open(os.path.join(args.train_dir, "args.json"), "w") as f:
        json.dump(vars(args), f, indent=2)

    # dataset dispatch (opt/util/dataset.py:7-28 auto-detect analog)
    dtype = args.dataset_type
    if dtype == "auto" and args.data_dir != "synthetic":
        if os.path.exists(os.path.join(args.data_dir, "transforms_train.json")):
            dtype = "nerf"
        elif os.path.exists(os.path.join(args.data_dir, "intrinsics.txt")):
            dtype = "nsvf"
        elif os.path.exists(os.path.join(args.data_dir, "poses_bounds.npy")):
            dtype = "llff"

    if args.data_dir == "synthetic":
        from flnerf_tpu_torch.data.synthetic import load_synthetic_data

        images, poses, _, hwf, i_split = load_synthetic_data(n_train=8, n_test=2, H=48, W=48)
        radius = (1.2, 1.2, 1.2)
    elif dtype == "nsvf":
        raise NotImplementedError(f"the NSVF loader {LATER_SLICE}")
    else:
        from flnerf_tpu_torch.data.blender import composite_white_bkgd, load_blender_data

        images, poses, _, hwf, i_split = load_blender_data(args.data_dir, False, 8)
        images = composite_white_bkgd(images, True)
        radius = (1.5, 1.5, 1.5)

    H, W, focal = [int(hwf[0]), int(hwf[1]), hwf[2]]
    K = intrinsics_matrix(H, W, focal)
    i_train, _, i_test = i_split
    rays = [get_rays_np(H, W, K, p[:3, :4]) for p in poses[i_train]]
    origins = np.stack([r[0] for r in rays], 0)
    dirs = np.stack([r[1] for r in rays], 0)
    budgeter = RayBudgeter(
        images[i_train], origins, dirs, init_level=args.init_level, seed=args.seed
    )

    reso_schedule = json.loads(args.reso) if isinstance(args.reso, str) else args.reso
    gcfg = VoxelGridConfig(
        reso=tuple(reso_schedule[0]),
        basis_dim=args.basis_dim,
        radius=radius,
        init_sigma=args.init_sigma,
        step_size=args.step_size,
        sigma_thresh=args.sigma_thresh,
        stop_thresh=args.stop_thresh,
        background_brightness=args.background_brightness,
        max_steps=int(3.5 * max(reso_schedule[0]) / args.step_size),
        backend=args.renderer_backend,
        background_nlayers=args.background_nlayers,
    )
    # schedule grid upsampling across epochs if more resolutions are given
    n_up = len(reso_schedule) - 1
    upsample_epochs = tuple(
        int(args.n_epochs * (i + 1) / (n_up + 1)) for i in range(n_up)
    )
    tcfg = PlenoxelsTrainConfig(
        n_epoch=args.n_epochs,
        batch_size=args.batch_size,
        lr_sigma=args.lr_sigma,
        lr_sigma_final=args.lr_sigma_final,
        lr_sigma_delay_steps=args.lr_sigma_delay_steps,
        lr_sigma_delay_mult=args.lr_sigma_delay_mult,
        lr_sh=args.lr_sh,
        lr_sh_final=args.lr_sh_final,
        rms_beta=args.rms_beta,
        lambda_tv=args.lambda_tv,
        lambda_tv_sh=args.lambda_tv_sh,
        lr_sigma_bg=args.lr_sigma_bg,
        lr_sigma_bg_final=args.lr_sigma_bg_final,
        lr_color_bg=args.lr_color_bg,
        lr_color_bg_final=args.lr_color_bg_final,
        lambda_tv_background_sigma=args.lambda_tv_background_sigma,
        lambda_tv_background_color=args.lambda_tv_background_color,
        background_density_thresh=args.background_density_thresh,
        subdivide_every=args.subdivide_every,
        subdivide_thres=args.subdivide_thres,
        rand_samp_perc=args.randSamp_perc,
        steps_per_chunk=args.steps_per_chunk,
        upsample_epochs=upsample_epochs,
        seed=args.seed,
    )
    trainer = PlenoxelsTrainer(gcfg, tcfg, device=device)

    def on_epoch_end(tr, epoch_id):
        final = epoch_id == tcfg.n_epoch
        if args.tune_nosave or (args.tune_mode and not final):
            return  # tune runs keep only test_psnr.txt (opt.py:562-566)
        save_npz(os.path.join(args.train_dir, f"ckpt{epoch_id:02d}.npz"), tr.state.grid, tr.gcfg)
        budgeter.forest.save(os.path.join(args.train_dir, f"treeDivide_{epoch_id:04d}.pkl"))

    t0 = time.time()
    trainer.fit(budgeter, on_epoch_end=on_epoch_end)
    mins = (time.time() - t0) / 60.0
    with open(os.path.join(args.train_dir, "time_mins.txt"), "w") as f:
        f.write(f"{mins:.3f}\n")

    psnr, ssim = trainer.eval_images(
        poses[i_test], images[i_test], H, W, K, chunk=args.eval_chunk
    )
    print(f"test PSNR {psnr:.3f} SSIM {ssim:.4f} ({mins:.1f} min)")
    with open(os.path.join(args.train_dir, "test_psnr.txt"), "w") as f:
        f.write(f"{psnr}\n")
    return {"psnr": psnr, "ssim": ssim, "mins": mins, "history": trainer.history,
            "grid": trainer.state.grid}


if __name__ == "__main__":
    main()

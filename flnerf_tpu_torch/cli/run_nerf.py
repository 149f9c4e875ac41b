"""Vanilla-NeRF quadtree training CLI, flag-compatible with the reference.

Port of ``flnerf_tpu/cli/run_nerf.py`` (parity target
nerf-ours/argument_parser.py:4-123 and run_nerf.py:156-546: data load ->
model -> quadtree manager -> checkpoint/tree resume -> center-crop warmup
-> epoch loop -> per-epoch {epoch:03d}.tar + treeDivide_{epoch:04d}.pkl ->
render_only/render_test eval), plus ``--device`` (default ``cuda``; with no
card it raises unless ``--device cpu``).

As in the reference, the fine network takes ``--netdepth``/``--netwidth``;
``--netdepth_fine``/``--netwidth_fine`` are parsed and unused (ROADMAP
fault R3 of the reference).  ``--dataset_type`` takes llff, blender,
LINEMOD (the loader's K and near/far), deepvoxels (near/far at the mean
camera distance +- 1) and synthetic, as the reference does.

Usage:
  python -m flnerf_tpu_torch.cli.run_nerf --config configs/lego.txt
  python -m flnerf_tpu_torch.cli.run_nerf --config configs/lego.txt --render_only --render_test
  python -m flnerf_tpu_torch.cli.run_nerf --config configs/synthetic_smoke.txt --device cpu
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np


def config_parser():
    from flnerf_tpu_torch.core.config import ConfigArgumentParser

    parser = ConfigArgumentParser()
    parser.add_argument("--config", is_config_file=True, help="config file path")
    parser.add_argument("--expname", type=str, help="experiment name")
    parser.add_argument("--basedir", type=str, default="./logs/")
    parser.add_argument("--datadir", type=str, default="./data/llff/fern")

    # training options
    parser.add_argument("--netdepth", type=int, default=8)
    parser.add_argument("--netwidth", type=int, default=256)
    parser.add_argument("--netdepth_fine", type=int, default=8)
    parser.add_argument("--netwidth_fine", type=int, default=256)
    parser.add_argument("--N_rand", type=int, default=32 * 32 * 4)
    parser.add_argument("--lrate", type=float, default=5e-4)
    parser.add_argument("--lrate_decay", type=int, default=250)
    parser.add_argument("--chunk", type=int, default=1024 * 32)
    parser.add_argument("--netchunk", type=int, default=1024 * 64)
    parser.add_argument("--no_batching", action="store_true")
    parser.add_argument("--no_reload", action="store_true")
    parser.add_argument("--ft_path", type=str, default=None)

    # rendering options
    parser.add_argument("--N_samples", type=int, default=64)
    parser.add_argument("--N_importance", type=int, default=0)
    parser.add_argument("--perturb", type=float, default=1.0)
    parser.add_argument("--use_viewdirs", action="store_true")
    parser.add_argument("--i_embed", type=int, default=0)
    parser.add_argument("--multires", type=int, default=10)
    parser.add_argument("--multires_views", type=int, default=4)
    parser.add_argument("--raw_noise_std", type=float, default=0.0)
    parser.add_argument("--render_only", action="store_true")
    parser.add_argument("--render_test", action="store_true")
    parser.add_argument("--render_factor", type=int, default=0)

    # quadtree / epoch options
    parser.add_argument("--precrop_iters", type=int, default=0)
    parser.add_argument("--precrop_frac", type=float, default=0.5)
    parser.add_argument("--n_epoch", type=int, default=12)
    parser.add_argument("--init_level", type=int, default=3)
    parser.add_argument("--rays_downscale", type=int, default=1)
    parser.add_argument("--subdivide_every", type=int, default=1)
    parser.add_argument("--subdivide_thres", type=float, default=0.015)
    parser.add_argument("--randSamp_perc", type=float, default=0.5)
    parser.add_argument("--dset_name", type=str, default="Truck")
    parser.add_argument("--end_rand", type=int, default=11)

    # dataset options
    parser.add_argument("--dataset_type", type=str, default="llff")
    parser.add_argument("--testskip", type=int, default=8)
    parser.add_argument("--shape", type=str, default="greek")
    parser.add_argument("--white_bkgd", action="store_true")
    parser.add_argument("--half_res", action="store_true")
    parser.add_argument("--factor", type=int, default=8)
    parser.add_argument("--no_ndc", action="store_true")
    parser.add_argument("--lindisp", action="store_true")
    parser.add_argument("--spherify", action="store_true")
    parser.add_argument("--llffhold", type=int, default=8)

    # logging
    parser.add_argument("--i_print", type=int, default=100)
    parser.add_argument("--i_img", type=int, default=500)
    parser.add_argument("--i_weights", type=int, default=10000)
    parser.add_argument("--i_testset", type=int, default=50000)
    parser.add_argument("--i_video", type=int, default=50000)

    # the reference package's extras
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        help="matmul operand dtype: bfloat16|float32 (products summed in f32)")
    parser.add_argument("--steps_per_chunk", type=int, default=32,
                        help="accepted for the reference's flag surface; no effect on the "
                        "math here (the port runs one optimizer step per batch)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda or cpu)")
    return parser


def load_dataset(args):
    """Dataset dispatch (run_nerf.py:162-242)."""
    K = None
    if args.dataset_type == "llff":
        from flnerf_tpu_torch.data.llff import load_llff_data

        images, poses, bds, render_poses, i_test = load_llff_data(
            args.datadir, args.factor, recenter=True, bd_factor=0.75,
            spherify=args.spherify,
        )
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        if args.llffhold > 0:
            i_test = np.arange(images.shape[0])[:: args.llffhold]
        else:
            i_test = np.array([i_test])
        i_val = i_test
        i_train = np.array(
            [i for i in np.arange(images.shape[0]) if i not in i_test and i not in i_val]
        )
        if args.no_ndc:
            near, far = float(bds.min()) * 0.9, float(bds.max()) * 1.0
        else:
            near, far = 0.0, 1.0
    elif args.dataset_type == "blender":
        from flnerf_tpu_torch.data.blender import composite_white_bkgd, load_blender_data

        images, poses, render_poses, hwf, i_split = load_blender_data(
            args.datadir, args.half_res, args.testskip
        )
        i_train, i_val, i_test = i_split
        near, far = 2.0, 6.0
        images = composite_white_bkgd(images, args.white_bkgd)
    elif args.dataset_type == "LINEMOD":
        from flnerf_tpu_torch.data.blender import composite_white_bkgd
        from flnerf_tpu_torch.data.extra_loaders import load_linemod_data

        images, poses, render_poses, hwf, K, i_split, near, far = load_linemod_data(
            args.datadir, args.half_res, args.testskip
        )
        i_train, i_val, i_test = i_split
        images = composite_white_bkgd(images, args.white_bkgd)
    elif args.dataset_type == "deepvoxels":
        from flnerf_tpu_torch.data.extra_loaders import load_dv_data

        images, poses, render_poses, hwf, i_split = load_dv_data(
            scene=args.shape, basedir=args.datadir, testskip=args.testskip
        )
        i_train, i_val, i_test = i_split
        hemi_r = float(np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1)))
        near, far = hemi_r - 1.0, hemi_r + 1.0
    elif args.dataset_type == "synthetic":
        from flnerf_tpu_torch.data.synthetic import load_synthetic_data

        images, poses, render_poses, hwf, i_split = load_synthetic_data()
        i_train, i_val, i_test = i_split
        near, far = 1.5, 6.0
    else:
        raise SystemExit(f"Unknown dataset type {args.dataset_type}")

    H, W, focal = hwf
    H, W = int(H), int(W)
    hwf = [H, W, focal]
    if K is None:
        K = np.array(
            [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], dtype=np.float32
        )
    return images, poses, render_poses, hwf, K, i_train, i_val, i_test, near, far


def build(args, near: float, far: float, focal: float):
    """The configs and the trainer the flags describe."""
    import torch

    from flnerf_tpu_torch.render.renderer import RenderConfig
    from flnerf_tpu_torch.train.trainer import NerfConfig, NerfTrainer, TrainConfig

    use_ndc = args.dataset_type == "llff" and not args.no_ndc
    field_cfg = NerfConfig(
        multires=args.multires if args.i_embed == 0 else 0,
        multires_views=args.multires_views if args.i_embed == 0 else 0,
        # the reference builds both networks from netdepth/netwidth (R3)
        netdepth=args.netdepth,
        netwidth=args.netwidth,
        use_viewdirs=args.use_viewdirs,
        compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32,
    )
    render_cfg = RenderConfig(
        n_samples=args.N_samples,
        n_importance=args.N_importance,
        perturb=args.perturb,
        lindisp=args.lindisp,
        white_bkgd=args.white_bkgd,
        raw_noise_std=args.raw_noise_std,
        near=near,
        far=far,
        use_viewdirs=args.use_viewdirs,
        ndc=use_ndc,
        ndc_focal=float(focal),
    )
    train_cfg = TrainConfig(
        n_epoch=args.n_epoch,
        n_rand=args.N_rand,
        lrate=args.lrate,
        lrate_decay=args.lrate_decay,
        init_level=args.init_level,
        subdivide_every=args.subdivide_every,
        subdivide_thres=args.subdivide_thres,
        rand_samp_perc=args.randSamp_perc,
        precrop_iters=args.precrop_iters,
        seed=args.seed,
    )
    return NerfTrainer(field_cfg, render_cfg, train_cfg, device=args.device)


def main(argv=None):
    """Train (or, with --render_only, render) as the reference's main does.
    Returns the test-set results dict (psnr, ssim, lpips), with the
    trainer's per-epoch ``history``, ``precrop_s``/``precrop_rays`` and the
    ``run_dir`` added; None when there is no test set."""
    import torch

    from flnerf_tpu_torch.core.checkpoint import (
        find_latest_checkpoint,
        load_nerf_checkpoint,
        save_nerf_checkpoint,
    )
    from flnerf_tpu_torch.core.config import save_args
    from flnerf_tpu_torch.rays.camera import get_rays_np, ndc_rays
    from flnerf_tpu_torch.rays.quadtree import QuadTreeForest, RayBudgeter
    from flnerf_tpu_torch.train.eval import render_path, write_video
    from flnerf_tpu_torch.core.device import resolve_device

    parser = config_parser()
    args = parser.parse_args(argv)
    resolve_device(args.device)

    images, poses, render_poses, hwf, K, i_train, i_val, i_test, near, far = load_dataset(args)
    H, W, focal = hwf
    if args.render_test:
        render_poses = np.array(poses[i_test])

    # Log dir + config snapshot (run_nerf.py:248-260)
    run_dir = os.path.join(args.basedir, args.expname)
    os.makedirs(run_dir, exist_ok=True)
    save_args(args, os.path.join(run_dir, "args.txt"))
    if args.config is not None and os.path.exists(args.config):
        shutil.copy(args.config, os.path.join(run_dir, "config.txt"))

    trainer = build(args, near, far, focal)
    render_cfg = trainer.render_cfg

    # Checkpoint resume (run_nerf.py:109-127)
    start_epoch = 0
    ckpt_path = args.ft_path if args.ft_path not in (None, "None") else None
    if ckpt_path is None and not args.no_reload:
        ckpt_path = find_latest_checkpoint(run_dir)
    if ckpt_path:
        print("Reloading from", ckpt_path)
        start_epoch, trainer.global_iter = load_nerf_checkpoint(
            ckpt_path, trainer.coarse, trainer.fine, trainer.optimizer)

    def extras(results):
        if results is not None:
            results.update(history=trainer.history, precrop_s=trainer.precrop_s,
                           precrop_rays=trainer.precrop_rays, run_dir=run_dir)
        return results

    if args.render_only:
        print("RENDER ONLY")
        testsavedir = os.path.join(
            run_dir,
            "renderonly_{}_{:03d}".format("test" if args.render_test else "path", start_epoch),
        )
        os.makedirs(testsavedir, exist_ok=True)
        gt = images[i_test] if args.render_test else None
        rgbs, _, results = render_path(
            trainer.coarse, trainer.fine, render_cfg, render_poses, hwf, K,
            gt_imgs=gt, savedir=testsavedir, render_factor=args.render_factor,
            chunk=args.chunk,
        )
        write_video(os.path.join(testsavedir, "video.mp4"), rgbs)
        print("Done rendering", testsavedir)
        return extras(results)

    # Quadtree budgeter over training views (run_nerf.py:337)
    train_images = images[i_train]
    train_poses = poses[i_train]
    origins = np.stack([get_rays_np(H, W, K, p[:3, :4])[0] for p in train_poses], 0)
    dirs = np.stack([get_rays_np(H, W, K, p[:3, :4])[1] for p in train_poses], 0)
    viewdirs = None
    if render_cfg.ndc:
        viewdirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        no, nd = ndc_rays(H, W, float(focal), 1.0, torch.from_numpy(origins),
                          torch.from_numpy(dirs))
        origins, dirs = no.numpy(), nd.numpy()

    budgeter = RayBudgeter(
        train_images, origins, dirs, init_level=args.init_level,
        seed=args.seed, viewdirs=viewdirs,
    )
    tree_pkl = os.path.join(run_dir, f"treeDivide_{start_epoch:04d}.pkl")
    if os.path.exists(tree_pkl):
        budgeter.forest = QuadTreeForest.load(tree_pkl)
        print(f"loaded '{tree_pkl}'")

    def on_epoch_end(tr, epoch_id):
        path = os.path.join(run_dir, f"{epoch_id:03d}.tar")
        save_nerf_checkpoint(path, epoch_id, tr.global_iter, tr.coarse, tr.fine, tr.optimizer)
        budgeter.forest.save(os.path.join(run_dir, f"treeDivide_{epoch_id:04d}.pkl"))
        print("Saved checkpoints at", path)

    t0 = time.time()
    trainer.fit(budgeter, start_epoch=start_epoch, on_epoch_end=on_epoch_end)
    print("train complete. time={:.1f}s.".format(time.time() - t0))

    # Final held-out eval
    if len(i_test):
        testsavedir = os.path.join(run_dir, f"testset_{args.n_epoch:03d}")
        os.makedirs(testsavedir, exist_ok=True)
        _, _, results = render_path(
            trainer.coarse, trainer.fine, render_cfg, poses[i_test], hwf, K,
            gt_imgs=images[i_test], savedir=testsavedir, chunk=args.chunk,
        )
        return extras(results)
    return None


if __name__ == "__main__":
    main()

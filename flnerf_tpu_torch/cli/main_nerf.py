"""Instant-NGP CLI, flag-compatible with the reference entry point.

Port of ``flnerf_tpu/cli/main_nerf.py`` (parity target ngp-ours/main_nerf.py:
26-176): the same flags, including the -O meta-flag (fp16 -> bf16 MLPs,
cuda_ray, preload, EMA 0.95), plus ``--device`` (default ``cuda``; with no
card it raises unless ``--device cpu``).  Flow: dataset (poses scaled by
nerf_matrix_to_ngp's scale/offset, provider.py:20) -> field, renderer and
trainer configs -> fit -> final checkpoint -> test-split eval ->
``results.txt`` (and ``time_mins.txt``).

``--log2_hashmap_size`` 16 and above (torch-ngp's own 19 included) runs the
lattice engine under ``--hash_engine auto`` or ``lattice``, as the reference
resolves it, and the sorted engine (torch-ngp's xor hash) under
``--hash_engine sorted``; ``matmul`` keeps the packed engine at any size.

``--gui`` runs the interactive session (``render/interactive.py``): a
dearpygui window when that package is importable; otherwise the same session
headless, training frames until ``--iters`` (then a checkpoint), or 4
preview frames under ``--test``.

``--clip_text`` / ``--rand_pose`` gate as the reference's do (cli/
main_nerf.py:178-193): ``--rand_pose`` without ``--clip_text`` exits, and
``--clip_text`` exits unless ``core/clip_guidance.clip_loss_fn`` finds a
local CLIP encoder.  Text-guided training goes through the library:
``CLIPGuidance`` on views of ``rays/camera.rand_poses``.

``--bg_radius R`` (R > 0; torch-ngp's switch for unbounded scenes) trains
the background env-map of ``models/hash_ngp.py`` beside the field: its 2-D
encoding is plain torch, so the run launches the same kernels as without it.

Usage:
  python -m flnerf_tpu_torch.cli.main_nerf data/nerf_synthetic/lego -O --bound 1 --scale 0.8
  python -m flnerf_tpu_torch.cli.main_nerf synthetic -O --iters 2000
  python -m flnerf_tpu_torch.cli.main_nerf synthetic -O --log2_hashmap_size 19
  python -m flnerf_tpu_torch.cli.main_nerf synthetic -O --log2_hashmap_size 19 --hash_engine sorted
  python -m flnerf_tpu_torch.cli.main_nerf synthetic -O --gui [--test]
  python -m flnerf_tpu_torch.cli.main_nerf synthetic -O --bg_radius 32
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def make_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str)
    parser.add_argument("-O", action="store_true", help="recommended settings")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--workspace", type=str, default="workspace")
    parser.add_argument("--synth_h", type=int, default=64,
                        help="offline synthetic scene resolution")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda or cpu)")

    # training
    parser.add_argument("--iters", type=int, default=30000)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--ckpt", type=str, default="latest")
    parser.add_argument("--num_rays", type=int, default=4096)
    parser.add_argument("--cuda_ray", action="store_true",
                        help="occupancy-grid marching")
    parser.add_argument("--max_steps", type=int, default=1024)
    parser.add_argument("--num_steps", type=int, default=128)
    parser.add_argument("--upsample_steps", type=int, default=128)
    parser.add_argument("--update_extra_interval", type=int, default=16)
    parser.add_argument("--max_ray_batch", type=int, default=4096)
    parser.add_argument("--patch_size", type=int, default=1)

    # network
    parser.add_argument("--fp16", action="store_true", help="bf16 MLPs")
    parser.add_argument("--ff", action="store_true")
    parser.add_argument("--tcnn", action="store_true")

    # dataset
    parser.add_argument("--color_space", type=str, default="srgb")
    parser.add_argument("--preload", action="store_true")
    parser.add_argument("--bound", type=float, default=2.0)
    parser.add_argument("--scale", type=float, default=0.33)
    parser.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    parser.add_argument("--dt_gamma", type=float, default=1 / 128)
    parser.add_argument("--min_near", type=float, default=0.2)
    parser.add_argument("--density_thresh", type=float, default=10)
    parser.add_argument("--bg_radius", type=float, default=-1)

    # ray selection (the paper's grafting)
    parser.add_argument("--error_map", action="store_true")
    parser.add_argument("--prob_map", action="store_true",
                        help="variance-based image probability sampling")

    # text-guided training (main_nerf.py:73-74)
    parser.add_argument("--clip_text", type=str, default="")
    parser.add_argument("--rand_pose", type=int, default=-1,
                        help="<0 none, =0 only rand poses, >0 one rand "
                        "pose every N known poses (provider.py:58)")

    # GUI (main_nerf.py:62-68)
    parser.add_argument("--gui", action="store_true")
    parser.add_argument("--W", type=int, default=1920)
    parser.add_argument("--H", type=int, default=1080)
    parser.add_argument("--radius", type=float, default=5.0)
    parser.add_argument("--fovy", type=float, default=50.0)
    parser.add_argument("--max_spp", type=int, default=64)

    # the reference package's static-shape extras
    parser.add_argument("--grid_size", type=int, default=128)
    parser.add_argument("--n_candidates", type=int, default=192)
    parser.add_argument("--n_keep", type=int, default=96)
    parser.add_argument("--steps_per_chunk", type=int, default=16)
    parser.add_argument("--eval_interval", type=int, default=0)
    parser.add_argument("--log2_hashmap_size", type=int, default=15)
    parser.add_argument("--hash_engine", type=str, default="auto",
                        choices=("auto", "matmul", "sorted", "lattice"),
                        help="big-table encode engine at log2 >= 16: auto and lattice "
                        "run the lattice engine, sorted the sorted engine")
    return parser


def parse_args(argv=None):
    """The parsed flags, with -O expanded (main_nerf.py:78-81)."""
    args = make_parser().parse_args(argv)
    if args.O:
        args.fp16 = True
        args.cuda_ray = True
        args.preload = True
    return args


def load_ngp_dataset(args):
    """Blender transforms.json or the offline synthetic scene; applies the
    nerf_matrix_to_ngp translation scale/offset (provider.py:20-33)."""
    if args.path == "synthetic":
        from flnerf_tpu_torch.data.synthetic import load_synthetic_data

        h = getattr(args, "synth_h", 64)
        images, poses, _, hwf, i_split = load_synthetic_data(n_train=8, n_test=2, H=h, W=h)
        scale = min(args.scale, 0.5)
    else:
        from flnerf_tpu_torch.data.blender import composite_white_bkgd, load_blender_data

        images, poses, _, hwf, i_split = load_blender_data(args.path, False, 8)
        images = composite_white_bkgd(images, True)
        scale = args.scale
    poses = poses.copy()
    poses[:, :3, 3] = poses[:, :3, 3] * scale + np.asarray(args.offset, np.float32)
    H, W, focal = hwf
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)
    return images, poses, [int(H), int(W), focal], K, i_split


def build(args):
    """The configs and the trainer the flags describe:
    (trainer, field_cfg, render_cfg, train_cfg)."""
    import torch

    from flnerf_tpu_torch.models.hash_ngp import NGPConfig
    from flnerf_tpu_torch.render.ngp import NGPRenderConfig
    from flnerf_tpu_torch.train.ngp_trainer import NGPTrainConfig, NGPTrainer

    cfg = NGPConfig(bound=args.bound, desired_resolution=2048,
                    log2_hashmap_size=args.log2_hashmap_size,
                    hash_engine=args.hash_engine,
                    bg_radius=max(args.bg_radius, 0.0))
    rcfg = NGPRenderConfig(
        n_candidates=args.n_candidates, n_keep=args.n_keep,
        grid_size=args.grid_size, bound=args.bound, min_near=args.min_near,
        density_thresh=0.01, bg_color=1.0,
        # adaptive stepping only helps large-bound scenes (torch-ngp uses
        # dt_gamma=0 on blender); honor the flag when bound > 1
        dt_gamma=args.dt_gamma if args.bound > 1.0 else 0.0,
    )
    tcfg = NGPTrainConfig(
        max_steps=args.iters, batch_rays=args.num_rays, lr=args.lr,
        steps_per_chunk=args.steps_per_chunk, use_prob_map=args.prob_map,
        use_error_map=args.error_map, ema_decay=0.95 if args.O else 0.0,
        bg_color=1.0, seed=args.seed, patch_size=args.patch_size,
    )
    compute_dtype = torch.bfloat16 if args.fp16 else torch.float32
    trainer = NGPTrainer(cfg, rcfg, tcfg, device=args.device, compute_dtype=compute_dtype)
    return trainer, cfg, rcfg, tcfg


def run_gui(args, trainer, sampler, time=None):
    """NeRFGUI mode (main_nerf.py:166-171, dnerf/gui.py): the budgeted
    train/preview loop.  A dearpygui window attaches when the package is
    importable; otherwise the session runs headless until --iters (training
    frames, then a checkpoint) or for 4 preview frames (--test).  ``time``
    starts the D-NeRF time slider.  Returns {"step", "spp"}."""
    from flnerf_tpu_torch.render.interactive import InteractiveSession, run_dearpygui

    sess = InteractiveSession(trainer, sampler, W=args.W, H=args.H, radius=args.radius,
                              fovy=args.fovy, max_spp=args.max_spp, time=time)
    sess.training = not args.test
    try:
        run_dearpygui(sess)
    except ImportError:
        if args.test:
            for _ in range(4):
                sess.frame()
        else:
            while sess.step < args.iters:
                out = sess.frame()
                tr = out.get("train", {})
                print(f"step {sess.step} loss {tr.get('loss', 0.0):.5f} "
                      f"downscale {out['render']['downscale']} "
                      f"spp {out['render']['spp']}")
            trainer.save_checkpoint(args.workspace)
    return {"step": sess.step, "spp": sess.spp}


def main(argv=None):
    from flnerf_tpu_torch.train.ngp_trainer import NGPSampler

    args = parse_args(argv)
    if args.clip_text or args.rand_pose >= 0:
        # rand-pose batches have no gt pixels; they train on the CLIP
        # loss only (utils.py:429-437) — so both flags gate together
        if not args.clip_text:
            raise SystemExit(
                "--rand_pose needs --clip_text: rand-pose batches have "
                "no ground truth and train on the CLIP loss")
        from flnerf_tpu_torch.core.clip_guidance import clip_loss_fn

        if clip_loss_fn([args.clip_text]) is None:
            raise SystemExit(
                "--clip_text needs a local CLIP encoder (none in this "
                "offline environment; core/clip_guidance.py documents "
                "the gate).  Differentiable text-guided training needs "
                "a torch encoder injected through the library API "
                "(CLIPGuidance + rays.camera.rand_poses).")
    trainer, _, _, tcfg = build(args)
    os.makedirs(args.workspace, exist_ok=True)
    images, poses, hwf, K, i_split = load_ngp_dataset(args)
    H, W, _ = hwf
    i_train, _, i_test = i_split

    if args.gui:
        sampler = NGPSampler(images[i_train], poses[i_train], K, tcfg, seed=args.seed)
        return run_gui(args, trainer, sampler)

    if not args.test:
        sampler = NGPSampler(images[i_train], poses[i_train], K, tcfg, seed=args.seed)
        t0 = time.time()
        trainer.fit(sampler)   # ends in a host sync (the loss history)
        dt = time.time() - t0
        print(f"training done in {dt / 60:.1f} min "
              f"({args.iters * args.num_rays / dt:.0f} rays/s)")
        with open(os.path.join(args.workspace, "time_mins.txt"), "w") as f:
            f.write(f"{dt / 60:.3f}\n")
        trainer.save_checkpoint(args.workspace)

    psnr, ssim = trainer.eval_images(poses[i_test], images[i_test], H, W, K,
                                     chunk=args.max_ray_batch)
    print(f"test PSNR {psnr:.3f} SSIM {ssim:.4f}")
    with open(os.path.join(args.workspace, "results.txt"), "w") as f:
        f.write(f"mean PSNR: {psnr}\nmean SSIM: {ssim}\n")
    return {"psnr": psnr, "ssim": ssim, "steps": trainer.step, "history": trainer.history}


if __name__ == "__main__":
    main()

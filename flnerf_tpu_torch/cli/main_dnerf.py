"""D-NeRF training CLI (ngp-ours/main_dnerf.py analog).

Port of ``flnerf_tpu/cli/main_dnerf.py``: ``cli/main_nerf.make_parser``'s
flags plus ``--variant`` (``deform``, ``basis``, ``hyper``: network.py,
network_basis.py, network_hyper.py) and ``--device`` (default ``cuda``; with
no card it raises unless ``--device cpu``).  Flow: dataset -> per-frame
times -> the variant's field, renderer and trainer configs -> fit on the
time path of ``train/ngp_trainer.py`` -> test-split eval at the test times
-> ``results.txt`` (and ``time_mins.txt``).  No checkpoint is written, as
in the reference; ``main`` returns the trainer so a caller can save one.

The configs are the reference CLI's own, not ``main_nerf``'s (ROADMAP.md
R6): ``NGPConfig(bound=--bound)`` only (``--log2_hashmap_size``,
``--hash_engine`` and ``--bg_radius`` are parsed and not read), a renderer
config of ``--n_candidates``, ``--n_keep``, ``--grid_size``, ``--bound`` and
``--min_near`` (so ``dt_gamma`` stays 0), a trainer config without
``--prob_map``, ``--error_map``, ``--patch_size`` or EMA, and times spread
by ``np.linspace(0, 1, n_images)`` over the train, val and test images
together.

Not ported yet (raises ``NotImplementedError``): ``--gui`` (ROADMAP.md M19).

Usage:
  python -m flnerf_tpu_torch.cli.main_dnerf data/dnerf/jumpingjacks -O --bound 1
  python -m flnerf_tpu_torch.cli.main_dnerf synthetic -O --iters 512 --variant basis
"""

from __future__ import annotations

import os
import time

import numpy as np


def make_dnerf_parser():
    from flnerf_tpu_torch.cli.main_nerf import make_parser

    parser = make_parser()
    parser.add_argument("--variant", type=str, default="deform",
                        choices=("deform", "basis", "hyper"),
                        help="network.py / network_basis.py / network_hyper.py")
    return parser


def parse_args(argv=None):
    """The parsed flags, with -O expanded (main_nerf.py:78-81)."""
    args = make_dnerf_parser().parse_args(argv)
    if args.O:
        args.fp16 = True
        args.cuda_ray = True
        args.preload = True
    return args


def frame_times(n_images: int) -> np.ndarray:
    """Every image's time: spread over [0, 1] in dataset order (R6)."""
    return np.linspace(0.0, 1.0, n_images, dtype=np.float32)


def build(args):
    """The time-dependent trainer of the variant's field that the flags
    describe, with the reference CLI's configs (R6); raises with no card
    unless ``--device cpu``."""
    import torch

    from flnerf_tpu_torch.core.device import resolve_device
    from flnerf_tpu_torch.models.dnerf import DNeRFConfig, make_dnerf_variant_field
    from flnerf_tpu_torch.models.hash_ngp import NGPConfig
    from flnerf_tpu_torch.render.ngp import NGPRenderConfig
    from flnerf_tpu_torch.train.ngp_trainer import NGPTrainConfig, NGPTrainer

    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if args.fp16 else torch.float32
    cfg = DNeRFConfig(ngp=NGPConfig(bound=args.bound), variant=args.variant)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    field = make_dnerf_variant_field(cfg, compute_dtype, gen, device)
    rcfg = NGPRenderConfig(
        n_candidates=args.n_candidates, n_keep=args.n_keep,
        grid_size=args.grid_size, bound=args.bound, min_near=args.min_near,
    )
    tcfg = NGPTrainConfig(
        max_steps=args.iters, batch_rays=args.num_rays, lr=args.lr,
        steps_per_chunk=args.steps_per_chunk, time_dependent=True, seed=args.seed,
    )
    return NGPTrainer(field, rcfg, tcfg, device=device)


def main(argv=None):
    from flnerf_tpu_torch.cli.main_nerf import load_ngp_dataset
    from flnerf_tpu_torch.train.ngp_trainer import NGPSampler

    args = parse_args(argv)
    if args.gui:
        raise NotImplementedError("--gui (the interactive viewer with its time slider) is "
                                  "not ported yet; it is queued in ROADMAP.md as M19")
    trainer = build(args)
    os.makedirs(args.workspace, exist_ok=True)
    images, poses, hwf, K, i_split = load_ngp_dataset(args)
    H, W, _ = hwf
    i_train, _, i_test = i_split
    times = frame_times(images.shape[0])

    if not args.test:
        sampler = NGPSampler(images[i_train], poses[i_train], K, trainer.cfg, seed=args.seed,
                             times=times[i_train])
        t0 = time.time()
        trainer.fit(sampler)   # ends in a host sync (the loss history)
        dt = time.time() - t0
        print(f"training done in {dt / 60:.1f} min "
              f"({args.iters * args.num_rays / dt:.0f} rays/s)")
        with open(os.path.join(args.workspace, "time_mins.txt"), "w") as f:
            f.write(f"{dt / 60:.3f}\n")

    psnr, ssim = trainer.eval_images(poses[i_test], images[i_test], H, W, K,
                                     chunk=args.max_ray_batch, times=times[i_test])
    print(f"test PSNR {psnr:.3f} SSIM {ssim:.4f}")
    with open(os.path.join(args.workspace, "results.txt"), "w") as f:
        f.write(f"mean PSNR: {psnr}\nmean SSIM: {ssim}\n")
    return {"psnr": psnr, "ssim": ssim, "steps": trainer.step, "history": trainer.history,
            "trainer": trainer}


if __name__ == "__main__":
    main()

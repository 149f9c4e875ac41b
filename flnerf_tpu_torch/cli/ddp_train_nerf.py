"""NeRF++ quadtree training CLI, flag-compatible with the reference.

Port of ``flnerf_tpu/cli/ddp_train_nerf.py`` (parity target
nerf++-ours/ddp_train_nerf.py:428-498 for the flags and :187-324 for the
flow: load the splits at resolution_level 2 -> the cascade nets -> the
quadtree manager with sharpness sampling -> the epoch loop with mean-loss
subdivision -> model_{epoch:04d}.pth + treeDivide_{epoch:04d}.pkl -> the
test split's PSNR and SSIM), plus ``--device`` (default ``cuda``; with no
card it raises unless ``--device cpu``).

As in the reference, 14 parsed flags are read by nothing (ROADMAP fault R4
of the reference): --no_reload, --ckpt_path, --det, --use_viewdirs,
--N_rand, --N_iters, --render_splits, --load_min_depth, --world_size,
--rays_downscale, --dset_name, --i_print, --i_img and --i_weights; so the
CLI never resumes.  --steps_per_chunk sizes the reference's jitted chunks
and has no counterpart here (one optimizer step a batch).

The checkpoint is the reference's pickle, ``{"format": "flnerf_nerfpp_v1",
"epoch", "global_iter", "params"}`` with ``params`` the reference's numpy
params tuple (``core/convert.nerfpp_params_to_numpy``), so either package
reads the other's files.

Usage:
  python -m flnerf_tpu_torch.cli.ddp_train_nerf --config configs/tat_training_truck.txt
  python -m flnerf_tpu_torch.cli.ddp_train_nerf --datadir synthetic --scene any \\
      --expname smoke --device cpu
"""

from __future__ import annotations

import os
import pickle
import time

CKPT_FORMAT = "flnerf_nerfpp_v1"


def config_parser():
    from flnerf_tpu_torch.core.config import ConfigArgumentParser

    parser = ConfigArgumentParser()
    parser.add_argument("--config", is_config_file=True)
    parser.add_argument("--expname", type=str)
    parser.add_argument("--basedir", type=str, default="./logs/")
    parser.add_argument("--datadir", type=str, default=None)
    parser.add_argument("--scene", type=str, default=None)
    parser.add_argument("--testskip", type=int, default=8)
    parser.add_argument("--netdepth", type=int, default=8)
    parser.add_argument("--netwidth", type=int, default=256)
    parser.add_argument("--use_viewdirs", action="store_true")
    parser.add_argument("--init_level", type=int, default=3)
    parser.add_argument("--subdivide_every", type=int, default=1)
    parser.add_argument("--subdivide_thres", type=float, default=0.015)
    parser.add_argument("--rays_downscale", type=int, default=1)
    parser.add_argument("--randSamp_perc", type=float, default=0.5)
    parser.add_argument("--dset_name", type=str, default="Truck")
    parser.add_argument("--no_reload", action="store_true")
    parser.add_argument("--ckpt_path", type=str, default=None)
    parser.add_argument("--N_rand", type=int, default=32 * 32 * 2)
    parser.add_argument("--chunk_size", type=int, default=1024 * 8)
    parser.add_argument("--batch_size", type=int, default=2880)
    parser.add_argument("--N_iters", type=int, default=250001)
    parser.add_argument("--n_epoch", type=int, default=6)
    parser.add_argument("--render_splits", type=str, default="test")
    parser.add_argument("--cascade_level", type=int, default=2)
    parser.add_argument("--cascade_samples", type=str, default="64,64")
    parser.add_argument("--world_size", type=int, default=-1)
    parser.add_argument("--optim_autoexpo", action="store_true")
    parser.add_argument("--lambda_autoexpo", type=float, default=1.0)
    parser.add_argument("--lrate", type=float, default=5e-4)
    parser.add_argument("--lrate_decay_factor", type=float, default=0.1)
    parser.add_argument("--lrate_decay_steps", type=int, default=5000)
    parser.add_argument("--det", action="store_true")
    parser.add_argument("--max_freq_log2", type=int, default=10)
    parser.add_argument("--max_freq_log2_viewdirs", type=int, default=4)
    parser.add_argument("--load_min_depth", action="store_true")
    parser.add_argument("--i_print", type=int, default=100)
    parser.add_argument("--i_img", type=int, default=500)
    parser.add_argument("--i_weights", type=int, default=10000)
    # the reference package's extras
    parser.add_argument("--resolution_level", type=int, default=2,
                        help="training downsample (data_loader_split.py:102)")
    parser.add_argument("--steps_per_chunk", type=int, default=16,
                        help="accepted for the reference's flag surface; no effect here "
                        "(the port runs one optimizer step per batch)")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16")
    parser.add_argument("--seed", type=int, default=777)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda or cpu)")
    return parser


def load_splits(args):
    """(train, test) dicts: the procedural scene for ``--datadir
    synthetic``, else the split layout at ``--resolution_level``."""
    from flnerf_tpu_torch.data import nerfpp_dataset as ds

    if args.datadir == "synthetic":
        return ds.make_synthetic_nerfpp_scene(n_train=6, n_test=2, H=40, W=40)
    train = ds.load_nerfpp_split(args.datadir, args.scene, "train",
                                 resolution_level=args.resolution_level)
    test = ds.load_nerfpp_split(args.datadir, args.scene, "test", skip=args.testskip,
                                resolution_level=args.resolution_level)
    return train, test


def build(args, n_images: int):
    """The configs and the trainer the flags describe."""
    from flnerf_tpu_torch.models.nerfpp import NerfPPConfig
    from flnerf_tpu_torch.train.nerfpp_trainer import NerfPPTrainConfig, NerfPPTrainer

    cascade_samples = tuple(int(x) for x in args.cascade_samples.split(","))
    mcfg = NerfPPConfig(
        netdepth=args.netdepth, netwidth=args.netwidth,
        max_freq_log2=args.max_freq_log2,
        max_freq_log2_viewdirs=args.max_freq_log2_viewdirs,
        cascade_samples=cascade_samples[: args.cascade_level],
        optim_autoexpo=args.optim_autoexpo,
        lambda_autoexpo=args.lambda_autoexpo,
    )
    tcfg = NerfPPTrainConfig(
        n_epoch=args.n_epoch, batch_size=args.batch_size, lrate=args.lrate,
        lrate_decay_factor=args.lrate_decay_factor,
        lrate_decay_steps=args.lrate_decay_steps,
        subdivide_every=args.subdivide_every,
        subdivide_thres=args.subdivide_thres,
        rand_samp_perc=args.randSamp_perc,
        compute_dtype=args.compute_dtype,
        seed=args.seed,
    )
    # n_images sizes the per-image autoexpo table when --optim_autoexpo
    return NerfPPTrainer(mcfg, tcfg, n_images=n_images, device=args.device)


def save_checkpoint(path: str, trainer, epoch: int) -> None:
    """model_{epoch:04d}.pth: the reference's pickle of its params tuple."""
    from flnerf_tpu_torch.core.convert import nerfpp_params_to_numpy

    with open(path, "wb") as f:
        pickle.dump({"format": CKPT_FORMAT, "epoch": epoch,
                     "global_iter": int(trainer.global_iter),
                     "params": nerfpp_params_to_numpy(trainer.nets)}, f)


def load_checkpoint(path: str, trainer) -> int:
    """Load a model_*.pth written by either package into ``trainer``'s
    nets; returns its epoch."""
    import torch

    from flnerf_tpu_torch.core.convert import nerfpp_params_from_numpy

    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    if ckpt.get("format") != CKPT_FORMAT:
        raise ValueError(f"{path} is not a {CKPT_FORMAT} checkpoint")
    with torch.no_grad():
        for net, sd in zip(trainer.nets, nerfpp_params_from_numpy(ckpt["params"],
                                                                  trainer.device)):
            net.load_state_dict(sd)
    trainer.global_iter = int(ckpt["global_iter"])
    return int(ckpt["epoch"])


def main(argv=None):
    """Train as the reference's main does; returns {"psnr", "ssim"} of the
    test split, with the trainer's per-epoch ``history`` and the
    ``run_dir``."""
    from flnerf_tpu_torch.core.config import save_args
    from flnerf_tpu_torch.core.device import resolve_device
    from flnerf_tpu_torch.rays.quadtree import RayBudgeter

    args = config_parser().parse_args(argv)
    resolve_device(args.device)
    run_dir = os.path.join(args.basedir, args.expname)
    os.makedirs(run_dir, exist_ok=True)
    save_args(args, os.path.join(run_dir, "args.txt"))

    train, test = load_splits(args)
    budgeter = RayBudgeter(train["images"], train["origins"], train["dirs"],
                           init_level=args.init_level, seed=args.seed)
    trainer = build(args, train["images"].shape[0])

    def on_epoch_end(tr, epoch_id):
        # model_{epoch:04d}.pth naming (ddp_train_nerf.py:307-315)
        save_checkpoint(os.path.join(run_dir, f"model_{epoch_id:04d}.pth"), tr, epoch_id)
        budgeter.forest.save(os.path.join(run_dir, f"treeDivide_{epoch_id:04d}.pkl"))

    t0 = time.time()
    trainer.fit(budgeter, on_epoch_end=on_epoch_end)
    print(f"train complete. time={time.time() - t0:.1f}s")

    psnr, ssim = trainer.eval_images(test["poses"], test["images"], test["H"], test["W"],
                                     test["intrinsics"][0], chunk=args.chunk_size)
    print(f"test PSNR {psnr:.3f} SSIM {ssim:.4f}")
    with open(os.path.join(run_dir, "results.txt"), "w") as f:
        f.write(f"mean PSNR: {psnr}\nmean SSIM: {ssim}\n")
    return {"psnr": psnr, "ssim": ssim, "history": trainer.history, "run_dir": run_dir}


if __name__ == "__main__":
    main()

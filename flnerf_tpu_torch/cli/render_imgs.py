"""Plenoxels checkpoint evaluation CLI (opt/render_imgs.py analog).

Port of ``flnerf_tpu/cli/render_imgs.py``: loads a ckpt.npz + dataset,
renders every test view of the loaded grid through ``render_grid_image``
(the fused cuvol forward on a CUDA device; no trainer), computes
PSNR/SSIM/(gated LPIPS), writes PNGs (``data/png.py``) + results.txt;
``--timing`` renders only and prints the views per second
(opt/render_imgs.py:22-92 flag surface subset).  Plus ``--device`` (default
``cuda``; with no card it raises unless ``--device cpu``).  Data: the
offline ``synthetic`` scene or a blender directory, as in the reference.

Usage:
  python -m flnerf_tpu_torch.cli.render_imgs ckpt_dir/ckpt07.npz <datadir> [--timing]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    import torch

    from flnerf_tpu_torch.core.device import resolve_device
    from flnerf_tpu_torch.core.metrics import compute_ssim, lpips_fn, to8b
    from flnerf_tpu_torch.data.png import write_png
    from flnerf_tpu_torch.models.voxel_sh import load_npz
    from flnerf_tpu_torch.rays.camera import intrinsics_matrix
    from flnerf_tpu_torch.train.plenoxels_trainer import render_grid_image

    parser = argparse.ArgumentParser()
    parser.add_argument("ckpt", type=str)
    parser.add_argument("data_dir", type=str)
    parser.add_argument("--render_dir", type=str, default=None)
    parser.add_argument("--timing", action="store_true")
    parser.add_argument("--eval_chunk", type=int, default=4096)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (cuda or cpu)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    grid, gcfg = load_npz(args.ckpt, device=device)

    if args.data_dir == "synthetic":
        from flnerf_tpu_torch.data.synthetic import load_synthetic_data

        images, poses, _, hwf, i_split = load_synthetic_data(n_train=8, n_test=2, H=48, W=48)
    else:
        from flnerf_tpu_torch.data.blender import composite_white_bkgd, load_blender_data

        images, poses, _, hwf, i_split = load_blender_data(args.data_dir, False, 8)
        images = composite_white_bkgd(images, True)
    H, W, focal = int(hwf[0]), int(hwf[1]), hwf[2]
    K = intrinsics_matrix(H, W, focal)
    i_test = i_split[2]

    render_dir = args.render_dir or os.path.join(os.path.dirname(args.ckpt), "test_renders")
    os.makedirs(render_dir, exist_ok=True)
    lp = lpips_fn()

    psnrs, ssims, lpipss = [], [], []
    t0 = time.time()
    for i, vi in enumerate(i_test):
        rgb = render_grid_image(grid, gcfg, H, W, K, poses[vi][:3, :4], chunk=args.eval_chunk)
        if not args.timing:
            write_png(os.path.join(render_dir, f"{i:04d}.png"), to8b(rgb))
            gt = images[vi]
            mse = float(np.mean((rgb - gt) ** 2))
            psnrs.append(-10.0 * np.log10(max(mse, 1e-12)))
            ssims.append(float(compute_ssim(torch.from_numpy(np.asarray(gt, np.float32)),
                                            torch.from_numpy(rgb))))
            lpipss.append(lp(gt, rgb) if lp else float("nan"))
    dt = time.time() - t0   # render_grid_image returns host arrays: the device is done

    if args.timing:
        fps = len(i_test) / dt
        print(f"rendered {len(i_test)} views in {dt:.2f}s ({fps:.2f} FPS)")
        return {"fps": fps}

    results = {
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "lpips": float(np.nanmean(lpipss)) if lpipss else float("nan"),
    }
    text = "mean PSNR: {psnr}\nmean SSIM: {ssim}\nmean LPIPS: {lpips}".format(**results)
    print(text)
    with open(os.path.join(render_dir, "results.txt"), "w") as f:
        f.write(text)
    return results


if __name__ == "__main__":
    main()

"""Standalone metric computation over two image directories
(plenoxels-ours/opt/calc_metrics.py analog): PSNR/SSIM/(gated LPIPS)
between rendered images and GT images, means written to stdout.

Port of ``flnerf_tpu/cli/calc_metrics.py``; images are read through
``data/png.py`` (JPEGs need imageio) and the metrics run on the CPU.

Usage: python -m flnerf_tpu_torch.cli.calc_metrics <render_dir> <gt_dir>
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    import torch

    from flnerf_tpu_torch.core.metrics import compute_ssim, lpips_fn
    from flnerf_tpu_torch.data.png import imread

    parser = argparse.ArgumentParser()
    parser.add_argument("render_dir", type=str)
    parser.add_argument("gt_dir", type=str)
    args = parser.parse_args(argv)

    def list_imgs(d):
        return sorted(
            os.path.join(d, f)
            for f in os.listdir(d)
            if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )

    renders = list_imgs(args.render_dir)
    gts = list_imgs(args.gt_dir)
    if len(renders) != len(gts):
        raise ValueError(f"{len(renders)} renders against {len(gts)} ground-truth images")
    lp = lpips_fn()

    psnrs, ssims, lpipss = [], [], []
    for rf, gf in zip(renders, gts):
        r = imread(rf)[..., :3].astype(np.float32) / 255.0
        g = imread(gf)[..., :3].astype(np.float32) / 255.0
        mse = float(np.mean((r - g) ** 2))
        psnrs.append(-10.0 * np.log10(max(mse, 1e-12)))
        ssims.append(float(compute_ssim(torch.from_numpy(g), torch.from_numpy(r))))
        lpipss.append(lp(g, r) if lp else float("nan"))

    print(f"PSNR: {np.mean(psnrs)}")
    print(f"SSIM: {np.mean(ssims)}")
    print(f"LPIPS: {np.nanmean(lpipss)}")
    return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}


if __name__ == "__main__":
    main()

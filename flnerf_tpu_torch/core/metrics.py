"""Image-quality metrics: MSE/PSNR and tf-compatible SSIM.

Port of ``flnerf_tpu/core/metrics.py`` in torch:
  * img2mse / mse2psnr  — nerf-ours/run_nerf_helpers.py:9-10
  * compute_ssim (tf.image.ssim clone) — nerf-ours/run_nerf_helpers.py:158-234:
    separable 11-tap Gaussian window (sigma 1.5), zero 'same' padding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse) -> torch.Tensor:
    mse = torch.as_tensor(mse, dtype=torch.float32)
    return -10.0 * torch.log(torch.clamp(mse, min=1e-12)) / math.log(10.0)


def _gaussian_filter1d(filter_size: int, filter_sigma: float, device) -> torch.Tensor:
    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((torch.arange(filter_size, device=device) - hw + shift)
           / filter_sigma) ** 2
    filt = torch.exp(-0.5 * f_i)
    return filt / torch.sum(filt)


def compute_ssim(
    img0: torch.Tensor,
    img1: torch.Tensor,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    return_map: bool = False,
):
    """SSIM modeled after tf.image.ssim.

    Args:
      img0, img1: [H, W, C] images in [0, max_val].
    Returns:
      scalar mean SSIM (or the [H, W, C] map when ``return_map``).
    """
    img0 = img0.float()
    img1 = img1.float()
    filt = _gaussian_filter1d(filter_size, filter_sigma, img0.device)
    hw = filter_size // 2

    def blur(img):  # [H, W, C] -> [H, W, C], separable gaussian, SAME padding
        x = img.permute(2, 0, 1)[:, None]                   # [C, 1, H, W]
        x = F.conv2d(x, filt.reshape(1, 1, filter_size, 1), padding=(hw, 0))
        x = F.conv2d(x, filt.reshape(1, 1, 1, filter_size), padding=(0, hw))
        return x[:, 0].permute(1, 2, 0)

    mu0 = blur(img0)
    mu1 = blur(img1)
    mu00 = mu0 * mu0
    mu11 = mu1 * mu1
    mu01 = mu0 * mu1
    sigma00 = torch.clamp(blur(img0 ** 2) - mu00, min=0.0)
    sigma11 = torch.clamp(blur(img1 ** 2) - mu11, min=0.0)
    sigma01 = blur(img0 * img1) - mu01
    sigma01 = torch.sign(sigma01) * torch.minimum(
        torch.sqrt(sigma00 * sigma11), torch.abs(sigma01))

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else torch.mean(ssim_map)

"""Training losses (ngp-ours/loss.py parity).

Port of ``flnerf_tpu/core/losses.py``:
  * mape_loss (loss.py:7-15), the SDF trainer's loss;
  * huber_loss (loss.py:18-27), the NGP trainer's ``loss_type="huber"``;
  * eff_distloss (loss.py:30-76): the O(N) mip-NeRF-360 distortion loss of
    "Efficient distortion loss" (weights w at midpoints m with interval
    lengths dt):  L = sum_i sum_j w_i w_j |m_i - m_j| + (1/3) sum_i w_i^2 dt_i
    computed with prefix sums instead of the O(N^2) pairwise form.
"""

from __future__ import annotations

import torch


def mape_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean absolute percentage error, |pred - gt| / (|gt| + 1e-2)
    (loss.py:7-15)."""
    return torch.mean(torch.abs(pred - gt) / (torch.abs(gt) + 1e-2))


def huber_loss(pred: torch.Tensor, gt: torch.Tensor, delta: float = 0.1,
               reduce: bool = True) -> torch.Tensor:
    """Quadratic near zero, linear beyond delta (loss.py:18-27)."""
    err = torch.abs(pred - gt)
    loss = torch.where(err < delta, 0.5 * err ** 2 / delta, err - 0.5 * delta)
    return torch.mean(loss) if reduce else loss


def eff_distloss(w: torch.Tensor, m: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """O(N) distortion loss of w, m, dt [..., N] (m ascending on the last
    axis): for ascending m, sum_{i>j} w_i w_j (m_i - m_j) = sum_i w_i (m_i
    csum(w)_{<i} - csum(w m)_{<i})."""
    cw = torch.cumsum(w, -1)
    cwm = torch.cumsum(w * m, -1)
    cw_prev = torch.cat([torch.zeros_like(cw[..., :1]), cw[..., :-1]], -1)
    cwm_prev = torch.cat([torch.zeros_like(cwm[..., :1]), cwm[..., :-1]], -1)
    pairwise = torch.sum(w * (m * cw_prev - cwm_prev), -1)
    self_term = torch.sum(w ** 2 * dt, -1) / 3.0
    return torch.mean(2.0 * pairwise + self_term)

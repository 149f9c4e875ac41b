"""Training losses (ngp-ours/loss.py parity).

Port of ``flnerf_tpu/core/losses.py``: ``huber_loss`` (loss.py:18-27), the
NGP trainer's ``loss_type="huber"``.
"""

from __future__ import annotations

import torch


def huber_loss(pred: torch.Tensor, gt: torch.Tensor, delta: float = 0.1,
               reduce: bool = True) -> torch.Tensor:
    """Quadratic near zero, linear beyond delta (loss.py:18-27)."""
    err = torch.abs(pred - gt)
    loss = torch.where(err < delta, 0.5 * err ** 2 / delta, err - 0.5 * delta)
    return torch.mean(loss) if reduce else loss

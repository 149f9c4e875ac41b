"""Custom activations.

Port of ``flnerf_tpu/ops/activations.py``.  ``trunc_exp`` (parity target
ngp-ours/activation.py:5-18): forward exp(x), backward
grad * exp(clamp(x, -15, 15)).  The clamp keeps the density gradient bounded
during the early high-LR phase of Instant-NGP training.
"""

from __future__ import annotations

import torch


class TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return TruncExp.apply(x)

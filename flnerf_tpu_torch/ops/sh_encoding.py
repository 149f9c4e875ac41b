"""Real spherical-harmonics direction encoding, degree <= 4 (closed form).

Port of ``flnerf_tpu/ops/sh_encoding.py`` in torch.  The constants are the
standard real spherical harmonics (same table as plenoxels' eval_sh_bases,
svox2/utils.py:115).  Plenoxels uses degree 3 (9 basis functions).
"""

from __future__ import annotations

import torch


def sh_encode(d: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Encode unit directions [..., 3] -> [..., degree**2]."""
    if not 1 <= degree <= 4:
        raise ValueError(f"sh_encode supports degree 1..4, got {degree}")
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full_like(x, 0.28209479177387814)]  # l=0
    if degree > 1:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree > 2:
        xy, yz, xz = x * y, y * z, x * z
        x2, y2, z2 = x * x, y * y, z * z
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (x2 - y2),
        ]
    if degree > 3:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return torch.stack(out, dim=-1)

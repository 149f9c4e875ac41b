"""The seeded start that the program and the reference both train from.

A fresh field is the same everywhere (a flat Plenoxels density of
``init_sigma``; NGP's tables at 1e-4, so sigma is about 1), and no
empty-space skip drops a sample in its first steps.  The start here is the
configuration's own initial state, carved: space outside a ball around the
scene and outside ``blobs`` small balls, whose centres the seed draws, is
empty.  So K1/K2's 8^3-block skip and NGP's occupancy march drop samples
from the first checked step on, as they do on a trained field.  The
configuration's ``start`` gives the sizes; the centres come from a
``torch.Generator`` on the device, and both sides get the same tensors.
Imports nothing of the program.
"""

from __future__ import annotations

import torch


def _centres(start: dict, seed: int, device) -> torch.Tensor:
    """[blobs, 3] centres, uniform in [-extent, extent]^3."""
    gen = torch.Generator(device=device).manual_seed(seed + 7919)
    u = torch.rand((start["blobs"], 3), generator=gen, device=device)
    return (u * 2.0 - 1.0) * start["extent"]


def kept(xyz: torch.Tensor, start: dict, seed: int) -> torch.Tensor:
    """Bool [...]: world points [..., 3] that the carve leaves occupied."""
    keep = torch.linalg.vector_norm(xyz, dim=-1) <= start["ball"]
    for c in _centres(start, seed, xyz.device):
        keep |= torch.linalg.vector_norm(xyz - c, dim=-1) <= start["blob_radius"]
    return keep


def plenoxels_density(reso, radius, init_sigma: float, start: dict, seed: int,
                      device) -> torch.Tensor:
    """[X, Y, Z] density: ``init_sigma`` in the kept cells, ``start['empty']``
    elsewhere.  Cell i of an axis lies at (i + 0.5 - reso / 2) / (reso / 2r)
    in the world (the render's grid transform)."""
    axes = [(torch.arange(n, device=device, dtype=torch.float32) + 0.5 - 0.5 * n) * (r / (0.5 * n))
            for n, r in zip(reso, radius)]
    xyz = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    return torch.where(kept(xyz, start, seed), torch.tensor(float(init_sigma), device=device),
                       torch.tensor(float(start["empty"]), device=device))


def carve_ngp(leaves: list, scale0: float, side0: int, bound: float, start: dict,
              seed: int) -> None:
    """Carve an NGP field's leaves in place: level 0's first feature holds
    the log-density, 0 where kept and ``start['empty']`` elsewhere, at each
    vertex of its dense lattice (vertex i at x01 = (i - 0.5) / scale0), and
    two hidden units of the sigma net pass it to sigma's logit alone:
    h0 = relu(f) - relu(-f).  Every other weight keeps its draw.  ``leaves``
    are [small [Ls, T, 2], big, sigma layer 1 [in, hidden], sigma layer 2
    [hidden, 1 + geo], colour layers]."""
    small, w1, w2 = leaves[0], leaves[2], leaves[3]
    dev = small.device
    ax = ((torch.arange(side0, device=dev, dtype=torch.float32) - 0.5) / scale0 * 2.0 - 1.0) * bound
    xyz = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
    # the dense index x + S (y + S z): x fastest
    logd = torch.where(kept(xyz, start, seed), 0.0, float(start["empty"]))
    with torch.no_grad():
        small[0, :side0 ** 3, 0] = logd.permute(2, 1, 0).reshape(-1)
        w1[0, :] = 0.0
        w1[:, :2] = 0.0
        w1[0, 0], w1[0, 1] = 1.0, -1.0
        w2[:2, :] = 0.0
        w2[0, 0], w2[1, 0] = 1.0, -1.0

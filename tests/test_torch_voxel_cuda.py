"""The cuvol CUDA kernels (flnerf_tpu_torch/ops/csrc/voxel_cuvol.cu) against
their plain version (models/voxel_sh.voxel_render_rays with autograd) on the
card.  Skips without a CUDA device: the kernels have no CPU mode.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_voxel_cuda.py
"""

import numpy as np
import pytest
import torch

from flnerf_tpu_torch.models import voxel_sh as vs
from flnerf_tpu_torch.ops import voxel_kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cuvol kernels have no CPU mode")
    return torch.device("cuda")


def _scene(device, reso=32, n=256, seed=0):
    rng = np.random.default_rng(seed)
    shape = (reso,) * 3
    grid = vs.VoxelGrid(
        torch.tensor(rng.random(shape) * 2.0, dtype=torch.float32, device=device),
        torch.tensor(rng.standard_normal(shape + (27,)) * 0.3, dtype=torch.float32,
                     device=device),
        torch.tensor(rng.random(shape) > 0.1, device=device))
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    d = u + 0.3 * rng.standard_normal((n, 3))
    o = -2.5 * u
    # an axis-parallel miss and a ray starting inside the grid
    o[:2] = [[2.0, 0.0, -3.0], [0.1, 0.2, 0.3]]
    d[:2] = [[0.0, 0.0, 1.0], [0.3, -0.2, 1.0]]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cfg = vs.VoxelGridConfig(reso=shape, max_steps=int(3.5 * reso / 0.5), step_size=0.5)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return grid, t(o), t(d), cfg


def _render_and_grad(fn, grid, gt):
    dens = grid.density.clone().requires_grad_(True)
    sh = grid.sh.clone().requires_grad_(True)
    out = fn(vs.VoxelGrid(dens, sh, grid.alive))
    loss = torch.mean((out["rgb"] - gt) ** 2) + 0.1 * torch.sum(out["log_t"])
    return out, torch.autograd.grad(loss, [dens, sh])


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_thresh", [1e-8, 0.5])
def test_kernels_match_plain_version_on_card(cuda, sigma_thresh):
    grid, o, d, cfg = _scene(cuda)
    cfg = cfg._replace(sigma_thresh=sigma_thresh)
    gt = torch.rand((o.shape[0], 3), device=cuda)

    def fused(gr):
        out = voxel_kernel.render_rays_fused(gr, o, d, cfg)
        return {"rgb": out[:, :3], "depth": out[:, 3], "log_t": out[:, 4], "acc": out[:, 5]}

    before = voxel_kernel.FWD_LAUNCHES, voxel_kernel.BWD_LAUNCHES
    out_k, (gd_k, gs_k) = _render_and_grad(fused, grid, gt)
    torch.cuda.synchronize()
    assert (voxel_kernel.FWD_LAUNCHES, voxel_kernel.BWD_LAUNCHES) == (before[0] + 1,
                                                                      before[1] + 1)
    out_p, (gd_p, gs_p) = _render_and_grad(
        lambda gr: vs.voxel_render_rays(gr, o, d, cfg), grid, gt)
    # f32 on both sides; the kernels sum in another order
    for k, tol in (("rgb", 1e-4), ("acc", 1e-4), ("log_t", 1e-4), ("depth", 1e-2)):
        torch.testing.assert_close(out_k[k], out_p[k], atol=tol, rtol=0)
    # atomics reorder the gradient sums: within 1e-4 of the largest entry
    for a, b in ((gd_k, gd_p), (gs_k, gs_p)):
        assert float(b.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        assert float(a[~grid.alive].abs().max()) == 0.0   # pruned: zero gradient


@pytest.mark.cuda
def test_backward_adds_into_given_gradients(cuda):
    grid, o, d, cfg = _scene(cuda, n=64)
    rays = voxel_kernel.ray_inputs(cfg, o, d)
    out = voxel_kernel.cuvol_forward(*grid, *rays, cfg)
    grad_out = torch.rand_like(out)
    gd, gs = voxel_kernel.cuvol_backward(*grid, *rays, out, grad_out, cfg)
    grads = (torch.ones_like(gd), torch.ones_like(gs))
    added = voxel_kernel.cuvol_backward(*grid, *rays, out, grad_out, cfg, grads=grads)
    assert added[0] is grads[0] and added[1] is grads[1]
    # atomics reorder the sums: within 1e-6 of the largest entry
    for a, b in ((grads[0], gd + 1.0), (grads[1], gs + 1.0)):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    with pytest.raises(ValueError, match="grad_sh"):
        voxel_kernel.cuvol_backward(*grid, *rays, out, grad_out, cfg,
                                    grads=(grads[0], grads[1][..., :9].contiguous()))


@pytest.mark.cuda
def test_kernel_wrappers_check_their_inputs(cuda):
    grid, o, d, cfg = _scene(cuda, n=8)
    rays = voxel_kernel.ray_inputs(cfg, o, d)
    with pytest.raises(ValueError, match="dtype"):
        voxel_kernel.cuvol_forward(grid.density.double(), grid.sh, grid.alive, *rays, cfg)
    with pytest.raises(ValueError, match="shape"):
        voxel_kernel.cuvol_forward(grid.density, grid.sh[..., :9].contiguous(), grid.alive,
                                   *rays, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        voxel_kernel.cuvol_forward(grid.density.transpose(0, 1), grid.sh, grid.alive,
                                   *rays, cfg)
    empty = voxel_kernel.ray_inputs(cfg, o[:0], d[:0])
    assert voxel_kernel.cuvol_forward(*grid, *empty, cfg).shape == (0, 8)

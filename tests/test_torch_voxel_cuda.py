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
    # the forward's occupancy passed in, as RenderFused passes it
    occ = voxel_kernel.skip_occupancy(grid.density, grid.alive, cfg)
    grads = (torch.ones_like(gd), torch.ones_like(gs))
    voxel_kernel.cuvol_backward(*grid, *rays, out, grad_out, cfg, grads=grads, occ=occ)
    for a, b in ((grads[0], gd + 1.0), (grads[1], gs + 1.0)):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    with pytest.raises(ValueError, match="sigma_thresh"):
        voxel_kernel.cuvol_backward(*grid, *rays, out, grad_out, cfg._replace(sigma_thresh=0.0),
                                    occ=occ)
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


def _shaped_grid(kind, device, reso=64, seed=0):
    """Grids for K1's empty-space skip: the filled sphere of chip_smoke.py
    phase 2, one occupied cell at an 8^3 block corner, a thin shell, and
    an empty grid (negative and zero densities, ~10% of cells pruned)."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (reso,) * 3
    idx = (torch.arange(reso, device=device, dtype=torch.float32) - (reso - 1) / 2) / (reso / 2)
    x, y, z = torch.meshgrid(idx, idx, idx, indexing="ij")
    r = torch.sqrt(x * x + y * y + z * z)
    density = -torch.rand(shape, generator=g, device=device)
    density[torch.rand(shape, generator=g, device=device) < 0.3] = 0.0
    if kind == "sphere":
        density = torch.where(r < 0.55, 2.0 * torch.rand(shape, generator=g, device=device), 0.0)
    elif kind == "block corner cell":
        density[31, 32, 24] = 50.0          # the corner of four 8^3 blocks
    elif kind == "thin shell":
        shell = (r > 0.6) & (r < 0.62)
        density = torch.where(shell, 5.0 * torch.rand(shape, generator=g, device=device),
                              density)
    sh = 0.3 * torch.randn(shape + (27,), generator=g, device=device)
    alive = torch.rand(shape, generator=g, device=device) > 0.1
    if kind == "block corner cell":
        alive[31, 32, 24] = True
    return vs.VoxelGrid(density.contiguous(), sh, alive)


def _sphere_rays(device, n, reso=64, seed=1):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    d = -u + 0.35 * rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return t(2.5 * u), t(d)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sphere", "block corner cell", "thin shell", "empty"])
@pytest.mark.parametrize("sigma_thresh", [1e-8, 0.5, 0.0])
@pytest.mark.parametrize("n", [777, 1])
def test_skip_is_bitwise_the_replaced_kernel(cuda, kind, sigma_thresh, n):
    """K1 (skip, density first) against the kernel it replaced, kept by
    tools/voxel_probe.py: equal bit for bit, every probe variant too; and
    within the tolerance of the plain version.  sigma_thresh 0 skips
    nothing; the empty grid renders the background with log-T 0."""
    from flnerf_tpu_torch.tools import voxel_probe
    grid = _shaped_grid(kind, cuda)
    o, d = _sphere_rays(cuda, n)
    cfg = vs.VoxelGridConfig(reso=(64,) * 3, max_steps=int(3.5 * 64 / 0.5), step_size=0.5,
                             sigma_thresh=sigma_thresh)
    ray_in = voxel_kernel.ray_inputs(cfg, o, d)
    before = voxel_kernel.FWD_LAUNCHES
    got = voxel_kernel.cuvol_forward(*grid, *ray_in, cfg)
    assert voxel_kernel.FWD_LAUNCHES == before + 1
    occ = voxel_kernel.skip_occupancy(grid.density, grid.alive, cfg)
    assert (occ is None) == (sigma_thresh <= 0)
    want = torch.full_like(got, float("nan"))
    voxel_probe.launch(voxel_probe.REPLACED, grid, ray_in, cfg, None, want)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for name, (_, skip) in voxel_probe.VARIANTS.items():
        if skip and occ is None:
            continue
        out = torch.full_like(got, float("nan"))
        voxel_probe.launch(name, grid, ray_in, cfg, occ, out)
        torch.cuda.synchronize()
        assert torch.equal(out, want), name
    plain = voxel_kernel.render_rays_plain(grid, o, d, cfg)
    for sl, tol in ((slice(0, 3), 1e-4), (slice(4, 6), 1e-4), (slice(3, 4), 1e-2)):
        torch.testing.assert_close(got[:, sl], plain[:, sl], atol=tol, rtol=0)
    if kind == "empty":
        assert not bool(occ.any()) if occ is not None else True
        assert float(got[:, 4].abs().max()) == 0.0 and float(got[:, 5].abs().max()) == 0.0
        torch.testing.assert_close(got[:, :3], torch.ones_like(got[:, :3]), atol=0, rtol=0)
    elif kind == "sphere" and n > 1:
        assert float(got[:, 5].max()) > 0.1


@pytest.mark.cuda
def test_forward_builds_its_occupancy_and_takes_no_rays(cuda):
    """The wrapper's occupancy is the plain one, built on the card; no rays
    launch nothing."""
    grid = _shaped_grid("thin shell", cuda)
    o, d = _sphere_rays(cuda, 64)
    cfg = vs.VoxelGridConfig(reso=(64,) * 3, max_steps=448, step_size=0.5)
    occ = voxel_kernel.skip_occupancy(grid.density, grid.alive, cfg)
    assert occ.shape == (8, 8, 8) and bool(occ.any()) and not bool(occ.all())
    cpu = voxel_kernel.occupancy_blocks(grid.density.cpu(), grid.alive.cpu())
    assert torch.equal(occ.cpu(), cpu)
    before = voxel_kernel.FWD_LAUNCHES
    empty = voxel_kernel.ray_inputs(cfg, o[:0], d[:0])
    assert voxel_kernel.cuvol_forward(*grid, *empty, cfg).shape == (0, 8)
    assert voxel_kernel.FWD_LAUNCHES == before


def _plain_grads(grid, o, d, cfg, grad_out):
    """The plain version's gradients of sum(out * grad_out), by autograd."""
    dens = grid.density.clone().requires_grad_(True)
    sh = grid.sh.clone().requires_grad_(True)
    out = voxel_kernel.render_rays_plain(vs.VoxelGrid(dens, sh, grid.alive), o, d, cfg)
    return torch.autograd.grad(out, [dens, sh], grad_out)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sphere", "block corner cell", "thin shell", "empty"])
@pytest.mark.parametrize("sigma_thresh", [1e-8, 0.5, 0.0])
@pytest.mark.parametrize("n", [777, 1])
def test_backward_is_the_replaced_kernel(cuda, kind, sigma_thresh, n):
    """K2 (the forward's occupancy, density first) against the kernel it
    replaced, kept by tools/voxel_probe.py: within 1e-5 of the largest entry
    (atomics from many rays add in any order), every probe variant too; bit
    for bit, every variant without a merge, on a single ray (one warp's
    atomics apply in program order); within 1e-4 of the plain version's
    gradient; exactly zero on pruned cells, and everywhere on the empty
    grid."""
    from flnerf_tpu_torch.tools import voxel_probe
    grid = _shaped_grid(kind, cuda)
    o, d = _sphere_rays(cuda, n)
    cfg = vs.VoxelGridConfig(reso=(64,) * 3, max_steps=int(3.5 * 64 / 0.5), step_size=0.5,
                             sigma_thresh=sigma_thresh)
    ray_in = voxel_kernel.ray_inputs(cfg, o, d)
    occ = voxel_kernel.skip_occupancy(grid.density, grid.alive, cfg)
    out = voxel_kernel.cuvol_forward(*grid, *ray_in, cfg, occ=occ)
    g = torch.Generator(device=cuda).manual_seed(n)
    grad_out = torch.randn((n, 8), generator=g, device=cuda)
    grad_out[:, 3] = 0.0          # K2 reads channels 0:3 and 4 (rgb and log-T) only
    grad_out[:, 5:] = 0.0
    before = voxel_kernel.BWD_LAUNCHES
    got = voxel_kernel.cuvol_backward(*grid, *ray_in, out, grad_out, cfg, occ=occ)
    assert voxel_kernel.BWD_LAUNCHES == before + 1
    zeros = lambda: (torch.zeros_like(grid.density), torch.zeros_like(grid.sh))
    want = zeros()
    voxel_probe.launch_backward(voxel_probe.REPLACED_K2_NAME, grid, ray_in, cfg, None, out,
                                grad_out, want)
    torch.cuda.synchronize()
    assert voxel_probe.backward_error(got, want) <= 1e-5
    for name, (t, skip) in voxel_probe.k2_variants().items():
        if (t is not None and not t[3]) or (skip and occ is None):   # no atomics, no skip
            continue
        var = zeros()
        voxel_probe.launch_backward(name, grid, ray_in, cfg, occ, out, grad_out, var)
        torch.cuda.synchronize()
        assert voxel_probe.backward_error(var, want) <= 1e-5, name
        if n == 1 and t is not None and not t[2]:   # no merge: the replaced kernel's order
            assert torch.equal(var[0], want[0]) and torch.equal(var[1], want[1]), name
    plain = _plain_grads(grid, o, d, cfg, grad_out)
    for a, b in zip(got, plain):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-30)
        assert float(a[~grid.alive].abs().max()) == 0.0   # pruned: exactly zero
    if kind == "empty":
        assert float(got[0].abs().max()) == 0.0 and float(got[1].abs().max()) == 0.0
    elif n > 1:
        assert float(got[1].abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_thresh", [1e-8, 0.0])
def test_backward_of_a_zero_upstream_gradient_is_exactly_zero(cuda, sigma_thresh):
    grid = _shaped_grid("sphere", cuda)
    o, d = _sphere_rays(cuda, 300)
    cfg = vs.VoxelGridConfig(reso=(64,) * 3, max_steps=448, step_size=0.5,
                             sigma_thresh=sigma_thresh)
    ray_in = voxel_kernel.ray_inputs(cfg, o, d)
    out = voxel_kernel.cuvol_forward(*grid, *ray_in, cfg)
    gd, gs = voxel_kernel.cuvol_backward(*grid, *ray_in, out, torch.zeros_like(out), cfg)
    torch.cuda.synchronize()
    assert float(gd.abs().max()) == 0.0 and float(gs.abs().max()) == 0.0
    empty = voxel_kernel.ray_inputs(cfg, o[:0], d[:0])
    before = voxel_kernel.BWD_LAUNCHES
    gd, _ = voxel_kernel.cuvol_backward(*grid, *empty, out[:0], out[:0], cfg)
    assert voxel_kernel.BWD_LAUNCHES == before and float(gd.abs().max()) == 0.0


@pytest.mark.cuda
def test_render_builds_one_occupancy_for_forward_and_backward(cuda, monkeypatch):
    """RenderFused builds the occupancy once, in the forward, and K2 skips
    by that one: no second build in the backward."""
    calls = []
    build = voxel_kernel.occupancy_blocks

    def counted(density, alive):
        calls.append(1)
        return build(density, alive)

    monkeypatch.setattr(voxel_kernel, "occupancy_blocks", counted)
    grid = _shaped_grid("thin shell", cuda)
    o, d = _sphere_rays(cuda, 64)
    cfg = vs.VoxelGridConfig(reso=(64,) * 3, max_steps=448, step_size=0.5)
    dens = grid.density.clone().requires_grad_(True)
    sh = grid.sh.clone().requires_grad_(True)
    before = voxel_kernel.FWD_LAUNCHES, voxel_kernel.BWD_LAUNCHES
    out = voxel_kernel.render_rays_fused(vs.VoxelGrid(dens, sh, grid.alive), o, d, cfg)
    assert len(calls) == 1
    gd, gs = torch.autograd.grad(out[:, :3].sum() + out[:, 4].sum(), [dens, sh])
    torch.cuda.synchronize()
    assert len(calls) == 1
    assert (voxel_kernel.FWD_LAUNCHES, voxel_kernel.BWD_LAUNCHES) == (before[0] + 1,
                                                                      before[1] + 1)
    assert float(gs.abs().max()) > 0

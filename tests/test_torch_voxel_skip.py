"""K1's empty-space skip (flnerf_tpu_torch/ops/voxel_kernel.py, the plain
versions of the skip in csrc/voxel_cuvol.cu) on small grids, on the CPU.

The occupancy of 8^3 blocks of floor cells, the skip predicate, the step
jump and the march that uses them are held against brute force, against
the reference package's own 8^3 occupancy (``occupancy_mip``, which the
port's must cover), and against ``models/voxel_sh.voxel_render_rays``: no
skipped step has sigma >= sigma_thresh under its arithmetic, and the plain
render with the skip equals the render without it bit for bit.  Grids hold
sparse occupied cells on block faces, edges and corners, negative
densities and dead cells; rays graze block planes, cross block corners and
are clipped at the grid's edges."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from flnerf_tpu.models import voxel_sh as vs_ref
from flnerf_tpu.ops import voxel_pallas as vp_ref
from flnerf_tpu_torch.models import voxel_sh as vs
from flnerf_tpu_torch.ops import voxel_kernel as vk

torch.set_num_threads(1)

# occupied cells on block faces, edges and corners of the 8^3 blocks, and
# the grid's own faces and corners
BOUNDARY_CELLS = [(7, 7, 7), (8, 8, 8), (7, 8, 3), (8, 2, 15), (0, 0, 0), (15, 15, 15),
                  (16, 7, 8), (23, 23, 23), (0, 31, 16), (8, 0, 24), (24, 16, 31)]


def _grid(reso, seed, occupied, p_dead=0.1, high=3.0):
    """Negative densities everywhere (they must not mark a block) but at
    ``occupied``, where they are ``high``; ~``p_dead`` of cells pruned (an
    occupied cell may be dead: it then marks nothing)."""
    rng = np.random.default_rng(seed)
    density = -np.abs(rng.standard_normal(reso)).astype(np.float32) - 0.01
    density[rng.random(reso) < 0.3] = 0.0
    for c in occupied:
        if all(0 <= c[a] < reso[a] for a in range(3)):
            density[c] = high
    sh = (rng.standard_normal(reso + (27,)) * 0.3).astype(np.float32)
    alive = rng.random(reso) > p_dead
    return vs.VoxelGrid(torch.from_numpy(density), torch.from_numpy(sh),
                        torch.from_numpy(alive))


def _cfg(reso, sigma_thresh=1e-8):
    return vs.VoxelGridConfig(reso=reso, max_steps=int(3.5 * max(reso) / 0.5),
                              step_size=0.5, sigma_thresh=sigma_thresh)


def _world(reso, grid_pts):
    """World points of grid-space points (the inverse of world2grid at
    radius 1, center 0)."""
    r = np.asarray(reso, np.float64)
    return ((np.asarray(grid_pts, np.float64) + 0.5 - r / 2) / (r / 2)).astype(np.float32)


def _rays(reso, seed, n=160):
    """World rays: random ones through the grid, axis-parallel ones along
    block planes (grid coordinates 8, 16, 7.5), diagonals through block
    corners, and rays starting inside the grid near its edges."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    d = u + 0.4 * rng.standard_normal((n, 3))
    o = -2.5 * u
    planes = [8.0, 16.0, 7.5, 8.0 - 1e-3]
    graze_o, graze_d = [], []
    for a in range(3):
        for p in planes:
            g = np.array([-3.0, 0.0, 0.0])
            g[a] = -3.0
            g[(a + 1) % 3] = p
            g[(a + 2) % 3] = planes[(planes.index(p) + 1) % len(planes)]
            dd = np.zeros(3)
            dd[a] = 1.0
            graze_o.append(g)
            graze_d.append(dd)
    for c in (8.0, 16.0):                           # through block corners
        graze_o.append([c - 5.0, c - 5.0, c - 5.0])
        graze_d.append([1.0, 1.0, 1.0])
        graze_o.append([c + 5.0, c - 5.0, c + 5.0])
        graze_d.append([-1.0, 1.0, -1.0])
    hi = np.asarray(reso, np.float64) - 1.0
    for k in range(6):                              # inside the grid, near its edges
        graze_o.append([0.2, hi[1] - 0.3, 0.5 * hi[2]] if k % 2 else [hi[0] - 0.1, 0.4, 0.1])
        graze_d.append(rng.standard_normal(3))
    o = np.concatenate([o, _world(reso, graze_o)]).astype(np.float32)
    d = np.concatenate([d, np.asarray(graze_d)]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


def _occupancy_brute(density, alive):
    occ = (alive & (density > 0)).numpy()
    x, y, z = occ.shape
    out = np.zeros(vk.occupancy_shape(occ.shape), bool)
    for l in np.ndindex(x - 1, y - 1, z - 1):
        if occ[l[0]:l[0] + 2, l[1]:l[1] + 2, l[2]:l[2] + 2].any():
            out[l[0] // 8, l[1] // 8, l[2] // 8] = True
    return out


def _sample_sigma(grid, cfg, origins, dirs, tmin):
    """Every step's relu'd sigma under voxel_render_rays' own arithmetic."""
    steps = torch.arange(cfg.max_steps)
    ts = tmin[:, None] + cfg.step_size * steps[None, :]
    pos = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
    sigma, _ = vs.trilinear_sample(grid, pos, cfg)
    return torch.relu(sigma)


@pytest.mark.parametrize("reso", [(16, 16, 16), (32, 32, 32), (17, 24, 9), (25, 18, 32),
                                  (9, 2, 13)])
def test_occupancy_blocks_match_brute_force(reso):
    grid = _grid(reso, 1, BOUNDARY_CELLS)
    got = vk.occupancy_blocks(grid.density, grid.alive)
    assert got.dtype == torch.bool and tuple(got.shape) == vk.occupancy_shape(reso)
    assert np.array_equal(got.numpy(), _occupancy_brute(grid.density, grid.alive))


def test_occupancy_covers_the_reference_mip():
    """Every 8^3 block the reference's occupancy_mip marks (a cell alive
    with density >= sigma_thresh) is marked here too."""
    reso = (32, 32, 32)
    grid = _grid(reso, 2, BOUNDARY_CELLS, p_dead=0.3)
    cfg = vs_ref.VoxelGridConfig(reso=reso)
    ref = vs_ref.VoxelGrid(grid.density.numpy(), grid.sh.numpy(), grid.alive.numpy())
    mip = np.asarray(vp_ref.occupancy_mip(ref, cfg))
    ours = vk.occupancy_blocks(grid.density, grid.alive).numpy()
    assert mip.shape == ours.shape and mip.any()
    assert not (mip & ~ours).any()


def test_skip_occupancy_only_with_a_positive_threshold():
    grid = _grid((16, 16, 16), 0, BOUNDARY_CELLS)
    assert vk.skip_occupancy(grid.density, grid.alive, _cfg((16, 16, 16))) is not None
    for thresh in (0.0, -1.0):
        cfg = _cfg((16, 16, 16), sigma_thresh=thresh)
        assert not vk.skips(cfg)
        assert vk.skip_occupancy(grid.density, grid.alive, cfg) is None
    assert not vk.skips(_cfg((16, 1, 16)))


@pytest.mark.parametrize("reso,seed", [((16, 16, 16), 0), ((32, 32, 32), 1), ((17, 24, 9), 2)])
def test_leave_block_is_the_first_step_out_of_the_block(reso, seed):
    """From every marched step, the jump lands on the first later step
    whose floor cell leaves the step's block or that is past the march."""
    cfg = _cfg(reso)
    o, d = _rays(reso, seed, n=64)
    origins, dirs, tmin, tmax, _, _ = vs.grid_ray_setup(cfg, o, d)
    steps = torch.arange(cfg.max_steps)
    ts = vk._step_t(tmin[:, None], steps[None, :], cfg)
    blocks = vk._floor_cells(origins, dirs, ts, cfg) // 8                 # [N, S, 3]
    ray, j = torch.nonzero(ts <= tmax[:, None], as_tuple=True)
    got = vk.leave_block(blocks[ray, j], j, cfg, origins[ray], dirs[ray], tmin[ray], tmax[ray])
    # brute force: the first k > j out of the block or past the march
    out = (blocks[ray] != blocks[ray, j][:, None, :]).any(-1) | (ts[ray] > tmax[ray, None])
    out = torch.cat([out, torch.ones((out.shape[0], 1), dtype=torch.bool)], 1)
    want = torch.argmax((out & (torch.arange(cfg.max_steps + 1)[None, :] > j[:, None])).int(), 1)
    assert torch.equal(got, want)


def _check_skip(grid, cfg, o, d):
    """The skip's three promises on one grid and batch; returns the number
    of skipped marched steps."""
    origins, dirs, tmin, tmax, _, _ = vs.grid_ray_setup(cfg, o, d)
    occ = vk.occupancy_blocks(grid.density, grid.alive)
    skipped = vk.skipped_steps(occ, cfg, origins, dirs, tmin, tmax)
    sigma = _sample_sigma(grid, cfg, origins, dirs, tmin)
    # no skipped step would pass the gate: its sigma is exactly 0
    assert not bool((skipped & (sigma >= cfg.sigma_thresh)).any())
    assert not bool(sigma[skipped].any())
    # the march with its jumps reads exactly the marched steps in marked blocks
    steps = torch.arange(cfg.max_steps)
    valid = vk._step_t(tmin[:, None], steps[None, :], cfg) <= tmax[:, None]
    marched = vk.marched_steps(occ, cfg, origins, dirs, tmin, tmax)
    assert torch.equal(marched, valid & ~skipped)
    # the render with the skip is the render without it, bit for bit
    with_skip = vk.render_rays_skip_plain(grid, o, d, cfg)
    without = vs.voxel_render_rays(grid, o, d, cfg)
    for k in ("rgb", "depth", "acc", "log_t", "weights"):
        assert torch.equal(with_skip[k], without[k]), k
    return int(skipped.sum()), float(without["acc"].max())


@pytest.mark.parametrize("reso,seed,thresh", [((16, 16, 16), 0, 1e-8), ((32, 32, 32), 1, 1e-8),
                                              ((32, 32, 32), 3, 0.5), ((17, 24, 9), 2, 1e-8),
                                              ((25, 18, 32), 4, 1e-8)])
def test_skip_drops_only_samples_that_add_nothing(reso, seed, thresh):
    grid = _grid(reso, seed, BOUNDARY_CELLS)
    n_skipped, acc = _check_skip(grid, _cfg(reso, thresh), *_rays(reso, seed))
    assert n_skipped > 0 and acc > 0.01


def test_skip_render_without_occupancy_is_the_plain_render():
    """sigma_thresh 0: nothing is skipped, the march is the plain one."""
    reso = (16, 16, 16)
    grid = _grid(reso, 5, BOUNDARY_CELLS)
    cfg = _cfg(reso, 0.0)
    o, d = _rays(reso, 5, n=32)
    a, b = vk.render_rays_skip_plain(grid, o, d, cfg), vs.voxel_render_rays(grid, o, d, cfg)
    for k in b:
        assert torch.equal(a[k], b[k]), k


def test_empty_grid_skips_every_step():
    reso = (16, 16, 16)
    grid = _grid(reso, 6, [])
    cfg = _cfg(reso)
    o, d = _rays(reso, 6, n=32)
    origins, dirs, tmin, tmax, _, _ = vs.grid_ray_setup(cfg, o, d)
    occ = vk.occupancy_blocks(grid.density, grid.alive)
    assert not bool(occ.any())
    assert not bool(vk.marched_steps(occ, cfg, origins, dirs, tmin, tmax).any())
    out = vk.render_rays_skip_plain(grid, o, d, cfg)
    assert float(out["acc"].abs().max()) == 0.0 and float(out["log_t"].abs().max()) == 0.0


@settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(reso=st.tuples(st.integers(9, 32), st.integers(9, 32), st.integers(9, 32)),
       cells=st.lists(st.tuples(st.sampled_from([0, 7, 8, 15, 16, 23, 24, 31]),
                                st.integers(0, 31), st.sampled_from([0, 7, 8, 15, 16, 31])),
                      min_size=0, max_size=6),
       seed=st.integers(0, 2 ** 16), p_dead=st.sampled_from([0.0, 0.1, 0.5]))
def test_skip_on_random_sparse_grids(reso, cells, seed, p_dead):
    """Sparse occupied cells on block planes of random small grids, some of
    them dead: the occupancy against brute force, and the skip's promises."""
    grid = _grid(reso, seed, cells, p_dead=p_dead)
    occ = vk.occupancy_blocks(grid.density, grid.alive)
    assert np.array_equal(occ.numpy(), _occupancy_brute(grid.density, grid.alive))
    _check_skip(grid, _cfg(reso), *_rays(reso, seed, n=48))


def _grads(render, grid, o, d, cfg, g_rgb, g_log_t):
    """Gradients of sum(rgb * g_rgb) + sum(log_t * g_log_t) in density and
    sh, through autograd: an upstream gradient on rgb and on log-T (the
    kernels' channel 4)."""
    dens = grid.density.clone().requires_grad_(True)
    sh = grid.sh.clone().requires_grad_(True)
    out = render(vs.VoxelGrid(dens, sh, grid.alive), o, d, cfg)
    loss = torch.sum(out["rgb"] * g_rgb) + torch.sum(out["log_t"] * g_log_t)
    return torch.autograd.grad(loss, [dens, sh])


@pytest.mark.parametrize("reso,seed,thresh", [((32, 32, 32), 8, 1e-8), ((32, 32, 32), 9, 0.5),
                                              ((25, 18, 32), 4, 1e-8), ((17, 24, 9), 10, 0.5)])
def test_skip_render_has_the_gradients_of_the_plain_render(reso, seed, thresh):
    """What K2's skip rests on: the plain render with the skip has, through
    autograd, the gradients of the render without it, bit for bit (a
    skipped sample's sigma is 0 with a zero relu gradient, and its weight
    0)."""
    grid = _grid(reso, seed, BOUNDARY_CELLS)
    cfg = _cfg(reso, thresh)
    o, d = _rays(reso, seed, n=96)
    rng = np.random.default_rng(seed)
    g_rgb = torch.from_numpy(rng.standard_normal((o.shape[0], 3)).astype(np.float32))
    g_log_t = torch.from_numpy(rng.standard_normal(o.shape[0]).astype(np.float32))
    with_skip = _grads(vk.render_rays_skip_plain, grid, o, d, cfg, g_rgb, g_log_t)
    without = _grads(vs.voxel_render_rays, grid, o, d, cfg, g_rgb, g_log_t)
    for a, b in zip(with_skip, without):
        assert float(b.abs().max()) > 0
        assert torch.equal(a, b)
    # the skip did drop samples here
    origins, dirs, tmin, tmax, _, _ = vs.grid_ray_setup(cfg, o, d)
    occ = vk.occupancy_blocks(grid.density, grid.alive)
    assert bool(vk.skipped_steps(occ, cfg, origins, dirs, tmin, tmax).any())


def _repeated_loop(cells, kept):
    out = np.zeros(kept.shape, bool)
    for i in range(kept.shape[0]):
        prev = None
        for j in range(kept.shape[1]):
            if kept[i, j]:
                out[i, j] = prev is not None and cells[i, j] == prev
                prev = cells[i, j]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_repeated_floor_cells_match_a_loop(seed):
    """The kept samples whose floor cell repeats the previous kept one's
    (what K2's merge folds): random runs of cells and kept masks, with the
    first and last steps kept or not, and a real march's floor cells."""
    rng = np.random.default_rng(seed)
    cells = np.cumsum(rng.random((40, 60)) < 0.4, 1) + 1000 * np.arange(40)[:, None]
    kept = rng.random((40, 60)) < (1.0, 0.3, 0.8)[seed]
    kept[::7] = rng.random((len(kept[::7]), 60)) < 0.5
    got = vk.repeated_floor_cells(torch.from_numpy(cells), torch.from_numpy(kept))
    assert np.array_equal(got.numpy(), _repeated_loop(cells, kept))
    # a march: the floor cells of every step, kept where sigma passes the gate
    reso = (16, 16, 16)
    grid = _grid(reso, seed, BOUNDARY_CELLS)
    cfg = _cfg(reso)
    o, d = _rays(reso, seed, n=32)
    origins, dirs, tmin, tmax, _, _ = vs.grid_ray_setup(cfg, o, d)
    ts = vk._step_t(tmin[:, None], torch.arange(cfg.max_steps)[None, :], cfg)
    fl = vk._floor_cells(origins, dirs, ts, cfg)
    key = (fl[..., 0] * reso[1] + fl[..., 1]) * reso[2] + fl[..., 2]
    kept = (ts <= tmax[:, None]) & (_sample_sigma(grid, cfg, origins, dirs, tmin)
                                    >= cfg.sigma_thresh)
    got = vk.repeated_floor_cells(key, kept)
    want = _repeated_loop(key.numpy(), kept.numpy())
    assert np.array_equal(got.numpy(), want) and want.any()

"""Port parity: the Plenoxels MSI background (flnerf_tpu_torch/models/
voxel_sh.py and the trainer) against the reference package's, on the same
seeded inputs: msi_background and compose_msi_background at L=4, R=16 on
256 rays, their gradients, the background TV and sparsify, the npz layout
both ways, and a 16^3 trainer fit with a background on the plain path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flnerf_tpu.data.synthetic import load_synthetic_data
from flnerf_tpu.models import voxel_sh as vs_ref
from flnerf_tpu.parallel.mesh import replicated
from flnerf_tpu.rays.camera import get_rays_np, intrinsics_matrix
from flnerf_tpu.rays.quadtree import RayBudgeter as RefBudgeter
from flnerf_tpu.train import plenoxels_trainer as ref
from flnerf_tpu_torch.core.convert import (
    plenoxels_extras_to_numpy,
    plenoxels_state_from_numpy,
    plenoxels_state_to_numpy,
    voxel_grid_from_numpy,
    voxel_grid_to_numpy,
)
from flnerf_tpu_torch.models import voxel_sh as vs
from flnerf_tpu_torch.ops.voxel_kernel import render_rays_plain
from flnerf_tpu_torch.rays.quadtree import RayBudgeter
from flnerf_tpu_torch.train import plenoxels_trainer as pt

torch.set_num_threads(1)

L, R, N = 4, 16, 256


def _bg(seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    bg = (rng.standard_normal((2 * R, R, L, 4)) * 0.5).astype(np.float32)
    bg[..., 3] = np.abs(bg[..., 3]) * scale
    return bg


def _rays(seed=1, n=N):
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((n, 3)) * 0.3).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _cfgs(**kw):
    d = dict(reso=(16, 16, 16), radius=(1.0,) * 3, max_steps=64, step_size=0.5,
             background_nlayers=L, background_reso=R)
    d.update(kw)
    return vs.VoxelGridConfig(**d), vs_ref.VoxelGridConfig(**d)


def _grid(seed=2, reso=16, bg=True):
    rng = np.random.default_rng(seed)
    density = (rng.random((reso,) * 3) * 2.0).astype(np.float32)
    sh = (rng.standard_normal((reso,) * 3 + (27,)) * 0.3).astype(np.float32)
    alive = rng.random((reso,) * 3) > 0.1
    return density, sh, alive, (_bg(seed) if bg else None)


def test_config_and_state_fields_match_reference():
    assert vs.VoxelGridConfig._fields == vs_ref.VoxelGridConfig._fields
    assert tuple(vs.VoxelGridConfig()) == tuple(vs_ref.VoxelGridConfig())
    assert vs.VoxelGrid._fields == vs_ref.VoxelGrid._fields
    assert pt.PlenoxelsState._fields == ref.PlenoxelsState._fields
    cfg, cfg_r = _cfgs()
    g, g_r = vs.init_voxel_grid(cfg), vs_ref.init_voxel_grid(cfg_r)
    np.testing.assert_array_equal(g.background.numpy(), np.asarray(g_r.background))


def test_msi_background_matches():
    cfg, cfg_r = _cfgs()
    bg = _bg()
    o, d = _rays()
    rng = np.random.default_rng(4)
    remaining = rng.random(N).astype(np.float32)
    wstep = (0.5 + rng.random(N)).astype(np.float32)
    rgb, t_after = vs.msi_background(torch.tensor(bg), torch.tensor(o), torch.tensor(d),
                                     torch.tensor(remaining), torch.tensor(wstep), cfg)
    rgb_r, t_r = vs_ref.msi_background(jnp.asarray(bg), jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(remaining), jnp.asarray(wstep), cfg_r)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_r), atol=1e-5)
    np.testing.assert_allclose(t_after.numpy(), np.asarray(t_r), atol=1e-5)
    assert float(np.abs(np.asarray(rgb_r)).max()) > 0.1   # the background shows

    # compose on a flat-filled render with its final log-T
    rgb_flat = rng.random((N, 3)).astype(np.float32)
    log_t = np.log(remaining)
    ours = vs.compose_msi_background(torch.tensor(bg), torch.tensor(rgb_flat),
                                     torch.tensor(log_t), torch.tensor(o), torch.tensor(d), cfg)
    theirs = vs_ref.compose_msi_background(jnp.asarray(bg), jnp.asarray(rgb_flat),
                                           jnp.asarray(log_t), jnp.asarray(o), jnp.asarray(d),
                                           cfg_r)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)


@pytest.mark.parametrize("path", ["plain", "kernel_composite"])
def test_render_with_background_and_gradients_match(path):
    """The render with the background, and its gradients into the
    background, density and SH: the plain render composes it inside
    (voxel_render_rays); the kernel path composes it on the kernels'
    output from their final log-T (here their plain version, the CPU's)."""
    cfg, cfg_r = _cfgs()
    density, sh, alive, bg = _grid()
    rng = np.random.default_rng(5)
    o = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (N, 1))
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (N, 1))
    d[:, :2] += (rng.standard_normal((N, 2)) * 0.3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    gt = rng.random((N, 3)).astype(np.float32)

    def loss_ref(dens, s, b):
        g = vs_ref.VoxelGrid(dens, s, jnp.asarray(alive), b)
        return jnp.mean((vs_ref.voxel_render_rays(g, jnp.asarray(o), jnp.asarray(d),
                                                  cfg_r)["rgb"] - gt) ** 2)

    v_r, g_r = jax.value_and_grad(loss_ref, argnums=(0, 1, 2))(
        jnp.asarray(density), jnp.asarray(sh), jnp.asarray(bg))
    leaves = [torch.tensor(a, requires_grad=True) for a in (density, sh, bg)]
    grid = vs.VoxelGrid(leaves[0], leaves[1], torch.tensor(alive), leaves[2])
    ot, dt = torch.tensor(o), torch.tensor(d)
    if path == "plain":
        rgb = vs.voxel_render_rays(grid, ot, dt, cfg)["rgb"]
    else:
        out = render_rays_plain(grid, ot, dt, cfg)
        rgb = vs.compose_msi_background(leaves[2], out[:, 0:3], out[:, 4], ot, dt, cfg)
    loss = torch.mean((rgb - torch.tensor(gt)) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(v_r), rtol=1e-5)
    for ours, theirs in zip(grads, g_r):
        theirs = np.asarray(theirs)
        assert np.abs(theirs).max() > 0
        assert np.linalg.norm(ours.numpy() - theirs) <= 1e-4 * np.linalg.norm(theirs)


def test_background_tv_and_sparsify_match():
    bg = _bg(7)
    for sc, sd in ((1.0, 0.0), (0.0, 1.0), (1e-2, 3e-2)):
        np.testing.assert_allclose(float(vs.tv_loss_background(torch.tensor(bg), sc, sd)),
                                   float(vs_ref.tv_loss_background(jnp.asarray(bg), sc, sd)),
                                   rtol=1e-6)
    # a leaf bg with one dense cell: the reference's own case, then random
    small = np.zeros((8, 4, 2, 4), np.float32)
    small[2, 1, 0, 3] = 5.0
    kept = []
    for b, thresh, dil in ((small, 1.0, 1), (bg, 4.0, 1), (bg, 6.0, 2), (bg, 1e9, 1)):
        out, keep = vs.sparsify_background(torch.tensor(b), thresh, dil)
        out_r, keep_r = vs_ref.sparsify_background(jnp.asarray(b), thresh, dil)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_r))
        np.testing.assert_array_equal(out.numpy(), np.asarray(out_r))
        kept.append(int(keep.sum()))
    assert kept[0] == 9 and 0 < kept[1] < keep.numel() and kept[3] == 0


def test_npz_with_background_crosses_between_packages(tmp_path):
    cfg, cfg_r = _cfgs()
    density, sh, alive, bg = _grid(9)
    grid = voxel_grid_from_numpy(density, sh, alive, background=bg)
    grid_r = vs_ref.VoxelGrid(jnp.asarray(density), jnp.asarray(sh), jnp.asarray(alive),
                              jnp.asarray(bg))
    vs.save_npz(str(tmp_path / "port.npz"), grid, cfg)
    vs_ref.save_npz(str(tmp_path / "ref.npz"), grid_r, cfg_r)
    with np.load(str(tmp_path / "port.npz")) as zp, np.load(str(tmp_path / "ref.npz")) as zr:
        assert sorted(zp.files) == sorted(zr.files)
        for k in zp.files:
            assert zp[k].dtype == zr[k].dtype, k
            np.testing.assert_array_equal(zp[k], zr[k], err_msg=k)
    g, c = vs.load_npz(str(tmp_path / "ref.npz"))
    g_r, c_r = vs_ref.load_npz(str(tmp_path / "port.npz"))
    assert tuple(c) == tuple(c_r) and c.background_nlayers == L and c.background_reso == R
    np.testing.assert_array_equal(g.background.numpy(), np.asarray(g_r.background))
    for a, b in zip(voxel_grid_to_numpy(g), (g_r.density, g_r.sh, g_r.alive)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_trainer_with_background_matches_reference():
    """Two epochs at 16^3 with an L=4, R=16 background, batch 256, 2 steps a
    chunk, on the plain path (the reference's use_kernel=False): epoch MSE
    within 1e-4 relative, the fields and the RMSProp states norm-wise."""
    images, poses, _, hwf, _ = load_synthetic_data(n_train=2, n_test=0, H=16, W=16)
    H, W, focal = hwf
    K = intrinsics_matrix(H, W, focal)
    rays = [get_rays_np(H, W, K, p[:3, :4]) for p in poses]
    origins = np.stack([r[0] for r in rays])
    dirs = np.stack([r[1] for r in rays])
    budgets = (RefBudgeter(images, origins, dirs, init_level=2, seed=0),
               RayBudgeter(images, origins, dirs, init_level=2, seed=0))
    grid_kw = dict(reso=(16, 16, 16), radius=(1.2,) * 3, max_steps=112,
                   background_nlayers=L, background_reso=R)
    train_kw = dict(n_epoch=2, batch_size=256, steps_per_chunk=2, use_kernel=False,
                    lambda_tv_background_sigma=1e-3, lambda_tv_background_color=1e-3)
    t_ref = ref.PlenoxelsTrainer(vs_ref.VoxelGridConfig(**grid_kw),
                                 ref.PlenoxelsTrainConfig(**train_kw))
    t_port = pt.PlenoxelsTrainer(vs.VoxelGridConfig(**grid_kw),
                                 pt.PlenoxelsTrainConfig(**train_kw), device="cpu")
    assert not t_port.use_kernel
    density, sh, alive, bg = _grid(11)
    density *= 0.3
    zd, zs = np.zeros_like(density), np.zeros_like(sh)
    t_ref.state = jax.device_put(t_ref.state._replace(grid=t_ref.state.grid._replace(
        density=jnp.asarray(density), sh=jnp.asarray(sh), alive=jnp.asarray(alive),
        background=jnp.asarray(bg))), replicated(t_ref.mesh))
    t_port.state = plenoxels_state_from_numpy(
        density, sh, alive, zd, zs, 0, background=bg, rms_bg=np.zeros_like(bg),
        bg_alive=np.ones(bg.shape[:2], bool))
    for epoch_id in (1, 2):
        last = epoch_id == 2
        _, mse_ref = t_ref.run_epoch_rays(budgets[0].gen_rays(last_epoch=last))
        _, mse = t_port.run_epoch_rays(budgets[1].gen_rays(last_epoch=last))
        np.testing.assert_allclose(mse, mse_ref, rtol=1e-4)
    d, s, a, rms_d, rms_s, step = plenoxels_state_to_numpy(t_port.state)
    ex = plenoxels_extras_to_numpy(t_port.state)
    st = t_ref.state
    assert step == int(st.step)
    for ours, theirs in ((d, st.grid.density), (s, st.grid.sh), (ex["background"],
                         st.grid.background), (ex["rms_bg"], st.rms_bg)):
        theirs = np.asarray(theirs)
        assert np.linalg.norm(ours - theirs) <= 1e-4 * np.linalg.norm(theirs)
    assert np.abs(ex["background"] - bg).max() > 1e-3   # the background trained


def test_sparsify_bg_pins_cells_on_both_packages():
    """The trainer-level sparsify at an upsample boundary: the same cells
    off in both packages, and pinned cells stay zero through a step."""
    grid_kw = dict(reso=(8, 8, 8), radius=(0.5,) * 3, max_steps=24, step_size=0.7,
                   background_nlayers=2, background_reso=8, init_sigma=0.0)
    train_kw = dict(n_epoch=1, batch_size=128, steps_per_chunk=2, lr_sigma=0.0, lr_sh=0.0,
                    lr_sigma_delay_steps=0, lambda_tv=0.0, lambda_tv_sh=0.0,
                    background_density_thresh=0.5, subdivide_every=0)
    t_ref = ref.PlenoxelsTrainer(vs_ref.VoxelGridConfig(**grid_kw),
                                 ref.PlenoxelsTrainConfig(**train_kw))
    t_port = pt.PlenoxelsTrainer(vs.VoxelGridConfig(**grid_kw),
                                 pt.PlenoxelsTrainConfig(**train_kw), device="cpu")
    rng = np.random.default_rng(12)
    bg = np.abs(rng.standard_normal((16, 8, 2, 4))).astype(np.float32) * 0.3
    bg[3:5, 2:4, 1, 3] = 2.0
    t_ref.state = t_ref.state._replace(grid=t_ref.state.grid._replace(
        background=jnp.asarray(bg)))
    t_port.state = t_port.state._replace(grid=t_port.state.grid._replace(
        background=torch.tensor(bg)))
    assert t_port.sparsify_bg() == t_ref.sparsify_bg() > 0
    np.testing.assert_array_equal(t_port.state.bg_alive.numpy(),
                                  np.asarray(t_ref.state.bg_alive))
    from flnerf_tpu_torch.rays.quadtree import RayEpoch
    o = np.zeros((256, 3), np.float32)
    d = rng.standard_normal((256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_port.run_epoch_rays(RayEpoch(origins=o, dirs=d, rgb=np.full((256, 3), 0.3, np.float32),
                                   leaf_id=np.zeros(256, np.int32), n_leaves=1))
    dead = ~t_port.state.bg_alive
    assert float(t_port.state.grid.background[dead].abs().max()) == 0.0

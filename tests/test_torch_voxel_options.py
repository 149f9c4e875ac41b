"""Port parity: the Plenoxels options beside the SH cuvol render
(flnerf_tpu_torch/models/voxel_sh.py, train/plenoxels_trainer.py) against
the reference package on the same seeded inputs: the nvol and svox1 renders
at 8^3 (and their closed-form single-value cases), the 3d_texture and mlp
bases, the lumisphere TV on the reference's key chain, the max-weight
grids, the basis npz layouts, the trainer on these options, and the
configuration rule that sends the renders no kernel computes to the plain
path on CUDA."""

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
    plenoxels_state_from_numpy,
    plenoxels_state_to_numpy,
    voxel_grid_from_numpy,
)
from flnerf_tpu_torch.models import voxel_sh as vs
from flnerf_tpu_torch.rays.quadtree import RayBudgeter
from flnerf_tpu_torch.train import plenoxels_trainer as pt

torch.set_num_threads(1)


def _scene(reso=8, seed=0, n=64):
    rng = np.random.default_rng(seed)
    density = (rng.random((reso,) * 3) * 3.0).astype(np.float32)
    sh = (rng.standard_normal((reso,) * 3 + (27,)) * 0.3).astype(np.float32)
    alive = rng.random((reso,) * 3) > 0.1
    o = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (n, 1))
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    d[:, :2] += (rng.standard_normal((n, 2)) * 0.3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return density, sh, alive, o, d


def _basis(btype, cfg, seed=3):
    """A nonzero learned basis, as numpy (texture array or the MLP dict)."""
    b = vs_ref.init_basis(cfg, seed)
    if btype == "3d_texture":
        rng = np.random.default_rng(seed)
        return (rng.standard_normal(np.asarray(b).shape) * 0.3).astype(np.float32)
    return {k: np.asarray(v) + (0.05 if k.startswith("b") else 0.0) for k, v in b.items()}


def _both(density, sh, alive, basis=None):
    ours = voxel_grid_from_numpy(density, sh, alive, basis=basis)
    rb = None if basis is None else (
        {k: jnp.asarray(v) for k, v in basis.items()} if isinstance(basis, dict)
        else jnp.asarray(basis))
    return ours, vs_ref.VoxelGrid(jnp.asarray(density), jnp.asarray(sh),
                                  jnp.asarray(alive), basis=rb)


KW = dict(reso=(8, 8, 8), radius=(1.0,) * 3, max_steps=64, step_size=0.5)


@pytest.mark.parametrize("backend", ["nvol", "svox1"])
def test_backend_render_and_gradients_match(backend):
    density, sh, alive, o, d = _scene()
    cfg, cfg_r = vs.VoxelGridConfig(backend=backend, **KW), vs_ref.VoxelGridConfig(
        backend=backend, **KW)
    gt = np.random.default_rng(1).random((o.shape[0], 3)).astype(np.float32)

    def loss_ref(dens, s):
        out = vs_ref.voxel_render_rays(vs_ref.VoxelGrid(dens, s, jnp.asarray(alive)),
                                       jnp.asarray(o), jnp.asarray(d), cfg_r)
        return jnp.mean((out["rgb"] - gt) ** 2), out

    (v_r, out_r), g_r = jax.value_and_grad(loss_ref, argnums=(0, 1), has_aux=True)(
        jnp.asarray(density), jnp.asarray(sh))
    leaves = [torch.tensor(a, requires_grad=True) for a in (density, sh)]
    out = vs.voxel_render_rays(vs.VoxelGrid(*leaves, torch.tensor(alive)),
                               torch.tensor(o), torch.tensor(d), cfg)
    for k in ("rgb", "depth", "acc"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(out_r[k]), atol=1e-5,
                                   err_msg=k)
    loss = torch.mean((out["rgb"] - torch.tensor(gt)) ** 2)
    for ours, theirs in zip(torch.autograd.grad(loss, leaves), g_r):
        theirs = np.asarray(theirs)
        assert np.abs(theirs).max() > 0
        assert np.linalg.norm(ours.numpy() - theirs) <= 1e-4 * np.linalg.norm(theirs)
    assert 0.1 < float(out["acc"].detach().mean()) < 0.999


def test_nvol_single_value_closed_form():
    """The reference's own case (tests/test_voxel_sh.py:201): constant
    sigma, DC-only SH; the alpha sum saturates at 1."""
    cfg = vs.VoxelGridConfig(reso=(8, 8, 8), radius=(1.0,) * 3, max_steps=64, step_size=0.5,
                             backend="nvol", background_brightness=0.0)
    sigma0 = 0.8
    sh = torch.zeros((8, 8, 8, 27))
    sh[..., 0] = 1.0
    grid = vs.VoxelGrid(torch.full((8, 8, 8), sigma0), sh, torch.ones((8, 8, 8), dtype=torch.bool))
    out = vs.voxel_render_rays(grid, torch.tensor([[0.0, 0.0, -3.0]]),
                               torch.tensor([[0.0, 0.0, 1.0]]), cfg)
    ds = 1.0 / (0.5 * 8 / 1.0)
    a = 1.0 - np.exp(-0.5 * sigma0 * ds)
    expected_acc = min((8 / 0.5) * a, 1.0)
    np.testing.assert_allclose(float(out["acc"][0]), expected_acc, atol=0.05)
    c0 = 0.28209479177387814
    np.testing.assert_allclose(out["rgb"][0].numpy(), [expected_acc * (c0 + 0.5),
                               expected_acc * 0.5, expected_acc * 0.5], atol=0.05)


def test_svox1_constant_voxels_beer_lambert():
    """svox1 on a uniform grid: transmittance through the box is
    exp(-sigma * length), the reference's closed form."""
    cfg = vs.VoxelGridConfig(reso=(8, 8, 8), radius=(1.0,) * 3, max_steps=64, step_size=0.5,
                             backend="svox1", background_brightness=1.0)
    sigma0 = 0.5
    grid = vs.VoxelGrid(torch.full((8, 8, 8), sigma0), torch.zeros((8, 8, 8, 27)),
                        torch.ones((8, 8, 8), dtype=torch.bool))
    out = vs.voxel_render_rays(grid, torch.tensor([[0.0, 0.0, -3.0]]),
                               torch.tensor([[0.0, 0.0, 1.0]]), cfg)
    ref_out = vs_ref.voxel_render_rays(
        vs_ref.VoxelGrid(jnp.full((8, 8, 8), sigma0), jnp.zeros((8, 8, 8, 27)),
                         jnp.ones((8, 8, 8), bool)),
        jnp.asarray([[0.0, 0.0, -3.0]]), jnp.asarray([[0.0, 0.0, 1.0]]), cfg._replace())
    np.testing.assert_allclose(out["acc"].numpy(), np.asarray(ref_out["acc"]), atol=1e-5)
    # 7 voxel widths in grid space (centres 0..7 after the +0.5 offset)
    # at delta_scale 1/4 and the +1e-2 exit pad per voxel
    t_expected = np.exp(-sigma0 * (7 + 8 * 1e-2) * 0.25)
    np.testing.assert_allclose(1.0 - float(out["acc"][0]), t_expected, rtol=0.05)


@pytest.mark.parametrize("btype", ["3d_texture", "mlp"])
def test_learned_basis_eval_render_and_gradients_match(btype):
    kw = dict(KW, basis_type=btype, basis_reso=6, mlp_posenc_size=2, mlp_width=8)
    cfg, cfg_r = vs.VoxelGridConfig(**kw), vs_ref.VoxelGridConfig(**kw)
    density, sh, alive, o, d = _scene(seed=4)
    basis = _basis(btype, cfg_r)
    # init_basis draws the reference's numbers (numpy) in both packages
    init = vs.init_basis(cfg, 3)
    init_r = vs_ref.init_basis(cfg_r, 3)
    for a, b in zip(vs.basis_leaves(init), jax.tree_util.tree_leaves(init_r)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    g, g_r = _both(density, sh, alive, basis)
    dirs = torch.tensor(d)
    np.testing.assert_allclose(vs.eval_basis(g, dirs, cfg).numpy(),
                               np.asarray(vs_ref.eval_basis(g_r, jnp.asarray(d), cfg_r)),
                               atol=1e-5)
    gt = np.random.default_rng(2).random((o.shape[0], 3)).astype(np.float32)
    names = list(basis) if isinstance(basis, dict) else None

    def loss_ref(dens, s, b):
        gg = g_r._replace(density=dens, sh=s, basis=b)
        return jnp.mean((vs_ref.voxel_render_rays(gg, jnp.asarray(o), jnp.asarray(d),
                                                  cfg_r)["rgb"] - gt) ** 2)

    v_r, (gd_r, gs_r, gb_r) = jax.value_and_grad(loss_ref, argnums=(0, 1, 2))(
        g_r.density, g_r.sh, g_r.basis)
    leaves = [t.clone().requires_grad_(True)
              for t in [g.density, g.sh] + vs.basis_leaves(g.basis)]
    gg = g._replace(density=leaves[0], sh=leaves[1],
                    basis=vs.basis_from_leaves(g.basis, leaves[2:]))
    loss = torch.mean((vs.voxel_render_rays(gg, torch.tensor(o), dirs, cfg)["rgb"]
                       - torch.tensor(gt)) ** 2)
    np.testing.assert_allclose(float(loss.detach()), float(v_r), rtol=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    theirs_all = [gd_r, gs_r] + ([gb_r[k] for k in sorted(names)] if names else [gb_r])
    for ours, theirs in zip(grads, theirs_all):
        theirs = np.asarray(theirs)
        assert np.abs(theirs).max() > 0
        assert np.linalg.norm(ours.numpy() - theirs) <= 1e-4 * np.linalg.norm(theirs)


def _ref_lumi_draws(seed, z, slab):
    """The reference trainer's lumisphere draws: fold_in(PRNGKey(seed + 1),
    step) split into (kd, kz, kp, ka)."""
    n_starts = z - min(slab, z) + 1

    def draws(step):
        key = jax.random.fold_in(jax.random.PRNGKey(seed + 1), step)
        kd, kz, kp, ka = jax.random.split(key, 4)
        return vs.LumisphereDraws(
            torch.tensor(np.asarray(jax.random.normal(kd, (3,)))),
            int(jax.random.randint(kz, (), 0, n_starts)),
            torch.tensor(np.asarray(jax.random.normal(kp, (3,)))),
            int(jax.random.randint(ka, (), 0, n_starts)))
    return draws


@pytest.mark.parametrize("btype,dir_factor", [("sh", 0.0), ("mlp", 0.5), ("3d_texture", 0.5)])
def test_lumisphere_tv_and_gradients_match(btype, dir_factor):
    kw = dict(KW, basis_type=btype, basis_reso=6, mlp_posenc_size=2, mlp_width=8)
    cfg, cfg_r = vs.VoxelGridConfig(**kw), vs_ref.VoxelGridConfig(**kw)
    density, sh, alive, _, _ = _scene(seed=6)
    g, g_r = _both(density, sh, alive, None if btype == "sh" else _basis(btype, cfg_r))
    slab = 4
    for step in (0, 5):
        key = jax.random.fold_in(jax.random.PRNGKey(1), step)
        v_r, gs_r = jax.value_and_grad(
            lambda s: vs_ref.tv_loss_lumisphere(g_r._replace(sh=s), cfg_r, key, slab,
                                                dir_factor))(g_r.sh)
        sh_t = g.sh.clone().requires_grad_(True)
        v = vs.tv_loss_lumisphere(g._replace(sh=sh_t), cfg, _ref_lumi_draws(0, 8, slab)(step),
                                  slab, dir_factor)
        np.testing.assert_allclose(float(v.detach()), float(v_r), rtol=1e-5)
        (gs,) = torch.autograd.grad(v, [sh_t])
        gs_r = np.asarray(gs_r)
        assert np.abs(gs_r).max() > 0
        assert np.linalg.norm(gs.numpy() - gs_r) <= 1e-4 * np.linalg.norm(gs_r)


def test_weight_grids_match_on_the_four_camera_ball():
    """The reference's case (tests/test_aux_parity.py:123-140): an opaque
    ball seen by 4 training cameras; the max-weight grid and the alive mask
    of weight pruning are the reference's exactly, and the core goes."""
    images, poses, _, hwf, i_split = load_synthetic_data(n_train=6, n_test=1, H=24, W=24)
    H, W, focal = hwf
    K = intrinsics_matrix(H, W, focal)
    r = 24
    kw = dict(reso=(r, r, r), radius=(1.2,) * 3, max_steps=96, step_size=0.7)
    cfg, cfg_r = vs.VoxelGridConfig(**kw), vs_ref.VoxelGridConfig(**kw)
    xx, yy, zz = np.meshgrid(*([np.arange(r)] * 3), indexing="ij")
    rad = np.sqrt((xx - r / 2) ** 2 + (yy - r / 2) ** 2 + (zz - r / 2) ** 2)
    density = np.where(rad < r * 0.3, 50.0, 0.0).astype(np.float32)
    sh = np.zeros((r, r, r, 27), np.float32)
    g, g_r = _both(density, sh, np.ones((r, r, r), bool))
    cams = poses[i_split[0]][:4]
    maxw = vs.max_weight_grid(g, cfg, cams, H, W, K, stride=2)
    maxw_r = vs_ref.max_weight_grid(g_r, cfg_r, cams, H, W, K, stride=2)
    np.testing.assert_allclose(maxw.numpy(), np.asarray(maxw_r), atol=1e-5)
    pruned = vs.weight_prune_grid(g, cfg, cams, H, W, K, weight_thresh=0.05, dilate=1)
    pruned_r = vs_ref.weight_prune_grid(g_r, cfg_r, cams, H, W, K, weight_thresh=0.05,
                                        dilate=1)
    np.testing.assert_array_equal(pruned.alive.numpy(), np.asarray(pruned_r.alive))
    assert not pruned.alive.numpy()[rad < r * 0.15].any()
    assert pruned.alive.numpy()[(rad > r * 0.25) & (rad < r * 0.3)].any()
    with pytest.raises(ValueError, match="svox1"):
        vs.max_weight_grid(g, cfg._replace(backend="svox1"), cams, H, W, K)


@pytest.mark.parametrize("btype", ["3d_texture", "mlp"])
def test_basis_npz_crosses_between_packages(btype, tmp_path):
    kw = dict(reso=(8, 8, 8), basis_type=btype, basis_reso=8, mlp_width=8, mlp_posenc_size=1)
    cfg, cfg_r = vs.VoxelGridConfig(**kw), vs_ref.VoxelGridConfig(**kw)
    density, sh, alive, _, _ = _scene(seed=8)
    g, g_r = _both(density, sh, alive, _basis(btype, cfg_r))
    vs.save_npz(str(tmp_path / "port.npz"), g, cfg)
    vs_ref.save_npz(str(tmp_path / "ref.npz"), g_r, cfg_r)
    with np.load(str(tmp_path / "port.npz")) as zp, np.load(str(tmp_path / "ref.npz")) as zr:
        assert sorted(zp.files) == sorted(zr.files)
        assert int(zp["basis_type"]) == (4 if btype == "3d_texture" else 255)
        for k in zp.files:
            assert zp[k].dtype == zr[k].dtype, k
            np.testing.assert_array_equal(zp[k], zr[k], err_msg=k)
    g2, c2 = vs.load_npz(str(tmp_path / "ref.npz"))
    g2_r, c2_r = vs_ref.load_npz(str(tmp_path / "port.npz"))
    assert tuple(c2) == tuple(c2_r) and c2.basis_type == btype
    for a, b in zip(vs.basis_leaves(g2.basis), vs.basis_leaves(g2_r.basis)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("option", ["nvol", "3d_texture", "mlp+lumisphere"])
def test_trainer_on_off_kernel_options_matches_reference(option):
    """One epoch of both trainers at 8^3 on each option, from the same grid
    (and basis), the lumisphere on the reference's key chain: epoch MSE
    within 1e-4 relative, the fields and the basis norm-wise.  svox1 has
    its own test below."""
    images, poses, _, hwf, _ = load_synthetic_data(n_train=2, n_test=0, H=12, W=12)
    H, W, focal = hwf
    K = intrinsics_matrix(H, W, focal)
    rays = [get_rays_np(H, W, K, p[:3, :4]) for p in poses]
    origins, dirs = np.stack([r[0] for r in rays]), np.stack([r[1] for r in rays])
    budgets = (RefBudgeter(images, origins, dirs, init_level=2, seed=0),
               RayBudgeter(images, origins, dirs, init_level=2, seed=0))
    grid_kw = dict(reso=(8, 8, 8), radius=(1.2,) * 3, max_steps=56, basis_reso=6,
                   mlp_posenc_size=2, mlp_width=8)
    train_kw = dict(n_epoch=1, batch_size=128, steps_per_chunk=2, lr_basis=1e-2,
                    lr_basis_final=1e-3)
    if option in ("nvol", "svox1"):
        grid_kw["backend"] = option
    else:
        grid_kw["basis_type"] = option.split("+")[0]
    if option.endswith("lumisphere"):
        train_kw.update(lambda_tv_lumisphere=1e-2, tv_lumisphere_dir_factor=0.5)
    gcfg_r = vs_ref.VoxelGridConfig(**grid_kw)
    t_ref = ref.PlenoxelsTrainer(gcfg_r, ref.PlenoxelsTrainConfig(**train_kw))
    t_port = pt.PlenoxelsTrainer(vs.VoxelGridConfig(**grid_kw),
                                 pt.PlenoxelsTrainConfig(**train_kw), device="cpu")
    t_port.lumisphere_draws = _ref_lumi_draws(0, 8, 4)
    density, sh, alive, _, _ = _scene(seed=9)
    density *= 0.5
    basis = None if "basis_type" not in grid_kw else _basis(grid_kw["basis_type"], gcfg_r)
    rb = None if basis is None else jax.tree_util.tree_map(jnp.asarray, basis)
    t_ref.state = jax.device_put(t_ref.state._replace(grid=t_ref.state.grid._replace(
        density=jnp.asarray(density), sh=jnp.asarray(sh), alive=jnp.asarray(alive),
        basis=rb)), replicated(t_ref.mesh))
    zeros = None if basis is None else jax.tree_util.tree_map(np.zeros_like, basis)
    t_port.state = plenoxels_state_from_numpy(density, sh, alive, np.zeros_like(density),
                                              np.zeros_like(sh), 0, basis=basis,
                                              rms_basis=zeros)
    _, mse_ref = t_ref.run_epoch_rays(budgets[0].gen_rays(last_epoch=True))
    _, mse = t_port.run_epoch_rays(budgets[1].gen_rays(last_epoch=True))
    np.testing.assert_allclose(mse, mse_ref, rtol=1e-4)
    d, s, _, _, _, step = plenoxels_state_to_numpy(t_port.state)
    st = t_ref.state
    assert step == int(st.step) > 0
    pairs = [(d, st.grid.density), (s, st.grid.sh)]
    if basis is not None:
        ours = vs.basis_leaves(t_port.state.grid.basis)
        theirs = ([st.grid.basis[k] for k in sorted(basis)] if isinstance(basis, dict)
                  else [st.grid.basis])
        pairs += [(a.numpy(), b) for a, b in zip(ours, theirs)]
        assert max(float(np.abs(a.numpy() - np.asarray(b0)).max())
                   for a, b0 in zip(ours, vs.basis_leaves(
                       voxel_grid_from_numpy(density, sh, alive, basis=basis).basis))) > 1e-4
    for ours, theirs in pairs:
        theirs = np.asarray(theirs)
        assert np.linalg.norm(ours - theirs) <= 1e-4 * np.linalg.norm(theirs)


def test_kernel_path_is_chosen_by_configuration():
    """On a CUDA device the trainer takes the kernel path for SH cuvol, with
    the MSI background or the lumisphere TV too, and the plain path for the
    renders no kernel computes (nvol, svox1, a learned basis); on the CPU
    always the plain path.  The rule reads the configuration only."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    g, t = vs.VoxelGridConfig(), pt.PlenoxelsTrainConfig()
    assert pt.kernel_path(g, cuda)
    assert pt.kernel_path(g._replace(background_nlayers=64, background_reso=1024), cuda)
    assert not pt.kernel_path(g, cpu)
    for gg in (g._replace(backend="nvol"), g._replace(backend="svox1"),
               g._replace(basis_type="3d_texture"), g._replace(basis_type="mlp")):
        assert not pt.kernel_path(gg, cuda)
    tr = pt.PlenoxelsTrainer(g._replace(reso=(4, 4, 4), backend="nvol"), t, device="cpu")
    assert not tr.use_kernel


def test_svox1_trainer_gradient_matches_reference_loss():
    """svox1's trainer step: the port's gradients of the masked MSE plus TV
    on an epoch's padded batch against ``jax.grad`` of the reference
    trainer's loss (its XLA path, plenoxels_trainer.py:282-314) outside the
    trainer's jit, norm-wise to 1e-6.  The jitted epoch is not compared: a
    ray that enters the grid through a far face starts in the cell on one
    side of it or the other by the last bit of origin + t * dir, which XLA
    rounds differently once it fuses the whole step; the cells so entered
    take a gradient of ~1e-6 in one run and of ~1e-7 (TV only) in the
    other, and RMSProp moves both by the same full step.  The port rounds
    as the reference does outside the jit."""
    images, poses, _, hwf, _ = load_synthetic_data(n_train=2, n_test=0, H=12, W=12)
    H, W, focal = hwf
    K = intrinsics_matrix(H, W, focal)
    rays = [get_rays_np(H, W, K, p[:3, :4]) for p in poses]
    ep = RefBudgeter(images, np.stack([r[0] for r in rays]), np.stack([r[1] for r in rays]),
                     init_level=2, seed=0).gen_rays(last_epoch=True)
    n, b = ep.origins.shape[0], 512
    o = np.zeros((b, 3), np.float32)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (b, 1))
    gt = np.zeros((b, 3), np.float32)
    m = np.zeros(b, np.float32)
    o[:n], d[:n], gt[:n], m[:n] = ep.origins, ep.dirs, ep.rgb, 1.0
    density, sh, alive, _, _ = _scene(seed=9)
    density *= 0.5
    kw = dict(reso=(8, 8, 8), radius=(1.2,) * 3, max_steps=56, backend="svox1")
    cfg_r = vs_ref.VoxelGridConfig(**kw)
    tcfg = pt.PlenoxelsTrainConfig()
    t = pt.PlenoxelsTrainer(vs.VoxelGridConfig(**kw), tcfg, device="cpu")
    t.state = plenoxels_state_from_numpy(density, sh, alive, np.zeros_like(density),
                                         np.zeros_like(sh), 0)
    grads, mse, count, _ = t._grads(*(torch.tensor(a) for a in (o, d, gt, m)))

    def loss_ref(dens, s):
        out = vs_ref.voxel_render_rays(vs_ref.VoxelGrid(dens, s, jnp.asarray(alive)),
                                       jnp.asarray(o), jnp.asarray(d), cfg_r)
        mse = jnp.sum(m[:, None] * (out["rgb"] - gt) ** 2) / (max(m.sum(), 1.0) * 3.0)
        return mse + tcfg.lambda_tv * vs_ref.tv_loss(dens, jnp.asarray(alive)) + (
            tcfg.lambda_tv_sh * vs_ref.tv_loss(s, jnp.asarray(alive))), mse

    (_, mse_r), g_r = jax.value_and_grad(loss_ref, argnums=(0, 1), has_aux=True)(
        jnp.asarray(density), jnp.asarray(sh))
    assert int(count) == n
    np.testing.assert_allclose(float(mse), float(mse_r), rtol=1e-5)
    for ours, theirs in zip(grads, g_r):
        theirs = np.asarray(theirs)
        assert np.linalg.norm(ours.numpy() - theirs) <= 1e-6 * np.linalg.norm(theirs)

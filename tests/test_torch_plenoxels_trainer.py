"""Port parity: the Plenoxels trainer (flnerf_tpu_torch/train) against the
reference trainer (flnerf_tpu/train/plenoxels_trainer.py, XLA path), from
the same initial grid carried across with flnerf_tpu_torch/core/convert.py
and the same ray budgeter seed, at 32^3, batch 256, 2 steps per chunk."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flnerf_tpu.data.synthetic import load_synthetic_data
from flnerf_tpu.models.voxel_sh import VoxelGridConfig as RefGridConfig
from flnerf_tpu.parallel.mesh import replicated
from flnerf_tpu.rays.camera import get_rays_np, intrinsics_matrix
from flnerf_tpu.rays.quadtree import RayBudgeter as RefBudgeter
from flnerf_tpu.train import plenoxels_trainer as ref
from flnerf_tpu_torch.core.convert import (
    plenoxels_state_from_numpy,
    plenoxels_state_to_numpy,
)
from flnerf_tpu_torch.models.voxel_sh import VoxelGridConfig
from flnerf_tpu_torch.rays.quadtree import RayBudgeter
from flnerf_tpu_torch.train import plenoxels_trainer as pt

torch.set_num_threads(1)


@pytest.mark.parametrize("step", [0.0, 1.0, 7.0, 1500.0, 15000.0, 300000.0])
@pytest.mark.parametrize("sched", [(3e1, 5e-2, 15000, 1e-2, 250000),
                                   (1e-2, 5e-6, 0, 1.0, 250000)])
def test_expon_lr_matches(step, sched):
    # float32 on both sides
    np.testing.assert_allclose(float(pt.expon_lr(step, *sched)),
                               float(ref.expon_lr(jnp.float32(step), *sched)), rtol=1e-6)


def test_train_config_fields_and_defaults_match():
    assert pt.PlenoxelsTrainConfig._fields == ref.PlenoxelsTrainConfig._fields
    assert pt.PlenoxelsTrainConfig() == ref.PlenoxelsTrainConfig()


def test_trainer_matches_reference():
    images, poses, _, hwf, _ = load_synthetic_data(n_train=2, n_test=0, H=16, W=16)
    H, W, focal = hwf
    K = intrinsics_matrix(H, W, focal)
    rays = [get_rays_np(H, W, K, p[:3, :4]) for p in poses]
    origins = np.stack([r[0] for r in rays])
    dirs = np.stack([r[1] for r in rays])
    budgets = (RefBudgeter(images, origins, dirs, init_level=2, seed=0),
               RayBudgeter(images, origins, dirs, init_level=2, seed=0))

    grid_kw = dict(reso=(32, 32, 32), radius=(1.2, 1.2, 1.2), max_steps=224)
    train_kw = dict(n_epoch=2, batch_size=256, steps_per_chunk=2, tv_sparsity=1.0,
                    use_kernel=False)
    t_ref = ref.PlenoxelsTrainer(RefGridConfig(**grid_kw), ref.PlenoxelsTrainConfig(**train_kw))
    t_port = pt.PlenoxelsTrainer(VoxelGridConfig(**grid_kw), pt.PlenoxelsTrainConfig(**train_kw),
                                 device="cpu")

    # one random initial grid, carried across as numpy arrays
    rng = np.random.default_rng(0)
    density = (rng.random((32, 32, 32)) * 0.5).astype(np.float32)
    sh = (rng.standard_normal((32, 32, 32, 27)) * 0.1).astype(np.float32)
    alive = rng.random((32, 32, 32)) > 0.1
    zeros_d, zeros_s = np.zeros_like(density), np.zeros_like(sh)
    t_ref.state = jax.device_put(
        t_ref.state._replace(
            grid=t_ref.state.grid._replace(density=jnp.asarray(density), sh=jnp.asarray(sh),
                                           alive=jnp.asarray(alive))),
        replicated(t_ref.mesh))
    t_port.state = plenoxels_state_from_numpy(density, sh, alive, zeros_d, zeros_s, 0)

    for epoch_id in (1, 2):
        last = epoch_id == 2
        e_ref = budgets[0].gen_rays(last_epoch=last)
        e_port = budgets[1].gen_rays(last_epoch=last)
        np.testing.assert_array_equal(e_ref.origins, e_port.origins)
        stat_ref, mse_ref = t_ref.run_epoch_rays(e_ref)
        stat, mse = t_port.run_epoch_rays(e_port)
        # per-leaf mean |error| and MSE: f32 renders of the same grid
        np.testing.assert_allclose(stat, stat_ref, atol=1e-4)
        np.testing.assert_allclose(mse, mse_ref, atol=1e-4)
        if epoch_id == 1:
            d, s, a, rms_d, rms_s, step = plenoxels_state_to_numpy(t_port.state)
            st = t_ref.state
            assert step == int(st.step) == 2
            np.testing.assert_array_equal(a, np.asarray(st.grid.alive))
            # two RMSProp steps of f32 math: 1e-4 relative, norm-wise.
            # RMSProp divides each cell's step by that cell's own |g|, so
            # where |g| is near its eps (1e-8) and is a sum of cancelling
            # ray and TV terms, f32 rounding in either package moves single
            # cells by ~1e-4 of the field's scale (measured 1.3e-4): those
            # are bounded at 1e-3, the field as a whole at 1e-4.
            for ours, theirs in ((d, st.grid.density), (s, st.grid.sh),
                                 (rms_d, st.rms_density), (rms_s, st.rms_sh)):
                theirs = np.asarray(theirs)
                assert np.linalg.norm(ours - theirs) <= 1e-4 * np.linalg.norm(theirs)
                assert np.abs(ours - theirs).max() <= 1e-3 * np.abs(theirs).max()
            assert np.abs(d - density).max() > 1e-2   # the step moved the grid
            # subdivision from each trainer's own leaf statistic
            n_ref = budgets[0].adjust(stat_ref, 0.015)
            n_port = budgets[1].adjust(stat, 0.015)
            assert n_ref == n_port > 0
            np.testing.assert_array_equal(budgets[0].forest.boxes,
                                          budgets[1].forest.boxes)


def test_coherence_order_shuffles_morton_blocks():
    """The kernel path's ray order: every ray once, each 64-ray block a run
    of the reference's morton order, the blocks in the rng's order."""
    from flnerf_tpu.ops.voxel_pallas import morton_order as ref_morton
    rng = np.random.default_rng(3)
    px, py, img = rng.integers(0, 48, 1000), rng.integers(0, 48, 1000), rng.integers(0, 8, 1000)
    order = pt.coherence_order(px, py, img, np.random.default_rng(0))
    morton = ref_morton(px, py, img)
    perm = np.random.default_rng(0).permutation(1000 // 64)
    np.testing.assert_array_equal(np.sort(order), np.arange(1000))
    for i, b in enumerate(perm):
        np.testing.assert_array_equal(order[i * 64:(i + 1) * 64], morton[b * 64:(b + 1) * 64])
    np.testing.assert_array_equal(order[len(perm) * 64:], morton[len(perm) * 64:])
    # the trainer orders rays only on the kernel path (CUDA)
    cfg = VoxelGridConfig(reso=(16, 16, 16), radius=(1.2, 1.2, 1.2), max_steps=112)
    assert not pt.PlenoxelsTrainer(cfg, pt.PlenoxelsTrainConfig(), device="cpu").use_kernel


def test_render_image_orders_rays_back():
    """The pixels march in chunks; the image must come back in raster order,
    equal to the render of all its rays at once."""
    from flnerf_tpu_torch.models.voxel_sh import voxel_render_rays
    from flnerf_tpu_torch.rays.camera import get_rays

    cfg = VoxelGridConfig(reso=(16, 16, 16), radius=(1.2, 1.2, 1.2), max_steps=112)
    t = pt.PlenoxelsTrainer(cfg, pt.PlenoxelsTrainConfig(), device="cpu")
    rng = np.random.default_rng(1)
    t.state = plenoxels_state_from_numpy(
        rng.random((16, 16, 16)).astype(np.float32) * 3.0,
        rng.standard_normal((16, 16, 16, 27)).astype(np.float32) * 0.3,
        np.ones((16, 16, 16), bool), np.zeros((16, 16, 16), np.float32),
        np.zeros((16, 16, 16, 27), np.float32), 0)
    K = intrinsics_matrix(10, 12, 11.0)
    c2w = np.asarray(load_synthetic_data(n_train=1, n_test=0, H=4, W=4)[1][0])[:3, :4]
    a = t.render_image(10, 12, K, c2w, chunk=37)
    ro, rd = get_rays(10, 12, K, c2w)
    b = voxel_render_rays(t.state.grid, ro.reshape(-1, 3), rd.reshape(-1, 3), cfg)["rgb"]
    assert a.shape == (10, 12, 3)
    np.testing.assert_allclose(a, b.numpy().reshape(10, 12, 3), atol=1e-6)


def test_eval_metrics_match_reference():
    from flnerf_tpu.core import metrics as metrics_ref
    from flnerf_tpu_torch.core import metrics

    rng = np.random.default_rng(2)
    a = rng.random((20, 24, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    # f32 on both sides; the SSIM blur is two 11-tap convolutions
    np.testing.assert_allclose(float(metrics.img2mse(ta, tb)),
                               float(metrics_ref.img2mse(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(metrics.mse2psnr(0.0123)),
                               float(metrics_ref.mse2psnr(jnp.float32(0.0123))), rtol=1e-6)
    np.testing.assert_allclose(
        metrics.compute_ssim(ta, tb, return_map=True).numpy(),
        np.asarray(metrics_ref.compute_ssim(jnp.asarray(a), jnp.asarray(b), return_map=True)),
        atol=1e-5)
    np.testing.assert_allclose(float(metrics.compute_ssim(ta, tb)),
                               float(metrics_ref.compute_ssim(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-6)


def test_g1_three_epochs_reach_the_references_test_psnr():
    """G1 for slice 1: both packages train three epochs of the quadtree
    budgeter (a subdivision after epoch 1, the all-pixel last epoch) from
    the same grid, then render the test view: test PSNRs within 0.05 dB."""
    images, poses, _, hwf, i_split = load_synthetic_data(n_train=4, n_test=1, H=16, W=16)
    H, W, focal = hwf
    K = intrinsics_matrix(H, W, focal)
    tr, te = i_split[0], i_split[2]
    rays = [get_rays_np(H, W, K, p[:3, :4]) for p in poses[tr]]
    origins, dirs = np.stack([r[0] for r in rays]), np.stack([r[1] for r in rays])
    budgets = (RefBudgeter(images[tr], origins, dirs, init_level=2, seed=0),
               RayBudgeter(images[tr], origins, dirs, init_level=2, seed=0))
    grid_kw = dict(reso=(32, 32, 32), radius=(1.2, 1.2, 1.2), max_steps=224)
    train_kw = dict(n_epoch=3, batch_size=256, steps_per_chunk=2, subdivide_every=1,
                    use_kernel=False)
    t_ref = ref.PlenoxelsTrainer(RefGridConfig(**grid_kw), ref.PlenoxelsTrainConfig(**train_kw))
    t_port = pt.PlenoxelsTrainer(VoxelGridConfig(**grid_kw), pt.PlenoxelsTrainConfig(**train_kw),
                                 device="cpu")
    density, sh, alive, rms_d, rms_s, _ = plenoxels_state_to_numpy(t_port.state)
    t_ref.state = jax.device_put(
        t_ref.state._replace(grid=t_ref.state.grid._replace(
            density=jnp.asarray(density), sh=jnp.asarray(sh), alive=jnp.asarray(alive))),
        replicated(t_ref.mesh))
    untrained, _ = t_port.eval_images(poses[te], images[te], H, W, K)
    t_ref.fit(budgets[0], verbose=False)
    t_port.fit(budgets[1], verbose=False)
    np.testing.assert_array_equal(budgets[0].forest.boxes, budgets[1].forest.boxes)
    assert budgets[1].forest.n_leaves > 16
    psnr_ref, _ = t_ref.eval_images(poses[te], images[te], H, W, K)
    psnr, _ = t_port.eval_images(poses[te], images[te], H, W, K)
    assert psnr_ref > untrained + 3.0          # measured 13.06 -> 17.17 dB
    assert abs(psnr - psnr_ref) <= 0.05, (psnr, psnr_ref)

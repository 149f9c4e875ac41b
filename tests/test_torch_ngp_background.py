"""Port parity: NGP's background env-map (bg_radius > 0) in
flnerf_tpu_torch (models/hash_ngp.py sph_from_ray, make_bg_spec,
NGPField.background; render/ngp.py bg_fn; the trainer and main_nerf)
against the reference (flnerf_tpu/models/hash_ngp.py, render/ngp.py,
train/ngp_trainer.py), weights carried across with core/convert.py, at the
widths of tests/test_torch_ngp.py and a 4-level 2^10 background table."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flnerf_tpu.data.synthetic import load_synthetic_data
from flnerf_tpu.models import hash_ngp as ref_m
from flnerf_tpu.parallel.mesh import make_mesh
from flnerf_tpu.rays.camera import intrinsics_matrix
from flnerf_tpu.render import ngp as ref_r
from flnerf_tpu.train import ngp_trainer as ref_t
from flnerf_tpu_torch.cli import main_nerf
from flnerf_tpu_torch.core import convert
from flnerf_tpu_torch.models import hash_ngp as m
from flnerf_tpu_torch.render import ngp as r
from flnerf_tpu_torch.train import ngp_trainer as t_ngp

torch.set_num_threads(1)

KW = dict(num_levels=4, log2_hashmap_size=10, desired_resolution=64, bound=1.0,
          bg_radius=4.0, bg_levels=4, bg_log2_hashmap_size=10)


def _rays(n=256, seed=0):
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((n, 3)) * 1.5).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _ref_params(seed=0):
    cfg = ref_m.NGPConfig(**KW)
    params = jax.tree_util.tree_map(np.asarray, ref_m.init_ngp(jax.random.PRNGKey(seed), cfg))
    params["table"] = params["table"] * np.float32(1e4)
    params["bg_table"] = params["bg_table"] * np.float32(1e4)
    return cfg, params


def test_bg_spec_and_sph_from_ray_match():
    cfg, cfg_r = m.NGPConfig(**KW), ref_m.NGPConfig(**KW)
    ours, theirs = m.make_bg_spec(cfg), ref_m.make_bg_spec(cfg_r)
    for f in ours._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ours, f)),
                                      np.asarray(getattr(theirs, f)), err_msg=f)
    assert ours.input_dim == 2 and ours.num_levels == 4
    o, d = _rays()
    for radius in (4.0, 32.0):
        np.testing.assert_allclose(
            m.sph_from_ray(torch.tensor(o), torch.tensor(d), radius).numpy(),
            np.asarray(ref_m.sph_from_ray(jnp.asarray(o), jnp.asarray(d), radius)), atol=1e-6)


def test_background_and_gradients_match():
    cfg_r, params = _ref_params()
    field = m.NGPField(m.NGPConfig(**KW), torch.float32)
    convert.load_ngp_params(field, params)
    assert [tuple(p.shape) for p in field.parameters()] == [
        tuple(np.shape(a)) for a in convert.ngp_params_from_numpy(params)]
    o, d = _rays(seed=1)
    gt = np.random.default_rng(2).random((o.shape[0], 3)).astype(np.float32)

    def loss_ref(p):
        bg = ref_m.ngp_background(p, jnp.asarray(o), jnp.asarray(d), cfg_r, jnp.float32)
        return jnp.mean((bg - gt) ** 2), bg

    (v_r, bg_r), g_r = jax.value_and_grad(loss_ref, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    bg = field.background(torch.tensor(o), torch.tensor(d))
    np.testing.assert_allclose(bg.detach().numpy(), np.asarray(bg_r), atol=1e-5)
    assert float(np.asarray(bg_r).std()) > 1e-2          # the env map varies
    loss = torch.mean((bg - torch.tensor(gt)) ** 2)
    np.testing.assert_allclose(float(loss.detach()), float(v_r), rtol=1e-5)
    bg_params = [field.bg_table] + list(field.bg_net)
    grads = torch.autograd.grad(loss, bg_params)
    for ours, theirs in zip(grads, [g_r["bg_table"]] + list(g_r["bg_net"])):
        theirs = np.asarray(theirs)
        assert np.abs(theirs).max() > 0
        assert np.linalg.norm(ours.numpy() - theirs) <= 1e-5 * np.linalg.norm(theirs)


def test_render_with_background_matches():
    cfg_r, params = _ref_params(3)
    field = m.NGPField(m.NGPConfig(**KW), torch.float32)
    convert.load_ngp_params(field, params)
    rcfg = r.NGPRenderConfig(n_candidates=32, n_keep=16, grid_size=16, bound=1.0)
    density = np.zeros((16, 16, 16), np.float32)
    density[4:12, 4:12, 4:12] = 0.05
    occ_r = ref_r.with_density(ref_r.init_occupancy(rcfg), jnp.asarray(density), rcfg)
    occ = convert.occupancy_from_numpy(density, float(occ_r.mean_density), rcfg)
    _, density_fn, rgb_fn = ref_m.make_ngp_field(cfg_r, compute_dtype=jnp.float32)
    bg_fn = ref_m.make_ngp_bg_fn(cfg_r, compute_dtype=jnp.float32)
    o, d = _rays(64, seed=4)
    o = -2.5 * d + 0.1 * o                                # rays towards the box
    out_r = ref_r.ngp_render_rays(jax.random.PRNGKey(0), jax.tree_util.tree_map(
        jnp.asarray, params), density_fn, rgb_fn, occ_r, jnp.asarray(o), jnp.asarray(d),
        rcfg, perturb=False, bg_fn=bg_fn)
    with torch.no_grad():
        out = r.ngp_render_rays(field, occ, torch.tensor(o), torch.tensor(d), rcfg,
                                perturb=False, bg_fn=field.background)
    for k in ("rgb", "depth", "acc"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(out_r[k]), atol=1e-5, err_msg=k)
    assert float(np.asarray(out_r["acc"]).min()) < 0.9     # the background shows


@pytest.mark.parametrize("rgba", [False, True])
def test_two_trainer_steps_match(rgba):
    """Two Adam steps (with EMA) with the background model from the same
    params, occupancy, rays and noise, as tests/test_torch_ngp.py's test of
    that name; RGBA data is composited on white, the background model
    draws no random background."""
    init_fn, density_fn, rgb_fn = ref_m.make_ngp_field(ref_m.NGPConfig(**KW),
                                                       compute_dtype=jnp.float32)
    bg_fn = ref_m.make_ngp_bg_fn(ref_m.NGPConfig(**KW), compute_dtype=jnp.float32)
    rcfg = r.NGPRenderConfig(n_candidates=32, n_keep=16, grid_size=16, bound=1.0)
    tcfg = t_ngp.NGPTrainConfig(max_steps=64, batch_rays=64, steps_per_chunk=2,
                                ema_decay=0.95)
    t_ref = ref_t.NGPTrainer(init_fn, density_fn, rgb_fn, rcfg, ref_t.NGPTrainConfig(*tcfg),
                             mesh=make_mesh(jax.devices()[:1]), bg_fn=bg_fn)
    t = t_ngp.NGPTrainer(m.NGPConfig(**KW), rcfg, tcfg, device="cpu",
                         compute_dtype=torch.float32)
    assert t.bg_fn is not None
    params = jax.tree_util.tree_map(np.asarray, t_ref.state.params)
    params["bg_table"] = params["bg_table"] * np.float32(1e4)
    t_ref.state = t_ref.state._replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        ema_params=jax.tree_util.tree_map(jnp.asarray, params))
    convert.load_ngp_params(t.field, params)
    t.ema = [p.detach().clone() for p in t.params]
    rng = np.random.default_rng(10)
    density = (rng.random((16, 16, 16)) * 0.05).astype(np.float32)
    density[rng.random((16, 16, 16)) < 0.5] = 0.0
    t_ref.occ = ref_r.with_density(ref_r.init_occupancy(rcfg), jnp.asarray(density), rcfg)
    t.occ = convert.occupancy_from_numpy(density, float(t_ref.occ.mean_density), rcfg)

    images, poses, _, hwf, _ = load_synthetic_data(n_train=3, n_test=0, H=16, W=16)
    if rgba:
        alpha = (images.mean(-1, keepdims=True) < 0.99).astype(np.float32)
        images = np.concatenate([images, alpha], -1)
    K = intrinsics_matrix(16, 16, hwf[2])
    poses[:, :3, 3] *= 0.5
    o, d, rgb, _, _ = t_ngp.NGPSampler(images, poses, K, tcfg, seed=0).sample_chunk(2, 64)
    base_key = jax.random.PRNGKey(11)
    t_ref.state, losses_ref, per_ray_ref = t_ref._chunk_fn(t_ref.state, t_ref.occ, o, d,
                                                           rgb, base_key)
    for k, key in enumerate(jax.random.split(base_key, 2)):
        kp, _ = jax.random.split(key)
        noise = torch.from_numpy(np.array(jax.random.uniform(kp, (64, 32))))
        loss, per_ray = t.train_step(torch.from_numpy(o[k]), torch.from_numpy(d[k]),
                                     torch.from_numpy(rgb[k]), noise=noise)
        np.testing.assert_allclose(float(loss), float(losses_ref[k]), rtol=1e-5)
        np.testing.assert_allclose(per_ray.numpy(), np.asarray(per_ray_ref[k]), atol=1e-6)
    st = t_ref.state
    for ours, theirs in ((t.params, st.params), (t.mu, st.opt_state.mu),
                         (t.nu, st.opt_state.nu), (t.ema, st.ema_params)):
        theirs = convert.ngp_params_from_numpy(jax.tree_util.tree_map(np.asarray, theirs))
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            a, b = a.detach().numpy(), b.numpy()
            assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
            assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
    start = convert.ngp_params_from_numpy(params)
    n_bg = 1 + len(params["bg_net"])
    for a, b in zip(t.params[-n_bg:], start[-n_bg:]):     # the background trained
        assert np.abs(a.detach().numpy() - b.numpy()).max() > 1e-4


@pytest.mark.parametrize("rgba", [False, True])
def test_eval_images_with_background_matches(rgba):
    """eval_images with the background model (ngp_trainer.py:650-668): the
    render composites on the env-map, an RGBA gt on the eval bg_color; the
    PSNR and SSIM on the same converted weights and occupancy agree with
    the reference's."""
    init_fn, density_fn, rgb_fn = ref_m.make_ngp_field(ref_m.NGPConfig(**KW),
                                                       compute_dtype=jnp.float32)
    bg_fn = ref_m.make_ngp_bg_fn(ref_m.NGPConfig(**KW), compute_dtype=jnp.float32)
    rcfg = r.NGPRenderConfig(n_candidates=32, n_keep=16, grid_size=16, bound=1.0)
    tcfg = t_ngp.NGPTrainConfig(max_steps=4, batch_rays=64, steps_per_chunk=2)
    t_ref = ref_t.NGPTrainer(init_fn, density_fn, rgb_fn, rcfg, ref_t.NGPTrainConfig(*tcfg),
                             mesh=make_mesh(jax.devices()[:1]), bg_fn=bg_fn)
    t = t_ngp.NGPTrainer(m.NGPConfig(**KW), rcfg, tcfg, device="cpu",
                         compute_dtype=torch.float32)
    _, params = _ref_params(5)
    t_ref.state = t_ref.state._replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    convert.load_ngp_params(t.field, params)
    density = np.zeros((16, 16, 16), np.float32)
    density[5:11, 5:11, 5:11] = 0.05
    t_ref.occ = ref_r.with_density(ref_r.init_occupancy(rcfg), jnp.asarray(density), rcfg)
    t.occ = convert.occupancy_from_numpy(density, float(t_ref.occ.mean_density), rcfg)
    images, poses, _, hwf, _ = load_synthetic_data(n_train=2, n_test=0, H=16, W=16)
    if rgba:
        alpha = (images.mean(-1, keepdims=True) < 0.99).astype(np.float32)
        images = np.concatenate([images, alpha], -1)
    K = intrinsics_matrix(16, 16, hwf[2])
    psnr_r, ssim_r = t_ref.eval_images(poses, images, 16, 16, K, chunk=128)
    psnr, ssim = t.eval_images(poses, images, 16, 16, K, chunk=128)
    assert abs(psnr - psnr_r) <= 1e-4
    assert abs(ssim - ssim_r) <= 1e-5
    # the env-map enters: a white fill gives another PSNR
    t.bg_fn = None
    assert abs(t.eval_images(poses, images, 16, 16, K, chunk=128)[0] - psnr) > 1e-2


def test_checkpoint_and_converters_carry_the_background(tmp_path):
    rcfg = r.NGPRenderConfig(n_candidates=16, n_keep=8, grid_size=8, bound=1.0)
    tcfg = t_ngp.NGPTrainConfig(max_steps=4, batch_rays=32, steps_per_chunk=4)
    t = t_ngp.NGPTrainer(m.NGPConfig(**KW), rcfg, tcfg, device="cpu")
    tree = t._tree(t.params)
    assert set(tree) == {"table", "sigma_net", "color_net", "bg_table", "bg_net"}
    _, ref_params = _ref_params()
    for k in tree:
        for a, b in zip(jax.tree_util.tree_leaves(tree[k]),
                        jax.tree_util.tree_leaves(ref_params[k])):
            assert a.shape == b.shape, k
    for a, b in zip(convert.ngp_params_from_numpy(tree), t.params):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
    images, poses, _, hwf, _ = load_synthetic_data(n_train=2, n_test=0, H=8, W=8)
    K = intrinsics_matrix(8, 8, hwf[2])
    t.fit(t_ngp.NGPSampler(images, poses, K, tcfg), verbose=False)
    t.save_checkpoint(str(tmp_path))
    t2 = t_ngp.NGPTrainer(m.NGPConfig(**KW), rcfg, tcfg, device="cpu")
    t2.load_checkpoint(str(tmp_path))
    for a, b in zip(t.params + t.mu + t.nu, t2.params + t2.mu + t2.nu):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=0)
    psnr, _ = t2.eval_images(poses[:1], images[:1], 8, 8, K, chunk=64)
    assert math.isfinite(psnr)


def test_main_nerf_bg_radius_trains_on_the_cpu(tmp_path):
    tiny = ["--synth_h", "16", "--grid_size", "8", "--num_rays", "64", "--n_candidates", "32",
            "--n_keep", "16", "--steps_per_chunk", "4", "--device", "cpu", "--iters", "16"]
    args = main_nerf.parse_args(["synthetic", "-O", "--bg_radius", "32"] + tiny)
    assert args.bg_radius == 32.0
    trainer = main_nerf.build(args)[0]
    assert trainer.field.cfg.bg_radius == 32.0 and trainer.field.has_background
    res = main_nerf.main(["synthetic", "-O", "--bg_radius", "32", "--workspace",
                          str(tmp_path)] + tiny)
    assert res["steps"] == 16 and math.isfinite(res["psnr"])
    # without the flag (default -1) there is no background
    assert not main_nerf.build(main_nerf.parse_args(["synthetic"] + tiny))[0].field.has_background

"""The port's CLIP guidance (flnerf_tpu_torch/core/clip_guidance.py), the
rand_pose views (rays/camera.rand_poses) and main_nerf's gate for
--clip_text / --rand_pose, against the reference package.

Tolerances: rand_poses bit for bit (numpy on both sides); clip_preprocess
within 2e-5 of jax.image.resize's bilinear resize and the normalisation
(measured 1.26e-5 after the division by CLIP's std, 0.26-0.28: 3.6e-6 in
the resized pixels); the loss within 1e-6 and its
gradient in the images within 1e-5 of the largest entry (f32, a stub
encoder on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flnerf_tpu.core import clip_guidance as ref_clip
from flnerf_tpu.rays import camera as ref_camera
from flnerf_tpu_torch.cli import main_nerf
from flnerf_tpu_torch.core import clip_guidance
from flnerf_tpu_torch.rays import camera

torch.set_num_threads(1)
D = 32


def _images(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80), (17, 19), (256, 256), (800, 800),
                                (224, 224)])
def test_clip_preprocess_matches_jax_image_resize(hw):
    x = _images((2,) + hw + (3,), seed=hw[0])
    got = clip_guidance.clip_preprocess(torch.from_numpy(x)).numpy()
    want = np.asarray(ref_clip.clip_preprocess(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 3, 224, 224)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def _stub_pair(seed=0):
    """The reference test's stub encoder (mean-pool to [N, 3], a fixed map
    to D), seeded, in both packages."""
    w = np.random.default_rng(seed).standard_normal((3, D)).astype(np.float32) * 0.1

    def enc_jax(images):
        return jnp.mean(images, axis=(2, 3)) @ jnp.asarray(w)

    def enc_torch(images):
        return images.mean(dim=(2, 3)) @ torch.from_numpy(w)

    return enc_jax, enc_torch


@pytest.mark.parametrize("n_prompts", [1, 2])
def test_loss_and_gradient_match_the_reference(n_prompts):
    enc_jax, enc_torch = _stub_pair()
    text = np.random.default_rng(1).standard_normal((n_prompts, D)).astype(np.float32)
    ref = ref_clip.CLIPGuidance(enc_jax, jnp.asarray(text))
    ours = clip_guidance.CLIPGuidance(enc_torch, torch.from_numpy(text))
    x = _images((2, 17, 19, 3), seed=2)
    want, g_want = jax.value_and_grad(lambda im: ref(im))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = ours(xt)
    loss.backward()
    assert abs(float(loss) - float(want)) <= 1e-6
    g_want = np.asarray(g_want)
    assert np.abs(g_want).max() > 0
    np.testing.assert_allclose(xt.grad.numpy(), g_want, rtol=0, atol=1e-5 * np.abs(g_want).max())


def test_generator_draws_the_prompt():
    """With several prompts a generator picks one a call (the reference's
    key); each drawn loss is the one-prompt loss of that prompt."""
    _, enc = _stub_pair(3)
    text = torch.from_numpy(np.random.default_rng(4).standard_normal((3, D)).astype(np.float32))
    g = clip_guidance.CLIPGuidance(enc, text)
    x = torch.from_numpy(_images((1, 8, 8, 3), seed=5))
    single = [float(clip_guidance.CLIPGuidance(enc, text[i:i + 1])(x)) for i in range(3)]
    gen = torch.Generator().manual_seed(0)
    drawn = [float(g(x, generator=gen)) for _ in range(12)]
    assert set(drawn) <= set(single) and len(set(drawn)) > 1
    gen2 = torch.Generator().manual_seed(0)
    assert [float(g(x, generator=gen2)) for _ in range(12)] == drawn
    assert float(g(x)) == single[0]


def test_clip_loss_fn_is_gated_without_the_clip_package():
    assert clip_guidance.clip_loss_fn(["a chair"]) is None
    assert ref_clip.clip_loss_fn(["a chair"]) is None


@pytest.mark.parametrize("kw", [{}, {"radius": 2.0, "theta_range": (np.pi / 3, 2 * np.pi / 3)},
                                {"radius": 0.7, "phi_range": (0.5, 1.0)}])
def test_rand_poses_match_the_reference(kw):
    got = camera.rand_poses(64, np.random.default_rng(0), **kw)
    want = ref_camera.rand_poses(64, np.random.default_rng(0), **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_rand_poses_orbit_geometry():
    """The reference test's checks (provider.py:58-93): orthonormal
    rotations, centres on the shell within the theta range, the forward
    column looking at the origin."""
    poses = camera.rand_poses(256, np.random.default_rng(0), radius=2.0,
                              theta_range=(np.pi / 3, 2 * np.pi / 3))
    c = poses[:, :3, 3]
    np.testing.assert_allclose(np.linalg.norm(c, axis=-1), 2.0, rtol=1e-5)
    y = c[:, 1] / 2.0
    assert (y <= np.cos(np.pi / 3) + 1e-6).all() and (y >= np.cos(2 * np.pi / 3) - 1e-6).all()
    r = poses[:, :3, :3]
    np.testing.assert_allclose(np.einsum("nij,nkj->nik", r, r),
                               np.tile(np.eye(3), (256, 1, 1)), atol=1e-5)
    np.testing.assert_allclose(r[:, :, 2], -c / 2.0, atol=1e-5)


def test_guided_step_on_ngp_renders_of_rand_poses():
    """The library path main_nerf's gate points to: an NGP trainer after 8
    steps (so its occupancy grid keeps samples), two rand_poses views
    (flipped to the OpenGL camera get_rays uses) rendered by its field with
    autograd, the guidance loss on them with a stub encoder (pool 224^2 ->
    8^2, a fixed map to 512), one backward: a finite loss and a nonzero
    table gradient (the plain encode on the CPU)."""
    from flnerf_tpu_torch.render.ngp import ngp_render_rays
    from flnerf_tpu_torch.train.ngp_trainer import NGPSampler

    args = main_nerf.parse_args(["synthetic", "-O", "--synth_h", "16", "--grid_size", "16",
                                 "--num_rays", "64", "--n_candidates", "32", "--n_keep", "16",
                                 "--steps_per_chunk", "4", "--device", "cpu"])
    trainer, _, _, tcfg = main_nerf.build(args)
    images, poses, _, K, (i_train, _, _) = main_nerf.load_ngp_dataset(args)
    trainer.fit(NGPSampler(images[i_train], poses[i_train], K, tcfg, seed=0),
                verbose=False, n_steps=8)
    radius = float(np.linalg.norm(poses[:, :3, 3], axis=-1).mean())
    views = camera.rand_poses(2, np.random.default_rng(0), radius=radius) @ np.diag(
        [1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    rays = [camera.get_rays(16, 16, K, p[:3, :4]) for p in views]
    o = torch.cat([r[0].reshape(-1, 3) for r in rays])
    d = torch.cat([r[1].reshape(-1, 3) for r in rays])
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((192, 512)).astype(np.float32))

    def encoder(x):
        return F.avg_pool2d(x, 28).reshape(x.shape[0], -1) @ w

    guide = clip_guidance.CLIPGuidance(
        encoder, torch.from_numpy(np.random.default_rng(2).standard_normal((1, 512),
                                                                           dtype=np.float32)))
    trainer.field.zero_grad()
    out = ngp_render_rays(trainer.field, trainer.occ, o, d, trainer.rcfg, perturb=False)
    assert float(out["acc"].max()) > 0
    loss = guide(out["rgb"].reshape(2, 16, 16, 3))
    loss.backward()
    assert np.isfinite(float(loss))
    assert float(trainer.field.table.grad.abs().max()) > 0

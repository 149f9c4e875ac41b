"""Port parity: the NeRF++ model of flnerf_tpu_torch (models/nerfpp.py and the
trainer's per-level render) against the reference's (flnerf_tpu/models/
nerfpp.py, train/nerfpp_trainer.py ``_render_level``), with the same
numpy-seeded rays, the reference's weights carried across by
core/convert.py and the reference's uniforms fed in.

Tolerances, each stated where it is checked:
  * geometry (intersect_sphere, depth2pts_outside): 1e-5 absolute;
  * MLPNet rgb and sigma: 1e-5 relative to the output's scale in f32, 1e-3
    in bf16 (an operand on a bf16 rounding boundary can round the other way
    after an f32 difference in the layer before);
  * the sampled depths 1e-5 relative (1e-6 absolute near 0); rgb,
    weights and bg_lambda 1e-4 absolute;
  * each parameter's loss gradient within 1e-3 of its norm (the fg's last
    distance and the bg's 1e10 amplify f32 differences in the density
    path; ROADMAP.md oracle notes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flnerf_tpu.models import nerfpp as ref
from flnerf_tpu.train import nerfpp_trainer as ref_t
from flnerf_tpu_torch.core import convert
from flnerf_tpu_torch.models import nerfpp as ours
from flnerf_tpu_torch.models.nerf_mlp import embed_fn
from flnerf_tpu_torch.train import nerfpp_trainer as t

torch.set_num_threads(1)

N_RAYS = 24
SMALL = dict(netdepth=6, netwidth=32, max_freq_log2=4, max_freq_log2_viewdirs=2,
             cascade_samples=(8, 16))
GRAD_TOL = 1e-3        # measured at most 1.6e-4 (bg.sigma.bias, level 1)


def _rays(n=N_RAYS, seed=0):
    """Origins inside a 0.4 ball, unnormalized directions."""
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-1, 1, (n, 3)) * 0.4 / np.sqrt(3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32) * rng.uniform(0.5, 2.0, (n, 1)).astype(
        np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    img = rng.integers(0, 3, n).astype(np.int32)
    return o, d, rgb, img


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def ref_uniforms(key, level, n_rays, n_samples):
    """The uniforms the reference's ``_render_level`` draws from ``key``:
    fg and bg perturbation at level 0 (k1, k2), fg and bg inverse-CDF
    uniforms at level 1 (k3, k4)."""
    ks = jax.random.split(key, 4)
    a, b = (ks[0], ks[1]) if level == 0 else (ks[2], ks[3])
    return (np.asarray(jax.random.uniform(a, (n_rays, n_samples))),
            np.asarray(jax.random.uniform(b, (n_rays, n_samples))))


def _pair(dtype="float32", autoexpo=False, n_images=3):
    mcfg = ref.NerfPPConfig(**SMALL, optim_autoexpo=autoexpo)
    tcfg = ref_t.NerfPPTrainConfig(compute_dtype=dtype, batch_size=N_RAYS)
    r = ref_t.NerfPPTrainer(mcfg, tcfg, n_images=n_images)
    o = t.NerfPPTrainer(ours.NerfPPConfig(**SMALL, optim_autoexpo=autoexpo),
                        t.NerfPPTrainConfig(compute_dtype=dtype, batch_size=N_RAYS),
                        n_images=n_images, device="cpu")
    with torch.no_grad():
        for net, sd in zip(o.nets, convert.nerfpp_params_from_numpy(_np(r.state.params))):
            net.load_state_dict(sd)
    return r, o


def test_intersect_sphere_and_depth2pts_outside():
    o, d, _, _ = _rays(64)
    depth_r, inside_r = ref.intersect_sphere(jnp.asarray(o), jnp.asarray(d))
    depth, inside = ours.intersect_sphere(torch.as_tensor(o), torch.as_tensor(d))
    np.testing.assert_allclose(depth.numpy(), np.asarray(depth_r), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(inside.numpy(), np.asarray(inside_r))
    assert bool(inside.all())
    # a ray that misses is flagged
    _, miss = ours.intersect_sphere(torch.tensor([[2.0, 0, 0]]), torch.tensor([[0, 1.0, 0]]))
    assert not bool(miss[0])

    z = np.sort(np.random.default_rng(1).uniform(0, 1, (64, 12)).astype(np.float32), -1)
    z[:, 0] = 0.0
    z[:, -1] = 1.0
    ob = np.broadcast_to(o[:, None], (64, 12, 3))
    db = np.broadcast_to(d[:, None], (64, 12, 3))
    pts_r = ref.depth2pts_outside(jnp.asarray(ob), jnp.asarray(db), jnp.asarray(z))
    pts = ours.depth2pts_outside(torch.as_tensor(ob.copy()), torch.as_tensor(db.copy()),
                                 torch.as_tensor(z))
    assert pts.shape == (64, 12, 4)
    np.testing.assert_allclose(pts.numpy(), np.asarray(pts_r), rtol=0, atol=1e-5)


def test_perturb_samples_with_fed_uniforms():
    z = torch.linspace(0, 1, 9).expand(5, 9)
    u = np.random.default_rng(2).uniform(0, 1, (5, 9)).astype(np.float32)
    got = ours.perturb_samples(z, torch.as_tensor(u))
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    lower = torch.cat([z[..., :1], mids], -1)
    upper = torch.cat([mids, z[..., -1:]], -1)
    np.testing.assert_allclose(got.numpy(), (lower + (upper - lower) * torch.as_tensor(u)).numpy(),
                               rtol=0, atol=0)
    gen = torch.Generator().manual_seed(0)
    drawn = ours.perturb_samples(z, generator=gen)
    assert bool(((drawn >= lower) & (drawn <= upper)).all())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
def test_mlpnet_matches_apply_mlpnet(dtype, tol):
    r, o = _pair(dtype)
    rng = np.random.default_rng(3)
    for net in ("fg", "bg"):
        in_dims = 3 if net == "fg" else 4
        x = rng.uniform(-1, 1, (2, 40, in_dims)).astype(np.float32)
        v = rng.normal(size=(2, 40, 3)).astype(np.float32)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        pe = embed_fn(torch.as_tensor(x), SMALL["max_freq_log2"])
        ve = embed_fn(torch.as_tensor(v), SMALL["max_freq_log2_viewdirs"])
        rgb, sigma = getattr(o.nets[0], net)(pe, ve)
        rgb_r, sigma_r = ref.apply_mlpnet(r.state.params[0][net], jnp.asarray(pe.numpy()),
                                          jnp.asarray(ve.numpy()), r.dtype)
        for a, b in ((rgb, rgb_r), (sigma, sigma_r)):
            b = np.asarray(b)
            assert a.shape == b.shape
            scale = max(float(np.abs(b).max()), 1e-6)
            assert float(np.abs(a.detach().numpy() - b).max()) <= tol * scale, net


def _render_both(r, o):
    """Both levels through both packages with the reference's uniforms:
    returns the per-level outputs (port, reference)."""
    ro, rd, _, _ = _rays()
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, 2)
    fg_z_max_r, _ = ref.intersect_sphere(jnp.asarray(ro), jnp.asarray(rd))
    ro_t, rd_t = torch.as_tensor(ro), torch.as_tensor(rd)
    fg_z_max, _ = ours.intersect_sphere(ro_t, rd_t)
    outs, outs_r, prev, prev_r = [], [], None, None
    for m, n in enumerate(SMALL["cascade_samples"]):
        out_r = r._render_level(r.state.params[m], keys[m], jnp.asarray(ro), jnp.asarray(rd),
                                fg_z_max_r, prev_r, m, n)
        out = o._render_level(m, ro_t, rd_t, fg_z_max, prev,
                              ref_uniforms(keys[m], m, N_RAYS, n))
        outs.append(out)
        outs_r.append(_np(out_r))
        prev, prev_r = {k: v.detach() for k, v in out.items()}, out_r
    return outs, outs_r


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_both_levels_with_the_references_uniforms(dtype):
    r, o = _pair(dtype)
    outs, outs_r = _render_both(r, o)
    for m, (out, out_r) in enumerate(zip(outs, outs_r)):
        n = sum(SMALL["cascade_samples"][:m + 1])
        assert out["fg_depth_vals"].shape == (N_RAYS, n)
        for k in ("fg_depth_vals", "bg_depth_vals"):
            np.testing.assert_allclose(out[k].detach().numpy(), out_r[k], rtol=1e-5,
                                       atol=1e-6, err_msg=f"level {m} {k}")
        for k in ("rgb", "fg_weights", "bg_weights", "bg_lambda", "fg_rgb", "bg_rgb",
                  "fg_depth", "bg_depth"):
            np.testing.assert_allclose(out[k].detach().numpy(), out_r[k], rtol=0, atol=1e-4,
                                       err_msg=f"level {m} {k}")
        assert set(out) == set(out_r)


def _ref_loss_grad(r, m, prev_r, key, ro, rd, rgb, img):
    """jax.grad of the reference trainer's level-m loss (nerfpp_trainer.py
    loss_fn, every ray real)."""
    mcfg = r.mcfg
    fg_z_max, _ = ref.intersect_sphere(ro, rd)

    def loss_fn(p):
        out = r._render_level(p, key, ro, rd, fg_z_max, prev_r, m, mcfg.cascade_samples[m])
        pred = out["rgb"]
        n = ro.shape[0]
        if "autoexpo" in p:
            ae = p["autoexpo"][img]
            scale = jnp.abs(ae[:, 0:1]) + 0.5
            shift = ae[:, 1:2]
            pred = (pred - shift) / scale
        loss = jnp.sum((pred - rgb) ** 2) / (n * 3.0)
        if "autoexpo" in p:
            reg = jnp.abs(scale[:, 0] - 1.0) + jnp.abs(shift[:, 0])
            loss = loss + mcfg.lambda_autoexpo * jnp.sum(reg) / n
        return loss, out

    (loss, out), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(r.state.params[m])
    return float(loss), g, jax.lax.stop_gradient(out)


@pytest.mark.parametrize("autoexpo", [False, True])
def test_each_levels_loss_gradient_matches_jax_grad(autoexpo):
    r, o = _pair("float32", autoexpo=autoexpo)
    ro, rd, rgb, img = _rays()
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, 2)
    ro_t, rd_t, rgb_t = (torch.as_tensor(a) for a in (ro, rd, rgb))
    img_t = torch.as_tensor(img.astype(np.int64))
    fg_z_max, _ = ours.intersect_sphere(ro_t, rd_t)
    prev, prev_r = None, None
    for m, n in enumerate(SMALL["cascade_samples"]):
        loss_r, g_r, prev_r_next = _ref_loss_grad(r, m, prev_r, keys[m], jnp.asarray(ro),
                                                  jnp.asarray(rd), jnp.asarray(rgb),
                                                  jnp.asarray(img))
        net = o.nets[m]
        net.zero_grad(set_to_none=True)
        out = o._render_level(m, ro_t, rd_t, fg_z_max, prev,
                              ref_uniforms(keys[m], m, N_RAYS, n))
        loss = o._loss(net, out["rgb"], rgb_t, img_t)
        loss.backward()
        assert abs(float(loss.detach()) - loss_r) <= 1e-5 * abs(loss_r)
        want = convert.nerfpp_params_from_numpy((_np(g_r),))[0]
        grads = {k: p.grad for k, p in net.named_parameters()}
        assert set(grads) == set(want) and ("autoexpo" in grads) == autoexpo
        for k, g in grads.items():
            ref_norm = float(want[k].norm())
            assert ref_norm > 0, k
            assert float((g - want[k]).norm()) <= GRAD_TOL * ref_norm, (m, k)
        prev, prev_r = {k: v.detach() for k, v in out.items()}, prev_r_next


def test_nerfnet_autoexpo_table_and_converter_round_trip():
    cfg = ours.NerfPPConfig(**SMALL, optim_autoexpo=True)
    net = ours.NerfNet(cfg, n_images=4)
    np.testing.assert_array_equal(net.autoexpo.detach().numpy(), np.tile([[0.5, 0.0]], (4, 1)))
    assert ours.NerfNet(cfg, n_images=0).autoexpo is None
    # base_remap is W -> 256 whatever W is; rgb0 takes 256 + view channels
    assert net.fg.base_remap.out_features == 256 and net.fg.rgb0.in_features == 256 + 15
    assert net.fg.base[5].in_features == 32 + 27 and net.bg.base[5].in_features == 32 + 36
    params = convert.nerfpp_params_to_numpy([net])
    ref_params = ref.init_nerfpp(jax.random.PRNGKey(0), ref.NerfPPConfig(**SMALL,
                                                                         optim_autoexpo=True), 4)
    assert jax.tree_util.tree_structure(params[0]) == jax.tree_util.tree_structure(
        _np(ref_params))
    for a, b in zip(jax.tree_util.tree_leaves(params[0]),
                    jax.tree_util.tree_leaves(_np(ref_params))):
        assert a.shape == b.shape and a.dtype == np.float32
    back = convert.nerfpp_params_from_numpy(params)[0]
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())

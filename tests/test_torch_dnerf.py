"""Port parity: the D-NeRF fields of flnerf_tpu_torch (models/dnerf.py) and
the time path of its NGP renderer (render/ngp.py ``times``, ``time``) and
sampler against the reference (flnerf_tpu/models/dnerf.py, render/ngp.py,
train/ngp_trainer.py), on inputs drawn with numpy from a seed.  Weights
cross with core/convert.py's D-NeRF converters; the reference's draws are
taken from its keys and fed to the port.

Small widths: a canonical grid of 4 levels x 2^10 (the packed engine; the
hyper grid 4-D on the same numbers), MLPs of 2-3 x 32, a 16^3 occupancy
grid, 32 candidates and 16 kept samples.  The tables are scaled from their
U(-1e-4, 1e-4) init to O(1) so the encoding carries weight.  Tolerances as
tests/test_torch_ngp.py holds the NGP field: f32 1e-5, bf16 2e-2 (a sum on
the other side of a bf16 rounding boundary moves an activation by one bf16
ulp); gradients within that share of their largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flnerf_tpu.data.synthetic import load_synthetic_data
from flnerf_tpu.models import dnerf as ref_d
from flnerf_tpu.models import hash_ngp as ref_m
from flnerf_tpu.rays.camera import intrinsics_matrix
from flnerf_tpu.render import ngp as ref_r
from flnerf_tpu.train import ngp_trainer as ref_t
from flnerf_tpu_torch.core import convert
from flnerf_tpu_torch.models import dnerf as d
from flnerf_tpu_torch.models import hash_ngp as m
from flnerf_tpu_torch.render import ngp as r
from flnerf_tpu_torch.train import ngp_trainer as t_ngp

torch.set_num_threads(1)

VARIANTS = ["deform", "basis", "hyper"]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
NGP_KW = dict(num_levels=4, log2_hashmap_size=10, desired_resolution=64, bound=1.0)
SMALL = dict(num_layers_deform=3, hidden_dim_deform=32, deform_multires=4, time_multires=3,
             num_layers_basis=2, hidden_dim_basis=32, sigma_basis_dim=8, color_basis_dim=4,
             num_layers_ambient=2, hidden_dim_ambient=32)
RCFG = dict(n_candidates=32, n_keep=16, grid_size=16, bound=1.0)


def configs(variant, ngp_kw=NGP_KW):
    return (ref_d.DNeRFConfig(ngp=ref_m.NGPConfig(**ngp_kw), variant=variant, **SMALL),
            d.DNeRFConfig(ngp=m.NGPConfig(**ngp_kw), variant=variant, **SMALL))


def ref_params(variant, dtype="f32", seed=0, ngp_kw=NGP_KW):
    """The reference's (density_fn, rgb_fn) and numpy params, the table(s)
    scaled to O(1)."""
    cfg, _ = configs(variant, ngp_kw)
    init_fn, density_fn, rgb_fn = ref_d.make_dnerf_variant_field(cfg, DTYPES[dtype][0])
    params = jax.tree_util.tree_map(np.asarray, init_fn(jax.random.PRNGKey(seed)))
    holder = params["canonical"] if variant == "deform" else params
    holder["table"] = jax.tree_util.tree_map(lambda t: t * np.float32(1e4), holder["table"])
    return density_fn, rgb_fn, params


def port_field(variant, params, dtype="f32", ngp_kw=NGP_KW):
    field = d.make_dnerf_variant_field(configs(variant, ngp_kw)[1], DTYPES[dtype][1])
    convert.load_dnerf_params(field, params)
    return field


def jtree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def grad_list(field, grads):
    return [g.numpy() for g in convert.dnerf_params_from_numpy(
        field, jax.tree_util.tree_map(np.asarray, grads))]


def unit_dirs(rng, n):
    v = rng.standard_normal((n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_config_matches_reference():
    assert d.DNeRFConfig._fields == ref_d.DNeRFConfig._fields
    assert tuple(d.DNeRFConfig())[1:] == tuple(ref_d.DNeRFConfig())[1:]
    assert tuple(d.DNeRFConfig().ngp) == tuple(ref_d.DNeRFConfig().ngp)


@pytest.mark.parametrize("variant", VARIANTS)
def test_converters_round_trip_the_reference_tree(variant):
    _, _, params = ref_params(variant)
    field = port_field(variant, params)
    back = convert.dnerf_params_to_numpy(field)
    assert (jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    geo = {"deform": 15, "basis": 15 + 4, "hyper": 15}[variant]
    _, g = field.density(torch.zeros((5, 3)), torch.zeros(5))
    assert g.shape == (5, geo)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_field_matches(variant, dtype):
    """sigma, geo and rgb of points at per-point times, and the gradient of
    a loss of both in every parameter (the deform net's through the
    encoding's point gradient, the reference's CPU path)."""
    density_fn, rgb_fn, params = ref_params(variant, dtype)
    field = port_field(variant, params, dtype)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (32, 8, 3)).astype(np.float32)
    t = rng.random((32, 8)).astype(np.float32)
    dd = unit_dirs(rng, 32 * 8).reshape(32, 8, 3)
    a, b = rng.random((32, 8)).astype(np.float32), rng.random((32, 8, 3)).astype(np.float32)

    @jax.jit
    def ref_loss(p):
        s, geo = density_fn(p, jnp.asarray(x), jnp.asarray(t))
        rgb = rgb_fn(p, jnp.asarray(dd), geo)
        return jnp.sum(jnp.log1p(s) * a) + jnp.sum(rgb * b), (s, geo, rgb)

    (_, (s_r, geo_r, rgb_r)), g_r = jax.value_and_grad(ref_loss, has_aux=True)(jtree(params))
    s, geo = field.density(torch.from_numpy(x), torch.from_numpy(t))
    rgb = field.color(torch.from_numpy(dd), geo)
    loss = torch.sum(torch.log1p(s) * torch.from_numpy(a)) + torch.sum(rgb * torch.from_numpy(b))
    grads = torch.autograd.grad(loss, list(field.parameters()))
    tol = TOL[dtype]
    assert s.shape == (32, 8) and rgb.shape == (32, 8, 3)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(s_r), rtol=tol["rtol"])
    np.testing.assert_allclose(geo.detach().numpy(), np.asarray(geo_r), **tol)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_r), **tol)
    for ours, theirs in zip(grads, grad_list(field, g_r)):
        scale = float(np.abs(theirs).max())
        assert scale > 0
        np.testing.assert_allclose(ours.numpy(), theirs, atol=tol["atol"] * scale)
    # the variant uses its time: the same points at t = 0 and t = 1 differ
    with torch.no_grad():
        s0, g0 = field.density(torch.from_numpy(x), torch.zeros(32, 8))
        s1, g1 = field.density(torch.from_numpy(x), torch.ones(32, 8))
        c0 = field.color(torch.from_numpy(dd), g0)
        c1 = field.color(torch.from_numpy(dd), g1)
    assert float((s0 - s1).abs().max()) > 0 or float((c0 - c1).abs().max()) > 1e-6


def test_basis_on_a_split_table():
    """A split table at 2^16 (the sorted engine's SplitHashSpec: 4 small and
    2 big levels) through the basis variant (tests/test_dnerf.py:153): the
    tuple table crosses and both tables get the reference's gradient."""
    kw = dict(num_levels=6, base_resolution=4, desired_resolution=64, log2_hashmap_size=16,
              bound=1.0, hidden_dim=16, hidden_dim_color=16, hash_engine="sorted")
    # the port's weights carried to the reference, the tables scaled to O(1)
    ref_cfg, cfg = configs("basis", kw)
    _, density_fn, rgb_fn = ref_d.make_dnerf_variant_field(ref_cfg, jnp.float32)
    field = d.make_dnerf_variant_field(cfg, torch.float32, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in (field.table_small, field.table_big):
            p.mul_(1e4)
    params = convert.dnerf_params_to_numpy(field)
    assert isinstance(params["table"], tuple) and m.engine_kind(field.spec) == "sorted"
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    t = np.full((64,), 0.25, np.float32)
    dd = unit_dirs(rng, 64)

    @jax.jit
    def ref_loss(p):
        s, geo = density_fn(p, jnp.asarray(x), jnp.asarray(t))
        return jnp.sum(s) + jnp.sum(rgb_fn(p, jnp.asarray(dd), geo)), s

    (_, s_r), g_r = jax.value_and_grad(ref_loss, has_aux=True)(jtree(params))
    s, geo = field.density(torch.from_numpy(x), torch.from_numpy(t))
    loss = torch.sum(s) + torch.sum(field.color(torch.from_numpy(dd), geo))
    grads = torch.autograd.grad(loss, list(field.parameters()))
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(s_r), rtol=1e-5)
    theirs = grad_list(field, g_r)
    assert np.abs(theirs[0]).sum() > 0 and np.abs(theirs[1]).sum() > 0
    for ours, want in zip(grads, theirs):
        np.testing.assert_allclose(ours.numpy(), want, atol=1e-5 * np.abs(want).max())


def occ_pair(rcfg, seed=5):
    rng = np.random.default_rng(seed)
    dens = (rng.random((16, 16, 16)) * 0.05).astype(np.float32)
    dens[rng.random((16, 16, 16)) < 0.5] = 0.0
    ref = ref_r.with_density(ref_r.init_occupancy(rcfg), jnp.asarray(dens), rcfg)
    return ref, convert.occupancy_from_numpy(dens, float(ref.mean_density), rcfg)


def rays(n, seed=6):
    rng = np.random.default_rng(seed)
    u = unit_dirs(rng, n)
    dd = -u + 0.3 * rng.standard_normal((n, 3)).astype(np.float32)
    return (2.5 * u).astype(np.float32), dd / np.linalg.norm(dd, axis=-1, keepdims=True)


@pytest.mark.parametrize("variant", VARIANTS)
def test_render_with_times_matches(variant):
    """ngp_render_rays with per-ray times: rgb, depth, acc and the
    gradients, with the reference's perturbation fed in."""
    density_fn, rgb_fn, params = ref_params(variant)
    field = port_field(variant, params)
    rcfg = r.NGPRenderConfig(**RCFG)
    occ_ref, occ = occ_pair(rcfg)
    o, dd = rays(64)
    times = np.random.default_rng(7).random(64).astype(np.float32)
    key = jax.random.PRNGKey(8)
    noise = np.array(jax.random.uniform(key, (64, 32)))
    w = np.random.default_rng(9).random((64, 3)).astype(np.float32)

    @jax.jit
    def ref_loss(p):
        out = ref_r.ngp_render_rays(key, p, density_fn, rgb_fn, occ_ref, jnp.asarray(o),
                                    jnp.asarray(dd), rcfg, perturb=True,
                                    times=jnp.asarray(times))
        return jnp.sum(out["rgb"] * w) + jnp.sum(out["depth"]) * 0.1, out

    (_, want), g_r = jax.value_and_grad(ref_loss, has_aux=True)(jtree(params))
    out = r.ngp_render_rays(field, occ, torch.from_numpy(o), torch.from_numpy(dd), rcfg,
                            perturb=True, noise=torch.from_numpy(noise),
                            times=torch.from_numpy(times))
    loss = torch.sum(out["rgb"] * torch.from_numpy(w)) + torch.sum(out["depth"]) * 0.1
    grads = torch.autograd.grad(loss, list(field.parameters()))
    for k in ("rgb", "acc", "depth"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want[k]), atol=1e-5)
    assert float(out["acc"].detach().max()) > 0.1
    for ours, theirs in zip(grads, grad_list(field, g_r)):
        scale = float(np.abs(theirs).max())
        np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-4 * scale)


@pytest.mark.parametrize("partial", [False, True])
def test_refresh_at_a_fed_time_matches(partial):
    """The reference trainer's refresh (its occ_fn: kt, ku = split(key), t ~
    U(kt), then update_occupancy with ku) against the port's refresh fed
    that t and ku's draws: one time for every cell."""
    density_fn, rgb_fn, params = ref_params("deform")
    field = port_field("deform", params)
    rcfg = r.NGPRenderConfig(**RCFG, decay=0.9)
    occ_ref, occ = occ_pair(rcfg, seed=3)
    key = jax.random.PRNGKey(4)
    kt, ku = jax.random.split(key)
    tval = float(jax.random.uniform(kt, ()))

    def at_t(p, x):
        return density_fn(p, x, jnp.full(x.shape[:-1], tval))

    want = ref_r.update_occupancy(occ_ref, jtree(params), at_t, ku, rcfg, chunk=1024,
                                  partial=partial)
    if partial:
        kp, kj = jax.random.split(ku)
        parity = torch.from_numpy(np.array(jax.random.randint(kp, (3,), 0, 2)))
        jitter = np.array(jax.random.uniform(kj, (8 ** 3, 3)))
    else:
        parity, jitter = None, np.array(jax.random.uniform(ku, (16 ** 3, 3)))
    got = r.update_occupancy(occ, field, rcfg, chunk=1024, partial=partial,
                             jitter=torch.from_numpy(jitter), parity=parity,
                             time=torch.tensor(tval))
    np.testing.assert_allclose(got.density.numpy(), np.asarray(want.density), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    other = r.update_occupancy(occ, field, rcfg, chunk=1024, partial=partial,
                               jitter=torch.from_numpy(jitter), parity=parity, time=1.0 - tval)
    assert not torch.equal(other.density, got.density)


def test_render_image_at_a_time_matches():
    density_fn, rgb_fn, params = ref_params("deform")
    field = port_field("deform", params)
    rcfg = r.NGPRenderConfig(**RCFG)
    occ_ref, occ = occ_pair(rcfg, seed=9)
    _, poses, _, _, _ = load_synthetic_data(n_train=1, n_test=0, H=4, W=4)
    c2w = poses[0][:3, :4].copy()
    c2w[:, 3] *= 0.6
    K = intrinsics_matrix(10, 12, 11.0)
    want = ref_r.ngp_render_image(jtree(params), density_fn, rgb_fn, occ_ref, rcfg, 10, 12, K,
                                  c2w, chunk=256, time=0.7)
    got = r.ngp_render_image(field, occ, rcfg, 10, 12, K, c2w, chunk=256, time=0.7)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5)
    at_0 = r.ngp_render_image(field, occ, rcfg, 10, 12, K, c2w, chunk=256, time=0.0)
    assert np.abs(at_0[0] - got[0]).max() > 0


def test_sampler_times_bit_equal():
    """The sampler's times ride on its draws without drawing: the rays and
    the [n_steps, batch] times equal the reference's."""
    images, poses, _, hwf, _ = load_synthetic_data(n_train=3, n_test=0, H=16, W=16)
    K = intrinsics_matrix(16, 16, hwf[2])
    times = np.linspace(0, 1, 3, dtype=np.float32)
    s_ref = ref_t.NGPSampler(images, poses, K, ref_t.NGPTrainConfig(), seed=5, times=times)
    s = t_ngp.NGPSampler(images, poses, K, t_ngp.NGPTrainConfig(), seed=5, times=times)
    for _ in range(3):
        want, got = s_ref.sample_chunk(4, 50), s.sample_chunk(4, 50)
        assert len(got) == 6
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert len(t_ngp.NGPSampler(images, poses, K, t_ngp.NGPTrainConfig()).sample_chunk(1, 8)) == 5

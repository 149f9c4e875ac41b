"""Port parity: the TensoRF VM field of flnerf_tpu_torch (models/tensorf.py),
its samplers, upsample, shrink and L1 loss, core/losses.eff_distloss and
the TensoRF-family converters, against the reference
(flnerf_tpu/models/tensorf.py, core/losses.py).  Small widths: resolution
16-24, ranks 2-8, a 12-wide colour feature, a 2 x 32 colour MLP; the same
numpy inputs through both packages, the weights carried across with
core/convert.py.

Tolerances: the samplers 1e-6 (the same f32 arithmetic); the field in f32
1e-5 relative for sigma and 1e-5 absolute for the feature and rgb, its
gradients 1e-4 of the largest entry; in bf16 the feature and rgb 1e-2
(a column whose f32 value differs by an ulp may round to the next bf16
value, 2^-8 relative), sigma (all f32) 1e-5, the gradients 1e-2 of the
largest entry; upsample 1e-6; shrink exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flnerf_tpu.core import losses as ref_losses
from flnerf_tpu.models import tensorf as ref_tf
from flnerf_tpu.models import tensorf_variants as ref_v
from flnerf_tpu_torch.core import convert, losses
from flnerf_tpu_torch.models import tensorf as tf
from flnerf_tpu_torch.models import tensorf_variants as tv

torch.set_num_threads(1)

SMALL = dict(resolution=(16, 20, 24), sigma_rank=(2, 3, 4), color_rank=(4, 6, 8),
             color_feat_dim=12, num_layers=2, hidden_dim=32, bound=1.0)
AABB = (-0.9, -0.7, -0.8, 0.6, 0.9, 0.7)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def jtree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def vm_pair(dtype="f32", aabb=None, seed=0):
    """(reference density_fn, rgb_fn, numpy params, the port's field): the
    port's field drawn from a seeded generator, its tree the reference's
    params."""
    _, density_fn, rgb_fn = ref_tf.make_tensorf_field(ref_tf.TensoRFConfig(**SMALL, aabb=aabb),
                                                      DTYPES[dtype][0])
    field = tf.TensoRFField(tf.TensoRFConfig(**SMALL, aabb=aabb), DTYPES[dtype][1],
                            torch.Generator().manual_seed(seed))
    return density_fn, rgb_fn, convert.tensorf_params_to_numpy(field), field


def points(n, seed=1, lo=-1.1, hi=1.1):
    """[n, 3] points, some outside [-1, 1] (clamped), one at each corner."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    x[:2] = [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]
    return x


def unit_dirs(n, seed=2):
    d = np.random.default_rng(seed).standard_normal((n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def field_outputs_and_grads(density_fn, rgb_fn, params, field, x, d):
    """sigma, feature, rgb and the gradient trees of one weighted loss,
    through both packages: ((ref outputs, ref grads), (port outputs, port
    grads))."""
    rng = np.random.default_rng(3)
    ws = [rng.standard_normal(s).astype(np.float32) for s in (x.shape[:-1], x.shape[:-1] + (3,))]

    def ref_loss(p):
        s, f = density_fn(p, jnp.asarray(x))
        rgb = rgb_fn(p, jnp.asarray(d), f)
        return jnp.sum(s * ws[0]) * 1e-2 + jnp.sum(f) + jnp.sum(rgb * ws[1]), (s, f, rgb)

    (_, ref_out), g_ref = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(jtree(params))
    s, f = field.density(torch.from_numpy(x))
    rgb = field.color(torch.from_numpy(d), f)
    loss = (torch.sum(s * torch.from_numpy(ws[0])) * 1e-2 + torch.sum(f)
            + torch.sum(rgb * torch.from_numpy(ws[1])))
    grads = torch.autograd.grad(loss, list(field.parameters()))
    ours = [t.detach().numpy() for t in (s, f, rgb)]
    return ([np.asarray(a, np.float32) for a in ref_out], np_tree(g_ref)), (
        ours, convert.tensorf_params_to_numpy(field, grads))


def assert_fields_match(ref, ours, dtype):
    (ref_out, g_ref), (out, g) = ref, ours
    out_tol = 1e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(out[0], ref_out[0], rtol=1e-5, atol=1e-6)
    for a, b in zip(out[1:], ref_out[1:]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=out_tol * max(1.0, np.abs(b).max()))
    grad_tol = 1e-4 if dtype == "f32" else 1e-2
    flat_ref = jax.tree_util.tree_leaves(g_ref)
    flat = jax.tree_util.tree_leaves(g)
    assert len(flat) == len(flat_ref)
    for a, b in zip(flat, flat_ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=grad_tol * max(np.abs(b).max(), 1e-6))


def test_configs_match_reference():
    for ours, theirs in ((tf.TensoRFConfig(), ref_tf.TensoRFConfig()),
                         (tv.CPConfig(), ref_v.CPConfig()),
                         (tv.CCNeRFConfig(), ref_v.CCNeRFConfig())):
        assert ours._asdict() == theirs._asdict()
    assert tv.CCNeRFConfig().K == ref_v.CCNeRFConfig().K == 3


@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 16, 16)])
def test_samplers_match(shape):
    """Random coordinates, coordinates at -1 and +1 exactly, and beyond."""
    rng = np.random.default_rng(0)
    plane = rng.standard_normal(shape).astype(np.float32)
    line = rng.standard_normal(shape[:2]).astype(np.float32)
    u = rng.uniform(-1.0, 1.0, 200).astype(np.float32)
    v = rng.uniform(-1.0, 1.0, 200).astype(np.float32)
    u[:6] = [-1.0, 1.0, -1.0, 1.0, 1.02, -1.02]
    v[:6] = [-1.0, 1.0, 1.0, -1.0, 0.0, 0.0]
    want = np.asarray(ref_tf._sample_plane(jnp.asarray(plane), jnp.asarray(u), jnp.asarray(v)))
    got = tf.sample_plane(torch.from_numpy(plane), torch.from_numpy(u), torch.from_numpy(v)).T
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(got.numpy()[:, 0], plane[:, 0, 0], atol=1e-6)
    np.testing.assert_allclose(got.numpy()[:, 1], plane[:, -1, -1], atol=1e-6)
    want = np.asarray(ref_tf._sample_line(jnp.asarray(line), jnp.asarray(u)))
    got = tf.sample_line(torch.from_numpy(line), torch.from_numpy(u)).T
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(got.numpy()[:, :2], line[:, [0, -1]], atol=1e-6)


@pytest.mark.parametrize("aabb", [None, AABB])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vm_field_matches(dtype, aabb):
    density_fn, rgb_fn, params, field = vm_pair(dtype, aabb)
    x = points(300).reshape(20, 15, 3)
    d = unit_dirs(300).reshape(20, 15, 3)
    assert_fields_match(*field_outputs_and_grads(density_fn, rgb_fn, params, field, x, d),
                        dtype)
    assert [p.shape for p in field.sigma_mat] == [(2, 20, 16), (3, 24, 16), (4, 24, 20)]


def test_norm_coords_matches():
    x = points(50)
    for aabb in (None, AABB):
        want = ref_tf.norm_coords(jnp.asarray(x), ref_tf.TensoRFConfig(bound=2.0, aabb=aabb))
        got = tf.norm_coords(torch.from_numpy(x), tf.TensoRFConfig(bound=2.0, aabb=aabb))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("new_res", [(24, 30, 36), (16, 20, 24), (11, 33, 17)])
def test_upsample_matches(new_res):
    """Align-corners resize (up, the same size, and mixed down/up)."""
    _, _, params, field = vm_pair()
    cfg = ref_tf.TensoRFConfig(**SMALL)
    want, want_cfg = ref_tf.upsample_tensorf(jtree(params), cfg, new_res)
    got = tf.upsample_tensorf(field, new_res)
    assert got.cfg._asdict() == want_cfg._asdict()
    tree = convert.tensorf_params_to_numpy(got)
    for k in ("sigma_mat", "sigma_vec", "color_mat", "color_vec"):
        for a, b in zip(tree[k], want[k]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
    np.testing.assert_array_equal(tree["basis"], params["basis"])
    for a, b in zip(tree["color_net"], params["color_net"]):
        np.testing.assert_array_equal(a, b)


def _occupancy(g=16, seed=0, box=((3, 12), (5, 9), (2, 14))):
    rng = np.random.default_rng(seed)
    dens = (rng.random((g, g, g)) * 0.005).astype(np.float32)
    (x0, x1), (y0, y1), (z0, z1) = box
    dens[x0:x1, y0:y1, z0:z1] += 0.5
    return dens


@pytest.mark.parametrize("aabb", [None, AABB])
def test_shrink_matches(aabb):
    _, _, params, field = vm_pair(aabb=aabb)
    dens = _occupancy()
    cfg = ref_tf.TensoRFConfig(**SMALL, aabb=aabb)
    want, want_cfg = ref_tf.shrink_tensorf(jtree(params), cfg, dens, float(dens.mean()), 1.0)
    got = tf.shrink_tensorf(field, dens, float(dens.mean()), 1.0)
    assert got.cfg._asdict() == want_cfg._asdict()
    assert got.cfg.resolution != field.cfg.resolution
    tree = convert.tensorf_params_to_numpy(got)
    for k in ("sigma_mat", "sigma_vec", "color_mat", "color_vec"):
        for a, b in zip(tree[k], want[k]):
            assert a.shape == np.asarray(b).shape
            np.testing.assert_array_equal(a, np.asarray(b))
    # the shrunk field answers as the reference's
    density_fn = ref_tf.make_tensorf_field(want_cfg, jnp.float32)[1]
    x = points(64, lo=-0.5, hi=0.5)
    s_ref, f_ref = density_fn(want, jnp.asarray(x))
    s, f = got.density(torch.from_numpy(x))
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(s_ref), rtol=1e-5)
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(f_ref), atol=1e-5)


def test_shrink_of_an_empty_grid_is_a_no_op():
    _, _, params, field = vm_pair()
    dens = np.zeros((16, 16, 16), np.float32)
    want, want_cfg = ref_tf.shrink_tensorf(jtree(params), ref_tf.TensoRFConfig(**SMALL),
                                           dens, 0.0, 1.0)
    assert want_cfg == ref_tf.TensoRFConfig(**SMALL)
    assert tf.shrink_tensorf(field, dens, 0.0, 1.0) is field


def test_density_l1_loss_matches():
    _, _, params, field = vm_pair()
    want = ref_tf.density_l1_loss(jtree(params))
    got = tf.density_l1_loss(field)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    g = torch.autograd.grad(got, list(field.sigma_mat))
    g_ref = jax.grad(ref_tf.density_l1_loss)(jtree(params))["sigma_mat"]
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("shape", [(7, 16), (3, 5, 33)])
def test_eff_distloss_matches(shape):
    rng = np.random.default_rng(4)
    w = rng.random(shape).astype(np.float32)
    m = np.sort(rng.random(shape), -1).astype(np.float32)
    dt = rng.random(shape).astype(np.float32) * 0.1
    want, g_ref = jax.value_and_grad(ref_losses.eff_distloss, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(m), jnp.asarray(dt))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (w, m, dt)]
    got = losses.eff_distloss(*args)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    # the O(N^2) pairwise form it replaces, in float64
    pair = np.abs(m[..., :, None].astype(np.float64) - m[..., None, :])
    direct = (np.einsum("...i,...j,...ij->...", w, w, pair)
              + np.sum(w.astype(np.float64) ** 2 * dt, -1) / 3.0)
    np.testing.assert_allclose(float(got.detach()), direct.mean(), rtol=1e-4)
    for a, b in zip(torch.autograd.grad(got, args), g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-7)


def _ref_trees():
    """A VM, a CP and a CCNeRF params tree in the reference's structure and
    shapes (its init traced by ``jax.eval_shape``, filled from numpy), with
    the port's field of each."""
    vm = ref_tf.TensoRFConfig(**SMALL)
    cp = ref_v.CPConfig(resolution=(16, 20, 24), sigma_rank=4, color_rank=6,
                        color_feat_dim=12, num_layers=2, hidden_dim=32)
    cc = ref_v.CCNeRFConfig(resolution=(16, 20, 24), rank_vec_density=(2, 4),
                            rank_mat_density=(1, 2), rank_vec=(2, 4), rank_mat=(1, 3),
                            color_feat_dim=12, num_layers=2, hidden_dim=32)
    out = {}
    for name, init, cls, cfg in (("vm", ref_tf.init_tensorf, tf.TensoRFField, vm),
                                 ("cp", ref_v.init_cp, tv.CPField, cp),
                                 ("ccnerf", ref_v.init_ccnerf, tv.CCNeRFField, cc)):
        shapes = jax.eval_shape(functools.partial(init, cfg=cfg), jax.random.PRNGKey(5))
        rng = np.random.default_rng(5)
        params = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)
        port_cfg = {"vm": tf.TensoRFConfig, "cp": tv.CPConfig,
                    "ccnerf": tv.CCNeRFConfig}[name](**cfg._asdict())
        out[name] = (params, cls(port_cfg, torch.float32, torch.Generator().manual_seed(0)))
    return out


@pytest.mark.parametrize("kind", ["vm", "cp", "ccnerf"])
def test_converters_round_trip(kind):
    """The reference's tree -> tensors in the field's parameter order ->
    the tree again, shape for shape and bit for bit; the port's own
    fields register the same keys and shapes."""
    params, field = _ref_trees()[kind]
    tensors = convert.tensorf_params_from_numpy(field, params)
    assert [t.shape for t in tensors] == [p.shape for p in field.parameters()]
    back = convert.tensorf_params_to_numpy(field, tensors)
    assert sorted(back) == sorted(params)
    for k in params:
        a, b = back[k], params[k]
        if isinstance(b, list):
            assert isinstance(a, list) and len(a) == len(b)
        else:
            a, b = [a], [b]
        for x, y in zip(a, b):
            assert x.dtype == np.float32 and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    own = convert.tensorf_params_to_numpy(field)
    assert jax.tree_util.tree_structure(own) == jax.tree_util.tree_structure(params)
    assert [a.shape for a in jax.tree_util.tree_leaves(own)] == [
        a.shape for a in jax.tree_util.tree_leaves(params)]

"""Port parity: the CP and CCNeRF fields and the composed CCNeRF scene of
flnerf_tpu_torch (models/tensorf_variants.py) against the reference
(flnerf_tpu/models/tensorf_variants.py), and CCNeRF objects written by one
package and read by the other (cli/main_ccnerf.py).  Small widths:
resolution 16-24, ranks 2-8, a 12-wide colour feature, a 2 x 32 colour
MLP; the weights drawn by the port and carried across as the reference's
tree.  Tolerances are those of tests/test_torch_tensorf.py (f32: sigma
1e-5 relative, feature and rgb 1e-5, gradients 1e-4 of the largest entry;
bf16: 1e-2 for the feature, rgb and gradients)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flnerf_tpu.cli import main_ccnerf as ref_cli
from flnerf_tpu.models import tensorf_variants as ref_v
from flnerf_tpu_torch.cli import main_ccnerf
from flnerf_tpu_torch.core import convert
from flnerf_tpu_torch.models import tensorf_variants as tv
from test_torch_tensorf import (
    DTYPES,
    assert_fields_match,
    field_outputs_and_grads,
    jtree,
    points,
    unit_dirs,
)

torch.set_num_threads(1)

CP = dict(resolution=(16, 20, 24), sigma_rank=4, color_rank=6, color_feat_dim=12,
          num_layers=2, hidden_dim=32, bound=1.0)
CC = dict(resolution=(16, 20, 24), rank_vec_density=(2, 4, 8), rank_mat_density=(1, 2, 3),
          rank_vec=(2, 5, 8), rank_mat=(1, 2, 4), color_feat_dim=12, num_layers=2,
          hidden_dim=32, bound=1.0)


def cc_field(dtype="f32", seed=0, **kw):
    cfg = tv.CCNeRFConfig(**{**CC, **kw})
    field = tv.CCNeRFField(cfg, DTYPES[dtype][1], torch.Generator().manual_seed(seed))
    with torch.no_grad():       # scales off their ones init, so they carry weight
        field.sigma_vec_scale.mul_(torch.linspace(0.5, 1.5, field.sigma_vec_scale.numel()))
        for s in field.sigma_mat_scale:
            s.mul_(torch.linspace(1.2, 0.8, s.numel()))
    return field


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cp_field_matches(dtype):
    _, density_fn, rgb_fn = ref_v.make_cp_field(ref_v.CPConfig(**CP), DTYPES[dtype][0])
    field = tv.CPField(tv.CPConfig(**CP), DTYPES[dtype][1], torch.Generator().manual_seed(1))
    params = convert.tensorf_params_to_numpy(field)
    x, d = points(300).reshape(20, 15, 3), unit_dirs(300).reshape(20, 15, 3)
    assert_fields_match(*field_outputs_and_grads(density_fn, rgb_fn, params, field, x, d),
                        dtype)


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ccnerf_field_matches_at_each_level(dtype, level):
    """The port's field with ``level`` set against the reference's field
    built at that level; ranks past the level get zero gradients on both."""
    field = cc_field(dtype)
    field.level = level
    _, density_fn, rgb_fn = ref_v.make_ccnerf_field(ref_v.CCNeRFConfig(**CC), level,
                                                    DTYPES[dtype][0])
    params = convert.tensorf_params_to_numpy(field)
    x, d = points(300, seed=7).reshape(20, 15, 3), unit_dirs(300).reshape(20, 15, 3)
    ref, ours = field_outputs_and_grads(density_fn, rgb_fn, params, field, x, d)
    assert_fields_match(ref, ours, dtype)
    if level < 3:
        dead = ours[1]["color_vec"][0][CC["rank_vec"][level - 1]:]
        assert dead.size and not dead.any()


def test_ccnerf_level_is_validated_and_shares_parameters():
    field = cc_field()
    assert field.level == 3
    params = [p.data_ptr() for p in field.parameters()]
    outs = []
    for level in (1, 2, 3, -1):
        field.level = level
        outs.append(field.density(torch.from_numpy(points(10)))[0].detach())
    assert field.level == 3
    assert [p.data_ptr() for p in field.parameters()] == params
    assert not torch.equal(outs[0], outs[2]) and torch.equal(outs[2], outs[3])
    for bad in (0, 4):
        with pytest.raises(ValueError, match="truncation level must be in 1..K=3"):
            field.level = bad
        with pytest.raises(ValueError, match="truncation level must be in 1..K=3"):
            ref_v.make_ccnerf_field(ref_v.CCNeRFConfig(**CC), bad)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_composed_field_matches(dtype):
    """Two objects of different colour widths, under an offset, a scale and
    one rotation: sigma, the packed per-object payload and rgb."""
    a = cc_field(dtype, seed=2)
    b = cc_field(dtype, seed=3, color_feat_dim=9)
    a.level = 1     # composition evaluates every object at its full K
    theta = 0.4
    rot = np.array([[np.cos(theta), -np.sin(theta), 0.0], [np.sin(theta), np.cos(theta), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    place = [(None, 1.0, np.array([0.1, -0.2, 0.0], np.float32)),
             (rot, 0.7, np.array([0.5, 0.0, 0.2], np.float32))]
    ours = tv.ComposedField([tv.ComposedObject(f, *p) for f, p in zip((a, b), place)])
    refs = [ref_v.ComposedObject(jtree(convert.tensorf_params_to_numpy(f)),
                                 ref_v.CCNeRFConfig(**f.cfg._asdict()), *p)
            for f, p in zip((a, b), place)]
    density_fn, rgb_fn = ref_v.compose_ccnerf_fields(refs, DTYPES[dtype][0])
    x, d = points(300, seed=8).reshape(20, 15, 3), unit_dirs(300).reshape(20, 15, 3)
    s_ref, packed_ref = density_fn(None, jnp.asarray(x))
    rgb_ref = rgb_fn(None, jnp.asarray(d), packed_ref)
    with torch.no_grad():
        s, packed = ours.density(torch.from_numpy(x))
        rgb = ours.color(torch.from_numpy(d), packed)
    tol = 1e-5 if dtype == "f32" else 1e-2
    assert packed.shape == (20, 15, 2 + 12 + 9) == packed_ref.shape
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5)
    np.testing.assert_allclose(packed.numpy(), np.asarray(packed_ref, np.float32),
                               atol=tol * np.abs(np.asarray(packed_ref)).max(), rtol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_ref, np.float32), atol=tol)
    assert ours.device == torch.device("cpu")


def test_objects_cross_between_the_packages(tmp_path):
    """An object.pkl written by the reference's ``_save_object`` loads in
    the port and gives the reference's density; one the port writes loads
    in the reference, tree for tree."""
    field = cc_field(seed=4)
    cfg = ref_v.CCNeRFConfig(**CC)
    params = convert.tensorf_params_to_numpy(field)
    path = str(tmp_path / "ref.pkl")
    ref_cli._save_object(path, jtree(params), cfg)
    ours = main_ccnerf.load_object(path, torch.float32)
    assert ours.cfg._asdict() == cfg._asdict() and ours.level == cfg.K
    x = points(200, seed=9)
    s_ref, f_ref = ref_v.ccnerf_density(jtree(params), jnp.asarray(x), cfg, cfg.K, jnp.float32)
    s, f = ours.density(torch.from_numpy(x))
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(s_ref), rtol=1e-5)
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(f_ref), atol=1e-5)

    path = str(tmp_path / "port.pkl")
    main_ccnerf.save_object(path, field)
    back, back_cfg = ref_cli.load_object(path)
    assert back_cfg == cfg
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)

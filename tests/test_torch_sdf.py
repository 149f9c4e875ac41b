"""Port parity: SDF fitting in flnerf_tpu_torch (models/sdf.py,
data/mesh_sdf.py, core/losses.py mape_loss, cli/main_sdf.py) against the
reference (flnerf_tpu/models/sdf.py, data/mesh_sdf.py, cli/main_sdf.py), on
inputs drawn with numpy from a seed.

Small widths: 4 levels x 2^10, an MLP of 2 x 32, batches of 512.
Tolerances:
  * the field against hash_encode_xla's path (f32): 1e-5 of the largest
    output, gradients 1e-5 of their largest entry; bf16 operands 2e-2;
  * against the Pallas kernel in interpret mode, which rounds the table
    (and the backward's w*g) to bf16: outputs 1e-2 of the largest, the
    table gradient 3e-2 norm-wise (the rounded table moves a few hidden
    units across their ReLU kinks; the reference's own XLA path is 1.7%
    from its Pallas path here, and the port within 1e-6 of the XLA path);
  * the batch sampler and the surface draws: equal;
  * MeshSDF (f32 arithmetic in another library): 1e-5;
  * G1, 60 Adam steps of both packages from the same weights on the same
    batches: loss histories within 1e-4 relative (5e-7 measured; at lr
    1e-2 the two runs drift apart to 1e-2 by step 60: Adam with eps 1e-15
    steps every entry by lr whatever its |g|, so rounding-level gradients
    take full steps), the meshes' mean vertex radii within 1e-3.
The CLIs run at full width on the CPU with few steps."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flnerf_tpu.data import mesh_sdf as ref_ms
from flnerf_tpu.models import sdf as ref_sdf
from flnerf_tpu_torch.cli import main_sdf
from flnerf_tpu_torch.core import convert
from flnerf_tpu_torch.core.losses import mape_loss
from flnerf_tpu_torch.data import mesh_sdf as ms
from flnerf_tpu_torch.models import sdf
from flnerf_tpu_torch.ops import hash_kernel as hk
from flnerf_tpu_torch.ops.marching import save_obj
from chip_smoke import icosphere

torch.set_num_threads(1)

SMALL = dict(num_levels=4, log2_hashmap_size=10, desired_resolution=64, num_layers=2,
             hidden_dim=32)
CUBE_V = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)],
                  np.float32)
CUBE_F = np.array([[0, 1, 3], [0, 3, 2], [4, 7, 5], [4, 6, 7], [0, 4, 5], [0, 5, 1],
                   [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)


def sphere(p):
    return np.linalg.norm(np.asarray(p), axis=-1) - 0.5


def ref_field(dtype=jnp.float32, backend="auto", seed=0):
    cfg = ref_sdf.SDFConfig(**SMALL, hash_backend=backend)
    init_fn, sdf_fn = ref_sdf.make_sdf_field(cfg, dtype)
    params = jax.tree_util.tree_map(np.asarray, init_fn(jax.random.PRNGKey(seed)))
    params["table"] = params["table"] * np.float32(1e4)
    return sdf_fn, params


def port_field(params, dtype=torch.float32, backend="auto"):
    field = sdf.SDFField(sdf.SDFConfig(**SMALL, hash_backend=backend), dtype)
    with torch.no_grad():
        for p, v in zip(field.parameters(), convert.sdf_params_from_numpy(params)):
            p.copy_(v)
    return field


def test_config_and_mape_loss_match():
    assert sdf.SDFConfig._fields == ref_sdf.SDFConfig._fields
    assert tuple(sdf.SDFConfig()) == tuple(ref_sdf.SDFConfig())
    rng = np.random.default_rng(0)
    pred, gt = rng.standard_normal(300).astype(np.float32), rng.standard_normal(300).astype(
        np.float32)
    gt[:5] = 0.0
    np.testing.assert_allclose(float(mape_loss(torch.from_numpy(pred), torch.from_numpy(gt))),
                               float(ref_sdf.mape_loss(jnp.asarray(pred), jnp.asarray(gt))),
                               rtol=1e-6)
    assert float(mape_loss(torch.tensor([1.0, 2.0]), torch.tensor([1.0, 1.0]))) == \
        pytest.approx(0.5 / 1.01, abs=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_field_matches_the_xla_path(dtype):
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    sdf_fn, params = ref_field(jd)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    gt = sphere(x).astype(np.float32)
    want, g_r = jax.value_and_grad(lambda p: ref_sdf.mape_loss(sdf_fn(p, jnp.asarray(x)),
                                                             jnp.asarray(gt)))(
        jax.tree_util.tree_map(jnp.asarray, params))
    pred_r = np.asarray(sdf_fn(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)))
    for backend in ("auto", "xla"):
        field = port_field(params, td, backend)
        pred = field(torch.from_numpy(x))
        loss = mape_loss(pred, torch.from_numpy(gt))
        grads = torch.autograd.grad(loss, list(field.parameters()))
        tol = 1e-5 if dtype == "f32" else 2e-2
        scale = float(np.abs(pred_r).max())
        np.testing.assert_allclose(pred.detach().numpy(), pred_r, atol=tol * scale)
        np.testing.assert_allclose(float(loss.detach()), float(want), rtol=tol)
        for ours, theirs in zip(grads, convert.sdf_params_from_numpy(
                jax.tree_util.tree_map(np.asarray, g_r))):
            s = float(theirs.abs().max())
            assert s > 0
            np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=tol * s)


def test_field_matches_the_pallas_kernel_in_interpret_mode():
    sdf_fn, params = ref_field(backend="pallas")
    x = np.random.default_rng(2).uniform(-1, 1, (300, 3)).astype(np.float32)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(sdf_fn(p, jnp.asarray(x)))
        g_r = jax.grad(lambda q: jnp.sum(sdf_fn(q, jnp.asarray(x))))(p)
    field = port_field(params)
    before = hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES
    got = field(torch.from_numpy(x))
    (g,) = torch.autograd.grad(got.sum(), [field.table])
    assert (hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES) == before     # the plain version
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-2 * np.abs(want).max())
    g_ref = convert.sdf_params_from_numpy(jax.tree_util.tree_map(np.asarray, g_r))[0].numpy()
    assert np.linalg.norm(g.numpy() - g_ref) <= 3e-2 * np.linalg.norm(g_ref)


@pytest.mark.parametrize("shape", ["sphere", "torus"])
def test_sample_sdf_batch_equal(shape):
    oracle = main_sdf._analytic_oracle(shape)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        got = sdf.sample_sdf_batch(r1, oracle, 1000, bound=1.0)
        want = ref_sdf.sample_sdf_batch(r2, oracle, 1000, bound=1.0)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_g1_sdf_fit_reaches_the_references_mesh():
    """Both packages fit 60 steps from the same weights on the same batches
    of 1024 (lr 5e-3): the loss histories agree and fall below half
    (0.675 -> 0.332), and the meshes' mean vertex radii agree (~0.77 at
    these widths: the sphere is 0.5)."""
    cfg = dict(SMALL, bound=1.0)
    t_ref = ref_sdf.SDFTrainer(ref_sdf.SDFConfig(**cfg), lr=5e-3)
    t = sdf.SDFTrainer(sdf.SDFConfig(**cfg), lr=5e-3, device="cpu")
    params = convert.sdf_params_to_numpy(list(t.field.parameters()))
    t_ref.params = jax.tree_util.tree_map(jnp.asarray, params)
    t_ref.opt_state = t_ref.tx.init(t_ref.params)
    want = t_ref.fit(sphere, steps=60, batch=1024, seed=0)
    got = t.fit(sphere, steps=60, batch=1024, seed=0)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < 0.5 * got[0]
    v_ref, _ = t_ref.extract_mesh(reso=32)
    v, f = t.extract_mesh(reso=32)
    assert len(v) and len(f)
    assert abs(np.linalg.norm(v, axis=-1).mean() - np.linalg.norm(v_ref, axis=-1).mean()) <= 1e-3


@pytest.mark.parametrize("mesh", ["cube", "sphere"])
def test_mesh_sdf_matches(mesh):
    verts, faces = (CUBE_V, CUBE_F) if mesh == "cube" else icosphere(2)
    rng = np.random.default_rng(4)
    p = rng.uniform(-1.2, 1.2, (700, 3)).astype(np.float32)
    ours = ms.MeshSDF(verts, faces, chunk=256, device="cpu")
    theirs = ref_ms.MeshSDF(verts, faces, chunk=256)
    got = ours(p)
    np.testing.assert_allclose(got, theirs(p), atol=1e-5)
    assert (got > 0).any() and (got < 0).any()
    if mesh == "sphere":   # within the faceting error of the analytic sphere
        assert np.abs(got + sphere(p)).max() < 0.02
    np.testing.assert_array_equal(ours.sample_surface(300, np.random.default_rng(5)),
                                  theirs.sample_surface(300, np.random.default_rng(5)))


def test_sdf_mesh_dataset_batches_match(tmp_path):
    path = str(tmp_path / "sphere.obj")
    save_obj(path, *icosphere(1))
    ours = ms.SDFMeshDataset(path, num_samples=256, clip_sdf=0.1, seed=0, device="cpu")
    theirs = ref_ms.SDFMeshDataset(path, num_samples=256, clip_sdf=0.1, seed=0)
    for _ in range(2):
        (p, s), (p_r, s_r) = ours.sample_batch(), theirs.sample_batch()
        np.testing.assert_array_equal(p, p_r)
        assert s.shape == (256, 1) and np.all(s[:128] == 0.0)
        np.testing.assert_allclose(s, s_r, atol=1e-5)


def test_loaders_match(tmp_path):
    obj = tmp_path / "quad.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 2\nvt 0 0\nvn 0 0 1\n"
                   "f 1/1/1 2/1/1 3/1/1 4/1/1\nf -1 1 2\n")
    ply = tmp_path / "face_first.ply"
    ply.write_text("\n".join([
        "ply", "format ascii 1.0", "element face 2", "property list uchar int vertex_indices",
        "element vertex 4", "property float x", "property float y", "property float z",
        "end_header", "3 0 1 2", "4 0 1 2 3", "0 0 0", "1 0 0", "0 1 0", "0.5 0.5 1"]) + "\n")
    for path in (obj, ply):
        got, want = ms.load_mesh(str(path)), ref_ms.load_mesh(str(path))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    v = CUBE_V * 3.0 + 1.0
    np.testing.assert_array_equal(ms.normalize_mesh(v), ref_ms.normalize_mesh(v))
    with pytest.raises(ValueError, match="unsupported"):
        ms.load_mesh("mesh.stl")


ARGS = ["--device", "cpu", "--batch", "256", "--mesh_reso", "24"]


def test_cli_sphere(tmp_path):
    res = main_sdf.main(["sphere", "--iters", "30", "--lr", "5e-3",
                         "--workspace", str(tmp_path)] + ARGS)
    assert res["trainer"].field.cfg == sdf.SDFConfig()          # full width
    assert len(res["losses"]) == 30 and res["losses"][-1] < res["losses"][0]
    assert res["n_verts"] > 0 and os.path.exists(tmp_path / "mesh.obj")


def test_cli_mesh_and_samples(tmp_path):
    mesh = str(tmp_path / "sphere.obj")
    save_obj(mesh, *icosphere(1))
    res = main_sdf.main([mesh, "--iters", "4", "--workspace", str(tmp_path / "m")] + ARGS)
    assert np.isfinite(res["loss"]) and os.path.exists(tmp_path / "m" / "mesh.obj")
    pts = np.random.default_rng(6).uniform(-1, 1, (4000, 3)).astype(np.float32)
    npz = str(tmp_path / "samples.npz")
    np.savez(npz, points=pts, sdf=sphere(pts).astype(np.float32))
    res = main_sdf.main([npz, "--iters", "4", "--workspace", str(tmp_path / "s")] + ARGS)
    assert np.isfinite(res["loss"]) and os.path.exists(tmp_path / "s" / "mesh.obj")

"""Port parity: mesh extraction in flnerf_tpu_torch (ops/marching.py, a
numpy copy of the reference's, and cli/extract_mesh.py) against the
reference (flnerf_tpu/ops/marching.py, flnerf_tpu/cli/extract_mesh.py).

Tolerances: the marching functions and the writers are host numpy in both
packages, so their meshes and files are equal bit for bit and byte for
byte; a Plenoxels .npz gives equal files; a NeRF .tar is queried in f32 by
torch and by XLA (sigma within 1e-4 of its largest value), so its mesh has
the reference's vertex and triangle counts and vertices within 1e-4."""

import numpy as np
import pytest
import torch

from flnerf_tpu.cli import extract_mesh as ref_cli
from flnerf_tpu.ops import marching as ref_mc
from flnerf_tpu_torch.cli import extract_mesh
from flnerf_tpu_torch.core.checkpoint import save_nerf_checkpoint
from flnerf_tpu_torch.models.nerf_mlp import make_nerf_mlp
from flnerf_tpu_torch.models.voxel_sh import VoxelGrid, VoxelGridConfig, save_npz
from flnerf_tpu_torch.ops import marching as mc

torch.set_num_threads(1)


def fields(reso=24):
    g = np.linspace(-1, 1, reso, dtype=np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    torus = 0.15 - np.sqrt((np.sqrt(X ** 2 + Y ** 2) - 0.45) ** 2 + Z ** 2)
    return {"sphere": 0.6 - r, "torus": torus.astype(np.float32)}, g


@pytest.mark.parametrize("shape", ["sphere", "torus"])
@pytest.mark.parametrize("algo", ["marching_cubes", "marching_tetrahedra"])
def test_marching_equals_the_reference(shape, algo):
    field, g = fields()
    kw = dict(iso=0.0, origin=(-1.0,) * 3, spacing=(float(g[1] - g[0]),) * 3)
    verts, tris = getattr(mc, algo)(field[shape], **kw)
    want_v, want_t = getattr(ref_mc, algo)(field[shape], **kw)
    assert len(verts) > 0 and len(tris) > 0
    for a, b in ((verts, want_v), (tris, want_t)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_writers_equal_byte_for_byte(tmp_path):
    field, g = fields(16)
    verts, tris = mc.marching_cubes(field["torus"], iso=0.0)
    for name in ("save_obj", "save_ply"):
        ours, theirs = tmp_path / f"a_{name}", tmp_path / f"b_{name}"
        getattr(mc, name)(str(ours), verts, tris)
        getattr(ref_mc, name)(str(theirs), verts, tris)
        assert ours.read_bytes() == theirs.read_bytes()


def test_extract_mesh_from_a_plenoxels_npz(tmp_path):
    reso = 20
    field, _ = fields(reso)
    density = torch.from_numpy(field["sphere"] * 100.0)
    alive = density > -30.0
    cfg = VoxelGridConfig(reso=(reso,) * 3, radius=(1.0,) * 3)
    path = str(tmp_path / "grid.npz")
    save_npz(path, VoxelGrid(density, torch.zeros((reso,) * 3 + (27,)), alive), cfg)
    for algo in ("cubes", "tetrahedra"):
        argv = ["--ckpt", path, "--sigma_thresh", "5", "--algo", algo, "--device", "cpu"]
        n = extract_mesh.main(argv + ["--out", str(tmp_path / f"a_{algo}.ply")])
        n_ref = ref_cli.main(argv[:-2] + ["--out", str(tmp_path / f"b_{algo}.ply")])
        assert n == n_ref and n[0] > 0
        assert ((tmp_path / f"a_{algo}.ply").read_bytes()
                == (tmp_path / f"b_{algo}.ply").read_bytes())


def test_extract_mesh_from_a_nerf_tar(tmp_path):
    """A coarse + fine .tar at D2 W32: the fine network is queried; the
    threshold is the median sigma so the surface is not empty."""
    torch.manual_seed(0)
    kw = dict(netdepth=2, netwidth=32, compute_dtype=torch.float32)
    coarse, fine = make_nerf_mlp(**kw), make_nerf_mlp(**kw)
    path = str(tmp_path / "001.tar")
    save_nerf_checkpoint(path, 1, 10, coarse, fine)
    sigma, _ = extract_mesh.density_grid_from_nerf(fine, 1.2, 16)
    thresh = str(float(np.median(sigma)))
    common = ["--ckpt", path, "--netdepth", "2", "--netwidth", "32", "--reso", "16",
              "--sigma_thresh", thresh]
    n = extract_mesh.main(common + ["--device", "cpu", "--out", str(tmp_path / "a.obj")])
    n_ref = ref_cli.main(common + ["--out", str(tmp_path / "b.obj")])
    assert n == n_ref and n[0] > 0

    def verts(p):
        return np.array([[float(t) for t in line.split()[1:]]
                         for line in p.read_text().splitlines() if line.startswith("v ")])

    np.testing.assert_allclose(verts(tmp_path / "a.obj"), verts(tmp_path / "b.obj"), atol=1e-4)
    coarse_sigma, _ = extract_mesh.density_grid_from_nerf(coarse, 1.2, 16)
    assert not np.array_equal(coarse_sigma, sigma)

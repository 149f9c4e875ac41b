"""The port stands alone: flnerf_tpu_torch and chip_smoke.py import neither
JAX nor the reference package, and its entry points run on the card or
raise."""

import ast
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flnerf_tpu_torch.models.voxel_sh import VoxelGridConfig, init_voxel_grid
from flnerf_tpu_torch.models.hash_ngp import NGPConfig
from flnerf_tpu_torch.ops import (
    _build,
    hash_kernel,
    hash_lattice,
    hash_sorted,
    sort_kernel,
    voxel_kernel,
)
from flnerf_tpu_torch.render.ngp import NGPRenderConfig
from flnerf_tpu_torch.train import ngp_trainer
from flnerf_tpu_torch.train import plenoxels_trainer as pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "flnerf_tpu_torch")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flnerf_tpu")


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import flnerf_tpu_torch\n"
        "for m in pkgutil.walk_packages(flnerf_tpu_torch.__path__, 'flnerf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flnerf_tpu')]\n"
        "print(len([n for n in sys.modules if n.startswith('flnerf_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 15, res.stdout


def test_no_source_imports_jax_or_the_reference_package():
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and node.args and isinstance(
                    node.args[0], ast.Constant) and isinstance(node.args[0].value, str) and (
                    getattr(node.func, "attr", getattr(node.func, "id", None))
                    in ("import_module", "__import__")):
                names = [node.args[0].value]
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{os.path.relpath(path, ROOT)}:{node.lineno} imports {bad}"


def test_cuda_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = VoxelGridConfig(reso=(8, 8, 8), max_steps=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.PlenoxelsTrainer(cfg, pt.PlenoxelsTrainConfig())
    from flnerf_tpu_torch.cli import main_nerf, opt
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt.main(["synthetic", "-t", str(tmp_path), "--reso", "[[8,8,8]]"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ngp_trainer.NGPTrainer(NGPConfig(num_levels=2, log2_hashmap_size=8),
                               NGPRenderConfig(grid_size=8), ngp_trainer.NGPTrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_nerf.main(["synthetic", "-O", "--iters", "4", "--workspace", str(tmp_path)])


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers never run a plain version: a CPU tensor is a
    caller error for them (only render_rays_fused dispatches by device)."""
    cfg = VoxelGridConfig(reso=(8, 8, 8), max_steps=8)
    g = init_voxel_grid(cfg)
    rays = voxel_kernel.ray_inputs(cfg, torch.zeros((4, 3)), torch.ones((4, 3)))
    before = voxel_kernel.FWD_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        voxel_kernel.cuvol_forward(*g, *rays, cfg)
    with pytest.raises(ValueError, match="CUDA tensors"):
        voxel_kernel.cuvol_backward(*g, *rays, torch.zeros((4, 8)), torch.zeros((4, 8)), cfg)
    assert voxel_kernel.FWD_LAUNCHES == before
    spec = hash_kernel.make_packed_spec(num_levels=2, log2_hashmap_size=8)
    x, table = torch.rand((4, 3)), torch.zeros((2, spec.t_cap, 2))
    before = hash_kernel.HASH_FWD_LAUNCHES, hash_kernel.HASH_BWD_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        hash_kernel.hash_encode_forward(x, table, spec)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hash_kernel.hash_encode_backward(x, torch.zeros((4, 4)), spec)
    assert (hash_kernel.HASH_FWD_LAUNCHES, hash_kernel.HASH_BWD_LAUNCHES) == before
    lspec = hash_lattice.make_lattice_spec(num_levels=6, log2_hashmap_size=16,
                                           desired_resolution=512)
    tb = torch.zeros((lspec.n_big, lspec.t_big, 2))
    before = (hash_lattice.LATTICE_FWD_LAUNCHES, hash_lattice.LATTICE_BWD_LAUNCHES,
              sort_kernel.SORT_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hash_lattice.lattice_encode_forward(x, tb, lspec)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hash_lattice.lattice_encode_backward(x, torch.zeros((lspec.n_big, 4, 2)), lspec)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sort_kernel.bitonic_sort_kernel(torch.zeros(128, dtype=torch.int32))
    assert (hash_lattice.LATTICE_FWD_LAUNCHES, hash_lattice.LATTICE_BWD_LAUNCHES,
            sort_kernel.SORT_LAUNCHES) == before
    sspec = hash_sorted.make_split_spec(num_levels=6, log2_hashmap_size=16,
                                        desired_resolution=512)
    pairs = hash_sorted.sorted_pairs(x, sspec)
    tb = torch.zeros((sspec.n_big, sspec.t_cap_big, 2))
    before = (hash_sorted.SORTED_FWD_LAUNCHES, hash_sorted.SORTED_BWD_LAUNCHES,
              sort_kernel.SORT_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hash_sorted.sorted_encode_forward(x, tb, sspec, pairs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hash_sorted.sorted_encode_backward(x, torch.zeros((4, 2 * sspec.n_big)), sspec)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sort_kernel.sort_pairs_(pairs.clone())
    assert (hash_sorted.SORTED_FWD_LAUNCHES, hash_sorted.SORTED_BWD_LAUNCHES,
            sort_kernel.SORT_LAUNCHES) == before


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(["voxel_cuvol"])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert _build.sources() == ["hash_encode", "hash_lattice", "hash_sorted", "radix_sort",
                               "voxel_cuvol"]
    assert _build.headers() == ["hash_corners"]
    assert np.all([not f.endswith(".so") for f in os.listdir(tmp_path)])


def test_an_edited_header_rebuilds_its_kernels(monkeypatch, tmp_path):
    """A library's name hashes its source and every shared header
    (csrc/*.cuh), so a kernel built against an older header is not loaded."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = {n: _build.library_path(n) for n in _build.sources()}
    with open(csrc / "hash_corners.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build.library_path(n) for n in _build.sources()}
    assert all(before[n] != after[n] for n in before)
    for name in ("hash_encode", "hash_sorted"):      # the kernels that include it
        with open(csrc / f"{name}.cu") as f:
            assert '#include "hash_corners.cuh"' in f.read()


def test_the_sorted_backward_keeps_no_pairs():
    """SortedEncode's backward reads x01 alone (K9 recomputes the corners):
    its source saves no pairs for it."""
    src = inspect.getsource(hash_sorted.SortedEncode)
    assert "ctx.save_for_backward(x01)" in src and "pairs" not in src.split("def backward")[1]
    src = inspect.getsource(hash_lattice.LatticeEncode)
    assert "ctx.save_for_backward(x01)" in src and "sort" not in src.split("def forward")[1]

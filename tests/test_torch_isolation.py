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
    from flnerf_tpu_torch.cli import run_nerf
    from flnerf_tpu_torch.render.renderer import RenderConfig
    from flnerf_tpu_torch.train import trainer as nerf_trainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nerf_trainer.NerfTrainer(nerf_trainer.NerfConfig(), RenderConfig(),
                                 nerf_trainer.TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_nerf.main(["--config", os.path.join(ROOT, "configs", "synthetic_smoke.txt"),
                       "--basedir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "synthetic_smoke")
    from flnerf_tpu_torch.cli import ddp_train_nerf
    from flnerf_tpu_torch.models.nerfpp import NerfPPConfig
    from flnerf_tpu_torch.train import nerfpp_trainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nerfpp_trainer.NerfPPTrainer(NerfPPConfig(), nerfpp_trainer.NerfPPTrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ddp_train_nerf.main(["--datadir", "synthetic", "--scene", "any", "--expname", "npp",
                             "--basedir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "npp")



def test_tensorf_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The TensoRF and CCNeRF CLIs, and the NGP trainer given a field, raise
    with no card before they write anything; their modules import no JAX."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from flnerf_tpu_torch.cli import main_ccnerf, main_tensorf
    from flnerf_tpu_torch.models.tensorf import TensoRFConfig, TensoRFField
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ngp_trainer.NGPTrainer(TensoRFField(TensoRFConfig(resolution=(4, 4, 4))),
                               NGPRenderConfig(grid_size=8), ngp_trainer.NGPTrainConfig())
    for argv in (["synthetic", "-O"], ["synthetic", "-O", "--cp"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main_tensorf.main(argv + ["--workspace", str(tmp_path / "vm")])
    for argv in (["synthetic", "-O"], ["synthetic", "--compose", "a.pkl", "b.pkl"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main_ccnerf.main(argv + ["--workspace", str(tmp_path / "cc")])
    assert not os.listdir(tmp_path)
    code = ("import sys\n"
            "import flnerf_tpu_torch.cli.main_tensorf, flnerf_tpu_torch.cli.main_ccnerf\n"
            "import flnerf_tpu_torch.models.tensorf_variants, flnerf_tpu_torch.core.losses\n"
            "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flnerf_tpu')]\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr

def test_dnerf_and_sdf_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The D-NeRF, SDF and mesh CLIs, the SDF trainer, MeshSDF and the
    time-dependent NGP trainer raise with no card before they write
    anything; their modules import no JAX."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from flnerf_tpu_torch.cli import extract_mesh, main_dnerf, main_sdf
    from flnerf_tpu_torch.data.mesh_sdf import MeshSDF
    from flnerf_tpu_torch.models.dnerf import DNeRFConfig, DNeRFField
    from flnerf_tpu_torch.models.sdf import SDFConfig, SDFTrainer
    cfg = DNeRFConfig(ngp=NGPConfig(num_levels=2, log2_hashmap_size=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ngp_trainer.NGPTrainer(DNeRFField(cfg), NGPRenderConfig(grid_size=8),
                               ngp_trainer.NGPTrainConfig(time_dependent=True))
    for variant in ("deform", "basis", "hyper"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main_dnerf.main(["synthetic", "-O", "--variant", variant,
                             "--workspace", str(tmp_path / "dn")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SDFTrainer(SDFConfig(num_levels=2, log2_hashmap_size=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshSDF(np.eye(3, dtype=np.float32), np.array([[0, 1, 2]], np.int32))
    for shape in ("sphere", "mesh.obj", "samples.npz"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main_sdf.main([shape, "--workspace", str(tmp_path / "sdf")])
    for ckpt in ("run/001.tar", "ckpt.npz"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            extract_mesh.main(["--ckpt", ckpt, "--out", str(tmp_path / "mesh.obj")])
    assert not os.listdir(tmp_path)
    code = ("import sys\n"
            "import flnerf_tpu_torch.cli.main_dnerf, flnerf_tpu_torch.cli.main_sdf\n"
            "import flnerf_tpu_torch.cli.extract_mesh, flnerf_tpu_torch.models.dnerf\n"
            "import flnerf_tpu_torch.models.sdf, flnerf_tpu_torch.data.mesh_sdf\n"
            "import flnerf_tpu_torch.ops.marching\n"
            "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flnerf_tpu')]\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_imports_an_image_library():
    """The card's machine has no cv2, imageio, matplotlib or clip: no module
    of the port imports one at module level; cv2 only in cli/converters.py
    (inside Record3D's video branch), and imageio only in data/png.py's
    fallback for formats other than 8-bit PNG and in train/eval.py's video
    writer, which skips the video without it."""
    lazy_ok = {"cv2": {os.path.join("flnerf_tpu_torch", "cli", "converters.py")},
               "imageio": {os.path.join("flnerf_tpu_torch", "data", "png.py"),
                           os.path.join("flnerf_tpu_torch", "train", "eval.py")}}
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        rel = os.path.relpath(path, ROOT)
        in_function = {id(n) for f in ast.walk(tree)
                       if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                       for n in ast.walk(f)}
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for top in {n.split(".")[0] for n in names}:
                if top not in ("cv2", "imageio", "matplotlib", "clip"):
                    continue
                assert id(node) in in_function, f"{rel}:{node.lineno} imports {top} at load"
                assert top in ("matplotlib", "clip") or rel in lazy_ok[top], (
                    f"{rel}:{node.lineno} imports {top}")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers never run a plain version: a CPU tensor is a
    caller error for them (only render_rays_fused dispatches by device)."""
    cfg = VoxelGridConfig(reso=(8, 8, 8), max_steps=8)
    g = init_voxel_grid(cfg)
    rays = voxel_kernel.ray_inputs(cfg, torch.zeros((4, 3)), torch.ones((4, 3)))
    before = voxel_kernel.FWD_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        voxel_kernel.cuvol_forward(*g.tensors, *rays, cfg)
    with pytest.raises(ValueError, match="CUDA tensors"):
        voxel_kernel.cuvol_backward(*g.tensors, *rays, torch.zeros((4, 8)), torch.zeros((4, 8)), cfg)
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
                               "tv_rmsprop", "voxel_cuvol"]
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


def test_session_resunet_and_parallel_stand_alone(monkeypatch, tmp_path):
    """The interactive session, ResUNet and parallel/ import no JAX; the
    --gui CLIs, a process group on the card and the dry run raise with no
    card before they write or spawn anything."""
    code = ("import sys\n"
            "import flnerf_tpu_torch.render.interactive, flnerf_tpu_torch.models.resunet\n"
            "import flnerf_tpu_torch.parallel.mesh, flnerf_tpu_torch.parallel.dryrun\n"
            "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flnerf_tpu')]\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from flnerf_tpu_torch.cli import main_ccnerf, main_dnerf, main_nerf, main_tensorf
    from flnerf_tpu_torch.parallel import mesh
    for cli in (main_nerf, main_dnerf, main_tensorf, main_ccnerf):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["synthetic", "-O", "--gui", "--workspace", str(tmp_path / "gui")])
    assert not os.listdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.init_distributed("localhost:1", 1, 0)
    from flnerf_tpu_torch.parallel import dryrun
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)          # before it spawns a rank
    import torch.distributed as dist
    assert not dist.is_initialized()

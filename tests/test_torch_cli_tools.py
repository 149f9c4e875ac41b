"""The port's tools around the trainers against the reference package, on the
CPU at 16-48 px and 16^3-32^3: the PlenOctree export (core/svox1_export.py,
cli/to_svox1.py), the dataset converters (cli/converters.py tanks2nerf,
hyper2nerf, colmap2nsvf), autotune (cli/autotune.py), the eval tools
(cli/render_imgs.py, cli/calc_metrics.py), the NSVF path of cli/opt.py
with the reference's fault R8 (ROADMAP §3), and cli/run_nerf.py on LINEMOD
and deepvoxels scenes.

Tolerances: numpy results bit for bit; the opt.py NSVF test PSNR within
0.05 dB of the reference's (measured equal); render_imgs' PSNR within 1e-3
dB of opt.py's eval of the same grid (its checkpoint stores SH in f16) and
1e-4 dB (SSIM 1e-4) of the reference's render_imgs on the same checkpoint
(measured 1.4e-6 dB, SSIM 3.4e-5)."""

import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from flnerf_tpu.cli import converters as ref_conv
from flnerf_tpu.core import svox1_export as ref_svox1
from flnerf_tpu_torch.cli import autotune, converters, opt, run_nerf
from flnerf_tpu_torch.core import svox1_export
from flnerf_tpu_torch.data.png import read_png, write_png
from chip_smoke import write_nsvf_scene
from test_torch_loaders import write_dv_fixture, write_linemod_fixture

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# ---------------------------------------------------------------- svox1

@pytest.mark.parametrize("reso,frac", [(16, 0.2), (32, 0.05), (8, 0.0), (2, 1.0)])
def test_build_octree_matches_the_reference(reso, frac):
    rng = np.random.default_rng(reso)
    occ = np.argwhere(rng.random((reso,) * 3) < frac).astype(np.int64)
    got = svox1_export.build_octree(occ, reso)
    want = ref_svox1.build_octree(occ, reso)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_build_octree_refuses_a_grid_not_a_power_of_two():
    with pytest.raises(ValueError, match="power-of-2"):
        svox1_export.build_octree(np.zeros((1, 3), np.int64), 24)


def test_to_svox1_matches_the_reference(tmp_path):
    from flnerf_tpu.cli.to_svox1 import main as ref_main
    from flnerf_tpu_torch.cli.to_svox1 import main
    from flnerf_tpu_torch.models.voxel_sh import VoxelGrid, VoxelGridConfig, save_npz

    rng = np.random.default_rng(1)
    r = 16
    cfg = VoxelGridConfig(reso=(r, r, r), radius=(1.3, 1.3, 1.3), center=(0.1, -0.2, 0.0))
    grid = VoxelGrid(torch.from_numpy(rng.random((r, r, r), dtype=np.float32) * 3),
                     torch.from_numpy(rng.standard_normal((r, r, r, 27), dtype=np.float32)),
                     torch.from_numpy(rng.random((r, r, r)) > 0.8))
    ckpt = str(tmp_path / "ckpt.npz")
    save_npz(ckpt, grid, cfg)
    got = dict(np.load(main([ckpt, "--out", str(tmp_path / "port.npz")]), allow_pickle=True))
    want = dict(np.load(ref_main([ckpt, "--out", str(tmp_path / "ref.npz")]), allow_pickle=True))
    assert got.keys() == want.keys() == {"data_dim", "data_format", "invradius3", "offset",
                                         "child", "data"}
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert str(got["data_format"]) == "SH9" and int(got["data_dim"]) == 28
    # every alive voxel's leaf is its density and SH, as saved in the
    # checkpoint and cast to f16; a dead voxel reads zeros
    alive = np.argwhere(grid.alive.numpy())
    dens = grid.density.numpy().astype(np.float16)
    sh = grid.sh.numpy().astype(np.float16).astype(np.float32).astype(np.float16)
    for c in alive[::7]:
        leaf = svox1_export.lookup_octree(got, c, r)
        np.testing.assert_array_equal(leaf, ref_svox1.lookup_octree(want, c, r))
        assert leaf[-1] == dens[tuple(c)]
        np.testing.assert_array_equal(leaf[:-1], sh[tuple(c)])
    dead = np.argwhere(~grid.alive.numpy())[0]
    assert not np.any(svox1_export.lookup_octree(got, dead, r))


# ----------------------------------------------------------- converters

def _write_tanks(root, seed=0):
    """test_aux_parity.py's T&T NSVF layout: 4 train (0_) and 2 val (1_)
    views with look-at poses, a 4x4 intrinsics.txt, 40x30 PNGs."""
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "pose"))
    np.savetxt(os.path.join(root, "intrinsics.txt"),
               np.array([[100.0, 0, 20, 0], [0, 100, 15, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))
    rng = np.random.default_rng(seed)
    for i in range(6):
        prefix = "0_" if i < 4 else "1_"
        pos = np.array([np.cos(i) * 3, np.sin(i) * 3, 1.0])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0, 0, 1.0], fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], 1)
        c2w[:3, 3] = pos
        np.savetxt(os.path.join(root, "pose", f"{prefix}{i:04d}.txt"), c2w)
        write_png(os.path.join(root, "rgb", f"{prefix}{i:04d}.png"),
                  rng.integers(0, 256, (30, 40, 3)).astype(np.uint8))


def test_tanks2nerf_matches_the_reference(tmp_path, monkeypatch):
    _write_tanks(str(tmp_path / "ref"))
    _write_tanks(str(tmp_path / "port"))
    want = ref_conv.tanks2nerf(str(tmp_path / "ref"))
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    got = converters.tanks2nerf(str(tmp_path / "port"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    tr = json.loads((tmp_path / "port" / "transforms_train.json").read_text())
    assert (tr["w"], tr["h"], len(tr["frames"])) == (40, 30, 4)
    p = np.asarray([f["transform_matrix"] for f in tr["frames"]])
    assert 1.0 < np.linalg.norm(p[:, :3, 3], axis=-1).mean() < 8.0


def _write_hyper(root, val_ids=()):
    os.makedirs(os.path.join(root, "camera"))
    names = [f"f{i:03d}" for i in range(8)]
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"ids": names, "val_ids": list(val_ids),
                   "train_ids": [n for n in names if n not in val_ids]}, f)
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump({n: {"time_id": i} for i, n in enumerate(names)}, f)
    for i, n in enumerate(names):
        th = 2 * np.pi * i / 8
        orient = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
        with open(os.path.join(root, "camera", f"{n}.json"), "w") as f:
            json.dump({"orientation": orient.tolist(),
                       "position": [np.cos(th) * 2, np.sin(th) * 2, 0.5],
                       "image_size": [64, 48], "principal_point": [32, 24],
                       "focal_length": 80.0}, f)


@pytest.mark.parametrize("val_ids", [(), ("f001", "f005")])
def test_hyper2nerf_matches_the_reference(tmp_path, val_ids):
    _write_hyper(str(tmp_path / "ref"), val_ids)
    _write_hyper(str(tmp_path / "port"), val_ids)
    want = ref_conv.hyper2nerf(str(tmp_path / "ref"), downscale=2, interval=4)
    got = converters.hyper2nerf(str(tmp_path / "port"), downscale=2, interval=4)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    tr = json.loads((tmp_path / "port" / "transforms_train.json").read_text())
    assert (tr["w"], tr["h"]) == (32, 24) and all("time" in f for f in tr["frames"])


def test_colmap2nsvf_matches_the_reference(tmp_path):
    sparse = tmp_path / "sparse"
    os.makedirs(sparse)
    (sparse / "cameras.txt").write_text("# cams\n1 PINHOLE 64 48 80 80 32 24\n")
    lines = ["# imgs"]
    for i in range(3):
        lines += [f"{i + 1} 0.9 0.1 {0.2 * i} 0.1 {0.1 * i} 0.2 {0.3 + i} 1 im{i}.png",
                  "0.0 0.0 -1"]
    (sparse / "images.txt").write_text("\n".join(lines) + "\n")
    assert converters.colmap2nsvf(str(sparse), str(tmp_path / "port")) == 3
    assert ref_conv.colmap2nsvf(str(sparse), str(tmp_path / "ref")) == 3
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    assert sorted(os.listdir(tmp_path / "port" / "pose"))[0].startswith("0_")


# ------------------------------------------------------------- autotune

def test_autotune_search_space_matches_the_reference():
    from flnerf_tpu.cli import autotune as ref_tune

    grid = {"lr_sigma": [10, 30], "lambda_tv": [1e-5, 1e-4, 1e-3]}
    assert list(autotune.expand_grid(grid)) == list(ref_tune.expand_grid(grid))
    space = {"lr_sh": [1e-2, 3e-2], "init_sigma": [0.1, 0.5, 1.0]}
    assert list(autotune.sample_random(space, 7, seed=3)) == list(
        ref_tune.sample_random(space, 7, seed=3))
    for params in ({}, {"lambda_tv": 1e-05, "lr_sigma": 30}):
        assert autotune.variant_name(params) == ref_tune.variant_name(params)


def test_autotune_runs_variants_and_skips_finished_ones(tmp_path):
    """The launcher with a stub entry module (test_aux.py's), through
    python -m as a user runs it: a leaderboard best first, then a rerun
    that skips both variants."""
    stub_dir = tmp_path / "stubpkg"
    stub_dir.mkdir()
    (stub_dir / "stub_train.py").write_text(textwrap.dedent("""
        import argparse, os
        p = argparse.ArgumentParser()
        p.add_argument("data")
        p.add_argument("-t", "--train_dir")
        p.add_argument("--lr", type=float, default=1.0)
        a = p.parse_args()
        os.makedirs(a.train_dir, exist_ok=True)
        open(os.path.join(a.train_dir, "test_psnr.txt"), "w").write(str(10 * a.lr))
        """))
    task = {"entry": "stub_train", "base_args": ["synthetic"],
            "train_root": str(tmp_path / "runs"), "grid": {"lr": [1.0, 2.0]}}
    (tmp_path / "task.json").write_text(json.dumps(task))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(stub_dir), ROOT,
                                                       os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "flnerf_tpu_torch.cli.autotune", str(tmp_path / "task.json")]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    board = (tmp_path / "runs" / "leaderboard.txt").read_text().splitlines()
    assert board == ["20.0\tlr2.0", "10.0\tlr1.0"]
    res2 = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert res2.stdout.count("skip finished") == 2 and "launch:" not in res2.stdout


def test_autotune_default_entry_trains_the_ports_opt(tmp_path, capsys):
    """No "entry" in the task: the variants run the port's own cli/opt.py
    (never the reference package's), one after another."""
    assert autotune.DEFAULT_ENTRY == "flnerf_tpu_torch.cli.opt"
    task = {"base_args": ["synthetic", "--device", "cpu", "--n_epochs", "1", "--tune_nosave",
                          "--reso", "[[16,16,16]]", "--batch_size", "512"],
            "train_root": str(tmp_path / "runs"), "grid": {"lambda_tv": [1e-5, 1e-4]}}
    (tmp_path / "task.json").write_text(json.dumps(task))
    rows = autotune.main([str(tmp_path / "task.json")])
    assert sorted(name for _, name in rows) == ["lambda_tv0.0001", "lambda_tv1e-05"]
    assert all(math.isfinite(p) for p, _ in rows)
    launches = [l for l in capsys.readouterr().out.splitlines() if l.startswith("launch:")]
    assert len(launches) == 2 and all(" -m flnerf_tpu_torch.cli.opt " in l for l in launches)
    for _, name in rows:      # --tune_nosave: no checkpoint, only the PSNR
        assert not [f for f in os.listdir(tmp_path / "runs" / name) if f.endswith(".npz")]
    assert autotune.main([str(tmp_path / "task.json")]) == rows
    assert "skip finished" in capsys.readouterr().out


# ----------------------------------------------------------- eval tools

def test_calc_metrics_matches_the_reference(tmp_path, capsys, monkeypatch):
    from flnerf_tpu.cli.calc_metrics import main as ref_main
    from flnerf_tpu_torch.cli.calc_metrics import main

    rd, gd = tmp_path / "render", tmp_path / "gt"
    os.makedirs(rd)
    os.makedirs(gd)
    rng = np.random.default_rng(0)
    for i in range(3):
        img = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
        noisy = np.clip(img.astype(np.int32) + rng.integers(-8, 8, img.shape), 0, 255)
        write_png(str(gd / f"{i:03d}.png"), img)
        write_png(str(rd / f"{i:03d}.png"), noisy.astype(np.uint8))
    want = ref_main([str(rd), str(gd)])
    ref_out = capsys.readouterr().out
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    got = main([str(rd), str(gd)])
    out = capsys.readouterr().out
    assert got["psnr"] == want["psnr"]
    assert abs(got["ssim"] - want["ssim"]) <= 1e-6
    assert out.splitlines()[0] == ref_out.splitlines()[0]       # PSNR: ...
    write_png(str(gd / "extra.png"), np.zeros((16, 16, 3), np.uint8))
    with pytest.raises(ValueError, match="3 renders against 4"):
        main([str(rd), str(gd)])


@pytest.fixture(scope="module")
def opt_run(tmp_path_factory):
    """cli/opt.py on the synthetic scene at 32^3, 2 epochs, on the CPU."""
    d = tmp_path_factory.mktemp("opt")
    res = opt.main(["synthetic", "-t", str(d), "--reso", "[[32,32,32]]", "--n_epochs", "2",
                    "--batch_size", "1024", "--device", "cpu"])
    return d, res


def test_render_imgs_gives_opt_evals_psnr(opt_run, tmp_path, capsys):
    from flnerf_tpu.cli.render_imgs import main as ref_main
    from flnerf_tpu_torch.cli.render_imgs import main

    d, res = opt_run
    ckpt = str(d / "ckpt02.npz")
    out = main([ckpt, "synthetic", "--render_dir", str(tmp_path / "port"), "--device", "cpu"])
    want = ref_main([ckpt, "synthetic", "--render_dir", str(tmp_path / "ref")])
    assert abs(out["psnr"] - res["psnr"]) <= 1e-3, (out["psnr"], res["psnr"])
    print("render_imgs vs opt eval", out["psnr"] - res["psnr"], "vs reference",
          out["psnr"] - want["psnr"], out["ssim"] - want["ssim"])
    assert abs(out["psnr"] - want["psnr"]) <= 1e-4 and abs(out["ssim"] - want["ssim"]) <= 1e-4
    assert math.isnan(out["lpips"])
    assert sorted(os.listdir(tmp_path / "port")) == ["0000.png", "0001.png", "results.txt"]
    for name in ("0000.png", "0001.png"):
        a = read_png(str(tmp_path / "port" / name)).astype(int)
        b = read_png(str(tmp_path / "ref" / name)).astype(int)
        assert a.shape == (48, 48, 3) and np.abs(a - b).max() <= 1
    assert (tmp_path / "port" / "results.txt").read_text().startswith(
        f"mean PSNR: {out['psnr']}")
    capsys.readouterr()
    t = main([ckpt, "synthetic", "--render_dir", str(tmp_path / "t"), "--timing",
              "--device", "cpu"])
    assert t["fps"] > 0 and "FPS" in capsys.readouterr().out
    assert os.listdir(tmp_path / "t") == []


def test_r9_render_imgs_marches_with_load_npz_defaults_in_both_packages(tmp_path):
    """R9 (a fault of the reference, mirrored): a checkpoint keeps no march
    settings, so render_imgs renders with load_npz's defaults (step 0.5,
    512 steps) whatever opt.py trained with: here --step_size 0.25, whose
    eval render_imgs does not reproduce, in either package, by the same
    amount."""
    from flnerf_tpu.cli.render_imgs import main as ref_main
    from flnerf_tpu.models.voxel_sh import load_npz as ref_load
    from flnerf_tpu_torch.cli.render_imgs import main
    from flnerf_tpu_torch.models.voxel_sh import load_npz

    res = opt.main(["synthetic", "-t", str(tmp_path), "--reso", "[[32,32,32]]", "--n_epochs",
                    "1", "--batch_size", "2048", "--step_size", "0.25", "--device", "cpu"])
    ckpt = str(tmp_path / "ckpt01.npz")
    for load in (load_npz, ref_load):
        cfg = load(ckpt)[1]
        assert (cfg.step_size, cfg.max_steps) == (0.5, 512)
    got = main([ckpt, "synthetic", "--render_dir", str(tmp_path / "p"), "--device", "cpu"])
    want = ref_main([ckpt, "synthetic", "--render_dir", str(tmp_path / "r")])
    assert abs(got["psnr"] - res["psnr"]) > 1e-3
    assert abs(got["psnr"] - want["psnr"]) <= 1e-4


def test_render_imgs_raises_without_a_card(opt_run, tmp_path, monkeypatch):
    """Its --device defaults to cuda: with no card it raises before it
    loads or writes anything."""
    from flnerf_tpu_torch.cli.render_imgs import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([str(opt_run[0] / "ckpt02.npz"), "synthetic", "--render_dir", str(tmp_path / "r")])
    assert not os.path.exists(tmp_path / "r")


# ------------------------------------------------------ opt.py on NSVF

def test_opt_on_nsvf_matches_the_references_test_psnr(tmp_path):
    from flnerf_tpu.cli.opt import main as ref_main

    write_nsvf_scene(str(tmp_path / "nsvf"), n_train=4, n_test=1, H=16)
    argv = [str(tmp_path / "nsvf"), "--reso", "[[32,32,32]]", "--n_epochs", "2",
            "--batch_size", "256", "--steps_per_chunk", "2"]
    got = opt.main(argv + ["-t", str(tmp_path / "port"), "--device", "cpu"])
    want = ref_main(argv + ["-t", str(tmp_path / "ref")])
    assert abs(got["psnr"] - want["psnr"]) <= 0.05, (got["psnr"], want["psnr"])
    hist = [h["train_psnr"] for h in got["history"]]
    assert hist[-1] > hist[0] and hist[-1] > got["psnr"] + 3.0    # R8: eval looks away
    assert got["grid"].density.shape == (32, 32, 32)
    assert json.loads((tmp_path / "port" / "args.json").read_text())["dataset_type"] == "auto"
    assert {"ckpt01.npz", "ckpt02.npz", "test_psnr.txt"} <= set(os.listdir(tmp_path / "port"))


def test_opt_nsvf_scene_scale_scales_the_training_origins(tmp_path, monkeypatch):
    """--scene_scale multiplies the poses' translations (nsvf_dataset.py),
    and the grid radius is 1.5: caught at the budgeter and the config."""
    from flnerf_tpu_torch.rays import quadtree
    from flnerf_tpu_torch.train import plenoxels_trainer

    write_nsvf_scene(str(tmp_path / "nsvf"), n_train=4, n_test=1, H=16)
    seen = {}
    real_budgeter = quadtree.RayBudgeter

    class Stop(Exception):
        pass

    def budgeter(images, origins, dirs, **kw):
        seen.setdefault("origins", []).append(origins)
        return real_budgeter(images, origins, dirs, **kw)

    def trainer(gcfg, tcfg, device):
        seen["radius"] = gcfg.radius
        raise Stop

    monkeypatch.setattr(quadtree, "RayBudgeter", budgeter)
    monkeypatch.setattr(plenoxels_trainer, "PlenoxelsTrainer", trainer)
    for scale in ([], ["--scene_scale", "0.5"]):
        with pytest.raises(Stop):
            opt.main([str(tmp_path / "nsvf"), "-t", str(tmp_path / "t"), "--device", "cpu",
                      "--reso", "[[16,16,16]]"] + scale)
    a, b = seen["origins"]
    np.testing.assert_allclose(b, 0.5 * a, rtol=1e-6)
    assert seen["radius"] == (1.5, 1.5, 1.5)


def test_r8_nsvf_eval_rays_flip_y_and_z_in_both_packages(tmp_path):
    """R8 (a fault of the reference, mirrored): opt.py trains an NSVF scene
    on OpenCV rays from the file's own K, but its test evaluation renders
    the same poses with the centred K through the OpenGL get_rays, so in the
    camera's frame every eval ray has the training ray's x and the negated
    y and z."""
    from flnerf_tpu.data.nerfpp_dataset import get_rays_opencv_np as ref_cv_rays
    from flnerf_tpu.rays.camera import get_rays as ref_gl_rays
    from flnerf_tpu.rays.camera import intrinsics_matrix as ref_k
    from flnerf_tpu_torch.data.extra_loaders import load_nsvf_data
    from flnerf_tpu_torch.data.nerfpp_dataset import get_rays_opencv_np
    from flnerf_tpu_torch.rays.camera import get_rays, intrinsics_matrix

    write_nsvf_scene(str(tmp_path), n_train=4, n_test=1, H=16)
    _, poses, K_nsvf, (H, W, focal) = load_nsvf_data(str(tmp_path), "test")
    K4 = np.eye(4, dtype=np.float32)
    K4[:3, :3] = K_nsvf
    pose = poses[0]
    R = pose[:3, :3].astype(np.float64)
    for cv_rays, gl_rays, k in ((get_rays_opencv_np, get_rays, intrinsics_matrix),
                                (ref_cv_rays, ref_gl_rays, ref_k)):
        _, d_train = cv_rays(H, W, K4, pose)
        d_eval = np.asarray(gl_rays(H, W, k(H, W, focal), pose[:3, :4])[1])
        cam_train = d_train.reshape(-1, 3) @ R           # R^T d, row-wise
        cam_eval = d_eval.reshape(-1, 3) @ R
        np.testing.assert_allclose(cam_eval[:, 0], cam_train[:, 0], atol=1e-5)
        np.testing.assert_allclose(cam_eval[:, 1:], -cam_train[:, 1:], atol=1e-5)


# ------------------------------------------- run_nerf: LINEMOD, deepvoxels

TINY = ["--N_samples", "8", "--N_importance", "8", "--netdepth", "2", "--netwidth", "32",
        "--N_rand", "1024", "--n_epoch", "1", "--init_level", "2", "--precrop_iters", "0",
        "--compute_dtype", "float32", "--use_viewdirs", "--device", "cpu"]


def test_run_nerf_on_linemod(tmp_path):
    """LINEMOD at 16 px (the json's K and near/far, white background): one
    epoch, a checkpoint and a finite test PSNR."""
    write_linemod_fixture(str(tmp_path / "data"), n=3, hw=16, intrinsic=True, channels=4)
    res = run_nerf.main(["--dataset_type", "LINEMOD", "--datadir", str(tmp_path / "data"),
                         "--white_bkgd", "--testskip", "1", "--basedir", str(tmp_path / "logs"),
                         "--expname", "lm"] + TINY)
    assert math.isfinite(res["psnr"]) and [h["epoch"] for h in res["history"]] == [1]
    assert {"001.tar", "treeDivide_0001.pkl", "testset_001"} <= set(
        os.listdir(tmp_path / "logs" / "lm"))


def test_run_nerf_on_deepvoxels(tmp_path):
    """DeepVoxels frames are 512 x 512 (the loader's fixed size) and every
    epoch of run_nerf takes every pixel, so one train, validation and test
    view each, at 4 + 4 samples and width 16; near/far at the mean camera
    distance +- 1."""
    write_dv_fixture(str(tmp_path / "data"), n=1, hw=512)
    res = run_nerf.main(["--dataset_type", "deepvoxels", "--datadir", str(tmp_path / "data"),
                         "--shape", "cube", "--testskip", "1", "--basedir", str(tmp_path / "logs"),
                         "--expname", "dv"] + TINY + [
                         "--N_samples", "4", "--N_importance", "4", "--netwidth", "16",
                         "--multires", "2", "--multires_views", "1", "--N_rand", "8192"])
    assert math.isfinite(res["psnr"]) and [h["epoch"] for h in res["history"]] == [1]
    assert "001.tar" in os.listdir(tmp_path / "logs" / "dv")

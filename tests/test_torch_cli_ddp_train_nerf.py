"""The port's NeRF++ CLI (flnerf_tpu_torch/cli/ddp_train_nerf.py) end to end
on the CPU at a tiny size (D3 W32, 8 + 8 samples, max_freq_log2 4 and 2,
f32), on the procedural scene and on a written fixture at
--resolution_level 2; its parser against the reference's; its checkpoints
against the reference package both ways (a port .pth renders in the
reference's nerfpp_render, a reference .pth loads into the port, rgb within
1e-5 in f32); and the 14 flags that the reference parses and ignores
(fault R4), parsed and ignored here too."""

import math
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flnerf_tpu.cli import ddp_train_nerf as ref_cli
from flnerf_tpu.data.nerfpp_dataset import load_nerfpp_split as ref_load
from flnerf_tpu.data.nerfpp_dataset import write_nerfpp_fixture as ref_fixture
from flnerf_tpu.models import nerfpp as ref_model
from flnerf_tpu_torch.cli import ddp_train_nerf
from flnerf_tpu_torch.data.nerfpp_dataset import load_nerfpp_split, write_nerfpp_fixture
from flnerf_tpu_torch.models import nerfpp

torch.set_num_threads(1)

TINY = ["--netdepth", "3", "--netwidth", "32", "--cascade_samples", "8,8",
        "--max_freq_log2", "4", "--max_freq_log2_viewdirs", "2", "--batch_size", "512",
        "--compute_dtype", "float32", "--chunk_size", "1024"]
# the flags the reference parses and never reads (ROADMAP R4), set away from
# their defaults
R4 = ["--no_reload", "--ckpt_path", "x.pth", "--det", "--use_viewdirs", "--N_rand", "7",
      "--N_iters", "3", "--render_splits", "train", "--load_min_depth", "--world_size", "4",
      "--rays_downscale", "2", "--dset_name", "Other", "--i_print", "1", "--i_img", "1",
      "--i_weights", "1"]


def test_parser_matches_the_reference_flag_for_flag():
    ours = {a.dest: a.default for a in ddp_train_nerf.config_parser()._actions}
    theirs = {a.dest: a.default for a in ref_cli.config_parser()._actions}
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    assert sum(f.startswith("--") for f in R4) == 14
    assert {f[2:] for f in R4 if f.startswith("--")} <= set(theirs)


def test_synthetic_run_writes_checkpoints_and_trees(tmp_path):
    res = ddp_train_nerf.main(["--datadir", "synthetic", "--scene", "any", "--expname", "syn",
                               "--basedir", str(tmp_path), "--n_epoch", "3",
                               "--device", "cpu"] + TINY)
    run_dir = tmp_path / "syn"
    files = set(os.listdir(run_dir))
    assert {"args.txt", "results.txt"} | {f"model_{e:04d}.pth" for e in (1, 2, 3)} | {
        f"treeDivide_{e:04d}.pkl" for e in (1, 2, 3)} == files
    assert math.isfinite(res["psnr"]) and 0 < res["ssim"] <= 1
    assert res["run_dir"] == str(run_dir)
    assert [h["epoch"] for h in res["history"]] == [1, 2, 3]
    assert res["history"][0]["n_leaves"] > 6 * 16        # subdivided after epoch 1
    with open(run_dir / "model_0002.pth", "rb") as f:
        ckpt = pickle.load(f)
    assert ckpt["format"] == "flnerf_nerfpp_v1" and ckpt["epoch"] == 2
    assert ckpt["global_iter"] == 2 * 19                  # 9600 rays / 512, twice
    with open(run_dir / "results.txt") as f:
        assert f.read().startswith(f"mean PSNR: {res['psnr']}")


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("npp")
    write_nerfpp_fixture(str(base / "fixture"), H=32, n_train=3, n_test=2)
    ref_fixture(str(base / "ref"), H=32, n_train=3, n_test=2)
    return base


def test_fixture_equals_the_references_and_loads_at_resolution_level_2(fixture_dir,
                                                                     monkeypatch):
    for split in ("train", "test", "validation"):
        for sub in ("intrinsics", "pose", "rgb"):
            names = sorted(os.listdir(fixture_dir / "fixture" / split / sub))
            assert names == sorted(os.listdir(fixture_dir / "ref" / split / sub))
            if sub != "rgb":
                for n in names:
                    with open(fixture_dir / "fixture" / split / sub / n) as a, \
                            open(fixture_dir / "ref" / split / sub / n) as b:
                        assert a.read() == b.read()
    want = ref_load(str(fixture_dir), "ref", "train", resolution_level=2)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for scene in ("fixture", "ref"):
        got = load_nerfpp_split(str(fixture_dir), scene, "train", resolution_level=2)
        assert got["H"] == got["W"] == 16
        for k in ("images", "origins", "dirs", "intrinsics", "poses"):
            np.testing.assert_array_equal(got[k], want[k])


def test_fixture_run_at_resolution_level_2_and_r4_flags(fixture_dir, tmp_path):
    args = ["--datadir", str(fixture_dir), "--scene", "fixture", "--basedir", str(tmp_path),
            "--testskip", "1", "--resolution_level", "2", "--n_epoch", "2", "--init_level",
            "2", "--device", "cpu"] + TINY
    res = ddp_train_nerf.main(args + ["--expname", "plain"])
    res_r4 = ddp_train_nerf.main(args + ["--expname", "r4"] + R4)
    assert math.isfinite(res["psnr"])
    # the R4 flags change nothing
    assert res_r4["psnr"] == res["psnr"] and res_r4["ssim"] == res["ssim"]
    assert [h["train_psnr"] for h in res_r4["history"]] == [
        h["train_psnr"] for h in res["history"]]
    assert not os.path.exists(tmp_path / "r4" / "x.pth")
    for name in ("plain", "r4"):
        assert sorted(f for f in os.listdir(tmp_path / name) if f.endswith(".pth")) == [
            "model_0001.pth", "model_0002.pth"]


def _render_ref(params, ro, rd, cfg):
    """Both levels through the reference's nerfpp_render at fixed depths."""
    fg_z_max, _ = ref_model.intersect_sphere(jnp.asarray(ro), jnp.asarray(rd))
    n = ro.shape[0]
    outs = []
    for m, s in enumerate(cfg.cascade_samples):
        fg = np.linspace(1e-4, 1.0, s, dtype=np.float32)[None] * np.asarray(fg_z_max)[:, None]
        bg = np.broadcast_to(np.linspace(0, 1, s, dtype=np.float32), (n, s))
        outs.append(np.asarray(ref_model.nerfpp_render(
            params[m], jnp.asarray(ro), jnp.asarray(rd), fg_z_max, jnp.asarray(fg),
            jnp.asarray(bg), cfg, jnp.float32)["rgb"]))
    return outs, fg_z_max


def _render_ours(trainer, ro, rd, fg_z_max, cfg):
    outs = []
    n = ro.shape[0]
    fz = torch.as_tensor(np.array(fg_z_max))
    with torch.no_grad():
        for m, s in enumerate(cfg.cascade_samples):
            fg = torch.as_tensor(np.linspace(1e-4, 1.0, s, dtype=np.float32)[None]
                                 * np.asarray(fg_z_max)[:, None])
            bg = torch.as_tensor(np.broadcast_to(np.linspace(0, 1, s, dtype=np.float32),
                                                 (n, s)).copy())
            outs.append(nerfpp.nerfpp_render(trainer.nets[m], torch.as_tensor(ro),
                                             torch.as_tensor(rd), fz, fg, bg,
                                             trainer.mcfg)["rgb"].numpy())
    return outs


def test_checkpoints_cross_between_the_packages(tmp_path):
    common = ["--datadir", "synthetic", "--scene", "any", "--n_epoch", "1", "--basedir",
              str(tmp_path), "--optim_autoexpo"] + TINY
    ddp_train_nerf.main(common + ["--expname", "ours", "--device", "cpu"])
    ref_cli.main(common + ["--expname", "ref", "--steps_per_chunk", "4"])
    rng = np.random.default_rng(0)
    ro = (rng.uniform(-0.2, 0.2, (64, 3))).astype(np.float32)
    rd = rng.normal(size=(64, 3)).astype(np.float32)
    cfg = ref_model.NerfPPConfig(netdepth=3, netwidth=32, max_freq_log2=4,
                                 max_freq_log2_viewdirs=2, cascade_samples=(8, 8),
                                 optim_autoexpo=True)
    args = ddp_train_nerf.config_parser().parse_args(common + ["--device", "cpu"])
    for who in ("ours", "ref"):
        path = str(tmp_path / who / "model_0001.pth")
        with open(path, "rb") as f:
            ckpt = pickle.load(f)
        assert ckpt["format"] == "flnerf_nerfpp_v1"
        assert ckpt["params"][0]["autoexpo"].shape == (6, 2)
        want, fg_z_max = _render_ref(ckpt["params"], ro, rd, cfg)
        trainer = ddp_train_nerf.build(args, n_images=6)
        assert ddp_train_nerf.load_checkpoint(path, trainer) == 1
        assert trainer.global_iter == ckpt["global_iter"] > 0
        got = _render_ours(trainer, ro, rd, fg_z_max, trainer.mcfg)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="flnerf_nerfpp_v1"):
        with open(tmp_path / "bad.pth", "wb") as f:
            pickle.dump({"format": "other"}, f)
        ddp_train_nerf.load_checkpoint(str(tmp_path / "bad.pth"), trainer)

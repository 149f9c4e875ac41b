"""The port's Plenoxels CLI (flnerf_tpu_torch/cli/opt.py) end to end on the
CPU: the synthetic scene at 32^3 for 2 epochs."""

import json
import math
import os

import pytest
import torch

from flnerf_tpu_torch.cli import opt
from flnerf_tpu_torch.models.voxel_sh import load_npz
from flnerf_tpu_torch.rays.quadtree import QuadTreeForest

torch.set_num_threads(1)


def test_opt_cli_writes_artifacts_and_a_finite_psnr(tmp_path):
    res = opt.main(["synthetic", "-t", str(tmp_path), "--reso", "[[32,32,32]]",
                    "--n_epochs", "2", "--device", "cpu"])
    for name in ("args.json", "ckpt01.npz", "ckpt02.npz", "treeDivide_0001.pkl",
                 "time_mins.txt", "test_psnr.txt"):
        assert os.path.exists(tmp_path / name), name
    assert math.isfinite(res["psnr"])
    with open(tmp_path / "test_psnr.txt") as f:
        assert float(f.read()) == pytest.approx(res["psnr"])
    grid, cfg = load_npz(str(tmp_path / "ckpt02.npz"))
    assert cfg.reso == (32, 32, 32) and grid.sh.shape == (32, 32, 32, 27)
    assert QuadTreeForest.load(str(tmp_path / "treeDivide_0001.pkl")).n_images == 8
    hist = res["history"]
    assert [h["epoch"] for h in hist] == [1, 2]
    assert all(math.isfinite(h["train_psnr"]) for h in hist)
    with open(tmp_path / "args.json") as f:
        assert json.load(f)["device"] == "cpu"


def test_config_file_merge_rejects_unknown_keys(tmp_path):
    good, bad = tmp_path / "good.json", tmp_path / "bad.json"
    good.write_text(json.dumps({"lambda_tv": 3e-5, "reso": [[64, 64, 64]]}))
    bad.write_text(json.dumps({"no_such_flag": 1}))
    args = opt.parse_arguments(["synthetic", "-c", str(good)])
    assert args.lambda_tv == 3e-5 and args.reso == [[64, 64, 64]]
    assert args.device == "cuda"
    with pytest.raises(ValueError, match="Invalid config keys"):
        opt.parse_arguments(["synthetic", "-c", str(bad)])

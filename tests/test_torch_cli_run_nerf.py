"""The port's NeRF CLI (flnerf_tpu_torch/cli/run_nerf.py) end to end on the
CPU at a tiny size (configs/synthetic_smoke.txt, cut to 8 + 8 samples,
width 32 and 3 epochs), its config parser against the reference's, and the
port's LLFF loader (data/llff.py) against flnerf_tpu/data/llff.py on a
written fixture."""

import math
import os

import numpy as np
import pytest
import torch

from flnerf_tpu.cli import run_nerf as ref_cli
from flnerf_tpu.data import llff as ref_llff
from flnerf_tpu_torch.cli import run_nerf
from flnerf_tpu_torch.data import llff

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "synthetic_smoke.txt")
TINY = ["--N_samples", "8", "--N_importance", "8", "--netwidth", "32", "--N_rand", "1024",
        "--device", "cpu"]


def test_main_trains_resumes_and_renders(tmp_path, capsys):
    base = ["--config", SMOKE, "--basedir", str(tmp_path), "--expname", "run"] + TINY
    res = run_nerf.main(base + ["--n_epoch", "3", "--subdivide_every", "1"])
    run_dir = tmp_path / "run"
    files = set(os.listdir(run_dir))
    assert {"args.txt", "config.txt", "testset_003"} | {
        f"{e:03d}.tar" for e in (1, 2, 3)} | {f"treeDivide_{e:04d}.pkl" for e in (1, 2, 3)} <= files
    assert sorted(os.listdir(run_dir / "testset_003")) == ["000.png", "001.png", "results.txt"]
    assert math.isfinite(res["psnr"]) and 0 < res["ssim"] <= 1 and math.isnan(res["lpips"])
    assert [h["epoch"] for h in res["history"]] == [1, 2, 3]
    assert res["history"][0]["n_leaves"] > 8 * 4          # subdivided after epoch 1
    ckpt = torch.load(run_dir / "001.tar", weights_only=False)
    assert ckpt["global_epoch"] == 1 and ckpt["global_iter"] == 32     # 32768 rays / 1024

    # resume from the last .tar and its tree, one more epoch
    capsys.readouterr()
    res4 = run_nerf.main(base + ["--n_epoch", "4", "--subdivide_every", "1"])
    out = capsys.readouterr().out
    assert "Reloading from" in out and "003.tar" in out and "treeDivide_0003.pkl" in out
    assert "center-crop" not in out and [h["epoch"] for h in res4["history"]] == [4]
    assert res4["history"][0]["n_leaves"] == res["history"][-1]["n_leaves"]
    it3 = torch.load(run_dir / "003.tar", weights_only=False)["global_iter"]
    assert torch.load(run_dir / "004.tar", weights_only=False)["global_iter"] > it3

    # render the test set from 004.tar: the final eval's PSNR again
    res_r = run_nerf.main(base + ["--n_epoch", "4", "--render_only", "--render_test"])
    assert os.path.isdir(run_dir / "renderonly_test_004")
    assert abs(res_r["psnr"] - res4["psnr"]) < 1e-6


def test_parser_matches_the_reference_and_reads_config_files():
    ours = {a.dest: a.default for a in run_nerf.config_parser()._actions}
    theirs = {a.dest: a.default for a in ref_cli.config_parser()._actions}
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    for name in ("lego.txt", "fern.txt", "synthetic_smoke.txt"):
        argv = ["--config", os.path.join(ROOT, "configs", name)]
        a = vars(run_nerf.config_parser().parse_args(argv + ["--device", "cpu"]))
        b = vars(ref_cli.config_parser().parse_args(argv))
        assert a.pop("device") == "cpu" and a == b
    lego = run_nerf.config_parser().parse_args(["--config", os.path.join(ROOT, "configs",
                                                                         "lego.txt")])
    assert (lego.N_samples, lego.N_importance, lego.N_rand, lego.netwidth, lego.netdepth,
            lego.use_viewdirs, lego.white_bkgd, lego.compute_dtype) == (
        64, 128, 1920, 256, 8, True, True, "bfloat16")


@pytest.mark.parametrize("dataset_type", ["LINEMOD", "deepvoxels"])
def test_unported_loaders_raise(dataset_type, tmp_path):
    """LINEMOD and deepvoxels raised until their loaders were ported; the
    test keeps its name and now holds the dataset dispatch of both against
    the reference's on a written fixture (LINEMOD with its json K and
    white-background composite, deepvoxels with hemi_r +- 1)."""
    from test_torch_loaders import write_dv_fixture, write_linemod_fixture

    if dataset_type == "LINEMOD":
        write_linemod_fixture(str(tmp_path), intrinsic=True, channels=4)
    else:
        write_dv_fixture(str(tmp_path))
    argv = ["--dataset_type", dataset_type, "--datadir", str(tmp_path), "--shape", "cube",
            "--white_bkgd", "--testskip", "1"]
    got = run_nerf.load_dataset(run_nerf.config_parser().parse_args(argv))
    want = ref_cli.load_dataset(ref_cli.config_parser().parse_args(argv))
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        if isinstance(a, (list, tuple)):
            assert [float(x) for x in a] == [float(x) for x in b]
        else:
            np.testing.assert_array_equal(a, b)
    images, near, far = got[0], got[8], got[9]
    assert images.shape[-1] == 3
    if dataset_type == "deepvoxels":
        hemi_r = float(np.mean(np.linalg.norm(got[1][:, :3, -1], axis=-1)))
        assert (near, far) == (hemi_r - 1.0, hemi_r + 1.0)
    else:
        assert (near, far) == (0.2, 2.2) and got[4][0, 2] == 8 / 2 - 0.3


@pytest.fixture(scope="module")
def llff_dir(tmp_path_factory):
    """The fixture of tests/test_llff.py: 7 posed views at 32x40."""
    import imageio.v2 as imageio

    base = tmp_path_factory.mktemp("llff")
    (base / "images").mkdir()
    rng = np.random.default_rng(3)
    rows = []
    for i in range(7):
        th = -0.5 + 0.9 * (i / 6) ** 1.7
        pos = np.array([np.sin(th) * 4, 0.13 * i - 0.2, np.cos(th) * (4 + 0.2 * i)])
        fwd = -pos / np.linalg.norm(pos)
        upv = np.array([0, 1.0, 0])
        right = np.cross(upv, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        m = np.stack([-up2, right, -fwd], 1)  # LLFF [down, right, back] cols
        p35 = np.concatenate(
            [np.concatenate([m, pos[:, None]], 1),
             np.array([[32.0], [40.0], [50.0]])], 1)
        rows.append(np.concatenate([p35.reshape(-1), [2.0, 8.0]]))
        imageio.imwrite(
            str(base / "images" / f"im{i:02d}.png"),
            (rng.random((32, 40, 3)) * 255).astype(np.uint8))
    np.save(str(base / "poses_bounds.npy"), np.stack(rows))
    return str(base)


@pytest.mark.parametrize("kw", [dict(factor=1), dict(factor=2), dict(factor=1, spherify=True),
                                dict(factor=1, path_zflat=True)])
def test_load_llff_data_matches_the_reference(llff_dir, kw):
    ours = llff.load_llff_data(llff_dir, **kw)
    theirs = ref_llff.load_llff_data(llff_dir, **kw)
    for a, b in zip(ours[:4], theirs[:4]):
        np.testing.assert_array_equal(a, b)
    assert ours[4] == theirs[4]


def test_main_on_llff_ndc(llff_dir, tmp_path):
    """The CLI's default dataset type: LLFF with NDC rays, llffhold 8."""
    res = run_nerf.main(["--datadir", llff_dir, "--factor", "2", "--basedir", str(tmp_path),
                         "--expname", "fern_like", "--n_epoch", "1", "--N_rand", "512",
                         "--init_level", "2", "--use_viewdirs", "--netdepth", "2"] + TINY)
    assert math.isfinite(res["psnr"])
    assert os.path.exists(tmp_path / "fern_like" / "001.tar")


def _images(rng):
    smooth = np.clip(np.cumsum(rng.random((37, 29, 3)), 1) / 20, 0, 1)
    return [(smooth * 255).astype(np.uint8),                        # adaptive filters
            rng.integers(0, 256, (23, 31, 4), dtype=np.uint8),      # RGBA
            rng.integers(0, 256, (9, 14), dtype=np.uint8),          # grey
            np.zeros((5, 7, 3), np.uint8)]


def test_png_codec_matches_imageio(tmp_path):
    """data/png.py, the codec the port uses where imageio is absent: it
    reads imageio's PNGs (Pillow picks a filter per row) bit for bit, and
    imageio reads what it writes."""
    import imageio.v2 as imageio

    from flnerf_tpu_torch.data import png

    for i, img in enumerate(_images(np.random.default_rng(11))):
        a, b = str(tmp_path / f"a{i}.png"), str(tmp_path / f"b{i}.png")
        imageio.imwrite(a, img)
        np.testing.assert_array_equal(png.read_png(a), imageio.imread(a))
        png.write_png(b, img)
        np.testing.assert_array_equal(imageio.imread(b), img)


def test_png_codec_undoes_every_row_filter(tmp_path):
    """Rows that name each of the five filters in turn (any bytes are a
    valid filtered row) decode as imageio decodes them."""
    import struct
    import zlib

    import imageio.v2 as imageio

    from flnerf_tpu_torch.data import png

    rng = np.random.default_rng(12)
    for c, (h, w) in ((4, (21, 17)), (3, (9, 30)), (1, (16, 5)), (2, (7, 7))):
        rows = rng.integers(0, 256, (h, w * c + 1), dtype=np.uint8)
        rows[:, 0] = np.arange(h) % 5
        path = str(tmp_path / f"f{c}.png")
        with open(path, "wb") as f:
            f.write(png._SIGNATURE)
            f.write(png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                    png._COLOUR_TYPE[c], 0, 0, 0)))
            f.write(png._chunk(b"IDAT", zlib.compress(rows.tobytes())))
            f.write(png._chunk(b"IEND", b""))
        np.testing.assert_array_equal(png.imread(path), imageio.imread(path))


def test_blender_fixture_without_imageio(tmp_path, monkeypatch):
    from flnerf_tpu.data.synthetic import write_blender_fixture as ref_fixture
    from flnerf_tpu_torch.data import blender, png, synthetic

    ref_fixture(str(tmp_path / "ref"), H=24, n_train=3, n_val=1, n_test=1)
    with_imageio = blender.load_blender_data(str(tmp_path / "ref"))
    monkeypatch.setattr(png, "_imageio", lambda: None)
    synthetic.write_blender_fixture(str(tmp_path / "ours"), H=24, n_train=3, n_val=1, n_test=1)
    for d in ("ref", "ours"):
        got = blender.load_blender_data(str(tmp_path / d))
        for a, b in zip(got[:2], with_imageio[:2]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="needs imageio"):
        png.imwrite(str(tmp_path / "x.jpg"), np.zeros((2, 2, 3), np.uint8))

"""Port parity: the inspection tools and the benchmark recorder
(flnerf_tpu_torch/cli/render_orbit.py, rays/visualize.py, cli/view_data.py,
cli/inspect_cameras.py, core/logging_utils.py, core/benchmark.py) against
the reference package's, on the same files and seeded inputs; the
reference's cv2 drawing is the oracle of the numpy overlays."""

import json
import os

import numpy as np
import pytest
import torch

from flnerf_tpu.cli import inspect_cameras as ref_inspect
from flnerf_tpu.cli import render_orbit as ref_orbit
from flnerf_tpu.cli import view_data as ref_view
from flnerf_tpu.core import benchmark as ref_bench
from flnerf_tpu.core import metrics as ref_metrics
from flnerf_tpu.models import voxel_sh as vs_ref
from flnerf_tpu.rays import quadtree as ref_qt
from flnerf_tpu.rays import visualize as ref_vis
from flnerf_tpu_torch.cli import inspect_cameras, render_orbit, view_data
from flnerf_tpu_torch.core import benchmark, logging_utils
from flnerf_tpu_torch.core import metrics
from flnerf_tpu_torch.core.checkpoint import save_nerf_checkpoint
from flnerf_tpu_torch.core.convert import voxel_grid_from_numpy
from flnerf_tpu_torch.data import png
from flnerf_tpu_torch.data.pose_tools import inspect_epipolar_geometry
from flnerf_tpu_torch.data.synthetic import load_synthetic_data, write_blender_fixture
from flnerf_tpu_torch.models import voxel_sh as vs
from flnerf_tpu_torch.models.nerf_mlp import make_nerf_mlp
from flnerf_tpu_torch.rays import quadtree, visualize

torch.set_num_threads(1)

ORBIT = ["--n_frames", "3", "--H", "12", "--W", "16", "--chunk", "64"]


def _capture_frames(monkeypatch, module):
    """Record the float frames a CLI hands to ``to8b``."""
    frames, to8b = [], module.to8b

    def wrap(x):
        frames.append(np.array(x))
        return to8b(x)
    monkeypatch.setattr(module, "to8b", wrap)
    return frames


def _npz(path, bg=True, step_size=0.5):
    rng = np.random.default_rng(0)
    r = 16
    density = (rng.random((r,) * 3) * 4.0).astype(np.float32)
    density[rng.random((r,) * 3) < 0.6] = 0.0
    sh = (rng.standard_normal((r,) * 3 + (27,)) * 0.3).astype(np.float32)
    background = None
    if bg:
        background = (rng.standard_normal((16, 8, 2, 4)) * 0.5).astype(np.float32)
        background[..., 3] = np.abs(background[..., 3]) * 3.0
    cfg = vs.VoxelGridConfig(reso=(r,) * 3, radius=(1.2,) * 3, step_size=step_size,
                             background_nlayers=2 if bg else 0, background_reso=8)
    grid = voxel_grid_from_numpy(density, sh, np.ones((r,) * 3, bool), background=background)
    vs.save_npz(path, grid, cfg)
    return grid, cfg


@pytest.mark.parametrize("bg", [False, True])
def test_render_orbit_npz_matches_reference(bg, tmp_path, monkeypatch):
    ckpt = str(tmp_path / "ckpt.npz")
    _npz(ckpt, bg)
    ours = _capture_frames(monkeypatch, metrics)
    theirs = _capture_frames(monkeypatch, ref_metrics)
    assert render_orbit.main(["--ckpt", ckpt, "--out", str(tmp_path / "p"), "--device", "cpu"]
                             + ORBIT) == 3
    assert ref_orbit.main(["--ckpt", ckpt, "--out", str(tmp_path / "r")] + ORBIT) == 3
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    for i in range(3):
        np.testing.assert_array_equal(png.read_png(str(tmp_path / "p" / f"{i:03d}.png")),
                                      png.imread(str(tmp_path / "r" / f"{i:03d}.png")))
    assert os.path.getsize(tmp_path / "p" / "orbit.gif") > 0
    assert np.ptp(ours[0]) > 0.1                               # not a blank frame


def test_r9_render_orbit_marches_with_load_npz_defaults_in_both_packages(tmp_path,
                                                                         monkeypatch):
    """R9 (a fault of the reference, mirrored): the orbit of a checkpoint
    trained at step 0.25 renders with load_npz's defaults (step 0.5, 512
    steps) in both packages, not with the training march."""
    ckpt = str(tmp_path / "ckpt.npz")
    grid, cfg = _npz(ckpt, bg=False, step_size=0.25)
    for cfg_l in (vs.load_npz(ckpt)[1], vs_ref.load_npz(ckpt)[1]):
        assert (cfg_l.step_size, cfg_l.max_steps) == (0.5, 512)
    ours = _capture_frames(monkeypatch, metrics)
    theirs = _capture_frames(monkeypatch, ref_metrics)
    render_orbit.main(["--ckpt", ckpt, "--out", str(tmp_path / "p"), "--device", "cpu",
                       "--no_gif"] + ORBIT)
    ref_orbit.main(["--ckpt", ckpt, "--out", str(tmp_path / "r")] + ORBIT)
    np.testing.assert_allclose(ours[0], np.asarray(theirs[0]), atol=1e-5)
    assert not (tmp_path / "p" / "orbit.gif").exists()
    # the training march (step 0.25, enough steps) renders another image
    from flnerf_tpu_torch.rays.camera import intrinsics_matrix, pose_spherical
    from flnerf_tpu_torch.train.plenoxels_trainer import PlenoxelsTrainConfig, PlenoxelsTrainer

    tr = PlenoxelsTrainer(cfg._replace(max_steps=1024), PlenoxelsTrainConfig(), device="cpu")
    tr.state = tr.state._replace(grid=grid)
    trained = tr.render_image(12, 16, intrinsics_matrix(12, 16, 1.1 * 16),
                              pose_spherical(-180.0, -30.0, 4.0)[:3, :4])
    assert np.abs(trained - ours[0]).max() > 1e-3


def test_render_orbit_tar_matches_reference(tmp_path, monkeypatch):
    net = dict(multires=4, multires_views=2, netdepth=2, netwidth=32)
    torch.manual_seed(0)
    coarse, fine = make_nerf_mlp(**net), make_nerf_mlp(**net)
    ckpt = str(tmp_path / "001.tar")
    save_nerf_checkpoint(ckpt, 1, 10, coarse, fine)
    flags = ["--multires", "4", "--multires_views", "2", "--netdepth", "2", "--netwidth", "32"]
    ours = _capture_frames(monkeypatch, metrics)
    theirs = _capture_frames(monkeypatch, ref_metrics)
    render_orbit.main(["--ckpt", ckpt, "--out", str(tmp_path / "p"), "--device", "cpu",
                       "--n_frames", "2", "--H", "6", "--W", "8"] + flags)
    ref_orbit.main(["--ckpt", ckpt, "--out", str(tmp_path / "r"), "--n_frames", "2",
                    "--H", "6", "--W", "8"] + flags)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    with pytest.raises(SystemExit, match="unsupported"):
        render_orbit.main(["--ckpt", "x.pkl", "--device", "cpu"])


def test_render_orbit_gif_needs_imageio(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "ckpt.npz")
    _npz(ckpt, bg=False)
    monkeypatch.setattr(png, "_imageio", lambda: None)
    with pytest.raises(ImportError, match="imageio"):
        render_orbit.main(["--ckpt", ckpt, "--out", str(tmp_path / "p"), "--device", "cpu"]
                          + ORBIT)
    assert sorted(os.listdir(tmp_path / "p")) == ["000.png", "001.png", "002.png"]


def _forests():
    images, _, _, _, _ = load_synthetic_data(n_train=2, n_test=0, H=24, W=20)
    out = []
    for mod in (quadtree, ref_qt):
        f = mod.QuadTreeForest.uniform(2, 24, 20, 2)
        stat = np.random.default_rng(1).random(f.n_leaves)
        f.subdivide(stat, 0.5)
        out.append(f)
    return images, out


def test_visualize_overlays_equal_cv2_drawing(tmp_path):
    images, (f, f_r) = _forests()
    np.testing.assert_array_equal(f.boxes, f_r.boxes)
    for i in range(2):
        np.testing.assert_array_equal(visualize.draw_tree_overlay(images[i], f, i),
                                      ref_vis.draw_tree_overlay(images[i], f_r, i))
    rng = np.random.default_rng(2)
    px = np.concatenate([rng.integers(0, 24, 50), [-1, 30, 0, 23]]).astype(np.float64)
    py = np.concatenate([rng.integers(0, 20, 50), [3, 2, -4, 19]]).astype(np.float64) + 0.4
    np.testing.assert_array_equal(visualize.draw_sample_points(images[0], px, py),
                                  ref_vis.draw_sample_points(images[0], px, py))
    # boxes past every edge, reversed corners, a single pixel
    img = np.full((9, 11, 3), 0.7)
    for box in ((-3, -2, 20, 30), (6, 8, 2, 1), (4, 5, 4, 5), (0, 10, 8, 10)):
        ours = (img * 255).astype(np.uint8)
        visualize.draw_rectangle(ours, *box, (0, 0, 0))
        import cv2
        theirs = (img * 255).astype(np.uint8)
        cv2.rectangle(theirs, (box[1], box[0]), (box[3], box[2]), (0, 0, 0), 1)
        np.testing.assert_array_equal(ours, theirs, err_msg=str(box))
    prob = rng.random((24, 20)) ** 3
    np.testing.assert_array_equal(visualize.prob_heatmap(prob), ref_vis.prob_heatmap(prob))
    sharp = np.stack([prob, prob[::-1]])
    paths = visualize.save_debug_images(str(tmp_path / "p"), images, f, sharp)
    ref_vis.save_debug_images(str(tmp_path / "r"), images, f_r, sharp)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "r"))
    for p in paths:
        with open(p, "rb") as a, open(os.path.join(tmp_path / "r", os.path.basename(p)),
                                      "rb") as b:
            assert a.read() == b.read()
    pngs = visualize.save_debug_images(str(tmp_path / "png"), images, f, ext="png")
    np.testing.assert_array_equal(png.read_png(pngs[1]),
                                  ref_vis.draw_tree_overlay(images[1], f_r, 1))


def test_view_data_detects_and_loads_like_the_reference(tmp_path):
    for name, kind in (("transforms_train.json", "nerf"), ("transforms.json", "ngp"),
                       ("intrinsics.txt", "nsvf"), ("poses_bounds.npy", "llff")):
        d = tmp_path / kind
        d.mkdir()
        (d / name).write_text("")
        assert view_data.detect_dataset_type(str(d)) == ref_view.detect_dataset_type(str(d)) \
            == kind
    (tmp_path / "pp" / "train" / "pose").mkdir(parents=True)
    assert view_data.detect_dataset_type(str(tmp_path / "pp")) == "nerfpp"
    with pytest.raises(ValueError, match="auto-detect"):
        view_data.detect_dataset_type(str(tmp_path))
    write_blender_fixture(str(tmp_path / "blender"), H=16, n_train=3, n_val=1, n_test=1)
    for data, kind in (("synthetic", "synthetic"), (str(tmp_path / "blender"), "nerf")):
        poses, hwf = view_data.load_scene(data, kind)
        poses_r, hwf_r = ref_view.load_scene(data, kind)
        np.testing.assert_allclose(poses, np.asarray(poses_r), atol=1e-6)
        np.testing.assert_allclose(np.asarray(hwf, np.float64), np.asarray(hwf_r, np.float64))
    res = view_data.main([str(tmp_path / "blender"), "--out", str(tmp_path / "vis.png")])
    assert res["type"] == "nerf" and res["n_cams"] == len(ref_view.load_scene(
        str(tmp_path / "blender"), "nerf")[0]) == 5
    assert os.path.getsize(tmp_path / "vis.png") > 0


def test_inspect_cameras_epipolar_matches_reference(tmp_path):
    rng = np.random.default_rng(3)
    cam = {}
    for name, angle in (("a.png", 0.0), ("b.png", 0.3)):
        c2w = np.eye(4)
        c, s = np.cos(angle), np.sin(angle)
        c2w[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        c2w[:3, 3] = [4 * s, 0.1, 4 * c]
        K = np.eye(4)
        K[0, 0] = K[1, 1] = 30.0
        K[0, 2], K[1, 2] = 16, 12
        cam[name] = {"K": K.reshape(-1).tolist(),
                     "W2C": np.linalg.inv(c2w).reshape(-1).tolist(), "img_size": [32, 24]}
        img = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
        png.write_png(str(tmp_path / name), img)
    with open(tmp_path / "cams.json", "w") as f:
        json.dump(cam, f)
    args = ["epipolar", "--cam_dict", str(tmp_path / "cams.json"), "--img_dir", str(tmp_path),
            "--img1", "a.png", "--img2", "b.png", "--n_points", "6"]
    lines = inspect_cameras.main(args + ["--out", str(tmp_path / "p.png")])
    ref_inspect.main(args + ["--out", str(tmp_path / "r.png")])
    assert os.path.getsize(tmp_path / "p.png") > 0 and os.path.getsize(tmp_path / "r.png") > 0
    from flnerf_tpu.data.pose_tools import inspect_epipolar_geometry as ref_epi
    img1, img2 = png.read_png(str(tmp_path / "a.png")), png.read_png(str(tmp_path / "b.png"))
    mats = [np.asarray(cam[n][k]).reshape(4, 4) for n in cam for k in ("K", "W2C")]
    theirs = ref_epi(img1, *mats[:2], img2, *mats[2:], n_points=6)
    np.testing.assert_allclose(lines, theirs, rtol=1e-12)
    # the check alone draws nothing (no matplotlib)
    np.testing.assert_array_equal(inspect_epipolar_geometry(img1, *mats[:2], img2, *mats[2:],
                                                            n_points=6), lines)
    inspect_cameras.main(["frustums", "--cam_dict", str(tmp_path / "cams.json"),
                          "--out", str(tmp_path / "f.png")])
    assert os.path.getsize(tmp_path / "f.png") > 0


def test_logging_utils(tmp_path, capsys):
    t = logging_utils.PhaseTimers()
    for _ in range(2):
        with t.phase("render"):
            pass
    with t.phase("train"):
        sum(range(20000))
    assert t.counts == {"render": 2, "train": 1}
    assert t.totals["train"] > 0
    lines = t.summary().splitlines()
    assert lines[0].startswith("train:") and lines[1].endswith("(2x)")
    log = logging_utils.setup_logger("flnerf_torch_test", str(tmp_path / "log.txt"))
    assert logging_utils.setup_logger("flnerf_torch_test") is log
    log.info("hello %d", 3)
    for h in log.handlers:
        h.flush()
    assert "INFO] flnerf_torch_test: hello 3" in (tmp_path / "log.txt").read_text()
    assert "hello 3" in capsys.readouterr().out
    for h in list(log.handlers):
        log.removeHandler(h)
        h.close()
    w = logging_utils.SummaryWriterWrapper(None)      # no writer: a no-op
    w.add_scalar("a", 1.0, 0)
    w.add_image("b", np.zeros((2, 2, 3), np.uint8), 0)
    w.close()


def test_bench_recorder_matches_reference(tmp_path):
    """The reference's own case (tests/test_aux.py:14-30) on both classes,
    and files that cross between them."""
    recs = [benchmark.BenchRecorder({"scene": "lego"}), ref_bench.BenchRecorder({"scene": "lego"})]
    for r in recs:
        r.record(wall_s=1.0, psnr=10.0, rays=100)
        r.record(wall_s=3.0, psnr=20.0, rays=100)
        r.record(wall_s=5.0, psnr=25.0, rays=100)
        r.record(loss=0.5)
    for target in (15.0, 10.0, 22.5, 30.0):
        assert recs[0].time_to_psnr(target) == recs[1].time_to_psnr(target)
    assert abs(recs[0].time_to_psnr(15.0) - 2.0) < 1e-6
    assert recs[0].time_to_psnr(30.0) is None
    recs[0].samples[-1]["wall_s"] = recs[1].samples[-1]["wall_s"] = 6.0
    recs[0].save(str(tmp_path / "p.json"))
    recs[1].save(str(tmp_path / "r.json"))
    assert (tmp_path / "p.json").read_text() == (tmp_path / "r.json").read_text()
    r2 = ref_bench.BenchRecorder.load(str(tmp_path / "p.json"))
    r3 = benchmark.BenchRecorder.load(str(tmp_path / "r.json"))
    assert r2.meta == r3.meta == {"scene": "lego"} and r2.samples == r3.samples
    rec = benchmark.BenchRecorder()
    rec.record(psnr=1.0)
    assert rec.samples[0]["wall_s"] >= 0.0

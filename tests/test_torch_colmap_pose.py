"""The port's COLMAP readers, pose tools and the CLIs on them
(flnerf_tpu_torch/data/colmap.py, data/pose_tools.py, cli/colmap2nerf.py,
cli/run_colmap.py, cli/converters.py create_split/unsplit/record3d) against
the reference package on the reference tests' own fixtures.  Both packages
are numpy here, so every result is held bit for bit."""

import json
import os
import sqlite3
import sys

import numpy as np
import pytest

from flnerf_tpu.cli import converters as ref_conv
from flnerf_tpu.cli import run_colmap as ref_run
from flnerf_tpu.data import colmap as ref_colmap
from flnerf_tpu.data import pose_tools as ref_pose
from flnerf_tpu_torch.cli import converters, run_colmap
from flnerf_tpu_torch.data import colmap, pose_tools
from flnerf_tpu_torch.data.png import read_png, write_png
from test_colmap import _write_colmap_bin
from test_pose_tools import _camera, _project, _write_sparse_model


def _same(a, b):
    """Equal nested results: arrays bit for bit, named tuples field by field."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b and type(a) is type(b), (a, b)


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# ------------------------------------------------------------ colmap.py

def test_qvec2rotmat_matches_the_reference():
    rng = np.random.default_rng(0)
    qs = [np.array([1.0, 0, 0, 0]), np.array([0.5, 0.5, 0.5, 0.5])]
    qs += [q / np.linalg.norm(q) for q in rng.normal(size=(8, 4))]
    for q in qs:
        _same(colmap.qvec2rotmat(q), ref_colmap.qvec2rotmat(q))
    R = colmap.qvec2rotmat(qs[1])
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)


def test_read_colmap_bin_matches_the_reference(tmp_path):
    truth = _write_colmap_bin(str(tmp_path))
    cams = colmap.read_cameras_bin(str(tmp_path / "cameras.bin"))
    imgs = colmap.read_images_bin(str(tmp_path / "images.bin"))
    _same(cams, ref_colmap.read_cameras_bin(str(tmp_path / "cameras.bin")))
    _same(imgs, ref_colmap.read_images_bin(str(tmp_path / "images.bin")))
    assert cams[1].model == "PINHOLE" and len(imgs) == 4
    for im in imgs.values():
        np.testing.assert_array_equal(im.qvec, truth[im.name][0])


def test_read_colmap_txt_matches_the_reference(tmp_path):
    (tmp_path / "cameras.txt").write_text("# cams\n1 SIMPLE_RADIAL 64 48 80 32 24 0.01\n")
    lines = ["# imgs"]
    for i in range(3):
        lines += [f"{i + 1} 0.9 0.1 {0.1 * i} 0.2 {0.1 * i} 0.2 {0.3 + i} 1 im{i}.png",
                  "1.0 2.0 -1 3.0 4.0 7"]
    (tmp_path / "images.txt").write_text("\n".join(lines) + "\n")
    got = colmap.load_colmap_model(str(tmp_path))
    _same(got, ref_colmap.load_colmap_model(str(tmp_path)))
    assert got[0][1].model == "SIMPLE_RADIAL" and len(got[1]) == 3


@pytest.mark.parametrize("center_and_scale", [True, False])
def test_colmap_to_transforms_matches_the_reference(tmp_path, center_and_scale):
    _write_colmap_bin(str(tmp_path))
    got = colmap.colmap_to_transforms(str(tmp_path), center_and_scale=center_and_scale)
    _same(got, ref_colmap.colmap_to_transforms(str(tmp_path),
                                               center_and_scale=center_and_scale))
    assert got["w"] == 640 and len(got["frames"]) == 4


def test_llff_to_transforms_matches_the_reference(tmp_path):
    n = 3
    poses = np.zeros((n, 3, 5))
    rng = np.random.default_rng(1)
    for i in range(n):
        poses[i, :, :4] = np.eye(3, 4) + 0.1 * rng.normal(size=(3, 4))
        poses[i, :, 4] = [480, 640, 500.0]
    np.save(tmp_path / "poses_bounds.npy",
            np.concatenate([poses.reshape(n, -1), np.tile([1.0, 10.0], (n, 1))], 1))
    (tmp_path / "images").mkdir()
    for i in range(n):
        write_png(str(tmp_path / "images" / f"{i:03d}.png"), np.zeros((4, 4, 3), np.uint8))
    got = colmap.llff_to_transforms(str(tmp_path))
    _same(got, ref_colmap.llff_to_transforms(str(tmp_path)))
    assert len(got["frames"]) == 3


def test_colmap2nerf_cli_writes_the_references_file(tmp_path):
    from flnerf_tpu.cli.colmap2nerf import main as ref_main
    from flnerf_tpu_torch.cli.colmap2nerf import main

    _write_colmap_bin(str(tmp_path))
    main(["--colmap_sparse", str(tmp_path), "--out", str(tmp_path / "port.json")])
    ref_main(["--colmap_sparse", str(tmp_path), "--out", str(tmp_path / "ref.json")])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert len(json.loads((tmp_path / "port.json").read_text())["frames"]) == 4
    with pytest.raises(SystemExit, match="need --colmap_sparse or --llff"):
        main(["--out", str(tmp_path / "x.json")])


# ------------------------------------------------------------- converters

def _split_fixture(root):
    for sub, ext in (("pose", ".txt"), ("rgb", ".png"), ("depths", ".npy")):
        os.makedirs(root / sub)
        for i in range(8):
            (root / sub / f"{i:03d}{ext}").write_bytes(b"x")


@pytest.mark.parametrize("randomize", [False, True])
def test_create_split_and_unsplit_match_the_reference(tmp_path, randomize):
    a, b = tmp_path / "port", tmp_path / "ref"
    _split_fixture(a)
    _split_fixture(b)
    got = converters.create_split(str(a), every=4, randomize=randomize, seed=3)
    want = ref_conv.create_split(str(b), every=4, randomize=randomize, seed=3)
    assert [(os.path.relpath(s, a), os.path.relpath(d, a)) for s, d in got] == \
        [(os.path.relpath(s, b), os.path.relpath(d, b)) for s, d in want]
    assert len(got) == 24 and _tree(a) == _tree(b)
    assert converters.create_split(str(a), every=4) == []
    assert converters.unsplit(str(a)) == ref_conv.unsplit(str(b)) == 24
    assert _tree(a) == _tree(b)
    assert sorted(os.listdir(a / "pose")) == [f"{i:03d}.txt" for i in range(8)]


def _record3d_fixture(root, n=6):
    os.makedirs(root / "frames")
    rng = np.random.default_rng(2)
    poses = []
    for i in range(n):
        write_png(str(root / "frames" / f"f{i:03d}.png"),
                  rng.integers(0, 256, (8, 10, 3)).astype(np.uint8))
        q = rng.normal(size=4)
        poses.append([*(q / np.linalg.norm(q)), float(i), 0.5 * i, -0.2 * i])
    meta = {"K": [100.0, 0, 0, 0, 110.0, 0, 40.0, 30.0, 1.0], "poses": poses}
    (root / "metadata.json").write_text(json.dumps(meta))


def test_record3d_frames_dir_matches_the_reference(tmp_path, monkeypatch):
    a, b = tmp_path / "port", tmp_path / "ref"
    _record3d_fixture(a)
    _record3d_fixture(b)
    assert ref_conv.record3d_to_nsvf(str(b), every=2, factor=2) == 3
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    assert converters.record3d_to_nsvf(str(a), every=2, factor=2) == 3
    for name in ["intrinsics.txt"] + [f"pose/{i:05d}.txt" for i in range(3)]:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    for i in range(3):
        np.testing.assert_array_equal(read_png(str(a / "rgb" / f"{i:05d}.png")),
                                      read_png(str(b / "rgb" / f"{i:05d}.png")))
    K = np.loadtxt(a / "intrinsics.txt")
    assert K.shape == (4, 4) and K[0, 0] == 50.0


def test_record3d_video_without_cv2_names_it(tmp_path, monkeypatch):
    _record3d_fixture(tmp_path)
    (tmp_path / "capture.mp4").write_bytes(b"\x00")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="needs cv2"):
        converters.record3d_to_nsvf(str(tmp_path))


def test_record3d_video_frames_match_the_reference(tmp_path):
    """The video branch: the right half of each frame, BGR to RGB, shrunk by
    INTER_AREA (data/resize.py here, cv2 in the reference)."""
    import cv2

    rng = np.random.default_rng(5)
    for root in (tmp_path / "port", tmp_path / "ref"):
        _record3d_fixture(root, n=8)
    frames = rng.integers(0, 256, (8, 24, 64, 3)).astype(np.uint8)
    for root in (tmp_path / "port", tmp_path / "ref"):
        out = cv2.VideoWriter(str(root / "capture.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                              10, (64, 24))
        assert out.isOpened()
        for fr in frames:
            out.write(fr)
        out.release()
    n = converters.record3d_to_nsvf(str(tmp_path / "port"), every=3, factor=2)
    assert n == ref_conv.record3d_to_nsvf(str(tmp_path / "ref"), every=3, factor=2) == 3
    for i in range(n):
        got = read_png(str(tmp_path / "port" / "rgb" / f"{i:05d}.png"))
        assert got.shape == (12, 16, 3)
        np.testing.assert_array_equal(
            got, read_png(str(tmp_path / "ref" / "rgb" / f"{i:05d}.png")))


# ------------------------------------------------------------ pose_tools

def test_fundamental_matrix_matches_the_reference():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 0.5, (50, 3)) + [0, 0, 3.0]
    K1, W1 = _camera([0, 0, 0], [0, 0, 3.0])
    K2, W2 = _camera([1.0, 0.3, 0.2], [0, 0, 3.0])
    p1, p2 = _project(K1, W1, pts), _project(K2, W2, pts)
    E, F = pose_tools.two_view_fundamental(K1, W1, K2, W2)
    _same((E, F), ref_pose.two_view_fundamental(K1, W1, K2, W2))
    d = pose_tools.epipolar_distance(p1, p2, F)
    _same(d, ref_pose.epipolar_distance(p1, p2, F))
    assert d.max() < 1e-6
    _, W2_bad = _camera([-1.0, 0.5, -0.3], [0.2, 0.1, 3.0])
    _, F_bad = pose_tools.two_view_fundamental(K1, W1, K2, W2_bad)
    assert pose_tools.epipolar_distance(p1, p2, F_bad).mean() > 1.0


def test_interest_points_and_inspector_match_the_reference(tmp_path):
    rng = np.random.default_rng(1)
    img = (rng.random((60, 80)) * 255).astype(np.uint8)
    _same(pose_tools.interest_points(img.astype(np.float32), 8),
          ref_pose.interest_points(img.astype(np.float32), 8))
    K1, W1 = _camera([0, 0, 0], [0, 0, 3.0], f=60, w=80, h=60)
    K2, W2 = _camera([0.5, 0, 0], [0, 0, 3.0], f=60, w=80, h=60)
    out = str(tmp_path / "epi.png")
    lines = pose_tools.inspect_epipolar_geometry(img, K1, W1, img, K2, W2,
                                                 out_path=out, n_points=8)
    _same(lines, ref_pose.inspect_epipolar_geometry(img, K1, W1, img, K2, W2, n_points=8))
    assert lines.shape[1] == 3 and os.path.getsize(out) > 0


def test_normalize_cam_dict_matches_the_reference():
    rng = np.random.default_rng(2)
    cams = {}
    for i in range(6):
        K, W2C = _camera(rng.uniform(5, 9, 3), [0, 0, 0])
        cams[f"im_{i}.png"] = {"K": K.reshape(-1).tolist(),
                               "W2C": W2C.reshape(-1).tolist(), "img_size": [640, 480]}
    norm = pose_tools.normalize_cam_dict(cams, target_radius=1.0)
    _same(norm, ref_pose.normalize_cam_dict(cams, target_radius=1.0))
    centers = np.stack([np.linalg.inv(np.asarray(v["W2C"]).reshape(4, 4))[:3, 3]
                        for v in norm.values()])
    assert 0.85 <= np.linalg.norm(centers - centers.mean(0), axis=1).max() <= 1.0 + 1e-9


def test_frustum_plot_writes_png(tmp_path):
    d = tmp_path / "sparse0"
    _write_sparse_model(str(d))
    cams = pose_tools.cam_dict_from_colmap(str(d))
    _same(cams, ref_pose.cam_dict_from_colmap(str(d)))
    out = str(tmp_path / "cams.png")
    pose_tools.plot_camera_frustums(cams, out, bbox=([-1, -1, -1], [1, 1, 1]))
    assert os.path.getsize(out) > 0


def test_run_colmap_pipeline_matches_the_reference(tmp_path, monkeypatch):
    """The 4 COLMAP stages through an injected runner, then the cam dicts
    and the nerf++ split layout: the same commands and the same files."""
    outs = {}
    for name, mod in (("ref", ref_run), ("port", run_colmap)):
        img_dir, out_dir = tmp_path / name / "imgs", tmp_path / name / "scene"
        os.makedirs(img_dir)
        for i in range(1, 5):
            write_png(str(img_dir / f"im_{i:03d}.png"), np.full((8, 8, 3), 10 * i, np.uint8))
        calls = []

        def fake_runner(cmd, out_dir=out_dir, calls=calls):
            calls.append([os.path.basename(c) for c in cmd])
            if cmd[1] == "mapper":
                _write_sparse_model(str(out_dir / "sparse" / "0"))

        if name == "port":
            monkeypatch.setitem(sys.modules, "imageio", None)
            monkeypatch.setitem(sys.modules, "imageio.v2", None)
        norm = mod.run_pipeline(str(img_dir), str(out_dir), colmap_bin="colmap",
                                runner=fake_runner)
        outs[name] = (norm, calls, _tree(out_dir))
    _same(outs["port"], outs["ref"])
    assert [c[1] for c in outs["port"][1]] == ["feature_extractor", "exhaustive_matcher",
                                               "mapper", "image_undistorter"]
    from flnerf_tpu_torch.data.nerfpp_dataset import load_nerfpp_split

    data = load_nerfpp_split(str(tmp_path / "port"), "scene", "train")
    assert data["images"].shape[0] == 4 and np.isfinite(data["poses"]).all()


def test_run_colmap_posed_pipeline_matches_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    v = rng.standard_normal(3)
    R = colmap.qvec2rotmat(np.array([np.cos(0.4), *(np.sin(0.4) * v / np.linalg.norm(v))]))
    q = run_colmap.rotmat2qvec(R)
    _same(q, ref_run.rotmat2qvec(R))
    np.testing.assert_allclose(colmap.qvec2rotmat(q), R, atol=1e-8)

    cam_dict = {}
    for i, name in enumerate(["a.png", "b.png"]):
        K = np.eye(4)
        K[0, 0] = K[1, 1] = 100.0
        K[0, 2], K[1, 2] = 32, 24
        W2C = np.eye(4)
        W2C[:3, :3] = colmap.qvec2rotmat(np.array([np.cos(0.1 * i), np.sin(0.1 * i), 0, 0]))
        W2C[2, 3] = 2.0 + i
        cam_dict[name] = {"K": K.reshape(-1).tolist(), "W2C": W2C.reshape(-1).tolist(),
                          "img_size": [64, 48]}
    cd_file = tmp_path / "cam_dict.json"
    cd_file.write_text(json.dumps(cam_dict))
    outs = {}
    for name, mod in (("ref", ref_run), ("port", run_colmap)):
        out_dir = tmp_path / name
        stages = []

        def fake_runner(cmd, out_dir=out_dir, stages=stages):
            stages.append(cmd[1])
            if cmd[1] == "feature_extractor":
                db = sqlite3.connect(str(out_dir / "database.db"))
                db.execute("CREATE TABLE images (image_id INTEGER PRIMARY KEY, name TEXT)")
                db.execute("INSERT INTO images VALUES (7, 'b.png')")
                db.execute("INSERT INTO images VALUES (3, 'a.png')")
                db.commit()
                db.close()

        sfm = mod.run_posed_pipeline(str(tmp_path / "imgs"), str(out_dir), str(cd_file),
                                     colmap_bin="colmap", runner=fake_runner)
        outs[name] = (os.path.relpath(sfm, out_dir), stages, _tree(out_dir / "sfm"))
    _same(outs["port"], outs["ref"])
    assert outs["port"][1] == ["feature_extractor", "exhaustive_matcher", "point_triangulator"]
    assert outs["port"][2]["cameras.txt"].startswith(b"3 PINHOLE 64 48 100.0 100.0")

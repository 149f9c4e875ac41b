"""The port's extra loaders (flnerf_tpu_torch/data/extra_loaders.py:
DeepVoxels, LINEMOD, NSVF) and CO3D loader (data/co3d.py) against the
reference package on the layouts of the reference tests' fixtures, and again
with cv2 and imageio unimportable (the port reads PNGs through data/png.py
and shrinks through data/resize.py).  Both packages are numpy: every array
is held bit for bit (the shrink is INTER_AREA at a whole scale, where
data/resize.py equals cv2 exactly)."""

import gzip
import json
import os
import sys

import numpy as np
import pytest

from flnerf_tpu.data import co3d as ref_co3d
from flnerf_tpu.data import extra_loaders as ref_loaders
from flnerf_tpu_torch.data import co3d, extra_loaders
from flnerf_tpu_torch.data.png import write_png
from test_aux_parity import _make_co3d_fixture


def _no_image_libraries(monkeypatch):
    for name in ("cv2", "imageio", "imageio.v2"):
        monkeypatch.setitem(sys.modules, name, None)


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, (list, tuple)) and a and isinstance(a[0], np.ndarray):
            _same(a, b)
        elif isinstance(a, np.ndarray):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, (a, b)


def _rgb(rng, h=8, w=8, c=3):
    return rng.integers(0, 256, (h, w, c)).astype(np.uint8)


def write_dv_fixture(root, n=3, hw=8, seed=0):
    """test_aux.py's deepvoxels layout: train/validation/test, pose txts,
    rgb PNGs, train intrinsics.txt (f cx cy / barycenter / near / scale /
    height width)."""
    rng = np.random.default_rng(seed)
    for split in ("train", "validation", "test"):
        base = os.path.join(root, split, "cube")
        os.makedirs(os.path.join(base, "pose"))
        os.makedirs(os.path.join(base, "rgb"))
        for i in range(n):
            pose = np.eye(4)
            pose[:3, 3] = rng.normal(size=3) + [0, 0, 4.0]
            np.savetxt(os.path.join(base, "pose", f"{i:04d}.txt"), pose.reshape(1, -1))
            write_png(os.path.join(base, "rgb", f"{i:04d}.png"), _rgb(rng, hw, hw))
        if split == "train":
            with open(os.path.join(base, "intrinsics.txt"), "w") as f:
                f.write(f"{hw}. {hw / 2} {hw / 2} 0.\n0 0 0\n1.\n1.\n{hw}. {hw}.\n0\n")


def write_linemod_fixture(root, n=2, hw=8, seed=0, intrinsic=False, channels=3):
    """test_aux.py's LINEMOD layout: transforms_{split}.json with file paths,
    camera_angle_x, near/far (and optionally a per-frame intrinsic_matrix)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "imgs"))
    for s in ("train", "val", "test"):
        frames = []
        for i in range(n):
            name = f"imgs/{s}_{i}.png"
            write_png(os.path.join(root, name), _rgb(rng, hw, hw, channels))
            frame = {"file_path": name, "transform_matrix": np.eye(4).tolist()}
            if intrinsic:
                frame["intrinsic_matrix"] = [[hw * 1.2, 0, hw / 2 - 0.3],
                                             [0, hw * 1.2, hw / 2 + 0.2], [0, 0, 1]]
            frames.append(frame)
        with open(os.path.join(root, f"transforms_{s}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911, "near": 0.2, "far": 2.2, "frames": frames}, f)


def write_nsvf_fixture(root, counts=(("0", 3), ("2", 2)), hw=8, seed=0, intrinsics="10.0 4.0 4.0\n"):
    """test_aux.py's NSVF layout: rgb/ and pose/ with split prefixes and a
    single-focal intrinsics.txt."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "pose"))
    for prefix, n in counts:
        for i in range(n):
            write_png(os.path.join(root, "rgb", f"{prefix}_{i:03d}.png"), _rgb(rng, hw, hw, 4))
            pose = np.eye(4)
            pose[:3, 3] = rng.normal(size=3)
            np.savetxt(os.path.join(root, "pose", f"{prefix}_{i:03d}.txt"), pose.reshape(1, -1))
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        f.write(intrinsics)


@pytest.mark.parametrize("testskip", [1, 2])
def test_deepvoxels_matches_the_reference(tmp_path, monkeypatch, testskip):
    write_dv_fixture(str(tmp_path))
    want = ref_loaders.load_dv_data("cube", str(tmp_path), testskip=testskip)
    _no_image_libraries(monkeypatch)
    got = extra_loaders.load_dv_data("cube", str(tmp_path), testskip=testskip)
    _same(got, want)
    assert got[0].shape[0] == 3 + 2 * len(range(0, 3, testskip))
    assert got[3][0] == 512


@pytest.mark.parametrize("half_res", [False, True])
@pytest.mark.parametrize("intrinsic", [False, True])
def test_linemod_matches_the_reference(tmp_path, monkeypatch, half_res, intrinsic):
    write_linemod_fixture(str(tmp_path), intrinsic=intrinsic, channels=4)
    want = ref_loaders.load_linemod_data(str(tmp_path), half_res=half_res)
    _no_image_libraries(monkeypatch)
    got = extra_loaders.load_linemod_data(str(tmp_path), half_res=half_res)
    _same(got, want)
    images, _, _, hwf, K, _, near, far = got
    assert images.shape == ((6, 4, 4, 4) if half_res else (6, 8, 8, 4))
    assert (near, far) == (0.2, 2.2) and K.shape == (3, 3)


@pytest.mark.parametrize("intrinsics", ["10.0 4.0 4.0\n", "9.5\n",
                                        " ".join(str(v) for v in
                                                 [11, 0, 3.5, 0, 0, 12, 4.5, 0, 0, 0, 1, 0,
                                                  0, 0, 0, 1]) + "\n"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_nsvf_matches_the_reference(tmp_path, monkeypatch, intrinsics, split):
    write_nsvf_fixture(str(tmp_path), intrinsics=intrinsics)
    want = ref_loaders.load_nsvf_data(str(tmp_path), split, scene_scale=0.7)
    _no_image_libraries(monkeypatch)
    got = extra_loaders.load_nsvf_data(str(tmp_path), split, scene_scale=0.7)
    _same(got, want)
    assert got[0].shape == ((3 if split == "train" else 2), 8, 8, 3)


def test_nsvf_refuses_a_split_without_files(tmp_path):
    write_nsvf_fixture(str(tmp_path))
    with pytest.raises(ValueError, match="1_"):
        extra_loaders.load_nsvf_data(str(tmp_path), "val")


# ----------------------------------------------------------------- CO3D

def _co3d_as_png(root):
    """The reference's CO3D fixture with its JPEG frames rewritten as PNGs
    (and the annotations pointing at them), for a run without imageio."""
    import imageio.v2 as imageio

    fa = os.path.join(root, "chair", "frame_annotations.jgz")
    with gzip.open(fa, "rt") as f:
        frames = json.load(f)
    for fr in frames:
        jpg = fr["image"]["path"]
        png = jpg[:-4] + ".png"
        write_png(os.path.join(root, png), imageio.imread(os.path.join(root, jpg)))
        fr["image"]["path"] = png
    with gzip.open(fa, "wt") as f:
        json.dump(frames, f)


def test_co3d_index_and_similarity_match_the_reference(tmp_path):
    _make_co3d_fixture(str(tmp_path))
    want = ref_co3d.build_co3d_index(str(tmp_path), str(tmp_path / "ref.npz"))
    got = co3d.build_co3d_index(str(tmp_path), str(tmp_path / "port.npz"))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert len(got["seq_names"]) == 1 and got["seq_offsets"][-1] == 12
    cached = co3d.build_co3d_index(str(tmp_path), str(tmp_path / "port.npz"))
    for k in got:
        np.testing.assert_array_equal(cached[k], got[k])
    t, s = co3d.similarity_from_cameras(got["pose"])
    t_ref, s_ref = ref_co3d.similarity_from_cameras(want["pose"])
    np.testing.assert_array_equal(t, t_ref)
    assert s == s_ref


@pytest.mark.parametrize("split,max_dim,n", [("train", 800, 10), ("test", 800, 2),
                                              ("train", 20, 10)])
def test_co3d_sequence_matches_the_reference(tmp_path, split, max_dim, n):
    """hold_every 8 keeps 10 train frames and 2 test frames; max_image_dim
    20 halves the 40x30 frames (the INTER_AREA shrink)."""
    _make_co3d_fixture(str(tmp_path))
    idx = str(tmp_path / "idx.npz")
    want = ref_co3d.load_co3d_sequence(str(tmp_path), 0, split, index_file=idx,
                                       max_image_dim=max_dim)
    got = co3d.load_co3d_sequence(str(tmp_path), 0, split, index_file=idx,
                                  max_image_dim=max_dim)
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert got.images.shape == ((n, 40, 30, 3) if max_dim == 800 else (n, 20, 15, 3))
    assert got.c2w.shape == (n, 4, 4)


def test_co3d_png_sequence_without_image_libraries(tmp_path, monkeypatch):
    _make_co3d_fixture(str(tmp_path))
    _co3d_as_png(str(tmp_path))
    idx = str(tmp_path / "idx.npz")
    want = ref_co3d.load_co3d_sequence(str(tmp_path), 0, "train", index_file=idx,
                                       max_image_dim=20)
    _no_image_libraries(monkeypatch)
    got = co3d.load_co3d_sequence(str(tmp_path), 0, "train", index_file=idx,
                                  max_image_dim=20)
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert got.images.shape == (10, 20, 15, 3)
    d = np.linalg.norm(got.c2w[:, :3, 3], axis=-1)
    assert 0.5 < np.median(d) < 2.0

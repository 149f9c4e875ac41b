"""Port parity: the host ray budgeter (flnerf_tpu_torch/rays) against the
reference package (flnerf_tpu/rays).  Both are host numpy driven by the same
``default_rng(seed)``, so every comparison here is exact."""

import numpy as np
import pytest
import torch

from flnerf_tpu.data.synthetic import load_synthetic_data
from flnerf_tpu.rays import quadtree as qt_ref
from flnerf_tpu.rays.camera import get_rays_np, intrinsics_matrix
from flnerf_tpu_torch.rays import quadtree as qt
from flnerf_tpu_torch.rays import sharpness

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    images, poses, _, hwf, _ = load_synthetic_data(n_train=3, n_test=0, H=16, W=16)
    H, W, focal = hwf
    K = intrinsics_matrix(H, W, focal)
    rays = [get_rays_np(H, W, K, p[:3, :4]) for p in poses]
    return images, np.stack([r[0] for r in rays]), np.stack([r[1] for r in rays])


def _budgeters(scene, seed=0):
    images, origins, dirs = scene
    return (qt_ref.RayBudgeter(images, origins, dirs, init_level=2, seed=seed),
            qt.RayBudgeter(images, origins, dirs, init_level=2, seed=seed))


def _assert_same_epoch(a, b):
    assert a.n_leaves == b.n_leaves
    for name in ("origins", "dirs", "rgb", "leaf_id", "px", "py", "img"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("kind", ["uniform", "prob", "fractional", "last_epoch"])
def test_gen_rays_bit_identical(scene, kind):
    ref, port = _budgeters(scene, seed=3)
    kw = {"uniform": {}, "prob": {"prob": True, "rand_samp_perc": 0.4},
          "fractional": {"fractional": True},
          "last_epoch": {"last_epoch": True}}[kind]
    for _ in range(2):    # the second epoch checks that the rng streams stay in step
        _assert_same_epoch(ref.gen_rays(**kw), port.gen_rays(**kw))


def test_sharpness_maps_identical(scene):
    images = scene[0]
    from flnerf_tpu.rays import sharpness as sharp_ref
    np.testing.assert_array_equal(
        sharpness.SharpnessSampler(images).sharp,
        sharp_ref.SharpnessSampler(images).sharp)


def test_adjust_makes_the_same_splits(scene):
    ref, port = _budgeters(scene)
    rng = np.random.default_rng(7)
    for _ in range(3):
        e_ref, e_port = ref.gen_rays(), port.gen_rays()
        _assert_same_epoch(e_ref, e_port)
        stat = rng.random(e_ref.n_leaves) * 0.03
        n_ref = ref.adjust(stat, 0.015)
        n_port = port.adjust(stat, 0.015)
        assert n_ref == n_port > 0
        np.testing.assert_array_equal(ref.forest.boxes, port.forest.boxes)
        np.testing.assert_array_equal(ref.forest.img, port.forest.img)
        np.testing.assert_array_equal(ref.forest.min_area, port.forest.min_area)
        assert ref.forest.cur_level == port.forest.cur_level


def test_tree_pickles_cross_both_ways(scene, tmp_path):
    ref, port = _budgeters(scene)
    stat = np.linspace(0.0, 0.03, ref.forest.n_leaves)
    ref.adjust(stat, 0.015)
    port.adjust(stat, 0.015)
    ref.forest.save(str(tmp_path / "treeDivide_ref.pkl"))
    port.forest.save(str(tmp_path / "treeDivide_port.pkl"))
    for loaded, src in ((qt.QuadTreeForest.load(str(tmp_path / "treeDivide_ref.pkl")), ref.forest),
                        (qt_ref.QuadTreeForest.load(str(tmp_path / "treeDivide_port.pkl")), port.forest)):
        np.testing.assert_array_equal(loaded.boxes, src.boxes)
        np.testing.assert_array_equal(loaded.img, src.img)
        np.testing.assert_array_equal(loaded.min_area, src.min_area)
        assert (loaded.n_images, loaded.H, loaded.W, loaded.cur_level) == (
            src.n_images, src.H, src.W, src.cur_level)

"""The port's area resize (flnerf_tpu_torch/data/resize.py) against OpenCV's
INTER_AREA, which the reference loaders call, and the loaders that use it
running with cv2 unimportable.

Tolerances: where the scale divides the size (a box mean), float32 output
equal to cv2's bit for bit; where it does not, float32 within 1e-5 and
uint8 within 1 level, with the count of differing uint8 values held to
what was measured (0: the weights and the order of the f32 sums are
OpenCV's)."""

import sys

import cv2
import numpy as np
import pytest

from flnerf_tpu_torch.data import blender, llff
from flnerf_tpu_torch.data.png import write_png
from flnerf_tpu_torch.data.resize import area_resize

EXACT = [((96, 96), (48, 48)), ((800, 800), (400, 400))]
FRACTIONAL = [((97, 99), (48, 49)), ((302, 403), (37, 50))]
UINT8_DIFFERING = 0      # uint8 values that differ from cv2's, measured at every size below


def _image(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.random(shape, dtype=np.float32)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("src,dst", EXACT)
def test_box_mean_is_exact(src, dst, channels):
    img = _image(src + (channels,), np.float32)
    got = area_resize(img, dst[::-1])
    assert got.dtype == np.float32 and got.shape == dst + (channels,)
    np.testing.assert_array_equal(got, cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("channels", [None, 1, 3, 4])
@pytest.mark.parametrize("src,dst", FRACTIONAL)
def test_fractional_scale_float32(src, dst, channels):
    shape = src if channels is None else src + (channels,)
    img = _image(shape, np.float32, seed=1)
    got = area_resize(img, dst[::-1])
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA).reshape(got.shape)
    assert got.shape[:2] == dst
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("src,dst", EXACT + FRACTIONAL + [((64, 64), (16, 16)),
                                                          ((45, 30), (15, 10))])
def test_uint8_rounds_and_saturates_as_cv2(src, dst, channels):
    img = _image(src + (channels,), np.uint8, seed=2)
    got = area_resize(img, dst[::-1])
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA).reshape(got.shape)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert int((diff > 0).sum()) == UINT8_DIFFERING


@pytest.mark.parametrize("src,dst", [((64, 64), (16, 16)), ((45, 30), (15, 10)),
                                     ((40, 40), (20, 10)), ((20, 70), (10, 35))])
def test_whole_scales_sum_in_opencv_order(src, dst):
    """Scales 4 and 3, unequal scales, and one channel at 2x with a width
    that is not a multiple of 4 (OpenCV's SIMD loop leaves the last pixels
    to its scalar loop): bit for bit."""
    for channels in (1, 3, 4):
        img = _image(src + (channels,), np.float32, seed=3)
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(area_resize(img, dst[::-1]).reshape(want.shape), want)


def test_refuses_to_enlarge():
    with pytest.raises(ValueError, match="shrinks only"):
        area_resize(np.zeros((4, 4, 3), np.float32), (8, 4))


def test_blender_half_res_without_cv2(tmp_path, monkeypatch):
    from flnerf_tpu.data.blender import load_blender_data as ref_load
    from flnerf_tpu_torch.data.synthetic import write_blender_fixture

    write_blender_fixture(str(tmp_path), H=24, W=30, n_train=2, n_val=1, n_test=1)
    want = ref_load(str(tmp_path), half_res=True)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = blender.load_blender_data(str(tmp_path), half_res=True)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (4, 12, 15, 3)
    assert got[3] == want[3]


def test_llff_factor_2_without_cv2(tmp_path, monkeypatch):
    """No images_2/ directory: the loader downsamples uint8 images itself,
    before /255, as the reference does."""
    from flnerf_tpu.data.llff import load_llff_data as ref_load

    (tmp_path / "images").mkdir()
    rng = np.random.default_rng(4)
    rows = []
    for i in range(5):
        th = -0.4 + 0.2 * i
        pos = np.array([np.sin(th) * 4, 0.1 * i, np.cos(th) * 4])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0, 1.0, 0], fwd)
        right /= np.linalg.norm(right)
        m = np.stack([-np.cross(fwd, right), right, -fwd], 1)
        p35 = np.concatenate([m, pos[:, None], [[33.0], [42.0], [50.0]]], 1)
        rows.append(np.concatenate([p35.reshape(-1), [2.0, 8.0]]))
        write_png(str(tmp_path / "images" / f"im{i:02d}.png"),
                  rng.integers(0, 256, (33, 42, 3)).astype(np.uint8))
    np.save(str(tmp_path / "poses_bounds.npy"), np.stack(rows))
    want = ref_load(str(tmp_path), factor=2)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = llff.load_llff_data(str(tmp_path), factor=2)
    assert got[0].shape == (5, 16, 21, 3)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)

"""Port parity: cameras and datasets (flnerf_tpu_torch/rays/camera.py,
flnerf_tpu_torch/data) against the reference package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flnerf_tpu.data import blender as blender_ref
from flnerf_tpu.data import synthetic as synthetic_ref
from flnerf_tpu.rays import camera as camera_ref
from flnerf_tpu_torch.data import blender, synthetic
from flnerf_tpu_torch.rays import camera

torch.set_num_threads(1)


@pytest.mark.parametrize("theta,phi", [(-120.0, -25.0), (35.0, -60.0)])
def test_get_rays_matches(theta, phi):
    H, W = 12, 16
    K = camera.intrinsics_matrix(H, W, 0.9 * W)
    c2w = camera.pose_spherical(theta, phi, 3.5)[:3, :4]
    o_ref, d_ref = camera_ref.get_rays(H, W, jnp.asarray(K), jnp.asarray(c2w))
    o, d = camera.get_rays(H, W, K, c2w)
    # f32 on both sides, one 3x3 product: agreement to 1e-6
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-6)
    for a, b in zip(camera.get_rays_np(H, W, K, c2w), camera_ref.get_rays_np(H, W, K, c2w)):
        np.testing.assert_array_equal(a, b)


def test_host_camera_helpers_identical():
    np.testing.assert_array_equal(camera.intrinsics_matrix(30, 40, 36.0),
                                  camera_ref.intrinsics_matrix(30, 40, 36.0))
    for args in ((0.0, -30.0, 4.0), (-144.0, -25.0, 3.5)):
        np.testing.assert_array_equal(camera.pose_spherical(*args),
                                      camera_ref.pose_spherical(*args))


def test_load_synthetic_data_identical():
    ours = synthetic.load_synthetic_data(n_train=3, n_test=1, H=12, W=12)
    ref = synthetic_ref.load_synthetic_data(n_train=3, n_test=1, H=12, W=12)
    for a, b in zip(ours[:3], ref[:3]):      # images, poses, render poses
        np.testing.assert_array_equal(a, b)
    assert ours[3] == ref[3]
    for a, b in zip(ours[4], ref[4]):
        np.testing.assert_array_equal(a, b)


def test_blender_fixture_round_trips(tmp_path):
    d_port = synthetic.write_blender_fixture(str(tmp_path / "port"), H=16, n_train=4,
                                             n_val=1, n_test=1)
    d_ref = synthetic_ref.write_blender_fixture(str(tmp_path / "ref"), H=16, n_train=4,
                                                n_val=1, n_test=1)
    port = blender.load_blender_data(d_port, False, 1)
    for loaded in (blender_ref.load_blender_data(d_port, False, 1),
                   blender_ref.load_blender_data(d_ref, False, 1)):
        for a, b in zip(port[:3], loaded[:3]):
            np.testing.assert_array_equal(a, b)
        assert port[3] == loaded[3]
        for a, b in zip(port[4], loaded[4]):
            np.testing.assert_array_equal(a, b)
    imgs = port[0]
    assert imgs.shape == (6, 16, 16, imgs.shape[-1])
    np.testing.assert_array_equal(blender.composite_white_bkgd(imgs, True),
                                  blender_ref.composite_white_bkgd(imgs, True))

"""The benchmark's frozen scene equals the program's procedural scene."""

import numpy as np
import torch

from flnerf_tpu_torch.data import synthetic
from flnerf_tpu_torch.rays.camera import get_rays_np, intrinsics_matrix, pose_spherical
from portbench import scene


def test_render_gt_equals_synthetic_on_a_small_view():
    H = W = 24
    K = intrinsics_matrix(H, W, 0.9 * W)
    for theta in (-180.0, -37.0, 90.0):
        pose = pose_spherical(theta, -25.0, 3.5)
        ro, rd = get_rays_np(H, W, K, pose[:3, :4])
        want = synthetic.render_gt(ro, rd)
        got = scene.render_gt(torch.from_numpy(ro), torch.from_numpy(rd)).numpy()
        # float32 in another order: a shade may differ in its last bits (a few
        # pixels by up to 5e-5 at 24x24); a hit or a miss never does
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_make_scene_is_load_synthetic_data():
    s = scene.make_scene(6, 2, 16, 16, "cpu")
    images, poses, _, hwf, _ = synthetic.load_synthetic_data(n_train=6, n_test=2, H=16, W=16)
    np.testing.assert_allclose(s["poses"], poses, atol=1e-6)
    np.testing.assert_allclose(s["K"], intrinsics_matrix(16, 16, hwf[2]))
    np.testing.assert_allclose(s["images"].numpy(), images, atol=1e-5)
    ro, rd = get_rays_np(16, 16, s["K"], poses[3][:3, :4])
    np.testing.assert_allclose(s["origins"][3].numpy(), ro, atol=1e-6)
    np.testing.assert_allclose(s["dirs"][3].numpy(), rd, atol=1e-6)

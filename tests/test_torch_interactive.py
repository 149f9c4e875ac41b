"""Port parity: the interactive session of flnerf_tpu_torch
(render/interactive.py) against the reference's (flnerf_tpu/render/
interactive.py), headless on the CPU.  The camera is numpy in both and is
held bit for bit.  The preview is held at 1e-5 (rgb and depth) on the same
weights and occupancy (carried across with core/convert.py), at each
downscale, with EMA weights that differ from the live ones.  A small field:
4 levels, 2^10 tables, a 16^3 grid, 32 candidates and 16 kept samples."""

import jax
import numpy as np
import pytest
import torch

from flnerf_tpu.models import hash_ngp as ref_m
from flnerf_tpu.parallel.mesh import make_mesh
from flnerf_tpu.render import interactive as ref_i
from flnerf_tpu.train import ngp_trainer as ref_t
from flnerf_tpu_torch.core import convert
from flnerf_tpu_torch.models import hash_ngp as m
from flnerf_tpu_torch.render import interactive as inter
from flnerf_tpu_torch.render import ngp as r
from flnerf_tpu_torch.train import ngp_trainer as t_ngp

from test_torch_ngp import FIELD_KW, _occ_density, _occ_pair, _scene

torch.set_num_threads(1)

RCFG = r.NGPRenderConfig(n_candidates=32, n_keep=16, grid_size=16, bound=1.0)
TCFG = t_ngp.NGPTrainConfig(max_steps=64, batch_rays=64, steps_per_chunk=4, ema_decay=0.95)


def _sampler(seed=0):
    images, poses, K = _scene()
    poses[:, :3, 3] *= 0.5
    return t_ngp.NGPSampler(images, poses, K, TCFG, seed=seed)


def _session(seed=0, radius=2.5, **kw):
    tr = t_ngp.NGPTrainer(m.NGPConfig(**FIELD_KW), RCFG, TCFG, device="cpu",
                          compute_dtype=torch.float32)
    return inter.InteractiveSession(tr, _sampler(seed), W=32, H=24, radius=radius, **kw)


def _camera_moves(cam):
    cam.orbit(300.0, 0.0)
    cam.orbit(-20.0, 45.0)
    cam.scale(1.0)
    cam.scale(-0.5)
    cam.pan(10.0, -4.0, 2.0)


def test_orbit_camera_matches_the_reference():
    ref, ours = ref_i.OrbitCamera(64, 48, r=2.0, fovy=60.0), inter.OrbitCamera(64, 48, 2.0, 60.0)
    for step in range(2):
        np.testing.assert_array_equal(ours.pose, ref.pose)
        np.testing.assert_array_equal(ours.intrinsics, ref.intrinsics)
        _camera_moves(ref)
        _camera_moves(ours)
    np.testing.assert_array_equal(ours.rot, ref.rot)
    np.testing.assert_array_equal(ours.center, ref.center)
    assert ours.radius == ref.radius < 2.0
    for axis, angle in (([0, 1, 0], 0.3), ([1, 2, 3], -1.1), ([0, 0, 0], 0.5)):
        np.testing.assert_array_equal(inter._rotvec_matrix(np.array(axis), angle),
                                      ref_i._rotvec_matrix(np.array(axis), angle))
    assert inter.DOWNSCALES == ref_i.DOWNSCALES
    for d in (0.1, 0.3, 0.4, 0.6, 0.8, 1.4):
        assert inter._snap_downscale(d) == ref_i._snap_downscale(d)


@pytest.fixture(scope="module")
def sessions():
    """The reference's and the port's sessions on the same weights, EMA
    (the weights with the tables scaled by 0.5) and occupancy, the camera
    inside the bound: the orbit pose looks along +z, away from the origin
    (gui.py's convention, kept by both packages)."""
    init_fn, density_fn, rgb_fn = ref_m.make_ngp_field(ref_m.NGPConfig(**FIELD_KW),
                                                       compute_dtype=jax.numpy.float32)
    t_ref = ref_t.NGPTrainer(init_fn, density_fn, rgb_fn, RCFG, ref_t.NGPTrainConfig(*TCFG),
                             mesh=make_mesh(jax.devices()[:1]))
    params = jax.tree_util.tree_map(np.asarray, t_ref.state.params)
    params["table"] = params["table"] * np.float32(1e4)
    ema = dict(params, table=params["table"] * np.float32(0.5))
    t_ref.state = t_ref.state._replace(params=jax.tree_util.tree_map(jax.numpy.asarray, params),
                                       ema_params=jax.tree_util.tree_map(jax.numpy.asarray, ema))
    ours = _session(radius=0.5)
    convert.load_ngp_params(ours.trainer.field, params)
    ours.trainer.ema = convert.ngp_params_from_numpy(ema)
    t_ref.occ, ours.trainer.occ = _occ_pair(RCFG, _occ_density(16, seed=3, pinned=False))
    ref = ref_i.InteractiveSession(t_ref, None, W=32, H=24, radius=0.5)
    return ref, ours


@pytest.mark.parametrize("downscale", [1.0, 0.5, 0.25])
def test_preview_matches_the_reference(sessions, downscale):
    ref, ours = sessions
    for s in (ref, ours):
        s.cam.orbit(40.0, -15.0)
    live = [p.detach().clone() for p in ours.trainer.params]
    rgb_ref, depth_ref = ref._render(downscale)
    rgb, depth = ours._render(downscale)
    assert rgb.shape == (24, 32, 3) and depth.shape == (24, 32)
    np.testing.assert_allclose(rgb, np.asarray(rgb_ref), atol=1e-5)
    np.testing.assert_allclose(depth, np.asarray(depth_ref), atol=1e-5)
    assert np.ptp(depth) > 0.1 and np.ptp(rgb) > 0.1      # a scene, not a blank frame
    # the render swapped the EMA in and restored the live weights exactly
    for p, q in zip(ours.trainer.params, live):
        assert torch.equal(p, q)
    ema, ours.trainer.ema = ours.trainer.ema, None
    plain, _ = ours._render(downscale)                      # the live weights
    ours.trainer.ema = ema
    assert np.abs(plain - rgb).max() > 1e-3                 # the EMA was used


def test_train_frames_quantised_and_budgeted():
    s = _session()
    s.training = True
    assert s.train_steps == 16
    s.train_budget_ms = 1e-6
    out = s.frame()["train"]
    assert out["train_steps"] == 16 and s.step == 16 and s.trainer.step == 16
    assert s.train_steps == 4                               # the floor of the rule
    out = s.frame()["train"]
    assert out["train_steps"] == 4 and s.step == 20
    s.train_budget_ms = 1e9
    s.frame()
    assert s.train_steps == 16
    s.train_steps = 7                                       # runs 4, a whole chunk
    assert s.train_frame()["train_steps"] == 4
    assert np.isfinite(out["loss"]) and out["lr"] == pytest.approx(1e-2 * 0.1 ** (20 / 64))


def test_spp_accumulates_and_resets():
    s = _session(max_spp=3)
    s.render_budget_ms = 1e9
    outs = [s.render_frame() for _ in range(4)]
    assert [o["spp"] for o in outs] == [1, 2, 3, 3]
    assert outs[3]["time_ms"] == 0.0                        # max_spp reached: no render
    s.zoom(1.0)
    assert s.need_update and s.render_frame()["spp"] == 1
    s.pan(5.0, 0.0)
    assert s.render_frame()["spp"] == 1
    s.render_frame()
    s.set_time(0.5)                     # the D-NeRF slider (rendered in the CLI tests)
    assert s.time == 0.5 and s.need_update
    s.time = None
    assert s.render_frame()["spp"] == 1
    s.mode = "depth"
    s.orbit(10.0, 0.0)
    img = s.render_frame()["image"]
    assert np.array_equal(img[..., 0], img[..., 2])


def test_dynamic_downscale_reacts_to_budget():
    s = _session()
    s.render_budget_ms = 1e-6
    for _ in range(2):
        s.need_update = True
        s.frame()
    assert s.downscale == 0.25
    s.render_budget_ms = 1e9
    s.need_update = True
    s.frame()
    assert s.downscale == 1.0


def test_a_preview_between_train_frames_leaves_training_unchanged():
    """Frames train, render, train give the weights, Adam state and EMA of
    train, train, bit for bit: the preview's EMA swap restores the live
    weights exactly and draws nothing from the trainer's generator.  Both
    budgets are pinned: the step rule follows the wall clock of the last
    frame (interactive.py:150-154), so an unpinned budget lets a loaded
    machine give the two sessions different second frames."""
    a, b = _session(), _session()
    for s in (a, b):
        s.training = True
        s.train_budget_ms = 1e9
    a.train_frame()
    a.render_frame()
    a.train_frame()
    b.train_frame()
    b.train_frame()
    for x, y in ((a.trainer.params, b.trainer.params), (a.trainer.ema, b.trainer.ema),
                 (a.trainer.mu, b.trainer.mu), (a.trainer.nu, b.trainer.nu)):
        for p, q in zip(x, y):
            assert torch.equal(p, q)
    assert a.trainer.history[-1]["loss"] == b.trainer.history[-1]["loss"]


def test_run_dearpygui_raises_without_dearpygui():
    with pytest.raises(ImportError, match="dearpygui"):
        inter.run_dearpygui(_session())

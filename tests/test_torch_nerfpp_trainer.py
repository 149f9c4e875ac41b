"""Port parity: the NeRF++ trainer of flnerf_tpu_torch (train/nerfpp_trainer.py)
against the reference's (flnerf_tpu/train/nerfpp_trainer.py, jitted chunks
of steps_per_chunk steps over the 8-device CPU mesh).  A small f32 cascade
(D6 W32, max_freq_log2 4 and 2, 8 + 16 samples), the same starting weights
(carried across with core/convert.py), the same RayEpochs from the quadtree
budgeter (sharpness sampling on) and the reference's own uniforms fed in
through the trainer's ``draws`` hook, from the reference's key chain:
``fit`` splits PRNGKey(seed + 1) once an epoch, ``run_epoch_rays`` splits
the epoch key into one key a chunk, each chunk one key a step, each step
one key a level, each level four (fg and bg perturbation at level 0, fg
and bg inverse-CDF uniforms at level 1).  768 rays an epoch in steps of 88:
the last step is partial (64 rays) and the reference pads its second chunk
of 5 steps with one padding-only step.

Tolerances: the leaf statistic and the epoch mse 1e-4 relative; each
level's weights after an epoch norm-wise within 1e-3 of the update the
level took, and each parameter within 5e-3 of its own (Adam normalizes
each entry's gradient, so f32 rounding differences of a gradient near zero
become step differences, and the inverse CDF of level 1 turns ulp
differences of level 0's weights into 2e-5 of its depths; ROADMAP.md
oracle notes); the learning rate is the T&T config's 5e-4;
G1, three epochs of both packages (at lr 5e-3) from the same weights on
the same rays: test PSNRs within 0.05 dB."""

import jax
import numpy as np
import pytest
import torch

from flnerf_tpu.data.nerfpp_dataset import make_synthetic_nerfpp_scene as ref_scene
from flnerf_tpu.models.nerfpp import NerfPPConfig as RefConfig
from flnerf_tpu.parallel.mesh import pad_to_multiple
from flnerf_tpu.rays.quadtree import RayBudgeter as RefBudgeter
from flnerf_tpu.train import nerfpp_trainer as ref_t
from flnerf_tpu_torch.core import convert
from flnerf_tpu_torch.data.nerfpp_dataset import make_synthetic_nerfpp_scene
from flnerf_tpu_torch.models.nerfpp import NerfPPConfig
from flnerf_tpu_torch.rays.quadtree import RayBudgeter, RayEpoch
from flnerf_tpu_torch.train import nerfpp_trainer as t

torch.set_num_threads(1)

SMALL = dict(netdepth=6, netwidth=32, max_freq_log2=4, max_freq_log2_viewdirs=2,
             cascade_samples=(8, 16))
B, SPC = 88, 5
G1_DB = 0.05


def ref_uniforms(key, level, n_rays, n_samples):
    """The reference ``_render_level``'s uniforms from its level key."""
    ks = jax.random.split(key, 4)
    a, b = (ks[0], ks[1]) if level == 0 else (ks[2], ks[3])
    return (np.asarray(jax.random.uniform(a, (n_rays, n_samples))),
            np.asarray(jax.random.uniform(b, (n_rays, n_samples))))


def ref_epoch_draws(epoch_key, n_rays, samples=SMALL["cascade_samples"], batch=B, spc=SPC):
    """The per-(step, level) draws of the reference's ``run_epoch_rays``."""
    n_chunks = pad_to_multiple(max(n_rays, 1), batch * spc) // (batch * spc)
    chunk_keys = jax.random.split(epoch_key, n_chunks)
    step_keys = {}

    def draws(step, level):
        ci, j = divmod(step, spc)
        if ci not in step_keys:
            step_keys[ci] = jax.random.split(chunk_keys[ci], spc)
        level_keys = jax.random.split(step_keys[ci][j], len(samples))
        return ref_uniforms(level_keys[level], level, batch, samples[level])
    return draws


def ref_fit_draws(seed):
    """``fit``'s chain: PRNGKey(seed + 1), split once an epoch."""
    state = {"key": jax.random.PRNGKey(seed + 1)}

    def per_epoch(epoch_id, n_rays):
        state["key"], sub = jax.random.split(state["key"])
        return ref_epoch_draws(sub, n_rays)
    return per_epoch


@pytest.fixture(scope="module")
def scene():
    train, test = ref_scene(n_train=3, n_test=1, H=16, W=16)
    ours = make_synthetic_nerfpp_scene(n_train=3, n_test=1, H=16, W=16)
    for d, o in zip((train, test), ours):
        for k in ("images", "origins", "dirs", "intrinsics", "poses"):
            np.testing.assert_array_equal(d[k], o[k])
    return train, test


def _budgeters(train, init_level=2):
    args = (train["images"], train["origins"], train["dirs"])
    return (RefBudgeter(*args, init_level=init_level, seed=0),
            RayBudgeter(*args, init_level=init_level, seed=0))


def _trainers(n_epoch=1, autoexpo=False, n_images=3, lrate=5e-4):
    tc = dict(n_epoch=n_epoch, batch_size=B, lrate=lrate, subdivide_every=1,
              subdivide_thres=0.2, compute_dtype="float32")
    ref = ref_t.NerfPPTrainer(RefConfig(**SMALL, optim_autoexpo=autoexpo),
                              ref_t.NerfPPTrainConfig(**tc, steps_per_chunk=SPC),
                              n_images=n_images)
    ours = t.NerfPPTrainer(NerfPPConfig(**SMALL, optim_autoexpo=autoexpo),
                           t.NerfPPTrainConfig(**tc), n_images=n_images, device="cpu")
    params = jax.tree_util.tree_map(np.asarray, ref.state.params)
    with torch.no_grad():
        for net, sd in zip(ours.nets, convert.nerfpp_params_from_numpy(params)):
            net.load_state_dict(sd)
    return ref, ours


def _hold_weights(ours, ref, before):
    """Each level's weights within 1e-3 of the update the level took,
    norm-wise over all its parameters; each parameter within 5e-3 of its
    own update (a scalar such as sigma.bias takes Adam's +-lr steps, so its
    f32 noise shows undiluted: measured at most 1.4e-3)."""
    want = convert.nerfpp_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                   ref.state.params))
    for m, (net, w, start) in enumerate(zip(ours.nets, want, before)):
        err = step = 0.0
        for name, p in net.state_dict().items():
            e, s = float((p - w[name]).norm()), float((w[name] - start[name]).norm())
            assert s > 0 and e <= 5e-3 * s, (m, name, e / s)
            err, step = err + e * e, step + s * s
        assert err ** 0.5 <= 1e-3 * step ** 0.5, (m, (err / step) ** 0.5)


@pytest.mark.parametrize("autoexpo", [False, True])
def test_one_epoch_matches_the_reference(scene, autoexpo):
    train, _ = scene
    ref_b, b = _budgeters(train)
    epoch = ref_b.gen_rays(prob=True, rand_samp_perc=0.5)
    ours_epoch = b.gen_rays(prob=True, rand_samp_perc=0.5)
    for a, c in zip(epoch, ours_epoch):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
    n = epoch.origins.shape[0]
    assert n == 768 and n % B == 64

    ref, ours = _trainers(autoexpo=autoexpo)
    before = [{k: v.clone() for k, v in net.state_dict().items()} for net in ours.nets]
    key = jax.random.PRNGKey(3)
    leaf_ref, mse_ref = ref.run_epoch_rays(epoch, key)
    calls = []
    step = ours._step
    ours._step = lambda o, *a: calls.append(o.shape[0]) or step(o, *a)
    leaf, mse = ours.run_epoch_rays(ours_epoch, ref_epoch_draws(key, n))
    # the reference ran 10 steps (2 chunks of 5); its padding-only one is a no-op
    assert calls == [B] * 8 + [64]
    assert int(ref.state.global_iter) == ours.global_iter == 9
    np.testing.assert_allclose(leaf, leaf_ref, rtol=1e-4)
    np.testing.assert_allclose(mse, mse_ref, rtol=1e-4)
    _hold_weights(ours, ref, before)
    if autoexpo:
        moved = [float((net.autoexpo.detach() - torch.tensor([0.5, 0.0])).abs().max())
                 for net in ours.nets]
        assert min(moved) > 0

    # the next adjust makes the same subdivisions (threshold in the widest
    # gap of the reference's statistic around its median)
    s = np.sort(leaf_ref)
    mid = len(s) // 2
    gaps = s[mid - 2:mid + 3][1:] - s[mid - 2:mid + 3][:-1]
    thres = float(s[mid - 2 + np.argmax(gaps)] + gaps.max() / 2)
    n_ref, n_ours = ref_b.adjust(leaf_ref, thres), b.adjust(leaf, thres)
    assert 0 < n_ref == n_ours < len(leaf)
    np.testing.assert_array_equal(ref_b.forest.boxes, b.forest.boxes)


def test_rays_outside_the_unit_sphere_are_refused(scene):
    train, _ = scene
    _, b = _budgeters(train)
    e = b.gen_rays()
    _, ours = _trainers()
    far = RayEpoch(e.origins + np.float32([3.0, 0, 0]), *e[1:])
    with pytest.raises(ValueError, match="never enter the unit sphere"):
        ours.run_epoch_rays(far)
    assert ours.global_iter == 0
    # on the main path's draws (the trainer's own generator) it trains
    stat, mse = ours.run_epoch_rays(e)
    assert ours.global_iter == 9 and np.isfinite(mse) and np.isfinite(stat).all()


def test_g1_three_epochs_reach_the_references_test_psnr(scene):
    """G1 for this slice: both packages train three epochs from the same
    weights on the same rays and draws (sharpness sampling, a subdivision
    after epoch 1, the all-pixel last epoch), then render the test view
    with the reference's eval draws: test PSNRs within 0.05 dB."""
    train, test = scene
    ref_b, b = _budgeters(train)
    # lr 5e-3, so that three epochs move the test PSNR well off the
    # untrained render (to ~16 dB; measured difference 1.1e-3 dB)
    ref, ours = _trainers(n_epoch=3, lrate=5e-3)
    ref.fit(ref_b, verbose=False)
    ours.fit(b, verbose=False, draws=ref_fit_draws(ours.cfg.seed))
    assert ours.global_iter == int(ref.state.global_iter)
    np.testing.assert_array_equal(ref_b.forest.boxes, b.forest.boxes)
    assert b.forest.n_leaves > 12
    chunk = 256
    eval_draws = {m: ref_uniforms(jax.random.PRNGKey(m), m, chunk, n)
                  for m, n in enumerate(SMALL["cascade_samples"])}
    args = (test["poses"], test["images"], test["H"], test["W"], test["intrinsics"][0])
    psnr_ref, ssim_ref = ref.eval_images(*args, chunk=chunk)
    psnr, ssim = ours.eval_images(*args, chunk=chunk, draws=eval_draws.__getitem__)
    first = [h["train_psnr"] for h in ours.history]
    assert first[-1] > first[0]
    assert psnr_ref > 14.0
    assert abs(psnr - psnr_ref) <= G1_DB, (psnr, psnr_ref)
    assert abs(ssim - ssim_ref) <= 1e-2

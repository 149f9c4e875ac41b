"""Port parity: the time path of flnerf_tpu_torch's NGP trainer
(train/ngp_trainer.py ``time_dependent``) driving the D-NeRF fields, and the
D-NeRF CLI (cli/main_dnerf.py), against the reference
(flnerf_tpu/train/ngp_trainer.py, flnerf_tpu/cli/main_dnerf.py).

The reference's starting weights are carried to the port with
core/convert.py; its draws come from its own key chain (``fold_in(PRNGKey(seed
+ 1), base_step)``; split once a refresh, which splits into (kt, ku) for its
one time and its jitter and parity, and once a chunk, once a step, then
(perturbation, background)) and are fed to the port through
``update_occupancy(jitter=, parity=, time=)`` and ``train_step(noise=,
times=)``.  Widths as tests/test_torch_dnerf.py; 64 rays a step.

Tolerances: the trainer steps as tests/test_torch_ngp.py holds them (loss
1e-5 relative, per-ray 1e-6; weights and Adam moments norm-wise 1e-4 of the
reference's and entry-wise 1e-3 of the largest entry); G1, test PSNRs within
0.05 dB.  The CLIs run at full width on 16-px views on the CPU."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flnerf_tpu.data.synthetic import load_synthetic_data
from flnerf_tpu.models import dnerf as ref_d
from flnerf_tpu.parallel.mesh import make_mesh
from flnerf_tpu.rays.camera import intrinsics_matrix
from flnerf_tpu.train import ngp_trainer as ref_t
from flnerf_tpu_torch.cli import main_dnerf
from flnerf_tpu_torch.core import convert
from flnerf_tpu_torch.models import dnerf as d
from flnerf_tpu_torch.render import ngp as r
from flnerf_tpu_torch.train import ngp_trainer as t_ngp
from test_torch_dnerf import RCFG, configs, jtree

torch.set_num_threads(1)

G1_DB = 0.05
CLI = ["synthetic", "-O", "--device", "cpu", "--synth_h", "16", "--grid_size", "16",
       "--num_rays", "128", "--n_candidates", "32", "--n_keep", "16", "--steps_per_chunk", "8"]


def trainers(variant, tcfg, seed=0):
    """(the reference's trainer, the port's) on the port's starting weights
    (its tables scaled to O(1)), f32, time-dependent."""
    ref_cfg, cfg = configs(variant)
    field = d.make_dnerf_variant_field(cfg, torch.float32, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        next(field.parameters()).mul_(1e4)
    params = convert.dnerf_params_to_numpy(field)
    _, density_fn, rgb_fn = ref_d.make_dnerf_variant_field(ref_cfg, jnp.float32)
    rcfg = r.NGPRenderConfig(**RCFG)
    tcfg = tcfg._replace(time_dependent=True)
    t_ref = ref_t.NGPTrainer(lambda key: jtree(params), density_fn, rgb_fn, rcfg,
                             ref_t.NGPTrainConfig(*tcfg), mesh=make_mesh(jax.devices()[:1]))
    return t_ref, t_ngp.NGPTrainer(field, rcfg, tcfg, device="cpu")


def scene(n_train=3, n_test=0):
    images, poses, _, hwf, i_split = load_synthetic_data(n_train=n_train, n_test=n_test,
                                                         H=16, W=16)
    poses = poses.copy()
    poses[:, :3, 3] *= 0.5
    times = np.linspace(0, 1, images.shape[0], dtype=np.float32)
    return images, poses, intrinsics_matrix(16, 16, hwf[2]), times, i_split


def port_chunk(t, o, dd, rgb, times, key):
    """The chunk's steps with the reference chunk's perturbation draws."""
    out = []
    for k, kk in enumerate(jax.random.split(key, o.shape[0])):
        kp, _ = jax.random.split(kk)
        noise = torch.from_numpy(np.array(jax.random.uniform(kp, (o.shape[1],
                                                                  t.rcfg.n_candidates))))
        out.append(t.train_step(*(torch.from_numpy(a[k]) for a in (o, dd, rgb)), noise=noise,
                                times=torch.from_numpy(times[k])))
    return out


def ref_occ_draws(key, g, stride, partial):
    """The reference trainer's refresh draws from its key: (t, jitter,
    parity or None)."""
    kt, ku = jax.random.split(key)
    tval = float(jax.random.uniform(kt, ()))
    if partial:
        kp, kj = jax.random.split(ku)
        return (tval, np.array(jax.random.uniform(kj, ((g // stride) ** 3, 3))),
                np.array(jax.random.randint(kp, (3,), 0, stride)))
    return tval, np.array(jax.random.uniform(ku, (g ** 3, 3))), None


def assert_states_match(t, t_ref):
    st = t_ref.state
    assert t.step == int(st.step)
    for ours, theirs in ((t.params, st.params), (t.mu, st.opt_state.mu),
                         (t.nu, st.opt_state.nu)):
        want = convert.dnerf_params_from_numpy(t.field, jax.tree_util.tree_map(np.asarray,
                                                                               theirs))
        for a, b in zip(ours, want):
            a, b = a.detach().numpy(), b.numpy()
            assert a.shape == b.shape
            assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b) + 1e-12
            assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max() + 1e-12


def test_two_trainer_steps_match():
    """Two Adam steps of the deform field from the same weights, occupancy,
    rays, times and noise; the reference's chunk of 2 steps jitted on one
    device.  Both moved the deform net (the CPU paths differentiate the
    encoding in its points)."""
    tcfg = t_ngp.NGPTrainConfig(max_steps=64, batch_rays=64, steps_per_chunk=2)
    t_ref, t = trainers("deform", tcfg)
    g = t.rcfg.grid_size
    tval, jitter, _ = ref_occ_draws(jax.random.PRNGKey(3), g, 2, False)
    t_ref.occ = t_ref._occ_fn(t_ref.occ, t_ref.state.params, jax.random.PRNGKey(3), False)
    t.occ = r.update_occupancy(t.occ, t.field, t.rcfg, jitter=torch.from_numpy(jitter),
                               time=tval)
    np.testing.assert_allclose(t.occ.density.numpy(), np.asarray(t_ref.occ.density),
                               rtol=1e-5, atol=1e-7)
    images, poses, K, times, _ = scene()
    o, dd, rgb, _, _, tt = t_ngp.NGPSampler(images, poses, K, t.cfg, seed=0,
                                            times=times).sample_chunk(2, 64)
    key = jax.random.PRNGKey(11)
    t_ref.state, losses_ref, per_ray_ref = t_ref._chunk_fn(t_ref.state, t_ref.occ, o, dd, rgb,
                                                           tt, key)
    for k, (loss, per_ray) in enumerate(port_chunk(t, o, dd, rgb, tt, key)):
        np.testing.assert_allclose(float(loss), float(losses_ref[k]), rtol=1e-5)
        np.testing.assert_allclose(per_ray.numpy(), np.asarray(per_ray_ref[k]), atol=1e-6)
    assert t.count == int(t_ref.state.opt_state.count) == 2
    assert_states_match(t, t_ref)
    assert float(t.mu[-1].abs().max()) > 0          # the deform net's last layer


def test_deform_net_without_a_point_gradient_stays(monkeypatch):
    """With the encoding's points given no gradient (the kernel path on the
    card: K3/K4's backward returns none for them, as the reference's TPU
    kernel does, R7) a step leaves the deform net and its moments at rest
    and moves the canonical field."""
    from flnerf_tpu_torch.models import hash_ngp
    inner = hash_ngp.hash_encode
    monkeypatch.setattr(hash_ngp, "hash_encode", lambda x, t, s: inner(x.detach(), t, s))
    tcfg = t_ngp.NGPTrainConfig(max_steps=64, batch_rays=64, steps_per_chunk=2)
    _, t = trainers("deform", tcfg)
    t.occ = r.update_occupancy(t.occ, t.field, t.rcfg, time=0.5)
    images, poses, K, times, _ = scene()
    o, dd, rgb, _, _, tt = t_ngp.NGPSampler(images, poses, K, t.cfg,
                                            times=times).sample_chunk(1, 64)
    before = [p.detach().clone() for p in t.params]
    t.train_step(*(torch.from_numpy(a[0]) for a in (o, dd, rgb)), times=torch.from_numpy(tt[0]))
    n_deform = len(t.field.deform_net)
    for p, b, m_ in zip(t.params[-n_deform:], before[-n_deform:], t.mu[-n_deform:]):
        assert torch.equal(p.detach(), b) and not m_.any()
    assert not torch.equal(t.params[0].detach(), before[0])


def test_refresh_draws_one_time_before_its_jitter():
    """The trainer's own refresh draws t ~ U(0, 1) from its generator and
    then the refresh's jitter: the same grid as a refresh fed those draws."""
    tcfg = t_ngp.NGPTrainConfig(time_dependent=True)
    _, cfg = configs("deform")
    rcfg = r.NGPRenderConfig(**RCFG)
    t = t_ngp.NGPTrainer(d.DNeRFField(cfg, torch.float32, torch.Generator().manual_seed(1)),
                         rcfg, tcfg, device="cpu")
    gen = torch.Generator().manual_seed(tcfg.seed + 1)
    tval = torch.rand((), generator=gen)
    want = r.update_occupancy(t.occ, t.field, rcfg, generator=gen, time=tval)
    t.refresh_occupancy(partial=False)
    torch.testing.assert_close(t.occ.density, want.density, rtol=0, atol=0)


def test_g1_deform_chunks_reach_the_references_test_psnr():
    """G1 for this slice: both packages train 8 chunks of 4 steps of the
    deform field (4 full refreshes, then partial ones, each at its own
    time) from the same weights on the same rays, times and draws, then
    render the test views at their times: test PSNRs within G1_DB.  The
    reference's last-step loss falls 0.164 -> 0.095 over the chunks and both
    test renders sit near 9.8 dB, away from the white one."""
    tcfg = t_ngp.NGPTrainConfig(max_steps=32, batch_rays=64, steps_per_chunk=4,
                                full_refreshes=4, lr=3e-3)
    t_ref, t = trainers("deform", tcfg)
    images, poses, K, times, (i_train, _, i_test) = scene(n_train=4, n_test=2)
    s_ref = ref_t.NGPSampler(images[i_train], poses[i_train], K, t_ref.cfg, seed=0,
                             times=times[i_train])
    s = t_ngp.NGPSampler(images[i_train], poses[i_train], K, t.cfg, seed=0,
                         times=times[i_train])
    t_ref.fit(s_ref, verbose=False)

    key = jax.random.fold_in(jax.random.PRNGKey(tcfg.seed + 1), 0)
    g = t.rcfg.grid_size
    for ci in range(tcfg.max_steps // tcfg.steps_per_chunk):
        key, sub = jax.random.split(key)
        partial = ci >= tcfg.full_refreshes
        tval, jitter, parity = ref_occ_draws(sub, g, t.rcfg.partial_stride, partial)
        t.occ = r.update_occupancy(t.occ, t.field, t.rcfg, partial=partial,
                                   jitter=torch.from_numpy(jitter),
                                   parity=None if parity is None else torch.from_numpy(parity),
                                   time=tval)
        o, dd, rgb, _, _, tt = s.sample_chunk(tcfg.steps_per_chunk, tcfg.batch_rays)
        key, sub = jax.random.split(key)
        port_chunk(t, o, dd, rgb, tt, sub)
    assert t.step == int(t_ref.state.step) == tcfg.max_steps
    args = (poses[i_test], images[i_test], 16, 16, K)
    psnr_ref, ssim_ref = t_ref.eval_images(*args, chunk=128, times=times[i_test])
    psnr, ssim = t.eval_images(*args, chunk=128, times=times[i_test])
    losses = [h["loss"] for h in t_ref.history]
    assert losses[-1] < losses[0], losses
    assert abs(psnr - psnr_ref) <= G1_DB, (psnr, psnr_ref)
    assert abs(ssim - ssim_ref) <= 1e-2


@pytest.mark.parametrize("variant", ["deform", "basis", "hyper"])
def test_checkpoint_round_trip(tmp_path, variant):
    """A D-NeRF field's checkpoint holds the reference's trees (params, Adam
    moments) and reloads bit for bit into a fresh trainer of the same
    field, which renders the same test PSNR at the test times."""
    tcfg = t_ngp.NGPTrainConfig(max_steps=8, batch_rays=32, steps_per_chunk=4,
                                time_dependent=True)
    rcfg = r.NGPRenderConfig(n_candidates=16, n_keep=8, grid_size=8, bound=1.0)
    images, poses, K, times, (i_train, _, i_test) = scene(n_train=2, n_test=1)
    ref_cfg, cfg = configs(variant)
    field = d.make_dnerf_variant_field(cfg, torch.float32, torch.Generator().manual_seed(0))
    t = t_ngp.NGPTrainer(field, rcfg, tcfg, device="cpu")
    t.fit(t_ngp.NGPSampler(images[i_train], poses[i_train], K, tcfg, times=times[i_train]),
          verbose=False)
    path = t.save_checkpoint(str(tmp_path))
    with open(path, "rb") as f:
        saved = pickle.load(f)
    init_fn, _, _ = ref_d.make_dnerf_variant_field(ref_cfg, jnp.float32)
    structure = jax.tree_util.tree_structure(init_fn(jax.random.PRNGKey(0)))
    for tree in (saved["params"], saved["opt_state"]["mu"], saved["opt_state"]["nu"]):
        assert jax.tree_util.tree_structure(tree) == structure
    t2 = t_ngp.NGPTrainer(d.make_dnerf_variant_field(cfg, torch.float32), rcfg, tcfg,
                          device="cpu")
    t2.load_checkpoint(str(tmp_path))
    assert t2.step == 8
    for a, b in zip(t.params + t.mu + t.nu, t2.params + t2.mu + t2.nu):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=0)
    args = (poses[i_test], images[i_test], 16, 16, K)
    assert t2.eval_images(*args, chunk=128, times=times[i_test]) == t.eval_images(
        *args, chunk=128, times=times[i_test])


@pytest.mark.parametrize("variant", ["deform", "basis", "hyper"])
def test_cli_each_variant(tmp_path, variant):
    """The CLI at full width on the CPU: 16 steps, the test views at their
    times, results.txt and time_mins.txt; the trainer it returns is
    time-dependent on the variant's field."""
    res = main_dnerf.main(CLI + ["--iters", "16", "--variant", variant,
                                 "--workspace", str(tmp_path)])
    tr = res["trainer"]
    assert isinstance(tr.field, d.VARIANTS[variant]) and tr.cfg.time_dependent
    assert tr.field.cfg.ngp.num_levels == 16 and tr.field.compute_dtype == torch.bfloat16
    assert res["steps"] == 16 and len(res["history"]) == 2
    assert np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])
    for f in ("time_mins.txt", "results.txt"):
        assert os.path.exists(tmp_path / f)
    assert not os.path.exists(tmp_path / "checkpoints")


def test_r6_ignored_settings_have_no_effect(tmp_path, monkeypatch):
    """R6: the CLI builds the reference's configs, not main_nerf's: the
    parsed --log2_hashmap_size, --hash_engine and --bg_radius are not read,
    dt_gamma stays 0, --prob_map, --error_map, --patch_size and EMA are
    off, and the times spread over all the images (test views included)."""
    seen = {}
    inner = t_ngp.NGPTrainer.eval_images

    def capture(self, *a, times=None, **kw):
        seen.setdefault("times", []).append(np.asarray(times))
        return inner(self, *a, times=times, **kw)

    monkeypatch.setattr(t_ngp.NGPTrainer, "eval_images", capture)
    base = CLI + ["--iters", "8", "--workspace"]
    res = main_dnerf.main(base + [str(tmp_path / "a")])
    ignored = ["--log2_hashmap_size", "19", "--hash_engine", "sorted", "--bg_radius", "1",
               "--dt_gamma", "0.5", "--prob_map", "--error_map", "--patch_size", "4"]
    res2 = main_dnerf.main(base + [str(tmp_path / "b")] + ignored)
    tr = res2["trainer"]
    assert tr.field.canonical.spec.t_cap == 2 ** 15 and tr.rcfg.dt_gamma == 0.0
    assert not (tr.cfg.use_prob_map or tr.cfg.use_error_map) and tr.cfg.patch_size == 1
    assert tr.ema is None
    assert res2["psnr"] == res["psnr"]
    assert [h["loss"] for h in res2["history"]] == [h["loss"] for h in res["history"]]
    # synthetic: 8 train, 2 test views; times over all 10, the test ones last
    np.testing.assert_array_equal(seen["times"][0], np.linspace(0, 1, 10,
                                                                dtype=np.float32)[8:])


def test_gui_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="M19"):
        main_dnerf.main(CLI + ["--gui", "--workspace", str(tmp_path)])
    assert not os.listdir(tmp_path)

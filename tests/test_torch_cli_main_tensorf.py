"""Port parity: the NGP trainer of flnerf_tpu_torch driving TensoRF-family
fields (train/ngp_trainer.py's field interface and ``replace_field``), and
the TensoRF and CCNeRF CLIs (cli/main_tensorf.py, cli/main_ccnerf.py),
against the reference (flnerf_tpu/train/ngp_trainer.py,
flnerf_tpu/cli/main_tensorf.py, main_ccnerf.py).

Small widths as in tests/test_torch_tensorf.py, f32, a 16^3 occupancy grid,
32 candidates and 16 kept samples (powers of two: the reference's jitted
divisions by them stay exact), 64 rays a step.  The reference's starting
weights are the port's, carried across as its params tree; its random
draws (occupancy jitter and parity, perturbation) come from its own key
chain (``fold_in(PRNGKey(seed + 1), base_step)``, split once a refresh and
once a chunk, once a step, then (perturbation, background)) and are fed to
the port through ``update_occupancy(jitter=, parity=)`` and
``train_step(noise=)``.

Tolerances: the trainer steps as tests/test_torch_ngp.py holds them (loss
1e-5 relative, per-ray 1e-6; weights, moments and EMA norm-wise 1e-4 of
the reference's and entry-wise 1e-3 of the largest entry: Adam divides
each entry's step by its own |g|); G1, test PSNRs within 0.05 dB."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flnerf_tpu.data.synthetic import load_synthetic_data
from flnerf_tpu.models import tensorf as ref_tf
from flnerf_tpu.models import tensorf_variants as ref_v
from flnerf_tpu.parallel.mesh import make_mesh
from flnerf_tpu.rays.camera import intrinsics_matrix
from flnerf_tpu.render import ngp as ref_r
from flnerf_tpu.train import ngp_trainer as ref_t
from flnerf_tpu_torch.cli import main_ccnerf, main_tensorf
from flnerf_tpu_torch.core import convert
from flnerf_tpu_torch.models import tensorf as tf
from flnerf_tpu_torch.models import tensorf_variants as tv
from flnerf_tpu_torch.render import ngp as r
from flnerf_tpu_torch.train import ngp_trainer as t_ngp
from test_torch_tensorf import SMALL, jtree
from test_torch_tensorf_variants import CC, CP

torch.set_num_threads(1)

RCFG = dict(n_candidates=32, n_keep=16, grid_size=16, bound=1.0)
G1_DB = 0.05
# the CLIs at 16 px on the CPU, at the kernel-free path's small widths
CLI = ["synthetic", "-O", "--device", "cpu", "--synth_h", "16", "--grid_size", "16",
       "--num_rays", "128", "--n_candidates", "32", "--n_keep", "16", "--steps_per_chunk", "8"]


def fields(kind, seed=0):
    """(the reference's (init_fn, density_fn, rgb_fn) on the port's starting
    weights, the port's field), f32."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "vm":
        field = tf.TensoRFField(tf.TensoRFConfig(**SMALL), torch.float32, gen)
        _, density_fn, rgb_fn = ref_tf.make_tensorf_field(ref_tf.TensoRFConfig(**SMALL),
                                                          jnp.float32)
    elif kind == "cp":
        field = tv.CPField(tv.CPConfig(**CP), torch.float32, gen)
        _, density_fn, rgb_fn = ref_v.make_cp_field(ref_v.CPConfig(**CP), jnp.float32)
    else:
        field = tv.CCNeRFField(tv.CCNeRFConfig(**CC), torch.float32, gen, level=2)
        _, density_fn, rgb_fn = ref_v.make_ccnerf_field(ref_v.CCNeRFConfig(**CC), 2,
                                                        jnp.float32)
    params = convert.tensorf_params_to_numpy(field)
    return (lambda key: jtree(params), density_fn, rgb_fn), field


def scene(n=3, h=16):
    images, poses, _, hwf, _ = load_synthetic_data(n_train=n, n_test=0, H=h, W=h)
    poses = poses.copy()
    poses[:, :3, 3] *= 0.5
    return images, poses, intrinsics_matrix(h, h, hwf[2])


def occupancy_density(g=16, seed=10):
    rng = np.random.default_rng(seed)
    d = (rng.random((g, g, g)) * 0.05).astype(np.float32)
    d[rng.random((g, g, g)) < 0.5] = 0.0
    return d


def trainers(kind, tcfg, seed=0):
    ref_fns, field = fields(kind, seed)
    rcfg = r.NGPRenderConfig(**RCFG)
    t_ref = ref_t.NGPTrainer(*ref_fns, rcfg, ref_t.NGPTrainConfig(*tcfg),
                             mesh=make_mesh(jax.devices()[:1]))
    t = t_ngp.NGPTrainer(field, rcfg, tcfg, device="cpu")
    return t_ref, t


def set_occupancy(t_ref, t, density):
    rcfg = t.rcfg
    t_ref.occ = ref_r.with_density(ref_r.init_occupancy(rcfg), jnp.asarray(density), rcfg)
    t.occ = convert.occupancy_from_numpy(density, float(t_ref.occ.mean_density), rcfg)


def ref_chunk(t_ref, o, d, rgb, key):
    t_ref.state, losses, per_ray = t_ref._chunk_fn(t_ref.state, t_ref.occ, o, d, rgb, key)
    return losses, per_ray


def port_chunk(t, o, d, rgb, key):
    """The chunk's steps with the reference chunk's perturbation draws."""
    out = []
    for k, kk in enumerate(jax.random.split(key, o.shape[0])):
        kp, _ = jax.random.split(kk)
        noise = torch.from_numpy(np.array(jax.random.uniform(
            kp, (o.shape[1], t.rcfg.n_candidates))))
        out.append(t.train_step(*(torch.from_numpy(a[k]) for a in (o, d, rgb)), noise=noise))
    return out


def assert_states_match(t, t_ref):
    st = t_ref.state
    assert t.step == int(st.step)
    trees = [(t.params, st.params), (t.mu, st.opt_state.mu), (t.nu, st.opt_state.nu)]
    if t.ema is not None:
        trees.append((t.ema, st.ema_params))
    for ours, theirs in trees:
        want = convert.tensorf_params_from_numpy(t.field, jax.tree_util.tree_map(np.asarray,
                                                                                 theirs))
        for a, b in zip(ours, want):
            a, b = a.detach().numpy(), b.numpy()
            assert a.shape == b.shape
            assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b) + 1e-12
            assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max() + 1e-12


@pytest.mark.parametrize("kind", ["vm", "cp", "ccnerf"])
def test_two_trainer_steps_match(kind):
    """Two Adam steps (with EMA) from the same weights, occupancy, rays and
    noise; the reference's chunk of 2 steps jitted on one device."""
    tcfg = t_ngp.NGPTrainConfig(max_steps=64, batch_rays=64, steps_per_chunk=2,
                                ema_decay=0.95)
    t_ref, t = trainers(kind, tcfg)
    set_occupancy(t_ref, t, occupancy_density())
    images, poses, K = scene()
    o, d, rgb, _, _ = t_ngp.NGPSampler(images, poses, K, tcfg, seed=0).sample_chunk(2, 64)
    key = jax.random.PRNGKey(11)
    losses_ref, per_ray_ref = ref_chunk(t_ref, o, d, rgb, key)
    for k, (loss, per_ray) in enumerate(port_chunk(t, o, d, rgb, key)):
        np.testing.assert_allclose(float(loss), float(losses_ref[k]), rtol=1e-5)
        np.testing.assert_allclose(per_ray.numpy(), np.asarray(per_ray_ref[k]), atol=1e-6)
    assert t.count == int(t_ref.state.opt_state.count) == 2
    assert_states_match(t, t_ref)
    start = fields(kind)[1]
    moved = [np.abs(a.detach().numpy() - b.detach().numpy()).max()
             for a, b in zip(t.params, start.parameters())]
    assert min(moved) > 0 or kind == "ccnerf"
    assert max(moved) > 1e-3


def test_replace_field_matches_the_reference():
    """Two steps, then a shrink and an upsample of the VM field swapped in by
    ``replace_field`` on both trainers, then two more steps: Adam restarts
    from zero moments and count 0, the step and so the lr decay carry on,
    the occupancy grid is kept and the EMA restarts from the new weights."""
    tcfg = t_ngp.NGPTrainConfig(max_steps=64, batch_rays=64, steps_per_chunk=2,
                                ema_decay=0.95)
    t_ref, t = trainers("vm", tcfg)
    dens = occupancy_density()
    dens[:3] = 0.0
    set_occupancy(t_ref, t, dens)
    images, poses, K = scene()
    sampler = t_ngp.NGPSampler(images, poses, K, tcfg, seed=0)
    o, d, rgb, _, _ = sampler.sample_chunk(2, 64)
    ref_chunk(t_ref, o, d, rgb, jax.random.PRNGKey(1))
    port_chunk(t, o, d, rgb, jax.random.PRNGKey(1))

    occ = t.occ
    cfg = ref_tf.TensoRFConfig(**SMALL)
    params, cfg = ref_tf.shrink_tensorf(t_ref.state.params, cfg, np.asarray(t_ref.occ.density),
                                        float(t_ref.occ.mean_density), 1.0)
    params, cfg = ref_tf.upsample_tensorf(params, cfg, (18, 22, 26))
    _, density_fn, rgb_fn = ref_tf.make_tensorf_field(cfg, jnp.float32)
    t_ref.replace_field(density_fn, rgb_fn, params)
    field = tf.upsample_tensorf(tf.shrink_tensorf(t.field, t.occ.density.numpy(),
                                                  float(t.occ.mean_density), 1.0),
                                (18, 22, 26))
    assert field.cfg._asdict() == cfg._asdict() and cfg.aabb[0] > -1.0
    t.replace_field(field)
    assert t.field is field and t.step == 2 and t.count == 0 and t.occ is occ
    assert [p.shape for p in t.params] == [p.shape for p in field.parameters()]
    assert all(not m.any() and not v.any() for m, v in zip(t.mu, t.nu))
    for e, p in zip(t.ema, t.params):
        assert torch.equal(e, p.detach()) and e.data_ptr() != p.data_ptr()
    assert_states_match(t, t_ref)

    o, d, rgb, _, _ = sampler.sample_chunk(2, 64)
    ref_chunk(t_ref, o, d, rgb, jax.random.PRNGKey(2))
    port_chunk(t, o, d, rgb, jax.random.PRNGKey(2))
    assert t.step == 4 and t.count == 2 and t.lr_at(t.step) < tcfg.lr
    assert_states_match(t, t_ref)


def test_field_checkpoint_round_trip(tmp_path):
    """A TensoRF field's checkpoint holds the reference's trees (params,
    EMA, Adam moments) and loads back bit for bit into a trainer of the
    same field; a field of other shapes refuses it."""
    tcfg = t_ngp.NGPTrainConfig(max_steps=16, batch_rays=32, steps_per_chunk=4,
                                ema_decay=0.95)
    rcfg = r.NGPRenderConfig(n_candidates=16, n_keep=8, grid_size=8, bound=1.0)
    images, poses, K = scene(n=2)
    field = fields("vm")[1]
    t = t_ngp.NGPTrainer(field, rcfg, tcfg, device="cpu")
    t.fit(t_ngp.NGPSampler(images, poses, K, tcfg), verbose=False, n_steps=8)
    path = t.save_checkpoint(str(tmp_path))
    import pickle
    with open(path, "rb") as f:
        d = pickle.load(f)
    ref_structure = jax.tree_util.tree_structure(convert.tensorf_params_to_numpy(field))
    for tree in (d["params"], d["ema_params"], d["opt_state"]["mu"], d["opt_state"]["nu"]):
        assert jax.tree_util.tree_structure(tree) == ref_structure
    assert d["step"] == d["opt_state"]["count"] == 8

    t2 = t_ngp.NGPTrainer(fields("vm", seed=1)[1], rcfg, tcfg, device="cpu")
    t2.load_checkpoint(str(tmp_path))
    assert t2.step == t2.count == 8
    for a, b in zip(t.params + t.mu + t.nu + t.ema, t2.params + t2.mu + t2.nu + t2.ema):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=0)
    for a, b in zip(t.occ, t2.occ):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    other = tf.upsample_tensorf(fields("vm")[1], (17, 20, 24))
    with pytest.raises(ValueError, match="shape"):
        t_ngp.NGPTrainer(other, rcfg, tcfg, device="cpu").load_checkpoint(path)


def _ref_occ_draws(key, g, stride, partial):
    """The reference's refresh draws from its key (render/ngp.py
    update_occupancy): (jitter, parity or None)."""
    if partial:
        kp, kj = jax.random.split(key)
        parity = np.array(jax.random.randint(kp, (3,), 0, stride))
        return np.array(jax.random.uniform(kj, ((g // stride) ** 3, 3))), parity
    return np.array(jax.random.uniform(key, (g ** 3, 3))), None


def test_g1_tensorf_chunks_reach_the_references_test_psnr():
    """G1 for this slice: both packages train 8 chunks of 4 steps of the VM
    field (4 full refreshes, then partial ones) from the same weights on
    the same rays and draws, then render the test views: test PSNRs within
    G1_DB.  At lr 3e-3 the loss falls (0.148 -> 0.066 a chunk) and the test
    render leaves the white one of an empty grid (12.24 dB) for ~11.4 dB;
    at the CLI's 1e-2 and above it returns to white (R1)."""
    tcfg = t_ngp.NGPTrainConfig(max_steps=32, batch_rays=64, steps_per_chunk=4,
                                full_refreshes=4, lr=3e-3)
    t_ref, t = trainers("vm", tcfg)
    images, poses, _, hwf, i_split = load_synthetic_data(n_train=4, n_test=2, H=16, W=16)
    poses = poses.copy()
    poses[:, :3, 3] *= 0.5
    K = intrinsics_matrix(16, 16, hwf[2])
    i_train, _, i_test = i_split
    s_ref = ref_t.NGPSampler(images[i_train], poses[i_train], K, t_ref.cfg, seed=0)
    s = t_ngp.NGPSampler(images[i_train], poses[i_train], K, tcfg, seed=0)
    t_ref.fit(s_ref, verbose=False)

    key = jax.random.fold_in(jax.random.PRNGKey(tcfg.seed + 1), 0)
    g = t.rcfg.grid_size
    for ci in range(tcfg.max_steps // tcfg.steps_per_chunk):
        key, sub = jax.random.split(key)
        partial = ci >= tcfg.full_refreshes
        jitter, parity = _ref_occ_draws(sub, g, t.rcfg.partial_stride, partial)
        t.occ = r.update_occupancy(t.occ, t.field, t.rcfg, partial=partial,
                                   jitter=torch.from_numpy(jitter),
                                   parity=None if parity is None else torch.from_numpy(parity))
        o, d, rgb, _, _ = s.sample_chunk(tcfg.steps_per_chunk, tcfg.batch_rays)
        key, sub = jax.random.split(key)
        port_chunk(t, o, d, rgb, sub)
    assert t.step == int(t_ref.state.step) == tcfg.max_steps
    psnr_ref, ssim_ref = t_ref.eval_images(poses[i_test], images[i_test], 16, 16, K, chunk=128)
    psnr, ssim = t.eval_images(poses[i_test], images[i_test], 16, 16, K, chunk=128)
    assert [h["loss"] for h in t_ref.history][-1] < t_ref.history[0]["loss"]
    assert abs(psnr_ref - 12.24) > 0.5, psnr_ref
    assert abs(psnr - psnr_ref) <= G1_DB, (psnr, psnr_ref)
    assert abs(ssim - ssim_ref) <= 1e-2


def test_cli_vm_across_two_upsamples(tmp_path):
    res = main_tensorf.main(CLI + ["--iters", "48", "--resolution0", "16", "--resolution1", "24",
                                   "--upsample_model_steps", "16", "32", "--workspace",
                                   str(tmp_path)])
    cfg = res["field_cfg"]
    assert res["steps"] == 48 and [s["steps"] for s in res["segments"]] == [16, 16, 16]
    assert cfg.resolution == main_tensorf.adaptive_resolution(cfg, 2.0, 24 ** 3)
    assert np.prod(cfg.resolution) <= 24 ** 3 and cfg.resolution != (16, 16, 16)
    assert np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])
    assert len(res["history"]) == 6 and all(np.isfinite(h["loss"]) for h in res["history"])
    for f in ("time_mins.txt", "results.txt"):
        assert os.path.exists(tmp_path / f)
    field = tf.TensoRFField(cfg, torch.bfloat16)
    t = t_ngp.NGPTrainer(field, r.NGPRenderConfig(grid_size=16), t_ngp.NGPTrainConfig(),
                         device="cpu")
    t.load_checkpoint(str(tmp_path))
    assert t.step == 48 and t.count == 16    # Adam restarted at step 32


def test_cli_cp(tmp_path):
    res = main_tensorf.main(CLI + ["--cp", "--iters", "16", "--resolution0", "16",
                                   "--workspace", str(tmp_path)])
    assert res["steps"] == 16 and len(res["segments"]) == 1
    assert isinstance(res["field_cfg"], tv.CPConfig) and res["field_cfg"].resolution == (16,) * 3
    assert np.isfinite(res["psnr"])
    assert os.listdir(tmp_path / "checkpoints") == ["ngp_ep0000016.pkl"]


def test_l1_reg_weight_has_no_effect(tmp_path):
    """R5: --l1_reg_weight is parsed and never read, as in the reference."""
    runs = [main_tensorf.main(CLI + ["--iters", "8", "--resolution0", "16", "--l1_reg_weight",
                                     w, "--workspace", str(tmp_path / w)])
            for w in ("0", "10")]
    assert runs[0]["psnr"] == runs[1]["psnr"]
    assert [h["loss"] for h in runs[0]["history"]] == [h["loss"] for h in runs[1]["history"]]


def test_cli_ccnerf_train_then_compose(tmp_path):
    ws = tmp_path / "train"
    ranks = ["--rank_vec_density", "2", "4", "6", "--rank_mat_density", "1", "2", "3",
             "--rank_vec", "2", "4", "6", "--rank_mat", "1", "2", "3"]
    res = main_ccnerf.main(CLI + ranks + ["--iters", "24", "--resolution0", "16",
                                          "--workspace", str(ws)])
    assert list(res) == ["6_3-6_3", "4_2-4_2", "2_1-2_1"]
    assert all(np.isfinite(p) for p in res.values())
    obj = str(ws / "object.pkl")
    field = main_ccnerf.load_object(obj)
    assert field.cfg.rank_vec == (2, 4, 6) and field.cfg.resolution == (16, 16, 16)
    out = tmp_path / "compose"
    res = main_ccnerf.main(CLI + ["--compose", obj, obj, "--offsets", "0,0,0", "0.6,0,0",
                                  "--scales", "1", "0.5", "--iters", "0",
                                  "--workspace", str(out)])
    assert res["n_objects"] == 2 and np.isfinite(res["psnr"])
    assert sorted(os.listdir(out)) == ["compose_008.png", "compose_009.png"]


@pytest.mark.parametrize("cli", [main_tensorf, main_ccnerf])
def test_gui_is_not_ported(cli, tmp_path):
    with pytest.raises(NotImplementedError, match="M19"):
        cli.main(CLI + ["--gui", "--workspace", str(tmp_path)])

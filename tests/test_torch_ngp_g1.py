"""G1 for the NGP engines (the packed engine at 2^15, the lattice and the
sorted engines at 2^16): both packages start from the reference's weights
(carried across with core/convert.py), train the same chunks on the same
rays with the reference's key chain fed to the port (its refresh jitter and
parity, its perturbation noise), and render the test views: test PSNRs
within 0.05 dB (they land within 1e-5 dB of each other).  The lr (3e-3) is
one at which the loss falls; the CLI's default schedule at these step
counts leaves the white render (R1).  The references train jitted: the
rounding that separates their jitted sample positions from the eager ones
(tests/test_torch_ngp.py test_two_trainer_steps_match) does not reach the
test PSNR."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flnerf_tpu.data.synthetic import load_synthetic_data
from flnerf_tpu.models import hash_ngp as ref_m
from flnerf_tpu.parallel.mesh import make_mesh
from flnerf_tpu.rays.camera import intrinsics_matrix
from flnerf_tpu.train import ngp_trainer as ref_t
from flnerf_tpu_torch.core import convert
from flnerf_tpu_torch.models import hash_ngp as m
from flnerf_tpu_torch.render import ngp as r
from flnerf_tpu_torch.train import ngp_trainer as t_ngp

torch.set_num_threads(1)

G1_DB = 0.05
ENGINE_KW = {"packed": dict(num_levels=4, log2_hashmap_size=15, desired_resolution=64),
             "lattice": dict(num_levels=6, log2_hashmap_size=16, desired_resolution=512),
             "sorted": dict(num_levels=6, log2_hashmap_size=16, desired_resolution=512,
                            hash_engine="sorted")}
RCFG = dict(n_candidates=32, n_keep=16, grid_size=16, bound=1.0)


def _ref_occ_draws(key, g, stride, partial):
    """The reference refresh's draws from its key: (jitter, parity or None)."""
    if partial:
        kp, kj = jax.random.split(key)
        return (np.array(jax.random.uniform(kj, ((g // stride) ** 3, 3))),
                np.array(jax.random.randint(kp, (3,), 0, stride)))
    return np.array(jax.random.uniform(key, (g ** 3, 3))), None


@pytest.mark.parametrize("engine", ["packed", "lattice", "sorted"])
def test_g1_engine_chunks_reach_the_references_test_psnr(engine):
    kw = dict(ENGINE_KW[engine], bound=1.0)
    init_fn, density_fn, rgb_fn = ref_m.make_ngp_field(ref_m.NGPConfig(**kw),
                                                       compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, init_fn(jax.random.PRNGKey(0)))
    params["table"] = jax.tree_util.tree_map(lambda a: a * np.float32(1e4), params["table"])
    rcfg = r.NGPRenderConfig(**RCFG)
    tcfg = t_ngp.NGPTrainConfig(max_steps=24, batch_rays=64, steps_per_chunk=4,
                                full_refreshes=3, lr=3e-3)
    t_ref = ref_t.NGPTrainer(lambda key: jax.tree_util.tree_map(jnp.asarray, params),
                             density_fn, rgb_fn, rcfg, ref_t.NGPTrainConfig(*tcfg),
                             mesh=make_mesh(jax.devices()[:1]))
    t = t_ngp.NGPTrainer(m.NGPConfig(**kw), rcfg, tcfg, device="cpu",
                         compute_dtype=torch.float32)
    convert.load_ngp_params(t.field, params)

    images, poses, _, hwf, (i_train, _, i_test) = load_synthetic_data(n_train=4, n_test=2,
                                                                      H=16, W=16)
    poses = poses.copy()
    poses[:, :3, 3] *= 0.5
    K = intrinsics_matrix(16, 16, hwf[2])
    s_ref = ref_t.NGPSampler(images[i_train], poses[i_train], K, t_ref.cfg, seed=0)
    s = t_ngp.NGPSampler(images[i_train], poses[i_train], K, t.cfg, seed=0)
    t_ref.fit(s_ref, verbose=False)

    key = jax.random.fold_in(jax.random.PRNGKey(tcfg.seed + 1), 0)
    for ci in range(tcfg.max_steps // tcfg.steps_per_chunk):
        key, sub = jax.random.split(key)
        partial = ci >= tcfg.full_refreshes
        jitter, parity = _ref_occ_draws(sub, rcfg.grid_size, rcfg.partial_stride, partial)
        t.occ = r.update_occupancy(t.occ, t.field, rcfg, partial=partial,
                                   jitter=torch.from_numpy(jitter),
                                   parity=None if parity is None else torch.from_numpy(parity))
        o, d, rgb, _, _ = s.sample_chunk(tcfg.steps_per_chunk, tcfg.batch_rays)
        key, sub = jax.random.split(key)
        for k, kk in enumerate(jax.random.split(sub, tcfg.steps_per_chunk)):
            kp, _ = jax.random.split(kk)
            noise = torch.from_numpy(np.array(jax.random.uniform(
                kp, (tcfg.batch_rays, rcfg.n_candidates))))
            t.train_step(*(torch.from_numpy(a[k]) for a in (o, d, rgb)), noise=noise)
    assert t.step == int(t_ref.state.step) == tcfg.max_steps
    args = (poses[i_test], images[i_test], 16, 16, K)
    psnr_ref, ssim_ref = t_ref.eval_images(*args, chunk=128)
    psnr, ssim = t.eval_images(*args, chunk=128)
    losses = [h["loss"] for h in t_ref.history]
    assert losses[-1] < losses[0], losses
    assert abs(psnr - psnr_ref) <= G1_DB, (psnr, psnr_ref)
    assert abs(ssim - ssim_ref) <= 1e-2

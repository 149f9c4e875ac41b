"""Port parity: the NGP field, renderer, sampler and trainer of
flnerf_tpu_torch against the reference (flnerf_tpu/models/hash_ngp.py,
render/ngp.py, train/ngp_trainer.py; the encoding through hash_encode_xla,
the reference's CPU path).  Weights cross with core/convert.py; the
reference's random draws (jitter, parity, perturbation, background) are
taken from its keys and fed to the port.  Small widths: 4 levels, 2^10
tables (the packed engine) or 6 levels, 2^16 tables (the lattice engine: 1
small level, 1 dense and 4 hashed big levels), 16^3 occupancy grids, 32
candidates and 16 kept samples (powers of two, so the reference's jitted
divisions by these constants, which XLA turns into reciprocal multiplies,
stay exact).  The sorted engine takes the lattice's widths with
hash_engine='sorted' (the same 1 small and 5 big levels, torch-ngp's xor
hash); the reference's CPU path encodes its big levels with
hash_encode_xla."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flnerf_tpu.data.synthetic import load_synthetic_data
from flnerf_tpu.models import hash_ngp as ref_m
from flnerf_tpu.parallel.mesh import make_mesh
from flnerf_tpu.rays.camera import intrinsics_matrix
from flnerf_tpu.render import ngp as ref_r
from flnerf_tpu.train import ngp_trainer as ref_t
from flnerf_tpu_torch.core import convert
from flnerf_tpu_torch.models import hash_ngp as m
from flnerf_tpu_torch.ops.hash_lattice import LatticeSpec
from flnerf_tpu_torch.ops.hash_sorted import SplitHashSpec
from flnerf_tpu_torch.render import ngp as r
from flnerf_tpu_torch.train import ngp_trainer as t_ngp

torch.set_num_threads(1)

FIELD_KW = dict(num_levels=4, log2_hashmap_size=10, desired_resolution=64, bound=1.0)
ENGINE_KW = {"packed": FIELD_KW,
             "lattice": dict(num_levels=6, log2_hashmap_size=16, desired_resolution=512,
                             bound=1.0),
             "sorted": dict(num_levels=6, log2_hashmap_size=16, desired_resolution=512,
                            bound=1.0, hash_engine="sorted")}
ENGINES = ["packed", "lattice", "sorted"]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _ref_params(dtype="f32", seed=0, table_scale=1e4, engine="packed"):
    """The reference field's functions and params (numpy), the table(s)
    scaled from their U(-1e-4, 1e-4) init to O(1) so the encoding carries
    weight."""
    init_fn, density_fn, rgb_fn = ref_m.make_ngp_field(ref_m.NGPConfig(**ENGINE_KW[engine]),
                                                       compute_dtype=DTYPES[dtype][0])
    params = jax.tree_util.tree_map(np.asarray, init_fn(jax.random.PRNGKey(seed)))
    params["table"] = jax.tree_util.tree_map(lambda t: t * np.float32(table_scale),
                                             params["table"])
    return density_fn, rgb_fn, params


def _field(params, dtype="f32", engine="packed"):
    field = m.NGPField(m.NGPConfig(**ENGINE_KW[engine]), DTYPES[dtype][1])
    convert.load_ngp_params(field, params)
    return field


def _jtree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _grad_list(grads):
    return [g.numpy() for g in convert.ngp_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, grads))]


def _occ_density(g=16, seed=0, pinned=True):
    rng = np.random.default_rng(seed)
    d = (rng.random((g, g, g)) * 0.05).astype(np.float32)
    d[rng.random((g, g, g)) < 0.5] = 0.0
    if pinned:
        d[rng.random((g, g, g)) < 0.05] = -1.0
    return d


def _occ_pair(rcfg, density):
    ref = ref_r.with_density(ref_r.init_occupancy(rcfg), jnp.asarray(density), rcfg)
    return ref, convert.occupancy_from_numpy(density, float(ref.mean_density), rcfg)


def _rays(n, seed=0, radius=2.5):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    d = -u + 0.3 * rng.standard_normal((n, 3))
    d[:2] = [[0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]       # axis-parallel rays
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = radius * u
    o[1] = [0.0, 3.0, 0.0]                             # a miss
    return o.astype(np.float32), d.astype(np.float32)


def test_configs_match_reference():
    for ours, theirs in ((m.NGPConfig, ref_m.NGPConfig),
                         (r.NGPRenderConfig, ref_r.NGPRenderConfig),
                         (t_ngp.NGPTrainConfig, ref_t.NGPTrainConfig)):
        assert ours._fields == theirs._fields
        assert tuple(ours()) == tuple(theirs())


def test_engine_choice_and_unported_options_raise():
    assert m.make_ngp_spec(m.NGPConfig(bound=2.0)).t_cap == 2 ** 15
    assert m.make_ngp_spec(m.NGPConfig(log2_hashmap_size=16, hash_engine="matmul")).t_cap == 2 ** 16
    spec = m.make_ngp_spec(m.NGPConfig(log2_hashmap_size=19, bound=2.0))
    assert isinstance(spec, LatticeSpec) and spec.n_big == 14 and spec.t_big == 2 ** 19
    assert isinstance(m.make_ngp_spec(m.NGPConfig(log2_hashmap_size=16,
                                                  hash_engine="lattice")), LatticeSpec)
    spec = m.make_ngp_spec(m.NGPConfig(log2_hashmap_size=19, bound=2.0, hash_engine="sorted"))
    ref = ref_m.make_ngp_spec(ref_m.NGPConfig(log2_hashmap_size=19, bound=2.0,
                                              hash_engine="sorted"))
    assert isinstance(spec, SplitHashSpec) and (spec.n_small, spec.n_big) == (2, 14)
    assert spec.t_cap_big == ref.t_cap_big == 2 ** 19 and spec.t_r_big == ref.t_r_big
    assert spec.small.t_cap == ref.small.t_cap
    for ours, theirs in ((spec.base, ref.base), (spec.big, ref.big)):
        for f in ours._fields:
            np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f), err_msg=f)
    assert m.engine_kind(spec) == "sorted"
    with pytest.raises(ValueError, match="needs log2_hashmap_size"):
        m.make_ngp_spec(m.NGPConfig(hash_engine="sorted"))
    with pytest.raises(ValueError, match="needs log2_hashmap_size"):
        m.make_ngp_spec(m.NGPConfig(hash_engine="lattice"))
    # the background env-map is ported (tests/test_torch_ngp_background.py):
    # bg_radius > 0 builds its 2-D table and net
    f = m.NGPField(m.NGPConfig(bg_radius=1.0, **FIELD_KW))
    assert f.has_background and f.bg_table.shape == (m.make_bg_spec(f.cfg).table_size, 2)
    assert not m.NGPField(m.NGPConfig(**FIELD_KW)).has_background
    # the time-dependent (D-NeRF) path is ported: a trainer of a static
    # field with it set refuses a sampler without times
    t = t_ngp.NGPTrainer(m.NGPConfig(**FIELD_KW), r.NGPRenderConfig(grid_size=8),
                         t_ngp.NGPTrainConfig(time_dependent=True), device="cpu")
    images, poses, _, hwf, _ = load_synthetic_data(n_train=1, n_test=0, H=4, W=4)
    with pytest.raises(ValueError, match="times"):
        t.fit(t_ngp.NGPSampler(images, poses, intrinsics_matrix(4, 4, hwf[2]), t.cfg),
              verbose=False)


# f32: the same f32 products summed in another order; bf16: the operands and
# hidden activations round to bf16 at the same places, and a sum that lands
# on the other side of a bf16 rounding boundary moves that activation by one
# bf16 ulp (2^-8), so outputs and gradients are held at bf16 precision.
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_field_matches(dtype, engine):
    density_fn, rgb_fn, params = _ref_params(dtype, engine=engine)
    field = _field(params, dtype, engine)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    d = rng.standard_normal((256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    a, b = rng.random(256).astype(np.float32), rng.random((256, 3)).astype(np.float32)

    def ref_loss(p):
        s, geo = density_fn(p, jnp.asarray(x))
        rgb = rgb_fn(p, jnp.asarray(d), geo)
        return jnp.sum(jnp.log1p(s) * a) + jnp.sum(rgb * b), (s, geo, rgb)

    (_, (s_r, geo_r, rgb_r)), g_r = jax.value_and_grad(ref_loss, has_aux=True)(_jtree(params))
    s, geo = field.density(torch.from_numpy(x))
    rgb = field.color(torch.from_numpy(d), geo)
    loss = torch.sum(torch.log1p(s) * torch.from_numpy(a)) + torch.sum(rgb * torch.from_numpy(b))
    grads = torch.autograd.grad(loss, list(field.parameters()))
    assert s.dtype == geo.dtype == rgb.dtype == torch.float32
    tol = TOL[dtype]
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(s_r), rtol=tol["rtol"])
    np.testing.assert_allclose(geo.detach().numpy(), np.asarray(geo_r), **tol)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_r), **tol)
    for ours, theirs in zip(grads, _grad_list(g_r)):
        scale = float(np.abs(theirs).max())
        assert scale > 0
        np.testing.assert_allclose(ours.numpy(), theirs, atol=tol["atol"] * scale)


def test_near_far_from_aabb_matches():
    o, d = _rays(64)
    o[2] = [0.1, 0.2, 0.3]                             # starts inside
    ref = ref_r.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), 1.0, 0.05)
    ours = r.near_far_from_aabb(torch.from_numpy(o), torch.from_numpy(d), 1.0, 0.05)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not bool(ours[2][1]) and bool(ours[2][0])


@pytest.mark.parametrize("g", [16, 12])
def test_pack_occupancy_and_lookup_match(g):
    """g=16 reads the bitfield, g=12 (12^3 % 32 != 0) the float grid."""
    rcfg = r.NGPRenderConfig(grid_size=g, bound=1.5)
    occ_ref, occ = _occ_pair(rcfg, _occ_density(g))
    if occ.bits is not None:
        np.testing.assert_array_equal(occ.bits.numpy(), np.asarray(occ_ref.bits))
        assert occ.bits.dtype == torch.int32
    xyz = np.random.default_rng(2).uniform(-1.5, 1.5, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        r.occupancy_lookup(occ, torch.from_numpy(xyz), rcfg).numpy(),
        np.asarray(ref_r.occupancy_lookup(occ_ref, jnp.asarray(xyz), rcfg)))


def test_mark_untrained_grid_matches():
    images, poses, _, hwf, _ = load_synthetic_data(n_train=2, n_test=0, H=16, W=16)
    K = intrinsics_matrix(16, 16, hwf[2])
    rcfg = r.NGPRenderConfig(grid_size=16, bound=1.0)
    poses = poses.copy()
    poses[:, :3, 3] *= 0.5
    occ_ref, occ = _occ_pair(rcfg, _occ_density(16, pinned=False))
    a = r.mark_untrained_grid(occ, poses, K, 16, 16, rcfg, chunk=1000)
    b = ref_r.mark_untrained_grid(occ_ref, poses, K, 16, 16, rcfg, chunk=1000)
    np.testing.assert_array_equal(a.density.numpy(), np.asarray(b.density))
    np.testing.assert_array_equal(a.bits.numpy(), np.asarray(b.bits))
    assert (a.density.numpy() == -1).any() and (a.density.numpy() >= 0).any()


@pytest.mark.parametrize("partial,stride", [(False, 2), (True, 2), (True, 4)])
def test_update_occupancy_matches(partial, stride):
    density_fn, _, params = _ref_params()
    field = _field(params)
    rcfg = r.NGPRenderConfig(grid_size=16, bound=1.0, decay=0.9, partial_stride=stride)
    occ_ref, occ = _occ_pair(rcfg, _occ_density(16, seed=3))
    key = jax.random.PRNGKey(4)
    want = ref_r.update_occupancy(occ_ref, _jtree(params), density_fn, key, rcfg,
                                  chunk=1024, partial=partial)
    if partial:
        kp, kj = jax.random.split(key)
        parity = np.array(jax.random.randint(kp, (3,), 0, stride))
        jitter = np.array(jax.random.uniform(kj, ((16 // stride) ** 3, 3)))
    else:
        parity, jitter = None, np.array(jax.random.uniform(key, (16 ** 3, 3)))
    got = r.update_occupancy(occ, field, rcfg, chunk=1024, partial=partial,
                             jitter=torch.from_numpy(jitter),
                             parity=None if parity is None else torch.from_numpy(parity))
    # f32 field evaluations: sigma within 1e-5 relative
    np.testing.assert_allclose(got.density.numpy(), np.asarray(want.density), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(got.mean_density), float(want.mean_density), rtol=1e-5)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    pinned = _occ_density(16, seed=3) < 0
    assert (got.density.numpy()[pinned] == -1).all()


@pytest.mark.parametrize("compaction,dt_gamma", [("argsort", 0.0), ("onehot", 0.0),
                                                 ("argsort", 1 / 128)])
def test_render_rays_matches(compaction, dt_gamma):
    density_fn, rgb_fn, params = _ref_params()
    field = _field(params)
    rcfg = r.NGPRenderConfig(n_candidates=32, n_keep=16, grid_size=16, bound=1.0,
                             compaction=compaction, dt_gamma=dt_gamma)
    occ_ref, occ = _occ_pair(rcfg, _occ_density(16, seed=5))
    o, d = _rays(64, seed=6)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.uniform(key, (64, 32)))
    w = np.random.default_rng(8).random((64, 3)).astype(np.float32)

    def ref_loss(p):
        out = ref_r.ngp_render_rays(key, p, density_fn, rgb_fn, occ_ref, jnp.asarray(o),
                                    jnp.asarray(d), rcfg, perturb=True)
        return jnp.sum(out["rgb"] * w) + jnp.sum(out["depth"]) * 0.1, out

    (_, want), g_r = jax.value_and_grad(ref_loss, has_aux=True)(_jtree(params))
    out = r.ngp_render_rays(field, occ, torch.from_numpy(o), torch.from_numpy(d), rcfg,
                            perturb=True, noise=torch.from_numpy(noise))
    loss = torch.sum(out["rgb"] * torch.from_numpy(w)) + torch.sum(out["depth"]) * 0.1
    grads = torch.autograd.grad(loss, list(field.parameters()))
    # f32 on both sides; the same kept samples (same occupancy decisions)
    for k in ("rgb", "acc", "depth"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want[k]), atol=1e-5)
    assert float(out["acc"].detach().max()) > 0.1
    for ours, theirs in zip(grads, _grad_list(g_r)):
        scale = float(np.abs(theirs).max())
        assert scale > 0
        np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-4 * scale)


def test_render_image_matches():
    density_fn, rgb_fn, params = _ref_params()
    field = _field(params)
    rcfg = r.NGPRenderConfig(n_candidates=32, n_keep=16, grid_size=16, bound=1.0)
    occ_ref, occ = _occ_pair(rcfg, _occ_density(16, seed=9))
    _, poses, _, _, _ = load_synthetic_data(n_train=1, n_test=0, H=4, W=4)
    c2w = poses[0][:3, :4].copy()
    c2w[:, 3] *= 0.6
    K = intrinsics_matrix(10, 12, 11.0)
    # 120 rays in chunks of 128 -> one wrap-padded chunk
    want = ref_r.ngp_render_image(_jtree(params), density_fn, rgb_fn, occ_ref, rcfg,
                                  10, 12, K, c2w, chunk=256)
    got = r.ngp_render_image(field, occ, rcfg, 10, 12, K, c2w, chunk=256)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5)


def _scene(n=3, h=16, rgba=False):
    images, poses, _, hwf, _ = load_synthetic_data(n_train=n, n_test=0, H=h, W=h)
    if rgba:
        alpha = np.random.default_rng(0).random(images.shape[:3] + (1,)).astype(np.float32)
        images = np.concatenate([images, alpha], -1)
    return images, poses, intrinsics_matrix(h, h, hwf[2])


@pytest.mark.parametrize("mode", ["uniform", "prob_map", "error_map", "patch", "rgba"])
def test_sampler_draws_equal(mode):
    images, poses, K = _scene(rgba=mode == "rgba")
    kw = {"prob_map": dict(use_prob_map=True), "error_map": dict(use_error_map=True),
          "patch": dict(patch_size=4, use_error_map=True)}.get(mode, {})
    s_ref = ref_t.NGPSampler(images, poses, K, ref_t.NGPTrainConfig(**kw), seed=5)
    s = t_ngp.NGPSampler(images, poses, K, t_ngp.NGPTrainConfig(**kw), seed=5)
    for rnd in range(3):
        want = s_ref.sample_chunk(3, 70)
        got = s.sample_chunk(3, 70)
        for a, b in zip(got, want[:5]):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
        if mode == "error_map" and rnd == 0:
            err = np.random.default_rng(1).random((3, 70))
            s_ref.update_error_map(want[3], want[4], err)
            s.update_error_map(got[3], got[4], err)
            np.testing.assert_array_equal(s.error_map, s_ref.error_map)
            assert (s.error_map != 1.0).any()
        if rnd == 1:
            s_ref.change_to_allpixel()
            s.change_to_allpixel()
            assert s.image_probs is None and s.error_map is None


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("rgba", [False, True])
def test_two_trainer_steps_match(rgba, engine):
    """Two Adam steps (with EMA) from the same params, occupancy, rays and
    noise; the reference runs its chunk of 2 steps on one device, jitted for
    the packed engine and eagerly for the lattice and sorted engines (its CPU
    paths there are lattice_encode_xla and hash_encode_xla).  Jitted, XLA:CPU
    rounds the sample positions differently from the eager reference (which
    the port matches to ~1e-6 entry-wise); the 2^16 tables' fine levels move
    single table-gradient entries by up to ~1% then, and Adam, which divides
    each entry's step by its own |g|, turns that into step differences the
    test would report."""
    kw = ENGINE_KW[engine]
    init_fn, density_fn, rgb_fn = ref_m.make_ngp_field(ref_m.NGPConfig(**kw),
                                                       compute_dtype=jnp.float32)
    rcfg = r.NGPRenderConfig(n_candidates=32, n_keep=16, grid_size=16, bound=1.0)
    tcfg = t_ngp.NGPTrainConfig(max_steps=64, batch_rays=64, steps_per_chunk=2,
                                ema_decay=0.95)
    t_ref = ref_t.NGPTrainer(init_fn, density_fn, rgb_fn, rcfg, ref_t.NGPTrainConfig(*tcfg),
                             mesh=make_mesh(jax.devices()[:1]))
    t = t_ngp.NGPTrainer(m.NGPConfig(**kw), rcfg, tcfg, device="cpu",
                         compute_dtype=torch.float32)
    params = jax.tree_util.tree_map(np.asarray, t_ref.state.params)
    convert.load_ngp_params(t.field, params)
    t.ema = [p.detach().clone() for p in t.params]
    t_ref.occ, t.occ = _occ_pair(rcfg, _occ_density(16, seed=10, pinned=False))

    images, poses, K = _scene(rgba=rgba)
    poses[:, :3, 3] *= 0.5
    o, d, rgb, _, _ = t_ngp.NGPSampler(images, poses, K, tcfg, seed=0).sample_chunk(2, 64)
    base_key = jax.random.PRNGKey(11)
    with jax.disable_jit(engine != "packed"):
        t_ref.state, losses_ref, per_ray_ref = t_ref._chunk_fn(t_ref.state, t_ref.occ, o, d,
                                                               rgb, base_key)
    for k, key in enumerate(jax.random.split(base_key, 2)):
        kp, kb = jax.random.split(key)
        noise = torch.from_numpy(np.array(jax.random.uniform(kp, (64, 32))))
        bg = torch.from_numpy(np.array(jax.random.uniform(kb, (64, 3)))) if rgba else None
        loss, per_ray = t.train_step(torch.from_numpy(o[k]), torch.from_numpy(d[k]),
                                     torch.from_numpy(rgb[k]), noise=noise, bg_noise=bg)
        np.testing.assert_allclose(float(loss), float(losses_ref[k]), rtol=1e-5)
        np.testing.assert_allclose(per_ray.numpy(), np.asarray(per_ray_ref[k]), atol=1e-6)
    assert t.step == int(t_ref.state.step) == 2

    st = t_ref.state
    adam = st.opt_state
    assert int(adam.count) == 2
    # Adam divides each entry's step by that entry's own |g|: two steps of f32
    # math, held norm-wise at 1e-4 relative and entry-wise at 1e-3 of the
    # largest entry (entries whose |g| is a sum of cancelling terms may move)
    for ours, theirs in ((t.params, st.params), (t.mu, adam.mu), (t.nu, adam.nu),
                         (t.ema, st.ema_params)):
        for a, b in zip(ours, _grad_list(theirs)):
            a = a.detach().numpy()
            assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
            assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
    start = convert.ngp_params_from_numpy(params)
    for i in range(1 if engine == "packed" else 2):   # the steps moved the table(s)
        assert np.abs(t.params[i].detach().numpy() - start[i].numpy()).max() > 1e-3


@pytest.mark.parametrize("engine", ENGINES)
def test_fit_checkpoint_round_trip(tmp_path, engine):
    rcfg = r.NGPRenderConfig(n_candidates=16, n_keep=8, grid_size=8, bound=1.0)
    tcfg = t_ngp.NGPTrainConfig(max_steps=8, batch_rays=32, steps_per_chunk=4,
                                ema_decay=0.95, use_error_map=True)
    images, poses, K = _scene(n=2)
    s = t_ngp.NGPSampler(images, poses, K, tcfg)
    t = t_ngp.NGPTrainer(m.NGPConfig(**ENGINE_KW[engine]), rcfg, tcfg, device="cpu")
    t.fit(s, verbose=False)
    assert t.step == 8 and [h["step"] for h in t.history] == [4, 8]
    assert all(isinstance(h[k], float) and np.isfinite(h[k]) for h in t.history
               for k in ("loss", "chunk_loss"))
    assert (s.error_map != 1.0).any()     # the error map absorbed both chunks
    assert float(t.occ.mean_density) > 0  # the refresh ran

    t.save_checkpoint(str(tmp_path), max_keep=2)
    t.save_checkpoint(str(tmp_path), name="ngp_ep9999999", max_keep=1)
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == ["ngp_ep9999999.pkl"]
    t2 = t_ngp.NGPTrainer(m.NGPConfig(**ENGINE_KW[engine]), rcfg, tcfg, device="cpu")
    t2.load_checkpoint(str(tmp_path))
    assert t2.step == 8
    for a, b in zip(t.params + t.mu + t.nu + t.ema, t2.params + t2.mu + t2.nu + t2.ema):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=0)
    for a, b in zip(t.occ, t2.occ):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # EMA weights render a finite image
    psnr, ssim = t2.eval_images(poses[:1], images[:1], 16, 16, K, chunk=128, use_ema=True)
    assert np.isfinite(psnr) and np.isfinite(ssim)
    torch.testing.assert_close(t2.params[0], t.params[0], rtol=0, atol=0)  # swapped back


@pytest.mark.parametrize("engine", ENGINES)
def test_converters_round_trip(engine):
    _, _, params = _ref_params(engine=engine)
    split = engine != "packed"
    back = convert.ngp_params_to_numpy(convert.ngp_params_from_numpy(params), 2, engine)
    for k in ("table", "sigma_net", "color_net"):
        ours, theirs = back[k], params[k]
        if k == "table":
            assert isinstance(ours, tuple) == split
            ours, theirs = (ours, theirs) if split else ([ours], [theirs])
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    rcfg = r.NGPRenderConfig(grid_size=16)
    dens = _occ_density(16)
    occ = convert.occupancy_from_numpy(dens, 0.01, rcfg)
    d, mean, bits = convert.occupancy_to_numpy(occ)
    np.testing.assert_array_equal(d, dens)
    assert mean == pytest.approx(0.01) and bits.shape == (16 ** 3 // 32,)


def test_sorted_engine_gradients_arrive_entry_for_entry():
    """The reference's sorted-engine gradients ([Ls, C, Trs, 128] and
    [Lb, C, t_r_big, 128], both 4-D) land in the port's natural tables
    entry for entry: entry e of level l, feature c at [l, e, c]."""
    density_fn, _, params = _ref_params(engine="sorted")
    x = jnp.asarray(np.random.default_rng(3).uniform(-1, 1, (256, 3)).astype(np.float32))
    g_r = jax.grad(lambda p: jnp.sum(density_fn(p, x)[0]))(_jtree(params))
    ts, tb = (np.asarray(t) for t in g_r["table"])
    assert ts.ndim == tb.ndim == 4 and np.abs(tb).max() > 0 and np.abs(ts).max() > 0
    ours = _grad_list(g_r)
    for nat, packed in ((ours[0], ts), (ours[1], tb)):
        L, C, t_r, lanes = packed.shape
        assert nat.shape == (L, t_r * lanes, C)
        rng = np.random.default_rng(4)
        for l, e, c in zip(rng.integers(0, L, 500), rng.integers(0, t_r * lanes, 500),
                           rng.integers(0, C, 500)):
            assert nat[l, e, c] == packed[l, c, e // lanes, e % lanes]
        nz = np.argwhere(packed != 0)[:200]
        for l, c, r, ln in nz:
            assert nat[l, r * lanes + ln, c] == packed[l, c, r, ln]
    mlp = [np.asarray(w) for w in list(g_r["sigma_net"]) + list(g_r["color_net"])]
    for a, b in zip(ours[2:], mlp):
        np.testing.assert_array_equal(a, b)

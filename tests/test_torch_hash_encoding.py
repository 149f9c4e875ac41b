"""Port parity: the hash encoding of flnerf_tpu_torch (ops/hash_encoding.py,
ops/hash_kernel.py's plain version, ops/activations.py) against the
reference (flnerf_tpu/ops/hash_encoding.py, hash_pallas.py), on inputs drawn
with numpy from a seed.  Tolerances:
  * spec numbers, corner indices: equal;
  * the plain encode against hash_encode_xla (f32): atol 1e-6 on outputs of
    magnitude ~1; its table gradient against jax.grad: 1e-5 of the largest
    entry (the scatter-adds sum in another order);
  * against the Pallas kernel in interpret mode, which rounds the table (and
    the backward's w*g) to bf16: 1e-2 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flnerf_tpu.core.losses import huber_loss as ref_huber
from flnerf_tpu.ops import hash_encoding as ref_enc
from flnerf_tpu.ops import hash_pallas as ref_hp
from flnerf_tpu.ops.activations import trunc_exp as ref_trunc_exp
from flnerf_tpu.ops.sh_encoding import sh_encode as ref_sh
from flnerf_tpu_torch.core.losses import huber_loss
from flnerf_tpu_torch.ops import hash_encoding as enc
from flnerf_tpu_torch.ops import hash_kernel as hk
from flnerf_tpu_torch.ops.activations import trunc_exp
from flnerf_tpu_torch.ops.sh_encoding import sh_encode

torch.set_num_threads(1)

SMALL = dict(num_levels=4, level_dim=2, base_resolution=4, log2_hashmap_size=10,
             desired_resolution=32)
FULL = dict(desired_resolution=4096)   # NGPConfig defaults at --bound 2


def _table(spec, seed=0, scale=1.0):
    """A random [L, T_cap, C] table and the reference's [L, C, T_r, 128]."""
    rng = np.random.default_rng(seed)
    t = (rng.uniform(-1, 1, (spec.num_levels, spec.t_cap, spec.level_dim)) * scale
         ).astype(np.float32)
    packed = np.ascontiguousarray(t.transpose(0, 2, 1)).reshape(
        spec.num_levels, spec.level_dim, spec.t_r, 128)
    return t, packed


def _points(n, seed=1):
    x = np.random.default_rng(seed).random((n, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0.999999]]
    return x


@pytest.mark.parametrize("kw", [
    {},
    dict(num_levels=16, log2_hashmap_size=15, desired_resolution=4096),
    dict(num_levels=4, base_resolution=4, log2_hashmap_size=10, desired_resolution=32),
    dict(num_levels=4, log2_hashmap_size=15, desired_resolution=2048, input_dim=2),
    dict(num_levels=1, per_level_scale=1.5, desired_resolution=None),
])
def test_spec_numbers_equal(kw):
    a, b = enc.make_hashgrid_spec(**kw), ref_enc.make_hashgrid_spec(**kw)
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.table_size == b.table_size and a.output_dim == b.output_dim


@pytest.mark.parametrize("kw", [SMALL, FULL, dict(log2_hashmap_size=12)])
def test_packed_spec_equal(kw):
    a, b = hk.make_packed_spec(**kw), ref_hp.make_packed_spec(**kw)
    assert (a.t_cap, a.t_r, a.num_levels, a.level_dim, a.output_dim) == (
        b.t_cap, b.t_r, b.num_levels, b.level_dim, b.output_dim)
    for f in a.base._fields:
        np.testing.assert_array_equal(getattr(a.base, f), getattr(b.base, f))


@pytest.mark.parametrize("dim", [2, 3])
def test_corner_index_with_overflowing_coordinates(dim):
    """uint32 wraparound of the dense stride products and the hash products,
    negative coordinates included: equal."""
    rng = np.random.default_rng(3)
    pg = rng.integers(-2 ** 31, 2 ** 31, (4, 500, dim), dtype=np.int64).astype(np.int32)
    pg[:, :50] = rng.integers(0, 40, (4, 50, dim))
    use_hash = np.array([False, True, False, True])[:, None]
    res = np.array([15, 31, 65535, 2047], np.int32)[:, None]
    size = np.array([4920, 32768, 2 ** 19, 12345], np.int64)[:, None]
    want = np.asarray(ref_enc._corner_index(jnp.asarray(pg), jnp.asarray(use_hash),
                                            jnp.asarray(res), jnp.asarray(size)))
    got = enc._corner_index(torch.from_numpy(pg), torch.from_numpy(use_hash),
                            torch.from_numpy(res), torch.from_numpy(size))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("dim", [2, 3, 4])
def test_flat_oracle_matches(dim):
    """The plain encode of 2-, 3- and 4-D points (D-NeRF hyper's lifted
    points) and its table gradient; the 4-D grid has a dense first level
    (5^4 = 625 entries in a 2^10 table) and hashed ones."""
    kw = dict(num_levels=4, base_resolution=4, log2_hashmap_size=10 if dim == 4 else 8,
              desired_resolution=64, input_dim=dim)
    spec, ref_spec = enc.make_hashgrid_spec(**kw), ref_enc.make_hashgrid_spec(**kw)
    if dim == 4:
        assert not spec.use_hash[0] and spec.use_hash[1:].all()
    rng = np.random.default_rng(4)
    table = rng.uniform(-1, 1, (spec.table_size, spec.level_dim)).astype(np.float32)
    x = rng.random((200, dim)).astype(np.float32)
    g_out = rng.standard_normal((200, spec.output_dim)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: ref_enc.hash_encode(jnp.asarray(x), t, ref_spec),
                        jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    got = enc.hash_encode(torch.from_numpy(x), tt, spec)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    (g,) = torch.autograd.grad(got, [tt], torch.from_numpy(g_out))
    g_ref = np.asarray(vjp(jnp.asarray(g_out))[0])
    np.testing.assert_allclose(g.numpy(), g_ref, atol=1e-5 * np.abs(g_ref).max())


@pytest.mark.parametrize("kw", [SMALL, FULL])
def test_corner_indices_weights_match(kw):
    spec, ref_spec = hk.make_packed_spec(**kw), ref_hp.make_packed_spec(**kw)
    x = _points(300)
    hi, lo, w_ref = (np.asarray(a) for a in ref_hp.corner_indices_weights(jnp.asarray(x),
                                                                          ref_spec))
    idx, w = hk.corner_indices_weights(torch.from_numpy(x), spec)
    np.testing.assert_array_equal(idx.numpy(), hi.astype(np.int64) * 128 + lo)
    np.testing.assert_allclose(w.numpy(), w_ref, atol=1e-7)
    assert int(idx.max()) < spec.t_cap
    for l in range(spec.num_levels):   # padding rows are never indexed
        assert int(idx[l].max()) < int(spec.base.sizes[l])


@pytest.mark.parametrize("kw,n", [(SMALL, 300), (FULL, 777)])
def test_plain_encode_matches_xla_twin(kw, n):
    spec, ref_spec = hk.make_packed_spec(**kw), ref_hp.make_packed_spec(**kw)
    t, packed = _table(spec)
    x = _points(n)
    g = np.random.default_rng(5).standard_normal((n, spec.output_dim)).astype(np.float32)

    want = np.asarray(ref_hp.hash_encode_xla(jnp.asarray(x), jnp.asarray(packed), ref_spec))
    tt = torch.from_numpy(t).requires_grad_(True)
    got = hk.hash_encode_plain(torch.from_numpy(x), tt, spec)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)

    gw = np.asarray(jax.grad(lambda tb: jnp.sum(
        ref_hp.hash_encode_xla(jnp.asarray(x), tb, ref_spec) * g))(jnp.asarray(packed)))
    gw = gw.reshape(spec.num_levels, spec.level_dim, spec.t_cap).transpose(0, 2, 1)
    (gt,) = torch.autograd.grad(got, [tt], torch.from_numpy(g))
    scale = float(np.abs(gw).max())
    assert scale > 0
    np.testing.assert_allclose(gt.numpy(), gw, atol=1e-5 * scale)


@pytest.mark.parametrize("kw,n", [(SMALL, 300), (FULL, 300)])
def test_plain_encode_matches_pallas_interpret(kw, n):
    """n * 8 corners is not a multiple of the kernel's 2048-corner chunk, so
    the padded tail runs too."""
    spec, ref_spec = hk.make_packed_spec(**kw), ref_hp.make_packed_spec(**kw)
    t, packed = _table(spec, seed=6)
    x = _points(n, seed=7)
    g = np.random.default_rng(8).standard_normal((n, spec.output_dim)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_hp.hash_encode_pallas(jnp.asarray(x), jnp.asarray(packed),
                                                    ref_spec, 2048))
        gw = np.asarray(jax.grad(lambda tb: jnp.sum(ref_hp.hash_encode_pallas(
            jnp.asarray(x), tb, ref_spec, 2048) * g))(jnp.asarray(packed)))
    tt = torch.from_numpy(t).requires_grad_(True)
    got = hk.hash_encode_plain(torch.from_numpy(x), tt, spec)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-2 * np.abs(want).max())
    (gt,) = torch.autograd.grad(got, [tt], torch.from_numpy(g))
    gw = gw.reshape(spec.num_levels, spec.level_dim, spec.t_cap).transpose(0, 2, 1)
    np.testing.assert_allclose(gt.numpy(), gw, atol=1e-2 * np.abs(gw).max())


def test_cpu_dispatch_runs_the_plain_version_without_launching():
    spec = hk.make_packed_spec(**SMALL)
    t, _ = _table(spec)
    x = torch.from_numpy(_points(50))
    before = hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES
    tt = torch.from_numpy(t).requires_grad_(True)
    out = hk.hash_encode(x, tt, spec)
    out.sum().backward()
    torch.testing.assert_close(out, hk.hash_encode_plain(x, torch.from_numpy(t), spec))
    assert (hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES) == before
    assert float(tt.grad.abs().sum()) > 0


def test_trunc_exp_value_and_clamped_gradient():
    x = np.array([-30.0, -15.5, -1.0, 0.0, 2.0, 14.9, 20.0], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = trunc_exp(xt)
    (g,) = torch.autograd.grad(y.sum(), [xt])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_trunc_exp(jnp.asarray(x))),
                               rtol=1e-6)
    gw = np.asarray(jax.grad(lambda v: jnp.sum(ref_trunc_exp(v)))(jnp.asarray(x)))
    np.testing.assert_allclose(g.numpy(), gw, rtol=1e-6)


def test_sh_encode_degree_4_matches():
    d = np.random.default_rng(9).standard_normal((100, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(sh_encode(torch.from_numpy(d), 4).numpy(),
                               np.asarray(ref_sh(jnp.asarray(d), 4)), atol=1e-6)


def test_huber_loss_matches():
    rng = np.random.default_rng(10)
    a, b = (rng.random((64, 3)).astype(np.float32) for _ in range(2))
    for reduce in (True, False):
        np.testing.assert_allclose(
            huber_loss(torch.from_numpy(a), torch.from_numpy(b), 0.1, reduce).numpy(),
            np.asarray(ref_huber(jnp.asarray(a), jnp.asarray(b), 0.1, reduce)), rtol=1e-6)

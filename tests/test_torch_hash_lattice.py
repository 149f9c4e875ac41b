"""Port parity: the lattice engine of flnerf_tpu_torch (ops/hash_lattice.py,
ops/sort_kernel.py, ops/hash_sorted.py's spec half) against the reference
(flnerf_tpu/ops/hash_lattice.py, sort_pallas.py, hash_sorted.py), on inputs
drawn with numpy from a seed.  Tolerances:
  * multipliers, specs, base keys, sorted keys, converters: equal;
  * the plain encode against lattice_encode_xla (f32, the same products
    summed in the same corner order): atol 1e-6 on outputs of magnitude ~1;
    its table gradient against jax.grad: 1e-5 of the largest entry (the
    scatter-adds sum in another order);
  * against the Pallas engine in interpret mode, which fetches a bf16 table
    with 16/14-bit fractions and scatters w*g in bf16: the reference's own
    tolerances (tests/test_hash_lattice.py:46 and :95) on its own U(-1e-4,
    1e-4) table scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flnerf_tpu.ops import hash_lattice as ref_hl
from flnerf_tpu.ops import hash_pallas as ref_hp
from flnerf_tpu.ops import hash_sorted as ref_hs
from flnerf_tpu.ops import sort_pallas as ref_sort
from flnerf_tpu_torch.ops import hash_kernel as hk
from flnerf_tpu_torch.ops import hash_lattice as hl
from flnerf_tpu_torch.ops import hash_sorted as hs
from flnerf_tpu_torch.ops import sort_kernel as sk

torch.set_num_threads(1)

FULL = dict(log2_hashmap_size=19, desired_resolution=4096)    # main_nerf -O at 2^19
SMALL = dict(num_levels=6, log2_hashmap_size=16, desired_resolution=512)


def _specs(kw):
    return hl.make_lattice_spec(**kw), ref_hl.make_lattice_spec(**kw)


def _table_big(spec, seed=0, scale=1.0):
    """A U(-scale, scale) [Lb, T, 2] table and the reference's [Lb, t_r64, 128]."""
    t = (np.random.default_rng(seed).uniform(-1, 1, (spec.n_big, spec.t_big, 2)) * scale
         ).astype(np.float32)
    return t, t.reshape(spec.n_big, spec.t_r64, 128)


def _points(kind, n=4096, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        x = rng.random((n, 3))
    elif kind == "boundary":          # tests/test_hash_lattice.py:77
        x = np.asarray([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5],
                        [1.0, 0.0, 1.0]] * 64)
    else:                             # two z-slabs, tests/test_hash_lattice.py:60
        a = rng.random((n, 3)) * [1.0, 1.0, 0.08]
        b = rng.random((n, 3)) * [1.0, 1.0, 0.08] + [0.0, 0.0, 0.9]
        x = np.concatenate([a, b])
    return x.astype(np.float32)


def test_multipliers_match_reference_at_full_width():
    np.testing.assert_array_equal(hl._pick_multipliers(1 << 19, 14),
                                  ref_hl._pick_multipliers(1 << 19, 14))


@pytest.mark.parametrize("t,radius,n_cand", [(1 << 19, 20, 30), (1 << 16, 40, 50),
                                             (64, 20, 30), (2, 8, 12)])
def test_multipliers_match_reference(t, radius, n_cand):
    """Small balls, and tables smaller than the ball (several dz per class,
    and the (0, 0, +-t) alias); more levels than candidates, so the picks
    wrap around.  (One call each: the reference's cache holds 8 entries,
    and evicting its full-width picks would cost a recomputation.)"""
    np.testing.assert_array_equal(hl._pick_multipliers(t, n_cand + 2, radius, n_cand),
                                  ref_hl._pick_multipliers(t, n_cand + 2, radius, n_cand))


@pytest.mark.parametrize("kw", [FULL, SMALL], ids=["full", "small"])
def test_lattice_spec_matches(kw):
    spec, ref = _specs(kw)
    np.testing.assert_array_equal(spec.mult, ref.mult)
    np.testing.assert_array_equal(spec.offs, ref.offs)
    assert (spec.t_r64, spec.n_big, spec.num_levels, spec.output_dim) == (
        ref.t_r64, ref.n_big, ref.num_levels, ref.output_dim)
    a, b = spec.split, ref.split
    assert (a.n_small, a.t_cap_big, a.t_r_big, a.small.t_cap, a.small.t_r) == (
        b.n_small, b.t_cap_big, b.t_r_big, b.small.t_cap, b.small.t_r)
    for ours, theirs in ((a.base, b.base), (a.big, b.big), (a.small.base, b.small.base),
                         (hs._big_packed_spec(a).base, ref_hs._big_packed_spec(b).base)):
        for f in ours._fields:
            np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f), err_msg=f)
    if kw is SMALL:   # 1 small level, 1 dense big level, 4 hashed ones
        assert a.n_small == 1 and list(a.big.use_hash) == [False] + [True] * 4


@pytest.mark.parametrize("kind", ["uniform", "boundary", "clustered"])
def test_plain_encode_matches_xla_twin(kind):
    """The clustered points make the TPU engine drop corners outside its
    slabs; the twin, like the port, drops none."""
    spec, ref = _specs(FULL)
    t, packed = _table_big(spec)
    x = _points(kind)
    want = np.asarray(ref_hl.lattice_encode_xla(jnp.asarray(x), jnp.asarray(packed), ref))
    got = hl.lattice_encode_plain(torch.from_numpy(x), torch.from_numpy(t), spec)
    assert got.shape == (x.shape[0], 2 * spec.n_big)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_plain_gradient_matches_jax_grad():
    spec, ref = _specs(FULL)
    t, packed = _table_big(spec, seed=2)
    x = _points("uniform", seed=3)
    g = np.random.default_rng(4).standard_normal((x.shape[0], 2 * spec.n_big)).astype(np.float32)
    gw = np.asarray(jax.grad(lambda tb: jnp.sum(
        ref_hl.lattice_encode_xla(jnp.asarray(x), tb, ref) * g))(jnp.asarray(packed)))
    tt = torch.from_numpy(t).requires_grad_(True)
    (gt,) = torch.autograd.grad(hl.lattice_encode_plain(torch.from_numpy(x), tt, spec), [tt],
                                torch.from_numpy(g))
    gw = gw.reshape(gt.shape)
    scale = float(np.abs(gw).max())
    assert scale > 0
    np.testing.assert_allclose(gt.numpy(), gw, atol=1e-5 * scale)


def test_plain_encode_matches_pallas_interpret():
    spec, ref = _specs(SMALL)
    t, packed = _table_big(spec, seed=5, scale=1e-4)
    x = _points("uniform", n=2048, seed=6)
    w = np.random.default_rng(7).standard_normal((x.shape[0], 2 * spec.n_big)).astype(np.float32)
    want = np.asarray(ref_hl.lattice_encode(jnp.asarray(x), jnp.asarray(packed), ref))
    gw = np.asarray(jax.grad(lambda tb: jnp.sum(
        ref_hl.lattice_encode(jnp.asarray(x), tb, ref) * w))(jnp.asarray(packed)))
    tt = torch.from_numpy(t).requires_grad_(True)
    got = hl.lattice_encode_plain(torch.from_numpy(x), tt, spec)
    (gt,) = torch.autograd.grad(got, [tt], torch.from_numpy(w))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1.2e-5)
    np.testing.assert_allclose(gt.numpy(), gw.reshape(gt.shape), atol=3e-2)


def test_split_encode_matches_reference():
    spec, ref = _specs(FULL)
    small = spec.split.small
    rng = np.random.default_rng(8)
    ts = rng.uniform(-1, 1, (small.num_levels, small.t_cap, 2)).astype(np.float32)
    ts_packed = np.ascontiguousarray(ts.transpose(0, 2, 1)).reshape(
        small.num_levels, 2, small.t_r, 128)
    tb, tb_packed = _table_big(spec, seed=9)
    x = _points("uniform", n=2048, seed=10)
    want = np.asarray(ref_hl.lattice_encode_split(
        jnp.asarray(x), (jnp.asarray(ts_packed), jnp.asarray(tb_packed)), ref,
        use_kernels=False))
    got = hl.lattice_encode_split(torch.from_numpy(x),
                                  (torch.from_numpy(ts), torch.from_numpy(tb)), spec)
    assert got.shape == (2048, spec.output_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("kw", [FULL, SMALL], ids=["full", "small"])
def test_base_keys_and_sort_order(kw):
    """The base keys equal the reference's sort keys (:317-339); the order
    walks each level's points in ascending key order."""
    spec, ref = _specs(kw)
    x = _points("clustered", n=300, seed=11)
    want = np.asarray(ref_hl._base_keys_payloads(jnp.asarray(x)[None], ref)[0])
    keys = hl.lattice_keys(torch.from_numpy(x), spec)
    np.testing.assert_array_equal(keys.numpy(), want)
    order = hl.lattice_sort_order(torch.from_numpy(x), spec)
    n = x.shape[0]
    assert order.shape == (spec.n_big, 1024) and order.dtype == torch.int32
    for l in range(spec.n_big):
        row = order[l, :n].long()
        assert sorted(row.tolist()) == list(range(n))
        assert bool((torch.diff(keys[l][row]) >= 0).all())


def _multiset(keys, values):
    """Rows of (key, *payloads) tuples, sorted, per sort row."""
    stacked = np.stack([keys] + list(values), -1).reshape(-1, keys.shape[-1], 1 + len(values))
    return [r[np.lexsort(r.T[::-1])] for r in stacked]


@pytest.mark.parametrize("shape,n_values,variant", [((512,), 1, 2), ((512,), 3, 2),
                                                    ((3, 256), 1, 2), ((3, 256), 3, 2),
                                                    ((2, 128), 2, 1)])
def test_bitonic_sort_plain_matches_pallas(shape, n_values, variant):
    """Keys with many duplicates: equal sorted keys, and an equal multiset
    of (key, payloads) per row (the sort is not stable)."""
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 40, shape).astype(np.int32)
    keys[..., :5] = 2 ** 31 - 1
    values = [rng.integers(-2 ** 31, 2 ** 31, shape).astype(np.int32) for _ in range(n_values)]
    want = [np.asarray(a) for a in ref_sort.bitonic_sort(
        jnp.asarray(keys), *map(jnp.asarray, values), variant=variant)]
    got = [a.numpy() for a in sk.bitonic_sort(
        torch.from_numpy(keys), *map(torch.from_numpy, values), variant=variant)]
    assert [a.shape for a in got] == [a.shape for a in want]
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(_multiset(got[0], got[1:]), _multiset(want[0], want[1:])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_multiset(got[0], got[1:]), _multiset(keys, values)):
        np.testing.assert_array_equal(a, b)


def test_bitonic_sort_checks_its_contract():
    k = torch.zeros(96, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        sk.bitonic_sort(k)
    with pytest.raises(ValueError, match="int32"):
        sk.bitonic_sort(torch.zeros(128))
    with pytest.raises(ValueError, match="payloads"):
        sk.bitonic_sort(torch.zeros(128, dtype=torch.int32), torch.zeros(128))
    with pytest.raises(ValueError, match="variant"):
        sk.bitonic_sort(torch.zeros(128, dtype=torch.int32), variant=3)


def test_pack_converters_match():
    spec, ref = _specs(SMALL)
    rng = np.random.default_rng(13)
    levels = [rng.normal(size=(int(s), 2)).astype(np.float32) for s in spec.split.big.sizes]
    want = np.asarray(ref_hl.pack64_from_levels([jnp.asarray(a) for a in levels], ref))
    got = hl.pack64_from_levels(levels, spec)
    np.testing.assert_array_equal(got.numpy(), want.reshape(got.shape))
    for a, b, c in zip(hl.levels_from_pack64(got, spec),
                       ref_hl.levels_from_pack64(jnp.asarray(want), ref), levels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), c)


def test_init_tables_shapes():
    spec = hl.make_lattice_spec(**SMALL)
    ts, tb = hl.init_lattice_tables(spec, torch.Generator().manual_seed(0))
    assert ts.shape == (1, spec.split.small.t_cap, 2)
    assert tb.shape == (spec.n_big, spec.t_r64 * 64, 2)
    assert float(tb.abs().max()) <= 1e-4 and float(tb.abs().min()) > 0


def test_dense_levels_match_the_packed_plain_version():
    """Dense big levels keep the reference index: the same per-level tables
    through the packed engine's plain version give the same columns."""
    spec = hl.make_lattice_spec(**FULL)
    big = spec.split.big
    n_dense = int(np.sum(~big.use_hash))
    t, _ = _table_big(spec, seed=14)
    pspec = hk.PackedHashSpec(base=big, t_cap=spec.t_big, t_r=spec.t_big // 128)
    x = torch.from_numpy(_points("uniform", n=1000, seed=15))
    want = hk.hash_encode_plain(x, torch.from_numpy(t), pspec)[:, :2 * n_dense]
    got = hl.lattice_encode_plain(x, torch.from_numpy(t), spec)[:, :2 * n_dense]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_cpu_dispatch_runs_the_plain_version_without_launching():
    spec = hl.make_lattice_spec(**SMALL)
    ts, tb = hl.init_lattice_tables(spec, torch.Generator().manual_seed(1))
    ts, tb = ts.requires_grad_(True), tb.requires_grad_(True)
    x = torch.from_numpy(_points("uniform", n=200, seed=16))
    before = (hl.LATTICE_FWD_LAUNCHES, hl.LATTICE_BWD_LAUNCHES, sk.SORT_LAUNCHES,
              hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES)
    out = hl.lattice_encode_split(x, (ts, tb), spec)
    out.sum().backward()
    hl.lattice_sort_order(x, spec)
    torch.testing.assert_close(out[:, 2:], hl.lattice_encode_plain(x, tb.detach(), spec))
    assert (hl.LATTICE_FWD_LAUNCHES, hl.LATTICE_BWD_LAUNCHES, sk.SORT_LAUNCHES,
            hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES) == before
    assert float(tb.grad.abs().sum()) > 0 and float(ts.grad.abs().sum()) > 0

"""Port parity: the sorted hash engine of flnerf_tpu_torch
(ops/hash_sorted.py) against the reference (flnerf_tpu/ops/hash_sorted.py),
at the reference test's sizes (tests/test_hash_sorted.py:24: 6 levels, 2^12
tables, split at 2^10) and at full width, on inputs drawn with numpy from a
seed.  Tolerances:
  * specs, corner keys, sorted keys and payloads, converters: equal;
  * the split encode against the reference's exact paths (the flat oracle
    hash_encode, and hash_encode_split with use_kernels=False) on N(0, 1)
    tables: atol 1e-6 (the same f32 products, summed in another order);
    table gradients within 1e-5 of the largest entry;
  * against the reference's engine in interpret mode, which fetches bf16
    slabs, scatters bf16 w*g and carries 15-bit weights: the reference's own
    atol 3e-2 / rtol 2e-2 (tests/test_hash_sorted.py:58).
Documented difference, not a fault: where a sorted block holds three
clusters of keys on a dense level, the TPU engine gives zeros for the middle
cluster's corners that fall outside its head and tail slabs; the port,
which gathers directly, gives the oracle's values
(test_three_cluster_input_is_exact_where_the_engine_spills).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flnerf_tpu.ops import hash_encoding as ref_he
from flnerf_tpu.ops import hash_pallas as ref_hp
from flnerf_tpu.ops import hash_sorted as ref_hs
from flnerf_tpu_torch.ops import hash_kernel as hk
from flnerf_tpu_torch.ops import hash_sorted as hs
from flnerf_tpu_torch.ops import sort_kernel as sk

torch.set_num_threads(1)

SMALL = dict(num_levels=6, level_dim=2, base_resolution=4, log2_hashmap_size=12,
             desired_resolution=64, split_min_size=1 << 10)   # tests/test_hash_sorted.py:24
SORTED_ONLY = dict(SMALL, split_min_size=1)
FULL = dict(log2_hashmap_size=19, desired_resolution=4096)    # main_nerf -O at 2^19
GAP = dict(num_levels=2, level_dim=2, base_resolution=8, log2_hashmap_size=17,
           desired_resolution=33, split_min_size=1 << 10)     # tests/test_hash_sorted.py:159


def _specs(kw):
    return hs.make_split_spec(**kw), ref_hs.make_split_spec(**kw)


def _flat(spec, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((int(spec.base.offsets[-1]), spec.level_dim)).astype(np.float32)


def _packed(t):
    """Port [L, T, C] -> the reference's [L, C, T/128, 128]."""
    L, T, C = t.shape
    return np.ascontiguousarray(np.asarray(t).transpose(0, 2, 1).reshape(L, C, T // 128, 128))


def _oracle(x, flat, spec):
    return np.asarray(ref_he.hash_encode(jnp.asarray(x), jnp.asarray(flat), spec.base))


def _two_slabs(rng, n=512):
    """tests/test_hash_sorted.py:168: two separated z-slabs."""
    x = rng.random((n, 3)).astype(np.float32)
    x[: n // 2, 2] = 0.05 + 0.02 * x[: n // 2, 2]
    x[n // 2:, 2] = 0.90 + 0.02 * x[n // 2:, 2]
    return x


def _three_clusters(rng):
    """tests/test_hash_sorted.py:193: three tiny z-clusters in one block."""
    nf, nt = 1794, 10
    x = rng.random((nf + 3 * nt, 3)).astype(np.float32)
    x[:nf, 2] = 0.15 * x[:nf, 2]
    x[nf:nf + nt, 2] = 0.40 + 0.001 * x[nf:nf + nt, 2]
    x[nf + nt:nf + 2 * nt, 2] = 0.82 + 0.001 * x[nf + nt:nf + 2 * nt, 2]
    x[nf + 2 * nt:, 2] = 0.95 + 0.001 * x[nf + 2 * nt:, 2]
    return x, slice(nf + nt, nf + 2 * nt)


def _walk(x01, table_big, spec, pairs, grad_out=None):
    """What K8 (or, with grad_out, K9) computes from the pairs, in torch:
    decode each pair, recompute its weight, gather (scatter) its entry."""
    lb = spec.n_big
    n = x01.shape[0]
    rows, m, _ = pairs.shape
    per = -(-n // (rows // lb))
    key, pay = pairs[..., 0].long(), pairs[..., 1].long()
    row = torch.arange(rows)[:, None].expand(rows, m)
    lvl, p, c = row % lb, (row // lb) * per + (pay >> 3), pay & 7
    real = (key >= 0) & (key < spec.t_cap_big) & (pay >= 0) & ((pay >> 3) < per) & (p < n)
    key, lvl, p, c = key[real], lvl[real], p[real], c[real]
    scale = torch.as_tensor(spec.big.scales)[lvl]
    pos = x01[p] * scale[:, None] + 0.5
    frac = pos - torch.floor(pos)
    bits = torch.stack([(c >> d) & 1 for d in range(3)], -1) == 1
    w = torch.prod(torch.where(bits, frac, 1.0 - frac), -1)
    if grad_out is None:
        out = torch.zeros((n * lb, 2))
        out.index_add_(0, p * lb + lvl, w[:, None] * table_big[lvl, key])
        return out.reshape(n, 2 * lb)
    g = grad_out.reshape(n * lb, 2)[p * lb + lvl]
    grad = torch.zeros((lb * spec.t_cap_big, 2))
    grad.index_add_(0, lvl * spec.t_cap_big + key, w[:, None] * g)
    return grad.reshape(lb, spec.t_cap_big, 2)


@pytest.mark.parametrize("kw", [SMALL, SORTED_ONLY, FULL, GAP],
                         ids=["small", "sorted_only", "full", "gap"])
def test_split_spec_matches(kw):
    spec, ref = _specs(kw)
    assert (spec.n_small, spec.n_big, spec.t_cap_big, spec.t_r_big, spec.output_dim) == (
        ref.n_small, ref.n_big, ref.t_cap_big, ref.t_r_big, ref.output_dim)
    pairs = [(spec.base, ref.base), (hs._big_packed_spec(spec).base,
                                     ref_hs._big_packed_spec(ref).base)]
    if spec.small is not None:
        assert (spec.small.t_cap, spec.small.t_r) == (ref.small.t_cap, ref.small.t_r)
        pairs.append((spec.small.base, ref.small.base))
    for ours, theirs in pairs:
        for f in ours._fields:
            np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f), err_msg=f)
    if kw is FULL:
        assert (spec.n_small, spec.n_big, spec.t_cap_big) == (2, 14, 2 ** 19)


def test_split_from_flat_and_init_shapes():
    spec, ref = _specs(SMALL)
    flat = _flat(spec, 0)
    ts, tb = hs.split_from_flat(torch.from_numpy(flat), spec)
    rts, rtb = ref_hs.split_from_flat(jnp.asarray(flat), ref)
    assert ts.shape == (spec.n_small, spec.small.t_cap, 2)
    assert tb.shape == (spec.n_big, spec.t_cap_big, 2)
    np.testing.assert_array_equal(_packed(ts.numpy()), np.asarray(rts))
    np.testing.assert_array_equal(_packed(tb.numpy()), np.asarray(rtb))
    ts, tb = hs.init_split_table(spec, torch.Generator().manual_seed(0))
    assert ts.shape == (spec.n_small, spec.small.t_cap, 2)
    assert tb.shape == (spec.n_big, spec.t_cap_big, 2)
    assert float(tb.abs().max()) <= 1e-4 and float(tb.abs().min()) > 0
    assert hs.init_split_table(hs.make_split_spec(**SORTED_ONLY))[0] is None


@pytest.mark.parametrize("kw,kind", [(SMALL, "uniform"), (FULL, "uniform"),
                                     (FULL, "boundary"), (GAP, "slabs")])
def test_corner_keys_match_reference(kw, kind):
    """The keys the port sorts are the reference's hi * 128 + lo on the big
    packed spec, and hash_kernel's corner indices."""
    spec, ref = _specs(kw)
    rng = np.random.default_rng(1)
    if kind == "uniform":
        x = rng.random((777, 3)).astype(np.float32)
    elif kind == "boundary":
        x = np.asarray([[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]] * 16, np.float32)
    else:
        x = _two_slabs(rng)
    hi, lo, _ = ref_hp.corner_indices_weights(jnp.asarray(x), ref_hs._big_packed_spec(ref))
    want = np.asarray(hi) * 128 + np.asarray(lo)
    keys = hs.corner_keys(torch.from_numpy(x), spec)
    assert keys.dtype == torch.int32 and keys.shape == (spec.n_big, x.shape[0], 8)
    np.testing.assert_array_equal(keys.reshape(spec.n_big, -1).numpy(), want)
    idx, _ = hk.corner_indices_weights(torch.from_numpy(x), hs._big_packed_spec(spec))
    np.testing.assert_array_equal(keys.reshape(spec.n_big, -1).long().numpy(), idx.numpy())


def test_sorted_keys_and_payloads_match_reference():
    """One chunk of 1024 points (the reference pads no point there): each
    row's sorted keys equal the reference's sidx, and the (key, slot)
    multisets equal the reference's (key, payload >> 15)."""
    spec, ref = _specs(SMALL)
    x = np.random.default_rng(2).random((1024, 3)).astype(np.float32)
    _, sidx, spay, _, _ = ref_hs._sorted_prep(jnp.asarray(x), ref)
    pairs = hs.sorted_pairs(torch.from_numpy(x), spec)
    m = 1024 * 8
    assert pairs.shape == (spec.n_big, m, 2) == tuple(sidx.shape) + (2,)
    np.testing.assert_array_equal(pairs[..., 0].numpy(), np.asarray(sidx))
    slots = (np.asarray(spay).astype(np.int64) >> 15) & ((1 << 17) - 1)
    for ours, k, s in zip(pairs.numpy(), np.asarray(sidx), slots):
        assert sorted(map(tuple, ours.tolist())) == sorted(zip(k.tolist(), s.tolist()))


def test_pairs_cover_every_corner_once_beyond_one_chunk(monkeypatch):
    """700 points in chunks of at most 256 (tests/test_hash_sorted.py:149):
    3 chunks of 234 points, rows of 2048 slots; every (point, corner) of
    every level appears once with its key, the rest are pads; walking the
    sorted or the unsorted pairs gives the oracle's features and
    gradient."""
    monkeypatch.setattr(hs, "POINT_CAP", 256)
    spec, _ = _specs(SORTED_ONLY)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((700, 3)).astype(np.float32))
    pairs = hs.sort_inputs(x, spec)
    lb = spec.n_big
    assert pairs.shape == (3 * lb, 2048, 2)
    keys = hs.corner_keys(x, spec)
    for l in range(lb):
        seen = []
        for ch in range(3):
            row = pairs[ch * lb + l]
            real = row[:, 0] != hs.PAD_KEY
            p = ch * 234 + (row[real, 1] >> 3).long()
            c = (row[real, 1] & 7).long()
            np.testing.assert_array_equal(row[real, 0].numpy(), keys[l, p, c].numpy())
            seen.append(p * 8 + c)
        assert torch.equal(torch.sort(torch.cat(seen))[0], torch.arange(700 * 8))
    flat = _flat(spec, 4)
    _, tb = hs.split_from_flat(torch.from_numpy(flat), spec)
    want = _oracle(x.numpy(), flat, spec)
    g = torch.from_numpy(rng.standard_normal((700, 2 * lb)).astype(np.float32))
    tt = tb.clone().requires_grad_(True)
    (g_want,) = torch.autograd.grad(hk.hash_encode_plain(x, tt, hs._big_packed_spec(spec)),
                                    [tt], g)
    for pr in (pairs, hs.sorted_pairs(x, spec)):
        np.testing.assert_allclose(_walk(x, tb, spec, pr).numpy(), want, atol=1e-6)
        np.testing.assert_allclose(_walk(x, tb, spec, pr, g).numpy(), g_want.numpy(),
                                   atol=1e-5 * float(g_want.abs().max()))
    got = hs.hash_encode_split(x, (None, tb), spec)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("kw,n", [(SMALL, 300), (SORTED_ONLY, 193), (FULL, 2048)],
                         ids=["small", "sorted_only", "full"])
def test_split_encode_matches_exact_paths(kw, n):
    spec, ref = _specs(kw)
    rng = np.random.default_rng(5)
    flat = _flat(spec, 6)
    x = rng.random((n, 3)).astype(np.float32)
    ts, tb = hs.split_from_flat(torch.from_numpy(flat), spec)
    got = hs.hash_encode_split(torch.from_numpy(x), (ts, tb), spec)
    assert got.shape == (n, spec.output_dim)
    want = np.asarray(ref_hs.hash_encode_split(
        jnp.asarray(x), ref_hs.split_from_flat(jnp.asarray(flat), ref), ref,
        use_kernels=False))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _oracle(x, flat, spec), atol=1e-6)


@pytest.mark.parametrize("kw", [SMALL, SORTED_ONLY], ids=["small", "sorted_only"])
def test_split_gradients_match_jax_grad(kw):
    spec, ref = _specs(kw)
    rng = np.random.default_rng(7)
    flat = _flat(spec, 8)
    x = rng.random((256, 3)).astype(np.float32)
    cot = rng.standard_normal((256, spec.output_dim)).astype(np.float32)
    gflat = jax.grad(lambda f: jnp.sum(ref_he.hash_encode(jnp.asarray(x), f, ref.base) * cot))(
        jnp.asarray(flat))
    want = hs.split_from_flat(torch.from_numpy(np.array(gflat)), spec)
    tables = [None if t is None else t.requires_grad_(True)
              for t in hs.split_from_flat(torch.from_numpy(flat), spec)]
    out = hs.hash_encode_split(torch.from_numpy(x), tables, spec)
    live = [t for t in tables if t is not None]
    grads = torch.autograd.grad(out, live, torch.from_numpy(cot))
    for g, w in zip(grads, [w for w in want if w is not None]):
        scale = float(w.abs().max())
        assert scale > 0
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5 * scale)


def test_split_encode_matches_the_engine_in_interpret_mode():
    """The reference's own tolerances against its bf16 engine
    (tests/test_hash_sorted.py:58 and :81)."""
    spec, ref = _specs(SMALL)
    rng = np.random.default_rng(9)
    flat = _flat(spec, 10)
    x = rng.random((256, 3)).astype(np.float32)
    cot = rng.standard_normal((256, spec.output_dim)).astype(np.float32)
    rt = ref_hs.split_from_flat(jnp.asarray(flat), ref)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_hs.hash_encode_split(jnp.asarray(x), rt, ref))
        gs, gb = jax.grad(lambda a, b: jnp.sum(ref_hs.hash_encode_split(
            jnp.asarray(x), (a, b), ref) * cot), argnums=(0, 1))(*rt)
    ts, tb = (t.requires_grad_(True) for t in hs.split_from_flat(torch.from_numpy(flat), spec))
    got = hs.hash_encode_split(torch.from_numpy(x), (ts, tb), spec)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=3e-2, rtol=2e-2)
    g_ts, g_tb = torch.autograd.grad(got, [ts, tb], torch.from_numpy(cot))
    np.testing.assert_allclose(_packed(g_ts.numpy()), np.asarray(gs), atol=3e-2, rtol=2e-2)
    np.testing.assert_allclose(_packed(g_tb.numpy()), np.asarray(gb), atol=3e-2, rtol=2e-2)


def test_two_slab_dense_level_is_exact():
    """tests/test_hash_sorted.py:154: two z-slabs on a dense big level."""
    spec, _ = _specs(GAP)
    assert not bool(spec.big.use_hash[-1])
    rng = np.random.default_rng(7)
    flat = _flat(spec, 11)
    x = _two_slabs(rng)
    _, tb = hs.split_from_flat(torch.from_numpy(flat), spec)
    got = hs.hash_encode_sorted(torch.from_numpy(x), tb, spec)
    want = _oracle(x, flat, spec)[:, 2 * spec.n_small:]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    pairs = hs.sorted_pairs(torch.from_numpy(x), spec)
    np.testing.assert_allclose(_walk(torch.from_numpy(x), tb, spec, pairs).numpy(), want,
                               atol=1e-6)


def test_three_cluster_input_is_exact_where_the_engine_spills():
    """tests/test_hash_sorted.py:180: three clusters in one sorted block of
    a dense level.  The engine gives zeros for the middle cluster's corners
    outside its slabs, so its middle outputs miss them; the port equals the
    oracle there and everywhere (a documented difference, not a fault)."""
    spec, ref = _specs(GAP)
    rng = np.random.default_rng(7)
    x, mid = _three_clusters(rng)
    flat = _flat(spec, 12)
    _, tb = hs.split_from_flat(torch.from_numpy(flat), spec)
    lo = 2 * spec.n_small
    want = _oracle(x, flat, spec)[:, lo:]
    got = hs.hash_encode_sorted(torch.from_numpy(x), tb, spec).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        engine = np.asarray(ref_hs.hash_encode_sorted(
            jnp.asarray(x), ref_hs.split_from_flat(jnp.asarray(flat), ref)[1], ref))
    # the input exercises the difference: the engine misses whole N(0, 1)
    # corner terms at the middle cluster, far beyond its bf16 rounding
    assert float(np.abs(engine[mid] - want[mid]).max()) > 0.1
    assert float(np.abs(got[mid] - want[mid]).max()) <= 1e-6


def test_cpu_dispatch_runs_the_plain_version_without_launching():
    spec, _ = _specs(SMALL)
    ts, tb = (t.requires_grad_(True) for t in hs.init_split_table(
        spec, torch.Generator().manual_seed(1)))
    x = torch.from_numpy(np.random.default_rng(13).random((200, 3)).astype(np.float32))
    before = (hs.SORTED_FWD_LAUNCHES, hs.SORTED_BWD_LAUNCHES, sk.SORT_LAUNCHES,
              hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES)
    out = hs.hash_encode_split(x, (ts, tb), spec)
    out.sum().backward()
    hs.sorted_pairs(x, spec)
    torch.testing.assert_close(out[:, 2 * spec.n_small:], hk.hash_encode_plain(
        x, tb.detach(), hs._big_packed_spec(spec)))
    assert (hs.SORTED_FWD_LAUNCHES, hs.SORTED_BWD_LAUNCHES, sk.SORT_LAUNCHES,
            hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES) == before
    assert float(tb.grad.abs().sum()) > 0 and float(ts.grad.abs().sum()) > 0

"""The sorted-engine CUDA kernels K8 (forward, one (chunk, level) row per
thread-block cluster) and K9 (table gradient from the points, no pairs) of
flnerf_tpu_torch/ops/csrc/hash_sorted.cu, with the radix sort K5 on the
engine's own pairs, against their plain versions (ops/hash_kernel.py
hash_encode_plain on the big levels' packed spec with autograd,
ops/sort_kernel.py bitonic_sort_plain) on the card.  Skips without a CUDA
device: the kernels have no CPU mode.

Tolerances: the forward sums each point's 8 corners in corner order, where
the plain version's torch sum may take another: 1e-6 of the largest
output; atomics reorder the gradient sums: 1e-4 of the largest
entry; K5 is exact (both sorts are stable).

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sorted_cuda.py
"""

import pytest
import torch

from flnerf_tpu_torch.models.hash_ngp import NGPConfig, NGPField
from flnerf_tpu_torch.ops import hash_kernel as hk
from flnerf_tpu_torch.ops import hash_sorted as hs
from flnerf_tpu_torch.ops import sort_kernel as sk

FULL = dict(log2_hashmap_size=19, desired_resolution=4096)
SMALL = dict(num_levels=6, base_resolution=4, log2_hashmap_size=12, desired_resolution=64,
             split_min_size=1)
GAP = dict(num_levels=2, base_resolution=8, log2_hashmap_size=17, desired_resolution=33,
           split_min_size=1 << 10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sorted-engine kernels have no CPU mode")
    return torch.device("cuda")


def _points(device, kind, n, g):
    x = torch.rand((n, 3), generator=g, device=device)
    if kind == "slabs":                                  # two z-slabs
        x[:, 2] *= 0.02
        x[: n // 2, 2] += 0.05
        x[n // 2:, 2] += 0.90
    elif kind == "clusters":                             # tests/test_hash_sorted.py:193
        nf, nt = 1794, 10
        x[:nf, 2] *= 0.15
        for k, z in enumerate((0.40, 0.82, 0.95)):
            sl = slice(nf + k * nt, nf + (k + 1) * nt)
            x[sl, 2] = z + 0.001 * x[sl, 2]
    if n >= 4:
        x[:4] = torch.tensor([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0.999999]],
                             device=device)
    return x


def _inputs(device, spec, kind, n, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn((spec.n_big, spec.t_cap_big, 2), generator=g, device=device)
    x = _points(device, kind, n, g)
    grad = torch.randn((n, 2 * spec.n_big), generator=g, device=device)
    grad[::3] = 0.0       # the kernel skips points with a zero upstream gradient
    return x, table, grad


def _plain(x, table, grad, spec):
    tp = table.clone().requires_grad_(True)
    out = hk.hash_encode_plain(x, tp, hs._big_packed_spec(spec))
    (g,) = torch.autograd.grad(out, [tp], grad)
    return out.detach(), g


def _close(got, want, rel):
    scale = float(want.abs().max())
    assert scale > 0 and float((got - want).abs().max()) <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("kw,kind,n", [(FULL, "uniform", 20000), (FULL, "slabs", 8192),
                                       (FULL, "uniform", 1 << 16), (GAP, "slabs", 512),
                                       (GAP, "clusters", 1824), (SMALL, "uniform", 777)],
                         ids=["full", "full_slabs", "refresh_chunk", "two_slabs",
                              "three_clusters", "small"])
def test_kernels_match_plain_version_on_card(cuda, kw, kind, n):
    spec = hs.make_split_spec(**kw)
    x, table, grad = _inputs(cuda, spec, kind, n)
    before = hs.SORTED_FWD_LAUNCHES, hs.SORTED_BWD_LAUNCHES, sk.SORT_LAUNCHES
    t_k = table.clone().requires_grad_(True)
    out_k = hs.hash_encode_sorted(x, t_k, spec)
    # the backward keeps x01 alone: the forward's pairs are freed
    assert [tuple(t.shape) for t in out_k.grad_fn.saved_tensors] == [(n, 3)]
    (g_k,) = torch.autograd.grad(out_k, [t_k], grad)
    torch.cuda.synchronize()
    assert (hs.SORTED_FWD_LAUNCHES, hs.SORTED_BWD_LAUNCHES, sk.SORT_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    out_p, g_p = _plain(x, table, grad, spec)
    _close(out_k.detach(), out_p, 1e-6)
    _close(g_k, g_p, 1e-4)
    # any order of the pairs gives the same function; K9 gives it on either
    # grid and without the warp merge, and exactly zero on a zero gradient
    pairs = hs.sort_inputs(x, spec)
    _close(hs.sorted_encode_forward(x, table, spec, pairs), out_p, 1e-6)
    for level_major in (False, True):
        for merge in (True, False):
            _close(hs.sorted_encode_backward(x, grad, spec, level_major=level_major,
                                             merge=merge), g_p, 1e-4)
            zero = hs.sorted_encode_backward(x, torch.zeros_like(grad), spec,
                                             level_major=level_major, merge=merge)
            assert float(zero.abs().max()) == 0.0
    # the columns of a wider gradient (the split encode's), read in place
    wide = torch.zeros((n, 2 * spec.n_big + 4), device=cuda)
    wide[:, 4:] = grad
    assert hs.rows_strided(wide[:, 4:]) and not wide[:, 4:].is_contiguous()
    _close(hs.sorted_encode_backward(x, wide[:, 4:], spec), g_p, 1e-4)
    for l in range(spec.n_big):   # padding past a dense level's size receives nothing
        pad = g_k[l, int(spec.big.sizes[l]):]
        assert pad.numel() == 0 or float(pad.abs().max()) == 0.0


@pytest.mark.cuda
def test_sort_on_the_engine_pairs_matches_plain_version(cuda):
    spec = hs.make_split_spec(**FULL)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand((40000, 3), generator=g, device=cuda)
    pairs = hs.sort_inputs(x, spec)
    assert pairs.shape == (3 * spec.n_big, 1 << 17, 2)
    want = sk.bitonic_sort_plain(pairs[..., 0].contiguous(), pairs[..., 1].contiguous())
    for bits in (sk.key_bits_for(spec.t_cap_big), sk.KEY_BITS):   # the engine's width, 31
        got = sk.sort_pairs_(pairs.clone(), bits)
        torch.cuda.synchronize()
        assert torch.equal(got[..., 0], want[0]) and torch.equal(got[..., 1], want[1])
    assert torch.equal(hs.sorted_pairs(x, spec), torch.stack(want, -1))


def _forward_case(cuda, case):
    """(x, table, pairs, out given or None) for a K8 case."""
    spec = hs.make_split_spec(**FULL)
    n = {"full chunk": hs.POINT_CAP, "ragged": 40000, "refresh": 1 << 16,
         "point order": 20000, "accumulate": 3000}[case]
    x, table, _ = _inputs(cuda, spec, "uniform", n, seed=5)
    pairs = hs.sort_inputs(x, spec) if case == "point order" else hs.sorted_pairs(x, spec)
    out = None
    if case == "accumulate":
        out = torch.randn((n, 2 * spec.n_big), device=cuda)
    return spec, x, table, pairs, out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full chunk", "ragged", "refresh", "point order",
                                  "accumulate"])
def test_cluster_forward_matches_plain_version(cuda, case):
    """K8 within 1e-6 of the largest plain output: one full 16,384-point
    chunk; 40,000 points in 3 chunks, the last one short; a 65,536-point
    refresh chunk (4 chunks x 14 levels = 56 rows); unsorted pairs; adding
    into a given output.  Every output is written, so the uninitialised
    buffer leaves no trace."""
    spec, x, table, pairs, out = _forward_case(cuda, case)
    if case == "refresh":
        assert pairs.shape[0] == 56
    base = None if out is None else out.clone()
    before = hs.SORTED_FWD_LAUNCHES
    got = hs.sorted_encode_forward(x, table, spec, pairs, out=out)
    torch.cuda.synchronize()
    assert hs.SORTED_FWD_LAUNCHES == before + 1
    want = hk.hash_encode_plain(x, table, hs._big_packed_spec(spec))
    if base is not None:
        assert got is out
        got = got - base
    _close(got, want, 1e-6)


@pytest.mark.cuda
def test_cluster_forward_raises_beyond_the_point_cap(cuda):
    """One row set for 20,000 points: a chunk beyond POINT_CAP, whose
    outputs would not fit the cluster's shared memory."""
    spec = hs.make_split_spec(**FULL)
    x, table, _ = _inputs(cuda, spec, "uniform", 20000)
    pairs = torch.full((spec.n_big, 1 << 18, 2), hs.PAD_KEY, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        hs.sorted_encode_forward(x, table, spec, pairs)
    assert hs.forward_active_clusters(hs.POINT_CAP) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1])
def test_empty_and_single_point(cuda, n):
    spec = hs.make_split_spec(**FULL)
    x, table, grad = _inputs(cuda, spec, "uniform", n)
    t_k = table.clone().requires_grad_(True)
    out_k = hs.hash_encode_sorted(x, t_k, spec)
    assert out_k.shape == (n, 2 * spec.n_big)
    (g_k,) = torch.autograd.grad(out_k, [t_k], torch.ones_like(out_k))
    out_p, g_p = _plain(x, table, torch.ones_like(out_k), spec)
    torch.cuda.synchronize()
    if n == 0:
        assert float(g_k.abs().max()) == 0.0
    else:
        _close(out_k.detach(), out_p, 1e-6)
        _close(g_k, g_p, 1e-4)


@pytest.mark.cuda
def test_backward_accumulates_into_a_given_gradient(cuda):
    spec = hs.make_split_spec(**SMALL)
    x, table, grad = _inputs(cuda, spec, "uniform", 3000, seed=2)
    pairs = hs.sorted_pairs(x, spec)
    base = torch.randn((spec.n_big, spec.t_cap_big, 2), device=cuda)
    acc = hs.sorted_encode_backward(x, grad, spec, grad_table=base.clone())
    _, g_p = _plain(x, table, grad, spec)
    _close(acc - base, g_p, 1e-4)
    out = hs.sorted_encode_forward(x, table, spec, pairs, out=torch.ones((3000, 2 * spec.n_big),
                                                                         device=cuda))
    out_p, _ = _plain(x, table, grad, spec)
    _close(out - 1.0, out_p, 1e-5)


@pytest.mark.cuda
def test_kernel_wrappers_check_their_inputs(cuda):
    spec = hs.make_split_spec(**SMALL)
    x, table, grad = _inputs(cuda, spec, "uniform", 64)
    pairs = hs.sorted_pairs(x, spec)
    with pytest.raises(ValueError, match="dtype"):
        hs.sorted_encode_forward(x, table.double(), spec, pairs)
    with pytest.raises(ValueError, match="shape"):
        hs.sorted_encode_forward(x, table[:2].contiguous(), spec, pairs)
    with pytest.raises(ValueError, match="pairs"):
        hs.sorted_encode_forward(x, table, spec, pairs[:, :16].contiguous())
    with pytest.raises(ValueError, match="float32"):
        hs.sorted_encode_backward(x, grad.double(), spec)
    with pytest.raises(ValueError, match="rows"):         # rows not contiguous
        hs.sorted_encode_backward(x, grad.t().contiguous().t(), spec)
    with pytest.raises(ValueError, match="shape"):
        hs.sorted_encode_backward(x, grad[:, :4].contiguous(), spec)
    with pytest.raises(ValueError, match="contiguous"):
        sk.sort_pairs_(pairs.transpose(0, 1))


@pytest.mark.cuda
def test_sorted_field_on_card_matches_its_plain_twin(cuda):
    """The full-width 2^19 field on the sorted engine (bf16 MLPs) on the
    card through K3/K4 and K5/K8 against the same weights on the CPU
    through the plain versions."""
    cfg = NGPConfig(bound=2.0, log2_hashmap_size=19, hash_engine="sorted")
    field = NGPField(cfg, torch.bfloat16, torch.Generator(device=cuda).manual_seed(0), cuda)
    with torch.no_grad():
        field.table_small.mul_(1e4)
        field.table_big.mul_(1e4)
    cpu = NGPField(cfg, torch.bfloat16)
    cpu.load_state_dict({k: v.cpu() for k, v in field.state_dict().items()})
    x = (torch.rand((4096, 3), device=cuda) * 4 - 2)
    before = hk.HASH_FWD_LAUNCHES, sk.SORT_LAUNCHES, hs.SORTED_FWD_LAUNCHES
    s_k, geo_k = field.density(x)
    assert (hk.HASH_FWD_LAUNCHES, sk.SORT_LAUNCHES, hs.SORTED_FWD_LAUNCHES) == tuple(
        b + 1 for b in before)
    s_p, geo_p = cpu.density(x.cpu())
    # bf16 hidden activations: a one-ulp flip moves an output by ~2^-8
    torch.testing.assert_close(geo_k.cpu(), geo_p, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(s_k.cpu(), s_p, rtol=2e-2, atol=2e-2)

"""The lattice-engine CUDA kernels K6 (forward) and K7 (table gradient) of
flnerf_tpu_torch/ops/csrc/hash_lattice.cu, and the radix sort K5 of
flnerf_tpu_torch/ops/csrc/radix_sort.cu on the reference's base keys and
beyond the grid's 65,535 rows, against their plain versions
(ops/hash_lattice.py lattice_encode_plain_levels with autograd;
ops/sort_kernel.py bitonic_sort_plain, a stable torch.sort and a gather,
which K5 equals exactly) on the card.  Skips without a CUDA device: the
kernels have no CPU mode.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_lattice_cuda.py
"""

import pytest
import torch

from flnerf_tpu_torch.models.hash_ngp import NGPConfig, NGPField
from flnerf_tpu_torch.ops import hash_kernel as hk
from flnerf_tpu_torch.ops import hash_lattice as hl
from flnerf_tpu_torch.ops import sort_kernel as sk

FULL = dict(log2_hashmap_size=19, desired_resolution=4096)
SMALL = dict(num_levels=6, log2_hashmap_size=16, desired_resolution=512)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lattice kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_values,variant", [((128,), 1, 2), ((4096,), 0, 2),
                                                    ((3, 8192), 3, 1), ((14, 1 << 19), 1, 2),
                                                    ((2, 1 << 15), 2, 2)])
def test_sort_matches_plain_version_on_card(cuda, shape, n_values, variant):
    g = torch.Generator(device=cuda).manual_seed(0)
    keys = torch.randint(0, 1 << 19, shape, generator=g, device=cuda, dtype=torch.int32)
    keys[..., ::7] = 5                                   # duplicates
    keys[..., -3:] = 2 ** 31 - 1                         # pad keys
    values = [torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g, device=cuda,
                            dtype=torch.int32) for _ in range(n_values)]
    before = sk.SORT_LAUNCHES
    got = sk.bitonic_sort(keys, *values, variant=variant)
    torch.cuda.synchronize()
    assert sk.SORT_LAUNCHES == before + 1
    want = sk.bitonic_sort_plain(keys, *values)
    # both sorts are stable: equal keys and payloads, position by position
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1 << 16, 2 * 65535 + 3])
def test_sort_beyond_the_grid_rows_equals_the_stable_sort(cuda, rows):
    """K5 on [rows, 128] keys with payloads, more rows than the grid's y
    axis holds: launched in blocks of 65,535 rows, equal to the stable sort."""
    g = torch.Generator(device=cuda).manual_seed(3)
    keys = torch.randint(0, 1 << 12, (rows, 128), generator=g, device=cuda, dtype=torch.int32)
    keys[-1] = 7                                          # a row of equal keys, in the last block
    pay = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, 128), generator=g, device=cuda,
                        dtype=torch.int32)
    before = sk.SORT_LAUNCHES
    got = sk.bitonic_sort(keys, pay)
    torch.cuda.synchronize()
    assert sk.SORT_LAUNCHES == before + 1
    want_k, order = torch.sort(keys, dim=-1, stable=True)
    assert torch.equal(got[0], want_k)
    assert torch.equal(got[1], torch.gather(pay, -1, order))


def _radix_keys(kind, shape, g, cuda):
    """(keys, key_bits) for a card test of K5."""
    if kind == "random31":
        return torch.randint(0, 2 ** 31 - 1, shape, generator=g, device=cuda,
                             dtype=torch.int32), sk.KEY_BITS
    n = shape[-1]
    if kind == "pads20":
        keys = torch.randint(0, 1 << 19, shape, generator=g, device=cuda, dtype=torch.int32)
        keys[..., ::5] = 3
        keys[torch.rand(shape, generator=g, device=cuda) < 0.2] = 2 ** 31 - 1
    elif kind == "equal":
        keys = torch.full(shape, 777, dtype=torch.int32, device=cuda)
    elif kind == "sorted":
        keys = (torch.arange(n, device=cuda, dtype=torch.int32) // 3).expand(shape)
    else:                                                # reversed
        keys = ((n - torch.arange(n, device=cuda, dtype=torch.int32)) // 3).expand(shape)
    return keys.contiguous(), sk.key_bits_for(1 << 19)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [
    ("random31", (1, 128)), ("random31", (7, 1 << 12)), ("random31", (336, 1 << 17)),
    ("pads20", (14, 1 << 19)), ("pads20", (3, 8192)), ("pads20", (336, 128)),
    ("equal", (2, 1 << 15)), ("equal", (1, 1 << 19)), ("sorted", (1, 1 << 19)),
    ("sorted", (5, 256)), ("reversed", (5, 4096)), ("reversed", (2, 1 << 18))])
def test_radix_sort_equals_the_stable_sort_on_card(cuda, kind, shape):
    """K5 on (key, position) pairs equals torch.sort(stable=True) and a
    gather exactly: random 31-bit keys on the default width, 20-bit keys
    with pads on the engines' width, all-equal, sorted and reversed rows,
    rows of 128 to 2^19 in 1 to 336 rows."""
    g = torch.Generator(device=cuda).manual_seed(1)
    keys, bits = _radix_keys(kind, shape, g, cuda)
    pay = torch.arange(keys.numel(), dtype=torch.int32, device=cuda).reshape(shape)
    pairs = torch.stack([keys, pay], -1).contiguous()
    before = sk.SORT_LAUNCHES
    sk.sort_pairs_(pairs, bits)
    torch.cuda.synchronize()
    assert sk.SORT_LAUNCHES == before + 1
    want_k, order = torch.sort(keys, dim=-1, stable=True)
    assert torch.equal(pairs[..., 0], want_k)
    assert torch.equal(pairs[..., 1], torch.gather(pay, -1, order))


def _inputs(device, spec, n, seed=0, clustered=False):
    g = torch.Generator(device=device).manual_seed(seed)
    table = torch.rand((spec.n_big, spec.t_big, 2), generator=g, device=device) * 2 - 1
    x = torch.rand((n, 3), generator=g, device=device)
    if clustered:                                        # two z-slabs
        x[:, 2] *= 0.08
        x[n // 2:, 2] += 0.9
    x[:4] = torch.tensor([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0.999999]],
                         device=device)
    grad = torch.randn((n, 2 * spec.n_big), generator=g, device=device)
    grad[::3] = 0.0       # the kernel skips points with a zero upstream gradient
    return x, table, grad


@pytest.mark.cuda
@pytest.mark.parametrize("kw,n,clustered", [(FULL, 20000, False), (FULL, 8192, True),
                                            (FULL, 1 << 16, False), (SMALL, 777, False)],
                         ids=["ragged", "two_slabs", "refresh_chunk", "small"])
def test_kernels_match_plain_version_on_card(cuda, kw, n, clustered):
    """K6 within 1e-6 of the largest plain output and K7 within 1e-4 of the
    largest plain gradient entry, through the autograd Function (no sort:
    K5 is not launched) and through the kernels' own wrappers."""
    spec = hl.make_lattice_spec(**kw)
    x, table, grad = _inputs(cuda, spec, n, clustered=clustered)
    before = hl.LATTICE_FWD_LAUNCHES, hl.LATTICE_BWD_LAUNCHES, sk.SORT_LAUNCHES
    t_k = table.clone().requires_grad_(True)
    out_k = hl.lattice_encode(x, t_k, spec)
    (g_k,) = torch.autograd.grad(out_k, [t_k], grad)
    torch.cuda.synchronize()
    assert (hl.LATTICE_FWD_LAUNCHES, hl.LATTICE_BWD_LAUNCHES, sk.SORT_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2])
    t_p = table.clone().requires_grad_(True)
    out_p = hl.lattice_encode_plain(x, t_p, spec)
    (g_p,) = torch.autograd.grad(out_p, [t_p], grad)
    # f32 on both sides, the same products in the same corner order: 1e-6 of
    # the largest output; atomics reorder the gradient sums: 1e-4 of the largest
    out_k, out_p = out_k.detach(), out_p.detach()
    assert float((out_k - out_p).abs().max()) <= 1e-6 * float(out_p.abs().max())
    assert float((g_k - g_p).abs().max()) <= 1e-4 * float(g_p.abs().max())
    # the wrappers' own layout: level-major output, level-major gradient
    levels = hl.lattice_encode_forward(x, table, spec)
    assert levels.shape == (spec.n_big, n, 2)
    torch.testing.assert_close(hl.point_major(levels), out_k, rtol=0, atol=0)
    view = grad.view(n, spec.n_big, 2).transpose(0, 1)     # autograd's layout
    for g_up in (view, view.contiguous()):                  # read in place, or level-major
        g_l = hl.lattice_encode_backward(x, g_up, spec)
        assert float((g_l - g_p).abs().max()) <= 1e-4 * float(g_p.abs().max())
    for l in range(spec.n_big):   # padding past a dense level's size receives nothing
        pad = g_k[l, int(spec.split.big.sizes[l]):]
        assert pad.numel() == 0 or float(pad.abs().max()) == 0.0
    # a zero upstream gradient adds exactly nothing
    zero = hl.lattice_encode_backward(x, torch.zeros((spec.n_big, n, 2), device=cuda), spec)
    assert float(zero.abs().max()) == 0.0


@pytest.mark.cuda
def test_split_encode_on_card_matches_the_plain_assembly(cuda):
    """The [N, L*2] split encode on the card (K3 for the small levels, K6
    for the big ones, joined in one copy; K4 and K7 in the backward, no K5)
    against the same tables on the CPU."""
    spec = hl.make_lattice_spec(**FULL)
    ts, tb = hl.init_lattice_tables(spec, torch.Generator(device=cuda).manual_seed(4), cuda)
    ts, tb = (t.mul(1e4).requires_grad_(True) for t in (ts, tb))
    x = torch.rand((5000, 3), device=cuda)
    grad = torch.randn((5000, spec.output_dim), device=cuda)
    before = (hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES, hl.LATTICE_FWD_LAUNCHES,
              hl.LATTICE_BWD_LAUNCHES, sk.SORT_LAUNCHES)
    out = hl.lattice_encode_split(x, (ts, tb), spec)
    g_s, g_b = torch.autograd.grad(out, [ts, tb], grad)
    torch.cuda.synchronize()
    assert (hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES, hl.LATTICE_FWD_LAUNCHES,
            hl.LATTICE_BWD_LAUNCHES, sk.SORT_LAUNCHES) == tuple(
                b + d for b, d in zip(before, (1, 1, 1, 1, 0)))
    c_s, c_b = (t.detach().cpu().requires_grad_(True) for t in (ts, tb))
    want = hl.lattice_encode_split(x.cpu(), (c_s, c_b), spec)
    w_s, w_b = torch.autograd.grad(want, [c_s, c_b], grad.cpu())
    assert out.shape == want.shape == (5000, spec.output_dim)
    assert float((out.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    for got, exp in ((g_s, w_s), (g_b, w_b)):
        assert float((got.cpu() - exp).abs().max()) <= 1e-4 * float(exp.abs().max())


@pytest.mark.cuda
def test_sort_order_walks_keys_in_order(cuda):
    spec = hl.make_lattice_spec(**FULL)
    x, _, _ = _inputs(cuda, spec, 5000, seed=2)
    order = hl.lattice_sort_order(x, spec)
    keys = hl.lattice_keys(x, spec)
    assert order.shape == (spec.n_big, 8192)
    row = order[:, :5000].long()
    assert torch.equal(torch.sort(row, -1)[0],
                       torch.arange(5000, device=cuda).expand(spec.n_big, 5000))
    assert bool((torch.diff(torch.gather(keys, 1, row), dim=-1) >= 0).all())


@pytest.mark.cuda
def test_kernel_wrappers_check_their_inputs(cuda):
    spec = hl.make_lattice_spec(**SMALL)
    x, table, grad = _inputs(cuda, spec, 64)
    with pytest.raises(ValueError, match="dtype"):
        hl.lattice_encode_forward(x, table.double(), spec)
    with pytest.raises(ValueError, match="shape"):
        hl.lattice_encode_forward(x, table[:2].contiguous(), spec)
    with pytest.raises(ValueError, match="shape"):        # [N, Lb*2] is not K7's layout
        hl.lattice_encode_backward(x, grad, spec)
    with pytest.raises(ValueError, match="float32"):
        hl.lattice_encode_backward(x, grad.view(64, -1, 2).transpose(0, 1).double(), spec)
    split = grad.view(64, -1, 2).permute(2, 1, 0).contiguous().permute(1, 2, 0)
    with pytest.raises(ValueError, match="pairs"):       # each pair's two values apart
        hl.lattice_encode_backward(x, split, spec)
    assert not hl.pairs_strided(split) and hl.pairs_strided(grad.view(64, -1, 2).transpose(0, 1))
    assert hl.lattice_encode_forward(x[:0], table, spec).shape == (spec.n_big, 0, 2)
    with pytest.raises(ValueError, match="power of two"):
        sk.bitonic_sort(torch.zeros(100, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
def test_lattice_field_on_card_matches_its_plain_twin(cuda):
    """The full-width 2^19 field (bf16 MLPs) on the card through K3, K4, K6
    and K7 (no sort) against the same weights on the CPU through the plain
    versions."""
    cfg = NGPConfig(bound=2.0, log2_hashmap_size=19)
    field = NGPField(cfg, torch.bfloat16, torch.Generator(device=cuda).manual_seed(0), cuda)
    with torch.no_grad():
        field.table_small.mul_(1e4)
        field.table_big.mul_(1e4)
    cpu = NGPField(cfg, torch.bfloat16)
    cpu.load_state_dict({k: v.cpu() for k, v in field.state_dict().items()})
    x = (torch.rand((4096, 3), device=cuda) * 4 - 2)
    before = hk.HASH_FWD_LAUNCHES, sk.SORT_LAUNCHES, hl.LATTICE_FWD_LAUNCHES
    s_k, geo_k = field.density(x)
    assert (hk.HASH_FWD_LAUNCHES, sk.SORT_LAUNCHES, hl.LATTICE_FWD_LAUNCHES) == (
        before[0] + 1, before[1], before[2] + 1)
    s_p, geo_p = cpu.density(x.cpu())
    # bf16 hidden activations: a one-ulp flip moves an output by ~2^-8
    torch.testing.assert_close(geo_k.cpu(), geo_p, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(s_k.cpu(), s_p, rtol=2e-2, atol=2e-2)


def _train_like(n, spec, g, device, clustered=False):
    """Points and a train-like upstream gradient: groups of 96 samples (a
    ray) live at about one group in nine, handed to K7 as autograd's view,
    the big levels' columns of a [N, L_all*2] gradient."""
    x = torch.rand((n, 3), generator=g, device=device)
    if clustered:                                    # 4 cells of the coarsest level
        base = torch.randint(0, 16, (4, 3), generator=g, device=device).float()
        pick = torch.randint(0, 4, (n,), generator=g, device=device)
        x = ((base[pick] + x) / 16.0).clamp(0.0, 1.0)
    wide = torch.randn((n, spec.num_levels, 2), generator=g, device=device)
    live = (torch.arange(n, device=device) // 96) % 9 == 0
    wide = wide * live[:, None, None]
    return x.contiguous(), wide[:, spec.split.n_small:].transpose(0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,clustered", [(393216, False), (8192, True), (1000, False),
                                         (1, False), (0, False)],
                         ids=["train_batch", "clustered_8192", "p1000", "p1", "p0"])
def test_tile_k7_matches_plain_version_on_card(cuda, n, clustered):
    """K7 (the tile, the warp merge) within 1e-4 of the plain gradient's
    largest entry on a train-like gradient read in place, on a dense one
    (also level-major), and exactly zero on a zero gradient."""
    spec = hl.make_lattice_spec(**FULL)
    g = torch.Generator(device=cuda).manual_seed(7)
    x, g_train = _train_like(n, spec, g, cuda, clustered)
    if n == 1:
        g_train = torch.randn_like(g_train)            # one live point
    g_dense = torch.randn((spec.n_big, n, 2), generator=g, device=cuda)
    for g_up in (g_train, g_dense, g_dense.transpose(0, 1).contiguous().transpose(0, 1)):
        before = hl.LATTICE_BWD_LAUNCHES
        got = hl.lattice_encode_backward(x, g_up, spec)
        assert hl.LATTICE_BWD_LAUNCHES == before + (1 if n else 0)
        t_p = torch.zeros((spec.n_big, spec.t_big, 2), device=cuda, requires_grad=True)
        if n:
            (want,) = torch.autograd.grad(hl.lattice_encode_plain_levels(x, t_p, spec), [t_p],
                                          g_up)
        else:
            want = torch.zeros_like(t_p)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale
        assert (scale > 0) == (n > 0)
    zero = hl.lattice_encode_backward(x, torch.zeros_like(g_dense), spec)
    assert not bool(zero.any())


@pytest.mark.cuda
def test_tile_k7_is_exactly_zero_on_dead_tiles(cuda):
    """Tiles whose gradient is +-0 everywhere add nothing and read no x01
    (NaN points there would poison any corner they reached); a live tile
    beside them adds only its own points."""
    spec = hl.make_lattice_spec(**FULL)
    g = torch.Generator(device=cuda).manual_seed(8)
    n = 128 * 6
    x = torch.rand((n, 3), generator=g, device=cuda)
    x[: 128 * 5] = float("nan")                      # the dead tiles' points
    grad = torch.zeros((spec.n_big, n, 2), device=cuda)
    grad[:, : 128 * 5:2] = -0.0
    got = hl.lattice_encode_backward(x, grad, spec)
    assert not bool(got.any()) and bool(torch.isfinite(got).all())
    grad[:, 128 * 5:] = torch.randn((spec.n_big, 128, 2), generator=g, device=cuda)
    got = hl.lattice_encode_backward(x, grad, spec)
    t_p = torch.zeros((spec.n_big, spec.t_big, 2), device=cuda, requires_grad=True)
    (want,) = torch.autograd.grad(hl.lattice_encode_plain_levels(x[128 * 5:], t_p, spec), [t_p],
                                  grad[:, 128 * 5:])
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())

"""The lattice-engine CUDA kernels K5 (sort), K6 (forward) and K7 (table
gradient) of flnerf_tpu_torch/ops/csrc/hash_lattice.cu against their plain
versions (ops/sort_kernel.py bitonic_sort_plain, ops/hash_lattice.py
lattice_encode_plain with autograd) on the card.  Skips without a CUDA
device: the kernels have no CPU mode.

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


def _sorted_rows(keys, values):
    """Per row, the (key, *payloads) tuples in lexicographic order."""
    cols = torch.stack([keys] + list(values), -1).reshape(-1, keys.shape[-1], 1 + len(values))
    out = []
    for r in cols.cpu():
        order = torch.arange(r.shape[0])
        for c in reversed(range(r.shape[1])):
            order = order[torch.sort(r[order, c], stable=True)[1]]
        out.append(r[order])
    return torch.stack(out)


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
    assert torch.equal(got[0], want[0])
    if n_values:
        assert torch.equal(_sorted_rows(got[0], got[1:]), _sorted_rows(want[0], want[1:]))


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
                                            (SMALL, 777, False)])
def test_kernels_match_plain_version_on_card(cuda, kw, n, clustered):
    spec = hl.make_lattice_spec(**kw)
    x, table, grad = _inputs(cuda, spec, n, clustered=clustered)
    before = hl.LATTICE_FWD_LAUNCHES, hl.LATTICE_BWD_LAUNCHES, sk.SORT_LAUNCHES
    t_k = table.clone().requires_grad_(True)
    out_k = hl.lattice_encode(x, t_k, spec)
    (g_k,) = torch.autograd.grad(out_k, [t_k], grad)
    torch.cuda.synchronize()
    assert (hl.LATTICE_FWD_LAUNCHES, hl.LATTICE_BWD_LAUNCHES, sk.SORT_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    t_p = table.clone().requires_grad_(True)
    out_p = hl.lattice_encode_plain(x, t_p, spec)
    (g_p,) = torch.autograd.grad(out_p, [t_p], grad)
    # f32 on both sides, the same products in the same corner order: 1e-6 of
    # the largest output; atomics reorder the gradient sums: 1e-4 of the largest
    out_k, out_p = out_k.detach(), out_p.detach()
    assert float((out_k - out_p).abs().max()) <= 1e-6 * float(out_p.abs().max())
    assert float((g_k - g_p).abs().max()) <= 1e-4 * float(g_p.abs().max())
    # the result does not depend on the walk's order
    ident = torch.arange(n, dtype=torch.int32, device=cuda).expand(spec.n_big, n).contiguous()
    torch.testing.assert_close(hl.lattice_encode_forward(x, table, spec, ident), out_k,
                               rtol=0, atol=0)
    g_i = hl.lattice_encode_backward(x, grad, spec, ident)
    assert float((g_i - g_p).abs().max()) <= 1e-4 * float(g_p.abs().max())
    for l in range(spec.n_big):   # padding past a dense level's size receives nothing
        pad = g_k[l, int(spec.split.big.sizes[l]):]
        assert pad.numel() == 0 or float(pad.abs().max()) == 0.0


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
    order = hl.lattice_sort_order(x, spec)
    with pytest.raises(ValueError, match="dtype"):
        hl.lattice_encode_forward(x, table.double(), spec, order)
    with pytest.raises(ValueError, match="shape"):
        hl.lattice_encode_forward(x, table[:2].contiguous(), spec, order)
    with pytest.raises(ValueError, match="order"):
        hl.lattice_encode_forward(x, table, spec, order[:, :10])
    with pytest.raises(ValueError, match="dtype"):
        hl.lattice_encode_backward(x, grad, spec, order.long())
    assert hl.lattice_encode_forward(x[:0], table, spec, order).shape == (0, 2 * spec.n_big)
    with pytest.raises(ValueError, match="power of two"):
        sk.bitonic_sort(torch.zeros(100, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
def test_lattice_field_on_card_matches_its_plain_twin(cuda):
    """The full-width 2^19 field (bf16 MLPs) on the card through K3-K7
    against the same weights on the CPU through the plain versions."""
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
    assert (hk.HASH_FWD_LAUNCHES, sk.SORT_LAUNCHES, hl.LATTICE_FWD_LAUNCHES) == tuple(
        b + 1 for b in before)
    s_p, geo_p = cpu.density(x.cpu())
    # bf16 hidden activations: a one-ulp flip moves an output by ~2^-8
    torch.testing.assert_close(geo_k.cpu(), geo_p, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(s_k.cpu(), s_p, rtol=2e-2, atol=2e-2)

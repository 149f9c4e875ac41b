"""The hash-encoding CUDA kernels K3/K4 (flnerf_tpu_torch/ops/csrc/
hash_encode.cu) against their plain version (ops/hash_kernel.py
hash_encode_plain, with autograd for the gradient) on the card: at 2^15
(16 levels) and on the 2^19 engines' 2 small levels, on clustered points,
a strided gradient, a zero gradient and ragged point counts.  The card
tests skip without a CUDA device: the kernels have no CPU mode.  The check
of which gradients K4 reads in place is host code and is tested here on
the CPU.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_hash_cuda.py
"""

import pytest
import torch

from flnerf_tpu_torch.models.hash_ngp import NGPConfig, NGPField
from flnerf_tpu_torch.ops import hash_kernel as hk
from flnerf_tpu_torch.ops.hash_lattice import make_lattice_spec
from flnerf_tpu_torch.ops.hash_sorted import make_split_spec

# The specs the main paths give K3/K4: 2^15 (main_nerf -O: desired
# resolution 2048 x bound 2) and the small levels of the two 2^19 engines.
SPECS = {
    "2^15": lambda: hk.make_packed_spec(desired_resolution=4096),
    "lattice small": lambda: make_lattice_spec(desired_resolution=4096).split.small,
    "sorted small": lambda: make_split_spec(desired_resolution=4096).small,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hash-encoding kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, n, spec, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    table = torch.rand((spec.num_levels, spec.t_cap, 2), generator=g, device=device) * 2 - 1
    x = torch.rand((n, 3), generator=g, device=device)
    edge = torch.tensor([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0.999999]],
                        device=device)
    x[:4] = edge[:n]
    grad = torch.randn((n, spec.output_dim), generator=g, device=device)
    grad[::3] = 0.0       # the kernel skips points with a zero upstream gradient
    return x, table, grad


@pytest.mark.cuda
@pytest.mark.parametrize("kw,n", [(dict(desired_resolution=4096), 20000),
                                  (dict(num_levels=4, base_resolution=4, log2_hashmap_size=10,
                                        desired_resolution=32), 777)])
def test_kernels_match_plain_version_on_card(cuda, kw, n):
    spec = hk.make_packed_spec(**kw)
    x, table, grad = _inputs(cuda, n, spec)
    before = hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES
    t_k = table.clone().requires_grad_(True)
    out_k = hk.hash_encode(x, t_k, spec)
    (g_k,) = torch.autograd.grad(out_k, [t_k], grad)
    torch.cuda.synchronize()
    assert (hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    t_p = table.clone().requires_grad_(True)
    out_p = hk.hash_encode_plain(x, t_p, spec)
    (g_p,) = torch.autograd.grad(out_p, [t_p], grad)
    # f32 on both sides, corners summed in another order: 1e-6 of the
    # largest output; atomics reorder the gradient sums: 1e-4 of the largest
    out_k, out_p = out_k.detach(), out_p.detach()
    assert float((out_k - out_p).abs().max()) <= 1e-6 * float(out_p.abs().max())
    assert float((g_k - g_p).abs().max()) <= 1e-4 * float(g_p.abs().max())
    for l in range(spec.num_levels):   # padding rows receive nothing
        pad = g_k[l, int(spec.base.sizes[l]):]
        assert pad.numel() == 0 or float(pad.abs().max()) == 0.0


@pytest.mark.cuda
def test_backward_adds_into_a_given_gradient(cuda):
    spec = hk.make_packed_spec(desired_resolution=4096)
    x, _, grad = _inputs(cuda, 5000, spec, seed=1)
    fresh = hk.hash_encode_backward(x, grad, spec)
    given = torch.ones_like(fresh)
    added = hk.hash_encode_backward(x, grad, spec, grad_table=given)
    assert added is given
    assert float((added - (fresh + 1.0)).abs().max()) <= 1e-5 * float(fresh.abs().max() + 1)


@pytest.mark.cuda
def test_kernel_wrappers_check_their_inputs(cuda):
    spec = hk.make_packed_spec(desired_resolution=4096)
    x, table, grad = _inputs(cuda, 64, spec)
    with pytest.raises(ValueError, match="dtype"):
        hk.hash_encode_forward(x, table.double(), spec)
    with pytest.raises(ValueError, match="shape"):
        hk.hash_encode_forward(x, table[:4].contiguous(), spec)
    with pytest.raises(ValueError, match="contiguous"):
        hk.hash_encode_forward(x.t().contiguous().t(), table, spec)
    with pytest.raises(ValueError, match="level_dim 2"):
        hk.hash_encode_forward(x, table, hk.make_packed_spec(level_dim=4))
    assert hk.hash_encode_forward(x[:0], table, spec).shape == (0, spec.output_dim)


@pytest.mark.cuda
def test_field_on_card_matches_its_plain_twin(cuda):
    """The full-width field (bf16 MLPs) on the card through K3/K4 against the
    same weights on the CPU through the plain version."""
    field = NGPField(NGPConfig(bound=2.0), torch.bfloat16,
                     torch.Generator(device=cuda).manual_seed(0), cuda)
    with torch.no_grad():
        field.table.mul_(1e4)
    cpu = NGPField(NGPConfig(bound=2.0), torch.bfloat16)
    cpu.load_state_dict({k: v.cpu() for k, v in field.state_dict().items()})
    x = (torch.rand((4096, 3), device=cuda) * 4 - 2)
    s_k, geo_k = field.density(x)
    s_p, geo_p = cpu.density(x.cpu())
    # bf16 hidden activations: a one-ulp flip moves an output by ~2^-8
    torch.testing.assert_close(geo_k.cpu(), geo_p, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(s_k.cpu(), s_p, rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# The strided-gradient check (host code: no card needed)
# ---------------------------------------------------------------------------

def test_strided_gradients_are_read_in_place():
    wide = torch.zeros((64, 32))
    assert hk.rows_strided(wide) and hk.rows_strided(wide[:, :4]) and hk.rows_strided(wide[:, 4:])
    assert not wide[:, :4].is_contiguous()
    assert hk.rows_strided(wide[:1, :4])
    assert not hk.rows_strided(wide[:, 1:5])          # rows not 8-byte aligned
    assert not hk.rows_strided(wide.t())              # columns not contiguous
    assert not hk.rows_strided(torch.zeros((64, 33))[:, :4])   # odd row stride


# ---------------------------------------------------------------------------
# The kernels on the card: contention, strides, zero and ragged inputs
# ---------------------------------------------------------------------------

def _hold(spec, x, table, grad):
    """K3 within 1e-6 of the largest output (f32 both sides, corners summed
    in the same order), K4 within 1e-4 of the largest entry (atomics and
    the merge reorder the sums), exactly zero on a zero gradient."""
    n = x.shape[0]
    with torch.no_grad():
        out_k = hk.hash_encode_forward(x, table, spec)
        out_p = hk.hash_encode_plain(x, table, spec)
    g_k = hk.hash_encode_backward(x, grad, spec)
    g_p = torch.zeros_like(table)
    if n:
        t_p = table.clone().requires_grad_(True)
        (g_p,) = torch.autograd.grad(hk.hash_encode_plain(x, t_p, spec), [t_p], grad)
    torch.cuda.synchronize()
    assert out_k.shape == (n, spec.output_dim)
    if n:
        assert float((out_k - out_p).abs().max()) <= 1e-6 * float(out_p.abs().max())
    if not bool(grad.any()):
        assert not bool(g_k.any())
    else:
        assert float((g_k - g_p).abs().max()) <= 1e-4 * float(g_p.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("n", [20000, 1000, 129, 1])
def test_kernels_on_main_path_specs_and_ragged_tiles(cuda, name, n):
    spec = SPECS[name]()
    x, table, grad = _inputs(cuda, n, spec, seed=n)
    _hold(spec, x, table, grad)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPECS))
def test_kernels_on_clustered_points(cuda, name):
    """Every point in 4 cells of level 0: the shared-memory adds and the
    warp merge see the worst contention."""
    spec = SPECS[name]()
    g = torch.Generator(device=cuda).manual_seed(3)
    cells = torch.randint(0, 16, (4, 3), generator=g, device=cuda).float()
    pick = torch.randint(0, 4, (30000,), generator=g, device=cuda)
    x = ((cells[pick] + torch.rand((30000, 3), generator=g, device=cuda)) / 16).clamp(0, 1)
    _, table, _ = _inputs(cuda, 1, spec)
    grad = torch.randn((30000, spec.output_dim), generator=g, device=cuda)
    _hold(spec, x.contiguous(), table, grad)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPECS))
def test_backward_reads_a_strided_gradient_in_place(cuda, name):
    """A column slice of a wider gradient, as the 2^19 engines' split
    encode hands the small levels theirs, at an offset with 16-byte and
    with only 8-byte aligned rows."""
    spec = SPECS[name]()
    x, table, grad = _inputs(cuda, 5000, spec, seed=4)
    for lead, width in ((0, 32), (4, 40), (2, 38)):
        wide = torch.randn((5000, width), device=cuda)
        g = wide[:, lead:lead + spec.output_dim]
        g.copy_(grad)
        assert not g.is_contiguous() or width == spec.output_dim
        assert hk.rows_strided(g)
        _hold(spec, x, table, g)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPECS))
def test_zero_gradient_gives_exactly_zero(cuda, name):
    spec = SPECS[name]()
    x, table, _ = _inputs(cuda, 20000, spec)
    given = torch.full((spec.num_levels, spec.t_cap, 2), 0.25, device=cuda)
    out = hk.hash_encode_backward(x, torch.zeros((20000, spec.output_dim), device=cuda), spec,
                                  grad_table=given)
    torch.cuda.synchronize()
    assert bool((out == 0.25).all())
    _hold(spec, x, table, torch.zeros((20000, spec.output_dim), device=cuda))


@pytest.mark.cuda
def test_no_points_launch_nothing(cuda):
    spec = SPECS["2^15"]()
    x, table, grad = _inputs(cuda, 8, spec)
    before = hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES
    assert hk.hash_encode_forward(x[:0], table, spec).shape == (0, spec.output_dim)
    assert not bool(hk.hash_encode_backward(x[:0], grad[:0], spec).any())
    assert (hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES) == before


@pytest.mark.cuda
def test_autograd_hands_the_small_levels_a_column_slice(cuda):
    """The small levels' encode joined with other columns, as the split
    encode joins them: the backward reads its columns of the joined
    gradient in place and matches the plain version."""
    spec = SPECS["lattice small"]()
    x, table, _ = _inputs(cuda, 3000, spec, seed=5)
    other = torch.randn((3000, 28), device=cuda)
    up = torch.randn((3000, 32), device=cuda)
    t_k = table.clone().requires_grad_(True)
    joined = torch.cat([hk.hash_encode(x, t_k, spec), other], -1)
    (g_k,) = torch.autograd.grad(joined, [t_k], up)
    t_p = table.clone().requires_grad_(True)
    (g_p,) = torch.autograd.grad(torch.cat([hk.hash_encode_plain(x, t_p, spec), other], -1),
                                 [t_p], up)
    assert float((g_k - g_p).abs().max()) <= 1e-4 * float(g_p.abs().max())

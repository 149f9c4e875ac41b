"""The hash-encoding CUDA kernels K3/K4 (flnerf_tpu_torch/ops/csrc/
hash_encode.cu) against their plain version (ops/hash_kernel.py
hash_encode_plain, with autograd for the gradient) on the card.  Skips
without a CUDA device: the kernels have no CPU mode.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_hash_cuda.py
"""

import pytest
import torch

from flnerf_tpu_torch.models.hash_ngp import NGPConfig, NGPField
from flnerf_tpu_torch.ops import hash_kernel as hk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hash-encoding kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, n, spec, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    table = torch.rand((spec.num_levels, spec.t_cap, 2), generator=g, device=device) * 2 - 1
    x = torch.rand((n, 3), generator=g, device=device)
    x[:4] = torch.tensor([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0.999999]],
                         device=device)
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

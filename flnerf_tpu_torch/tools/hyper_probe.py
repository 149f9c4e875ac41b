"""The D-NeRF hyper field's plain 4-D encode on the card, two ways.

``ops/hash_encoding.hash_encode`` forms each corner's d-linear weight as a
chain of products.  Its earlier form took ``torch.prod`` over the [L, N, D]
factors, whose backward scans them; ``encode_prod`` keeps that form here.
``probe`` times both (forward, and forward with the table's and the
points' backward) by CUDA events on the given points and checks that they
agree.  chip_smoke.py phase 17c runs it on one step's 393,216 lifted
points; alone:

    python -m flnerf_tpu_torch.tools.hyper_probe
"""

from __future__ import annotations

import numpy as np
import torch

from flnerf_tpu_torch.ops.hash_encoding import _corner_index, corner_bits, hash_encode


def encode_prod(x01: torch.Tensor, table: torch.Tensor, spec) -> torch.Tensor:
    """``hash_encode`` with the corner weight as ``torch.prod``."""
    n, dim = x01.shape[0], spec.input_dim
    L, C = spec.num_levels, spec.level_dim
    dev = x01.device
    scales = torch.as_tensor(spec.scales, device=dev)
    resolutions = torch.as_tensor(spec.resolutions.astype(np.int64), device=dev)
    offsets = torch.as_tensor(spec.offsets[:-1], device=dev)
    sizes = torch.as_tensor(spec.sizes, device=dev)
    use_hash = torch.as_tensor(spec.use_hash, device=dev)
    pos = x01[None, :, :] * scales[:, None, None] + 0.5
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    pos_grid = pos_grid.to(torch.int64)
    out = torch.zeros((L, n, C), dtype=table.dtype, device=dev)
    for bits in corner_bits(dim):
        corner = torch.tensor(bits, device=dev)
        w = torch.prod(torch.where(corner == 1, frac, 1.0 - frac), dim=-1)
        idx = _corner_index(pos_grid + corner, use_hash[:, None], resolutions[:, None],
                            sizes[:, None])
        out = out + w[..., None] * table[offsets[:, None] + idx]
    return out.permute(1, 0, 2).reshape(n, L * C)


def _ms(fn, iters):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def probe(x01: torch.Tensor, table: torch.Tensor, spec, iters: int = 3) -> dict:
    """{"chain" | "prod": (forward ms, forward + backward ms)} on CUDA
    tensors, and "max_abs_err" of the forward between the two."""
    g = torch.randn((x01.shape[0], spec.output_dim), device=x01.device)
    x = x01.detach().clone().requires_grad_(True)
    t = table.detach().clone().requires_grad_(True)
    res = {}
    for name, fn in (("chain", hash_encode), ("prod", encode_prod)):
        with torch.no_grad():
            fwd = _ms(lambda: fn(x, t, spec), iters)
        both = _ms(lambda: torch.autograd.grad(fn(x, t, spec), [x, t], g), iters)
        res[name] = (fwd, both)
    with torch.no_grad():
        res["max_abs_err"] = float((hash_encode(x, t, spec) - encode_prod(x, t, spec)).abs().max())
    return res


def main():
    from flnerf_tpu_torch.models.dnerf import DNeRFConfig, make_hyper_spec
    from flnerf_tpu_torch.models.hash_ngp import NGPConfig

    spec = make_hyper_spec(DNeRFConfig(ngp=NGPConfig(bound=2.0)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x01 = torch.rand((4096 * 96, 4), generator=gen, device="cuda")
    table = torch.rand((spec.table_size, spec.level_dim), generator=gen, device="cuda") * 2e-4
    print(probe(x01, table, spec))


if __name__ == "__main__":
    main()

"""Multiresolution hash-grid encoding (Instant-NGP): the level geometry and
the plain semantics oracle.

Port of ``flnerf_tpu/ops/hash_encoding.py``.  Parity target
ngp-ours/gridencoder (grid.py:19-160, src/gridencoder.cu):
  * L levels; level l has scale = 2^(l*log2(per_level_scale))*H - 1 and
    resolution = ceil(scale)+1 (gridencoder.cu:125-126);
  * align_corners=False: pos = x01*scale + 0.5 (cu:134);
  * per-level table size = min(2^log2_hashmap_size, (res+1)^D) rounded up to
    a multiple of 8 (grid.py:117-121); dense indexing when the level fits,
    else xor-hash with primes (1, 2654435761, 805459861) (cu:36-69);
  * d-linear interpolation of the 2^D corners; output layout [N, L*C].

The reference computes the index in uint32 with wraparound.  torch has few
uint32 operators, so ``_corner_index`` works in int64 and keeps the low 32
bits after every multiply, add and xor; the low 32 bits of an int64 product
are those of the uint32 product even where the int64 product wraps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# gridencoder.cu:42 — up to 7-D inputs
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737)
_U32 = 0xFFFFFFFF


class HashGridSpec(NamedTuple):
    num_levels: int
    level_dim: int
    base_resolution: int
    log2_hashmap_size: int
    per_level_scale: float
    input_dim: int
    # derived (numpy, static):
    scales: np.ndarray        # [L] float32
    resolutions: np.ndarray   # [L] int32
    offsets: np.ndarray       # [L+1] int64
    sizes: np.ndarray         # [L] int64 (table entries per level)
    use_hash: np.ndarray      # [L] bool

    @property
    def table_size(self) -> int:
        return int(self.offsets[-1])

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim


def make_hashgrid_spec(
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    per_level_scale: float | None = None,
    desired_resolution: int | None = 2048,
    input_dim: int = 3,
) -> HashGridSpec:
    """The level geometry, in numpy exactly as the reference computes it.
    An explicit per_level_scale wins; desired_resolution (default 2048) is
    consulted only when the scale is not given."""
    if per_level_scale is None:
        if desired_resolution is None:
            desired_resolution = 2048
        per_level_scale = float(
            np.exp2(np.log2(desired_resolution / base_resolution)
                    / max(num_levels - 1, 1))
        ) if num_levels > 1 else 1.0
    S = np.log2(per_level_scale)
    max_params = 2 ** log2_hashmap_size

    scales, resolutions, offsets, sizes, use_hash = [], [], [0], [], []
    for l in range(num_levels):
        scale = np.exp2(l * S) * base_resolution - 1.0
        res = int(np.ceil(scale)) + 1
        # get_grid_index strides by (resolution+1) for align_corners=False
        dense = (res + 1) ** input_dim
        params = min(max_params, dense)
        params = int(np.ceil(params / 8) * 8)
        scales.append(scale)
        resolutions.append(res)
        sizes.append(params)
        use_hash.append(dense > params)
        offsets.append(offsets[-1] + params)

    return HashGridSpec(
        num_levels=num_levels,
        level_dim=level_dim,
        base_resolution=base_resolution,
        log2_hashmap_size=log2_hashmap_size,
        per_level_scale=float(per_level_scale),
        input_dim=input_dim,
        scales=np.asarray(scales, np.float32),
        resolutions=np.asarray(resolutions, np.int32),
        offsets=np.asarray(offsets, np.int64),
        sizes=np.asarray(sizes, np.int64),
        use_hash=np.asarray(use_hash, bool),
    )


def _corner_index(pos_grid: torch.Tensor, use_hash, resolution, size) -> torch.Tensor:
    """Table index of one corner (get_grid_index, gridencoder.cu:55-70), as
    the uint32 arithmetic of the reference gives it, in int64.

    pos_grid: [..., D] integer corner coordinates (D <= 7, one prime an
    axis; negative or large values wrap as their uint32 casts do).
    use_hash, resolution and size broadcast against pos_grid[..., 0].
    """
    d = pos_grid.shape[-1]
    pg = pos_grid.to(torch.int64) & _U32
    stride = (torch.as_tensor(resolution, dtype=torch.int64, device=pg.device) + 1) & _U32
    dense_idx = pg[..., d - 1]
    for a in range(d - 2, -1, -1):
        dense_idx = (pg[..., a] + ((stride * dense_idx) & _U32)) & _U32
    hash_idx = (pg[..., 0] * _PRIMES[0]) & _U32
    for a in range(1, d):
        hash_idx = hash_idx ^ ((pg[..., a] * _PRIMES[a]) & _U32)
    use_hash = torch.as_tensor(use_hash, device=pg.device)
    idx = torch.where(use_hash, hash_idx, dense_idx)
    return idx % torch.as_tensor(size, dtype=torch.int64, device=pg.device)


def corner_bits(dim: int) -> list:
    """Corner c's offset along axis d is bit d of c (hash_pallas.py:118)."""
    return [[(c >> d) & 1 for d in range(dim)] for c in range(2 ** dim)]


def hash_encode(x01: torch.Tensor, table: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Encode points x01 in [0, 1]^D -> [N, L*C] features (D <= 7: the NGP
    background's 2-D grid, the 3-D grids, D-NeRF hyper's 4-D one) from the
    flat [T, C] table; the plain oracle of the CUDA forward (kernel_grid,
    gridencoder.cu:100-180), differentiable in ``table``."""
    n = x01.shape[0]
    dim = spec.input_dim
    L, C = spec.num_levels, spec.level_dim
    dev = x01.device
    scales = torch.as_tensor(spec.scales, device=dev)
    resolutions = torch.as_tensor(spec.resolutions.astype(np.int64), device=dev)
    offsets = torch.as_tensor(spec.offsets[:-1], device=dev)
    sizes = torch.as_tensor(spec.sizes, device=dev)
    use_hash = torch.as_tensor(spec.use_hash, device=dev)

    pos = x01[None, :, :] * scales[:, None, None] + 0.5      # [L, N, D]
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    pos_grid = pos_grid.to(torch.int64)

    out = torch.zeros((L, n, C), dtype=table.dtype, device=dev)
    for bits in corner_bits(dim):
        corner = torch.tensor(bits, device=dev)
        # the d-linear weight as a chain of products: torch.prod's backward
        # scans the [L, N, D] factors (35 ms a corner at 393,216 4-D points
        # on the card), the chain's is elementwise
        w = frac[..., 0] if bits[0] else 1.0 - frac[..., 0]
        for a in range(1, dim):
            w = w * (frac[..., a] if bits[a] else 1.0 - frac[..., a])
        idx = _corner_index(pos_grid + corner, use_hash[:, None],
                            resolutions[:, None], sizes[:, None])
        out = out + w[..., None] * table[offsets[:, None] + idx]
    # [L, N, C] -> [N, L*C] (grid.py:52 permutes back the L-first layout)
    return out.permute(1, 0, 2).reshape(n, L * C)

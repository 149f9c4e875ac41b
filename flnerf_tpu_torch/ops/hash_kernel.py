"""The multiresolution hash encoding of the packed (matmul-engine) spec, with
its forward and table gradient as CUDA kernels.

Port of ``flnerf_tpu/ops/hash_pallas.py``.  The TPU kernels there
(``_fwd_kernel`` and ``_bwd_kernel``, one-hot MXU matmuls against a
lane-partitioned bf16 table) become the hand-written CUDA kernels of
``csrc/hash_encode.cu``: K3 (forward: corner indices, weights, gathers and
the corner sum, fused) and K4 (the table gradient by atomic adds).
``hash_encode`` dispatches by device: on CUDA tensors it is
``HashEncode``, a ``torch.autograd.Function`` whose forward launches K3 and
whose backward launches K4; on CPU tensors the plain version,
``hash_encode_plain`` (the gather formulation of ``hash_encode_xla``),
runs under autograd.  Nothing falls back from the card to the plain
version.

Layout: the port keeps the table in the natural [L, T_cap, C] f32 layout
(``hash_encode_xla``'s own view, hash_pallas.py:366) instead of the TPU's
[L, C, T_r, 128]; ``core/convert.py`` converts between the two.  The
kernels work in f32 throughout, where the TPU kernel rounds the table (and
the backward's w*g) to bf16.

``HASH_FWD_LAUNCHES`` and ``HASH_BWD_LAUNCHES`` count the kernel launches,
so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from flnerf_tpu_torch.ops import _build
from flnerf_tpu_torch.ops.hash_encoding import (
    HashGridSpec,
    _corner_index,
    corner_bits,
    make_hashgrid_spec,
)

LANES = 128
MAX_LEVELS = 32        # csrc/hash_encode.cu kMaxLevels

HASH_FWD_LAUNCHES = 0
HASH_BWD_LAUNCHES = 0

_P = ctypes.c_void_p
_ARGS = [_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P]


class PackedHashSpec(NamedTuple):
    """Static geometry of the packed engine (all levels padded to T_cap)."""

    base: HashGridSpec
    t_cap: int            # padded per-level table entries (multiple of 128)
    t_r: int              # t_cap // 128 (rows of the reference's layout)

    @property
    def num_levels(self) -> int:
        return self.base.num_levels

    @property
    def level_dim(self) -> int:
        return self.base.level_dim

    @property
    def output_dim(self) -> int:
        return self.base.output_dim


def make_packed_spec(
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 15,
    desired_resolution: int = 2048,
) -> PackedHashSpec:
    base = make_hashgrid_spec(
        num_levels=num_levels,
        level_dim=level_dim,
        base_resolution=base_resolution,
        log2_hashmap_size=log2_hashmap_size,
        desired_resolution=desired_resolution,
    )
    t_cap = int(max(base.sizes))
    t_cap = (t_cap + LANES - 1) // LANES * LANES
    return PackedHashSpec(base=base, t_cap=t_cap, t_r=t_cap // LANES)


def init_packed_table(spec: PackedHashSpec, generator=None, device="cpu") -> torch.Tensor:
    """[L, T_cap, C] f32, U(-1e-4, 1e-4) (torch-ngp grid.py init).  Rows
    t >= sizes[l] are padding and never indexed."""
    t = torch.rand((spec.num_levels, spec.t_cap, spec.level_dim),
                   generator=generator, device=device)
    return t * 2e-4 - 1e-4


def reset_launch_counts() -> None:
    global HASH_FWD_LAUNCHES, HASH_BWD_LAUNCHES
    HASH_FWD_LAUNCHES = 0
    HASH_BWD_LAUNCHES = 0


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def corner_indices_weights(x01: torch.Tensor, spec: PackedHashSpec):
    """Per level: the 8 corner rows (within the level) and trilinear weights,
    corners interleaved per point.  Returns idx [L, N*8] int64 (the
    reference's hi * 128 + lo) and w [L, N*8] f32.  Index semantics ==
    gridencoder.cu:125-135 (scale, +0.5, dense-vs-hash)."""
    base = spec.base
    n = x01.shape[0]
    dev = x01.device
    scales = torch.as_tensor(base.scales, device=dev)[:, None, None]
    pos = x01[None] * scales + 0.5                            # [L, N, 3]
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    pos_grid = pos_grid.to(torch.int64)

    resolutions = torch.as_tensor(base.resolutions.astype(np.int64), device=dev)[:, None]
    sizes = torch.as_tensor(base.sizes, device=dev)[:, None]
    use_hash = torch.as_tensor(base.use_hash, device=dev)[:, None]

    idxs, ws = [], []
    for bits in corner_bits(3):
        corner = torch.tensor(bits, device=dev)
        ws.append(torch.prod(torch.where(corner == 1, frac, 1.0 - frac), dim=-1))
        idxs.append(_corner_index(pos_grid + corner, use_hash, resolutions, sizes))
    L = base.num_levels
    return (torch.stack(idxs, -1).reshape(L, n * 8),
            torch.stack(ws, -1).reshape(L, n * 8))


def hash_encode_plain(x01: torch.Tensor, table: torch.Tensor,
                      spec: PackedHashSpec) -> torch.Tensor:
    """x01 [N, 3] in [0, 1] -> [N, L*C] from the [L, T_cap, C] table, by
    gathers (``hash_encode_xla``); differentiable in ``table``.  The
    kernels' yardstick of correctness; runs on any device."""
    n = x01.shape[0]
    L, C = spec.num_levels, spec.level_dim
    idx, w = corner_indices_weights(x01, spec)
    feats = torch.gather(table, 1, idx[..., None].expand(L, n * 8, C))   # [L, N*8, C]
    feats = (feats * w[..., None]).reshape(L, n, 8, C).sum(dim=2)
    return feats.permute(1, 0, 2).reshape(n, L * C)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("hash_encode")
    if lib.hash_encode_forward.argtypes is None:
        for fn in (lib.hash_encode_forward, lib.hash_encode_backward):
            fn.restype = ctypes.c_int
            fn.argtypes = _ARGS
    return lib


def _level_args(spec: PackedHashSpec) -> list:
    """The level geometry the kernels read (scale, stride = resolution + 1,
    size, use_hash) as host-array pointers; each pointer keeps its array
    alive, and the C function copies them before it returns."""
    b = spec.base
    arrays = (np.ascontiguousarray(b.scales, np.float32),
              np.ascontiguousarray(b.resolutions.astype(np.int64) + 1, np.uint32),
              np.ascontiguousarray(b.sizes, np.uint32),
              np.ascontiguousarray(b.use_hash, np.int32))
    return [a.ctypes.data_as(ctypes.c_void_p) for a in arrays]


def _kernel_args(x01: torch.Tensor, spec: PackedHashSpec):
    """Validate what both kernels share; returns (n, the C arguments after
    the first pointer)."""
    dev = x01.device
    if dev.type != "cuda":
        raise ValueError(f"the hash-encoding kernels take CUDA tensors, got {dev}")
    if spec.level_dim != 2 or spec.base.input_dim != 3:
        raise ValueError("the hash-encoding kernels take 3-D inputs and level_dim 2, "
                         f"got input_dim {spec.base.input_dim}, level_dim {spec.level_dim}")
    if not 1 <= spec.num_levels <= MAX_LEVELS:
        raise ValueError(f"the hash-encoding kernels take 1..{MAX_LEVELS} levels")
    n = x01.shape[0]
    _build.check_tensor(x01, "x01", (n, 3), torch.float32, dev)
    if n * spec.num_levels * 8 >= 2 ** 62 or spec.t_cap >= 2 ** 31:
        raise ValueError("point count or table size out of the kernels' range")
    return n, [n, spec.num_levels, spec.t_cap] + _level_args(spec)


def hash_encode_forward(x01: torch.Tensor, table: torch.Tensor,
                        spec: PackedHashSpec) -> torch.Tensor:
    """K3: [N, L*2] f32 features of the points x01 [N, 3]."""
    global HASH_FWD_LAUNCHES
    n, args = _kernel_args(x01, spec)
    _build.check_tensor(table, "table", (spec.num_levels, spec.t_cap, 2), torch.float32,
                        x01.device)
    out = torch.empty((n, spec.output_dim), dtype=torch.float32, device=x01.device)
    if n == 0:
        return out
    rc = _lib().hash_encode_forward(x01.data_ptr(), table.data_ptr(), *args,
                                    out.data_ptr(),
                                    torch.cuda.current_stream(x01.device).cuda_stream)
    HASH_FWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"hash_encode_forward launch failed: cudaError {rc}")
    return out


def hash_encode_backward(x01: torch.Tensor, grad_out: torch.Tensor,
                         spec: PackedHashSpec, grad_table=None) -> torch.Tensor:
    """K4: the [L, T_cap, 2] f32 table gradient for the upstream gradient
    grad_out [N, L*2].  The gradient is zero-filled here, or, when
    ``grad_table`` is given, added into it."""
    global HASH_BWD_LAUNCHES
    n, args = _kernel_args(x01, spec)
    _build.check_tensor(grad_out, "grad_out", (n, spec.output_dim), torch.float32, x01.device)
    shape = (spec.num_levels, spec.t_cap, 2)
    if grad_table is None:
        grad_table = torch.zeros(shape, dtype=torch.float32, device=x01.device)
    _build.check_tensor(grad_table, "grad_table", shape, torch.float32, x01.device)
    if n == 0:
        return grad_table
    rc = _lib().hash_encode_backward(x01.data_ptr(), grad_out.data_ptr(), *args,
                                     grad_table.data_ptr(),
                                     torch.cuda.current_stream(x01.device).cuda_stream)
    HASH_BWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"hash_encode_backward launch failed: cudaError {rc}")
    return grad_table


class HashEncode(torch.autograd.Function):
    """Forward K3, backward K4; the gradient flows to the table only (the
    reference's custom VJP returns none for x01)."""

    @staticmethod
    def forward(ctx, x01, table, spec):
        x01 = x01.contiguous()
        ctx.save_for_backward(x01)
        ctx.spec = spec
        return hash_encode_forward(x01, table, spec)

    @staticmethod
    def backward(ctx, grad_out):
        (x01,) = ctx.saved_tensors
        return None, hash_encode_backward(x01, grad_out.contiguous(), ctx.spec), None


def hash_encode(x01: torch.Tensor, table: torch.Tensor,
                spec: PackedHashSpec) -> torch.Tensor:
    """x01 [N, 3] in [0, 1] -> [N, L*C] features, differentiable in table.

    CUDA tensors launch K3 (and K4 in the backward); CPU tensors take the
    plain version; any other device raises."""
    dev = table.device
    if dev.type == "cuda":
        return HashEncode.apply(x01, table, spec)
    if dev.type == "cpu":
        return hash_encode_plain(x01, table, spec)
    raise ValueError(f"no hash encoding for device {dev}")

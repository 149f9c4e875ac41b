"""The lattice-hash encoding of the big hash levels, with its forward and
table gradient as CUDA kernels.

Port of ``flnerf_tpu/ops/hash_lattice.py``.  Hashed levels use the linear
hash ``key = (x*P1 + y*P2 + z*P3) mod T`` (T = 2^k) with per-level odd
multipliers chosen to keep the alias lattice's shortest vector long
(``_pick_multipliers``), so the 8 corners of a cell sit at fixed per-level
offsets from its base key: corner c is ``(key + offs[l, c]) mod T``.  Dense
levels keep the reference index ``x + S*(y + S*z)``, plus ``offs[l, c]``
with no modulo.  Levels with tables below ``split_min_size`` stay on the
packed engine (``ops/hash_kernel.py``, K3/K4), with the xor hash.

The function is ``lattice_encode_xla``'s (hash_lattice.py:827-875): an f32
table, exact fractions, every corner.  The TPU engine's bf16 table, its
16/14-bit fixed-point fractions and its slab spill are TPU machinery and
are not carried over.  Neither is its slab geometry (``r_pad``, ``block``,
``cb``, ``_geometry``, ``_slab_bases``, ``spill_fraction_lattice``,
``lattice_flops_estimate``): a direct gather has no slab to size, and no
corner to drop.

On CUDA tensors ``lattice_encode`` is ``LatticeEncode``, a
``torch.autograd.Function``:
  * the forward computes each big level's base keys with torch integer ops
    (as the reference's XLA prep does, :317-350), sorts them with K5 (one
    [Lb, N_pad] sort, the point index as payload, pads at key 2^31-1 sorting
    last and dropped), and launches K6, which walks the points in key order
    and gathers their corners;
  * the backward launches K7 on the forward's order, kept in ``ctx``, so
    the reference's unsort (:699) and gradient permutation (:736) have no
    counterpart.
The sort buys locality, not correctness: K6/K7 give the same result in any
order (``csrc/hash_lattice.cu`` says why the order matters on the card).  CPU
tensors take the plain version, ``lattice_encode_plain``, under autograd.
Nothing falls back from the card to the plain version.

Layout: the big table is [Lb, t_r64 * 64, 2] f32, a plain reshape of the
reference's packed [Lb, t_r64, 128] (entry e of level l sits there at
[l, e >> 6, 2 * (e & 63) + c]); ``core/convert.py`` converts.

``LATTICE_FWD_LAUNCHES`` and ``LATTICE_BWD_LAUNCHES`` count K6 and K7's
launches (K5's are ``sort_kernel.SORT_LAUNCHES``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from flnerf_tpu_torch.ops import _build
from flnerf_tpu_torch.ops.hash_kernel import MAX_LEVELS, hash_encode, init_packed_table
from flnerf_tpu_torch.ops.hash_sorted import SplitHashSpec, make_split_spec
from flnerf_tpu_torch.ops.sort_kernel import bitonic_sort

PACK = 64                # table entries per 128-lane row of the reference's layout
PAD_KEY = (1 << 31) - 1  # sorts after every real key

LATTICE_FWD_LAUNCHES = 0
LATTICE_BWD_LAUNCHES = 0

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGS = [_P, _P, _P, _LL, _LL, ctypes.c_int, _LL, _P, _P, _P, _P, _P, _P, _P, _P]


def reset_launch_counts() -> None:
    global LATTICE_FWD_LAUNCHES, LATTICE_BWD_LAUNCHES
    LATTICE_FWD_LAUNCHES = 0
    LATTICE_BWD_LAUNCHES = 0


# ---------------------------------------------------------------------------
# Multiplier selection
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _pick_multipliers(t: int, n_levels: int, radius: int = 96,
                      n_cand: int = 96, seed: int = 7) -> np.ndarray:
    """[n_levels, 3] odd multipliers mod t (a power of two): the reference's
    picks (hash_lattice.py:107-133), computed in closed form.

    The reference scores each candidate P by the shortest nonzero D in the
    |D|_inf <= radius ball with D.P == 0 (mod t), testing all (2r+1)^3
    offsets.  P's third multiplier is odd, so it is invertible mod t: for
    each (dx, dy) exactly one residue class of dz solves the congruence,
    and its centred representative c is the shortest; (dx, dy, c) is a hit
    when |c| <= radius.  For (dx, dy) = (0, 0) the class is dz = 0 (mod t),
    whose shortest nonzero member is |dz| = t.  That is (2r+1)^2 work per
    candidate, with the same draws, scores and order as the reference."""
    if t < 2 or t & (t - 1):
        raise ValueError(f"t must be a power of two >= 2, got {t}")
    rng = np.random.default_rng(seed)
    ax = np.arange(-radius, radius + 1, dtype=np.int64)
    dx, dy = np.meshgrid(ax, ax, indexing="ij")
    origin = (dx == 0) & (dy == 0)
    scored = []
    for _ in range(n_cand):
        p = (rng.integers(1, t, 3) | 1).astype(np.int64)
        inv = pow(int(p[2]), -1, t)
        dz = (-((dx * p[0] + dy * p[1]) % t) * inv) % t
        dz = np.where(dz > t // 2, dz - t, dz)
        n2 = dx * dx + dy * dy + dz * dz
        hit = (np.abs(dz) <= radius) & ~origin
        cands = [int(n2[hit].min())] if hit.any() else []
        if t <= radius:
            cands.append(t * t)
        lam2 = min(cands) if cands else (radius + 1) ** 2
        scored.append((lam2, tuple(int(v) for v in p)))
    scored.sort(reverse=True)
    return np.asarray([scored[i % len(scored)][1] for i in range(n_levels)], np.int64)


# ---------------------------------------------------------------------------
# The spec
# ---------------------------------------------------------------------------

class LatticeSpec(NamedTuple):
    """Static config: the small/big split plus the big group's lattice."""

    split: SplitHashSpec
    mult: np.ndarray      # [Lb, 3] int64 multipliers (hashed levels)
    offs: np.ndarray      # [Lb, 8] int64 corner offsets (all big levels)
    t_r64: int            # big-table rows at PACK entries a row

    @property
    def n_big(self) -> int:
        return self.split.n_big

    @property
    def level_dim(self) -> int:
        return self.split.level_dim

    @property
    def num_levels(self) -> int:
        return self.split.num_levels

    @property
    def output_dim(self) -> int:
        return self.split.base.num_levels * self.split.base.level_dim

    @property
    def t_big(self) -> int:
        """Entries per level of the big table."""
        return self.t_r64 * PACK


def _corner_bits(c: int):
    return [(c >> d) & 1 for d in range(3)]


def make_lattice_spec(
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: int = 2048,
    split_min_size: int = 1 << 15,
) -> LatticeSpec:
    """The reference's ``make_lattice_spec`` without its slab arguments
    (``block``, ``cb``): the same split, multipliers, offsets and rows."""
    split = make_split_spec(
        num_levels=num_levels, level_dim=level_dim,
        base_resolution=base_resolution,
        log2_hashmap_size=log2_hashmap_size,
        desired_resolution=desired_resolution,
        split_min_size=split_min_size,
    )
    if split.big is None:
        raise ValueError("the lattice engine needs big levels")
    if level_dim != 2:
        raise ValueError("the lattice engine assumes level_dim == 2")
    big = split.big
    sizes = big.sizes.astype(np.int64)
    hashed = big.use_hash.astype(bool)
    # every hashed level's table is the shared power-of-two capacity
    t_hash = 0
    if hashed.any():
        hsz = sizes[hashed]
        if not (np.all(hsz == hsz[0]) and (hsz[0] & (hsz[0] - 1)) == 0):
            raise ValueError(f"hashed level sizes must be one power of two, got {hsz}")
        t_hash = int(hsz[0])
    t_cap = max(int(sizes.max()), t_hash)
    t_cap = -(-t_cap // (8 * PACK)) * (8 * PACK)
    if hashed.any() and t_cap != t_hash:
        raise ValueError(f"a dense level outgrows the hashed capacity ({t_cap} > {t_hash})")
    mult = _pick_multipliers(max(t_hash, 2), split.n_big).copy()   # the cache keeps its own
    offs = np.zeros((split.n_big, 8), np.int64)
    for li in range(split.n_big):
        for c in range(8):
            b = _corner_bits(c)
            if hashed[li]:
                p = mult[li]
                offs[li, c] = (b[0] * p[0] + b[1] * p[1] + b[2] * p[2]) % t_hash
            else:
                s = int(big.resolutions[li]) + 1
                offs[li, c] = b[0] + s * (b[1] + s * b[2])
    return LatticeSpec(split=split, mult=mult, offs=offs, t_r64=t_cap // PACK)


def init_lattice_tables(spec: LatticeSpec, generator=None, device="cpu"):
    """(table_small [Ls, T_cap, 2] or None, table_big [Lb, t_r64 * 64, 2]),
    U(-1e-4, 1e-4) like torch-ngp; every entry is drawn, padding included."""
    ts = None
    if spec.split.small is not None:
        ts = init_packed_table(spec.split.small, generator, device)
    tb = torch.rand((spec.n_big, spec.t_big, spec.level_dim), generator=generator,
                    device=device)
    return ts, tb * 2e-4 - 1e-4


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

_LEVEL_TENSORS: dict = {}


def _level_tensors(spec: LatticeSpec, device):
    """(scales, mult, strides, sizes, use_hash, offs) on ``device``, made once
    per (spec, device): copying them to the card on every call would make
    the host wait for the card each time (a pageable host-to-device copy
    synchronizes the stream)."""
    key = (id(spec), str(device))
    hit = _LEVEL_TENSORS.get(key)
    if hit is None or hit[0] is not spec:
        if len(_LEVEL_TENSORS) >= 16:
            _LEVEL_TENSORS.clear()
        big = spec.split.big
        hit = (spec, (
            torch.as_tensor(big.scales, device=device)[:, None, None],
            torch.as_tensor(spec.mult & 0xFFFFFFFF, device=device),
            torch.as_tensor(big.resolutions.astype(np.int64) + 1, device=device)[:, None],
            torch.as_tensor(big.sizes.astype(np.int64), device=device)[:, None],
            torch.as_tensor(big.use_hash, device=device)[:, None],
            torch.as_tensor(spec.offs, device=device)))
        _LEVEL_TENSORS[key] = hit
    return hit[1]


def _cells(x01: torch.Tensor, spec: LatticeSpec):
    """(frac [Lb, N, 3] f32, base key [Lb, N] int64).  The hashed base is the uint32 sum of products, kept unreduced in int64;
    every level size divides 2^32, so reducing it mod size later equals the
    reference's uint32 arithmetic (products stay below 2^63 for the
    coordinates of points in [0, 1])."""
    scales, mult, strides, _, use_hash, _ = _level_tensors(spec, x01.device)
    pos = x01[None] * scales + 0.5                            # [Lb, N, 3]
    cell = torch.floor(pos)
    frac = pos - cell
    cell = cell.to(torch.int64)
    base_h = (cell[..., 0] * mult[:, 0:1] + cell[..., 1] * mult[:, 1:2]
              + cell[..., 2] * mult[:, 2:3])
    base_d = cell[..., 0] + strides * (cell[..., 1] + strides * cell[..., 2])
    return frac, torch.where(use_hash, base_h, base_d)


def lattice_keys(x01: torch.Tensor, spec: LatticeSpec) -> torch.Tensor:
    """[Lb, N] int32 base keys, the reference's sort keys (:317-339): the
    hashed levels' key mod size, the dense levels' x + S*(y + S*z)."""
    _, _, _, sizes, use_hash, _ = _level_tensors(spec, x01.device)
    _, base = _cells(x01, spec)
    return torch.where(use_hash, base % sizes, base).to(torch.int32)


def corner_indices_weights(x01: torch.Tensor, spec: LatticeSpec):
    """Per big level: the 8 corner entries (within the level) and trilinear
    weights, [Lb, N, 8] int64 and [Lb, N, 8] f32, corner c's offset along
    axis d being bit d of c; the weight is the product in axis order."""
    _, _, _, sizes, use_hash, offs = _level_tensors(spec, x01.device)
    frac, base = _cells(x01, spec)
    idxs, ws = [], []
    for c in range(8):
        b = _corner_bits(c)
        w = [frac[..., d] if b[d] else 1.0 - frac[..., d] for d in range(3)]
        ws.append(w[0] * w[1] * w[2])
        a = base + offs[:, c:c + 1]
        idxs.append(torch.where(use_hash, a % sizes, a))
    return torch.stack(idxs, -1), torch.stack(ws, -1)


def lattice_encode_plain(x01: torch.Tensor, table_big: torch.Tensor,
                         spec: LatticeSpec) -> torch.Tensor:
    """x01 [N, 3] in [0, 1] -> [N, Lb*2] from the [Lb, T, 2] table, by
    gathers, the corners summed in order (``lattice_encode_xla``);
    differentiable in ``table_big``.  The kernels' yardstick of
    correctness; runs on any device."""
    n = x01.shape[0]
    lb, C = spec.n_big, spec.level_dim
    idx, w = corner_indices_weights(x01, spec)
    out = torch.zeros((lb, n, C), dtype=table_big.dtype, device=x01.device)
    for c in range(8):
        f = torch.gather(table_big, 1, idx[..., c:c + 1].expand(lb, n, C))
        out = out + w[..., c:c + 1] * f
    return out.permute(1, 0, 2).reshape(n, lb * C)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def lattice_sort_inputs(x01: torch.Tensor, spec: LatticeSpec):
    """The sort's operands: keys [Lb, N_pad] int32, the base keys padded
    with 2^31-1 (N_pad = N rounded up to a power of two, at least 128), and
    the point index [Lb, N_pad] int32 as payload."""
    n = x01.shape[0]
    n_pad = max(128, 1 << max(n - 1, 0).bit_length())
    keys = torch.full((spec.n_big, n_pad), PAD_KEY, dtype=torch.int32, device=x01.device)
    keys[:, :n] = lattice_keys(x01, spec)
    iota = torch.arange(n_pad, dtype=torch.int32, device=x01.device)
    return keys, iota.expand(spec.n_big, n_pad).contiguous()


def lattice_sort_order(x01: torch.Tensor, spec: LatticeSpec) -> torch.Tensor:
    """[Lb, N_pad] int32: per big level, the points in ascending base-key
    order in the first N slots (the pads sort last).  On CUDA tensors the
    sort is K5."""
    return bitonic_sort(*lattice_sort_inputs(x01, spec))[1]


def _lib() -> ctypes.CDLL:
    lib = _build.load("hash_lattice")
    if lib.lattice_encode_forward.argtypes is None:
        for fn in (lib.lattice_encode_forward, lib.lattice_encode_backward):
            fn.restype = ctypes.c_int
            fn.argtypes = _ARGS
    return lib


_LEVEL_ARGS: dict = {}


def _level_args(spec: LatticeSpec) -> list:
    """The level constants the kernels read, as host-array pointers, made
    once per spec; the cache keeps the arrays alive, and the C function
    copies them before it returns."""
    hit = _LEVEL_ARGS.get(id(spec))
    if hit is None or hit[0] is not spec:
        if len(_LEVEL_ARGS) >= 16:
            _LEVEL_ARGS.clear()
        big = spec.split.big
        hashed = big.use_hash.astype(bool)
        masks = np.where(hashed, big.sizes.astype(np.int64) - 1, 0)
        arrays = (np.ascontiguousarray(big.scales, np.float32),
                  np.ascontiguousarray((spec.mult & 0xFFFFFFFF).reshape(-1), np.uint32),
                  np.ascontiguousarray(spec.offs.reshape(-1), np.uint32),
                  np.ascontiguousarray(big.resolutions.astype(np.int64) + 1, np.uint32),
                  np.ascontiguousarray(masks, np.uint32),
                  np.ascontiguousarray(hashed, np.int32))
        hit = (spec, arrays, [a.ctypes.data_as(ctypes.c_void_p) for a in arrays])
        _LEVEL_ARGS[id(spec)] = hit
    return hit[2]


def _kernel_args(x01: torch.Tensor, order: torch.Tensor, spec: LatticeSpec):
    """Validate what both kernels share; returns (n, the C arguments after
    the second pointer)."""
    dev = x01.device
    if dev.type != "cuda":
        raise ValueError(f"the lattice kernels take CUDA tensors, got {dev}")
    if spec.level_dim != 2:
        raise ValueError(f"the lattice kernels take level_dim 2, got {spec.level_dim}")
    if not 1 <= spec.n_big <= MAX_LEVELS:
        raise ValueError(f"the lattice kernels take 1..{MAX_LEVELS} big levels")
    n = x01.shape[0]
    _build.check_tensor(x01, "x01", (n, 3), torch.float32, dev)
    if order.dim() != 2 or order.shape[0] != spec.n_big or order.shape[1] < n:
        raise ValueError(f"order must be [{spec.n_big}, >= {n}], got {tuple(order.shape)}")
    _build.check_tensor(order, "order", tuple(order.shape), torch.int32, dev)
    if n >= 2 ** 31 or spec.t_big > 2 ** 31:
        raise ValueError("point count or table size out of the kernels' range")
    return n, [order.data_ptr(), n, order.shape[1], spec.n_big, spec.t_big] + _level_args(spec)


def lattice_encode_forward(x01: torch.Tensor, table_big: torch.Tensor, spec: LatticeSpec,
                           order: torch.Tensor) -> torch.Tensor:
    """K6: [N, Lb*2] f32 features of the points x01 [N, 3], walked in the
    given order (``lattice_sort_order``'s, or any permutation)."""
    global LATTICE_FWD_LAUNCHES
    n, args = _kernel_args(x01, order, spec)
    _build.check_tensor(table_big, "table_big", (spec.n_big, spec.t_big, 2), torch.float32,
                        x01.device)
    out = torch.empty((n, spec.n_big * 2), dtype=torch.float32, device=x01.device)
    if n == 0:
        return out
    rc = _lib().lattice_encode_forward(x01.data_ptr(), table_big.data_ptr(), *args,
                                       out.data_ptr(),
                                       torch.cuda.current_stream(x01.device).cuda_stream)
    LATTICE_FWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"lattice_encode_forward launch failed: cudaError {rc}")
    return out


def lattice_encode_backward(x01: torch.Tensor, grad_out: torch.Tensor, spec: LatticeSpec,
                            order: torch.Tensor, grad_table=None) -> torch.Tensor:
    """K7: the [Lb, T, 2] f32 table gradient for the upstream gradient
    grad_out [N, Lb*2].  The gradient is zero-filled here, or, when
    ``grad_table`` is given, added into it."""
    global LATTICE_BWD_LAUNCHES
    n, args = _kernel_args(x01, order, spec)
    _build.check_tensor(grad_out, "grad_out", (n, spec.n_big * 2), torch.float32, x01.device)
    shape = (spec.n_big, spec.t_big, 2)
    if grad_table is None:
        grad_table = torch.zeros(shape, dtype=torch.float32, device=x01.device)
    _build.check_tensor(grad_table, "grad_table", shape, torch.float32, x01.device)
    if n == 0:
        return grad_table
    rc = _lib().lattice_encode_backward(x01.data_ptr(), grad_out.data_ptr(), *args,
                                        grad_table.data_ptr(),
                                        torch.cuda.current_stream(x01.device).cuda_stream)
    LATTICE_BWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"lattice_encode_backward launch failed: cudaError {rc}")
    return grad_table


class LatticeEncode(torch.autograd.Function):
    """Forward K5 then K6, backward K7 on the forward's order; the gradient
    flows to the table only (the reference's custom VJP returns none for
    x01)."""

    @staticmethod
    def forward(ctx, x01, table_big, spec):
        x01 = x01.contiguous()
        order = lattice_sort_order(x01, spec)
        ctx.save_for_backward(x01, order)
        ctx.spec = spec
        return lattice_encode_forward(x01, table_big, spec, order)

    @staticmethod
    def backward(ctx, grad_out):
        x01, order = ctx.saved_tensors
        return None, lattice_encode_backward(x01, grad_out.contiguous(), ctx.spec, order), None


def lattice_encode(x01: torch.Tensor, table_big: torch.Tensor,
                   spec: LatticeSpec) -> torch.Tensor:
    """Big-group lattice encode: x01 [N, 3] in [0, 1] -> [N, Lb*2],
    differentiable in table_big.  CUDA tensors launch K5, K6 (and K7 in the
    backward); CPU tensors take the plain version; any other device
    raises."""
    dev = table_big.device
    if dev.type == "cuda":
        return LatticeEncode.apply(x01, table_big, spec)
    if dev.type == "cpu":
        return lattice_encode_plain(x01, table_big, spec)
    raise ValueError(f"no lattice encoding for device {dev}")


def lattice_encode_split(x01: torch.Tensor, tables, spec: LatticeSpec) -> torch.Tensor:
    """Small levels through the packed engine (xor hash, K3/K4 on the
    card), big levels through the lattice engine; tables = (table_small or
    None, table_big).  Returns [N, L*2] in level order."""
    table_small, table_big = tables
    parts = []
    if spec.split.small is not None:
        parts.append(hash_encode(x01, table_small, spec.split.small))
    parts.append(lattice_encode(x01, table_big, spec))
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


# ---------------------------------------------------------------------------
# Layout converters
# ---------------------------------------------------------------------------

def pack64_from_levels(levels, spec: LatticeSpec) -> torch.Tensor:
    """List of [size_l, 2] level tables -> the [Lb, T, 2] big table, zero
    past each level's size."""
    out = torch.zeros((spec.n_big, spec.t_big, 2), dtype=torch.float32)
    for li, lvl in enumerate(levels):
        out[li, :lvl.shape[0]] = torch.as_tensor(lvl)
    return out


def levels_from_pack64(table_big: torch.Tensor, spec: LatticeSpec) -> list:
    """[Lb, T, 2] -> list of [size_l, 2] level tables."""
    sizes = spec.split.big.sizes
    return [table_big[li, :int(sizes[li])] for li in range(spec.n_big)]

"""The split of the hash levels into a small group (the packed engine, K3/K4)
and a big group, and the sorted engine that encodes the big group with
torch-ngp's xor hash, with its forward (K8) and table gradient (K9) as CUDA
kernels.

Port of ``flnerf_tpu/ops/hash_sorted.py``: the spec half (``SplitHashSpec``,
``_subset``, ``make_split_spec``, ``_big_packed_spec``), which the lattice
engine (``ops/hash_lattice.py``) also reads to route its levels, and the
engine half (``init_split_table``, ``hash_encode_sorted``,
``hash_encode_split``, ``split_from_flat``).

The function is ``hash_encoding.hash_encode`` on the big levels, which the
reference's CPU path computes as ``hash_encode_xla`` on ``_big_packed_spec``
(hash_sorted.py:627): an f32 table, exact f32 weights, every corner.  The
TPU engine's bf16 slabs (:310) and bf16 ``w * feature`` (:326), its 15-bit
weights in the sort payload (:444) and its slab spill (corners outside a
block's head and tail slabs contribute zeros, :243) are TPU machinery and
are not carried over.  Neither is its slab and block geometry: ``_geometry``,
``_pack_cols``, ``_base_rows``, ``_decode_cols``, ``_dual_slab_onehot``, the
dense/hashed kernel split (``_level_ranges``), ``BLOCK``, ``CB``,
``W_BITS``/``W_SCALE``, and ``spill_fraction``: a direct gather has no slab
to size and drops no corner.  So the port and the TPU engine differ by
design on inputs whose sorted blocks hold three clusters of keys on a dense
level: there the engine gives zeros for the middle cluster's corners, and
the port gives the oracle's values.

On CUDA tensors ``hash_encode_sorted`` is ``SortedEncode``, a
``torch.autograd.Function``:
  * the forward builds (key, payload) pairs with torch integer ops
    (``sort_inputs``): per point chunk and big level, the 8 corners' table
    entries as keys (``corner_keys``, the reference's ``hi * 128 + lo``) and
    each corner's slot in its chunk (``p_local * 8 + corner``) as payload,
    rows padded to a power of two with ``PAD_KEY``, which sorts last; K5
    sorts every row in one launch (``sort_kernel.sort_pairs_``); K8 walks the
    sorted pairs, recomputes each corner's weight from x01 and adds
    ``w * feature`` into the zero-filled [N, Lb*2] output;
  * the backward launches K9 on the forward's sorted pairs, kept in ``ctx``
    as the reference keeps ``sidx``/``spay``: no second sort.
Point sets beyond ``POINT_CAP`` split into equal chunks, as the reference's
do, and batch along the sort's rows: one K5, one K8 and one K9 launch per
call, however many chunks.  CPU tensors take the plain version,
``hash_kernel.hash_encode_plain`` on ``_big_packed_spec``, under autograd.
Nothing falls back from the card to the plain version.

Layout: tables stay in the natural [L, T, 2] f32 layout (the small table
[Ls, t_cap, 2], the big one [Lb, t_cap_big, 2]) where the reference keeps
[L, C, T/128, 128]; ``core/convert.py`` converts.

``SORTED_FWD_LAUNCHES`` and ``SORTED_BWD_LAUNCHES`` count K8 and K9's
launches (K5's are ``sort_kernel.SORT_LAUNCHES``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from flnerf_tpu_torch.ops import _build
from flnerf_tpu_torch.ops.hash_encoding import HashGridSpec, make_hashgrid_spec
from flnerf_tpu_torch.ops.hash_kernel import (
    LANES,
    MAX_LEVELS,
    PackedHashSpec,
    hash_encode,
    hash_encode_plain,
    init_packed_table,
)
from flnerf_tpu_torch.ops.sort_kernel import bitonic_sort_plain, sort_pairs_

POINT_CAP = 1 << 14      # points per chunk (the reference's pid budget, :87)
PAD_KEY = (1 << 31) - 1  # sorts after every real key
_PRIME_Y, _PRIME_Z = 2654435761, 805459861   # gridencoder.cu:42
_U32 = 0xFFFFFFFF

SORTED_FWD_LAUNCHES = 0
SORTED_BWD_LAUNCHES = 0

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def reset_launch_counts() -> None:
    global SORTED_FWD_LAUNCHES, SORTED_BWD_LAUNCHES
    SORTED_FWD_LAUNCHES = 0
    SORTED_BWD_LAUNCHES = 0


def _round8(x: int) -> int:
    return (int(x) + 7) // 8 * 8


# ---------------------------------------------------------------------------
# The spec
# ---------------------------------------------------------------------------

class SplitHashSpec(NamedTuple):
    """Static split of levels into the packed path (small) and a large-table
    engine (big)."""

    base: HashGridSpec                  # full spec, all levels
    n_small: int                        # levels [0, n_small) -> packed path
    small: Optional[PackedHashSpec]
    big: Optional[HashGridSpec]         # subset spec for levels [n_small, L)
    t_cap_big: int                      # big-group padded entries (multiple of 1024)
    t_r_big: int

    @property
    def num_levels(self) -> int:
        return self.base.num_levels

    @property
    def level_dim(self) -> int:
        return self.base.level_dim

    @property
    def n_big(self) -> int:
        return self.base.num_levels - self.n_small

    @property
    def output_dim(self) -> int:
        return self.base.num_levels * self.base.level_dim


def _subset(base: HashGridSpec, lo: int, hi: int) -> HashGridSpec:
    sizes = base.sizes[lo:hi]
    return base._replace(
        num_levels=hi - lo,
        scales=base.scales[lo:hi],
        resolutions=base.resolutions[lo:hi],
        sizes=sizes,
        use_hash=base.use_hash[lo:hi],
        offsets=np.concatenate([[0], np.cumsum(sizes)]),
    )


def make_split_spec(
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: int = 2048,
    split_min_size: int = 1 << 15,
) -> SplitHashSpec:
    """Levels whose table has fewer than ``split_min_size`` entries take the
    packed path.  Level sizes do not decrease, so the split is a prefix and
    a suffix in level order."""
    base = make_hashgrid_spec(
        num_levels=num_levels, level_dim=level_dim,
        base_resolution=base_resolution,
        log2_hashmap_size=log2_hashmap_size,
        desired_resolution=desired_resolution,
    )
    n_small = int(np.sum(base.sizes < split_min_size))
    small = None
    if n_small:
        sub = _subset(base, 0, n_small)
        cap = _round8(int(max(sub.sizes)))
        cap = (cap + LANES - 1) // LANES * LANES
        small = PackedHashSpec(base=sub, t_cap=cap, t_r=cap // LANES)
    big = _subset(base, n_small, num_levels) if n_small < num_levels else None
    t_cap_big = 0
    if big is not None:
        t_cap_big = (int(max(big.sizes)) + 8 * LANES - 1) // (8 * LANES) * (8 * LANES)
    return SplitHashSpec(base=base, n_small=n_small, small=small, big=big,
                         t_cap_big=t_cap_big, t_r_big=t_cap_big // LANES)


def _big_packed_spec(spec: SplitHashSpec) -> PackedHashSpec:
    return PackedHashSpec(base=spec.big, t_cap=spec.t_cap_big, t_r=spec.t_r_big)


def init_split_table(spec: SplitHashSpec, generator=None, device="cpu"):
    """(table_small [Ls, t_cap, 2] or None, table_big [Lb, t_cap_big, 2] or
    None), U(-1e-4, 1e-4) like torch-ngp; every entry is drawn, padding
    included."""
    ts = tb = None
    if spec.small is not None:
        ts = init_packed_table(spec.small, generator, device)
    if spec.big is not None:
        tb = torch.rand((spec.n_big, spec.t_cap_big, spec.level_dim), generator=generator,
                        device=device) * 2e-4 - 1e-4
    return ts, tb


def split_from_flat(flat_table: torch.Tensor, spec: SplitHashSpec):
    """[T_total, C] flat table (``hash_encoding`` layout, per-level offsets)
    -> (table_small [Ls, t_cap, C] or None, table_big [Lb, t_cap_big, C] or
    None), each level zero-padded to its group's cap."""
    flat_table = torch.as_tensor(flat_table)
    outs = []
    for lo_lvl, hi_lvl, cap in (
            (0, spec.n_small, 0 if spec.small is None else spec.small.t_cap),
            (spec.n_small, spec.num_levels, spec.t_cap_big)):
        if hi_lvl <= lo_lvl:
            outs.append(None)
            continue
        out = torch.zeros((hi_lvl - lo_lvl, cap, spec.level_dim), dtype=flat_table.dtype)
        for l in range(lo_lvl, hi_lvl):
            o, sz = int(spec.base.offsets[l]), int(spec.base.sizes[l])
            out[l - lo_lvl, :sz] = flat_table[o:o + sz]
        outs.append(out)
    return tuple(outs)


# ---------------------------------------------------------------------------
# The sort's operands
# ---------------------------------------------------------------------------

_LEVEL_TENSORS: dict = {}


def _level_tensors(spec: SplitHashSpec, device):
    """(scales [Lb, 1, 1] f32, strides [Lb, 1, 1] int64, sizes [Lb, 1, 1]
    int64, n_dense) on ``device``, made once per (spec, device): a pageable
    host-to-device copy on every call would make the host wait for the
    card."""
    key = (id(spec), str(device))
    hit = _LEVEL_TENSORS.get(key)
    if hit is None or hit[0] is not spec:
        if len(_LEVEL_TENSORS) >= 16:
            _LEVEL_TENSORS.clear()
        big = spec.big
        hashed = big.use_hash.astype(bool)
        n_dense = int(np.sum(~hashed))
        if np.any(hashed[:n_dense]) or not np.all(hashed[n_dense:]):
            raise ValueError(f"dense big levels must precede the hashed ones: {hashed}")
        sizes = big.sizes.astype(np.int64)
        if np.any(sizes[hashed] & (sizes[hashed] - 1)):
            raise ValueError(f"hashed level sizes must be powers of two, got {sizes[hashed]}")
        col = lambda a: torch.as_tensor(a, device=device)[:, None, None]
        hit = (spec, (col(big.scales), col(big.resolutions.astype(np.int64) + 1),
                      col(sizes), n_dense))
        _LEVEL_TENSORS[key] = hit
    return hit[1]


def _as_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def corner_keys(x01: torch.Tensor, spec: SplitHashSpec) -> torch.Tensor:
    """[Lb, N, 8] int32: each big level's 8 corner entries (within the
    level), corner c's offset along axis d being bit d of c; the reference's
    ``hi * 128 + lo`` on ``_big_packed_spec`` (gridencoder.cu:55-70).  Dense
    levels index x + S*(y + S*z) mod size; hashed ones x ^ y*P1 ^ z*P2 in
    uint32, masked to their power-of-two size, combined as int32 bit
    patterns."""
    scales, strides, sizes, n_dense = _level_tensors(spec, x01.device)
    lb, n = spec.n_big, x01.shape[0]
    cell = torch.floor(x01[None] * scales + 0.5).to(torch.int64)          # [Lb, N, 3]
    cell = torch.stack([cell, cell + 1], -1)                               # [Lb, N, 3, 2]

    def combine(a, b, c, op):
        # [.., N, 2] per axis -> [.., N, 8], corner c = b0 + 2 b1 + 4 b2
        return op(op(c[..., :, None, None], b[..., None, :, None]),
                  a[..., None, None, :]).reshape(a.shape[0], n, 8)

    parts = []
    if n_dense:
        cd, s = cell[:n_dense], strides[:n_dense]
        idx = combine(cd[:, :, 0], cd[:, :, 1] * s, cd[:, :, 2] * s * s, torch.add)
        parts.append((idx % sizes[:n_dense]).to(torch.int32))
    if n_dense < lb:
        ch = cell[n_dense:] & _U32
        h = combine(_as_i32(ch[:, :, 0]), _as_i32((ch[:, :, 1] * _PRIME_Y) & _U32),
                    _as_i32((ch[:, :, 2] * _PRIME_Z) & _U32), torch.bitwise_xor)
        parts.append(h & (sizes[n_dense:] - 1).to(torch.int32))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _chunks(n: int):
    """(chunks, points per chunk, slots per row): equal chunks of at most
    ``POINT_CAP`` points, 8 corner slots a point, rows padded to a power of
    two of at least 128 (the sort's contract)."""
    n_ch = max(1, -(-n // POINT_CAP))
    per = max(1, -(-n // n_ch))
    return n_ch, per, max(LANES, 1 << (per * 8 - 1).bit_length())


def sort_inputs(x01: torch.Tensor, spec: SplitHashSpec) -> torch.Tensor:
    """The sort's operands, [chunks * Lb, M, 2] int32 (key, payload) pairs:
    row ch * Lb + l holds chunk ch's corners at big level l, in point order,
    key = the corner's table entry, payload = p_local * 8 + corner; the
    slots past the chunk's points are (PAD_KEY, PAD_KEY)."""
    n = x01.shape[0]
    lb = spec.n_big
    n_ch, per, m = _chunks(n)
    keys = corner_keys(x01, spec).reshape(lb, n * 8)
    if n_ch * per != n:
        keys = torch.nn.functional.pad(keys, (0, (n_ch * per - n) * 8), value=PAD_KEY)
    pairs = torch.full((n_ch, lb, m, 2), PAD_KEY, dtype=torch.int32, device=x01.device)
    pairs[:, :, :per * 8, 0] = keys.view(lb, n_ch, per * 8).transpose(0, 1)
    pairs[:, :, :per * 8, 1] = torch.arange(per * 8, dtype=torch.int32, device=x01.device)
    return pairs.view(n_ch * lb, m, 2)


def sorted_pairs(x01: torch.Tensor, spec: SplitHashSpec) -> torch.Tensor:
    """``sort_inputs`` with every row sorted by key (K5, in place, on CUDA
    tensors; the plain sort on CPU tensors)."""
    pairs = sort_inputs(x01, spec)
    if pairs.device.type == "cuda":
        return sort_pairs_(pairs)
    sk, sp = bitonic_sort_plain(pairs[..., 0].contiguous(), pairs[..., 1].contiguous())
    return torch.stack([sk, sp], -1)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("hash_sorted")
    if lib.sorted_encode_forward.argtypes is None:
        head = [_P, _P, _P, _LL, _LL, _LL, _LL, ctypes.c_int, _LL, _P]
        lib.sorted_encode_forward.argtypes = head + [_P, _P]
        lib.sorted_encode_backward.argtypes = head + [ctypes.c_int, _P, _P]
        for fn in (lib.sorted_encode_forward, lib.sorted_encode_backward):
            fn.restype = ctypes.c_int
    return lib


_SCALES: dict = {}


def _scales_arg(spec: SplitHashSpec):
    """The big levels' scales as a host-array pointer, made once per spec;
    the cache keeps the array alive, and the C function copies it before it
    returns."""
    hit = _SCALES.get(id(spec))
    if hit is None or hit[0] is not spec:
        if len(_SCALES) >= 16:
            _SCALES.clear()
        arr = np.ascontiguousarray(spec.big.scales, np.float32)
        hit = (spec, arr, arr.ctypes.data_as(ctypes.c_void_p))
        _SCALES[id(spec)] = hit
    return hit[2]


def _kernel_args(x01: torch.Tensor, pairs: torch.Tensor, spec: SplitHashSpec):
    """Validate what both kernels share; returns (n, the C arguments from
    the point count to the scales)."""
    dev = x01.device
    if dev.type != "cuda":
        raise ValueError(f"the sorted-engine kernels take CUDA tensors, got {dev}")
    if spec.big is None or spec.level_dim != 2:
        raise ValueError("the sorted-engine kernels take big levels of level_dim 2")
    lb = spec.n_big
    if not 1 <= lb <= MAX_LEVELS:
        raise ValueError(f"the sorted-engine kernels take 1..{MAX_LEVELS} big levels")
    n = x01.shape[0]
    _build.check_tensor(x01, "x01", (n, 3), torch.float32, dev)
    if pairs.dim() != 3 or pairs.shape[2] != 2 or pairs.shape[0] % lb:
        raise ValueError(f"pairs must be [chunks * {lb}, M, 2], got {tuple(pairs.shape)}")
    _build.check_tensor(pairs, "pairs", tuple(pairs.shape), torch.int32, dev)
    rows, m = pairs.shape[0], pairs.shape[1]
    per = -(-n // (rows // lb))
    if m % 32 or m < 8 * per:
        raise ValueError(f"pairs rows of {m} slots do not hold {per} points of 8 corners "
                         "in whole warps")
    if pairs.numel() >= 2 ** 62 or spec.t_cap_big >= 2 ** 31:
        raise ValueError("point count or table size out of the kernels' range")
    return n, [n, per, rows, m, lb, spec.t_cap_big, _scales_arg(spec)]


def sorted_encode_forward(x01: torch.Tensor, table_big: torch.Tensor, spec: SplitHashSpec,
                          pairs: torch.Tensor, out=None) -> torch.Tensor:
    """K8: the [N, Lb*2] f32 features of the points x01 [N, 3] from the
    (key, payload) pairs (``sorted_pairs``'s, or the same pairs in any
    order).  The output is zero-filled here, or, when ``out`` is given,
    added into."""
    global SORTED_FWD_LAUNCHES
    n, args = _kernel_args(x01, pairs, spec)
    _build.check_tensor(table_big, "table_big", (spec.n_big, spec.t_cap_big, 2),
                        torch.float32, x01.device)
    shape = (n, spec.n_big * 2)
    if out is None:
        out = torch.zeros(shape, dtype=torch.float32, device=x01.device)
    _build.check_tensor(out, "out", shape, torch.float32, x01.device)
    if n == 0:
        return out
    rc = _lib().sorted_encode_forward(x01.data_ptr(), table_big.data_ptr(), pairs.data_ptr(),
                                      *args, out.data_ptr(),
                                      torch.cuda.current_stream(x01.device).cuda_stream)
    SORTED_FWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"sorted_encode_forward launch failed: cudaError {rc}")
    return out


def sorted_encode_backward(x01: torch.Tensor, grad_out: torch.Tensor, spec: SplitHashSpec,
                           pairs: torch.Tensor, grad_table=None,
                           aggregate: bool = True) -> torch.Tensor:
    """K9: the [Lb, t_cap_big, 2] f32 table gradient for the upstream
    gradient grad_out [N, Lb*2].  The gradient is zero-filled here, or, when
    ``grad_table`` is given, added into.  ``aggregate`` sums each warp's
    runs of equal keys before one atomic add per run (what the sort buys);
    without it every corner adds its own."""
    global SORTED_BWD_LAUNCHES
    n, args = _kernel_args(x01, pairs, spec)
    _build.check_tensor(grad_out, "grad_out", (n, spec.n_big * 2), torch.float32, x01.device)
    shape = (spec.n_big, spec.t_cap_big, 2)
    if grad_table is None:
        grad_table = torch.zeros(shape, dtype=torch.float32, device=x01.device)
    _build.check_tensor(grad_table, "grad_table", shape, torch.float32, x01.device)
    if n == 0:
        return grad_table
    rc = _lib().sorted_encode_backward(x01.data_ptr(), grad_out.data_ptr(), pairs.data_ptr(),
                                       *args, int(aggregate), grad_table.data_ptr(),
                                       torch.cuda.current_stream(x01.device).cuda_stream)
    SORTED_BWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"sorted_encode_backward launch failed: cudaError {rc}")
    return grad_table


class SortedEncode(torch.autograd.Function):
    """Forward K5 then K8, backward K9 on the forward's sorted pairs; the
    gradient flows to the table only (the reference's custom VJP returns
    none for x01)."""

    @staticmethod
    def forward(ctx, x01, table_big, spec):
        x01 = x01.contiguous()
        pairs = sorted_pairs(x01, spec)
        ctx.save_for_backward(x01, pairs)
        ctx.spec = spec
        return sorted_encode_forward(x01, table_big, spec, pairs)

    @staticmethod
    def backward(ctx, grad_out):
        x01, pairs = ctx.saved_tensors
        return None, sorted_encode_backward(x01, grad_out.contiguous(), ctx.spec, pairs), None


def hash_encode_sorted(x01: torch.Tensor, table_big: torch.Tensor,
                       spec: SplitHashSpec) -> torch.Tensor:
    """Big-group encode: x01 [N, 3] in [0, 1] -> [N, Lb*2], differentiable
    in table_big.  CUDA tensors launch K5, K8 (and K9 in the backward); CPU
    tensors take the plain version; any other device raises."""
    dev = table_big.device
    if dev.type == "cuda":
        return SortedEncode.apply(x01, table_big, spec)
    if dev.type == "cpu":
        return hash_encode_plain(x01, table_big, _big_packed_spec(spec))
    raise ValueError(f"no sorted hash encoding for device {dev}")


def hash_encode_split(x01: torch.Tensor, tables, spec: SplitHashSpec) -> torch.Tensor:
    """Small levels through the packed engine (K3/K4 on the card), big
    levels through the sorted engine; tables = (table_small or None,
    table_big or None).  Returns [N, L*2] in level order.

    The reference's ``chunk`` and ``use_kernels`` arguments have no
    counterpart: the tables' device chooses the kernels or the plain
    version, and each engine takes any number of points in one launch per
    direction (the sorted engine chunks inside)."""
    table_small, table_big = tables
    parts = []
    if spec.small is not None:
        parts.append(hash_encode(x01, table_small, spec.small))
    if spec.big is not None:
        parts.append(hash_encode_sorted(x01, table_big, spec))
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)

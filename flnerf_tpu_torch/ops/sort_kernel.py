"""Ascending sort of int32 keys with int32 payloads: the sort K5 as a CUDA
kernel, a segmented LSD radix sort.

Port of ``flnerf_tpu/ops/sort_pallas.py``.  ``bitonic_sort`` keeps the
reference's name and contract (``sort_pallas.py:236``): keys are ``[N]`` or
``[G, N]`` int32 and non-negative, N is a power of two and at least 128,
each row is sorted ascending, and the int32 payloads are permuted with
their keys.  The reference sorts with a bitonic network, which is not
stable; the kernel behind the name here is a radix sort, which is: equal
keys keep their input order, so its result is one exact permutation.
``variant`` chose between two TPU schedules of one network
(``_sort_kernel_v2`` and ``_sort_kernel``); both compute the same function,
so one CUDA kernel serves both.

CUDA tensors launch K5 (``radix_sort_pairs`` in ``csrc/radix_sort.cu``),
which sorts (key, payload) pairs in place.  With one payload the pair
carries it; with none or several, the pair carries the position and the
payloads are gathered through the sorted positions.  ``sort_pairs_`` is that
in-place sort for callers that build the pairs themselves (the sorted hash
engine).  The kernel's rows are its grid's y axis, at most
``MAX_GRID_ROWS`` a launch, so the wrapper sorts a taller array in blocks
of rows (``row_blocks``), one launch each.  CPU tensors take the plain
version, a stable torch sort and a gather.  ``SORT_LAUNCHES`` counts the
wrapper's calls that launch the kernel.

``key_bits`` states how many low bits of the keys the sort reads (31 by
default: any non-negative int32 key).  A caller whose real keys are all
below a bound passes ``key_bits_for(bound)``; its pads (``2^31 - 1``) have
all those bits set and still sort last.  ``radix_passes`` gives the digit
schedule the kernel runs for a width.
"""

from __future__ import annotations

import ctypes

import torch

from flnerf_tpu_torch.ops import _build

LANES = 128
MAX_N = 1 << 30
KEY_BITS = 31            # any non-negative int32 key
MAX_DIGIT_BITS = 10      # the kernel's largest digit (1024 counters a warp)
MAX_GRID_ROWS = 65535    # rows a launch: the grid's y axis (csrc/radix_sort.cu)

SORT_LAUNCHES = 0


def reset_launch_counts() -> None:
    global SORT_LAUNCHES
    SORT_LAUNCHES = 0


def key_bits_for(bound: int) -> int:
    """The key width for keys that are all < ``bound`` (pads aside):
    ``bound.bit_length()``, so the largest real key, at most ``bound - 1``,
    stays below the pad's all-ones low bits."""
    bound = int(bound)
    if bound < 1:
        raise ValueError(f"the key bound must be at least 1, got {bound}")
    bits = bound.bit_length()
    if bits > KEY_BITS:
        raise ValueError(f"keys below {bound} need {bits} bits; the sort reads at most "
                         f"{KEY_BITS}")
    return bits


def radix_passes(key_bits: int = KEY_BITS):
    """(passes, digit bits) of the kernel's LSD schedule for ``key_bits``:
    the fewest digits of at most ``MAX_DIGIT_BITS`` bits, rounded up to an
    even count so that the result lands back in the caller's buffer (20
    bits: 2 x 10; 31: 4 x 8)."""
    if not 1 <= int(key_bits) <= KEY_BITS:
        raise ValueError(f"key_bits must be in [1, {KEY_BITS}], got {key_bits}")
    passes = -(-int(key_bits) // MAX_DIGIT_BITS)
    passes += passes % 2
    return passes, -(-int(key_bits) // passes)


def _check(keys: torch.Tensor, values) -> int:
    """Validate the contract; returns N."""
    if keys.dim() not in (1, 2):
        raise ValueError(f"keys must be [N] or [G, N], got shape {tuple(keys.shape)}")
    if keys.dtype != torch.int32:
        raise ValueError(f"keys must be int32, got {keys.dtype}")
    n = keys.shape[-1]
    if n < LANES or n & (n - 1) or n > MAX_N:
        raise ValueError(f"N must be a power of two in [{LANES}, {MAX_N}], got {n}")
    for v in values:
        if v.shape != keys.shape or v.dtype != torch.int32 or v.device != keys.device:
            raise ValueError("payloads must be int32 tensors shaped like the keys, "
                             "on the keys' device")
    return n


def bitonic_sort_plain(keys: torch.Tensor, *values: torch.Tensor):
    """The plain version: (sorted keys, *payloads permuted with them), a
    stable sort."""
    _check(keys, values)
    sk, order = torch.sort(keys, dim=-1, stable=True)
    return (sk,) + tuple(torch.gather(v, -1, order) for v in values)


def _lib() -> ctypes.CDLL:
    lib = _build.load("radix_sort")
    if lib.radix_sort_pairs.argtypes is None:
        lib.radix_sort_config.restype = ctypes.c_int
        lib.radix_sort_config.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.radix_sort_pairs.restype = ctypes.c_int
        lib.radix_sort_pairs.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
    return lib


def sort_config(n: int, key_bits: int = KEY_BITS) -> dict:
    """The kernel's geometry for rows of n pairs: its passes and digit bits,
    pairs a tile, tiles a row, the scatter kernel's shared memory (bytes)
    and int32 scratch a row."""
    passes, dbits = radix_passes(key_bits)
    out = (ctypes.c_longlong * 4)()
    rc = _lib().radix_sort_config(int(n), dbits, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"no radix sort geometry for rows of {n}: cudaError {rc}")
    return {"passes": passes, "digit_bits": dbits, "tile": out[0], "tiles": out[1],
            "smem_bytes": out[2], "scratch_ints": out[3]}


def row_blocks(g: int):
    """(first row, rows) of each launch that sorts g rows: consecutive
    blocks of at most ``MAX_GRID_ROWS``."""
    return [(r, min(MAX_GRID_ROWS, g - r)) for r in range(0, int(g), MAX_GRID_ROWS)]


def _launch_rows(lib, pairs_ptr: int, scratch_ptr: int, ints_ptr: int, g: int, n: int,
                 cfg: dict, stream: int) -> None:
    """K5 on g rows of n pairs at ``pairs_ptr``, one launch per row block;
    the blocks run one after another on the stream, so they share the int32
    scratch of one block.  Raises on the first failed launch."""
    for r0, rows in row_blocks(g):
        off = r0 * n * 8                                  # bytes: n int2 pairs a row
        rc = lib.radix_sort_pairs(pairs_ptr + off, scratch_ptr + off, ints_ptr, rows, n,
                                  cfg["digit_bits"], cfg["passes"], stream)
        if rc != 0:
            raise RuntimeError(f"radix_sort_pairs launch failed on rows {r0}..{r0 + rows}: "
                               f"cudaError {rc}")


def sort_pairs_(pairs: torch.Tensor, key_bits: int = KEY_BITS) -> torch.Tensor:
    """K5 in place on CUDA (key, payload) pairs, ``[..., N, 2]`` int32 and
    contiguous (one int2 each), keys non-negative and, below ``KEY_BITS``,
    each < ``2^key_bits - 1`` or ``2^31 - 1``: each row of N pairs ends
    sorted by key, ascending and stable.  Takes a scratch copy of the pairs
    for its passes.  Returns ``pairs``."""
    global SORT_LAUNCHES
    if pairs.device.type != "cuda":
        raise ValueError(f"the sort kernel takes CUDA tensors, got {pairs.device}")
    if pairs.dim() < 2 or pairs.shape[-1] != 2 or not pairs.is_contiguous():
        raise ValueError(f"pairs must be contiguous [..., N, 2], got {tuple(pairs.shape)}")
    if pairs.data_ptr() % 16:
        raise ValueError("pairs must start on a 16-byte boundary (the kernel loads two "
                         "pairs at a time)")
    n = _check(pairs[..., 0], ())
    g = pairs.numel() // (2 * n)
    cfg = sort_config(n, key_bits)
    scratch = torch.empty_like(pairs)
    ints = torch.empty(min(g, MAX_GRID_ROWS) * cfg["scratch_ints"], dtype=torch.int32,
                       device=pairs.device)
    SORT_LAUNCHES += 1
    _launch_rows(_lib(), pairs.data_ptr(), scratch.data_ptr(), ints.data_ptr(), g, n, cfg,
                 torch.cuda.current_stream(pairs.device).cuda_stream)
    return pairs


def bitonic_sort_kernel(keys: torch.Tensor, *values: torch.Tensor, key_bits: int = KEY_BITS):
    """K5 on CUDA tensors: (sorted keys, *payloads permuted with them)."""
    if keys.device.type != "cuda":
        raise ValueError(f"the sort kernel takes CUDA tensors, got {keys.device}")
    n = _check(keys, values)
    carry = values[0] if len(values) == 1 else torch.arange(
        n, dtype=torch.int32, device=keys.device).expand(keys.shape)
    pairs = sort_pairs_(torch.stack([keys, carry], dim=-1).contiguous(), key_bits)
    sk, sp = pairs[..., 0].contiguous(), pairs[..., 1].contiguous()
    if len(values) == 1:
        return sk, sp
    return (sk,) + tuple(torch.gather(v, -1, sp.long()) for v in values)


def bitonic_sort(keys: torch.Tensor, *values: torch.Tensor, variant: int = 2,
                 key_bits: int = KEY_BITS):
    """Sort int32 keys ascending along the last axis, stably, permuting
    payloads; ``key_bits`` as ``sort_pairs_`` takes it.

    CUDA tensors launch K5, the radix sort (for either ``variant``); CPU
    tensors take the plain version; any other device raises."""
    if variant not in (1, 2):
        raise ValueError(f"variant must be 1 or 2, got {variant}")
    radix_passes(key_bits)
    dev = keys.device
    if dev.type == "cuda":
        return bitonic_sort_kernel(keys, *values, key_bits=key_bits)
    if dev.type == "cpu":
        return bitonic_sort_plain(keys, *values)
    raise ValueError(f"no sort for device {dev}")

"""Ascending sort of int32 keys with int32 payloads: the bitonic sort K5 as
a CUDA kernel.

Port of ``flnerf_tpu/ops/sort_pallas.py``.  ``bitonic_sort`` keeps the
reference's contract (``sort_pallas.py:236``): keys are ``[N]`` or ``[G, N]``
int32 and non-negative, N is a power of two and at least 128, each row is
sorted ascending (not stably), and the int32 payloads are permuted with
their keys.  ``variant`` chose between two TPU schedules of one network
(``_sort_kernel_v2`` and ``_sort_kernel``); both compute the same function,
so one CUDA kernel serves both.

CUDA tensors launch K5 (``bitonic_sort_pairs`` in ``csrc/hash_lattice.cu``),
which sorts (key, payload) pairs in place.  With one payload the pair
carries it; with none or several, the pair carries the position and the
payloads are gathered through the sorted positions.  ``sort_pairs_`` is that
in-place sort for callers that build the pairs themselves (the sorted hash
engine).  CPU tensors take the plain version, a torch sort and a gather.
``SORT_LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from flnerf_tpu_torch.ops import _build

LANES = 128
MAX_N = 1 << 30

SORT_LAUNCHES = 0


def reset_launch_counts() -> None:
    global SORT_LAUNCHES
    SORT_LAUNCHES = 0


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
    """The plain version: (sorted keys, *payloads permuted with them)."""
    _check(keys, values)
    sk, order = torch.sort(keys, dim=-1)
    return (sk,) + tuple(torch.gather(v, -1, order) for v in values)


def _lib() -> ctypes.CDLL:
    lib = _build.load("hash_lattice")
    fn = lib.bitonic_sort_pairs
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def sort_pairs_(pairs: torch.Tensor) -> torch.Tensor:
    """K5 in place on CUDA (key, payload) pairs, ``[..., N, 2]`` int32 and
    contiguous (one int2 each), keys non-negative: each row of N pairs ends
    sorted by key, ascending.  Returns ``pairs``."""
    global SORT_LAUNCHES
    if pairs.device.type != "cuda":
        raise ValueError(f"the sort kernel takes CUDA tensors, got {pairs.device}")
    if pairs.dim() < 2 or pairs.shape[-1] != 2 or not pairs.is_contiguous():
        raise ValueError(f"pairs must be contiguous [..., N, 2], got {tuple(pairs.shape)}")
    n = _check(pairs[..., 0], ())
    rc = _lib().bitonic_sort_pairs(pairs.data_ptr(), pairs.numel() // (2 * n), n,
                                   torch.cuda.current_stream(pairs.device).cuda_stream)
    SORT_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"bitonic_sort_pairs launch failed: cudaError {rc}")
    return pairs


def bitonic_sort_kernel(keys: torch.Tensor, *values: torch.Tensor):
    """K5 on CUDA tensors: (sorted keys, *payloads permuted with them)."""
    if keys.device.type != "cuda":
        raise ValueError(f"the sort kernel takes CUDA tensors, got {keys.device}")
    n = _check(keys, values)
    carry = values[0] if len(values) == 1 else torch.arange(
        n, dtype=torch.int32, device=keys.device).expand(keys.shape)
    pairs = sort_pairs_(torch.stack([keys, carry], dim=-1).contiguous())   # [..., N, 2]: int2
    sk, sp = pairs[..., 0].contiguous(), pairs[..., 1].contiguous()
    if len(values) == 1:
        return sk, sp
    return (sk,) + tuple(torch.gather(v, -1, sp.long()) for v in values)


def bitonic_sort(keys: torch.Tensor, *values: torch.Tensor, variant: int = 2):
    """Sort int32 keys ascending along the last axis, permuting payloads.

    CUDA tensors launch K5 (for either ``variant``); CPU tensors take the
    plain version; any other device raises."""
    if variant not in (1, 2):
        raise ValueError(f"variant must be 1 or 2, got {variant}")
    dev = keys.device
    if dev.type == "cuda":
        return bitonic_sort_kernel(keys, *values)
    if dev.type == "cpu":
        return bitonic_sort_plain(keys, *values)
    raise ValueError(f"no sort for device {dev}")

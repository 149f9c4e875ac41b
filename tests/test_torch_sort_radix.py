"""The radix sort K5's key widths and digit schedule (ops/sort_kernel.py),
and the key bounds the two big-table engines pass it (ops/hash_lattice.py,
ops/hash_sorted.py), on the CPU.

The kernel runs only on the card (tests/test_torch_lattice_cuda.py and
tests/test_torch_sorted_cuda.py hold it there).  Here a torch model of its
schedule, a stable sort on each digit of ``radix_passes``, least
significant first, over the low ``key_bits`` bits, is held equal to a
stable ``torch.sort``: that holds the pad trick (pads at 2^31 - 1 sort last
on fewer bits) and the pass count.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from flnerf_tpu_torch.ops import hash_lattice as hl
from flnerf_tpu_torch.ops import hash_sorted as hs
from flnerf_tpu_torch.ops import sort_kernel as sk

torch.set_num_threads(1)

FULL = dict(log2_hashmap_size=19, desired_resolution=4096)    # main_nerf -O at 2^19
SMALL = dict(num_levels=6, log2_hashmap_size=16, desired_resolution=512)
PAD = (1 << 31) - 1


def _digit_sort(keys, values, key_bits):
    """The kernel's LSD schedule in torch: one stable sort a digit."""
    passes, dbits = sk.radix_passes(key_bits)
    k, v = keys.long(), values
    for p in range(passes):
        digit = (k >> (p * dbits)) & ((1 << dbits) - 1)
        order = torch.sort(digit, dim=-1, stable=True)[1]
        k, v = torch.gather(k, -1, order), torch.gather(v, -1, order)
    return k.to(torch.int32), v


def _stable(keys, values):
    sk_, order = torch.sort(keys, dim=-1, stable=True)
    return sk_, torch.gather(values, -1, order)


def _rows(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    if kind == "pads":                # 19-bit keys, duplicates, pads spread over the row
        k = rng.integers(0, 1 << 19, shape)
        k[..., ::5] = 7
        k[..., rng.random(shape[-1]) < 0.2] = PAD
        return k, 20
    if kind == "all_equal":
        return np.full(shape, 12345), 20
    if kind == "sorted":
        return np.broadcast_to(np.arange(n) * 3, shape).copy(), 20
    if kind == "reversed":
        return np.broadcast_to((n - np.arange(n)) * 3, shape).copy(), 20
    return rng.integers(0, PAD, shape, endpoint=True), sk.KEY_BITS   # random 31-bit keys


@pytest.mark.parametrize("bound,bits", [(1, 1), (128, 8), (1 << 19, 20), ("t_cap_big", 20),
                                        ("t_big", 20), ((1 << 31) - 1, 31)],
                         ids=["1", "128", "2^19", "t_cap_big", "t_big", "2^31-1"])
def test_key_bits_for_widths(bound, bits):
    if bound == "t_cap_big":
        bound = hs.make_split_spec(**FULL).t_cap_big
    elif bound == "t_big":
        bound = hl.make_lattice_spec(**FULL).t_big
    assert sk.key_bits_for(bound) == bits
    # the largest real key stays below the pad's low bits
    assert (PAD & ((1 << bits) - 1)) > bound - 1


@pytest.mark.parametrize("call", [lambda: sk.key_bits_for(1 << 31), lambda: sk.key_bits_for(0),
                                  lambda: sk.radix_passes(32), lambda: sk.radix_passes(0),
                                  lambda: sk.bitonic_sort(torch.zeros(128, dtype=torch.int32),
                                                          key_bits=32)],
                         ids=["bound_2^31", "bound_0", "passes_32", "passes_0", "sort_32"])
def test_widths_above_31_bits_are_rejected(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("key_bits,want", [(1, (2, 1)), (8, (2, 4)), (20, (2, 10)),
                                           (21, (4, 6)), (31, (4, 8))])
def test_radix_passes(key_bits, want):
    """An even number of digits of at most 10 bits that covers the width:
    two 10-bit passes at the engines' 20 bits, four 8-bit ones at 31."""
    passes, dbits = sk.radix_passes(key_bits)
    assert (passes, dbits) == want
    assert passes % 2 == 0 and dbits <= sk.MAX_DIGIT_BITS and passes * dbits >= key_bits


def _cube_points(n=4096, seed=3):
    """Random points plus the unit cube's 8 corners and its face centres:
    x01 exactly 0 and 1 on every axis."""
    rng = np.random.default_rng(seed)
    corners = np.asarray([[(c >> d) & 1 for d in range(3)] for c in range(8)], np.float32)
    faces = np.asarray([[0.5, 0.5, 0], [0.5, 0.5, 1], [0, 0.5, 0.5], [1, 0.5, 0.5],
                        [0.5, 0, 0.5], [0.5, 1, 0.5]], np.float32)
    return torch.from_numpy(np.concatenate([corners, faces, rng.random((n, 3))]).astype(
        np.float32))


@pytest.mark.parametrize("engine", ["lattice", "sorted"])
@pytest.mark.parametrize("kw", [FULL, SMALL], ids=["full", "small"])
def test_engine_keys_stay_below_the_bound_they_pass(engine, kw):
    """The lattice's base keys stay below t_big and the sorted engine's
    corner keys below t_cap_big, x01 = 0 and 1 included, so the width each
    engine passes (20 bits at full width) orders them exactly."""
    x = _cube_points()
    if engine == "lattice":
        spec = hl.make_lattice_spec(**kw)
        keys, bound = hl.lattice_keys(x, spec), spec.t_big
    else:
        spec = hs.make_split_spec(**kw)
        keys, bound = hs.corner_keys(x, spec), spec.t_cap_big
    bits = sk.key_bits_for(bound)
    assert int(keys.min()) >= 0 and int(keys.max()) < bound
    assert (PAD & ((1 << bits) - 1)) > int(keys.max())
    if kw is FULL:
        assert bits == 20 and sk.radix_passes(bits) == (2, 10)


@pytest.mark.parametrize("kind", ["pads", "all_equal", "sorted", "reversed", "random31"])
@pytest.mark.parametrize("shape", [(128,), (3, 1024)], ids=["128", "3x1024"])
def test_digit_schedule_equals_a_stable_sort(kind, shape):
    keys, bits = _rows(kind, shape)
    keys = torch.from_numpy(np.ascontiguousarray(keys, np.int64)).to(torch.int32)
    pay = torch.arange(keys.numel(), dtype=torch.int32).reshape(keys.shape)
    want = _stable(keys, pay)
    got = _digit_sort(keys, pay, bits)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the CPU path of bitonic_sort is that stable sort, at any stated width
    plain = sk.bitonic_sort(keys, pay, key_bits=bits)
    assert torch.equal(plain[0], want[0]) and torch.equal(plain[1], want[1])


@pytest.mark.parametrize("engine", ["lattice", "sorted"])
def test_engine_orders_equal_the_digit_schedule_on_their_width(engine):
    """What each engine's sort call asks of the kernel: its own operands,
    sorted on the width it passes, equal its CPU order exactly (pads
    included)."""
    x = _cube_points(n=1500, seed=4)
    if engine == "lattice":
        spec = hl.make_lattice_spec(**SMALL)
        keys, iota = hl.lattice_sort_inputs(x, spec)
        got = _digit_sort(keys, iota, sk.key_bits_for(spec.t_big))[1]
        assert torch.equal(got, hl.lattice_sort_order(x, spec))
    else:
        spec = hs.make_split_spec(**SMALL)
        pairs = hs.sort_inputs(x, spec)
        got = _digit_sort(pairs[..., 0], pairs[..., 1], sk.key_bits_for(spec.t_cap_big))
        assert torch.equal(torch.stack(got, -1), hs.sorted_pairs(x, spec))


class _StubLib:
    """Stands in for K5's library: records each launch's pointers and
    rows, and fails the launch numbered ``fail_at``."""

    def __init__(self, fail_at=None):
        self.calls, self.fail_at = [], fail_at

    def radix_sort_pairs(self, pairs, scratch, ints, g, n, dbits, passes, stream):
        self.calls.append((pairs, scratch, ints, g, n, dbits, passes, stream))
        return 700 if len(self.calls) == self.fail_at else 0


@pytest.mark.parametrize("g,want", [(1, [(0, 1)]), (65535, [(0, 65535)]),
                                    (65536, [(0, 65535), (65535, 1)]),
                                    (2 * 65535 + 3, [(0, 65535), (65535, 65535), (131070, 3)])])
def test_row_blocks_fit_the_grid(g, want):
    """The kernel's rows are its grid's y axis (at most 65,535): a taller
    sort is cut into consecutive blocks that cover every row once."""
    assert sk.row_blocks(g) == want
    assert all(rows <= sk.MAX_GRID_ROWS for _, rows in want)


@pytest.mark.parametrize("g", [3, 65536, 200000])
def test_the_wrapper_launches_each_row_block(g):
    """One launch per block: its pairs and scratch pointers advance by the
    block's first row (n int2 pairs, 8 bytes each, a row), the int32
    scratch is shared, and the rows add up to g."""
    stub, n, cfg = _StubLib(), 128, {"digit_bits": 10, "passes": 2}
    sk._launch_rows(stub, 4096, 1 << 40, 64, g, n, cfg, 77)
    got = [((c[0] - 4096) // (n * 8), c[3]) for c in stub.calls]
    assert got == sk.row_blocks(g)
    assert all(c[1] - (1 << 40) == c[0] - 4096 for c in stub.calls)
    assert all(c[2] == 64 and c[4:] == (n, 10, 2, 77) for c in stub.calls)
    assert sum(rows for _, rows in got) == g


def test_a_failed_row_block_raises():
    stub = _StubLib(fail_at=2)
    with pytest.raises(RuntimeError, match="rows 65535..70000: cudaError 700"):
        sk._launch_rows(stub, 0, 0, 0, 70000, 256, {"digit_bits": 8, "passes": 4}, 0)
    assert len(stub.calls) == 2

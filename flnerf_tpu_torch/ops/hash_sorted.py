"""The split of the hash levels into a small group (the packed engine, K3/K4)
and a big group (the large-table engines).

Port of the spec half of ``flnerf_tpu/ops/hash_sorted.py`` (``SplitHashSpec``,
``_subset``, ``make_split_spec``, ``_big_packed_spec``).  The lattice engine
(``ops/hash_lattice.py``) reads it to route its levels.  The sorted engine
itself (``hash_encode_split``, the kernels K8/K9) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from flnerf_tpu_torch.ops.hash_encoding import HashGridSpec, make_hashgrid_spec
from flnerf_tpu_torch.ops.hash_kernel import LANES, PackedHashSpec


def _round8(x: int) -> int:
    return (int(x) + 7) // 8 * 8


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

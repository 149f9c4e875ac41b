"""Instant-NGP field: multiresolution hash encoding + tiny MLPs.

Port of ``flnerf_tpu/models/hash_ngp.py`` for its three encoding engines:
the packed (matmul) engine, the one the NGP CLI's defaults select
(``--log2_hashmap_size 15``); the lattice engine, which ``hash_engine``
``auto`` and ``lattice`` select at ``log2_hashmap_size >= 16`` (torch-ngp's
2^19, gridencoder grid.py:91); and the sorted engine (``hash_engine
sorted`` at ``log2_hashmap_size >= 16``), torch-ngp's own xor hash at that
capacity.
Parity target ngp-ours/nerf/network.py:10-194:
  * sigma net: 2 bias-free Linear layers, hidden 64, output 1+15 (sigma via
    trunc_exp + 15-dim geometric feature);
  * color net: 3 bias-free Linear layers, hidden 64, input = SH(dir, deg 4)
    ++ geo_feat, sigmoid rgb;
  * hash encoder with desired_resolution = 2048 * bound.

The encoding is ``encode_with_spec``: ``ops/hash_kernel.hash_encode`` (K3/K4
on the card) for a packed spec, ``ops/hash_lattice.lattice_encode_split``
(K3/K4 for the small levels, K6/K7 for the big ones) for a lattice spec,
``ops/hash_sorted.hash_encode_split`` (K3/K4 for the small levels, K5/K8/K9
for the big ones) for a split spec.
The MLP weights keep the reference's [in, out] layout, so
``core/convert.py`` carries them across unchanged.

bf16: the reference multiplies bf16 by bf16 into f32
(``preferred_element_type``), where ``torch.matmul`` on bf16 would round its
output to bf16.  ``mlp_chain`` therefore rounds the operands to the compute
type and multiplies them in f32: the products of bf16 values are exact in
f32, so each layer's output is rounded where the reference rounds it and
nowhere else.  The gradients round to bf16 at the same casts.

Not ported yet (raises ``NotImplementedError``): the background env-map
(``bg_radius > 0``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from flnerf_tpu_torch.ops.activations import trunc_exp
from flnerf_tpu_torch.ops.hash_kernel import (
    PackedHashSpec,
    hash_encode,
    init_packed_table,
    make_packed_spec,
)
from flnerf_tpu_torch.ops.hash_lattice import (
    LatticeSpec,
    init_lattice_tables,
    lattice_encode_split,
    make_lattice_spec,
)
from flnerf_tpu_torch.ops.hash_sorted import (
    SplitHashSpec,
    hash_encode_split,
    init_split_table,
    make_split_spec,
)
from flnerf_tpu_torch.ops.sh_encoding import sh_encode

NGP_BACKLOG = "is not ported yet; it is queued in ROADMAP.md's NGP backlog"


class NGPConfig(NamedTuple):
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    # 2^15 and below run the packed engine (K3/K4); 2^16 and above select
    # the lattice engine ('auto', 'lattice') or the sorted engine ('sorted')
    log2_hashmap_size: int = 15
    split_min_size: int = 1 << 15
    hash_engine: str = "auto"
    desired_resolution: int = 2048  # x bound
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    sh_degree: int = 4
    bound: float = 1.0
    density_scale: float = 1.0
    # kept so configs carry across; the port dispatches the encoding by
    # device (CUDA: the kernels, CPU: the plain version)
    hash_backend: str = "auto"
    hash_chunk: int = 2048
    # background model (network.py:66-93): not ported, must stay 0
    bg_radius: float = 0.0
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    bg_levels: int = 4
    bg_log2_hashmap_size: int = 15
    bg_resolution: int = 2048


def make_ngp_spec(cfg: NGPConfig):
    """The reference's engine choice: a ``PackedHashSpec`` up to 2^15 tables
    (and for 'matmul'); at 2^16 and above a ``LatticeSpec`` for 'auto' and
    'lattice', a ``SplitHashSpec`` for 'sorted'."""
    if cfg.hash_engine not in ("auto", "matmul", "sorted", "lattice"):
        raise ValueError(f"unknown hash_engine {cfg.hash_engine!r} "
                         "(auto|matmul|sorted|lattice)")
    if cfg.log2_hashmap_size < 16 and cfg.hash_engine in ("sorted", "lattice"):
        raise ValueError(
            f"hash_engine={cfg.hash_engine!r} needs log2_hashmap_size >= "
            f"16 (got {cfg.log2_hashmap_size}); the matmul path is "
            "cheaper below that and is selected by 'auto'")
    if cfg.log2_hashmap_size >= 16 and cfg.hash_engine != "matmul":
        # 'auto' resolves to the lattice engine, as in the reference
        make = make_split_spec if cfg.hash_engine == "sorted" else make_lattice_spec
        return make(
            num_levels=cfg.num_levels,
            level_dim=cfg.level_dim,
            base_resolution=cfg.base_resolution,
            log2_hashmap_size=cfg.log2_hashmap_size,
            desired_resolution=int(cfg.desired_resolution * cfg.bound),
            split_min_size=cfg.split_min_size,
        )
    return make_packed_spec(
        num_levels=cfg.num_levels,
        level_dim=cfg.level_dim,
        base_resolution=cfg.base_resolution,
        log2_hashmap_size=cfg.log2_hashmap_size,
        desired_resolution=int(cfg.desired_resolution * cfg.bound),
    )


def engine_kind(spec) -> str:
    """The engine a spec selects: "packed", "lattice" or "sorted"."""
    if isinstance(spec, LatticeSpec):
        return "lattice"
    return "sorted" if isinstance(spec, SplitHashSpec) else "packed"


def init_ngp_table(spec, generator=None, device="cpu"):
    """Table parameters for any spec kind: (table_small or None, table_big)
    for a lattice or split spec, the [L, T_cap, C] table for a packed one."""
    if isinstance(spec, LatticeSpec):
        return init_lattice_tables(spec, generator, device)
    if isinstance(spec, SplitHashSpec):
        return init_split_table(spec, generator, device)
    return init_packed_table(spec, generator, device)


def encode_with_spec(x01: torch.Tensor, table, spec) -> torch.Tensor:
    """x01 [N, 3] -> [N, L*C] features over the spec kind: the one place
    the field routes its encoding through."""
    if isinstance(spec, LatticeSpec):
        return lattice_encode_split(x01, table, spec)
    if isinstance(spec, SplitHashSpec):
        return hash_encode_split(x01, table, spec)
    return hash_encode(x01, table, spec)


def mlp_chain(x: torch.Tensor, layers, compute_dtype) -> torch.Tensor:
    """Bias-free relu MLP: operands rounded to ``compute_dtype``, products
    summed in f32 (the reference's bf16 x bf16 -> f32 dot).  Returns f32."""
    h = x.to(compute_dtype)
    for i, w in enumerate(layers):
        h = torch.matmul(h.float(), w.to(compute_dtype).float())
        if i != len(layers) - 1:
            h = torch.relu(h).to(compute_dtype)
    return h


def _linear_nobias(fan_in: int, fan_out: int, generator, device) -> nn.Parameter:
    bound = 1.0 / np.sqrt(fan_in)
    w = torch.rand((fan_in, fan_out), generator=generator, device=device)
    return nn.Parameter(w * (2 * bound) - bound)


class NGPField(nn.Module):
    """The field: the hash table(s), ``sigma_net`` and ``color_net`` as
    lists of [in, out] weights.  A packed spec holds ``table`` [L, T_cap,
    C]; a lattice or split spec holds ``table_small`` (None without small
    levels) and ``table_big``, in the reference's tuple order.  Parameters
    are drawn from ``generator`` (torch's stream, not the reference's);
    tests carry weights across."""

    def __init__(self, cfg: NGPConfig, compute_dtype=torch.bfloat16,
                 generator=None, device="cpu"):
        super().__init__()
        if cfg.bg_radius > 0:
            raise NotImplementedError(f"the background env-map (bg_radius > 0) {NGP_BACKLOG}")
        self.cfg = cfg
        self.spec = make_ngp_spec(cfg)
        self.compute_dtype = compute_dtype
        table = init_ngp_table(self.spec, generator, device)
        if engine_kind(self.spec) != "packed":
            ts, tb = table
            self.table_small = None if ts is None else nn.Parameter(ts)
            self.table_big = nn.Parameter(tb)
        else:
            self.table = nn.Parameter(table)
        dims = [self.spec.output_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1) + [
            1 + cfg.geo_feat_dim]
        self.sigma_net = nn.ParameterList(
            [_linear_nobias(a, b, generator, device) for a, b in zip(dims, dims[1:])])
        dims = [cfg.sh_degree ** 2 + cfg.geo_feat_dim] + [cfg.hidden_dim_color] * (
            cfg.num_layers_color - 1) + [3]
        self.color_net = nn.ParameterList(
            [_linear_nobias(a, b, generator, device) for a, b in zip(dims, dims[1:])])

    @property
    def tables(self):
        """The encoding's table argument: (table_small, table_big) for a
        lattice or split spec, ``table`` for a packed one."""
        if engine_kind(self.spec) != "packed":
            return self.table_small, self.table_big
        return self.table

    @property
    def device(self) -> torch.device:
        return self.sigma_net[0].device

    def unit_points(self, x: torch.Tensor) -> torch.Tensor:
        """World points [..., 3] -> the encoding's input, [N, 3] in [0, 1]."""
        return torch.clamp((x.reshape(-1, 3) / self.cfg.bound + 1.0) * 0.5, 0.0, 1.0)

    def density(self, x: torch.Tensor):
        """x in [-bound, bound]^3 [..., 3] -> (sigma [...], geo_feat [..., F])."""
        sh = x.shape[:-1]
        enc = encode_with_spec(self.unit_points(x), self.tables, self.spec)
        h = mlp_chain(enc, self.sigma_net, self.compute_dtype)
        sigma = trunc_exp(h[..., 0])
        return sigma.reshape(sh), h[..., 1:].reshape(*sh, -1)

    def color(self, d: torch.Tensor, geo_feat: torch.Tensor) -> torch.Tensor:
        """Unit dirs d [..., 3] + geo features -> rgb [..., 3] in [0, 1]."""
        h = torch.cat([sh_encode(d, self.cfg.sh_degree), geo_feat], dim=-1)
        return torch.sigmoid(mlp_chain(h, self.color_net, self.compute_dtype))

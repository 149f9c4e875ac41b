"""Instant-NGP field: multiresolution hash encoding + tiny MLPs.

Port of ``flnerf_tpu/models/hash_ngp.py`` for the packed (matmul) engine,
the one the NGP CLI's defaults select (``--log2_hashmap_size 15``).
Parity target ngp-ours/nerf/network.py:10-194:
  * sigma net: 2 bias-free Linear layers, hidden 64, output 1+15 (sigma via
    trunc_exp + 15-dim geometric feature);
  * color net: 3 bias-free Linear layers, hidden 64, input = SH(dir, deg 4)
    ++ geo_feat, sigmoid rgb;
  * hash encoder with desired_resolution = 2048 * bound.

The encoding is ``ops/hash_kernel.hash_encode`` (K3/K4 on the card).  The
MLP weights keep the reference's [in, out] layout, so ``core/convert.py``
carries them across unchanged.

bf16: the reference multiplies bf16 by bf16 into f32
(``preferred_element_type``), where ``torch.matmul`` on bf16 would round its
output to bf16.  ``mlp_chain`` therefore rounds the operands to the compute
type and multiplies them in f32: the products of bf16 values are exact in
f32, so each layer's output is rounded where the reference rounds it and
nowhere else.  The gradients round to bf16 at the same casts.

Not ported yet (each raises ``NotImplementedError``): the big-table engines
(``hash_engine`` lattice and sorted, log2_hashmap_size >= 16) and the
background env-map (``bg_radius > 0``).
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
from flnerf_tpu_torch.ops.sh_encoding import sh_encode

LATTICE_SLICE = ("is not ported yet; it is queued as slice 3 of the port "
                 "(ROADMAP.md: the lattice engine at 2^19, K6/K7)")
SORTED_SLICE = ("is not ported yet; it is queued as slice 4 of the port "
                "(ROADMAP.md: the sorted engine, K5/K8/K9)")
NGP_BACKLOG = "is not ported yet; it is queued in ROADMAP.md's NGP backlog"


class NGPConfig(NamedTuple):
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    # 2^15 and below run the packed engine (K3/K4); 2^16 and above select
    # the lattice or sorted engines, not ported yet
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


def make_ngp_spec(cfg: NGPConfig) -> PackedHashSpec:
    """The packed spec; the reference's engine choice, with the engines not
    ported yet raising."""
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
        if cfg.hash_engine == "sorted":
            raise NotImplementedError(f"the sorted hash engine {SORTED_SLICE}")
        raise NotImplementedError(
            f"the lattice hash engine (log2_hashmap_size >= 16, "
            f"hash_engine={cfg.hash_engine!r}) {LATTICE_SLICE}")
    return make_packed_spec(
        num_levels=cfg.num_levels,
        level_dim=cfg.level_dim,
        base_resolution=cfg.base_resolution,
        log2_hashmap_size=cfg.log2_hashmap_size,
        desired_resolution=int(cfg.desired_resolution * cfg.bound),
    )


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
    """The field: ``table`` [L, T_cap, C], ``sigma_net`` and ``color_net``
    as lists of [in, out] weights.  Parameters are drawn from ``generator``
    (torch's stream, not the reference's); tests carry weights across."""

    def __init__(self, cfg: NGPConfig, compute_dtype=torch.bfloat16,
                 generator=None, device="cpu"):
        super().__init__()
        if cfg.bg_radius > 0:
            raise NotImplementedError(f"the background env-map (bg_radius > 0) {NGP_BACKLOG}")
        self.cfg = cfg
        self.spec = make_ngp_spec(cfg)
        self.compute_dtype = compute_dtype
        self.table = nn.Parameter(init_packed_table(self.spec, generator, device))
        dims = [self.spec.output_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1) + [
            1 + cfg.geo_feat_dim]
        self.sigma_net = nn.ParameterList(
            [_linear_nobias(a, b, generator, device) for a, b in zip(dims, dims[1:])])
        dims = [cfg.sh_degree ** 2 + cfg.geo_feat_dim] + [cfg.hidden_dim_color] * (
            cfg.num_layers_color - 1) + [3]
        self.color_net = nn.ParameterList(
            [_linear_nobias(a, b, generator, device) for a, b in zip(dims, dims[1:])])

    def unit_points(self, x: torch.Tensor) -> torch.Tensor:
        """World points [..., 3] -> the encoding's input, [N, 3] in [0, 1]."""
        return torch.clamp((x.reshape(-1, 3) / self.cfg.bound + 1.0) * 0.5, 0.0, 1.0)

    def density(self, x: torch.Tensor):
        """x in [-bound, bound]^3 [..., 3] -> (sigma [...], geo_feat [..., F])."""
        sh = x.shape[:-1]
        enc = hash_encode(self.unit_points(x), self.table, self.spec)
        h = mlp_chain(enc, self.sigma_net, self.compute_dtype)
        sigma = trunc_exp(h[..., 0])
        return sigma.reshape(sh), h[..., 1:].reshape(*sh, -1)

    def color(self, d: torch.Tensor, geo_feat: torch.Tensor) -> torch.Tensor:
        """Unit dirs d [..., 3] + geo features -> rgb [..., 3] in [0, 1]."""
        h = torch.cat([sh_encode(d, self.cfg.sh_degree), geo_feat], dim=-1)
        return torch.sigmoid(mlp_chain(h, self.color_net, self.compute_dtype))

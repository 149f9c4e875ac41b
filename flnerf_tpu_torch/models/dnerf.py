"""D-NeRF fields: time-conditioned fields over the hash grid.

Port of ``flnerf_tpu/models/dnerf.py``, its three variants as modules with
``density(x, t) -> (sigma, geo)`` and ``color(d, geo) -> rgb``, the field
interface ``train/ngp_trainer.py`` drives with ``time_dependent=True``:

  * ``deform`` (ngp-ours/dnerf/network.py:10-123): a bias-free MLP on
    freq(x, 10) ++ freq(t, 6) gives dx; the canonical ``NGPField`` is
    queried at clamp(x + dx, -bound, bound);
  * ``basis`` (dnerf/network_basis.py): a time MLP gives a sigma basis and
    a colour basis; sigma = trunc_exp(h[:SB] . sigma_basis(t)) and rgb =
    sigmoid(reshape(colour net, [3, CB]) . colour_basis(t)).  ``geo``
    carries the colour basis from ``density`` to ``color``, so it is
    geo_feat_dim + CB wide;
  * ``hyper`` (dnerf/network_hyper.py): a time MLP gives ambient
    coordinates, tanh * bound, appended to x; a (3 + A)-D hash grid encodes
    the lifted point through the plain ``ops/hash_encoding.hash_encode``
    (the reference's plain JAX encode: no kernel of either package).

The ``deform`` canonical field and the ``basis`` table encode through
``models/hash_ngp.encode_with_spec``: K3/K4 on the card for the packed spec
the D-NeRF CLI builds.  K3's backward gives the table its gradient and the
points none, as the reference's TPU kernel does (``hash_encode_pallas``'s
VJP), so on the card the ``deform`` MLP is trained by no gradient through
the encoding; on the CPU the plain version differentiates the points too,
as the reference's ``hash_encode_xla`` does (ROADMAP.md R7).

Every MLP is ``models/hash_ngp.mlp_chain`` (bf16-rounded operands, f32
products); parameters are [in, out] weights drawn from a ``torch.Generator``
(not the reference's stream: tests carry weights across with
``core/convert.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from flnerf_tpu_torch.models.hash_ngp import (
    NGPConfig,
    NGPField,
    _linear_nobias,
    encode_with_spec,
    make_ngp_spec,
    mlp_chain,
    register_tables,
    registered_tables,
)
from flnerf_tpu_torch.models.nerf_mlp import embed_fn, embedder_out_dim
from flnerf_tpu_torch.ops.activations import trunc_exp
from flnerf_tpu_torch.ops.hash_encoding import hash_encode, make_hashgrid_spec
from flnerf_tpu_torch.ops.sh_encoding import sh_encode


class DNeRFConfig(NamedTuple):
    ngp: NGPConfig = NGPConfig()
    num_layers_deform: int = 5
    hidden_dim_deform: int = 128
    deform_multires: int = 10
    time_multires: int = 6
    variant: str = "deform"        # 'deform' | 'basis' | 'hyper'
    sigma_basis_dim: int = 32      # basis variant (network_basis.py:23-24)
    color_basis_dim: int = 8
    num_layers_basis: int = 5
    hidden_dim_basis: int = 128
    ambient_dim: int = 1           # hyper variant (network_hyper.py:25)
    num_layers_ambient: int = 5
    hidden_dim_ambient: int = 128


def _mlp(dims, generator, device) -> nn.ParameterList:
    """Bias-free [in, out] weights, U(-1/sqrt(in), 1/sqrt(in))."""
    return nn.ParameterList([_linear_nobias(a, b, generator, device)
                             for a, b in zip(dims, dims[1:])])


class DNeRFBase(nn.Module):
    """What the three variants share: the config, the compute type, the
    time MLP's input width and the device."""

    variant = ""

    def __init__(self, cfg: DNeRFConfig, compute_dtype):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.t_in = embedder_out_dim(cfg.time_multires, 1)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def time_mlp(self, t: torch.Tensor, net) -> torch.Tensor:
        """freq(t) of the per-point times [..] through ``net`` -> [N, out]."""
        return mlp_chain(embed_fn(t.reshape(-1, 1), self.cfg.time_multires), net,
                         self.compute_dtype)

    def sh_color_mlp(self, d: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        """SH(d) ++ feat [N, F] through the colour net -> [N, out] f32."""
        enc = sh_encode(d.reshape(-1, 3), self.cfg.ngp.sh_degree)
        return mlp_chain(torch.cat([enc, feat], dim=-1), self.color_net, self.compute_dtype)


class DNeRFField(DNeRFBase):
    """``deform``: a canonical ``NGPField`` and ``deform_net`` (parameters
    in that order: the canonical tables, sigma and colour nets, then the
    deform net)."""

    variant = "deform"

    def __init__(self, cfg: DNeRFConfig, compute_dtype=torch.bfloat16, generator=None,
                 device="cpu"):
        super().__init__(cfg, compute_dtype)
        self.canonical = NGPField(cfg.ngp, compute_dtype, generator, device)
        dims = ([embedder_out_dim(cfg.deform_multires, 3) + self.t_in]
                + [cfg.hidden_dim_deform] * (cfg.num_layers_deform - 1) + [3])
        self.deform_net = _mlp(dims, generator, device)

    def deform(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """dx for points x [..., 3] at times t [..., 1]."""
        h = torch.cat([embed_fn(x, self.cfg.deform_multires),
                       embed_fn(t, self.cfg.time_multires)], dim=-1)
        return mlp_chain(h, self.deform_net, self.compute_dtype)

    def density(self, x: torch.Tensor, t: torch.Tensor):
        b = self.cfg.ngp.bound
        x_canon = torch.clamp(x + self.deform(x, t[..., None]), -b, b)
        return self.canonical.density(x_canon)

    def color(self, d: torch.Tensor, geo: torch.Tensor) -> torch.Tensor:
        return self.canonical.color(d, geo)


class DNeRFBasisField(DNeRFBase):
    """``basis``: the hash table(s) of the NGP spec, ``basis_net``,
    ``sigma_net`` (2 layers, -> SB + geo_feat_dim) and ``color_net`` (3
    layers, -> 3 * CB), in that order."""

    variant = "basis"

    def __init__(self, cfg: DNeRFConfig, compute_dtype=torch.bfloat16, generator=None,
                 device="cpu"):
        super().__init__(cfg, compute_dtype)
        n = cfg.ngp
        self.spec = make_ngp_spec(n)
        sb, cb = cfg.sigma_basis_dim, cfg.color_basis_dim
        register_tables(self, self.spec, generator, device)
        self.basis_net = _mlp([self.t_in] + [cfg.hidden_dim_basis] * (cfg.num_layers_basis - 1)
                              + [sb + cb], generator, device)
        self.sigma_net = _mlp([self.spec.output_dim, n.hidden_dim, sb + n.geo_feat_dim],
                              generator, device)
        self.color_net = _mlp([n.sh_degree ** 2 + n.geo_feat_dim, n.hidden_dim_color,
                               n.hidden_dim_color, 3 * cb], generator, device)

    @property
    def tables(self):
        return registered_tables(self, self.spec)

    def density(self, x: torch.Tensor, t: torch.Tensor):
        sh = x.shape[:-1]
        sb = self.cfg.sigma_basis_dim
        x01 = torch.clamp((x.reshape(-1, 3) / self.cfg.ngp.bound + 1.0) * 0.5, 0.0, 1.0)
        h = mlp_chain(encode_with_spec(x01, self.tables, self.spec), self.sigma_net,
                      self.compute_dtype)                              # [N, SB + F]
        bases = self.time_mlp(t, self.basis_net)                       # [N, SB + CB]
        sigma = trunc_exp(torch.sum(h[:, :sb] * bases[:, :sb], dim=-1))
        geo = torch.cat([h[:, sb:], bases[:, sb:]], dim=-1)            # carries the colour basis
        return sigma.reshape(sh), geo.reshape(*sh, -1)

    def color(self, d: torch.Tensor, geo: torch.Tensor) -> torch.Tensor:
        sh = d.shape[:-1]
        f, cb = self.cfg.ngp.geo_feat_dim, self.cfg.color_basis_dim
        geo = geo.reshape(-1, geo.shape[-1])
        h = self.sh_color_mlp(d, geo[:, :f])                           # [N, 3 * CB]
        rgb = torch.sigmoid(torch.sum(h.reshape(-1, 3, cb) * geo[:, None, f:], dim=-1))
        return rgb.reshape(*sh, 3)


def make_hyper_spec(cfg: DNeRFConfig):
    """The (3 + ambient_dim)-D hash grid of the ``hyper`` variant."""
    n = cfg.ngp
    return make_hashgrid_spec(
        num_levels=n.num_levels, level_dim=n.level_dim, base_resolution=n.base_resolution,
        log2_hashmap_size=n.log2_hashmap_size,
        desired_resolution=int(n.desired_resolution * n.bound),
        input_dim=3 + cfg.ambient_dim)


class DNeRFHyperField(DNeRFBase):
    """``hyper``: ``table`` [T, C] (the natural layout of
    ``ops/hash_encoding``), ``ambient_net``, ``sigma_net`` (2 layers, -> 1 +
    geo_feat_dim) and ``color_net`` (3 layers, -> 3), in that order."""

    variant = "hyper"

    def __init__(self, cfg: DNeRFConfig, compute_dtype=torch.bfloat16, generator=None,
                 device="cpu"):
        super().__init__(cfg, compute_dtype)
        n = cfg.ngp
        self.spec = make_hyper_spec(cfg)
        t = torch.rand((self.spec.table_size, self.spec.level_dim), generator=generator,
                       device=device)
        self.table = nn.Parameter(t * 2e-4 - 1e-4)       # U(-1e-4, 1e-4), init_hashgrid
        self.ambient_net = _mlp([self.t_in] + [cfg.hidden_dim_ambient]
                                * (cfg.num_layers_ambient - 1) + [cfg.ambient_dim],
                                generator, device)
        self.sigma_net = _mlp([self.spec.output_dim, n.hidden_dim, 1 + n.geo_feat_dim],
                              generator, device)
        self.color_net = _mlp([n.sh_degree ** 2 + n.geo_feat_dim, n.hidden_dim_color,
                               n.hidden_dim_color, 3], generator, device)

    def density(self, x: torch.Tensor, t: torch.Tensor):
        sh = x.shape[:-1]
        b = self.cfg.ngp.bound
        amb = torch.tanh(self.time_mlp(t, self.ambient_net)) * b       # [N, A]
        lifted = torch.cat([x.reshape(-1, 3), amb], dim=-1)
        x01 = torch.clamp((lifted / b + 1.0) * 0.5, 0.0, 1.0)
        h = mlp_chain(hash_encode(x01, self.table, self.spec), self.sigma_net,
                      self.compute_dtype)
        return trunc_exp(h[:, 0]).reshape(sh), h[:, 1:].reshape(*sh, -1)

    def color(self, d: torch.Tensor, geo: torch.Tensor) -> torch.Tensor:
        h = self.sh_color_mlp(d, geo.reshape(-1, geo.shape[-1]))
        return torch.sigmoid(h).reshape(*d.shape[:-1], 3)


VARIANTS = {"deform": DNeRFField, "basis": DNeRFBasisField, "hyper": DNeRFHyperField}


def make_dnerf_variant_field(cfg: DNeRFConfig, compute_dtype=torch.bfloat16, generator=None,
                             device="cpu") -> DNeRFBase:
    """The field of ``cfg.variant``; any other name is the ``deform``
    field, as the reference dispatches."""
    return VARIANTS.get(cfg.variant, DNeRFField)(cfg, compute_dtype, generator, device)

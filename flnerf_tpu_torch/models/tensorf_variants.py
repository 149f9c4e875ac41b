"""TensoRF variants: CP decomposition and CCNeRF rank-residual composition.

Port of ``flnerf_tpu/models/tensorf_variants.py``.  Parity targets:
  * CP (ngp-ours/tensoRF/network_cp.py): pure line factorization,
    sigma = trunc_exp(sum_r prod_axis line_axis[r](x_axis)); colour features
    likewise from line products through the basis product.
  * CCNeRF (ngp-ours/tensoRF/network_cc.py:14-128): ranks are partitioned
    into K residual groups (rank_vec/rank_mat prefix lists); truncation
    level k uses only the first k groups' ranks, so one trained model serves
    K quality levels.  ``CCNeRFField.level`` (1..K, -1 for K) selects the
    level the field answers at: the reference swaps per-level
    ``density_fn``/``rgb_fn`` over shared parameters, the port sets the
    attribute and keeps the parameters.
  * Composition (network_cc.py:274-335, :552): finalized objects, each in
    its own rigid frame, baked into one field; the scene density is the sum
    of the objects' densities, the colour a softmax blend (over the objects'
    densities) of their pre-sigmoid logits.

All three reuse the TensoRF colour head (``models/tensorf.color_logits``)
and plug into the NGP trainer as fields.  No TPU kernel lies on this path.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from flnerf_tpu_torch.models.tensorf import (
    MAT_IDS,
    VEC_IDS,
    basis_product,
    color_in_dim,
    color_logits,
    init_color_net,
    normal_param,
    register_tree,
    sample_line,
    sample_plane,
    uniform_param,
)
from flnerf_tpu_torch.ops.activations import trunc_exp


# ---------------------------------------------------------------------------
# CP decomposition
# ---------------------------------------------------------------------------

class CPConfig(NamedTuple):
    resolution: Tuple[int, int, int] = (256, 256, 256)
    sigma_rank: int = 32
    color_rank: int = 32
    color_feat_dim: int = 27
    num_layers: int = 3
    hidden_dim: int = 128
    feat_multires: int = 2
    dir_multires: int = 2
    bound: float = 1.0


def cp_features(lines, x01: torch.Tensor) -> torch.Tensor:
    """Product over the axes of per-axis line samples -> [N, R]."""
    f = sample_line(lines[0], x01[:, 0])
    f = f * sample_line(lines[1], x01[:, 1])
    return f * sample_line(lines[2], x01[:, 2])


class CPField(nn.Module):
    """The CP field (``make_cp_field``): ``sigma_lines`` and ``color_lines``
    (3 x [R, res]), ``basis`` [R, C], ``color_net``."""

    def __init__(self, cfg: CPConfig, compute_dtype=torch.bfloat16, generator=None,
                 device="cpu", params=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        if params is None:
            params = {k: [normal_param((rank, cfg.resolution[ax]), 0.2, generator, device)
                          for ax in range(3)]
                      for k, rank in (("sigma_lines", cfg.sigma_rank),
                                      ("color_lines", cfg.color_rank))}
            params["basis"] = uniform_param((cfg.color_rank, cfg.color_feat_dim),
                                            1.0 / np.sqrt(cfg.color_rank), generator, device)
            params["color_net"] = init_color_net(color_in_dim(cfg), cfg.num_layers,
                                                 cfg.hidden_dim, generator, device)
        register_tree(self, params)

    @property
    def device(self) -> torch.device:
        return self.basis.device

    def density(self, x: torch.Tensor):
        sh = x.shape[:-1]
        x01 = torch.clamp(x.reshape(-1, 3) / self.cfg.bound, -1.0, 1.0)
        sigma = trunc_exp(torch.sum(cp_features(self.sigma_lines, x01), -1))
        feat = basis_product(cp_features(self.color_lines, x01), self.basis,
                             self.compute_dtype)
        return sigma.reshape(sh), feat.reshape(*sh, self.cfg.color_feat_dim)

    def color(self, d: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = color_logits(self.color_net, d, feat, cfg.feat_multires, cfg.dir_multires,
                         self.compute_dtype)
        return torch.sigmoid(h).reshape(*d.shape[:-1], 3)


# ---------------------------------------------------------------------------
# CCNeRF rank-residual composition
# ---------------------------------------------------------------------------

class CCNeRFConfig(NamedTuple):
    resolution: Tuple[int, int, int] = (128, 128, 128)
    # prefix rank lists (network_cc.py:21-24 style); level k uses ranks[:k]
    rank_vec_density: Tuple[int, ...] = (16, 32, 48)
    rank_mat_density: Tuple[int, ...] = (4, 8, 12)
    rank_vec: Tuple[int, ...] = (16, 32, 48)
    rank_mat: Tuple[int, ...] = (4, 8, 12)
    color_feat_dim: int = 27
    num_layers: int = 3
    hidden_dim: int = 64
    feat_multires: int = 2
    dir_multires: int = 2
    bound: float = 1.0

    @property
    def K(self) -> int:
        return len(self.rank_vec)


def _rank_mask(total: int, active: int, device) -> torch.Tensor:
    """[total] 0/1 mask keeping the first ``active`` ranks."""
    return (torch.arange(total, device=device) < active).to(torch.float32)


def _line_product(lines, x01: torch.Tensor) -> torch.Tensor:
    """The three per-axis line factors of each rank, multiplied
    (network_cc.py:158-160), each sampled at its VEC_IDS axis."""
    return (sample_line(lines[0], x01[:, VEC_IDS[0]])
            * sample_line(lines[1], x01[:, VEC_IDS[1]])
            * sample_line(lines[2], x01[:, VEC_IDS[2]]))


class CCNeRFField(nn.Module):
    """The CCNeRF field (``init_ccnerf``, ``ccnerf_density``): plane x line
    (``*_mat``, ``*_mat_line``) and line-product (``*_vec``) factors at the
    full ranks, the density scales ``sigma_vec_scale`` and
    ``sigma_mat_scale`` (ones), ``basis`` [Rv + 3 Rm, C] and ``color_net``.
    ``level`` (1..K; -1 for K) truncates the ranks of ``density``."""

    def __init__(self, cfg: CCNeRFConfig, compute_dtype=torch.bfloat16, generator=None,
                 device="cpu", params=None, level: int = -1):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        if params is None:
            params = {}
            for kind, r_mat, r_vec in (
                    ("sigma", cfg.rank_mat_density[-1], cfg.rank_vec_density[-1]),
                    ("color", cfg.rank_mat[-1], cfg.rank_vec[-1])):
                res = cfg.resolution
                params[f"{kind}_mat"] = [
                    normal_param((r_mat, res[MAT_IDS[i][1]], res[MAT_IDS[i][0]]), 0.2,
                                 generator, device) for i in range(3)]
                params[f"{kind}_mat_line"] = [
                    normal_param((r_mat, res[VEC_IDS[i]]), 0.2, generator, device)
                    for i in range(3)]
                params[f"{kind}_vec"] = [
                    normal_param((r_vec, res[VEC_IDS[i]]), 0.2, generator, device)
                    for i in range(3)]
            params["sigma_vec_scale"] = torch.ones((cfg.rank_vec_density[-1],), device=device)
            params["sigma_mat_scale"] = [torch.ones((cfg.rank_mat_density[-1],), device=device)
                                         for _ in range(3)]
            # CP ranks contribute one product feature each
            total = cfg.rank_vec[-1] + 3 * cfg.rank_mat[-1]
            params["basis"] = uniform_param((total, cfg.color_feat_dim),
                                            1.0 / np.sqrt(total), generator, device)
            params["color_net"] = init_color_net(color_in_dim(cfg), cfg.num_layers,
                                                 cfg.hidden_dim, generator, device)
        register_tree(self, params)
        self.level = level

    @property
    def level(self) -> int:
        return self._level

    @level.setter
    def level(self, level: int) -> None:
        level = int(level)
        if level < 0:
            level = self.cfg.K
        if not 1 <= level <= self.cfg.K:
            raise ValueError(
                f"truncation level must be in 1..K={self.cfg.K} (1-based; -1 for "
                f"full K), got {level}")
        self._level = level

    @property
    def device(self) -> torch.device:
        return self.basis.device

    def density_at(self, x: torch.Tensor, level: int):
        """Density + colour feature at truncation ``level`` (1..K): only the
        first rank_*[level-1] ranks contribute (compute_features,
        :128-160)."""
        cfg, dev = self.cfg, self.basis.device
        sh = x.shape[:-1]
        x01 = torch.clamp(x.reshape(-1, 3) / cfg.bound, -1.0, 1.0)

        mvd = _rank_mask(cfg.rank_vec_density[-1], cfg.rank_vec_density[level - 1], dev)
        mmd = _rank_mask(cfg.rank_mat_density[-1], cfg.rank_mat_density[level - 1], dev)
        vfd = _line_product(self.sigma_vec, x01)
        sig = torch.sum(self.sigma_vec_scale * vfd * mvd, -1)
        for i in range(3):
            m0, m1 = MAT_IDS[i]
            pf = sample_plane(self.sigma_mat[i], x01[:, m0], x01[:, m1])
            lf = sample_line(self.sigma_mat_line[i], x01[:, VEC_IDS[i]])
            sig = sig + torch.sum(self.sigma_mat_scale[i] * pf * lf * mmd, -1)
        sigma = trunc_exp(sig)

        mv = _rank_mask(cfg.rank_vec[-1], cfg.rank_vec[level - 1], dev)
        mm = _rank_mask(cfg.rank_mat[-1], cfg.rank_mat[level - 1], dev)
        feats = [_line_product(self.color_vec, x01) * mv]
        for i in range(3):
            m0, m1 = MAT_IDS[i]
            pf = sample_plane(self.color_mat[i], x01[:, m0], x01[:, m1])
            lf = sample_line(self.color_mat_line[i], x01[:, VEC_IDS[i]])
            feats.append(pf * lf * mm)
        feat = basis_product(torch.cat(feats, -1), self.basis, self.compute_dtype)
        return sigma.reshape(sh), feat.reshape(*sh, cfg.color_feat_dim)

    def density(self, x: torch.Tensor):
        return self.density_at(x, self.level)

    def logits(self, d: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return color_logits(self.color_net, d, feat, cfg.feat_multires, cfg.dir_multires,
                            self.compute_dtype)

    def color(self, d: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.logits(d, feat)).reshape(*d.shape[:-1], 3)


# ---------------------------------------------------------------------------
# K-object composition
# ---------------------------------------------------------------------------

class ComposedObject(NamedTuple):
    field: CCNeRFField
    rotation: Any = None      # [3, 3] world->object rotation (None = identity)
    scale: float = 1.0
    translation: Any = None   # [3] world-space object origin


def _as_f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


class ComposedField(nn.Module):
    """A scene of finalized CCNeRF objects (the reference's
    ``compose_ccnerf_fields``),
    each evaluated at its full K: sigma = sum_o sigma_o, rgb =
    sigmoid(sum_o softmax(sigma)_o * h_o) (network_cc.py:296-334).  The
    objects are baked in: composition is an eval-time operation, like the
    reference's no-rank-residual multi-object branch."""

    def __init__(self, objects: Sequence[ComposedObject]):
        super().__init__()
        self.objects = list(objects)
        self.fields = nn.ModuleList([o.field for o in self.objects])

    @property
    def device(self) -> torch.device:
        return self.fields[0].device

    def _frame(self, x: torch.Tensor, obj: ComposedObject) -> torch.Tensor:
        """normalize_coord analog: x_obj = R @ (x - t) / s."""
        if obj.translation is not None:
            x = x - _as_f32(obj.translation, x.device)
        if obj.rotation is not None:
            x = x @ _as_f32(obj.rotation, x.device).T
        return x / obj.scale

    def density(self, x: torch.Tensor):
        """-> (sigma [...], per-object (sigma, feature) packed [..., O*(1+C)])."""
        sigmas, packed = [], []
        for obj in self.objects:
            s, f = obj.field.density_at(self._frame(x, obj), obj.field.cfg.K)
            sigmas.append(s)
            packed.append(torch.cat([s[..., None], f], -1))
        return sum(sigmas), torch.cat(packed, -1)

    def color(self, d: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
        # each object carries its own colour width: split by the widths
        widths = [1 + obj.field.cfg.color_feat_dim for obj in self.objects]
        per = torch.split(packed, widths, dim=-1)
        ws = torch.softmax(torch.stack([p[..., 0] for p in per], 0), dim=0)
        h_all = 0.0
        for o, obj in enumerate(self.objects):
            do = d if obj.rotation is None else d @ _as_f32(obj.rotation, d.device).T
            h = obj.field.logits(do, per[o][..., 1:])
            h_all = h_all + ws[o].reshape(-1, 1) * h
        return torch.sigmoid(h_all).reshape(*d.shape[:-1], 3)

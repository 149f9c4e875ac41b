"""TensoRF field: vector-matrix (VM) decomposition.

Port of ``flnerf_tpu/models/tensorf.py`` (parity target
ngp-ours/tensoRF/network.py:13-283):
  * ``sigma_mat``/``sigma_vec`` and ``color_mat``/``color_vec``: per-axis
    plane [R, H, W] and line [R, D] factors (mat_ids [[0,1],[0,2],[1,2]],
    vec_ids [2,1,0]), init N(0, 0.1) (:99-109);
  * sigma = trunc_exp(sum_i sum_r plane_i_r(x_mat) * line_i_r(x_vec)) (:165);
  * color_feat = concat_i(plane*line) @ basis [3R -> 27] (:151-155);
  * rgb = sigmoid(MLP(freq(color_feat, 2) ++ freq(d, 2))), 3 x 128 bias-free;
  * the L1 density regularizer (:259), the align-corners upsample
    (:266-277) and the AABB shrink (:283-319);
  * grid_sample(align_corners=True) bilinear/linear factor sampling.

``TensoRFField`` is a field of the NGP trainer (``density``, ``color``,
``device``, ``parameters()``): the occupancy marcher and trainer of the NGP
path drive it unchanged, as the reference reuses NeRFRenderer.  Its
``density`` returns the colour feature as the feature payload.  The
parameters keep the reference's names, shapes and list structure
(``core/convert.py`` carries them across).  The basis product and the
colour MLP round their operands to the compute type and multiply in f32,
the rule of ``models/hash_ngp.mlp_chain``.

The factor samples are row gathers from a factor's [H*W, R] transpose
(points-major features [N, R]): ``index_select``, whose backward is
``index_add_`` (the choice ``chip_smoke.py`` phase 16d times against
advanced indexing's sort-based ``index_put_``).
No TPU kernel lies on this path.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flnerf_tpu_torch.models.hash_ngp import mlp_chain
from flnerf_tpu_torch.models.nerf_mlp import embed_fn, embedder_out_dim
from flnerf_tpu_torch.ops.activations import trunc_exp

MAT_IDS = ((0, 1), (0, 2), (1, 2))
VEC_IDS = (2, 1, 0)


class TensoRFConfig(NamedTuple):
    resolution: Tuple[int, int, int] = (128, 128, 128)
    sigma_rank: Tuple[int, int, int] = (16, 16, 16)
    color_rank: Tuple[int, int, int] = (48, 48, 48)
    color_feat_dim: int = 27
    num_layers: int = 3
    hidden_dim: int = 128
    feat_multires: int = 2
    dir_multires: int = 2
    bound: float = 1.0
    # parsed and never read, as in the reference (ROADMAP.md R5)
    l1_reg_weight: float = 1e-4
    # training AABB (xyz_min + xyz_max); None = the [-bound, bound] cube.
    # shrink_tensorf tightens it from occupancy stats (network.py:283)
    aabb: Tuple[float, ...] = None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [M, R] at rows idx [N] -> [N, R]; backward by ``index_add_``."""
    return torch.index_select(table, 0, idx)


def sample_plane(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of [R, H, W] at normalized coords (u -> W, v -> H) in
    [-1, 1], grid_sample(align_corners=True) semantics.  Returns [N, R]: the
    reference's [R, N] transposed, so that a corner's gather reads the R
    ranks of one plane entry from one contiguous row of the [H*W, R]
    table."""
    R, H, W = plane.shape
    x = (u + 1.0) * 0.5 * (W - 1)
    y = (v + 1.0) * 0.5 * (H - 1)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)[:, None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[:, None]
    table = plane.reshape(R, H * W).t().contiguous()
    base = y0 * W + x0
    return (gather_rows(table, base) * ((1 - fy) * (1 - fx))
            + gather_rows(table, base + 1) * ((1 - fy) * fx)
            + gather_rows(table, base + W) * (fy * (1 - fx))
            + gather_rows(table, base + W + 1) * (fy * fx))


def sample_line(line: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Linear sample of [R, D] at coords in [-1, 1]; returns [N, R]."""
    R, D = line.shape
    x = (t + 1.0) * 0.5 * (D - 1)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, D - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)[:, None]
    table = line.t().contiguous()
    return gather_rows(table, x0) * (1 - fx) + gather_rows(table, x0 + 1) * fx


def vm_features(mats, vecs, x01: torch.Tensor) -> torch.Tensor:
    """x01 in [-1, 1]^3 [N, 3] -> concat_i(plane_i * line_i) [N, sum(R)]."""
    feats = []
    for i in range(3):
        m0, m1 = MAT_IDS[i]
        pf = sample_plane(mats[i], x01[:, m0], x01[:, m1])
        feats.append(pf * sample_line(vecs[i], x01[:, VEC_IDS[i]]))
    return torch.cat(feats, -1)


def basis_product(col: torch.Tensor, basis: torch.Tensor, compute_dtype) -> torch.Tensor:
    """col [N, R] @ basis [R, C]: operands rounded to the compute type,
    products summed in f32 (the reference's dot_general)."""
    return torch.matmul(col.to(compute_dtype).float(), basis.to(compute_dtype).float())


def color_logits(color_net, d: torch.Tensor, feat: torch.Tensor, feat_multires: int,
                 dir_multires: int, compute_dtype) -> torch.Tensor:
    """The pre-sigmoid colour head shared by the VM, CP and CCNeRF fields
    and the composed field's blend: [N, 3] logits."""
    h = torch.cat([embed_fn(feat.reshape(-1, feat.shape[-1]), feat_multires),
                   embed_fn(d.reshape(-1, 3), dir_multires)], -1)
    return mlp_chain(h, color_net, compute_dtype)


def normal_param(shape, std, generator, device) -> nn.Parameter:
    return nn.Parameter(std * torch.randn(shape, generator=generator, device=device))


def uniform_param(shape, bound, generator, device) -> nn.Parameter:
    u = torch.rand(shape, generator=generator, device=device)
    return nn.Parameter(u * (2 * bound) - bound)


def register_tree(module: nn.Module, params: dict) -> None:
    """Register the reference's tree: lists as ``ParameterList``s, arrays as
    ``Parameter``s, under the tree's keys."""
    for k, v in params.items():
        if isinstance(v, (list, tuple, nn.ParameterList)):
            setattr(module, k, nn.ParameterList([nn.Parameter(p) for p in v]))
        else:
            setattr(module, k, nn.Parameter(v))


def init_color_net(in_dim: int, num_layers: int, hidden_dim: int, generator,
                   device) -> nn.ParameterList:
    """Bias-free [in, out] layers, U(-1/sqrt(in), 1/sqrt(in)), 3 outputs."""
    layers, dim = [], in_dim
    for layer in range(num_layers):
        out = 3 if layer == num_layers - 1 else hidden_dim
        layers.append(uniform_param((dim, out), 1.0 / np.sqrt(dim), generator, device))
        dim = out
    return nn.ParameterList(layers)


def color_in_dim(cfg) -> int:
    return (embedder_out_dim(cfg.feat_multires, cfg.color_feat_dim)
            + embedder_out_dim(cfg.dir_multires, 3))


def norm_coords(x: torch.Tensor, cfg) -> torch.Tensor:
    """World -> [-1, 1]^3 factor coordinates over the training AABB
    (network.py:147: (x - aabb[:3]) / (aabb[3:] - aabb[:3]) rescaled)."""
    if cfg.aabb is None:
        return x / cfg.bound
    amin = torch.tensor(cfg.aabb[:3], dtype=torch.float32, device=x.device)
    amax = torch.tensor(cfg.aabb[3:], dtype=torch.float32, device=x.device)
    return 2.0 * (x - amin) / (amax - amin) - 1.0


class TensoRFField(nn.Module):
    """The VM field (``make_tensorf_field``): parameters drawn from
    ``generator`` (torch's stream, not the reference's; tests carry weights
    across), or taken from ``params`` (a dict of the reference's keys)."""

    def __init__(self, cfg: TensoRFConfig, compute_dtype=torch.bfloat16, generator=None,
                 device="cpu", params=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        if params is None:
            params = {}
            for kind, ranks in (("sigma", cfg.sigma_rank), ("color", cfg.color_rank)):
                params[f"{kind}_mat"] = [
                    normal_param((ranks[i], cfg.resolution[MAT_IDS[i][1]],
                                  cfg.resolution[MAT_IDS[i][0]]), 0.1, generator, device)
                    for i in range(3)]
                params[f"{kind}_vec"] = [
                    normal_param((ranks[i], cfg.resolution[VEC_IDS[i]]), 0.1, generator, device)
                    for i in range(3)]
            total = sum(cfg.color_rank)
            params["basis"] = uniform_param((total, cfg.color_feat_dim),
                                            1.0 / np.sqrt(total), generator, device)
            params["color_net"] = init_color_net(color_in_dim(cfg), cfg.num_layers,
                                                 cfg.hidden_dim, generator, device)
        register_tree(self, params)

    @property
    def device(self) -> torch.device:
        return self.basis.device

    def factors(self) -> dict:
        """The four factor lists by name, as tensors (for shrink and
        upsample)."""
        return {k: [p.detach() for p in getattr(self, k)]
                for k in ("sigma_mat", "sigma_vec", "color_mat", "color_vec")}

    def with_factors(self, cfg: TensoRFConfig, factors: dict) -> "TensoRFField":
        """A new field at ``cfg`` with the given factors and this field's
        basis and colour net (fresh leaves)."""
        params = {k: [t.clone(memory_format=torch.contiguous_format) for t in v]
                  for k, v in factors.items()}
        params["basis"] = self.basis.detach().clone()
        params["color_net"] = [w.detach().clone() for w in self.color_net]
        return TensoRFField(cfg, self.compute_dtype, params=params)

    def density(self, x: torch.Tensor):
        """x [..., 3] -> (sigma [...], color_feat [..., C])."""
        sh = x.shape[:-1]
        x01 = torch.clamp(norm_coords(x.reshape(-1, 3), self.cfg), -1.0, 1.0)
        sigma = trunc_exp(torch.sum(vm_features(self.sigma_mat, self.sigma_vec, x01), -1))
        col = vm_features(self.color_mat, self.color_vec, x01)          # [N, 3R]
        feat = basis_product(col, self.basis, self.compute_dtype)
        return sigma.reshape(sh), feat.reshape(*sh, self.cfg.color_feat_dim)

    def color(self, d: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        """Unit dirs d [..., 3] + colour features -> rgb [..., 3] in [0, 1]."""
        cfg = self.cfg
        h = color_logits(self.color_net, d, feat, cfg.feat_multires, cfg.dir_multires,
                         self.compute_dtype)
        return torch.sigmoid(h).reshape(*d.shape[:-1], 3)


def density_l1_loss(field: TensoRFField) -> torch.Tensor:
    """L1 sparsity penalty on the sigma factors (network.py:259).  No
    trainer calls it, as in the reference (ROADMAP.md R5)."""
    loss = 0.0
    for t in list(field.sigma_mat) + list(field.sigma_vec):
        loss = loss + torch.mean(torch.abs(t))
    return loss


def _resize_align_corners(a: torch.Tensor, size) -> torch.Tensor:
    """[R, *spatial] -> [R, *size]: linear resize on align_corners=True nodes
    (the reference's map_coordinates on linspace(0, so-1, sn) nodes,
    F.interpolate(..., align_corners=True) as network.py:266-277 calls it).
    Half-pixel centres would shift the field against the samplers."""
    mode = "bilinear" if a.dim() == 3 else "linear"
    return F.interpolate(a[None], size=tuple(size), mode=mode, align_corners=True)[0]


def upsample_tensorf(field: TensoRFField, new_resolution) -> TensoRFField:
    """Bilinear factor upsampling (network.py:266-277) -> a new field at
    ``new_resolution``."""
    new_resolution = tuple(int(r) for r in new_resolution)
    out = {}
    with torch.no_grad():
        for k, v in field.factors().items():
            if k.endswith("_mat"):
                out[k] = [_resize_align_corners(v[i], (new_resolution[MAT_IDS[i][1]],
                                                       new_resolution[MAT_IDS[i][0]]))
                          for i in range(3)]
            else:
                out[k] = [_resize_align_corners(v[i], (new_resolution[VEC_IDS[i]],))
                          for i in range(3)]
    return field.with_factors(field.cfg._replace(resolution=new_resolution), out)


def shrink_tensorf(field: TensoRFField, occ_density: np.ndarray, mean_density: float,
                   grid_bound: float, density_thresh: float = 0.01) -> TensoRFField:
    """AABB shrink from occupancy stats (network.py:283-319 shrink_model):
    the occupied cells of the density grid give a tight world AABB; the
    factor planes and lines are sliced to the matching index windows and
    the config's training aabb is replaced.  The index arithmetic runs on
    the host in numpy, line for line the reference's; an empty grid returns
    ``field`` unchanged."""
    cfg = field.cfg
    g = occ_density.shape[0]
    dens = np.asarray(occ_density)
    thresh = min(density_thresh, float(mean_density))
    valid = np.argwhere(dens > thresh)
    if valid.size == 0:
        return field
    half = grid_bound / g
    pos = (2.0 * valid / (g - 1) - 1.0) * (grid_bound - half)
    min_pos = pos.min(0) - half
    max_pos = pos.max(0) + half

    aabb = cfg.aabb if cfg.aabb is not None else (
        (-cfg.bound,) * 3 + (cfg.bound,) * 3)
    amin = np.asarray(aabb[:3], np.float64)
    amax = np.asarray(aabb[3:], np.float64)
    min_pos = np.maximum(min_pos, amin)
    max_pos = np.minimum(max_pos, amax)
    reso = np.asarray(cfg.resolution)
    units = (amax - amin) / reso
    tl = np.clip(np.round((min_pos - amin) / units).astype(np.int64), 0, None)
    br = np.minimum(np.round((max_pos - amin) / units).astype(np.int64), reso)
    br = np.maximum(br, tl + 1)

    out = {}
    for k, v in field.factors().items():
        if k.endswith("_mat"):
            out[k] = [v[i][:, tl[MAT_IDS[i][1]]:br[MAT_IDS[i][1]],
                           tl[MAT_IDS[i][0]]:br[MAT_IDS[i][0]]] for i in range(3)]
        else:
            out[k] = [v[i][:, tl[VEC_IDS[i]]:br[VEC_IDS[i]]] for i in range(3)]
    return field.with_factors(cfg._replace(
        resolution=tuple(int(b - t) for t, b in zip(tl, br)),
        aabb=tuple(float(v) for v in min_pos) + tuple(float(v) for v in max_pos)), out)

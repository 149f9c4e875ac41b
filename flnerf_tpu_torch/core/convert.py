"""Weights carried across: the reference package's Plenoxels and NGP state,
given as numpy arrays, into this port's tensors, and back.

The reference (``flnerf_tpu/models/voxel_sh.py`` ``VoxelGrid`` and
``flnerf_tpu/train/plenoxels_trainer.py`` ``PlenoxelsState``) keeps the same
dense layouts as the port: density [X,Y,Z] f32, sh [X,Y,Z,27] f32, alive
[X,Y,Z] bool, RMSProp accumulators shaped like density and sh, and an int
step.  ``np.asarray`` of its arrays gives the inputs here.  The optional
parts cross as keyword arguments and come back as a dict: the MSI background
[2R, R, L, 4] f32, its RMSProp state and its [2R, R] bool ``bg_alive``, and
a learned basis, the [R, R, R, B] texture or the MLP's dict of ``w0..w3``
[in, out] and ``b0..b3``, with its RMSProp state shaped like it.

NGP (``flnerf_tpu/models/hash_ngp.py`` params): a dict with ``table`` and
the lists ``sigma_net`` and ``color_net`` of [in, out] weights.  The packed
engine's ``table`` is [L, C, T_r, 128] f32 (entry t of level l, feature c at
[l, c, t >> 7, t & 127]), kept by the port as [L, T_cap, C].  The lattice
engine's is the tuple (ts, tb): ts (None without small levels) in the packed
layout, tb [Lb, t_r64, 128] (entry e at [l, e >> 6, 2 * (e & 63) + c]),
kept by the port as [Lb, t_r64 * 64, 2].  The sorted engine's is the tuple
(ts, tb) with both in the packed layout, tb [Lb, C, t_r_big, 128], kept by
the port as [Lb, t_cap_big, C].  The two tuples differ in tb's rank (3 for
the lattice, 4 for the sorted engine).  Tables convert whole, padding
included, so checkpoints round-trip unchanged.  The weights stay [in, out], in
``NGPField.parameters()`` order: table(s), sigma_net, color_net and, with
the background env-map, ``bg_table`` [T, C] (its natural layout in both
packages) and ``bg_net``.  Its
occupancy state is the reference's density grid and mean, with the
bitfield repacked.

NeRF (``flnerf_tpu/models/nerf_mlp.py`` params): a dict of ``{"w": [in,
out], "b": [out]}`` leaves, ``pts_linears`` a list, then ``views_linear``,
``feature_linear``, ``alpha_linear`` and ``rgb_linear`` (or
``output_linear``).  It crosses to ``models/nerf_mlp.NerfMLP``'s
``state_dict`` (``nn.Linear`` names, weights [out, in]) and back.

NeRF++ (``flnerf_tpu/models/nerfpp.py`` params): a tuple with one tree per
cascade level, ``{"fg": mlp, "bg": mlp}`` and, with autoexpo, ``"autoexpo"``
[n_images, 2]; each mlp is ``{"base": [{"w": [in, out], "b"}, ...],
"sigma", "base_remap", "rgb0", "rgb1"}``.  Each level crosses to a
``models/nerfpp.NerfNet`` ``state_dict`` and back.

TensoRF, CP and CCNeRF (``flnerf_tpu/models/tensorf.py``,
``tensorf_variants.py`` params): a dict of arrays and lists of arrays, as
``jax.tree_util.tree_map(np.asarray, params)`` gives it: VM ``sigma_mat``,
``sigma_vec``, ``color_mat``, ``color_vec`` (3 each), ``basis`` and
``color_net`` [in, out] x L; CP ``sigma_lines`` and ``color_lines``;
CCNeRF adds ``*_mat_line`` (3 each), ``sigma_vec_scale`` and
``sigma_mat_scale`` (3).  The port's fields register the same keys with
the same shapes (``ParameterList`` for a list), so a parameter's name
``key.i`` is its place in the tree.

D-NeRF (``flnerf_tpu/models/dnerf.py`` params): ``deform`` is
``{"canonical": <the NGP dict>, "deform_net": [...]}``; ``basis`` is
``{"table", "basis_net", "sigma_net", "color_net"}`` with the NGP table
(packed, or the lattice or sorted tuple); ``hyper`` is ``{"table",
"ambient_net", "sigma_net", "color_net"}`` with a natural [T, C] table.  They
cross to ``models/dnerf.py``'s fields in parameter order (the tables, then
the nets in the order just named; the canonical field before
``deform_net``).

SDF (``flnerf_tpu/models/sdf.py`` params): ``{"table": packed [L, C, T_r,
128], "net": [...]}``, kept by ``models/sdf.SDFField`` as [L, T_cap, C] and
its net.
"""

from __future__ import annotations

import numpy as np
import torch

from flnerf_tpu_torch.models.voxel_sh import VoxelGrid
from flnerf_tpu_torch.render.ngp import NGPRenderConfig, OccupancyState, with_density
from flnerf_tpu_torch.train.plenoxels_trainer import PlenoxelsState


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _basis(basis, device):
    if basis is None:
        return None
    if isinstance(basis, dict):
        return {k: _f32(v, device) for k, v in basis.items()}
    return _f32(basis, device)


def _basis_np(basis):
    if basis is None:
        return None
    if isinstance(basis, dict):
        return {k: v.detach().cpu().numpy() for k, v in basis.items()}
    return basis.detach().cpu().numpy()


def voxel_grid_from_numpy(density, sh, alive, device="cpu", background=None,
                          basis=None) -> VoxelGrid:
    density = _f32(density, device)
    sh = _f32(sh, device)
    alive = torch.tensor(np.asarray(alive, bool), device=device)
    if sh.shape[:3] != density.shape or alive.shape != density.shape:
        raise ValueError(f"grid shapes disagree: density {tuple(density.shape)}, "
                         f"sh {tuple(sh.shape)}, alive {tuple(alive.shape)}")
    return VoxelGrid(density, sh, alive,
                     None if background is None else _f32(background, device),
                     _basis(basis, device))


def plenoxels_state_from_numpy(density, sh, alive, rms_density, rms_sh, step,
                               device="cpu", background=None, basis=None, rms_bg=None,
                               bg_alive=None, rms_basis=None) -> PlenoxelsState:
    grid = voxel_grid_from_numpy(density, sh, alive, device, background, basis)
    rms_density = _f32(rms_density, device)
    rms_sh = _f32(rms_sh, device)
    if rms_density.shape != grid.density.shape or rms_sh.shape != grid.sh.shape:
        raise ValueError("RMSProp accumulators must be shaped like density and sh")
    return PlenoxelsState(
        grid, rms_density, rms_sh, int(step),
        rms_bg=None if rms_bg is None else _f32(rms_bg, device),
        bg_alive=(None if bg_alive is None
                  else torch.tensor(np.asarray(bg_alive, bool), device=device)),
        rms_basis=_basis(rms_basis, device))


def voxel_grid_to_numpy(grid: VoxelGrid):
    """(density, sh, alive) as numpy arrays."""
    return tuple(t.detach().cpu().numpy() for t in grid.tensors)


def plenoxels_state_to_numpy(state: PlenoxelsState):
    """(density, sh, alive, rms_density, rms_sh, step)."""
    return voxel_grid_to_numpy(state.grid) + (
        state.rms_density.cpu().numpy(), state.rms_sh.cpu().numpy(),
        int(state.step))


def plenoxels_extras_to_numpy(state: PlenoxelsState) -> dict:
    """The optional parts as numpy (None where absent): background, basis,
    rms_bg, bg_alive, rms_basis."""
    g = state.grid
    return {"background": None if g.background is None else g.background.detach().cpu().numpy(),
            "basis": _basis_np(g.basis),
            "rms_bg": None if state.rms_bg is None else state.rms_bg.cpu().numpy(),
            "bg_alive": None if state.bg_alive is None else state.bg_alive.cpu().numpy(),
            "rms_basis": _basis_np(state.rms_basis)}


def _natural_from_packed(table) -> np.ndarray:
    """[L, C, T_r, 128] -> [L, T_r * 128, C]."""
    table = np.asarray(table, np.float32)
    L, C, t_r, lanes = table.shape
    return np.ascontiguousarray(table.reshape(L, C, t_r * lanes).transpose(0, 2, 1))


def _packed_from_natural(table: np.ndarray, lanes: int = 128) -> np.ndarray:
    """[L, T_cap, C] -> [L, C, T_cap / 128, 128]."""
    L, t_cap, C = table.shape
    return np.ascontiguousarray(table.transpose(0, 2, 1).reshape(L, C, t_cap // lanes, lanes))


def ngp_params_from_numpy(params, device="cpu") -> list:
    """The reference's NGP params dict -> [table(s), *sigma_net, *color_net]
    tensors (``NGPField.parameters()`` order): [L, T_cap, C] for a packed
    table; [Ls, T_cap, C] (when ts is not None) and then [Lb, t_r64 * 64, 2]
    for the lattice tuple (ts, tb), [Lb, t_cap_big, C] for the sorted one."""
    table = params["table"]
    if isinstance(table, (tuple, list)):
        ts, tb = table
        tb = np.asarray(tb, np.float32)
        if tb.ndim == 3:     # the lattice's [Lb, t_r64, 128]
            tb = tb.reshape(tb.shape[0], -1, 2)
        else:                # the sorted engine's [Lb, C, t_r_big, 128]
            tb = _natural_from_packed(tb)
        tables = ([] if ts is None else [_natural_from_packed(ts)]) + [tb]
    else:
        tables = [_natural_from_packed(table)]
    bg = ([params["bg_table"]] + list(params["bg_net"])) if "bg_table" in params else []
    return [torch.tensor(t, device=device) for t in tables] + [
        _f32(w, device) for w in list(params["sigma_net"]) + list(params["color_net"]) + bg]


def load_ngp_params(field, params) -> None:
    """Copy the reference's NGP params dict into ``field``'s parameters."""
    with torch.no_grad():
        for p, v in zip(field.parameters(), ngp_params_from_numpy(params, field.device)):
            p.copy_(v)


def ngp_params_to_numpy(tensors, num_sigma_layers: int, engine: str = "packed",
                        num_bg_layers: int = 0) -> dict:
    """Inverse of ``ngp_params_from_numpy``: tensors in parameter order ->
    the reference's dict (table, sigma_net, color_net, and bg_table and
    bg_net when ``num_bg_layers`` > 0: the last tensors).  ``engine`` is the
    field's (``models/hash_ngp.engine_kind``): "packed" gives one packed
    table; "lattice" and "sorted" read the leading 3-D tensors as
    (table_small,) table_big and give the tuple (ts or None, tb), tb
    [Lb, t_r64, 128] for the lattice and [Lb, C, t_r_big, 128] for the
    sorted engine."""
    if engine not in ("packed", "lattice", "sorted"):
        raise ValueError(f"unknown engine {engine!r} (packed|lattice|sorted)")
    arrs = [t.detach().cpu().numpy() for t in tensors]
    n_tables = sum(1 for a in arrs[:2] if a.ndim == 3)
    if engine == "packed":
        table = _packed_from_natural(arrs[0])
    else:
        tb = arrs[n_tables - 1]
        tb = (np.ascontiguousarray(tb.reshape(tb.shape[0], -1, 128)) if engine == "lattice"
              else _packed_from_natural(tb))
        table = (_packed_from_natural(arrs[0]) if n_tables == 2 else None, tb)
    n_bg = num_bg_layers + 1 if num_bg_layers else 0
    out = {"table": table, "sigma_net": arrs[n_tables:n_tables + num_sigma_layers],
           "color_net": arrs[n_tables + num_sigma_layers:len(arrs) - n_bg]}
    if n_bg:
        out["bg_table"], out["bg_net"] = arrs[-n_bg], arrs[len(arrs) - num_bg_layers:]
    return out


def occupancy_from_numpy(density, mean_density, cfg: NGPRenderConfig,
                         device="cpu") -> OccupancyState:
    """The reference's occupancy density grid [G, G, G] and mean -> an
    ``OccupancyState`` with its bitfield packed (when G^3 % 32 == 0)."""
    density = _f32(density, device)
    g = cfg.grid_size
    if tuple(density.shape) != (g, g, g):
        raise ValueError(f"occupancy grid {tuple(density.shape)} != grid_size {g}")
    occ = OccupancyState(density, torch.zeros((), device=device),
                         torch.zeros(1) if g ** 3 % 32 == 0 else None)
    return with_density(occ, density, cfg, mean_density=float(mean_density))


def occupancy_to_numpy(occ: OccupancyState):
    """(density [G, G, G], mean, bits [G^3/32] int32 or None)."""
    return (occ.density.cpu().numpy(), float(occ.mean_density),
            None if occ.bits is None else occ.bits.cpu().numpy())


_NERF_HEAD = (("views_linear", "views_linears.0"), ("feature_linear", "feature_linear"),
              ("alpha_linear", "alpha_linear"), ("rgb_linear", "rgb_linear"),
              ("output_linear", "output_linear"))


def nerf_params_from_numpy(params, device="cpu") -> dict:
    """The reference's NeRF params pytree -> a ``NerfMLP`` state dict."""
    sd = {}
    groups = [(f"pts_linears.{i}", layer) for i, layer in enumerate(params["pts_linears"])]
    groups += [(name, params[key]) for key, name in _NERF_HEAD if key in params]
    for name, layer in groups:
        sd[f"{name}.weight"] = _f32(np.asarray(layer["w"], np.float32).T, device)
        sd[f"{name}.bias"] = _f32(layer["b"], device)
    return sd


def nerf_params_to_numpy(module) -> dict:
    """A ``NerfMLP`` -> the reference's NeRF params pytree (numpy leaves,
    weights [in, out])."""
    sd = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}

    def layer(name):
        return {"w": np.ascontiguousarray(sd[f"{name}.weight"].T), "b": sd[f"{name}.bias"]}

    params = {"pts_linears": [layer(f"pts_linears.{i}") for i in range(len(module.pts_linears))]}
    for key, name in _NERF_HEAD:
        if f"{name}.weight" in sd:
            params[key] = layer(name)
    return params


_MLPNET_HEAD = ("sigma", "base_remap", "rgb0", "rgb1")


def nerfpp_params_from_numpy(levels, device="cpu") -> list:
    """The reference's NeRF++ params tuple -> one ``NerfNet`` state dict a
    cascade level."""
    out = []
    for params in levels:
        sd = {}
        for net in ("fg", "bg"):
            mlp = params[net]
            groups = [(f"base.{i}", layer) for i, layer in enumerate(mlp["base"])]
            groups += [(name, mlp[name]) for name in _MLPNET_HEAD]
            for name, layer in groups:
                sd[f"{net}.{name}.weight"] = _f32(np.asarray(layer["w"], np.float32).T, device)
                sd[f"{net}.{name}.bias"] = _f32(layer["b"], device)
        if "autoexpo" in params:
            sd["autoexpo"] = _f32(params["autoexpo"], device)
        out.append(sd)
    return out


def nerfpp_params_to_numpy(nets) -> tuple:
    """``NerfNet`` modules, one a cascade level -> the reference's NeRF++
    params tuple (numpy leaves, weights [in, out])."""
    levels = []
    for module in nets:
        sd = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}

        def layer(name):
            return {"w": np.ascontiguousarray(sd[f"{name}.weight"].T), "b": sd[f"{name}.bias"]}

        params = {}
        for net in ("fg", "bg"):
            n_base = len(getattr(module, net).base)
            params[net] = {"base": [layer(f"{net}.base.{i}") for i in range(n_base)]}
            params[net].update({name: layer(f"{net}.{name}") for name in _MLPNET_HEAD})
        if "autoexpo" in sd:
            params["autoexpo"] = sd["autoexpo"]
        levels.append(params)
    return tuple(levels)


def tensorf_tree_from_numpy(tree, device="cpu") -> dict:
    """The reference's TensoRF/CP/CCNeRF params tree -> the same tree of f32
    tensors (a field's ``params=``)."""
    return {k: [_f32(a, device) for a in v] if isinstance(v, (list, tuple)) else _f32(v, device)
            for k, v in tree.items()}


def tensorf_params_from_numpy(field, tree, device="cpu") -> list:
    """The tree's arrays as tensors in ``field.named_parameters()`` order."""
    out = []
    for name, _ in field.named_parameters():
        key, _, i = name.partition(".")
        out.append(_f32(tree[key][int(i)] if i else tree[key], device))
    return out


def tensorf_params_to_numpy(field, tensors=None) -> dict:
    """Tensors in ``field.named_parameters()`` order (default: the field's
    own) -> the reference's tree of numpy arrays."""
    tensors = list(field.parameters()) if tensors is None else tensors
    tree = {}
    for (name, _), t in zip(field.named_parameters(), tensors):
        key, _, i = name.partition(".")
        a = t.detach().cpu().numpy()
        if i:
            tree.setdefault(key, []).append(a)
        else:
            tree[key] = a
    return tree


def _arrays(tensors) -> list:
    return [t.detach().cpu().numpy() for t in tensors]


def dnerf_params_from_numpy(field, tree, device="cpu") -> list:
    """The reference's D-NeRF params of ``field``'s variant -> tensors in
    ``field.parameters()`` order."""
    if field.variant == "deform":
        return ngp_params_from_numpy(tree["canonical"], device) + [
            _f32(w, device) for w in tree["deform_net"]]
    if field.variant == "basis":
        heads = list(tree["sigma_net"]) + list(tree["color_net"])
        ngp = ngp_params_from_numpy({"table": tree["table"], "sigma_net": tree["sigma_net"],
                                     "color_net": tree["color_net"]}, device)
        n_tables = len(ngp) - len(heads)
        return ngp[:n_tables] + [_f32(w, device) for w in tree["basis_net"]] + ngp[n_tables:]
    return [_f32(w, device) for w in [tree["table"]] + list(tree["ambient_net"])
            + list(tree["sigma_net"]) + list(tree["color_net"])]


def dnerf_params_to_numpy(field, tensors=None) -> dict:
    """Tensors in ``field.parameters()`` order (default: the field's own) ->
    the reference's D-NeRF params of ``field``'s variant."""
    from flnerf_tpu_torch.models.hash_ngp import engine_kind

    tensors = list(field.parameters()) if tensors is None else list(tensors)
    if field.variant == "deform":
        n_deform = len(field.deform_net)
        return {"canonical": ngp_params_to_numpy(tensors[:-n_deform],
                                                 field.cfg.ngp.num_layers,
                                                 engine_kind(field.canonical.spec)),
                "deform_net": _arrays(tensors[-n_deform:])}
    n_sigma = len(field.sigma_net)
    heads = len(tensors) - n_sigma - len(field.color_net)     # where sigma_net starts
    if field.variant == "basis":
        n_tables = heads - len(field.basis_net)
        ngp = ngp_params_to_numpy(tensors[:n_tables] + tensors[heads:], n_sigma,
                                  engine_kind(field.spec))
        ngp["basis_net"] = _arrays(tensors[n_tables:heads])
        return ngp
    arrs = _arrays(tensors)
    return {"table": arrs[0], "ambient_net": arrs[1:heads],
            "sigma_net": arrs[heads:heads + n_sigma], "color_net": arrs[heads + n_sigma:]}


def load_dnerf_params(field, tree) -> None:
    """Copy the reference's D-NeRF params into ``field``'s parameters."""
    with torch.no_grad():
        for p, v in zip(field.parameters(), dnerf_params_from_numpy(field, tree, field.device)):
            p.copy_(v)


def sdf_params_from_numpy(tree, device="cpu") -> list:
    """The reference's SDF params -> [table [L, T_cap, C], *net]."""
    return [torch.tensor(_natural_from_packed(tree["table"]), device=device)] + [
        _f32(w, device) for w in tree["net"]]


def sdf_params_to_numpy(tensors) -> dict:
    """Inverse of ``sdf_params_from_numpy``."""
    arrs = _arrays(tensors)
    return {"table": _packed_from_natural(arrs[0]), "net": arrs[1:]}


def resunet_params_from_numpy(tree, device="cpu"):
    """The reference's ResUNet params (``flnerf_tpu/models/resunet.py``
    ``init_resunet``: dicts and lists of arrays, convolution weights HWIO)
    -> the port's tree, weights OIHW."""
    if isinstance(tree, dict):
        return {k: (_f32(np.transpose(np.asarray(v, np.float32), (3, 2, 0, 1)), device)
                    if k == "w" else resunet_params_from_numpy(v, device))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [resunet_params_from_numpy(v, device) for v in tree]
    return _f32(tree, device)

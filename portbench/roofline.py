"""The chip's peaks and the work of the kernels and steps the cells time.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.  A least
time is the larger of bytes over the memory bandwidth and operations over
the peak of the precision they run in.  Bytes count each input read and
each output written once, on the data of the batch at hand (the kernel
table of PERF.md counts them so): what these inputs need, not the most
they could.  The per-sample operation counts are chip_smoke.py's, copied.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12

# a cuvol sample: position and trilinear weights, 8 corners x 28
# multiply-adds, 3 SH dot products, compositing; the backward recomputes it
# and adds a multiply-add per channel and corner and the transmittance's
# gradient; a sample under the density gate costs its density pass alone
FWD_FLOPS_PER_SAMPLE = 542
BWD_FLOPS_PER_SAMPLE = 542 + 448 + 30
DENSITY_FLOPS_PER_SAMPLE = 41
# a (point, level) of the hash encoding: forward and its table gradient
K6_FLOPS = 60
K7_FLOPS = 44


def least_seconds(nbytes: float, f32_flops: float = 0.0, bf16_flops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, f32_flops / F32_FLOPS + bf16_flops / BF16_TC_FLOPS)


# -- Plenoxels -----------------------------------------------------------

def voxel_counts(density: torch.Tensor, cfg: dict, o: torch.Tensor, d: torch.Tensor,
                 block: int = 256) -> dict:
    """What a batch of rays needs of a dense grid: marched samples (all, and
    those at or above the density gate), distinct cells their corners touch,
    and distinct cells touched by gated-in samples (whose SH is read)."""
    reso = torch.tensor(cfg["reso"], dtype=torch.float32, device=o.device)
    scaling = 0.5 * reso / torch.tensor(cfg["radius"], dtype=torch.float32, device=o.device)
    Y, Z = cfg["reso"][1], cfg["reso"][2]
    touched, live_cells, n_all, n_live = [], [], 0, 0
    for i in range(0, o.shape[0], block):
        org = o[i:i + block] * scaling + 0.5 * reso - 0.5
        gd = d[i:i + block] / torch.linalg.norm(d[i:i + block], dim=-1, keepdim=True) * scaling
        gd = gd / torch.linalg.norm(gd, dim=-1, keepdim=True)
        safe = torch.where(gd.abs() < 1e-9, torch.full_like(gd, 1e-9), gd)
        t1, t2 = (-0.5 - org) / safe, (reso - 0.5 - org) / safe
        tmin = torch.clamp(torch.minimum(t1, t2).amax(-1), min=0.0)
        tmax = torch.maximum(t1, t2).amin(-1)
        ts = tmin[:, None] + cfg["step_size"] * torch.arange(cfg["max_steps"], device=o.device)
        valid = ts <= tmax[:, None]
        pos = (org[:, None] + ts[..., None] * gd[:, None])[valid]
        pos = torch.minimum(torch.clamp(pos, min=0.0), reso - 1)
        lo = torch.minimum(torch.floor(pos), reso - 2).long()
        f = pos - lo
        sig = 0.0
        cells = []
        for c in range(8):
            b = (c >> 2, (c >> 1) & 1, c & 1)
            w = 1.0
            for a in range(3):
                w = w * (f[:, a] if b[a] else 1 - f[:, a])
            idx = ((lo[:, 0] + b[0]) * Y + lo[:, 1] + b[1]) * Z + lo[:, 2] + b[2]
            sig = sig + w * density.reshape(-1)[idx]
            cells.append(idx)
        cells = torch.stack(cells, 1)
        live = torch.relu(sig) >= cfg["sigma_thresh"]
        touched.append(cells.unique())
        live_cells.append(cells[live].unique())
        n_all += int(pos.shape[0])
        n_live += int(live.sum())
    return {"samples": n_all, "live_samples": n_live,
            "cells": int(torch.cat(touched).unique().numel()),
            "sh_cells": int(torch.cat(live_cells).unique().numel())}


def k1_work(k: dict, rays: int) -> dict:
    """K1: each touched cell's density and alive byte, the SH of the cells
    gated-in samples touch, the ray inputs (18 floats) and the output (8)."""
    nbytes = k["cells"] * 5 + k["sh_cells"] * 27 * 4 + rays * (18 + 8) * 4
    flops = (k["live_samples"] * FWD_FLOPS_PER_SAMPLE
             + (k["samples"] - k["live_samples"]) * DENSITY_FLOPS_PER_SAMPLE)
    return {"bytes": nbytes, "f32_flops": flops}


def k2_work(k: dict, rays: int) -> dict:
    """K2: K1's reads, K1's output and the upstream gradient once more, and
    the 28 gradients of each cell gated-in samples touch written once."""
    w = k1_work(k, rays)
    nbytes = w["bytes"] + rays * 8 * 4 + k["sh_cells"] * 28 * 4
    flops = (k["live_samples"] * BWD_FLOPS_PER_SAMPLE
             + (k["samples"] - k["live_samples"]) * DENSITY_FLOPS_PER_SAMPLE)
    return {"bytes": nbytes, "f32_flops": flops}


def plenoxels_step_work(k: dict, rays: int, cells: int, sh_channels: int) -> dict:
    """A whole step: K1 and K2, and the dense TV-regularised RMSProp, whose
    gradient is nonzero in every cell: each of the 1 + C floats a cell is
    read and written once and its RMSProp state read and written once (the
    TV stencil and the data gradient fused into that pass)."""
    dense = cells * (1 + sh_channels) * 4 * 4
    w1, w2 = k1_work(k, rays), k2_work(k, rays)
    return {"bytes": dense + w1["bytes"] + w2["bytes"],
            "f32_flops": w1["f32_flops"] + w2["f32_flops"] + cells * (1 + sh_channels) * 20}


# -- Instant-NGP ---------------------------------------------------------

def lattice_counts(x01: torch.Tensor, live: torch.Tensor, cfg: dict) -> dict:
    """The big levels' distinct table entries the points' corners touch (all
    points, and the live ones: a kept, valid sample, whose gradient is not
    zero), with the reference's level geometry and hash."""
    from portbench.reference import ngp as ref

    lv = ref.levels(cfg)
    n_small = sum(1 for v in lv if v["size"] < cfg["split_min_size"])
    mult = ref.lattice_multipliers(2 ** cfg["log2_hashmap_size"], len(lv) - n_small)
    touched, touched_live = 0, 0
    for l, v in enumerate(lv[n_small:]):
        cell = torch.floor(x01 * v["scale"] + 0.5).long()
        idx = []
        for c in range(8):
            x, y, z = (cell[:, a] + ((c >> a) & 1) for a in range(3))
            if v["hashed"]:
                p = mult[l]
                idx.append((x * p[0] + y * p[1] + z * p[2]) % v["size"])
            else:
                idx.append(x + v["S"] * (y + v["S"] * z))
        idx = torch.stack(idx, 1)
        touched += int(idx.unique().numel())
        touched_live += int(idx[live].unique().numel())
    return {"points": int(x01.shape[0]), "live": int(live.sum()), "big_levels": len(lv) - n_small,
            "small_levels": n_small, "touched": touched, "touched_live": touched_live}


def k6_work(e: dict) -> dict:
    """K6: the points (12 bytes), the [Lb, N, 2] output, each touched entry."""
    nbytes = e["points"] * 12 + e["points"] * e["big_levels"] * 8 + e["touched"] * 8
    return {"bytes": nbytes, "f32_flops": e["points"] * e["big_levels"] * K6_FLOPS}


def k7_work(e: dict) -> dict:
    """K7: the points, the upstream gradient, each entry live points touch
    read and written once."""
    nbytes = e["points"] * 12 + e["points"] * e["big_levels"] * 8 + e["touched_live"] * 16
    return {"bytes": nbytes, "f32_flops": e["live"] * e["big_levels"] * K7_FLOPS}


def ngp_step_work(e: dict, cfg: dict, n_params: int) -> dict:
    """A whole step: the encode forward and backward of every level, the
    MLPs' products on every point (forward, and twice that backward) in
    bf16, the amortised partial occupancy refresh (a stride-2 parity class
    of the grid through the forward, every 16 steps), and Adam with the EMA:
    each parameter, its two moments and its EMA read and written once."""
    h = 64
    mlp = 2 * (32 * h + h * 16 + (cfg["sh_degree"] ** 2 + 15) * h + h * h + h * 3)
    sigma_mlp = 2 * (32 * h + h * 16)
    refresh = (cfg["grid_size"] // 2) ** 3 / 16
    levels = e["big_levels"] + e["small_levels"]
    enc = k6_work(e)["bytes"] + k7_work(e)["bytes"] + e["points"] * e["small_levels"] * 16
    return {"bytes": enc + n_params * 4 * 8,
            "bf16_flops": 3 * mlp * e["points"] + sigma_mlp * refresh,
            "f32_flops": e["points"] * levels * (K6_FLOPS + K7_FLOPS) + n_params * 12}

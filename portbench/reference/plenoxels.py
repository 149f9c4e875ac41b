"""Plain-torch reference of the Plenoxels training step (svox2 cuvol).

A dense grid of density and SH coefficients (``basis_dim`` per colour
channel), marched in grid space at ``step_size`` voxels from the box
entry, trilinear density and SH, ``relu`` density gated at
``sigma_thresh``, log-transmittance compositing with the step scaled by
1/|grid-space direction| (svox2.py:659-780), rgb = max(SH . basis + 0.5, 0)
and a white background.  The loss is the rays' mean squared error over the
channels plus ``lambda_tv`` and ``lambda_tv_sh`` times the total variation
(mean over cells of the squared forward differences) of density and SH;
RMSProp (beta ``rms_beta``, epsilon 1e-8) with svox2's delayed log-linear
learning rates (util.py get_expon_lr_func).  The quadtree's per-leaf
statistic is each leaf's mean over its rays of the largest |error| of the
ray's channels, rendered before the step's update: what the quadtree
budget splits its leaves by.  No kernel, no skip, no cache:
every ray marches every step up to its box exit, in blocks of rays.

``store`` is the dtype the grid, its gradients and RMSProp's state are
held in: float32 as configured, bfloat16 for the control.  Imports nothing
of the program.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.common import norms, sh_basis


def expon_lr(step, lr_init, lr_final, delay_steps, delay_mult, max_steps) -> float:
    t = min(max(step / max_steps, 0.0), 1.0)
    lr = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
    if delay_steps > 0:
        lr *= delay_mult + (1 - delay_mult) * math.sin(0.5 * math.pi * min(max(step / delay_steps, 0.0), 1.0))
    return lr


def render(density, sh, o, d, cfg) -> torch.Tensor:
    """[N, 3] colour of rays (o, d) through the grid (float32 geometry)."""
    reso = torch.tensor(cfg["reso"], dtype=torch.float32, device=o.device)
    scaling = 0.5 * reso / torch.tensor(cfg["radius"], dtype=torch.float32, device=o.device)
    org = o * scaling + 0.5 * reso - 0.5
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    gd = vd * scaling
    delta_scale = 1.0 / torch.linalg.norm(gd, dim=-1)
    gd = gd * delta_scale[:, None]
    safe = torch.where(gd.abs() < 1e-9, torch.full_like(gd, 1e-9), gd)
    t1, t2 = (-0.5 - org) / safe, (reso - 0.5 - org) / safe
    tmin = torch.clamp(torch.minimum(t1, t2).amax(-1), min=0.0)
    tmax = torch.maximum(t1, t2).amin(-1)
    n_steps = int(torch.clamp((tmax - tmin).max() / cfg["step_size"] + 1, min=1, max=cfg["max_steps"]))
    ts = tmin[:, None] + cfg["step_size"] * torch.arange(n_steps, device=o.device)[None, :]
    valid = ts <= tmax[:, None]
    pos = org[:, None, :] + ts[..., None] * gd[:, None, :]
    pos = torch.minimum(torch.clamp(pos, min=0.0), reso - 1)
    lo = torch.minimum(torch.floor(pos), reso - 2).long()
    f = pos - lo
    sig, coef = 0.0, 0.0
    for c in range(8):
        bx, by, bz = c >> 2, (c >> 1) & 1, c & 1
        w = ((f[..., 0] if bx else 1 - f[..., 0]) * (f[..., 1] if by else 1 - f[..., 1])
             * (f[..., 2] if bz else 1 - f[..., 2]))
        ix, iy, iz = lo[..., 0] + bx, lo[..., 1] + by, lo[..., 2] + bz
        sig = sig + w * density[ix, iy, iz].float()
        coef = coef + w[..., None] * sh[ix, iy, iz].float()
    sig = torch.where(valid, torch.relu(sig), 0.0)
    sig = torch.where(sig >= cfg["sigma_thresh"], sig, 0.0)
    log_att = -cfg["step_size"] * sig * delta_scale[:, None]
    log_t = torch.cumsum(log_att, -1)
    weights = torch.exp(log_t - log_att) * (1.0 - torch.exp(log_att))
    basis = sh_basis(vd, int(round(math.sqrt(cfg["basis_dim"]))))
    rgb = torch.clamp(torch.sum(coef.reshape(*coef.shape[:2], 3, -1) * basis[:, None, None, :], -1)
                      + 0.5, min=0.0)
    return torch.sum(weights[..., None] * rgb, 1) + torch.exp(log_t[:, -1])[:, None] * cfg["background_brightness"]


def tv(field: torch.Tensor) -> torch.Tensor:
    f = field.float() if field.ndim == 4 else field.float()[..., None]
    n = f.shape[0] * f.shape[1] * f.shape[2]
    return (torch.sum((f[1:] - f[:-1]) ** 2) + torch.sum((f[:, 1:] - f[:, :-1]) ** 2)
            + torch.sum((f[:, :, 1:] - f[:, :, :-1]) ** 2)) / n


def train(cfg: dict, density0: torch.Tensor, batches, n_leaves: int, device,
          store=torch.float32, block: int = 1250, fault=None) -> dict:
    """Run len(batches) steps from the grid ``density0`` [X, Y, Z] with zero
    SH; each batch is (origins, dirs, rgb [B, 3] float32, leaf [B] int64).
    Returns the readings: each step's data MSE, the first gradient's norm
    and the parameters' change after the steps, per leaf (density, SH), and
    each step's per-quadtree-leaf statistic: the mean over a leaf's rays of
    the ray's largest |error| over the channels, -inf for a leaf with no
    ray.  ``fault`` "half" trains on the first half of each batch (a
    planted fault)."""
    density = density0.to(device=device, dtype=store).clone()
    sh = torch.zeros((*density.shape, 3 * cfg["basis_dim"]), dtype=store, device=device)
    init = [density.clone(), sh.clone()]
    rms = [torch.zeros_like(density), torch.zeros_like(sh)]
    tc = cfg["train"]
    out = {"loss": [], "grad": None, "leaf": []}
    for step, (o, d, rgb, leaf) in enumerate(batches):
        if fault == "half":
            o, d, rgb, leaf = (a[: a.shape[0] // 2] for a in (o, d, rgb, leaf))
        leaves = [density.detach().requires_grad_(True), sh.detach().requires_grad_(True)]
        grads = [torch.zeros_like(density, dtype=torch.float32), torch.zeros_like(sh, dtype=torch.float32)]
        sq = 0.0
        denom = o.shape[0] * 3.0
        err_sum = torch.zeros(n_leaves, dtype=torch.float64, device=device)
        err_cnt = torch.zeros(n_leaves, dtype=torch.float64, device=device)
        for i in range(0, o.shape[0], block):
            diff = render(leaves[0], leaves[1], o[i:i + block], d[i:i + block], cfg) - rgb[i:i + block]
            s = torch.sum(diff ** 2)
            for g, gi in zip(grads, torch.autograd.grad(s / denom, leaves)):
                g += gi.float()
            sq += float(s.detach())
            err_sum.index_add_(0, leaf[i:i + block], diff.detach().abs().amax(-1).double())
            err_cnt.index_add_(0, leaf[i:i + block], torch.ones_like(err_sum[:1]).expand(diff.shape[0]))
        stat = err_sum / torch.clamp(err_cnt, min=1.0)
        out["leaf"].append(torch.where(err_cnt > 0, stat, -torch.inf).cpu())
        reg = tc["lambda_tv"] * tv(leaves[0]) + tc["lambda_tv_sh"] * tv(leaves[1])
        for g, gi in zip(grads, torch.autograd.grad(reg, leaves)):
            g += gi.float()
        out["loss"].append(sq / denom)
        if step == 0:
            out["grad"] = norms(grads)
        lrs = (expon_lr(step, tc["lr_sigma"], tc["lr_sigma_final"], tc["lr_sigma_delay_steps"],
                        tc["lr_sigma_delay_mult"], tc["lr_decay_steps"]),
               expon_lr(step, tc["lr_sh"], tc["lr_sh_final"], 0, 1.0, tc["lr_decay_steps"]))
        b = tc["rms_beta"]
        with torch.no_grad():
            for p, r, g, lr in zip((density, sh), rms, grads, lrs):
                g = g.to(store)
                r.mul_(b).addcmul_(g, g, value=1 - b)
                p.sub_(lr * g / (r.sqrt() + 1e-8))
        del leaves, grads
    out["change"] = norms([density.float() - init[0].float(), sh.float() - init[1].float()])
    return out

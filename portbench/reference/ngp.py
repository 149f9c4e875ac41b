"""Plain-torch reference of the Instant-NGP training step (torch-ngp
``main_nerf.py -O``, as the JAX package re-designed its march).

- Encoding: L levels of 2 features, level l at scale 2^(l log2 b) N_min - 1,
  resolution ceil(scale) + 1, align_corners=False (pos = x scale + 0.5),
  trilinear over the 8 corners (gridencoder.cu:100-180).  A level whose
  (res+1)^3 cells fit its table is indexed densely, x + S (y + S z) with
  S = res + 1; a hashed level by the linear lattice hash (x P1 + y P2 + z P3)
  mod 2^k with the odd multipliers ``lattice_multipliers`` picks (the
  configuration's ``auto`` engine at 2^19).
- MLPs: bias-free ReLU layers with operands rounded to ``operand`` and
  products summed in float32 (TF32 off); sigma = exp (its gradient clamped
  at |x| <= 15), the colour net on SH degree 4 of the direction and the 15
  geometry features, sigmoid.
- Occupancy: a G^3 grid of the field's sigma at jittered cell centres,
  kept where it exceeds min(mean, density_thresh); a full refresh from a
  zero grid before the first step.
- March: ``n_candidates`` stratified depths between the ray's entry into the
  [-bound, bound]^3 box (not nearer than ``min_near``) and its exit, each
  perturbed by (u - 0.5) of the spacing; of the occupied ones ``n_keep``
  kept, ranks floor((k + 0.5) n_occ / K) when more are occupied; alpha
  compositing with the gaps of the kept samples, the last one's the
  spacing; a white background.
- Loss: mean over rays and channels of the squared error.  Adam (0.9, 0.99,
  1e-15) at lr 0.1^(step / max_steps) of ``lr``, then the weights' EMA.
- A partial refresh: the EMA density grid decayed, one of the 2^3 parity
  classes of cells (its parity drawn first, then the jitter) raised to the
  field's sigma where that is larger.

The uniforms (the refreshes' draws, each step's perturbation) are drawn from
a ``torch.Generator`` in the states the caller gives.  Imports nothing of
the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.common import norms, sh_basis


@functools.lru_cache(maxsize=4)
def lattice_multipliers(t: int, n_levels: int, radius: int = 96, n_cand: int = 96,
                        seed: int = 7) -> tuple:
    """[n_levels] (P1, P2, P3) odd multipliers mod t: of ``n_cand`` random
    odd triples, those whose alias lattice {D : D.P = 0 mod t} has the
    longest shortest vector within |D|_inf <= radius, best first."""
    rng = np.random.default_rng(seed)
    ax = np.arange(-radius, radius + 1, dtype=np.int64)
    dx, dy = np.meshgrid(ax, ax, indexing="ij")
    origin = (dx == 0) & (dy == 0)
    scored = []
    for _ in range(n_cand):
        p = (rng.integers(1, t, 3) | 1).astype(np.int64)
        inv = pow(int(p[2]), -1, t)
        dz = (-((dx * p[0] + dy * p[1]) % t) * inv) % t
        dz = np.where(dz > t // 2, dz - t, dz)
        n2 = dx * dx + dy * dy + dz * dz
        hit = (np.abs(dz) <= radius) & ~origin
        cands = [int(n2[hit].min())] if hit.any() else []
        if t <= radius:
            cands.append(t * t)
        scored.append((min(cands) if cands else (radius + 1) ** 2, tuple(int(v) for v in p)))
    scored.sort(reverse=True)
    return tuple(scored[i % len(scored)][1] for i in range(n_levels))


def levels(cfg: dict) -> list:
    """Per level: dict(scale, S = res + 1, size, hashed)."""
    L, base = cfg["num_levels"], cfg["base_resolution"]
    b = np.exp2(np.log2(int(cfg["desired_resolution"] * cfg["bound"]) / base) / (L - 1))
    out = []
    for l in range(L):
        scale = np.exp2(l * np.log2(b)) * base - 1.0
        s = int(np.ceil(scale)) + 2
        size = int(np.ceil(min(2 ** cfg["log2_hashmap_size"], s ** 3) / 8) * 8)
        out.append({"scale": float(np.float32(scale)), "S": s, "size": size, "hashed": s ** 3 > size})
    return out


class Round(torch.autograd.Function):
    """Round the value to ``fwd`` and its gradient to ``bwd``, in float32."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return x.to(fwd).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.bwd).float(), None, None


OPERANDS = {"bf16": (torch.bfloat16, torch.bfloat16), "fp8": (torch.float8_e4m3fn, torch.bfloat16)}


class Field:
    """The field on explicit leaves: ``small`` [Ls, T, 2] and ``big``
    [Lb, T, 2] tables (level l's entry i at [l, i]), ``sigma`` and
    ``color`` lists of [in, out] weights."""

    def __init__(self, cfg: dict, leaves: list, operand: str = "bf16"):
        self.cfg = cfg
        self.lv = levels(cfg)
        self.n_small = sum(1 for v in self.lv if v["size"] < cfg["split_min_size"])
        self.leaves = leaves
        n_sig = cfg["num_layers"]
        self.small, self.big = leaves[0], leaves[1]
        self.sigma, self.color = leaves[2:2 + n_sig], leaves[2 + n_sig:]
        self.rnd = OPERANDS[operand]
        self.mult = lattice_multipliers(2 ** cfg["log2_hashmap_size"], len(self.lv) - self.n_small)

    def mlp(self, h, ws):
        h = Round.apply(h, *self.rnd)
        for i, w in enumerate(ws):
            h = h @ Round.apply(w, *self.rnd)
            if i != len(ws) - 1:
                h = Round.apply(torch.relu(h), *self.rnd)
        return h

    def encode(self, x01):
        feats = []
        for l, v in enumerate(self.lv):
            table = self.small[l] if l < self.n_small else self.big[l - self.n_small]
            pos = x01 * v["scale"] + 0.5
            cell = torch.floor(pos)
            f = pos - cell
            cell = cell.long()
            acc = 0.0
            for c in range(8):
                b = [(c >> a) & 1 for a in range(3)]
                w = 1.0
                for a in range(3):
                    w = w * (f[:, a] if b[a] else 1.0 - f[:, a])
                x, y, z = (cell[:, a] + b[a] for a in range(3))
                if v["hashed"]:
                    p = self.mult[l - self.n_small]
                    idx = (x * p[0] + y * p[1] + z * p[2]) % v["size"]
                else:
                    idx = x + v["S"] * (y + v["S"] * z)
                acc = acc + w[:, None] * table[idx]
            feats.append(acc)
        return torch.cat(feats, -1)

    def density(self, x):
        b = self.cfg["bound"]
        x01 = torch.clamp((x.reshape(-1, 3) / b + 1.0) * 0.5, 0.0, 1.0)
        h = self.mlp(self.encode(x01), self.sigma)
        sigma = TruncExp.apply(h[:, 0])
        return sigma.reshape(x.shape[:-1]), h[:, 1:].reshape(*x.shape[:-1], -1)

    def rgb(self, d, geo):
        h = torch.cat([sh_basis(d, self.cfg["sh_degree"]), geo], -1)
        return torch.sigmoid(self.mlp(h.reshape(-1, h.shape[-1]), self.color)).reshape(*d.shape[:-1], 3)


class TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


@torch.no_grad()
def occupancy(field: Field, cfg: dict, gen, chunk: int = 1 << 16) -> torch.Tensor:
    """[G^3] occupied cells after a full refresh of a zero grid."""
    g = cfg["grid_size"]
    xyz = (refresh_draws(cfg, gen, False, field.big.device) / g * 2.0 - 1.0) * cfg["bound"]
    sigma = torch.cat([field.density(xyz[i:i + chunk])[0] for i in range(0, xyz.shape[0], chunk)])
    dens = torch.clamp(sigma, min=0.0)
    return dens > torch.clamp(dens.mean(), max=cfg["density_thresh"])


def march(occ: torch.Tensor, o, d, cfg: dict, gen):
    """The occupancy march of unit rays (o, d) through ``occ`` [G^3] (bool),
    its perturbation drawn from ``gen``: (zk [N, K] kept depths, mk [N, K]
    valid, xyzk [N, K, 3] kept points, spacing [N])."""
    S, K, bound, g = cfg["n_candidates"], cfg["n_keep"], cfg["bound"], cfg["grid_size"]
    inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    t0, t1 = (-bound - o) * inv, (bound - o) * inv
    tmin, tmax = torch.minimum(t0, t1).amax(-1), torch.maximum(t0, t1).amin(-1)
    near = torch.clamp(tmin, min=cfg["min_near"])
    far = torch.maximum(tmax, near + 1e-6)
    hit = tmax > near
    spacing = (far - near) / S
    # i * f32(1 / (S - 1)), exactly 1 at the end
    t = torch.cat([torch.arange(S - 1, device=o.device).float() * float(np.float32(1) / np.float32(S - 1)),
                   torch.ones(1, device=o.device)])
    z = near[:, None] + (far - near)[:, None] * t[None, :]
    z = z + (torch.rand(z.shape, generator=gen, device=o.device) - 0.5) * spacing[:, None]
    xyz = torch.clamp(o[:, None] + d[:, None] * z[..., None], -bound, bound)
    cell = torch.clamp(((xyz / bound + 1.0) * 0.5 * g).long(), 0, g - 1)
    occd = occ[(cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]] & hit[:, None]
    n_occ = occd.sum(-1, keepdim=True)
    k = torch.arange(K, device=o.device)[None, :]
    rank = torch.where(n_occ > K, torch.floor((k + 0.5) * n_occ.float() / K).long(), k)
    # position of the rank-th occupied candidate
    csum = torch.cumsum(occd.long(), -1)
    pick = torch.searchsorted(csum, rank + 1).clamp(max=S - 1)
    zk = torch.gather(z, -1, pick)
    mk = k < n_occ
    xyzk = torch.clamp(o[:, None] + d[:, None] * zk[..., None], -bound, bound)
    return zk, mk, xyzk, spacing


def render(field: Field, occ: torch.Tensor, o, d, cfg: dict, gen) -> torch.Tensor:
    """[N, 3] colour of unit rays (o, d), perturbed by uniforms from ``gen``."""
    zk, mk, xyzk, spacing = march(occ, o, d, cfg, gen)
    sigma, geo = field.density(xyzk)
    sigma = torch.where(mk, sigma, 0.0)
    delta = torch.where(mk[:, 1:], zk[:, 1:] - zk[:, :-1], spacing[:, None])
    delta = torch.where(mk, torch.clamp(torch.cat([delta, spacing[:, None]], -1), min=0.0), 0.0)
    alpha = 1.0 - torch.exp(-delta * sigma)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-15], -1), -1)
    w = alpha * trans[:, :-1]
    rgb = torch.sum(w[..., None] * field.rgb(d[:, None].expand(xyzk.shape), geo), 1)
    return rgb + (1.0 - w.sum(-1))[:, None] * cfg["bg_color"]


def grid_cells(n: int, device) -> torch.Tensor:
    """[n^3, 3] integer cells, the last axis fastest."""
    idx = torch.arange(n, device=device)
    return torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1).reshape(-1, 3)


def refresh_draws(cfg: dict, gen, partial: bool, device) -> torch.Tensor:
    """[cells, 3] jittered cells (grid units) an occupancy refresh samples:
    every cell, or (partial) one of the 2^3 parity classes, whose parity
    [3] is drawn first, then the jitter."""
    g = cfg["grid_size"]
    if not partial:
        cells = grid_cells(g, device).float()
    else:
        parity = torch.randint(0, 2, (3,), generator=gen, device=device)
        cells = (grid_cells(g // 2, device) * 2 + parity[None, :]).float()
    return cells + torch.rand(cells.shape, generator=gen, device=device)


@torch.no_grad()
def partial_refresh(cfg: dict, leaves: list, density: torch.Tensor, state, device,
                    operand: str = "bf16", chunk: int = 1 << 16) -> dict:
    """One partial refresh of the EMA density grid [G, G, G] by the field on
    ``leaves``, its draws from a generator in ``state``: the grid decayed by
    ``decay`` (cells at -1 stay), the sampled class raised to the field's
    sigma where that is larger.  Returns the class's cells [n] (flat) and
    their new densities [n], and their densities decayed alone [n]."""
    g = cfg["grid_size"]
    gen = torch.Generator(device=device)
    gen.set_state(state)
    field = Field(cfg, [t.to(device).float() for t in leaves], operand)
    pts = refresh_draws(cfg, gen, True, device)
    xyz = (pts / g * 2.0 - 1.0) * cfg["bound"]
    sigma = torch.cat([field.density(xyz[i:i + chunk])[0] for i in range(0, xyz.shape[0], chunk)])
    flat = ((pts.long()[:, 0] * g + pts.long()[:, 1]) * g + pts.long()[:, 2])
    old = density.to(device).reshape(-1)[flat]
    decayed = torch.where(old < 0, old, old * cfg["decay"])
    return {"cells": flat.cpu(), "decayed": decayed.cpu(),
            "density": torch.where(decayed < 0, decayed, torch.maximum(decayed, sigma)).cpu()}


def train(cfg: dict, init: list, steps: list, refresh_state, device, operand: str = "bf16",
          fault=None) -> dict:
    """Run ``steps`` (each (origins, dirs, rgb, generator state)) from the
    ``init`` leaves after a full refresh drawn from ``refresh_state``.
    Returns the readings: each step's loss, the first gradient's norm, and
    the change of the parameters and of their EMA (decay ``ema_decay``)
    after the steps, per leaf.  ``fault`` "half" trains on the first half of
    each batch (a planted fault)."""
    params = [t.to(device).float().clone() for t in init]
    ema = [p.clone() for p in params]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    gen = torch.Generator(device=device)
    gen.set_state(refresh_state)
    occ = occupancy(Field(cfg, params, operand), cfg, gen)
    out = {"loss": [], "grad": None}
    for step, (o, d, rgb, state) in enumerate(steps):
        gen.set_state(state)
        leaves = [p.detach().requires_grad_(True) for p in params]
        o, d, rgb = o.to(device), d.to(device), rgb.to(device)
        if fault == "half":
            n = o.shape[0] // 2
            o, d, rgb = o[:n], d[:n], rgb[:n]
        loss = torch.mean((render(Field(cfg, leaves, operand), occ, o, d, cfg, gen) - rgb) ** 2)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        out["loss"].append(float(loss.detach()))
        if step == 0:
            out["grad"] = norms(grads)
        lr = float(np.float32(cfg["lr"]) * np.float32(0.1) ** min(np.float32(step) / np.float32(cfg["max_steps"]), 1.0))
        c1, c2 = 1.0 - 0.9 ** (step + 1), 1.0 - 0.99 ** (step + 1)
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, mu, nu):
                m.mul_(0.9).add_(g, alpha=0.1)
                v.mul_(0.99).addcmul_(g, g, value=0.01)
                p.add_((m / c1) / (torch.sqrt(v / c2) + 1e-15), alpha=-lr)
            for e, p in zip(ema, params):
                e.mul_(cfg["ema_decay"]).add_(p, alpha=1.0 - cfg["ema_decay"])
    out["change"] = norms([p - i.to(device).float() for p, i in zip(params, init)])
    out["ema"] = norms([e - i.to(device).float() for e, i in zip(ema, init)])
    return out

"""SDF fitting: a hash-grid field regressed on signed distances, and its mesh.

Port of ``flnerf_tpu/models/sdf.py`` (ngp-ours/sdf re-designed):
  * ``SDFField``: the packed hash encoding + a bias-free MLP -> sdf (no
    output activation).  The table is encoded through
    ``ops/hash_kernel.hash_encode``: K3 (forward) and K4 (table gradient) on
    the card, the plain version on the CPU.  ``hash_backend="xla"`` forces
    the plain version on any device; ``hash_chunk`` was a TPU tiling knob
    and is accepted and ignored;
  * ``sample_sdf_batch`` (sdf/provider.py): half near-surface, half uniform
    samples, in numpy line for line, so both packages draw the same batches
    from one ``np.random.default_rng``;
  * ``SDFTrainer`` (sdf/utils.py:83): MAPE regression with Adam (betas 0.9,
    0.99, eps 1e-15: ``optax.adam``'s update) and the mesh export through
    ``ops/marching.py``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from flnerf_tpu_torch.core.device import resolve_device
from flnerf_tpu_torch.core.losses import mape_loss
from flnerf_tpu_torch.models.hash_ngp import _linear_nobias, mlp_chain
from flnerf_tpu_torch.ops.hash_kernel import (
    hash_encode,
    hash_encode_plain,
    init_packed_table,
    make_packed_spec,
)


class SDFConfig(NamedTuple):
    num_levels: int = 16
    level_dim: int = 2
    log2_hashmap_size: int = 15
    desired_resolution: int = 2048
    num_layers: int = 3
    hidden_dim: int = 64
    bound: float = 1.0
    hash_backend: str = "auto"     # 'xla' forces the plain encode
    hash_chunk: int = 2048         # the TPU kernel's tile; ignored here


class SDFField(nn.Module):
    """``table`` [L, T_cap, C] and ``net`` (bias-free [in, out] weights), in
    that parameter order, drawn from ``generator``."""

    def __init__(self, cfg: SDFConfig, compute_dtype=torch.bfloat16, generator=None,
                 device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.spec = make_packed_spec(num_levels=cfg.num_levels, level_dim=cfg.level_dim,
                                     log2_hashmap_size=cfg.log2_hashmap_size,
                                     desired_resolution=cfg.desired_resolution)
        self.table = nn.Parameter(init_packed_table(self.spec, generator, device))
        dims = [self.spec.output_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1) + [1]
        self.net = nn.ParameterList([_linear_nobias(a, b, generator, device)
                                     for a, b in zip(dims, dims[1:])])

    @property
    def device(self) -> torch.device:
        return self.table.device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Points x [..., 3] in [-bound, bound] -> sdf [...]."""
        sh = x.shape[:-1]
        x01 = torch.clamp((x.reshape(-1, 3) / self.cfg.bound + 1.0) * 0.5, 0.0, 1.0)
        encode = hash_encode_plain if self.cfg.hash_backend == "xla" else hash_encode
        h = mlp_chain(encode(x01, self.table, self.spec), self.net, self.compute_dtype)
        return h[..., 0].reshape(sh)


def sample_sdf_batch(rng: np.random.Generator, oracle: Callable, n: int,
                     bound: float = 1.0, surface_frac: float = 0.5):
    """SDFDataset-style batch (sdf/provider.py): ~half near-surface samples
    (uniform points moved onto the level set along the numeric gradient,
    then jittered), the rest uniform in the cube."""
    n_surf = int(n * surface_frac)
    pts = rng.uniform(-bound, bound, (n, 3)).astype(np.float32)
    if n_surf:
        p = pts[:n_surf]
        eps = 1e-3
        d = oracle(p)
        grad = np.stack(
            [
                (oracle(p + eps * np.eye(3, dtype=np.float32)[i]) - d) / eps
                for i in range(3)
            ],
            -1,
        )
        g = grad / np.maximum(np.linalg.norm(grad, axis=-1, keepdims=True), 1e-6)
        p = p - d[:, None] * g
        p += rng.normal(0, 0.01, p.shape).astype(np.float32)
        pts[:n_surf] = np.clip(p, -bound, bound)
    sdf = oracle(pts).astype(np.float32)
    return pts, sdf


class SDFTrainer:
    """Supervised SDF regression (sdf/utils.py:83 Trainer analog) on one
    device (default the card; with none it raises).  Losses are read back
    once per ``fit``."""

    def __init__(self, cfg: SDFConfig, lr: float = 1e-3, seed: int = 0,
                 compute_dtype=torch.float32, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.field = SDFField(cfg, compute_dtype, gen, self.device)
        self.opt = torch.optim.Adam(self.field.parameters(), lr=lr, betas=(0.9, 0.99),
                                    eps=1e-15)

    def step(self, pts: np.ndarray, sdf: np.ndarray) -> torch.Tensor:
        """One Adam step on a batch; returns the loss as a device tensor."""
        pts = torch.as_tensor(pts, device=self.device)
        sdf = torch.as_tensor(sdf, device=self.device).reshape(-1)
        loss = mape_loss(self.field(pts), sdf)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def fit(self, oracle: Callable, steps: int = 200, batch: int = 4096, seed: int = 0):
        rng = np.random.default_rng(seed)
        losses = [self.step(*sample_sdf_batch(rng, oracle, batch, self.cfg.bound))
                  for _ in range(steps)]
        return torch.stack(losses).cpu().tolist()

    def fit_dataset(self, dataset, steps: int = 200):
        """Train from a provider with ``sample_batch() -> (pts, sdf)`` (the
        mesh path, ``data/mesh_sdf.SDFMeshDataset``)."""
        losses = [self.step(*dataset.sample_batch()) for _ in range(steps)]
        return torch.stack(losses).cpu().tolist()

    @torch.no_grad()
    def extract_mesh(self, reso: int = 128, chunk: int = 1 << 16, algo: str = "cubes"):
        """Iso-surface of the learned SDF (save_mesh analog): the field on a
        reso^3 grid over [-bound, bound]^3, ``chunk`` points a call (the
        last zero-padded, as the reference pads), then marching cubes by
        default, marching tetrahedra as the denser variant."""
        from flnerf_tpu_torch.ops.marching import marching_cubes, marching_tetrahedra

        b = self.cfg.bound
        g = np.linspace(-b, b, reso, dtype=np.float32)
        X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
        pts = np.stack([X, Y, Z], -1).reshape(-1, 3)
        n = pts.shape[0]
        n_pad = (n + chunk - 1) // chunk * chunk
        pp = np.zeros((n_pad, 3), np.float32)
        pp[:n] = pts
        pp = torch.from_numpy(pp).to(self.device)
        out = torch.cat([self.field(pp[i:i + chunk]) for i in range(0, n_pad, chunk)])
        field = out[:n].reshape(reso, reso, reso).cpu().numpy()
        march = marching_cubes if algo == "cubes" else marching_tetrahedra
        # inside = sdf < 0 -> pass -sdf so "inside" is positive
        return march(-field, iso=0.0, origin=(-b,) * 3, spacing=(g[1] - g[0],) * 3)

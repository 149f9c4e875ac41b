"""Weights carried across: the reference package's Plenoxels state, given as
numpy arrays, into this port's tensors, and back.

The reference (``flnerf_tpu/models/voxel_sh.py`` ``VoxelGrid`` and
``flnerf_tpu/train/plenoxels_trainer.py`` ``PlenoxelsState``) keeps the same
dense layouts as the port: density [X,Y,Z] f32, sh [X,Y,Z,27] f32, alive
[X,Y,Z] bool, RMSProp accumulators shaped like density and sh, and an int
step.  ``np.asarray`` of its arrays gives the inputs here.
"""

from __future__ import annotations

import numpy as np
import torch

from flnerf_tpu_torch.models.voxel_sh import VoxelGrid
from flnerf_tpu_torch.train.plenoxels_trainer import PlenoxelsState


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def voxel_grid_from_numpy(density, sh, alive, device="cpu") -> VoxelGrid:
    density = _f32(density, device)
    sh = _f32(sh, device)
    alive = torch.tensor(np.asarray(alive, bool), device=device)
    if sh.shape[:3] != density.shape or alive.shape != density.shape:
        raise ValueError(f"grid shapes disagree: density {tuple(density.shape)}, "
                         f"sh {tuple(sh.shape)}, alive {tuple(alive.shape)}")
    return VoxelGrid(density, sh, alive)


def plenoxels_state_from_numpy(density, sh, alive, rms_density, rms_sh, step,
                               device="cpu") -> PlenoxelsState:
    grid = voxel_grid_from_numpy(density, sh, alive, device)
    rms_density = _f32(rms_density, device)
    rms_sh = _f32(rms_sh, device)
    if rms_density.shape != grid.density.shape or rms_sh.shape != grid.sh.shape:
        raise ValueError("RMSProp accumulators must be shaped like density and sh")
    return PlenoxelsState(grid, rms_density, rms_sh, int(step))


def voxel_grid_to_numpy(grid: VoxelGrid):
    """(density, sh, alive) as numpy arrays."""
    return tuple(t.detach().cpu().numpy() for t in grid)


def plenoxels_state_to_numpy(state: PlenoxelsState):
    """(density, sh, alive, rms_density, rms_sh, step)."""
    return voxel_grid_to_numpy(state.grid) + (
        state.rms_density.cpu().numpy(), state.rms_sh.cpu().numpy(),
        int(state.step))

"""NeRF checkpoints in the reference's ``.tar`` format.

Port of the NeRF half of ``flnerf_tpu/core/checkpoint.py``
(``save_nerf_checkpoint``, ``load_nerf_checkpoint``,
``find_latest_checkpoint``):

  * ``{basedir}/{expname}/{epoch:03d}.tar`` — a torch.save dict with keys
    {global_epoch, global_iter, network_fn_state_dict,
    network_fine_state_dict, optimizer_state_dict}
    (nerf-ours/run_nerf.py:532-539); the model state dicts carry the
    DataParallel ``module.`` prefix (run_nerf.py:82,90) and ``nn.Linear``
    naming; the optimizer state is torch Adam's, indexed over
    ``list(coarse.parameters()) + list(fine.parameters())`` (run_nerf.py:83,91).
  * ``treeDivide_{epoch:04d}.pkl`` — the quadtree next to the weights
    (run_nerf.py:542-544); ``QuadTreeForest.save/load``.

A ``.tar`` written by either package loads in the other.  The reference's
orbax checkpoints (``save_orbax``/``load_orbax``) write JAX arrays with
their TPU shardings and have no counterpart here.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

PREFIX = "module."


def _params(coarse, fine) -> list:
    """Adam's index order (run_nerf.py:83,91)."""
    return list(coarse.parameters()) + (list(fine.parameters()) if fine is not None else [])


def _adam_state(optimizer: torch.optim.Adam, params, step: int) -> dict:
    """torch Adam's state-dict layout with CPU tensors and the step as a
    float tensor, as the reference writes it."""
    state = {}
    for i, p in enumerate(params):
        s = optimizer.state.get(p)
        if not s:
            continue
        state[i] = {"step": torch.tensor(float(step)),
                    "exp_avg": s["exp_avg"].detach().cpu().clone(),
                    "exp_avg_sq": s["exp_avg_sq"].detach().cpu().clone()}
    groups = optimizer.state_dict()["param_groups"]
    return {"state": state, "param_groups": groups}


def save_nerf_checkpoint(path: str, epoch: int, global_iter: int, coarse, fine=None,
                         optimizer: Optional[torch.optim.Adam] = None) -> None:
    """Write a reference-compatible {epoch:03d}.tar (run_nerf.py:532-539)."""

    def sd(module):
        return {PREFIX + k: v.detach().cpu().clone() for k, v in module.state_dict().items()}

    payload = {
        "global_epoch": int(epoch),
        "global_iter": int(global_iter),
        "network_fn_state_dict": sd(coarse),
        "network_fine_state_dict": sd(fine) if fine is not None else None,
    }
    if optimizer is not None:
        payload["optimizer_state_dict"] = _adam_state(optimizer, _params(coarse, fine),
                                                      global_iter)
    torch.save(payload, path)


def _strip(sd: dict) -> dict:
    return {k[len(PREFIX):] if k.startswith(PREFIX) else k: torch.as_tensor(v)
            for k, v in sd.items()}


def load_nerf_checkpoint(path: str, coarse, fine=None,
                         optimizer: Optional[torch.optim.Adam] = None):
    """Load a .tar from either package into ``coarse``/``fine`` (and the
    Adam moments into ``optimizer``), in place on their device.

    Returns (epoch, global_iter).
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    coarse.load_state_dict(_strip(ckpt["network_fn_state_dict"]))
    if fine is not None and ckpt.get("network_fine_state_dict") is not None:
        fine.load_state_dict(_strip(ckpt["network_fine_state_dict"]))
    if optimizer is not None and "optimizer_state_dict" in ckpt:
        saved = ckpt["optimizer_state_dict"]["state"]
        for i, p in enumerate(_params(coarse, fine)):
            if i not in saved:
                continue
            s = saved[i]
            optimizer.state[p] = {
                # torch Adam keeps a float32 step on the CPU (not capturable)
                "step": torch.tensor(float(s["step"]), dtype=torch.float32),
                "exp_avg": torch.as_tensor(s["exp_avg"]).to(p.device, torch.float32),
                "exp_avg_sq": torch.as_tensor(s["exp_avg_sq"]).to(p.device, torch.float32),
            }
    return int(ckpt.get("global_epoch", 0)), int(ckpt.get("global_iter", 0))


def load_nerf_query_network(path: str, module) -> str:
    """Load into ``module`` the network a density query reads: the fine
    network when the .tar has one, else the coarse one (extract_mesh's
    choice).  Returns "fine" or "coarse"."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    which = "fine" if ckpt.get("network_fine_state_dict") is not None else "coarse"
    key = "network_fine_state_dict" if which == "fine" else "network_fn_state_dict"
    module.load_state_dict(_strip(ckpt[key]))
    return which


def find_latest_checkpoint(log_dir: str) -> Optional[str]:
    """Auto-resume: lexically-last *.tar in the run dir (run_nerf.py:112-118)."""
    if not os.path.isdir(log_dir):
        return None
    ckpts = sorted(f for f in os.listdir(log_dir) if f.endswith(".tar"))
    return os.path.join(log_dir, ckpts[-1]) if ckpts else None

"""SDF-fitting CLI (ngp-ours/main_sdf.py analog).

Port of ``flnerf_tpu/cli/main_sdf.py``, flag for flag, plus ``--device``
(default ``cuda``; with no card it raises unless ``--device cpu``).  The
input is one of the analytic shapes (``sphere``, ``box``, ``torus``), a
``.obj`` / ``.ply`` mesh (``data/mesh_sdf.SDFMeshDataset``, the reference's
SDFDataset path without pysdf), or a ``.npz`` of precomputed ``points`` and
``sdf`` samples looked up by their nearest sample (scipy's cKDTree).  The
fit ends in ``mesh.obj`` in the workspace.

Usage:
  python -m flnerf_tpu_torch.cli.main_sdf sphere --iters 500 --workspace /tmp/sdf
  python -m flnerf_tpu_torch.cli.main_sdf mesh.obj --iters 2000
  python -m flnerf_tpu_torch.cli.main_sdf samples.npz --iters 20000
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _analytic_oracle(name: str):
    if name == "sphere":
        return lambda p: np.linalg.norm(np.asarray(p), axis=-1) - 0.5
    if name == "box":
        def box(p):
            q = np.abs(np.asarray(p)) - 0.4
            outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
            inside = np.minimum(np.max(q, axis=-1), 0.0)
            return outside + inside
        return box
    if name == "torus":
        def torus(p):
            p = np.asarray(p)
            q = np.stack([np.linalg.norm(p[..., :2], axis=-1) - 0.45, p[..., 2]], -1)
            return np.linalg.norm(q, axis=-1) - 0.15
        return torus
    return None


def _samples_oracle(path: str):
    """Nearest-sample lookup over a .npz of (points, sdf)."""
    from scipy.spatial import cKDTree

    data = np.load(path)
    sdf_all = data["sdf"].astype(np.float32)
    tree = cKDTree(data["points"].astype(np.float32))

    def oracle(p):
        _, idx = tree.query(np.asarray(p))
        return sdf_all[idx]

    return oracle


def make_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str, help="analytic shape name, mesh or samples .npz")
    parser.add_argument("--workspace", type=str, default="workspace_sdf")
    parser.add_argument("--iters", type=int, default=20000)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--bound", type=float, default=1.0)
    parser.add_argument("--mesh_reso", type=int, default=128)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda or cpu)")
    return parser


def main(argv=None):
    from flnerf_tpu_torch.models.sdf import SDFConfig, SDFTrainer
    from flnerf_tpu_torch.ops.marching import save_obj

    args = make_parser().parse_args(argv)
    cfg = SDFConfig(bound=args.bound)
    trainer = SDFTrainer(cfg, lr=args.lr, seed=args.seed, device=args.device)
    os.makedirs(args.workspace, exist_ok=True)

    if args.path.endswith((".obj", ".ply")):
        from flnerf_tpu_torch.data.mesh_sdf import SDFMeshDataset

        ds = SDFMeshDataset(args.path, num_samples=args.batch, seed=args.seed,
                            device=trainer.device)
        losses = trainer.fit_dataset(ds, steps=args.iters)
    else:
        oracle = _analytic_oracle(args.path) or _samples_oracle(args.path)
        losses = trainer.fit(oracle, steps=args.iters, batch=args.batch, seed=args.seed)
    print(f"final mape loss: {losses[-1]:.5f}")

    verts, tris = trainer.extract_mesh(reso=args.mesh_reso)
    out = os.path.join(args.workspace, "mesh.obj")
    save_obj(out, verts, tris)
    print(f"wrote {out}: {len(verts)} verts, {len(tris)} tris")
    return {"loss": losses[-1], "n_verts": len(verts), "losses": losses, "trainer": trainer,
            "mesh": (verts, tris)}


if __name__ == "__main__":
    main()

"""Mesh extraction from a trained field (nerf-ours/extract_mesh.py analog).

Port of ``flnerf_tpu/cli/extract_mesh.py``, flag for flag, plus ``--device``
(default ``cuda``; with no card it raises unless ``--device cpu``):
  * a NeRF ``.tar`` (``core/checkpoint.py``, either package's): sigma of the
    fine network (the coarse one without it), f32, queried with the fixed
    view direction (0, 0, -1) on a reso^3 grid over [-bound, bound]^3 in
    chunks of 65,536 points;
  * a Plenoxels ``.npz`` (``models/voxel_sh.load_npz``): the density grid
    itself, zero where not alive;
then marching cubes (``--algo cubes``, the reference's PyMCubes choice) or
tetrahedra (``ops/marching.py``) at ``--sigma_thresh``, written as PLY when
``--out`` ends in .ply and as OBJ otherwise.

Usage:
  python -m flnerf_tpu_torch.cli.extract_mesh --ckpt logs/lego/018.tar --out lego.obj \\
      --bound 1.2 --reso 256 --sigma_thresh 25
  python -m flnerf_tpu_torch.cli.extract_mesh --ckpt ckpt.npz --out grid.ply
"""

from __future__ import annotations

import argparse

import numpy as np


def density_grid_from_nerf(mlp, bound: float, reso: int, chunk: int = 65536):
    """Raw sigma of ``mlp`` (a ``models/nerf_mlp.NerfMLP``) on a reso^3 grid
    in [-bound, bound]^3, the last chunk zero-padded.  Returns (sigma
    [reso]^3 numpy, the grid's axis)."""
    import torch

    g = np.linspace(-bound, bound, reso, dtype=np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([X, Y, Z], -1).reshape(-1, 3)
    n = pts.shape[0]
    n_pad = (n + chunk - 1) // chunk * chunk
    pts_pad = np.zeros((n_pad, 3), np.float32)
    pts_pad[:n] = pts
    dev = next(mlp.parameters()).device
    pts_pad = torch.from_numpy(pts_pad).to(dev)
    d = torch.tensor([0.0, 0.0, -1.0], device=dev).expand(chunk, 3)
    with torch.no_grad():
        out = [mlp.query(pts_pad[i:i + chunk, None, :], d)[:, 0, 3]
               for i in range(0, n_pad, chunk)]
    return torch.cat(out)[:n].reshape(reso, reso, reso).cpu().numpy(), g


def make_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", type=str, required=True, help=".tar or .npz checkpoint")
    parser.add_argument("--out", type=str, default="mesh.obj")
    parser.add_argument("--bound", type=float, default=1.2)
    parser.add_argument("--reso", type=int, default=192)
    parser.add_argument("--sigma_thresh", type=float, default=25.0)
    parser.add_argument("--algo", choices=["cubes", "tetrahedra"], default="cubes")
    parser.add_argument("--multires", type=int, default=10)
    parser.add_argument("--multires_views", type=int, default=4)
    parser.add_argument("--netdepth", type=int, default=8)
    parser.add_argument("--netwidth", type=int, default=256)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device for the NeRF query (cuda or cpu)")
    return parser


def main(argv=None):
    import torch

    from flnerf_tpu_torch.core.device import resolve_device
    from flnerf_tpu_torch.ops.marching import (
        marching_cubes,
        marching_tetrahedra,
        save_obj,
        save_ply,
    )

    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    march = marching_cubes if args.algo == "cubes" else marching_tetrahedra
    if args.ckpt.endswith(".npz"):
        # a Plenoxels grid: the density field is the grid
        from flnerf_tpu_torch.models.voxel_sh import load_npz

        grid, gcfg = load_npz(args.ckpt)
        field = np.where(grid.alive.numpy(), grid.density.numpy(), 0.0)
        spacing = tuple(2 * r / (n - 1) for r, n in zip(gcfg.radius, gcfg.reso))
        origin = tuple(-r for r in gcfg.radius)
        verts, tris = march(field, iso=args.sigma_thresh, origin=origin, spacing=spacing)
    else:
        from flnerf_tpu_torch.core.checkpoint import load_nerf_query_network
        from flnerf_tpu_torch.models.nerf_mlp import make_nerf_mlp

        mlp = make_nerf_mlp(multires=args.multires, multires_views=args.multires_views,
                            netdepth=args.netdepth, netwidth=args.netwidth,
                            use_viewdirs=True, compute_dtype=torch.float32, device=device)
        load_nerf_query_network(args.ckpt, mlp)
        field, g = density_grid_from_nerf(mlp, args.bound, args.reso)
        verts, tris = march(field, iso=args.sigma_thresh, origin=(-args.bound,) * 3,
                            spacing=(g[1] - g[0],) * 3)

    print(f"extracted {len(verts)} vertices, {len(tris)} triangles")
    (save_ply if args.out.endswith(".ply") else save_obj)(args.out, verts, tris)
    print("wrote", args.out)
    return len(verts), len(tris)


if __name__ == "__main__":
    main()

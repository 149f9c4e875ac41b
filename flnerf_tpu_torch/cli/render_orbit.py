"""Orbit-path renderer — the offline substitute for the dearpygui viewer
(ngp-ours/nerf/gui.py NeRFGUI) and plenoxels' render_imgs_circle.py.

Port of ``flnerf_tpu/cli/render_orbit.py``: renders a spherical camera
orbit from a trained checkpoint to a PNG sequence (``data/png.py``'s codec)
and a GIF (imageio, imported for the GIF only: without it the GIF raises an
ImportError naming imageio, and ``--no_gif`` skips it), plus ``--device``
(default ``cuda``).

  * A Plenoxels ``.npz`` renders through ``render_grid_image`` on the
    loaded grid (K1 on the card, no trainer and no optimizer state), with
    its MSI background when it has one.  Its config
    comes from ``load_npz``, which keeps no march settings, so the orbit
    marches load_npz's 512 steps of 0.5 voxel, as ``render_imgs`` does
    (ROADMAP.md R9, the reference's behaviour).
  * A NeRF ``.tar`` renders through ``render/renderer.render_image`` with
    the reference's bf16 MLPs (``--multires`` ... ``--netwidth`` must match
    the checkpoint); it launches no kernel.

Usage:
  python -m flnerf_tpu_torch.cli.render_orbit --ckpt logs/lego/018.tar --out orbit/
  python -m flnerf_tpu_torch.cli.render_orbit --ckpt plx/ckpt07.npz --out orbit/ --n_frames 24
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    import torch

    from flnerf_tpu_torch.core.device import resolve_device
    from flnerf_tpu_torch.core.metrics import to8b
    from flnerf_tpu_torch.data.png import mimwrite, write_png
    from flnerf_tpu_torch.rays.camera import intrinsics_matrix, pose_spherical

    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--out", type=str, default="orbit")
    parser.add_argument("--n_frames", type=int, default=40)
    parser.add_argument("--H", type=int, default=200)
    parser.add_argument("--W", type=int, default=200)
    parser.add_argument("--focal", type=float, default=0.0, help="0 = 1.1*W")
    parser.add_argument("--radius", type=float, default=4.0)
    parser.add_argument("--phi", type=float, default=-30.0)
    parser.add_argument("--chunk", type=int, default=8192)
    # nerf-mlp checkpoint architecture (must match the .tar)
    parser.add_argument("--multires", type=int, default=10)
    parser.add_argument("--multires_views", type=int, default=4)
    parser.add_argument("--netdepth", type=int, default=8)
    parser.add_argument("--netwidth", type=int, default=256)
    parser.add_argument("--no_gif", action="store_true",
                        help="write the PNG frames only (the GIF needs imageio)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (cuda or cpu)")
    args = parser.parse_args(argv)
    if not args.ckpt.endswith((".npz", ".tar")):
        raise SystemExit(f"unsupported checkpoint: {args.ckpt}")
    device = resolve_device(args.device)

    H, W = args.H, args.W
    focal = args.focal or 1.1 * W
    K = intrinsics_matrix(H, W, focal)
    thetas = np.linspace(-180, 180, args.n_frames, endpoint=False)
    poses = [pose_spherical(t, args.phi, args.radius)[:3, :4] for t in thetas]

    if args.ckpt.endswith(".npz"):
        from flnerf_tpu_torch.models.voxel_sh import load_npz
        from flnerf_tpu_torch.train.plenoxels_trainer import render_grid_image

        grid, gcfg = load_npz(args.ckpt, device=device)

        def render(c2w):
            return render_grid_image(grid, gcfg, H, W, K, c2w, chunk=args.chunk)
    else:
        from flnerf_tpu_torch.core.checkpoint import load_nerf_checkpoint
        from flnerf_tpu_torch.models.nerf_mlp import make_nerf_mlp
        from flnerf_tpu_torch.render.renderer import RenderConfig, render_image

        def mlp():
            return make_nerf_mlp(multires=args.multires, multires_views=args.multires_views,
                                 netdepth=args.netdepth, netwidth=args.netwidth, device=device)

        ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=False)
        coarse = mlp()
        fine = mlp() if ckpt.get("network_fine_state_dict") is not None else None
        load_nerf_checkpoint(args.ckpt, coarse, fine)
        rc = RenderConfig(near=2.0, far=6.0, white_bkgd=True)

        def render(c2w):
            return render_image(coarse, fine, rc, H, W, K, c2w, args.chunk)[0]

    os.makedirs(args.out, exist_ok=True)
    frames = []
    for i, c2w in enumerate(poses):
        frame = to8b(np.asarray(render(c2w)))
        write_png(os.path.join(args.out, f"{i:03d}.png"), frame)
        frames.append(frame)
        print(f"frame {i+1}/{len(poses)}")

    if not args.no_gif:
        gif = os.path.join(args.out, "orbit.gif")
        mimwrite(gif, frames, duration=0.08, loop=0)
        print("wrote", gif)
    return len(frames)


if __name__ == "__main__":
    main()

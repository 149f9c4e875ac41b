"""Convert a plenoxels ckpt.npz to a PlenOctree (svox1) npz.

Port of ``flnerf_tpu/cli/to_svox1.py`` (reference: plenoxels-ours/opt/
to_svox1.py + svox2.py:1635 to_svox1).  A host export: the grid loads on
the CPU and no card is needed.

Usage:
  python -m flnerf_tpu_torch.cli.to_svox1 ckpt/exp/ckpt07.npz
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("ckpt", type=str)
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)

    from flnerf_tpu_torch.core.svox1_export import save_svox1_npz
    from flnerf_tpu_torch.models.voxel_sh import load_npz

    grid, cfg = load_npz(args.ckpt, device="cpu")
    out_path = args.out or os.path.splitext(args.ckpt)[0] + "_svox1.npz"
    save_svox1_npz(
        out_path,
        grid.density.numpy(),
        grid.sh.numpy(),
        grid.alive.numpy(),
        cfg.radius,
        cfg.center,
        basis_dim=cfg.basis_dim,
    )
    print(f"saved {out_path}")
    return out_path


if __name__ == "__main__":
    main()

"""COLMAP/LLFF -> transforms.json conversion CLI
(ngp-ours/scripts/colmap2nerf.py + llff2nerf.py analog; the COLMAP feature
extraction/mapping itself requires the colmap binary, which cli/run_colmap.py
drives — this tool converts an EXISTING sparse model).

Port of ``flnerf_tpu/cli/colmap2nerf.py``.

Usage:
  python -m flnerf_tpu_torch.cli.colmap2nerf --colmap_sparse scene/sparse/0 --out transforms.json
  python -m flnerf_tpu_torch.cli.colmap2nerf --llff scene_dir --out transforms.json
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from flnerf_tpu_torch.data.colmap import (
        colmap_to_transforms,
        llff_to_transforms,
        write_transforms,
    )

    parser = argparse.ArgumentParser()
    parser.add_argument("--colmap_sparse", type=str, default=None,
                        help="COLMAP sparse model dir (cameras/images .bin|.txt)")
    parser.add_argument("--llff", type=str, default=None,
                        help="LLFF scene dir containing poses_bounds.npy")
    parser.add_argument("--images", type=str, default="images")
    parser.add_argument("--aabb_scale", type=int, default=4)
    parser.add_argument("--out", type=str, default="transforms.json")
    args = parser.parse_args(argv)

    if args.colmap_sparse:
        t = colmap_to_transforms(args.colmap_sparse, args.images, args.aabb_scale)
    elif args.llff:
        t = llff_to_transforms(args.llff, args.images)
    else:
        raise SystemExit("need --colmap_sparse or --llff")
    write_transforms(t, args.out)
    print(f"wrote {args.out} with {len(t['frames'])} frames")
    return t


if __name__ == "__main__":
    main()

"""COLMAP SfM pipeline driver -> normalized cam dict + nerf++ split dirs.

Reference: nerf++-ours/colmap_runner/run_colmap.py (feature extraction ->
exhaustive matching -> mapper -> undistort, then cam-dict extraction +
unit-sphere normalization).  This driver keeps the same stage sequence and
flag choices but reads the sparse model with this repo's own binary
readers (data/colmap.py) and normalizes poses in pure numpy
(data/pose_tools.py) — no pyquaternion/open3d/trimesh dependencies.

Port of ``flnerf_tpu/cli/run_colmap.py`` (the same stage commands, the
same cam dicts and split layout).  The COLMAP binary does not ship with the
package; point --colmap_bin (or $COLMAP_BIN) at one.  The post-SfM stages (extraction,
normalization, split layout) are pure Python and fixture-tested; the
subprocess runner is injectable for tests.

Usage:
  python -m flnerf_tpu_torch.cli.run_colmap --img_dir photos/ --out_dir scene/
"""

from __future__ import annotations

import argparse
import os
import subprocess
from typing import Callable, Optional

from flnerf_tpu_torch.data.pose_tools import (
    cam_dict_from_colmap,
    normalize_cam_dict,
    save_cam_dict,
    write_nerfpp_split,
)


def _colmap_cmds(colmap_bin: str, img_dir: str, out_dir: str,
                 use_gpu: bool = False):
    """The stage list (run_colmap.py:20-75 flag choices, CPU-safe)."""
    db = os.path.join(out_dir, "database.db")
    sparse = os.path.join(out_dir, "sparse")
    mvs = os.path.join(out_dir, "mvs")
    gpu = "1" if use_gpu else "0"
    return [
        [colmap_bin, "feature_extractor",
         "--database_path", db, "--image_path", img_dir,
         "--ImageReader.single_camera", "1",
         "--ImageReader.camera_model", "SIMPLE_RADIAL",
         "--SiftExtraction.max_num_features", "16384",
         "--SiftExtraction.use_gpu", gpu],
        [colmap_bin, "exhaustive_matcher",
         "--database_path", db,
         "--SiftMatching.guided_matching", "1",
         "--SiftMatching.use_gpu", gpu],
        [colmap_bin, "mapper",
         "--database_path", db, "--image_path", img_dir,
         "--output_path", sparse,
         "--Mapper.tri_min_angle", "3.0",
         "--Mapper.filter_min_tri_angle", "3.0"],
        [colmap_bin, "image_undistorter",
         "--image_path", img_dir,
         "--input_path", os.path.join(sparse, "0"),
         "--output_path", mvs,
         "--output_type", "COLMAP",
         "--max_image_size", "2000"],
    ]


def run_pipeline(
    img_dir: str,
    out_dir: str,
    colmap_bin: Optional[str] = None,
    target_radius: float = 1.0,
    split: str = "train",
    runner: Optional[Callable] = None,
    skip_sfm: bool = False,
) -> dict:
    """Full pipeline; returns the normalized cam dict.

    runner(cmd_list) runs one stage (default subprocess.check_call) —
    injectable so tests can fabricate the sparse model.  skip_sfm=True
    post-processes an existing sparse/0 model only."""
    os.makedirs(os.path.join(out_dir, "sparse"), exist_ok=True)
    if not skip_sfm:
        colmap_bin = colmap_bin or os.environ.get("COLMAP_BIN", "colmap")
        runner = runner or (lambda cmd: subprocess.check_call(cmd))
        for cmd in _colmap_cmds(colmap_bin, img_dir, out_dir):
            print("running:", " ".join(cmd), flush=True)
            runner(cmd)

    sparse0 = os.path.join(out_dir, "sparse", "0")
    cam_dict = cam_dict_from_colmap(sparse0)
    save_cam_dict(cam_dict, os.path.join(out_dir, "cam_dict.json"))
    norm = normalize_cam_dict(cam_dict, target_radius=target_radius)
    save_cam_dict(norm, os.path.join(out_dir, "cam_dict_norm.json"))
    write_nerfpp_split(norm, img_dir, out_dir, split=split)
    print(f"wrote {len(norm)} cameras -> {out_dir}/cam_dict_norm.json "
          f"+ {split}/ split dirs", flush=True)
    return norm


# ---------------------------------------------------------------------------
# Posed mode: triangulation with KNOWN poses
# (nerf++-ours/colmap_runner/run_colmap_posed.py)
# ---------------------------------------------------------------------------

def rotmat2qvec(R):
    """Rotation matrix -> COLMAP (w, x, y, z) quaternion (the standard
    eigenvector method COLMAP's own scripts use)."""
    import numpy as np

    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(R).flat
    M = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(M)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def create_init_files(cam_dict: dict, db_file: str, out_dir: str):
    """Known-pose COLMAP model template (run_colmap_posed.py:53-108):
    cameras.txt (PINHOLE) + images.txt (pose quaternions) keyed by the
    image ids COLMAP assigned in the database, + an empty points3D.txt.
    ``cam_dict`` is this repo's {img_name: {K, W2C, img_size}} layout."""
    import sqlite3

    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    db = sqlite3.connect(db_file)
    name2id = {row[1]: row[0]
               for row in db.execute("SELECT image_id, name FROM images")}
    db.close()

    cam_lines, img_lines = [], []
    for name, img_id in sorted(name2id.items(), key=lambda kv: kv[1]):
        if name not in cam_dict:
            continue
        v = cam_dict[name]
        K = np.asarray(v["K"], np.float64).reshape(4, 4)
        W2C = np.asarray(v["W2C"], np.float64).reshape(4, 4)
        w, h = v["img_size"]
        q = rotmat2qvec(W2C[:3, :3])
        t = W2C[:3, 3]
        cam_lines.append(
            f"{img_id} PINHOLE {w} {h} {K[0, 0]} {K[1, 1]} "
            f"{K[0, 2]} {K[1, 2]}\n")
        img_lines.append(
            f"{img_id} {q[0]} {q[1]} {q[2]} {q[3]} "
            f"{t[0]} {t[1]} {t[2]} {img_id} {name}\n\n")

    with open(os.path.join(out_dir, "cameras.txt"), "w") as fp:
        fp.writelines(cam_lines)
    with open(os.path.join(out_dir, "images.txt"), "w") as fp:
        fp.writelines(img_lines)
        fp.write("\n")
    open(os.path.join(out_dir, "points3D.txt"), "w").close()


def _posed_cmds(colmap_bin: str, img_dir: str, out_dir: str,
                use_gpu: bool = False):
    """SIFT + guided matching with PINHOLE cameras, then (after
    create_init_files) point_triangulator against the known-pose model
    (run_colmap_posed.py:25-121 stage flags, CPU-safe)."""
    db = os.path.join(out_dir, "database.db")
    sfm = os.path.join(out_dir, "sfm")
    gpu = "1" if use_gpu else "0"
    pre = [
        [colmap_bin, "feature_extractor",
         "--database_path", db, "--image_path", img_dir,
         "--ImageReader.camera_model", "PINHOLE",
         "--SiftExtraction.max_image_size", "5000",
         "--SiftExtraction.estimate_affine_shape", "0",
         "--SiftExtraction.domain_size_pooling", "1",
         "--SiftExtraction.use_gpu", gpu],
        [colmap_bin, "exhaustive_matcher",
         "--database_path", db,
         "--SiftMatching.guided_matching", "1",
         "--SiftMatching.use_gpu", gpu],
    ]
    tri = [
        [colmap_bin, "point_triangulator",
         "--database_path", db, "--image_path", img_dir,
         "--input_path", sfm, "--output_path", sfm,
         "--Mapper.tri_ignore_two_view_tracks", "1"],
    ]
    return pre, tri


def run_posed_pipeline(
    img_dir: str,
    out_dir: str,
    cam_dict_file: str,
    colmap_bin: Optional[str] = None,
    runner: Optional[Callable] = None,
) -> str:
    """run_colmap_posed.py:216-229 main, minus the MVS/poisson tail (those
    are plain further colmap invocations): sift/match -> known-pose model
    template -> point_triangulator.  Returns the sfm model dir."""
    import json

    os.makedirs(out_dir, exist_ok=True)
    with open(cam_dict_file) as fp:
        cam_dict = json.load(fp)
    colmap_bin = colmap_bin or os.environ.get("COLMAP_BIN", "colmap")
    runner = runner or (lambda cmd: subprocess.check_call(cmd))
    pre, tri = _posed_cmds(colmap_bin, img_dir, out_dir)
    for cmd in pre:
        print("running:", " ".join(cmd), flush=True)
        runner(cmd)
    sfm = os.path.join(out_dir, "sfm")
    create_init_files(cam_dict, os.path.join(out_dir, "database.db"), sfm)
    for cmd in tri:
        print("running:", " ".join(cmd), flush=True)
        runner(cmd)
    print(f"posed triangulation model -> {sfm}", flush=True)
    return sfm


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--img_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--colmap_bin", default=None)
    p.add_argument("--target_radius", type=float, default=1.0)
    p.add_argument("--split", default="train")
    p.add_argument("--skip_sfm", action="store_true",
                   help="post-process an existing sparse/0 model only")
    p.add_argument("--posed_cam_dict", default=None,
                   help="cam_dict.json with KNOWN poses: run the "
                        "run_colmap_posed.py pipeline (triangulation "
                        "only, no pose estimation)")
    a = p.parse_args(argv)
    if a.posed_cam_dict:
        run_posed_pipeline(a.img_dir, a.out_dir, a.posed_cam_dict,
                           a.colmap_bin)
        return
    run_pipeline(a.img_dir, a.out_dir, a.colmap_bin, a.target_radius,
                 a.split, skip_sfm=a.skip_sfm)


if __name__ == "__main__":
    main()

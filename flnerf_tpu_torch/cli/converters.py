"""Dataset conversion tools: tanks2nerf, hyper2nerf, colmap2nsvf,
create_split/unsplit (NSVF train/test prefixing), record3d (Record3D
capture -> NSVF layout).

Port of ``flnerf_tpu/cli/converters.py`` (numpy; every JSON and text file
it writes equals the reference's, every PNG decodes to the same pixels).
Images are read and written through ``data/png.py`` and
shrunk through ``data/resize.py``; only Record3D's video branch needs cv2
(to decode the .mp4), imported when a video is found.

Parity targets: ngp-ours/scripts/tanks2nerf.py (156 LoC),
scripts/hyper2nerf.py (223 LoC), plenoxels-ours/opt/scripts/
{colmap2nsvf,create_split,unsplit,proc_record3d}.py.
All three share the torch-ngp pose-alignment recipe: flip to the NGP
convention, rotate the mean camera-up to +z, recenter on the weighted
closest-point of all camera axes, rescale — reimplemented here with
vectorized pairwise math instead of the O(N^2) Python loops.

Usage:
  python -m flnerf_tpu_torch.cli.converters tanks2nerf  <root>
  python -m flnerf_tpu_torch.cli.converters hyper2nerf  <root> --downscale 2
  python -m flnerf_tpu_torch.cli.converters colmap2nsvf <sparse_dir> <out_dir>
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from flnerf_tpu_torch.data.colmap import load_colmap_model, qvec2rotmat
from flnerf_tpu_torch.data.png import imread, imwrite
from flnerf_tpu_torch.data.resize import area_resize


# ---------------------------------------------------------------------------
# shared pose alignment (tanks2nerf.py:6-28 closest_point_2_lines/rotmat)
# ---------------------------------------------------------------------------

def rot_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation sending unit-ish vector a to b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-10:
        return rot_between(a + np.random.uniform(-1e-2, 1e-2, 3), b)
    s = np.linalg.norm(v)
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + k + k @ k * ((1 - c) / (s ** 2 + 1e-10))


def _pairwise_focus(poses: np.ndarray) -> np.ndarray:
    """Weighted mean of pairwise camera-axis closest points
    (closest_point_2_lines over all pairs, vectorized)."""
    o = poses[:, :3, 3]
    d = poses[:, :3, 2]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    n = len(o)
    ii, jj = np.triu_indices(n, k=1)
    oa, da, ob, db = o[ii], d[ii], o[jj], d[jj]
    c = np.cross(da, db)
    denom = np.sum(c * c, -1)
    t = ob - oa
    det = lambda x, y, z: np.einsum("ni,ni->n", np.cross(y, z), x)
    ta = np.minimum(det(t, db, c) / (denom + 1e-10), 0.0)
    tb = np.minimum(det(t, da, c) / (denom + 1e-10), 0.0)
    p = (oa + ta[:, None] * da + ob + tb[:, None] * db) * 0.5
    w = np.where(denom > 0.01, denom, 0.0)
    return (p * w[:, None]).sum(0) / max(w.sum(), 1e-10)


def align_poses_ngp(poses: np.ndarray, target_radius: float = 4.0):
    """The torch-ngp alignment: axis flips, up -> +z, recenter, rescale."""
    poses = poses.copy()
    poses[:, 0:3, 1] *= -1
    poses[:, 0:3, 2] *= -1
    poses = poses[:, [1, 0, 2, 3], :]
    poses[:, 2, :] *= -1

    up = poses[:, 0:3, 1].sum(0)
    r = np.pad(rot_between(up, np.array([0, 0, 1.0])), [(0, 1), (0, 1)])
    r[-1, -1] = 1
    poses = r @ poses

    poses[:, :3, 3] -= _pairwise_focus(poses)
    avglen = np.linalg.norm(poses[:, :3, 3], axis=-1).mean()
    poses[:, :3, 3] *= target_radius / avglen
    return poses


def _write_transforms(path, w, h, fl_x, fl_y, cx, cy, frames, **extra):
    out = {"w": int(w), "h": int(h), "fl_x": float(fl_x), "fl_y": float(fl_y),
           "cx": float(cx), "cy": float(cy), "aabb_scale": 2,
           "frames": frames}
    out.update(extra)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)


# ---------------------------------------------------------------------------
# tanks2nerf: T&T NSVF layout (rgb/, pose/, intrinsics.txt) -> transforms
# ---------------------------------------------------------------------------

def tanks2nerf(root: str) -> list:
    intr = np.loadtxt(os.path.join(root, "intrinsics.txt"))
    pose_dir = os.path.join(root, "pose")
    img_dir = os.path.join(root, "rgb")
    pose_files = sorted(os.listdir(pose_dir))
    img_files = sorted(
        f for f in os.listdir(img_dir)
        if f.lower().endswith(("png", "jpg", "jpeg")))

    im0 = imread(os.path.join(img_dir, img_files[0]))
    h, w = im0.shape[:2]

    poses = np.stack(
        [np.loadtxt(os.path.join(pose_dir, f)).reshape(4, 4)
         for f in pose_files], 0)
    poses = align_poses_ngp(poses)

    written = []
    for split, prefix in zip(["train", "val", "test"], ["0_", "1_", "2_"]):
        sel = [i for i, f in enumerate(pose_files) if f.startswith(prefix)]
        imgs = [f for f in img_files if f.startswith(prefix)]
        if not sel:  # reference falls back to val for missing test
            sel = [i for i, f in enumerate(pose_files) if f.startswith("1_")]
            imgs = [f for f in img_files if f.startswith("1_")]
        frames = [
            {"file_path": os.path.join("rgb", img),
             "transform_matrix": poses[i].tolist()}
            for i, img in zip(sel, imgs)
        ]
        out = os.path.join(root, f"transforms_{split}.json")
        _write_transforms(out, w, h, intr[0, 0], intr[1, 1],
                          intr[0, 2], intr[1, 2], frames)
        written.append(out)
    return written


# ---------------------------------------------------------------------------
# hyper2nerf: HyperNeRF layout (camera/, rgb/, dataset/scene/metadata.json)
# ---------------------------------------------------------------------------

def hyper2nerf(root: str, downscale: int = 2, interval: int = 4) -> list:
    with open(os.path.join(root, "dataset.json")) as f:
        ds = json.load(f)
    names = ds["ids"]
    if ds.get("val_ids"):
        train_ids = [i for i, n in enumerate(names) if n in ds["train_ids"]]
        val_ids = [i for i, n in enumerate(names) if n in ds["val_ids"]]
    else:
        all_ids = np.arange(len(names))
        train_ids = list(all_ids[::interval])
        val_ids = list((np.asarray(train_ids[:-1]) +
                        np.asarray(train_ids[1:])) // 2)
    with open(os.path.join(root, "metadata.json")) as f:
        meta = json.load(f)

    poses, times = [], []
    w = h = fl = cx = cy = None
    for name in names:
        with open(os.path.join(root, "camera", f"{name}.json")) as f:
            cam = json.load(f)
        pose = np.eye(4)
        pose[:3, :3] = np.asarray(cam["orientation"]).T
        pose[:3, 3] = np.asarray(cam["position"])
        poses.append(pose)
        times.append(meta[name]["time_id"])
        w, h = cam["image_size"]
        cx, cy = cam["principal_point"]
        fl = cam["focal_length"]
    poses = align_poses_ngp(np.stack(poses))
    times = np.asarray(times, np.float32)
    times = times / max(times.max(), 1e-9)
    w, h = w // downscale, h // downscale
    fl, cx, cy = fl / downscale, cx / downscale, cy / downscale

    written = []
    for split, ids in (("train", train_ids), ("val", val_ids),
                       ("test", val_ids)):
        frames = [
            {"file_path": os.path.join("rgb", f"{downscale}x",
                                       f"{names[i]}.png"),
             "time": float(times[i]),
             "transform_matrix": poses[i].tolist()}
            for i in ids
        ]
        out = os.path.join(root, f"transforms_{split}.json")
        _write_transforms(out, w, h, fl, fl, cx, cy, frames)
        written.append(out)
    return written


# ---------------------------------------------------------------------------
# colmap2nsvf: COLMAP sparse model -> NSVF dir layout (pose/, intrinsics.txt)
# ---------------------------------------------------------------------------

def colmap2nsvf(sparse_dir: str, out_dir: str) -> int:
    """opt/scripts/colmap2nsvf.py analog: per-image 4x4 c2w text poses +
    a shared intrinsics.txt, NSVF file naming (0_ train prefix)."""
    cams, ims = load_colmap_model(sparse_dir)
    os.makedirs(os.path.join(out_dir, "pose"), exist_ok=True)

    cam = cams[next(iter(cams))]
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
        fx = fy = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
    else:
        fx, fy, cx, cy = cam.params[:4]
    intr = np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0],
                     [0, 0, 0, 1]], np.float64)
    np.savetxt(os.path.join(out_dir, "intrinsics.txt"), intr)

    n = 0
    for _, im in sorted(ims.items(), key=lambda kv: kv[1].name):
        r = qvec2rotmat(im.qvec)
        t = im.tvec.reshape(3, 1)
        w2c = np.concatenate(
            [np.concatenate([r, t], 1), [[0, 0, 0, 1]]], 0)
        c2w = np.linalg.inv(w2c)
        stem = os.path.splitext(os.path.basename(im.name))[0]
        np.savetxt(os.path.join(out_dir, "pose", f"0_{stem}.txt"), c2w)
        n += 1
    return n


# ---------------------------------------------------------------------------
# NSVF split management (plenoxels-ours/opt/scripts/create_split.py /
# unsplit.py): the loaders treat a '0_' name prefix as train and '1_' as
# test; these rename files in-place across the parallel data dirs.
# ---------------------------------------------------------------------------

_SPLIT_DIRS = (
    ("pose", (".txt",)), ("poses", (".txt",)), ("feature", (".npz",)),
    ("rgb", (".png", ".jpg", ".jpeg", ".gif", ".tif", ".tiff", ".bmp")),
    ("images", (".png", ".jpg", ".jpeg", ".gif", ".tif", ".tiff", ".bmp")),
    ("image", (".png", ".jpg", ".jpeg", ".gif", ".tif", ".tiff", ".bmp")),
    ("depths", (".exr", ".pfm", ".png", ".npy")),
)


def _split_dirs(root: str):
    out = []
    for d in sorted(os.listdir(root)):
        full = os.path.join(root, d)
        if not os.path.isdir(full):
            continue
        for prefix, exts in _SPLIT_DIRS:
            if d.startswith(prefix):
                out.append((full, exts, prefix == "pose" and d == "pose"))
                break
    return out


def create_split(root: str, every: int = 16, randomize: bool = False,
                 seed: int = 0, dry_run: bool = False) -> list:
    """Prefix every `every`-th stem with '1_' (test), the rest with '0_'
    (train), consistently across all parallel data dirs.  Returns the
    (old, new) rename list; dry_run only reports."""
    dirs = _split_dirs(root)
    assert dirs, f"no data dirs under {root}"
    ref = next((d for d in dirs if d[2]), dirs[0])
    stems = [os.path.splitext(f)[0] for f in sorted(os.listdir(ref[0]))
             if os.path.splitext(f)[1].lower() in ref[1]
             and not f.startswith(("0_", "1_"))]
    if randomize:
        np.random.default_rng(seed).shuffle(stems)
    prefix = {s: f"{int(i % every == 0)}_" for i, s in enumerate(stems)}

    renames = []
    for dirname, exts, _ in dirs:
        for f in sorted(os.listdir(dirname)):
            stem, ext = os.path.splitext(f)
            if (f.startswith(("0_", "1_")) or ext.lower() not in exts
                    or stem not in prefix):
                continue
            src = os.path.join(dirname, f)
            dst = os.path.join(dirname, prefix[stem] + f)
            renames.append((src, dst))
            if not dry_run:
                os.rename(src, dst)
    return renames


def unsplit(root: str) -> int:
    """Strip the 0_/1_ split prefixes again (scripts/unsplit.py)."""
    n = 0
    for dirname, exts, _ in _split_dirs(root):
        for f in sorted(os.listdir(dirname)):
            if f.startswith(("0_", "1_")):
                os.rename(os.path.join(dirname, f),
                          os.path.join(dirname, f[2:]))
                n += 1
    return n


# ---------------------------------------------------------------------------
# Record3D capture -> NSVF layout (scripts/proc_record3d.py): metadata.json
# carries K and per-frame (quat xyzw, t) poses; the mp4 frames are
# side-by-side depth|rgb and the RIGHT half is the image.
# ---------------------------------------------------------------------------

def _quat_xyzw_to_rot(q: np.ndarray) -> np.ndarray:
    """[N, 4] xyzw quaternions -> [N, 3, 3] (scipy's from_quat order)."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    n = x * x + y * y + z * z + w * w
    s = np.where(n > 0, 2.0 / np.maximum(n, 1e-12), 0.0)
    R = np.empty((q.shape[0], 3, 3))
    R[:, 0, 0] = 1 - s * (y * y + z * z)
    R[:, 0, 1] = s * (x * y - z * w)
    R[:, 0, 2] = s * (x * z + y * w)
    R[:, 1, 0] = s * (x * y + z * w)
    R[:, 1, 1] = 1 - s * (x * x + z * z)
    R[:, 1, 2] = s * (y * z - x * w)
    R[:, 2, 0] = s * (x * z - y * w)
    R[:, 2, 1] = s * (y * z + x * w)
    R[:, 2, 2] = 1 - s * (x * x + y * y)
    return R


def record3d_to_nsvf(data_dir: str, every: int = 15, factor: int = 2) -> int:
    """metadata.json + capture video -> intrinsics.txt + pose/*.txt +
    rgb/*.png in the NSVF layout.  Returns the number of frames written."""
    with open(os.path.join(data_dir, "metadata.json")) as f:
        meta = json.load(f)
    K = np.eye(4)
    K[:3, :3] = np.asarray(meta["K"], np.float64).reshape(3, 3).T / factor
    np.savetxt(os.path.join(data_dir, "intrinsics.txt"), K)

    poses7 = np.asarray(meta["poses"], np.float64)       # [N, 7] quat|t
    t = poses7[:, 4:] - poses7[:, 4:].mean(0)            # recenter
    c2w = np.tile(np.eye(4), (poses7.shape[0], 1, 1))
    c2w[:, :3, :3] = _quat_xyzw_to_rot(poses7[:, :4])
    c2w[:, :3, 3] = t
    c2w = c2w @ np.diag([1.0, -1.0, -1.0, 1.0])          # to the nerf axes

    pose_dir = os.path.join(data_dir, "pose")
    rgb_dir = os.path.join(data_dir, "rgb")
    os.makedirs(pose_dir, exist_ok=True)
    os.makedirs(rgb_dir, exist_ok=True)

    import glob as _glob
    vids = _glob.glob(os.path.join(data_dir, "*.mp4"))
    idx = 0
    if vids:
        try:
            import cv2
        except ImportError as e:
            raise ImportError(f"{vids[0]}: decoding a Record3D video needs cv2 "
                              "(OpenCV); extract its frames to frames/*.png instead") from e

        video = cv2.VideoCapture(vids[0])
        n_frames = int(video.get(cv2.CAP_PROP_FRAME_COUNT))
        for i in range(0, n_frames, every):
            video.set(cv2.CAP_PROP_POS_FRAMES, i)
            ok, frame = video.read()
            if not ok or frame is None or i >= c2w.shape[0]:
                continue
            half = frame.shape[1] // 2
            rgb = frame[:, half:, ::-1]                  # right half, BGR->RGB
            if factor != 1:
                rgb = area_resize(rgb, (half // factor, frame.shape[0] // factor))
            imwrite(os.path.join(rgb_dir, f"{idx:05d}.png"), rgb)
            np.savetxt(os.path.join(pose_dir, f"{idx:05d}.txt"), c2w[i])
            idx += 1
    else:
        # frames already extracted (frames/*.png): pose-only processing
        frames = sorted(_glob.glob(os.path.join(data_dir, "frames", "*.png")))
        for i in range(0, len(frames), every):
            if i >= c2w.shape[0]:
                break
            imwrite(os.path.join(rgb_dir, f"{idx:05d}.png"), imread(frames[i]))
            np.savetxt(os.path.join(pose_dir, f"{idx:05d}.txt"), c2w[i])
            idx += 1
    return idx


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("tanks2nerf")
    p1.add_argument("root")
    p2 = sub.add_parser("hyper2nerf")
    p2.add_argument("root")
    p2.add_argument("--downscale", type=int, default=2)
    p2.add_argument("--interval", type=int, default=4)
    p3 = sub.add_parser("colmap2nsvf")
    p3.add_argument("sparse_dir")
    p3.add_argument("out_dir")
    p4 = sub.add_parser("create_split")
    p4.add_argument("root")
    p4.add_argument("--every", type=int, default=16)
    p4.add_argument("--random", action="store_true")
    p4.add_argument("--dry_run", action="store_true")
    p5 = sub.add_parser("unsplit")
    p5.add_argument("root")
    p6 = sub.add_parser("record3d")
    p6.add_argument("data_dir")
    p6.add_argument("--every", type=int, default=15)
    p6.add_argument("--factor", type=int, default=2)
    args = parser.parse_args(argv)
    if args.cmd == "tanks2nerf":
        print(tanks2nerf(args.root))
    elif args.cmd == "hyper2nerf":
        print(hyper2nerf(args.root, args.downscale, args.interval))
    elif args.cmd == "colmap2nsvf":
        print(colmap2nsvf(args.sparse_dir, args.out_dir))
    elif args.cmd == "create_split":
        print(create_split(args.root, args.every, args.random,
                           dry_run=args.dry_run))
    elif args.cmd == "unsplit":
        print(unsplit(args.root))
    else:
        print(record3d_to_nsvf(args.data_dir, args.every, args.factor))


if __name__ == "__main__":
    main()

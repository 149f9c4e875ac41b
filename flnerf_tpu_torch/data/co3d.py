"""CO3D dataset loader (plenoxels-ours/opt/util/co3d_dataset.py analog).

Port of ``flnerf_tpu/data/co3d.py`` (numpy; images read through
``data/png.py`` and shrunk through ``data/resize.py``, OpenCV's INTER_AREA
in numpy, where the reference calls cv2).  CO3D's own frames are JPEGs,
which ``data/png.py`` hands to imageio: where imageio is not installed, only
PNG frames load.

Facebook CO3D layout: ``root/<category>/frame_annotations.jgz`` with
per-frame viewpoint (R, T, NDC focal/principal point) + image paths.
Semantics preserved from the reference:
  * first run builds a cached index npz (poses already converted from the
    PyTorch3D convention by the diag(-1,-1,1,1) right-multiply and
    t = -R @ T);
  * NDC intrinsics -> pixels: focal = fxy * wh/2, principal =
    -(cxy - 1) * wh/2;
  * per-sequence loading with hold_every test split, max_image_dim
    downscale, median-distance pose outlier filtering (max_pose_dist),
    and similarity_from_cameras + cam_scale_factor normalization.

Intentional difference: images are resized to one common (H, W) per
sequence (the median scaled size) so the ray budgeter's dense [N, H, W]
tensors apply; per-image intrinsics are rescaled accordingly.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import NamedTuple, Optional

import numpy as np

from flnerf_tpu_torch.data.png import imread
from flnerf_tpu_torch.data.resize import area_resize


def similarity_from_cameras(c2w: np.ndarray):
    """Similarity transform normalizing OpenCV-convention c2w cameras
    (opt/util/util.py:321-375): rotate mean camera-up to +z, recenter on
    the median nearest-point of the center rays, scale by median distance."""
    t = c2w[:, :3, 3]
    rot = c2w[:, :3, :3]

    ups = np.sum(rot * np.array([0, -1.0, 0]), axis=-1)
    world_up = ups.mean(0)
    world_up /= np.linalg.norm(world_up)

    up_cam = np.array([0.0, -1.0, 0.0])
    c = float((up_cam * world_up).sum())
    cross = np.cross(world_up, up_cam)
    skew = np.array([
        [0.0, -cross[2], cross[1]],
        [cross[2], 0.0, -cross[0]],
        [-cross[1], cross[0], 0.0],
    ])
    if c > -1:
        r_align = np.eye(3) + skew + skew @ skew / (1 + c)
    else:
        r_align = np.diag([-1.0, 1.0, 1.0])

    rot = r_align @ rot
    fwds = np.sum(rot * np.array([0.0, 0.0, 1.0]), axis=-1)
    t = (r_align @ t[..., None])[..., 0]

    nearest = t + (fwds * -t).sum(-1)[:, None] * fwds
    translate = -np.median(nearest, axis=0)

    transform = np.eye(4)
    transform[:3, 3] = translate
    transform[:3, :3] = r_align
    scale = 1.0 / np.median(np.linalg.norm(t + translate, axis=-1))
    return transform, scale


_CAM_TRANS = np.diag(np.array([-1.0, -1.0, 1.0, 1.0], np.float32))


def build_co3d_index(root: str, index_file: str) -> dict:
    """Parse every category's frame_annotations.jgz into the flat index
    (co3d_dataset.py:79-155); cached to ``index_file``."""
    if os.path.exists(index_file):
        z = np.load(index_file, allow_pickle=True)
        return {k: z[k] for k in z.files}

    cats = sorted(
        x for x in os.listdir(root) if os.path.isdir(os.path.join(root, x))
    )
    by_seq: dict = {}
    for cat in cats:
        fa = os.path.join(root, cat, "frame_annotations.jgz")
        if not os.path.exists(fa):
            continue
        with gzip.open(fa, "r") as f:
            frames = json.load(f)
        for fr in frames:
            seq = cat + "//" + fr["sequence_name"]
            h, w = fr["image"]["size"]
            half = np.array([w * 0.5, h * 0.5], np.float32)
            rot = np.asarray(fr["viewpoint"]["R"], np.float64)
            trans = np.asarray(fr["viewpoint"]["T"], np.float64)
            pose = np.zeros((4, 4))
            pose[:3, :3] = rot
            pose[:3, 3:] = -rot @ trans[..., None]
            pose[3, 3] = 1.0
            pose = pose @ _CAM_TRANS
            by_seq.setdefault(seq, []).append({
                "frame_number": fr["frame_number"],
                "image_path": fr["image"]["path"],
                "image_size": np.array([w, h]),
                "pose": pose,
                "fxy": np.asarray(fr["viewpoint"]["focal_length"]) * half,
                "cxy": -(np.asarray(fr["viewpoint"]["principal_point"]) - 1.0)
                       * half,
            })

    idx = {
        "seq_cats": [], "seq_names": [], "seq_offsets": [],
        "image_path": [], "image_size": [], "pose": [], "fxy": [], "cxy": [],
    }
    for seq in by_seq:
        fd = sorted(by_seq[seq], key=lambda x: x["frame_number"])
        cat, name = seq.split("//")
        idx["seq_cats"].append(cat)
        idx["seq_names"].append(name)
        idx["seq_offsets"].append(len(idx["image_path"]))
        for x in fd:
            idx["image_path"].append(x["image_path"])
            idx["image_size"].append(x["image_size"])
            idx["pose"].append(x["pose"])
            idx["fxy"].append(x["fxy"])
            idx["cxy"].append(x["cxy"])
    idx["seq_offsets"].append(len(idx["image_path"]))
    out = {
        "seq_cats": np.asarray(idx["seq_cats"]),
        "seq_names": np.asarray(idx["seq_names"]),
        "seq_offsets": np.asarray(idx["seq_offsets"]),
        "image_path": np.asarray(idx["image_path"]),
        "image_size": np.stack(idx["image_size"]),
        "pose": np.stack(idx["pose"]),
        "fxy": np.stack(idx["fxy"]),
        "cxy": np.stack(idx["cxy"]),
    }
    os.makedirs(os.path.dirname(index_file) or ".", exist_ok=True)
    np.savez(index_file, **out)
    return out


class CO3DSequence(NamedTuple):
    images: np.ndarray      # [N, H, W, 3] f32
    c2w: np.ndarray         # [N, 4, 4]
    fxy: np.ndarray         # [N, 2] pixels (common-size adjusted)
    cxy: np.ndarray         # [N, 2]
    cat: str
    name: str


def load_co3d_sequence(
    root: str,
    seq_id: int,
    split: str = "train",
    index_file: Optional[str] = None,
    max_image_dim: int = 800,
    max_pose_dist: float = 5.0,
    cam_scale_factor: float = 0.95,
    hold_every: int = 8,
) -> CO3DSequence:
    """Load one sequence (co3d_dataset.py:166-253 semantics)."""
    idx = build_co3d_index(
        root, index_file or os.path.join(root, "co3d_index.npz"))
    lo, hi = int(idx["seq_offsets"][seq_id]), int(idx["seq_offsets"][seq_id + 1])

    keep, ims, c2ws, fxys, cxys = [], [], [], [], []
    ref_c2ws = idx["pose"][lo:hi]
    for i in range(lo, hi):
        is_train = (i - lo) % hold_every != 0
        if split.endswith("train") != is_train:
            continue
        im = imread(os.path.join(root, str(idx["image_path"][i])))
        im = np.asarray(im, np.float32)[..., :3] / 255.0
        h, w = im.shape[:2]
        sc = min(max_image_dim / max(h, w), 1.0)
        h2, w2 = int(sc * h), int(sc * w)
        if (h2, w2) != (h, w):
            im = area_resize(im, (w2, h2))
        ims.append(im)
        scale = np.array([w2 / w, h2 / h], np.float32)
        fxys.append(idx["fxy"][i] * scale)
        cxys.append(idx["cxy"][i] * scale)
        c2ws.append(idx["pose"][i])
        keep.append(i)

    c2w = np.stack(c2ws)
    # outlier-pose filtering (median distance x max_pose_dist)
    dists = np.linalg.norm(
        c2w[:, :3, 3] - np.median(c2w[:, :3, 3], axis=0), axis=-1)
    good = dists < np.median(dists) * max_pose_dist
    ims = [im for im, g in zip(ims, good) if g]
    c2w = c2w[good]
    fxy = np.stack(fxys)[good]
    cxy = np.stack(cxys)[good]

    transform, sscale = similarity_from_cameras(ref_c2ws)
    c2w = transform @ c2w
    c2w[:, :3, 3] *= cam_scale_factor * sscale

    # unify image sizes (median) so downstream dense tensors apply
    hs = np.array([im.shape[0] for im in ims])
    ws = np.array([im.shape[1] for im in ims])
    H, W = int(np.median(hs)), int(np.median(ws))
    out = np.empty((len(ims), H, W, 3), np.float32)
    for j, im in enumerate(ims):
        if im.shape[:2] != (H, W):
            ry, rx = H / im.shape[0], W / im.shape[1]
            out[j] = area_resize(im, (W, H))
            fxy[j] *= (rx, ry)
            cxy[j] *= (rx, ry)
        else:
            out[j] = im
    return CO3DSequence(
        out, c2w.astype(np.float32), fxy.astype(np.float32),
        cxy.astype(np.float32),
        str(idx["seq_cats"][seq_id]), str(idx["seq_names"][seq_id]),
    )

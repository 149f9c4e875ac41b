"""Camera pose tooling: two-view epipolar checks, cam-dict normalization,
COLMAP-model -> nerf++ dataset conversion, frustum visualization.

Port of ``flnerf_tpu/data/pose_tools.py`` (numpy, the port's own copy; every
numpy result equals the reference's bit for bit).  The two plots import
matplotlib when called, as the reference does, and raise ImportError where
it is not installed (their callers are the inspection tools,
``cli/view_data.py`` and ``cli/inspect_cameras.py``).

Reference surfaces being re-provided (behavior, not transcription):
  * nerf++-ours/camera_inspector/inspect_epipolar_geometry.py — fundamental
    matrix from two posed cameras + epipolar-line overlays (cv2/GUI there;
    numpy + matplotlib-to-PNG here: no display in this environment).
  * nerf++-ours/colmap_runner/normalize_cam_dict.py — recenter/rescale all
    cameras into a target-radius sphere (the open3d geometry transform is
    dropped: open3d is absent offline, poses are the load-bearing part).
  * nerf++-ours/colmap_runner/extract_sfm.py (pose part) — COLMAP sparse
    model -> {img_name: K, W2C, img_size} cam dict, via the binary/text
    readers in flnerf_tpu_torch.data.colmap.
  * nerf++-ours/camera_visualizer/visualize_cameras.py — camera frustum
    plot (open3d interactive there; matplotlib 3D -> PNG here).

The cam-dict JSON layout matches the reference exactly (K and W2C as
flattened 4x4 row-major lists + img_size) so files interchange.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from flnerf_tpu_torch.data.colmap import load_colmap_model, qvec2rotmat


# ---------------------------------------------------------------------------
# Two-view geometry
# ---------------------------------------------------------------------------

def _skew(v: np.ndarray) -> np.ndarray:
    return np.array([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])


def two_view_fundamental(K1, w2c1, K2, w2c2) -> Tuple[np.ndarray, np.ndarray]:
    """(E, F) for pixel correspondences x2^T F x1 = 0.

    K*, w2c* are 3x3/4x4-compatible arrays (4x4 intrinsics accepted, the
    reference stores them padded)."""
    K1 = np.asarray(K1, np.float64)[:3, :3]
    K2 = np.asarray(K2, np.float64)[:3, :3]
    rel = np.asarray(w2c2, np.float64) @ np.linalg.inv(
        np.asarray(w2c1, np.float64))
    R, t = rel[:3, :3], rel[:3, 3]
    E = _skew(t) @ R
    F = np.linalg.inv(K2).T @ E @ np.linalg.inv(K1)
    return E, F


def epipolar_distance(pts1: np.ndarray, pts2: np.ndarray,
                      F: np.ndarray) -> np.ndarray:
    """Symmetric point-to-epipolar-line distance per correspondence
    (pixels).  pts* are [N, 2]; the pose-sanity metric the reference's
    visual inspector eyeballs."""
    ones = np.ones((pts1.shape[0], 1))
    x1 = np.concatenate([pts1, ones], 1)
    x2 = np.concatenate([pts2, ones], 1)
    l2 = x1 @ F.T                                    # lines in image 2
    l1 = x2 @ F                                      # lines in image 1
    num = np.abs(np.sum(x2 * l2, 1))
    d2 = num / np.linalg.norm(l2[:, :2], axis=1)
    d1 = np.abs(np.sum(x1 * l1, 1)) / np.linalg.norm(l1[:, :2], axis=1)
    return 0.5 * (d1 + d2)


def interest_points(gray: np.ndarray, n: int = 20,
                    border: int = 8) -> np.ndarray:
    """[n, 2] (x, y) strongest gradient-magnitude pixels, de-clustered on
    a coarse grid (the numpy stand-in for the reference's ORB picks)."""
    gy, gx = np.gradient(gray.astype(np.float32))
    mag = gx * gx + gy * gy
    mag[:border], mag[-border:] = 0, 0
    mag[:, :border], mag[:, -border:] = 0, 0
    h, w = mag.shape
    g = int(np.ceil(np.sqrt(n * 2)))
    pts = []
    for ci in range(g):
        for cj in range(g):
            sl = mag[ci * h // g:(ci + 1) * h // g,
                     cj * w // g:(cj + 1) * w // g]
            if sl.size == 0 or sl.max() <= 0:
                continue
            i, j = np.unravel_index(np.argmax(sl), sl.shape)
            pts.append((cj * w // g + j, ci * h // g + i, sl[i, j]))
    pts.sort(key=lambda p: -p[2])
    return np.array([(p[0], p[1]) for p in pts[:n]], np.float64)


def inspect_epipolar_geometry(img1, K1, w2c1, img2, K2, w2c2,
                              out_path: Optional[str] = None,
                              n_points: int = 12):
    """Pick interest points in img1, draw them + their epipolar lines in
    img2, save a side-by-side PNG (the inspector's screenshot).  Returns
    the [n, 3] epipolar lines for programmatic checks."""
    gray = np.asarray(img1, np.float32)
    if gray.ndim == 3:
        gray = gray.mean(-1)
    pts1 = interest_points(gray, n_points)
    _, F = two_view_fundamental(K1, w2c1, K2, w2c2)
    ones = np.ones((pts1.shape[0], 1))
    lines2 = np.concatenate([pts1, ones], 1) @ F.T

    if out_path is not None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, (a1, a2) = plt.subplots(1, 2, figsize=(10, 5))
        a1.imshow(np.asarray(img1), cmap="gray")
        a2.imshow(np.asarray(img2), cmap="gray")
        w = np.asarray(img2).shape[1]
        colors = plt.cm.tab20(np.linspace(0, 1, len(pts1)))
        for p, l, c in zip(pts1, lines2, colors):
            a1.plot(p[0], p[1], "o", color=c, ms=5)
            if abs(l[1]) > 1e-12:
                xs = np.array([0.0, w])
                a2.plot(xs, (-l[2] - l[0] * xs) / l[1], "-", color=c, lw=1)
        for a in (a1, a2):
            a.set_axis_off()
        fig.savefig(out_path, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return lines2


# ---------------------------------------------------------------------------
# Cam dict (the colmap_runner JSON format)
# ---------------------------------------------------------------------------

def cam_dict_from_colmap(sparse_dir: str,
                         img_size: Tuple[int, int] = None) -> Dict:
    """COLMAP sparse model dir -> {img_name: {K, W2C, img_size}} with 4x4
    row-major flattened matrices (colmap_runner's cam dict layout)."""
    cameras, images = load_colmap_model(sparse_dir)
    out = {}
    for im in sorted(images.values(), key=lambda v: v.name):
        cam = cameras[im.camera_id]
        if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            fx = fy = cam.params[0]
            cx, cy = cam.params[1], cam.params[2]
        else:
            fx, fy, cx, cy = cam.params[:4]
        K = np.eye(4)
        K[0, 0], K[1, 1] = fx, fy
        K[0, 2], K[1, 2] = cx, cy
        W2C = np.eye(4)
        W2C[:3, :3] = qvec2rotmat(im.qvec)
        W2C[:3, 3] = im.tvec
        out[im.name] = {
            "K": K.reshape(-1).tolist(),
            "W2C": W2C.reshape(-1).tolist(),
            "img_size": list(img_size) if img_size else [cam.width,
                                                         cam.height],
        }
    return out


def normalize_cam_dict(cam_dict: Dict, target_radius: float = 1.0) -> Dict:
    """Recenter camera centers on their mean and scale the farthest one to
    target_radius (x1.1 slack), preserving orientations — nerf++'s
    unit-sphere convention (normalize_cam_dict.py:7-28)."""
    centers = []
    for v in cam_dict.values():
        W2C = np.asarray(v["W2C"], np.float64).reshape(4, 4)
        centers.append(np.linalg.inv(W2C)[:3, 3])
    centers = np.stack(centers)
    mid = centers.mean(0)
    radius = np.max(np.linalg.norm(centers - mid, axis=1)) * 1.1
    scale = target_radius / max(radius, 1e-12)

    out = {}
    for name, v in cam_dict.items():
        W2C = np.asarray(v["W2C"], np.float64).reshape(4, 4)
        C2W = np.linalg.inv(W2C)
        C2W[:3, 3] = (C2W[:3, 3] - mid) * scale
        out[name] = dict(v)
        out[name]["W2C"] = np.linalg.inv(C2W).reshape(-1).tolist()
    return out


def write_nerfpp_split(cam_dict: Dict, img_dir: str, out_dir: str,
                       split: str = "train") -> None:
    """Materialize the {split}/{intrinsics,pose,rgb} txt layout
    load_nerfpp_split consumes (pose = C2W, flattened 4x4)."""
    import shutil

    for sub in ("intrinsics", "pose", "rgb"):
        os.makedirs(os.path.join(out_dir, split, sub), exist_ok=True)
    for name in sorted(cam_dict):
        stem = os.path.splitext(name)[0]
        v = cam_dict[name]
        K = np.asarray(v["K"], np.float64).reshape(4, 4)
        W2C = np.asarray(v["W2C"], np.float64).reshape(4, 4)
        np.savetxt(os.path.join(out_dir, split, "intrinsics",
                                stem + ".txt"),
                   K.reshape(1, -1))
        np.savetxt(os.path.join(out_dir, split, "pose", stem + ".txt"),
                   np.linalg.inv(W2C).reshape(1, -1))
        src = os.path.join(img_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out_dir, split, "rgb", name))


def plot_camera_frustums(cam_dict: Dict, out_path: str,
                         frustum_depth: float = 0.25,
                         bbox=None) -> None:
    """3D frustum wireframe plot of every camera -> PNG (the open3d
    visualizer substitute).  ``bbox`` (xyz_min, xyz_max) overlays the
    scene bounding cube (view_data.py's bbox display)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    if bbox is not None:
        lo, hi = (np.asarray(b, np.float64) for b in bbox)
        pts = np.stack([
            np.where([i & 1 for i in range(8)], hi[0], lo[0]),
            np.where([(i >> 1) & 1 for i in range(8)], hi[1], lo[1]),
            np.where([(i >> 2) & 1 for i in range(8)], hi[2], lo[2]),
        ], -1)
        for a in range(8):
            for b in range(a + 1, 8):
                if bin(a ^ b).count("1") == 1:     # cube edges only
                    ax.plot(*zip(pts[a], pts[b]), "g-", lw=0.8)
    for v in cam_dict.values():
        K = np.asarray(v["K"], np.float64).reshape(4, 4)
        W2C = np.asarray(v["W2C"], np.float64).reshape(4, 4)
        w, h = (v.get("img_size") or [2 * K[0, 2], 2 * K[1, 2]])[:2]
        C2W = np.linalg.inv(W2C)
        corners_px = np.array(
            [[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], np.float64)
        rays = corners_px @ np.linalg.inv(K[:3, :3]).T * frustum_depth
        pts = (C2W[:3, :3] @ rays.T).T + C2W[:3, 3]
        c = C2W[:3, 3]
        for i in range(4):
            ax.plot(*zip(c, pts[i]), "b-", lw=0.5)
            ax.plot(*zip(pts[i], pts[(i + 1) % 4]), "b-", lw=0.5)
        ax.scatter(*c, color="r", s=6)
    ax.set_box_aspect((1, 1, 1))
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def save_cam_dict(cam_dict: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(cam_dict, f, indent=2)

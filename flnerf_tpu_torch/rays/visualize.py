"""Quadtree debug visualization (SURVEY.md §5.5 keeps these first-class).

Port of ``flnerf_tpu/rays/visualize.py``.  Parity targets: tree-overlay
images (tree.py:148-156 visualize_tree, 195-229
visualize_split_and_sample_points), sample-point scatters and probability
heatmaps (image_process.py:98-167), ngp error-map dumps (nerf/utils.py:
513-518).  The reference draws with cv2; here the same 1-px pixels are set
in numpy: ``cv2.rectangle(..., thickness=1)`` is the box's border rows and
columns, ends included and clipped to the image, and ``cv2.circle(...,
radius=0, thickness=-1)`` is the one pixel at its centre when it lies in
the image.  JPEG output goes through ``data/png.py``'s lazy imageio writer.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from flnerf_tpu_torch.data.png import imwrite
from flnerf_tpu_torch.rays.quadtree import QuadTreeForest


def _to8(image: np.ndarray) -> np.ndarray:
    return (np.asarray(image) * 255.0).astype(np.uint8).copy()


def draw_rectangle(img: np.ndarray, r0: int, c0: int, r1: int, c1: int, color) -> None:
    """The 1-px border of the box with corners (r0, c0) and (r1, c1), both
    included, in place (``cv2.rectangle`` at thickness 1 with the points
    (c0, r0) and (c1, r1))."""
    r0, r1 = min(r0, r1), max(r0, r1)
    c0, c1 = min(c0, c1), max(c0, c1)
    h, w = img.shape[:2]
    rows = slice(max(r0, 0), min(r1, h - 1) + 1)
    cols = slice(max(c0, 0), min(c1, w - 1) + 1)
    for r in (r0, r1):
        if 0 <= r < h:
            img[r, cols] = color
    for c in (c0, c1):
        if 0 <= c < w:
            img[rows, c] = color


def draw_tree_overlay(image: np.ndarray, forest: QuadTreeForest, img_id: int) -> np.ndarray:
    """Leaf-boundary overlay for one view ([H,W,3] float in [0,1])."""
    imgc = _to8(image)
    for x0, y0, x1, y1 in forest.boxes[forest.img == img_id]:
        draw_rectangle(imgc, int(x0), int(y0), int(x1), int(y1), (0, 0, 0))
    return imgc


def draw_sample_points(
    image: np.ndarray, px: np.ndarray, py: np.ndarray, color=(255, 0, 0)
) -> np.ndarray:
    """Scatter selected pixels (row px, column py) onto a view."""
    imgc = _to8(image)
    rows = np.asarray(px).astype(np.int64)
    cols = np.asarray(py).astype(np.int64)
    h, w = imgc.shape[:2]
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    imgc[rows[inside], cols[inside]] = color
    return imgc


def prob_heatmap(prob: np.ndarray) -> np.ndarray:
    """Red-high / green-low probability heatmap
    (image_process.py visualize_prob_distribution semantics)."""
    p = np.asarray(prob, np.float64)
    lo, mid, hi = p.min(), 2 * p.mean(), p.max()
    img = np.zeros(p.shape + (3,), np.uint8)
    low = p <= mid
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.clip(255 * (p - lo) / max(mid - lo, 1e-9), 0, 255)
        g = np.clip(255 - 255 * (p - mid) / max(hi - mid, 1e-9), 0, 255)
    img[..., 0] = np.where(low, r, 255).astype(np.uint8)
    img[..., 1] = np.where(low, 255, g).astype(np.uint8)
    return img


def save_debug_images(
    out_dir: str,
    images: np.ndarray,
    forest: QuadTreeForest,
    sharp_maps: Optional[np.ndarray] = None,
    prefix: str = "tree",
    ext: str = "jpg",
) -> list:
    """Dump per-view tree overlays (+ prob heatmaps) like the reference's
    debug/ directory, as ``ext`` files (the reference's JPEGs need imageio;
    "png" goes through the package's own codec).  Returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(forest.n_images):
        paths.append(os.path.join(out_dir, f"{prefix}_subdivide_{i}.{ext}"))
        imwrite(paths[-1], draw_tree_overlay(images[i], forest, i))
        if sharp_maps is not None:
            paths.append(os.path.join(out_dir, f"{prefix}_prob_{i}.{ext}"))
            imwrite(paths[-1], prob_heatmap(sharp_maps[i]))
    return paths

"""Image downsampling by area averaging, as OpenCV's ``INTER_AREA`` computes it.

The reference loaders shrink images with ``cv2.resize(..., INTER_AREA)``
(``flnerf_tpu/data/blender.py`` half_res, ``data/llff.py`` factor,
``data/nerfpp_dataset.py`` resolution_level).  This is the same arithmetic in
numpy, so the port needs no image library:

  * where each scale is a whole number (``resizeAreaFast_``), a box mean: the
    k x k source block summed in OpenCV's order and multiplied by f32(1 / k^2);
    uint8 at 2x rounds ``(sum + 2) >> 2`` as OpenCV's 2x2 path does, and
    elsewhere sums in integers and rounds the f32 product half to even;
  * elsewhere (``resizeArea_``), each destination pixel averages its source
    interval [d * s, (d + 1) * s) with fractional weights at the interval's
    ends: rows first, the weighted sum along x of one source row in f32,
    then the rows weighted along y, in f32, in OpenCV's order.  uint8 input
    is rounded half to even and saturated.

Only downsampling is implemented (the loaders never enlarge).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _area_tab(ssize: int, dsize: int) -> List[List[Tuple[int, np.float32]]]:
    """OpenCV's ``computeResizeAreaTab``: for each destination index, its
    (source index, f32 weight) pairs in OpenCV's order."""
    scale = ssize / dsize
    tab = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            row.append((sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
        tab.append(row)
    return tab


def _weighted_rows(src: np.ndarray, tab, axis: int) -> List[np.ndarray]:
    """For each destination index along ``axis``: the f32 sum of its source
    slices times their weights, accumulated in the table's order."""
    out = []
    for row in tab:
        acc = None
        for s, w in row:
            term = np.take(src, s, axis=axis) * w
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def _fast(img: np.ndarray, kx: int, ky: int, uint8: bool) -> np.ndarray:
    """``resizeAreaFast_`` at whole scales kx, ky."""
    h, w = img.shape[0] // ky, img.shape[1] // kx
    blocks = img[:h * ky, :w * kx].reshape(h, ky, w, kx, *img.shape[2:])
    cn = img.shape[2] if img.ndim == 3 else 1
    two = kx == ky == 2
    if uint8:
        b = blocks.astype(np.int32)
        s = sum(b[:, sy, :, sx] for sy in range(ky) for sx in range(kx))
        if two and cn in (1, 3, 4):
            return ((s + 2) >> 2).astype(np.uint8)
        out = np.rint(s.astype(np.float32) * np.float32(1.0 / (kx * ky)))
        return np.clip(out, 0, 255).astype(np.uint8)
    b = blocks.astype(np.float32)
    # the scalar loop: four terms at a time, ((a + b) + c) + d, added to the
    # running sum, then one at a time
    terms = [b[:, k // kx, :, k % kx] for k in range(kx * ky)]
    s, k = None, 0
    while k + 4 <= len(terms):
        four = ((terms[k] + terms[k + 1]) + terms[k + 2]) + terms[k + 3]
        s, k = four if s is None else s + four, k + 4
    for t in terms[k:]:
        s = t if s is None else s + t
    if two and cn in (1, 4):
        # the 4-lane SIMD loop of 2x2 for 1 and 4 channels, (a + b) + (c +
        # d); one channel leaves its last w % 4 pixels to the scalar loop
        n = w if cn == 4 else w - w % 4
        s[:, :n] = ((terms[0] + terms[1]) + (terms[2] + terms[3]))[:, :n]
    return s * np.float32(1.0 / (kx * ky))


def area_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_AREA)`` for a
    shrink: img [H, W] or [H, W, C], uint8 or float; size (w, h).  Returns
    uint8 for uint8 input and float32 otherwise."""
    img = np.asarray(img)
    dw, dh = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    if dw <= 0 or dh <= 0 or dw > sw or dh > sh:
        raise ValueError(f"area_resize shrinks only: {sw}x{sh} -> {dw}x{dh}")
    uint8 = img.dtype == np.uint8
    if not uint8:
        img = img.astype(np.float32)
    if sw % dw == 0 and sh % dh == 0:
        return _fast(img, sw // dw, sh // dh, uint8)
    src = img.astype(np.float32)
    cols = np.stack(_weighted_rows(src, _area_tab(sw, dw), axis=1), axis=1)   # [sh, dw, ...]
    out = np.stack(_weighted_rows(cols, _area_tab(sh, dh), axis=0), axis=0)   # [dh, dw, ...]
    if uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out

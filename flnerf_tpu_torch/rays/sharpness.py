"""Sharpness-probability pixel sampling (ImageProcessor equivalent).

Port of ``flnerf_tpu/rays/sharpness.py`` (numpy and scipy, unchanged).

Parity target: nerf-ours/image_process.py (clones in nerf++/plenoxels):
  * get_sharp_img (image_process.py:26-39): per-pixel local 3x3 std
    sqrt(|E[x^2] - E[x]^2|) via box blur, converted to gray with
    ITU-R BT.601 luma on RGB (the reference's double channel flip).
  * to_prob_v2 (image_process.py:60-75): +1e-6, clip to
    [0.01*mean, max], scale by max, normalize to a distribution.
  * sample_pixels (image_process.py:77-96): categorical draw over the block.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def sharp_image(img: np.ndarray) -> np.ndarray:
    """Local 3x3 std-dev gray map of an [H, W, 3] float image."""
    img = np.asarray(img, dtype=np.float32)
    # 'mirror' == cv2.blur's default BORDER_REFLECT_101
    e_sq = uniform_filter(img ** 2, size=(3, 3, 1), mode="mirror")
    sq_e = uniform_filter(img, size=(3, 3, 1), mode="mirror") ** 2
    std = np.sqrt(np.abs(e_sq - sq_e))
    return 0.299 * std[..., 0] + 0.587 * std[..., 1] + 0.114 * std[..., 2]


def block_prob(gray_block: np.ndarray) -> np.ndarray:
    """to_prob_v2: normalized sampling distribution over one leaf block."""
    g = gray_block.astype(np.float64).ravel() + 1e-6
    g_min = 0.01 * np.mean(g)
    g_max = np.max(g)
    g = np.clip(g, g_min, g_max)
    g = g / g_max if g_max > 0 else np.ones_like(g)
    s = g.sum()
    return (g / s if s > 0 else np.full_like(g, 1.0 / g.size)).reshape(gray_block.shape)


class SharpnessSampler:
    def __init__(self, images: np.ndarray):
        """images: [n, H, W, 3] float32."""
        self.n_images, self.H, self.W = images.shape[:3]
        self.sharp = np.stack([sharp_image(im) for im in images], 0)

    def sample_in_leaves(
        self,
        boxes: np.ndarray,     # [M, 4] leaf boxes
        img: np.ndarray,       # [M] image per leaf
        counts: np.ndarray,    # [M] rays to draw per leaf (may be 0)
        rng: np.random.Generator,
    ):
        """Draw ``counts[i]`` pixels in each leaf from its sharpness prob map.

        Returns (leaf_of_ray, px, py) flat arrays (total = counts.sum()).
        The block is images[int(x0):int(x1), int(y0):int(y1)] and sampled
        indices are offset by (int(x0), int(y0)) (tree.py:583-590).

        Uses the native C++ sampler (``flnerf_tpu_torch/native``) when a host
        compiler can build it: one pass over all leaves instead of a per-leaf
        Python loop.  Otherwise numpy (same distribution, another RNG
        stream).  Both draw the native seed from ``rng`` first, so the epoch
        stream stays in step with the reference package either way.
        """
        total = int(counts.sum())
        leaf_of_ray = np.repeat(np.arange(boxes.shape[0]), counts)

        from flnerf_tpu_torch import native

        res = native.sample_leaves_weighted(
            self.sharp, boxes, img, counts, int(rng.integers(0, 2 ** 62))
        )
        if res is not None:
            px, py = res
            px = np.minimum(px, self.H - 1)
            py = np.minimum(py, self.W - 1)
            return leaf_of_ray, px, py

        px = np.empty(total, np.int64)
        py = np.empty(total, np.int64)
        off = 0
        for li in np.nonzero(counts)[0]:
            c = int(counts[li])
            x0, y0, x1, y1 = boxes[li]
            bx0, by0 = int(x0), int(y0)
            bx1 = max(int(x1), bx0 + 1)
            by1 = max(int(y1), by0 + 1)
            block = self.sharp[img[li], bx0:bx1, by0:by1]
            p = block_prob(block)
            idx = rng.choice(p.size, size=c, p=p.ravel())
            bw = block.shape[1]
            px[off : off + c] = bx0 + idx // bw
            py[off : off + c] = by0 + idx % bw
            off += c
        px = np.minimum(px, self.H - 1)
        py = np.minimum(py, self.W - 1)
        return leaf_of_ray, px, py

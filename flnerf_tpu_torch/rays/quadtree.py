"""Quadtree ray-budget subsystem (the paper's core contribution).

Port of ``flnerf_tpu/rays/quadtree.py`` (host numpy, copied unchanged):
one flat struct-of-arrays forest over all training views, vectorized ray
allocation and subdivision, ``treeDivide_*.pkl`` persistence in the same
format.  Rays cross to the device only at the ``RayEpoch`` boundary: the
trainer pads them and copies them to its device once per chunk.

Behavioral parity with the reference (nerf-ours/tree.py):
  * init: uniform 4-way split to depth ``init_level``; minArea =
    H*W/4**(init_level-1) (tree.py:94).
  * allocation (tree.py:577-581): leaf area > minArea+0.01 -> 10 rays,
    else int(area * ray_num_per_pixel).
  * integer-pixel draw: x ~ randint(ceil(x0), ceil(x1)),
    y ~ randint(ceil(y0), ceil(y1 - 0.01))  (tree.py:598-599).
  * subdivision (tree.py:629-652): split a leaf iff its loss statistic
    exceeds ``thres`` AND area == minArea; minArea /= 4 once per image.
  * last-epoch fallback (tree.py:389-400) and sharpness-probability
    in-leaf sampling (tree.py:583-595).
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np

from flnerf_tpu_torch.core.logging_utils import RECORDER
from flnerf_tpu_torch.rays.sharpness import SharpnessSampler


class RayEpoch(NamedTuple):
    """One epoch's ray set (host numpy; the trainer pads + ships to device)."""

    origins: np.ndarray   # [N, 3] float32
    dirs: np.ndarray      # [N, 3] float32
    rgb: np.ndarray       # [N, 3] float32
    leaf_id: np.ndarray   # [N] int32 — global index into the CURRENT forest
    n_leaves: int         # forest size M when these rays were generated
    viewdirs: Optional[np.ndarray] = None  # [N, 3] pre-NDC unit dirs (LLFF)
    px: Optional[np.ndarray] = None        # [N] int32 pixel row (coherence keys
    py: Optional[np.ndarray] = None        # [N] int32 pixel col  for the
    img: Optional[np.ndarray] = None       # [N] int32 image id   ordering)


def _uniform_forest(n_images: int, H: int, W: int, depth: int):
    """Boxes of the full uniform quadtree at ``depth`` (root = depth 1)."""
    n_side = 2 ** (depth - 1)
    # Reference order is depth-first (TL, BL-ish, ...) per recursive_subdivide;
    # leaf identity only needs to be stable within an epoch, so we use
    # row-major order for the uniform init (every leaf is identical anyway).
    xs = np.linspace(0.0, float(H), n_side + 1)
    ys = np.linspace(0.0, float(W), n_side + 1)
    x0, y0 = np.meshgrid(xs[:-1], ys[:-1], indexing="ij")
    x1, y1 = np.meshgrid(xs[1:], ys[1:], indexing="ij")
    per_img = np.stack([x0.ravel(), y0.ravel(), x1.ravel(), y1.ravel()], -1)
    boxes = np.tile(per_img, (n_images, 1))
    img = np.repeat(np.arange(n_images, dtype=np.int32), n_side * n_side)
    return boxes.astype(np.float64), img


@dataclass
class QuadTreeForest:
    """All leaves of all per-view quadtrees, as flat arrays."""

    n_images: int
    H: int
    W: int
    boxes: np.ndarray      # [M, 4] float64 (x0, y0, x1, y1); x is the row axis
    img: np.ndarray        # [M] int32
    min_area: np.ndarray   # [n_images] float64
    cur_level: int

    @classmethod
    def uniform(cls, n_images: int, H: int, W: int, init_level: int) -> "QuadTreeForest":
        boxes, img = _uniform_forest(n_images, H, W, init_level)
        min_area = np.full(n_images, H * W / 4.0 ** (init_level - 1), np.float64)
        return cls(n_images, H, W, boxes, img, min_area, cur_level=init_level)

    @property
    def n_leaves(self) -> int:
        return self.boxes.shape[0]

    def areas(self) -> np.ndarray:
        b = self.boxes
        return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])

    def image_offsets(self) -> np.ndarray:
        """Start index of each image's leaf run ([n_images+1]); leaves are
        kept grouped by image."""
        counts = np.bincount(self.img, minlength=self.n_images)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def subdivide(self, leaf_stat: np.ndarray, thres: float,
                  min_area_floor: float = 0.0) -> int:
        """Split deepest-level leaves whose loss statistic exceeds ``thres``.

        Mirrors adjust_tree_subThread (tree.py:629-652): only leaves with
        area exactly == the image's current minArea split; minArea is then
        divided by 4 once per image that had at least one split.  Returns the
        number of leaves split.

        ``min_area_floor`` stops subdivision once children would fall below
        that leaf area.  The reference has no explicit floor — it relies on
        its subdivide_every=3 / n_epoch=18 schedule (configs/lego.txt:24-26)
        never reaching pixel scale at 800x800.  At small scenes the drift is
        fatal: once minArea/4^k drops under ~10 px the area*rate allocation
        for the deepest (hardest) leaves falls BELOW the easy leaves' flat
        10-ray floor (tree.py:579-581) and hard regions starve, so callers
        at toy scale pass an explicit floor.
        """
        assert leaf_stat.shape[0] == self.n_leaves
        areas = self.areas()
        at_min = np.isclose(areas, self.min_area[self.img], rtol=1e-9, atol=1e-9)
        # Per-IMAGE floor gate: min_area drifts independently per image
        # (divided by 4 only in images that split), so an image reaching
        # the floor must not halt refinement of the others.
        img_ok = self.min_area / 4.0 >= min_area_floor
        split = (leaf_stat > thres) & at_min & img_ok[self.img]
        n_split = int(split.sum())
        if n_split == 0:
            return 0

        counts = np.where(split, 4, 1)
        parent_of = np.repeat(np.arange(self.n_leaves), counts)
        new_boxes = self.boxes[parent_of].copy()
        new_img = self.img[parent_of]

        # Child slot within its parent (0 for kept leaves).
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(parent_of.shape[0]) - first[parent_of]

        sb = self.boxes[split]
        midx = 0.5 * (sb[:, 0] + sb[:, 2])
        midy = 0.5 * (sb[:, 1] + sb[:, 3])
        # Children in the reference's order (tree.py:57-72):
        #   0: (x0, y0, mx, my)  1: (mx, y0, x1, my)
        #   2: (x0, my, mx, y1)  3: (mx, my, x1, y1)
        child_boxes = np.stack(
            [
                np.stack([sb[:, 0], sb[:, 1], midx, midy], -1),
                np.stack([midx, sb[:, 1], sb[:, 2], midy], -1),
                np.stack([sb[:, 0], midy, midx, sb[:, 3]], -1),
                np.stack([midx, midy, sb[:, 2], sb[:, 3]], -1),
            ],
            axis=1,
        )  # [n_split, 4, 4]
        is_child = split[parent_of]
        # dense index of each split parent among split parents
        split_rank = np.cumsum(split) - 1
        new_boxes[is_child] = child_boxes[split_rank[parent_of[is_child]], slot[is_child]]

        self.boxes = new_boxes
        self.img = new_img
        had_split = np.zeros(self.n_images, bool)
        had_split[new_img[is_child]] = True
        self.min_area = np.where(had_split, self.min_area / 4.0, self.min_area)
        self.cur_level += 1
        return n_split

    # -- persistence (treeDivide_*.pkl analog, run_nerf.py:339-345,542-544) --
    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "format": "flnerf_quadtree_forest_v1",
                    "n_images": self.n_images,
                    "H": self.H,
                    "W": self.W,
                    "boxes": self.boxes,
                    "img": self.img,
                    "min_area": self.min_area,
                    "cur_level": self.cur_level,
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "QuadTreeForest":
        with open(path, "rb") as f:
            d = pickle.load(f)
        assert d.get("format") == "flnerf_quadtree_forest_v1"
        return cls(d["n_images"], d["H"], d["W"], d["boxes"], d["img"], d["min_area"], d["cur_level"])


class RayBudgeter:
    """QuadTreeManager equivalent: owns the forest + per-pixel ray caches and
    produces each epoch's ray set (tree.py:159-428)."""

    @RECORDER.spanned("flnerf.budget.budgeter_init")
    def __init__(
        self,
        images: np.ndarray,    # [n, H, W, 3] float32
        origins: np.ndarray,   # [n, H, W, 3] float32
        dirs: np.ndarray,      # [n, H, W, 3] float32
        init_level: int = 2,
        seed: int = 0,
        enable_sharpness: bool = True,
        viewdirs: Optional[np.ndarray] = None,
    ):
        self.images = np.ascontiguousarray(images, dtype=np.float32)
        self.origins = np.ascontiguousarray(origins, dtype=np.float32)
        self.dirs = np.ascontiguousarray(dirs, dtype=np.float32)
        self.viewdirs = (
            np.ascontiguousarray(viewdirs, dtype=np.float32) if viewdirs is not None else None
        )
        self.n_images, self.H, self.W = images.shape[:3]
        self.epoch_size = self.n_images * self.H * self.W
        self.forest = QuadTreeForest.uniform(self.n_images, self.H, self.W, init_level)
        self.rng = np.random.default_rng(seed)
        # lazy: two full box-filter passes over every image on the 1-core
        # host are only worth paying if prob sampling actually runs
        self._enable_sharpness = enable_sharpness
        self._sharpness: Optional[SharpnessSampler] = None

    @property
    def sharpness(self) -> Optional[SharpnessSampler]:
        if self._enable_sharpness and self._sharpness is None:
            self._sharpness = SharpnessSampler(self.images)
        return self._sharpness

    # ------------------------------------------------------------------
    def _draw_uniform_pixels(self, boxes: np.ndarray, counts: np.ndarray):
        """Integer-pixel uniform draw per leaf, vectorized over all rays.

        x ~ randint(ceil(x0), ceil(x1)); y ~ randint(ceil(y0), ceil(y1-0.01))
        (tree.py:598-599).
        """
        leaf_of_ray = np.repeat(np.arange(boxes.shape[0]), counts)
        x_lo = np.ceil(boxes[:, 0]).astype(np.int64)
        x_hi = np.maximum(np.ceil(boxes[:, 2]).astype(np.int64), x_lo + 1)
        y_lo = np.ceil(boxes[:, 1]).astype(np.int64)
        y_hi = np.maximum(np.ceil(boxes[:, 3] - 0.01).astype(np.int64), y_lo + 1)
        n = leaf_of_ray.shape[0]
        ux = self.rng.random(n)
        uy = self.rng.random(n)
        px = (x_lo[leaf_of_ray] + ux * (x_hi - x_lo)[leaf_of_ray]).astype(np.int64)
        py = (y_lo[leaf_of_ray] + uy * (y_hi - y_lo)[leaf_of_ray]).astype(np.int64)
        px = np.minimum(px, self.H - 1)
        py = np.minimum(py, self.W - 1)
        return leaf_of_ray, px, py

    def _draw_fractional_pixels(self, boxes: np.ndarray, counts: np.ndarray):
        """Fractional-pixel draw (gen_rays_v3, tree.py:265-269): positions
        at 1/1000-pixel granularity inside each leaf box."""
        scale = 1000
        leaf_of_ray = np.repeat(np.arange(boxes.shape[0]), counts)
        x_lo = (boxes[:, 0] * scale).astype(np.int64)
        x_hi = np.maximum(((boxes[:, 2] - 0.01) * scale).astype(np.int64),
                          x_lo + 1)
        y_lo = (boxes[:, 1] * scale).astype(np.int64)
        y_hi = np.maximum(((boxes[:, 3] - 0.01) * scale).astype(np.int64),
                          y_lo + 1)
        n = leaf_of_ray.shape[0]
        px = (x_lo[leaf_of_ray]
              + (self.rng.random(n) * (x_hi - x_lo)[leaf_of_ray]).astype(np.int64)
              ).astype(np.float64) / scale
        py = (y_lo[leaf_of_ray]
              + (self.rng.random(n) * (y_hi - y_lo)[leaf_of_ray]).astype(np.int64)
              ).astype(np.float64) / scale
        return leaf_of_ray, px, py

    def _bilerp(self, arr: np.ndarray, img: np.ndarray, px: np.ndarray,
                py: np.ndarray) -> np.ndarray:
        """grid_sample(align_corners=False, zeros padding) of per-image
        fields at fractional pixels: the reference normalizes pixel/(h/2)-1,
        which lands at position (pixel - 0.5) in array coords."""
        x = px - 0.5
        y = py - 0.5
        x0 = np.floor(x).astype(np.int64)
        y0 = np.floor(y).astype(np.int64)
        fx = (x - x0)[:, None]
        fy = (y - y0)[:, None]

        def tap(ix, iy):
            inb = ((ix >= 0) & (ix < self.H) & (iy >= 0) & (iy < self.W))
            v = arr[img, np.clip(ix, 0, self.H - 1), np.clip(iy, 0, self.W - 1)]
            return v * inb[:, None]

        return (
            tap(x0, y0) * (1 - fx) * (1 - fy)
            + tap(x0, y0 + 1) * (1 - fx) * fy
            + tap(x0 + 1, y0) * fx * (1 - fy)
            + tap(x0 + 1, y0 + 1) * fx * fy
        ).astype(np.float32)

    def ray_counts(self, down_scale: int = 1, forest: Optional[QuadTreeForest] = None) -> np.ndarray:
        """Per-leaf ray budget under the 10-ray / area×rate rule."""
        f = forest or self.forest
        ray_num_per_pixel = self.epoch_size / self.n_images / down_scale / self.H / self.W
        areas = f.areas()
        deepest = areas <= f.min_area[f.img] + 0.01
        return np.where(deepest, (areas * ray_num_per_pixel).astype(np.int64), 10)

    @RECORDER.spanned("flnerf.budget.gen_rays")
    def gen_rays(
        self,
        down_scale: int = 1,
        prob: bool = False,
        rand_samp_perc: float = 1.0,
        last_epoch: bool = False,
        shuffle: bool = True,
        fractional: bool = False,
    ) -> RayEpoch:
        """Generate one epoch's ray set (gen_rays_v3_multiThread analog,
        tree.py:377-428 + gen_rays_v3_1_subThread tree.py:569-624)."""
        if last_epoch:
            # Fresh single-leaf trees; every image contributes H*W uniform
            # pixels (with replacement), tree.py:389-400 + run_nerf.py:437-440.
            forest = QuadTreeForest.uniform(self.n_images, self.H, self.W, 1)
        else:
            forest = self.forest

        counts = self.ray_counts(down_scale, forest)

        if prob and fractional:
            # the reference keeps these as distinct generations
            # (gen_rays_v3_1 prob vs gen_rays_v3 fractional) — silently
            # preferring one over the other hid the conflict
            raise ValueError("prob and fractional sampling are mutually "
                             "exclusive (pick one per epoch)")
        if prob and self.sharpness is not None:
            n_prob = (counts * (1.0 - rand_samp_perc)).astype(np.int64)
            n_unif = counts - n_prob
            leaf_u, px_u, py_u = self._draw_uniform_pixels(forest.boxes, n_unif)
            leaf_p, px_p, py_p = self.sharpness.sample_in_leaves(
                forest.boxes, forest.img, n_prob, self.rng
            )
            # Per-leaf interleave order doesn't matter (global shuffle below).
            leaf_of_ray = np.concatenate([leaf_p, leaf_u])
            px = np.concatenate([px_p, px_u])
            py = np.concatenate([py_p, py_u])
        elif fractional:
            # gen_rays_v3 (tree.py:231-307): fractional pixels + bilinear
            # grid_sample interpolation of rgb/origins/dirs
            leaf_of_ray, pxf, pyf = self._draw_fractional_pixels(
                forest.boxes, counts)
            # shuffle indices BEFORE the 4-tap bilerps (bit-identical to
            # bilerp-then-permute; saves re-permuting 4 float arrays)
            if shuffle:
                perm = self.rng.permutation(leaf_of_ray.shape[0])
                leaf_of_ray = leaf_of_ray[perm]
                pxf, pyf = pxf[perm], pyf[perm]
            img_of_ray = forest.img[leaf_of_ray]
            rgb = self._bilerp(self.images, img_of_ray, pxf, pyf)
            origins = self._bilerp(self.origins, img_of_ray, pxf, pyf)
            dirs = self._bilerp(self.dirs, img_of_ray, pxf, pyf)
            vdirs = (
                self._bilerp(self.viewdirs, img_of_ray, pxf, pyf)
                if self.viewdirs is not None else None
            )
            px = np.minimum(pxf.astype(np.int64), self.H - 1)
            py = np.minimum(pyf.astype(np.int64), self.W - 1)
            leaf_id = leaf_of_ray.astype(np.int32)
            return RayEpoch(
                origins, dirs, rgb, leaf_id, forest.n_leaves, vdirs,
                px.astype(np.int32), py.astype(np.int32),
                img_of_ray.astype(np.int32),
            )
        else:
            leaf_of_ray, px, py = self._draw_uniform_pixels(forest.boxes, counts)

        # Shuffle the INDEX arrays before the big per-pixel gathers:
        # a[idx][perm] == a[idx[perm]] exactly, and permuting 3 small int
        # arrays is far cheaper than re-gathering rgb/origins/dirs/vdirs
        # (at 800^2 x 8 views this takes one epoch gen 1.9 -> 1.5 s on the
        # 1-core host; the rng call order is unchanged, so epochs are
        # bit-identical to the gather-then-permute form).
        if shuffle:
            perm = self.rng.permutation(leaf_of_ray.shape[0])
            leaf_of_ray, px, py = leaf_of_ray[perm], px[perm], py[perm]

        img_of_ray = forest.img[leaf_of_ray]
        # one shared flat index: 4 gathers reuse it instead of each
        # recombining (img, px, py)
        flat = (img_of_ray * self.H + px) * self.W + py
        rgb = self.images.reshape(-1, 3)[flat]
        origins = self.origins.reshape(-1, 3)[flat]
        dirs = self.dirs.reshape(-1, 3)[flat]
        vdirs = (self.viewdirs.reshape(-1, 3)[flat]
                 if self.viewdirs is not None else None)
        leaf_id = leaf_of_ray.astype(np.int32)

        return RayEpoch(
            origins, dirs, rgb, leaf_id, forest.n_leaves, vdirs,
            px.astype(np.int32), py.astype(np.int32),
            img_of_ray.astype(np.int32),
        )

    @RECORDER.spanned("flnerf.budget.adjust")
    def adjust(self, leaf_stat: np.ndarray, thres: float,
               min_area_floor: float = 0.0) -> int:
        """Subdivide based on the on-device per-leaf loss statistic."""
        return self.forest.subdivide(np.asarray(leaf_stat), thres,
                                     min_area_floor=min_area_floor)

    def starvation_floor(self, down_scale: int = 1,
                         margin: float = 4.0) -> float:
        """Smallest safe ``min_area_floor`` (in px) for ``adjust``.

        Derivation (the allocation rule, tree.py:577-581): a deepest leaf
        gets ``area * rate`` rays with
        rate = epoch_size / (n_images * down_scale * H * W); every
        shallower leaf gets a flat 10.  After one more subdivision a
        floor-area leaf's children each draw ``floor/4 * rate`` rays —
        once that falls below the flat 10, refined (hard) regions receive
        FEWER rays than learned ones and starve (the toy-scale fog
        collapse).  Requiring floor/4 * rate >= 10 gives

            floor = margin * 10 / rate,   margin = 4 (the /4 headroom).

        At the reference's scale (800^2, 18 epochs, subdivide_every=3,
        configs/lego.txt:24-26) minArea stops at ~156 px >> 40, so this
        rule never binds there — it only activates at bench/test scales
        where minArea would otherwise drift below the 10-ray floor."""
        rate = self.epoch_size / (self.n_images * down_scale
                                  * self.H * self.W)
        return margin * 10.0 / max(rate, 1e-9)

    def compute_leaf_stat(
        self, epoch: RayEpoch, per_ray_err: np.ndarray, stat: str = "max"
    ) -> np.ndarray:
        """Host fallback for grouping per-ray errors by leaf (the trainer
        reduces by leaf on its device with ``index_add_``)."""
        m = epoch.n_leaves
        if stat == "max":
            out = np.full(m, -np.inf)
            np.maximum.at(out, epoch.leaf_id, per_ray_err)
        else:
            s = np.zeros(m)
            c = np.zeros(m)
            np.add.at(s, epoch.leaf_id, per_ray_err)
            np.add.at(c, epoch.leaf_id, 1.0)
            out = s / np.maximum(c, 1.0)
            out[c == 0] = -np.inf
        return out

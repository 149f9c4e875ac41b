"""LLFF forward-facing dataset loader (poses_bounds.npy convention).

Port of ``flnerf_tpu/data/llff.py`` (numpy, copied; images read through
``data/png.py``).

Parity target: nerf-ours/load_llff.py (load_llff_data at :246) and its pose
tooling — recentering into the average-camera frame, bd_factor rescale, the
spherified orbit variant, the spiral render path, and the nearest-to-mean
held-out view; nerf-ours/run_nerf.py:163-189 consumes the result with
llffhold test splits and NDC bounds.

This is a from-scratch implementation of those semantics (batched frame
construction, loop-free paths); numeric behavior is pinned by the golden
fixture test in tests/test_llff.py (the reference's) and held against
the reference by tests/test_torch_cli_run_nerf.py.

Intentional differences from the reference implementation:
  * image downsampling computes OpenCV's INTER_AREA (``data/resize.py``,
    in numpy) instead of shelling out to imagemagick ``mogrify`` (same
    output resolution);
  * pose math is vectorized (no per-view / per-frame Python loops).
"""

from __future__ import annotations

import os

import numpy as np

# The reference seeds the spherified "up" frame with this arbitrary
# non-axis-aligned vector (any vector not parallel to `up` works; keeping
# the same one keeps render orbits comparable across implementations).
_FRAME_SEED = np.array([0.1, 0.2, 0.3])


def _unit(v: np.ndarray, axis: int = -1) -> np.ndarray:
    return v / np.linalg.norm(v, axis=axis, keepdims=True)


def camera_frame(forward: np.ndarray, up_hint: np.ndarray,
                 origin: np.ndarray) -> np.ndarray:
    """[..., 3, 4] camera-to-world basis: columns (right, up, forward, origin).

    Batched: all inputs broadcast over leading dims.  `up_hint` need not be
    orthogonal to `forward`; it is re-orthogonalized.
    """
    fwd = _unit(forward)
    right = _unit(np.cross(up_hint, fwd))
    up = _unit(np.cross(fwd, right))
    return np.stack([right, up, fwd, np.broadcast_to(origin, fwd.shape)], -1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """[3, 4] mean camera frame: mean origin, summed forward/up directions."""
    return camera_frame(
        poses[:, :3, 2].sum(0), poses[:, :3, 1].sum(0), poses[:, :3, 3].mean(0)
    )


def to_reference_frame(poses: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Express [N, 3, >=4] poses in the frame of a [3, 4] reference pose
    (rigid inverse applied in closed form — no 4x4 padding round-trip)."""
    r_inv = ref[:3, :3].T
    rot = np.einsum("ij,njk->nik", r_inv, poses[:, :3, :3])
    trans = np.einsum("ij,nj->ni", r_inv, poses[:, :3, 3] - ref[:3, 3])
    out = poses.copy()
    out[:, :3, :3] = rot
    out[:, :3, 3] = trans
    return out


def spiral_path(anchor: np.ndarray, up: np.ndarray, radii: np.ndarray,
                focus_depth: float, z_rate: float = 0.5, n_rot: int = 2,
                n_frames: int = 120) -> np.ndarray:
    """[N, 3, 5] look-at spiral around `anchor`, all frames at once.

    Cameras orbit at per-axis `radii` (with z oscillating at `z_rate` x the
    angular rate) and aim at the point `focus_depth` in front of the anchor.
    """
    theta = np.linspace(0.0, 2.0 * np.pi * n_rot, n_frames + 1)[:-1]
    local = np.stack(
        [np.cos(theta), -np.sin(theta), -np.sin(theta * z_rate),
         np.ones_like(theta)], -1
    ) * np.concatenate([radii, [1.0]])                         # [N, 4]
    centers = local @ anchor[:3, :4].T                         # [N, 3]
    target = anchor[:3, :4] @ np.array([0.0, 0.0, -focus_depth, 1.0])
    frames = camera_frame(centers - target, up, centers)       # [N, 3, 4]
    hwf = np.broadcast_to(anchor[:3, 4:5], (n_frames, 3, 1))
    return np.concatenate([frames, hwf], -1)


def nearest_ray_point(origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Least-squares point closest to all rays (the spherify focus).

    Solves  (mean_i P_i) x = mean_i (P_i o_i)  with P_i = I - d_i d_i^T.
    """
    d = _unit(dirs.reshape(-1, 3))
    o = origins.reshape(-1, 3)
    proj = np.eye(3)[None] - d[:, :, None] * d[:, None, :]     # [N, 3, 3]
    lhs = np.einsum("nij,njk->ik", proj.transpose(0, 2, 1), proj) / len(d)
    rhs = np.einsum("nij,nj->i", proj.transpose(0, 2, 1),
                    np.einsum("nij,nj->ni", proj, o)) / len(d)
    return np.linalg.solve(lhs, rhs)


def spherify_poses(poses: np.ndarray, bds: np.ndarray):
    """Re-frame an inward-facing capture onto the unit sphere and build a
    120-frame equatorial orbit (reference spherify_poses semantics)."""
    focus = nearest_ray_point(poses[:, :3, 3], poses[:, :3, 2])
    up = _unit((poses[:, :3, 3] - focus).mean(0))

    # world frame whose +z is `up`, seeded like the reference
    x_axis = _unit(np.cross(_FRAME_SEED, up))
    y_axis = _unit(np.cross(up, x_axis))
    world = np.stack([x_axis, y_axis, up, focus], 1)           # [3, 4]

    reframed = to_reference_frame(poses[:, :3, :4], world)
    scale = 1.0 / np.sqrt(np.mean(np.sum(reframed[:, :3, 3] ** 2, -1)))
    reframed[:, :3, 3] *= scale
    bds = bds * scale

    # equatorial circle at the mean camera height
    z_h = reframed[:, :3, 3].mean(0)[2]
    r_circle = np.sqrt(max(1.0 - z_h ** 2, 0.0))
    phi = np.linspace(0.0, 2.0 * np.pi, 120)
    centers = np.stack(
        [r_circle * np.cos(phi), r_circle * np.sin(phi),
         np.full_like(phi, z_h)], -1
    )
    # +z hint reproduces the reference orbit's basis handedness
    # (its right vector is forward x [0,0,-1])
    orbit = camera_frame(centers, np.array([0.0, 0.0, 1.0]), centers)

    hwf_n = np.broadcast_to(poses[0, :3, 4:5], orbit[:, :3, :1].shape)
    orbit = np.concatenate([orbit, hwf_n], -1)
    hwf_r = np.broadcast_to(poses[0, :3, 4:5], reframed[:, :3, :1].shape)
    reframed = np.concatenate([reframed[:, :3, :4], hwf_r], -1)
    return reframed, orbit, bds


def _load_images(basedir: str, factor: int) -> np.ndarray:
    from flnerf_tpu_torch.data.png import imread
    from flnerf_tpu_torch.data.resize import area_resize

    imgdir = os.path.join(basedir, "images")
    if factor is not None and factor > 1:
        pre = os.path.join(basedir, f"images_{factor}")
        if os.path.isdir(pre):
            imgdir, factor = pre, 1
    files = sorted(
        f for f in os.listdir(imgdir)
        if f.lower().endswith(("jpg", "jpeg", "png"))
    )
    imgs = []
    for f in files:
        im = imread(os.path.join(imgdir, f))
        if factor is not None and factor > 1:
            h, w = im.shape[:2]
            im = area_resize(im, (w // factor, h // factor))
        imgs.append(im[..., :3] / 255.0)
    return np.stack(imgs, 0).astype(np.float32)


def load_llff_data(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: float = 0.75,
    spherify: bool = False,
    path_zflat: bool = False,
):
    """Returns (images, poses [N,3,5], bds [N,2], render_poses, i_test)."""
    raw = np.load(os.path.join(basedir, "poses_bounds.npy"))   # [N, 17]
    n = raw.shape[0]
    poses = raw[:, :15].reshape(n, 3, 5)
    bds = raw[:, 15:17]

    imgs = _load_images(basedir, factor)
    poses[:, 0, 4] = imgs.shape[1]
    poses[:, 1, 4] = imgs.shape[2]
    poses[:, 2, 4] /= factor if factor else 1

    # LLFF stores [down, right, back] columns; convert to [right, up, back]
    poses = np.concatenate(
        [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:]], axis=2
    ).astype(np.float32)
    bds = bds.astype(np.float32)

    scale = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= scale
    bds = bds * scale

    if recenter:
        avg = average_pose(poses)
        poses = to_reference_frame(poses, avg)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        anchor = average_pose(poses)
        anchor = np.concatenate([anchor, poses[0, :3, 4:5]], -1)
        up = _unit(poses[:, :3, 1].sum(0))

        # focus plane from the harmonic blend of near/far (reference dt=.75)
        near, far = bds.min() * 0.9, bds.max() * 5.0
        blend = 0.75
        focus = 1.0 / ((1.0 - blend) / near + blend / far)
        radii = np.percentile(np.abs(poses[:, :3, 3]), 90, 0)
        n_rot, n_frames = 2, 120
        if path_zflat:
            anchor[:3, 3] -= near * 0.1 * anchor[:3, 2]
            radii[2] = 0.0
            n_rot, n_frames = 1, 60
        render_poses = spiral_path(
            anchor, up, radii, focus, z_rate=0.5, n_rot=n_rot,
            n_frames=n_frames,
        )

    render_poses = np.asarray(render_poses, np.float32)
    avg = average_pose(poses)
    i_test = int(np.argmin(
        np.sum((poses[:, :3, 3] - avg[:3, 3]) ** 2, -1)))
    return imgs, poses, bds, render_poses, i_test

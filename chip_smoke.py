#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (flnerf_tpu_torch) on one NVIDIA
H100.  Run from the repository root:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. the card's name and power limit; build every CUDA kernel of the port
     (one nvcc per source, all at once) and report the build seconds;
  2. the fused cuvol kernels K1 (forward) and K2 (backward) against their
     plain version, models/voxel_sh.voxel_render_rays with autograd, at the
     shapes the main path gives them: a 256^3 grid (a filled sphere, ~10% of
     cells pruned), 1792 steps (3.5 * 256 / 0.5), and the main path's own
     first training batch (5000 rays from the quadtree budgeter over the
     synthetic scene's 48x48 train views, grid radius 1.2, in the trainer's
     ray order on the card, built as cli/opt.py builds them); K1 also on one
     48x48 test view (2304 rays, the eval render's one chunk);
  3. the main path: cli/opt.py main on the synthetic scene at 256^3 for 3
     epochs on the card (syn.json's first-stage width: SH degree 3, batch
     5000, 1792 steps), with the launch counters set to 0 just before and
     read just after; train PSNR must rise and the test PSNR be finite;
     3b. a profiled rerun (2 epochs, no checkpoints): where the device time
     goes;
     3c. train rays/s over epochs 2-10 of a 10-epoch run (no checkpoints);
  4. K1, K2's kernel body (its gradients zero-filled outside the timed
     loop; the zero-fill timed apart) and the plain version, by CUDA events
     on phase 2's training batch, beside the least time the card could take
     for the same work; then K1/K2 on batches in the budgeter's shuffled
     order against the trainer's coherence order (morton, 64-ray blocks) at
     48x48 and 800x800 train views, and on one eval chunk of a test view in
     raster against morton order;
  5. the hash-encoding kernels K3 (forward) and K4 (table gradient) against
     their plain version, ops/hash_kernel.hash_encode_plain with autograd,
     at the NGP main path's shapes and on a trained table: the trainer
     cli/main_nerf builds for `synthetic -O` (16 levels x 2^15, bf16 MLPs)
     trains 256 steps, then the kept points of its next batch (NGPSampler
     on the 64x64 synthetic views, 4096 rays x 96 kept samples, rendered
     through the trainer's field and occupancy grid with the train loss's
     real upstream gradient, and with a dense random one) and the first
     65,536-point chunk of a full occupancy refresh go through both;
  6. the NGP main path: cli/main_nerf main `synthetic -O --iters 512` on the
     card (32 chunks: 16 full and 16 partial refreshes), with the launch
     counters set to 0 just before and read just after: K4 once per step,
     K3 once per step, refresh chunk and eval chunk; the last chunk's mean
     train loss below the first's; a finite test PSNR; then train rays/s over
     steps 257-512 (phase 5's trainer, a second fit of 256 steps between
     two synchronizes);
     6b. a profiled fit of 64 more steps: device busy share, top kernels;
  7. K3, K4's body (its gradient zero-filled outside the timed loop; the
     zero-fill timed apart; on the train loss's gradient, and on the dense
     one) and the plain version by CUDA events on phase 5's batch, beside
     the least time the card could take;
  8. the lattice engine's kernels, K5 (sort), K6 (forward) and K7 (table
     gradient), against their plain versions (ops/sort_kernel.py
     bitonic_sort_plain, ops/hash_lattice.py lattice_encode_plain with
     autograd) on the trainer cli/main_nerf builds for `synthetic -O
     --log2_hashmap_size 19` (2 small levels on K3/K4, 14 big ones on a
     [14, 2^19, 2] table) after 256 steps: the kept points of its next
     batch with the train loss's gradient and a dense random one, a
     65,536-point refresh chunk and 65,536 points in two z-slabs; K5 also
     through variant=1;
  9. the lattice main path: `main_nerf synthetic -O --log2_hashmap_size 19
     --iters 512` with the counters set to 0 just before and read just
     after: K3 == K5 == K6 == steps + refresh chunks + eval chunks, K4 == K7
     == steps, no cuvol launch; the loss falls; a finite test PSNR; peak
     memory; train rays/s over steps 257-512; a 64-step profile;
 10. K5 (beside torch.sort on the same keys), K6 and K7's body in sorted
     and in point order, and their plain versions, by CUDA events on phase
     8's batch, beside the least time the card could take, and whether the
     sorted walk pays for its sort;
 11. the sorted engine's kernels, K5 on the engine's own (corner entry,
     slot) pairs, K8 (forward) and K9 (table gradient), against their plain
     versions (bitonic_sort_plain, ops/hash_kernel.py hash_encode_plain on
     the big levels' packed spec with autograd) on the trainer cli/main_nerf
     builds for `synthetic -O --log2_hashmap_size 19 --hash_engine sorted`
     (2 small levels on K3/K4, 14 big ones on a [14, 2^19, 2] table, the
     xor hash) after 256 steps: the kept points of its next batch with the
     train loss's gradient and a dense random one, a 65,536-point refresh
     chunk, 65,536 points in two z-slabs and 65,536 points whose three
     z-clusters share sorted blocks of a dense level;
 12. the sorted main path: `main_nerf synthetic -O --log2_hashmap_size 19
     --hash_engine sorted --iters 512` with the counters set to 0 just
     before and read just after: K3 == K5 == K8 == steps + refresh chunks +
     eval chunks, K4 == K9 == steps, no K1/K2/K6/K7 launch; the loss falls;
     a finite test PSNR, printed beside phase 6's (2^15, xor hash) and
     phase 9's (2^19, lattice hash); peak memory; train rays/s over steps
     257-512; a 64-step profile;
 13. K5 on the engine's pairs (beside torch.sort on the same keys), K8 and
     K9's body (sorted and point order; K9 with and without its warp's run
     sums) and the plain versions, by CUDA events on phase 11's batch,
     beside the least time the card could take.

The last lines are one JSON object describing the kernels, the card's name
and power limit as nvidia-smi gives them, and
{"ok": true, "device": {...}}.  With no CUDA device, or with the port
missing, it exits non-zero and prints no result.
"""

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
RESO = 256
STEP = 0.5
MAX_STEPS = int(3.5 * RESO / STEP)
BATCH = 5000               # cli/opt.py --batch_size: the rays of one train step
SCENE_RADIUS = 1.2         # cli/opt.py's grid radius for the synthetic scene
# floating-point operations per marched sample, counted from the kernels'
# source: sample position (6), trilinear weights (19), 28 channels x 8
# corners multiply-adds (448), 3 SH dot products (54), compositing (15);
# the backward recomputes that and adds a multiply-add per channel and
# corner (448) and the transmittance gradient (30)
FWD_FLOPS_PER_SAMPLE = 542
BWD_FLOPS_PER_SAMPLE = 542 + 448 + 30

NGP_ITERS = 512            # 32 chunks of 16 steps: 16 full, 16 partial refreshes
NGP_WINDOW = 256           # steps per fit of the rays/s window
NGP_PROFILE_STEPS = 64
REFRESH_CHUNK = 1 << 16    # render/ngp.update_occupancy's chunk
# f32 operations per (point, level), counted from csrc/hash_encode.cu:
# position (6), frac and 1 - frac (6), 8 corner weights (16), 8 corners x 2
# features multiply-add (32); K4 recomputes the geometry (28) and forms
# the 16 products w * g (16)
K3_FLOPS = 60
K4_FLOPS = 44
LATTICE_FLAGS = ("--log2_hashmap_size", "19")   # torch-ngp's capacity: the lattice engine
SLAB_POINTS = 1 << 16      # the clustered two-z-slab points of phase 8
# K6/K7 do K3/K4's f32 arithmetic per (point, level) (their integer key
# arithmetic is not counted)
K6_FLOPS = K3_FLOPS
K7_FLOPS = K4_FLOPS
SORTED_FLAGS = ("--log2_hashmap_size", "19", "--hash_engine", "sorted")
CLUSTER_POINTS = 1 << 10   # points in each small cluster of phase 11's three-cluster input
# f32 operations per (point, level), 8 corners, counted from
# csrc/hash_sorted.cu: per corner K8 recomputes the position (6), frac and
# 1 - frac (6), the weight (2), w * f (2) and adds it (2); K9 the same
# geometry (14) and w * g (2), its run sums not counted
K8_FLOPS = 8 * 18
K9_FLOPS = 8 * 16


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters):
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sphere_grid(device):
    """The bench's filled sphere at 256^3 (density U(0,2), SH N(0,0.3^2)
    inside r < 0.55), with ~10% of all cells pruned, from a seed."""
    import torch
    from flnerf_tpu_torch.models.voxel_sh import VoxelGrid
    gen = torch.Generator(device=device).manual_seed(0)
    idx = (torch.arange(RESO, device=device, dtype=torch.float32) - (RESO - 1) / 2) / (RESO / 2)
    x, y, z = torch.meshgrid(idx, idx, idx, indexing="ij")
    inside = torch.sqrt(x * x + y * y + z * z) < 0.55
    shape = (RESO,) * 3
    density = torch.where(inside, 2.0 * torch.rand(shape, generator=gen, device=device), 0.0)
    sh = torch.where(inside[..., None],
                     0.3 * torch.randn(shape + (27,), generator=gen, device=device), 0.0)
    alive = torch.rand(shape, generator=gen, device=device) > 0.1
    return VoxelGrid(density, sh, alive)


def scene():
    """The synthetic scene as cli/opt.py loads it: 8 train and 2 test views
    at 48x48, their poses and intrinsics."""
    from flnerf_tpu_torch.data.synthetic import load_synthetic_data
    from flnerf_tpu_torch.rays.camera import intrinsics_matrix
    images, poses, _, hwf, (i_train, _, i_test) = load_synthetic_data(
        n_train=8, n_test=2, H=48, W=48)
    H, W, focal = int(hwf[0]), int(hwf[1]), hwf[2]
    return images, poses, H, W, focal, intrinsics_matrix(H, W, focal), i_train, i_test


def first_epoch(images, poses, H, W, K, i_train):
    """The quadtree budgeter's first epoch, as cli/opt.py and the trainer
    draw it (init_level 2, seed 0): rays in the budgeter's shuffled order."""
    from flnerf_tpu_torch.rays.camera import get_rays_np
    from flnerf_tpu_torch.rays.quadtree import RayBudgeter
    rays = [get_rays_np(H, W, K, p[:3, :4]) for p in poses[i_train]]
    budgeter = RayBudgeter(images[i_train], np.stack([r[0] for r in rays]),
                           np.stack([r[1] for r in rays]), init_level=2, seed=0)
    return budgeter.gen_rays()


def wide_batches(poses, i_train, size, device):
    """One training batch from the train views rendered at size x size (the
    lego views' 800x800): BATCH pixels drawn uniformly over all views (what
    the budgeter's shuffle gives at a full-pixel budget), and the first BATCH
    pixels of the trainer's coherence order of every pixel."""
    import torch
    from flnerf_tpu_torch.rays.camera import get_rays_np, intrinsics_matrix
    from flnerf_tpu_torch.train.plenoxels_trainer import coherence_order
    K = intrinsics_matrix(size, size, 0.9 * size)
    rays = [get_rays_np(size, size, K, p[:3, :4]) for p in poses[i_train]]
    o_all = np.stack([r[0] for r in rays]).reshape(-1, 3)
    d_all = np.stack([r[1] for r in rays]).reshape(-1, 3)
    n_all = o_all.shape[0]
    shuffled = np.random.default_rng(0).choice(n_all, BATCH, replace=False)
    flat = np.arange(n_all)
    img, pix = flat // (size * size), flat % (size * size)
    ordered = coherence_order(pix // size, pix % size, img, np.random.default_rng(0))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    return {"shuffled": (t(o_all[shuffled]), t(d_all[shuffled])),
            "coherent": (t(o_all[ordered[:BATCH]]), t(d_all[ordered[:BATCH]]))}


def eval_chunks(pose, size, chunk, device):
    """The eval chunk (``--eval_chunk`` rays) of a size x size test view that
    holds its center pixel, in raster and in morton order."""
    import torch
    from flnerf_tpu_torch.ops.voxel_kernel import morton_order
    from flnerf_tpu_torch.rays.camera import get_rays_np, intrinsics_matrix
    ro, rd = get_rays_np(size, size, intrinsics_matrix(size, size, 0.9 * size), pose[:3, :4])
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    center = (size // 2) * size + size // 2
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    out = {}
    for name, order in (("raster", np.arange(size * size)),
                        ("morton", morton_order(xx.reshape(-1), yy.reshape(-1),
                                                np.zeros(size * size, np.int64)))):
        k = int(np.nonzero(order == center)[0][0]) // chunk * chunk
        out[name] = (t(ro[order[k:k + chunk]]), t(rd[order[k:k + chunk]]))
    return out


def work_counts(grid, cfg, o, d):
    """What this run's data needs: the marched samples (t <= tmax) and the
    distinct cells their corners touch (all, and alive)."""
    import torch
    from flnerf_tpu_torch.models.voxel_sh import grid_ray_setup
    origins, dirs, tmin, tmax, _, _ = grid_ray_setup(cfg, o, d)
    steps = torch.arange(cfg.max_steps, device=o.device)
    hi = torch.tensor([r - 1.0 for r in cfg.reso], device=o.device)
    cells, n_samples = [], 0
    for i in range(0, o.shape[0], 128):
        ts = tmin[i:i + 128, None] + cfg.step_size * steps[None, :]
        valid = ts <= tmax[i:i + 128, None]
        pos = origins[i:i + 128, None, :] + ts[..., None] * dirs[i:i + 128, None, :]
        pos = pos[valid]
        n_samples += pos.shape[0]
        pos = torch.minimum(torch.clamp(pos, min=0.0), hi)
        l = torch.minimum(torch.floor(pos), hi - 1.0).long()
        for c in range(8):
            ix, iy, iz = l[:, 0] + (c >> 2), l[:, 1] + ((c >> 1) & 1), l[:, 2] + (c & 1)
            cells.append(((ix * cfg.reso[1] + iy) * cfg.reso[2] + iz).unique())
    cells = torch.cat(cells).unique()
    n_alive = int(grid.alive.reshape(-1)[cells].sum())
    return n_samples, int(cells.numel()), n_alive


def upstream_grad(out, gt):
    """d/d(out) of mean((rgb - gt)^2) + 0.1 * sum(log_T): phase 2's loss."""
    import torch
    g = torch.zeros_like(out)
    g[:, :3] = 2.0 * (out[:, :3] - gt) / gt.numel()
    g[:, 4] = 0.1
    return g


def kernel_ms(grid, cfg, o, d, gt, iters=20):
    """K1 and K2's kernel body on one batch, by CUDA events.  K2 adds into
    gradient buffers zero-filled once, outside the timed loop."""
    import torch
    from flnerf_tpu_torch.ops import voxel_kernel as vk
    ray_in = vk.ray_inputs(cfg, o, d)
    out = vk.cuvol_forward(*grid, *ray_in, cfg)
    grad_out = upstream_grad(out, gt)
    grads = (torch.zeros_like(grid.density), torch.zeros_like(grid.sh))
    k1 = cuda_ms(lambda: vk.cuvol_forward(*grid, *ray_in, cfg), iters)
    k2 = cuda_ms(lambda: vk.cuvol_backward(*grid, *ray_in, out, grad_out, cfg,
                                           grads=grads), iters)
    return k1, k2


def ngp_setup(workspace, extra=()):
    """The NGP trainer and sampler as cli/main_nerf builds them for
    `synthetic -O --iters 512` (plus ``extra`` flags), the test views'
    indices and [H, W, focal]."""
    from flnerf_tpu_torch.cli import main_nerf
    from flnerf_tpu_torch.train.ngp_trainer import NGPSampler
    args = main_nerf.parse_args(["synthetic", "-O", "--iters", str(NGP_ITERS),
                                 "--workspace", workspace, *extra])
    trainer, _, _, tcfg = main_nerf.build(args)
    images, poses, hwf, K, (i_train, _, i_test) = main_nerf.load_ngp_dataset(args)
    sampler = NGPSampler(images[i_train], poses[i_train], K, tcfg, seed=args.seed)
    return trainer, sampler, i_test, hwf


def expected_hash_launches(trainer, n_test, hwf):
    """K3 launches of one main_nerf run: one per train step, per refresh
    chunk (full sweeps for the first full_refreshes chunks, then one parity
    class) and per eval chunk.  Returns (total, refresh chunks, eval chunks)."""
    tcfg, rcfg = trainer.cfg, trainer.rcfg
    n_chunks = -(-tcfg.max_steps // tcfg.steps_per_chunk)
    g, s = rcfg.grid_size, max(rcfg.partial_stride, 2)
    full = -(-g ** 3 // REFRESH_CHUNK)
    part = -(-(g // s) ** 3 // REFRESH_CHUNK) if g % s == 0 else full
    refresh = sum(part if ci >= tcfg.full_refreshes else full for ci in range(n_chunks))
    n = hwf[0] * hwf[1]
    chunk = min(4096, (n + 127) // 128 * 128)        # main_nerf --max_ray_batch
    n_eval = n_test * -(-n // chunk)
    return n_chunks * tcfg.steps_per_chunk + refresh + n_eval, refresh, n_eval


def bound_of(nbytes, flops):
    """(least ms, what bounds it): bytes over HBM, f32 operations over the
    f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def pair_codes(keys, payload):
    """Per row, the sorted int64 codes key << 32 | payload: equal codes mean
    equal keys and an equal multiset of payloads per key."""
    import torch
    return torch.sort((keys.long() << 32) | (payload.long() & 0xFFFFFFFF), dim=-1)[0]


def next_batch_encode(trainer, sampler, to_dev, encoder):
    """The encoding's input and the train loss's real upstream gradient on
    the trainer's next batch: ``encoder`` (the encode's name in
    models/hash_ngp) is wrapped while the batch renders through the
    trainer's field and occupancy grid.  Returns (x01, gradient of the whole
    [N, L*2] encoding).  (The loss is differentiated for the field's first
    table, which every engine's encoding reads.)"""
    import torch
    from flnerf_tpu_torch.models import hash_ngp
    from flnerf_tpu_torch.render.ngp import ngp_render_rays
    bo, bd, brgb, _, _ = copy.deepcopy(sampler).sample_chunk(1, trainer.cfg.batch_rays)
    seen = {}
    inner = getattr(hash_ngp, encoder)

    def capture(x01, tables, spec_):
        out = inner(x01, tables, spec_)
        seen["x01"] = x01
        out.register_hook(lambda g: seen.setdefault("g", g))
        return out

    setattr(hash_ngp, encoder, capture)
    try:
        out = ngp_render_rays(trainer.field, trainer.occ, to_dev(bo[0]), to_dev(bd[0]),
                              trainer.rcfg, generator=trainer.gen)
        torch.autograd.grad(torch.mean((out["rgb"] - to_dev(brgb[0])) ** 2),
                            [next(trainer.field.parameters())])
    finally:
        setattr(hash_ngp, encoder, inner)
    return seen["x01"].detach().contiguous(), seen["g"]


def refresh_chunk(trainer, gen):
    """The first REFRESH_CHUNK cells of a full occupancy refresh, jittered,
    as the encoding's input."""
    import torch
    dev = trainer.device
    g_cells = trainer.rcfg.grid_size
    idx = torch.arange(g_cells, device=dev)
    cells = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1).reshape(-1, 3)
    cells = cells[:REFRESH_CHUNK].float() + torch.rand((REFRESH_CHUNK, 3), generator=gen,
                                                       device=dev)
    return trainer.field.unit_points(
        (cells / g_cells * 2.0 - 1.0) * trainer.rcfg.bound).contiguous()


def two_slabs(gen, dev):
    """SLAB_POINTS points in two separated z-slabs
    (tests/test_hash_lattice.py:60), where the TPU engines drop corners
    outside their slabs."""
    import torch
    x = torch.rand((SLAB_POINTS, 3), generator=gen, device=dev)
    x[:, 2] *= 0.08
    x[SLAB_POINTS // 2:, 2] += 0.9
    return x


def lattice_phases(dev, to_dev):
    """Phases 8-10, the hash-NGP path at 2^19 (the lattice engine, K3-K7).
    Returns the K5, K5', K6 and K7 rows of the kernels line and phase 9's
    test PSNR."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from flnerf_tpu_torch.cli import main_nerf
    from flnerf_tpu_torch.ops import hash_kernel as hk
    from flnerf_tpu_torch.ops import hash_lattice as hl
    from flnerf_tpu_torch.ops import sort_kernel as sk
    from flnerf_tpu_torch.ops import voxel_kernel as vk

    # ---- phase 8: K5, K6 and K7 against their plain versions ----
    lat_tmp = tempfile.TemporaryDirectory()
    trainer, sampler, n_test, hwf = ngp_setup(lat_tmp.name, LATTICE_FLAGS)
    spec = trainer.field.spec
    n_small = spec.split.n_small
    trainer.fit(sampler, verbose=False, n_steps=NGP_WINDOW)    # steps 1-256
    # the next batch, through the trainer's own loss: the big levels' input
    # and real upstream gradient are read at the split encode
    x_batch, g_seen = next_batch_encode(trainer, sampler, to_dev, "lattice_encode_split")
    table = trainer.field.table_big.detach().clone()
    g_train = g_seen[:, 2 * n_small:].contiguous()
    gen = torch.Generator(device=dev).manual_seed(2)
    x_refresh = refresh_chunk(trainer, gen)
    x_slabs = two_slabs(gen, dev)
    inputs = {"train batch": x_batch, "refresh chunk": x_refresh, "two z-slabs": x_slabs}
    print(f"[phase 8] lattice spec: {n_small} small levels (t_cap {spec.split.small.t_cap}), "
          f"{spec.n_big} big levels (sizes {spec.split.big.sizes.tolist()}), big table "
          f"{tuple(table.shape)} = {table.numel() * 4 / 1e6:.1f} MB", flush=True)

    k5_err = 0
    for name, xx in inputs.items():
        keys, iota = hl.lattice_sort_inputs(xx, spec)
        want = sk.bitonic_sort_plain(keys, iota)
        for variant in (2, 1):
            got = sk.bitonic_sort(keys, iota, variant=variant)
            torch.cuda.synchronize()
            wrong = int((got[0] != want[0]).sum())
            same_pairs = torch.equal(pair_codes(*got), pair_codes(*want))
            print(f"[phase 8] K5 (variant {variant}) on the {name}'s keys "
                  f"{tuple(keys.shape)}: {wrong} keys differ, payload multisets per key "
                  f"{'equal' if same_pairs else 'DIFFER'}", flush=True)
            check(wrong == 0 and same_pairs,
                  f"K5 (variant {variant}) differs from the plain version ({name})")
            k5_err = max(k5_err, int((got[0].long() - want[0].long()).abs().max()))
    del got, want

    k6_err = k7_err = 0.0
    orders = {}
    for name, xx in inputs.items():
        orders[name] = order = hl.lattice_sort_order(xx, spec)
        with torch.no_grad():
            out_k = hl.lattice_encode_forward(xx, table, spec, order)
            out_p = hl.lattice_encode_plain(xx, table, spec)
        torch.cuda.synchronize()
        err, scale = float((out_k - out_p).abs().max()), float(out_p.abs().max())
        print(f"[phase 8] K6 on the {name} {tuple(xx.shape)}: max_err {err:.3e} "
              f"(largest output {scale:.4e})", flush=True)
        check(bool(torch.isfinite(out_k).all()), f"K6 output not finite ({name})")
        check(scale > 0 and err <= 1e-6 * scale,
              f"K6 differs from the plain version by {err} > 1e-6 * {scale} ({name})")
        k6_err = max(k6_err, err)
    del out_k, out_p
    grads = [("train batch", "train gradient", g_train)] + [
        (name, "dense gradient", torch.randn((xx.shape[0], 2 * spec.n_big), generator=gen,
                                             device=dev))
        for name, xx in inputs.items()]
    for name, what, g_up in grads:
        xx = inputs[name]
        grad_k = hl.lattice_encode_backward(xx, g_up, spec, orders[name])
        tp = table.clone().requires_grad_(True)
        (grad_p,) = torch.autograd.grad(hl.lattice_encode_plain(xx, tp, spec), [tp], g_up)
        torch.cuda.synchronize()
        err, scale = float((grad_k - grad_p).abs().max()), float(grad_p.abs().max())
        live = float((g_up != 0).any(-1).float().mean())
        print(f"[phase 8] K7 on the {name}, {what} (nonzero at {live:.4f} of the points): "
              f"max_err {err:.3e} (largest entry {scale:.4e})", flush=True)
        # on the plateau the train gradient may be zero at every point; then
        # K7 must give exactly zero too
        check((scale > 0 or what == "train gradient") and err <= 1e-4 * scale,
              f"K7 differs from the plain version by {err} > 1e-4 * {scale} ({name}, {what})")
        k7_err = max(k7_err, err)
    g_dense = grads[1][2]
    del grad_k, grad_p, tp, grads

    # ---- phase 9: the lattice main path, through the CLI on the card ----
    for mod in (hk, hl, sk, vk):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        res = main_nerf.main(["synthetic", "-O", *LATTICE_FLAGS, "--iters", str(NGP_ITERS),
                              "--workspace", tmp])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {"K3": hk.HASH_FWD_LAUNCHES, "K4": hk.HASH_BWD_LAUNCHES,
                    "K5": sk.SORT_LAUNCHES, "K6": hl.LATTICE_FWD_LAUNCHES,
                    "K7": hl.LATTICE_BWD_LAUNCHES}
        with open(os.path.join(tmp, "results.txt")) as f:
            results = f.read().split()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = res["steps"]
    losses = [h["chunk_loss"] for h in res["history"]]
    want_fwd, n_refresh, n_eval = expected_hash_launches(trainer, len(n_test), hwf)
    print(f"[phase 9] launches {launches} (K1 {vk.FWD_LAUNCHES}, K2 {vk.BWD_LAUNCHES}); "
          f"steps {steps}, refresh chunks {n_refresh}, eval chunks {n_eval}; mean train loss "
          f"per chunk first {losses[0]:.5f} last {losses[-1]:.5f} (min {min(losses):.5f} max "
          f"{max(losses[1:]):.5f} after the first); test PSNR {res['psnr']:.3f} SSIM "
          f"{res['ssim']:.4f}; main {wall:.1f} s; peak memory {peak_gb:.2f} GB; results.txt "
          f"{results}", flush=True)
    check(launches["K4"] == launches["K7"] == steps == NGP_ITERS,
          f"K4/K7 launches {launches} != steps {steps}")
    check(launches["K3"] == launches["K5"] == launches["K6"] == want_fwd,
          f"K3/K5/K6 launches {launches} != steps + refresh + eval chunks {want_fwd}")
    check(vk.FWD_LAUNCHES == vk.BWD_LAUNCHES == 0, "the NGP path launched a cuvol kernel")
    check(all(math.isfinite(v) for v in losses), f"train loss not finite: {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(math.isfinite(res["psnr"]), f"test PSNR not finite: {res['psnr']}")

    torch.cuda.synchronize()
    t0 = time.time()
    trainer.fit(sampler, verbose=False, n_steps=NGP_WINDOW)
    torch.cuda.synchronize()
    win_s = time.time() - t0
    print(f"[phase 9] train rays/s over steps {NGP_WINDOW + 1}-{2 * NGP_WINDOW}: "
          f"{NGP_WINDOW * trainer.cfg.batch_rays / win_s:.1f} ({NGP_WINDOW} steps, "
          f"{NGP_WINDOW // trainer.cfg.steps_per_chunk} partial refreshes, {win_s:.3f} s); "
          f"loss {trainer.history[-1]['loss']:.5f}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.fit(sampler, verbose=False, n_steps=NGP_PROFILE_STEPS)
        torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3
    dev_events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    print(f"[phase 9] profiled lattice fit of {NGP_PROFILE_STEPS} steps: device busy "
          f"{dev_ms:.1f} ms of {prof_wall_ms:.1f} ms wall ({100 * dev_ms / prof_wall_ms:.1f}%); "
          f"top kernels by device time:")
    for e in dev_events[:14] + [e for e in dev_events[14:]
                                if "hash_" in e.key or "lattice" in e.key or "bitonic" in e.key]:
        print(f"[phase 9]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    lat_tmp.cleanup()

    # ---- phase 10: K5, K6 and K7 times on phase 8's batch ----
    n_pts, lb = x_batch.shape[0], spec.n_big
    keys, iota = hl.lattice_sort_inputs(x_batch, spec)
    k5_ms = cuda_ms(lambda: sk.bitonic_sort(keys, iota), 20)
    k5_plain_ms = cuda_ms(lambda: sk.bitonic_sort_plain(keys, iota), 20)
    k5_lib_ms = cuda_ms(lambda: torch.sort(keys, dim=-1), 20)
    keys_ms = cuda_ms(lambda: hl.lattice_sort_inputs(x_batch, spec), 20)
    order = orders["train batch"]
    ident = torch.arange(n_pts, dtype=torch.int32, device=dev).expand(lb, n_pts).contiguous()
    grad_buf = torch.zeros((lb, spec.t_big, 2), device=dev)
    ms = {}
    for oname, o in (("sorted", order), ("point", ident)):
        ms[f"K6 {oname}"] = cuda_ms(lambda: hl.lattice_encode_forward(x_batch, table, spec, o), 20)
        ms[f"K7 {oname} dense"] = cuda_ms(lambda: hl.lattice_encode_backward(
            x_batch, g_dense, spec, o, grad_table=grad_buf), 20)
        ms[f"K7 {oname} train"] = cuda_ms(lambda: hl.lattice_encode_backward(
            x_batch, g_train, spec, o, grad_table=grad_buf), 20)
    zero_ms = cuda_ms(lambda: torch.zeros((lb, spec.t_big, 2), device=dev), 20)
    with torch.no_grad():
        k6_plain_ms = cuda_ms(lambda: hl.lattice_encode_plain(x_batch, table, spec), 5)
    tp = table.clone().requires_grad_(True)
    out_g = hl.lattice_encode_plain(x_batch, tp, spec)
    k7_plain_ms = cuda_ms(lambda: torch.autograd.grad(out_g, [tp], g_dense, retain_graph=True), 5)
    del out_g, tp
    # what this batch's data needs: the distinct big-table entries its
    # corners touch (K6), and those of the points with a nonzero gradient
    cidx, _ = hl.corner_indices_weights(x_batch, spec)                 # [Lb, N, 8]
    cidx = cidx + torch.arange(lb, device=dev)[:, None, None] * spec.t_big
    touched = int(cidx.unique().numel())
    live = (g_train != 0).any(-1)
    live_pts = int(live.sum())
    touched_live = int(cidx[:, live].unique().numel())
    del cidx
    # the encode's own bytes: x01 and the [N, Lb*2] output (K6) or upstream
    # gradient (K7) once, each touched entry read once (K6) or read and
    # written once (K7's body adds into the gradient); the walk order is the
    # sorted design's and is not counted
    x_bytes, io_bytes = n_pts * 12, n_pts * lb * 8
    bounds = {
        "K5": bound_of(2 * keys.numel() * 8, 0),
        "K6": bound_of(x_bytes + io_bytes + touched * 8, n_pts * lb * K6_FLOPS),
        "K7": bound_of(x_bytes + io_bytes + touched * 16, n_pts * lb * K7_FLOPS),
        "K7 train": bound_of(x_bytes + io_bytes + touched_live * 16, live_pts * lb * K7_FLOPS),
    }
    sorted_total = keys_ms + k5_ms + ms["K6 sorted"] + ms["K7 sorted dense"]
    point_total = ms["K6 point"] + ms["K7 point dense"]
    print(f"[phase 10] train batch: {n_pts} points x {lb} big levels, {touched} distinct "
          f"big-table entries touched ({touched_live} by the {live_pts} points with a "
          f"gradient); L2 sector volume {n_pts * lb * 8 * 32 / 1e6:.1f} MB (8 corners x a "
          f"32 B sector per point and level) for {n_pts * lb * 8 * 8 / 1e6:.1f} MB of "
          f"gathered entries", flush=True)
    print(f"[phase 10] K5 on keys {tuple(keys.shape)}: {k5_ms:.4f} ms (plain "
          f"{k5_plain_ms:.4f} ms; torch.sort {k5_lib_ms:.4f} ms; bound "
          f"{bounds['K5'][0]:.4f} ms by {bounds['K5'][1]}); base keys and padding "
          f"{keys_ms:.4f} ms", flush=True)
    print(f"[phase 10] K6 sorted order {ms['K6 sorted']:.4f} ms, point order "
          f"{ms['K6 point']:.4f} ms (plain {k6_plain_ms:.3f} ms, bound {bounds['K6'][0]:.4f} ms "
          f"by {bounds['K6'][1]}); K7 body on the dense gradient sorted "
          f"{ms['K7 sorted dense']:.4f} ms, point {ms['K7 point dense']:.4f} ms (plain "
          f"backward {k7_plain_ms:.3f} ms, bound {bounds['K7'][0]:.4f} ms by "
          f"{bounds['K7'][1]}); on the train gradient sorted {ms['K7 sorted train']:.4f} ms, "
          f"point {ms['K7 point train']:.4f} ms (bound {bounds['K7 train'][0]:.4f} ms); "
          f"zero-fill {zero_ms:.4f} ms", flush=True)
    print(f"[phase 10] sorted walk incl. keys and sort (keys + K5 + K6 + K7 dense) "
          f"{sorted_total:.4f} ms vs point order (K6 + K7 dense) {point_total:.4f} ms: "
          f"{'sorted' if sorted_total < point_total else 'point'} order is faster; launches "
          f"per train step K5 {launches['K5'] / steps:.4f}, K6 {launches['K6'] / steps:.4f}, "
          f"K7 {launches['K7'] / steps:.4f}", flush=True)

    src = "flnerf_tpu_torch/ops/csrc/hash_lattice.cu"
    return res["psnr"], [
        {"name": "bitonic_sort (K5)", "route": "cuda", "source": src,
         "replaces": "flnerf_tpu/ops/sort_pallas.py:118", "launches": launches["K5"],
         "max_abs_err": float(k5_err), "ms": k5_ms, "plain_ms": k5_plain_ms,
         "bound_ms": bounds["K5"][0], "bound_by": bounds["K5"][1], "library_ms": k5_lib_ms},
        # K5' is K5's kernel: the variant chose a TPU schedule only, so the
        # row repeats K5's launches and times
        {"name": "bitonic_sort variant=1 (K5', the same kernel as K5)", "route": "cuda",
         "source": src, "replaces": "flnerf_tpu/ops/sort_pallas.py:61",
         "launches": launches["K5"], "max_abs_err": float(k5_err), "ms": k5_ms,
         "plain_ms": k5_plain_ms, "bound_ms": bounds["K5"][0], "bound_by": bounds["K5"][1],
         "library_ms": k5_lib_ms},
        {"name": "lattice_encode_forward (K6)", "route": "cuda", "source": src,
         "replaces": "flnerf_tpu/ops/hash_lattice.py:415", "launches": launches["K6"],
         "max_abs_err": k6_err, "ms": ms["K6 sorted"], "plain_ms": k6_plain_ms,
         "bound_ms": bounds["K6"][0], "bound_by": bounds["K6"][1], "library_ms": None},
        {"name": "lattice_encode_backward (K7)", "route": "cuda", "source": src,
         "replaces": "flnerf_tpu/ops/hash_lattice.py:502", "launches": launches["K7"],
         "max_abs_err": k7_err, "ms": ms["K7 sorted dense"], "plain_ms": k7_plain_ms,
         "bound_ms": bounds["K7"][0], "bound_by": bounds["K7"][1], "library_ms": None},
    ]


def three_clusters(gen, dev):
    """SLAB_POINTS points: a bulk in z < 0.15 and three tiny z-clusters of
    CLUSTER_POINTS (tests/test_hash_sorted.py:180 at this scale), whose
    keys share sorted blocks of a dense level; the TPU engine gives zeros
    for the middle cluster's corners outside its head and tail slabs."""
    import torch
    x = torch.rand((SLAB_POINTS, 3), generator=gen, device=dev)
    nf = SLAB_POINTS - 3 * CLUSTER_POINTS
    x[:nf, 2] *= 0.15
    for k, z in enumerate((0.40, 0.82, 0.95)):
        sl = slice(nf + k * CLUSTER_POINTS, nf + (k + 1) * CLUSTER_POINTS)
        x[sl, 2] = z + 0.001 * x[sl, 2]
    return x


def sorted_phases(dev, to_dev, other_psnrs=None):
    """Phases 11-13, the hash-NGP path at 2^19 on the sorted engine (K3, K4,
    K5, K8, K9).  ``other_psnrs`` names the other NGP paths' test PSNRs, to
    print beside this one's.  Returns the K8 and K9 rows of the kernels
    line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from flnerf_tpu_torch.cli import main_nerf
    from flnerf_tpu_torch.ops import hash_kernel as hk
    from flnerf_tpu_torch.ops import hash_lattice as hl
    from flnerf_tpu_torch.ops import hash_sorted as hs
    from flnerf_tpu_torch.ops import sort_kernel as sk
    from flnerf_tpu_torch.ops import voxel_kernel as vk

    # ---- phase 11: K5 on the engine's pairs, K8 and K9 against their plain versions ----
    tmp_dir = tempfile.TemporaryDirectory()
    trainer, sampler, n_test, hwf = ngp_setup(tmp_dir.name, SORTED_FLAGS)
    spec = trainer.field.spec
    bspec = hs._big_packed_spec(spec)
    lb = spec.n_big
    trainer.fit(sampler, verbose=False, n_steps=NGP_WINDOW)    # steps 1-256
    x_batch, g_seen = next_batch_encode(trainer, sampler, to_dev, "hash_encode_split")
    table = trainer.field.table_big.detach().clone()
    g_train = g_seen[:, 2 * spec.n_small:].contiguous()
    gen = torch.Generator(device=dev).manual_seed(3)
    inputs = {"train batch": x_batch, "refresh chunk": refresh_chunk(trainer, gen),
              "two z-slabs": two_slabs(gen, dev), "three z-clusters": three_clusters(gen, dev)}
    print(f"[phase 11] split spec: {spec.n_small} small levels (t_cap {spec.small.t_cap}), "
          f"{lb} big levels (sizes {spec.big.sizes.tolist()}, hashed "
          f"{spec.big.use_hash.astype(int).tolist()}), big table {tuple(table.shape)} = "
          f"{table.numel() * 4 / 1e6:.1f} MB; {hs.POINT_CAP} points a chunk", flush=True)

    pairs = {}
    for name, xx in inputs.items():
        unsorted = hs.sort_inputs(xx, spec)
        keys, pay = unsorted[..., 0].contiguous(), unsorted[..., 1].contiguous()
        want = sk.bitonic_sort_plain(keys, pay)
        got = sk.sort_pairs_(unsorted.clone())
        torch.cuda.synchronize()
        wrong = int((got[..., 0] != want[0]).sum())
        same_pairs = torch.equal(pair_codes(got[..., 0], got[..., 1]), pair_codes(*want))
        print(f"[phase 11] K5 on the {name}'s pairs {tuple(unsorted.shape)}: {wrong} keys "
              f"differ, payload multisets per key {'equal' if same_pairs else 'DIFFER'}",
              flush=True)
        check(wrong == 0 and same_pairs, f"K5 differs from the plain version ({name})")
        pairs[name] = (unsorted, got)
    del keys, pay, want

    k8_err = k9_err = 0.0
    for name, xx in inputs.items():
        with torch.no_grad():
            out_k = hs.sorted_encode_forward(xx, table, spec, pairs[name][1])
            out_p = hk.hash_encode_plain(xx, table, bspec)
        torch.cuda.synchronize()
        err, scale = float((out_k - out_p).abs().max()), float(out_p.abs().max())
        print(f"[phase 11] K8 on the {name} {tuple(xx.shape)}: max_err {err:.3e} "
              f"(largest output {scale:.4e})", flush=True)
        check(bool(torch.isfinite(out_k).all()), f"K8 output not finite ({name})")
        check(scale > 0 and err <= 1e-6 * scale,
              f"K8 differs from the plain version by {err} > 1e-6 * {scale} ({name})")
        k8_err = max(k8_err, err)
    del out_k, out_p
    grads = [("train batch", "train gradient", g_train)] + [
        (name, "dense gradient", torch.randn((xx.shape[0], 2 * lb), generator=gen, device=dev))
        for name, xx in inputs.items()]
    for name, what, g_up in grads:
        xx = inputs[name]
        grad_k = hs.sorted_encode_backward(xx, g_up, spec, pairs[name][1])
        tp = table.clone().requires_grad_(True)
        (grad_p,) = torch.autograd.grad(hk.hash_encode_plain(xx, tp, bspec), [tp], g_up)
        torch.cuda.synchronize()
        err, scale = float((grad_k - grad_p).abs().max()), float(grad_p.abs().max())
        live = float((g_up != 0).any(-1).float().mean())
        print(f"[phase 11] K9 on the {name}, {what} (nonzero at {live:.4f} of the points): "
              f"max_err {err:.3e} (largest entry {scale:.4e})", flush=True)
        # the train gradient may be zero at every point (the 2^15 plateau);
        # then K9 must give exactly zero too
        check((scale > 0 or what == "train gradient") and err <= 1e-4 * scale,
              f"K9 differs from the plain version by {err} > 1e-4 * {scale} ({name}, {what})")
        k9_err = max(k9_err, err)
    g_dense = grads[1][2]
    del grad_k, grad_p, tp, grads

    # ---- phase 12: the sorted main path, through the CLI on the card ----
    for mod in (hk, hl, hs, sk, vk):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        res = main_nerf.main(["synthetic", "-O", *SORTED_FLAGS, "--iters", str(NGP_ITERS),
                              "--workspace", tmp])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {"K3": hk.HASH_FWD_LAUNCHES, "K4": hk.HASH_BWD_LAUNCHES,
                    "K5": sk.SORT_LAUNCHES, "K8": hs.SORTED_FWD_LAUNCHES,
                    "K9": hs.SORTED_BWD_LAUNCHES}
        others = {"K1": vk.FWD_LAUNCHES, "K2": vk.BWD_LAUNCHES,
                  "K6": hl.LATTICE_FWD_LAUNCHES, "K7": hl.LATTICE_BWD_LAUNCHES}
        with open(os.path.join(tmp, "results.txt")) as f:
            results = f.read().split()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = res["steps"]
    losses = [h["chunk_loss"] for h in res["history"]]
    want_fwd, n_refresh, n_eval = expected_hash_launches(trainer, len(n_test), hwf)
    print(f"[phase 12] launches {launches} (others {others}); steps {steps}, refresh chunks "
          f"{n_refresh}, eval chunks {n_eval}; mean train loss per chunk first "
          f"{losses[0]:.5f} last {losses[-1]:.5f} (min {min(losses):.5f} max "
          f"{max(losses[1:]):.5f} after the first); test PSNR {res['psnr']:.3f} SSIM "
          f"{res['ssim']:.4f}; main {wall:.1f} s; peak memory {peak_gb:.2f} GB; results.txt "
          f"{results}", flush=True)
    psnrs = dict(other_psnrs or {})
    psnrs["2^19, xor hash (phase 12, the sorted engine)"] = res["psnr"]
    print("[phase 12] test PSNR after " + str(NGP_ITERS) + " steps: " + "; ".join(
        f"{k} {v:.3f}" for k, v in psnrs.items()), flush=True)
    check(launches["K4"] == launches["K9"] == steps == NGP_ITERS,
          f"K4/K9 launches {launches} != steps {steps}")
    check(launches["K3"] == launches["K5"] == launches["K8"] == want_fwd,
          f"K3/K5/K8 launches {launches} != steps + refresh + eval chunks {want_fwd}")
    check(not any(others.values()), f"the sorted path launched another engine's kernel: "
                                    f"{others}")
    check(all(math.isfinite(v) for v in losses), f"train loss not finite: {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(math.isfinite(res["psnr"]), f"test PSNR not finite: {res['psnr']}")

    torch.cuda.synchronize()
    t0 = time.time()
    trainer.fit(sampler, verbose=False, n_steps=NGP_WINDOW)
    torch.cuda.synchronize()
    win_s = time.time() - t0
    print(f"[phase 12] train rays/s over steps {NGP_WINDOW + 1}-{2 * NGP_WINDOW}: "
          f"{NGP_WINDOW * trainer.cfg.batch_rays / win_s:.1f} ({NGP_WINDOW} steps, "
          f"{NGP_WINDOW // trainer.cfg.steps_per_chunk} partial refreshes, {win_s:.3f} s); "
          f"loss {trainer.history[-1]['loss']:.5f}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.fit(sampler, verbose=False, n_steps=NGP_PROFILE_STEPS)
        torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3
    dev_events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    print(f"[phase 12] profiled sorted-engine fit of {NGP_PROFILE_STEPS} steps: device busy "
          f"{dev_ms:.1f} ms of {prof_wall_ms:.1f} ms wall ({100 * dev_ms / prof_wall_ms:.1f}%); "
          f"top kernels by device time:")
    for e in dev_events[:14] + [e for e in dev_events[14:]
                                if "hash_" in e.key or "sorted" in e.key or "bitonic" in e.key]:
        print(f"[phase 12]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    del trainer, sampler
    tmp_dir.cleanup()

    # ---- phase 13: K5, K8 and K9 times on phase 11's batch ----
    n_pts = x_batch.shape[0]
    unsorted, spairs = pairs["train batch"]
    keys, pay = unsorted[..., 0].contiguous(), unsorted[..., 1].contiguous()
    work = spairs.clone()
    # the bitonic network is oblivious to the data: sorting sorted rows again
    # is the same work
    k5_ms = cuda_ms(lambda: sk.sort_pairs_(work), 10)
    k5_plain_ms = cuda_ms(lambda: sk.bitonic_sort_plain(keys, pay), 5)
    k5_lib_ms = cuda_ms(lambda: torch.sort(keys, dim=-1), 5)
    prep_ms = cuda_ms(lambda: hs.sort_inputs(x_batch, spec), 10)
    del work
    out_buf = torch.zeros((n_pts, 2 * lb), device=dev)
    grad_buf = torch.zeros((lb, spec.t_cap_big, 2), device=dev)
    ms = {}
    for oname, pr in (("sorted", spairs), ("point", unsorted)):
        ms[f"K8 {oname}"] = cuda_ms(lambda: hs.sorted_encode_forward(
            x_batch, table, spec, pr, out=out_buf), 20)
        for agg, tag in ((True, "run sums"), (False, "per corner")):
            for gname, g_up in (("dense", g_dense), ("train", g_train)):
                ms[f"K9 {oname} {gname} {tag}"] = cuda_ms(lambda: hs.sorted_encode_backward(
                    x_batch, g_up, spec, pr, grad_table=grad_buf, aggregate=agg), 20)
    out_zero_ms = cuda_ms(lambda: torch.zeros((n_pts, 2 * lb), device=dev), 20)
    grad_zero_ms = cuda_ms(lambda: torch.zeros((lb, spec.t_cap_big, 2), device=dev), 20)
    del out_buf, grad_buf
    with torch.no_grad():
        k8_plain_ms = cuda_ms(lambda: hk.hash_encode_plain(x_batch, table, bspec), 5)
    tp = table.clone().requires_grad_(True)
    out_g = hk.hash_encode_plain(x_batch, tp, bspec)
    k9_plain_ms = cuda_ms(lambda: torch.autograd.grad(out_g, [tp], g_dense, retain_graph=True), 5)
    del out_g, tp
    # what this batch's data needs: the distinct big-table entries its
    # corners touch (K8), and those of the points with a nonzero gradient
    ck = hs.corner_keys(x_batch, spec).long()
    ck = ck + torch.arange(lb, device=dev)[:, None, None] * spec.t_cap_big
    touched = int(ck.unique().numel())
    live = (g_train != 0).any(-1)
    live_pts = int(live.sum())
    touched_live = int(ck[:, live].unique().numel())
    del ck
    # the encode's own bytes: x01 and the [N, Lb*2] output (K8) or upstream
    # gradient (K9) once, each touched entry read once (K8) or read and
    # written once (K9's body adds into the gradient); the pairs are the
    # sorted design's own and are not counted
    x_bytes, io_bytes = n_pts * 12, n_pts * lb * 8
    bounds = {
        "K5": bound_of(2 * spairs.numel() * 4, 0),
        "K8": bound_of(x_bytes + io_bytes + touched * 8, n_pts * lb * K8_FLOPS),
        "K9": bound_of(x_bytes + io_bytes + touched * 16, n_pts * lb * K9_FLOPS),
        "K9 train": bound_of(x_bytes + io_bytes + touched_live * 16, live_pts * lb * K9_FLOPS),
    }
    print(f"[phase 13] train batch: {n_pts} points x {lb} big levels in "
          f"{spairs.shape[0] // lb} chunks, pairs {tuple(spairs.shape)} = "
          f"{spairs.numel() * 4 / 1e6:.1f} MB; {touched} distinct big-table entries touched "
          f"({touched_live} by the {live_pts} points with a gradient)", flush=True)
    print(f"[phase 13] K5 on the engine's pairs: {k5_ms:.4f} ms (plain {k5_plain_ms:.4f} ms; "
          f"torch.sort of the keys {k5_lib_ms:.4f} ms; bound {bounds['K5'][0]:.4f} ms by "
          f"{bounds['K5'][1]}); keys, payloads and padding (sort_inputs) {prep_ms:.4f} ms",
          flush=True)
    print(f"[phase 13] K8 body sorted order {ms['K8 sorted']:.4f} ms, point order "
          f"{ms['K8 point']:.4f} ms (plain {k8_plain_ms:.3f} ms, bound {bounds['K8'][0]:.4f} ms "
          f"by {bounds['K8'][1]}); output zero-fill {out_zero_ms:.4f} ms", flush=True)
    for gname, bname in (("dense", "K9"), ("train", "K9 train")):
        print(f"[phase 13] K9 body on the {gname} gradient: sorted order run sums "
              f"{ms[f'K9 sorted {gname} run sums']:.4f} ms, per corner "
              f"{ms[f'K9 sorted {gname} per corner']:.4f} ms; point order run sums "
              f"{ms[f'K9 point {gname} run sums']:.4f} ms, per corner "
              f"{ms[f'K9 point {gname} per corner']:.4f} ms (bound {bounds[bname][0]:.4f} ms "
              f"by {bounds[bname][1]})", flush=True)
    sorted_total = prep_ms + k5_ms + ms["K8 sorted"] + ms["K9 sorted dense run sums"]
    point_total = prep_ms + ms["K8 point"] + ms["K9 point dense per corner"]
    print(f"[phase 13] K9 plain backward {k9_plain_ms:.3f} ms; gradient zero-fill "
          f"{grad_zero_ms:.4f} ms; sorted walk (keys + K5 + K8 + K9 dense, run sums) "
          f"{sorted_total:.4f} ms vs point order (keys + K8 + K9 dense, per corner) "
          f"{point_total:.4f} ms; launches per train step K5 {launches['K5'] / steps:.4f}, "
          f"K8 {launches['K8'] / steps:.4f}, K9 {launches['K9'] / steps:.4f}", flush=True)

    src = "flnerf_tpu_torch/ops/csrc/hash_sorted.cu"
    return [
        {"name": "sorted_encode_forward (K8)", "route": "cuda", "source": src,
         "replaces": "flnerf_tpu/ops/hash_sorted.py:261", "launches": launches["K8"],
         "max_abs_err": k8_err, "ms": ms["K8 sorted"], "plain_ms": k8_plain_ms,
         "bound_ms": bounds["K8"][0], "bound_by": bounds["K8"][1], "library_ms": None},
        {"name": "sorted_encode_backward (K9)", "route": "cuda", "source": src,
         "replaces": "flnerf_tpu/ops/hash_sorted.py:340", "launches": launches["K9"],
         "max_abs_err": k9_err, "ms": ms["K9 sorted dense run sums"], "plain_ms": k9_plain_ms,
         "bound_ms": bounds["K9"][0], "bound_by": bounds["K9"][1], "library_ms": None},
    ]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from flnerf_tpu_torch.cli import opt
    from flnerf_tpu_torch.models.voxel_sh import VoxelGrid, VoxelGridConfig, voxel_render_rays
    from flnerf_tpu_torch.ops import _build, voxel_kernel as vk
    from flnerf_tpu_torch.rays.camera import get_rays
    from flnerf_tpu_torch.train.plenoxels_trainer import coherence_order

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = smi_line()
    print(f"[phase 1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.time()
    _build.build_all()
    build_s = time.time() - t0
    for name in _build.sources():
        regs = [ln.strip() for ln in _build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[phase 1] {name}.cu ptxas: " + " | ".join(regs))
    print(f"[phase 1] built {_build.sources()} in {build_s:.1f} s", flush=True)

    # ---- phase 2: K1 and K2 against the plain version, main-path shapes ----
    cfg = VoxelGridConfig(reso=(RESO,) * 3, radius=(SCENE_RADIUS,) * 3,
                          max_steps=MAX_STEPS, step_size=STEP)
    grid = sphere_grid(dev)
    images, poses, H, W, focal, K, i_train, i_test = scene()
    epoch = first_epoch(images, poses, H, W, K, i_train)
    # the trainer's first batch on the card: its order rng is seeded with 0
    first = coherence_order(epoch.px, epoch.py, epoch.img, np.random.default_rng(0))[:BATCH]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    o, d, gt = t(epoch.origins[first]), t(epoch.dirs[first]), t(epoch.rgb[first])
    eo, ed = (r.reshape(-1, 3).contiguous() for r in get_rays(H, W, K, poses[i_test[0]][:3, :4], dev))

    def render_and_grad(fn):
        dens = grid.density.clone().requires_grad_(True)
        sh = grid.sh.clone().requires_grad_(True)
        out = fn(VoxelGrid(dens, sh, grid.alive))
        # loss with an upstream gradient on log-T as well as on rgb
        loss = torch.mean((out[:, :3] - gt) ** 2) + 0.1 * torch.sum(out[:, 4])
        gd, gs = torch.autograd.grad(loss, [dens, sh])
        return out.detach(), gd, gs

    def channel_errs(a, b):
        err = (a - b).abs().amax(0).tolist()
        return {"rgb": max(err[0:3]), "depth": err[3], "log_t": err[4], "acc": err[5]}

    def check_fwd(errs, what):
        for k, tol in (("rgb", 1e-4), ("acc", 1e-4), ("log_t", 1e-4), ("depth", 1e-2)):
            check(errs[k] <= tol, f"K1 {k} differs from the plain version by "
                                  f"{errs[k]} > {tol} ({what})")

    out_k, gd_k, gs_k = render_and_grad(lambda gr: vk.render_rays_fused(gr, o, d, cfg))
    out_p, gd_p, gs_p = render_and_grad(lambda gr: vk.render_rays_plain(gr, o, d, cfg))
    torch.cuda.synchronize()
    errs = channel_errs(out_k, out_p)
    g_err = {"grad_density": float((gd_k - gd_p).abs().max()),
             "grad_sh": float((gs_k - gs_p).abs().max())}
    g_scale = {"grad_density": float(gd_p.abs().max()), "grad_sh": float(gs_p.abs().max())}
    print(f"[phase 2] {BATCH}-ray training batch: K1 max_err per channel {errs}; "
          f"K2 max_err {g_err} (scale {g_scale})", flush=True)
    check_fwd(errs, "training batch")
    for k in g_err:
        check(g_scale[k] > 0 and g_err[k] <= 1e-4 * g_scale[k],
              f"K2 {k} differs from the plain version by {g_err[k]} > 1e-4 * {g_scale[k]}")
    check(bool(torch.isfinite(out_k).all()), "K1 output not finite")
    check(float(out_k[:, 5].max()) > 0.1, "the training batch's rays miss the sphere")
    with torch.no_grad():
        eval_errs = channel_errs(vk.render_rays_fused(grid, eo, ed, cfg),
                                 vk.render_rays_plain(grid, eo, ed, cfg))
    print(f"[phase 2] {eo.shape[0]}-ray test view: K1 max_err per channel {eval_errs}",
          flush=True)
    check_fwd(eval_errs, "test view")
    k1_err = max(float((out_k - out_p).abs().max()), max(eval_errs.values()))
    k2_err = max(g_err.values())
    del out_k, out_p, gd_k, gs_k, gd_p, gs_p

    # ---- phase 3: the main path, through the CLI on the card ----
    reso_arg = f"[[{RESO},{RESO},{RESO}]]"
    vk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        res = opt.main(["synthetic", "-t", tmp, "--reso", reso_arg, "--n_epochs", "3"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        fwd_launches, bwd_launches = vk.FWD_LAUNCHES, vk.BWD_LAUNCHES
        ckpts = sorted(f for f in os.listdir(tmp) if f.endswith(".npz"))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res["history"]
    psnrs = [h["train_psnr"] for h in hist]
    steps = hist[-1]["steps"]
    print(f"[phase 3] launches K1 {fwd_launches} K2 {bwd_launches}; steps {steps}; "
          f"train PSNR {psnrs}; test PSNR {res['psnr']:.3f} SSIM {res['ssim']:.4f}; "
          f"rays per epoch {[h['rays'] for h in hist]}, epoch s "
          f"{[round(h['epoch_s'], 4) for h in hist]}; fit with checkpoints "
          f"{res['mins'] * 60:.1f} s, main {wall:.1f} s; peak memory {peak_gb:.2f} GB; "
          f"checkpoints {ckpts}", flush=True)
    check(fwd_launches > 0 and bwd_launches > 0, "the main path launched no kernel")
    check(bwd_launches == steps, f"K2 launches {bwd_launches} != steps {steps}")
    check(all(math.isfinite(p) for p in psnrs), f"train PSNR not finite: {psnrs}")
    check(psnrs[-1] > psnrs[0], f"train PSNR did not rise: {psnrs}")
    check(math.isfinite(res["psnr"]), f"test PSNR not finite: {res['psnr']}")
    check(len(ckpts) == 3, f"expected 3 checkpoints, got {ckpts}")

    # ---- phase 3b: where the main path's device time goes (a profiled
    # rerun of 2 epochs without checkpoints; its launches are not counted) ----
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with tempfile.TemporaryDirectory() as tmp, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        opt.main(["synthetic", "-t", tmp, "--reso", reso_arg, "--n_epochs", "2",
                  "--tune_nosave"])
        torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3
    dev_events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    print(f"[phase 3b] profiled main path: device busy {dev_ms:.1f} ms of "
          f"{prof_wall_ms:.1f} ms wall; top kernels by device time:")
    for e in dev_events[:10] + [e for e in dev_events[10:] if "cuvol" in e.key]:
        print(f"[phase 3b]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")

    # ---- phase 3c: train rays/s over a longer window (epochs 2-10) ----
    with tempfile.TemporaryDirectory() as tmp:
        hist = opt.main(["synthetic", "-t", tmp, "--reso", reso_arg, "--n_epochs", "10",
                         "--tune_nosave"])["history"]
    window = hist[1:]
    rates = [h["rays"] / h["epoch_s"] for h in window]
    win_rays = sum(h["rays"] for h in window)
    win_s = sum(h["epoch_s"] for h in window)
    print(f"[phase 3c] train rays/s over epochs 2-{len(hist)}: {win_rays / win_s:.1f} "
          f"({win_rays} rays, {hist[-1]['steps'] - hist[0]['steps']} steps in {win_s:.4f} s "
          f"of epochs); per epoch min {min(rates):.1f} max {max(rates):.1f}; "
          f"train PSNR {hist[0]['train_psnr']:.2f} -> {hist[-1]['train_psnr']:.2f}", flush=True)

    # ---- phase 4: times on phase 2's training batch ----
    k1_ms, k2_ms = kernel_ms(grid, cfg, o, d, gt)
    zero_ms = cuda_ms(lambda: (torch.zeros_like(grid.density), torch.zeros_like(grid.sh)), 10)
    with torch.no_grad():
        plain_fwd_ms = cuda_ms(lambda: voxel_render_rays(grid, o, d, cfg), 5)
    dens = grid.density.clone().requires_grad_(True)
    sh = grid.sh.clone().requires_grad_(True)
    out_g = vk.render_rays_plain(VoxelGrid(dens, sh, grid.alive), o, d, cfg)
    grad_out = upstream_grad(out_g.detach(), gt)
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(out_g, [dens, sh], grad_out,
                                                       retain_graph=True), 5)
    del out_g, dens, sh

    n_samples, n_cells, n_alive = work_counts(grid, cfg, o, d)
    ray_bytes = BATCH * (3 + 3 + 1 + 1 + 1 + 9) * 4
    # unique bytes: each touched alive cell's density + 27 SH (f32) read,
    # each touched cell's alive byte, the per-ray inputs, the [N,8] output;
    # K2 also reads K1's output and the upstream gradient and writes each
    # touched alive cell's 28 gradients once (the zero-fill of the rest of
    # the dense gradients is timed apart)
    k1_bytes = n_alive * 4 * 28 + n_cells + ray_bytes + BATCH * 32
    k2_bytes = k1_bytes + BATCH * 32 + n_alive * 4 * 28
    bounds = {}
    for name, nbytes, flops in (("K1", k1_bytes, n_samples * FWD_FLOPS_PER_SAMPLE),
                                ("K2", k2_bytes, n_samples * BWD_FLOPS_PER_SAMPLE)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        bounds[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    zero_bound = grid.density.numel() * 4 * 28 / HBM_BYTES_PER_S * 1e3
    print(f"[phase 4] training batch: {n_samples} marched samples, {n_cells} distinct corner "
          f"cells ({n_alive} alive); K1 {k1_ms:.4f} ms (plain {plain_fwd_ms:.3f} ms, bound "
          f"{bounds['K1'][0]:.4f} ms); K2 body {k2_ms:.4f} ms (plain backward "
          f"{plain_bwd_ms:.3f} ms, bound {bounds['K2'][0]:.4f} ms); K2's zero-fill of the "
          f"dense gradients {zero_ms:.4f} ms (bound {zero_bound:.4f} ms); K1 launches per "
          f"train step {fwd_launches / steps:.3f} ({fwd_launches - bwd_launches} of "
          f"{fwd_launches} are the test renders)", flush=True)

    # ray order: the budgeter's shuffle against the trainer's coherence
    # order (train batches), raster against morton order (eval chunks)
    batches = {"train 48x48 shuffled": (t(epoch.origins[:BATCH]), t(epoch.dirs[:BATCH])),
               "train 48x48 coherent": (o, d)}
    for k, v in wide_batches(poses, i_train, 800, dev).items():
        batches[f"train 800x800 {k}"] = v
    for size in (48, 800):
        for k, v in eval_chunks(poses[i_test[0]], size, 4096, dev).items():
            batches[f"eval {size}x{size} {k}"] = v
    for name, (bo, bd) in batches.items():
        ms1, ms2 = kernel_ms(grid, cfg, bo, bd, torch.full_like(bo, 0.5))
        ns, nc, _ = work_counts(grid, cfg, bo, bd)
        print(f"[phase 4] order {name}: K1 {ms1:.4f} ms, K2 body {ms2:.4f} ms "
              f"({ns} samples, {nc} distinct cells)", flush=True)


    # ---- phase 5: K3 and K4 against the plain version, NGP main-path shapes ----
    from flnerf_tpu_torch.ops import hash_kernel as hk
    ngp_tmp = tempfile.TemporaryDirectory()
    trainer, sampler, n_test, n_hwf = ngp_setup(ngp_tmp.name)
    trainer.fit(sampler, verbose=False, n_steps=NGP_WINDOW)    # steps 1-256
    # the next batch the trainer draws, through the trainer's own loss: the
    # encoding's input (the kept samples) and its real upstream gradient are
    # read at the hash_encode call
    x_batch, g_train = next_batch_encode(trainer, sampler, t, "hash_encode")
    g_train = g_train.contiguous()
    spec = trainer.field.spec
    table = trainer.field.table.detach().clone()
    gen = torch.Generator(device=dev).manual_seed(1)
    x_refresh = refresh_chunk(trainer, gen)
    # a dense N(0, 1) upstream gradient: every point adds its atomics
    g_dense = torch.randn((x_batch.shape[0], spec.output_dim), generator=gen, device=dev)
    k3_err, k3_rel = 0.0, 0.0
    for name, xx in (("train batch", x_batch), ("refresh chunk", x_refresh)):
        with torch.no_grad():
            out_k = hk.hash_encode_forward(xx, table, spec)
            out_p = hk.hash_encode_plain(xx, table, spec)
        torch.cuda.synchronize()
        err, scale = float((out_k - out_p).abs().max()), float(out_p.abs().max())
        print(f"[phase 5] K3 on the {name} {tuple(xx.shape)}: max_err {err:.3e} "
              f"(largest output {scale:.4f})", flush=True)
        check(bool(torch.isfinite(out_k).all()), f"K3 output not finite ({name})")
        check(err <= 1e-5 * scale, f"K3 differs from the plain version by {err} > "
                                   f"1e-5 * {scale} ({name})")
        k3_err, k3_rel = max(k3_err, err), max(k3_rel, err / scale)
    del out_k, out_p
    k4_err = 0.0
    for name, g_up in (("train gradient", g_train), ("dense gradient", g_dense)):
        grad_k = hk.hash_encode_backward(x_batch, g_up, spec)
        tp = table.clone().requires_grad_(True)
        (grad_p,) = torch.autograd.grad(hk.hash_encode_plain(x_batch, tp, spec), [tp], g_up)
        torch.cuda.synchronize()
        err, scale = float((grad_k - grad_p).abs().max()), float(grad_p.abs().max())
        live = float((g_up != 0).any(-1).float().mean())
        print(f"[phase 5] K4 on the train batch, {name} (nonzero at {live:.4f} of the "
              f"points): max_err {err:.3e} (largest entry {scale:.4e})", flush=True)
        # on the plateau the train gradient may be zero at every point (dead
        # sigma-net ReLUs); then K4 must give exactly zero too
        check((scale > 0 or name == "train gradient") and err <= 1e-4 * scale,
              f"K4 differs from the plain version by {err} > 1e-4 * {scale} ({name})")
        k4_err = max(k4_err, err)
    print(f"[phase 5] table after {NGP_WINDOW} steps: max |entry| "
          f"{float(table.abs().max()):.4f}, mean |entry| {float(table.abs().mean()):.3e}",
          flush=True)
    del grad_k, grad_p, tp

    # ---- phase 6: the NGP main path, through the CLI on the card ----
    from flnerf_tpu_torch.cli import main_nerf
    hk.reset_launch_counts()
    vk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        res = main_nerf.main(["synthetic", "-O", "--iters", str(NGP_ITERS),
                              "--workspace", tmp])
        torch.cuda.synchronize()
        ngp_wall = time.time() - t0
        h_fwd, h_bwd = hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES
        with open(os.path.join(tmp, "results.txt")) as f:
            results = f.read().split()
    ngp_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps_ngp, ngp_psnr = res["steps"], res["psnr"]
    losses = [h["chunk_loss"] for h in res["history"]]
    want_fwd, n_refresh, n_eval = expected_hash_launches(trainer, len(n_test), n_hwf)
    print(f"[phase 6] launches K3 {h_fwd} K4 {h_bwd} (K1 {vk.FWD_LAUNCHES}, K2 "
          f"{vk.BWD_LAUNCHES}); steps {steps_ngp}, refresh chunks {n_refresh}, eval chunks "
          f"{n_eval}; mean train loss per chunk first {losses[0]:.5f} last {losses[-1]:.5f} "
          f"(min {min(losses):.5f} max {max(losses[1:]):.5f} after the first); "
          f"test PSNR {res['psnr']:.3f} SSIM {res['ssim']:.4f}; "
          f"main {ngp_wall:.1f} s; peak memory {ngp_peak_gb:.2f} GB; results.txt "
          f"{results}", flush=True)
    check(h_bwd == steps_ngp == NGP_ITERS, f"K4 launches {h_bwd} != steps {steps_ngp}")
    check(h_fwd == want_fwd, f"K3 launches {h_fwd} != steps + refresh + eval chunks "
                             f"{want_fwd}")
    check(vk.FWD_LAUNCHES == vk.BWD_LAUNCHES == 0, "the NGP path launched a cuvol kernel")
    check(all(math.isfinite(v) for v in losses), f"train loss not finite: {losses}")
    # the first chunk's mean holds the fall from the initial field; after
    # it, this configuration sits on the reference's plateau (fault R1)
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(math.isfinite(res["psnr"]), f"test PSNR not finite: {res['psnr']}")

    # train rays/s over steps 257-512: phase 5's trainer, a second fit
    torch.cuda.synchronize()
    t0 = time.time()
    trainer.fit(sampler, verbose=False, n_steps=NGP_WINDOW)
    torch.cuda.synchronize()
    win_s = time.time() - t0
    print(f"[phase 6] train rays/s over steps {NGP_WINDOW + 1}-{2 * NGP_WINDOW}: "
          f"{NGP_WINDOW * trainer.cfg.batch_rays / win_s:.1f} ({NGP_WINDOW} steps, "
          f"{NGP_WINDOW // trainer.cfg.steps_per_chunk} partial refreshes, {win_s:.3f} s); "
          f"loss {trainer.history[-1]['loss']:.5f}", flush=True)

    # ---- phase 6b: where the NGP step's device time goes ----
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.fit(sampler, verbose=False, n_steps=NGP_PROFILE_STEPS)
        torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3
    dev_events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    print(f"[phase 6b] profiled NGP fit of {NGP_PROFILE_STEPS} steps: device busy "
          f"{dev_ms:.1f} ms of {prof_wall_ms:.1f} ms wall ({100 * dev_ms / prof_wall_ms:.1f}%); "
          f"top kernels by device time:")
    for e in dev_events[:12] + [e for e in dev_events[12:] if "hash_" in e.key]:
        print(f"[phase 6b]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    ngp_tmp.cleanup()

    # ---- phase 7: K3 and K4 times on phase 5's batch ----
    n_pts = x_batch.shape[0]
    k3_ms = cuda_ms(lambda: hk.hash_encode_forward(x_batch, table, spec), 20)
    grad_buf = torch.zeros((spec.num_levels, spec.t_cap, 2), device=dev)
    k4_ms = cuda_ms(lambda: hk.hash_encode_backward(x_batch, g_train, spec,
                                                    grad_table=grad_buf), 20)
    k4_dense_ms = cuda_ms(lambda: hk.hash_encode_backward(x_batch, g_dense, spec,
                                                          grad_table=grad_buf), 20)
    k4_zero_ms = cuda_ms(lambda: torch.zeros((spec.num_levels, spec.t_cap, 2), device=dev), 20)
    with torch.no_grad():
        k3_plain_ms = cuda_ms(lambda: hk.hash_encode_plain(x_batch, table, spec), 5)
    tp = table.clone().requires_grad_(True)
    out_g = hk.hash_encode_plain(x_batch, tp, spec)
    k4_plain_ms = cuda_ms(lambda: torch.autograd.grad(out_g, [tp], g_train,
                                                      retain_graph=True), 5)
    k4_dense_plain_ms = cuda_ms(lambda: torch.autograd.grad(out_g, [tp], g_dense,
                                                            retain_graph=True), 5)
    del out_g, tp
    # what this batch's data needs: distinct table entries its corners touch
    # (K3), and those of the points with a nonzero upstream gradient (K4)
    idx, _ = hk.corner_indices_weights(x_batch, spec)
    lvl = torch.arange(spec.num_levels, device=dev)[:, None] * spec.t_cap
    touched = int((idx + lvl).unique().numel())
    live = (g_train != 0).any(-1)
    live_pts = int(live.sum())
    touched_live = int((idx.reshape(spec.num_levels, n_pts, 8)[:, live].reshape(
        spec.num_levels, -1) + lvl).unique().numel())
    del idx
    L2 = spec.num_levels
    # K4 on the dense gradient: every point adds its atomics, every touched
    # entry is read and written (the body adds into the gradient); on the
    # train gradient only the entries of the points it reaches
    k3_bytes = n_pts * 12 + n_pts * L2 * 8 + touched * 8
    k4_bytes = n_pts * 12 + n_pts * L2 * 8 + touched * 16
    k4_train_bytes = n_pts * 12 + n_pts * L2 * 8 + touched_live * 16
    for name, nbytes, flops in (("K3", k3_bytes, n_pts * L2 * K3_FLOPS),
                                ("K4", k4_bytes, n_pts * L2 * K4_FLOPS),
                                ("K4 train", k4_train_bytes, live_pts * L2 * K4_FLOPS)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        bounds[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    zero_bound = spec.num_levels * spec.t_cap * 8 / HBM_BYTES_PER_S * 1e3
    print(f"[phase 7] train batch: {n_pts} points x {L2} levels, {touched} distinct table "
          f"entries touched ({touched_live} by the {live_pts} points with a gradient); L2 "
          f"gather volume {n_pts * L2 * 8 * 8 / 1e6:.1f} MB (8 corners x 8 B per point and "
          f"level); K3 {k3_ms:.4f} ms (plain {k3_plain_ms:.3f} ms, bound "
          f"{bounds['K3'][0]:.4f} ms by {bounds['K3'][1]}); K4 body on the dense gradient "
          f"{k4_dense_ms:.4f} ms (plain backward {k4_dense_plain_ms:.3f} ms, bound "
          f"{bounds['K4'][0]:.4f} ms by {bounds['K4'][1]}), on the train gradient "
          f"{k4_ms:.4f} ms (plain backward {k4_plain_ms:.3f} ms, bound "
          f"{bounds['K4 train'][0]:.4f} ms by {bounds['K4 train'][1]}); K4's zero-fill "
          f"{k4_zero_ms:.4f} ms (bound {zero_bound:.4f} ms); launches per train step K3 "
          f"{h_fwd / steps_ngp:.4f}, K4 {h_bwd / steps_ngp:.4f}", flush=True)

    src = "flnerf_tpu_torch/ops/csrc/voxel_cuvol.cu"
    hsrc = "flnerf_tpu_torch/ops/csrc/hash_encode.cu"
    kernels = [
        {"name": "cuvol_forward (K1)", "route": "cuda", "source": src,
         "replaces": "flnerf_tpu/ops/voxel_pallas.py:430", "launches": fwd_launches,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": plain_fwd_ms,
         "bound_ms": bounds["K1"][0], "bound_by": bounds["K1"][1], "library_ms": None},
        {"name": "cuvol_backward (K2)", "route": "cuda", "source": src,
         "replaces": "flnerf_tpu/ops/voxel_pallas.py:511", "launches": bwd_launches,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": plain_bwd_ms,
         "bound_ms": bounds["K2"][0], "bound_by": bounds["K2"][1], "library_ms": None},
        {"name": "hash_encode_forward (K3)", "route": "cuda", "source": hsrc,
         "replaces": "flnerf_tpu/ops/hash_pallas.py:142", "launches": h_fwd,
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": bounds["K3"][0], "bound_by": bounds["K3"][1], "library_ms": None},
        {"name": "hash_encode_backward (K4)", "route": "cuda", "source": hsrc,
         "replaces": "flnerf_tpu/ops/hash_pallas.py:185", "launches": h_bwd,
         "max_abs_err": k4_err, "ms": k4_dense_ms, "plain_ms": k4_dense_plain_ms,
         "bound_ms": bounds["K4"][0], "bound_by": bounds["K4"][1], "library_ms": None},
    ]
    del trainer, sampler, x_batch, x_refresh, g_train, g_dense, table, grad_buf
    lattice_psnr, rows = lattice_phases(dev, t)
    kernels += rows
    kernels += sorted_phases(dev, t, {"2^15, xor hash (phase 6)": ngp_psnr,
                                      "2^19, lattice hash (phase 9)": lattice_psnr})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K1's design choices, timed on the card against each other and against
the kernel it replaced.

    python -m flnerf_tpu_torch.tools.voxel_probe [--reso 256] [--rays 5000]
        on a filled sphere (chip_smoke.py's phase-2 grid) and random rays;
    chip_smoke.py phase 4 calls ``probe`` and ``sample_counts`` on the main
    path's first training batch, on the sphere grid and on the grid the
    main path trained.

The variants (``VARIANTS``) are instantiations of K1 (``cuvol_fwd_kernel``
of ``ops/csrc/voxel_cuvol.cu``, a template over the steps of a pass,
density first and the spread of rays over the SMs) launched with or without
the occupancy, and the kernel K1
replaced (every step marched, all 28 channels gathered before the sigma
gate, one step a pass), kept here as a source string beside the committed
source, whose ``gather_sample`` K2 still uses.  Every variant's output must
equal the replaced kernel's bit for bit: the skip and the gate drop only
samples that add exactly nothing.  Built by nvcc into ``build/probe/``;
needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

from flnerf_tpu_torch.ops import _build
from flnerf_tpu_torch.ops import voxel_kernel as vk

# The kernel K1 replaced (csrc/voxel_cuvol.cu before its skip and its
# density-first passes).
REPLACED_K1 = r"""
__global__ void __launch_bounds__(32 * kWarps)
replaced_fwd_kernel(GridView g, RayView r, Params p, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (ray >= p.n_rays) return;  // whole warp leaves together
  const RayIn in = load_ray(r, ray, lane);

  float log_t = 0.f, depth = 0.f, acc[3] = {0.f, 0.f, 0.f};
  Sample s;
  for (int j = 0; j < p.max_steps; ++j) {
    const float t = __fadd_rn(in.tmin, __fmul_rn(p.step, (float)j));
    if (t > in.tmax) break;
    gather_sample(g, in.o, in.d, t, in.shm, lane, s);
    const float sigma = s.sigma_raw > 0.f ? s.sigma_raw : 0.f;
    if (!(sigma >= p.sigma_thresh)) continue;  // contributes exactly nothing
    const float la = -p.step * sigma * in.dscale;
    const float w = expf(log_t) * (1.f - expf(la));
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] += w * fmaxf(s.rgb_raw[k], 0.f);
    depth += w * t;
    log_t += la;
  }
  if (lane == 0) {
    const float t_fin = expf(log_t);
    float* o = out + (int64_t)ray * 8;
#pragma unroll
    for (int k = 0; k < 3; ++k) o[k] = acc[k] + t_fin * p.background;
    o[3] = depth;
    o[4] = log_t;
    o[5] = 1.f - t_fin;
    o[6] = 0.f;
    o[7] = 0.f;
  }
}
"""

_LAUNCHER = """
extern "C" int probe_forward(int variant, const float* density, const float* sh,
                             const uint8_t* alive, int X, int Y, int Z, const float* origins,
                             const float* dirs, const float* tmin, const float* tmax,
                             const float* dscale, const float* shmult, int n_rays, int max_steps,
                             float step, float sigma_thresh, float background,
                             const uint8_t* occ, float* out, void* stream) {
  const GridView g = make_grid(density, sh, alive, X, Y, Z);
  const Occupancy oc = make_occupancy(occ, Y, Z);
  const RayView r = make_rays(origins, dirs, tmin, tmax, dscale, shmult);
  const Params p = make_params(n_rays, max_steps, step, sigma_thresh, background);
  const dim3 block(32 * kWarps), grid((n_rays + kWarps - 1) / kWarps);
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case -1: replaced_fwd_kernel<<<grid, block, 0, st>>>(g, r, p, out); break;
%s
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""

# name -> (launcher case, with the occupancy); a case is the template's
# (steps a pass, density first, spread) encoded as steps * 4 + 2 * density
# first + spread
VARIANTS = {
    "K1 (skip, density first, 2 steps a pass)": (2 * 4 + 2, True),
    "skip off": (2 * 4 + 2, False),
    "density first off (SH gathered for every marched step)": (2 * 4 + 0, True),
    "1 step a pass": (1 * 4 + 2, True),
    "4 steps a pass": (4 * 4 + 2, True),
    "rays spread over the SMs (warp w of block b takes ray w * blocks + b)": (2 * 4 + 3, True),
    "the replaced K1 (no skip, all 28 channels before the gate, a step a pass)": (-1, False),
}
K1 = "K1 (skip, density first, 2 steps a pass)"
REPLACED = "the replaced K1 (no skip, all 28 channels before the gate, a step a pass)"

_LIB: list = []


def source() -> str:
    """The probe's CUDA source: voxel_cuvol.cu with the replaced K1 and a
    launcher for each variant appended (the launcher at file scope sees the
    source's anonymous namespace)."""
    with open(os.path.join(_build.CSRC, "voxel_cuvol.cu")) as f:
        src = f.read()
    end = src.index("}  // namespace\n")
    cases = "\n".join(
        f"    case {v}: cuvol_fwd_kernel<{v // 4}, {str(bool(v & 2)).lower()}, "
        f"{str(bool(v & 1)).lower()}><<<grid, block, 0, st>>>(g, oc, r, p, out); break;"
        for v in sorted({code for code, _ in VARIANTS.values() if code >= 0}))
    return src[:end] + REPLACED_K1 + src[end:] + _LAUNCHER % cases


def build() -> ctypes.CDLL:
    """nvcc the probe into build/probe/ and load it (once a process)."""
    if _LIB:
        return _LIB[0]
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "probe")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "voxel_probe.cu")
    with open(cu, "w") as f:
        f.write(source())
    so = cu[:-3] + ".so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"the K1 probe did not build:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(so)
    lib.probe_forward.restype = ctypes.c_int
    lib.probe_forward.argtypes = [ctypes.c_int] + vk._COMMON + [ctypes.c_void_p] * 3
    _LIB.append(lib)
    return lib


def launch(variant: str, grid, ray_in, cfg, occ, out) -> None:
    """One launch of a variant into ``out`` [N, 8]; ``occ`` is used by the
    variants that skip."""
    code, skip = VARIANTS[variant]
    args = vk._common_args(*grid, *ray_in, cfg)
    rc = build().probe_forward(code, *args, occ.data_ptr() if skip else None, out.data_ptr(),
                               torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 probe variant {variant!r} failed: cudaError {rc}")


def probe(grid, cfg, o, d) -> dict:
    """Name -> (ms by CUDA events, device ms a call) of each variant on
    these rays, K1 with its occupancy given, "K1 through the wrapper" (the
    occupancy built before each launch, as the main path calls it) and
    "occupancy build".  Every variant's output is checked bitwise equal to
    the replaced kernel's first; raises if one differs."""
    from flnerf_tpu_torch.tools.hash_probe import _time
    if not vk.skips(cfg):
        raise ValueError("the probe's skipping variants need sigma_thresh > 0")
    ray_in = vk.ray_inputs(cfg, o, d)
    occ = vk.skip_occupancy(grid.density, grid.alive, cfg)
    n = o.shape[0]
    want = torch.empty((n, 8), device=o.device)
    launch(REPLACED, grid, ray_in, cfg, occ, want)
    out = torch.empty_like(want)
    for name in VARIANTS:
        out.fill_(float("nan"))
        launch(name, grid, ray_in, cfg, occ, out)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            bad = int((out != want).any(-1).sum())
            raise RuntimeError(f"K1 probe variant {name!r} differs from the replaced kernel "
                               f"on {bad} of {n} rays")
    ms = {name: _time(lambda name=name: launch(name, grid, ray_in, cfg, occ, out))
          for name in VARIANTS}
    ms["K1 through the wrapper (occupancy built before the launch)"] = _time(
        lambda: vk.cuvol_forward(*grid, *ray_in, cfg))
    ms["occupancy build"] = _time(lambda: vk.skip_occupancy(grid.density, grid.alive, cfg))
    return ms


def sample_counts(grid, cfg, o, d, chunk: int = 256) -> dict:
    """What K1's skip and gate leave of this batch, counted in plain torch:
    the marched samples (t <= tmax), those in unmarked blocks (skipped), in
    marked blocks with a relu'd sigma under sigma_thresh (gated) and kept;
    the steps of the longest ray, and its steps in marked blocks; the
    share of marked blocks; the distinct corner cells of the samples in
    marked blocks (K1 reads their alive byte and density) and of those the
    alive cells with density > 0 (whose SH a kept sample may read)."""
    from flnerf_tpu_torch.models.voxel_sh import grid_ray_setup
    origins, dirs, tmin, tmax, _, _ = grid_ray_setup(cfg, o, d)
    occ = vk.occupancy_blocks(grid.density, grid.alive)
    dens = torch.where(grid.alive, grid.density, 0.0).reshape(-1)
    steps = torch.arange(cfg.max_steps, device=o.device)
    _, y, z = cfg.reso
    c = dict(samples=0, skipped=0, gated=0, kept=0, longest_steps=0, longest_marked_steps=0)
    cells = []
    for i in range(0, o.shape[0], chunk):
        sl = slice(i, i + chunk)
        ts = vk._step_t(tmin[sl, None], steps[None, :], cfg)
        valid = ts <= tmax[sl, None]
        pos = origins[sl, None, :] + ts[..., None] * dirs[sl, None, :]
        hi = torch.tensor([r - 1.0 for r in cfg.reso], device=o.device)
        pos = torch.minimum(torch.clamp(pos, min=0.0), hi)
        fl = torch.minimum(torch.clamp(torch.floor(pos), min=0.0), hi - 1.0)
        frac, lo = pos - fl, fl.long()
        marked = valid & vk._marked(occ, lo)
        sigma = torch.zeros(ts.shape, device=o.device)
        for j in range(8):
            b = [(j >> 2) & 1, (j >> 1) & 1, j & 1]
            w = 1.0
            for a in range(3):
                w = w * (frac[..., a] if b[a] else 1 - frac[..., a])
            cell = ((lo[..., 0] + b[0]) * y + lo[..., 1] + b[1]) * z + lo[..., 2] + b[2]
            sigma = sigma + w * dens[cell]
            cells.append(cell[marked].unique())
        kept = marked & (torch.relu(sigma) >= cfg.sigma_thresh)
        c["samples"] += int(valid.sum())
        c["skipped"] += int((valid & ~marked).sum())
        c["gated"] += int((marked & ~kept).sum())
        c["kept"] += int(kept.sum())
        c["longest_steps"] = max(c["longest_steps"], int(valid.sum(1).max()))
        c["longest_marked_steps"] = max(c["longest_marked_steps"], int(marked.sum(1).max()))
    touched = torch.cat(cells).unique()
    c["touched_cells"] = int(touched.numel())
    c["sh_cells"] = int((grid.alive.reshape(-1)[touched] & (grid.density.reshape(-1)[touched]
                                                            > 0)).sum())
    c["marked_blocks"] = float(occ.float().mean())
    return c


def finding(ms: dict) -> str:
    """One line, by device time: K1 against the replaced kernel and what
    each design choice buys."""
    dev = {k: v[1] for k, v in ms.items()}
    k1 = dev[K1]
    parts = [f"K1 {k1:.4f} ms against the replaced {dev[REPLACED]:.4f} "
             f"({dev[REPLACED] / k1:.2f}x)"]
    for name in VARIANTS:
        if name in (K1, REPLACED):
            continue
        parts.append(f"{name} {dev[name] - k1:+.4f}")
    parts.append(f"the occupancy build {dev['occupancy build']:.4f}")
    return "K1 (device time): " + "; ".join(parts)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reso", type=int, default=256)
    ap.add_argument("--rays", type=int, default=5000)
    args = ap.parse_args()
    from flnerf_tpu_torch.models.voxel_sh import VoxelGrid, VoxelGridConfig
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = args.reso
    idx = (torch.arange(r, device=dev, dtype=torch.float32) - (r - 1) / 2) / (r / 2)
    x, y, z = torch.meshgrid(idx, idx, idx, indexing="ij")
    inside = torch.sqrt(x * x + y * y + z * z) < 0.55
    grid = VoxelGrid(torch.where(inside, 2.0 * torch.rand((r,) * 3, generator=g, device=dev), 0.0),
                     torch.where(inside[..., None], 0.3 * torch.randn((r,) * 3 + (27,), generator=g,
                                                                      device=dev), 0.0),
                     torch.rand((r,) * 3, generator=g, device=dev) > 0.1)
    cfg = VoxelGridConfig(reso=(r,) * 3, max_steps=int(3.5 * r / 0.5), step_size=0.5)
    u = torch.nn.functional.normalize(torch.randn((args.rays, 3), generator=g, device=dev), dim=-1)
    d = torch.nn.functional.normalize(-u + 0.3 * torch.randn((args.rays, 3), generator=g,
                                                             device=dev), dim=-1)
    o = 2.5 * u
    print(sample_counts(grid, cfg, o, d))
    ms = probe(grid, cfg, o, d)
    for name, (ev, dt) in ms.items():
        print(f"{ev:9.4f} ms by events, {dt:9.4f} ms of device time  {name}")
    print(finding(ms))


if __name__ == "__main__":
    main()

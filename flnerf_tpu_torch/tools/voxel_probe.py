"""K1's and K2's design choices, timed on the card against each other and
against the kernels they replaced.

    python -m flnerf_tpu_torch.tools.voxel_probe [--reso 256] [--rays 5000]
        on a filled sphere (chip_smoke.py's phase-2 grid) and random rays;
    chip_smoke.py phase 4 calls ``probe``, ``probe_backward`` and
    ``sample_counts`` on the main path's first training batch, on the
    sphere grid and on the grid the main path trained.

The variants are instantiations of ``ops/csrc/voxel_cuvol.cu``'s kernels,
templates over the steps of a pass, density first, K1's spread of rays over
the SMs and K2's merge of a ray's repeated corners (off in K2 as launched),
launched with or without the occupancy.  Beside them stand, as source strings here: the
kernels K1 and K2 replaced (every step marched, all 28 channels gathered
before the sigma gate by ``gather_sample``, one step a pass, 8 atomics a
kept sample), K1's own body before it came to share its march with K2, and
K2 without its atomics (a measurement only: it writes no gradient).  Every
K1 variant's output must equal the replaced kernel's bit for bit (the skip
and the gate drop only samples that add exactly nothing); every K2
variant's gradient must be within 1e-5 of the largest entry of the
replaced kernel's (atomics from many rays add in any order).  Built by nvcc
into ``build/probe/``; needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import os
import subprocess

import torch

from flnerf_tpu_torch.ops import _build
from flnerf_tpu_torch.ops import voxel_kernel as vk

# What the replaced kernels gather at each step: all 28 channels at the live
# corners, the alive bits read first (csrc/voxel_cuvol.cu before the
# density-first passes).
GATHER_SAMPLE = r"""
// What one step of the march gives each lane.
struct Sample {
  int64_t cell[8];   // corner cell index, corner j = (dx, dy, dz) bits 2,1,0
  float w[8];        // trilinear corner weight
  unsigned live;     // bit j set: corner j alive
  float sigma_raw;   // channel 0, broadcast
  float rgb_raw[3];  // SH dot products + 0.5, broadcast
};

__device__ __forceinline__ void gather_sample(const GridView& g, const float o[3],
                                              const float d[3], float t,
                                              float shm_lane, int lane,
                                              Sample& s) {
  int lx, ly, lz;
  float fx, fy, fz;
  axis_lerp(o[0], d[0], t, g.X, lx, fx);
  axis_lerp(o[1], d[1], t, g.Y, ly, fy);
  axis_lerp(o[2], d[2], t, g.Z, lz, fz);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int dx = j >> 2, dy = (j >> 1) & 1, dz = j & 1;
    s.cell[j] = ((int64_t)(lx + dx) * g.Y + (ly + dy)) * g.Z + (lz + dz);
    s.w[j] = __fmul_rn(__fmul_rn(dx ? fx : 1.f - fx, dy ? fy : 1.f - fy),
                       dz ? fz : 1.f - fz);
  }
  // lanes 0-7 read one corner's alive bit each (no dynamic register index)
  const int mj = lane & 7;
  const int64_t my_cell =
      ((int64_t)(lx + (mj >> 2)) * g.Y + (ly + ((mj >> 1) & 1))) * g.Z +
      (lz + (mj & 1));
  const bool mine = lane < 8 && g.alive[my_cell] != 0;
  s.live = __ballot_sync(kFull, mine) & 0xffu;

  float v = 0.f;
  if (lane < kCh) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (s.live & (1u << j)) {
        const float c = lane == 0 ? g.density[s.cell[j]]
                                  : g.sh[s.cell[j] * (kCh - 1) + (lane - 1)];
        v = __fadd_rn(v, __fmul_rn(s.w[j], c));
      }
    }
  }
  s.sigma_raw = __shfl_sync(kFull, v, 0);

  // segmented sum of shm * c over lanes 1-9 (r), 10-18 (g), 19-27 (b)
  const int seg = (lane >= 1 && lane < kCh) ? (lane - 1) / kBasis : -1 - lane;
  float p = seg >= 0 ? shm_lane * v : 0.f;
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    const float other = __shfl_down_sync(kFull, p, off);
    const int ol = lane + off;
    const int oseg = (ol >= 1 && ol < kCh) ? (ol - 1) / kBasis : -1 - ol;
    if (ol < 32 && oseg == seg) p += other;
  }
  s.rgb_raw[0] = __shfl_sync(kFull, p, 1) + 0.5f;
  s.rgb_raw[1] = __shfl_sync(kFull, p, 1 + kBasis) + 0.5f;
  s.rgb_raw[2] = __shfl_sync(kFull, p, 1 + 2 * kBasis) + 0.5f;
}
"""

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

# The kernel K2 replaced (csrc/voxel_cuvol.cu before it took K1's skip and
# its density-first passes).
REPLACED_K2 = r"""
__global__ void __launch_bounds__(32 * kWarps)
replaced_bwd_kernel(GridView g, RayView r, Params p, const float* __restrict__ out,
                 const float* __restrict__ grad_out,
                 float* __restrict__ grad_density, float* __restrict__ grad_sh) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (ray >= p.n_rays) return;
  const RayIn in = load_ray(r, ray, lane);

  const float* o = out + (int64_t)ray * 8;
  const float* go = grad_out + (int64_t)ray * 8;
  const float gk[3] = {go[0], go[1], go[2]};
  const float t_fin = expf(o[4]);
  // S_total = sum_c g_c (rgb_c - T_fin bg); the T_fin term adds the
  // background's coupling and the upstream gradient on log-T (channel 4)
  float s_tot = 0.f, gbg = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s_tot += gk[k] * (o[k] - t_fin * p.background);
    gbg += gk[k] * p.background;
  }
  const float tfin_gbg = t_fin * gbg + go[4];
  // lane c's color (lanes 1-27) and its upstream gradient
  const int kc = (lane >= 1 && lane < kCh) ? (lane - 1) / kBasis : 0;
  const float g_lane = kc == 0 ? gk[0] : (kc == 1 ? gk[1] : gk[2]);

  float log_t = 0.f, prefix = 0.f;
  Sample s;
  for (int j = 0; j < p.max_steps; ++j) {
    const float t = __fadd_rn(in.tmin, __fmul_rn(p.step, (float)j));
    if (t > in.tmax) break;
    gather_sample(g, in.o, in.d, t, in.shm, lane, s);
    const float sigma = s.sigma_raw > 0.f ? s.sigma_raw : 0.f;
    if (!(sigma >= p.sigma_thresh)) continue;  // gated: zero gradient
    const float la = -p.step * sigma * in.dscale;
    const float w = expf(log_t) * (1.f - expf(la));
    const float t_next = expf(log_t + la);
    float rgb[3], gc = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rgb[k] = fmaxf(s.rgb_raw[k], 0.f);
      gc += gk[k] * rgb[k];
    }
    prefix += gc * w;                       // P_i, inclusive
    const float dla = (s_tot - prefix) - t_next * gc + tfin_gbg;
    log_t += la;

    const float raw_lane =
        kc == 0 ? s.rgb_raw[0] : (kc == 1 ? s.rgb_raw[1] : s.rgb_raw[2]);
    float dval = 0.f;
    if (lane == 0) {
      // the thresh gate passed; the relu gate matters when sigma_thresh <= 0
      if (s.sigma_raw > 0.f) dval = dla * (-p.step) * in.dscale;
    } else if (lane < kCh && raw_lane > 0.f) {
      dval = g_lane * w * in.shm;
    }
    if (dval != 0.f) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (s.live & (1u << c)) {
          const float add = s.w[c] * dval;
          if (lane == 0) {
            atomicAdd(grad_density + s.cell[c], add);
          } else {
            atomicAdd(grad_sh + s.cell[c] * (kCh - 1) + (lane - 1), add);
          }
        }
      }
    }
  }
}
"""

# K1's own body before its march came to be shared with K2 (csrc/voxel_cuvol.cu
# cuvol_fwd_kernel before jump_block, density_pass, gather_sh and step_rgb):
# timed beside K1 to show what sharing the march costs.
OWN_K1 = r"""
template <int kSteps, bool kDensityFirst, bool kSpread>
__global__ void __launch_bounds__(32 * kWarps)
own_fwd_kernel(GridView g, Occupancy oc, RayView r, Params p, float* __restrict__ out) {
  static_assert(kSteps >= 1 && kSteps <= 4, "8 lanes a step");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ray = kSpread ? warp * (int)gridDim.x + (int)blockIdx.x
                          : (int)blockIdx.x * kWarps + warp;
  if (ray >= p.n_rays) return;  // whole warp leaves together
  const RayIn in = load_ray(r, ray, lane);
  const int ls = lane >> 3, lc = lane & 7;   // this lane's step of the pass, and corner
  const int dx = lc >> 2, dy = (lc >> 1) & 1, dz = lc & 1;
  const int64_t yz = (int64_t)g.Y * g.Z;

  float log_t = 0.f, depth = 0.f, acc[3] = {0.f, 0.f, 0.f};
  int j0 = 0;
  while (j0 < p.max_steps) {
    const float t0 = step_t(in, p, j0);
    if (t0 > in.tmax) break;
    if (oc.bits) {   // a step in an unmarked block: jump to the first out of it
      int bx, by, bz;
      floor_cell(g, in, t0, bx, by, bz);
      if (!block_marked(oc, bx, by, bz)) {
        j0 = leave_block(g, in, p, j0, bx >> 3, by >> 3, bz >> 3);
        continue;
      }
    }
    // the density pass: lane (s, c) reads corner c's alive byte and density
    // at step j0 + s, both loads in one round trip
    const int js = j0 + ls;
    const float t = step_t(in, p, js);
    int lx, ly, lz;
    float fx, fy, fz;
    axis_lerp(in.o[0], in.d[0], t, g.X, lx, fx);
    axis_lerp(in.o[1], in.d[1], t, g.Y, ly, fy);
    axis_lerp(in.o[2], in.d[2], t, g.Z, lz, fz);
    bool use = ls < kSteps && js < p.max_steps && t <= in.tmax;
    if (use && oc.bits) use = block_marked(oc, lx, ly, lz);
    const int64_t cell0 = ((int64_t)lx * g.Y + ly) * g.Z + lz;   // corner 0
    const int64_t cell = cell0 + dx * yz + dy * (int64_t)g.Z + dz;
    const float w = __fmul_rn(__fmul_rn(dx ? fx : 1.f - fx, dy ? fy : 1.f - fy),
                              dz ? fz : 1.f - fz);
    bool alive = false;
    float dens = 0.f;
    if (use) {
      alive = g.alive[cell] != 0;
      dens = g.density[cell];
    }
    const unsigned live = __ballot_sync(kFull, alive);   // bit 8s + c
    const unsigned used = __ballot_sync(kFull, use);
    const float prod = __fmul_rn(w, dens);
    // each step's sigma, summed over its live corners in corner order as
    // gather_sample sums it, in every lane
    float sig[kSteps];
    unsigned marched = 0, gated = 0;   // bit s: step s marched / passes the gate
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float pc = __shfl_sync(kFull, prod, 8 * s + c);
        if (live & (1u << (8 * s + c))) v = __fadd_rn(v, pc);
      }
      sig[s] = v > 0.f ? v : 0.f;
      if ((used >> (8 * s)) & 1u) {
        marched |= 1u << s;
        if (sig[s] >= p.sigma_thresh) gated |= 1u << s;
      }
    }
    const unsigned gather = kDensityFirst ? gated : marched;
    if (gather) {
      // lane c (1-27) reads SH channel c - 1 at the live corners of every
      // gathered step: all loads of the pass in flight at once
      float cv[kSteps][8];
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int64_t cs = __shfl_sync(kFull, cell0, 8 * s);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int64_t cc = cs + (c >> 2) * yz + ((c >> 1) & 1) * (int64_t)g.Z + (c & 1);
          const bool ld = ((gather >> s) & 1u) && ((live >> (8 * s + c)) & 1u) && lane >= 1 &&
                          lane < kCh;
          cv[s][c] = ld ? __ldg(g.sh + cc * (kCh - 1) + (lane - 1)) : 0.f;
        }
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        if (!((gated >> s) & 1u)) continue;   // contributes exactly nothing
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float wc = __shfl_sync(kFull, w, 8 * s + c);
          if (live & (1u << (8 * s + c))) v = __fadd_rn(v, __fmul_rn(wc, cv[s][c]));
        }
        // segmented sum of shm * c over lanes 1-9 (r), 10-18 (g), 19-27 (b),
        // as gather_sample sums it
        const int seg = (lane >= 1 && lane < kCh) ? (lane - 1) / kBasis : -1 - lane;
        float q = seg >= 0 ? in.shm * v : 0.f;
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) {
          const float other = __shfl_down_sync(kFull, q, off);
          const int ol = lane + off;
          const int oseg = (ol >= 1 && ol < kCh) ? (ol - 1) / kBasis : -1 - ol;
          if (ol < 32 && oseg == seg) q += other;
        }
        float rgb_raw[3];
        rgb_raw[0] = __shfl_sync(kFull, q, 1) + 0.5f;
        rgb_raw[1] = __shfl_sync(kFull, q, 1 + kBasis) + 0.5f;
        rgb_raw[2] = __shfl_sync(kFull, q, 1 + 2 * kBasis) + 0.5f;
        // composite, as the replaced kernel does
        const float sigma = sig[s];
        const float ts = step_t(in, p, j0 + s);
        const float la = -p.step * sigma * in.dscale;
        const float wt = expf(log_t) * (1.f - expf(la));
#pragma unroll
        for (int k = 0; k < 3; ++k) acc[k] += wt * fmaxf(rgb_raw[k], 0.f);
        depth += wt * ts;
        log_t += la;
      }
    }
    j0 += kSteps;
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
    case -2: own_fwd_kernel<2, true, false><<<grid, block, 0, st>>>(g, oc, r, p, out); break;
%s
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int probe_backward(int variant, const float* density, const float* sh,
                              const uint8_t* alive, int X, int Y, int Z, const float* origins,
                              const float* dirs, const float* tmin, const float* tmax,
                              const float* dscale, const float* shmult, int n_rays,
                              int max_steps, float step, float sigma_thresh, float background,
                              const uint8_t* occ, const float* out, const float* grad_out,
                              float* grad_density, float* grad_sh, float* sink, void* stream) {
  const GridView g = make_grid(density, sh, alive, X, Y, Z);
  const Occupancy oc = make_occupancy(occ, Y, Z);
  const RayView r = make_rays(origins, dirs, tmin, tmax, dscale, shmult);
  const Params p = make_params(n_rays, max_steps, step, sigma_thresh, background);
  const dim3 block(32 * kWarps), grid((n_rays + kWarps - 1) / kWarps);
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case -1:
      replaced_bwd_kernel<<<grid, block, 0, st>>>(g, r, p, out, grad_out, grad_density,
                                                  grad_sh);
      break;
%s
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""

# name -> (launcher case, with the occupancy); a case is K1's template
# (steps a pass, density first, spread) encoded as steps * 4 + 2 * density
# first + spread, -1 the replaced K1, -2 K1's own body
VARIANTS = {
    "K1 (skip, density first, 2 steps a pass)": (2 * 4 + 2, True),
    "K1's own body before its march was shared with K2": (-2, True),
    "skip off": (2 * 4 + 2, False),
    "density first off (SH gathered for every marched step)": (2 * 4 + 0, True),
    "1 step a pass": (1 * 4 + 2, True),
    "4 steps a pass": (4 * 4 + 2, True),
    "rays spread over the SMs (warp w of block b takes ray w * blocks + b)": (2 * 4 + 3, True),
    "the replaced K1 (no skip, all 28 channels before the gate, a step a pass)": (-1, False),
}
K1 = "K1 (skip, density first, 2 steps a pass)"
OWN = "K1's own body before its march was shared with K2"
REPLACED = "the replaced K1 (no skip, all 28 channels before the gate, a step a pass)"

K2 = "K2 (as cuvol_backward launches it)"
REPLACED_K2_NAME = ("the replaced K2 (no skip, all 28 channels before the gate, a step a "
                    "pass, 8 atomics a kept sample)")
ATOMICS_OFF = "atomics off (a measurement only: its adds are summed, no gradient written)"
MERGE_ON = "merge on"
MERGE_OFF = "merge off (8 atomics a kept sample)"

_LIB: list = []


def _cu_source() -> str:
    with open(os.path.join(_build.CSRC, "voxel_cuvol.cu")) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def k2_config() -> tuple:
    """K2's (steps a pass, merge) as csrc/voxel_cuvol.cu launches it."""
    import re
    src = _cu_source()
    steps = int(re.search(r"constexpr int kBwdSteps = (\d+);", src).group(1))
    merge = re.search(r"constexpr bool kBwdMerge = (true|false);", src).group(1) == "true"
    return steps, merge


@functools.lru_cache(maxsize=None)
def k2_variants() -> dict:
    """Name -> (K2's template (steps a pass, density first, merge, atomics)
    or None for the replaced K2, with the occupancy): K2 as launched and
    each switch flipped; ``ATOMICS_OFF`` is a measurement, not a gradient."""
    steps, merge = k2_config()
    v = {K2: ((steps, True, merge, True), True),
         "skip off": ((steps, True, merge, True), False),
         "density first off (SH gathered for every marched step)": ((steps, False, merge, True),
                                                                    True),
         (MERGE_OFF if merge else MERGE_ON): ((steps, True, not merge, True), True)}
    for n in (1, 2, 4):
        if n != steps:
            v[f"{n} step{'s' if n > 1 else ''} a pass"] = ((n, True, merge, True), True)
    v[REPLACED_K2_NAME] = (None, False)
    v[ATOMICS_OFF] = ((steps, True, merge, False), True)
    return v


def merge_off_variant() -> str:
    """The K2 variant without the merge, whose single ray's gradient is the
    replaced K2's bit for bit."""
    return MERGE_OFF if k2_config()[1] else K2


def _k2_code(t) -> int:
    return -1 if t is None else t[0] * 8 + 4 * t[1] + 2 * t[2] + t[3]


def source() -> str:
    """The probe's CUDA source: voxel_cuvol.cu with the replaced kernels,
    their ``gather_sample``, K1's own body and a launcher for each variant
    appended (the launchers at file scope see the source's anonymous
    namespace)."""
    src = _cu_source()
    end = src.index("}  // namespace\n")
    b = lambda x: str(bool(x)).lower()
    fwd = "\n".join(
        f"    case {v}: cuvol_fwd_kernel<{v // 4}, {b(v & 2)}, {b(v & 1)}>"
        f"<<<grid, block, 0, st>>>(g, oc, r, p, out); break;"
        for v in sorted({code for code, _ in VARIANTS.values() if code >= 0}))
    bwd = "\n".join(
        f"    case {_k2_code(t)}: cuvol_bwd_kernel<{t[0]}, {b(t[1])}, {b(t[2])}, {b(t[3])}>"
        f"<<<grid, block, 0, st>>>(g, oc, r, p, out, grad_out, grad_density, grad_sh, sink); "
        f"break;"
        for t in sorted({t for t, _ in k2_variants().values() if t is not None}))
    return (src[:end] + GATHER_SAMPLE + REPLACED_K1 + REPLACED_K2 + OWN_K1 + src[end:]
            + _LAUNCHER % (fwd, bwd))


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
        raise RuntimeError(f"the K1/K2 probe did not build:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(so)
    lib.probe_forward.restype = ctypes.c_int
    lib.probe_forward.argtypes = [ctypes.c_int] + vk._COMMON + [ctypes.c_void_p] * 3
    lib.probe_backward.restype = ctypes.c_int
    lib.probe_backward.argtypes = [ctypes.c_int] + vk._COMMON + [ctypes.c_void_p] * 7
    _LIB.append(lib)
    return lib


def launch(variant: str, grid, ray_in, cfg, occ, out) -> None:
    """One launch of a K1 variant into ``out`` [N, 8]; ``occ`` is used by
    the variants that skip (None: they march every step)."""
    code, skip = VARIANTS[variant]
    args = vk._common_args(*grid, *ray_in, cfg)
    rc = build().probe_forward(code, *args, occ.data_ptr() if skip and occ is not None else None,
                               out.data_ptr(),
                               torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 probe variant {variant!r} failed: cudaError {rc}")


def launch_backward(variant: str, grid, ray_in, cfg, occ, out, grad_out, grads,
                    sink=None) -> None:
    """One launch of a K2 variant, adding into ``grads`` (grad_density,
    grad_sh); ``occ`` is used by the variants that skip (None: they march
    every step), ``sink`` ([N, 32] f32) only by ``ATOMICS_OFF``."""
    t, skip = k2_variants()[variant]
    args = vk._common_args(*grid, *ray_in, cfg)
    if t is not None and not t[3] and sink is None:
        raise ValueError(f"{variant!r} needs a sink")
    rc = build().probe_backward(
        _k2_code(t), *args, occ.data_ptr() if skip and occ is not None else None, out.data_ptr(),
        grad_out.data_ptr(), grads[0].data_ptr(), grads[1].data_ptr(),
        None if sink is None else sink.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 probe variant {variant!r} failed: cudaError {rc}")


def probe(grid, cfg, o, d) -> dict:
    """Name -> (ms by CUDA events, device ms a call) of each K1 variant on
    these rays, K1 with its occupancy given, "K1 through the wrapper" (the
    occupancy built before each launch, as a caller without one calls it)
    and "occupancy build".  Every variant's output is checked bitwise equal
    to the replaced kernel's first; raises if one differs."""
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


def backward_error(got, want) -> float:
    """The largest of |got - want| over grad_density and grad_sh, each over
    its own largest |want| entry (1 where that is 0)."""
    err = 0.0
    for a, b in zip(got, want):
        scale = float(b.abs().max()) or 1.0
        err = max(err, float((a - b).abs().max()) / scale)
    return err


def probe_backward(grid, cfg, o, d, grad_out) -> dict:
    """Name -> (ms by CUDA events, device ms a call) of each K2 variant on
    these rays and this upstream gradient [N, 8], adding into gradients
    zero-filled once outside the timed calls, and "K2 through the wrapper"
    (the forward's occupancy passed, as the main path calls it).  Every
    variant but ``ATOMICS_OFF`` is checked first within 1e-5 of the largest
    entry of the replaced kernel's gradient; raises if one is not."""
    from flnerf_tpu_torch.tools.hash_probe import _time
    if not vk.skips(cfg):
        raise ValueError("the probe's skipping variants need sigma_thresh > 0")
    ray_in = vk.ray_inputs(cfg, o, d)
    occ = vk.skip_occupancy(grid.density, grid.alive, cfg)
    out = vk.cuvol_forward(*grid, *ray_in, cfg, occ=occ)
    zeros = lambda: (torch.zeros_like(grid.density), torch.zeros_like(grid.sh))
    want = zeros()
    launch_backward(REPLACED_K2_NAME, grid, ray_in, cfg, occ, out, grad_out, want)
    variants = k2_variants()
    sink = torch.empty((o.shape[0], 32), device=o.device)
    for name, (t, _) in variants.items():
        if t is not None and not t[3]:   # no atomics: a measurement, not a gradient
            continue
        got = zeros()
        launch_backward(name, grid, ray_in, cfg, occ, out, grad_out, got)
        torch.cuda.synchronize()
        err = backward_error(got, want)
        if not err <= 1e-5:
            raise RuntimeError(f"K2 probe variant {name!r} differs from the replaced kernel by "
                               f"{err:.3e} of the largest entry")
    grads = zeros()
    ms = {name: _time(lambda name=name: launch_backward(name, grid, ray_in, cfg, occ, out,
                                                        grad_out, grads, sink))
          for name in variants}
    ms["K2 through the wrapper (the forward's occupancy passed)"] = _time(
        lambda: vk.cuvol_backward(*grid, *ray_in, out, grad_out, cfg, grads=grads, occ=occ))
    return ms


def sample_counts(grid, cfg, o, d, chunk: int = 256) -> dict:
    """What the skip and the gate leave of this batch, counted in plain
    torch: the marched samples (t <= tmax), those in unmarked blocks
    (skipped), in marked blocks with a relu'd sigma under sigma_thresh
    (gated) and kept; the kept samples whose floor cell repeats the
    previous kept sample's of their ray (``repeated``: what K2's merge
    would fold); the steps of the longest ray, and its steps in marked blocks;
    the share of marked blocks; the distinct corner cells of the samples in
    marked blocks (the kernels read their alive byte and density), of those
    the alive cells with density > 0 (whose SH a kept sample may read), and
    the alive corner cells of the kept samples (``kept_cells``: K2 reads
    their SH and adds into their 28 gradients)."""
    from flnerf_tpu_torch.models.voxel_sh import grid_ray_setup
    origins, dirs, tmin, tmax, _, _ = grid_ray_setup(cfg, o, d)
    occ = vk.occupancy_blocks(grid.density, grid.alive)
    dens = torch.where(grid.alive, grid.density, 0.0).reshape(-1)
    alive = grid.alive.reshape(-1)
    steps = torch.arange(cfg.max_steps, device=o.device)
    _, y, z = cfg.reso
    c = dict(samples=0, skipped=0, gated=0, kept=0, repeated=0, longest_steps=0,
             longest_marked_steps=0)
    cells, kept_cells = [], []
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
        corners = []
        for j in range(8):
            b = [(j >> 2) & 1, (j >> 1) & 1, j & 1]
            w = 1.0
            for a in range(3):
                w = w * (frac[..., a] if b[a] else 1 - frac[..., a])
            cell = ((lo[..., 0] + b[0]) * y + lo[..., 1] + b[1]) * z + lo[..., 2] + b[2]
            sigma = sigma + w * dens[cell]
            cells.append(cell[marked].unique())
            corners.append(cell)
        kept = marked & (torch.relu(sigma) >= cfg.sigma_thresh)
        for cell in corners:
            kc = cell[kept].unique()
            kept_cells.append(kc[alive[kc]])
        c["samples"] += int(valid.sum())
        c["skipped"] += int((valid & ~marked).sum())
        c["gated"] += int((marked & ~kept).sum())
        c["kept"] += int(kept.sum())
        c["repeated"] += int(vk.repeated_floor_cells(corners[0], kept).sum())
        c["longest_steps"] = max(c["longest_steps"], int(valid.sum(1).max()))
        c["longest_marked_steps"] = max(c["longest_marked_steps"], int(marked.sum(1).max()))
    touched = torch.cat(cells).unique()
    c["touched_cells"] = int(touched.numel())
    c["sh_cells"] = int((alive[touched] & (grid.density.reshape(-1)[touched] > 0)).sum())
    c["kept_cells"] = int(torch.cat(kept_cells).unique().numel())
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


def finding_backward(ms: dict) -> str:
    """One line, by CUDA events (K2 runs long enough that the host's launch
    gaps do not count): K2 against the replaced kernel, what each design
    choice buys, and the atomics' share of K2."""
    ev = {k: v[0] for k, v in ms.items()}
    k2 = ev[K2]
    parts = [f"K2 {k2:.4f} ms against the replaced {ev[REPLACED_K2_NAME]:.4f} "
             f"({ev[REPLACED_K2_NAME] / k2:.2f}x)"]
    for name in ms:
        if name in (K2, REPLACED_K2_NAME, ATOMICS_OFF):
            continue
        parts.append(f"{name} {ev[name] - k2:+.4f}")
    parts.append(f"without its atomics {ev[ATOMICS_OFF] - k2:+.4f} (the atomics "
                 f"{100 * (1 - ev[ATOMICS_OFF] / k2):.1f}% of K2)")
    return "K2 (events): " + "; ".join(parts)


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
    out = vk.cuvol_forward(*grid, *vk.ray_inputs(cfg, o, d), cfg)
    grad_out = torch.zeros_like(out)
    grad_out[:, :3] = 2.0 * (out[:, :3] - 0.5) / (3 * out.shape[0])
    grad_out[:, 4] = 0.1
    ms = probe_backward(grid, cfg, o, d, grad_out)
    for name, (ev, dt) in ms.items():
        print(f"{ev:9.4f} ms by events, {dt:9.4f} ms of device time  {name}")
    print(finding_backward(ms))


if __name__ == "__main__":
    main()

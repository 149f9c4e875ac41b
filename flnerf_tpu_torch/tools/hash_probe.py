"""K3 and K4's design choices, timed on the card against each other.

    python -m flnerf_tpu_torch.tools.hash_probe [--n 393216]
        on uniform random points and on points clustered in a few coarse
        cells, at 2^15 (16 levels) and on the 2^19 engines' 2 small levels;
    chip_smoke.py phases 7 and 10 call ``probe`` on the 2^15 trainer's own
    batch and gradients and on the lattice trainer's small levels.

Beside K3 and K4 as the wrapper launches them, by CUDA events and by the
profiler's device time on the same inputs:
  replaced  the kernels K3/K4 replaced (one thread per (point, level),
            level fastest; K4 with 8 global atomics per live thread on a
            contiguous copy of a column-slice gradient, the copy timed
            apart), kept here as a source string;
  own body  K4's own tile kernel before the lattice engine's K7 came to
            share its skeleton (csrc/hash_corners.cuh tile_bwd_kernel),
            kept here as a source string: what the sharing costs K4;
  no gather K3 with a value made from each corner's index in place of its
            table loads (substituted into a copy of hash_encode.cu);
  unpaired  K3 with one load for every corner, where it loads two
            x-neighbours in one 16-byte pair at once (substituted likewise);
  tiled     K3 walking a tile level by level: a warp takes 32 consecutive
            points through every level (ray neighbours share the coarse
            levels' sectors in one gather), writes their features into a
            padded shared tile and stores its rows as one contiguous span in
            16-byte stores.  Kept here as a source string;
  shared    K4 with its leading levels accumulated in shared memory, the
            Hopper form of the TPU kernel's VMEM accumulator (the TPU
            kernel's acc_ref, hash_pallas.py:185): a few CTAs each sum a
            contiguous share of the points into a private copy of levels 0
            and 1 (164 KB) or of level 0, with shared-memory atomics, after
            the warp's equal corners are merged (or without the merge), and
            flush the entries they touched with one global atomic each; K4
            takes the other levels.  Kept here as a source string.
Each K4 variant's gradient is held against K4's (1e-4 of the largest
entry; exactly zero where K4's is), the replaced K3's output must equal
K3's.  Built by nvcc into ``build/probe/``; needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import subprocess

import torch

from flnerf_tpu_torch.ops import _build
from flnerf_tpu_torch.ops import hash_kernel as hk

# The replaced K3/K4 (csrc/hash_encode.cu before its tiled redesign).
OLD_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "hash_corners.cuh"
namespace {
using hashgrid::Levels;
constexpr int kThreads = 256;
__global__ void __launch_bounds__(kThreads)
old_fwd_kernel(const float* __restrict__ x01, const float2* __restrict__ table, int64_t n,
               Levels lv, float2* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n * lv.L) return;
  const int64_t p = i / lv.L;
  const int l = (int)(i - p * lv.L);
  const float x[3] = {x01[p * 3], x01[p * 3 + 1], x01[p * 3 + 2]};
  uint32_t idx[8];
  float w[8];
  hashgrid::level_corners(x, lv, l, idx, w);
  const float2* tab = table + (int64_t)l * lv.t_cap;
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float2 f = __ldg(tab + idx[c]);
    acc.x = __fadd_rn(acc.x, __fmul_rn(w[c], f.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(w[c], f.y));
  }
  out[i] = acc;
}
__global__ void __launch_bounds__(kThreads)
old_bwd_kernel(const float* __restrict__ x01, const float2* __restrict__ grad_out,
               int64_t n, Levels lv, float2* __restrict__ grad_table) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n * lv.L) return;
  const float2 g = grad_out[i];
  if (g.x == 0.f && g.y == 0.f) return;
  const int64_t p = i / lv.L;
  const int l = (int)(i - p * lv.L);
  const float x[3] = {x01[p * 3], x01[p * 3 + 1], x01[p * 3 + 2]};
  uint32_t idx[8];
  float w[8];
  hashgrid::level_corners(x, lv, l, idx, w);
  float2* gt = grad_table + (int64_t)l * lv.t_cap;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    hashgrid::atomic_add2(gt + idx[c], make_float2(__fmul_rn(w[c], g.x), __fmul_rn(w[c], g.y)));
}
}  // namespace
extern "C" int old_launch(int bwd, const float* x01, const float* data, long long n, int L,
                          int t_cap, const float* scales, const uint32_t* strides,
                          const uint32_t* sizes, const int* use_hash, float* out, void* stream) {
  Levels lv;
  const int err = hashgrid::make_levels(L, t_cap, scales, strides, sizes, use_hash, lv);
  if (err != 0) return err;
  const dim3 grid((unsigned)((n * L + kThreads - 1) / kThreads));
  if (bwd)
    old_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        x01, reinterpret_cast<const float2*>(data), n, lv, reinterpret_cast<float2*>(out));
  else
    old_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        x01, reinterpret_cast<const float2*>(data), n, lv, reinterpret_cast<float2*>(out));
  return (int)cudaGetLastError();
}
"""

# K4's own body before the lattice engine's K7 came to share it
# (csrc/hash_encode.cu hash_bwd_tile_kernel before csrc/hash_corners.cuh
# tile_bwd_kernel): timed beside K4 to show what the shared skeleton costs.
OWN_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "hash_corners.cuh"
namespace {
using hashgrid::Levels;
using hashgrid::atomic_add2;
using hashgrid::lanemask_lt;
using hashgrid::level_corners;
using hashgrid::nonzero;
using hashgrid::padded;
using hashgrid::sum_peers;
constexpr int kTile = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
__global__ void __launch_bounds__(kThreads)
own_bwd_kernel(const float* __restrict__ x01, const float2* __restrict__ grad,
                int64_t g_row, int64_t n, Levels lv, int vec,
                float2* __restrict__ grad_table) {
  extern __shared__ float2 gs[];     // [kTile][padded(L)]
  __shared__ float xs[kTile * 3];
  __shared__ int live_list[kTile];
  __shared__ int warp_live[kTile / 32];
  const int L = lv.L, s = padded(L);
  const int64_t p0 = (int64_t)blockIdx.x * kTile;
  const int np = (int)(n - p0 < kTile ? n - p0 : kTile);
  const float2* g0 = grad + p0 * g_row;
  if (vec) {   // L even, rows 16-byte aligned
    const int h = L / 2;
    for (int j = threadIdx.x; j < np * h; j += kThreads) {
      const int r = j / h, c = 2 * (j - r * h);
      const float4 v = __ldg(reinterpret_cast<const float4*>(g0 + r * g_row + c));
      gs[r * s + c] = make_float2(v.x, v.y);
      gs[r * s + c + 1] = make_float2(v.z, v.w);
    }
  } else {
    for (int j = threadIdx.x; j < np * L; j += kThreads) {
      const int r = j / L, c = j - r * L;
      gs[r * s + c] = __ldg(g0 + r * g_row + c);
    }
  }
  __syncthreads();

  // the tile's live points, in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool live = false;
  if (threadIdx.x < np)
    for (int l = 0; l < L; ++l) live |= nonzero(gs[threadIdx.x * s + l]);
  int rank = 0;
  if (warp < kTile / 32) {
    const unsigned b = __ballot_sync(kFull, live);
    if (lane == 0) warp_live[warp] = __popc(b);
    rank = __popc(b & lanemask_lt());
  }
  __syncthreads();
  int n_live = 0, before = 0;
  for (int w = 0; w < kTile / 32; ++w) {
    before += w < warp ? warp_live[w] : 0;
    n_live += warp_live[w];
  }
  if (n_live == 0) return;   // the whole CTA: a dead tile reads no x01
  if (live) live_list[before + rank] = threadIdx.x;
  for (int j = threadIdx.x; j < np * 3; j += kThreads) xs[j] = __ldg(x01 + p0 * 3 + j);
  __syncthreads();

  const int groups = (n_live + 31) >> 5;
  for (int task = warp; task < groups * L; task += kWarps) {   // level-major
    const int l = task / groups;
    const int i = (task - l * groups) * 32 + lane;
    const int p = i < n_live ? live_list[i] : -1;
    const float2 g = p >= 0 ? gs[p * s + l] : make_float2(0.f, 0.f);
    const bool on = nonzero(g);
    if (!__any_sync(kFull, on)) continue;
    uint32_t idx[8] = {};
    float w[8] = {};
    if (on) {
      const float x[3] = {xs[p * 3], xs[p * 3 + 1], xs[p * 3 + 2]};
      level_corners(x, lv, l, idx, w);
    }
    float2* gt = grad_table + (int64_t)l * lv.t_cap;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float2 v = on ? make_float2(__fmul_rn(w[c], g.x), __fmul_rn(w[c], g.y))
                    : make_float2(0.f, 0.f);
      bool lead;
      const int key = on ? (int)idx[c] : -1 - lane;   // a dead lane keys itself apart
      v = sum_peers(__match_any_sync(kFull, key), v, lead);
      if (lead && nonzero(v)) atomic_add2(gt + idx[c], v);
    }
  }
}

}  // namespace
extern "C" int own_launch(const float* x01, const float* grad, long long g_row, long long n,
                          int L, int t_cap, const float* scales, const uint32_t* strides,
                          const uint32_t* sizes, const int* use_hash, float* grad_table,
                          void* stream) {
  Levels lv;
  const int err = hashgrid::make_levels(L, t_cap, scales, strides, sizes, use_hash, lv);
  if (err != 0) return err;
  const float2* g = reinterpret_cast<const float2*>(grad);
  const int vec = L % 2 == 0 && g_row % 2 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  own_bwd_kernel<<<(unsigned)((n + kTile - 1) / kTile), kThreads,
                   kTile * padded(L) * (int)sizeof(float2), (cudaStream_t)stream>>>(
      x01, g, (int64_t)g_row, (int64_t)n, lv, vec, reinterpret_cast<float2*>(grad_table));
  return (int)cudaGetLastError();
}
"""

# K4's leading levels in shared memory.
SHARED_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "hash_corners.cuh"
namespace {
using hashgrid::Levels;
using hashgrid::atomic_add2;
using hashgrid::level_corners;
using hashgrid::sum_peers;
constexpr int kSharedThreads = 512;
constexpr int kMaxShared = 4;
constexpr int kSmemMax = 232448;
constexpr unsigned kFull = 0xffffffffu;
__device__ __forceinline__ bool nonzero(float2 v) { return v.x != 0.f || v.y != 0.f; }
template <bool kMerge>
__global__ void __launch_bounds__(kSharedThreads)
shared_bwd_kernel(const float* __restrict__ x01, const float2* __restrict__ grad,
                  int64_t g_row, int64_t n, Levels lv, int n_shared,
                  float2* __restrict__ grad_table) {
  extern __shared__ float2 acc[];    // level l's entries at off[l]
  int off[kMaxShared + 1];
  off[0] = 0;
#pragma unroll
  for (int l = 0; l < kMaxShared; ++l) off[l + 1] = off[l] + (l < n_shared ? (int)lv.size[l] : 0);
  const int total = off[kMaxShared];
  for (int j = threadIdx.x; j < total; j += kSharedThreads) acc[j] = make_float2(0.f, 0.f);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t begin = n * blockIdx.x / gridDim.x, end = n * (blockIdx.x + 1) / gridDim.x;
  for (int64_t base = begin; base < end; base += kSharedThreads) {   // uniform in the CTA
    const int64_t p = base + threadIdx.x;
    float2 g[kMaxShared];
    bool live = false;
#pragma unroll
    for (int l = 0; l < kMaxShared; ++l) {
      g[l] = (l < n_shared && p < end) ? grad[p * g_row + l] : make_float2(0.f, 0.f);
      live |= nonzero(g[l]);
    }
    if (!__any_sync(kFull, live)) continue;   // the warp's 32 points are all dead
    float x[3] = {0.f, 0.f, 0.f};
    if (live) {
      x[0] = __ldg(x01 + p * 3);
      x[1] = __ldg(x01 + p * 3 + 1);
      x[2] = __ldg(x01 + p * 3 + 2);
    }
#pragma unroll
    for (int l = 0; l < kMaxShared; ++l) {
      const bool on = nonzero(g[l]);
      if (!__any_sync(kFull, on)) continue;
      uint32_t idx[8] = {};
      float w[8] = {};
      if (on) level_corners(x, lv, l, idx, w);
      float* a = reinterpret_cast<float*>(acc + off[l]);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float2 v = on ? make_float2(__fmul_rn(w[c], g[l].x), __fmul_rn(w[c], g[l].y))
                      : make_float2(0.f, 0.f);
        bool lead = on;
        if (kMerge) {   // a dead lane keys itself apart
          const int key = on ? (int)idx[c] : -1 - lane;
          v = sum_peers(__match_any_sync(kFull, key), v, lead);
        }
        if (lead && nonzero(v)) {
          atomicAdd(a + 2 * idx[c], v.x);
          atomicAdd(a + 2 * idx[c] + 1, v.y);
        }
      }
    }
  }
  __syncthreads();

  // the entries this CTA touched, one global atomic each
  for (int j = threadIdx.x; j < total; j += kSharedThreads) {
    const float2 v = acc[j];
    if (!nonzero(v)) continue;
    int l = 0;
#pragma unroll
    for (int k = 1; k < kMaxShared; ++k) l += j >= off[k];
    int at = j;
#pragma unroll
    for (int k = 1; k < kMaxShared; ++k) at -= l == k ? off[k] : 0;
    atomic_add2(grad_table + (int64_t)l * lv.t_cap + at, v);
  }
}

}  // namespace
extern "C" int shared_launch(int merge, const float* x01, const float* grad, long long g_row,
                             long long n, int L, int t_cap, const float* scales,
                             const uint32_t* strides, const uint32_t* sizes, const int* use_hash,
                             int n_shared, int ctas, float* grad_table, void* stream) {
  Levels lv;
  const int err = hashgrid::make_levels(L, t_cap, scales, strides, sizes, use_hash, lv);
  if (err != 0) return err;
  long long smem = 0;
  for (int l = 0; l < n_shared; ++l) smem += sizes[l] * 8LL;
  if (n < 1 || n_shared < 1 || n_shared > kMaxShared || n_shared > L || smem > kSmemMax ||
      ctas < 1)
    return (int)cudaErrorInvalidValue;
  auto kernel = merge ? shared_bwd_kernel<true> : shared_bwd_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<ctas, kSharedThreads, (size_t)smem, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(grad), g_row, n, lv, n_shared,
      reinterpret_cast<float2*>(grad_table));
  return (int)cudaGetLastError();
}
"""

# K3 walking a tile level by level: a warp takes 32 consecutive points
# through all levels, writes their features into a padded shared tile and
# stores its rows as one contiguous span.
TILED_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "hash_corners.cuh"
namespace {
using hashgrid::Levels;
using hashgrid::level_corners;
constexpr int kTile = 128;
constexpr int kFwdThreads = 128;
__host__ __device__ constexpr int padded(int cols) { return cols | 1; }
__device__ __forceinline__ void load_pair(const float2* __restrict__ tab, uint32_t a,
                                          uint32_t b, bool pair, float2& fa, float2& fb) {
  if (pair && (a ^ b) == 1u) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(tab + (a & ~1u)));
    const float2 lo = make_float2(v.x, v.y), hi = make_float2(v.z, v.w);
    fa = (a & 1u) ? hi : lo;
    fb = (a & 1u) ? lo : hi;
  } else {
    fa = __ldg(tab + a);
    fb = __ldg(tab + b);
  }
}
__global__ void __launch_bounds__(kFwdThreads)
tiled_fwd_kernel(const float* __restrict__ x01, const float2* __restrict__ table, int64_t n,
                 Levels lv, int vec, float2* __restrict__ out) {
  extern __shared__ float2 tiles[];   // [kTile][padded(L)]: 32 rows a warp
  const int L = lv.L, s = padded(L);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t p0 = (int64_t)blockIdx.x * kTile + warp * 32;   // the warp's first point
  if (p0 >= n) return;   // the whole warp
  const int np = (int)(n - p0 < 32 ? n - p0 : 32);
  float2* tile = tiles + warp * 32 * s;
  if (lane < np) {
    const float* xp = x01 + (p0 + lane) * 3;
    const float x[3] = {__ldg(xp), __ldg(xp + 1), __ldg(xp + 2)};
#pragma unroll 2
    for (int l = 0; l < L; ++l) {   // level by level: the warp's 32 points gather together
      uint32_t idx[8];
      float w[8];
      level_corners(x, lv, l, idx, w);
      const float2* tab = table + (int64_t)l * lv.t_cap;
      const bool pair = lv.use_hash[l] != 0;
      float2 f[8];
#pragma unroll
      for (int c = 0; c < 8; c += 2) load_pair(tab, idx[c], idx[c + 1], pair, f[c], f[c + 1]);
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int c = 0; c < 8; ++c) {   // corner order, as the plain version sums
        acc.x = __fadd_rn(acc.x, __fmul_rn(w[c], f[c].x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(w[c], f[c].y));
      }
      tile[lane * s + l] = acc;
    }
  }
  __syncwarp();

  // the warp's rows are out[p0 : p0 + np] of [N, L, 2]: one contiguous span
  float2* dst = out + p0 * L;
  const int total = np * L;
  if (vec) {   // L even, out 16-byte aligned
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int j = lane; j < total / 2; j += 32) {
      const int r = 2 * j / L, c = 2 * j - r * L;
      const float2 a = tile[r * s + c], b = tile[r * s + c + 1];
      dst4[j] = make_float4(a.x, a.y, b.x, b.y);
    }
  } else {
    for (int j = lane; j < total; j += 32) {
      const int r = j / L;
      dst[j] = tile[r * s + j - r * L];
    }
  }
}

}  // namespace
extern "C" int tiled_launch(const float* x01, const float* table, long long n, int L, int t_cap,
                            const float* scales, const uint32_t* strides, const uint32_t* sizes,
                            const int* use_hash, float* out, void* stream) {
  Levels lv;
  const int err = hashgrid::make_levels(L, t_cap, scales, strides, sizes, use_hash, lv);
  if (err != 0) return err;
  const int vec = L % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  tiled_fwd_kernel<<<(unsigned)((n + kTile - 1) / kTile), kFwdThreads,
                     kTile * padded(L) * sizeof(float2), (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(table), n, lv, vec, reinterpret_cast<float2*>(out));
  return (int)cudaGetLastError();
}
"""

_GATHER = ("  for (int c = 0; c < 8; c += 2) load_pair(tab, idx[c], idx[c + 1], pair, f[c], "
           "f[c + 1]);")
_NO_GATHER = "  for (int c = 0; c < 8; ++c) f[c] = make_float2((float)(idx[c] & 1023), 1e-9f);"
_PAIRED = "  if (pair && (a ^ b) == 1u) {"
_UNPAIRED = "  if (false) {"

SHARED_CTAS = (33, 66, 132, 264)   # CTAs that split the shared levels' points
SMEM_MAX = 232_448                 # shared memory a block can use on the H100
_LIBS: dict = {}


def build() -> dict:
    """nvcc the probe's six libraries into build/probe/, all at once (once
    a process): "old" (the replaced kernels), "own" (K4's own body before
    the shared tile skeleton), "no gather" (K3 without its
    table loads), "unpaired" (K3 with a load for every corner), "tiled" (K3
    walking a tile level by level) and "shared" (K4's shared-memory
    levels)."""
    if _LIBS:
        return _LIBS
    with open(os.path.join(_build.CSRC, "hash_encode.cu")) as f:
        src = f.read()
    for line in (_GATHER, _PAIRED):
        if src.count(line) != 1:
            raise RuntimeError(f"hash_encode.cu no longer holds the probed line {line!r}")
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in (("old", OLD_SOURCE), ("own", OWN_SOURCE),
                       ("no gather", src.replace(_GATHER, _NO_GATHER)),
                       ("unpaired", src.replace(_PAIRED, _UNPAIRED)),
                       ("tiled", TILED_SOURCE), ("shared", SHARED_SOURCE)):
        cu = os.path.join(out_dir, f"hash_probe_{name.replace(' ', '_')}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (cu[:-3] + ".so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"the hash probe's {name!r} library did not build:\n{log}")
        libs[name] = ctypes.CDLL(so)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs["old"].old_launch.restype = I
    libs["old"].old_launch.argtypes = [I, P, P, LL, I, I] + [P] * 6
    libs["own"].own_launch.restype = I
    libs["own"].own_launch.argtypes = [P, P, LL, LL, I, I] + [P] * 6
    libs["tiled"].tiled_launch.restype = I
    libs["tiled"].tiled_launch.argtypes = [P, P, LL, I, I] + [P] * 6
    libs["shared"].shared_launch.restype = I
    libs["shared"].shared_launch.argtypes = [I, P, P, LL, LL, I, I, P, P, P, P, I, I, P, P]
    hk.bind(libs["no gather"])
    hk.bind(libs["unpaired"])
    _LIBS.update(libs)
    return _LIBS


def _time(fn, iters=20) -> tuple:
    """(ms by CUDA events around back-to-back calls, device ms a call by the
    profiler: the kernels' own time, without the host's launch gaps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    dev_us = 0.0
    for _ in range(2):   # a trace may record no kernel at all: trace once more
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
        if dev_us > 0:
            break
    # no recorded kernel gives no device time (nan), not zero
    return start.elapsed_time(end) / iters, dev_us / 1e3 / iters if dev_us > 0 else math.nan


def levels_from(spec, lo: int):
    """The packed spec of levels [lo, L) of ``spec``."""
    b = spec.base
    return spec._replace(base=b._replace(
        num_levels=b.num_levels - lo, scales=b.scales[lo:], resolutions=b.resolutions[lo:],
        offsets=b.offsets[lo:] - b.offsets[lo], sizes=b.sizes[lo:], use_hash=b.use_hash[lo:]))


def shared_variants(spec) -> dict:
    """Name -> (levels in shared memory, CTAs, merge) of the shared
    variants that fit one block's shared memory."""
    sizes = [int(v) for v in spec.base.sizes]
    out = {}
    if sizes[0] * 8 <= SMEM_MAX:
        out["level 0 in shared memory, 132 CTAs"] = (1, 132, True)
    if spec.num_levels >= 2 and (sizes[0] + sizes[1]) * 8 <= SMEM_MAX:
        for c in SHARED_CTAS:
            out[f"levels 0-1 in shared memory, {c} CTAs"] = (2, c, True)
        out["levels 0-1 in shared memory, 132 CTAs, no merge"] = (2, 132, False)
    return out


def probe(x01: torch.Tensor, table: torch.Tensor, spec, grads: dict) -> dict:
    """Name -> (ms by events, device ms) of K3 and K4 and their variants on
    these inputs (``_time``); ``grads`` maps a name to an upstream gradient
    [N, L*2] as the caller hands it to K4 (a column slice is read in place;
    the replaced kernel gets a contiguous copy, timed apart).  Every kernel
    is launched straight through its C entry point into buffers allocated
    once: K3 stores into one output, K4's times are of its body, adding
    into a gradient zero-filled outside the timed loop."""
    libs = build()
    n, L = x01.shape[0], spec.num_levels
    stream = lambda: torch.cuda.current_stream(x01.device).cuda_stream
    level_args = hk._level_args(spec)
    args = hk._kernel_args(x01, spec)[1]
    shape = (L, spec.t_cap, 2)
    buf = torch.zeros(shape, device=x01.device)
    out = torch.empty((n, 2 * L), device=x01.device)

    def old(bwd, data, dst):
        rc = libs["old"].old_launch(bwd, x01.data_ptr(), data.data_ptr(), n, L, spec.t_cap,
                                    *level_args, dst.data_ptr(), stream())
        if rc != 0:
            raise RuntimeError(f"the replaced kernel failed: cudaError {rc}")

    def k3(name):
        lib = hk._lib() if name == "K3" else libs[name]
        fn = lib.tiled_launch if name == "tiled" else lib.hash_encode_forward
        rc = fn(x01.data_ptr(), table.data_ptr(), n, L, spec.t_cap, *level_args,
                out.data_ptr(), stream())
        if rc != 0:
            raise RuntimeError(f"K3 ({name}) failed: cudaError {rc}")

    def own(g, dst):
        rc = libs["own"].own_launch(x01.data_ptr(), g.data_ptr(), max(g.stride(0), g.shape[1]) // 2,
                                    n, L, spec.t_cap, *level_args, dst.data_ptr(), stream())
        if rc != 0:
            raise RuntimeError(f"K4's own body failed: cudaError {rc}")

    def shared(g, how, dst):
        ns, ctas, merge = how
        rc = libs["shared"].shared_launch(int(merge), x01.data_ptr(), g.data_ptr(),
                                          max(g.stride(0), g.shape[1]) // 2, n, L, spec.t_cap,
                                          *level_args, ns, ctas, dst.data_ptr(), stream())
        if rc == 0 and ns < L:
            rc = hk.launch_backward(hk._lib(), x01, g[:, 2 * ns:],
                                    hk._kernel_args(x01, levels_from(spec, ns))[1], dst[ns:])
        if rc != 0:
            raise RuntimeError(f"the shared variant {how} failed: cudaError {rc}")

    want = hk.hash_encode_forward(x01, table, spec)
    for run in (lambda: old(0, table, out), lambda: k3("unpaired"), lambda: k3("tiled")):
        out.zero_()
        run()
        if not torch.equal(out, want):
            raise RuntimeError("a K3 variant's output differs from K3's")
    ms = {"K3": _time(lambda: k3("K3")),
          "K3 (replaced)": _time(lambda: old(0, table, out)),
          "K3, a load for every corner": _time(lambda: k3("unpaired")),
          "K3, a tile walked level by level": _time(lambda: k3("tiled")),
          "K3, no gather": _time(lambda: k3("no gather"))}
    variants = shared_variants(spec)
    for gname, g in grads.items():
        want = hk.hash_encode_backward(x01, g, spec)
        gc = g.contiguous()
        got = {" (replaced)": torch.zeros(shape, device=x01.device),
               " (its own body)": torch.zeros(shape, device=x01.device)}
        old(1, gc, got[" (replaced)"])
        own(g, got[" (its own body)"])
        for vname, how in variants.items():
            got[vname] = torch.zeros(shape, device=x01.device)
            shared(g, how, got[vname])
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        for vname, gv in got.items():
            err = float((gv - want).abs().max())
            if err > 1e-4 * scale:
                raise RuntimeError(f"K4{vname} differs from K4 by {err} on the {gname} gradient "
                                   f"(largest entry {scale})")
        ms[f"K4 {gname}"] = _time(lambda: hk.launch_backward(hk._lib(), x01, g, args, buf))
        ms[f"K4 {gname} (replaced)"] = _time(lambda: old(1, gc, buf))
        ms[f"K4 {gname} (its own body before the shared skeleton)"] = _time(lambda: own(g, buf))
        if not g.is_contiguous():
            ms[f"K4 {gname} (replaced, its gradient copy)"] = _time(lambda: g.contiguous())
        for vname, how in variants.items():
            ms[f"K4 {gname}, {vname}"] = _time(lambda how=how: shared(g, how, buf))
    return ms


def finding(ms: dict, gname: str) -> str:
    """One line for one gradient, by device time: K4 against the replaced
    kernel (its gradient copy included) and against the shared variants."""
    k4 = ms[f"K4 {gname}"][1]
    if math.isnan(k4):
        return f"{gname} gradient: K4's device time was not recorded"
    old = (ms[f"K4 {gname} (replaced)"][1]
           + ms.get(f"K4 {gname} (replaced, its gradient copy)", (0.0, 0.0))[1])
    own = ms[f"K4 {gname} (its own body before the shared skeleton)"][1]
    parts = [f"K4 {k4:.4f} ms against the replaced {old:.4f} ({old / k4:.2f}x)",
             f"the shared skeleton costs {k4 - own:+.4f} ms against K4's own body"]
    rivals = {k[len(f"K4 {gname}, "):]: v[1] for k, v in ms.items()
              if k.startswith(f"K4 {gname}, ")}
    if rivals:
        best = min(rivals, key=rivals.get)
        parts.append("; ".join(f"{k} {v - k4:+.4f}" for k, v in rivals.items()))
        parts.append(f"fastest variant: {best} ({rivals[best]:.4f} ms)" if rivals[best] < k4
                     else "K4 is faster than every variant")
    return f"{gname} gradient (device time): " + "; ".join(parts)


def clustered(n: int, gen, dev, cells: int = 4) -> torch.Tensor:
    """n points in ``cells`` cells of the coarsest level (resolution 16):
    every corner add of a level-0 tile lands on a few entries."""
    base = torch.randint(0, 16, (cells, 3), generator=gen, device=dev).float()
    pick = torch.randint(0, cells, (n,), generator=gen, device=dev)
    x = (base[pick] + torch.rand((n, 3), generator=gen, device=dev)) / 16.0
    return x.clamp(0.0, 1.0).contiguous()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=393216)
    args = ap.parse_args()
    from flnerf_tpu_torch.ops import hash_lattice as hl
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    specs = {"2^15, 16 levels": hk.make_packed_spec(desired_resolution=4096),
             "2^19 small levels": hl.make_lattice_spec(desired_resolution=4096).split.small}
    for sname, spec in specs.items():
        table = torch.rand((spec.num_levels, spec.t_cap, 2), generator=gen, device=dev) * 2 - 1
        wide = torch.randn((args.n, 32), generator=gen, device=dev)
        rays = torch.arange(args.n, device=dev) // 96          # 96 kept samples a ray
        grads = {"dense": wide[:, :spec.output_dim],
                 "1 ray in 9": wide[:, :spec.output_dim] * (rays % 9 == 0)[:, None],
                 "zero": torch.zeros((args.n, spec.output_dim), device=dev)}
        for xname, x in (("uniform", torch.rand((args.n, 3), generator=gen, device=dev)),
                         ("clustered", clustered(args.n, gen, dev))):
            print(f"{sname}, {xname} points")
            ms = probe(x, table, spec, grads)
            for name, (ev, dt) in ms.items():
                print(f"  {ev:9.4f} ms by events, {dt:9.4f} ms of device time  {name}")
            for gname in grads:
                print("  " + finding(ms, gname))


if __name__ == "__main__":
    main()

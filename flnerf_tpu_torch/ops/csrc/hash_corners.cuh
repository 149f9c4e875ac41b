// The multiresolution hash grid's corner geometry, shared by the packed
// encode (csrc/hash_encode.cu: K3, K4) and the sorted engine's table
// gradient (csrc/hash_sorted.cu: K9): per level, the 8 trilinear corners of
// pos = x01*scale + 0.5, each indexed densely (x + S*(y + S*z)) or by
// torch-ngp's xor hash (x ^ y*P1 ^ z*P2, gridencoder.cu:55-70), modulo the
// level's size, with their weights; the warp merge of equal corners that
// K4, K7 and K9 apply before their atomic adds; and the tile skeleton of
// the table gradients K4 and K7 (tile_bwd_kernel, a template over the
// corner geometry: the packed one here, the lattice hash's in
// csrc/hash_lattice.cu).  The plain versions are
// flnerf_tpu_torch/ops/hash_kernel.py corner_indices_weights and, for the
// sorted engine's big levels, ops/hash_sorted.py corner_keys.
//
// The arithmetic of the position is __fmul_rn/__fadd_rn, so that no FMA
// contraction moves a point into another cell than the plain version's
// separate torch multiply and add.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hashgrid {

constexpr int kMaxLevels = 32;

struct Levels {
  float scale[kMaxLevels];
  uint32_t stride[kMaxLevels];   // resolution + 1 (align_corners=False)
  uint32_t size[kMaxLevels];     // table entries of the level
  int use_hash[kMaxLevels];
  int L;
  int t_cap;                     // entries per level in the [L, t_cap, 2] table
};

// The 8 corners of point x at level l: table row (within the level) and
// trilinear weight.  Corner c's offset along axis d is bit d of c.
__device__ __forceinline__ void level_corners(const float x[3], const Levels& lv, int l,
                                              uint32_t idx[8], float w[8]) {
  const float scale = lv.scale[l];
  float frac[3];
  uint32_t pg[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[d], scale), 0.5f);
    const float fl = floorf(pos);
    frac[d] = __fsub_rn(pos, fl);
    pg[d] = (uint32_t)(int)fl;
  }
  const uint32_t stride = lv.stride[l];
  const uint32_t size = lv.size[l];
  const bool hashed = lv.use_hash[l] != 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t b0 = c & 1, b1 = (c >> 1) & 1, b2 = (c >> 2) & 1;
    const uint32_t p0 = pg[0] + b0, p1 = pg[1] + b1, p2 = pg[2] + b2;
    w[c] = __fmul_rn(__fmul_rn(b0 ? frac[0] : __fsub_rn(1.f, frac[0]),
                               b1 ? frac[1] : __fsub_rn(1.f, frac[1])),
                     b2 ? frac[2] : __fsub_rn(1.f, frac[2]));
    const uint32_t i = hashed ? (p0 ^ (p1 * 2654435761u) ^ (p2 * 805459861u))
                              : (p0 + stride * (p1 + stride * p2));
    idx[c] = i % size;
  }
}

// One float2 added into device memory.
__device__ __forceinline__ void atomic_add2(float2* addr, float2 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(addr, v);   // per-component atomic (sm_90, global)
#else
  atomicAdd(&addr->x, v.x);
  atomicAdd(&addr->y, v.y);
#endif
}

// The mask of this warp's lanes below this lane.
__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Sums v over the lanes of `peers` (this lane's group, from match.any) onto
// the group's lowest lane, which is told so by `lead`.  Each round a lane
// adds the value of the next remaining peer above it, then the peers of odd
// rank drop out; log2 of the group's size rounds, none for a group of one.
// Every lane of the warp takes part (the shuffles are full-warp).
__device__ __forceinline__ float2 sum_peers(unsigned peers, float2 v, bool& lead) {
  const unsigned full = 0xffffffffu;
  unsigned rank = __popc(peers & lanemask_lt());
  lead = rank == 0;
  unsigned above = peers & ~(lanemask_lt() | (1u << (threadIdx.x & 31)));
  while (__any_sync(full, above != 0)) {
    const int next = __ffs(above);   // 1 + the next peer's lane, 0 if none
    const int src = next ? next - 1 : (int)(threadIdx.x & 31);
    const float ox = __shfl_sync(full, v.x, src);
    const float oy = __shfl_sync(full, v.y, src);
    if (next) {
      v.x += ox;
      v.y += oy;
    }
    above &= ~__ballot_sync(full, rank & 1);
    rank >>= 1;
  }
  return v;
}

// The packed table's geometry for tile_bwd_kernel: level l's entries are
// row l of the [L, t_cap, 2] table.
struct PackedGeo {
  Levels lv;
  __device__ __forceinline__ int levels() const { return lv.L; }
  __device__ __forceinline__ int64_t entries() const { return lv.t_cap; }
  __device__ __forceinline__ void corners(const float x[3], int l, uint32_t idx[8],
                                          float w[8]) const {
    level_corners(x, lv, l, idx, w);
  }
};

// ---- the tile skeleton of the table gradients K4 and K7 ----
//
// A CTA takes a tile of kTile consecutive points (the kept samples are
// ray-major, 96 to a ray: a 128-point tile is ~1.3 rays).  It stages the
// tile's upstream gradient rows in shared memory, read in place through
// the gradient's strides: element (point p, level l) is the float2 at
// grad[p * g_point + l * g_level].  With g_level == 1 (rows: K4's [N, L*2]
// gradient, or K7's column slice of the whole [N, L_all*2] one) a thread
// reads whole rows, in 16-byte loads where `vec` allows; otherwise
// (level-major, g_point == 1) the points run fastest.  The CTA lists the
// tile's live points (a nonzero gradient at any level) in order and leaves
// if there is none, so a dead point costs its gradient's bytes alone; it
// then stages x01, and a warp takes 32 consecutive live points of one level
// (the tasks are level-major: the warps of a CTA sweep a level together).
// With kMerge, per corner the warp merges lanes whose entries agree
// (match.any, sum_peers) and the group's lowest lane issues one global
// float2 atomic; ray neighbours share the coarse levels' cells, so the
// merge removes most of the contention there.  A zero gradient adds
// nothing anywhere: the result stays exactly zero.
//
// Geo gives levels(), entries() (the table's row length) and corners(x, l,
// idx, w): PackedGeo above, LatticeGeo in csrc/hash_lattice.cu.

constexpr int kTileThreads = 256;

__device__ __forceinline__ bool nonzero(float2 v) { return v.x != 0.f || v.y != 0.f; }

// A shared tile row of `cols` float2, padded to an odd count: the same
// column of 16 consecutive rows then falls in 16 distinct bank pairs.
__host__ __device__ constexpr int padded(int cols) { return cols | 1; }

template <class Geo, int kTile, bool kMerge>
__global__ void __launch_bounds__(kTileThreads)
tile_bwd_kernel(const float* __restrict__ x01, const float2* __restrict__ grad,
                int64_t g_point, int64_t g_level, int64_t n, Geo geo, int vec,
                float2* __restrict__ grad_table) {
  static_assert(kTile % 32 == 0 && kTile <= kTileThreads, "a thread a point when listing");
  constexpr int kWarps = kTileThreads / 32;
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ float2 gs[];     // [kTile][padded(L)]
  __shared__ float xs[kTile * 3];
  __shared__ int live_list[kTile];
  __shared__ int warp_live[kTile / 32];
  const int L = geo.levels(), s = padded(L);
  const int64_t p0 = (int64_t)blockIdx.x * kTile;
  const int np = (int)(n - p0 < kTile ? n - p0 : kTile);
  const float2* g0 = grad + p0 * g_point;
  if (g_level != 1) {   // level-major: the points run fastest
    for (int j = threadIdx.x; j < np * L; j += kTileThreads) {
      const int c = j / np, r = j - c * np;
      gs[r * s + c] = __ldg(g0 + r * g_point + c * g_level);
    }
  } else if (vec) {     // rows, L even, 16-byte aligned
    const int h = L / 2;
    for (int j = threadIdx.x; j < np * h; j += kTileThreads) {
      const int r = j / h, c = 2 * (j - r * h);
      const float4 v = __ldg(reinterpret_cast<const float4*>(g0 + r * g_point + c));
      gs[r * s + c] = make_float2(v.x, v.y);
      gs[r * s + c + 1] = make_float2(v.z, v.w);
    }
  } else {
    for (int j = threadIdx.x; j < np * L; j += kTileThreads) {
      const int r = j / L, c = j - r * L;
      gs[r * s + c] = __ldg(g0 + r * g_point + c);
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
  for (int j = threadIdx.x; j < np * 3; j += kTileThreads) xs[j] = __ldg(x01 + p0 * 3 + j);
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
      geo.corners(x, l, idx, w);
    }
    float2* gt = grad_table + (int64_t)l * geo.entries();
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float2 v = on ? make_float2(__fmul_rn(w[c], g.x), __fmul_rn(w[c], g.y))
                    : make_float2(0.f, 0.f);
      if (kMerge) {
        bool lead;
        const int key = on ? (int)idx[c] : -1 - lane;   // a dead lane keys itself apart
        v = sum_peers(__match_any_sync(kFull, key), v, lead);
        if (lead && nonzero(v)) atomic_add2(gt + idx[c], v);
      } else if (on && nonzero(v)) {
        atomic_add2(gt + idx[c], v);
      }
    }
  }
}

// Launches tile_bwd_kernel on n >= 1 points of L levels (L the geometry's
// level count); returns the cudaError_t of the launch.  The dynamic shared
// memory, kTile * padded(L) float2, is at most 66 KB (256 points, 32
// levels) beside up to 4 KB of static arrays; past 32 KB of it the opt-in
// beyond a block's default 48 KB is set here (128-point tiles never need
// it: 33 KB at 32 levels).
template <class Geo, int kTile = 128, bool kMerge = true>
int launch_tile_bwd(const float* x01, const float2* grad, int64_t g_point, int64_t g_level,
                    int64_t n, int L, const Geo& geo, float2* grad_table,
                    cudaStream_t stream) {
  const int smem = kTile * padded(L) * (int)sizeof(float2);
  if (smem > 34 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(tile_bwd_kernel<Geo, kTile, kMerge>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = g_level == 1 && L % 2 == 0 && g_point % 2 == 0 &&
                  reinterpret_cast<uintptr_t>(grad) % 16 == 0;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile));
  tile_bwd_kernel<Geo, kTile, kMerge><<<grid, kTileThreads, smem, stream>>>(
      x01, grad, g_point, g_level, n, geo, vec, grad_table);
  return (int)cudaGetLastError();
}

// The host arrays of L levels -> Levels; cudaErrorInvalidValue for L
// outside [1, kMaxLevels].
inline int make_levels(int L, int t_cap, const float* scales, const uint32_t* strides,
                       const uint32_t* sizes, const int* use_hash, Levels& lv) {
  if (L < 1 || L > kMaxLevels || t_cap < 1) return (int)cudaErrorInvalidValue;
  lv.L = L;
  lv.t_cap = t_cap;
  for (int l = 0; l < L; ++l) {
    lv.scale[l] = scales[l];
    lv.stride[l] = strides[l];
    lv.size[l] = sizes[l];
    lv.use_hash[l] = use_hash[l];
  }
  return 0;
}

}  // namespace hashgrid

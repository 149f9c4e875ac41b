// The multiresolution hash grid's corner geometry, shared by the packed
// encode (csrc/hash_encode.cu: K3, K4) and the sorted engine's table
// gradient (csrc/hash_sorted.cu: K9): per level, the 8 trilinear corners of
// pos = x01*scale + 0.5, each indexed densely (x + S*(y + S*z)) or by
// torch-ngp's xor hash (x ^ y*P1 ^ z*P2, gridencoder.cu:55-70), modulo the
// level's size, with their weights; and the warp merge of equal corners
// that K4 and K9 apply before their atomic adds.  The plain versions are
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

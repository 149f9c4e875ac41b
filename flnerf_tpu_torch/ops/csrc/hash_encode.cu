// Multiresolution hash encoding for Instant-NGP: forward (K3) and table
// gradient (K4).
//
// Replaces the TPU kernels in flnerf_tpu/ops/hash_pallas.py:
//   K3  _fwd_kernel (hash_pallas.py:142, via hash_encode_pallas at :281)
//   K4  _bwd_kernel (hash_pallas.py:185, via _hash_encode_bwd at :328)
// They compute WHAT those compute, the packed-table encode of
// hash_encode_xla (hash_pallas.py:349-369): per level, the 8 trilinear
// corners of pos = x01*scale + 0.5, each indexed densely or by the xor hash
// of gridencoder.cu:55-70, summed with their weights into [N, L*C]; and the
// gradient of that sum with respect to the table.  None of the TPU
// machinery is carried over: the one-hot MXU matmuls exist there only
// because TPU gather and scatter are slow (hash_pallas.py:3-20), and the
// TPU kernel's per-level VMEM accumulator (acc_ref, :185) has no
// counterpart: its Hopper form, the coarse levels' gradient summed in
// shared memory by a few CTAs and flushed with one atomic per touched
// entry, measured slower than the warp merge below on every input
// (flnerf_tpu_torch/tools/hash_probe.py, PERF.md).  The plain version is
// flnerf_tpu_torch/ops/hash_kernel.py hash_encode_plain.
//
// Layout: the table is [L, T_cap, 2] f32, the natural layout
// hash_encode_xla gathers from (hash_pallas.py:366); entry t of level l is
// one 8-byte float2.  x01 is [N, 3] f32 in [0, 1]; the output is [N, L*2]
// f32; the upstream gradient is [N, L*2] f32 rows at any even stride (the
// 2^19 engines hand the small levels a column slice of the whole gradient,
// read in place).  The corner geometry (csrc/hash_corners.cuh
// level_corners, shared with the sorted engine's K9) does the position
// arithmetic with __fmul_rn/__fadd_rn, so that no FMA contraction moves a
// point into another cell than the plain version's.
//
// What bounds them on this card.  The bytes that must move are x01, the
// [N, L*2] output or gradient and the touched table entries: ~55 MB at
// 2^15 (16 levels x 393,216 points), 0.017 ms at 3.35 TB/s.  What the card
// pays instead:
// - K3: 8 scattered 8-byte corner reads per (point, level), 50 M at that
//   shape, each a 32-byte sector from L2 (the 4.2 MB table stays in the
//   50 MB L2): ~1.6 GB of L2 traffic; and the corner geometry (per lane
//   another level's parameters, 8 integer modulos), which overlaps the
//   loads: without its loads K3 keeps ~3/4 of its time (the probe).
// - K4: the atomics, above all on the dense coarse levels (17^3 and 25^3
//   cells), where the samples of a ray land on the same corners.
//
// K3 (hash_fwd_kernel): one thread per (point, level), level fastest, so a
// warp covers 2 points x 16 levels and writes 256 contiguous bytes of the
// output.  At a hashed level of 2^k entries the x-neighbour corners of an
// even cell x are the two halves of one aligned 16-byte pair (x + 1 = x ^
// 1 flips bit 0 of the hash), which one load fetches: a quarter fewer L2
// requests there.  Where no level is hashed (the 2^19 engines' two small
// levels) the branch is compiled out.  A walk of a tile level by level (a
// warp takes 32 ray neighbours through every level and stores its rows
// through shared memory) shares coarse sectors within a gather but
// measured slower on the train batch; the probe keeps it.
//
// K4 (csrc/hash_corners.cuh tile_bwd_kernel on PackedGeo, the skeleton it
// shares with the lattice engine's K7): a CTA takes a tile of 128
// consecutive points (the kept samples are ray-major, 96 to a ray: ~1.3
// rays).  It stages the tile's gradient rows in shared memory (16-byte
// loads where the rows allow, read in place through the row stride), lists
// the tile's live points (a nonzero gradient at any level) in order and
// leaves if there is none, so a dead point costs its gradient's bytes
// alone; it then stages x01, and a warp takes 32 consecutive live points of
// one level.  Per corner the warp merges lanes with equal entries
// (__match_any_sync, shuffle sums onto the lowest lane; sum_peers) and the
// leader issues one global float2 atomic per distinct entry.  Ray
// neighbours share the coarse levels' cells, so the merge removes most of
// the contention there.  A zero gradient adds nothing anywhere: the result
// stays exactly zero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_corners.cuh"   // Levels, level_corners, make_levels, PackedGeo, launch_tile_bwd

namespace {

using hashgrid::Levels;
using hashgrid::level_corners;
using hashgrid::make_levels;

constexpr int kThreads = 256;         // K3: threads a CTA

// The table entries a and b of corners c and c + 1, which differ in x
// only.  At a hashed level of 2^k entries an even cell x has x + 1 = x ^ 1,
// so a and b differ in bit 0 alone: the two halves of one aligned 16-byte
// pair, which one load fetches.  The dense levels' tables are small and
// stay in L1, where the branch costs more than the second load saves, so
// `pair` is false there.
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

// kPair: some level is hashed (else the pair branch is compiled out).
template <bool kPair>
__global__ void __launch_bounds__(kThreads)
hash_fwd_kernel(const float* __restrict__ x01, const float2* __restrict__ table, int64_t n,
                Levels lv, float2* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;   // (point, level), level fastest
  if (i >= n * lv.L) return;
  const int64_t p = i / lv.L;
  const int l = (int)(i - p * lv.L);
  const float* xp = x01 + p * 3;
  const float x[3] = {__ldg(xp), __ldg(xp + 1), __ldg(xp + 2)};
  uint32_t idx[8];
  float w[8];
  level_corners(x, lv, l, idx, w);
  const float2* tab = table + (int64_t)l * lv.t_cap;
  const bool pair = kPair && lv.use_hash[l] != 0;
  float2 f[8];
#pragma unroll
  for (int c = 0; c < 8; c += 2) load_pair(tab, idx[c], idx[c + 1], pair, f[c], f[c + 1]);
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int c = 0; c < 8; ++c) {   // corner order, as the plain version sums
    acc.x = __fadd_rn(acc.x, __fmul_rn(w[c], f[c].x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(w[c], f[c].y));
  }
  out[i] = acc;   // [N, L, 2] == [N, L*2]: a warp writes 256 contiguous bytes
}

}  // namespace

extern "C" {

// K3.  x01 [n, 3], table [L, t_cap, 2] and out [n, L*2] are device memory;
// scales, strides, sizes and use_hash are host arrays of L entries.
// Returns the cudaError_t of the launch (0 on success).
int hash_encode_forward(const float* x01, const float* table, long long n, int L,
                        int t_cap, const float* scales, const uint32_t* strides,
                        const uint32_t* sizes, const int* use_hash, float* out,
                        void* stream) {
  Levels lv;
  const int err = make_levels(L, t_cap, scales, strides, sizes, use_hash, lv);
  if (err != 0) return err;
  if (n < 1) return (int)cudaErrorInvalidValue;
  bool hashed = false;
  for (int l = 0; l < L; ++l) hashed |= use_hash[l] != 0;
  const dim3 grid((unsigned)((n * L + kThreads - 1) / kThreads));
  const auto kernel = hashed ? hash_fwd_kernel<true> : hash_fwd_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(table), (int64_t)n, lv,
      reinterpret_cast<float2*>(out));
  return (int)cudaGetLastError();
}

// K4.  grad_out holds the upstream gradient's rows, [n, L*2] f32 with row
// p at grad_out + 2 * p * g_row (g_row >= L float2; a column slice of a
// wider gradient is read in place); grad_table [L, t_cap, 2] must be
// zero-filled (or hold a gradient to add to) and is accumulated
// atomically.
int hash_encode_backward(const float* x01, const float* grad_out, long long g_row,
                         long long n, int L, int t_cap, const float* scales,
                         const uint32_t* strides, const uint32_t* sizes, const int* use_hash,
                         float* grad_table, void* stream) {
  Levels lv;
  const int err = make_levels(L, t_cap, scales, strides, sizes, use_hash, lv);
  if (err != 0) return err;
  if (n < 1 || g_row < L) return (int)cudaErrorInvalidValue;
  return hashgrid::launch_tile_bwd(x01, reinterpret_cast<const float2*>(grad_out),
                                   (int64_t)g_row, 1, (int64_t)n, L, hashgrid::PackedGeo{lv},
                                   reinterpret_cast<float2*>(grad_table), (cudaStream_t)stream);
}

}  // extern "C"

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
// because TPU gather and scatter are slow (hash_pallas.py:3-20).  Here a
// gather is a load and a scatter is an atomic add.  The plain version is
// flnerf_tpu_torch/ops/hash_kernel.py hash_encode_plain.
//
// Layout: the table is [L, T_cap, 2] f32, the natural layout
// hash_encode_xla gathers from (hash_pallas.py:366); entry t of level l is
// one 8-byte float2.  x01 is [N, 3] f32 in [0, 1]; the output and the
// upstream gradient are [N, L*2] f32.
//
// Design: one thread per (point, level), level fastest, so a warp covers 2
// points x 16 levels: it reads the points' coordinates once (broadcast) and
// writes (K3) or reads (K4) 256 contiguous bytes of [N, L*2].  Each thread
// computes its level's 8 corner indices and weights in registers (the
// reference's corner_indices_weights, fused; csrc/hash_corners.cuh, which
// the sorted engine's K9 shares), then:
//   K3 gathers the 8 corners as one float2 load each and sums them;
//   K4 adds w*g into the zero-filled gradient with one float2 atomicAdd per
//      corner (per-component atomic, Hopper, global memory), and skips a
//      point whose upstream gradient is zero (masked samples), which adds
//      exactly nothing.
// The arithmetic of the position is __fmul_rn/__fadd_rn so that no FMA
// contraction moves a point into another cell than the plain version's
// separate torch multiply and add.
//
// What bounds it on this card: the gathers.  At the NGP train step's shape
// (393,216 points x 16 levels x 8 corners = 50.3 M corner reads or atomics)
// the 4.2 MB table stays in the 50 MB L2, so device memory sees only x01,
// the 50.3 MB output (K3) or upstream gradient (K4) and the table once; the
// L2 sees 50.3 M scattered 8-byte accesses, one 32-byte sector each.  The
// dense coarse levels (level 0 has 17^3 entries) make K4's atomics collide
// heavily.  Not done yet: shared-memory aggregation of the coarse levels'
// gradients, warp-level merging of equal indices.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_corners.cuh"   // Levels, level_corners, atomic_add2, make_levels

namespace {

using hashgrid::Levels;
using hashgrid::atomic_add2;
using hashgrid::level_corners;
using hashgrid::make_levels;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hash_fwd_kernel(const float* __restrict__ x01, const float2* __restrict__ table,
                int64_t n, Levels lv, float2* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n * lv.L) return;
  const int64_t p = i / lv.L;
  const int l = (int)(i - p * lv.L);
  const float x[3] = {x01[p * 3], x01[p * 3 + 1], x01[p * 3 + 2]};
  uint32_t idx[8];
  float w[8];
  level_corners(x, lv, l, idx, w);
  const float2* tab = table + (int64_t)l * lv.t_cap;
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float2 f = __ldg(tab + idx[c]);
    acc.x = __fadd_rn(acc.x, __fmul_rn(w[c], f.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(w[c], f.y));
  }
  out[i] = acc;   // [N, L, 2] == [N, L*2]
}

__global__ void __launch_bounds__(kThreads)
hash_bwd_kernel(const float* __restrict__ x01, const float2* __restrict__ grad_out,
                int64_t n, Levels lv, float2* __restrict__ grad_table) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n * lv.L) return;
  const float2 g = grad_out[i];
  if (g.x == 0.f && g.y == 0.f) return;   // adds exactly nothing
  const int64_t p = i / lv.L;
  const int l = (int)(i - p * lv.L);
  const float x[3] = {x01[p * 3], x01[p * 3 + 1], x01[p * 3 + 2]};
  uint32_t idx[8];
  float w[8];
  level_corners(x, lv, l, idx, w);
  float2* gt = grad_table + (int64_t)l * lv.t_cap;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    atomic_add2(gt + idx[c], make_float2(__fmul_rn(w[c], g.x), __fmul_rn(w[c], g.y)));
  }
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
  const int64_t threads = (int64_t)n * L;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  hash_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(table), (int64_t)n, lv,
      reinterpret_cast<float2*>(out));
  return (int)cudaGetLastError();
}

// K4.  grad_out [n, L*2] is the upstream gradient; grad_table [L, t_cap, 2]
// must be zero-filled (or hold a gradient to add to) and is accumulated
// atomically.
int hash_encode_backward(const float* x01, const float* grad_out, long long n, int L,
                         int t_cap, const float* scales, const uint32_t* strides,
                         const uint32_t* sizes, const int* use_hash,
                         float* grad_table, void* stream) {
  Levels lv;
  const int err = make_levels(L, t_cap, scales, strides, sizes, use_hash, lv);
  if (err != 0) return err;
  const int64_t threads = (int64_t)n * L;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  hash_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(grad_out), (int64_t)n, lv,
      reinterpret_cast<float2*>(grad_table));
  return (int)cudaGetLastError();
}

}  // extern "C"

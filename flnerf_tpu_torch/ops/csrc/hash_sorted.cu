// The sorted hash engine's big-level encode: forward (K8) and table
// gradient (K9) over locality-sorted (corner entry, corner slot) pairs.
//
// Replaces the TPU kernels in flnerf_tpu/ops/hash_sorted.py:
//   K8  _fused_fwd_kernel (hash_sorted.py:261, called at :489)
//   K9  _fused_bwd_kernel (hash_sorted.py:340, called at :554)
// They compute WHAT hash_encoding.hash_encode computes on the big levels
// (hash_encode_xla on _big_packed_spec, the reference's CPU path,
// hash_sorted.py:627): per big level l, the 8 trilinear corners of
// pos = x01*scale + 0.5, indexed by torch-ngp's xor hash or densely
// (gridencoder.cu:55-70), summed with their weights into [N, L*2]; and the
// gradient of that sum with respect to the table.  None of the TPU
// machinery is carried over: the VMEM slabs, the one-hot MXU fetch and
// point-scatter matmuls, the bf16 slabs and bf16 w*feature, the 15-bit
// weights in the payload, and the head/tail slab spill exist there because
// TPU gathers and scatters are slow.  Here a gather is a load and a scatter
// an atomic add, so the table and the weights are f32 and no corner is ever
// dropped.  The plain version is flnerf_tpu_torch/ops/hash_kernel.py
// hash_encode_plain on the big levels' packed spec.
//
// Inputs: the big table [L, t, 2] f32 (entry e of level l is one 8-byte
// float2); x01 [n, 3] f32 in [0, 1]; the output and the upstream gradient
// [n, L*2] f32; pairs [rows, m, 2] int32 (one int2 each), rows = chunks * L:
// row ch*L + l holds the corners of chunk ch's points (points
// [ch*per, ch*per + per)) at level l, sorted by key (K5), as (key = the
// corner's table entry within the level, payload = p_local*8 + corner);
// pads carry a key outside [0, t).  The keys come from torch
// (ops/hash_sorted.py corner_keys); the kernels recompute only the weights.
//
// Design: one thread per (row, slot), so a warp walks 32 consecutive sorted
// corners of one level (m is a multiple of 32).  Each thread decodes its
// pair, recomputes its corner's weight from x01 (__fmul_rn/__fadd_rn, so no
// FMA contraction moves a point into another cell than the plain version's
// separate torch multiply and add), then
//   K8 gathers the float2 entry and atomically adds w*f into the zero-filled
//      output at [p, l] (each output receives its point's 8 corners);
//   K9 reads the upstream gradient at [p, l] and adds w*g into the gradient
//      at [l, key].  Equal keys are adjacent after the sort, so with
//      `aggregate` a warp first sums each run of equal keys (a segmented
//      scan by shuffles over the warp's runs, found with a ballot) and the
//      run's last lane issues one float2 atomic; without it every corner
//      issues its own.  The runs are found from adjacency, so any order of
//      the pairs gives the right sum; the sort makes the runs long.
// What bounds them on this card: the scattered 8-byte accesses.  At the
// 2^19 train step (393,216 points x 14 levels x 8 corners = 44 M pairs,
// 352 MB) K8 and K9 each stream the pairs once and make 44 M scattered
// accesses to the 44 MB [n, L*2] array (atomics in K8, reads in K9) and 44 M
// to the 58.7 MB table (reads in K8, atomics in K9, fewer with aggregation),
// beside 44 M scattered 12-byte x01 reads that stay in L2.  The sort gives
// the table side locality (a warp's keys are nearby entries) and takes it
// from the point side (a warp's corners belong to points far apart).  Not
// done yet: keeping a chunk's [per, L*2] outputs in shared memory, which the
// chunking would allow (16,384 points x 14 levels x 8 B = 1.8 MB does not
// fit; a level at a time, 128 KB, would).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;

struct Walk {
  float scale[kMaxLevels];
  int L;
  int t;          // entries per level in the table
  int64_t n;      // points
  int64_t per;    // points per chunk
  int64_t m;      // slots per row
  int64_t total;  // rows * m
};

// Trilinear weight of corner c (offset along axis d = bit d of c) of point
// p at a level of the given scale.
__device__ __forceinline__ float corner_weight(const float* __restrict__ x01, int64_t p,
                                               float scale, int c) {
  float w[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x01[p * 3 + d], scale), 0.5f);
    const float frac = __fsub_rn(pos, floorf(pos));
    w[d] = ((c >> d) & 1) ? frac : __fsub_rn(1.f, frac);
  }
  return __fmul_rn(__fmul_rn(w[0], w[1]), w[2]);
}

// Slot i's level l and, for a real corner, its key, point p and corner c;
// returns false for a pad (key outside the table) or a slot past the points.
__device__ __forceinline__ bool decode(const int2* __restrict__ pairs, int64_t i,
                                       const Walk& wk, int& l, int& key, int64_t& p, int& c) {
  const int64_t row = i / wk.m;
  l = (int)(row % wk.L);
  const int2 kp = pairs[i];
  if (kp.x < 0 || kp.x >= wk.t || kp.y < 0) return false;
  const int64_t pl = kp.y >> 3;
  p = (row / wk.L) * wk.per + pl;
  if (pl >= wk.per || p >= wk.n) return false;
  key = kp.x;
  c = kp.y & 7;
  return true;
}

__device__ __forceinline__ void atomic_add2(float2* addr, float2 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(addr, v);   // per-component atomic (sm_90, global)
#else
  atomicAdd(&addr->x, v.x);
  atomicAdd(&addr->y, v.y);
#endif
}

__global__ void __launch_bounds__(kThreads)
sorted_fwd_kernel(const float* __restrict__ x01, const float2* __restrict__ table,
                  const int2* __restrict__ pairs, Walk wk, float2* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= wk.total) return;
  int l, key, c;
  int64_t p;
  if (!decode(pairs, i, wk, l, key, p, c)) return;
  const float w = corner_weight(x01, p, wk.scale[l], c);
  const float2 f = __ldg(table + (int64_t)l * wk.t + key);
  atomic_add2(out + p * wk.L + l, make_float2(__fmul_rn(w, f.x), __fmul_rn(w, f.y)));
}

template <bool kAggregate>
__global__ void __launch_bounds__(kThreads)
sorted_bwd_kernel(const float* __restrict__ x01, const float2* __restrict__ grad_out,
                  const int2* __restrict__ pairs, Walk wk, float2* __restrict__ grad_table) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int l = 0, key = -1, c = 0;
  int64_t p = 0;
  float2 v = make_float2(0.f, 0.f);
  if (i < wk.total && decode(pairs, i, wk, l, key, p, c)) {
    const float2 g = grad_out[p * wk.L + l];
    if (g.x != 0.f || g.y != 0.f) {   // a zero gradient adds exactly nothing
      const float w = corner_weight(x01, p, wk.scale[l], c);
      v = make_float2(__fmul_rn(w, g.x), __fmul_rn(w, g.y));
    }
  }
  float2* gt = grad_table + (int64_t)l * wk.t;
  if (!kAggregate) {
    if (key >= 0 && (v.x != 0.f || v.y != 0.f)) atomic_add2(gt + key, v);
    return;
  }
  // The warp lies in one row (m % 32 == 0), so one level.  Runs of equal
  // adjacent keys: run id = number of run heads up to this lane.  Every
  // lane takes part in the shuffles (no early return above).
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(full, key, 1);
  const unsigned heads = __ballot_sync(full, lane == 0 || prev != key);
  const int run = __popc(heads & (full >> (31 - lane)));
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {   // segmented inclusive scan
    const float ux = __shfl_up_sync(full, v.x, off);
    const float uy = __shfl_up_sync(full, v.y, off);
    const int ur = __shfl_up_sync(full, run, off);
    if (lane >= off && ur == run) {
      v.x += ux;
      v.y += uy;
    }
  }
  const int next = __shfl_down_sync(full, run, 1);
  if ((lane == 31 || next != run) && key >= 0 && (v.x != 0.f || v.y != 0.f))
    atomic_add2(gt + key, v);   // the run's last lane holds the run's sum
}

int make_walk(long long n, long long per, long long rows, long long m, int L, long long t,
              const float* scales, Walk& wk) {
  if (L < 1 || L > kMaxLevels || t < 1 || t >= (1LL << 31) || n < 1 || per < 1 ||
      rows < L || rows % L != 0 || m < 32 || m % 32 != 0 || m < 8 * per ||
      (rows / L) * per < n)
    return (int)cudaErrorInvalidValue;
  wk.L = L;
  wk.t = (int)t;
  wk.n = n;
  wk.per = per;
  wk.m = m;
  wk.total = rows * m;
  for (int l = 0; l < L; ++l) wk.scale[l] = scales[l];
  return 0;
}

dim3 grid_of(const Walk& wk) {
  return dim3((unsigned)((wk.total + kThreads - 1) / kThreads));
}

}  // namespace

extern "C" {

// K8.  x01 [n, 3], table [L, t, 2], pairs [rows, m, 2] and out [n, L*2]
// are device memory; scales [L] is a host array.  out must be zero-filled
// (or hold features to add to) and is accumulated atomically.  Returns the
// cudaError_t of the launch (0 on success).
int sorted_encode_forward(const float* x01, const float* table, const int* pairs, long long n,
                          long long per, long long rows, long long m, int L, long long t,
                          const float* scales, float* out, void* stream) {
  Walk wk;
  const int err = make_walk(n, per, rows, m, L, t, scales, wk);
  if (err != 0) return err;
  sorted_fwd_kernel<<<grid_of(wk), kThreads, 0, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(table), reinterpret_cast<const int2*>(pairs), wk,
      reinterpret_cast<float2*>(out));
  return (int)cudaGetLastError();
}

// K9.  grad_out [n, L*2] is the upstream gradient; grad_table [L, t, 2]
// must be zero-filled (or hold a gradient to add to) and is accumulated
// atomically; aggregate != 0 sums each warp's runs of equal keys first.
int sorted_encode_backward(const float* x01, const float* grad_out, const int* pairs,
                           long long n, long long per, long long rows, long long m, int L,
                           long long t, const float* scales, int aggregate, float* grad_table,
                           void* stream) {
  Walk wk;
  const int err = make_walk(n, per, rows, m, L, t, scales, wk);
  if (err != 0) return err;
  const float2* g = reinterpret_cast<const float2*>(grad_out);
  const int2* pr = reinterpret_cast<const int2*>(pairs);
  float2* gt = reinterpret_cast<float2*>(grad_table);
  if (aggregate)
    sorted_bwd_kernel<true><<<grid_of(wk), kThreads, 0, (cudaStream_t)stream>>>(x01, g, pr, wk, gt);
  else
    sorted_bwd_kernel<false><<<grid_of(wk), kThreads, 0, (cudaStream_t)stream>>>(x01, g, pr, wk, gt);
  return (int)cudaGetLastError();
}

}  // extern "C"

// The sorted hash engine's big-level encode: forward (K8) over
// locality-sorted (corner entry, corner slot) pairs, and table gradient (K9)
// recomputed from the points.
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
// [n, L*2] f32.  K8 also takes pairs [rows, m, 2] int32 (one int2 each),
// rows = chunks * L: row ch*L + l holds the corners of chunk ch's points
// (points [ch*per, ch*per + per)) at level l, sorted by key (K5), as (key =
// the corner's table entry within the level, payload = p_local*8 + corner);
// pads carry a key outside [0, t).  The keys come from torch
// (ops/hash_sorted.py corner_keys); K8 recomputes only the weights.
//
// K8 design: one (chunk, level) row per thread-block cluster of 8 CTAs.
// A pair's payload names its own (point, corner) slot, and each slot
// receives exactly one term, so no sum needs an atomic: CTA r of the
// cluster owns points [r*per_c, (r+1)*per_c) of the chunk (per_c = per / 8)
// with their 8 corner slots, a [8, per_c] float2 array in its shared memory
// (128 KB at per = 16,384; the row's 1 MB of slots is what sets the cluster
// at 8, the most a portable cluster holds), and walks 1/8 of the row's
// pairs.  Each thread decodes 4 pairs at once, recomputes each corner's
// weight from x01 (__fmul_rn/__fadd_rn, so no FMA contraction moves a point
// into another cell than the plain version's separate torch multiply and
// add), gathers the float2 table entry, and stores w*f into the owning
// CTA's slot through distributed shared memory (a plain store; remote for 7
// pairs in 8).  After a cluster barrier each CTA sums its points' 8 slots in
// corner order and writes [p, l] once: stored into an uninitialised output,
// or added to a given one, since each (p, l) has one owner.  So there is no
// zero-fill, no global atomic and no shared-memory atomic (an f32 add on
// shared memory, local or remote, is far slower on this card than a store:
// PERF.md).  The sum is deterministic.
// K9 design: no pairs.  One thread per (point, level) reads the upstream
// gradient at [p, l] once (in place, from the rows of the whole [N, L_all*2]
// gradient: no copy of the big levels' columns) and, if it is zero (89% of the points of a 2^19
// train step), adds exactly nothing and touches nothing else; a warp whose
// 32 gradients are all zero leaves at once.  A live thread reads its
// point's x01, recomputes its 8 corner entries and weights
// (csrc/hash_corners.cuh level_corners, the function of K3/K4 and of
// corner_keys) and adds w*g into the zero-filled gradient with one float2
// atomic per corner.  With `merge`, the warp first merges equal corners:
// per corner, __match_any_sync groups the lanes whose (level, entry) agree,
// the group's sum is reduced onto its lowest lane by shuffles (log2 of the
// group's size rounds), and that lane alone issues the atomic; ray-
// neighbouring points share the cells of the dense and coarse levels.  The
// grid's shape is the caller's: level fastest (a warp is ~2 points x 14
// levels: the gradient is read coalesced, a dead point skips all its levels
// at once) or level-major (a warp is 32 consecutive points of one level,
// the point count padded to whole warps: one level's gradient slice stays in
// L2 for the atomics, and the merge sees 32 ray neighbours).
// What bounds them on this card: the scattered 8-byte accesses.  At the
// 2^19 train step (393,216 points x 14 levels x 8 corners = 44 M corners)
// K8 streams the 352 MB of pairs once (0.105 ms alone) and makes 44 M
// scattered accesses to the 58.7 MB table and 44 M scattered 12-byte x01
// reads that stay in L2; its 44 M terms go to shared memory, and the output
// is written once, [p, l] by [p, l].  The sort gives the table side
// locality (a warp's keys are nearby entries) and takes it from the point
// side (a warp's corners belong to points far apart), which the cluster's
// shared memory absorbs for K8.  K9 reads the 44 MB gradient once and makes
// 8 atomics for each live (point, level) only, fewer where the merge finds
// equal corners; streaming the pairs and reading the gradient at each of
// the 44 M sorted corners, as its sorted-pair design did, cost more than
// the sorted runs saved (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_corners.cuh"   // Levels, level_corners, atomic_add2, make_levels

namespace cg = cooperative_groups;

namespace {

using hashgrid::kMaxLevels;
using hashgrid::Levels;
using hashgrid::atomic_add2;
using hashgrid::level_corners;
using hashgrid::sum_peers;

constexpr int kThreads = 256;       // K9: threads a block
constexpr int kUnroll = 4;          // K8: pairs a thread walks at once
constexpr int kPointCap = 1 << 14;  // K8: points a chunk (ops/hash_sorted.py POINT_CAP)
constexpr int kCluster = 8;         // K8: CTAs a row (ops/hash_sorted.py CLUSTER)
constexpr int kFwdThreads = 1024;   // K8: threads a CTA (one CTA an SM at 128 KB)

struct Walk {      // K8's pairs
  float scale[kMaxLevels];
  int L;
  int t;          // entries per level in the table
  int64_t n;      // points
  int64_t per;    // points per chunk
  int64_t m;      // slots per row
};

// Trilinear weight of corner c (offset along axis d = bit d of c) of the
// point x at a level of the given scale.
__device__ __forceinline__ float weight_of(const float x[3], float scale, int c) {
  float w[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[d], scale), 0.5f);
    const float frac = __fsub_rn(pos, floorf(pos));
    w[d] = ((c >> d) & 1) ? frac : __fsub_rn(1.f, frac);
  }
  return __fmul_rn(__fmul_rn(w[0], w[1]), w[2]);
}

// The terms w * f of kUnroll pairs and their points' indices within the
// chunk (-1 for a pad or a slot past the points).  Every load is issued
// whatever the pair (indices clamped into range), so the kUnroll chains of
// pair -> x01 and table loads overlap instead of running one after another.
__device__ __forceinline__ void fwd_terms(const float* __restrict__ x01,
                                          const float2* __restrict__ tab, const int2* kp,
                                          int64_t p0, float scale, const Walk& wk, int* pl,
                                          float2* v) {
  int64_t p[kUnroll];
  int key[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int q = kp[u].y >> 3;
    const bool ok = kp[u].x >= 0 && kp[u].x < wk.t && kp[u].y >= 0 && q < wk.per &&
                    p0 + q < wk.n;
    pl[u] = ok ? q : -1;
    p[u] = ok ? p0 + q : 0;
    key[u] = ok ? kp[u].x : 0;
  }
  float x[kUnroll][3];
  float2 f[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
    for (int d = 0; d < 3; ++d) x[u][d] = __ldg(x01 + p[u] * 3 + d);
    f[u] = __ldg(tab + key[u]);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const float w = weight_of(x[u], scale, kp[u].y & 7);
    v[u] = make_float2(__fmul_rn(w, f[u].x), __fmul_rn(w, f[u].y));
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kFwdThreads)
sorted_fwd_kernel(const float* __restrict__ x01, const float2* __restrict__ table,
                  const int2* __restrict__ pairs, Walk wk, int per_c, int accumulate,
                  float2* __restrict__ out) {
  // [8][per_c]: corner c of this CTA's point i at c * per_c + i (corner-major,
  // so the sum below reads consecutive slots across a warp)
  extern __shared__ float2 slot[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int64_t row = blockIdx.x / kCluster;
  const int l = (int)(row % wk.L);
  const int64_t p0 = (row / wk.L) * wk.per;       // the chunk's first point
  for (int i = threadIdx.x; i < 8 * per_c; i += kFwdThreads) slot[i] = make_float2(0.f, 0.f);
  cluster.sync();   // every slot of the cluster is zero before any store

  const float scale = wk.scale[l];
  const float2* tab = table + (int64_t)l * wk.t;
  const int2* rp = pairs + row * wk.m;
  const int64_t span = (wk.m + kCluster - 1) / kCluster;
  const int64_t lo = r * span, hi = lo + span < wk.m ? lo + span : wk.m;
  for (int64_t j = lo + threadIdx.x; j < hi; j += (int64_t)kFwdThreads * kUnroll) {
    int2 kp[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ju = j + (int64_t)u * kFwdThreads;
      kp[u] = ju < hi ? rp[ju] : make_int2(-1, -1);
    }
    float2 v[kUnroll];
    int pl[kUnroll];
    fwd_terms(x01, tab, kp, p0, scale, wk, pl, v);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (pl[u] < 0) continue;
      const int owner = pl[u] / per_c;
      // the pair's own slot: a plain store, remote for 7 pairs in 8
      cluster.map_shared_rank(slot, owner)[(kp[u].y & 7) * per_c + pl[u] - owner * per_c] = v[u];
    }
  }
  cluster.sync();   // every store has landed; no CTA touches another's memory after this

  const int first = r * per_c;
  for (int i = threadIdx.x; i < per_c; i += kFwdThreads) {
    const int64_t p = p0 + first + i;
    if (first + i >= wk.per || p >= wk.n) break;
    float2 a = slot[i];
#pragma unroll
    for (int c = 1; c < 8; ++c) {   // corner order
      const float2 b = slot[c * per_c + i];
      a = make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
    }
    float2* o = out + p * wk.L + l;
    if (accumulate) {
      const float2 b = *o;
      a = make_float2(__fadd_rn(b.x, a.x), __fadd_rn(b.y, a.y));
    }
    *o = a;
  }
}

template <bool kLevelMajor>
__global__ void __launch_bounds__(kThreads)
sorted_bwd_kernel(const float* __restrict__ x01, const float2* __restrict__ grad_out,
                  int64_t g_row, int n, int n_pad, Levels lv, int merge,
                  float2* __restrict__ grad_table) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int p, l;
  if (kLevelMajor) {            // [L, n_pad]: a warp is 32 points of one level
    l = (int)(i / n_pad);
    p = (int)(i - (int64_t)l * n_pad);
  } else {                      // [n, L]: level fastest
    p = (int)(i / lv.L);
    l = (int)(i - (int64_t)p * lv.L);
  }
  const bool in = p < n && l < lv.L;
  const float2 g = in ? grad_out[(int64_t)p * g_row + l] : make_float2(0.f, 0.f);
  const bool live = g.x != 0.f || g.y != 0.f;   // a zero gradient adds exactly nothing
  const unsigned full = 0xffffffffu;
  if (!__any_sync(full, live)) return;          // the whole warp (every lane exists)
  uint32_t idx[8] = {};
  float w[8] = {};
  if (live) {
    const float* xp = x01 + (int64_t)p * 3;
    const float x[3] = {__ldg(xp), __ldg(xp + 1), __ldg(xp + 2)};
    level_corners(x, lv, l, idx, w);
  }
  float2* gt = grad_table + (int64_t)(live ? l : 0) * lv.t_cap;
  // a dead lane's key is its own negative number: it joins no live group
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float2 v = live ? make_float2(__fmul_rn(w[c], g.x), __fmul_rn(w[c], g.y))
                    : make_float2(0.f, 0.f);
    bool lead = live;
    if (merge) {   // warp-uniform
      const int key = live ? l * lv.t_cap + (int)idx[c] : -1 - lane;
      v = sum_peers(__match_any_sync(full, key), v, lead);
    }
    if (lead && (v.x != 0.f || v.y != 0.f)) atomic_add2(gt + idx[c], v);
  }
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
  for (int l = 0; l < L; ++l) wk.scale[l] = scales[l];
  return 0;
}

size_t fwd_smem(int per_c) { return (size_t)8 * per_c * sizeof(float2); }

cudaLaunchConfig_t fwd_config(long long rows, int per_c, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * kCluster));   // the cluster shape is the kernel's own
  cfg.blockDim = dim3(kFwdThreads);
  cfg.dynamicSmemBytes = fwd_smem(per_c);
  cfg.stream = st;
  return cfg;
}

cudaError_t allow_fwd_smem(int per_c) {
  return cudaFuncSetAttribute(sorted_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)fwd_smem(per_c));
}

}  // namespace

extern "C" {

// K8.  x01 [n, 3], table [L, t, 2], pairs [rows, m, 2] and out [n, L*2]
// are device memory; scales [L] is a host array.  One cluster of 8 CTAs per
// row; per <= 16,384; each (point, corner) pair at most once.  With
// accumulate == 0 every out[p, l] is stored (out may be uninitialised), else
// added to.  Returns the cudaError_t of the launch (0 on success).
int sorted_encode_forward(const float* x01, const float* table, const int* pairs, long long n,
                          long long per, long long rows, long long m, int L, long long t,
                          const float* scales, int accumulate, float* out, void* stream) {
  Walk wk;
  const int err = make_walk(n, per, rows, m, L, t, scales, wk);
  if (err != 0) return err;
  if (per > kPointCap || rows * kCluster > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int per_c = (int)((per + kCluster - 1) / kCluster);
  cudaError_t e = allow_fwd_smem(per_c);
  if (e != cudaSuccess) return (int)e;
  const cudaLaunchConfig_t cfg = fwd_config(rows, per_c, (cudaStream_t)stream);
  e = cudaLaunchKernelEx(&cfg, sorted_fwd_kernel, x01, reinterpret_cast<const float2*>(table),
                         reinterpret_cast<const int2*>(pairs), wk, per_c, accumulate,
                         reinterpret_cast<float2*>(out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many K8 clusters the card holds at once for chunks of `per` points
// (cudaOccupancyMaxActiveClusters); a negative cudaError_t on failure.
int sorted_forward_active_clusters(long long per) {
  if (per < 1 || per > kPointCap) return -(int)cudaErrorInvalidValue;
  const int per_c = (int)((per + kCluster - 1) / kCluster);
  cudaError_t e = allow_fwd_smem(per_c);
  if (e != cudaSuccess) return -(int)e;
  const cudaLaunchConfig_t cfg = fwd_config(64, per_c, 0);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, sorted_fwd_kernel, &cfg);
  return e != cudaSuccess ? -(int)e : clusters;
}

// K9.  x01 [n, 3] and grad_out [n, L*2] (the upstream gradient, row p at
// grad_out + 2 * p * g_row: a slice of a wider gradient is read in place)
// are device memory, as is grad_table [L, t_cap, 2], which must be zero-filled (or hold
// a gradient to add to) and is accumulated atomically; scales, strides,
// sizes and use_hash are host arrays of L entries (csrc/hash_corners.cuh).
// level_major != 0 walks [L, n] (level-major), else [n, L]; merge != 0 merges
// each warp's equal corners before the atomics.  Returns the cudaError_t of
// the launch.
int sorted_encode_backward(const float* x01, const float* grad_out, long long g_row,
                           long long n, int L,
                           int t_cap, const float* scales, const uint32_t* strides,
                           const uint32_t* sizes, const int* use_hash, int level_major,
                           int merge, float* grad_table, void* stream) {
  Levels lv;
  const int err = hashgrid::make_levels(L, t_cap, scales, strides, sizes, use_hash, lv);
  if (err != 0) return err;
  const long long n_pad = (n + 31) / 32 * 32;
  if (n < 1 || n_pad >= (1LL << 31) || (long long)L * t_cap >= (1LL << 31) || g_row < L)
    return (int)cudaErrorInvalidValue;
  const long long threads = (level_major ? n_pad : n) * L;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  const float2* g = reinterpret_cast<const float2*>(grad_out);
  float2* gt = reinterpret_cast<float2*>(grad_table);
  cudaStream_t st = (cudaStream_t)stream;
  if (level_major)
    sorted_bwd_kernel<true><<<grid, kThreads, 0, st>>>(x01, g, g_row, (int)n, (int)n_pad, lv,
                                                        merge, gt);
  else
    sorted_bwd_kernel<false><<<grid, kThreads, 0, st>>>(x01, g, g_row, (int)n, (int)n_pad, lv,
                                                         merge, gt);
  return (int)cudaGetLastError();
}

}  // extern "C"

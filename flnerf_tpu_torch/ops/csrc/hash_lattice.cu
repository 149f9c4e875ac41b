// The lattice-hash encoding of the big hash levels: forward (K6) and table
// gradient (K7), walked level by level in the points' own order.
//
// Replaces the TPU kernels:
//   K6  _fetch_kernel (flnerf_tpu/ops/hash_lattice.py:415, called at :668);
//   K7  _scatter_kernel (hash_lattice.py:502, called at :769 and :796).
// K6/K7 compute WHAT lattice_encode_xla computes (hash_lattice.py:827-875):
// per big level l, the 8 trilinear corners of pos = x01*scale + 0.5; a
// hashed level indexes corner c at (key + offs[l][c]) mod size with the
// linear key x*P1 + y*P2 + z*P3 (uint32 wrap-around; size is a power of two,
// so mod size is a mask); a dense level at x + S*(y + S*z) + offs[l][c] with
// no modulo.  K7 is the gradient of that sum with respect to the table.
// None of the TPU machinery is carried over: the sort by base key, the
// slabs, the one-hot MXU matmuls, the bf16 table and the 16/14-bit
// fixed-point fractions exist there because TPU gathers are slow.  Here a
// gather is a load, so no corner is ever dropped (the TPU engine spills
// corners outside its slab), and the table and fractions are f32.  The
// plain version is flnerf_tpu_torch/ops/hash_lattice.py
// lattice_encode_plain_levels.
//
// Layout: the big table is [L, T, 2] f32 (T = t_r64 * 64), the natural view
// of the reference's packed [L, t_r64, 128]; entry e of level l is one
// 8-byte float2.  x01 is [N, 3] f32 in [0, 1].  The output is level-major,
// [L, N, 2] f32: level l's features of all points are one contiguous slice
// (ops/hash_lattice.py assembles the [N, L*2] encoding from it in the copy
// that joins the small levels).  The upstream gradient is [L, N, 2] read
// through its strides (in float2): level-major, or autograd's transposed
// view of the [N, L_all*2] gradient, which then needs no copy.
//
// Both walk the points in their own order (ray order for a train batch,
// grid order for a refresh chunk: neighbouring points are near in space),
// and compute a point's cell, base key, 8 corner indices and weights in
// registers from its x01 (12 bytes), with __fmul_rn/__fadd_rn, so that no
// FMA contraction moves a point into another cell than the plain version's
// separate multiply and add.
//   K6, one thread per (level, point), the level on the grid's y axis and
//      the point on x (the blocks of level l are issued before those of
//      level l + 1; a warp walks 32 consecutive points of one level), gathers
//      the 8 corners as one float2 load each, sums them in corner order, and
//      stores the float2 at [l, p]: the warp's 256 contiguous bytes, whole
//      sectors.
//   K7 is K4's tile on the lattice geometry (csrc/hash_corners.cuh
//      tile_bwd_kernel on LatticeGeo): a CTA stages 64 consecutive points'
//      gradient rows in shared memory, read in place through the strides
//      (on the main path autograd's column slice of the [N, L_all*2]
//      gradient: rows of 14 float2 at a stride of 16, in 16-byte loads),
//      lists the live points (nonzero at any big level) and leaves a dead
//      tile before it reads x01; a warp then takes 32 consecutive live
//      points of one level, merges the lanes whose corner entries agree
//      (match.any and shuffle sums onto the lowest lane) and adds w*g into
//      the gradient with one float2 atomicAdd per distinct entry.  The
//      kernel it replaced, one thread per (point, level) with 8 atomics a
//      live thread and no merge, is kept by tools/lattice_probe.py.
// What bounds them on this card: the gathers and the atomics.  At the 2^19
// train step (393,216 points x 14 levels x 8 corners = 44 M accesses) the
// 58.7 MB big table does not fit in the 50 MB L2; one level's slice (4.2
// MB at 2^19) does, and K6's level-major grid keeps about one level's slice
// hot at a time.  A fine hashed level's corners are 8 scattered 32-byte
// sectors for 8 useful bytes each; neighbouring points share the coarse
// levels' sectors.  K7's train gradient is live at ~11% of the points: the
// tile reads the dead points' gradient rows and nothing else, and the merge
// takes the ray neighbours' shared coarse corners off the L2's atomic
// units; what is left is one atomic per distinct (level, entry) of a warp.
// The design takes the sort by base key off the path: it bought shared
// sectors at the price of scattered x01 reads and [p, l] stores, and cost
// more than it saved (PERF.md, chip_smoke.py phase 10).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_corners.cuh"   // launch_tile_bwd: K7's tile skeleton, shared with K4

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr int kTileK7 = 64;   // K7's points a CTA (tools/lattice_probe.py times 64-256)

struct Lattice {
  float scale[kMaxLevels];
  uint32_t mult[kMaxLevels][3];    // hashed levels' multipliers
  uint32_t offs[kMaxLevels][8];    // corner offsets from the base key
  uint32_t stride[kMaxLevels];     // resolution + 1 (dense levels)
  uint32_t mask[kMaxLevels];       // size - 1 (hashed levels; size is 2^k)
  int use_hash[kMaxLevels];
  int L;
  uint32_t t;                      // entries per level in the table
};

// The 8 corners of point x at level l: table entry (within the level) and
// trilinear weight.  Corner c's offset along axis d is bit d of c.  A dense
// index past the table is clamped into it: that happens only for x01
// outside [0, 1] (a caller error), and keeps every access inside the table.
__device__ __forceinline__ void lattice_corners(const float x[3], const Lattice& lv,
                                                int l, uint32_t idx[8], float w[8]) {
  const float scale = lv.scale[l];
  float frac[3];
  uint32_t cell[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[d], scale), 0.5f);
    const float fl = floorf(pos);
    frac[d] = __fsub_rn(pos, fl);
    cell[d] = (uint32_t)(int)fl;
  }
  const bool hashed = lv.use_hash[l] != 0;
  const uint32_t s = lv.stride[l];
  const uint32_t base = hashed
      ? cell[0] * lv.mult[l][0] + cell[1] * lv.mult[l][1] + cell[2] * lv.mult[l][2]
      : cell[0] + s * (cell[1] + s * cell[2]);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int b0 = c & 1, b1 = (c >> 1) & 1, b2 = (c >> 2) & 1;
    w[c] = __fmul_rn(__fmul_rn(b0 ? frac[0] : __fsub_rn(1.f, frac[0]),
                               b1 ? frac[1] : __fsub_rn(1.f, frac[1])),
                     b2 ? frac[2] : __fsub_rn(1.f, frac[2]));
    const uint32_t a = base + lv.offs[l][c];
    idx[c] = hashed ? (a & lv.mask[l]) : min(a, lv.t - 1u);
  }
}

__global__ void __launch_bounds__(kThreads)
lattice_fwd_kernel(const float* __restrict__ x01, const float2* __restrict__ table, int n,
                   Lattice lv, float2* __restrict__ out) {
  const int l = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const float* xp = x01 + (int64_t)p * 3;
  const float x[3] = {__ldg(xp), __ldg(xp + 1), __ldg(xp + 2)};
  uint32_t idx[8];
  float w[8];
  lattice_corners(x, lv, l, idx, w);
  const float2* tab = table + (int64_t)l * lv.t;
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float2 f = __ldg(tab + idx[c]);
    acc.x = __fadd_rn(acc.x, __fmul_rn(w[c], f.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(w[c], f.y));
  }
  out[(int64_t)l * n + p] = acc;   // [L, N, 2]
}

// The lattice hash's geometry for the tile skeleton of K7
// (csrc/hash_corners.cuh tile_bwd_kernel): level l's entries are row l of
// the [L, t, 2] big table.
struct LatticeGeo {
  Lattice lv;
  __device__ __forceinline__ int levels() const { return lv.L; }
  __device__ __forceinline__ int64_t entries() const { return lv.t; }
  __device__ __forceinline__ void corners(const float x[3], int l, uint32_t idx[8],
                                          float w[8]) const {
    lattice_corners(x, lv, l, idx, w);
  }
};

int make_lattice(int L, long long t, const float* scales, const uint32_t* mult,
                 const uint32_t* offs, const uint32_t* strides, const uint32_t* masks,
                 const int* use_hash, Lattice& lv) {
  if (L < 1 || L > kMaxLevels || t < 1 || t > (1LL << 31)) return (int)cudaErrorInvalidValue;
  lv.L = L;
  lv.t = (uint32_t)t;
  for (int l = 0; l < L; ++l) {
    lv.scale[l] = scales[l];
    for (int d = 0; d < 3; ++d) lv.mult[l][d] = mult[l * 3 + d];
    for (int c = 0; c < 8; ++c) lv.offs[l][c] = offs[l * 8 + c];
    lv.stride[l] = strides[l];
    lv.mask[l] = masks[l];
    lv.use_hash[l] = use_hash[l];
  }
  return 0;
}

// K6: one block row per level (the grid's y axis), the points along x.
dim3 grid_of(long long n, int L) {
  return dim3((unsigned)((n + kThreads - 1) / kThreads), (unsigned)L);
}

}  // namespace

extern "C" {

// K6.  x01 [n, 3], table [L, t, 2] and out [L, n, 2] are device memory;
// scales [L], mult [L*3], offs [L*8], strides [L], masks [L] and use_hash
// [L] are host arrays.  Returns the cudaError_t of the launch.
int lattice_encode_forward(const float* x01, const float* table, long long n, int L,
                           long long t, const float* scales, const uint32_t* mult,
                           const uint32_t* offs, const uint32_t* strides, const uint32_t* masks,
                           const int* use_hash, float* out, void* stream) {
  Lattice lv;
  const int err = make_lattice(L, t, scales, mult, offs, strides, masks, use_hash, lv);
  if (err != 0) return err;
  if (n < 1 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  lattice_fwd_kernel<<<grid_of(n, L), kThreads, 0, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(table), (int)n, lv, reinterpret_cast<float2*>(out));
  return (int)cudaGetLastError();
}

// K7.  grad_out [L, n, 2] is the upstream gradient, its (level, point)
// element at grad_out + 2 * (l * g_level + p * g_point); grad_table [L, t, 2]
// must be zero-filled (or hold a gradient to add to) and is accumulated
// atomically.
int lattice_encode_backward(const float* x01, const float* grad_out, long long g_level,
                            long long g_point, long long n, int L,
                            long long t, const float* scales, const uint32_t* mult,
                            const uint32_t* offs, const uint32_t* strides,
                            const uint32_t* masks, const int* use_hash, float* grad_table,
                            void* stream) {
  Lattice lv;
  const int err = make_lattice(L, t, scales, mult, offs, strides, masks, use_hash, lv);
  if (err != 0) return err;
  if (n < 1 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  return hashgrid::launch_tile_bwd<LatticeGeo, kTileK7>(
      x01, reinterpret_cast<const float2*>(grad_out), (int64_t)g_point, (int64_t)g_level,
      (int64_t)n, L, LatticeGeo{lv}, reinterpret_cast<float2*>(grad_table),
      (cudaStream_t)stream);
}

}  // extern "C"

// Fused cuvol volume render for Plenoxels: forward (K1) and backward (K2).
//
// Replaces the TPU kernels in flnerf_tpu/ops/voxel_pallas.py:
//   K1  _fwd_kernel (voxel_pallas.py:430, via _fwd_call and render_blocks)
//   K2  _bwd_kernel (voxel_pallas.py:511, via _bwd_call and _render_bwd)
// It computes WHAT they compute, the cuvol march of svox2's
// render_lerp_kernel_cuvol.cu (trace_ray_cuvol and its backward).  Of the
// TPU design K1 keeps one element, its empty-space skip at 8^3 blocks
// (voxel_pallas.py occupancy_mip, :139-151, made exact here), and none of
// its machinery (64-ray blocks, 12-step windows, box DMA, one-hot stamp
// matmuls, the bf16 lane-packed table).  The plain version is
// flnerf_tpu_torch/models/voxel_sh.py voxel_render_rays; both kernels are
// held against it.
//
// Design: one warp per ray, in both kernels.
//
// K1 (cuvol_fwd_kernel<2, true, false>) marches in passes of 2 steps, lane
// 8s + c owning corner c of step s of the pass:
//   * empty-space skip: ops/voxel_kernel.py builds, before each launch, an
//     occupancy of 8^3 blocks of floor cells (a block is marked when some
//     floor cell in it has an alive corner of positive density); a pass
//     whose first step's floor cell lies in an unmarked block jumps to the
//     first step whose floor cell leaves that block (leave_block: the
//     exit through the block's planes, corrected by stepping to the exact
//     step; the floor cell is monotone in the step along each axis), and a
//     later step of a pass in an unmarked block reads nothing.  Exact: such
//     a sample's 8 corners are dead or <= 0, so its relu'd sigma is 0 and
//     fails sigma >= sigma_thresh for sigma_thresh > 0; with sigma_thresh <=
//     0 the wrapper passes no occupancy and every step is marched;
//   * density first: each lane reads its corner's alive byte and density in
//     one round trip, the pass's sigmas are summed in corner order from
//     shuffles, and the 27 SH channels (lanes 1-27, 108 contiguous bytes a
//     corner) are gathered only for the steps that pass the gate, all of
//     the pass's loads in flight at once;
//   * 2 steps a pass measured faster than 1 or 4 on both the phase-2
//     sphere and a trained grid, and handing neighbouring rays to
//     different SMs slower than 4 consecutive rays a block
//     (tools/voxel_probe.py, PERF.md);
//   * the SH dot products (a segmented shuffle sum) and the compositing are
//     the replaced kernel's statements in its order, so every kept sample's
//     sigma and rgb and the output equal the replaced kernel's (and K2's
//     recomputation) bit for bit; the replaced kernel, and the design's
//     switches (no skip, no density first, 1 or 4 steps a pass, rays spread
//     over the SMs) are kept by flnerf_tpu_torch/tools/voxel_probe.py.
// K2 (cuvol_bwd_kernel) keeps the replaced design: lane c owns channel c of
// the 28 (density and 27 SH coefficients; lanes 28-31 idle in the gathers);
// each step every lane computes the sample's trilinear geometry, lanes 0-7
// read the alive bits of the 8 corners (one ballot), and lane c gathers its
// channel at the live corners straight from the f32 density [X,Y,Z] and sh
// [X,Y,Z,27] tensors (gather_sample).  Every lane then holds the sample's
// sigma and rgb and composites redundantly, so no lane waits on another.
// The kernels serve every ray: there are no boxes and no coherence
// requirement.
//
// Contract, matched to the plain version:
//   * t_j = tmin + step*j for j < max_steps, counted while t_j <= tmax
//     (a miss has tmax = tmin - 1 and marches no step);
//   * position clipped to [0, reso-1], floor clipped to [0, reso-2];
//   * relu, then the sigma >= sigma_thresh gate, then
//     rgb = max(sum_b sh_mult[b] * c[b] + 0.5, 0);
//   * pruned cells read as zero and receive zero gradient;
//   * background: rgb += T_fin * background, acc = 1 - T_fin,
//     depth = sum w * t;
//   * no early termination at stop_thresh (the plain version has none).
// Output [N, 8] f32: rgb (0:3), depth (3), final log-T (4), acc (5), 0, 0.
// K2 takes the upstream [N, 8] gradient (channels 0:3 and 4), recomputes
// the march, and atomically adds into f32 grad_density and grad_sh.
//
// What bounds them on the card: memory latency along the longest ray, not
// bytes or arithmetic.  A sample reads at most 8 corners x 28 channels x 4
// B = 896 B (mostly from L2, since neighbouring samples and rays share
// corners) for about 600 flops, far below the ~20 flops/B the f32 pipes
// would need to be the limit; the main path's 5000 rays are ~38 warps an
// SM, each marching a few hundred dependent steps.  K1 takes one round trip
// for the densities of 2 steps and one for the SH of those that pass, and
// none for a step in an empty block, so its time follows the steps inside
// marked blocks (chip_smoke.py phase 4 reports the longest ray's).  K2
// still takes two round trips a step over every step (redesign 5).  Not
// done: early exit at stop_thresh (the contract has none), TMA or
// shared-memory tiling of the grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 28;          // density + 27 SH coefficients
constexpr int kBasis = 9;        // SH degree 3
constexpr int kWarps = 4;        // rays (warps) per block
constexpr unsigned kFull = 0xffffffffu;

struct GridView {
  const float* density;   // [X, Y, Z]
  const float* sh;        // [X, Y, Z, 27]
  const uint8_t* alive;   // [X, Y, Z] bool
  int X, Y, Z;
};

struct RayView {
  const float* origins;   // [N, 3] grid space
  const float* dirs;      // [N, 3] unit length in grid space
  const float* tmin;      // [N]
  const float* tmax;      // [N]
  const float* dscale;    // [N]
  const float* shmult;    // [N, 9]
};

struct Params {
  int n_rays, max_steps;
  float step, sigma_thresh, background;
};

// one axis of the sample position: clip, floor, clip the floor
__device__ __forceinline__ void axis_lerp(float o, float d, float t, int reso,
                                          int& l, float& f) {
  float pos = __fadd_rn(o, __fmul_rn(t, d));
  pos = fminf(fmaxf(pos, 0.f), (float)(reso - 1));
  float fl = floorf(pos);
  fl = fminf(fmaxf(fl, 0.f), (float)(reso - 2));
  l = (int)fl;
  f = __fsub_rn(pos, fl);
}

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

struct RayIn {
  float o[3], d[3], tmin, tmax, dscale, shm;
};

__device__ __forceinline__ RayIn load_ray(const RayView& r, int ray, int lane) {
  RayIn in;
  const int64_t i = ray;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    in.o[a] = r.origins[i * 3 + a];
    in.d[a] = r.dirs[i * 3 + a];
  }
  in.tmin = r.tmin[i];
  in.tmax = r.tmax[i];
  in.dscale = r.dscale[i];
  in.shm = (lane >= 1 && lane < kCh) ? r.shmult[i * kBasis + (lane - 1) % kBasis]
                                     : 0.f;
  return in;
}

// K1's empty-space skip: the 8^3 blocks of floor cells that some sample
// whose floor cell lies in them can draw a positive density from
// (ops/voxel_kernel.py occupancy_blocks); bits == nullptr marches every
// step.
struct Occupancy {
  const uint8_t* bits;   // [BX, BY, BZ] bool
  int BY, BZ;
};

__device__ __forceinline__ float step_t(const RayIn& in, const Params& p, int j) {
  return __fadd_rn(in.tmin, __fmul_rn(p.step, (float)j));
}

// the floor cell of the sample at t
__device__ __forceinline__ void floor_cell(const GridView& g, const RayIn& in, float t,
                                           int& lx, int& ly, int& lz) {
  float f;
  axis_lerp(in.o[0], in.d[0], t, g.X, lx, f);
  axis_lerp(in.o[1], in.d[1], t, g.Y, ly, f);
  axis_lerp(in.o[2], in.d[2], t, g.Z, lz, f);
}

__device__ __forceinline__ bool block_marked(const Occupancy& oc, int lx, int ly, int lz) {
  return __ldg(oc.bits + ((int64_t)(lx >> 3) * oc.BY + (ly >> 3)) * oc.BZ + (lz >> 3)) != 0;
}

// Whether step k is out of block (bx, by, bz): past the march (k >=
// max_steps or t_k > tmax), or its floor cell lies in another block.
__device__ __forceinline__ bool out_of_block(const GridView& g, const RayIn& in,
                                             const Params& p, int k, int bx, int by, int bz) {
  if (k >= p.max_steps) return true;
  const float t = step_t(in, p, k);
  if (t > in.tmax) return true;
  int lx, ly, lz;
  floor_cell(g, in, t, lx, ly, lz);
  return (lx >> 3) != bx || (ly >> 3) != by || (lz >> 3) != bz;
}

// The first step after j that is out of the block (bx, by, bz) of step j's
// floor cell.  Along each axis t_k, the position, its clip and its floor
// are monotone in k, so a step that leaves the block never returns:
// out_of_block is false up to one step and true from it on.  The ray's
// exit through the block's planes estimates that step; stepping back and
// forth from the estimate finds it exactly (a step or two of rounding).
__device__ int leave_block(const GridView& g, const RayIn& in, const Params& p, int j,
                           int bx, int by, int bz) {
  const int b[3] = {bx, by, bz};
  const int reso[3] = {g.X, g.Y, g.Z};
  float t_out = in.tmax;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    // the floor is clipped to [0, reso - 2]: past the first and last
    // blocks' outer planes it stays
    const float d = in.d[a];
    if (d > 0.f && 8 * (b[a] + 1) <= reso[a] - 2)
      t_out = fminf(t_out, ((float)(8 * (b[a] + 1)) - in.o[a]) / d);
    else if (d < 0.f && b[a] > 0)
      t_out = fminf(t_out, ((float)(8 * b[a]) - in.o[a]) / d);
  }
  float e = floorf((t_out - in.tmin) / p.step) + 1.f;
  e = fminf(fmaxf(e, (float)(j + 1)), (float)p.max_steps);   // a NaN takes j + 1
  int k = (int)e;
  while (k > j + 1 && out_of_block(g, in, p, k - 1, bx, by, bz)) --k;
  while (!out_of_block(g, in, p, k, bx, by, bz)) ++k;
  return k;
}

// K1.  kSteps steps a pass (lane = 8 * step + corner); kDensityFirst
// gathers the SH channels only for the steps that pass the sigma gate
// (false: for every marched step, as the replaced kernel did); kSpread
// hands warp w of block b ray w * gridDim.x + b, so that neighbouring rays
// of the coherent order, which cross the same occupied blocks, run on
// different SMs (false: a block takes 4 consecutive rays).  The variants
// are kept for tools/voxel_probe.py.
template <int kSteps, bool kDensityFirst, bool kSpread>
__global__ void __launch_bounds__(32 * kWarps)
cuvol_fwd_kernel(GridView g, Occupancy oc, RayView r, Params p, float* __restrict__ out) {
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

__global__ void __launch_bounds__(32 * kWarps)
cuvol_bwd_kernel(GridView g, RayView r, Params p, const float* __restrict__ out,
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

GridView make_grid(const float* density, const float* sh, const uint8_t* alive,
                   int X, int Y, int Z) {
  GridView g;
  g.density = density;
  g.sh = sh;
  g.alive = alive;
  g.X = X;
  g.Y = Y;
  g.Z = Z;
  return g;
}

RayView make_rays(const float* origins, const float* dirs, const float* tmin,
                  const float* tmax, const float* dscale, const float* shmult) {
  RayView r;
  r.origins = origins;
  r.dirs = dirs;
  r.tmin = tmin;
  r.tmax = tmax;
  r.dscale = dscale;
  r.shmult = shmult;
  return r;
}

// the block counts along y and z of the floor cells 0 .. reso - 2
Occupancy make_occupancy(const uint8_t* bits, int Y, int Z) {
  Occupancy oc;
  oc.bits = bits;
  oc.BY = (Y - 2) / 8 + 1;
  oc.BZ = (Z - 2) / 8 + 1;
  return oc;
}

Params make_params(int n_rays, int max_steps, float step, float sigma_thresh,
                   float background) {
  Params p;
  p.n_rays = n_rays;
  p.max_steps = max_steps;
  p.step = step;
  p.sigma_thresh = sigma_thresh;
  p.background = background;
  return p;
}

}  // namespace

extern "C" {

// K1.  Every pointer is device memory; out is [n_rays, 8]; occ is the
// [ceil((X-1)/8), ceil((Y-1)/8), ceil((Z-1)/8)] block occupancy of
// ops/voxel_kernel.py occupancy_blocks, or null to march every step (it
// must be null unless sigma_thresh > 0).  Returns the cudaError_t of the
// launch (0 on success).
int cuvol_forward(const float* density, const float* sh, const uint8_t* alive,
                  int X, int Y, int Z, const float* origins, const float* dirs,
                  const float* tmin, const float* tmax, const float* dscale,
                  const float* shmult, int n_rays, int max_steps, float step,
                  float sigma_thresh, float background, const uint8_t* occ, float* out,
                  void* stream) {
  const dim3 block(32 * kWarps);
  const dim3 grid((n_rays + kWarps - 1) / kWarps);
  cuvol_fwd_kernel<2, true, false><<<grid, block, 0, (cudaStream_t)stream>>>(
      make_grid(density, sh, alive, X, Y, Z), make_occupancy(occ, Y, Z),
      make_rays(origins, dirs, tmin, tmax, dscale, shmult),
      make_params(n_rays, max_steps, step, sigma_thresh, background), out);
  return (int)cudaGetLastError();
}

// K2.  out is K1's output for the same inputs, grad_out the upstream
// gradient [n_rays, 8]; grad_density [X,Y,Z] and grad_sh [X,Y,Z,27] must be
// zero-filled by the caller and are accumulated atomically.
int cuvol_backward(const float* density, const float* sh, const uint8_t* alive,
                   int X, int Y, int Z, const float* origins, const float* dirs,
                   const float* tmin, const float* tmax, const float* dscale,
                   const float* shmult, int n_rays, int max_steps, float step,
                   float sigma_thresh, float background, const float* out,
                   const float* grad_out, float* grad_density, float* grad_sh,
                   void* stream) {
  const dim3 block(32 * kWarps);
  const dim3 grid((n_rays + kWarps - 1) / kWarps);
  cuvol_bwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      make_grid(density, sh, alive, X, Y, Z),
      make_rays(origins, dirs, tmin, tmax, dscale, shmult),
      make_params(n_rays, max_steps, step, sigma_thresh, background), out,
      grad_out, grad_density, grad_sh);
  return (int)cudaGetLastError();
}

}  // extern "C"

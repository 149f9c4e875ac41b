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
// Design: one warp per ray, in both kernels, and one march for both.
//
// The march (jump_block, density_pass, gather_sh, step_rgb) walks a ray in
// passes of kSteps steps, lane 8s + c owning corner c of step s of the pass:
//   * empty-space skip: ops/voxel_kernel.py builds, before each forward, an
//     occupancy of 8^3 blocks of floor cells (a block is marked when some
//     floor cell in it has an alive corner of positive density); a pass
//     whose first step's floor cell lies in an unmarked block jumps to the
//     first step whose floor cell leaves that block (leave_block: the
//     exit through the block's planes, corrected by stepping to the exact
//     step; the floor cell is monotone in the step along each axis), and a
//     later step of a pass in an unmarked block reads nothing.  Exact: such
//     a sample's 8 corners are dead or <= 0, so its relu'd sigma is 0 and
//     fails sigma >= sigma_thresh for sigma_thresh > 0; with sigma_thresh <=
//     0 the wrapper passes no occupancy and every step is marched.  The
//     backward takes the forward's occupancy (RenderFused keeps it);
//   * density first: each lane reads its corner's alive byte and density in
//     one round trip, the pass's sigmas are summed in corner order from
//     shuffles, and the 27 SH channels (lanes 1-27, 108 contiguous bytes a
//     corner) are gathered only for the steps that pass the gate, all of
//     the pass's loads in flight at once;
//   * the SH dot products (a segmented shuffle sum) and the compositing are
//     the replaced kernels' statements in their order, so every kept
//     sample's sigma and rgb, K1's output and K2's per-sample gradient
//     terms equal the replaced kernels' bit for bit.
// K1 (cuvol_fwd_kernel<2, true, false>) composites the kept samples.  2
// steps a pass measured faster than 1 or 4 on both the phase-2 sphere and a
// trained grid, and handing neighbouring rays to different SMs slower than
// 4 consecutive rays a block (tools/voxel_probe.py, PERF.md).
// K2 (cuvol_bwd_kernel<4, true, false, true>) recomputes the march, 4
// steps a pass, and, for each kept sample, the replaced kernel's
// transmittance gradient; lane 0 then adds into the density's gradient and
// lane c (1-27) into SH channel c - 1's, one atomic per live corner, in the
// replaced kernel's order, so a single ray's gradient is the replaced
// kernel's bit for bit.  Its switches: 1 or 2 steps a pass, and a merge that
// keeps a lane's 8 corners' adds in registers while the kept samples stay in
// one floor cell (39% of kept samples repeat the previous one's) and flushes
// them when it changes; at 4 steps a pass the merge measured slower (its
// registers cost more than the atomics it saves: they are 7% of K2 on a
// trained grid).  The replaced kernels (every step marched, all 28 channels
// gathered before the gate, a step a pass, an atomic per sample) and the
// design's switches are kept by flnerf_tpu_torch/tools/voxel_probe.py.
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
// SM, each marching a few hundred dependent steps.  Both kernels take one
// round trip for the densities of a pass and one for the SH of the steps
// that pass the gate, and none for a step in an empty block, so their time
// follows the steps inside marked blocks (chip_smoke.py phase 4 reports the
// longest ray's); K2 adds its atomics (the probe's "atomics off" variant
// shows their share).  Not done: early exit at stop_thresh (the contract
// has none), TMA or shared-memory tiling of the grid.

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

// The skip of both kernels: when step j0 (at t0) lies in an unmarked block,
// move j0 to the first step out of it and return true.
__device__ __forceinline__ bool jump_block(const GridView& g, const Occupancy& oc,
                                           const RayIn& in, const Params& p, float t0, int& j0) {
  int bx, by, bz;
  floor_cell(g, in, t0, bx, by, bz);
  if (block_marked(oc, bx, by, bz)) return false;
  j0 = leave_block(g, in, p, j0, bx >> 3, by >> 3, bz >> 3);
  return true;
}

// What the density pass of kSteps steps from j0 gives each lane.
template <int kSteps>
struct Pass {
  int64_t cell0;       // corner 0 of the floor cell of this lane's step
  float w;             // this lane's trilinear corner weight
  unsigned live;       // bit 8s + c: corner c of step s read and alive
  unsigned marched;    // bit s: step s marched
  unsigned gated;      // bit s: step s passes the sigma gate
  float sig[kSteps];   // each step's relu'd sigma, in every lane
};

// The density pass: lane (s, c) reads corner c's alive byte and density at
// step j0 + s, both loads in one round trip; each step's sigma is summed
// over its live corners in corner order, as the replaced kernels sum it.
// The lane's step ls and corner (dx, dy, dz), and yz = Y * Z, are the
// kernel's, computed once (recomputed here they cost K1 12-19%).
template <int kSteps>
__device__ __forceinline__ void density_pass(const GridView& g, const Occupancy& oc,
                                             const RayIn& in, const Params& p, int j0,
                                             int ls, int dx, int dy, int dz, int64_t yz,
                                             Pass<kSteps>& ps) {
  static_assert(kSteps >= 1 && kSteps <= 4, "8 lanes a step");
  const int js = j0 + ls;
  const float t = step_t(in, p, js);
  int lx, ly, lz;
  float fx, fy, fz;
  axis_lerp(in.o[0], in.d[0], t, g.X, lx, fx);
  axis_lerp(in.o[1], in.d[1], t, g.Y, ly, fy);
  axis_lerp(in.o[2], in.d[2], t, g.Z, lz, fz);
  bool use = ls < kSteps && js < p.max_steps && t <= in.tmax;
  if (use && oc.bits) use = block_marked(oc, lx, ly, lz);
  ps.cell0 = ((int64_t)lx * g.Y + ly) * g.Z + lz;
  const int64_t cell = ps.cell0 + dx * yz + dy * (int64_t)g.Z + dz;
  ps.w = __fmul_rn(__fmul_rn(dx ? fx : 1.f - fx, dy ? fy : 1.f - fy), dz ? fz : 1.f - fz);
  bool alive = false;
  float dens = 0.f;
  if (use) {
    alive = g.alive[cell] != 0;
    dens = g.density[cell];
  }
  ps.live = __ballot_sync(kFull, alive);   // bit 8s + c
  const unsigned used = __ballot_sync(kFull, use);
  const float prod = __fmul_rn(ps.w, dens);
  ps.marched = 0;
  ps.gated = 0;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    float v = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float pc = __shfl_sync(kFull, prod, 8 * s + c);
      if (ps.live & (1u << (8 * s + c))) v = __fadd_rn(v, pc);
    }
    ps.sig[s] = v > 0.f ? v : 0.f;
    if ((used >> (8 * s)) & 1u) {
      ps.marched |= 1u << s;
      if (ps.sig[s] >= p.sigma_thresh) ps.gated |= 1u << s;
    }
  }
}

// corner c (dx, dy, dz bits 2, 1, 0) of the floor cell whose corner 0 is cell0
__device__ __forceinline__ int64_t corner_cell(const GridView& g, int64_t yz, int64_t cell0,
                                               int c) {
  return cell0 + (c >> 2) * yz + ((c >> 1) & 1) * (int64_t)g.Z + (c & 1);
}

// Lane c (1-27) reads SH channel c - 1 at the live corners of every step of
// `gather`: all loads of the pass in flight at once.
template <int kSteps>
__device__ __forceinline__ void gather_sh(const GridView& g, int64_t yz, const Pass<kSteps>& ps,
                                          unsigned gather, int lane, float (&cv)[kSteps][8]) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int64_t cs = __shfl_sync(kFull, ps.cell0, 8 * s);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const bool ld = ((gather >> s) & 1u) && ((ps.live >> (8 * s + c)) & 1u) && lane >= 1 &&
                      lane < kCh;
      cv[s][c] = ld ? __ldg(g.sh + corner_cell(g, yz, cs, c) * (kCh - 1) + (lane - 1)) : 0.f;
    }
  }
}

// Step s's SH dot products + 0.5 (rgb_raw), in every lane, from its
// gathered SH, summed as the replaced kernels sum them.
template <int kSteps>
__device__ __forceinline__ void step_rgb(const Pass<kSteps>& ps, const float (&cv)[kSteps][8],
                                         int s, float shm, int lane, float (&rgb_raw)[3]) {
  float v = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wc = __shfl_sync(kFull, ps.w, 8 * s + c);
    if (ps.live & (1u << (8 * s + c))) v = __fadd_rn(v, __fmul_rn(wc, cv[s][c]));
  }
  // segmented sum of shm * c over lanes 1-9 (r), 10-18 (g), 19-27 (b)
  const int seg = (lane >= 1 && lane < kCh) ? (lane - 1) / kBasis : -1 - lane;
  float q = seg >= 0 ? shm * v : 0.f;
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    const float other = __shfl_down_sync(kFull, q, off);
    const int ol = lane + off;
    const int oseg = (ol >= 1 && ol < kCh) ? (ol - 1) / kBasis : -1 - ol;
    if (ol < 32 && oseg == seg) q += other;
  }
  rgb_raw[0] = __shfl_sync(kFull, q, 1) + 0.5f;
  rgb_raw[1] = __shfl_sync(kFull, q, 1 + kBasis) + 0.5f;
  rgb_raw[2] = __shfl_sync(kFull, q, 1 + 2 * kBasis) + 0.5f;
}

// K1.  kSteps steps a pass; kDensityFirst gathers the SH channels only for
// the steps that pass the sigma gate (false: for every marched step, as the
// replaced kernel did); kSpread hands warp w of block b ray w * gridDim.x +
// b, so that neighbouring rays of the coherent order, which cross the same
// occupied blocks, run on different SMs (false: a block takes 4
// consecutive rays).  The variants are kept for tools/voxel_probe.py.
template <int kSteps, bool kDensityFirst, bool kSpread>
__global__ void __launch_bounds__(32 * kWarps)
cuvol_fwd_kernel(GridView g, Occupancy oc, RayView r, Params p, float* __restrict__ out) {
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
    if (oc.bits && jump_block(g, oc, in, p, t0, j0)) continue;
    Pass<kSteps> ps;
    density_pass(g, oc, in, p, j0, ls, dx, dy, dz, yz, ps);
    const unsigned gather = kDensityFirst ? ps.gated : ps.marched;
    if (gather) {
      float cv[kSteps][8];
      gather_sh(g, yz, ps, gather, lane, cv);
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        if (!((ps.gated >> s) & 1u)) continue;   // contributes exactly nothing
        float rgb_raw[3];
        step_rgb(ps, cv, s, in.shm, lane, rgb_raw);
        // composite, as the replaced kernel does
        const float sigma = ps.sig[s];
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

// K2.  kSteps and kDensityFirst as K1's; kMerge keeps a lane's adds to the
// 8 corners of the kept samples' floor cell in registers until the floor
// cell changes (false: 8 atomics a kept sample, the replaced kernel's);
// kAtomics false sums the adds into sink[ray * 32 + lane] instead of the
// gradients, a measurement of what the atomics cost
// (tools/voxel_probe.py), not a gradient.
template <int kSteps, bool kDensityFirst, bool kMerge, bool kAtomics>
__global__ void __launch_bounds__(32 * kWarps)
cuvol_bwd_kernel(GridView g, Occupancy oc, RayView r, Params p, const float* __restrict__ out,
                 const float* __restrict__ grad_out, float* __restrict__ grad_density,
                 float* __restrict__ grad_sh, float* __restrict__ sink) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (ray >= p.n_rays) return;
  const RayIn in = load_ray(r, ray, lane);
  const int ls = lane >> 3, lc = lane & 7;   // this lane's step of the pass, and corner
  const int dx = lc >> 2, dy = (lc >> 1) & 1, dz = lc & 1;
  const int64_t yz = (int64_t)g.Y * g.Z;

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
  // this lane's channel of the gradients: lane 0 the density, lane c
  // (1-27) SH channel c - 1 (lanes 28-31 add nothing)
  float* const gch = lane == 0 ? grad_density : grad_sh + (lane - 1);
  const int64_t gstride = lane == 0 ? 1 : kCh - 1;
  float sunk = 0.f;
  auto add = [&](int64_t cell, float v) {
    if constexpr (kAtomics) {
      atomicAdd(gch + cell * gstride, v);
    } else {
      sunk += v;
    }
  };
  // kMerge: the adds to the corners of floor cell run_cell (its corner 0)
  int64_t run_cell = -1;
  unsigned run_live = 0;
  float run[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) run[c] = 0.f;
  auto flush = [&]() {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (((run_live >> c) & 1u) && run[c] != 0.f) add(corner_cell(g, yz, run_cell, c), run[c]);
  };

  float log_t = 0.f, prefix = 0.f;
  int j0 = 0;
  while (j0 < p.max_steps) {
    const float t0 = step_t(in, p, j0);
    if (t0 > in.tmax) break;
    if (oc.bits && jump_block(g, oc, in, p, t0, j0)) continue;
    Pass<kSteps> ps;
    density_pass(g, oc, in, p, j0, ls, dx, dy, dz, yz, ps);
    const unsigned gather = kDensityFirst ? ps.gated : ps.marched;
    if (gather) {
      float cv[kSteps][8];
      gather_sh(g, yz, ps, gather, lane, cv);
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        if (!((ps.gated >> s) & 1u)) continue;   // gated: zero gradient
        float rgb_raw[3];
        step_rgb(ps, cv, s, in.shm, lane, rgb_raw);
        float wc[8];   // the step's corner weights
#pragma unroll
        for (int c = 0; c < 8; ++c) wc[c] = __shfl_sync(kFull, ps.w, 8 * s + c);
        // the replaced kernel's per-sample terms, in its order
        const float sigma = ps.sig[s];
        const float la = -p.step * sigma * in.dscale;
        const float w = expf(log_t) * (1.f - expf(la));
        const float t_next = expf(log_t + la);
        float rgb[3], gc = 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          rgb[k] = fmaxf(rgb_raw[k], 0.f);
          gc += gk[k] * rgb[k];
        }
        prefix += gc * w;                       // P_i, inclusive
        const float dla = (s_tot - prefix) - t_next * gc + tfin_gbg;
        log_t += la;

        const float raw_lane = kc == 0 ? rgb_raw[0] : (kc == 1 ? rgb_raw[1] : rgb_raw[2]);
        float dval = 0.f;
        if (lane == 0) {
          // the thresh gate passed; the relu gate matters when sigma_thresh <= 0
          if (sigma > 0.f) dval = dla * (-p.step) * in.dscale;
        } else if (lane < kCh && raw_lane > 0.f) {
          dval = g_lane * w * in.shm;
        }
        const int64_t cs = __shfl_sync(kFull, ps.cell0, 8 * s);
        if constexpr (kMerge) {
          if (cs != run_cell) {   // a new floor cell: the last one's adds go out
            flush();
            run_cell = cs;
            run_live = (ps.live >> (8 * s)) & 0xffu;
#pragma unroll
            for (int c = 0; c < 8; ++c) run[c] = 0.f;
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) run[c] += wc[c] * dval;
        } else if (dval != 0.f) {
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (ps.live & (1u << (8 * s + c))) add(corner_cell(g, yz, cs, c), wc[c] * dval);
        }
      }
    }
    j0 += kSteps;
  }
  if constexpr (kMerge) flush();
  if constexpr (!kAtomics) sink[(int64_t)ray * 32 + lane] = sunk;
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

// K2's steps a pass and merge (tools/voxel_probe.py times the others)
constexpr int kBwdSteps = 4;
constexpr bool kBwdMerge = false;

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
// gradient [n_rays, 8]; occ as for K1 (the forward's own, or null: march
// every step; null unless sigma_thresh > 0); grad_density [X,Y,Z] and
// grad_sh [X,Y,Z,27] must be zero-filled by the caller and are accumulated
// atomically.
int cuvol_backward(const float* density, const float* sh, const uint8_t* alive,
                   int X, int Y, int Z, const float* origins, const float* dirs,
                   const float* tmin, const float* tmax, const float* dscale,
                   const float* shmult, int n_rays, int max_steps, float step,
                   float sigma_thresh, float background, const uint8_t* occ, const float* out,
                   const float* grad_out, float* grad_density, float* grad_sh,
                   void* stream) {
  const dim3 block(32 * kWarps);
  const dim3 grid((n_rays + kWarps - 1) / kWarps);
  cuvol_bwd_kernel<kBwdSteps, true, kBwdMerge, true><<<grid, block, 0, (cudaStream_t)stream>>>(
      make_grid(density, sh, alive, X, Y, Z), make_occupancy(occ, Y, Z),
      make_rays(origins, dirs, tmin, tmax, dscale, shmult),
      make_params(n_rays, max_steps, step, sigma_thresh, background), out, grad_out,
      grad_density, grad_sh, nullptr);
  return (int)cudaGetLastError();
}

}  // extern "C"

// The Plenoxels step's dense TV gradient and RMSProp update in one pass.
//
// Replaces no TPU kernel: flnerf_tpu/train/plenoxels_trainer.py leaves the
// total variation (models/voxel_sh.py tv_loss, through jax.grad) and RMSProp
// to XLA, which fuses them there.  On the card the same work ran as PyTorch's
// generic elementwise kernels, through autograd: the TV's sliced differences,
// `where`s on the alive mask, squares, sums and their backward's fills and
// copies, then the gradients' sum and five RMSProp passes, each a full pass
// over the 1.9 GB grid of a 256^3 step (about 13x the bytes the update
// needs).  tv_rmsprop_kernel computes the same function in one sweep, and
// the TV gradient never reaches device memory.
//
// What it computes, for one field p [X, Y, Z, C] (density: C = 1; SH: C =
// 27), its data gradient g, its RMSProp state rms and the [X, Y, Z] alive
// mask, cell c and channel k:
//   acc = sum over the neighbours j of c in the order x-1, x+1, y-1, y+1,
//         z-1, z+1 that lie inside the grid and whose pair (c, j) is alive
//         on both sides, of (p[c, k] - p[j, k])
//   gg  = g + coef * acc              coef = 2 * lambda / (X * Y * Z)
//   rms = rms * beta + ((1 - beta) * gg) * gg
//   out = p + (-lr) * (gg / (sqrt(rms) + eps))
// which is tv_loss's gradient (its forward differences count when both cells
// are alive) times lambda, added to the data gradient, then the trainer's
// RMSProp.  Every operation is rounded on its own (__f*_rn: nvcc contracts
// nothing), in the order of ops/tv_rmsprop.py tv_rmsprop_plain, so the two
// agree bit for bit on the same inputs on the card.
//
// What bounds it on the card: bytes.  Each float is read from p, g and rms and
// written to rms and out once, 20 bytes, with ~20 operations, far below the
// ~20 flops a byte the f32 pipes would need to be the limit.  At 256^3 with
// 27 SH channels that is 9.1 GB a step, 2.7 ms at 3.35 TB/s.
//
// Design.  A thread takes 2 floats of one x-plane, 128 threads apart, so
// each load of a warp is 128 contiguous bytes; blocks are laid out x-plane
// by x-plane (blockIdx.y = x), and the card starts them in that order.  A
// float's 6 neighbours are read where they already are: its z neighbours (C
// floats away) in the block's own lines (L1), its y neighbours in the lines
// of the blocks beside it, its x neighbours in the planes before and after,
// which the sweep read moments ago or will read next (L2).  g and rms are
// read, and rms and out written, with the streaming cache hint (evict
// first), so that the L2 keeps p's planes.  What measured slower on the H100
// (PERF.md): a march along x keeping the x neighbours in registers
// (latency: each plane's loads wait on the last), more floats a thread or
// 256-512 threads a block (registers, occupancy), and reading the 7 alive
// bytes of each float, or the neighbours only behind its own alive byte
// (two round trips).  So the alive rule is precomputed a cell at a time by
// tv_pairs_kernel (bit d: the pair with neighbour d counts), and the sweep
// issues all of a float's loads at once, the neighbours' addresses clamped
// into the field at its two ends (a neighbour outside the grid has its bit
// clear, so what is read there is never used).
//
// The update cannot be made in place, since a block would read a neighbour
// that another block has already updated: out is a second buffer, and the
// trainer swaps the two each step (ping-pong).  rms is updated in place:
// only its own thread reads it.  With lambda = 0 no neighbour is read (the
// RMSProp alone).  Offsets are 64-bit (a 512^3 SH grid holds 3.6e9 floats);
// one x-plane is under 2^31 floats and X under 65536 (the wrapper checks).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 2;
constexpr int kPairThreads = 256;

struct SweepArgs {
  const float* p;
  const float* g;
  float* rms;
  const uint8_t* pairs;
  float* out;
  int X, Y, Z, C;
  float coef, beta, omb, neg_lr, eps;
  const float* lr;  // kLrPtr: the learning rate in device memory, in place of neg_lr
};

// bits[c] = bit d set when cell c and its neighbour d (x-1, x+1, y-1, y+1,
// z-1, z+1) lie inside the grid and are both alive.  One thread a cell of
// plane blockIdx.y.
__global__ void __launch_bounds__(kPairThreads) tv_pairs_kernel(const uint8_t* alive,
                                                                uint8_t* bits, int X, int Y,
                                                                int Z) {
  const int yz = blockIdx.x * kPairThreads + threadIdx.x;
  if (yz >= Y * Z) return;
  const int x = blockIdx.y, y = yz / Z, z = yz - y * Z;
  const long long YZ = (long long)Y * Z;
  const long long c = x * YZ + yz;
  unsigned b = 0;
  if (alive[c]) {
    b |= (x > 0 && alive[c - YZ]) << 0;
    b |= (x < X - 1 && alive[c + YZ]) << 1;
    b |= (y > 0 && alive[c - Z]) << 2;
    b |= (y < Y - 1 && alive[c + Z]) << 3;
    b |= (z > 0 && alive[c - 1]) << 4;
    b |= (z < Z - 1 && alive[c + 1]) << 5;
  }
  bits[c] = (uint8_t)b;
}

// kC: the channels, fixed at compile time for 1 and 27 (0: s.C at run time).
// kLrPtr: -lr is read from s.lr in device memory (a CUDA graph's replay
// gives each step its own rate there) rather than passed by value.
template <int kC, bool kLrPtr>
__global__ void __launch_bounds__(kThreads) tv_rmsprop_kernel(const SweepArgs s) {
  const int C = kC > 0 ? kC : s.C;
  const float neg_lr = kLrPtr ? -__ldg(s.lr) : s.neg_lr;
  const int x = blockIdx.y;
  const int ZC = s.Z * C;
  const int YZC = s.Y * ZC;
  const long long last = (long long)s.X * YZC - 1;
  const long long plane = (long long)x * YZC;
  const long long aplane = (long long)x * s.Y * s.Z;
  const bool tv = s.coef != 0.f;
  const long long off[6] = {-(long long)YZC, (long long)YZC, -ZC, ZC, -C, C};
  const int j0 = blockIdx.x * (kThreads * kPerThread) + threadIdx.x;

  float pc[kPerThread], gv[kPerThread], rv[kPerThread], pn[kPerThread][6];
  unsigned bits[kPerThread];
  // every load of the thread first, so that they are all in flight at once
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) {
    const int j = j0 + m * kThreads;
    if (j >= YZC) continue;
    const long long o = plane + j;
    pc[m] = __ldg(s.p + o);
    gv[m] = __ldcs(s.g + o);
    rv[m] = __ldcs(s.rms + o);
    if (!tv) continue;
    bits[m] = __ldg(s.pairs + aplane + j / C);
#pragma unroll
    for (int d = 0; d < 6; ++d)
      pn[m][d] = __ldg(s.p + min(max(o + off[d], 0LL), last));
  }
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) {
    const int j = j0 + m * kThreads;
    if (j >= YZC) continue;
    float acc = 0.f;
    if (tv) {
#pragma unroll
      for (int d = 0; d < 6; ++d)
        if ((bits[m] >> d) & 1u) acc = __fadd_rn(acc, __fsub_rn(pc[m], pn[m][d]));
    }
    const float gg = __fadd_rn(gv[m], __fmul_rn(s.coef, acc));
    const float r = __fadd_rn(__fmul_rn(rv[m], s.beta), __fmul_rn(__fmul_rn(s.omb, gg), gg));
    const float den = __fadd_rn(__fsqrt_rn(r), s.eps);
    const long long o = plane + j;
    __stcs(s.rms + o, r);
    __stcs(s.out + o, __fadd_rn(pc[m], __fmul_rn(neg_lr, __fdiv_rn(gg, den))));
  }
}

template <bool kLrPtr>
int launch_sweep(const SweepArgs& s, void* stream) {
  const long long plane = (long long)s.Y * s.Z * s.C;
  const dim3 grid((unsigned)((plane + kThreads * kPerThread - 1) / (kThreads * kPerThread)),
                  (unsigned)s.X);
  const cudaStream_t st = (cudaStream_t)stream;
  if (s.C == 1)
    tv_rmsprop_kernel<1, kLrPtr><<<grid, kThreads, 0, st>>>(s);
  else if (s.C == 27)
    tv_rmsprop_kernel<27, kLrPtr><<<grid, kThreads, 0, st>>>(s);
  else
    tv_rmsprop_kernel<0, kLrPtr><<<grid, kThreads, 0, st>>>(s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The live pairs of an [X, Y, Z] alive mask (bytes 0 or 1) into bits [X, Y,
// Z] (device memory both; Y*Z < 2^31, X <= 65535).  Returns the cudaError_t
// of the launch (0 on success).
int tv_pairs(const uint8_t* alive, uint8_t* bits, int X, int Y, int Z, void* stream) {
  const dim3 grid((unsigned)(((long long)Y * Z + kPairThreads - 1) / kPairThreads), (unsigned)X);
  tv_pairs_kernel<<<grid, kPairThreads, 0, (cudaStream_t)stream>>>(alive, bits, X, Y, Z);
  return (int)cudaGetLastError();
}

// One sweep.  Every pointer is device memory: p, g, rms and out [X, Y, Z, C]
// f32 (out neither p, g nor rms), pairs [X, Y, Z] from tv_pairs (unread, and
// may be null, when coef is 0); rms is updated in place, out receives the new
// parameters.  coef = 2 * lambda / (X*Y*Z), omb = 1 - beta, neg_lr = -lr,
// each already rounded to f32.  Y*Z*C < 2^31 and X <= 65535.  Returns the
// cudaError_t of the launch (0 on success).
int tv_rmsprop(const float* p, const float* g, float* rms, const uint8_t* pairs, float* out,
               int X, int Y, int Z, int C, float coef, float beta, float omb, float neg_lr,
               float eps, void* stream) {
  return launch_sweep<false>(
      SweepArgs{p, g, rms, pairs, out, X, Y, Z, C, coef, beta, omb, neg_lr, eps, nullptr},
      stream);
}

// The same sweep with the learning rate read on the device from lr (one f32
// of device memory) when the kernel runs, so a captured launch takes the
// rate written there before each replay.
int tv_rmsprop_lrp(const float* p, const float* g, float* rms, const uint8_t* pairs, float* out,
                   int X, int Y, int Z, int C, float coef, float beta, float omb,
                   const float* lr, float eps, void* stream) {
  return launch_sweep<true>(
      SweepArgs{p, g, rms, pairs, out, X, Y, Z, C, coef, beta, omb, 0.f, eps, lr}, stream);
}

}  // extern "C"

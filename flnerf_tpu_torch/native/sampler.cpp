// Native host runtime for the quadtree ray budgeter (copy of the reference
// package's flnerf_tpu/native/sampler.cpp, weighted sampler only).
//
// The reference's hot host path is Python loops over leaves with per-leaf
// np.random.choice over the sharpness-probability block
// (nerf-ours/tree.py:569-624 + image_process.py:77-96, run under a
// threadpool).  The uniform-draw path is already vectorized numpy in
// flnerf_tpu/rays/quadtree.py; this extension replaces the remaining
// per-leaf weighted-sampling Python loop with a single C++ pass:
// per leaf, normalize the block with the to_prob_v2 rule
// (clip to [0.01*mean, max]; image_process.py:60-75) and inverse-CDF sample.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

namespace {

// xorshift128+ PRNG — deterministic per call given the seed.
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    s0 = seed ^ 0x9E3779B97F4A7C15ULL;
    s1 = (seed << 21) | 0x1234567ULL;
    for (int i = 0; i < 8; ++i) next();
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  double uniform() {  // [0, 1)
    return (next() >> 11) * (1.0 / 9007199254740992.0);
  }
};

}  // namespace

extern "C" {

// Weighted per-leaf pixel sampling.
//   sharp:    [n_images * H * W] float32 sharpness maps
//   boxes:    [n_leaves * 4] float64 (x0, y0, x1, y1), x = row axis
//   img:      [n_leaves] int32 image id per leaf
//   counts:   [n_leaves] int64 rays to draw per leaf
//   out_px/py:[sum(counts)] int64 outputs (caller-allocated)
// Returns total rays written, or -1 on error.
int64_t sample_leaves_weighted(
    const float* sharp, int32_t n_images, int32_t H, int32_t W,
    const double* boxes, const int32_t* img, const int64_t* counts,
    int64_t n_leaves, uint64_t seed,
    int64_t* out_px, int64_t* out_py) {
  Rng rng(seed);
  std::vector<double> cdf;
  int64_t written = 0;

  for (int64_t li = 0; li < n_leaves; ++li) {
    int64_t c = counts[li];
    if (c <= 0) continue;
    int32_t im = img[li];
    if (im < 0 || im >= n_images) return -1;

    // block = sharp[int(x0):int(x1), int(y0):int(y1)] (tree.py:588)
    int64_t bx0 = (int64_t)boxes[li * 4 + 0];
    int64_t by0 = (int64_t)boxes[li * 4 + 1];
    int64_t bx1 = std::max((int64_t)boxes[li * 4 + 2], bx0 + 1);
    int64_t by1 = std::max((int64_t)boxes[li * 4 + 3], by0 + 1);
    bx0 = std::min(std::max(bx0, (int64_t)0), (int64_t)H - 1);
    by0 = std::min(std::max(by0, (int64_t)0), (int64_t)W - 1);
    bx1 = std::min(bx1, (int64_t)H);
    by1 = std::min(by1, (int64_t)W);
    int64_t bh = bx1 - bx0, bw = by1 - by0;
    int64_t bsize = bh * bw;

    const float* base = sharp + (int64_t)im * H * W;

    // to_prob_v2: g += 1e-6; clip to [0.01*mean, max]; normalize.
    double mean = 0.0, gmax = 0.0;
    for (int64_t r = 0; r < bh; ++r) {
      const float* row = base + (bx0 + r) * W + by0;
      for (int64_t q = 0; q < bw; ++q) {
        double g = (double)row[q] + 1e-6;
        mean += g;
        gmax = std::max(gmax, g);
      }
    }
    mean = 0.01 * (mean / (double)bsize);

    cdf.resize(bsize);
    double acc = 0.0;
    int64_t k = 0;
    for (int64_t r = 0; r < bh; ++r) {
      const float* row = base + (bx0 + r) * W + by0;
      for (int64_t q = 0; q < bw; ++q) {
        double g = (double)row[q] + 1e-6;
        g = std::min(std::max(g, mean), gmax);
        acc += g;
        cdf[k++] = acc;
      }
    }
    if (acc <= 0.0) acc = 1.0;

    for (int64_t j = 0; j < c; ++j) {
      double u = rng.uniform() * acc;
      int64_t idx = (int64_t)(std::lower_bound(cdf.begin(), cdf.end(), u) - cdf.begin());
      if (idx >= bsize) idx = bsize - 1;
      int64_t px = bx0 + idx / bw;
      int64_t py = by0 + idx % bw;
      out_px[written] = std::min(px, (int64_t)H - 1);
      out_py[written] = std::min(py, (int64_t)W - 1);
      ++written;
    }
  }
  return written;
}

}  // extern "C"

// Fused fixed-matrix stain normalization (K9), one thread-block cluster per
// tile (sm_90a).
//
// Replaces the Pallas TPU kernel fused_normalize_planar / _normalize_kernel
// (the JAX package's kernels/fused_stain.py:149-278). Per tile, against the
// tile's given source stain rows:
//   1. the exact K=2 lasso of every pixel's OD (_od_lasso) and the two
//      q-th percentile concentrations over every pixel, by count bisection
//      (14 rounds) and the exact successor;
//   2. rescale by maxC_target / maxC, 255*exp(-C M_tgt), clip, truncate to
//      uint8 on every pixel.
// The OD table holds _od_lasso's expression, -log(max(u, 1) * (1/255)), which
// differs from the other kernels' _od_and_mask OD in the last bit for 100 of
// the 256 byte values. K9 has no tissue mask, so its table is that one row.
// Bound: work per pixel, not bytes (2 x 196 KB per 256^2 tile): a lasso per
// pixel, 14 bisection rounds over two values per pixel, three expf per pixel.
// Design: one thread-block cluster of G blocks of 512 threads per tile, G from
// macenko_fused.cluster_plan's batch rule (one image spreads over 16 SMs; 256
// tiles take two blocks each, staged in device memory). The tile is read from
// device memory once: its 512-pixel chunks are dealt to the blocks in turns,
// and each pixel's lasso (its divisions through the Gram terms' kept
// reciprocals, stain::lasso2_by) is staged as two concentrations
// (stain::Staged, in shared memory or a device-memory scratch buffer), so the
// bisection bins staged values into leaf histograms, up to eight rounds and the
// successor per reduction (stain::staged_conc_percentiles): a chain of 3
// dependent reductions (the max, two passes of seven rounds). Since the sample
// is the whole tile, the apply takes each pixel's staged concentrations, not
// its bytes: the rescale and 255*exp(-C M_tgt), a byte store per channel
// (consecutive threads, consecutive pixels). Against an apply that reads the
// bytes again 8 pixels per thread (stain::map_image, K1's) and takes a second
// lasso, it measured the same at 256 tiles and 6-8% faster for one image and 16
// tiles of 512^2 (PERF.md, section 6). The per-tile source rows, the target
// rows and maxC_target arrive by pointer and stride (0: shared by all tiles),
// the regularizer by value. Reductions fold in a fixed order, so the output is
// bit-reproducible and the same at every G.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stain_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Args {
  const uint8_t* in;
  uint8_t* out;
  const float* luts;  // (256,): _od_lasso's OD of a byte
  const float* rows;  // tile i's values at ptr + i * stride (0: shared):
  const float* tgt;   //   source rows (6), target rows (6),
  const float* mct;   //   maxC_target (2)
  int rows_stride, tgt_stride, mct_stride;
  int n_pix, pix_stride, ch_stride;
  int nblk, blk, stp;  // the sample: the whole tile
  float y_thr;         // unused: no tissue mask
  float lam, q;
  int iters;
  int slice;       // sample pixels staged per block
  int levels;      // the most bisection rounds per reduction
  float* scratch;  // the blocks' stages in device memory, or nullptr
};

// The reduction buffers of stain::Staged: the successor's counts and minima
// (4 doubles), the bisection counts (14 ints), the maxima (2 floats).
struct ClusterShared {
  double dbuf[4 * kWarps];
  float lut[1][256];
  float fbuf[2 * kWarps];
  uint32_t hist[stain::hist_words(stain::kStaticLevels)];
  float res[8];
  stain::ClusterSlots cs;
};

__global__ void __launch_bounds__(kThreads, 2) fused_normalize_kernel(Args a) {
  __shared__ ClusterShared sh;
  extern __shared__ __align__(16) float stage[];
  stain::Staged s = stain::stage_tile<kThreads>(a, sh, stage, kThreads);
  const int tile = blockIdx.x / s.G;
  const float* rows = a.rows + (size_t)tile * a.rows_stride;
  const float* tgt = a.tgt + (size_t)tile * a.tgt_stride;
  const float* mct = a.mct + (size_t)tile * a.mct_stride;
  stain::ApplyScal as;
  for (int i = 0; i < 6; ++i) {
    as.he[i] = __ldg(rows + i);
    as.tgt[i] = __ldg(tgt + i);
  }
  as.g = stain::gram(as.he);
  as.lam = a.lam;

  // Phase 1: every pixel's lasso (its three divisors prepared once), its
  // two concentrations staged, then the two percentiles over the staged
  // values.
  float* c1v = s.vals;
  float* c2v = s.vals + s.cap;
  float chi[2] = {-stain::kBig, -stain::kBig};
  const stain::GramDiv gd = stain::gram_div(as.g);
  s.for_slice<kThreads>([&](int l, int p) {
    float o0, o1, o2, c1, c2;
    s.t.od(p, o0, o1, o2);
    stain::lasso2_by(o0, o1, o2, as.he, as.g, gd, as.lam, c1, c2);
    c1v[l] = c1;
    c2v[l] = c2;
    chi[0] = fmaxf(chi[0], c1);
    chi[1] = fmaxf(chi[1], c2);
  });
  float maxc[2];
  stain::staged_conc_percentiles<kThreads>(s, chi, a.q, a.iters, maxc);

  // Phase 2: rescale + reconstruction through the target rows of the
  // pixels this block staged, from their staged concentrations (the sample
  // is the whole tile): normalize_bytes' arithmetic after its lasso.
  as.scale1 = __ldg(mct) / fmaxf(maxc[0], 1e-8f);
  as.scale2 = __ldg(mct + 1) / fmaxf(maxc[1], 1e-8f);
  uint8_t* dst = a.out + (size_t)tile * 3 * a.n_pix;
  s.for_slice<kThreads>([&](int l, int p) {
    const float c1s = c1v[l] * as.scale1, c2s = c2v[l] * as.scale2;
    uint8_t* px = dst + (size_t)p * a.pix_stride;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      px[ch * a.ch_stride] = (uint8_t)stain::u8_trunc(
          255.0f * expf(-(c1s * as.tgt[ch] + c2s * as.tgt[3 + ch])));
  });
  stain::staged_end(s);
}

}  // namespace

// K9 over `batch` tiles of n_pix pixels, planar (pix_stride 1) or
// interleaved: clusters of G blocks, each staging `slice` pixels (12 bytes
// each; macenko_fused.cluster_plan) in `smem` bytes of dynamic shared
// memory or, where `scratch` is given (smem 0), in batch * G * 12 * slice
// bytes of device memory. rows / tgt / mct: float32 on the device, tile i's
// values at ptr + i * stride (stride 0: one set for all tiles).
extern "C" cudaError_t fused_normalize_launch(
    int device, const void* in, void* out, const void* rows, int rows_stride,
    const void* tgt, int tgt_stride, const void* mct, int mct_stride,
    const void* lut, int batch, int n_pix, int pix_stride, int ch_stride,
    float lam, float q, int iters, int G, int slice, int smem, int levels,
    void* scratch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  Args a;
  a.in = static_cast<const uint8_t*>(in);
  a.out = static_cast<uint8_t*>(out);
  a.luts = static_cast<const float*>(lut);
  a.rows = static_cast<const float*>(rows);
  a.tgt = static_cast<const float*>(tgt);
  a.mct = static_cast<const float*>(mct);
  a.rows_stride = rows_stride;
  a.tgt_stride = tgt_stride;
  a.mct_stride = mct_stride;
  a.n_pix = n_pix;
  a.pix_stride = pix_stride;
  a.ch_stride = ch_stride;
  // The percentile covers the whole tile: a one-block sample.
  a.nblk = 1;
  a.blk = n_pix;
  a.stp = n_pix;
  a.y_thr = 0.0f;
  a.lam = lam;
  a.q = q;
  a.iters = iters;
  a.slice = slice;
  a.levels = levels;
  a.scratch = static_cast<float*>(scratch);
  return stain::launch_cluster<fused_normalize_kernel>(
      a, device, batch, G, kThreads, smem, static_cast<cudaStream_t>(stream));
}

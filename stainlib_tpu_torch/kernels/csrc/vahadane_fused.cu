// Fused Vahadane kernels (sm_90a): fit + transform (K2) and the dictionary
// (K8), each one thread-block cluster per tile.
//
// vahadane_normalize_kernel replaces the Pallas TPU kernel
// vahadane_normalize_planar / _vahadane_full_kernel (the JAX package's
// kernels/vahadane_fused.py:111-215, :342-404). Per tile:
//   1. the Macenko warm start on the estimation sample (K1's phases 1-3,
//      angular percentiles 1 and 99);
//   2. num_iters BCD alternations on the sample (_bcd_iteration :218-278):
//      each one pass of lasso codes at the fit regularizer and nine masked
//      sums (accumulated in double, rounded once) in one reduction, then
//      the two row sweeps;
//   3. H-first swap on the unnormalized rows, row normalization;
//   4. the apply lasso and the two 99th-percentile concentrations over the
//      sample (unmasked);
//   5. rescale, 255*exp(-C M_tgt), clip, truncate to uint8 on every pixel.
// A tile with an empty mask keeps its BCD start and reconstructs with zero
// concentrations: white stays white, as in the TPU kernel.
//
// Bound: work per pixel, not bytes. At fs=2 it=8 nb=10 a tile takes 15
// passes over its sample; 4 of them (the bisection passes) only bin one
// per-pixel value (pseudo-angle, concentration) into leaf histograms, so
// that value is worth keeping. Design:
// one cluster of G blocks of 512 threads per tile (G from
// macenko_fused.cluster_plan: 4 at 256^2 fs=2, 16 at 512^2), each block
// owning a slice of the sample; the stain::Staged phases (stain_common.cuh)
// stage the slice's bytes and mask bits in the first pass, the angles,
// then the two concentrations, in shared memory, so the bisection rounds
// read staged values (up to eight rounds and the successor per reduction,
// as far as the stage leaves shared memory for the histograms: 7 beside
// K2's 96 KB stages at 256^2 fs=2) and the angle,
// BCD and concentration passes read no device memory; the apply pass is
// split over the cluster. A sample larger than 16 blocks' shared memory
// holds (over 293K pixels) is staged in a device-memory scratch buffer
// instead, by the same code. Reductions
// run over the block, then across the cluster through distributed shared
// memory in rank order; the scalar step after a sum (eigenplane, BCD
// update) runs on one thread and is broadcast. A BCD pass divides by its
// three divisors with the loop-invariant half of each division kept
// (stain::lasso2_by: the division's own bits). The output is
// bit-reproducible and equals the plain version's. A tile is then a chain
// of 15 dependent reductions, and the time grows with the blocks per tile
// (PERF.md, section 5).
//
// vahadane_dict_kernel replaces vahadane_stain_matrix_planar / _dict_kernel
// (:48-108, :286-323): phases 1-2 only, on the whole tile at the callers'
// fit_stride=1, writing [D(6), n_valid, 0] per tile; the wrapper does the swap
// / normalization / NaN post-pass. Bound: work per pixel; at it=12 nb=14 a tile
// is 12 BCD passes (a lasso, nine products and nine double sums per tissue
// pixel) after a warm start of 5 reductions. Design: K2's cluster and stage, G
// from cluster_plan("K8"), which weighs the batch against the card's SMs (one
// image spreads over 16 of them; 256 tiles take two blocks each, staged in
// device memory). The sample's chunks of 512 pixels are dealt to the cluster's
// blocks in turns, so a band of background idles no block. The warm start reads
// device memory once and then staged values only (stain::staged_macenko_rows);
// the 12 alternations read one staged word per pixel (its bytes and mask bit)
// in place of three bytes from device memory, skip a pixel outside the mask,
// and divide as K2's do (stain::staged_bcd_iteration). Rank 0 writes the eight
// floats. A chain of 16 dependent reductions per tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stain_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Args {
  const uint8_t* in;
  void* out;          // u8 tiles (normalize) or (B, 8) f32 (dictionary)
  const float* scal;  // (B, 8): target rows (6), maxC (2); unused by dict
  const float* luts;  // (4, 256): OD, then 3 luminance terms
  int n_pix, pix_stride, ch_stride;
  int nblk, blk, stp;
  float y_thr, lam_fit, lam, q_lo, q_hi, q_conc;
  int num_iters, it_angle, it_conc;
  int slice;      // sample pixels staged per block
  int levels;     // the most bisection rounds per reduction
  float* scratch;  // the blocks' stages in device memory, or nullptr
};

// One cluster of G blocks per tile (blockIdx.x / G), the bisection
// operands and the sample's bytes staged in `stage` (dynamic shared memory,
// 12 * a.slice bytes) or, with a.scratch, in the block's part of it.
struct ClusterShared {
  double dbuf[10 * kWarps];
  float lut[4][256];
  float fbuf[2 * kWarps];
  uint32_t hist[stain::hist_words(stain::kStaticLevels)];
  float res[8];
  stain::ClusterSlots cs;
};

__global__ void __launch_bounds__(kThreads, 2) vahadane_normalize_kernel(Args a) {
  __shared__ ClusterShared sh;
  extern __shared__ __align__(16) float stage[];
  stain::Staged s = stain::stage_tile<kThreads>(a, sh, stage, 0);
  const stain::Tile& t = s.t;
  const unsigned G = s.G;
  const int tile = blockIdx.x / G;
  const size_t tile_off = (size_t)tile * 3 * a.n_pix;
  const float* scal = a.scal + tile * 8;

  // Phases 1-2: warm start and BCD on the sample.
  float D[6];
  stain::staged_macenko_rows<kThreads>(s, a.q_lo, a.q_hi, a.it_angle, D);
  for (int it = 0; it < a.num_iters; ++it)
    stain::staged_bcd_iteration<kThreads>(s, D, a.lam_fit);
  // Phase 3: H first, rows normalized.
  float he[6];
  stain::finalize_rows(D, he);
  // Phase 4: apply lasso, 99th-pct concentrations over the sample.
  const stain::Gram g = stain::gram(he);
  float maxc[2];
  stain::staged_conc_maxc<kThreads>(s, he, g, a.lam, a.q_conc, a.it_conc,
                                    maxc);
  // Phase 5: rescale + reconstruction through the target rows, this
  // block's share of the tile's pixels.
  const int per = (a.n_pix + (int)G - 1) / (int)G;
  const int p0 = (int)s.rank * per, p1 = min(a.n_pix, p0 + per);
  const float scale1 = scal[6] / fmaxf(maxc[0], 1e-8f);
  const float scale2 = scal[7] / fmaxf(maxc[1], 1e-8f);
  uint8_t* dst = static_cast<uint8_t*>(a.out) + tile_off;
  for (int p = p0 + threadIdx.x; p < p1; p += kThreads) {
    float o0, o1, o2, c1, c2;
    t.od(p, o0, o1, o2);
    stain::lasso2(o0, o1, o2, he, g, a.lam, c1, c2);
    stain::write_pixel(dst + (size_t)p * a.pix_stride, a.ch_stride,
                       c1 * scale1, c2 * scale2, scal);
  }
  stain::staged_end(s);
}

__global__ void __launch_bounds__(kThreads, 2) vahadane_dict_kernel(Args a) {
  __shared__ ClusterShared sh;
  extern __shared__ __align__(16) float stage[];
  stain::Staged s = stain::stage_tile<kThreads>(a, sh, stage, kThreads);
  // Phases 1-2: warm start and BCD on the sample.
  float D[6];
  const float n_valid =
      stain::staged_macenko_rows<kThreads>(s, a.q_lo, a.q_hi, a.it_angle, D);
  for (int it = 0; it < a.num_iters; ++it)
    stain::staged_bcd_iteration<kThreads>(s, D, a.lam_fit);
  if (s.rank == 0 && threadIdx.x == 0) {
    float* out = static_cast<float*>(a.out) + blockIdx.x / s.G * 8;
    for (int i = 0; i < 6; ++i) out[i] = D[i];
    out[6] = n_valid;
    out[7] = 0.0f;
  }
  stain::staged_end(s);
}

Args make_args(const void* in, void* out, const void* scal, const void* luts,
               int n_pix, int pix_stride, int ch_stride, int nblk, int blk,
               int stp, float y_thr, float lam_fit, float lam, float q_lo,
               float q_hi, float q_conc, int num_iters, int it_angle,
               int it_conc, int slice, int levels, float* scratch) {
  Args a;
  a.in = static_cast<const uint8_t*>(in);
  a.out = out;
  a.scal = static_cast<const float*>(scal);
  a.luts = static_cast<const float*>(luts);
  a.n_pix = n_pix;
  a.pix_stride = pix_stride;
  a.ch_stride = ch_stride;
  a.nblk = nblk;
  a.blk = blk;
  a.stp = stp;
  a.y_thr = y_thr;
  a.lam_fit = lam_fit;
  a.lam = lam;
  a.q_lo = q_lo;
  a.q_hi = q_hi;
  a.q_conc = q_conc;
  a.num_iters = num_iters;
  a.it_angle = it_angle;
  a.it_conc = it_conc;
  a.slice = slice;
  a.levels = levels;
  a.scratch = scratch;
  return a;
}

}  // namespace

// K2 and K8 over `batch` tiles: clusters of G blocks, each staging `slice`
// sample pixels (12 bytes each; macenko_fused.cluster_plan) in `smem` bytes
// of dynamic shared memory or, where `scratch` is given (smem 0), in
// batch * G * 12 * slice bytes of device memory.
extern "C" cudaError_t vahadane_normalize_launch(
    int device, const void* in, void* out, const void* scal, const void* luts,
    int batch, int n_pix, int pix_stride, int ch_stride, int nblk, int blk,
    int stp, float y_thr, float lam_fit, float lam, float q_lo, float q_hi,
    float q_conc, int num_iters, int it_angle, int it_conc, int G, int slice,
    int smem, int levels, void* scratch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  const Args a = make_args(in, out, scal, luts, n_pix, pix_stride, ch_stride,
                           nblk, blk, stp, y_thr, lam_fit, lam, q_lo, q_hi,
                           q_conc, num_iters, it_angle, it_conc, slice,
                           levels, static_cast<float*>(scratch));
  return stain::launch_cluster<vahadane_normalize_kernel>(
      a, device, batch, G, kThreads, smem, static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t vahadane_dict_launch(
    int device, const void* in, void* out, const void* luts, int batch,
    int n_pix, int pix_stride, int ch_stride, int nblk, int blk, int stp,
    float y_thr, float lam_fit, float q_lo, float q_hi, int num_iters,
    int it_angle, int G, int slice, int smem, int levels, void* scratch,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  const Args a = make_args(in, out, nullptr, luts, n_pix, pix_stride,
                           ch_stride, nblk, blk, stp, y_thr, lam_fit, 0.0f,
                           q_lo, q_hi, 0.0f, num_iters, it_angle, 0, slice,
                           levels, static_cast<float*>(scratch));
  return stain::launch_cluster<vahadane_dict_kernel>(
      a, device, batch, G, kThreads, smem, static_cast<cudaStream_t>(stream));
}

// Fused Vahadane kernels, one thread block per tile (sm_90a).
//
// vahadane_normalize_kernel replaces the Pallas TPU kernel
// vahadane_normalize_planar / _vahadane_full_kernel (the JAX package's
// kernels/vahadane_fused.py:111-215, :342-404). Per tile:
//   1. the Macenko warm start on the estimation sample (K1's phases 1-3,
//      stain::macenko_rows, angular percentiles 1 and 99);
//   2. num_iters BCD alternations on the sample (_bcd_iteration :218-278):
//      each one pass of lasso codes at the fit regularizer and nine masked
//      sums (accumulated in double, rounded once) in one block reduction,
//      then the two row sweeps;
//   3. H-first swap on the unnormalized rows, row normalization;
//   4. the apply lasso and the two 99th-percentile concentrations over the
//      sample (unmasked);
//   5. rescale, 255*exp(-C M_tgt), clip, truncate to uint8 on every pixel.
// A tile with an empty mask keeps its BCD start and reconstructs with zero
// concentrations: white stays white, as in the TPU kernel.
//
// vahadane_dict_kernel replaces vahadane_stain_matrix_planar / _dict_kernel
// (:48-108, :286-323): phases 1-2 only, writing [D(6), n_valid, 0] per
// tile; the wrapper does the swap / normalization / NaN post-pass.
//
// Bound: work per pixel, as K1 (macenko_fused.cu). At fs=2 it=8 nb=10 a
// 256^2 tile's passes visit 16.5 tiles' worth of pixels (K1: 12.5), and the
// 8 BCD passes carry a lasso and 9 products per tissue pixel. Simple design,
// K1's: strided passes over the tile re-read from device memory (L2 keeps
// it), OD and luminance from shared 256-entry tables, fixed-order block
// reductions (no float atomics), so the output is bit-reproducible.

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
};

struct Shared {
  double dbuf[9 * kWarps];
  float lut[4][256];
  float fbuf[2 * kWarps];
  int ibuf[2 * kWarps];
  float v_sh[6];
  float d_sh[6];
};

// Phases 1-2: warm start and BCD on the estimation sample -> D, n_valid.
__device__ __forceinline__ float fit_dictionary(const Args& a, Shared& sh,
                                                const stain::Tile& t,
                                                float D[6]) {
  const float n_valid = stain::macenko_rows<kThreads>(
      t, a.q_lo, a.q_hi, a.it_angle, sh.fbuf, sh.ibuf, sh.dbuf, sh.v_sh, D);
  for (int it = 0; it < a.num_iters; ++it)
    stain::bcd_iteration<kThreads>(t, D, a.lam_fit, sh.dbuf, sh.d_sh);
  return n_valid;
}

__device__ __forceinline__ stain::Tile load_tile(const Args& a, Shared& sh) {
  for (int i = threadIdx.x; i < 4 * 256; i += kThreads)
    sh.lut[i >> 8][i & 255] = a.luts[i];
  __syncthreads();
  const size_t tile_off = (size_t)blockIdx.x * 3 * a.n_pix;
  return stain::Tile{a.in + tile_off, sh.lut, a.n_pix, a.pix_stride,
                     a.ch_stride, a.nblk, a.blk, a.stp, a.y_thr};
}

__global__ void __launch_bounds__(kThreads, 2) vahadane_normalize_kernel(Args a) {
  __shared__ Shared sh;
  const stain::Tile t = load_tile(a, sh);
  const float* scal = a.scal + blockIdx.x * 8;

  float D[6];
  fit_dictionary(a, sh, t, D);
  // Phase 3: H first, rows normalized.
  float he[6];
  stain::finalize_rows(D, he);
  // Phase 4: apply lasso, 99th-pct concentrations over the sample.
  const stain::Gram g = stain::gram(he);
  float maxc[2];
  stain::conc_maxc<kThreads>(t, he, g, a.lam, a.q_conc, a.it_conc, sh.fbuf,
                             sh.ibuf, maxc);
  // Phase 5: rescale + reconstruction through the target rows.
  uint8_t* dst = static_cast<uint8_t*>(a.out) + (size_t)blockIdx.x * 3 * a.n_pix;
  stain::reconstruct<kThreads>(t, dst, he, g, a.lam, maxc, scal, scal[6],
                               scal[7]);
}

__global__ void __launch_bounds__(kThreads, 2) vahadane_dict_kernel(Args a) {
  __shared__ Shared sh;
  const stain::Tile t = load_tile(a, sh);
  float D[6];
  const float n_valid = fit_dictionary(a, sh, t, D);
  if (threadIdx.x == 0) {
    float* out = static_cast<float*>(a.out) + blockIdx.x * 8;
    for (int i = 0; i < 6; ++i) out[i] = D[i];
    out[6] = n_valid;
    out[7] = 0.0f;
  }
}

cudaError_t launch(bool dict, int device, const void* in, void* out,
                   const void* scal, const void* luts, int batch, int n_pix,
                   int pix_stride, int ch_stride, int nblk, int blk, int stp,
                   float y_thr, float lam_fit, float lam, float q_lo,
                   float q_hi, float q_conc, int num_iters, int it_angle,
                   int it_conc, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dict)
    vahadane_dict_kernel<<<batch, kThreads, 0, s>>>(a);
  else
    vahadane_normalize_kernel<<<batch, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t vahadane_normalize_launch(
    int device, const void* in, void* out, const void* scal, const void* luts,
    int batch, int n_pix, int pix_stride, int ch_stride, int nblk, int blk,
    int stp, float y_thr, float lam_fit, float lam, float q_lo, float q_hi,
    float q_conc, int num_iters, int it_angle, int it_conc, void* stream) {
  return launch(false, device, in, out, scal, luts, batch, n_pix, pix_stride,
                ch_stride, nblk, blk, stp, y_thr, lam_fit, lam, q_lo, q_hi,
                q_conc, num_iters, it_angle, it_conc, stream);
}

extern "C" cudaError_t vahadane_dict_launch(
    int device, const void* in, void* out, const void* luts, int batch,
    int n_pix, int pix_stride, int ch_stride, int nblk, int blk, int stp,
    float y_thr, float lam_fit, float q_lo, float q_hi, int num_iters,
    int it_angle, void* stream) {
  return launch(true, device, in, out, nullptr, luts, batch, n_pix,
                pix_stride, ch_stride, nblk, blk, stp, y_thr, lam_fit, 0.0f,
                q_lo, q_hi, 0.0f, num_iters, it_angle, 0, stream);
}

// Fused Macenko fit + transform, one thread block per tile (sm_90a).
//
// Replaces the Pallas TPU kernel macenko_normalize_planar / _apply_kernel
// (the JAX package's kernels/macenko_fused.py:413-490, :541-608). Per tile:
//   1. ten masked OD moments over the estimation sample;
//   2. the eigenplane (scalar Newton eigh, one thread, broadcast);
//   3. the two masked angular percentiles by count bisection, both counted
//      in one pass per round, then the exact successor recovery;
//   4. stain rows, the exact K=2 lasso, and the two 99th-percentile
//      concentration searches over the sample (unmasked);
//   5. rescale, 255*exp(-od), clip, truncate to uint8 for every pixel.
// Bound: not bytes (2 x 196 KB per 256^2 tile) but work per pixel. A tile
// is a chain of about 25 dependent block-wide reductions; at fs=2 nb=10 its
// passes visit 12.5 tiles' worth of pixels, and once two tiles share an SM
// the time follows that count (measured on an H100: 0.78 ms for 132 tiles,
// 1.34 ms for 256). Simple design: every phase is a strided pass over the
// tile, re-read from device memory (L2 keeps it close), followed by a
// fixed-order block reduction, so the output is bit-reproducible.
// OD and the luminance terms come from 256-entry tables that the wrapper
// builds with the plain version's own expressions. The phases are the
// shared device functions of stain_common.cuh (macenko_rows, conc_maxc,
// reconstruct), which the Vahadane kernels reuse; stain::Tile there
// describes the planar / interleaved layouts and the estimation sample.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stain_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Args {
  const uint8_t* in;
  uint8_t* out;
  const float* scal;  // (B, 8): target rows (6), maxC (2)
  const float* luts;  // (4, 256): OD, then 3 luminance terms
  int n_pix, pix_stride, ch_stride;
  int nblk, blk, stp;
  float y_thr, lam, q_lo, q_hi, q_conc;
  int it_angle, it_conc;
};

__global__ void __launch_bounds__(kThreads, 2) macenko_apply_kernel(Args a) {
  __shared__ float lut[4][256];
  __shared__ double dbuf[9 * kWarps];
  __shared__ float fbuf[2 * kWarps];
  __shared__ int ibuf[2 * kWarps];
  __shared__ float v_sh[6];

  const size_t tile_off = (size_t)blockIdx.x * 3 * a.n_pix;
  const float* scal = a.scal + blockIdx.x * 8;
  for (int i = threadIdx.x; i < 4 * 256; i += kThreads) lut[i >> 8][i & 255] = a.luts[i];
  __syncthreads();
  const stain::Tile t{a.in + tile_off, lut, a.n_pix, a.pix_stride, a.ch_stride,
                      a.nblk, a.blk, a.stp, a.y_thr};

  // Phases 1-3: moments, eigenplane, angular percentiles, stain rows.
  float he[6];
  stain::macenko_rows<kThreads>(t, a.q_lo, a.q_hi, a.it_angle, fbuf, ibuf,
                                dbuf, v_sh, he);
  // Phase 4: 99th-pct concentrations over the sample.
  const stain::Gram g = stain::gram(he);
  float maxc[2];
  stain::conc_maxc<kThreads>(t, he, g, a.lam, a.q_conc, a.it_conc, fbuf, ibuf,
                             maxc);
  // Phase 5: rescale + Beer-Lambert reconstruction on every pixel.
  stain::reconstruct<kThreads>(t, a.out + tile_off, he, g, a.lam, maxc, scal,
                               scal[6], scal[7]);
}

}  // namespace

extern "C" cudaError_t macenko_normalize_launch(
    int device, const void* in, void* out, const void* scal, const void* luts,
    int batch, int n_pix, int pix_stride, int ch_stride, int nblk, int blk,
    int stp, float y_thr, float lam, float q_lo, float q_hi, float q_conc,
    int it_angle, int it_conc, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  Args a;
  a.in = static_cast<const uint8_t*>(in);
  a.out = static_cast<uint8_t*>(out);
  a.scal = static_cast<const float*>(scal);
  a.luts = static_cast<const float*>(luts);
  a.n_pix = n_pix;
  a.pix_stride = pix_stride;
  a.ch_stride = ch_stride;
  a.nblk = nblk;
  a.blk = blk;
  a.stp = stp;
  a.y_thr = y_thr;
  a.lam = lam;
  a.q_lo = q_lo;
  a.q_hi = q_hi;
  a.q_conc = q_conc;
  a.it_angle = it_angle;
  a.it_conc = it_conc;
  macenko_apply_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" const char* stain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

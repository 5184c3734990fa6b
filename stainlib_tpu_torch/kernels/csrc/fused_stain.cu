// Fused fixed-matrix stain normalization, one thread block per tile (sm_90a).
//
// Replaces the Pallas TPU kernel fused_normalize_planar / _normalize_kernel
// (the JAX package's kernels/fused_stain.py:149-278). Per tile, against the
// tile's given source stain rows:
//   1. the exact K=2 lasso of every pixel's OD (_od_lasso) and the two
//      q-th percentile concentrations over every pixel, by count bisection
//      (14 rounds) with the exact successor recovery;
//   2. rescale by maxC_target / maxC, 255*exp(-C M_tgt), clip, truncate to
//      uint8 on every pixel.
// The OD table (row 0 of `luts`) holds _od_lasso's expression,
// -log(max(u, 1) * (1/255)), which differs from the other kernels'
// _od_and_mask OD in the last bit for 100 of the 256 byte values.
// Bound: work per pixel: 17 passes over the whole tile (max, 14 rounds,
// successor, apply), each a lasso per pixel. Simple design, as K6
// (macenko_fused.cu): strided passes re-reading the tile through L2, a
// shared OD table, fixed-order block reductions (bit-reproducible).

#include <cuda_runtime.h>
#include <stdint.h>

#include "stain_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Per-tile scalar table, the TPU kernel's layout: [0:6] source rows,
// [6:12] target rows, [12:14] maxC_target, [14] lasso regularizer, [15] pad.
constexpr int kScal = 16;

struct Args {
  const uint8_t* in;
  uint8_t* out;
  const float* scal;  // (B, 16)
  const float* lut;   // (256,): _od_lasso's OD of a byte
  int n_pix, pix_stride, ch_stride;
  float q;
  int iters;
};

__global__ void __launch_bounds__(kThreads, 2) fused_normalize_kernel(Args a) {
  __shared__ float lut[1][256];
  __shared__ float fbuf[2 * kWarps];
  __shared__ int ibuf[2 * kWarps];

  for (int i = threadIdx.x; i < 256; i += kThreads) lut[0][i] = a.lut[i];
  __syncthreads();
  const size_t tile_off = (size_t)blockIdx.x * 3 * a.n_pix;
  // The percentile covers the whole tile: a one-block sample.
  const stain::Tile t{a.in + tile_off, lut, a.n_pix, a.pix_stride,
                      a.ch_stride, 1, a.n_pix, a.n_pix, 0.0f};
  const float* scal = a.scal + blockIdx.x * kScal;
  float he[6];
  for (int i = 0; i < 6; ++i) he[i] = scal[i];
  const float lam = scal[14];
  const stain::Gram g = stain::gram(he);
  float maxc[2];
  stain::conc_maxc<kThreads>(t, he, g, lam, a.q, a.iters, fbuf, ibuf, maxc);
  stain::reconstruct<kThreads>(t, a.out + tile_off, he, g, lam, maxc,
                               scal + 6, scal[12], scal[13]);
}

}  // namespace

extern "C" cudaError_t fused_normalize_launch(
    int device, const void* in, void* out, const void* scal, const void* lut,
    int batch, int n_pix, int pix_stride, int ch_stride, float q, int iters,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  Args a;
  a.in = static_cast<const uint8_t*>(in);
  a.out = static_cast<uint8_t*>(out);
  a.scal = static_cast<const float*>(scal);
  a.lut = static_cast<const float*>(lut);
  a.n_pix = n_pix;
  a.pix_stride = pix_stride;
  a.ch_stride = ch_stride;
  a.q = q;
  a.iters = iters;
  fused_normalize_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

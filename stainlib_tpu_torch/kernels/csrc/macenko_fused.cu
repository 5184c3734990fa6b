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
// builds with the plain version's own expressions.
//
// Pixel p, channel c of tile t lives at in[t*3*n_pix + p*pix_stride +
// c*ch_stride]: (1, n_pix) reads planar (B, 3, R, 128) tiles, (3, 1)
// interleaved (B, H, W, 3) ones. The estimation sample is `nblk` blocks of
// `blk` consecutive pixels, block i starting at pixel i*stp (the JAX
// kernel's _stride_rows in flat pixel units); nblk = 1, blk = stp = n_pix
// is the full tile.

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

struct Pixel {
  float od0, od1, od2;
  bool mask;
};

__device__ __forceinline__ Pixel load_pixel(const uint8_t* __restrict__ src,
                                            int p, const Args& a,
                                            const float (*lut)[256]) {
  const uint8_t* px = src + (size_t)p * a.pix_stride;
  const int r = __ldg(px), g = __ldg(px + a.ch_stride), b = __ldg(px + 2 * a.ch_stride);
  Pixel o;
  o.od0 = lut[0][r];
  o.od1 = lut[0][g];
  o.od2 = lut[0][b];
  o.mask = lut[1][r] + lut[2][g] + lut[3][b] < a.y_thr;
  return o;
}

// Visit every pixel of the estimation sample, in a fixed per-thread order.
template <typename F>
__device__ __forceinline__ void for_sample(const Args& a, F&& f) {
  for (int i = 0; i < a.nblk; ++i)
    for (int j = threadIdx.x; j < a.blk; j += kThreads) f(i * a.stp + j);
}

// np.percentile's linear rule from the bracket top, the count at or below
// it and the smallest value above it (fused_stain.py:136-146).
__device__ __forceinline__ float interpolate(float hi, int cnt_hi, float succ,
                                             float rank, float frac) {
  const float v_b = (float)cnt_hi > rank + 1.0f ? hi : succ;
  return hi * (1.0f - frac) + v_b * frac;
}

__global__ void __launch_bounds__(kThreads, 2) macenko_apply_kernel(Args a) {
  __shared__ float lut[4][256];
  __shared__ float fbuf[10 * kWarps];
  __shared__ int ibuf[2 * kWarps];
  __shared__ float v_sh[6];

  const size_t tile_off = (size_t)blockIdx.x * 3 * a.n_pix;
  const uint8_t* __restrict__ src = a.in + tile_off;
  uint8_t* __restrict__ dst = a.out + tile_off;
  const float* scal = a.scal + blockIdx.x * 8;
  for (int i = threadIdx.x; i < 4 * 256; i += kThreads) lut[i >> 8][i & 255] = a.luts[i];
  __syncthreads();

  // Phase 1: masked OD moments over the sample.
  float st[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int cnt[2] = {0, 0};
  for_sample(a, [&](int p) {
    const Pixel x = load_pixel(src, p, a, lut);
    if (x.mask) {
      cnt[0] += 1;
      st[1] += x.od0;
      st[2] += x.od1;
      st[3] += x.od2;
      st[4] += x.od0 * x.od0;
      st[5] += x.od0 * x.od1;
      st[6] += x.od0 * x.od2;
      st[7] += x.od1 * x.od1;
      st[8] += x.od1 * x.od2;
      st[9] += x.od2 * x.od2;
    }
  });
  stain::block_sum<kThreads, 10>(st, fbuf);
  stain::block_count<kThreads, 2>(cnt, ibuf);
  st[0] = (float)cnt[0];
  const float n_valid = st[0];

  // Phase 2: eigenplane, one thread, broadcast through shared memory.
  if (threadIdx.x == 0) stain::eigenplane_scalars(st, v_sh);
  __syncthreads();
  float v[6];
  for (int i = 0; i < 6; ++i) v[i] = v_sh[i];

  // Phase 3: masked angular percentiles. Unmasked pixels read as kBig.
  auto angle_at = [&](int p) {
    const Pixel x = load_pixel(src, p, a, lut);
    return x.mask ? stain::pseudo_angle(x.od0, x.od1, x.od2, v) : stain::kBig;
  };
  float lo_hi[2] = {4.0f, 0.0f};  // data-seeded bracket: masked min, max
  {
    float mn[1] = {4.0f}, mx[1] = {0.0f};
    for_sample(a, [&](int p) {
      const float vm = angle_at(p);
      if (vm < stain::kBig) {
        mn[0] = fminf(mn[0], vm);
        mx[0] = fmaxf(mx[0], vm);
      }
    });
    stain::block_extreme<kThreads, 1, true>(mn, fbuf);
    stain::block_extreme<kThreads, 1, false>(mx, fbuf);
    lo_hi[0] = mn[0];
    lo_hi[1] = fmaxf(mx[0], mn[0]);
  }
  const float nm1 = fmaxf(n_valid - 1.0f, 0.0f);
  float rank[2] = {a.q_lo * nm1, a.q_hi * nm1}, frac[2];
  for (int k = 0; k < 2; ++k) {
    const float r = floorf(rank[k]);
    frac[k] = rank[k] - r;
    rank[k] = r;
  }
  float lo[2] = {lo_hi[0], lo_hi[0]}, hi[2] = {lo_hi[1], lo_hi[1]};
  for (int it = 0; it < a.it_angle; ++it) {
    const float mid[2] = {0.5f * (lo[0] + hi[0]), 0.5f * (lo[1] + hi[1])};
    int c[2] = {0, 0};
    for_sample(a, [&](int p) {
      const float vm = angle_at(p);
      c[0] += vm <= mid[0];
      c[1] += vm <= mid[1];
    });
    stain::block_count<kThreads, 2>(c, ibuf);
    for (int k = 0; k < 2; ++k) {
      if ((float)c[k] > rank[k]) hi[k] = mid[k];
      else lo[k] = mid[k];
    }
  }
  float bounds[2];
  {
    int c[2] = {0, 0};
    float succ[2] = {stain::kBig, stain::kBig};
    for_sample(a, [&](int p) {
      const float vm = angle_at(p);
      for (int k = 0; k < 2; ++k) {
        c[k] += vm <= hi[k];
        if (vm > hi[k]) succ[k] = fminf(succ[k], vm);
      }
    });
    stain::block_count<kThreads, 2>(c, ibuf);
    stain::block_extreme<kThreads, 2, true>(succ, fbuf);
    for (int k = 0; k < 2; ++k)
      bounds[k] = interpolate(hi[k], c[k], succ[k], rank[k], frac[k]);
  }

  // Phase 4: stain rows, lasso, 99th-pct concentrations over the sample.
  float he[6];
  stain::stain_rows_from_bounds(v, bounds[0], bounds[1], he);
  const stain::Gram g = stain::gram(he);
  auto conc_at = [&](int p, float& c1, float& c2) {
    const Pixel x = load_pixel(src, p, a, lut);
    stain::lasso2(x.od0, x.od1, x.od2, he, g, a.lam, c1, c2);
  };
  float chi[2] = {-stain::kBig, -stain::kBig};
  for_sample(a, [&](int p) {
    float c1, c2;
    conc_at(p, c1, c2);
    chi[0] = fmaxf(chi[0], c1);
    chi[1] = fmaxf(chi[1], c2);
  });
  stain::block_extreme<kThreads, 2, false>(chi, fbuf);
  const float n_fit = (float)(a.nblk * a.blk);
  float crank[2], cfrac[2];
  for (int k = 0; k < 2; ++k) {
    const float r = a.q_conc * fmaxf(n_fit - 1.0f, 0.0f);
    crank[k] = floorf(r);
    cfrac[k] = r - crank[k];
  }
  float clo[2] = {0.0f, 0.0f};
  for (int it = 0; it < a.it_conc; ++it) {
    const float mid[2] = {0.5f * (clo[0] + chi[0]), 0.5f * (clo[1] + chi[1])};
    int c[2] = {0, 0};
    for_sample(a, [&](int p) {
      float c1, c2;
      conc_at(p, c1, c2);
      c[0] += c1 <= mid[0];
      c[1] += c2 <= mid[1];
    });
    stain::block_count<kThreads, 2>(c, ibuf);
    for (int k = 0; k < 2; ++k) {
      if ((float)c[k] > crank[k]) chi[k] = mid[k];
      else clo[k] = mid[k];
    }
  }
  float maxc[2];
  {
    int c[2] = {0, 0};
    float succ[2] = {stain::kBig, stain::kBig};
    for_sample(a, [&](int p) {
      float cc[2];
      conc_at(p, cc[0], cc[1]);
      for (int k = 0; k < 2; ++k) {
        c[k] += cc[k] <= chi[k];
        if (cc[k] > chi[k]) succ[k] = fminf(succ[k], cc[k]);
      }
    });
    stain::block_count<kThreads, 2>(c, ibuf);
    stain::block_extreme<kThreads, 2, true>(succ, fbuf);
    for (int k = 0; k < 2; ++k)
      maxc[k] = interpolate(chi[k], c[k], succ[k], crank[k], cfrac[k]);
  }

  // Phase 5: rescale + Beer-Lambert reconstruction on every pixel.
  const float scale1 = scal[6] / fmaxf(maxc[0], 1e-8f);
  const float scale2 = scal[7] / fmaxf(maxc[1], 1e-8f);
  for (int p = threadIdx.x; p < a.n_pix; p += kThreads) {
    float c1, c2;
    conc_at(p, c1, c2);
    const float c1s = c1 * scale1, c2s = c2 * scale2;
    uint8_t* px = dst + (size_t)p * a.pix_stride;
    for (int ch = 0; ch < 3; ++ch) {
      const float val = 255.0f * expf(-(c1s * scal[ch] + c2s * scal[3 + ch]));
      px[ch * a.ch_stride] = (uint8_t)(int)fminf(fmaxf(val, 0.0f), 255.0f);
    }
  }
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

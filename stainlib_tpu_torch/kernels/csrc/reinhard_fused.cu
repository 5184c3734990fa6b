// Fused Reinhard normalization, one thread block per tile (sm_90a).
//
// Replaces the Pallas TPU kernel reinhard_normalize_planar /
// _reinhard_kernel (the JAX package's kernels/reinhard_fused.py:140-231,
// helpers _percentile_u8_multi :29-72, _rgb_to_lab_planes :75-103,
// _lab_to_rgb_planes :106-137). Per tile:
//   1. the joint q-th percentile of the tile's 3N channel bytes
//      (np.percentile's linear rule): a 256-bin shared-memory histogram
//      with integer atomics gives the rank-floor order statistic and its
//      successor exactly, as the TPU kernel's 10-round bisection over the
//      integer grid does; integer counts do not depend on order;
//   2. brightness floor(clip(c*255/p, 0, 255)) per channel, sRGB -> CIELAB
//      (linearization from a 256-entry table, since the bright value is a
//      byte; cbrt as exp(log/3) plus one Newton step), the uint8-LAB
//      quantize, and the six L/a/b sums and sums of squares accumulated in
//      double, rounded once -> per-channel mean and population std;
//   3. recompute the quantized LAB of every pixel, the affine transfer to
//      the target statistics, the merge-back floor in the packed domain,
//      CIELAB -> sRGB, round, clip, uint8.
// Every expression keeps the TPU kernel's operation order (c*255 then /p;
// true divisions by the constants), and the library is built with
// -fmad=false: the rounds and floors turn one-ulp differences into whole
// uint8 steps. Bound: per-pixel arithmetic (three expf + three logf each
// way, divisions) over three passes; the tile is re-read through L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stain_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Constants the TPU kernel takes from Python doubles, rounded once to f32.
constexpr float kDelta = 0.008856f;
constexpr float k16_116 = (float)(16.0 / 116.0);
constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kInv24 = (float)(1.0 / 2.4);
constexpr float kLKnee = (float)(903.3 * 0.008856);

struct Args {
  const uint8_t* in;
  uint8_t* out;
  const float* scal;  // (B, 8): target means (L, a, b), target stds, pad
  const float* lin;   // (256,): sRGB linearization of a byte
  int n_pix, pix_stride, ch_stride;
  float rank_lo, frac, one_minus_frac;
};

__device__ __forceinline__ float cbrt_newton(float t) {
  const float y0 = expf(logf(fmaxf(t, 1e-12f)) * kThird);
  return (2.0f * y0 + t / (y0 * y0)) * kThird;
}

__device__ __forceinline__ float lab_f(float t) {
  return t > kDelta ? cbrt_newton(t) : 7.787f * t + k16_116;
}

// One pixel's brightness-standardized bytes -> quantized CIELAB.
__device__ __forceinline__ void quantized_lab(const uint8_t* px, int ch_stride,
                                              float p, const float* lin,
                                              float lab[3]) {
  float l[3];
  for (int c = 0; c < 3; ++c) {
    const float v = (float)__ldg(px + c * ch_stride);
    const float b = floorf(fminf(fmaxf(v * 255.0f / p, 0.0f), 255.0f));
    l[c] = lin[(int)b];
  }
  const float x = (0.412453f * l[0] + 0.357580f * l[1] + 0.180423f * l[2]) / 0.950456f;
  const float y = 0.212671f * l[0] + 0.715160f * l[1] + 0.072169f * l[2];
  const float z = (0.019334f * l[0] + 0.119193f * l[1] + 0.950227f * l[2]) / 1.088754f;
  const float fy = lab_f(y);
  const float L = y > kDelta ? 116.0f * cbrt_newton(fmaxf(y, kDelta)) - 16.0f
                             : 903.3f * y;
  const float a = 500.0f * (lab_f(x) - fy);
  const float bb = 200.0f * (fy - lab_f(z));
  // The uint8 LAB image (reinhard.py::_quantize_lab).
  lab[0] = fminf(fmaxf(rintf(L * 2.55f), 0.0f), 255.0f) / 2.55f;
  lab[1] = fminf(fmaxf(rintf(a + 128.0f), 0.0f), 255.0f) - 128.0f;
  lab[2] = fminf(fmaxf(rintf(bb + 128.0f), 0.0f), 255.0f) - 128.0f;
}

__device__ __forceinline__ float f_inv(float ft) {
  const float t3 = ft * ft * ft;
  return t3 > kDelta ? t3 : (ft - k16_116) / 7.787f;
}

__device__ __forceinline__ float compress(float c) {
  c = fmaxf(c, 0.0f);
  const float srgb = c <= 0.0031308f
                         ? c * 12.92f
                         : 1.055f * expf(logf(fmaxf(c, 1e-12f)) * kInv24) - 0.055f;
  return fminf(fmaxf(srgb, 0.0f), 1.0f) * 255.0f;
}

__global__ void __launch_bounds__(kThreads, 2) reinhard_kernel(Args a) {
  __shared__ int hist[kWarps][256];
  __shared__ float lin[256];
  __shared__ double dbuf[6 * kWarps];
  __shared__ float p_sh;

  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) (&hist[0][0])[i] = 0;
  for (int i = threadIdx.x; i < 256; i += kThreads) lin[i] = a.lin[i];
  __syncthreads();

  const size_t tile_off = (size_t)blockIdx.x * 3 * a.n_pix;
  const uint8_t* src = a.in + tile_off;

  // Phase 1: joint histogram of the 3N bytes (one sub-histogram per warp).
  for (int p = threadIdx.x; p < a.n_pix; p += kThreads) {
    const uint8_t* px = src + (size_t)p * a.pix_stride;
    for (int c = 0; c < 3; ++c)
      atomicAdd(&hist[warp][__ldg(px + c * a.ch_stride)], 1);
  }
  __syncthreads();
  if (threadIdx.x < 256) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += hist[w][threadIdx.x];
    hist[0][threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // The rank-floor order statistic v_lo: the smallest byte whose count at
    // or below exceeds rank_lo. Its partner: v_lo again if the count at
    // v_lo exceeds rank_lo + 1, else the next byte present (255 if none).
    int cum = 0, v_lo = 255;
    for (int v = 0; v < 256; ++v) {
      cum += hist[0][v];
      if ((float)cum > a.rank_lo) {
        v_lo = v;
        break;
      }
    }
    int succ = 255;
    for (int v = v_lo + 1; v < 256; ++v)
      if (hist[0][v] > 0) {
        succ = v;
        break;
      }
    const float v_hi = (float)cum > a.rank_lo + 1.0f ? (float)v_lo : (float)succ;
    p_sh = fmaxf((float)v_lo * a.one_minus_frac + v_hi * a.frac, 1e-6f);
  }
  __syncthreads();
  const float p = p_sh;

  // Phase 2: per-channel mean and population std of the quantized LAB.
  double acc[6] = {0., 0., 0., 0., 0., 0.};
  for (int q = threadIdx.x; q < a.n_pix; q += kThreads) {
    float lab[3];
    quantized_lab(src + (size_t)q * a.pix_stride, a.ch_stride, p, lin, lab);
    for (int c = 0; c < 3; ++c) {
      acc[2 * c] += lab[c];
      acc[2 * c + 1] += lab[c] * lab[c];  // float products, as the plain version's
    }
  }
  stain::block_sum<kThreads, 6>(acc, dbuf);
  const float n = (float)a.n_pix;
  const float* scal = a.scal + blockIdx.x * 8;
  float mu[3], gain[3], tm[3];
  for (int c = 0; c < 3; ++c) {
    mu[c] = (float)acc[2 * c] / n;
    const float sd = sqrtf(fmaxf((float)acc[2 * c + 1] / n - mu[c] * mu[c], 1e-12f));
    gain[c] = scal[3 + c] / sd;
    tm[c] = scal[c];
  }

  // Phase 3: transfer, merge-back floor, CIELAB -> sRGB, round.
  uint8_t* dst = a.out + tile_off;
  for (int q = threadIdx.x; q < a.n_pix; q += kThreads) {
    float lab[3];
    quantized_lab(src + (size_t)q * a.pix_stride, a.ch_stride, p, lin, lab);
    float L = (lab[0] - mu[0]) * gain[0] + tm[0];
    float A = (lab[1] - mu[1]) * gain[1] + tm[1];
    float Bv = (lab[2] - mu[2]) * gain[2] + tm[2];
    L = floorf(fminf(fmaxf(L * 2.55f, 0.0f), 255.0f)) / 2.55f;
    A = floorf(fminf(fmaxf(A + 128.0f, 0.0f), 255.0f)) - 128.0f;
    Bv = floorf(fminf(fmaxf(Bv + 128.0f, 0.0f), 255.0f)) - 128.0f;
    const float fy = (L + 16.0f) / 116.0f;
    const float fx = fy + A / 500.0f;
    const float fz = fy - Bv / 200.0f;
    const float y = L > kLKnee ? fy * fy * fy : L / 903.3f;
    const float x = f_inv(fx) * 0.950456f;
    const float z = f_inv(fz) * 1.088754f;
    const float rgb[3] = {
        compress(3.240479f * x + -1.537150f * y + -0.498535f * z),
        compress(-0.969256f * x + 1.875992f * y + 0.041556f * z),
        compress(0.055648f * x + -0.204043f * y + 1.057311f * z)};
    uint8_t* px = dst + (size_t)q * a.pix_stride;
    for (int c = 0; c < 3; ++c)
      px[c * a.ch_stride] = (uint8_t)(int)fminf(fmaxf(rintf(rgb[c]), 0.0f), 255.0f);
  }
}

}  // namespace

extern "C" cudaError_t reinhard_normalize_launch(
    int device, const void* in, void* out, const void* scal, const void* lin,
    int batch, int n_pix, int pix_stride, int ch_stride, float rank_lo,
    float frac, float one_minus_frac, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  Args a;
  a.in = static_cast<const uint8_t*>(in);
  a.out = static_cast<uint8_t*>(out);
  a.scal = static_cast<const float*>(scal);
  a.lin = static_cast<const float*>(lin);
  a.n_pix = n_pix;
  a.pix_stride = pix_stride;
  a.ch_stride = ch_stride;
  a.rank_lo = rank_lo;
  a.frac = frac;
  a.one_minus_frac = one_minus_frac;
  reinhard_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

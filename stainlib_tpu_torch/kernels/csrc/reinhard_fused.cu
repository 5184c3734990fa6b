// Fused Reinhard normalization, one thread-block cluster per tile (sm_90a).
//
// Replaces the Pallas TPU kernel reinhard_normalize_planar /
// _reinhard_kernel (the JAX package's kernels/reinhard_fused.py:140-231,
// helpers _percentile_u8_multi :29-72, _rgb_to_lab_planes :75-103,
// _lab_to_rgb_planes :106-137). Per tile:
//   A. the joint q-th percentile p of the tile's 3N channel bytes
//      (np.percentile's linear rule) from a 256-bin histogram: integer
//      counts give the rank-floor order statistic and its successor exactly,
//      as the TPU kernel's 10-round bisection over the integer grid does;
//   B. brightness floor(clip(c*255/p, 0, 255)) per channel, sRGB -> CIELAB,
//      the uint8-LAB quantize, and the six L/a/b sums and sums of squares
//      accumulated in double, rounded once -> per-channel mean and
//      population std;
//   C. the affine transfer to the target statistics, the merge-back floor in
//      the packed domain, CIELAB -> sRGB, round, clip, uint8.
// Bound: arithmetic per pixel, not bytes. Nearly all of that arithmetic is a
// function of a byte, so the design turns it into tables and runs each
// transcendental once per pixel:
//   * after the brightness floor a channel is a byte, so once p is known
//     256 threads build blin[v] = lin[floor(clip(v*255/p))] per tile and
//     pass B takes no division by p;
//   * pass B takes y's cube root once for both fy and L (the same operand
//     where y > delta) and stores the packed LAB integers as three bytes
//     per pixel in the tile's own region of the output (each thread reads
//     back only what it wrote; the region is L2-resident), so pass C does
//     not recompute them;
//   * after the sums, three 256-entry maps per tile take a staged byte
//     straight to the transferred, merge-back-floored value: (fy, y) for L,
//     A/500 and Bv/200, each entry by the expression the per-pixel code
//     used, on the same operands;
//   * pass C is three gathers, f_inv, the 3x3, three compress.
// Every pass moves 8 pixels per thread and step as three 8-byte vectors.
// The histogram pass counts runs of equal bytes in each vector before the
// shared-memory atomic (one sub-histogram per warp), so a white background
// costs one atomic per 8 bytes. A tile is one cluster of
// G blocks (reinhard_fused.reinhard_plan weighs batch x G against the
// card's block slots: G = 1 at 256 tiles, 16 for one image), each block
// owning n_pix / G pixels; the cluster meets twice per tile, for the 256
// integer bins and for the six doubles, which every block folds in rank
// order, so every G gives the same bytes.
// Every expression keeps the TPU kernel's operation order (c*255 then /p;
// true divisions by the constants), and the library is built with
// -fmad=false: the rounds and floors turn one-ulp differences into whole
// uint8 steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stain_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Pixels per thread and step: three 8-byte vectors. On an H100 8 measured 9%
// faster than 16 at 256 tiles and 3x faster on one image, where a slice of
// 4096 pixels then keeps all 512 threads busy; 4 measured the same as 8.
constexpr int kWidth = 8;

// Constants the TPU kernel takes from Python doubles, rounded once to f32.
constexpr float kDelta = 0.008856f;
constexpr float k16_116 = (float)(16.0 / 116.0);
constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kInv24 = (float)(1.0 / 2.4);
constexpr float kLKnee = (float)(903.3 * 0.008856);

struct Args {
  const uint8_t* in;
  uint8_t* out;
  const float* means;  // target means (L, a, b): tile i's at + i * stride
  const float* stds;   // target stds
  int means_stride, stds_stride;
  const float* lin;  // (256,): sRGB linearization of a byte
  int n_pix;
  int slice;  // pixels per block, a multiple of kWidth; G * slice >= n_pix
  bool in_vec, out_vec;  // the tensors' bases are kWidth-byte aligned
  float rank_lo, frac, one_minus_frac;
};

struct Shared {
  int hist[kWarps][256];               // pass A: one sub-histogram per warp
  int hslot[stain::kMaxCluster][256];  // each rank's bins, pushed by it
  double dbuf[6 * kWarps];
  double dslot[stain::kMaxCluster][6];  // each rank's six sums
  float lin[256];       // sRGB linearization of a byte
  float blin[256];      // ... of a byte after the tile's brightness floor
  float unpack_l[256];  // q / 2.55: the quantized L of a packed byte
  float2 map_l[256];    // packed L byte -> (fy, y) after the transfer
  float map_a[256];     // packed a byte -> A / 500 after the transfer
  float map_b[256];     // packed b byte -> Bv / 200
  int cum[256];         // inclusive prefix counts of the bins
  int wtot[8];
  int succ;
  float p;
};

__device__ __forceinline__ float cbrt_newton(float t) {
  const float y0 = expf(logf(fmaxf(t, 1e-12f)) * kThird);
  return (2.0f * y0 + t / (y0 * y0)) * kThird;
}

__device__ __forceinline__ float lab_f(float t) {
  return t > kDelta ? cbrt_newton(t) : 7.787f * t + k16_116;
}

// One pixel's linear RGB (after the brightness floor) -> the packed uint8
// LAB image (reinhard.py::_quantize_lab): L*2.55, a+128, b+128, rounded and
// clipped. y's cube root serves fy and L: where y > delta, lab_f(y) and
// cbrt(max(y, delta)) have the same operand.
__device__ __forceinline__ void packed_lab(float l0, float l1, float l2,
                                           uint32_t q[3]) {
  const float x = (0.412453f * l0 + 0.357580f * l1 + 0.180423f * l2) / 0.950456f;
  const float y = 0.212671f * l0 + 0.715160f * l1 + 0.072169f * l2;
  const float z = (0.019334f * l0 + 0.119193f * l1 + 0.950227f * l2) / 1.088754f;
  float fy, L;
  if (y > kDelta) {
    fy = cbrt_newton(y);
    L = 116.0f * fy - 16.0f;
  } else {
    fy = 7.787f * y + k16_116;
    L = 903.3f * y;
  }
  const float a = 500.0f * (lab_f(x) - fy);
  const float bb = 200.0f * (fy - lab_f(z));
  q[0] = stain::u8_round(L * 2.55f);
  q[1] = stain::u8_round(a + 128.0f);
  q[2] = stain::u8_round(bb + 128.0f);
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

// One count per run of equal bytes among the W.
template <int W>
__device__ __forceinline__ void count_runs(int* h, const stain::Bytes<W>& v) {
  uint32_t prev = v.w[0] & 255u;
  int n = 1;
#pragma unroll
  for (int i = 1; i < W; ++i) {
    const uint32_t b = (v.w[i >> 2] >> ((i & 3) * 8)) & 255u;
    if (b == prev) {
      ++n;
    } else {
      atomicAdd(&h[prev], n);
      prev = b;
      n = 1;
    }
  }
  atomicAdd(&h[prev], n);
}

template <bool kPlanar>
__global__ void __launch_bounds__(kThreads, 2) reinhard_kernel(Args a) {
  constexpr int W = kWidth;
  __shared__ Shared sh;
  const cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const unsigned G = cl.num_blocks(), rank = cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x / G;

  for (int i = tid; i < kWarps * 256; i += kThreads) (&sh.hist[0][0])[i] = 0;
  if (tid < 256) {
    sh.lin[tid] = a.lin[tid];
    sh.unpack_l[tid] = (float)tid / 2.55f;
  }
  // Past this barrier every block of the cluster runs, so its shared memory
  // may be written from another block.
  if (G > 1) cl.sync();
  else __syncthreads();

  const size_t tile_off = (size_t)tile * 3 * a.n_pix;
  const uint8_t* src = a.in + tile_off;
  uint8_t* dst = a.out + tile_off;
  // This block's groups of W pixels.
  const int per_block = a.slice / W;
  const int g0 = (int)rank * per_block;
  const int g1 = min(a.n_pix / W, g0 + per_block);

  // Pass A: the joint histogram of the slice's 3 * slice bytes.
  for (int grp = g0 + tid; grp < g1; grp += kThreads) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      count_runs<W>(sh.hist[warp],
                 stain::load<W, true>(
                     src + stain::vec_offset<kPlanar, W>(a.n_pix, grp, k), a.in_vec));
  }
  __syncthreads();
  int bin = 0;  // threads 0..255: the tile's count of byte value tid
  if (tid < 256)
    for (int w = 0; w < kWarps; ++w) bin += sh.hist[w][tid];
  if (G > 1) {
    if (tid < 256)
      for (unsigned r = 0; r < G; ++r)
        *cl.map_shared_rank(&sh.hslot[rank][tid], r) = bin;
    cl.sync();
    if (tid < 256) {
      bin = 0;
      for (unsigned r = 0; r < G; ++r) bin += sh.hslot[r][tid];
    }
  }
  // The rank-floor order statistic v_lo: the smallest byte whose count at or
  // below exceeds rank_lo (the counts are monotone, so it is the number of
  // bytes whose count does not). Its partner: v_lo again if the count at
  // v_lo exceeds rank_lo + 1, else the next byte present (255 if none).
  int incl = bin;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(stain::kFull, incl, off);
    if (lane >= off) incl += up;
  }
  if (tid < 256 && lane == 31) sh.wtot[warp] = incl;
  if (tid == 0) sh.succ = 255;
  __syncthreads();
  if (tid < 256) {
    for (int w = 0; w < warp; ++w) incl += sh.wtot[w];
    sh.cum[tid] = incl;
  }
  const int below =
      __syncthreads_count(tid < 256 && !((float)incl > a.rank_lo));
  const int v_lo = min(below, 255);
  if (tid < 256 && tid > v_lo && bin > 0) atomicMin(&sh.succ, tid);
  __syncthreads();
  if (tid == 0) {
    const float v_hi = (float)sh.cum[v_lo] > a.rank_lo + 1.0f ? (float)v_lo
                                                              : (float)sh.succ;
    sh.p = fmaxf((float)v_lo * a.one_minus_frac + v_hi * a.frac, 1e-6f);
  }
  __syncthreads();
  if (tid < 256) {
    const float b =
        floorf(fminf(fmaxf((float)tid * 255.0f / sh.p, 0.0f), 255.0f));
    sh.blin[tid] = sh.lin[(int)b];
  }
  __syncthreads();

  // Pass B: the packed LAB of every pixel, staged in the output's vector
  // slots (vector k: the W pixels' channel k), and the six sums.
  double acc[6] = {0., 0., 0., 0., 0., 0.};
  for (int grp = g0 + tid; grp < g1; grp += kThreads) {
    stain::Pixels<W> x, s;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      x.v[k] = stain::load<W, true>(
          src + stain::vec_offset<kPlanar, W>(a.n_pix, grp, k), a.in_vec);
      for (int i = 0; i < W / 4; ++i) s.v[k].w[i] = 0;
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      uint32_t q[3];
      packed_lab(sh.blin[stain::px_get<kPlanar, W>(x, j, 0)],
                 sh.blin[stain::px_get<kPlanar, W>(x, j, 1)],
                 sh.blin[stain::px_get<kPlanar, W>(x, j, 2)], q);
      const float lab[3] = {sh.unpack_l[q[0]], (float)q[1] - 128.0f,
                            (float)q[2] - 128.0f};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        acc[2 * c] += lab[c];
        acc[2 * c + 1] += lab[c] * lab[c];  // float products, as the plain version's
        stain::px_put<true, W>(s, j, c, q[c]);
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
      stain::store<W>(dst + stain::vec_offset<kPlanar, W>(a.n_pix, grp, k), s.v[k],
                     a.out_vec);
  }
  stain::block_sum<kThreads, 6>(acc, sh.dbuf);
  if (G > 1) {
    if (tid < (int)G) {
      double* slot = cl.map_shared_rank(sh.dslot[rank], tid);
      for (int k = 0; k < 6; ++k) slot[k] = acc[k];
    }
    cl.sync();
    for (int k = 0; k < 6; ++k) {
      double t = sh.dslot[0][k];
      for (unsigned r = 1; r < G; ++r) t += sh.dslot[r][k];
      acc[k] = t;
    }
  }

  // The tile's byte maps: a staged byte -> its transferred, floored value.
  const float n = (float)a.n_pix;
  const float* tmean = a.means + (size_t)tile * a.means_stride;
  const float* tstd = a.stds + (size_t)tile * a.stds_stride;
  float mu[3], gain[3], tm[3];
  for (int c = 0; c < 3; ++c) {
    mu[c] = (float)acc[2 * c] / n;
    const float sd = sqrtf(fmaxf((float)acc[2 * c + 1] / n - mu[c] * mu[c], 1e-12f));
    gain[c] = tstd[c] / sd;
    tm[c] = tmean[c];
  }
  if (tid < 256) {
    float L = (sh.unpack_l[tid] - mu[0]) * gain[0] + tm[0];
    L = floorf(fminf(fmaxf(L * 2.55f, 0.0f), 255.0f)) / 2.55f;
    const float fy = (L + 16.0f) / 116.0f;
    sh.map_l[tid] = make_float2(fy, L > kLKnee ? fy * fy * fy : L / 903.3f);
  } else {
    const float q = (float)(tid - 256) - 128.0f;
    float A = (q - mu[1]) * gain[1] + tm[1];
    float Bv = (q - mu[2]) * gain[2] + tm[2];
    A = floorf(fminf(fmaxf(A + 128.0f, 0.0f), 255.0f)) - 128.0f;
    Bv = floorf(fminf(fmaxf(Bv + 128.0f, 0.0f), 255.0f)) - 128.0f;
    sh.map_a[tid - 256] = A / 500.0f;
    sh.map_b[tid - 256] = Bv / 200.0f;
  }
  __syncthreads();

  // Pass C: staged bytes -> sRGB bytes, into the slots they came from.
  for (int grp = g0 + tid; grp < g1; grp += kThreads) {
    stain::Pixels<W> s, o;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s.v[k] = stain::load<W, false>(
          dst + stain::vec_offset<kPlanar, W>(a.n_pix, grp, k), a.out_vec);
      for (int i = 0; i < W / 4; ++i) o.v[k].w[i] = 0;
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float2 ly = sh.map_l[stain::px_get<true, W>(s, j, 0)];
      const float fx = ly.x + sh.map_a[stain::px_get<true, W>(s, j, 1)];
      const float fz = ly.x - sh.map_b[stain::px_get<true, W>(s, j, 2)];
      const float y = ly.y;
      const float x = f_inv(fx) * 0.950456f;
      const float z = f_inv(fz) * 1.088754f;
      const float rgb[3] = {
          compress(3.240479f * x + -1.537150f * y + -0.498535f * z),
          compress(-0.969256f * x + 1.875992f * y + 0.041556f * z),
          compress(0.055648f * x + -0.204043f * y + 1.057311f * z)};
#pragma unroll
      for (int c = 0; c < 3; ++c)
        stain::px_put<kPlanar, W>(o, j, c, stain::u8_round(rgb[c]));
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
      stain::store<W>(dst + stain::vec_offset<kPlanar, W>(a.n_pix, grp, k), o.v[k],
                     a.out_vec);
  }
}

}  // namespace

// K5 over `batch` tiles of n_pix pixels (a multiple of 128), planar or
// interleaved, each tile a cluster of G blocks owning `slice` pixels
// (reinhard_fused.reinhard_plan). means / stds: float32 on the device, tile
// i's three values at ptr + i * stride (stride 0: one set for all tiles).
extern "C" cudaError_t reinhard_normalize_launch(
    int device, const void* in, void* out, const void* means, int means_stride,
    const void* stds, int stds_stride, const void* lin, int batch, int n_pix,
    int planar, int G, int slice, float rank_lo, float frac,
    float one_minus_frac, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  Args a;
  a.in = static_cast<const uint8_t*>(in);
  a.out = static_cast<uint8_t*>(out);
  a.means = static_cast<const float*>(means);
  a.stds = static_cast<const float*>(stds);
  a.means_stride = means_stride;
  a.stds_stride = stds_stride;
  a.lin = static_cast<const float*>(lin);
  a.n_pix = n_pix;
  a.slice = slice;
  a.in_vec = (reinterpret_cast<uintptr_t>(in) & (kWidth - 1)) == 0;
  a.out_vec = (reinterpret_cast<uintptr_t>(out) & (kWidth - 1)) == 0;
  a.rank_lo = rank_lo;
  a.frac = frac;
  a.one_minus_frac = one_minus_frac;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planar)
    return stain::launch_cluster<reinhard_kernel<true>>(a, device, batch, G,
                                                        kThreads, 0, s);
  return stain::launch_cluster<reinhard_kernel<false>>(a, device, batch, G,
                                                       kThreads, 0, s);
}

// The flow's residual branch in the deploy encode: pack, branch and gather
// kernels (sm_90a).
//
// One iResBlock's y + g(y) with g(y) = conv3(act(conv2(act(conv1(y)))))
// (models/flow_layers.py lipschitz_apply; act(v) = silu(v) / 1.1): conv1
// 3x3 c -> hidden, conv2 1x1 hidden -> hidden, conv3 3x3 hidden -> c, SAME
// zero padding, each with its bias, on (B, c, H, W) float32, c <= 16, a
// hidden width that is a multiple of 32 up to 128.
//
// Replaces no TPU kernel: the JAX package leaves the branch to XLA's
// convolutions. Added because in the port the branch ran as three cuDNN
// convolutions and six elementwise passes, each writing or reading a
// 128-channel float32 tensor (2.15 GB at 64 tiles of 256^2): about 226 GB
// of device traffic per batch of the capacity model, 3.6x the time of its
// arithmetic at the card's FP32 rate.
// Bound: FP32 FFMA arithmetic, 37-106 kFLOP per pixel, once the hidden
// activations stay on chip. Design:
//   * conv3 at pixel p is sum_tap W3[tap] . h(p + d_tap) = sum_tap
//     t_tap(p + d_tap) with t_tap(q) = W3[tap] . h(q), zero padding
//     included. So the branch kernel ends in a per-pixel projection
//     hidden -> 9c (t, written as (B, 9c, H, W)), and the gather kernel
//     sums the nine shifted taps, the bias and the residual. Nothing is
//     recomputed across tile edges, and t is 9c floats a pixel at every
//     scale (151 MB a block at 64 tiles) where the hidden tensor is 128.
//   * The branch kernel is persistent: one block of 256 threads per SM
//     walks tiles of 128 consecutive pixels of one image. Per tile: the
//     3x3 window of y as a (9c x 128) matrix in shared memory; h1 =
//     act(W1 . window + b1), h2 = act(W2 . h1 + b2), t = W3' . h2, each a
//     register-tiled product from shared memory (8 x 8 outputs a thread,
//     two 16-byte loads of each operand per step, 64 FFMA), h1 and h2
//     written over the same (128 x 128) shared buffer.
//   * A pack kernel lays the weights out once per call, transposed and
//     zero-padded to 128 hidden and 16 NJ taps (Layout), so a block
//     stages them with 16-byte cp.async copies: W2 (64 KB) and the
//     biases once per block, W1 and W3 in one region per tile (at most
//     74 KB, 13 KB at c = 1, from L2), W1's copy in flight while the
//     window loads, W3's while h1 is stored and W2 runs.
// Precision: float32 throughout, no TF32. The library is built with
// -fmad=false for the stain kernels; the products here are written as
// __fmaf_rn, which that flag leaves fused, as cuDNN's FP32 kernels fuse
// them. act takes expf and one IEEE division, v / (1.1 (1 + e^-v)). Sums
// run in a fixed order, without atomics: the same bytes on every run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kP = 128;    // pixels per tile
constexpr int kHid = 128;  // hidden width of the packed layout
constexpr int kMaxC = 16;

// Tap columns of the projection per thread: 16 NJ >= 9c.
__host__ __device__ constexpr int nj_of(int c) {
  return c <= 1 ? 1 : (c <= 5 ? 3 : 9);
}

// The packed weights, in floats: W1^T (9c x 128), b1 (128), W2^T
// (128 x 128), b2 (128), W3' (128 x 16 NJ) with column j = tap * c + c'.
struct Layout {
  int k1, n3;
  int w1, b1, w2, b2, w3, total;
  __host__ __device__ explicit Layout(int c)
      : k1(9 * c), n3(16 * nj_of(c)), w1(0), b1(9 * c * kHid),
        w2(b1 + kHid), b2(w2 + kHid * kHid), w3(b2 + kHid),
        total(w3 + kHid * n3) {}
};

struct PackArgs {
  const float *w1, *b1, *w2, *b2, *w3;  // OIHW kernels and biases
  float* pack;
  int c, hidden;
};

__global__ void pack_kernel(PackArgs a) {
  const Layout L(a.c);
  const int hid = a.hidden;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < L.total;
       i += gridDim.x * blockDim.x) {
    float v = 0.0f;
    if (i < L.b1) {
      const int k = i / kHid, n = i % kHid;  // k = ch * 9 + ky * 3 + kx
      if (n < hid) v = a.w1[n * L.k1 + k];
    } else if (i < L.w2) {
      if (i - L.b1 < hid) v = a.b1[i - L.b1];
    } else if (i < L.b2) {
      const int k = (i - L.w2) / kHid, n = (i - L.w2) % kHid;
      if (n < hid && k < hid) v = a.w2[n * hid + k];
    } else if (i < L.w3) {
      if (i - L.b2 < hid) v = a.b2[i - L.b2];
    } else {
      const int k = (i - L.w3) / L.n3, j = (i - L.w3) % L.n3;
      if (k < hid && j < L.k1) v = a.w3[((j % a.c) * hid + k) * 9 + j / a.c];
    }
    a.pack[i] = v;
  }
}

struct BranchArgs {
  const float* y;     // (B, c, H, W)
  const float* pack;  // Layout(c)
  float* t;           // (B, 9c, H, W)
  int c, hidden, h, w, hw;
  int tiles_per_image, n_tiles;
  bool vec;  // hw % 4 == 0: t's rows take 16-byte stores
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying n floats (a multiple of 4) from src to shared dst.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads)
    cp_async16(dst + i, src + i);
}

// silu(v) / 1.1 = v / (1.1 (1 + e^-v)).
__device__ __forceinline__ float act(float v) {
  return v / (1.1f * (1.0f + expf(-v)));
}

// The thread's 8 x 8 outputs: pixels p_i = 4 tx + (i & 3) + 64 (i >> 2),
// columns n_j = 4 ty + (j & 3) + 64 (j >> 2). acc[i][j] += A[k][p_i]
// B[k][n_j] for k < K, in k order; A has rows of kP floats, B of kHid.
__device__ __forceinline__ void gemm88(const float* __restrict__ A,
                                       const float* __restrict__ B, int K,
                                       int tx, int ty, float (&acc)[8][8]) {
  const float* a = A + 4 * tx;
  const float* b = B + 4 * ty;
#pragma unroll 2
  for (int k = 0; k < K; ++k, a += kP, b += kHid) {
    const float4 a0 = *reinterpret_cast<const float4*>(a);
    const float4 a1 = *reinterpret_cast<const float4*>(a + 64);
    const float4 b0 = *reinterpret_cast<const float4*>(b);
    const float4 b1 = *reinterpret_cast<const float4*>(b + 64);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
  }
}

// h[n_j][p_i] = act(acc[i][j] + bias[n_j]), 16-byte stores along pixels.
__device__ __forceinline__ void act_store(float* h, const float* bias,
                                          int tx, int ty,
                                          const float (&acc)[8][8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 4 * ty + (j & 3) + 64 * (j >> 2);
    const float bn = bias[n];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * half;
      const float4 v = make_float4(
          act(acc[i][j] + bn), act(acc[i + 1][j] + bn),
          act(acc[i + 2][j] + bn), act(acc[i + 3][j] + bn));
      *reinterpret_cast<float4*>(h + n * kP + 4 * tx + 64 * half) = v;
    }
  }
}

// The projection: pixels p_i as gemm88's, columns ty + 16 m. acc[i][m] +=
// A[k][p_i] B[k][ty + 16 m] for k < K; B has rows of n3 floats.
template <int NJ>
__device__ __forceinline__ void gemm_taps(const float* __restrict__ A,
                                          const float* __restrict__ B, int n3,
                                          int K, int tx, int ty,
                                          float (&acc)[8][NJ]) {
  const float* a = A + 4 * tx;
  const float* b = B + ty;
#pragma unroll 2
  for (int k = 0; k < K; ++k, a += kP, b += n3) {
    const float4 a0 = *reinterpret_cast<const float4*>(a);
    const float4 a1 = *reinterpret_cast<const float4*>(a + 64);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float bv[NJ];
#pragma unroll
    for (int m = 0; m < NJ; ++m) bv[m] = b[16 * m];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int m = 0; m < NJ; ++m) acc[i][m] = __fmaf_rn(av[i], bv[m], acc[i][m]);
  }
}

template <int NJ>
__global__ void __launch_bounds__(kThreads, 1) branch_kernel(BranchArgs a) {
  extern __shared__ float4 smem4[];
  const Layout L(a.c);
  float* sw2 = reinterpret_cast<float*>(smem4);  // kHid x kHid
  float* sb1 = sw2 + kHid * kHid;
  float* sb2 = sb1 + kHid;
  float* sh = sb2 + kHid;  // max(kHid, k1) x kP: the window, then h1, h2
  // W1^T (k1 x kHid), then W3' (kHid x n3) in its place.
  float* sw1 = sh + (L.k1 > kHid ? L.k1 : kHid) * kP;
  float* sw3 = sw1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int hid = a.hidden;

  stage(sw2, a.pack + L.w2, kHid * kHid);
  stage(sb1, a.pack + L.b1, kHid);
  stage(sb2, a.pack + L.b2, kHid);

  // The window's rows r = ch * 9 + ky * 3 + kx for this thread's pixel.
  const int p = threadIdx.x & (kP - 1);
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int b = tile / a.tiles_per_image;
    const int base = (tile - b * a.tiles_per_image) * kP;
    stage(sw1, a.pack + L.w1, L.k1 * kHid);
    {
      const int g = base + p;
      const int gy = g / a.w, gx = g - gy * a.w;
      const bool live = g < a.hw;
      const float* yb = a.y + (size_t)b * a.c * a.hw;
      for (int r = threadIdx.x / kP; r < L.k1; r += kThreads / kP) {
        const int ch = r / 9, tap = r - 9 * ch;
        const int sy = gy + tap / 3 - 1, sx = gx + tap % 3 - 1;
        float v = 0.0f;
        if (live && sy >= 0 && sy < a.h && sx >= 0 && sx < a.w)
          v = __ldg(yb + (size_t)ch * a.hw + sy * a.w + sx);
        sh[r * kP + p] = v;
      }
    }
    cp_async_wait();
    __syncthreads();

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    gemm88(sh, sw1, L.k1, tx, ty, acc);
    __syncthreads();  // the window and W1^T are read
    stage(sw3, a.pack + L.w3, kHid * L.n3);
    act_store(sh, sb1, tx, ty, acc);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    gemm88(sh, sw2, hid, tx, ty, acc);
    __syncthreads();  // h1 is read
    act_store(sh, sb2, tx, ty, acc);
    cp_async_wait();
    __syncthreads();

    float proj[8][NJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int m = 0; m < NJ; ++m) proj[i][m] = 0.0f;
    gemm_taps<NJ>(sh, sw3, L.n3, hid, tx, ty, proj);
    float* tb = a.t + (size_t)b * L.k1 * a.hw + base;
#pragma unroll
    for (int m = 0; m < NJ; ++m) {
      const int j = ty + 16 * m;
      if (j >= L.k1) continue;
      float* row = tb + (size_t)j * a.hw;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = 4 * tx + 64 * half;
        const int i = 4 * half;
        if (a.vec) {
          if (base + q < a.hw)
            *reinterpret_cast<float4*>(row + q) =
                make_float4(proj[i][m], proj[i + 1][m], proj[i + 2][m],
                            proj[i + 3][m]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (base + q + e < a.hw) row[q + e] = proj[i + e][m];
        }
      }
    }
    __syncthreads();  // h2 and W3' are read before the next tile's copies
  }
}

struct GatherArgs {
  const float* y;   // (B, c, H, W)
  const float* t;   // (B, 9c, H, W)
  const float* b3;  // (c,)
  float* out;       // (B, c, H, W)
  int c, h, w, hw, planes;
};

// out = y + (b3 + sum over the taps inside the image of t_tap(p + d_tap)),
// taps in (ky, kx) order.
__global__ void gather_kernel(GatherArgs a) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= a.hw) return;
  const int gy = g / a.w, gx = g - gy * a.w;
  for (int bc = blockIdx.y; bc < a.planes; bc += gridDim.y) {
    const int b = bc / a.c, cc = bc - b * a.c;
    const float* tb = a.t + ((size_t)b * 9 * a.c + cc) * a.hw;
    float acc = a.b3[cc];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int sy = gy + tap / 3 - 1, sx = gx + tap % 3 - 1;
      if (sy >= 0 && sy < a.h && sx >= 0 && sx < a.w)
        acc += tb[(size_t)tap * a.c * a.hw + sy * a.w + sx];
    }
    const size_t o = (size_t)bc * a.hw + g;
    a.out[o] = a.y[o] + acc;
  }
}

template <int NJ>
cudaError_t launch_branch(const BranchArgs& a, int device, int grid, int smem,
                          int optin, cudaStream_t s) {
  static bool ready[64] = {};  // per device
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        branch_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  branch_kernel<NJ><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The branch's t (B, 9c, H, W) from y (B, c, H, W): the pack kernel lays
// the weights (w1 (hidden, c, 3, 3), b1, w2 (hidden, hidden, 1, 1), b2,
// w3 (c, hidden, 3, 3); float32, contiguous) out in `pack` (pack_floats
// floats, at least Layout(c).total), then the branch kernel runs one block
// per SM over the tiles.
extern "C" cudaError_t flow_branch_launch(
    int device, const void* y, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, void* pack, int pack_floats, void* t,
    int batch, int c, int hidden, int h, int w, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  const Layout L(c);
  if (c < 1 || c > kMaxC || hidden < 32 || hidden > kHid || hidden % 32 ||
      h < 1 || w < 1 || batch < 0 || pack_floats < L.total)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  int sms = 0, optin = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  PackArgs pa;
  pa.w1 = static_cast<const float*>(w1);
  pa.b1 = static_cast<const float*>(b1);
  pa.w2 = static_cast<const float*>(w2);
  pa.b2 = static_cast<const float*>(b2);
  pa.w3 = static_cast<const float*>(w3);
  pa.pack = static_cast<float*>(pack);
  pa.c = c;
  pa.hidden = hidden;
  pack_kernel<<<(L.total + kThreads - 1) / kThreads, kThreads, 0, s>>>(pa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  BranchArgs a;
  a.y = static_cast<const float*>(y);
  a.pack = static_cast<const float*>(pack);
  a.t = static_cast<float*>(t);
  a.c = c;
  a.hidden = hidden;
  a.h = h;
  a.w = w;
  a.hw = h * w;
  a.tiles_per_image = (a.hw + kP - 1) / kP;
  a.n_tiles = batch * a.tiles_per_image;
  a.vec = a.hw % 4 == 0;
  const int fixed = kHid * kHid + 2 * kHid + (L.k1 > kHid ? L.k1 : kHid) * kP;
  const int w1n = L.k1 * kHid, w3n = kHid * L.n3;
  const int smem = 4 * (fixed + (w1n > w3n ? w1n : w3n));
  if (smem > optin) return cudaErrorInvalidValue;
  const int grid = a.n_tiles < sms ? a.n_tiles : sms;
  switch (nj_of(c)) {
    case 1: return launch_branch<1>(a, device, grid, smem, optin, s);
    case 3: return launch_branch<3>(a, device, grid, smem, optin, s);
    default: return launch_branch<9>(a, device, grid, smem, optin, s);
  }
}

// out (B, c, H, W) = y + b3 + the gathered taps of t (flow_branch_launch's).
extern "C" cudaError_t flow_gather_launch(int device, const void* y,
                                          const void* t, const void* b3,
                                          void* out, int batch, int c, int h,
                                          int w, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (c < 1 || c > kMaxC || h < 1 || w < 1 || batch < 0)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  GatherArgs a;
  a.y = static_cast<const float*>(y);
  a.t = static_cast<const float*>(t);
  a.b3 = static_cast<const float*>(b3);
  a.out = static_cast<float*>(out);
  a.c = c;
  a.h = h;
  a.w = w;
  a.hw = h * w;
  a.planes = batch * c;
  const dim3 grid((a.hw + kThreads - 1) / kThreads,
                  a.planes < 65535 ? a.planes : 65535);
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

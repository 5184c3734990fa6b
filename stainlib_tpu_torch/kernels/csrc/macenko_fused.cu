// Fused Macenko kernels (sm_90a): the fit + transform (K1), the fit alone
// (K4), the eigenplane: masked OD moments and eigen-solve (K10), the fixed-matrix
// apply (K3), and the stain-augmentation kernels: the fused augment (K6)
// and the augment apply (K7).
//
// macenko_apply_kernel replaces the Pallas TPU kernel
// macenko_normalize_planar / _apply_kernel (the JAX package's
// kernels/macenko_fused.py:413-490, :541-608). Per tile:
//   1. ten masked OD moments over the estimation sample;
//   2. the eigenplane (scalar Newton eigh, one thread, broadcast);
//   3. the two masked angular percentiles by count bisection and the exact
//      successor;
//   4. stain rows, the exact K=2 lasso, and the two 99th-percentile
//      concentration searches over the sample (unmasked);
//   5. rescale, 255*exp(-od), clip, truncate to uint8 for every pixel.
// Bound: not bytes (2 x 196 KB per 256^2 tile) but work per pixel and the
// chain of dependent reductions: at fs=2 nb=10 phases 1-4 are 6 passes
// over the sample (the moments, the angles, one angle bisection pass, the
// lasso, two concentration bisection passes), each ending at a cluster
// barrier. Design: one thread-block cluster of G blocks of 512 threads per
// tile, G from macenko_fused.cluster_plan, which weighs the batch against
// the card's SMs (one image spreads over 16 of them; 256 tiles take two
// blocks each, staged in device memory). The stain::Staged phases
// (stain_common.cuh) stage each sample pixel's bytes and mask bit, its
// pseudo-angle, then its two concentrations, in shared memory (or, for a
// sample over 293K pixels, in a device-memory scratch buffer, by the same
// code), so after one pass over device memory a bisection pass reads
// staged values into leaf histograms in shared memory, up to eight rounds
// and the successor per reduction (stain::staged_percentile_pair): a chain
// of 6 dependent reductions (7 at nb=14). The sample's chunks of 512
// pixels are dealt to the cluster's blocks in turns, so a band of
// background idles no block.
// Phase 5, the only pass over every pixel, is split over the cluster by
// pixel range; a thread takes 8 pixels per step through 64-bit accesses
// (planar: three channel vectors; interleaved: 24 contiguous bytes, with a
// scalar head and tail where the image is off the vector grid), the
// lasso's one-stain quotients only where they are read, and converts to
// uint8 in one instruction (stain::map_image, stain::normalize_bytes).
// Reductions run in a fixed order, so the output is bit-reproducible and
// equal at every G. OD and the luminance terms come from 256-entry tables
// that the wrapper builds with the plain version's own expressions;
// stain::Tile describes the planar / interleaved layouts and the sample.
//
// macenko_fit_kernel replaces macenko_fit_planar / _fit_kernel
// (:628-679, :688-736): phases 1-4 of K1 on the whole tile, writing the
// stain rows and the two maxC values (8 floats) per tile. The tiled route
// calls it on one ~256^2 subsample per field, so the batch is 1 and one
// block per tile would use one SM of 132. Design: one
// thread-block cluster of G = 16 blocks per tile (macenko_fused.
// cluster_plan), each owning 1/16 of the tile; the stain::Staged phases
// (stain_common.cuh) stage each pixel's bytes and mask bit, its
// pseudo-angle, then its two concentrations, in shared memory, so after
// one pass over device memory the bisection reads staged values into leaf
// histograms (up to eight rounds and the successor per reduction) and the
// time is the chain of 7 dependent cluster reductions (nb=14). A tile
// over 293K pixels (more than 16 blocks' shared memory holds) is staged
// in a device-memory scratch buffer instead, by the same code. Rank 0
// writes the 8 floats.
//
// eigenplane_kernel replaces eigenplane / _stats_kernel (:237-248,
// :498-532): the ten masked OD moments (count, 3 sums, 6 second moments,
// double-accumulated) per tile, then the glue the JAX package leaves to XLA:
// np.cov's covariance and the top-2 eigenplane, sign-fixed. One pass over
// the tile: bound by bytes (3 in per pixel), and by the double sums of the
// tissue pixels. Design: one launch writes the (B, 3, 2) plane. A tile is
// one thread-block cluster of G blocks (macenko_fused.eigenplane_plan: G
// follows the batch against the card's block slots, 16 for one tile), each
// reading its part of the tile 16 pixels per thread and step through three
// 128-bit loads, OD and luminance term side by side in one 8-byte gather
// per channel (K7's table), five of the nine double terms converted by
// integer operations; the sums fold over the warps and the cluster's
// ranks in ascending order (every G gives the same bits), and one thread
// per tile runs the glue in float32 op for op as torch runs it on the card
// (stain::eigenplane_from_moments), where torch took about a hundred
// launches.
//
// matrix_apply_kernel replaces normalize_with_matrix_planar / the
// _augment_kernel with estimate=False, recon_in_scal=True (:754-813,
// :936-991): per pixel, K1's OD, the exact lasso against fixed source rows,
// the rescale maxC_tgt/maxC_src, reconstruction through the target rows.
// Bound by the per-pixel arithmetic (the lasso, three expf) and 3 bytes in
// and 3 out. Design: K7's persistent 1-D grid over (image, chunk) work
// items (walk_items), so one large field and 65,536 small tiles alike fill
// the card; the OD table in shared memory; 8 pixels per thread and step
// (three 64-bit loads), with a scalar head and tail off the vector grid;
// K1's apply body (stain::normalize_bytes: the lazy lasso, the
// rescale, a one-instruction uint8 conversion). The per-image rows and maxC
// arrive by pointer and stride, and the kernel takes each image's rescale
// itself: the wrapper builds no table.
//
// macenko_augment_kernel replaces the Pallas TPU kernel macenko_augment_planar
// / _augment_kernel with estimate=True (:754-813, :822-871): StainAugmentor fit
// + pop. K1's phases 1-3 on the whole tile (the moments, the eigenplane, both
// angular bisections, the successor recovery), then per pixel the exact lasso,
// C*alpha+beta where the pixel is tissue (or every pixel with the background
// flag), 255*exp(-C M) through the tile's own rows. Bound: work per pixel and
// the chain of dependent reductions, not bytes. Design: K1's cluster, the whole
// tile the sample (G from macenko_fused.cluster_plan's batch rule: 16 blocks
// for one image, two per tile staged in device memory for 256 tiles); the
// staged estimate (stain::staged_macenko_rows) reads device memory once and is
// then a chain of 4 dependent reductions at nb=14 (the moments, the angles' min
// and max, two passes for the ten rounds and the successor; 3 at nb=10); the
// apply is split over the cluster by pixel range, 8 pixels per thread and step
// (stain::map_image) through K7's per-pixel body (augment_bytes), which reads
// the staged kernels' table rows. Per-tile alpha and beta arrive by pointer and
// stride, the scalars by value: the wrapper builds no table.
//
// augment_apply_kernel replaces augment_with_matrix_planar / the
// _augment_kernel with estimate=False (:886-929): K6's per-pixel part
// (augment_bytes) against given rows, per pixel with no reduction. Bound by
// the per-pixel arithmetic (about 105 instructions: the lasso with two IEEE
// divisions, three expf, the conversions), 3 bytes in and 3 out. Design: a
// 1-D persistent grid sized from the card (SMs x resident blocks of 256
// threads) walks (image, chunk) work items in a fixed stride; a block
// loads the tables into shared memory once, each channel's OD and
// luminance term side by side so one 8-byte gather serves both (none of
// the luminance with the background flag), and an image's rows, Gram
// terms, alpha and beta when its work moves to another image. The
// per-image values arrive by pointer and stride (0: shared), the scalars
// by value: the wrapper builds no table. A thread takes 16 pixels of a
// planar tile per step from three aligned 128-bit loads, or 8 interleaved
// pixels from 24 contiguous bytes, and stores the same way; an interleaved
// image whose base is off the vector grid or whose size is no multiple of
// the width gets a scalar head and tail. The one-stain quotients of the
// lasso are taken only where they are read (stain::lasso2_lazy).

#include <cuda_runtime.h>
#include <stdint.h>

#include "stain_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Args {
  const uint8_t* in;
  void* out;          // u8 tiles (K1, K6) or (B, 8) f32 (K4)
  const float* scal;  // (B, 8): target rows (6), maxC (2); K1 only
  const float* luts;  // (4, 256): OD, then 3 luminance terms
  int n_pix, pix_stride, ch_stride;
  int nblk, blk, stp;
  float y_thr, lam, q_lo, q_hi, q_conc;
  int it_angle, it_conc;
  int slice;      // K1, K4, K6: sample pixels staged per block
  int levels;     // K1, K4, K6: the most bisection rounds per reduction
  float* scratch;  // K1, K4, K6: the blocks' stages in device memory, or
                   // nullptr
};

// K1, K4, K6: one cluster of G blocks per tile (blockIdx.x / G), the
// bisection operands and the sample's bytes staged in `stage` (dynamic
// shared memory, 12 * a.slice bytes) or, with a.scratch, in the block's
// part of it.
struct ClusterShared {
  double dbuf[10 * kWarps];
  float lut[4][256];
  float fbuf[2 * kWarps];
  uint32_t hist[stain::hist_words(stain::kStaticLevels)];
  float res[8];
  stain::ClusterSlots cs;
};

template <bool kPlanar>
__global__ void __launch_bounds__(kThreads, 2) macenko_apply_kernel(Args a) {
  __shared__ ClusterShared sh;
  extern __shared__ __align__(16) float stage[];
  stain::Staged s = stain::stage_tile<kThreads>(a, sh, stage, kThreads);
  const int tile = blockIdx.x / s.G;
  const size_t tile_off = (size_t)tile * 3 * a.n_pix;
  const float* scal = a.scal + tile * 8;

  // Phases 1-3: moments, eigenplane, angular percentiles, stain rows.
  stain::ApplyScal as;
  stain::staged_macenko_rows<kThreads>(s, a.q_lo, a.q_hi, a.it_angle, as.he);
  // Phase 4: 99th-pct concentrations over the sample.
  as.g = stain::gram(as.he);
  as.lam = a.lam;
  float maxc[2];
  stain::staged_conc_maxc<kThreads>(s, as.he, as.g, a.lam, a.q_conc,
                                    a.it_conc, maxc);
  // Phase 5: rescale + Beer-Lambert reconstruction, this block's share of
  // the tile's pixels, 8 per thread and step.
  as.scale1 = scal[6] / fmaxf(maxc[0], 1e-8f);
  as.scale2 = scal[7] / fmaxf(maxc[1], 1e-8f);
  for (int i = 0; i < 6; ++i) as.tgt[i] = scal[i];
  const float* od = sh.lut[0];
  stain::map_image<kPlanar, 8, kThreads>(
      s.t.src, static_cast<uint8_t*>(a.out) + tile_off, a.n_pix, (int)s.rank,
      (int)s.G,
      [&](uint32_t r, uint32_t g, uint32_t b, uint32_t* out) {
        stain::normalize_bytes(r, g, b, od, as, out);
      });
  stain::staged_end(s);
}

__global__ void __launch_bounds__(kThreads, 2) macenko_fit_kernel(Args a) {
  __shared__ ClusterShared sh;
  extern __shared__ __align__(16) float stage[];
  stain::Staged s = stain::stage_tile<kThreads>(a, sh, stage, 0);
  float he[6];
  stain::staged_macenko_rows<kThreads>(s, a.q_lo, a.q_hi, a.it_angle, he);
  const stain::Gram g = stain::gram(he);
  float maxc[2];
  stain::staged_conc_maxc<kThreads>(s, he, g, a.lam, a.q_conc, a.it_conc,
                                    maxc);
  if (s.rank == 0 && threadIdx.x == 0) {
    float* out = static_cast<float*>(a.out) + blockIdx.x / s.G * 8;
    for (int i = 0; i < 6; ++i) out[i] = he[i];
    out[6] = maxc[0];
    out[7] = maxc[1];
  }
  stain::staged_end(s);
}

// K10. One tile is one cluster of G blocks (macenko_fused.eigenplane_plan);
// block `rank` reads part `rank` of the tile's 16-pixel groups, three 128-bit
// loads each, and each pixel's OD and luminance term come from K7's paired
// table. The ten moments (the count rides as a tenth double, exactly) fold
// over the warps and then the cluster's ranks in ascending order, and thread
// 0 of rank 0 turns them into the eigenplane (stain::eigenplane_from_moments).
constexpr int kEigenW = 16;  // planar pixels per thread and step
// Of the nine float terms per tissue pixel, the first kIntTerms reach
// double through integer operations (stain::pos_to_double), the rest
// through the conversion unit, so the two pipes share the work: on an H100
// 5 of 9 ran faster than 0, 3, 7 or 9 at 256 tiles of 256^2.
constexpr int kIntTerms = 5;

struct EigenArgs {
  const uint8_t* in;  // (B, 3, n_pix) planar
  float* out;         // (B, 3, 2)
  const float* luts;  // (4, 256): OD, then 3 luminance terms
  int n_pix;
  float y_thr;
  bool vec;  // the tiles' base is 16-byte aligned
};

__global__ void __launch_bounds__(kThreads, 2) eigenplane_kernel(EigenArgs a) {
  __shared__ float2 tab[3][256];
  __shared__ double dbuf[10 * kWarps];
  __shared__ float res[8];
  __shared__ stain::ClusterSlots cs;
  for (int i = threadIdx.x; i < 3 * 256; i += kThreads) {
    const int c = i >> 8, v = i & 255;
    tab[c][v] = make_float2(a.luts[v], a.luts[(1 + c) * 256 + v]);
  }
  __syncthreads();
  const cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  stain::Staged s{};
  s.G = cl.num_blocks();
  s.rank = cl.block_rank();
  s.dbuf = dbuf;
  s.res = res;
  s.cs = &cs;
  const int tile = blockIdx.x / s.G;
  const uint8_t* src = a.in + (size_t)tile * 3 * a.n_pix;
  const int groups = a.n_pix / kEigenW;
  const int per = (groups + s.G - 1) / s.G;
  const int end = min(groups, ((int)s.rank + 1) * per);
  double acc[10] = {0., 0., 0., 0., 0., 0., 0., 0., 0., 0.};
  int count = 0;
  for (int grp = (int)s.rank * per + (int)threadIdx.x; grp < end; grp += kThreads)
    stain::read_group<true, kEigenW>(
        src, a.n_pix, grp, a.vec, [&](uint32_t r, uint32_t g, uint32_t b) {
          const float2 tr = tab[0][r], tg = tab[1][g], tb = tab[2][b];
          if (tr.y + tg.y + tb.y < a.y_thr) {
            // float products, as the plain version's
            const float t[9] = {tr.x,        tg.x,        tb.x,
                                tr.x * tr.x, tr.x * tg.x, tr.x * tb.x,
                                tg.x * tg.x, tg.x * tb.x, tb.x * tb.x};
            count += 1;
#pragma unroll
            for (int k = 0; k < 9; ++k)
              acc[k + 1] += k < kIntTerms ? stain::pos_to_double(t[k])
                                          : (double)t[k];
          }
        });
  acc[0] = count;
  float* out = a.out + (size_t)tile * 6;
  const bool writer = s.rank == 0;
  stain::staged_sum_apply<kThreads>(s, acc, [&](const double* t, float*) {
    if (!writer) return;
    float st[10], v[6];
    for (int k = 0; k < 10; ++k) st[k] = (float)t[k];
    stain::eigenplane_from_moments(st, v);
    for (int k = 0; k < 6; ++k) out[k] = v[k];
  });
}

// The augment kernels' per-pixel body (K6, K7). One image's values, loaded
// when a block's work moves to another image (K7) or estimated (K6).
struct AugImage {
  float he[6];
  stain::Gram g;
  float a1, a2, b1, b2;
};

// A byte's OD and channel c's luminance term of it: from K7's table, which
// keeps the two side by side (one 8-byte gather), or from the staged
// kernels' rows (OD, then the three channels' terms).
__device__ __forceinline__ float2 od_lum(const float2 (*tab)[256], int c,
                                         uint32_t v) {
  return tab[c][v];
}

__device__ __forceinline__ float2 od_lum(const float (*lut)[256], int c,
                                         uint32_t v) {
  return make_float2(lut[0][v], lut[1 + c][v]);
}

// One pixel of StainAugmentor.pop (_augment_kernel :797-813) on bytes already
// in registers: the exact lasso against the rows he (its one-stain quotients
// only where they are read), C*alpha+beta where the pixel is tissue (or every
// pixel with kAll, the background flag, which reads no luminance),
// 255*exp(-C he) through the same rows, truncated to uint8 in one
// instruction. out: the three channel bytes.
template <bool kAll, typename Tab>
__device__ __forceinline__ void augment_bytes(uint32_t r, uint32_t g,
                                              uint32_t b, Tab tab,
                                              const AugImage& im, float lam,
                                              float y_thr, uint32_t out[3]) {
  float od[3], c1, c2;
  bool gate = true;
  if (kAll) {
    od[0] = od_lum(tab, 0, r).x;
    od[1] = od_lum(tab, 1, g).x;
    od[2] = od_lum(tab, 2, b).x;
  } else {
    const float2 tr = od_lum(tab, 0, r), tg = od_lum(tab, 1, g),
                 tb = od_lum(tab, 2, b);
    od[0] = tr.x;
    od[1] = tg.x;
    od[2] = tb.x;
    gate = tr.y + tg.y + tb.y < y_thr;
  }
  stain::lasso2_lazy(od[0], od[1], od[2], im.he, im.g, lam, c1, c2);
  if (gate) {
    c1 = c1 * im.a1 + im.b1;
    c2 = c2 * im.a2 + im.b2;
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    out[ch] = stain::u8_trunc(
        255.0f * expf(-(c1 * im.he[ch] + c2 * im.he[3 + ch])));
}

// K6. K1's cluster over the whole tile: the stain rows from the staged
// Macenko estimate, then augment_bytes on this block's share of the tile.
// alpha and beta come by pointer and stride (0: shared by all tiles); the
// regularizer (Args.lam), the luminance threshold (Args.y_thr) and the
// background flag by value.
struct AugmentArgs : Args {
  const float* alpha;  // 2 floats per tile
  const float* beta;   // 2
  int alpha_stride, beta_stride;
  bool all;
};

template <bool kPlanar>
__global__ void __launch_bounds__(kThreads, 2) macenko_augment_kernel(
    AugmentArgs a) {
  __shared__ ClusterShared sh;
  extern __shared__ __align__(16) float stage[];
  stain::Staged s = stain::stage_tile<kThreads>(a, sh, stage, kThreads);
  const int tile = blockIdx.x / s.G;
  AugImage im;
  stain::staged_macenko_rows<kThreads>(s, a.q_lo, a.q_hi, a.it_angle, im.he);
  im.g = stain::gram(im.he);
  const float* al = a.alpha + (size_t)tile * a.alpha_stride;
  const float* be = a.beta + (size_t)tile * a.beta_stride;
  im.a1 = __ldg(al);
  im.a2 = __ldg(al + 1);
  im.b1 = __ldg(be);
  im.b2 = __ldg(be + 1);
  const float(*lut)[256] = s.t.lut;
  uint8_t* dst = static_cast<uint8_t*>(a.out) + (size_t)tile * 3 * a.n_pix;
  if (a.all)
    stain::map_image<kPlanar, 8, kThreads>(
        s.t.src, dst, a.n_pix, (int)s.rank, (int)s.G,
        [&](uint32_t r, uint32_t g, uint32_t b, uint32_t* px) {
          augment_bytes<true>(r, g, b, lut, im, a.lam, a.y_thr, px);
        });
  else
    stain::map_image<kPlanar, 8, kThreads>(
        s.t.src, dst, a.n_pix, (int)s.rank, (int)s.G,
        [&](uint32_t r, uint32_t g, uint32_t b, uint32_t* px) {
          augment_bytes<false>(r, g, b, lut, im, a.lam, a.y_thr, px);
        });
  stain::staged_end(s);
}

// K7 and K3. A persistent 1-D grid sized from the card walks (image, chunk)
// work items, a chunk being one group of W pixels per thread. load(img) runs
// when a block's work moves to another image; f(r, g, b, out) maps each
// pixel's bytes, W per thread and step through map_group, an interleaved
// image's head and tail one at a time. A: the kernel's arguments (in, out,
// n_pix, chunks, items, in_vec, out_vec).
constexpr int kAugThreads = 256;

template <bool kPlanar, int W, typename A, typename Load, typename F>
__device__ __forceinline__ void walk_items(const A& a, Load load, F f) {
  int cur = -1;
  for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int img = (int)(item / a.chunks);
    const int chunk = (int)(item - (long long)img * a.chunks);
    if (img != cur) {
      cur = img;
      load(img);
    }
    const size_t img_off = (size_t)img * 3 * a.n_pix;
    const uint8_t* src = a.in + img_off;
    uint8_t* dst = a.out + img_off;
    // Interleaved: an image's base need not be W-byte aligned. Its first
    // `head` pixels and the pixels after the last whole group of W go one
    // at a time.
    int head = 0;
    bool in_vec = a.in_vec, out_vec = a.out_vec;
    if (!kPlanar) {
      head = stain::vector_head<W>(src, a.n_pix);
      in_vec = true;
      out_vec = ((uintptr_t)(dst + 3 * head) & (W - 1)) == 0;
    }
    const int groups = (a.n_pix - head) / W;
    const int grp = chunk * kAugThreads + (int)threadIdx.x;
    if (grp < groups)
      stain::map_group<kPlanar, W>(src + 3 * head, dst + 3 * head, a.n_pix,
                                   grp, in_vec, out_vec, f);
    if (!kPlanar && chunk == 0) {
      // Warp 0 takes the head pixels, warp 1 the tail (under W each).
      const int tail0 = head + W * groups;
      int p = -1;
      if ((int)threadIdx.x < head) p = threadIdx.x;
      if (threadIdx.x >= 32 && tail0 + (int)threadIdx.x - 32 < a.n_pix)
        p = tail0 + (int)threadIdx.x - 32;
      if (p >= 0) {
        uint32_t px[3];
        f(__ldg(src + 3 * (size_t)p), __ldg(src + 3 * (size_t)p + 1),
          __ldg(src + 3 * (size_t)p + 2), px);
        for (int c = 0; c < 3; ++c) dst[3 * (size_t)p + c] = (uint8_t)px[c];
      }
    }
  }
}

// K7. The per-image values come by pointer with a stride each (0: shared by
// all images); the regularizer, the luminance threshold and the background
// flag by value.
struct AugArgs {
  const uint8_t* in;
  uint8_t* out;
  const float* rows;   // 6 floats per image
  const float* alpha;  // 2
  const float* beta;   // 2
  int rows_stride, alpha_stride, beta_stride;
  const float* luts;  // (4, 256): OD, then 3 luminance terms
  int n_pix, chunks;  // pixels and work items per image
  long long items;    // batch * chunks
  float lam, y_thr;
  bool in_vec, out_vec;  // planar: the tensors' bases are 16-byte aligned
};

template <bool kPlanar, bool kAll, int W>
__global__ void __launch_bounds__(kAugThreads) augment_apply_kernel(AugArgs a) {
  __shared__ float2 tab[3][256];
  for (int i = threadIdx.x; i < 3 * 256; i += kAugThreads) {
    const int c = i >> 8, v = i & 255;
    tab[c][v] = make_float2(a.luts[v], a.luts[(1 + c) * 256 + v]);
  }
  __syncthreads();
  AugImage im;
  walk_items<kPlanar, W>(
      a,
      [&](int img) {
        const float* rows = a.rows + (size_t)img * a.rows_stride;
        for (int i = 0; i < 6; ++i) im.he[i] = __ldg(rows + i);
        im.g = stain::gram(im.he);
        const float* al = a.alpha + (size_t)img * a.alpha_stride;
        const float* be = a.beta + (size_t)img * a.beta_stride;
        im.a1 = __ldg(al);
        im.a2 = __ldg(al + 1);
        im.b1 = __ldg(be);
        im.b2 = __ldg(be + 1);
      },
      [&](uint32_t r, uint32_t g, uint32_t b, uint32_t* px) {
        augment_bytes<kAll>(r, g, b, tab, im, a.lam, a.y_thr, px);
      });
}

// K3. The per-image source rows, source maxC, target rows and target maxC
// come by pointer with a stride each (0: shared by all images), the
// regularizer by value; each image's rescale maxC_tgt / max(maxC_src, 1e-8)
// is the plain version's IEEE quotient (clamp_min keeps a NaN), taken once
// per image.
struct MatrixArgs {
  const uint8_t* in;
  uint8_t* out;
  const float* src;      // 6 floats per image
  const float* max_src;  // 2
  const float* tgt;      // 6
  const float* max_tgt;  // 2
  int src_stride, max_src_stride, tgt_stride, max_tgt_stride;
  const float* od;  // K1's OD table (row 0 of its luts)
  int n_pix, chunks;
  long long items;
  float lam;
  bool in_vec, out_vec;
};

// 8 pixels per thread and step in both layouts: on an H100, planar tiles ran
// faster at 8 than at 16 (fewer registers), where K7 gains at 16; the lasso
// through lasso2_by gained on 256 tiles with per-tile rows and lost on a
// 2048^2 field, the tiled route's call.
constexpr int kMatrixW = 8;

__device__ __forceinline__ float rescale(float max_tgt, float max_src) {
  return max_tgt / (isnan(max_src) ? max_src : fmaxf(max_src, 1e-8f));
}

template <bool kPlanar>
__global__ void __launch_bounds__(kAugThreads) matrix_apply_kernel(MatrixArgs a) {
  __shared__ float od[256];
  for (int i = threadIdx.x; i < 256; i += kAugThreads) od[i] = a.od[i];
  __syncthreads();
  stain::ApplyScal as;
  as.lam = a.lam;
  walk_items<kPlanar, kMatrixW>(
      a,
      [&](int img) {
        const float* src = a.src + (size_t)img * a.src_stride;
        const float* tgt = a.tgt + (size_t)img * a.tgt_stride;
        for (int i = 0; i < 6; ++i) {
          as.he[i] = __ldg(src + i);
          as.tgt[i] = __ldg(tgt + i);
        }
        as.g = stain::gram(as.he);
        const float* ms = a.max_src + (size_t)img * a.max_src_stride;
        const float* mt = a.max_tgt + (size_t)img * a.max_tgt_stride;
        as.scale1 = rescale(__ldg(mt), __ldg(ms));
        as.scale2 = rescale(__ldg(mt + 1), __ldg(ms + 1));
      },
      [&](uint32_t r, uint32_t g, uint32_t b, uint32_t* px) {
        stain::normalize_bytes(r, g, b, od, as, px);
      });
}

Args make_args(const void* in, void* out, const void* scal, const void* luts,
               int n_pix, int pix_stride, int ch_stride, int nblk, int blk,
               int stp, float y_thr, float lam, float q_lo, float q_hi,
               float q_conc, int it_angle, int it_conc, int slice = 0,
               int levels = 0, float* scratch = nullptr) {
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
  a.lam = lam;
  a.q_lo = q_lo;
  a.q_hi = q_hi;
  a.q_conc = q_conc;
  a.it_angle = it_angle;
  a.it_conc = it_conc;
  a.slice = slice;
  a.levels = levels;
  a.scratch = scratch;
  return a;
}

}  // namespace

// K1 and K4 over `batch` tiles: clusters of G blocks, each staging `slice`
// sample pixels (12 bytes each; macenko_fused.cluster_plan) in `smem` bytes
// of dynamic shared memory or, where `scratch` is given (smem 0), in
// batch * G * 12 * slice bytes of device memory. K1 reads planar tiles
// (pix_stride 1) or interleaved ones.
extern "C" cudaError_t macenko_normalize_launch(
    int device, const void* in, void* out, const void* scal, const void* luts,
    int batch, int n_pix, int pix_stride, int ch_stride, int nblk, int blk,
    int stp, float y_thr, float lam, float q_lo, float q_hi, float q_conc,
    int it_angle, int it_conc, int G, int slice, int smem, int levels,
    void* scratch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  const Args a = make_args(in, out, scal, luts, n_pix, pix_stride, ch_stride,
                           nblk, blk, stp, y_thr, lam, q_lo, q_hi, q_conc,
                           it_angle, it_conc, slice, levels,
                           static_cast<float*>(scratch));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pix_stride == 1
             ? stain::launch_cluster<macenko_apply_kernel<true>>(
                   a, device, batch, G, kThreads, smem, s)
             : stain::launch_cluster<macenko_apply_kernel<false>>(
                   a, device, batch, G, kThreads, smem, s);
}

extern "C" cudaError_t macenko_fit_launch(
    int device, const void* in, void* out, const void* luts, int batch,
    int n_pix, int pix_stride, int ch_stride, float y_thr, float lam,
    float q_lo, float q_hi, float q_conc, int it_angle, int it_conc, int G,
    int slice, int smem, int levels, void* scratch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  // The fit covers the whole tile: a one-block sample.
  const Args a = make_args(in, out, nullptr, luts, n_pix, pix_stride,
                           ch_stride, 1, n_pix, n_pix, y_thr, lam, q_lo, q_hi,
                           q_conc, it_angle, it_conc, slice, levels,
                           static_cast<float*>(scratch));
  return stain::launch_cluster<macenko_fit_kernel>(
      a, device, batch, G, kThreads, smem, static_cast<cudaStream_t>(stream));
}

// K10 over `batch` planar tiles of n_pix pixels (a multiple of 128):
// clusters of G blocks, out (batch, 3, 2) float32.
extern "C" cudaError_t eigenplane_launch(int device, const void* in, void* out,
                                         const void* luts, int batch,
                                         int n_pix, float y_thr, int G,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  EigenArgs a;
  a.in = static_cast<const uint8_t*>(in);
  a.out = static_cast<float*>(out);
  a.luts = static_cast<const float*>(luts);
  a.n_pix = n_pix;
  a.y_thr = y_thr;
  a.vec = (reinterpret_cast<uintptr_t>(in) & (kEigenW - 1)) == 0;
  return stain::launch_cluster<eigenplane_kernel>(
      a, device, batch, G, kThreads, 0, static_cast<cudaStream_t>(stream));
}

// K6 over `batch` tiles of n_pix pixels, planar (pix_stride 1) or
// interleaved: clusters of G blocks as K1's, the whole tile the sample.
// alpha / beta: float32 on the device, tile i's values at ptr + i * stride
// (stride 0: one set for all tiles).
extern "C" cudaError_t augment_launch(
    int device, const void* in, void* out, const void* alpha,
    int alpha_stride, const void* beta, int beta_stride, const void* luts,
    int batch, int n_pix, int pix_stride, int ch_stride, float y_thr,
    float lam, int all, float q_lo, float q_hi, int it_angle, int G,
    int slice, int smem, int levels, void* scratch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  // The estimate covers the whole tile: a one-block sample.
  AugmentArgs a;
  static_cast<Args&>(a) = make_args(
      in, out, nullptr, luts, n_pix, pix_stride, ch_stride, 1, n_pix, n_pix,
      y_thr, lam, q_lo, q_hi, 0.0f, it_angle, 0, slice, levels,
      static_cast<float*>(scratch));
  a.alpha = static_cast<const float*>(alpha);
  a.beta = static_cast<const float*>(beta);
  a.alpha_stride = alpha_stride;
  a.beta_stride = beta_stride;
  a.all = all != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pix_stride == 1
             ? stain::launch_cluster<macenko_augment_kernel<true>>(
                   a, device, batch, G, kThreads, smem, s)
             : stain::launch_cluster<macenko_augment_kernel<false>>(
                   a, device, batch, G, kThreads, smem, s);
}

// A persistent grid of `kernel` over a.items images (K7, K3): the work
// items, the vector flags and the grid, sized from the card.
template <auto kernel, int W, typename A>
cudaError_t launch_walk(A a, int device, cudaStream_t stream) {
  int grid = 0;
  const cudaError_t err =
      stain::resident_blocks<kernel>(device, kAugThreads, &grid);
  if (err != cudaSuccess) return err;
  const int groups = a.n_pix / W;
  a.chunks = groups > 0 ? (groups + kAugThreads - 1) / kAugThreads : 1;
  a.items *= a.chunks;
  a.in_vec = (reinterpret_cast<uintptr_t>(a.in) & (W - 1)) == 0;
  a.out_vec = (reinterpret_cast<uintptr_t>(a.out) & (W - 1)) == 0;
  if ((long long)grid > a.items) grid = (int)a.items;
  kernel<<<grid, kAugThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// K7 over `batch` images of n_pix pixels, planar (n_pix a multiple of 128)
// or interleaved (any n_pix). rows / alpha / beta: float32 on the device,
// image i's values at ptr + i * stride (stride 0: one set for all images).
// A thread takes 16 pixels per step of a planar tile (three 128-bit loads)
// and 8 of an interleaved image (24 contiguous bytes): on an H100 the
// narrower de-interleave measured 15% faster on a 2048^2 field (56
// registers against 80), the wider planar form 5% faster on 256 tiles.
extern "C" cudaError_t augment_apply_launch(
    int device, const void* in, void* out, const void* rows, int rows_stride,
    const void* alpha, int alpha_stride, const void* beta, int beta_stride,
    const void* luts, int batch, int n_pix, int planar, float lam, float y_thr,
    int all, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0 || n_pix == 0) return cudaSuccess;
  AugArgs a;
  a.in = static_cast<const uint8_t*>(in);
  a.out = static_cast<uint8_t*>(out);
  a.rows = static_cast<const float*>(rows);
  a.alpha = static_cast<const float*>(alpha);
  a.beta = static_cast<const float*>(beta);
  a.rows_stride = rows_stride;
  a.alpha_stride = alpha_stride;
  a.beta_stride = beta_stride;
  a.luts = static_cast<const float*>(luts);
  a.n_pix = n_pix;
  a.items = batch;  // times the chunks per image, which follow the width
  a.lam = lam;
  a.y_thr = y_thr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planar)
    return all ? launch_walk<augment_apply_kernel<true, true, 16>, 16>(a, device, s)
               : launch_walk<augment_apply_kernel<true, false, 16>, 16>(a, device, s);
  return all ? launch_walk<augment_apply_kernel<false, true, 8>, 8>(a, device, s)
             : launch_walk<augment_apply_kernel<false, false, 8>, 8>(a, device, s);
}

// K3 over `batch` images of n_pix pixels, planar (n_pix a multiple of 128)
// or interleaved (any n_pix), on K7's grid. src / max_src
// / tgt / max_tgt: float32 on the device, image i's values at ptr + i *
// stride (stride 0: one set for all images). od: K1's OD table.
extern "C" cudaError_t matrix_normalize_launch(
    int device, const void* in, void* out, const void* src, int src_stride,
    const void* max_src, int max_src_stride, const void* tgt, int tgt_stride,
    const void* max_tgt, int max_tgt_stride, const void* od, int batch,
    int n_pix, int planar, float lam, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0 || n_pix == 0) return cudaSuccess;
  MatrixArgs a;
  a.in = static_cast<const uint8_t*>(in);
  a.out = static_cast<uint8_t*>(out);
  a.src = static_cast<const float*>(src);
  a.max_src = static_cast<const float*>(max_src);
  a.tgt = static_cast<const float*>(tgt);
  a.max_tgt = static_cast<const float*>(max_tgt);
  a.src_stride = src_stride;
  a.max_src_stride = max_src_stride;
  a.tgt_stride = tgt_stride;
  a.max_tgt_stride = max_tgt_stride;
  a.od = static_cast<const float*>(od);
  a.n_pix = n_pix;
  a.items = batch;  // times the chunks per image
  a.lam = lam;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return planar
             ? launch_walk<matrix_apply_kernel<true>, kMatrixW>(a, device, s)
             : launch_walk<matrix_apply_kernel<false>, kMatrixW>(a, device, s);
}

extern "C" const char* stain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// stainlib_tpu_torch's copy of stainlib_tpu/data/_native/tilereader.cpp, built and
// loaded by stainlib_tpu_torch/data/native.py (the port never loads the JAX
// package's library). The code below is the JAX package's, unchanged.
//
// Native host-side tile pipeline for stainlib_tpu.
//
// Role: the TPU-native equivalent of the reference's native data plumbing —
// OpenSlide/PyVips region decode + OpenCV HSV/morphology tissue detection in
// the WSI sampler (dlmodels/color-information/data_utils.py:1, class
// make_dataset) — re-designed as a small self-contained C++ library over
// memory-mapped raw pyramids so the host never bottlenecks the device:
//
//   * mmap'd zero-copy pyramid access ("WSR1" format; see data/wsiraw.py),
//   * threaded strided region copy (tr_read_region),
//   * tissue-filtered random tile sampling with white-mean and low-stddev
//     rejection quotas (tr_sample_tiles — the trainer-mode rejection rules
//     of data_utils.py:1: background mean>white_thresh or stddev<15),
//   * HSV in-range tissue mask + separable box close/open morphology
//     (tr_tissue_mask — the get_bb ROI detection: 50x50 close, 30x30 open),
//   * batched HWC->planar uint8 repack (tr_pack_planar) so the device-side
//     Pallas kernel receives lane-aligned planes without an on-device
//     transpose.
//
// Exposed as a C ABI for ctypes; no external dependencies.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x31525357;  // "WSR1" little-endian
constexpr int kMaxLevels = 16;

struct Level {
  uint64_t offset;  // byte offset of the RGB8 plane
  uint32_t width;
  uint32_t height;
};

struct Slide {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  uint32_t n_levels = 0;
  Level levels[kMaxLevels];
};

int thread_count() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 1 : static_cast<int>(n);
}

// Run fn(i) for i in [0, n) over the pool. Degrades to inline for small n.
template <typename F>
void parallel_for(int64_t n, F fn) {
  int workers = std::min<int64_t>(thread_count(), n);
  if (workers <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([&] {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& t : pool) t.join();
}

// xorshift64* — deterministic, seedable, fast.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ull) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1Dull;
  }
  uint32_t below(uint32_t n) { return static_cast<uint32_t>(next() % n); }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Pyramid file handling
// ---------------------------------------------------------------------------

void* tr_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t* base = static_cast<const uint8_t*>(mem);
  uint32_t magic, n_levels;
  std::memcpy(&magic, base, 4);
  std::memcpy(&n_levels, base + 4, 4);
  if (magic != kMagic || n_levels == 0 || n_levels > kMaxLevels) {
    munmap(mem, st.st_size);
    ::close(fd);
    return nullptr;
  }
  auto* s = new Slide;
  s->fd = fd;
  s->base = base;
  s->size = st.st_size;
  s->n_levels = n_levels;
  uint64_t off = 8 + 16ull * n_levels;
  bool bad = false;
  for (uint32_t i = 0; i < n_levels; ++i) {
    uint32_t w, h;
    std::memcpy(&w, base + 8 + 16ull * i, 4);
    std::memcpy(&h, base + 8 + 16ull * i + 4, 4);
    // Reject degenerate/overflowing geometry: with w,h <= 2^24 the plane
    // size 3*w*h <= 3*2^48 cannot wrap uint64, so the file-size check
    // below stays sound even for corrupt headers.
    if (w == 0 || h == 0 || w > (1u << 24) || h > (1u << 24)) bad = true;
    s->levels[i] = {off, w, h};
    off += 3ull * w * h;
  }
  if (bad || off > static_cast<uint64_t>(st.st_size)) {
    munmap(mem, st.st_size);
    ::close(fd);
    delete s;
    return nullptr;
  }
  return s;
}

void tr_close(void* handle) {
  auto* s = static_cast<Slide*>(handle);
  if (!s) return;
  munmap(const_cast<uint8_t*>(s->base), s->size);
  ::close(s->fd);
  delete s;
}

int tr_num_levels(void* handle) {
  return static_cast<Slide*>(handle)->n_levels;
}

void tr_level_size(void* handle, int level, uint32_t* w, uint32_t* h) {
  auto* s = static_cast<Slide*>(handle);
  if (!s || level < 0 || level >= static_cast<int>(s->n_levels)) {
    *w = *h = 0;  // callers validate against tr_num_levels
    return;
  }
  *w = s->levels[level].width;
  *h = s->levels[level].height;
}

// Copy an RGB region (x, y, w, h) of a level into `out` (h*w*3 bytes).
// Rows are copied in parallel; out-of-bounds area is filled white (the
// reference substitutes background on failed fetches, data_utils.py:1).
int tr_read_region(void* handle, int level, int64_t x, int64_t y,
                   int64_t w, int64_t h, uint8_t* out) {
  auto* s = static_cast<Slide*>(handle);
  if (!s || level < 0 || level >= static_cast<int>(s->n_levels)) return -1;
  const Level& lv = s->levels[level];
  const uint8_t* plane = s->base + lv.offset;
  parallel_for(h, [&](int64_t r) {
    uint8_t* dst = out + r * w * 3;
    int64_t src_y = y + r;
    if (src_y < 0 || src_y >= lv.height) {
      std::memset(dst, 0xFF, w * 3);
      return;
    }
    int64_t x0 = std::max<int64_t>(x, 0);
    int64_t x1 = std::min<int64_t>(x + w, lv.width);
    if (x0 >= x1) {
      std::memset(dst, 0xFF, w * 3);
      return;
    }
    if (x < x0) std::memset(dst, 0xFF, (x0 - x) * 3);
    std::memcpy(dst + (x0 - x) * 3,
                plane + (src_y * int64_t(lv.width) + x0) * 3,
                (x1 - x0) * 3);
    if (x + w > x1) std::memset(dst + (x1 - x) * 3, 0xFF, (x + w - x1) * 3);
  });
  return 0;
}

// ---------------------------------------------------------------------------
// Tissue-filtered random tile sampling
// ---------------------------------------------------------------------------

// Draw up to `n` tiles of size `tile` at `level`, rejecting tiles whose mean
// exceeds `white_mean_max` (background) or whose per-channel stddev is below
// `stddev_min` (the sampler's uniform-patch rejection, data_utils.py:1).
// Optional `mask` (mask_w x mask_h, 1 byte/px, covering the level at
// mask_scale) restricts top-left corners to mask>0. Returns the number of
// accepted tiles; fills out[n*tile*tile*3] and coords[n*2] (x, y).
int tr_sample_tiles(void* handle, int level, int tile, int n, uint64_t seed,
                    double white_mean_max, double stddev_min,
                    const uint8_t* mask, int mask_w, int mask_h,
                    double mask_scale, int max_attempts_per_tile,
                    uint8_t* out, int64_t* coords) {
  auto* s = static_cast<Slide*>(handle);
  if (!s) return -1;
  if (level < 0 || level >= static_cast<int>(s->n_levels)) return -2;
  const Level& lv = s->levels[level];
  if (lv.width < static_cast<uint32_t>(tile) ||
      lv.height < static_cast<uint32_t>(tile))
    return 0;  // callers pre-fill out/coords with the gray/(-1,-1) contract
  std::atomic<int> accepted(0);
  parallel_for(n, [&](int64_t i) {
    Rng rng(seed * 0x9E3779B1u + i * 0x85EBCA77u + 1);
    uint8_t* buf = out + i * int64_t(tile) * tile * 3;
    for (int attempt = 0; attempt < max_attempts_per_tile; ++attempt) {
      int64_t x = rng.below(lv.width - tile + 1);
      int64_t y = rng.below(lv.height - tile + 1);
      if (mask) {
        int mx = std::min<int>(int(x * mask_scale), mask_w - 1);
        int my = std::min<int>(int(y * mask_scale), mask_h - 1);
        if (!mask[my * mask_w + mx]) continue;
      }
      // Cheap accept/reject FIRST on a strided subsample straight from the
      // mmap'd plane (16x fewer bytes than the full tile); only accepted
      // tiles pay the full region copy. The subsampled mean/std is
      // statistically equivalent for the white/uniform rejection rule.
      {
        const Level& lv2 = s->levels[level];
        const uint8_t* plane = s->base + lv2.offset;
        double sum = 0, sq = 0;
        int64_t count = 0;
        for (int64_t r = 0; r < tile; r += 4) {
          const uint8_t* row = plane + ((y + r) * int64_t(lv2.width) + x) * 3;
          for (int64_t c = 0; c < tile * 3; c += 10) {  // stride!=3k cycles channels
            double v = row[c];
            sum += v;
            sq += v * v;
            ++count;
          }
        }
        double mean = sum / count;
        double var = sq / count - mean * mean;
        if (mean > white_mean_max) continue;
        if (var < stddev_min * stddev_min) continue;
      }
      // Serial in-bounds row copy: this already runs inside a
      // parallel_for worker, and tr_read_region would spawn a second
      // thread pool per candidate (quadratic oversubscription on
      // many-core hosts). x/y are clamped to the level, so no
      // white-fill handling is needed.
      {
        const uint8_t* plane = s->base + lv.offset;
        for (int64_t r = 0; r < tile; ++r)
          std::memcpy(buf + r * int64_t(tile) * 3,
                      plane + ((y + r) * int64_t(lv.width) + x) * 3,
                      size_t(tile) * 3);
      }
      // Exact stats on the (now cache-hot) copied tile: the subsample is a
      // pre-filter; acceptance always satisfies the exact thresholds.
      {
        double sum = 0, sq = 0;
        int64_t count = int64_t(tile) * tile * 3;
        for (int64_t k = 0; k < count; ++k) {
          double v = buf[k];
          sum += v;
          sq += v * v;
        }
        double mean = sum / count;
        double var = sq / count - mean * mean;
        if (mean > white_mean_max || var < stddev_min * stddev_min) continue;
      }
      coords[i * 2] = x;
      coords[i * 2 + 1] = y;
      accepted.fetch_add(1);
      return;
    }
    // Exhausted attempts: substitute mid-gray noise-free patch and mark it.
    std::memset(buf, 0x80, int64_t(tile) * tile * 3);
    coords[i * 2] = -1;
    coords[i * 2 + 1] = -1;
  });
  return accepted.load();
}

// ---------------------------------------------------------------------------
// HSV tissue mask + box morphology (the sampler's get_bb ROI detection)
// ---------------------------------------------------------------------------

namespace {

// OpenCV-convention HSV from RGB bytes: H in [0,180), S,V in [0,255].
// Divisions round to nearest (OpenCV's fixed-point tables round too), so
// the native mask agrees with the cv2 fallback at threshold boundaries.
inline void rgb_to_hsv(uint8_t r, uint8_t g, uint8_t b, uint8_t* h,
                       uint8_t* sat, uint8_t* val) {
  int mx = std::max({r, g, b}), mn = std::min({r, g, b});
  int v = mx, delta = mx - mn;
  int sv = mx == 0 ? 0 : (255 * delta + mx / 2) / mx;
  int hh = 0;
  if (delta != 0) {
    auto rdiv = [&](int num) {  // round-to-nearest, correct for num < 0
      return num >= 0 ? (num + delta / 2) / delta : -((-num + delta / 2) / delta);
    };
    if (mx == r)
      hh = rdiv(30 * (g - b));
    else if (mx == g)
      hh = 60 + rdiv(30 * (b - r));
    else
      hh = 120 + rdiv(30 * (r - g));
    if (hh < 0) hh += 180;
  }
  *h = static_cast<uint8_t>(hh);
  *sat = static_cast<uint8_t>(sv);
  *val = static_cast<uint8_t>(v);
}

// Separable box erode/dilate on a binary byte mask.
void box_morph(uint8_t* m, int w, int h, int k, bool dilate) {
  if (k <= 1) return;
  int r = k / 2;
  std::vector<uint8_t> tmp(size_t(w) * h);
  // Horizontal pass (sliding window count).
  parallel_for(h, [&](int64_t y) {
    const uint8_t* row = m + y * w;
    uint8_t* dst = tmp.data() + y * w;
    int count = 0;
    for (int x = -r; x <= r && x < w; ++x) count += x >= 0 ? row[x] : 0;
    for (int x = 0; x < w; ++x) {
      dst[x] = dilate ? (count > 0) : (count == std::min(w - 1, x + r) -
                                                    std::max(0, x - r) + 1);
      int enter = x + r + 1, leave = x - r;
      if (enter < w) count += row[enter];
      if (leave >= 0) count -= row[leave];
    }
  });
  // Vertical pass.
  parallel_for(w, [&](int64_t x) {
    int count = 0;
    for (int y = -r; y <= r && y < h; ++y)
      count += y >= 0 ? tmp[size_t(y) * w + x] : 0;
    for (int y = 0; y < h; ++y) {
      m[size_t(y) * w + x] =
          dilate ? (count > 0)
                 : (count == std::min(h - 1, y + r) - std::max(0, y - r) + 1);
      int enter = y + r + 1, leave = y - r;
      if (enter < h) count += tmp[size_t(enter) * w + x];
      if (leave >= 0) count -= tmp[size_t(leave) * w + x];
    }
  });
}

}  // namespace

// HSV in-range threshold on an RGB byte image followed by box close(k_close)
// then open(k_open) — data_utils.py:1's get_bb (inRange + 50x50 close +
// 30x30 open). Writes a 0/1 byte mask.
int tr_tissue_mask(const uint8_t* rgb, int w, int h, int h_lo, int h_hi,
                   int s_lo, int s_hi, int v_lo, int v_hi, int k_close,
                   int k_open, uint8_t* mask) {
  parallel_for(h, [&](int64_t y) {
    for (int x = 0; x < w; ++x) {
      const uint8_t* p = rgb + (y * w + x) * 3;
      uint8_t hh, ss, vv;
      rgb_to_hsv(p[0], p[1], p[2], &hh, &ss, &vv);
      bool in = hh >= h_lo && hh <= h_hi && ss >= s_lo && ss <= s_hi &&
                vv >= v_lo && vv <= v_hi;
      mask[y * w + x] = in ? 1 : 0;
    }
  });
  // close = dilate then erode; open = erode then dilate.
  box_morph(mask, w, h, k_close, /*dilate=*/true);
  box_morph(mask, w, h, k_close, /*dilate=*/false);
  box_morph(mask, w, h, k_open, /*dilate=*/false);
  box_morph(mask, w, h, k_open, /*dilate=*/true);
  return 0;
}

// ---------------------------------------------------------------------------
// Batch repack: (B, H, W, 3) uint8 -> (B, 3, H*W) planar
// ---------------------------------------------------------------------------

int tr_pack_planar(const uint8_t* in, uint8_t* out, int64_t b, int64_t h,
                   int64_t w) {
  int64_t n = h * w;
  parallel_for(b, [&](int64_t i) {
    const uint8_t* src = in + i * n * 3;
    uint8_t* dst = out + i * n * 3;
    for (int64_t p = 0; p < n; ++p) {
      dst[p] = src[p * 3];
      dst[n + p] = src[p * 3 + 1];
      dst[2 * n + p] = src[p * 3 + 2];
    }
  });
  return 0;
}

}  // extern "C"

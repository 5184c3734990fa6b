// stainlib_tpu_torch's copy of stainlib_tpu/data/_native/tiffreader.cpp, built and
// loaded by stainlib_tpu_torch/data/native.py (the port never loads the JAX
// package's library). The code below is the JAX package's, unchanged.
//
// libtiff-backed pyramidal slide reader/writer for stainlib_tpu.
//
// Role: real whole-slide-format ingestion — the reference streams tiles from
// .tif/.svs via OpenSlide.read_region and pyvips.Region.fetch
// (dlmodels/color-information/data_utils.py:1, trainer/tester fetch blocks).
// Aperio .svs files and pyramidal .tif are tiled TIFF containers; this module
// decodes them directly with the system libtiff (JPEG/deflate/LZW codecs),
// exposing the same C ABI surface as the WSIRAW reader (tilereader.cpp):
// level geometry, white-padded region reads, and tissue-filtered random tile
// sampling with white-mean / low-stddev rejection.
//
// Concurrency: libtiff handles are not thread-safe, so each slide keeps a
// pool of TIFF* handles; concurrent region reads each check one out. Built
// separately from tilereader.cpp so the base pipeline still works on hosts
// without libtiff.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <tiffio.h>

namespace {

struct LevelInfo {
  uint16_t dir;        // TIFF directory index
  uint32_t width, height;
  uint32_t tile_w, tile_h;  // tile dims, or (width, rows_per_strip) if stripped
  bool tiled;
  uint16_t spp;        // samples per pixel as decoded (3 or 4)
  bool ycbcr_jpeg;     // needs JPEGCOLORMODE_RGB before reads
};

struct Slide {
  std::string path;
  std::vector<LevelInfo> levels;
  std::mutex mu;
  std::vector<TIFF*> pool;

  TIFF* acquire() {
    {
      std::lock_guard<std::mutex> l(mu);
      if (!pool.empty()) {
        TIFF* t = pool.back();
        pool.pop_back();
        return t;
      }
    }
    return TIFFOpen(path.c_str(), "rm");  // m: no mmap of huge slides
  }
  void release(TIFF* t) {
    std::lock_guard<std::mutex> l(mu);
    pool.push_back(t);
  }
  ~Slide() {
    for (TIFF* t : pool) TIFFClose(t);
  }
};

// Silence libtiff's default stderr chatter (unknown tags in vendor files).
void quiet_handler(const char*, const char*, va_list) {}

struct InstallQuiet {
  InstallQuiet() {
    TIFFSetWarningHandler(quiet_handler);
    TIFFSetErrorHandler(quiet_handler);
  }
} install_quiet;

// Position a pooled handle on a level, applying per-read tags.
bool set_level(TIFF* t, const LevelInfo& lv) {
  if (!TIFFSetDirectory(t, lv.dir)) return false;
  if (lv.ycbcr_jpeg)
    TIFFSetField(t, TIFFTAG_JPEGCOLORMODE, JPEGCOLORMODE_RGB);
  return true;
}

int thread_count() {
  // STAINLIB_TIFF_THREADS overrides the decode-thread count: used by the
  // host-scaling benchmark and to cap threads on shared TPU-VM hosts.
  const char* env = std::getenv("STAINLIB_TIFF_THREADS");
  if (env != nullptr) {
    int v = std::atoi(env);
    if (v > 0) return v;
  }
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 1 : static_cast<int>(n);
}

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

// Copy the intersection of a decoded block (top-left origin, contiguous
// spp-channel rows) with the requested region; `bx, by` are the block's
// level coordinates, `bw, bh` its nominal dims, `valid_w/h` the in-image part.
void blit_block(const uint8_t* block, int64_t bx, int64_t by, int64_t bw,
                int64_t valid_w, int64_t valid_h, int spp, int64_t x,
                int64_t y, int64_t w, int64_t h, uint8_t* out) {
  int64_t x0 = std::max(x, bx), x1 = std::min(x + w, bx + valid_w);
  int64_t y0 = std::max(y, by), y1 = std::min(y + h, by + valid_h);
  if (x0 >= x1 || y0 >= y1) return;
  for (int64_t r = y0; r < y1; ++r) {
    const uint8_t* src = block + ((r - by) * bw + (x0 - bx)) * spp;
    uint8_t* dst = out + ((r - y) * w + (x0 - x)) * 3;
    if (spp == 3) {
      std::memcpy(dst, src, (x1 - x0) * 3);
    } else {
      for (int64_t c = 0; c < x1 - x0; ++c) {
        dst[c * 3] = src[c * spp];
        dst[c * 3 + 1] = src[c * spp + 1];
        dst[c * 3 + 2] = src[c * spp + 2];
      }
    }
  }
}

int read_region_locked(Slide* s, TIFF* t, int level, int64_t x, int64_t y,
                       int64_t w, int64_t h, uint8_t* out) {
  const LevelInfo& lv = s->levels[level];
  if (!set_level(t, lv)) return -2;
  std::memset(out, 0xFF, size_t(w) * h * 3);  // OOB area stays white
  int64_t ix0 = std::max<int64_t>(x, 0), iy0 = std::max<int64_t>(y, 0);
  int64_t ix1 = std::min<int64_t>(x + w, lv.width);
  int64_t iy1 = std::min<int64_t>(y + h, lv.height);
  if (ix0 >= ix1 || iy0 >= iy1) return 0;

  if (lv.tiled) {
    std::vector<uint8_t> buf(TIFFTileSize(t));
    for (int64_t ty = (iy0 / lv.tile_h) * lv.tile_h; ty < iy1;
         ty += lv.tile_h) {
      for (int64_t tx = (ix0 / lv.tile_w) * lv.tile_w; tx < ix1;
           tx += lv.tile_w) {
        if (TIFFReadTile(t, buf.data(), tx, ty, 0, 0) < 0) return -3;
        int64_t vw = std::min<int64_t>(lv.tile_w, lv.width - tx);
        int64_t vh = std::min<int64_t>(lv.tile_h, lv.height - ty);
        blit_block(buf.data(), tx, ty, lv.tile_w, vw, vh, lv.spp, x, y, w, h,
                   out);
      }
    }
  } else {
    std::vector<uint8_t> buf(TIFFStripSize(t));
    int64_t rps = lv.tile_h;  // rows per strip
    for (int64_t sy = (iy0 / rps) * rps; sy < iy1; sy += rps) {
      tstrip_t strip = TIFFComputeStrip(t, sy, 0);
      if (TIFFReadEncodedStrip(t, strip, buf.data(), -1) < 0) return -3;
      int64_t vh = std::min<int64_t>(rps, lv.height - sy);
      blit_block(buf.data(), 0, sy, lv.width, lv.width, vh, lv.spp, x, y, w,
                 h, out);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

void* tf_open(const char* path) {
  TIFF* t = TIFFOpen(path, "rm");
  if (!t) return nullptr;
  auto* s = new Slide;
  s->path = path;
  do {
    uint32_t w = 0, h = 0;
    uint16_t bits = 8, spp = 1, photo = 0, planar = PLANARCONFIG_CONTIG,
             comp = COMPRESSION_NONE;
    TIFFGetField(t, TIFFTAG_IMAGEWIDTH, &w);
    TIFFGetField(t, TIFFTAG_IMAGELENGTH, &h);
    TIFFGetFieldDefaulted(t, TIFFTAG_BITSPERSAMPLE, &bits);
    TIFFGetFieldDefaulted(t, TIFFTAG_SAMPLESPERPIXEL, &spp);
    TIFFGetFieldDefaulted(t, TIFFTAG_PLANARCONFIG, &planar);
    TIFFGetFieldDefaulted(t, TIFFTAG_COMPRESSION, &comp);
    TIFFGetField(t, TIFFTAG_PHOTOMETRIC, &photo);
    bool ycbcr_jpeg =
        photo == PHOTOMETRIC_YCBCR && comp == COMPRESSION_JPEG;
    bool ok = w > 0 && h > 0 && bits == 8 && spp >= 3 &&
              planar == PLANARCONFIG_CONTIG &&
              (photo == PHOTOMETRIC_RGB || ycbcr_jpeg);
    if (ok) {
      LevelInfo lv;
      lv.dir = TIFFCurrentDirectory(t);
      lv.width = w;
      lv.height = h;
      lv.tiled = TIFFIsTiled(t);
      lv.ycbcr_jpeg = ycbcr_jpeg;
      lv.spp = spp;
      if (lv.tiled) {
        TIFFGetField(t, TIFFTAG_TILEWIDTH, &lv.tile_w);
        TIFFGetField(t, TIFFTAG_TILELENGTH, &lv.tile_h);
      } else {
        uint32_t rps = h;
        TIFFGetFieldDefaulted(t, TIFFTAG_ROWSPERSTRIP, &rps);
        lv.tile_w = w;
        lv.tile_h = std::min(rps, h);
      }
      s->levels.push_back(lv);
    }
  } while (TIFFReadDirectory(t));

  if (s->levels.empty()) {
    TIFFClose(t);
    delete s;
    return nullptr;
  }
  // Pyramid order: widest first. Drop associated images (label/macro in
  // .svs) whose aspect ratio deviates from the baseline by > 10%.
  std::stable_sort(s->levels.begin(), s->levels.end(),
                   [](const LevelInfo& a, const LevelInfo& b) {
                     return a.width > b.width;
                   });
  double aspect0 = double(s->levels[0].width) / s->levels[0].height;
  s->levels.erase(
      std::remove_if(s->levels.begin() + 1, s->levels.end(),
                     [&](const LevelInfo& lv) {
                       double a = double(lv.width) / lv.height;
                       return a < aspect0 * 0.9 || a > aspect0 * 1.1;
                     }),
      s->levels.end());
  s->pool.push_back(t);
  return s;
}

void tf_close(void* handle) { delete static_cast<Slide*>(handle); }

int tf_num_levels(void* handle) {
  return static_cast<int>(static_cast<Slide*>(handle)->levels.size());
}

void tf_level_size(void* handle, int level, uint32_t* w, uint32_t* h) {
  auto* s = static_cast<Slide*>(handle);
  if (!s || level < 0 || level >= static_cast<int>(s->levels.size())) {
    *w = *h = 0;  // callers validate against tf_num_levels
    return;
  }
  *w = s->levels[level].width;
  *h = s->levels[level].height;
}

int tf_read_region(void* handle, int level, int64_t x, int64_t y, int64_t w,
                   int64_t h, uint8_t* out) {
  auto* s = static_cast<Slide*>(handle);
  if (!s || level < 0 || level >= static_cast<int>(s->levels.size()))
    return -1;
  TIFF* t = s->acquire();
  if (!t) return -4;
  int rc = read_region_locked(s, t, level, x, y, w, h, out);
  s->release(t);
  return rc;
}

// Batched region decode for the exhaustive eval stream (the reference
// tester's 100k-tile deployment loop, data_utils.py:1): one call decodes n
// same-sized regions concurrently across the slide's handle pool, so eval
// streaming gets the same multi-threaded decode as train-mode sampling.
// Returns the number of regions decoded successfully (failures are filled
// mid-gray so the batch stays usable, mirroring the sampler's slot
// substitution).
int tf_read_regions(void* handle, int level, const int64_t* xs,
                    const int64_t* ys, int n, int64_t w, int64_t h,
                    uint8_t* out) {
  auto* s = static_cast<Slide*>(handle);
  if (!s || level < 0 || level >= static_cast<int>(s->levels.size()))
    return -1;
  std::atomic<int> ok(0);
  parallel_for(n, [&](int64_t i) {
    uint8_t* buf = out + i * w * h * 3;
    TIFF* t = s->acquire();
    if (!t) {
      std::memset(buf, 0x80, w * h * 3);
      return;
    }
    if (read_region_locked(s, t, level, xs[i], ys[i], w, h, buf) == 0)
      ok.fetch_add(1);
    else
      std::memset(buf, 0x80, w * h * 3);
    s->release(t);
  });
  return ok.load();
}

// Random tissue tiles with the trainer-mode rejection rules
// (data_utils.py:1): background mean > white_mean_max or stddev < stddev_min.
// Same contract as tr_sample_tiles; the cheap pre-filter is skipped because
// every candidate costs a decode anyway.
int tf_sample_tiles(void* handle, int level, int tile, int n, uint64_t seed,
                    double white_mean_max, double stddev_min,
                    const uint8_t* mask, int mask_w, int mask_h,
                    double mask_scale, int max_attempts_per_tile,
                    uint8_t* out, int64_t* coords) {
  auto* s = static_cast<Slide*>(handle);
  if (!s) return -1;
  if (level < 0 || level >= static_cast<int>(s->levels.size())) return -2;
  const LevelInfo& lv = s->levels[level];
  if (lv.width < static_cast<uint32_t>(tile) ||
      lv.height < static_cast<uint32_t>(tile))
    return 0;
  std::atomic<int> accepted(0);
  parallel_for(n, [&](int64_t i) {
    Rng rng(seed * 0x9E3779B1u + i * 0x85EBCA77u + 1);
    uint8_t* buf = out + i * int64_t(tile) * tile * 3;
    TIFF* t = s->acquire();
    if (!t) {
      std::memset(buf, 0x80, int64_t(tile) * tile * 3);
      coords[i * 2] = coords[i * 2 + 1] = -1;
      return;
    }
    bool done = false;
    for (int attempt = 0; attempt < max_attempts_per_tile && !done;
         ++attempt) {
      int64_t x = rng.below(lv.width - tile + 1);
      int64_t y = rng.below(lv.height - tile + 1);
      if (mask) {
        int mx = std::min<int>(int(x * mask_scale), mask_w - 1);
        int my = std::min<int>(int(y * mask_scale), mask_h - 1);
        if (!mask[my * mask_w + mx]) continue;
      }
      if (read_region_locked(s, t, level, x, y, tile, tile, buf) != 0)
        continue;
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
      coords[i * 2] = x;
      coords[i * 2 + 1] = y;
      accepted.fetch_add(1);
      done = true;
    }
    if (!done) {
      std::memset(buf, 0x80, int64_t(tile) * tile * 3);
      coords[i * 2] = coords[i * 2 + 1] = -1;
    }
    s->release(t);
  });
  return accepted.load();
}

// ---------------------------------------------------------------------------
// Pyramidal tiled-TIFF writer (converter output + test fixtures)
// ---------------------------------------------------------------------------

void* tf_writer_open(const char* path) { return TIFFOpen(path, "w"); }

// compression: 1 = none, 5 = LZW, 7 = JPEG, 8 = deflate (TIFF tag values).
// JPEG levels are written as YCbCr (the .svs convention); tile must be a
// multiple of 16 for JPEG.
int tf_writer_add_level(void* handle, uint32_t w, uint32_t h,
                        const uint8_t* rgb, uint32_t tile, int compression,
                        int quality, int is_reduced) {
  TIFF* t = static_cast<TIFF*>(handle);
  if (!t) return -1;
  TIFFSetField(t, TIFFTAG_IMAGEWIDTH, w);
  TIFFSetField(t, TIFFTAG_IMAGELENGTH, h);
  TIFFSetField(t, TIFFTAG_BITSPERSAMPLE, 8);
  TIFFSetField(t, TIFFTAG_SAMPLESPERPIXEL, 3);
  TIFFSetField(t, TIFFTAG_PLANARCONFIG, PLANARCONFIG_CONTIG);
  TIFFSetField(t, TIFFTAG_ORIENTATION, ORIENTATION_TOPLEFT);
  TIFFSetField(t, TIFFTAG_TILEWIDTH, tile);
  TIFFSetField(t, TIFFTAG_TILELENGTH, tile);
  TIFFSetField(t, TIFFTAG_COMPRESSION, compression);
  if (is_reduced)
    TIFFSetField(t, TIFFTAG_SUBFILETYPE, FILETYPE_REDUCEDIMAGE);
  if (compression == COMPRESSION_JPEG) {
    TIFFSetField(t, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_YCBCR);
    TIFFSetField(t, TIFFTAG_JPEGQUALITY, quality);
    TIFFSetField(t, TIFFTAG_JPEGCOLORMODE, JPEGCOLORMODE_RGB);
    TIFFSetField(t, TIFFTAG_YCBCRSUBSAMPLING, 2, 2);
  } else {
    TIFFSetField(t, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_RGB);
  }
  std::vector<uint8_t> buf(size_t(tile) * tile * 3);
  for (uint32_t ty = 0; ty < h; ty += tile) {
    for (uint32_t tx = 0; tx < w; tx += tile) {
      uint32_t vw = std::min(tile, w - tx), vh = std::min(tile, h - ty);
      // Edge padding replicates the border pixel (avoids JPEG ringing).
      for (uint32_t r = 0; r < tile; ++r) {
        uint32_t sr = std::min(r, vh - 1);
        const uint8_t* src = rgb + ((size_t(ty) + sr) * w + tx) * 3;
        uint8_t* dst = buf.data() + size_t(r) * tile * 3;
        std::memcpy(dst, src, size_t(vw) * 3);
        for (uint32_t c = vw; c < tile; ++c)
          std::memcpy(dst + size_t(c) * 3, src + (size_t(vw) - 1) * 3, 3);
      }
      if (TIFFWriteTile(t, buf.data(), tx, ty, 0, 0) < 0) return -2;
    }
  }
  return TIFFWriteDirectory(t) == 1 ? 0 : -3;
}

void tf_writer_close(void* handle) {
  if (handle) TIFFClose(static_cast<TIFF*>(handle));
}

}  // extern "C"

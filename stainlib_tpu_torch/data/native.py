"""ctypes bindings and on-demand build of the native slide readers.

Port of the JAX package's ``data/native.py``. The C++ core plays the role of
the reference's native data plumbing (OpenSlide/PyVips decode and OpenCV
morphology inside ``data_utils.py:1``): ``_native/tilereader.cpp`` reads
memory-mapped WSIRAW pyramids, ``_native/tiffreader.cpp`` reads and writes
tiled pyramidal TIFF (.svs, .tif) through the system libtiff. Both are
copies of the JAX package's sources.

The port builds its own libraries at first use with ``g++`` into
``_native/_build/``, under names hashed from the source and the flags, and
moves each finished library into place with ``os.replace``, so a
concurrent build never leaves a half-written file to load. It never loads
the JAX package's libraries. Every entry point has a numpy (WSIRAW) or PIL
(TIFF) fallback for hosts without a compiler or libtiff; the TIFF writer
has none and raises there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_NATIVE = Path(__file__).resolve().parent / "_native"
BUILD_DIR = _NATIVE / "_build"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_libs: dict = {}  # source stem -> loaded CDLL, or None once a build failed

MAGIC = 0x31525357  # "WSR1"

_p, _i, _i64, _u64, _d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                          ctypes.c_uint64, ctypes.c_double)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_SAMPLE = [_p, _i, _i, _i, _u64, _d, _d, _p, _i, _i, _d, _i, _p, _p]
# (argtypes, restype) of every entry point.
_TR_API = {
    "tr_open": ([ctypes.c_char_p], _p),
    "tr_close": ([_p], None),
    "tr_num_levels": ([_p], _i),
    "tr_level_size": ([_p, _i, _u32p, _u32p], None),
    "tr_read_region": ([_p, _i, _i64, _i64, _i64, _i64, _p], _i),
    "tr_sample_tiles": (_SAMPLE, _i),
    "tr_tissue_mask": ([_p] + [_i] * 10 + [_p], _i),
    "tr_pack_planar": ([_p, _p, _i64, _i64, _i64], _i),
}
_TF_API = {
    "tf_open": ([ctypes.c_char_p], _p),
    "tf_close": ([_p], None),
    "tf_num_levels": ([_p], _i),
    "tf_level_size": ([_p, _i, _u32p, _u32p], None),
    "tf_read_region": ([_p, _i, _i64, _i64, _i64, _i64, _p], _i),
    "tf_read_regions": ([_p, _i, _p, _p, _i, _i64, _i64, _p], _i),
    "tf_sample_tiles": (_SAMPLE, _i),
    "tf_writer_open": ([ctypes.c_char_p], _p),
    "tf_writer_add_level": ([_p, ctypes.c_uint32, ctypes.c_uint32, _p,
                             ctypes.c_uint32, _i, _i, _i], _i),
    "tf_writer_close": ([_p], None),
}


def library_path(stem: str, libs: Tuple[str, ...] = ()) -> Path:
    """Where the library built from ``_native/<stem>.cpp`` lives: a name
    that carries the hash of the source and the flags."""
    src = _NATIVE / f"{stem}.cpp"
    h = hashlib.sha256(" ".join(_CXX_FLAGS + libs).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def _build(stem: str, libs: Tuple[str, ...] = ()) -> Optional[Path]:
    """Compile ``_native/<stem>.cpp`` unless its hashed library exists;
    its path, or None where ``g++`` (or a library it links) is missing."""
    target = library_path(stem, libs)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", *_CXX_FLAGS, str(_NATIVE / f"{stem}.cpp"),
                        *libs, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    except (OSError, subprocess.CalledProcessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def _load(stem: str, api: dict, libs: Tuple[str, ...] = ()):
    """The loaded library of ``stem`` (building it first), or None; a
    failure is remembered, so later calls go straight to the fallback."""
    with _lock:
        if stem in _libs:
            return _libs[stem]
        lib = None
        path = _build(stem, libs)
        if path is not None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:  # unloadable (foreign arch or glibc): fall back
                lib = None
        if lib is not None:
            for name, (argtypes, restype) in api.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
        _libs[stem] = lib
        return lib


def build_native() -> Optional[str]:
    """Build the WSIRAW reader if needed; its path, or None."""
    path = _build("tilereader")
    return None if path is None else str(path)


def get_lib() -> Optional[ctypes.CDLL]:
    """The WSIRAW reader's library (built if needed); None if unavailable."""
    return _load("tilereader", _TR_API)


def native_available() -> bool:
    return get_lib() is not None


def get_tiff_lib() -> Optional[ctypes.CDLL]:
    """The TIFF reader and writer (built against the system libtiff if
    needed); None where libtiff or a compiler is missing."""
    return _load("tiffreader", _TF_API, ("-ltiff",))


def tiff_native_available() -> bool:
    return get_tiff_lib() is not None


# ---------------------------------------------------------------------------
# WSIRAW ("WSR1") pyramid container
# ---------------------------------------------------------------------------


def write_wsiraw(path: str, levels) -> None:
    """Write a raw RGB pyramid: header (magic, n_levels, per-level w/h/pad)
    followed by contiguous uint8 HWC planes, coarsest last. ``levels``:
    sequence of (H, W, 3) uint8 arrays, level 0 first (full resolution)."""
    with open(path, "wb") as f:
        f.write(np.uint32(MAGIC).tobytes())
        f.write(np.uint32(len(levels)).tobytes())
        for lv in levels:
            h, w, c = lv.shape
            if c != 3 or lv.dtype != np.uint8:
                raise ValueError(f"levels are (H, W, 3) uint8, got "
                                 f"{lv.shape} {lv.dtype}")
            f.write(np.uint32(w).tobytes())
            f.write(np.uint32(h).tobytes())
            f.write(np.zeros(2, np.uint32).tobytes())  # reserved
        for lv in levels:
            f.write(np.ascontiguousarray(lv).tobytes())


class _SlideBase:
    """Shared native-with-fallback slide handle: level geometry,
    white-filled ``read_region``, and rejection ``sample_tiles`` (the
    trainer-mode rules of ``data_utils.py:1``). Subclasses set the C-ABI
    prefix (``tr_``/``tf_``) and provide the fallback level loader."""

    _PREFIX = ""

    def __init__(self, path: str):
        self.path = path
        self._lib = self._get_lib()
        self._handle = None
        self._np_levels = None
        if self._lib is not None:
            self._handle = self._fn("open")(path.encode())
        if not self._handle:
            self._lib = None
            self._np_levels = self._load_fallback(path)

    # -- subclass hooks -----------------------------------------------------
    def _get_lib(self):
        raise NotImplementedError

    def _load_fallback(self, path: str):
        raise NotImplementedError

    def _fn(self, name: str):
        return getattr(self._lib, self._PREFIX + name)

    # -- shared API ----------------------------------------------------------
    @property
    def native(self) -> bool:
        return self._handle is not None

    @property
    def num_levels(self) -> int:
        if self.native:
            return self._fn("num_levels")(self._handle)
        return len(self._np_levels)

    def _check_level(self, level: int):
        n = self.num_levels
        if not 0 <= level < n:
            raise IndexError(f"level {level} out of range for "
                             f"{n}-level slide {self.path!r}")

    def level_size(self, level: int) -> Tuple[int, int]:
        """(width, height)."""
        self._check_level(level)
        if self.native:
            w = ctypes.c_uint32()
            h = ctypes.c_uint32()
            self._fn("level_size")(self._handle, level, ctypes.byref(w),
                                   ctypes.byref(h))
            return w.value, h.value
        lv = self._np_levels[level]
        return lv.shape[1], lv.shape[0]

    def read_region(self, level: int, x: int, y: int, w: int, h: int):
        """(h, w, 3) uint8; out-of-bounds filled white."""
        self._check_level(level)
        out = np.empty((h, w, 3), np.uint8)
        if self.native:
            rc = self._fn("read_region")(
                self._handle, level, x, y, w, h,
                out.ctypes.data_as(ctypes.c_void_p),
            )
            if rc != 0:
                raise OSError(
                    f"{self._PREFIX}read_region failed (rc={rc}) on "
                    f"{self.path!r} level {level} at ({x}, {y})")
            return out
        lv = self._np_levels[level]
        out[:] = 255
        x0, y0 = max(x, 0), max(y, 0)
        x1, y1 = min(x + w, lv.shape[1]), min(y + h, lv.shape[0])
        if x0 < x1 and y0 < y1:
            out[y0 - y : y1 - y, x0 - x : x1 - x] = lv[y0:y1, x0:x1]
        return out

    def sample_tiles(self, level: int, tile: int, n: int, seed: int = 0,
                     white_mean_max: float = 230.0, stddev_min: float = 15.0,
                     mask: Optional[np.ndarray] = None,
                     mask_scale: float = 0.0,
                     max_attempts: int = 50):
        """Random tissue tiles with rejection (trainer-mode sampling rules
        of ``data_utils.py:1``). Returns (tiles (n,t,t,3), coords (n,2));
        coords are (-1,-1) for slots that exhausted their attempts (or when
        the level is smaller than the tile), with mid-gray filler tiles."""
        self._check_level(level)
        # The native samplers return early without touching the buffers
        # when the level is smaller than the tile: pre-fill the failure
        # contract so no uninitialized memory is mistaken for tiles.
        out = np.full((n, tile, tile, 3), 128, np.uint8)
        coords = np.full((n, 2), -1, np.int64)
        if self.native:
            m_ptr = None
            mw = mh = 0
            if mask is not None:
                mask = np.ascontiguousarray(mask.astype(np.uint8))
                m_ptr = mask.ctypes.data_as(ctypes.c_void_p)
                mh, mw = mask.shape
            rc = self._fn("sample_tiles")(
                self._handle, level, tile, n, seed, white_mean_max,
                stddev_min, m_ptr, mw, mh, mask_scale, max_attempts,
                out.ctypes.data_as(ctypes.c_void_p),
                coords.ctypes.data_as(ctypes.c_void_p),
            )
            if rc < 0:
                raise OSError(
                    f"{self._PREFIX}sample_tiles failed (rc={rc}) on "
                    f"{self.path!r} level {level}")
            return out, coords
        rng = np.random.default_rng(seed)
        W, H = self.level_size(level)
        if W < tile or H < tile:
            return out, coords  # same contract as the native early return
        for i in range(n):
            for _ in range(max_attempts):
                x = int(rng.integers(0, W - tile + 1))
                y = int(rng.integers(0, H - tile + 1))
                if mask is not None:
                    mx = min(int(x * mask_scale), mask.shape[1] - 1)
                    my = min(int(y * mask_scale), mask.shape[0] - 1)
                    if not mask[my, mx]:
                        continue
                patch = self.read_region(level, x, y, tile, tile)
                if patch.mean() > white_mean_max or patch.std() < stddev_min:
                    continue
                out[i] = patch
                coords[i] = (x, y)
                break
        return out, coords

    def close(self):
        if self.native and self._handle:
            self._fn("close")(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RawSlide(_SlideBase):
    """Handle over a WSIRAW pyramid, native-backed with a numpy fallback;
    the ``read_region`` / level-geometry surface the WSI sampler needs from
    OpenSlide/pyvips (``data_utils.py:1``)."""

    _PREFIX = "tr_"

    def _get_lib(self):
        return get_lib()

    def _load_fallback(self, path: str):
        return _read_wsiraw_numpy(path)


def _read_wsiraw_numpy(path: str):
    with open(path, "rb") as f:
        head = np.frombuffer(f.read(8), np.uint32)
        if len(head) < 2 or head[0] != MAGIC:
            raise ValueError(f"not a WSIRAW file: {path!r}")
        n = int(head[1])
        geom = np.frombuffer(f.read(16 * n), np.uint32)
        if len(geom) != 4 * n:
            raise ValueError(f"truncated WSIRAW header: {path!r}")
        geom = geom.reshape(n, 4)
        size = os.fstat(f.fileno()).st_size
        if 8 + 16 * n + sum(3 * int(w) * int(h) for w, h, _, _ in geom) > size:
            raise ValueError(f"WSIRAW levels exceed the file: {path!r}")
        levels = []
        for i in range(n):
            w, h = int(geom[i, 0]), int(geom[i, 1])
            levels.append(
                np.frombuffer(f.read(3 * w * h), np.uint8).reshape(h, w, 3)
            )
    return levels


# ---------------------------------------------------------------------------
# Tiled-TIFF (.svs / pyramidal .tif) ingestion
# ---------------------------------------------------------------------------

# TIFF compression tags accepted by write_tiff_pyramid.
TIFF_COMPRESSION = {"none": 1, "lzw": 5, "jpeg": 7, "deflate": 8}


def write_tiff_pyramid(path: str, levels, tile: int = 256,
                       compression: str = "jpeg", quality: int = 90) -> None:
    """Write a tiled pyramidal TIFF (the .svs container layout: baseline IFD
    first, reduced-resolution IFDs after). ``levels``: (H, W, 3) uint8
    arrays, level 0 first. JPEG levels are stored as YCbCr like Aperio."""
    lib = get_tiff_lib()
    if lib is None:
        raise RuntimeError("native TIFF writer unavailable (libtiff/g++)")
    comp = TIFF_COMPRESSION[compression]
    if comp == 7 and tile % 16 != 0:
        raise ValueError("JPEG tiles must be multiples of 16")
    handle = lib.tf_writer_open(path.encode())
    if not handle:
        raise OSError(f"cannot create {path}")
    try:
        for i, lv in enumerate(levels):
            if lv.dtype != np.uint8 or lv.shape[-1] != 3:
                raise ValueError(f"levels are (H, W, 3) uint8, got "
                                 f"{lv.shape} {lv.dtype}")
            lv = np.ascontiguousarray(lv)
            rc = lib.tf_writer_add_level(
                handle, lv.shape[1], lv.shape[0],
                lv.ctypes.data_as(ctypes.c_void_p), tile, comp, quality,
                1 if i else 0,
            )
            if rc != 0:
                raise OSError(f"TIFF level write failed ({rc})")
    finally:
        lib.tf_writer_close(handle)


class TiffSlide(_SlideBase):
    """Handle over a tiled/stripped pyramidal TIFF (.svs, .tif): the
    OpenSlide.read_region / pyvips.Region.fetch replacement
    (``data_utils.py:1``). Native libtiff decode with a PIL fallback."""

    _PREFIX = "tf_"

    def _get_lib(self):
        return get_tiff_lib()

    def _load_fallback(self, path: str):
        return _read_tiff_pil(path)

    def read_regions(self, level: int, coords, w: int, h: int):
        """Batched ``read_region``: (n, h, w, 3) uint8 decoded concurrently
        across the handle pool (one C call, threaded), the eval-stream
        counterpart of the threaded train-mode sampler (the reference
        tester's exhaustive deployment loop, ``data_utils.py:1``). Failed
        regions come back mid-gray, like the sampler's slot substitution."""
        self._check_level(level)
        coords = np.ascontiguousarray(coords, np.int64).reshape(-1, 2)
        n = len(coords)
        out = np.empty((n, h, w, 3), np.uint8)
        if self.native:
            xs = np.ascontiguousarray(coords[:, 0])
            ys = np.ascontiguousarray(coords[:, 1])
            rc = self._lib.tf_read_regions(
                self._handle, level, xs.ctypes.data_as(ctypes.c_void_p),
                ys.ctypes.data_as(ctypes.c_void_p), n, w, h,
                out.ctypes.data_as(ctypes.c_void_p),
            )
            if rc < 0:
                raise OSError(f"tf_read_regions failed (rc={rc}) on "
                              f"{self.path!r} level {level}")
            return out
        for i, (x, y) in enumerate(coords):
            out[i] = self.read_region(level, int(x), int(y), w, h)
        return out


def _read_tiff_pil(path: str):
    """Fallback full-level decode via PIL; keeps IFDs whose aspect ratio
    matches the baseline (drops .svs label/macro images)."""
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        frames = [
            np.asarray(f.convert("RGB"))
            for f in ImageSequence.Iterator(im)
        ]
    frames.sort(key=lambda a: -a.shape[1])
    a0 = frames[0].shape[1] / frames[0].shape[0]
    keep = [frames[0]] + [
        f for f in frames[1:]
        if 0.9 * a0 <= f.shape[1] / f.shape[0] <= 1.1 * a0
    ]
    return keep


_TIFF_EXTS = (".tif", ".tiff", ".svs")


def open_slide(path: str):
    """Open any supported slide container: WSIRAW ('WSR1') or tiled TIFF
    (.tif/.tiff/.svs). Dispatches on magic bytes, falling back to extension."""
    with open(path, "rb") as f:
        head = f.read(4)
    if len(head) == 4 and np.frombuffer(head, np.uint32)[0] == MAGIC:
        return RawSlide(path)
    if head[:2] in (b"II", b"MM") or path.lower().endswith(_TIFF_EXTS):
        return TiffSlide(path)
    return RawSlide(path)


# ---------------------------------------------------------------------------
# Standalone helpers
# ---------------------------------------------------------------------------


def tissue_mask_hsv(rgb: np.ndarray, h_range=(120, 180), s_range=(20, 255),
                    v_range=(30, 255), k_close: int = 51, k_open: int = 31):
    """HSV in-range tissue mask + box close/open morphology, the sampler's
    ``get_bb`` ROI detection (``data_utils.py:1``). Returns a bool mask."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    out = np.empty((h, w), np.uint8)
    lib = get_lib()
    if lib is not None:
        lib.tr_tissue_mask(
            rgb.ctypes.data_as(ctypes.c_void_p), w, h,
            h_range[0], h_range[1], s_range[0], s_range[1],
            v_range[0], v_range[1], k_close, k_open,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out.astype(bool)
    # numpy fallback (cv2-convention HSV)
    import cv2 as cv

    hsv = cv.cvtColor(rgb, cv.COLOR_RGB2HSV)
    m = cv.inRange(hsv, (h_range[0], s_range[0], v_range[0]),
                   (h_range[1], s_range[1], v_range[1])).astype(np.uint8)
    m = cv.morphologyEx(m, cv.MORPH_CLOSE, np.ones((k_close, k_close), np.uint8))
    m = cv.morphologyEx(m, cv.MORPH_OPEN, np.ones((k_open, k_open), np.uint8))
    return m.astype(bool)


def pack_planar(batch: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 -> (B, 3, H*W//128, 128): the host-side repack
    into the planar layout the fused kernels' planar entries take."""
    b, h, w, _ = batch.shape
    if (h * w) % 128:
        raise ValueError(f"H*W must be a multiple of 128, got {h}x{w}")
    out = np.empty((b, 3, h * w), np.uint8)
    lib = get_lib()
    batch = np.ascontiguousarray(batch)
    if lib is not None:
        lib.tr_pack_planar(
            batch.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p), b, h, w,
        )
    else:
        out[:] = batch.transpose(0, 3, 1, 2).reshape(b, 3, h * w)
    return out.reshape(b, 3, (h * w) // 128, 128)

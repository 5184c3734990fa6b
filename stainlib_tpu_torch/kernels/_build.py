"""Lazy build and ``ctypes`` binding of the CUDA kernels in ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, for ``sm_90a`` (Hopper), at first use. The library goes to
``kernels/_build/`` under a name that carries the hash of the sources and
flags, so it is rebuilt only when they change. Importing this module
builds nothing; neither does importing the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

# -fmad=false: products and sums round separately, as in the plain torch
# versions the kernels are held against. No fast math: 255*exp(-od) sits
# on uint8 boundaries. -Xptxas -v reports registers and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home
                  else []) + [shutil.which("nvcc") or "",
                              "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libstain_kernels_{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_info.update(seconds=time.perf_counter() - t0, built=True,
                      log=proc.stdout + proc.stderr)
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, target)  # atomic: concurrent builders never see a stub


def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    target = library_path()
    if target.exists():
        build_info.update(seconds=0.0, built=False, log="")
    else:
        _compile(target)
    lib = ctypes.CDLL(str(target))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.macenko_normalize_launch
    fn.argtypes = [i32, ptr, ptr, ptr, ptr,  # device, in, out, scal, luts
                   i32, i32, i32, i32,  # batch, n_pix, pix/ch stride
                   i32, i32, i32,  # nblk, blk, stp
                   f32, f32, f32, f32, f32,  # y_thr, lam, q_lo, q_hi, q_conc
                   i32, i32, ptr]  # it_angle, it_conc, stream
    fn.restype = i32
    lib.stain_error_string.argtypes = [i32]
    lib.stain_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def error_string(err: int) -> str:
    return load_library().stain_error_string(err).decode()

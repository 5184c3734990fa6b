"""Lazy build and ``ctypes`` binding of the CUDA kernels in ``csrc/``.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (Hopper), all sources
at once in parallel processes, and links the objects into one shared
library with a plain C interface, at first use. The library goes to
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from stainlib_tpu_torch.utils.profiling import launch_span

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

# -fmad=false: products and sums round separately, as in the plain torch
# versions the kernels are held against. No fast math: 255*exp(-od) sits
# on uint8 boundaries. -Xptxas -v reports registers and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lib = None
build_info: dict = {}

_ptr, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Every entry point takes the device first and the stream last, and
# returns a cudaError_t.
_ARGTYPES = {
    "macenko_normalize_launch": [
        _i32, _ptr, _ptr, _ptr, _ptr,  # device, in, out, scal, luts
        _i32, _i32, _i32, _i32,  # batch, n_pix, pix/ch stride
        _i32, _i32, _i32,  # nblk, blk, stp
        _f32, _f32, _f32, _f32, _f32,  # y_thr, lam, q_lo, q_hi, q_conc
        _i32, _i32,  # it_angle, it_conc
        _i32, _i32, _i32, _i32, _ptr,  # G, slice, smem bytes, levels,
        #                                scratch
        _ptr],  # stream
    "vahadane_normalize_launch": [
        _i32, _ptr, _ptr, _ptr, _ptr,  # device, in, out, scal, luts
        _i32, _i32, _i32, _i32,  # batch, n_pix, pix/ch stride
        _i32, _i32, _i32,  # nblk, blk, stp
        _f32, _f32, _f32, _f32, _f32, _f32,  # y_thr, lam_fit, lam, q_lo,
        #                                      q_hi, q_conc
        _i32, _i32, _i32,  # num_iters, it_angle, it_conc
        _i32, _i32, _i32, _i32, _ptr,  # G, slice, smem bytes, levels,
        #                                scratch
        _ptr],  # stream
    "vahadane_dict_launch": [
        _i32, _ptr, _ptr, _ptr,  # device, in, out, luts
        _i32, _i32, _i32, _i32,  # batch, n_pix, pix/ch stride
        _i32, _i32, _i32,  # nblk, blk, stp
        _f32, _f32, _f32, _f32,  # y_thr, lam_fit, q_lo, q_hi
        _i32, _i32,  # num_iters, it_angle
        _i32, _i32, _i32, _i32, _ptr,  # G, slice, smem bytes, levels,
        #                                scratch
        _ptr],  # stream
    "fused_normalize_launch": [
        _i32, _ptr, _ptr,  # device, in, out
        _ptr, _i32, _ptr, _i32, _ptr, _i32,  # source rows, target rows,
        #                                      maxC_target: each a pointer
        #                                      and a per-tile stride
        _ptr, _i32, _i32, _i32, _i32,  # lut, batch, n_pix, pix/ch stride
        _f32, _f32, _i32,  # lam, q, iters
        _i32, _i32, _i32, _i32, _ptr,  # G, slice, smem bytes, levels,
        #                                scratch
        _ptr],  # stream
    "macenko_fit_launch": [
        _i32, _ptr, _ptr, _ptr,  # device, in, out, luts
        _i32, _i32, _i32, _i32,  # batch, n_pix, pix/ch stride
        _f32, _f32, _f32, _f32, _f32,  # y_thr, lam, q_lo, q_hi, q_conc
        _i32, _i32,  # it_angle, it_conc
        _i32, _i32, _i32, _i32, _ptr,  # G, slice, smem bytes, levels,
        #                                scratch
        _ptr],  # stream
    "eigenplane_launch": [
        _i32, _ptr, _ptr, _ptr,  # device, in, out, luts
        _i32, _i32, _f32, _i32,  # batch, n_pix, y_thr, G
        _ptr],  # stream
    "matrix_normalize_launch": [
        _i32, _ptr, _ptr,  # device, in, out
        _ptr, _i32, _ptr, _i32, _ptr, _i32, _ptr, _i32,  # source rows,
        #   source maxC, target rows, target maxC: each a pointer and a
        #   per-image stride
        _ptr, _i32, _i32, _i32,  # OD table, batch, n_pix, planar
        _f32, _ptr],  # lam, stream
    "augment_launch": [
        _i32, _ptr, _ptr,  # device, in, out
        _ptr, _i32, _ptr, _i32,  # alpha, beta: pointer and per-tile stride
        _ptr, _i32, _i32, _i32, _i32,  # luts, batch, n_pix, pix/ch stride
        _f32, _f32, _i32,  # y_thr, lam, background flag
        _f32, _f32, _i32,  # q_lo, q_hi, it_angle
        _i32, _i32, _i32, _i32, _ptr,  # G, slice, smem bytes, levels,
        #                                scratch
        _ptr],  # stream
    "augment_apply_launch": [
        _i32, _ptr, _ptr,  # device, in, out
        _ptr, _i32, _ptr, _i32, _ptr, _i32,  # rows, alpha, beta: each a
        #                                      pointer and a per-image stride
        _ptr, _i32, _i32, _i32,  # luts, batch, n_pix, planar
        _f32, _f32, _i32, _ptr],  # lam, y_thr, background flag, stream
    "reinhard_normalize_launch": [
        _i32, _ptr, _ptr,  # device, in, out
        _ptr, _i32, _ptr, _i32,  # means, stds: pointer and per-tile stride
        _ptr, _i32, _i32, _i32,  # lin, batch, n_pix, planar
        _i32, _i32,  # G, slice
        _f32, _f32, _f32, _ptr],  # rank_lo, frac, 1 - frac, stream
}


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libstain_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run every command at once, each in its own process; (returncode,
    log) of each, in order."""
    def run(cmd):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return proc.returncode, proc.stdout + proc.stderr

    with ThreadPoolExecutor(max_workers=max(len(cmds), 1)) as pool:
        return list(pool.map(run, cmds))


def _compile(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cu = [s for s in _sources() if s.suffix == ".cu"]
        objs = [str(Path(tmp) / f"{s.stem}.o") for s in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(s), "-o", o]
                for s, o in zip(cu, objs)]
        results = _run_all(cmds)
        log = "".join(out for _, out in results)
        so = str(Path(tmp) / "lib.so")
        link = [nvcc, *LINK_FLAGS, "-o", so, *objs]
        if not any(rc for rc, _ in results):
            results += _run_all([link])
            log += results[-1][1]
        build_info.update(seconds=time.perf_counter() - t0, built=True,
                          log=log)
        for cmd, (rc, out) in zip(cmds + [link], results):
            if rc:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                                   f"{out}")
        os.replace(so, target)  # atomic: concurrent builders never see a stub


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
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _i32
    lib.stain_error_string.argtypes = [_i32]
    lib.stain_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def error_string(err: int) -> str:
    return load_library().stain_error_string(err).decode()


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` on ``device`` with ``args`` (everything
    between the device and the stream) on the device's current stream;
    raise if the launch is refused. Inside a kernel entry that a recording
    profiler traces (``utils.profiling.kernel_entry``), the call runs in
    the entry's launch span."""
    span = launch_span()
    if span is not None:  # handed out once: the call below runs untraced
        with span:
            return launch(name, device, *args)
    fn = getattr(load_library(), name)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:  # the usual case: no device context to enter
        err = fn(index, *args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(index):
            err = fn(index, *args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} failed: {error_string(err)} ({err})")

"""Builds the CUDA kernels of ``core/csrc/`` into one shared library.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into
``build/ipk_tpu_torch/libipk_kernels.so`` under the repository root, with a
plain C interface that ``core.kernels`` binds through ``ctypes``. The
library is built at first use, only from the sources in the checkout, and
rebuilt when a source is newer than it. A failed build raises with nvcc's
output. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "core", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ipk_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libipk_kernels.so")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v", "-c"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

#: what the last build printed (ptxas registers/spills) and how long it took
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_nvcc = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cuda_nvcc):
        return cuda_nvcc
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: the "
                       "CUDA kernels cannot be built")


def _sources() -> list:
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    return srcs


def _stale(srcs: list) -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in srcs)


def _run(cmds: list) -> str:
    """Run the commands in parallel; raise with the output of the first that
    fails, else return their joined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build_library() -> str:
    """Compile the kernels if the library is missing or older than a source;
    returns the library's path."""
    global build_log, build_seconds
    srcs = _sources()
    if not _stale(srcs):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    # private names, renamed at the end, so a concurrent process never loads
    # a half-written library
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(src) + f".{tag}.o")
            for src in srcs]
    tmp = f"{LIB_PATH}.{tag}"
    t0 = time.monotonic()
    try:
        log = _run([[nvcc, *COMPILE_FLAGS, "-o", obj, src]
                    for src, obj in zip(srcs, objs)])
        log += _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, LIB_PATH)
    finally:
        build_seconds = time.monotonic() - t0
        for path in objs + [tmp]:
            if os.path.exists(path):
                os.remove(path)
    build_log = log
    return LIB_PATH


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_library())
        vp = ctypes.c_void_p
        lib.ipk_combine_max.argtypes = [
            vp, vp, ctypes.c_float, vp, vp, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, vp]
        lib.ipk_combine_max.restype = ctypes.c_int
        lib.ipk_combine_max_uncounted.argtypes = lib.ipk_combine_max.argtypes
        lib.ipk_combine_max_uncounted.restype = ctypes.c_int
        lib.ipk_combine_max_positions.argtypes = [
            vp, vp, ctypes.c_float, vp, vp, vp, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, vp]
        lib.ipk_combine_max_positions.restype = ctypes.c_int
        ll = ctypes.c_longlong
        lib.ipk_staircase_select.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ll, ll, ll, ll,
            ctypes.c_int, ctypes.c_int, vp]
        lib.ipk_staircase_select.restype = ctypes.c_int
        lib.ipk_staircase_select_stages.argtypes = (
            lib.ipk_staircase_select.argtypes + [ctypes.c_int])
        lib.ipk_staircase_select_stages.restype = ctypes.c_int
        lib.ipk_staircase_scratch_bytes.argtypes = [ll, ll, ll, ctypes.c_int]
        lib.ipk_staircase_scratch_bytes.restype = ll
        lib.ipk_extract_columns.argtypes = [
            vp, ll, ll, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, vp, vp, vp, ctypes.c_int, vp]
        lib.ipk_extract_columns.restype = ctypes.c_int
        lib.ipk_extract_emit.argtypes = [
            vp, vp, ll, ll, ctypes.c_int, vp, vp, vp, ctypes.c_int, vp]
        lib.ipk_extract_emit.restype = ctypes.c_int
        lib.ipk_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ipk_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib

"""Build ``csrc/preprocess.cu`` with nvcc and bind it with ctypes.

The shared library has a plain C interface (no PyTorch or Python headers),
so one ``nvcc`` call builds it in seconds. It is built at first use into
``bbocr_tpu_torch/_build/`` and named by a hash of the source and flags, so
an edited source never loads a stale library. The build writes a
process-unique temporary file and renames it into place, so concurrent
first uses cannot load a half-written library. Any failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "preprocess.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output (ptxas register and shared-memory use)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libbbocr_preprocess_{digest}.so")


def build() -> str:
    """Compile the kernels unless a library for this source exists."""
    global build_log
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True, timeout=600,
    )
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The bound library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bbocr_blur3_u8.argtypes = [p, p, i, i, i, p, p]
        lib.bbocr_unsharp_u8.argtypes = [p, p, i, i, i, p, f, f, p]
        lib.bbocr_enhance_u8.argtypes = [p, p, p, i, i, i, f, f, p]
        for fn in (lib.bbocr_blur3_u8, lib.bbocr_unsharp_u8, lib.bbocr_enhance_u8):
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib

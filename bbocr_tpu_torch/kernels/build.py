"""Build ``csrc/preprocess.cu`` and ``csrc/moe_gemm.cu`` with nvcc, each
into its own library, and bind them with ctypes.

Each shared library has a plain C interface (no PyTorch or Python headers),
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
MOE_SOURCE = os.path.join(_PKG, "csrc", "moe_gemm.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs = {}
build_log = ""  # nvcc's output for ``SOURCE`` (ptxas register and shared-memory use)
build_logs = {}  # nvcc's output by source


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(source: str = SOURCE) -> str:
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"libbbocr_{stem}_{digest}.so")


def build(source: str = SOURCE) -> str:
    """Compile ``source`` unless a library for it exists."""
    global build_log
    path = library_path(source)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
        capture_output=True, text=True, timeout=600,
    )
    build_logs[source] = proc.stdout + proc.stderr
    if source == SOURCE:
        build_log = build_logs[source]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_logs[source]}")
    os.replace(tmp, path)
    return path


def build_moe() -> str:
    return build(MOE_SOURCE)


def _bind(source: str, signatures) -> ctypes.CDLL:
    """The library of ``source``, built and bound on first call; each entry
    of ``signatures`` is (name, argtypes), every function returning an int."""
    with _lock:
        if source not in _libs:
            lib = ctypes.CDLL(build(source))
            for name, argtypes in signatures:
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[source] = lib
        return _libs[source]


def load() -> ctypes.CDLL:
    """The preprocessing library, built on first call."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _bind(SOURCE, (
        ("bbocr_blur3_u8", [p, p, i, i, i, p, p]),
        ("bbocr_unsharp_u8", [p, p, i, i, i, p, f, f, p]),
        ("bbocr_enhance_u8", [p, p, p, i, i, i, f, f, p]),
    ))


def load_moe() -> ctypes.CDLL:
    """The routed experts' library, built on first call."""
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _bind(MOE_SOURCE, (
        ("bbocr_moe_block_rows", [i]),
        ("bbocr_moe_gate_up", [i, i, p, p, p, p, p, p, i, q, i, i, i, i, p]),
        ("bbocr_moe_down", [i, i, p, p, p, p, p, i, q, i, i, i, p]),
    ))

"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``dskd_tpu_torch/csrc/<name>.cu`` has a plain C interface and compiles on
its own with ``nvcc`` into ``dskd_tpu_torch/build/<name>-<key>.so``, where the
key hashes the source and the flags, so an edited source is rebuilt. No
PyTorch header is included, so a build takes seconds. The build directory is
listed in ``.gitignore``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library; name -> (build seconds, ptxas report)
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, tuple] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put "
                           "nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed, load it, and declare each entry
    point of ``signatures`` (C function name -> ctypes argument types; every
    entry point returns an ``int`` CUDA error code)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{key}.so"
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = BUILD_DIR / f"{name}-{key}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
        BUILD_LOG[name] = (time.perf_counter() - t0, proc.stderr.strip())
    lib = ctypes.CDLL(str(so))
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")

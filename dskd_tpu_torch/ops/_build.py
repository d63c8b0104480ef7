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


def _so_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(names: Sequence[str]) -> None:
    """Compile every ``csrc/<name>.cu`` of ``names`` that is not built yet,
    one ``nvcc`` process per source, all started together."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = []
    for name in names:
        so = _so_path(name)
        if so.exists():
            continue
        tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, so, tmp, t0, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{out}{err}")
            continue
        os.replace(tmp, so)
        BUILD_LOG[name] = (time.perf_counter() - t0, err.strip())
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed, load it, and declare each entry
    point of ``signatures`` (C function name -> ctypes argument types; every
    entry point returns an ``int`` CUDA error code)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(_so_path(name)))
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

"""Build the port's host C++ sources at first use and bind them with ctypes
(port of dskd_tpu/native/build.py ``load_library``): the COCO matcher
(``native/coco_match.cpp``, ``load_library``) and the exact JV assignment
solver (``native/lap_jv.cpp``, ``load_lap_jv``).

Each source compiles with ``c++ -O3 -shared -fPIC`` into
``dskd_tpu_torch/build/<source>-<key>.so``, where the key hashes the source
and the flags, as ``ops/_build.py`` builds the CUDA sources; the build
directory is listed in ``.gitignore``. A failed build raises: the port has
no silent fallback (the numpy matcher of ``eval/coco_eval.py`` and the
plain ``core/matching.py lap_jv`` are the plain versions the tests hold
the libraries against).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "coco_match.cpp"
LAP_JV_SRC = _HERE / "lap_jv.cpp"
BUILD_DIR = _HERE.parent / "build"
FLAGS = ("-O3", "-shared", "-fPIC")
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# source -> {extern "C" entry point: (argument types, result type)}
SIGNATURES = {
    "coco_match": {"coco_match": ((_P, _I64, _P, _P, _P, _I64, _P, _I64,
                                   _P, _P), None)},
    "lap_jv": {"lap_jv": ((_P, _I64, _I64, _I64, _P), ctypes.c_int)},
}
_lock = threading.Lock()
_lib = None          # coco_match's library
_lap_jv_lib = None


def so_path(src: Path = None) -> Path:
    src = SRC if src is None else src
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{key}.so"


def _compile_and_load(src: Path, signatures) -> ctypes.CDLL:
    """Compile ``src`` unless its library exists (raises RuntimeError if
    ``c++`` fails), load it and declare ``signatures``."""
    so = so_path(src)
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run(["c++", *FLAGS, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
        except OSError as err:
            raise RuntimeError(f"cannot run c++ to build {src.name}: "
                               f"{err}") from err
        if proc.returncode != 0:
            raise RuntimeError(f"c++ failed on {src.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def load_library() -> ctypes.CDLL:
    """The COCO matcher's library with ``coco_match`` declared, compiled on
    first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _compile_and_load(SRC, SIGNATURES["coco_match"])
        return _lib


def load_lap_jv() -> ctypes.CDLL:
    """The JV solver's library with ``lap_jv`` declared, compiled on first
    use."""
    global _lap_jv_lib
    with _lock:
        if _lap_jv_lib is None:
            _lap_jv_lib = _compile_and_load(LAP_JV_SRC, SIGNATURES["lap_jv"])
        return _lap_jv_lib

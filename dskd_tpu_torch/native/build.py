"""Build the COCO matcher (``native/coco_match.cpp``) at first use and bind it
with ctypes (port of dskd_tpu/native/build.py ``load_library``).

The source compiles with ``c++ -O3 -shared -fPIC`` into
``dskd_tpu_torch/build/coco_match-<key>.so``, where the key hashes the
source and the flags, as ``ops/_build.py`` builds the CUDA sources; the
build directory is listed in ``.gitignore``. A failed build raises: the
port has no silent fallback (the numpy matcher of ``eval/coco_eval.py`` is
the plain version the tests hold the library against).
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
BUILD_DIR = _HERE.parent / "build"
FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def so_path() -> Path:
    key = hashlib.sha256(SRC.read_bytes()
                         + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"coco_match-{key}.so"


def load_library() -> ctypes.CDLL:
    """Compile on first use (raises RuntimeError if ``c++`` fails) and
    return the library with ``coco_match`` declared."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = so_path()
        if not so.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.tmp"
            try:
                proc = subprocess.run(
                    ["c++", *FLAGS, "-o", str(tmp), str(SRC)],
                    capture_output=True, text=True)
            except OSError as err:
                raise RuntimeError(f"cannot run c++ to build {SRC.name}: "
                                   f"{err}") from err
            if proc.returncode != 0:
                raise RuntimeError(f"c++ failed on {SRC.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        c = ctypes.c_void_p
        lib.coco_match.argtypes = [c, ctypes.c_int64, c, c, c,
                                   ctypes.c_int64, c, ctypes.c_int64, c, c]
        lib.coco_match.restype = None
        _lib = lib
        return lib

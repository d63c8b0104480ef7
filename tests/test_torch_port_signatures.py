"""The ctypes bindings of the port's CUDA and host C++ sources against their
C entry points.

Each ``dskd_tpu_torch/csrc/<name>.cu`` is built into its own library and
loaded with the ``SIGNATURES`` dict of the module that binds it
(``ops/_build.py load``); each ``dskd_tpu_torch/native/<name>.cpp`` with
``native/build.py SIGNATURES[name]``. ctypes trusts those argument types: a
count or a kind that differs from the C declaration passes a pointer as a
32-bit int or shifts every argument after it, and shows only on the card or
as a wrong answer. Here each ``extern "C"`` declaration is parsed from the
source and held against the declared types, name for name and argument for
argument (and, for the host sources, the result type), on the CPU.
"""
import ctypes
import re
from pathlib import Path

import pytest

from dskd_tpu_torch.native import build as native_build
from dskd_tpu_torch.ops import _build, fused_sample, mxu_gather, pack_kernel, \
    window

# source -> the SIGNATURES its wrappers load it with
_BOUND = {
    "pack_corners": pack_kernel._SIGNATURES,
    "gather_weighted": mxu_gather._SIGNATURES,
    "gather_weighted_bwd": mxu_gather._BWD_SIGNATURES,
    "mxu_gather": mxu_gather.MXU_GATHER_SIGNATURES,
    "fused_sample": fused_sample.SIGNATURES,
    "window_sample": window.SIGNATURES,
}
_C_TYPES = {"void*": ctypes.c_void_p, "int64_t": ctypes.c_int64,
            "int": ctypes.c_int}
_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def _entry_points(source: Path):
    """{name: (ctypes types of its arguments)} of a source's extern "C"
    functions."""
    out = {}
    for name, args in _ENTRY.findall(source.read_text()):
        # "const void* table" -> "void*": the type without const and name
        kinds = ["".join(re.sub(r"\w+$", "", arg.strip())
                         .replace("const", "").split())
                 for arg in args.split(",")]
        assert set(kinds) <= set(_C_TYPES), (name, kinds)
        out[name] = tuple(_C_TYPES[k] for k in kinds)
    return out


def test_every_source_is_bound():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(_BOUND)


@pytest.mark.parametrize("source", sorted(_BOUND))
def test_signatures_match_entry_points(source):
    declared = _entry_points(_build.CSRC / f"{source}.cu")
    assert declared, f"no extern \"C\" entry point in {source}.cu"
    bound = {name: tuple(types) for name, types in _BOUND[source].items()}
    assert sorted(bound) == sorted(declared)
    for name, types in declared.items():
        assert bound[name] == types, name


# a host source's entry points: unindented, non-static definitions inside
# its extern "C" block
_NATIVE_ENTRY = re.compile(r"^(\w+)\s+(\w+)\s*\(([^)]*)\)\s*\{", re.M)
_NATIVE_TYPES = {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
                 "void": None}


def _native_entry_points(source: Path):
    """{name: ((ctypes argument types), result type)} of a host source's
    extern "C" functions; every pointer is a void pointer to ctypes."""
    text = source.read_text()
    block = text[text.index('extern "C" {'):]
    out = {}
    for restype, name, args in _NATIVE_ENTRY.findall(block):
        kinds = ["".join(re.sub(r"\w+$", "", arg.strip())
                         .replace("const", "").split())
                 for arg in args.split(",")]
        types = tuple(ctypes.c_void_p if k.endswith("*")
                      else _NATIVE_TYPES[k] for k in kinds)
        out[name] = (types, _NATIVE_TYPES[restype])
    return out


def _native_sources():
    return sorted(Path(native_build.__file__).parent.glob("*.cpp"))


def test_every_native_source_is_bound():
    assert [p.stem for p in _native_sources()] == \
        sorted(native_build.SIGNATURES) == ["coco_match", "lap_jv"]


@pytest.mark.parametrize("source", sorted(native_build.SIGNATURES))
def test_native_signatures_match_entry_points(source):
    path = Path(native_build.__file__).parent / f"{source}.cpp"
    declared = _native_entry_points(path)
    assert declared, f"no extern \"C\" entry point in {source}.cpp"
    bound = {name: (tuple(args), res) for name, (args, res)
             in native_build.SIGNATURES[source].items()}
    assert bound == declared

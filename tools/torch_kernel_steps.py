#!/usr/bin/env python3
"""Time the design steps of the port's ``gather_weighted`` kernel on one CUDA
card.

    python3 tools/torch_kernel_steps.py

Builds ``tools/gather_weighted_steps.cu`` (the design steps of
``dskd_tpu_torch/csrc/gather_weighted.cu``, one flag each; its header lists
them) with nvcc next to the port's kernels, checks that every step gives the
production kernel's output bit for bit, and times each step, the production
kernel (the weights read in their own type) and ``F.embedding_bag`` on the
same inputs, in device ms (``chip_smoke.device_ms``), over the four levels
of the 640x640 canvas at B=2, f32 and bf16, for three sets of samples: random
locations with Q=8500 (what ``chip_smoke.py`` times), the encoder's raster
queries (Q=8500, each sampling near its own pixel) and random locations
with Q=300 (the decoder's). The steps take f32 weights; in bf16 their time
includes the cast of the weights that the wrapper launched before this
design. Prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dskd_tpu_torch.ops import _build  # noqa: E402

STEPS = {1: "P rows in flight", 2: "+ 16-byte bf16 lanes",
         3: "+ persistent, next sample prefetched", 4: "+ streaming stores",
         5: "+ (b, hd, q) order", 6: "steps 1, 2 and 4"}


def build() -> ctypes.CDLL:
    src = os.path.join(ROOT, "tools", "gather_weighted_steps.cu")
    _build.BUILD_DIR.mkdir(exist_ok=True)
    so = _build.BUILD_DIR / "gather_weighted_steps.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    print("build: " + "; ".join(cs.ptxas(proc.stderr)))
    lib = ctypes.CDLL(str(so))
    lib.gather_weighted_step.argtypes = (
        [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 7
        + [ctypes.c_void_p])
    lib.gather_weighted_step.restype = ctypes.c_int
    return lib


def run_step(lib, k, table, idx, w):
    B, S, H, D4 = table.shape
    Q = idx.shape[1]
    w = w.float()                   # the earlier wrapper's cast
    out = torch.empty((B, Q, H, D4), dtype=table.dtype, device=table.device)
    _build.check(lib.gather_weighted_step(
        k, int(table.dtype == torch.bfloat16), table.data_ptr(),
        idx.data_ptr(), w.data_ptr(), out.data_ptr(), B, Q, H, S,
        table.stride(0), table.stride(1), table.stride(2),
        torch.cuda.current_stream().cuda_stream), f"step {k}")
    return out


def cases(gen, dtype):
    """(name, tables, [(idx, w)] per level) of the three sample sets."""
    from dskd_tpu_torch.ops.msda import corner_index_and_weights
    from dskd_tpu_torch.ops.pack_kernel import pack_corners

    def tables_of(value):
        out, start = [], 0
        for h, w in cs.LEVELS:
            out.append(pack_corners(value[:, start:start + h * w], h, w))
            start += h * w
        return out

    for name, Q in (("random Q=8500", cs.Q_ENC), ("random Q=300", cs.Q_DEC)):
        value, per_level = cs.level_inputs(gen, dtype, Q)
        yield name, tables_of(value), [
            corner_index_and_weights(loc, attn, h, w, dtype)
            for (h, w), (loc, attn) in zip(cs.LEVELS, per_level)]
    value, locs, attn = cs.raster_msda_inputs(gen, cs.LEVELS)
    value, locs, attn = (t.to(cs.DEVICE) for t in (value, locs, attn))
    yield "raster Q=8500", tables_of(value.to(dtype)), [
        corner_index_and_weights(locs[:, :, :, lvl], attn[:, :, :, lvl], h, w,
                                 dtype)
        for lvl, (h, w) in enumerate(cs.LEVELS)]


def main() -> int:
    from dskd_tpu_torch.ops.mxu_gather import gather_weighted

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    print(f"card: {cs.card_line()}")
    lib = build()
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for name, tables, args in cases(gen, dtype):
            want = [gather_weighted(t, f, c) for t, (f, c) in zip(tables,
                                                                  args)]
            for k in STEPS:
                got = [run_step(lib, k, t, f, c)
                       for t, (f, c) in zip(tables, args)]
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"step {k} differs from the "
                                         f"production kernel ({tag} {name})")
            shape = (cs.B, args[0][0].shape[1], cs.HEADS, 4 * cs.D)
            bags = [cs.gather_weighted_bags(t, f, c)
                    for t, (f, c) in zip(tables, args)]
            times = {f"step {k} ({what})": cs.device_ms(
                lambda: [run_step(lib, k, t, f, c)
                         for t, (f, c) in zip(tables, args)])
                for k, what in STEPS.items()}
            times["the kernel (weights in their own type)"] = \
                cs.device_ms(lambda: [gather_weighted(t, f, c)
                                      for t, (f, c) in zip(tables, args)])
            times["F.embedding_bag"] = cs.device_ms(
                lambda: [cs.embedding_bag(bg, shape) for bg in bags])
            print(f"{tag} {name}, four levels, B={cs.B}: " + "; ".join(
                f"{key} {ms:.4f} ms" for key, ms in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

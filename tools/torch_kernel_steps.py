#!/usr/bin/env python3
"""Time the design steps of the port's ``gather_weighted`` kernel and of
``fused_msda_sample``'s forward and backward on one CUDA card.

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
design.

Then builds ``tools/fused_sample_bwd_steps.cu`` (the design steps of the
backward in ``dskd_tpu_torch/csrc/fused_sample.cu``; its header lists them),
holds every step against the production backward (``dtable`` and ``dw``,
with the tolerances of ``chip_smoke.py``: the atomics' order varies), and
times each step and the production backward in device ms over levels 1-3 of
the 640x480 canvas at B=2 (what ``DSKD_FUSED_ROWS=1200`` sends the kernel),
f32 and bf16, for random locations with Q=6380 (what ``chip_smoke.py``
times) and the encoder's raster queries (Q=6380), whole and level by level,
with each timing's f32 adds into ``dtable`` per second.

Then builds ``tools/fused_sample_steps.cu`` (the design steps of the
forward in ``dskd_tpu_torch/csrc/fused_sample.cu``; its header lists them),
holds every step against the production forward with the tolerances of
``chip_smoke.py``, and times each step, the production forward and its
``F.embedding_bag`` yardstick in device ms over levels 1-3, whole and level
by level, f32 and bf16 (steps 0, 5 and 6 sum in the kernel's order and are
held to its output bit for bit): of the 640x480 canvas for random locations
with Q=6380, the encoder's raster queries (Q=6380) and random locations with
Q=300 (the decoder's), and of the 640x640 canvas for random locations with
Q=8500 (what ``DSKD_FUSED_ROWS=1600`` sends it in serving). Prints the
card's name and power limit first.

    python3 tools/torch_kernel_steps.py [fused_sample]

With ``fused_sample`` it runs only the forward's steps.
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
FUSED_STEPS = {0: "the first design, one tap at a time",
               1: "four taps per warp instruction, vector atomics",
               2: "+ four points in flight", 3: "+ float4 weights"}
FWD_STEPS = {0: "the first design", 1: "B4' lanes, 16 rows in flight",
             2: "+ 16-byte bf16 lanes", 3: "+ taps from shared memory",
             4: "+ batched indices and weights",
             5: "lanes over elements, staged",
             6: "lanes over elements, streamed"}


def build(name: str, fn: str, argtypes) -> ctypes.CDLL:
    """Compile ``tools/<name>.cu`` and bind its entry point ``fn``."""
    src = os.path.join(ROOT, "tools", f"{name}.cu")
    _build.BUILD_DIR.mkdir(exist_ok=True)
    so = _build.BUILD_DIR / f"{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    print(f"build {name}: " + "; ".join(cs.ptxas(proc.stderr)))
    lib = ctypes.CDLL(str(so))
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int
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


def gather_weighted_steps(gen) -> None:
    from dskd_tpu_torch.ops.mxu_gather import gather_weighted

    lib = build("gather_weighted_steps", "gather_weighted_step",
                [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 4
                + [ctypes.c_int64] * 7 + [ctypes.c_void_p])
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


def run_fused_step(lib, k, v, c00, wts, g, level_w):
    B, S, H, D = v.shape
    Q = c00.shape[1]
    dtable = torch.zeros((B, S, H, D), dtype=torch.float32, device=v.device)
    dw = torch.empty((B, Q, H, 4, 4), dtype=torch.float32, device=v.device)
    _build.check(lib.fused_sample_bwd_step(
        k, int(v.dtype == torch.bfloat16), v.data_ptr(), c00.data_ptr(),
        wts.data_ptr(), g.data_ptr(), dtable.data_ptr(), dw.data_ptr(), B, Q,
        H, S, level_w, D, v.stride(0), v.stride(1), v.stride(2),
        torch.cuda.current_stream().cuda_stream), f"fused step {k}")
    return dtable, dw


def fused_cases(gen, dtype):
    """(name, [(v, c00, wts, g, level_w, in-range taps)] for levels 1-3 of
    640x480) of the two sample sets."""
    from dskd_tpu_torch.ops.msda import fused_index_and_weights

    levels, Q = cs.TRAIN_LEVELS, cs.Q_TRAIN

    def per_level(value, locs_attn):
        out, start = [], levels[0][0] * levels[0][1]
        for (h, w), (loc, attn) in zip(levels[1:], locs_attn):
            v = value[:, start:start + h * w]
            start += h * w
            c00, wts = fused_index_and_weights(loc, attn, h, w, dtype)
            rows = c00[..., None].long() + torch.tensor(
                [0, 1, w, w + 1], device=c00.device)
            g = torch.randn(cs.B, Q, cs.HEADS, cs.D, generator=gen).to(
                cs.DEVICE, dtype)
            out.append((v, c00, wts, g, w,
                        int(((rows >= 0) & (rows < h * w)).sum())))
        return out

    value, pl = cs.level_inputs(gen, dtype, Q, levels)
    yield f"random Q={Q}", per_level(value, pl[1:])
    value, locs, attn = (t.to(cs.DEVICE)
                         for t in cs.raster_msda_inputs(gen, levels))
    yield f"raster Q={Q}", per_level(value.to(dtype), [
        (locs[:, :, :, lvl], attn[:, :, :, lvl])
        for lvl in range(1, len(levels))])


def fused_sample_bwd_steps(gen) -> None:
    from dskd_tpu_torch.ops.fused_sample import fused_msda_sample_bwd

    lib = build("fused_sample_bwd_steps", "fused_sample_bwd_step",
                [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 6
                + [ctypes.c_int64] * 9 + [ctypes.c_void_p])
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        dtol = cs.DTABLE_TOL if dtype == torch.float32 else cs.DTABLE_BF16_TOL
        for name, lv in fused_cases(gen, dtype):
            for v, c00, wts, g, w, _ in lv:
                want_dt, want_dw = fused_msda_sample_bwd(v, c00, wts, g, w)
                for k in FUSED_STEPS:
                    dt, dw = run_fused_step(lib, k, v, c00, wts, g, w)
                    torch.testing.assert_close(
                        dt.to(dtype).float(), want_dt.float(), **dtol,
                        msg=f"fused step {k} dtable ({tag} {name})")
                    torch.testing.assert_close(
                        dw, want_dw, **cs.F32_TOL,
                        msg=f"fused step {k} dw ({tag} {name})")
            for what, sub in [("levels 1-3", lv)] + [
                    (f"level {i}", [a]) for i, a in enumerate(lv, start=1)]:
                adds = sum(cs.D * taps for *_, taps in sub)
                times = {f"step {k} ({desc})": cs.device_ms(
                    lambda: [run_fused_step(lib, k, v, c, wt, g, w)
                             for v, c, wt, g, w, _ in sub], iters=10)
                    for k, desc in FUSED_STEPS.items()}
                times["the kernel"] = cs.device_ms(
                    lambda: [fused_msda_sample_bwd(v, c, wt, g, w)
                             for v, c, wt, g, w, _ in sub], iters=10)
                print(f"fused_sample_bwd {tag} {name}, {what}, B={cs.B}: "
                      + "; ".join(f"{key} {ms:.4f} ms{cs.adds_rate(adds, ms)}"
                                  for key, ms in times.items()))


def run_fwd_step(lib, k, v, c00, wts, level_w):
    B, S, H, D = v.shape
    out = torch.empty((B, c00.shape[1], H, D), dtype=v.dtype,
                      device=v.device)
    _build.check(lib.fused_sample_step(
        k, int(v.dtype == torch.bfloat16), v.data_ptr(), c00.data_ptr(),
        wts.data_ptr(), out.data_ptr(), B, c00.shape[1], H, S, level_w, D,
        v.stride(0), v.stride(1), v.stride(2),
        torch.cuda.current_stream().cuda_stream), f"forward step {k}")
    return out


def fwd_cases(gen, dtype):
    """(name, [(v, c00, wts, level_w, (h, w), bags)] for levels 1-3) of the
    four sample sets; v is the level's slice of the value, read in place."""
    from dskd_tpu_torch.ops.msda import fused_index_and_weights

    def per_level(levels, value, locs_attn):
        out, start = [], levels[0][0] * levels[0][1]
        for (h, w), (loc, attn) in zip(levels[1:], locs_attn):
            c00, wts = fused_index_and_weights(loc, attn, h, w, dtype)
            out.append((value[:, start:start + h * w], c00, wts, w, (h, w),
                        cs.fused_sample_bags(value, start, (h, w), c00,
                                             wts)))
            start += h * w
        return out

    for levels, Q in ((cs.TRAIN_LEVELS, cs.Q_TRAIN),
                      (cs.TRAIN_LEVELS, cs.Q_DEC), (cs.LEVELS, cs.Q_ENC)):
        value, pl = cs.level_inputs(gen, dtype, Q, levels)
        canvas = "640x480" if levels == cs.TRAIN_LEVELS else "640x640"
        yield f"{canvas} random Q={Q}", per_level(levels, value, pl[1:])
        if Q == cs.Q_TRAIN:
            value, locs, attn = (t.to(cs.DEVICE) for t in
                                 cs.raster_msda_inputs(gen, levels))
            yield f"{canvas} raster Q={Q}", per_level(
                levels, value.to(dtype),
                [(locs[:, :, :, lvl], attn[:, :, :, lvl])
                 for lvl in range(1, len(levels))])


def fused_sample_steps(gen) -> None:
    from dskd_tpu_torch.ops.fused_sample import fused_msda_sample

    lib = build("fused_sample_steps", "fused_sample_step",
                [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 4
                + [ctypes.c_int64] * 9 + [ctypes.c_void_p])
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        tol = cs.F32_TOL if dtype == torch.float32 else cs.BF16_TOL
        for name, lv in fwd_cases(gen, dtype):
            for v, c00, wts, w, _, _ in lv:
                want = fused_msda_sample(v, c00, wts, w)
                for k in FWD_STEPS:
                    got = run_fwd_step(lib, k, v, c00, wts, w)
                    torch.testing.assert_close(
                        got.float(), want.float(), **tol,
                        msg=f"forward step {k} ({tag} {name})")
                    # the first design's order: bit for bit the kernel's
                    if k in (0, 5, 6) and not torch.equal(got, want):
                        raise AssertionError(f"forward step {k} is not the "
                                             f"kernel's bit for bit ({tag} "
                                             f"{name})")
            for what, sub in [("levels 1-3", lv)] + [
                    (f"level {i} ({hw[0]}x{hw[1]})", [a])
                    for i, a in enumerate(lv, start=1) for hw in [a[4]]]:
                times = {f"step {k} ({desc})": cs.device_ms(
                    lambda: [run_fwd_step(lib, k, v, c, wt, w)
                             for v, c, wt, w, _, _ in sub])
                    for k, desc in FWD_STEPS.items()}
                times["the kernel"] = cs.device_ms(
                    lambda: [fused_msda_sample(v, c, wt, w)
                             for v, c, wt, w, _, _ in sub])
                times["F.embedding_bag"] = cs.device_ms(
                    lambda: [cs.embedding_bag(bg, c.shape[:3] + (cs.D,))
                             for _, c, _, _, _, bg in sub])
                print(f"fused_sample {tag} {name}, {what}, B={cs.B}: "
                      + "; ".join(f"{key} {ms:.4f} ms"
                                  for key, ms in times.items()))


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    print(f"card: {cs.card_line()}")
    gen = torch.Generator().manual_seed(0)
    if argv[1:] != ["fused_sample"]:
        gather_weighted_steps(gen)
        fused_sample_bwd_steps(gen)
    fused_sample_steps(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

Run from the repository root, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases; the first failure raises and the script exits non-zero:
  1. device: requires torch.cuda, prints the card's name and power limit,
     turns TF32 off for matmuls and convolutions (every comparison and time
     below is full f32 unless it says bf16);
  2. build: compiles the six CUDA sources from dskd_tpu_torch/csrc (eleven
     kernels; gather_weighted.cu carries fused_window, gather_weighted_bwd.cu
     the windowed weighted backward), one nvcc per source, all started
     together, and prints the registers and spills of each instantiation;
  3. kernels: each kernel against its plain PyTorch twin on the card at the
     flagship's shapes (B=2, H=8, D=32, P=4; the levels of the 640x640
     serving canvas with Q=8500 encoder and Q=300 decoder queries, and of
     the 640x480 training canvas with Q=6380), f32 and bf16, indices and
     taps outside [0, S) included; the windowed kernels at level 0's windows
     on the main paths (640x640: window_gather at 1024 rows, fused_window
     at 1232-3200; 640x480: fused_window and the windowed backward at 992
     and 1376), once with every sample in its window (escape counts 0) and
     once with some sent far away (counts > 0, the same results;
     fused_window also bit for bit gather_weighted's); and the
     gradients of ms_deform_attn_core in value, locations and attention on
     the card against the plain twins, on the default branch and under each
     sampling switch (the windowed ones for the encoder's raster queries of
     the 512x512 canvas);
  4. serve: the flagship config with seeded weights through init_detector
     and inference_detector on three synthetic images; every kernel must be
     launched the number of times the design implies, outputs must be finite
     and the head outputs must match the same weights run on the CPU;
  5. train: the flagship incremental step (frozen teacher + student, merged
     GT auction matching, detection and corr + decode_v1 distill losses,
     clip 0.1, AdamW) at full width, B=2, on the 640x480 canvas with GT
     padded to 32: a few f32 steps with dropout 0.1 and checked launch
     counts, one step at 2+2 layers held against the CPU (every loss key and
     the gradients of named parameters), and a few bf16 steps;
  6. switches: the MSDA sampling variants of the JAX package's environment
     switches, DSKD_WGATHER=0 (levels 1-3 through mxu_gather),
     DSKD_FUSED_ROWS (levels 1-3 through fused_msda_sample) and the
     windowed ones on the encoder's level 0, DSKD_WINBWD=1 and DSKD_FWIN=1
     (segments through the windowed backward, or fused_window and it) and
     DSKD_WINDOW_ROWS=1024 (window_gather; on a 640x640 batch in training):
     one serving call each (the first two, DSKD_WINDOW_ROWS and DSKD_FWIN)
     with checked launches and its head outputs held against the default
     path on the card; a few f32 and bf16 training steps with checked
     launches; and one full-width f32 step whose losses and named gradients
     are held against the default path on the card (same weights, batch,
     dropout generator, teacher and assignment);
  7. times: kernels against twins (and against one PyTorch library call
     where one computes the same function: index_select, index_add, or
     F.embedding_bag for gather_weighted, fused_sample and fused_window) in
     device ms (device_ms: the calls queued behind a spin kernel, so that no
     host time enters), gather_weighted and pack_corners also level by
     level, fused_sample by level of 640x480, fused_window beside
     gather_weighted on its segments, beside the least time the card could
     take (bytes over 3.35 TB/s
     or f32 operations over 67 TFLOP/s) and, for the backwards, their rate
     of f32 adds into dtable (G adds/s); the serving slice in ms/image (host
     clock and CUDA events), the train step in ms/step and img/s under each
     switch, and profiler tables of one serving forward and one bf16 train
     step.
The last three lines are the card, the kernel report as JSON and the result
as JSON.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "gfl_deformable_detr_40_40_il.py")
LEVELS = ((80, 80), (40, 40), (20, 20), (10, 10))   # 640x640, strides 8-64
TRAIN_HW = (640, 480)                               # the 4:3 bucket canvas
TRAIN_LEVELS = ((80, 60), (40, 30), (20, 15), (10, 8))
B, HEADS, D, P = 2, 8, 32, 4
Q_ENC, Q_DEC = sum(h * w for h, w in LEVELS), 300
Q_TRAIN = sum(h * w for h, w in TRAIN_LEVELS)       # 6380 encoder queries
MAX_GT = 32
DEVICE = "cuda"
F32_TOL = dict(rtol=1e-5, atol=1e-5)     # summation order only
BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)  # one bf16 rounding of the f32 sum
# dtable: f32 atomics add up to ~250 terms per element in run-to-run order
# (max abs err measured at these shapes on an H100: 5.7e-6)
DTABLE_TOL = dict(rtol=1e-5, atol=5e-5)
DTABLE_BF16_TOL = dict(rtol=2 ** -7, atol=5e-5)
HEAD_TOL = dict(rtol=1e-3, atol=1e-3)    # whole model, f32, TF32 off
# a windowed switch against the default path on the card: DSKD_WINBWD's and
# DSKD_FWIN's forwards sum each row in the default kernel's order, and
# DSKD_WINDOW_ROWS's copies rows and weights them in another order (f32);
# the earlier switches are held to HEAD_TOL, LOSS_TOL and GRAD_REL_TOL
WINDOW_HEAD_TOL = dict(rtol=1e-5, atol=1e-5)
WINDOW_LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
WINDOW_GRAD_REL_TOL = 1e-4
MSDA_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-3, atol=1e-4)    # one f32 step, card vs CPU
# gradients, card vs CPU: ||g_card - g_cpu|| / ||g_cpu||
GRAD_REL_TOL = 1e-3
MSDA_WEIGHT_STD = 0.02
# the sampling switches of ms_deform_attn_core (DSKD_FUSED_ROWS sends the
# levels of 1200 and fewer pixels: levels 1-3 of the 640x480 canvas, and
# with 1600 those of the 640x640 canvas; the windowed switches act on the
# encoder's level 0, DSKD_WINDOW_ROWS only where its pixels fill whole
# 128-query tiles: 6400 of the 640x640 canvas, not 4800 of the 640x480)
SWITCH_VARS = ("DSKD_WGATHER", "DSKD_FUSED_ROWS", "DSKD_MXU_GATHER_ROWS",
               "DSKD_WINDOW_ROWS", "DSKD_FWIN", "DSKD_FWIN_MARGIN",
               "DSKD_WINBWD")
TRAIN_SWITCHES = {"wgather0": {"DSKD_WGATHER": "0"},
                  "fused": {"DSKD_FUSED_ROWS": "1200"},
                  "winbwd": {"DSKD_WINBWD": "1"},
                  "fwin": {"DSKD_FWIN": "1"},
                  "window_rows": {"DSKD_WINDOW_ROWS": "1024"}}
TRAIN_CANVAS = {"window_rows": (640, 640)}      # the others: TRAIN_HW
SERVE_SWITCHES = {"wgather0": {"DSKD_WGATHER": "0"},
                  "fused": {"DSKD_FUSED_ROWS": "1600"},
                  "window_rows": {"DSKD_WINDOW_ROWS": "1024"},
                  "fwin640": {"DSKD_FWIN": "1"}}
# launches of each kernel in one MSDA call (four levels), forward and in
# the backward of a differentiated call, by switch; a windowed switch
# changes the encoder's calls only (the decoder's queries are not the
# raster tokens), so CALL gives the decoder's under it
CALL = {
    "default": ({"pack_corners": 4, "gather_weighted": 4},
                {"gather_weighted_bwd": 4}),
    "wgather0": ({"pack_corners": 4, "gather_weighted": 1, "mxu_gather": 3},
                 {"gather_weighted_bwd": 1, "mxu_gather_bwd": 3}),
    "fused": ({"pack_corners": 1, "gather_weighted": 1, "fused_sample": 3},
              {"gather_weighted_bwd": 1, "fused_sample_bwd": 3})}
ENCODER_CALL = {
    # 640x480 (and 512x512): level 0 in segments of source levels 0-3; the
    # windows of 0 and 1 fit (992 and 1376 rows of 640x480's 5084, of 5456
    # for JAX's table), those of 2 (2976) and 3 (80 queries) do not
    "winbwd": ({"pack_corners": 4, "gather_weighted": 7},
               {"window_weighted_bwd": 2, "gather_weighted_bwd": 5}),
    "fwin": ({"pack_corners": 4, "gather_weighted": 5, "fused_window": 2},
             {"window_weighted_bwd": 2, "gather_weighted_bwd": 5}),
    # 640x640: the windows of source levels 0-2 fit (1232, 1648 and 3200
    # rows of 6724); level 3 has 100 queries
    "fwin640": ({"pack_corners": 4, "gather_weighted": 4,
                 "fused_window": 3},
                {"window_weighted_bwd": 3, "gather_weighted_bwd": 4}),
    # 640x640 (and 512x512): level 0's raster queries through
    # window_gather, the other queries and levels 1-3 gather_weighted
    "window_rows": ({"pack_corners": 4, "gather_weighted": 4,
                     "window_gather": 1},
                    {"window_gather_bwd": 1, "gather_weighted_bwd": 4})}
# device_ms's spin: at most ~2 GHz, 10**8 cycles hold the stream for 50 ms
# or more, longer than the host takes to enqueue the calls it times
SPIN_CYCLES = 10 ** 8
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes/s and f32 FLOP/s outside the tensor cores, where these kernels'
# arithmetic runs whatever the table's type
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
GRAD_PARAMS = (
    "bbox_head.transformer.encoder.layers.0.attentions.0."
    "sampling_offsets.weight",
    "bbox_head.transformer.decoder.layers.1.attentions.1.value_proj.weight",
    "bbox_head.cls_branches.0.weight",
    "backbone.layer4.0.conv2.weight")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3) -> float:
    """Device time of one call of ``fn`` in ms, with no host time in it: a
    spin kernel holds the stream while the host enqueues ``iters`` calls,
    and the card then runs them back to back between two CUDA events.
    (Events around a few short launches from Python, as in ``cuda_ms``,
    time the host whenever it launches slower than the card runs.) A call
    that waits for the card, as the host-to-device copies of some plain
    twins do, ends the spin early; such a function is timed by
    ``cuda_ms``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    held = not start.query()        # still spinning after the last call
    torch.cuda.synchronize()
    if held:
        return start.elapsed_time(end) / iters
    return cuda_ms(fn, iters, warmup=0)


def device_events(prof):
    """The kernels and copies of a profile, by name."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def gather_weighted_bags(table, idx, w):
    """gather_weighted(table, idx, w) as one ``F.embedding_bag`` call (the
    library yardstick; the port never calls it): the contiguous
    (B, S, H, 4D) table read as (B*S*H*4, D) rows, one bag per
    (b, q, hd, corner) holding its P points, row ((b*S + idx)*H + hd)*4 + c
    weighted by w[..., p, c]; an index outside [0, S) takes a row in range
    with weight 0. Returns (input, weight, per_sample_weights); the output
    (B*Q*H*4, D) is gather_weighted's (B, Q, H, 4D)."""
    B, S, H, D4 = table.shape
    P = idx.shape[3]
    dev = idx.device
    valid = (idx >= 0) & (idx < S)
    bi = torch.arange(B, device=dev)[:, None, None, None]
    hi = torch.arange(H, device=dev)[None, None, :, None]
    rows = ((bi * S + idx.clamp(0, S - 1).long()) * H + hi) * 4
    bags = rows[..., None, :] + torch.arange(4, device=dev)[:, None]
    psw = (w * valid[..., None]).transpose(-1, -2)     # (B, Q, H, 4, P)
    return (bags.reshape(-1, P), table.reshape(-1, D4 // 4),
            psw.reshape(-1, P).to(table.dtype))


def fused_sample_bags(value, start, hw, c00, wts):
    """fused_msda_sample(value[:, start:start + h*w], c00, wts, w) as one
    ``F.embedding_bag`` call on the contiguous (B, S, H, D) value tensor read
    as (B*S*H, D) rows: one bag per (b, q, hd) of its P points' four taps
    c00 + (0, 1, w, w+1), a tap outside the level's [0, h*w) taking a row in
    range with weight 0. Returns (input, weight, per_sample_weights); the
    output (B*Q*H, D) is the sample's (B, Q, H, D)."""
    B, S, H, D = value.shape
    h, w = hw
    dev = c00.device
    taps = c00.long()[..., None] + torch.tensor([0, 1, w, w + 1], device=dev)
    valid = (taps >= 0) & (taps < h * w)
    bi = torch.arange(B, device=dev)[:, None, None, None, None]
    hi = torch.arange(H, device=dev)[None, None, :, None, None]
    rows = (bi * S + start + taps.clamp(0, h * w - 1)) * H + hi
    n = c00.shape[3] * 4
    return (rows.reshape(-1, n), value.reshape(-1, D),
            (wts.float() * valid).reshape(-1, n).to(value.dtype))


def embedding_bag(bags, shape):
    """The one library call of a ``*_bags`` mapping, shaped as the kernel's
    output."""
    import torch.nn.functional as F

    inp, weight, psw = bags
    return F.embedding_bag(inp, weight, per_sample_weights=psw,
                           mode="sum").view(shape)


def counters():
    from dskd_tpu_torch.ops.fused_sample import fused_msda_sample, \
        fused_msda_sample_bwd
    from dskd_tpu_torch.ops.fused_window import fused_window_sample, \
        windowed_weighted_bwd
    from dskd_tpu_torch.ops.mxu_gather import gather_weighted, \
        gather_weighted_bwd, mxu_gather, mxu_gather_bwd
    from dskd_tpu_torch.ops.pack_kernel import pack_corners
    from dskd_tpu_torch.ops.window_gather import window_gather, \
        window_gather_bwd
    return {"pack_corners": pack_corners, "gather_weighted": gather_weighted,
            "gather_weighted_bwd": gather_weighted_bwd,
            "mxu_gather": mxu_gather, "mxu_gather_bwd": mxu_gather_bwd,
            "fused_sample": fused_msda_sample,
            "fused_sample_bwd": fused_msda_sample_bwd,
            "window_gather": window_gather,
            "window_gather_bwd": window_gather_bwd,
            "fused_window": fused_window_sample,
            "window_weighted_bwd": windowed_weighted_bwd}


WINDOW_KERNELS = ("window_gather", "window_gather_bwd", "fused_window",
                  "window_weighted_bwd")


def expected_launches(switch, enc, dec, enc_bwd=0, dec_bwd=0):
    """Launches of every kernel under ``switch`` for ``enc`` encoder and
    ``dec`` decoder MSDA calls, of which ``enc_bwd`` and ``dec_bwd`` are
    differentiated."""
    want = dict.fromkeys(counters(), 0)
    enc_call = ENCODER_CALL.get(switch) or CALL[switch]
    dec_call = CALL.get(switch, CALL["default"])
    for n, calls in ((enc, enc_call[0]), (dec, dec_call[0]),
                     (enc_bwd, enc_call[1]), (dec_bwd, dec_call[1])):
        for name, k in calls.items():
            want[name] += k * n
    return want


def model_launches(switch, cfg, forwards, backwards=0):
    """Launches of every kernel in ``forwards`` forwards of the model, of
    which ``backwards`` are differentiated, under ``switch``."""
    n_enc = cfg.model.num_encoder_layers
    n_dec = cfg.model.num_decoder_layers
    return expected_launches(switch, forwards * n_enc, forwards * n_dec,
                             backwards * n_enc, backwards * n_dec)


@contextlib.contextmanager
def switched(env):
    """Set the environment of a sampling switch; restore it on exit."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bound(n_bytes, flops):
    """The least time in ms the card could take for the work: the larger of
    the bytes over its memory rate and the f32 operations over its peak."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def adds_rate(n_adds, ms) -> str:
    """A backward's f32 adds into dtable per second, for a timing line."""
    return "" if n_adds is None else f" ({n_adds / ms / 1e6:.1f} G adds/s)"


def reset_counts() -> None:
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    for name in WINDOW_KERNELS:
        counters()[name].escapes = None


def read_escapes() -> dict:
    """The escape count of each windowed kernel since the last reset."""
    torch.cuda.synchronize()
    return {name: 0 if counters()[name].escapes is None
            else int(counters()[name].escapes) for name in WINDOW_KERNELS}


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counters().items()}


def level_inputs(gen, dtype, Q, levels=LEVELS):
    """value (B, S, H, D) and per level (locations, attention) with
    locations spilling past the map so the zero-corner gates fire."""
    dev = torch.device(DEVICE)
    S = sum(h * w for h, w in levels)
    value = torch.randn(B, S, HEADS, D, generator=gen).to(dev, dtype)
    per_level = [((torch.rand(B, Q, HEADS, P, 2, generator=gen) * 1.3
                   - 0.15).to(dev),
                  torch.rand(B, Q, HEADS, P, generator=gen).to(dev))
                 for _ in levels]
    return value, per_level


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_kernels(gen):
    from dskd_tpu_torch.ops.msda import corner_index_and_weights
    from dskd_tpu_torch.ops.mxu_gather import gather_weighted, \
        gather_weighted_bwd, gather_weighted_bwd_plain, gather_weighted_plain
    from dskd_tpu_torch.ops.pack_kernel import pack_corners, \
        pack_corners_plain

    err = {k: 0.0 for k in ("pack_corners", "gather_weighted",
                            "gather_weighted_bf16", "dtable", "dw",
                            "dtable_bf16", "dw_bf16")}
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "" if dtype == torch.float32 else "_bf16"
        for levels, Q in ((LEVELS, Q_ENC), (LEVELS, Q_DEC),
                          (TRAIN_LEVELS, Q_TRAIN)):
            value, per_level = level_inputs(gen, dtype, Q, levels)
            start = 0
            for (h, w), (loc, attn) in zip(levels, per_level):
                v = value[:, start:start + h * w]
                start += h * w
                table = pack_corners(v, h, w)
                if not torch.equal(table, pack_corners_plain(v, h, w)):
                    raise AssertionError(f"pack_corners differs at {h}x{w} "
                                         f"{dtype}")
                flat, cw = corner_index_and_weights(loc, attn, h, w, dtype)
                got = gather_weighted(table, flat, cw)
                want = gather_weighted_plain(table.float(), flat, cw.float()
                                             ).to(dtype)
                dout = torch.randn(got.shape, generator=gen).to(got.device,
                                                                dtype)
                dt, dw = gather_weighted_bwd(table, flat, cw, dout)
                want_dt, want_dw = gather_weighted_bwd_plain(
                    table.float(), flat, cw.float(), dout.float())
                torch.cuda.synchronize()
                tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                torch.testing.assert_close(got.float(), want.float(), **tol)
                torch.testing.assert_close(
                    dt.float(), want_dt, **(DTABLE_TOL if not sfx
                                            else DTABLE_BF16_TOL))
                torch.testing.assert_close(dw.float(), want_dw.to(
                    dw.dtype).float(), **tol)
                for key, a, b in (("gather_weighted", got, want),
                                  ("dtable", dt, want_dt),
                                  ("dw", dw, want_dw.to(dw.dtype))):
                    err[key + sfx] = max(err[key + sfx], _max_err(a, b))
    # the bounds check: rows outside [0, S) contribute zero, unread, and
    # get dw = 0 with no dtable contribution
    value, per_level = level_inputs(gen, torch.float32, Q_DEC)
    loc, attn = per_level[0]
    h, w = LEVELS[0]
    table = pack_corners(value[:, :h * w], h, w)
    flat, cw = corner_index_and_weights(loc, attn, h, w, torch.float32)
    S = table.shape[1]
    flat = wild_indices(gen, flat, S)
    got = gather_weighted(table, flat, cw)
    want = gather_weighted_plain(table, flat, cw)
    dout = torch.randn(got.shape, generator=gen).to(got.device)
    dt, dw = gather_weighted_bwd(table, flat, cw, dout)
    want_dt, want_dw = gather_weighted_bwd_plain(table, flat, cw, dout)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **F32_TOL)
    torch.testing.assert_close(dt, want_dt, **DTABLE_TOL)
    torch.testing.assert_close(dw, want_dw, **F32_TOL)
    if not (dw[(flat < 0) | (flat >= S)] == 0).all():
        raise AssertionError("dw of an out-of-range index is not 0")
    return err


def wild_indices(gen, idx, S, share=4):
    """``idx`` with about 1/``share`` of it each moved far below 0 and past
    the table: those must read nothing, add nothing and get dw = 0."""
    wild = torch.randint(0, share, idx.shape, generator=gen).to(idx.device)
    return torch.where(wild == 0, idx - 10 ** 6,
                       torch.where(wild == 1, idx + S + 10, idx)
                       ).to(torch.int32)


def check_sampling_kernels(gen):
    """mxu_gather and fused_msda_sample, forward and backward, against their
    plain twins at the levels the switches send them (1-3 of each canvas),
    f32 and bf16, indices and taps outside [0, S) included."""
    from dskd_tpu_torch.ops.fused_sample import fused_msda_sample, \
        fused_msda_sample_bwd, fused_msda_sample_bwd_plain, \
        fused_msda_sample_plain
    from dskd_tpu_torch.ops.msda import corner_index_and_weights, \
        fused_index_and_weights
    from dskd_tpu_torch.ops.mxu_gather import mxu_gather, mxu_gather_bwd, \
        mxu_gather_bwd_plain, mxu_gather_plain
    from dskd_tpu_torch.ops.pack_kernel import pack_corners

    err = {}

    def note(key, got, want):
        err[key] = max(err.get(key, 0.0), _max_err(got, want))

    n_wrapped = 0
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "" if dtype == torch.float32 else "_bf16"
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        dtol = DTABLE_TOL if dtype == torch.float32 else DTABLE_BF16_TOL
        for levels, Q in ((LEVELS, Q_ENC), (LEVELS, Q_DEC),
                          (TRAIN_LEVELS, Q_TRAIN)):
            value, per_level = level_inputs(gen, dtype, Q, levels)
            start = levels[0][0] * levels[0][1]
            for (h, w), (loc, attn) in zip(levels[1:], per_level[1:]):
                v = value[:, start:start + h * w]
                start += h * w
                # B3: mxu_gather on the packed table, read in place
                table = pack_corners(v, h, w)
                S = table.shape[1]
                flat, _ = corner_index_and_weights(loc, attn, h, w, dtype)
                idx = wild_indices(gen, flat, S, share=8)
                got = mxu_gather(table, idx)
                want = mxu_gather_plain(table, idx)
                g = torch.randn(got.shape, generator=gen).to(got.device,
                                                              dtype)
                dt = mxu_gather_bwd(idx, g, S)
                want_dt = mxu_gather_bwd_plain(idx, g.float(), S)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"mxu_gather differs at {h}x{w} "
                                         f"{dtype}")
                bad = (idx < 0) | (idx >= S)
                if got[bad].any():
                    raise AssertionError("mxu_gather: an index outside "
                                         "[0, S) gave a nonzero row")
                torch.testing.assert_close(dt.float(), want_dt, **dtol)
                note("mxu_gather" + sfx, got, want)
                note("mxu_gather_bwd" + sfx, dt, want_dt)
                # B4: fused_msda_sample on the raw level slice, in place
                c00, wts = fused_index_and_weights(loc, attn, h, w, dtype)
                c00 = wild_indices(gen, c00, h * w, share=16)
                got = fused_msda_sample(v, c00, wts, w)
                want = fused_msda_sample_plain(v.float(), c00, wts, w)
                g = torch.randn(got.shape, generator=gen).to(got.device,
                                                              dtype)
                dt, dw = fused_msda_sample_bwd(v, c00, wts, g, w)
                want_dt, want_dw = fused_msda_sample_bwd_plain(
                    v.float(), c00, wts, g.float(), w)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want, **tol)
                torch.testing.assert_close(dt.float(), want_dt, **dtol)
                torch.testing.assert_close(dw, want_dw, **F32_TOL)
                rows = c00[..., None].long() + torch.tensor(
                    [0, 1, w, w + 1], device=c00.device)
                inside = (rows >= 0) & (rows < h * w)
                if dw[~inside].any():
                    raise AssertionError("fused_sample_bwd: a tap outside "
                                         "[0, S) got dw != 0")
                # a tap in range with weight 0 (a wrapped or gated corner)
                # still gets its dot, as the Pallas backward gives it
                n_wrapped += int((inside & (wts == 0) & (dw != 0)).sum())
                note("fused_sample" + sfx, got, want)
                note("fused_sample_bwd" + sfx, dt, want_dt)
                note("fused_sample_dw" + sfx, dw, want_dw)
    if not n_wrapped:
        raise AssertionError("no zero-weight tap in range got its dw")
    return err


def check_msda_grads(gen):
    """R1: autograd reaches value, locations and attention through the
    kernels on the card, on the default branch and under each sampling
    switch; the gradients match the plain twins (CPU)."""
    from dskd_tpu_torch.ops.msda import ms_deform_attn_core

    value, per_level = level_inputs(gen, torch.float32, Q_DEC)
    locs = torch.stack([l for l, _ in per_level], 3)      # (B,Q,H,L,P,2)
    attn = torch.stack([a for _, a in per_level], 3)
    cot = torch.randn(B, Q_DEC, HEADS * D, generator=gen)
    host = [value.cpu(), locs.cpu(), attn.cpu()]

    def grads(dev):
        args = [t.to(dev).requires_grad_(True) for t in host]
        out = ms_deform_attn_core(args[0], LEVELS, args[1], args[2])
        return [g.cpu() for g in torch.autograd.grad(out, args, cot.to(dev))]

    errs = {}
    for switch in CALL:                    # the decoder's queries
        with switched(SERVE_SWITCHES.get(switch, {})):
            reset_counts()
            card = grads(DEVICE)
            launches = read_counts()
            want = expected_launches(switch, 0, 1, 0, 1)
            if launches != want:
                raise AssertionError(f"msda grads {switch}: launches "
                                     f"{launches}, expected {want}")
            for name, got, ref in zip(("value", "locations", "attention"),
                                      card, grads("cpu")):
                if not got.abs().max() > 0:
                    raise AssertionError(f"no gradient reaches {name} on "
                                         f"the card ({switch})")
                torch.testing.assert_close(got, ref, **MSDA_GRAD_TOL,
                                           msg=f"{name} ({switch})")
                errs[f"{name} {switch}"] = _max_err(got, ref)
    return errs


# --- the windowed sampling family --------------------------------------------

WIN_TILE_Q, WIN_ROWS = 128, 1024   # the JAX defaults; DSKD_WINDOW_ROWS=1024
# the 512x512 canvas's levels: level 0 (64x64, 4356 packed rows) takes every
# windowed branch, as on the 640x480 (DSKD_WINBWD, DSKD_FWIN) and 640x640
# (DSKD_WINDOW_ROWS) canvases, at a size the plain twins run on the CPU
GRAD_LEVELS = ((64, 64), (32, 32), (16, 16), (8, 8))
# card vs CPU, f32 summation order relative to each gradient's scale: the
# location gradients of 64-pixel maps reach ~2e3 (the default branch's
# differ by 3.7e-4 there)
WINDOW_GRAD_TOL = 2e-6


def pixel_centres(hw):
    """(h*w, 2) normalized (x, y) centres of an (h, w) level's pixels, in
    raster order: where its encoder tokens sit."""
    h, w = hw
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    return torch.stack([(xs.reshape(-1) + 0.5) / w,
                        (ys.reshape(-1) + 0.5) / h], -1)


def raster_locations(gen, src_hw, hw, noise_px=0.5):
    """(B, n, H, P, 2) normalized locations at which the n raster tokens of
    a source level of size ``src_hw`` sample a level of size ``hw``: each
    at its own pixel's centre plus normal noise of ``noise_px`` pixels of
    the sampled level, as an encoder's queries sample near themselves."""
    own = pixel_centres(src_hw)
    noise = torch.randn(B, own.shape[0], HEADS, P, 2, generator=gen) * (
        noise_px / torch.tensor([float(hw[1]), float(hw[0])]))
    return (own[None, :, None, None] + noise).to(DEVICE)


def window_cases(gen, dtype):
    """The windowed kernels' calls on the main paths at the flagship's
    shapes: (tag, kind, table, flat, cw, starts, window) for level 0 of
    640x640 through window_gather (K=1024), and for each segment of level 0
    whose window fits: fused_window at 640x640 (K 1232, 1648, 3200) and
    640x480 (992, 1376), and windowed_bwd_sample at 640x480 (992, 1376, in
    JAX's 5456-row table). Each sample is clamped into its tile's window:
    the last window, clipped to end before the table does and aligned
    down, leaves the map's last few corner rows outside it."""
    from dskd_tpu_torch.ops.msda import corner_index_and_weights, \
        segment_windows
    from dskd_tpu_torch.ops.pack_kernel import pack_corners
    from dskd_tpu_torch.ops.window import pallas_pack_rows, \
        tile_window_starts

    def inside(flat, starts, window):
        lo = torch.tensor(starts, dtype=torch.int32, device=flat.device)[
            torch.arange(flat.shape[1], device=flat.device) // WIN_TILE_Q]
        lo = lo[None, :, None, None]
        return torch.minimum(torch.maximum(flat, lo), lo + window - 1)

    cases = []
    for levels, canvas in ((LEVELS, "640x640"), (TRAIN_LEVELS, "640x480")):
        h, w = levels[0]
        v = torch.randn(B, h * w, HEADS, D, generator=gen).to(DEVICE, dtype)
        table = pack_corners(v, h, w)
        sp = table.shape[1]

        def sampled(src):
            loc = raster_locations(gen, levels[src], (h, w))
            attn = torch.rand(B, loc.shape[1], HEADS, P, generator=gen)
            return corner_index_and_weights(loc, attn.to(DEVICE), h, w,
                                            dtype)

        if canvas == "640x640":
            flat, cw = sampled(0)
            starts = tile_window_starts(h * w, WIN_TILE_Q, w, w + 2, sp,
                                        WIN_ROWS)
            cases.append((f"{canvas} level 0 K={WIN_ROWS}", "gather", table,
                          inside(flat, starts, WIN_ROWS), cw, starts,
                          WIN_ROWS))
        kinds = (("fwin", sp), ("winbwd", pallas_pack_rows(h, w)))
        for kind, s_pad in kinds[:1] if canvas == "640x640" else kinds:
            for src, (_, _, window, starts) in enumerate(segment_windows(
                    levels, (h, w), WIN_TILE_Q, 6, s_pad)):
                if window is not None:
                    flat, cw = sampled(src)
                    cases.append((f"{canvas} source level {src} K={window}",
                                  kind, table, inside(flat, starts, window),
                                  cw, starts, window))
    return cases


def far_indices(gen, idx, S, share=16):
    """``idx`` with about 1/``share`` of it moved half the table away."""
    far = torch.randint(0, share, idx.shape, generator=gen).to(idx.device)
    return torch.where(far == 0, (idx + S // 2) % S, idx).to(torch.int32)


def check_window_kernels(gen):
    """window_gather, fused_window and the windowed weighted backward
    against their plain twins at the main paths' shapes, f32 and bf16, with
    every sample in its window (escape counts 0) and with some sent far
    away (counts > 0, results still the twins')."""
    from dskd_tpu_torch.ops.fused_window import fused_window_sample, \
        fused_window_sample_plain, windowed_weighted_bwd, \
        windowed_weighted_bwd_plain
    from dskd_tpu_torch.ops.mxu_gather import gather_weighted
    from dskd_tpu_torch.ops.window import window_escapes
    from dskd_tpu_torch.ops.window_gather import window_gather, \
        window_gather_bwd, window_gather_bwd_plain, window_gather_plain

    err, escaped = {}, {}

    def note(key, got, want):
        err[key] = max(err.get(key, 0.0), _max_err(got, want))

    for dtype in (torch.float32, torch.bfloat16):
        sfx = "" if dtype == torch.float32 else "_bf16"
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        dtol = DTABLE_TOL if dtype == torch.float32 else DTABLE_BF16_TOL
        for tag, kind, table, flat, cw, starts, K in window_cases(gen, dtype):
            S, tq = table.shape[1], WIN_TILE_Q
            for escape in (False, True):
                idx = far_indices(gen, flat, S) if escape else flat
                want_esc = int(window_escapes(idx, starts, tq, K))
                if (want_esc > 0) != escape:
                    raise AssertionError(f"{tag}: {want_esc} escapes")
                reset_counts()
                if kind == "gather":
                    got = window_gather(table, idx, starts, tq * P, K)
                    g = torch.randn(got.shape, generator=gen).to(DEVICE,
                                                                  dtype)
                    dt = window_gather_bwd(idx, g, starts, tq, K, S)
                    counted = ("window_gather", "window_gather_bwd")
                    esc = read_escapes()
                    want = window_gather_plain(table, idx, starts, tq, K)
                    if not torch.equal(got, want):   # a copy: bit for bit
                        raise AssertionError(f"window_gather differs at "
                                             f"{tag} {dtype}")
                    want_dt = window_gather_bwd_plain(idx, g.float(), starts,
                                                      tq, K, S)
                    torch.testing.assert_close(dt.float(), want_dt, **dtol)
                    note("window_gather" + sfx, got, want)
                    note("window_gather_bwd" + sfx, dt, want_dt)
                else:
                    w32 = cw.float()
                    g = torch.randn(B, idx.shape[1], HEADS, 4 * D,
                                    generator=gen).to(DEVICE, dtype)
                    if kind == "fwin":
                        got = fused_window_sample(table, idx, w32, starts, K,
                                                  tq)
                    dt, dw = windowed_weighted_bwd(table, idx, w32, g,
                                                   starts, K, tq)
                    counted = (("fused_window",) if kind == "fwin" else ()) \
                        + ("window_weighted_bwd",)
                    esc = read_escapes()
                    if kind == "fwin":
                        # gather_weighted's kernel: its output bit for bit
                        if not torch.equal(got, gather_weighted(table, idx,
                                                                w32)):
                            raise AssertionError(f"fused_window differs from "
                                                 f"gather_weighted at {tag} "
                                                 f"{dtype}")
                        want = fused_window_sample_plain(
                            table.float(), idx, w32, starts, K, tq)
                        torch.testing.assert_close(got.float(), want, **tol)
                        note("fused_window" + sfx, got, want)
                    want_dt, want_dw = windowed_weighted_bwd_plain(
                        table.float(), idx, w32, g.float(), starts, K, tq)
                    torch.testing.assert_close(dt.float(), want_dt, **dtol)
                    torch.testing.assert_close(dw, want_dw, **F32_TOL)
                    note("window_weighted_bwd" + sfx, dt, want_dt)
                    note("window_weighted_bwd_dw" + sfx, dw, want_dw)
                got_esc = {k: esc[k] for k in counted}
                if got_esc != dict.fromkeys(counted, want_esc):
                    raise AssertionError(f"{kind} {tag} {dtype}: escape "
                                         f"counts {got_esc}, expected "
                                         f"{want_esc}")
                if escape:
                    escaped[f"{kind} {tag}"] = want_esc
    print(f"kernels: window escapes counted in the escape cases {escaped} "
          f"(0 in every in-window case)")
    return err


def raster_msda_inputs(gen, levels, noise_px=0.5):
    """value, locations and attention of an encoder MSDA call on
    ``levels``: every token a query, each sampling near its own pixel."""
    S = sum(h * w for h, w in levels)
    own = torch.cat([pixel_centres(hw) for hw in levels])   # (S, 2)
    scale = torch.tensor([[1.0 / w, 1.0 / h] for h, w in levels])
    noise = torch.randn(B, S, HEADS, len(levels), P, 2, generator=gen) * (
        noise_px * scale[None, None, None, :, None, :])
    locs = own[:, None, None, None, :] + noise
    logits = torch.randn(B, S, HEADS, len(levels) * P, generator=gen)
    attn = logits.softmax(-1).reshape(B, S, HEADS, len(levels), P)
    value = torch.randn(B, S, HEADS, D, generator=gen)
    return value, locs, attn


def check_window_grads(gen):
    """The gradients of ms_deform_attn_core in value, locations and
    attention under each windowed switch, for the encoder's raster queries
    of the 512x512 canvas: the card (launches checked) against the plain
    twins on the CPU."""
    from dskd_tpu_torch.ops.msda import ms_deform_attn_core

    host = raster_msda_inputs(gen, GRAD_LEVELS)
    cot = torch.randn(B, host[0].shape[1], HEADS * D, generator=gen)

    def grads(dev):
        args = [t.to(dev).requires_grad_(True) for t in host]
        out = ms_deform_attn_core(args[0], GRAD_LEVELS, args[1], args[2],
                                  raster_queries=True)
        return [out.detach().cpu()] + [g.cpu() for g in torch.autograd.grad(
            out, args, cot.to(dev))]

    errs = {}
    for switch in ("winbwd", "fwin", "window_rows"):
        with switched(TRAIN_SWITCHES[switch]):
            reset_counts()
            card = grads(DEVICE)
            launches, escapes = read_counts(), read_escapes()
            want = expected_launches(switch, 1, 0, 1, 0)
            if launches != want:
                raise AssertionError(f"msda grads {switch}: launches "
                                     f"{launches}, expected {want}")
            for name, got, ref in zip(("out", "value", "locations",
                                       "attention"), card, grads("cpu")):
                if not got.abs().max() > 0:
                    raise AssertionError(f"no gradient reaches {name} on "
                                         f"the card ({switch})")
                torch.testing.assert_close(
                    got, ref, rtol=MSDA_GRAD_TOL["rtol"],
                    atol=WINDOW_GRAD_TOL * float(ref.abs().max()),
                    msg=f"{name} ({switch})")
                errs[f"{name} {switch}"] = _max_err(got, ref)
        print(f"kernels: msda grads {switch} on the 512x512 canvas: "
              f"launches {launches}, window escapes {escapes}")
    return errs


def time_window_kernels(gen):
    """The four windowed kernels at the shapes the main paths give them,
    against their plain twins, a library call where one computes the same
    function, and their bound: window_gather and its backward at level 0 of
    640x640 (B5's training canvas, Q=6400), fused_window over the two
    segments of 640x480 level 0 that take it (one MSDA call), and the
    windowed weighted backward over the two 640x480 segments of
    DSKD_WINBWD, fused_window and the windowed backward each beside its
    unwindowed kernel (gather_weighted, gather_weighted_bwd) on the same
    inputs; device ms.
    Returns {name: (kernel ms, plain ms, library ms or None, (bound ms, by),
    f32 adds into dtable or None)}."""
    from dskd_tpu_torch.ops.fused_window import fused_window_sample, \
        fused_window_sample_plain, windowed_weighted_bwd, \
        windowed_weighted_bwd_plain
    from dskd_tpu_torch.ops.mxu_gather import gather_weighted, \
        gather_weighted_bwd
    from dskd_tpu_torch.ops.window_gather import window_gather, \
        window_gather_bwd, window_gather_bwd_plain, window_gather_plain

    out = {}
    tq = WIN_TILE_Q
    hd = torch.arange(HEADS, device=DEVICE)[None, None, :, None]
    bi = torch.arange(B, device=DEVICE)[:, None, None, None]
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        cases = window_cases(gen, dtype)
        # B5: window_gather at 640x640 level 0
        _, _, table, flat, _, starts, K = next(c for c in cases
                                               if c[1] == "gather")
        S = table.shape[1]
        g = torch.randn(B, flat.shape[1], HEADS, P, 4 * D,
                        generator=gen).to(DEVICE, dtype)
        rows = table.view(-1, 4 * D)
        lin = ((bi * S + flat.long()) * HEADS + hd).reshape(-1)
        zeros = torch.zeros_like(rows)
        out[f"window_gather {tag}"] = (
            device_ms(lambda: window_gather(table, flat, starts, tq * P, K)),
            device_ms(lambda: window_gather_plain(table, flat, starts, tq, K),
                      iters=5),
            device_ms(lambda: torch.index_select(rows, 0, lin)),
            bound(nbytes(table, flat, g), 0), None)
        out[f"window_gather_bwd {tag}"] = (
            device_ms(lambda: window_gather_bwd(flat, g, starts, tq, K, S),
                      iters=10),
            device_ms(lambda: window_gather_bwd_plain(flat, g, starts, tq, K,
                                                    S), iters=3, warmup=1),
            device_ms(lambda: torch.index_add(zeros, 0, lin,
                                            g.view(-1, 4 * D)), iters=10),
            bound(nbytes(flat, g, table), flat.numel() * 4 * D),
            flat.numel() * 4 * D)
        for kind, name in (("fwin", "fused_window"),
                           ("winbwd", "window_weighted_bwd")):
            segs = [(t, f, c.float(), st, k,
                     torch.randn(B, f.shape[1], HEADS, 4 * D,
                                 generator=gen).to(DEVICE, dtype))
                    for tg, kd, t, f, c, st, k in cases
                    if kd == kind and tg.startswith("640x480")]
            table = segs[0][0]
            n_rows = sum(f.numel() for _, f, *_ in segs)
            row = 4 * D
            if kind == "fwin":
                bags = [gather_weighted_bags(t, f, c)
                        for t, f, c, *_ in segs]
                out[f"{name} {tag}"] = (
                    device_ms(lambda: [fused_window_sample(t, f, c, st, k, tq)
                                       for t, f, c, st, k, _ in segs]),
                    device_ms(lambda: [fused_window_sample_plain(
                        t, f, c, st, k, tq) for t, f, c, st, k, _ in segs],
                        iters=5),
                    # its function is gather_weighted's on the same inputs
                    device_ms(lambda: [embedding_bag(bg, g.shape)
                                       for bg, (*_, g) in zip(bags, segs)]),
                    # reads the table, idx and w; writes out (g's size)
                    bound(nbytes(table) + sum(nbytes(f, c, g) for
                                              _, f, c, _, _, g in segs),
                          2 * row * n_rows), None)
                out[f"gather_weighted on the same segments {tag}"] = (
                    device_ms(lambda: [gather_weighted(t, f, c)
                                       for t, f, c, *_ in segs]),
                    None, None, out[f"{name} {tag}"][3], None)
                continue
            out[f"{name} {tag}"] = (
                device_ms(lambda: [windowed_weighted_bwd(t, f, c, g, st, k, tq)
                                   for t, f, c, st, k, g in segs], iters=10),
                device_ms(lambda: [windowed_weighted_bwd_plain(
                    t, f, c, g, st, k, tq) for t, f, c, st, k, g in segs],
                    iters=3, warmup=1),
                None,
                # reads table, idx, w and g; writes dtable and dw
                bound(2 * nbytes(table) + sum(nbytes(f, g) + 2 * nbytes(c)
                                              for _, f, c, _, _, g in segs),
                      4 * row * n_rows), row * n_rows)
            out[f"gather_weighted_bwd on the same segments {tag}"] = (
                device_ms(lambda: [gather_weighted_bwd(t, f, c, g)
                                   for t, f, c, st, k, g in segs], iters=10),
                None, None, out[f"{name} {tag}"][3], row * n_rows)
            for t, f, c, st, k, g in segs:
                out[f"{name} {tag} K={k} ({f.shape[1]} queries)"] = (
                    device_ms(lambda: windowed_weighted_bwd(t, f, c, g, st, k,
                                                          tq), iters=10),
                    None, None,
                    bound(2 * nbytes(t) + nbytes(f, g) + 2 * nbytes(c),
                          4 * row * f.numel()), row * f.numel())
    return out


def check_slice(imgs):
    from dskd_tpu_torch.apis.inference import (inference_detector,
                                               init_detector, prepare_batch)

    model, cfg = init_detector(CONFIG, device=DEVICE, seed=0)
    # one launch of each kernel per level of every MSDA call of a forward
    want = model_launches("default", cfg, 1)
    reset_counts()
    results = inference_detector(model, cfg, imgs)
    launches = read_counts()
    print(f"serve: launches in one inference_detector call over "
          f"{len(imgs)} images: {launches}")
    if launches != want:
        raise AssertionError(f"serve: launches {launches}, expected {want}")
    n_det = []
    for per_class in results:
        if len(per_class) != cfg.model.num_classes:
            raise AssertionError("wrong number of classes in the result")
        for r in per_class:
            if r.ndim != 2 or r.shape[1] != 5 or not np.isfinite(r).all():
                raise AssertionError("malformed or non-finite detections")
        n_det.append(sum(len(r) for r in per_class))
    if not all(0 < n <= cfg.test_max_per_img for n in n_det):
        raise AssertionError(f"detections per image {n_det}")
    print(f"serve: detections per image {n_det}, all finite")

    # the head outputs against the same weights on the CPU (plain twins)
    images, img_hw, _ = prepare_batch(cfg, imgs, DEVICE)
    cpu_model, _ = init_detector(cfg, device="cpu", seed=0)
    with torch.inference_mode():
        out = model(images, img_hw).head
        ref = cpu_model(images.cpu(), img_hw.cpu()).head
    errs = {}
    for name in ("cls_scores", "bbox_preds"):
        got, want = getattr(out, name)[-1].cpu(), getattr(ref, name)[-1]
        if not torch.isfinite(got).all():
            raise AssertionError(f"non-finite {name}")
        torch.testing.assert_close(got, want, **HEAD_TOL)
        errs[name] = float((got - want).abs().max())
    print(f"serve: card vs CPU head outputs, last layer, max abs err "
          f"{errs} (tolerance {HEAD_TOL})")
    return model, cfg


# --- train -------------------------------------------------------------------

def train_batch(device, hw=TRAIN_HW):
    """bench.py's synthetic batch: B images of the (H, W) canvas ``hw``
    (640x480: valid widths 375-480), 5-29 valid GT of 32 in classes
    40-79."""
    from dskd_tpu_torch.data.batch import Batch

    H, W = hw
    rng = np.random.RandomState(0)
    images = rng.randn(B, H, W, 3).astype(np.float32) * 0.5
    img_hw = np.stack([np.full(B, H), rng.randint(int(W * 0.78125), W + 1,
                                                  B)], -1).astype(np.int32)
    xy = rng.rand(B, MAX_GT, 2).astype(np.float32) * 400
    wh = rng.rand(B, MAX_GT, 2).astype(np.float32) * 150 + 20
    gt = np.concatenate([xy, xy + wh], -1)
    labels = rng.randint(40, 80, (B, MAX_GT)).astype(np.int64)
    valid = np.arange(MAX_GT)[None] < rng.randint(5, 30, (B, 1))
    return Batch(*(torch.from_numpy(a) for a in (
        images, img_hw, gt, labels, valid))).to(device)


def build_models(cfg, device, **overrides):
    """Student (seed 0) and frozen teacher (seed 1) of the flagship model
    config, with ``overrides`` of its fields. The teacher stands for a model
    trained on the previous task's classes: its class bias is 0 (prior 0.5)
    for those and -20 for the new ones, so it keeps max_per_img confident
    old-class detections per image, as the corr distill expects."""
    from dskd_tpu_torch.models.detector import build_detector, init_weights
    from dskd_tpu_torch.train.state import frozen_copy

    mcfg = dataclasses.replace(cfg.model, **overrides)
    student = build_detector(mcfg, torch.device(device))
    init_weights(student, seed=0)
    teacher = build_detector(mcfg, torch.device(device))
    init_weights(teacher, seed=1)
    n_old = cfg.data.catsplit[0]
    with torch.no_grad():
        bias = teacher.bbox_head.cls_branches[0].bias
        bias[:n_old] = 0.0
        bias[n_old:] = -20.0
    return student, frozen_copy(teacher)


def train_setup(cfg, student, compute_dtype):
    from dskd_tpu_torch.distill.losses import DistillConfig
    from dskd_tpu_torch.models.gfl_detr_loss import DetLossConfig
    from dskd_tpu_torch.train.optim import make_optimizer
    from dskd_tpu_torch.train.schedule import step_lr_schedule
    from dskd_tpu_torch.train.state import TrainState
    from dskd_tpu_torch.train.step import make_train_step

    t = cfg.train
    sched = step_lr_schedule(t.base_lr, t.warmup_iters, t.warmup_ratio,
                             t.step_epochs, iters_per_epoch=1000)
    state = TrainState.create(student, make_optimizer(student, sched),
                              seed=1)
    det_cfg = DetLossConfig(num_classes=cfg.model.num_classes,
                            reg_max=cfg.model.reg_max)
    dcfg = DistillConfig.from_flags(
        cates_distill=cfg.distill.cates_distill,
        feats_distill=cfg.distill.feats_distill,
        num_prev=cfg.data.catsplit[0])
    step = make_train_step(det_cfg, dcfg, cfg.distill.teacher_score_thr,
                           cfg.distill.teacher_max_per_img,
                           compute_dtype=compute_dtype)
    return state, step, det_cfg, dcfg


def run_train(cfg, compute_dtype, n_steps, tag, switch="default"):
    """A few full-width steps under the sampling ``switch`` whose
    environment the caller set; checks finite losses, launch counts per step
    and which parameter groups move. Returns (state, step, teacher, batch,
    launches of the whole run)."""
    student, teacher = build_models(cfg, DEVICE)
    state, step, _, _ = train_setup(cfg, student, compute_dtype)
    batch = train_batch(DEVICE, TRAIN_CANVAS.get(switch, TRAIN_HW))
    # teacher and student forwards, the student's backward
    expected = model_launches(switch, cfg, 2, 1)
    before = {n: p.detach().clone() for n, p in student.named_parameters()}
    total = dict.fromkeys(expected, 0)
    reset_counts()
    for i in range(n_steps):
        start = read_counts()
        state, losses = step(state, batch, teacher)
        now = read_counts()
        per_step = {k: now[k] - start[k] for k in now}
        bad = {k: v for k, v in losses.items() if not torch.isfinite(v)}
        if bad:
            raise AssertionError(f"train {tag}: non-finite losses {bad}")
        if per_step != expected:
            raise AssertionError(f"train {tag}: launches per step "
                                 f"{per_step}, expected {expected}")
        print(f"train {tag}: step {i} loss {float(losses['loss']):.5f} "
              f"(cls {float(losses['loss_cls']):.5f}, corr "
              f"{float(losses['loss_corr']):.6f}, fg "
              f"{float(losses['loss_fg_feature']):.6f}, auction_fallback "
              f"{float(losses['auction_fallback']):.0f}); launches {per_step}")
        for k in total:
            total[k] += per_step[k]
    labels = state.optimizer.labels
    moved = {g: [0, 0] for g in ("base", "lr01", "frozen")}
    for n, p in student.named_parameters():
        moved[labels[n]][0] += not torch.equal(p.detach(), before[n])
        moved[labels[n]][1] += 1
    print(f"train {tag}: parameters changed / in group after {n_steps} "
          f"steps: {moved}")
    if moved["frozen"][0] or moved["base"][0] < moved["base"][1] - 1 \
            or moved["lr01"][0] < moved["lr01"][1]:
        # base: the head's unused prototype gets weight decay alone, 2e-10
        # of itself in warmup, below f32's resolution
        raise AssertionError(f"train {tag}: wrong parameters moved {moved}")
    return state, step, teacher, batch, total


def _to_cpu(x):
    """Tensors of nested (named) tuples, on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    items = [_to_cpu(t) for t in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def random_msda_kernels(model, seed):
    """Seeded normal(0, MSDA_WEIGHT_STD) ``sampling_offsets`` and
    ``attention_weights`` kernels, drawn on the CPU, as after a training
    step. The mmcv init's zero kernels leave the offsets on the bias's
    integer grid, so the encoder samples on pixel edges, where bilinear
    sampling's location gradient jumps and a 1-ulp difference between two
    devices picks the other slope."""
    from dskd_tpu_torch.models.transformer import MSDeformAttention

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, MSDeformAttention):
                for lin in (mod.sampling_offsets, mod.attention_weights):
                    lin.weight.copy_(torch.randn(
                        lin.weight.shape, generator=g) * MSDA_WEIGHT_STD)


def check_train_card_vs_cpu(cfg):
    """One step at full width with 2+2 layers, f32, dropout 0: every loss
    key and the gradients of GRAD_PARAMS, card against CPU."""
    from dskd_tpu_torch.train.step import compute_losses, parse_losses, \
        teacher_info

    small = dict(num_encoder_layers=2, num_decoder_layers=2, dropout=0.0)
    student, teacher = build_models(cfg, DEVICE, **small)
    cpu_student, cpu_teacher = build_models(cfg, "cpu", **small)
    for model in (student, cpu_student):
        random_msda_kernels(model, seed=3)
    _, _, det_cfg, dcfg = train_setup(cfg, student, torch.float32)
    thr, kmax = cfg.distill.teacher_score_thr, cfg.distill.teacher_max_per_img
    batch = train_batch(DEVICE)
    cpu_batch = batch.to("cpu")

    def run(model, tmodel, b, tinfo=None, assigned=None):
        model.train()
        if tinfo is None:
            tinfo = teacher_info(tmodel, b, det_cfg, thr, kmax)
        losses, targets = compute_losses(model, b, det_cfg, tinfo, dcfg,
                                         assigned=assigned)
        parse_losses(losses).backward()
        params = dict(model.named_parameters())
        return (tinfo, targets, losses,
                {n: params[n].grad.detach().cpu() for n in GRAD_PARAMS})

    tinfo, targets, losses, grads = run(student, teacher, batch)
    c_tinfo, c_targets, c_losses, c_grads = run(cpu_student, cpu_teacher,
                                                cpu_batch)
    same_teacher = all(torch.equal(a.cpu(), b) for a, b in zip(
        tinfo.det[4:], c_tinfo.det[4:]))            # keep_qid, valid
    same_assign = torch.equal(targets.assigned_gt.cpu(),
                              c_targets.assigned_gt)
    print(f"train card vs CPU (2+2 layers): teacher kept "
          f"{int(tinfo.det.valid.sum())} detections, same on both devices: "
          f"{same_teacher}; same auction assignments: {same_assign}")
    if not (same_teacher and same_assign):
        print("train card vs CPU: the devices differ at near-ties; the CPU "
              "losses are recomputed under the card's teacher and "
              "assignments")
        cpu_student.zero_grad(set_to_none=True)
        _, _, c_losses, c_grads = run(
            cpu_student, cpu_teacher, cpu_batch, _to_cpu(tinfo),
            (_to_cpu(targets), losses["auction_fallback"].cpu()))
    loss_err = {}
    for k, v in c_losses.items():
        got = losses[k].detach().cpu()
        torch.testing.assert_close(got, v.detach(), **LOSS_TOL, msg=k)
        loss_err[k] = float((got - v.detach()).abs())
    print(f"train card vs CPU: {len(loss_err)} loss keys within {LOSS_TOL}, "
          f"largest abs err {max(loss_err.values()):.3e} "
          f"({max(loss_err, key=loss_err.get)})")
    grad_err, bad = {}, {}
    for n in GRAD_PARAMS:
        ref, diff = c_grads[n], grads[n] - c_grads[n]
        rel = float(diff.norm() / ref.norm())
        grad_err[n] = rel
        if not rel <= GRAD_REL_TOL:
            bad[n] = rel
        print(f"train card vs CPU: grad {n}: relative L2 err {rel:.3e} "
              f"(tolerance {GRAD_REL_TOL}); max abs err "
              f"{float(diff.abs().max()):.3e} of max abs "
              f"{float(ref.abs().max()):.3e}")
    if bad:
        raise AssertionError(f"gradients differ card vs CPU: {bad}")
    return loss_err, grad_err


# --- switches ----------------------------------------------------------------

def check_serve_switch(model, cfg, imgs, switch):
    """One inference_detector call under a sampling switch (launches
    checked), and the model's head outputs under it against the default
    path's on the card."""
    from dskd_tpu_torch.apis.inference import inference_detector, \
        prepare_batch

    images, img_hw, _ = prepare_batch(cfg, imgs, DEVICE)
    with torch.inference_mode():
        ref = model(images, img_hw).head
    with switched(SERVE_SWITCHES[switch]):
        reset_counts()
        results = inference_detector(model, cfg, imgs)
        launches, escapes = read_counts(), read_escapes()
        with torch.inference_mode():
            out = model(images, img_hw).head
    want = model_launches(switch, cfg, 1)
    if launches != want:
        raise AssertionError(f"serve {switch}: launches {launches}, "
                             f"expected {want}")
    if not all(np.isfinite(r).all() for per in results for r in per):
        raise AssertionError(f"serve {switch}: non-finite detections")
    tol = WINDOW_HEAD_TOL if switch in ENCODER_CALL else HEAD_TOL
    errs = {}
    for name in ("cls_scores", "bbox_preds"):
        got, ref_t = getattr(out, name)[-1], getattr(ref, name)[-1]
        torch.testing.assert_close(got, ref_t, **tol)
        errs[name] = _max_err(got, ref_t)
    print(f"serve {switch} {SERVE_SWITCHES[switch]}: launches {launches}; "
          f"window escapes {escapes}; head outputs vs the default path on "
          f"the card, max abs err {errs} (tolerance {tol})")
    return errs


def check_train_switch_vs_default(cfg, switch):
    """One full-width f32 step of the student (6+6 layers, dropout 0.1)
    under a sampling switch against the default path on the card: the same
    weights, batch, dropout generator seed, teacher detections and
    assignment; every loss key within LOSS_TOL and each named gradient
    within GRAD_REL_TOL relative L2, or WINDOW_LOSS_TOL and
    WINDOW_GRAD_REL_TOL under a windowed switch."""
    from dskd_tpu_torch.train.step import compute_losses, parse_losses, \
        teacher_info

    student, teacher = build_models(cfg, DEVICE)
    random_msda_kernels(student, seed=3)
    _, _, det_cfg, dcfg = train_setup(cfg, student, torch.float32)
    batch = train_batch(DEVICE, TRAIN_CANVAS.get(switch, TRAIN_HW))
    tinfo = teacher_info(teacher, batch, det_cfg,
                         cfg.distill.teacher_score_thr,
                         cfg.distill.teacher_max_per_img)

    def run(assigned=None):
        student.zero_grad(set_to_none=True)
        gen = torch.Generator(device=DEVICE).manual_seed(5)
        losses, targets = compute_losses(student.train(), batch, det_cfg,
                                         tinfo, dcfg, gen, assigned=assigned)
        parse_losses(losses).backward()
        params = dict(student.named_parameters())
        return (targets, {k: v.detach() for k, v in losses.items()},
                {n: params[n].grad.detach().clone() for n in GRAD_PARAMS})

    targets, losses, grads = run()
    with switched(TRAIN_SWITCHES[switch]):
        reset_counts()
        _, s_losses, s_grads = run((targets, losses["auction_fallback"]))
        launches, escapes = read_counts(), read_escapes()
    want = model_launches(switch, cfg, 1, 1)
    if launches != want:
        raise AssertionError(f"train {switch} vs default: launches "
                             f"{launches}, expected {want}")
    loss_tol, grad_tol = ((WINDOW_LOSS_TOL, WINDOW_GRAD_REL_TOL)
                          if switch in ENCODER_CALL
                          else (LOSS_TOL, GRAD_REL_TOL))
    for k, v in losses.items():
        torch.testing.assert_close(s_losses[k], v, **loss_tol, msg=k)
    loss_err = max(float((s_losses[k] - v).abs()) for k, v in losses.items())
    grad_err = {}
    for n in GRAD_PARAMS:
        rel = float((s_grads[n] - grads[n]).norm() / grads[n].norm())
        grad_err[n] = rel
        if not rel <= grad_tol:
            raise AssertionError(f"train {switch}: grad {n} differs from "
                                 f"the default path: rel L2 {rel:.3e}")
    print(f"train {switch} vs default on the card (6+6 layers, f32, "
          f"dropout 0.1, one assignment, {batch.images.shape[1]}x"
          f"{batch.images.shape[2]}): {len(losses)} loss keys, largest "
          f"abs err {loss_err:.3e} (tolerance {loss_tol}); named "
          f"gradients rel L2 err {grad_err} (tolerance {grad_tol}); window "
          f"escapes {escapes}")
    return loss_err, grad_err


# --- times -------------------------------------------------------------------

def time_kernels(gen):
    """Device ms of the three default-path kernels and their plain twins
    over the four levels of each canvas, and level by level for
    gather_weighted and pack_corners at 640x640 and gather_weighted_bwd at
    640x480, with gather_weighted's ``F.embedding_bag`` yardstick on the
    same inputs. Returns ({name: (kernel ms, plain ms, library ms or
    None)}, {name: (bound ms, what bounds it)}, {name: f32 adds into dtable}
    of each backward timing)."""
    from dskd_tpu_torch.ops.msda import corner_index_and_weights
    from dskd_tpu_torch.ops.mxu_gather import gather_weighted, \
        gather_weighted_bwd, gather_weighted_bwd_plain, gather_weighted_plain
    from dskd_tpu_torch.ops.pack_kernel import pack_corners, \
        pack_corners_plain

    times, bounds, adds = {}, {}, {}
    row = 4 * D
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        es = torch.empty((), dtype=dtype).element_size()
        for levels, Q, canvas in ((LEVELS, Q_ENC, "640x640"),
                                  (LEVELS, Q_DEC, "640x640"),
                                  (TRAIN_LEVELS, Q_TRAIN, "640x480")):
            value, per_level = level_inputs(gen, dtype, Q, levels)
            slices, tables, args, douts = [], [], [], []
            start = 0
            for (h, w), (loc, attn) in zip(levels, per_level):
                v = value[:, start:start + h * w]
                start += h * w
                slices.append((v, h, w))
                tables.append(pack_corners(v, h, w))
                args.append(corner_index_and_weights(loc, attn, h, w, dtype))
                douts.append(torch.randn(B, Q, HEADS, 4 * D, generator=gen)
                             .to(DEVICE, dtype))
            if canvas == "640x640":
                shape = (B, Q, HEADS, row)
                bags = [gather_weighted_bags(t, f, c)
                        for t, (f, c) in zip(tables, args)]
                key = f"gather_weighted {tag} Q={Q}"
                # reads the tables, idx and w; writes one row per sample
                bounds[key] = bound(
                    sum(nbytes(t, f, c) for t, (f, c) in zip(tables, args))
                    + len(levels) * B * Q * HEADS * row * es,
                    2 * row * sum(f.numel() for f, _ in args))
                times[key] = (
                    device_ms(lambda: [gather_weighted(t, f, c) for t, (f, c)
                                       in zip(tables, args)]),
                    device_ms(lambda: [gather_weighted_plain(t, f, c)
                                       for t, (f, c) in zip(tables, args)],
                              iters=5),
                    device_ms(lambda: [embedding_bag(bg, shape)
                                       for bg in bags]))
                for lvl, ((h, w), t, (f, c), bg) in enumerate(zip(
                        levels, tables, args, bags)):
                    lkey = f"{key} level {lvl} ({h}x{w}, {t.shape[1]} rows)"
                    bounds[lkey] = bound(nbytes(t, f, c) + B * Q * HEADS
                                         * row * es, 2 * row * f.numel())
                    times[lkey] = (
                        device_ms(lambda: gather_weighted(t, f, c)),
                        device_ms(lambda: gather_weighted_plain(t, f, c),
                                  iters=5),
                        device_ms(lambda: embedding_bag(bg, shape)))
                if Q == Q_ENC:
                    key = f"pack_corners {tag}"
                    bounds[key] = bound(sum(nbytes(v, t) for (v, _, _), t
                                            in zip(slices, tables)), 0)
                    times[key] = (
                        device_ms(lambda: [pack_corners(*a) for a in slices]),
                        device_ms(lambda: [pack_corners_plain(*a)
                                           for a in slices]), None)
                    for lvl, (a, t) in enumerate(zip(slices, tables)):
                        lkey = f"{key} level {lvl} ({a[1]}x{a[2]})"
                        bounds[lkey] = bound(nbytes(a[0], t), 0)
                        times[lkey] = (
                            device_ms(lambda: pack_corners(*a)),
                            device_ms(lambda: pack_corners_plain(*a)), None)
            n_rows = sum(f.numel() for f, _ in args)   # all in range
            key = f"gather_weighted_bwd {tag} Q={Q} {canvas}"
            # reads table, idx, w and dout; writes dtable and dw
            bounds[key] = bound(
                sum(2 * nbytes(t) + nbytes(f, g) + 2 * nbytes(c)
                    for t, (f, c), g in zip(tables, args, douts)),
                4 * row * n_rows)
            adds[key] = row * n_rows
            times[key] = (
                device_ms(lambda: [gather_weighted_bwd(t, f, c, g) for
                                   t, (f, c), g in zip(tables, args, douts)],
                          iters=10),
                device_ms(lambda: [gather_weighted_bwd_plain(t, f, c, g) for
                                   t, (f, c), g in zip(tables, args, douts)],
                          iters=3, warmup=1), None)
            if canvas == "640x480":
                for lvl, ((h, w), t, (f, c), g) in enumerate(zip(
                        levels, tables, args, douts)):
                    lkey = f"{key} level {lvl} ({h}x{w}, {t.shape[1]} rows)"
                    bounds[lkey] = bound(2 * nbytes(t) + nbytes(f, g)
                                         + 2 * nbytes(c), 4 * row * f.numel())
                    adds[lkey] = row * f.numel()
                    times[lkey] = (
                        device_ms(lambda: gather_weighted_bwd(t, f, c, g),
                                  iters=10),
                        device_ms(lambda: gather_weighted_bwd_plain(t, f, c,
                                                                    g),
                                  iters=3, warmup=1), None)
    return times, bounds, adds


def time_sampling_kernels(gen):
    """mxu_gather and fused_msda_sample, forward and backward, at the shapes
    the switches give them in the training step's encoder: levels 1-3 of
    the 640x480 canvas, Q=6380, one MSDA call; device ms. Returns {name:
    (kernel ms, plain ms, library ms or None, (bound ms, bound by), f32 adds
    into dtable or None)}, f32 and bf16, and fused_msda_sample forward and
    backward and the mxu_gather backward per level."""
    from dskd_tpu_torch.ops.fused_sample import fused_msda_sample, \
        fused_msda_sample_bwd, fused_msda_sample_bwd_plain, \
        fused_msda_sample_plain
    from dskd_tpu_torch.ops.msda import corner_index_and_weights, \
        fused_index_and_weights
    from dskd_tpu_torch.ops.mxu_gather import mxu_gather, mxu_gather_bwd, \
        mxu_gather_bwd_plain, mxu_gather_plain
    from dskd_tpu_torch.ops.pack_kernel import pack_corners

    out = {}
    levels, Q = TRAIN_LEVELS, Q_TRAIN
    hd = torch.arange(HEADS, device=DEVICE)[None, None, :, None]
    bi = torch.arange(B, device=DEVICE)[:, None, None, None]
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        es = torch.empty((), dtype=dtype).element_size()
        value, per_level = level_inputs(gen, dtype, Q, levels)
        mg, fs, fbags = [], [], []
        start = levels[0][0] * levels[0][1]
        for (h, w), (loc, attn) in zip(levels[1:], per_level[1:]):
            v = value[:, start:start + h * w]
            start += h * w
            table = pack_corners(v, h, w)
            S = table.shape[1]
            flat, _ = corner_index_and_weights(loc, attn, h, w, dtype)
            g = torch.randn(B, Q, HEADS, P, 4 * D, generator=gen).to(DEVICE,
                                                                     dtype)
            # the same gather as one library call: rows of the flattened
            # (B*S*H, 4D) table at the linear row of each index
            lin = ((bi * S + flat.long()) * HEADS + hd).reshape(-1)
            mg.append((table, flat, g, S, lin))
            c00, wts = fused_index_and_weights(loc, attn, h, w, dtype)
            fbags.append(fused_sample_bags(value, start - h * w, (h, w), c00,
                                           wts))
            rows = c00[..., None].long() + torch.tensor([0, 1, w, w + 1],
                                                        device=DEVICE)
            taps = int(((rows >= 0) & (rows < h * w)).sum())
            gq = torch.randn(B, Q, HEADS, D, generator=gen).to(DEVICE, dtype)
            fs.append((v, c00, wts, gq, w, taps))
        n_idx = sum(f.numel() for _, f, _, _, _ in mg)
        zeros = [torch.zeros_like(t).view(-1, 4 * D) for t, *_ in mg]
        out[f"mxu_gather {tag}"] = (
            device_ms(lambda: [mxu_gather(t, f) for t, f, _, _, _ in mg]),
            device_ms(lambda: [mxu_gather_plain(t, f) for t, f, _, _, _ in mg],
                      iters=5),
            device_ms(lambda: [torch.index_select(t.view(-1, 4 * D), 0, lin)
                               for t, _, _, _, lin in mg]),
            bound(sum(nbytes(t, f, g) for t, f, g, _, _ in mg), 0), None)
        out[f"mxu_gather_bwd {tag}"] = (
            device_ms(lambda: [mxu_gather_bwd(f, g, S)
                               for _, f, g, S, _ in mg], iters=10),
            device_ms(lambda: [mxu_gather_bwd_plain(f, g, S)
                               for _, f, g, S, _ in mg], iters=3, warmup=1),
            device_ms(lambda: [torch.index_add(z, 0, lin, g.view(-1, 4 * D))
                               for z, (_, _, g, _, lin) in zip(zeros, mg)],
                      iters=10),
            bound(sum(nbytes(f, g, t) for t, f, g, _, _ in mg),
                  n_idx * 4 * D), n_idx * 4 * D)
        out[f"fused_sample {tag}"] = (
            device_ms(lambda: [fused_msda_sample(v, c, wt, w)
                               for v, c, wt, _, w, _ in fs]),
            device_ms(lambda: [fused_msda_sample_plain(v, c, wt, w)
                               for v, c, wt, _, w, _ in fs], iters=5),
            device_ms(lambda: [embedding_bag(bg, (B, Q, HEADS, D))
                               for bg in fbags]),
            bound(sum(nbytes(v, c, wt, gq) for v, c, wt, gq, _, _ in fs),
                  sum(2 * D * taps for *_, taps in fs)), None)
        out[f"fused_sample_bwd {tag}"] = (
            device_ms(lambda: [fused_msda_sample_bwd(v, c, wt, gq, w)
                               for v, c, wt, gq, w, _ in fs], iters=10),
            device_ms(lambda: [fused_msda_sample_bwd_plain(v, c, wt, gq, w)
                               for v, c, wt, gq, w, _ in fs], iters=3,
                      warmup=1),
            None,
            # reads table, idx, w and g; writes dtable and dw
            bound(sum(2 * nbytes(v) + nbytes(c, gq) + 2 * nbytes(wt)
                      for v, c, wt, gq, _, _ in fs),
                  sum(4 * D * taps for *_, taps in fs)),
            sum(D * taps for *_, taps in fs))
        for lvl, ((h, w), (_, f, g, S, _), (v, c, wt, gq, _, taps)) in \
                enumerate(zip(levels[1:], mg, fs), start=1):
            out[f"mxu_gather_bwd {tag} level {lvl} ({h}x{w}, {S} rows)"] = (
                device_ms(lambda: mxu_gather_bwd(f, g, S), iters=10),
                device_ms(lambda: mxu_gather_bwd_plain(f, g, S), iters=3,
                          warmup=1), None,
                bound(nbytes(f, g) + B * S * HEADS * 4 * D * es,
                      f.numel() * 4 * D), f.numel() * 4 * D)
            out[f"fused_sample {tag} level {lvl} ({h}x{w}, {h * w} rows)"] = (
                device_ms(lambda: fused_msda_sample(v, c, wt, w)),
                device_ms(lambda: fused_msda_sample_plain(v, c, wt, w),
                          iters=5),
                device_ms(lambda: embedding_bag(fbags[lvl - 1],
                                                (B, Q, HEADS, D))),
                bound(nbytes(v, c, wt, gq), 2 * D * taps), None)
            out[f"fused_sample_bwd {tag} level {lvl} ({h}x{w}, {h * w} "
                f"rows)"] = (
                device_ms(lambda: fused_msda_sample_bwd(v, c, wt, gq, w),
                          iters=10),
                device_ms(lambda: fused_msda_sample_bwd_plain(v, c, wt, gq, w),
                          iters=3, warmup=1), None,
                bound(2 * nbytes(v) + nbytes(c, gq) + 2 * nbytes(wt),
                      4 * D * taps), D * taps)
    return out


def time_slice(model, cfg, imgs_by_batch):
    from dskd_tpu_torch.apis.inference import inference_detector, \
        prepare_batch

    out = {}
    for bsz, imgs in imgs_by_batch.items():
        for _ in range(2):
            inference_detector(model, cfg, imgs)
        torch.cuda.synchronize()
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            inference_detector(model, cfg, imgs)
        torch.cuda.synchronize()
        e2e = (time.perf_counter() - t0) / iters / bsz * 1e3
        images, img_hw, _ = prepare_batch(cfg, imgs, DEVICE)
        with torch.inference_mode():
            fwd = cuda_ms(lambda: model(images, img_hw), iters=iters,
                          warmup=1) / bsz
        out[bsz] = (e2e, fwd)
    return out


def time_train(state, step, teacher, batch, iters=5):
    """ms/step and img/s of the train step, host clock around synchronized
    steps (the previous runs warmed it up)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, losses = step(state, batch, teacher)
    float(losses["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    return ms, B / ms * 1e3


def profile(fn, what):
    """Device time by kernel over one call of ``fn`` (the 15 largest and
    the port's own kernels), and the device's idle share of its wall time
    (one stream: kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_events(prof)
    busy = sum(e.self_device_time_total for e in kernels)
    print(f"profile: {what} under the profiler: wall {wall_us / 1e3:.3f} "
          f"ms, device busy {busy / 1e3:.3f} ms, idle share "
          f"{1 - busy / wall_us:.3f}, {sum(e.count for e in kernels)} kernel "
          f"launches of {len(kernels)} kernels")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the 15 largest, then the port's own kernels among the others
    port = [e for e in ranked[15:] if any(n in e.key for n in counters())]
    for e in ranked[:15] + port:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.self_device_time_total / busy:6.1%} x{e.count:<5d} "
              f"{e.key[:100]}")


def report_kernel_times(card, gen):
    """Time every kernel (phase 7) and print each timing beside its plain
    twin, library call, bound and, for a backward, its add rate. Returns
    the timings of time_kernels, time_sampling_kernels and
    time_window_kernels."""
    print(f"times on {card}, device ms (device_ms; a backward's rate: its "
          f"f32 adds into dtable, one per in-range sample element, over its "
          f"kernel time):")
    ktimes, kbounds, kadds = time_kernels(gen)
    for name, (k_ms, p_ms, l_ms) in ktimes.items():
        b_ms, rate = kbounds.get(name), adds_rate(kadds.get(name), k_ms)
        lib = "" if l_ms is None else f", embedding_bag {l_ms:.4f} ms"
        print(f"  {name}: kernel {k_ms:.4f} ms{rate}, plain twin "
              f"{p_ms:.4f} ms{lib} (B={B})"
              + (f", bound {b_ms[0]:.4f} ms ({b_ms[1]})" if b_ms else ""))
    sampling = time_sampling_kernels(gen)
    for name, (k_ms, p_ms, l_ms, (b_ms, by), n_adds) in sampling.items():
        lib = "" if l_ms is None else f", library call {l_ms:.4f} ms"
        print(f"  {name} (640x480, Q={Q_TRAIN}, B={B}): kernel {k_ms:.4f} "
              f"ms{adds_rate(n_adds, k_ms)}, plain twin {p_ms:.4f} ms{lib}, "
              f"bound {b_ms:.4f} ms ({by})")
    wtimes = time_window_kernels(gen)
    for name, (k_ms, p_ms, l_ms, (b_ms, by), n_adds) in wtimes.items():
        plain = "" if p_ms is None else f", plain twin {p_ms:.4f} ms"
        lib = "" if l_ms is None else f", library call {l_ms:.4f} ms"
        print(f"  {name} (B={B}): kernel {k_ms:.4f} ms"
              f"{adds_rate(n_adds, k_ms)}{plain}{lib}, bound {b_ms:.4f} ms "
              f"({by})")
    return ktimes, kbounds, sampling, wtimes


def ptxas(log):
    """'kernel: registers, spills' of each entry function in a ptxas -v
    report."""
    out, name, spills = [], "?", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "spill stores" in ln:
            spills = ln.strip().split(", ", 1)[-1]
        elif "Used" in ln and "registers" in ln:
            regs = ln.split("Used", 1)[1].split(",")[0].strip()
            out.append(f"{name}: {regs}, {spills}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and convolutions: every f32 comparison and "
          "time below is full f32")

    for k in SWITCH_VARS:
        if os.environ.pop(k, None) is not None:
            print(f"{k} was set; unset it: the default path comes first")

    from dskd_tpu_torch.apis.inference import prepare_batch
    from dskd_tpu_torch.ops import _build
    from dskd_tpu_torch.ops import fused_sample, mxu_gather, pack_kernel, \
        window
    t0 = time.perf_counter()
    sources = {"pack_corners": pack_kernel._SIGNATURES,
               "gather_weighted": mxu_gather._SIGNATURES,
               "gather_weighted_bwd": mxu_gather._BWD_SIGNATURES,
               "mxu_gather": mxu_gather.MXU_GATHER_SIGNATURES,
               "fused_sample": fused_sample.SIGNATURES,
               "window_sample": window.SIGNATURES}
    _build.build(list(sources))
    for name, signatures in sources.items():
        _build.load(name, signatures)
    print(f"build: {len(sources)} sources in {time.perf_counter() - t0:.2f} "
          f"s")
    for name, (secs, log) in _build.BUILD_LOG.items():
        print(f"build: {name} nvcc {secs:.2f} s; {'; '.join(ptxas(log))}")

    gen = torch.Generator().manual_seed(0)
    err = check_kernels(gen)
    print(f"kernels: match their twins on the card (f32 {F32_TOL}, bf16 "
          f"{BF16_TOL}, dtable {DTABLE_TOL} / {DTABLE_BF16_TOL}); max abs "
          f"err {err}")
    serr = check_sampling_kernels(gen)
    print(f"kernels: mxu_gather (bit for bit) and fused_sample match their "
          f"twins on the card, forward and backward, with the same "
          f"tolerances; max abs err {serr}")
    gerr = check_msda_grads(gen)
    print(f"kernels: ms_deform_attn_core gradients on the card vs the plain "
          f"twins, max abs err {gerr} (tolerance {MSDA_GRAD_TOL})")
    werr = check_window_kernels(gen)
    print(f"kernels: window_gather (bit for bit), fused_window and "
          f"window_weighted_bwd match their twins on the card, with the same "
          f"tolerances; max abs err {werr}")
    wgerr = check_window_grads(gen)
    print(f"kernels: ms_deform_attn_core gradients under the windowed "
          f"switches on the card vs the plain twins, max abs err {wgerr} "
          f"(tolerance rtol {MSDA_GRAD_TOL['rtol']}, atol "
          f"{WINDOW_GRAD_TOL} x each tensor's max)")

    rng = np.random.RandomState(0)
    shapes = [(480, 640), (427, 640), (640, 512), (512, 683)]
    imgs = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in shapes]
    model, cfg = check_slice(imgs[:3])
    for switch in SERVE_SWITCHES:
        check_serve_switch(model, cfg, imgs[:3], switch)

    state32, step32, teacher32, batch, launches = run_train(
        cfg, torch.float32, 3, "f32")
    print(f"train f32: launches over the 3 steps {launches}")
    check_train_card_vs_cpu(cfg)
    state16, step16, teacher16, _, _ = run_train(cfg, torch.bfloat16, 3,
                                                 "bf16")
    switch_states = {}
    for switch, env in TRAIN_SWITCHES.items():
        with switched(env):
            st, sp, tch, sw_batch, n = run_train(cfg, torch.float32, 2,
                                                 f"f32 {switch}", switch)
            switch_states[switch] = (st, sp, tch, sw_batch)
            print(f"train f32 {switch} {env}: launches over the 2 steps {n}")
            for k in ("mxu_gather", "mxu_gather_bwd", "fused_sample",
                      "fused_sample_bwd", *WINDOW_KERNELS):
                launches[k] = launches.get(k, 0) + n[k]
            # two steps: after one bf16 step from the init, some head
            # parameters still have a zero gradient and have not moved
            run_train(cfg, torch.bfloat16, 2, f"bf16 {switch}", switch)
        check_train_switch_vs_default(cfg, switch)

    ktimes, kbounds, sampling, wtimes = report_kernel_times(card, gen)
    stimes = time_slice(model, cfg, {1: imgs[:1], 4: imgs})
    for bsz, (e2e, fwd) in stimes.items():
        print(f"  serve B={bsz}: inference_detector {e2e:.3f} ms/image, "
              f"model forward {fwd:.3f} ms/image (f32)")
    for tag, (st, sp, tch) in (("f32", (state32, step32, teacher32)),
                               ("bf16", (state16, step16, teacher16))):
        ms, img_s = time_train(st, sp, tch, batch)
        print(f"  train {tag} B={B} {TRAIN_HW[0]}x{TRAIN_HW[1]}: "
              f"{ms:.3f} ms/step, {img_s:.3f} img/s")
    for switch, (st, sp, tch, sw_batch) in switch_states.items():
        with switched(TRAIN_SWITCHES[switch]):
            ms, img_s = time_train(st, sp, tch, sw_batch)
        h, w = TRAIN_CANVAS.get(switch, TRAIN_HW)
        print(f"  train f32 {switch} {TRAIN_SWITCHES[switch]} B={B} "
              f"{h}x{w}: {ms:.3f} ms/step, {img_s:.3f} img/s")
    images, img_hw, _ = prepare_batch(cfg, imgs, DEVICE)
    with torch.inference_mode():
        profile(lambda: model(images, img_hw),
                f"one B={len(imgs)} serving forward (f32)")
    profile(lambda: step16(state16, batch, teacher16),
            f"one B={B} bf16 train step")

    bwd_key = f"gather_weighted_bwd f32 Q={Q_TRAIN} 640x480"
    gw_key = f"gather_weighted f32 Q={Q_ENC}"

    def entry(name, source, replaces, max_abs_err, ms, plain_ms, library_ms,
              bound_ms):
        return {"name": name, "route": "cuda",
                "source": f"dskd_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms[0], "bound_by": bound_ms[1],
                "library_ms": library_ms}

    def sampled(name, source, replaces, max_abs_err, times=sampling):
        k_ms, p_ms, l_ms, b, _ = times[f"{name} f32"]
        return entry(name, source, replaces, max_abs_err, k_ms, p_ms, l_ms,
                     b)

    report = {"kernels": [
        entry("pack_corners", "pack_corners.cu",
              "dskd_tpu/ops/pack_kernel.py:45", err["pack_corners"],
              *ktimes["pack_corners f32"], kbounds["pack_corners f32"]),
        entry("gather_weighted", "gather_weighted.cu",
              "dskd_tpu/ops/mxu_gather.py:140", err["gather_weighted"],
              *ktimes[gw_key], kbounds[gw_key]),
        entry("gather_weighted_bwd", "gather_weighted_bwd.cu",
              "dskd_tpu/ops/mxu_gather.py:155",
              max(err["dtable"], err["dw"]), *ktimes[bwd_key],
              kbounds[bwd_key]),
        sampled("mxu_gather", "mxu_gather.cu",
                "dskd_tpu/ops/mxu_gather.py:25", serr["mxu_gather"]),
        sampled("mxu_gather_bwd", "mxu_gather.cu",
                "dskd_tpu/ops/mxu_gather.py:36", serr["mxu_gather_bwd"]),
        sampled("fused_sample", "fused_sample.cu",
                "dskd_tpu/ops/fused_sample.py:29", serr["fused_sample"]),
        sampled("fused_sample_bwd", "fused_sample.cu",
                "dskd_tpu/ops/fused_sample.py:45",
                max(serr["fused_sample_bwd"], serr["fused_sample_dw"])),
        sampled("window_gather", "window_sample.cu",
                "dskd_tpu/ops/window_gather.py:115", werr["window_gather"],
                wtimes),
        sampled("window_gather_bwd", "window_sample.cu",
                "dskd_tpu/ops/window_gather.py:138",
                werr["window_gather_bwd"], wtimes),
        # gather_weighted's kernel with an escape count
        sampled("fused_window", "gather_weighted.cu",
                "dskd_tpu/ops/fused_window.py:146", werr["fused_window"],
                wtimes),
        # one kernel for the two layouts of one function: B1''s scatter
        # with an escape count
        sampled("window_weighted_bwd", "gather_weighted_bwd.cu",
                "dskd_tpu/ops/fused_window.py:170 and "
                "dskd_tpu/ops/window_bwd.py:113",
                max(werr["window_weighted_bwd"],
                    werr["window_weighted_bwd_dw"]), wtimes)]}
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

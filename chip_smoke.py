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
     then starts phase 8's forgetting A/B in its child processes, which run
     beside phases 3-7 (so phase 7's ms are taken beside them);
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
  7. incremental: the incremental training loop end to end
     (dskd_tpu_torch.train.incremental.run_incremental through the
     train_increment CLI's config path) on a synthetic COCO written with PIL
     (24 train images, half 480x640 and half 640x480, 8 val images, 2-8
     boxes each over all 80 classes): the flagship config at full width and
     depth, f32, two tasks of the 40+40 split of 4 steps each at B=2 on both
     aspect canvases, loaded by two spawned workers, each task followed by
     COCO eval on the 640x640 canvas and a checkpoint; every step's launches
     held to expected_launches, ms/step, eval ms/image (each eval run
     twice on its loader, timed again once the workers are up), the val
     rows, the train loader alone for two epochs (ms/batch, the first with
     its workers starting), and the task-2 checkpoint restored by
     init_detector to the final model's detections bit for bit; each number
     beside the card's name and power limit;
  8. distill menu: the forgetting A/B's results, collected first (so that
     this phase's own timings run alone; below); every distill branch
     beyond the flagship's corr + decode_v1, in four configs
     (DISTILL_MENU: soft + ld_bbox + ld_logit + kldv + memory; corr +
     sg_out with the pre-merge GT; fg_only and decode_v2 with
     fix_fg_grad_direction), each in full-width f32 steps
     (dropout 0, launches held to expected_launches, loss keys and ms/step)
     and at 2+2 layers against the CPU; one full-width step with the
     exact JV matcher (its C++ solve's total cost against the plain
     lap_jv twin and not above the auction's on the same cost stacks,
     with the host ms of its solves beside the auction's). The forgetting
     A/B is dskd_tpu_torch/tools/ab_forgetting.py at the 400/600 horizon
     (ResNet-18, 1+1 layers, 128x128) for 8 initial-weight seeds at once,
     each a dskd_tpu_torch.tools.sweep_forgetting process: each seed's old
     / new mAP and ms/step per phase, then the mean over the seeds held to
     tests/test_forgetting_ab.py's margins, and the wall time from their
     start, each beside the card's name and power limit;
  9. times: kernels against twins (and against one PyTorch library call
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
     step;
 10. detr-il: the DETR-IL family (configs/detr_40_40_il.py: ResNet-50, 6+6
     full-attention layers, 100 queries, 80 classes, seeded weights, f32)
     through the port's family registry, which launches none of the
     port's kernels (every count held at 0): the registry's eval step at
     B=1 and B=8 on the 640x640 canvas with images of four aspect ratios
     (finite outputs; the last layer's head outputs against the CPU;
     ms/image); three family steps at B=8 with a frozen teacher ("hard +
     soft" + "kldv", exact JV on the 100 queries x 132 merged GT) and
     dropout 0.1 (ms/step, img/s, the host ms of the JV solves), a profile
     of one step, one 2+2-layer step against the CPU (losses and four named
     gradients); and the train_increment path for two tasks of 4 steps at
     B=2 with COCO eval after each and the task-2 checkpoint restored by
     init_detector, through the registry's eval step, bit for bit;
 11. yolof-il: the YOLOF-IL family (configs/yolof_40_40_il.py: caffe-style
     ResNet-50, DilatedEncoder, 5 anchors per position, 80 classes, seeded
     weights, f32) through the same family check as phase 10, which
     launches none of the port's kernels: serving at B=1 and B=8 (the head
     outputs against the CPU), three B=8 family steps with a frozen teacher
     that keeps 100 detections per image above 0.3 ("hard + soft", "bbox",
     "kldv"; GT padded to 100), their ms/step, img/s, profile and peak
     memory, the teacher's candidates and NMS survivors with the NMS's
     tiled keep mask held to the plain scan's, the closed-form loss_kd
     against the literal (N, N) product at B=2, a full-depth B=2 step
     against the CPU in f32 and in f64 (losses, four named gradients and
     every BatchNorm running buffer; in f32 the two neck gradients within
     THREAD_SPREAD_TOL, which the CPU's spread between its thread counts
     sets), and the
     two-task train_increment path, whose task-2 teacher carries task 1's
     final running buffers and whose task-2 checkpoint restores, buffers
     included, bit for bit;
 12. yoloy-il: the same for YOLOY-IL (configs/yoloy_40_40_il.py: ResNet-18,
     PAFPN, decoupled head at strides 8-32, 80 classes, "hard + soft" and
     "kldv"; the (N, N) product at B=2 takes 1.1 GB);
 13. deformable-detr: vanilla Deformable DETR (ResNet-50, 6+6 MSDA layers,
     300 queries, 80 classes, seeded weights, f32) through the same family
     check on its configs' 800x1344 canvas, each run held to 48 launches
     of gather_weighted and pack_corners a forward and 48 of
     gather_weighted_bwd a step: the two-stage config (box refinement and
     two-stage) served at B=1 and B=2 and stepped at B=2 with a profile,
     the peak memory and the host ms of its JV solves (decoder layers apart
     from the encoder proposals), a 2+2-layer step against the CPU, the
     proposals' top-k against the CPU on real logits, and the two-task
     train_increment path; the base and refine configs served at B=1,
     stepped once and held to the CPU at 2+2 layers;
 14. dense: the dense single-stage families GFL, RetinaNet, ATSS and FCOS
     (configs/{gfl,retinanet,atss,fcos}_r50_1x.py: ResNet-50, FPN-256
     P3-P7, 4-conv towers, 80 classes, seeded weights, f32), which launch
     none of the port's kernels, through the same family check on the
     configs' 800x1344 canvas: served at B=1 and B=2 (the head outputs
     against the CPU), three B=2 steps with GT padded to 100, a profile
     and the peak memory; the family's assignment (max-IoU, ATSS or FCOS's
     targets) on the training batch equal to the CPU's, and the per-level
     top-k and NMS survivors of a model whose scores pass 0.05 against the
     CPU's where the CPU's scores stand apart; a B=2 step against the CPU
     on 384x640 (losses and named gradients); the two-task train_increment
     path for GFL.
 15. variants: LD, PAA, LAD and the RetinaNet variants PISA, GHM, FPG and
     NAS-FPN (their stacks cut to VARIANT_STACKS) through the same family
     check, each with its own checks.
 16. dcn: deform_conv2d (plain PyTorch: one gather of the four corners'
     rows, a batched 1 x 4 matmul and the taps' matmul) on the
     card against the CPU at DyHead's P3 shape of 800x1344, v1 and v2,
     stride 1 and 2, offsets zero and a few pixels off, taps outside the
     map, forward and gradients; then ATSS-DyHead, NAS-FCOS, VFNet and
     RepPoints (their 1x configs: ResNet-50 at full width, six DyHead
     blocks, 80 classes, seeded weights, f32) through the same family check
     on 800x1344 at B=2: serving at B=1 and B=2, three steps, a profile,
     the peak memory, the assignment (ATSS, FCOS's targets, the point and
     refine max-IoU) and the decode against the CPU, the deformable convs'
     share of the forward + backward's device time, a step against the CPU
     on 384x640 (ATSS-DyHead's also with its offset convs redrawn), and
     none of the port's kernels launched over the phase.
 17. heads: TOOD, FSAF, FoveaBox, AutoAssign, FreeAnchor and SABL-RetinaNet
     (their 1x configs: ResNet-50, FPN-256 P3-P7, full heads, 80 classes,
     seeded weights, f32) through the same family check on 800x1344 at
     B=2, each with its own assignment or targets against the CPU (TOOD's
     task-aligned positives and its per-corner sampling with gradients,
     FreeAnchor's 50-anchor bags and P(anchor in A+), SABL's approx-max-IoU
     assignment and bucket targets, FSAF's level per GT, FoveaBox's labels
     per level, AutoAssign's negative weights and centre-prior
     gradients), and none of the port's kernels launched over the phase.
 18. zoo: RetinaNet on RegNetX-3.2GF, PVT-tiny (B=2, 800x1344) and
     EfficientNet-B3 (B=4, 896x896), FCOS on HRNetV2p-W18 + HRFPN (B=2,
     800x1344), YOLOX-s (B=8, 640x640), YOLOv3 on Darknet-53 (B=8,
     608x608) and MobileNetV2 (B=8, 416x416) and CenterNet R18 (B=16,
     512x512), each at its config's full width and depth through the same
     family check, with its own assignment or targets and decode against
     the CPU (EfficientNet's step also in f64), and none of the port's
     kernels launched over the phase.
Phases 10-18 take the CPU sides of their comparisons against the CPU (the
serving heads and the steps, GHM's and NAS-FPN's three steps of phase 15
too) from two spawned worker processes, queued at phase 10's start; they
stop while the script times the card or the host.
The last three lines are the card, the kernel report as JSON and the
result as JSON.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import signal
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
# gradients, card vs CPU: ||g_card - g_cpu|| / ||g_cpu||; in f64 the same
# function on both devices parts by f64 rounding alone
GRAD_REL_TOL = 1e-3
F64_GRAD_REL_TOL = 1e-8
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
    with card_alone():
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
    with card_alone():
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


DeviceEvent = collections.namedtuple("DeviceEvent",
                                     "key count self_device_time_total")


def device_events(prof):
    """The kernels and copies of a profile, by name: each name's launches
    and device us. Read from the profiler's raw events, as key_averages()
    sums them, without building an event for every host op first (seconds
    for one step's trace)."""
    totals = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                e.is_user_annotation():
            continue
        n, us = totals.get(e.name(), (0, 0.0))
        totals[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    return [DeviceEvent(k, n, us) for k, (n, us) in totals.items()]


def device_busy_us(prof):
    """The device's busy us over a profile: the union of its kernels' and
    copies' intervals, so that kernels running at once on other streams
    (cuDNN's and cuFFT's engines) count once."""
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation())
    busy, end = 0, None
    for lo, hi in spans:
        if end is None or lo > end:
            busy, end = busy + hi - lo, hi
        elif hi > end:
            busy, end = busy + hi - end, hi
    return busy / 1e3


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


# families whose step reads no teacher: JAX's deformable_detr losses
# ignore the task-2 teacher its driver passes
TEACHERLESS = ("deformable_detr", "retinanet", "atss", "gfl", "fcos", "paa",
               "pisa_retinanet", "retinanet_ghm", "retinanet_fpg",
               "retinanet_nasfpn", "nasfcos", "vfnet", "reppoints")


def path_launches(cfg, forwards, backwards=0):
    """The kernels' launches on the default path of ``cfg``'s family:
    model_launches for the MSDA families (the flagship, Deformable DETR);
    none for a family without MSDA (DETR-IL, YOLOF-IL, YOLOY-IL and the
    dense single-stage families)."""
    from dskd_tpu_torch.models.detector import FLAGSHIP_ARCHS

    if cfg.model.arch in FLAGSHIP_ARCHS + ("deformable_detr",):
        return model_launches("default", cfg, forwards, backwards)
    return dict.fromkeys(counters(), 0)


def step_launches(cfg, has_teacher):
    """path_launches of one family step: the teacher's forward where the
    family reads it, the student's forward and its backward."""
    teacher = has_teacher and cfg.model.arch not in TEACHERLESS
    return path_launches(cfg, 2 if teacher else 1, 1)


@contextlib.contextmanager
def timed_jv(solves):
    """Append (cost, columns, host ms) of every C++ JV solve to ``solves``
    (the cost copied to the host, the solve and the copy back)."""
    from dskd_tpu_torch.core import matching

    native = matching.lap_jv_native

    def timed(cost):
        t0 = time.perf_counter()
        cols = native(cost)
        solves.append((cost, cols, (time.perf_counter() - t0) * 1e3))
        return cols

    matching.lap_jv_native = timed
    try:
        yield solves
    finally:
        matching.lap_jv_native = native


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


def cpu_slice_heads(cfg, images, img_hw):
    """The last layer's head outputs of the flagship's seed-0 model on the
    CPU (the plain twins)."""
    from dskd_tpu_torch.apis.inference import init_detector

    cpu_model, _ = init_detector(cfg, device="cpu", seed=0)
    with torch.inference_mode():
        ref = cpu_model(images, img_hw).head
    return {name: getattr(ref, name)[-1] for name in ("cls_scores",
                                                      "bbox_preds")}


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
    with torch.inference_mode():
        out = model(images, img_hw).head
    ref = cpu_result(cpu_slice_heads, cfg, images.cpu(), img_hw.cpu())
    errs = {}
    for name in ("cls_scores", "bbox_preds"):
        got, want = getattr(out, name)[-1].cpu(), ref[name]
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


def train_state(cfg, student):
    """The TrainState of ``student`` with ``cfg.train``'s optimizer (clip,
    AdamW, the step schedule over epochs of 1000 steps), dropout seed 1."""
    from dskd_tpu_torch.train.optim import make_optimizer
    from dskd_tpu_torch.train.schedule import step_lr_schedule
    from dskd_tpu_torch.train.state import TrainState

    t = cfg.train
    sched = step_lr_schedule(t.base_lr, t.warmup_iters, t.warmup_ratio,
                             t.step_epochs, iters_per_epoch=1000)
    return TrainState.create(student, make_optimizer(
        student, sched, weight_decay=t.weight_decay, max_norm=t.grad_clip,
        frozen_stages=cfg.model.frozen_stages), seed=1)


def train_setup(cfg, student, compute_dtype, dcfg=None, matcher="auction"):
    """(state, step, det_cfg, dcfg) of the flagship step; ``dcfg`` replaces
    the config's corr + decode_v1 distills, ``matcher`` the auction."""
    from dskd_tpu_torch.distill.losses import DistillConfig
    from dskd_tpu_torch.models.gfl_detr_loss import DetLossConfig
    from dskd_tpu_torch.train.step import make_train_step

    state = train_state(cfg, student)
    det_cfg = DetLossConfig(num_classes=cfg.model.num_classes,
                            reg_max=cfg.model.reg_max, matcher=matcher)
    if dcfg is None:
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


def flagship_step(cfg, dcfg, device, tinfo=None, assigned=None):
    """One flagship step at full width with 2+2 layers, f32, dropout 0, on
    ``device`` (MSDA kernels redrawn, seed 3), with the config's distills
    or ``dcfg``'s, under the teacher info ``tinfo`` and the assignment
    ``assigned`` where given: (teacher info, targets, losses, the
    gradients of GRAD_PARAMS on the CPU)."""
    from dskd_tpu_torch.train.step import compute_losses, parse_losses, \
        teacher_info

    small = dict(num_encoder_layers=2, num_decoder_layers=2, dropout=0.0)
    model, tmodel = build_models(cfg, device, **small)
    random_msda_kernels(model, seed=3)
    _, _, det_cfg, dcfg = train_setup(cfg, model, torch.float32, dcfg)
    thr, kmax = cfg.distill.teacher_score_thr, cfg.distill.teacher_max_per_img
    b = train_batch(device)
    model.train()
    if tinfo is None:
        tinfo = teacher_info(tmodel, b, det_cfg, thr, kmax)
    losses, targets = compute_losses(model, b, det_cfg, tinfo, dcfg,
                                     assigned=assigned)
    parse_losses(losses).backward()
    params = dict(model.named_parameters())
    grads = {n: params[n].grad.detach().cpu() for n in GRAD_PARAMS}
    return tinfo, targets, losses, grads


def cpu_flagship_step(cfg, dcfg):
    """flagship_step on the CPU: what check_train_card_vs_cpu reads of it,
    the teacher's keep_qid and valid, the assignment, losses, gradients."""
    tinfo, targets, losses, grads = flagship_step(cfg, dcfg, "cpu")
    return {"teacher": list(tinfo.det[4:]), "assigned": targets.assigned_gt,
            "losses": {k: v.detach() for k, v in losses.items()},
            "grads": grads}


def check_train_card_vs_cpu(cfg, dcfg=None, tag="train"):
    """One step at full width with 2+2 layers, f32, dropout 0: every loss
    key and the gradients of GRAD_PARAMS, card against CPU (flagship_step;
    the CPU's from the CPU worker), with the config's distills or
    ``dcfg``'s."""
    tinfo, targets, losses, grads = flagship_step(cfg, dcfg, DEVICE)
    cpu = cpu_result(cpu_flagship_step, cfg, dcfg)
    c_losses, c_grads = cpu["losses"], cpu["grads"]
    same_teacher = all(torch.equal(a.cpu(), b) for a, b in zip(
        tinfo.det[4:], cpu["teacher"]))            # keep_qid, valid
    same_assign = torch.equal(targets.assigned_gt.cpu(), cpu["assigned"])
    print(f"{tag} card vs CPU (2+2 layers): teacher kept "
          f"{int(tinfo.det.valid.sum())} detections, same on both devices: "
          f"{same_teacher}; same auction assignments: {same_assign}")
    if not (same_teacher and same_assign):
        print(f"{tag} card vs CPU: the devices differ at near-ties; the CPU "
              "losses are recomputed under the card's teacher and "
              "assignments")
        _, _, c_losses, c_grads = flagship_step(
            cfg, dcfg, "cpu", _to_cpu(tinfo),
            (_to_cpu(targets), losses["auction_fallback"].cpu()))
    loss_err = {}
    for k, v in c_losses.items():
        got = losses[k].detach().cpu()
        torch.testing.assert_close(got, v.detach(), **LOSS_TOL, msg=k)
        loss_err[k] = float((got - v.detach()).abs())
    print(f"{tag} card vs CPU: {len(loss_err)} loss keys within {LOSS_TOL}, "
          f"largest abs err {max(loss_err.values()):.3e} "
          f"({max(loss_err, key=loss_err.get)})")
    grad_err, bad = {}, {}
    for n in GRAD_PARAMS:
        ref, diff = c_grads[n], grads[n] - c_grads[n]
        rel = float(diff.norm() / ref.norm())
        grad_err[n] = rel
        if not rel <= GRAD_REL_TOL:
            bad[n] = rel
        print(f"{tag} card vs CPU: grad {n}: relative L2 err {rel:.3e} "
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


def profile(fn, what, top=15):
    """Device time by kernel over one call of ``fn`` (the ``top`` largest
    and the port's own kernels, each with its share of the kernels' summed
    time), and the device's idle share of its wall time (device_busy_us:
    kernels that overlap count once); returns the device busy ms."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    with card_alone():
        fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_events(prof)
    summed = sum(e.self_device_time_total for e in kernels)
    busy = device_busy_us(prof)
    print(f"profile: {what} under the profiler: wall {wall_us / 1e3:.3f} "
          f"ms, device busy {busy / 1e3:.3f} ms (kernels summed "
          f"{summed / 1e3:.3f}), idle share "
          f"{1 - busy / wall_us:.3f}, {sum(e.count for e in kernels)} kernel "
          f"launches of {len(kernels)} kernels")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the largest, then the port's own kernels among the others
    port = [e for e in ranked[top:] if any(n in e.key for n in counters())]
    for e in ranked[:top] + port:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.self_device_time_total / summed:6.1%} x{e.count:<5d} "
              f"{e.key[:100]}")
    return busy / 1e3


def report_kernel_times(card, gen):
    """Time every kernel (phase 9) and print each timing beside its plain
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


# --- incremental ---------------------------------------------------------

# the synthetic COCO of the incremental phase: (h, w) of each image, half
# landscape and half portrait, so both aspect canvases train
INC_TRAIN_SHAPES = ((480, 640), (640, 480)) * 12
INC_VAL_SHAPES = ((480, 640), (640, 480)) * 4
INC_SETS = ("data.samples_per_device=2", "data.num_workers=2",
            "train.max_iters_per_task=4", "train.eval_interval=1",
            "train.log_interval=1")


def write_coco(root, split, shapes, cat_ids, seed, n_boxes=(2, 8)):
    """A COCO-format split under ``root``: one PNG (written by PIL) per
    (h, w) of ``shapes``, uint8 noise with ``n_boxes`` filled rectangles,
    which are its GT boxes; their classes cycle through ``cat_ids``.
    Returns (annotation file, image directory)."""
    from PIL import Image

    from dskd_tpu_torch.data.coco import COCO_CLASSES_MMDET_ORDER

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, split)
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate(shapes):
        arr = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for _ in range(rng.randint(n_boxes[0], n_boxes[1] + 1)):
            bw, bh = rng.randint(w // 10, w // 2), rng.randint(h // 10, h // 2)
            x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
            arr[y:y + bh, x:x + bw] = rng.randint(0, 256, 3)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(cat_ids[len(anns) % len(cat_ids)]),
                         "bbox": [int(x), int(y), int(bw), int(bh)],
                         "area": int(bw * bh), "iscrowd": 0})
        name = f"{split}_{i:04d}.png"
        Image.fromarray(arr).save(os.path.join(img_dir, name))
        images.append({"id": i + 1, "file_name": name, "height": h,
                       "width": w})
    ann_file = os.path.join(root, f"{split}.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [
            {"id": cid, "name": n} for n, cid in COCO_CLASSES_MMDET_ORDER]},
            f)
    return ann_file, img_dir


def check_incremental(card, config=CONFIG, sets=(),
                      train_shapes=INC_TRAIN_SHAPES,
                      val_shapes=INC_VAL_SHAPES):
    """The incremental training loop end to end, through the CLI's config path
    (``--set`` overrides) and ``run_incremental``: two tasks of the 40+40
    split, each of ``max_iters_per_task`` steps on both aspect canvases
    followed by COCO eval, with checkpoints. Checks each step's launches,
    the val rows and the checkpoint, which ``init_detector`` restores to
    the in-memory model's detections bit for bit. Returns the launches of
    the whole run."""
    import tempfile

    from dskd_tpu_torch.apis.inference import init_detector, prepare_batch
    from dskd_tpu_torch.data.coco import COCO_CLASSES_ALPHA_ORDER
    from dskd_tpu_torch.data.loader import DataLoader
    from dskd_tpu_torch.data.pipeline import load_image
    from dskd_tpu_torch.eval import evaluator
    from dskd_tpu_torch.tools.train_increment import build_parser, \
        config_from_args
    from dskd_tpu_torch.train import family, incremental

    steps, evals, teachers = [], [], []
    make_step, evaluate = family.make_family_train_step, evaluator.evaluate

    def counted_step(arch, model, cfg, num_prev, has_teacher, **kw):
        want = step_launches(cfg, has_teacher)
        step = make_step(arch, model, cfg, num_prev, has_teacher, **kw)

        def run(state, batch, teacher=None):
            if teacher is not None and not teachers:
                # the buffers it starts the task with
                teachers.append({k: v.clone() for k, v in
                                 teacher.state_dict().items()})
            start = read_counts()
            t0 = time.perf_counter()
            state, losses = step(state, batch, teacher)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            now = read_counts()
            per_step = {k: now[k] - start[k] for k in now}
            if per_step != want:
                raise AssertionError(f"incremental: launches per step "
                                     f"{per_step}, expected {want}")
            steps.append((num_prev, tuple(batch.images.shape[1:3]), ms))
            return state, losses
        return run

    def counted_evaluate(model, dataset, loader, **kw):
        # the first pass starts the val loader's workers; a second pass over
        # the same loader, once they are up, times the eval's own cost
        ms = []
        for _ in range(2):
            start = read_counts()
            t0 = time.perf_counter()
            stats = evaluate(model, dataset, loader, **kw)
            ms.append((time.perf_counter() - t0) * 1e3)
            now = read_counts()
            launched = {k: now[k] - start[k] for k in now}
            want = path_launches(cfg, len(loader))
            if launched != want:
                raise AssertionError(f"incremental: eval launches "
                                     f"{launched}, expected {want}")
        evals.append((len(dataset), *ms))
        return stats

    with tempfile.TemporaryDirectory() as root:
        cats = [cid for _, cid in COCO_CLASSES_ALPHA_ORDER]
        train_ann, train_dir = write_coco(root, "train", train_shapes, cats,
                                          seed=0)
        val_ann, val_dir = write_coco(root, "val", val_shapes, cats, seed=1)
        work = os.path.join(root, "work")
        args = build_parser().parse_args([
            config, "--work-dir", work, "--seed", "0", "--set",
            f"data.train_ann={train_ann}", f"data.val_ann={val_ann}",
            f"data.train_img_prefix={train_dir}",
            f"data.val_img_prefix={val_dir}", *INC_SETS, *sets])
        cfg = config_from_args(args)
        family.make_family_train_step = counted_step
        evaluator.evaluate = counted_evaluate
        t0 = time.perf_counter()
        try:
            reset_counts()
            model = incremental.run_incremental(cfg, device=DEVICE)
            launches = read_counts()
        finally:
            family.make_family_train_step = make_step
            evaluator.evaluate = evaluate
        wall = time.perf_counter() - t0
        rows = [json.loads(line) for name in sorted(os.listdir(work))
                if name.endswith(".log.json")
                for line in open(os.path.join(work, name))]

        for task, num_prev in ((1, 0), (2, cfg.data.catsplit[0])):
            ms = [t for n, _, t in steps if n == num_prev]
            canvases = sorted({hw for n, hw, _ in steps if n == num_prev})
            train = [r for r in rows if r["mode"] == "train"
                     and r["task"] == task]
            val = [r for r in rows if r["mode"] == "val" and r["task"] == task]
            if len(ms) != cfg.train.max_iters_per_task or \
                    len(train) != len(ms) or len(val) != 1:
                raise AssertionError(f"incremental: task {task}: {len(ms)} "
                                     f"steps, {len(train)} train rows, "
                                     f"{len(val)} val rows")
            if not all(np.isfinite(r["loss"]) for r in train) or \
                    not 0.0 <= val[0]["bbox_mAP"] <= 1.0:
                raise AssertionError(f"incremental: task {task} rows "
                                     f"{train} {val}")
            n_img, first_ms, ev_ms = evals[task - 1]
            print(f"incremental: task {task} (num_prev {num_prev}): "
                  f"{len(ms)} steps on canvases {canvases}, ms/step "
                  f"{[round(t, 3) for t in ms]} (host clock around "
                  f"synchronised steps; mean of steps 2-{len(ms)} "
                  f"{np.mean(ms[1:]):.3f}) [{card}]")
            print(f"incremental: task {task} eval {n_img} images in "
                  f"{ev_ms:.3f} ms with the workers up, {ev_ms / n_img:.3f} "
                  f"ms/image; the first pass, which starts the workers, "
                  f"{first_ms:.3f} ms; val row bbox_mAP "
                  f"{val[0]['bbox_mAP']} bbox_mAP_50 "
                  f"{val[0]['bbox_mAP_50']} [{card}]")
            seen = sorted({hw for _, hw, _ in steps})
        if cfg.data.aspect_buckets and \
                seen != sorted(map(tuple, cfg.data.aspect_buckets)):
            raise AssertionError(f"incremental: trained on canvases {seen}")
        print(f"incremental: launches over the run {launches} (every step "
              f"held to expected_launches); run_incremental {wall:.3f} s "
              f"[{card}]")

        # the train loader alone: task 1's batches, two epochs (the first
        # includes starting the workers)
        train_ds, _ = incremental.make_datasets(cfg, 1,
                                                len(cfg.data.catsplit))
        loader = DataLoader(train_ds, cfg.data.samples_per_device,
                            incremental.pipeline_config(cfg), train=True,
                            num_workers=cfg.data.num_workers,
                            aspect_buckets=cfg.data.aspect_buckets,
                            gt_buckets=cfg.data.gt_buckets,
                            pin_memory=DEVICE == "cuda")
        try:
            for epoch in range(2):
                t0 = time.perf_counter()
                n = sum(1 for _ in loader)
                ms = (time.perf_counter() - t0) * 1e3
                print(f"incremental: train loader epoch {epoch}: {n} batches "
                      f"of {cfg.data.samples_per_device} in {ms:.3f} ms, "
                      f"{ms / n:.3f} ms/batch ({cfg.data.num_workers} "
                      f"workers{'' if epoch else ', started in this epoch'}) "
                      f"[{card}]")
        finally:
            loader.close()

        # the task-2 teacher is task 1's final student, BatchNorm running
        # buffers included (the task-1 checkpoint holds that student)
        task1 = torch.load(os.path.join(work, "task_1_epoch_1",
                                        "checkpoint.pth"),
                           map_location="cpu", weights_only=True)["model"]
        bufs = [k for k in task1 if k.endswith(("running_mean",
                                                "running_var"))]
        for k in bufs:
            if not torch.equal(teachers[0][k].cpu(), task1[k]):
                raise AssertionError(f"incremental: the task-2 teacher's "
                                     f"{k} is not task 1's final student's")
        print(f"incremental: the task-2 teacher's {len(bufs)} BatchNorm "
              f"running buffers equal task 1's final student's bit for bit")

        # the task-2 checkpoint restores to the final model's buffers and
        # detections, through the family registry's eval step
        ckpt = os.path.join(work, f"task_{len(cfg.data.catsplit)}_epoch_1")
        restored, _ = init_detector(cfg, ckpt, device=DEVICE)
        final_sd, restored_sd = model.state_dict(), restored.state_dict()
        for k in bufs:
            if not torch.equal(final_sd[k], restored_sd[k]):
                raise AssertionError(f"incremental: the restored "
                                     f"checkpoint's {k} differs")
        imgs = [load_image(os.path.join(val_dir, f"val_{i:04d}.png"))
                for i in range(2)]
        batch = prepare_batch(cfg, imgs, DEVICE)

        def detections(m):
            return evaluator.make_eval_step(
                m, cfg.model.reg_max, cfg.test_score_thr,
                cfg.test_max_per_img, cfg.model.arch)(*batch)
        want, got = detections(model.eval()), detections(restored)
        for name, a, b in zip(got._fields, got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"incremental: the restored "
                                     f"checkpoint's {name} differ")
        print(f"incremental: init_detector({os.path.basename(ckpt)}) gives "
              f"the final model's {len(bufs)} running buffers and its "
              f"detections bit for bit on "
              f"{len(imgs)} val images ({int(got.valid.sum())} valid "
              f"detections) [{card}]")
    return launches


# --- distill menu ------------------------------------------------------------

# the distill-menu phase's configurations (flag strings, fix_fg_grad_direction)
# and the distill losses each must produce; together they run every branch
# beyond the flagship's corr + decode_v1
DISTILL_MENU = {
    "soft + ld + kldv + memory": (dict(
        cates_distill="hard + teacher-first + soft",
        locat_distill="bbox + logit", feats_distill="kldv",
        memory_distill="memory"), False, (
        "loss_kd", "loss_ld_bbox", "loss_ld_logit", "loss_fd",
        "loss_memory")),
    "corr + sg_out": (dict(cates_distill="hard + teacher-first",
                           feats_distill="corr + fg_info + sg_out"), False,
                      ("loss_corr", "loss_fg_feature")),
    "fg_only, fixed direction": (dict(cates_distill="hard + teacher-first",
                                      feats_distill="fg_info + fg_only"),
                                 True, ("loss_fg_feature",)),
    "decode_v2, fixed direction": (dict(cates_distill="hard + teacher-first",
                                        feats_distill="fg_info + decode_v2"),
                                   True, ("loss_fg_feature",)),
}
JV_COST_RTOL = 1e-5      # C++ JV against the plain twin, total cost
# the forgetting A/B on the card: the pinned 400/600 horizon of
# tests/test_forgetting_ab.py, whose margins it must meet, run by
# dskd_tpu_torch.tools.sweep_forgetting (TF32 off)
AB_VARIANT = "ref+soft@600/400"
# the margins hold on the mean over these k initial-weight seeds: one run's
# spread crosses "distill new > 0.6 finetune new". Over 58 single-seed runs
# of this variant on the card, that margin's slack, distill_new - 0.6
# finetune_new, had mean 7.75 and sd 9.41 (every other margin's slack: a
# mean of 1.7 sd or more), so the mean of k runs misses it with
# probability Phi(-7.75 sqrt(k) / 9.41): 1.5% at k = 7, 0.99% at k = 8
AB_SEEDS = tuple(range(8))


def menu_distill_cfg(cfg, flags, fix):
    from dskd_tpu_torch.distill.losses import DistillConfig

    return DistillConfig.from_flags(**flags, num_prev=cfg.data.catsplit[0],
                                    reg_max=cfg.model.reg_max,
                                    fix_fg_grad_direction=fix)


def timed_steps(cfg, card, tag, dcfg=None, matcher="auction", n_steps=2):
    """``n_steps`` full-width f32 steps with dropout 0 (student seed 0,
    teacher seed 1), each held to expected_launches; prints each step's
    ms and the last step's loss keys with the card line. Returns the last
    step's losses."""
    student, teacher = build_models(cfg, DEVICE, dropout=0.0)
    state, step, _, _ = train_setup(cfg, student, torch.float32, dcfg,
                                    matcher)
    batch = train_batch(DEVICE)
    want = model_launches("default", cfg, 2, 1)
    ms = []
    for i in range(n_steps):
        reset_counts()
        with card_alone():
            t0 = time.perf_counter()
            state, losses = step(state, batch, teacher)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        per_step = read_counts()
        if per_step != want:
            raise AssertionError(f"{tag}: launches per step {per_step}, "
                                 f"expected {want}")
        bad = {k: v for k, v in losses.items() if not torch.isfinite(v)}
        if bad:
            raise AssertionError(f"{tag}: non-finite losses {bad}")
    print(f"{tag}: ms/step {[round(t, 3) for t in ms]} (host clock, "
          f"synchronised), last loss {float(losses['loss']):.5f}, keys "
          f"{sorted(k for k in losses if k.startswith('loss_'))}; launches "
          f"{ {k: v for k, v in per_step.items() if v} } [{card}]")
    return losses


def check_jv(cfg, card):
    """The exact JV matcher (``matcher="jv"``) in a full-width f32 step:
    the step's launches, the host ms of its JV solves (cost copied to the
    host and back) beside the auction's on the same cost stack, the C++
    solve's total cost against the plain ``lap_jv`` twin (JV_COST_RTOL) and
    not above the auction's."""
    from dskd_tpu_torch.core import matching
    from dskd_tpu_torch.models import gfl_detr_loss
    from dskd_tpu_torch.native.build import load_lap_jv

    t0 = time.perf_counter()
    load_lap_jv()                  # c++ at first use, outside the timings
    print(f"jv matcher: native/lap_jv.cpp built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    solves, valid_rows = [], []
    assign = gfl_detr_loss.hungarian_assign

    def recording_assign(cost, gt_valid, gt_labels, *, solver):
        valid_rows.append(gt_valid)
        return assign(cost, gt_valid, gt_labels, solver=solver)

    gfl_detr_loss.hungarian_assign = recording_assign
    try:
        with timed_jv(solves):
            timed_steps(cfg, card, "jv matcher", matcher="jv")
    finally:
        gfl_detr_loss.hungarian_assign = assign
    cost, cols, jv_ms = solves[-1]
    N, R, C = cost.shape
    valid = valid_rows[-1]
    if tuple(valid.shape) != (N, R):     # the G <= Q branch: GT are rows
        raise AssertionError(f"jv: cost {tuple(cost.shape)}, GT mask "
                             f"{tuple(valid.shape)}")

    def auction():
        return matching.lap_auction(cost, row_mask=valid)

    auc_cols, _ = auction()
    auc_ms = cuda_ms(auction, iters=5, warmup=1)

    def totals(c, k):
        return torch.gather(c, 2, k[..., None])[..., 0].sum(1).double()

    jv_tot = totals(cost, cols).cpu()
    auc_tot = totals(cost, auc_cols).cpu()
    cpu_cost = cost.cpu()
    plain_tot = torch.stack([totals(cpu_cost[n:n + 1], matching.lap_jv(
        cpu_cost[n])[None])[0] for n in range(N)])
    rel = float(((jv_tot - plain_tot).abs() / plain_tot.abs()).max())
    print(f"jv matcher: {N} problems of {R} x {C} per step (merged GT x "
          f"queries); total cost, C++ JV {float(jv_tot.sum()):.6f}, plain "
          f"lap_jv {float(plain_tot.sum()):.6f} (largest rel err {rel:.3e}, "
          f"tolerance {JV_COST_RTOL}), auction "
          f"{float(auc_tot.sum()):.6f} [{card}]")
    print(f"jv matcher: host ms of the step's JV solves (copy to host, C++ "
          f"solve, copy back) {[round(t, 3) for _, _, t in solves]}; the "
          f"auction on the same cost stack {auc_ms:.3f} ms (CUDA events "
          f"around the call: device time and its host syncs) [{card}]")
    if not rel <= JV_COST_RTOL:
        raise AssertionError(f"jv: C++ and plain totals differ, {rel}")
    worse = jv_tot > auc_tot + JV_COST_RTOL * auc_tot.abs()
    if worse.any():
        raise AssertionError(f"jv: total cost above the auction's in "
                             f"{int(worse.sum())} problems")
    return jv_ms, auc_ms


def start_ab_seeds(seeds=AB_SEEDS):
    """Start ``python -m dskd_tpu_torch.tools.sweep_forgetting AB_VARIANT``
    on DEVICE once per initial-weight seed of ``seeds``, all at once, one
    thread each: one A/B leaves the card idle through most of its step,
    which its host's eager launches and the auction's syncs hold. They run
    beside phases 3-7 and stop while the main process times anything
    (card_alone). Returns the running children with their seeds and start
    time, for check_forgetting_ab; stop_ab_seeds kills those still
    running."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    running = [(seed, subprocess.Popen(
        [sys.executable, "-m", "dskd_tpu_torch.tools.sweep_forgetting",
         AB_VARIANT, "--device", DEVICE, "--seed", str(seed)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for seed in seeds]
    for _, proc in running:
        # card_alone stops them while the main process times anything
        _BACKGROUND[proc.pid] = lambda proc=proc: proc.poll() is None
    return time.perf_counter(), running


def stop_ab_seeds(ab) -> None:
    """Kill and reap the A/B children of start_ab_seeds still running."""
    for _, proc in ab[1]:
        _BACKGROUND.pop(proc.pid, None)
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def collect_ab_seeds(ab):
    """Each child's SWEEP result in seed order and the wall seconds since
    the start; a child that fails raises, and the children still running
    are killed."""
    t0, running = ab
    results = []
    try:
        for seed, proc in running:
            out, err = proc.communicate()
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("SWEEP ")]
            if proc.returncode != 0 or not lines:
                raise RuntimeError(f"forgetting A/B seed {seed} failed "
                                   f"(exit {proc.returncode}): {err[-2000:]}")
            results.append(json.loads(lines[-1][len("SWEEP "):]))
    finally:
        stop_ab_seeds(ab)
    return results, time.perf_counter() - t0


def check_forgetting_ab(card, ab):
    """The forgetting A/B (dskd_tpu_torch.tools.ab_forgetting) on the card
    at the pinned 400/600 horizon (AB_VARIANT), once per initial-weight
    seed of AB_SEEDS, from the children of start_ab_seeds (started after
    the build, collected at phase 8's start): each seed's old / new
    mAP of teacher, distilled and fine-tuned students and ms/step per
    phase, then their mean and sd over the seeds; each of
    tests/test_forgetting_ab.py's margins must hold on the mean."""
    from dskd_tpu_torch.tools.ab_forgetting import margins

    keys = ("teacher_old", "teacher_new", "distill_old", "distill_new",
            "finetune_old", "finetune_new")
    seeds = [seed for seed, _ in ab[1]]
    runs, wall = collect_ab_seeds(ab)
    for seed, r in zip(seeds, runs):
        print(f"forgetting A/B {AB_VARIANT} seed {seed}: old/new mAP "
              f"teacher {r['teacher_old']:.2f}/{r['teacher_new']:.2f}, "
              f"distill {r['distill_old']:.2f}/{r['distill_new']:.2f}, "
              f"finetune {r['finetune_old']:.2f}/{r['finetune_new']:.2f}; "
              f"ms/step task1 {r['task1_ms']:.3f}, distill "
              f"{r['distill_ms']:.3f}, finetune {r['finetune_ms']:.3f} "
              f"(host clock, synchronised, beside phases 3-7) [{card}]")
    mean = {k: float(np.mean([r[k] for r in runs])) for k in keys}
    sd = {k: float(np.std([r[k] for r in runs], ddof=1)) if len(runs) > 1
          else 0.0 for k in keys}
    comb_d = mean["distill_old"] + mean["distill_new"]
    comb_f = mean["finetune_old"] + mean["finetune_new"]
    print(f"forgetting A/B {AB_VARIANT}: mean (sd) over {len(runs)} seeds: "
          + ", ".join(f"{k} {mean[k]:.2f} ({sd[k]:.2f})" for k in keys)
          + f"; combined distill {comb_d:.2f} vs finetune {comb_f:.2f}; "
          f"wall {wall:.1f} s from their start, all at once [{card}]")
    held = margins(mean)
    print(f"forgetting A/B margins (tests/test_forgetting_ab.py) on the "
          f"mean of {len(runs)} seeds: {held}")
    if not all(held.values()):
        raise AssertionError(f"forgetting A/B margins failed on the mean: "
                             f"{held}")
    return mean


def check_distill_menu(cfg, card, ab):
    """Phase 8: the forgetting A/B of the children ``ab`` (collected first,
    so that the phase's timings run alone); every distill branch beyond
    corr + decode_v1 in a full-width f32 step (launches held to
    expected_launches) and card against CPU at 2+2 layers; the JV
    matcher."""
    check_forgetting_ab(card, ab)
    for name, (flags, fix, keys) in DISTILL_MENU.items():
        dcfg = menu_distill_cfg(cfg, flags, fix)
        tag = f"distill menu [{name}]"
        losses = timed_steps(cfg, card, tag, dcfg)
        missing = [k for k in keys if k not in losses]
        if missing:
            raise AssertionError(f"{tag}: no {missing} in {sorted(losses)}")
        print(f"{tag}: " + ", ".join(f"{k} {float(losses[k]):.6g}"
                                     for k in keys))
        check_train_card_vs_cpu(cfg, dcfg, tag)
    check_jv(cfg, card)


# --- the families behind the registry: DETR-IL, YOLOF-IL, YOLOY-IL ----------

DETR_CONFIG = os.path.join(ROOT, "configs", "detr_40_40_il.py")
DDETR_TWOSTAGE = os.path.join(ROOT, "configs",
                              "deformable_detr_twostage_r50_50e.py")
DDETR_BASE = os.path.join(ROOT, "configs", "deformable_detr_r50_50e.py")
DDETR_REFINE = os.path.join(ROOT, "configs",
                            "deformable_detr_refine_r50_50e.py")
# the 40+40 split, as the incremental runs take it (the configs train 80
# classes in one task)
DDETR_SETS = ("data.catsplit=(40,40)",)
YOLOF_CONFIG = os.path.join(ROOT, "configs", "yolof_40_40_il.py")
YOLOY_CONFIG = os.path.join(ROOT, "configs", "yoloy_40_40_il.py")
# the dense single-stage families (phase 14): their 1x COCO configs, each
# arch's own, cut to the 40+40 split for the incremental run
DENSE_CONFIGS = {arch: os.path.join(ROOT, "configs", f"{arch}_r50_1x.py")
                 for arch in ("gfl", "retinanet", "atss", "fcos")}
DENSE_SETS = ("data.catsplit=(40,40)",)
DENSE_CMP_HW = (384, 640)    # the step and the decode against the CPU
CANVAS_HW = (640, 640)     # the families' one canvas (DataConfig.bucket)
# valid (h, w) on the canvas: four aspect ratios, so the key mask acts
CANVAS_VALID = ((480, 640), (427, 640), (640, 512), (512, 640))
FAMILY_INC_SETS = ("data.num_workers=0",)
BN_TOL = dict(rtol=1e-3, atol=1e-4)     # running buffers after one step
KD_CLOSED_RTOL = 1e-5    # closed-form loss_kd against the (N, N) product
# YOLOF's two neck gradients in f32, card vs CPU (relative L2): at the init
# f32 decides them only loosely; PERF.md gives the CPU's spread between its
# thread counts that this bound stands on
THREAD_SPREAD_TOL = 2e-2


def family_batch(device, n, hw=CANVAS_HW, max_gt=MAX_GT, seed=7):
    """n images of the canvas ``hw`` whose valid (h, w) cycle through
    CANVAS_VALID (scaled to ``hw``), ``max_gt`` GT of which 5-29 are valid,
    in classes 40-79 and inside each image's valid region; drawn from
    ``seed``."""
    from dskd_tpu_torch.data.batch import Batch

    H, W = hw
    rng = np.random.RandomState(seed)
    images = rng.randn(n, H, W, 3).astype(np.float32) * 0.5
    img_hw = np.array([CANVAS_VALID[i % len(CANVAS_VALID)] for i in range(n)],
                      np.int32) * np.array([H, W]) // 640
    img_hw = img_hw.astype(np.int32)
    wh = rng.rand(n, max_gt, 2) * 0.3 + 0.05
    xy = rng.rand(n, max_gt, 2) * (1 - wh)
    scale = img_hw[:, None, ::-1].astype(np.float32)
    gt = (np.concatenate([xy, xy + wh], -1) * np.tile(scale, 2)).astype(
        np.float32)
    labels = rng.randint(40, 80, (n, max_gt)).astype(np.int64)
    valid = np.arange(max_gt)[None] < rng.randint(5, 30, (n, 1))
    return Batch(*(torch.from_numpy(a) for a in (
        images, img_hw, gt, labels, valid))).to(device)


def detr_models(cfg, device, **overrides):
    """Student (seed 0) and frozen teacher (seed 1) of the DETR config
    through the family registry. The teacher stands for a model trained on
    the old classes: its class weights are 8x wider and the new classes'
    bias is -20, so it keeps confident old-class detections."""
    from dskd_tpu_torch.registry import get_family
    from dskd_tpu_torch.train.state import frozen_copy

    spec = get_family("detr")
    mcfg = dataclasses.replace(cfg.model, **overrides)
    student = spec["build"](mcfg, torch.device(device))
    spec["init_weights"](student, 0)
    teacher = spec["build"](mcfg, torch.device(device))
    spec["init_weights"](teacher, 1)
    n_old = cfg.data.catsplit[0]
    with torch.no_grad():
        fc = teacher.bbox_head.fc_cls
        fc.weight.mul_(8.0)
        fc.bias[n_old:cfg.model.num_classes] = -20.0
    return student, frozen_copy(teacher)


def yolo_models(cfg, device, **overrides):
    """Student (seed 0) and frozen teacher (seed 1) of a YOLOF or YOLOY
    config through the family registry. The teacher stands for a model
    trained on the old classes: its class kernels are 100x wider (the
    init's logits spread by ~0.01), its old classes' bias is +2, its new
    classes' -20 and its objectness bias +2 (and YOLOY's boxes are 5
    strides wide), so that each image keeps ``teacher_max_per_img``
    old-class detections above the threshold after an NMS that
    suppresses."""
    from dskd_tpu_torch.registry import get_family
    from dskd_tpu_torch.train.state import frozen_copy

    spec = get_family(cfg.model.arch)
    mcfg = dataclasses.replace(cfg.model, **overrides)
    student = spec["build"](mcfg, torch.device(device))
    spec["init_weights"](student, 0)
    teacher = spec["build"](mcfg, torch.device(device))
    spec["init_weights"](teacher, 1)
    n_old, C = cfg.data.catsplit[0], cfg.model.num_classes
    head = teacher.bbox_head
    if cfg.model.arch == "yolof":
        cls_convs, obj_convs = [head.cls_score], [head.object_pred]
    else:
        cls_convs = list(head.multi_level_conv_cls)
        obj_convs = list(head.multi_level_conv_obj)
    with torch.no_grad():
        if cfg.model.arch == "yoloy":
            # boxes 5 strides wide, so that neighbours overlap past the
            # NMS threshold (at the init's width of one stride they touch)
            for conv in head.multi_level_conv_reg:
                conv.bias[2:] = float(np.log(5.0))
        for conv in cls_convs:
            conv.weight.mul_(100.0)
            bias = conv.bias.view(-1, C)        # (anchors, classes)
            bias[:, :n_old] = 2.0
            bias[:, n_old:] = -20.0
        for conv in obj_convs:
            conv.bias.fill_(2.0)
    return student, frozen_copy(teacher)


def yolo_decode(cfg, out, img_hw, max_per_img):
    """The family's teacher detections of ``out`` at the config's teacher
    threshold (JAX's ``*_teacher_out`` path)."""
    thr = cfg.distill.teacher_score_thr
    if cfg.model.arch == "yolof":
        from dskd_tpu_torch.models.yolof_head import yolof_anchors, \
            yolof_get_bboxes
        return yolof_get_bboxes(out.head, yolof_anchors(
            out.head.feat_hw, img_hw.device), img_hw, score_thr=thr,
            max_per_img=max_per_img)
    from dskd_tpu_torch.models.yoloy_head import yoloy_get_bboxes
    return yoloy_get_bboxes(out.head, img_hw, score_thr=thr,
                            max_per_img=max_per_img)


def yolo_scores(cfg, out):
    """(cls logits (B, N, C), scores (B, N, C)) of a YOLOF or YOLOY
    forward."""
    if cfg.model.arch == "yolof":
        B = out.head.cls_scores.shape[0]
        cls = out.head.cls_scores.reshape(B, -1, cfg.model.num_classes)
        return cls, torch.sigmoid(cls)
    from dskd_tpu_torch.models.yoloy_head import flatten_levels
    cls, _, obj = flatten_levels(out.head)
    return cls, torch.sigmoid(cls) * torch.sigmoid(obj)[..., None]


@contextlib.contextmanager
def nms_tiles_against_scan():
    """Have batched_nms hold each keep mask of its tiled fixpoint against
    the plain scan (``_nms_keep_scan``) on the same score-sorted
    candidates; yields a list of (images, rows, equal) per call."""
    from dskd_tpu_torch.core import postprocess

    tiled, seen = postprocess._nms_keep_tiled, []

    def both(shifted, svalid, iou_thr, tile):
        keep = tiled(shifted, svalid, iou_thr, tile)
        scan = postprocess._nms_keep_scan(shifted, svalid, iou_thr)
        seen.append((*svalid.shape, torch.equal(keep, scan)))
        return keep

    postprocess._nms_keep_tiled = both
    try:
        yield seen
    finally:
        postprocess._nms_keep_tiled = tiled


def check_yolo_teacher(fam, cfg, card, student, teacher, batch):
    """The teacher's detections on the B=8 batch: candidates above the
    threshold, NMS survivors and the kept detections per image, which must
    fill ``teacher_max_per_img``; the tiled NMS keep mask must equal the
    plain scan's on the teacher's sorted candidates. Then the closed-form
    loss_kd against the literal (N, N) product on the card at B=2
    (KD_CLOSED_RTOL), and the product's size."""
    from dskd_tpu_torch.core import losses as L
    from dskd_tpu_torch.distill.losses import _kept_query_weight

    nms_pre = 1000 if cfg.model.arch == "yolof" else 2000
    keep_n = cfg.distill.teacher_max_per_img
    with torch.no_grad():
        out = teacher(batch.images, batch.img_hw)
        scores = yolo_scores(cfg, out)[1].flatten(1)
        cands = (scores > cfg.distill.teacher_score_thr).sum(1).clamp(
            max=nms_pre)
        survivors = yolo_decode(cfg, out, batch.img_hw, nms_pre).valid.sum(1)
        with nms_tiles_against_scan() as masks:
            det = yolo_decode(cfg, out, batch.img_hw, keep_n)
    print(f"{fam['tag']} teacher: candidates above "
          f"{cfg.distill.teacher_score_thr} per image (of the top "
          f"{nms_pre}) {cands.tolist()}, NMS survivors "
          f"{survivors.tolist()}, kept {det.valid.sum(1).tolist()} [{card}]")
    if not ((survivors < cands).all() and (det.valid.sum(1) == keep_n)
            .all()):
        raise AssertionError(f"{fam['tag']}: the teacher must suppress and "
                             f"keep {keep_n} detections per image")
    if not (masks and all(equal for _, _, equal in masks)):
        raise AssertionError(f"{fam['tag']}: NMS keep masks, tiles against "
                             f"the scan: {masks}")
    print(f"{fam['tag']} teacher: the tiled NMS keep mask equals the plain "
          f"scan's on the sorted candidates ((images, rows) "
          f"{[m[:2] for m in masks]})")

    # loss_kd: the closed form against JAX's literal (N, N) product, on the
    # student's eval-mode outputs (a train-mode forward would move its
    # running statistics)
    n = 2
    two = type(batch)(*(t[:n] if t is not None else None for t in batch))
    student.eval()
    with torch.no_grad():
        t_out = teacher(two.images, two.img_hw)
        s_out = student(two.images, two.img_hw)
    student.train()
    with torch.no_grad():
        tdet = yolo_decode(cfg, t_out, two.img_hw, keep_n)
        s_cls, t_cls = (yolo_scores(cfg, o)[0] for o in (s_out, t_out))
        keep_w = _kept_query_weight(tdet, n, s_cls.shape[1]).reshape(-1)
        num_keep = tdet.valid.sum().float().clamp(min=1.0)
        C = cfg.model.num_classes
        closed = L.kd_kl_div_loss_outer(s_cls.reshape(-1, C),
                                        t_cls.reshape(-1, C), keep_w,
                                        num_keep, T=2.0)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        literal = L.kd_kl_div_loss(s_cls.reshape(-1, C), t_cls.reshape(-1, C),
                                   weight=keep_w[:, None],
                                   avg_factor=num_keep, T=2.0)
        extra = torch.cuda.max_memory_allocated() - base
    rel = float((closed - literal).abs() / literal.abs())
    N = keep_w.numel()
    print(f"{fam['tag']} loss_kd at B={n}: closed form {float(closed):.9g} "
          f"against the literal ({N}, {N}) product {float(literal):.9g}, "
          f"relative err {rel:.3e} (tolerance {KD_CLOSED_RTOL}); the "
          f"product took {extra / 2 ** 30:.3f} GiB [{card}]")
    if not rel <= KD_CLOSED_RTOL:
        raise AssertionError(f"{fam['tag']}: closed-form loss_kd differs "
                             f"from the product by {rel}")


DETR_GRAD_PARAMS = (
    "bbox_head.input_proj.weight",
    "bbox_head.transformer.decoder.layers.1.attentions.1.attn."
    "in_proj_weight",
    "bbox_head.fc_cls.weight",
    "bbox_head.query_embedding.weight")
YOLOF_GRAD_PARAMS = (
    "neck.lateral_conv.weight",
    "neck.dilated_encoder_blocks.1.conv2.conv.weight",
    "bbox_head.cls_score.weight",
    "bbox_head.bbox_subnet.3.bn.weight")
YOLOY_GRAD_PARAMS = (
    "neck.reduce_layers.0.conv.weight",
    "neck.bottom_up_blocks.1.final_conv.conv.weight",
    "bbox_head.multi_level_conv_cls.0.weight",
    "bbox_head.multi_level_reg_convs.2.1.bn.weight")


def _detr_jv_hooks():
    """Phase 10's per-step note and check: the JV solves of each step."""
    solves = []

    def note():
        cost, _, jv_ms = solves[-1]
        return (f"; JV solve {jv_ms:.3f} ms of host time for "
                f"{cost.shape[0]} problems of {cost.shape[1]} x "
                f"{cost.shape[2]} (rows x columns)")

    def after(cfg):
        _, rows, cols = solves[-1][0].shape
        if not cols > rows == cfg.model.num_query:
            raise AssertionError(f"detr-il: JV solved {rows} x {cols}: the "
                                 f"merged GT should outnumber the queries")
        return f"; merged GT {cols} > {rows} queries: JV with queries as rows"

    return timed_jv(solves), note, after


def _ddetr_jv_hooks():
    """Phase 13's per-step note: the host ms of each JV call of the step,
    the decoder layers' (one call for their nl x B problems of G x Q)
    apart from the two-stage encoder proposals' (B problems of G x S, every
    token a column)."""
    solves, done = [], [0]

    def note():
        step, done[0] = solves[done[0]:], len(solves)
        names = ("decoder layers", "encoder proposals")
        return "; JV host ms: " + ", ".join(
            f"{name} {ms:.3f} ({c.shape[0]} problems of {c.shape[1]} x "
            f"{c.shape[2]})" for name, (c, _, ms) in zip(names, step))

    return timed_jv(solves), note, lambda cfg: ""


def ddetr_models(cfg, device, **overrides):
    """Student (seed 0, random MSDA kernels at seed 3 as after a training
    step: see random_msda_kernels) and frozen teacher (seed 1) of a
    Deformable-DETR config through the family registry; the family's step
    reads no teacher."""
    from dskd_tpu_torch.registry import get_family
    from dskd_tpu_torch.train.state import frozen_copy

    spec = get_family("deformable_detr")
    mcfg = dataclasses.replace(cfg.model, **overrides)
    student = spec["build"](mcfg, torch.device(device))
    spec["init_weights"](student, 0)
    random_msda_kernels(student, seed=3)
    teacher = spec["build"](mcfg, torch.device(device))
    spec["init_weights"](teacher, 1)
    return student, frozen_copy(teacher)


def tie_proposals(model):
    """Zero the two-stage proposal classifier's class-0 kernel, so that
    every valid token's class-0 logit is its bias and the stable top-k
    takes the first num_query valid tokens on every device. Random logits
    put neighbours among the top 300 of 22,323 tokens a few 1e-6 apart (the
    smallest of 300 spacings ~1e-3 wide), under the ~7e-6 by which the
    card's logits differ from the CPU's; a swapped query changes the
    decoder's outputs."""
    head = getattr(model, "bbox_head", None)
    if getattr(head, "as_two_stage", False):
        with torch.no_grad():
            head.cls_branches[-1].weight[0] = 0.0


def _ddetr_heads(cfg, out):
    h = out.head
    heads = {"cls_scores": h.cls_scores[-1], "bbox_preds": h.bbox_preds[-1]}
    if h.enc_cls_scores is not None:
        heads.update(enc_cls_scores=h.enc_cls_scores,
                     enc_bbox_preds=h.enc_bbox_preds)
    return heads


def _yolo_heads(cfg, out):
    if cfg.model.arch == "yolof":
        return {"cls_scores": out.head.cls_scores,
                "bbox_preds": out.head.bbox_preds}
    from dskd_tpu_torch.models.yoloy_head import flatten_levels
    return dict(zip(("cls_scores", "bbox_preds", "objectnesses"),
                    flatten_levels(out.head)))




def ddetr_grad_params(m):
    """The named gradients of a Deformable-DETR model config: the proposal
    head's enc_output in the two-stage configuration only."""
    names = (
        "backbone.layer4.0.conv2.weight",
        "bbox_head.transformer.encoder.layers.0.attentions.0."
        "sampling_offsets.weight",
        "bbox_head.transformer.decoder.layers.1.attentions.1.value_proj."
        "weight",
        "bbox_head.cls_branches.0.weight",
        # the output layer: its zero init leaves the earlier ones no gradient
        "bbox_head.reg_branches.0.4.weight")
    if m.as_two_stage:
        names += ("bbox_head.transformer.enc_output.weight",)
    return names


# --- the dense single-stage families (phase 14) -------------------------------

DENSE_GRAD_PARAMS = {
    "retinanet": ("bbox_head.cls_convs.3.conv.weight",
                  "bbox_head.reg_convs.3.conv.weight",
                  "bbox_head.retina_cls.weight", "bbox_head.retina_reg.weight",
                  "neck.lateral_convs.0.conv.weight",
                  "neck.fpn_convs.3.conv.weight"),
    "atss": ("bbox_head.cls_convs.3.conv.weight",
             "bbox_head.reg_convs.3.conv.weight", "bbox_head.atss_cls.weight",
             "bbox_head.atss_reg.weight", "bbox_head.atss_centerness.weight",
             "neck.lateral_convs.0.conv.weight", "bbox_head.scales.0.scale"),
    "gfl": ("bbox_head.cls_convs.3.conv.weight",
            "bbox_head.reg_convs.3.conv.weight", "bbox_head.gfl_cls.weight",
            "bbox_head.gfl_reg.weight", "neck.lateral_convs.0.conv.weight",
            "bbox_head.scales.0.scale"),
    "fcos": ("bbox_head.cls_convs.3.conv.weight",
             "bbox_head.reg_convs.3.conv.weight", "bbox_head.conv_cls.weight",
             "bbox_head.conv_reg.weight", "bbox_head.conv_centerness.weight",
             "neck.lateral_convs.0.conv.weight", "bbox_head.scales.0.scale")}
# the FPN lateral's gradient at the init comes back through four towers of
# std-0.01 convs and their GroupNorms: f32 decides it only loosely (3.1e-3
# card vs CPU in GFL's first run), so it is held to THREAD_SPREAD_TOL,
# as YOLOF's neck is
DENSE_SPREAD_PARAMS = ("neck.lateral_convs.0.conv.weight",)
DENSE_CLS_CONV = {"retinanet": "retina_cls", "atss": "atss_cls",
                  "gfl": "gfl_cls", "fcos": "conv_cls", "paa": "paa_cls",
                  "vfnet": "vfnet_cls", "reppoints": "reppoints_cls_out"}
# phase 15's archs -> the dense family whose anchors, assignment and decode
# they share (LD is GFL's, LAD is PAA's, the variants are RetinaNet's)
DENSE_KIND = {"ld": "gfl", "lad": "paa", "pisa_retinanet": "retinanet",
              "retinanet_ghm": "retinanet", "retinanet_fpg": "retinanet",
              "retinanet_nasfpn": "retinanet", "nasfcos": "fcos"}


def dense_kind(arch: str) -> str:
    return DENSE_KIND.get(arch, arch)
DENSE_DECODE_BIAS = -4.0    # the decode model's class bias


def dense_models(cfg, device, **overrides):
    """Student (seed 0) and frozen teacher (seed 1) of a dense config
    through the family registry; the family's step reads no teacher."""
    from dskd_tpu_torch.registry import get_family
    from dskd_tpu_torch.train.state import frozen_copy

    spec = get_family(cfg.model.arch)
    mcfg = dataclasses.replace(cfg.model, **overrides)
    student = spec["build"](mcfg, torch.device(device))
    spec["init_weights"](student, 0)
    teacher = spec["build"](mcfg, torch.device(device))
    spec["init_weights"](teacher, 1)
    return student, frozen_copy(teacher)


def dense_decode_model(cfg, device, bias=DENSE_DECODE_BIAS, gain=1.0):
    """A dense model whose scores pass the decode's 0.05: seed 2, every
    head conv (the deformable ones too) redrawn lecun-normal (normal(0.01)
    leaves the towers' and outputs' spread ~1e-3) from a CPU generator, so
    that each device gets the same weights, the class conv's kernel times
    ``gain`` and its bias ``bias``."""
    from dskd_tpu_torch.models.detector import lecun_
    from dskd_tpu_torch.ops.deform_conv import DeformConv
    from dskd_tpu_torch.registry import get_family

    spec = get_family(cfg.model.arch)
    model = spec["build"](cfg.model, torch.device(device))
    spec["init_weights"](model, 2)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for mod in model.bbox_head.modules():
            if isinstance(mod, (torch.nn.Conv2d, DeformConv)):
                lecun_(mod.weight, g)
        cls = getattr(model.bbox_head, DENSE_CLS_CONV[dense_kind(
            cfg.model.arch)])
        cls.weight.mul_(gain)
        cls.bias.fill_(bias)
    return model.eval()


def _dense_heads(cfg, out):
    """Each head output, its levels flattened and concatenated."""
    h = out.head
    B = h.cls_scores[0].shape[0]
    return {name: torch.cat([t.reshape(B, -1) for t in getattr(h, name)], 1)
            for name in h._fields}


def dense_priors(arch, out, device):
    """The family's anchors or points of a forward ``out`` and their
    per-level counts."""
    sizes = [tuple(c.shape[1:3]) for c in out.head.cls_scores]
    arch = dense_kind(arch)
    if arch == "retinanet":
        from dskd_tpu_torch.models.retinanet import retina_anchors
        return retina_anchors(sizes, device), None
    if arch == "fcos":
        from dskd_tpu_torch.models.fcos import fcos_points
        return fcos_points(sizes, device)
    if arch == "vfnet":
        from dskd_tpu_torch.models.vfnet import vfnet_points
        return vfnet_points(sizes, device)
    if arch == "reppoints":
        from dskd_tpu_torch.models.reppoints import reppoints_centers
        return reppoints_centers(sizes, device)
    from dskd_tpu_torch.models.atss import atss_anchors
    return atss_anchors(sizes, device)


def dense_assign(arch, cfg, priors, batch):
    """The family's assignment of the batch's GT: (the assigned GT index
    or -1 / -2, labels, anything else it outputs)."""
    C = cfg.model.num_classes
    gt = (batch.gt_bboxes, batch.gt_labels, batch.gt_valid)
    arch = dense_kind(arch)
    if arch == "retinanet":
        from dskd_tpu_torch.core.max_iou_assigner import max_iou_assign
        # the EfficientNet recipe's negatives lie below IoU 0.5
        neg = 0.5 if cfg.model.backbone.startswith("effb") else 0.4
        r = max_iou_assign(priors[0], *gt, C, pos_iou_thr=0.5,
                           neg_iou_thr=neg, min_pos_iou=0.0)
        return r.assigned_gt, r.labels, r.max_ious
    if arch == "fcos":
        from dskd_tpu_torch.models.fcos import _fcos_targets
        labels, tgt, pos = _fcos_targets(*priors, *gt, C)
        return torch.where(pos, 0, -1), labels, tgt
    from dskd_tpu_torch.core.atss import atss_assign
    r = atss_assign(*(priors[1:] if arch == "vfnet" else priors), *gt, C)
    return r.assigned_gt, r.labels, r.pos_mask


def dense_decode(arch, out, priors, img_hw, max_per_img=100):
    """(the (B, N, C) scores, the per-level top-k, the detections) of a
    forward at the families' test settings (threshold 0.05, 1000 per
    level)."""
    from dskd_tpu_torch.core.postprocess import filter_scores_and_topk_mlvl
    from dskd_tpu_torch.models import (atss, fcos, gfl_head, paa, reppoints,
                                       retinanet, vfnet)
    from dskd_tpu_torch.models.gfl_head import cat_levels, level_sizes

    h = out.head
    arch = dense_kind(arch)
    C = h.cls_scores[0].shape[-1] // (retinanet.NUM_ANCHORS
                                      if arch == "retinanet" else 1)
    scores = torch.sigmoid(cat_levels(h.cls_scores, C))
    if arch in ("atss", "fcos"):
        scores = scores * torch.sigmoid(cat_levels(h.centernesses, 1))
    if arch == "paa":
        scores = torch.sqrt((scores * torch.sigmoid(cat_levels(
            h.iou_preds, 1))).clamp(min=1e-12))
    top = filter_scores_and_topk_mlvl(scores, 0.05, 1000,
                                      level_sizes(h.cls_scores, C))
    kw = dict(max_per_img=max_per_img)
    if arch == "retinanet":
        det = retinanet.retina_get_bboxes(h, priors[0], img_hw, **kw)
    elif arch == "paa":
        det = paa.paa_get_bboxes(h, priors[0], img_hw, **kw)
    elif arch == "atss":
        det = atss.atss_get_bboxes(h, priors[0], img_hw, **kw)
    elif arch == "gfl":
        det = gfl_head.gfl_get_bboxes(h, img_hw, **kw)
    elif arch == "vfnet":
        det = vfnet.vfnet_get_bboxes(h, priors[0], img_hw, **kw)
    elif arch == "reppoints":
        det = reppoints.reppoints_get_bboxes(h, out.moment, img_hw, **kw)
    else:
        det = fcos.fcos_get_bboxes(h, priors[0], img_hw, **kw)
    return scores, top, det


def apart(sorted_scores, gap):
    """(B, k) bool: entries of descending ``sorted_scores`` more than
    2 x ``gap`` from both neighbours."""
    spacing = sorted_scores[:, :-1] - sorted_scores[:, 1:]
    far = torch.ones_like(sorted_scores, dtype=torch.bool)
    far[:, :-1] &= spacing > 2 * gap
    far[:, 1:] &= spacing > 2 * gap
    return far


def check_dense_decode(fam, cfg, card, n=2):
    """The per-level top-k and the NMS survivors of ``dense_decode_model``
    on the card against the CPU's, on a B=n batch of DENSE_CMP_HW: every
    top-k entry whose CPU score stands more than twice the devices' largest
    score difference from its sorted neighbours holds the CPU's (position,
    class) on the card; so does every survivor that the card or the CPU
    alone keeps unless its score stands that close to another
    candidate's."""
    arch = cfg.model.arch
    bias = fam.get("decode_bias", DENSE_DECODE_BIAS)
    gain = fam.get("decode_gain", 1.0)
    got = {}
    for dev in (DEVICE, "cpu"):
        model = dense_decode_model(cfg, dev, bias, gain)
        batch = family_batch(dev, n, DENSE_CMP_HW, fam["max_gt"](cfg))
        with torch.inference_mode():
            out = model(batch.images, batch.img_hw)
            priors = dense_priors(arch, out, dev)
            scores, top, det = dense_decode(arch, out, priors, batch.img_hw)
        got[dev] = [t.cpu() for t in (scores, top.scores, top.keep_idxs,
                                      top.labels, top.valid, det.keep_qid,
                                      det.labels, det.valid)]
    (sc, ts, ti, tl, tv, qid, dl, dv), (c_sc, c_ts, c_ti, c_tl, c_tv, c_qid,
                                        c_dl, c_dv) = got[DEVICE], got["cpu"]
    gap = float((sc - c_sc).abs().max())
    # the top-k is level-major: each level's entries sorted, so a level's
    # last entry and the next level's first are no neighbours; a level
    # boundary only makes the check stricter
    far = apart(c_ts, gap) & c_tv
    same = (ti == c_ti) & (tl == c_tl) & (tv == c_tv)
    n_top = int(c_tv.sum())
    cands = c_ts[c_tv]
    bad_surv = 0
    for b in range(n):
        card_keep = {(int(q), int(lb)) for q, lb, v in zip(qid[b], dl[b],
                                                           dv[b]) if v}
        cpu_keep = {(int(q), int(lb)) for q, lb, v in zip(c_qid[b], c_dl[b],
                                                          c_dv[b]) if v}
        for q, lb in card_keep ^ cpu_keep:
            s = float(c_sc[b, q, lb])
            if not bool(((cands - s).abs() <= 2 * gap).sum() > 1):
                bad_surv += 1
    print(f"{fam['tag']} decode, card vs CPU (B={n}, {DENSE_CMP_HW[0]}x"
          f"{DENSE_CMP_HW[1]}, head convs lecun, class bias "
          f"{bias}): {n_top} top-k candidates above 0.05 "
          f"({tv.shape[1]} slots an image), {int(far.sum())} stand > 2 x "
          f"{gap:.3e} (the devices' largest score difference) apart and "
          f"the card holds the CPU's (position, class) in "
          f"{int(same[far].sum())} of them and in {int(same.sum())} of all "
          f"{same.numel()} slots; NMS survivors per image card "
          f"{dv.sum(1).tolist()} CPU {c_dv.sum(1).tolist()}, "
          f"{bad_surv} kept by one device only and standing apart [{card}]")
    if not far.any() or not bool(same[far].all()) or bad_surv:
        raise AssertionError(f"{fam['tag']}: the card's top-k or NMS "
                             f"survivors differ from the CPU's")


def check_dense(fam, cfg, card, student, teacher, batch):
    """Phase 14's family check: the family's assignment (max-IoU for
    RetinaNet, ATSS for ATSS and GFL, FCOS's targets) of the training
    batch on the card equals the CPU's exactly; then check_dense_decode."""
    arch = dense_kind(cfg.model.arch)
    with torch.no_grad():
        out = student(batch.images[:1], batch.img_hw[:1])
    res = {}
    for dev in (DEVICE, "cpu"):
        b = batch.to(dev)
        with torch.no_grad():
            res[dev] = [t.cpu() for t in dense_assign(
                arch, cfg, dense_priors(arch, out, dev), b)]
    (a, lb, extra), (c_a, c_lb, c_extra) = res[DEVICE], res["cpu"]
    exact = (torch.equal(a, c_a) and torch.equal(lb, c_lb)
             and torch.equal(extra, c_extra))
    pos = (c_a >= 0).sum(1).tolist()
    print(f"{fam['tag']} assignment, card vs CPU on the training batch (B="
          f"{batch.images.shape[0]}, {tuple(batch.images.shape[1:3])}, "
          f"{c_a.shape[1]} priors, GT padded to {batch.gt_valid.shape[1]} "
          f"of which {batch.gt_valid.sum(1).tolist()} valid): positives per "
          f"image {pos}, ignored {(c_a == -2).sum(1).tolist()}; equal "
          f"{exact} [{card}]")
    if not exact or not all(pos):
        raise AssertionError(f"{fam['tag']}: the card's assignment differs "
                             f"from the CPU's (or has no positive)")
    check_dense_decode(fam, cfg, card)


FAMILIES = {
    "detr": dict(
        tag="detr-il", models=detr_models, grad_params=DETR_GRAD_PARAMS,
        describe=lambda m: (f"ResNet-{m.depth}, {m.num_encoder_layers}+"
                            f"{m.num_decoder_layers} layers, {m.num_query} "
                            f"queries"),
        heads=lambda cfg, out: {"cls_scores": out.cls_scores[-1],
                                "bbox_preds": out.bbox_preds[-1]},
        n_dets=lambda cfg: min(cfg.test_max_per_img, cfg.model.num_query),
        max_gt=lambda cfg: MAX_GT, hooks=_detr_jv_hooks,
        small=dict(num_encoder_layers=2, num_decoder_layers=2, dropout=0.0),
        small_note="2+2 layers, ", vs_cpu_dtypes=(torch.float32,),
        thread_spread_params=(), train_checks=None),
    "yolof": dict(
        tag="yolof-il", models=yolo_models, grad_params=YOLOF_GRAD_PARAMS,
        describe=lambda m: (f"caffe-style ResNet-{m.depth}, DilatedEncoder, "
                            f"5 anchors per position"),
        heads=_yolo_heads, n_dets=lambda cfg: cfg.test_max_per_img,
        max_gt=lambda cfg: cfg.data.max_gt, hooks=None, small={},
        small_note="", vs_cpu_dtypes=(torch.float32, torch.float64),
        thread_spread_params=YOLOF_GRAD_PARAMS[:2],
        train_checks=check_yolo_teacher),
    "yoloy": dict(
        tag="yoloy-il", models=yolo_models, grad_params=YOLOY_GRAD_PARAMS,
        describe=lambda m: (f"ResNet-{m.depth}, PAFPN, decoupled head at "
                            f"strides 8-32"),
        heads=_yolo_heads, n_dets=lambda cfg: cfg.test_max_per_img,
        max_gt=lambda cfg: cfg.data.max_gt, hooks=None, small={},
        small_note="", vs_cpu_dtypes=(torch.float32,),
        thread_spread_params=(), train_checks=check_yolo_teacher),
    "deformable_detr": dict(
        tag="deformable-detr", models=ddetr_models,
        grad_params=ddetr_grad_params,
        describe=lambda m: (f"ResNet-{m.depth}, {m.num_encoder_layers}+"
                            f"{m.num_decoder_layers} MSDA layers, "
                            f"{m.num_query} queries, box refinement "
                            f"{m.with_box_refine}, two-stage "
                            f"{m.as_two_stage}"),
        heads=_ddetr_heads, n_dets=lambda cfg: cfg.test_max_per_img,
        max_gt=lambda cfg: MAX_GT, hooks=_ddetr_jv_hooks,
        small=dict(num_encoder_layers=2, num_decoder_layers=2, dropout=0.0),
        small_note="2+2 layers, ", vs_cpu_dtypes=(torch.float32,),
        thread_spread_params=(), train_checks=None, serve_batches=(1, 2),
        # landscape images: the configs serve on their landscape bucket
        serve_shapes=((480, 640), (427, 640), (512, 640)),
        prepare_compare=tie_proposals),
}
for _arch, _desc in (("gfl", "GFL head, integral over 17 bins"),
                     ("retinanet", "RetinaNet head, 9 anchors per position"),
                     ("atss", "ATSS head, one anchor per position"),
                     ("fcos", "FCOS head, exp(Scale x reg)")):
    FAMILIES[_arch] = dict(
        tag=_arch, models=dense_models, grad_params=DENSE_GRAD_PARAMS[_arch],
        describe=(lambda m, d=_desc: f"ResNet-{m.depth}, FPN-256 P3-P7, "
                  f"4-conv towers, {d}"),
        heads=_dense_heads, n_dets=lambda cfg: cfg.test_max_per_img,
        max_gt=lambda cfg: cfg.data.max_gt, hooks=None, small={},
        small_note="", vs_cpu_dtypes=(torch.float32,),
        thread_spread_params=DENSE_SPREAD_PARAMS, train_checks=check_dense,
        serve_batches=(1, 2), serve_shapes=((480, 640), (427, 640),
                                            (512, 640)),
        cmp_hw=DENSE_CMP_HW)


def rel_l2(got, want):
    """||got - want|| / ||want||."""
    return float((got - want).norm() / want.norm())


def family_step(fam, cfg, dtype, n, hw, dev, prepare=None):
    """One family step at B=n on the canvas ``hw``, dropout 0, in ``dtype``
    on ``dev`` through the registry's losses_fn (DETR and Deformable DETR
    at 2+2 layers, YOLOF and YOLOY at full depth), after the family's
    ``prepare_compare`` (Deformable DETR's tie_proposals) or the function
    named ``prepare``: its losses, the gradients of ``grad_params`` (names,
    or a map from the model config to them: Deformable DETR's; a name the
    model lacks raises) and its BatchNorm running buffers, on the CPU."""
    from dskd_tpu_torch.registry import get_family
    from dskd_tpu_torch.train.step import parse_losses

    losses_fn = get_family(cfg.model.arch)["losses"](
        None, cfg, num_prev=cfg.data.catsplit[0], has_teacher=True,
        use_dropout=False)
    grad_params = fam["grad_params"]
    if callable(grad_params):
        grad_params = grad_params(cfg.model)
    student, teacher = (mdl.to(dtype) for mdl in fam["models"](
        cfg, dev, **fam["small"]))
    prep = globals()[prepare] if prepare else fam.get("prepare_compare")
    if prep:
        prep(student)
    student.train()
    batch = family_batch(dev, n, hw, fam["max_gt"](cfg))
    batch = type(batch)(*(t.to(dtype) if t is not None and
                          t.is_floating_point() else t for t in batch))
    losses = losses_fn(student, batch, teacher, None)
    parse_losses(losses).backward()
    params = dict(student.named_parameters())
    return ({k: v.detach().cpu() for k, v in losses.items()},
            {k: params[k].grad.cpu() for k in grad_params},
            {k: v.cpu() for k, v in student.state_dict().items()
             if k.endswith(("running_mean", "running_var"))})


# --- the CPU worker: the CPU side of phases 10-17's comparisons --------------
#
# The families' checks against the CPU cost the host more than the card
# costs them: one spawned process computes their CPU sides in turn, queued
# at phase 10's start, while the main process drives the card; it stops
# (SIGSTOP) whenever the main process times the card or the host
# (card_alone), so that no timing of those phases runs beside it.

_WORKER = None
_QUEUED = {}
# pid -> "still running" of the child processes that card_alone stops: the
# CPU worker and the forgetting A/B's children
_BACKGROUND = {}
_ALONE = [0]


def cpu_family_step(key, cfg, dtype, n, hw, prepare=None):
    """family_step of FAMILIES[key] on the CPU, with FPG's and NAS-FPN's
    stacks cut as phase 15 cuts them."""
    with cut_stacks(key):
        return family_step(FAMILIES[key], cfg, dtype, n, hw, "cpu", prepare)


def cpu_serve_heads(key, cfg, images, img_hw):
    """The head outputs of the family's seed-0 model on the CPU (the
    registry's init_detector), after its ``prepare_compare``."""
    from dskd_tpu_torch.apis.inference import init_detector

    fam = FAMILIES[key]
    with cut_stacks(key):
        cpu_model, _ = init_detector(cfg, device="cpu", seed=0)
    if fam.get("prepare_compare"):
        fam["prepare_compare"](cpu_model)
    with torch.inference_mode():
        return fam["heads"](cfg, cpu_model(images, img_hw))


def _tree(x, leaf):
    """``x`` with every tensor or array leaf mapped by ``leaf``."""
    if isinstance(x, dict):
        return {k: _tree(v, leaf) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        items = [_tree(v, leaf) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return leaf(x)


def _to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _to_torch(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def _cpu_worker_loop(jobs, results, threads):
    """The worker: (ticket, function name, args) from ``jobs`` in turn, each
    result (or the traceback) to ``results``; None ends it. A thread reads
    the jobs, so that the main process never waits to queue one. Torch
    uses ``threads`` threads."""
    import queue
    import threading
    import traceback

    torch.set_num_threads(threads)
    todo = queue.Queue()

    def read():
        while True:
            msg = jobs.recv()
            todo.put(msg)
            if msg is None:
                return

    threading.Thread(target=read, daemon=True).start()
    while True:
        msg = todo.get()
        if msg is None:
            return
        ticket, name, args = msg
        try:
            out = ("ok", _tree(globals()[name](*_tree(args, _to_torch)),
                               _to_numpy))
        except BaseException:
            out = ("error", traceback.format_exc())
        results.send((ticket, out))


class CpuWorker:
    """One spawned process running _cpu_worker_loop on ``threads`` threads;
    a thread of the main process takes its results as they come, so that
    it never waits to send one."""

    def __init__(self, threads):
        import multiprocessing
        import threading

        ctx = multiprocessing.get_context("spawn")
        jobs_out, self._jobs = ctx.Pipe(duplex=False)
        self._results, results_in = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_cpu_worker_loop,
                                args=(jobs_out, results_in, threads),
                                daemon=True)
        self.proc.start()
        _BACKGROUND[self.proc.pid] = self.proc.is_alive
        jobs_out.close()
        results_in.close()
        self._done, self._next = {}, 0
        self._cond = threading.Condition()
        threading.Thread(target=self._collect, daemon=True).start()

    def _collect(self):
        while True:
            try:
                ticket, out = self._results.recv()
            except (EOFError, OSError):
                out, ticket = None, None
            with self._cond:
                if ticket is None:
                    self._done["ended"] = True
                else:
                    self._done[ticket] = out
                self._cond.notify_all()
            if ticket is None:
                return

    def submit(self, name, args):
        ticket, self._next = self._next, self._next + 1
        self._jobs.send((ticket, name, _tree(args, _to_numpy)))
        return ticket

    def result(self, ticket, name):
        with self._cond:
            while ticket not in self._done and "ended" not in self._done:
                self._cond.wait()
            out = self._done.pop(ticket, None)
        if out is None:
            raise RuntimeError(f"the CPU worker ended (exit "
                               f"{self.proc.exitcode}) before {name}")
        if out[0] != "ok":
            raise RuntimeError(f"{name} failed in the CPU worker:\n{out[1]}")
        return _tree(out[1], _to_torch)

    def close(self):
        _BACKGROUND.pop(self.proc.pid, None)
        if self.proc.is_alive():
            os.kill(self.proc.pid, signal.SIGCONT)
            try:
                self._jobs.send(None)
            except OSError:
                pass
            self.proc.join(60)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()


class CpuWorkers:
    """CPU_WORKERS CpuWorker processes, each on its share of the host's
    cores; jobs go to them in turn, so that each works through the phases
    in their order beside the other."""

    def __init__(self):
        n = CPU_WORKERS
        threads = max(1, (os.cpu_count() or n) // n)
        self.workers = [CpuWorker(threads) for _ in range(n)]
        self._next = 0

    def submit(self, name, args):
        i, self._next = self._next, (self._next + 1) % len(self.workers)
        return i, self.workers[i].submit(name, args)

    def result(self, ticket, name):
        i, t = ticket
        return self.workers[i].result(t, name)

    def close(self):
        for w in self.workers:
            w.close()


# the CPU worker processes of phases 10-18: two, each on half the host's
# cores, take the CPU sides of the comparisons in parallel (one left
# phase 15's steps_vs_cpu ~26.6 s behind its queue in PR 17's runs)
CPU_WORKERS = 2


@contextlib.contextmanager
def cpu_worker():
    """Run the CPU workers while the block runs; print how many of their
    jobs were queued ahead and how many were asked for unqueued."""
    global _WORKER
    _WORKER, stats = CpuWorkers(), {"queued": 0, "used": 0, "unqueued": 0}
    _WORKER.stats = stats
    try:
        yield
    finally:
        worker, _WORKER = _WORKER, None
        unused = len(_QUEUED)
        _QUEUED.clear()
        worker.close()
        print(f"cpu workers: {len(worker.workers)}, "
              f"{stats['queued']} jobs queued ahead, "
              f"{stats['used']} used, {unused} unused, "
              f"{stats['unqueued']} computed when asked")


def _job_key(fn, args):
    import hashlib
    import pickle

    return fn.__name__, hashlib.sha256(pickle.dumps(
        _tree(args, _to_numpy))).hexdigest()


def cpu_queue(fn, *args) -> None:
    """Queue fn(*args) on the CPU worker, if one runs, for cpu_result."""
    if _WORKER is not None:
        _QUEUED[_job_key(fn, args)] = _WORKER.submit(fn.__name__, args)
        _WORKER.stats["queued"] += 1


def cpu_result(fn, *args):
    """fn(*args): from the CPU worker, queued ahead by cpu_queue or now;
    without a worker, computed here."""
    if _WORKER is None:
        return fn(*args)
    ticket = _QUEUED.pop(_job_key(fn, args), None)
    if ticket is None:
        _WORKER.stats["unqueued"] += 1
        ticket = _WORKER.submit(fn.__name__, args)
    else:
        _WORKER.stats["used"] += 1
    return _WORKER.result(ticket, fn.__name__)


def _signal_background(sig) -> None:
    for pid, running in list(_BACKGROUND.items()):
        if running():
            os.kill(pid, sig)


@contextlib.contextmanager
def card_alone():
    """The block times the card or the host: the background processes (the
    CPU worker, the A/B's children) stop (SIGSTOP) while it runs."""
    if _ALONE[0] == 0:
        _signal_background(signal.SIGSTOP)
    _ALONE[0] += 1
    try:
        yield
    finally:
        _ALONE[0] -= 1
        if _ALONE[0] == 0:
            _signal_background(signal.SIGCONT)


def serve_inputs(fam, cfg, full=True):
    """check_family's serving batches {B: prepare_batch(...) on the card}:
    B=1 and the family's ``serve_batches`` (B=1 alone unless ``full``) of
    images of several aspect ratios (seed 3)."""
    from dskd_tpu_torch.apis.inference import prepare_batch

    rng = np.random.RandomState(3)
    imgs = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in fam.get("serve_shapes", CANVAS_VALID * 2)]
    sizes = fam.get("serve_batches", (1, 8)) if full else (1,)
    return {bsz: prepare_batch(cfg, imgs[:1] if bsz == 1 else imgs[-bsz:],
                               DEVICE) for bsz in sizes}


def queue_family_cpu(key, config, sets=(), hw=CANVAS_HW, full=True):
    """Queue on the CPU worker the CPU sides of check_family's comparisons
    for FAMILIES[key] on ``config``: the serving heads (``full``) and a
    step per dtype of ``vs_cpu_dtypes`` (ATSS-DyHead's also with its
    offset convs redrawn)."""
    from dskd_tpu_torch.utils.config import apply_overrides, load_config

    fam = FAMILIES[key]
    cfg = apply_overrides(load_config(config), list(sets))
    if full:
        images, img_hw, _ = serve_inputs(fam, cfg)[max(fam.get(
            "serve_batches", (1, 8)))]
        cpu_queue(cpu_serve_heads, key, cfg, images.cpu(), img_hw.cpu())
    for dtype in fam["vs_cpu_dtypes"]:
        cpu_queue(cpu_family_step, key, cfg, dtype, 2,
                  tuple(fam.get("cmp_hw", hw)), None)
    if key == "atss_dyhead":
        cpu_queue(cpu_family_step, key, cfg, torch.float32, 2,
                  tuple(DENSE_CMP_HW), "redraw_dyhead_offsets")
    if key in STEPS_VS_CPU:
        cpu_queue(cpu_family_steps, key, cfg, *STEPS_VS_CPU[key])


def queue_phase_cpu():
    """Queue the CPU sides of phases 10-18's family checks, in their
    order."""
    from dskd_tpu_torch.utils.config import load_config

    for key, config in (("detr", DETR_CONFIG), ("yolof", YOLOF_CONFIG),
                        ("yoloy", YOLOY_CONFIG)):
        queue_family_cpu(key, config)
    bucket = tuple(load_config(DDETR_TWOSTAGE).data.bucket)
    for config, full in ((DDETR_TWOSTAGE, True), (DDETR_BASE, False),
                         (DDETR_REFINE, False)):
        queue_family_cpu("deformable_detr", config, DDETR_SETS, bucket,
                         full)
    for key, config in DENSE_CONFIGS.items():
        queue_family_cpu(key, config, DENSE_SETS)
    for key, config in VARIANT_CONFIGS.items():
        queue_family_cpu(key, config, VARIANT_SETS)
    for key, config in DCN_CONFIGS.items():
        queue_family_cpu(key, config, DCN_SETS)
    for key, config in HEAD_CONFIGS.items():
        queue_family_cpu(key, config, HEAD_SETS)
    queue_zoo_cpu()


def check_family_card_vs_cpu(fam, cfg, card, dtype, n=2, hw=CANVAS_HW,
                             tag=None, prepare=None):
    """One family step's losses, named gradients and BatchNorm running
    buffers (family_step, after ``prepare`` where given) card against CPU
    (LOSS_TOL, GRAD_REL_TOL or in f64 F64_GRAD_REL_TOL, BN_TOL); the CPU's
    from the CPU worker where one runs. A family's
    ``thread_spread_params`` are gradients that f32 decides only loosely
    at the init: in f32 each of them is held to THREAD_SPREAD_TOL instead
    (PERF.md gives the CPU's own spread between its thread counts, which
    the bound stands on)."""
    hw = tuple(hw)
    losses, grads, bufs = family_step(fam, cfg, dtype, n, hw, DEVICE,
                                      prepare)
    c_losses, c_grads, c_bufs = cpu_result(cpu_family_step, fam["key"], cfg,
                                           dtype, n, hw, prepare)
    grad_params = list(grads)
    tag = tag or fam["tag"]
    tol = dict.fromkeys(grad_params, F64_GRAD_REL_TOL if dtype ==
                        torch.float64 else GRAD_REL_TOL)
    spread_params = (fam["thread_spread_params"] if dtype == torch.float32
                     else ())
    for k in spread_params:
        tol[k] = THREAD_SPREAD_TOL
    loss_err = {}
    for k, v in c_losses.items():
        torch.testing.assert_close(losses[k], v, **LOSS_TOL, msg=k)
        loss_err[k] = float((losses[k] - v).abs())
    print(f"{tag} card vs CPU ({fam['small_note']}B={n}, {hw[0]}x{hw[1]}, "
          f"{dtype}): "
          f"{len(loss_err)} "
          f"loss keys within {LOSS_TOL}, largest abs err "
          f"{max(loss_err.values()):.3e} ({max(loss_err, key=loss_err.get)})"
          f" [{card}]")
    bad = {}
    for k in grad_params:
        rel = rel_l2(grads[k], c_grads[k])
        print(f"{tag} card vs CPU: grad {k}: relative L2 err {rel:.3e} "
              f"(tolerance {tol[k]})")
        if not rel <= tol[k]:
            bad[k] = rel
    if bad:
        raise AssertionError(f"{tag}: gradients differ card vs CPU: {bad}")
    buf_err = {k: float((bufs[k] - v).abs().max()) for k, v in c_bufs.items()}
    for k, v in c_bufs.items():
        torch.testing.assert_close(bufs[k], v, **BN_TOL, msg=k)
    if buf_err:
        print(f"{tag} card vs CPU: {len(buf_err)} BatchNorm running buffers "
              f"after the step within {BN_TOL}, largest abs err "
              f"{max(buf_err.values()):.3e} "
              f"({max(buf_err, key=buf_err.get)})")
    else:
        print(f"{tag} card vs CPU: no BatchNorm running buffers")


def check_family(card, arch, config, sets=(), n_train=None, hw=CANVAS_HW,
                 inc_kw=None, full=True, incremental=True, family=None):
    """Phases 10-13: one family of the registry (FAMILIES) at the config's
    width and depth, f32, TF32 off, seeded weights. Serving: the registry's
    eval step at B=1 and B=8 (the family's ``serve_batches``) on the
    config's canvas, images of several aspect ratios, finite outputs, the
    head outputs against the CPU (HEAD_TOL), ms/image. Train: the family
    step with a frozen teacher (unread by Deformable DETR) and the config's
    distills at its samples_per_device on the canvas ``hw``, GT padded to
    the family's max_gt: three steps (ms/step, img/s), a profile of one
    step (device busy, idle share, launches), the peak memory of one step,
    the family's own checks (the teacher's detections and NMS paths and
    the closed-form loss_kd for YOLOF and YOLOY) and a step against the
    CPU. Every run of the path is held to path_launches: none of the
    port's kernels for DETR, YOLOF and YOLOY, B1, B1' and B2 per MSDA
    layer and level for Deformable DETR. Incremental: the
    train_increment CLI's path for two tasks of 4 steps at B=2, eval after
    each, the task-2 teacher's BatchNorm buffers those of task 1's final
    student, and the task-2 checkpoint restored bit for bit. With
    ``full=False`` (Deformable DETR's base and refine configs) it serves at
    B=1 with no full-depth head check against the CPU, takes one training
    step, and skips the profile, the peak memory, the family's own checks
    and the incremental run; the step against the CPU stays, on the
    family's ``cmp_hw`` where it has one (the dense families), else on
    ``hw``. ``incremental=False`` leaves out the incremental run alone.
    ``family`` names the FAMILIES entry where it is not the arch's own
    (ATSS-DyHead's)."""
    from dskd_tpu_torch.apis.inference import init_detector
    from dskd_tpu_torch.eval.evaluator import make_eval_step
    from dskd_tpu_torch.train.family import make_family_train_step
    from dskd_tpu_torch.utils.config import apply_overrides, load_config

    fam = FAMILIES[family or arch]
    tag = fam["tag"] if full else f"{fam['tag']} {os.path.basename(config)}"
    cfg = apply_overrides(load_config(config), list(sets))
    m, d = cfg.model, cfg.distill
    if m.arch != arch:
        raise AssertionError(f"{config} builds {m.arch}, not {arch}")
    flags = " + ".join(repr(f) for f in (d.cates_distill, d.locat_distill,
                                         d.feats_distill) if f)
    print(f"{tag}: {os.path.relpath(config, ROOT)}: arch {m.arch}, "
          f"{fam['describe'](m)}, {m.num_classes} classes, distill "
          f"{flags or 'none'} [{card}]")

    def times(counts, k):
        return {name: k * v for name, v in counts.items()}

    # serving
    model, _ = init_detector(cfg, device=DEVICE, seed=0)
    step = make_eval_step(model, cfg.model.reg_max, cfg.test_score_thr,
                          cfg.test_max_per_img, arch=m.arch)
    batches = serve_inputs(fam, cfg, full)
    sizes = tuple(batches)
    reset_counts()
    for bsz, batch in batches.items():
        det = step(*batch)
        if not all(bool(torch.isfinite(t.float()).all()) for t in det):
            raise AssertionError(f"{tag} serve B={bsz}: non-finite output")
        if tuple(det.bboxes.shape) != (bsz, fam["n_dets"](cfg), 4):
            raise AssertionError(f"{tag} serve: boxes {det.bboxes.shape}")
    per_forward = path_launches(cfg, 1)
    if read_counts() != times(per_forward, len(batches)):
        raise AssertionError(f"{tag} serve launched {read_counts()}, "
                             f"expected {per_forward} per forward")
    images, img_hw, _ = batches[max(sizes)]
    print(f"{tag} serve: canvas {tuple(images.shape[1:3])}, valid (h, w) "
          f"{img_hw.tolist()}; outputs finite at B="
          f"{' and B='.join(map(str, sizes))}; launches per forward "
          f"{per_forward}")
    if full:
        check_serve_heads_vs_cpu(fam, cfg, tag, model, images, img_hw)
    for bsz, batch in batches.items():
        with card_alone():
            for _ in range(2):
                step(*batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                step(*batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 5 * 1e3
        print(f"  {tag} serve B={bsz}: eval step {ms / bsz:.3f} ms/image "
              f"({ms:.3f} ms/batch; host clock around synchronised calls, "
              f"f32) [{card}]")
    del model

    # training
    n = n_train or cfg.data.samples_per_device
    student, teacher = fam["models"](cfg, DEVICE)
    state = train_state(cfg, student)
    train = make_family_train_step(m.arch, student, cfg,
                                   num_prev=cfg.data.catsplit[0],
                                   has_teacher=True)
    batch = family_batch(DEVICE, n, hw, fam["max_gt"](cfg))
    ctx, note, after = (fam["hooks"]() if fam["hooks"] else
                        (contextlib.nullcontext(), lambda: "",
                         lambda cfg: ""))
    per_step = step_launches(cfg, has_teacher=True)
    n_steps = 3 if full else 1
    reset_counts()
    with ctx, card_alone():
        for i in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, losses = train(state, batch, teacher)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            bad = {k: v for k, v in losses.items() if not torch.isfinite(v)}
            if bad:
                raise AssertionError(f"{tag} train: non-finite {bad}")
            parts = ", ".join(f"{k} {float(losses[k]):.6f}" for k in (
                "loss_cls", "loss_kd", "loss_fd", "enc.loss_cls")
                if k in losses)
            print(f"  {tag} train f32 B={n} {hw[0]}x{hw[1]} step {i}: "
                  f"{ms:.3f} ms/step, {n / ms * 1e3:.3f} img/s, loss "
                  f"{float(losses['loss']):.5f} ({parts}){note()} [{card}]")
    launched = read_counts()
    if launched != times(per_step, n_steps):
        raise AssertionError(f"{tag} train launched {launched}, expected "
                             f"{per_step} per step")
    print(f"{tag} train: {len(losses)} loss keys {sorted(losses)}; "
          f"launches per step {per_step}, held in {n_steps} "
          f"step{'s' * (n_steps > 1)}{after(cfg)}")
    if full:
        reset_counts()
        profile(lambda: train(state, batch, teacher),
                f"one {tag} B={n} f32 train step")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with card_alone():
            train(state, batch, teacher)
            torch.cuda.synchronize()
        print(f"{tag} train: peak memory of one B={n} step "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
              f"(torch.cuda.max_memory_allocated) [{card}]")
        if fam["train_checks"]:
            fam["train_checks"](fam, cfg, card, student, teacher, batch)
        # the profile's two steps and the peak memory's one
        if read_counts() != times(per_step, 3):
            raise AssertionError(f"{tag} train launched {read_counts()}")
    del state, student, teacher, train
    for dtype in fam["vs_cpu_dtypes"]:
        check_family_card_vs_cpu(fam, cfg, card, dtype,
                                 hw=fam.get("cmp_hw", hw), tag=tag)

    if full and incremental:
        # run_incremental through the train_increment CLI's config path
        with card_alone():
            check_incremental(card, config, sets=(*sets, *FAMILY_INC_SETS),
                              **(inc_kw or {}))


def check_serve_heads_vs_cpu(fam, cfg, tag, model, images, img_hw):
    """The head outputs of ``model`` on the card against the same seed's
    model on the CPU (HEAD_TOL, cpu_serve_heads), after the family's
    ``prepare_compare``."""
    if fam.get("prepare_compare"):
        fam["prepare_compare"](model)
    with torch.inference_mode():
        got_heads = fam["heads"](cfg, model(images, img_hw))
    want_heads = cpu_result(cpu_serve_heads, fam["key"], cfg, images.cpu(),
                            img_hw.cpu())
    errs = {}
    for name, want in want_heads.items():
        got = got_heads[name].cpu()
        torch.testing.assert_close(got, want, **HEAD_TOL)
        errs[name] = float((got - want).abs().max())
    print(f"{tag} serve: card vs CPU head outputs, B={images.shape[0]}, max "
          f"abs err {errs} (tolerance {HEAD_TOL})")


def check_detr(card, config=DETR_CONFIG, sets=(), n_train=None, hw=CANVAS_HW,
               inc_kw=None):
    """Phase 10: the DETR-IL family (ResNet-50, 6+6 layers, 100 queries,
    80 classes, exact JV on the 100 queries x 132 merged GT, dropout 0.1)
    through check_family."""
    check_family(card, "detr", config, sets, n_train, hw, inc_kw)


def check_proposal_topk(cfg, card, n=2):
    """The two-stage proposals' stable top-k on real logits (no
    tie_proposals), card against CPU at 2+2 layers, dropout off, B=n on the
    config's canvas: each device's select_proposals of its own class-0
    logits; every selected query whose CPU logit stands more than twice
    the devices' largest logit difference from both sorted neighbours
    must pick the same token on the card."""
    from dskd_tpu_torch.models.deformable_detr import select_proposals

    fam = FAMILIES["deformable_detr"]
    hw, Q = tuple(cfg.data.bucket), cfg.model.num_query
    got = {}
    for dev in (DEVICE, "cpu"):
        student, _ = ddetr_models(cfg, dev, **fam["small"])
        batch = family_batch(dev, n, hw)
        with torch.inference_mode():
            h = student.eval()(batch.images, batch.img_hw).head
            idx = select_proposals(h.enc_cls_scores, h.enc_token_valid, Q)
        got[dev] = (h.enc_cls_scores[..., 0].cpu(), h.enc_token_valid.cpu(),
                    idx.cpu())
    (score, valid, idx), (c_score, c_valid, c_idx) = got[DEVICE], got["cpu"]
    if not torch.equal(valid, c_valid):
        raise AssertionError("proposal top-k: the valid tokens differ")
    gap = float((score - c_score)[valid].abs().max())
    top = torch.where(c_valid, c_score, torch.full_like(c_score, -1e9)).sort(
        dim=1, descending=True, stable=True)[0][:, :Q + 1]
    spacing = top[:, :-1] - top[:, 1:]        # (n, Q): s_j - s_(j+1)
    apart = spacing > 2 * gap
    apart[:, 1:] &= spacing[:, :-1] > 2 * gap
    same = idx == c_idx
    print(f"proposal top-k, card vs CPU ({fam['small_note']}B={n}, "
          f"{hw[0]}x{hw[1]}, real logits): {int(apart.sum())} of {n * Q} "
          f"selected queries stand > 2 x {gap:.3e} (the devices' largest "
          f"class-0 logit difference) from their neighbours; the card "
          f"picks the CPU's token in {int(same[apart].sum())} of them and "
          f"in {int(same.sum())} of all [{card}]")
    if not apart.any() or not bool(same[apart].all()):
        raise AssertionError("proposal top-k: the card selects other tokens")


def check_ddetr(card):
    """Phase 13: the vanilla Deformable-DETR family. The two-stage config
    (box refinement and two-stage: R50, 6+6 layers, 300 queries, 80
    classes) through check_family on its 800x1344 canvas at B=2, its
    proposals' top-k against the CPU on real logits, then the base and
    refine configs through check_family with ``full=False``."""
    from dskd_tpu_torch.utils.config import apply_overrides, load_config

    cfg = apply_overrides(load_config(DDETR_TWOSTAGE), list(DDETR_SETS))
    hw = tuple(cfg.data.bucket)
    check_family(card, "deformable_detr", DDETR_TWOSTAGE, DDETR_SETS, hw=hw)
    check_proposal_topk(cfg, card)
    for config in (DDETR_BASE, DDETR_REFINE):
        check_family(card, "deformable_detr", config, DDETR_SETS, hw=hw,
                     full=False)


def check_dense_families(card):
    """Phase 14: the dense single-stage families (GFL, RetinaNet, ATSS,
    FCOS: R50, FPN-256, 4-conv towers, 80 classes) through check_family on
    their configs' 800x1344 canvas, f32, B=2 with GT padded to the
    config's max_gt: serving at B=1 and B=2, three steps, a profile, the
    peak memory, check_dense, a step against the CPU on DENSE_CMP_HW; the
    two-task incremental run for GFL alone. None of the port's kernels
    runs."""
    from dskd_tpu_torch.utils.config import apply_overrides, load_config

    for arch, config in DENSE_CONFIGS.items():
        t0 = time.perf_counter()
        cfg = apply_overrides(load_config(config), list(DENSE_SETS))
        check_family(card, arch, config, DENSE_SETS, n_train=2,
                     hw=tuple(cfg.data.bucket), incremental=arch == "gfl")
        print(f"{arch}: {time.perf_counter() - t0:.1f} s of phase 14")


# --- LD, PAA, LAD and the RetinaNet variants (phase 15) ----------------------

VARIANT_CONFIGS = {
    arch: os.path.join(ROOT, "configs", f"{name}.py") for arch, name in (
        ("ld", "ld_r18_gflv1_r101_1x"), ("paa", "paa_r50_1x"),
        ("lad", "lad_r50_paa_r101_1x"),
        ("pisa_retinanet", "pisa_retinanet_r50_1x"),
        ("retinanet_ghm", "retinanet_ghm_r50_1x"),
        ("retinanet_fpg", "retinanet_r50_fpg_50e"),
        ("retinanet_nasfpn", "retinanet_r50_nasfpn_50e"))}
# the head's gradients, which f32 decides closely at the init (the FPN
# lateral's, held loosely in phase 14, is left out). Behind FPG's nine
# stacks the cls tower's last conv, and in NAS-FPN's train-mode SepBN head
# the reg tower's, part from the CPU's by 8.6e-4 and 3.0e-3 in f32, as much
# as the CPU's own 1- and 8-thread steps part (2.5e-3, 3.0e-3), and agree
# within 4e-14 in f64 (tools/torch_dense_grad_check.py on the card): they are
# left out there rather than rerun on one thread here (~50 s each)
_HEAD_GRADS = ("bbox_head.cls_convs.3.conv.weight",
               "bbox_head.reg_convs.3.conv.weight")
_RETINA_OUT = ("bbox_head.retina_cls.weight", "bbox_head.retina_reg.weight")
VARIANT_GRAD_PARAMS = {
    "gfl": _HEAD_GRADS + ("bbox_head.gfl_cls.weight",
                          "bbox_head.gfl_reg.weight"),
    "paa": _HEAD_GRADS + ("bbox_head.paa_cls.weight",
                          "bbox_head.paa_reg.weight",
                          "bbox_head.paa_iou.weight"),
    "retinanet": _HEAD_GRADS + _RETINA_OUT,
    "retinanet_fpg": _HEAD_GRADS[1:] + _RETINA_OUT,
    "retinanet_nasfpn": _HEAD_GRADS[:1] + _RETINA_OUT}
VARIANT_SETS = ()         # the configs as they are (a rehearsal cuts them)
# FPG's and NAS-FPN's stacks in phase 15, cut from 9 and 7 to keep the
# script inside its time; each stack repeats the same searched block
VARIANT_STACKS = {"retinanet_fpg": 3, "retinanet_nasfpn": 3}
GHM_EMA_TOL = dict(rtol=1e-3, atol=2.0)   # EMAs of bin counts, 3 steps
ISR_TOL = dict(rtol=1e-4, atol=1e-6)      # ISR-P weights, card vs CPU


def variant_models(cfg, device, **overrides):
    """Student (seed 0) and frozen teacher (seed 1); LD's and LAD's teacher
    is the ResNet-101 model of ``build_teacher_model``."""
    from dskd_tpu_torch.registry import get_family
    from dskd_tpu_torch.train.incremental import build_teacher_model
    from dskd_tpu_torch.train.state import frozen_copy

    student, teacher = dense_models(cfg, device, **overrides)
    if not cfg.model.teacher_depth:
        return student, teacher
    teacher = build_teacher_model(dataclasses.replace(cfg, model=dataclasses
                                                      .replace(cfg.model,
                                                               **overrides)),
                                  torch.device(device))
    get_family(cfg.model.arch)["init_weights"](teacher, 1)
    return student, frozen_copy(teacher)


def _gt_sets(cand_idx, is_pos):
    """{(image, GT): frozenset of its positive anchors}."""
    return {(b, g): frozenset(cand_idx[b, g][is_pos[b, g]].tolist())
            for b in range(cand_idx.shape[0])
            for g in range(cand_idx.shape[1])}


def check_paa(fam, cfg, card, student, teacher, batch):
    """PAA's and LAD's positives on the training batch, card against CPU,
    from the same head outputs (the student's, or LAD's teacher's, taken on
    the card): each GT's positive anchors must match wherever its valid
    candidates' losses (on the CPU) stand more than twice the devices'
    largest candidate-loss difference apart; then check_dense_decode."""
    from dskd_tpu_torch.models import paa as P

    lad = cfg.model.arch == "lad"
    C = cfg.model.num_classes
    with torch.no_grad():
        out = (teacher if lad else student)(batch.images, batch.img_hw).head
    got = {}
    for dev in (DEVICE, "cpu"):
        h = type(out)(*(tuple(t.to(dev) for t in f) for f in out))
        b = batch.to(dev)
        anchors, counts = P.paa_anchors([tuple(c.shape[1:3])
                                         for c in h.cls_scores], dev)
        dec = P.delta2bbox(anchors[None], P.cat_levels(h.bbox_preds, 4),
                           stds=P.DELTA_STDS)
        args = (P.cat_levels(h.cls_scores, C), dec, anchors, counts,
                b.gt_bboxes, b.gt_labels, b.gt_valid,
                P.PAALossConfig(num_classes=C))
        with torch.no_grad():
            idx, score = P.paa_candidates(*args)
            is_pos = P.gmm_split(score, score < 1e7)
            assigned, pos, _ = P.paa_assign(*args)
        got[dev] = [t.cpu() for t in (idx, score, is_pos, pos)]
    (idx, score, is_pos, pos), (c_idx, c_score, c_pos, c_apos) = \
        got[DEVICE], got["cpu"]
    valid = c_score < 1e7
    same_idx = (idx == c_idx) & valid
    gap = float((score - c_score)[same_idx].abs().max())
    card_sets, cpu_sets = _gt_sets(idx, is_pos), _gt_sets(c_idx, c_pos)
    n_gt, excused, bad = 0, 0, []
    for (b, g), want in cpu_sets.items():
        vals = c_score[b, g][valid[b, g]].sort().values
        if vals.numel() == 0:
            continue
        n_gt += 1
        tied = vals.numel() > 1 and bool(((vals[1:] - vals[:-1])
                                          <= 2 * gap).any())
        if card_sets[(b, g)] != want:
            if tied:
                excused += 1
            else:
                bad.append((b, g))
    print(f"{fam['tag']} assignment, card vs CPU on the "
          f"{'teacher' if lad else 'student'}'s outputs (B="
          f"{batch.images.shape[0]}, {tuple(batch.images.shape[1:3])}, "
          f"{pos.shape[1]} anchors, GT padded to {batch.gt_valid.shape[1]}): "
          f"positives per image card {pos.sum(1).tolist()} CPU "
          f"{c_apos.sum(1).tolist()}; {n_gt} GT with candidates, "
          f"{n_gt - excused - len(bad)} with the CPU's positives, {excused} "
          f"differing where two candidate losses stand within 2 x {gap:.3e} "
          f"(the devices' largest difference), {len(bad)} differing apart "
          f"[{card}]")
    if bad or not bool(c_apos.any()) or excused == n_gt:
        raise AssertionError(f"{fam['tag']}: the card's positives differ "
                             f"from the CPU's at GT {bad[:8]}")
    check_dense_decode(fam, cfg, card)


def check_pisa(fam, cfg, card, student, teacher, batch):
    """check_dense (max-IoU), then ISR-P's weights of the training batch
    from the same head outputs (taken on the card), card against CPU
    (ISR_TOL) but at positives whose IoU with their target stands within
    twice the devices' largest IoU difference of another positive's of
    their class, where the rank may part."""
    from dskd_tpu_torch.core.anchors import bbox2delta, delta2bbox
    from dskd_tpu_torch.core.boxes import bbox_overlaps
    from dskd_tpu_torch.core.max_iou_assigner import max_iou_assign
    from dskd_tpu_torch.models import pisa, retinanet as R

    check_dense(fam, cfg, card, student, teacher, batch)
    C = cfg.model.num_classes
    with torch.no_grad():
        out = student(batch.images, batch.img_hw).head
    got = {}
    for dev in (DEVICE, "cpu"):
        h = type(out)(*(tuple(t.to(dev) for t in f) for f in out))
        b = batch.to(dev)
        with torch.no_grad():
            anchors = R.retina_anchors([c.shape[1:3] for c in h.cls_scores],
                                       dev)
            a = max_iou_assign(anchors, b.gt_bboxes, b.gt_labels, b.gt_valid,
                               C, pos_iou_thr=0.5, neg_iou_thr=0.4,
                               min_pos_iou=0.0)
            B, N = a.labels.shape
            G = b.gt_bboxes.shape[1]
            pos = a.assigned_gt >= 0
            tgt = torch.gather(b.gt_bboxes, 1, a.assigned_gt.clamp(0, G - 1)[
                ..., None].expand(-1, -1, 4))
            dt = bbox2delta(anchors[None], tgt).reshape(-1, 4)
            deltas = R.cat_levels(h.bbox_preds, 4).reshape(-1, 4)
            af = anchors[None].expand(B, N, 4).reshape(-1, 4)
            gt_off = a.assigned_gt + torch.arange(B, device=dev)[:, None] * G
            w = pisa.isr_p_weights(R.cat_levels(h.cls_scores, C).reshape(
                -1, C), deltas, af, a.labels.reshape(-1), pos.reshape(-1),
                gt_off.reshape(-1), dt, C)
            first = torch.argsort((~pos.reshape(-1)).to(torch.uint8),
                                  stable=True)[:pisa.MAX_POS]
            iou = bbox_overlaps(delta2bbox(af[first], deltas[first]),
                                delta2bbox(af[first], dt[first]),
                                is_aligned=True)
        got[dev] = [t.cpu() for t in (w, pos.reshape(-1), first, iou,
                                      a.labels.reshape(-1))]
    (w, pos, first, iou, lab), (c_w, c_pos, c_first, c_iou, c_lab) = \
        got[DEVICE], got["cpu"]
    if not (torch.equal(pos, c_pos) and torch.equal(first, c_first)):
        raise AssertionError("pisa: the positives differ card vs CPU")
    n_pos = int(c_pos.sum())
    P = min(n_pos, pisa.MAX_POS)
    gap = float((iou - c_iou)[:P].abs().max())
    ci, cl = c_iou[:P], c_lab[c_first[:P]]
    near = ((ci[:, None] - ci[None, :]).abs() <= 2 * gap) & (
        cl[:, None] == cl[None, :])
    excused = torch.zeros_like(c_w, dtype=torch.bool)
    excused[c_first[:P]] = (near.sum(1) > 1)
    close = (w - c_w).abs() <= ISR_TOL["atol"] + ISR_TOL["rtol"] * c_w.abs()
    bad = int((~close & ~excused).sum())
    print(f"pisa ISR-P weights, card vs CPU on the student's outputs (B="
          f"{batch.images.shape[0]}): {n_pos} positives, {P} weighted (cap "
          f"{pisa.MAX_POS}, {max(n_pos - pisa.MAX_POS, 0)} past it keep 1), "
          f"weights {float(c_w[c_first[:P]].min()):.4f}-"
          f"{float(c_w[c_first[:P]].max()):.4f}; max abs err "
          f"{float((w - c_w).abs().max()):.3e}, {int(excused.sum())} "
          f"positives within 2 x {gap:.3e} (the devices' largest IoU "
          f"difference) of another's IoU in their class, {bad} differing "
          f"beyond {ISR_TOL} elsewhere [{card}]")
    if bad or not n_pos:
        raise AssertionError(f"pisa: {bad} ISR-P weights differ card vs CPU")


def family_steps(key, cfg, dev, n_steps=3, base_lr=None, ghm=False):
    """``n_steps`` steps of FAMILIES[key] from the seeded init on ``dev``
    on B=2 batches of DENSE_CMP_HW (one batch, or with ``base_lr`` a batch
    of its own seed each step and that learning rate), cfg's optimizer:
    (the running buffers after them, the last losses, and with ``ghm``
    each GHM loss call's bin indices (ghm_bins), else None), moved to the
    CPU."""
    from dskd_tpu_torch.train.family import make_family_train_step

    fam = FAMILIES[key]
    if base_lr is not None:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, base_lr=base_lr))
    student, teacher = fam["models"](cfg, dev)
    state = train_state(cfg, student)
    step = make_family_train_step(cfg.model.arch, student, cfg, num_prev=0,
                                  has_teacher=True)
    calls = [] if ghm else None
    with ghm_bins(calls) if ghm else contextlib.nullcontext():
        for i in range(n_steps):
            batch = family_batch(dev, 2, DENSE_CMP_HW, fam["max_gt"](cfg),
                                 seed=7 if base_lr is None else 7 + i)
            state, losses = step(state, batch, teacher)
    return ({k: v.cpu() for k, v in student.state_dict().items()
             if k.endswith(("running_mean", "running_var"))
             or k.startswith("ghm_acc_")},
            {k: v.cpu() for k, v in losses.items()}, calls)


def cpu_family_steps(key, cfg, n_steps=3, base_lr=None, ghm=False):
    """family_steps on the CPU, with FPG's and NAS-FPN's stacks cut as
    phase 15 cuts them: the CPU worker's job for GHM and NAS-FPN."""
    with cut_stacks(key):
        return family_steps(key, cfg, "cpu", n_steps, base_lr, ghm)


# the arguments of each family's cpu_family_steps after (key, cfg)
STEPS_VS_CPU = {"retinanet_ghm": (3, None, True),
                "retinanet_nasfpn": (3, 0.0, False)}


def steps_vs_cpu(fam, cfg):
    """family_steps on the card and (from the CPU worker where one runs)
    on the CPU, with the family's STEPS_VS_CPU arguments: {device: its
    result}."""
    args = STEPS_VS_CPU[fam["key"]]
    return {DEVICE: family_steps(fam["key"], cfg, DEVICE, *args),
            "cpu": cpu_result(cpu_family_steps, fam["key"], cfg, *args)}


@contextlib.contextmanager
def ghm_bins(calls):
    """Append each GHM loss call's bin indices (int8, on the CPU) to
    ``calls`` while the block runs."""
    from dskd_tpu_torch.core import losses as L

    weights = L._ghm_weights

    def recording(g, valid, tot, edges, bins, momentum, acc_sum):
        idx = (torch.searchsorted(edges, g.reshape(-1).contiguous(),
                                  right=True) - 1).clamp(0, bins - 1)
        calls.append(torch.where(valid.reshape(-1), idx, -1).to(
            torch.int8).cpu())
        return weights(g, valid, tot, edges, bins, momentum, acc_sum)

    L._ghm_weights = recording
    try:
        yield
    finally:
        L._ghm_weights = weights


def check_ghm(fam, cfg, card, student, teacher, batch):
    """check_dense (max-IoU), then three family steps card and CPU from the
    seeded init on B=2 of DENSE_CMP_HW: GHM-C's and GHM-R's EMAs after them
    within GHM_EMA_TOL, with the count of elements whose gradient norm fell
    in another bin on the card than on the CPU."""
    check_dense(fam, cfg, card, student, teacher, batch)
    res = steps_vs_cpu(fam, cfg)
    (bufs, losses, calls), (c_bufs, c_losses, c_calls) = (res[DEVICE],
                                                          res["cpu"])
    moved = [int((a != b).sum()) for a, b in zip(calls, c_calls)]
    n_elem = sum(int((b >= 0).sum()) for b in c_calls)
    for k in ("ghm_acc_c", "ghm_acc_r"):
        print(f"ghm {k} after 3 steps (B=2, {DENSE_CMP_HW[0]}x"
              f"{DENSE_CMP_HW[1]}): card {bufs[k].tolist()} max abs err "
              f"{float((bufs[k] - c_bufs[k]).abs().max()):.4f} (tolerance "
              f"{GHM_EMA_TOL}) [{card}]")
        torch.testing.assert_close(bufs[k], c_bufs[k], **GHM_EMA_TOL, msg=k)
    print(f"ghm: {sum(moved)} of {n_elem} valid elements in the 3 steps' "
          f"{len(moved)} GHM calls fell in another bin on the card than on "
          f"the CPU (per call {moved}); last losses card "
          f"{ {k: round(float(v), 6) for k, v in losses.items()} } CPU "
          f"{ {k: round(float(v), 6) for k, v in c_losses.items()} }")


def check_nasfpn(fam, cfg, card, student, teacher, batch):
    """check_dense (max-IoU), then three family steps card and CPU from the
    seeded init, each on a B=2 batch of DENSE_CMP_HW of its own, at
    learning rate 0: every running buffer after them within BN_TOL; the
    SepBN head's have moved, NAS-FPN's have not (JAX's RetinaNet runs the
    neck on its running statistics). At the config's learning rate AdamW's
    first update, lr x sign(gradient) wherever the gradient is near 0,
    takes the two devices' weights apart by up to 2 lr on such elements,
    and the statistics of the steps after with them."""
    check_dense(fam, cfg, card, student, teacher, batch)
    res = steps_vs_cpu(fam, cfg)
    (bufs, _, _), (c_bufs, _, _) = res[DEVICE], res["cpu"]
    err = {k: float((bufs[k] - v).abs().max()) for k, v in c_bufs.items()}
    for k, v in c_bufs.items():
        torch.testing.assert_close(bufs[k], v, **BN_TOL, msg=k)
    # the seeded init's statistics: mean 0, variance 1
    moved = sorted(k for k, v in c_bufs.items() if not torch.equal(
        v, torch.full_like(v, float(k.endswith("running_var")))))
    neck = [k for k in moved if k.startswith("neck.")]
    print(f"nasfpn: {len(err)} running buffers after 3 steps at lr 0 (B=2, "
          f"{DENSE_CMP_HW[0]}x{DENSE_CMP_HW[1]}, three batches) card vs CPU "
          f"within {BN_TOL}, largest abs err {max(err.values()):.3e} "
          f"({max(err, key=err.get)}); moved: {len(moved)}, all in the "
          f"SepBN head {not neck} [{card}]")
    if neck or not moved:
        raise AssertionError(f"nasfpn: moved running buffers {moved[:6]}")


def check_external_teacher_run(card, config, sets=()):
    """LD or LAD through the train_increment CLI's config path and
    ``run_incremental``: one task (the config's catsplit (80,)) of 2 steps
    at B=2 on a synthetic COCO (4 train, 2 val images), eval after it, with
    an external teacher: a ResNet-101 model (seed 1) that the port writes
    as its own checkpoint, which ``build_teacher_model`` must rebuild and
    load bit for bit."""
    import tempfile

    from dskd_tpu_torch.data.coco import COCO_CLASSES_ALPHA_ORDER
    from dskd_tpu_torch.registry import get_family
    from dskd_tpu_torch.tools.train_increment import build_parser, \
        config_from_args
    from dskd_tpu_torch.train import incremental
    from dskd_tpu_torch.train.checkpoint import save_checkpoint
    from dskd_tpu_torch.train.optim import make_optimizer
    from dskd_tpu_torch.train.schedule import step_lr_schedule
    from dskd_tpu_torch.train.state import TrainState

    with tempfile.TemporaryDirectory() as root:
        cats = [cid for _, cid in COCO_CLASSES_ALPHA_ORDER]
        shapes = ((480, 640), (640, 480))
        train_ann, train_dir = write_coco(root, "train", shapes * 2, cats,
                                          seed=0)
        val_ann, val_dir = write_coco(root, "val", shapes, cats, seed=1)
        work = os.path.join(root, "work")
        cfg = config_from_args(build_parser().parse_args([
            config, "--work-dir", work, "--seed", "0", "--set",
            f"data.train_ann={train_ann}", f"data.val_ann={val_ann}",
            f"data.train_img_prefix={train_dir}",
            f"data.val_img_prefix={val_dir}", "data.samples_per_device=2",
            "data.num_workers=0", "train.max_iters_per_task=2",
            "train.eval_interval=1", "train.log_interval=1", *sets]))
        arch = cfg.model.arch
        teacher = incremental.build_teacher_model(cfg, DEVICE)
        get_family(arch)["init_weights"](teacher, 1)
        path = os.path.dirname(save_checkpoint(
            os.path.join(root, "teacher"), 1, 12, TrainState.create(
                teacher, make_optimizer(teacher, step_lr_schedule(1e-5)),
                seed=0)))
        seen, train_one_task = [], incremental.train_one_task

        def capture(model, cfg, tid, task_nums, teacher=None, device="cuda"):
            seen.append(teacher)
            return train_one_task(model, cfg, tid, task_nums, teacher, device)

        incremental.train_one_task = capture
        t0 = time.perf_counter()
        try:
            incremental.run_incremental(cfg, teacher_ckpt=path, device=DEVICE)
        finally:
            incremental.train_one_task = train_one_task
        wall = time.perf_counter() - t0
        rows = [json.loads(line) for name in sorted(os.listdir(work))
                if name.endswith(".log.json")
                for line in open(os.path.join(work, name))]
    train = [r for r in rows if r["mode"] == "train"]
    val = [r for r in rows if r["mode"] == "val"]
    ext = seen[0] if seen else None
    same = ext is not None and all(
        torch.equal(t, teacher.state_dict()[k])
        for k, t in ext.state_dict().items())
    print(f"{arch} run_incremental, one task of {len(train)} steps (B=2, "
          f"{tuple(cfg.data.bucket)}) with the external ResNet-"
          f"{cfg.model.teacher_depth} teacher the port wrote: teacher "
          f"layer3 of {0 if ext is None else len(ext.backbone.layer3)} "
          f"blocks, its weights the checkpoint's bit for bit {same}; "
          f"ms/step {[round(r['time'] * 1e3, 3) for r in train]} (the "
          f"row's mean of the epoch so far), losses "
          f"{[round(r['loss'], 5) for r in train]}, val bbox_mAP "
          f"{val[0]['bbox_mAP'] if val else None}; run_incremental {wall:.3f} "
          f"s [{card}]")
    if not (same and len(ext.backbone.layer3) == 23 and len(train) == 2
            and len(val) == 1 and len(seen) == 1
            and all(np.isfinite(r["loss"]) for r in train)
            and (arch != "ld" or all(r["loss_ld"] > 0 for r in train))):
        raise AssertionError(f"{arch}: the run with the external teacher: "
                             f"{train} {val}")


for _arch, _desc in (
        ("ld", "GFL head, integral over 17 bins, R101 teacher"),
        ("paa", "PAA head (GN towers, IoU branch), one anchor per position"),
        ("lad", "PAA head, R101 PAA teacher assigning"),
        ("pisa_retinanet", "RetinaNet head, ISR-P + CARL"),
        ("retinanet_ghm", "RetinaNet head, GHM-C + GHM-R"),
        ("retinanet_fpg", f"RetinaNet head on FPG's "
                          f"{VARIANT_STACKS['retinanet_fpg']} stacks (of 9)"),
        ("retinanet_nasfpn", f"RetinaSepBNHead on NAS-FPN's "
                             f"{VARIANT_STACKS['retinanet_nasfpn']} stacks "
                             f"(of 7)")):
    _neck = {"retinanet_fpg": "FPG-256 P2-P6",
             "retinanet_nasfpn": "NAS-FPN-256 P2-P6"}.get(_arch,
                                                         "FPN-256 P3-P7")
    FAMILIES[_arch] = dict(
        FAMILIES["retinanet"], tag=_arch, models=variant_models,
        grad_params=VARIANT_GRAD_PARAMS.get(_arch, VARIANT_GRAD_PARAMS.get(
            dense_kind(_arch))),
        describe=(lambda m, d=_desc, n=_neck: f"ResNet-{m.depth}, {n}, "
                  f"4-conv towers, {d}"),
        thread_spread_params=(),
        train_checks={"paa": check_paa, "lad": check_paa,
                      "pisa_retinanet": check_pisa,
                      "retinanet_ghm": check_ghm,
                      "retinanet_nasfpn": check_nasfpn}.get(_arch,
                                                            check_dense))


@contextlib.contextmanager
def summed_counts():
    """The port kernels' counts summed over the block (every reset_counts
    inside it adds the counts so far to the sum), yielded as a dict that
    holds the sum once the block ends."""
    total = dict.fromkeys(counters(), 0)
    reset = globals()["reset_counts"]

    def accumulating():
        for k, v in read_counts().items():
            total[k] += v
        reset()

    globals()["reset_counts"] = accumulating
    try:
        yield total
        accumulating()
    finally:
        globals()["reset_counts"] = reset


_STACKS_CUT = set()


@contextlib.contextmanager
def cut_stacks(arch):
    """The port's RetinaNet builds FPG or NAS-FPN with VARIANT_STACKS[arch]
    stacks while the block runs (any other arch: unchanged)."""
    from dskd_tpu_torch.models import retinanet

    name = {"retinanet_fpg": "FPG", "retinanet_nasfpn": "NASFPN"}.get(arch)
    if name is None or arch in _STACKS_CUT:
        yield
        return
    _STACKS_CUT.add(arch)
    neck = getattr(retinanet, name)
    setattr(retinanet, name, lambda *a, **kw: neck(
        *a, **kw, stack_times=VARIANT_STACKS[arch]))
    try:
        yield
    finally:
        setattr(retinanet, name, neck)
        _STACKS_CUT.discard(arch)


def check_variant_families(card):
    """Phase 15: LD (R18 student, R101 teacher), PAA, LAD (R50, R101
    teacher) and the RetinaNet variants PISA, GHM (R50, FPN), FPG and
    NAS-FPN (R50, 640x640, VARIANT_STACKS stacks) through check_family at
    their configs' canvas and full width, f32, seeded weights: the 800x1344
    configs at B=2, the 640x640 ones at B=8, GT padded to the config's
    max_gt. Each: serving at B=1 and B=2, three steps, a profile, the peak
    memory, its own checks (the assignment: ATSS's for LD, PAA's positives
    for PAA and LAD, max-IoU for the variants; PISA's ISR-P weights, GHM's
    EMAs and NAS-FPN's running statistics after three steps; the decode)
    and a step against the CPU on DENSE_CMP_HW; LD and LAD also
    run_incremental with an external ResNet-101 teacher. Every port
    kernel's count stays 0 over the phase."""
    from dskd_tpu_torch.utils.config import apply_overrides, load_config

    with summed_counts() as total:
        for arch, config in VARIANT_CONFIGS.items():
            t0 = time.perf_counter()
            cfg = load_config(config)
            n_train = 8 if tuple(cfg.data.bucket) == (640, 640) else 2
            cfg = apply_overrides(cfg, list(VARIANT_SETS))
            with cut_stacks(arch):
                check_family(card, arch, config, VARIANT_SETS,
                             n_train=n_train, hw=tuple(cfg.data.bucket),
                             incremental=False)
            if cfg.model.teacher_depth:
                with card_alone():
                    check_external_teacher_run(card, config, VARIANT_SETS)
            print(f"{arch}: {time.perf_counter() - t0:.1f} s of phase 15")
    print(f"phase 15: port kernel launches over the phase {total}")
    if any(total.values()):
        raise AssertionError(f"phase 15 launched port kernels: {total}")


# --- deformable convolution and the DCN families (phase 16) ------------------

DCN_CONFIGS = {key: os.path.join(ROOT, "configs", f"{name}.py")
               for key, name in (("atss_dyhead", "atss_r50_dyhead_1x"),
                                 ("nasfcos", "nasfcos_r50_1x"),
                                 ("vfnet", "vfnet_r50_1x"),
                                 ("reppoints", "reppoints_moment_r50_1x"))}
DCN_SETS = ()             # the configs as they are (a rehearsal cuts them)
DCN_HW = (100, 168)       # DyHead's P3 on 800x1344
DCN_TOL = dict(rtol=1e-4, atol=1e-4)    # deform_conv2d forward, card vs CPU
DCN_GRAD_REL_TOL = 1e-4                 # its gradients, relative L2
# the head's and the last DyHead block's gradients (the FPN lateral's, held
# loosely in phase 14, and the necks' behind the towers are left out)
_BLOCK5 = "dyhead.dyhead_blocks.5."
DCN_GRAD_PARAMS = {
    "atss_dyhead": tuple(_BLOCK5 + k for k in (
        "spatial_conv_offset.weight", "spatial_conv_mid.conv.weight",
        "spatial_conv_low.conv.weight", "spatial_conv_high.conv.weight")) + (
        "bbox_head.atss_cls.weight", "bbox_head.atss_reg.weight",
        "bbox_head.atss_centerness.weight"),
    "nasfcos": ("bbox_head.cls_convs.3.conv.weight",
                "bbox_head.reg_convs.3.conv.weight",
                "bbox_head.conv_cls.weight", "bbox_head.conv_reg.weight",
                "bbox_head.conv_centerness.weight"),
    "vfnet": ("bbox_head.vfnet_reg_refine_dconv.weight",
              "bbox_head.vfnet_cls_dconv.weight", "bbox_head.vfnet_cls.weight",
              "bbox_head.vfnet_reg.weight", "bbox_head.vfnet_reg_refine.weight",
              "bbox_head.reg_convs.2.conv.weight"),
    "reppoints": ("bbox_head.reppoints_cls_conv.weight",
                  "bbox_head.reppoints_pts_refine_conv.weight",
                  "bbox_head.reppoints_cls_out.weight",
                  "bbox_head.reppoints_pts_init_out.weight",
                  "bbox_head.reppoints_pts_refine_out.weight")}


def deform_case(gen, modulated, stride, offsets, hw):
    """B=2 inputs of deform_conv2d at ``hw`` with 256 channels in and out:
    x, offsets (zero, or N(0, 3 px) with every tap of the first output row
    20 px above the map), the weight, the mask (v2), the cotangent."""
    (H, W), C = hw, 256
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = torch.randn(2, H, W, C, generator=gen)
    if offsets == "zero":
        off = torch.zeros(2, Ho, Wo, 18)
    else:
        off = torch.randn(2, Ho, Wo, 18, generator=gen) * 3
        off[:, 0, :, 0::2] = -20.0
    weight = torch.randn(C, C, 3, 3, generator=gen) / (9 * C) ** 0.5
    mask = (torch.sigmoid(torch.randn(2, Ho, Wo, 9, generator=gen))
            if modulated else None)
    cot = torch.randn(2, Ho, Wo, C, generator=gen)
    return x, off, weight, mask, cot


def check_deform_conv(card, gen):
    """deform_conv2d on the card against the CPU at DyHead's P3 (B=2,
    100x168, 256 channels in and out): v1 stride 1 with offsets a few
    pixels off, v2 stride 1 at zero offsets (every sample on a pixel, the
    offset gradient one-sided), v2 stride 2 off, v1 stride 2 at zero; the
    forward within DCN_TOL, the gradients of x, offsets, weight and mask
    within DCN_GRAD_REL_TOL relative L2; device ms of the forward and of
    forward + backward, and the peak memory of the latter."""
    from dskd_tpu_torch.ops.deform_conv import deform_conv2d

    for modulated, stride, offsets in ((False, 1, "random"),
                                       (True, 1, "zero"),
                                       (True, 2, "random"),
                                       (False, 2, "zero")):
        case = deform_case(gen, modulated, stride, offsets, DCN_HW)
        res = {}
        for dev in (DEVICE, "cpu"):
            # detach: .to("cpu") of a CPU tensor is the tensor itself
            x, off, w, mask = (None if t is None else
                               t.to(dev).detach().requires_grad_()
                               for t in case[:4])
            out = deform_conv2d(x, off, w, stride=stride, mask=mask)
            (out * case[4].to(dev)).sum().backward()
            res[dev] = [out.detach().cpu()] + [
                t.grad.cpu() for t in (x, off, w, mask) if t is not None]
        (out, *grads), (c_out, *c_grads) = res[DEVICE], res["cpu"]
        torch.testing.assert_close(out, c_out, **DCN_TOL)
        rels = [rel_l2(g, c) for g, c in zip(grads, c_grads)]
        H, W = DCN_HW
        Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        ys = (torch.arange(Ho)[:, None, None] * stride - 1
              + torch.arange(3).repeat_interleave(3) + case[1][..., 0::2])
        xs = (torch.arange(Wo)[None, :, None] * stride - 1
              + torch.arange(3).repeat(3) + case[1][..., 1::2])
        gone = ((ys <= -1) | (ys >= H) | (xs <= -1) | (xs >= W)).float()
        x, off, w, mask = (None if t is None else t.to(DEVICE)
                           for t in case[:4])
        with torch.no_grad():
            fwd_ms = device_ms(lambda: deform_conv2d(
                x, off, w, stride=stride, mask=mask), iters=5, warmup=1)
        ts = [None if t is None else t.requires_grad_() for t in
              (x, off, w, mask)]
        cot = case[4].to(DEVICE)

        def fwd_bwd():
            (deform_conv2d(ts[0], ts[1], ts[2], stride=stride, mask=ts[3])
             * cot).sum().backward()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fwd_bwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        both_ms = device_ms(fwd_bwd, iters=5, warmup=1)
        print(f"deform_conv2d {'v2' if modulated else 'v1'} stride {stride} "
              f"offsets {offsets} (B=2, {H}x{W} in, {Ho}x{Wo} out, 256 -> "
              f"256, f32): {float(gone.mean()):.2%} of the taps wholly "
              f"outside the map; card vs CPU forward max abs err "
              f"{float((out - c_out).abs().max()):.3e} (tolerance {DCN_TOL}),"
              f" gradients x / offsets / weight{' / mask' * modulated} "
              f"relative L2 {' / '.join(f'{r:.3e}' for r in rels)} "
              f"(tolerance {DCN_GRAD_REL_TOL}); forward {fwd_ms:.3f} ms, "
              f"forward + backward {both_ms:.3f} ms (device), forward + "
              f"backward peak {peak / 2 ** 30:.3f} GiB above its inputs "
              f"[{card}]")
        if not all(r <= DCN_GRAD_REL_TOL for r in rels):
            raise AssertionError(f"deform_conv2d gradients differ card vs "
                                 f"CPU: {rels}")


def dcn_share(fam, cfg, card, student, teacher, batch):
    """The deformable convs' share of one family forward + backward's
    device time: the step's deform_conv2d calls are recorded by shape, each
    shape timed alone forward + backward on random inputs (device ms),
    summed over the calls, and set against the profiled busy ms."""
    from dskd_tpu_torch.ops import deform_conv as dc
    from dskd_tpu_torch.registry import get_family
    from dskd_tpu_torch.train.step import parse_losses

    losses_fn = get_family(cfg.model.arch)["losses"](
        None, cfg, num_prev=0, has_teacher=False, use_dropout=False)
    calls = {}
    plain = dc.deform_conv2d

    def recording(x, offsets, weight, bias=None, stride=1, padding=1,
                  dilation=1, mask=None):
        key = (tuple(x.shape), tuple(weight.shape), stride, mask is not None)
        calls[key] = calls.get(key, 0) + 1
        return plain(x, offsets, weight, bias, stride, padding, dilation,
                     mask)

    def fwd_bwd():
        student.zero_grad(set_to_none=True)
        parse_losses(losses_fn(student, batch, teacher, None)).backward()

    n = batch.images.shape[0]
    dc.deform_conv2d = recording
    try:
        busy = profile(fwd_bwd, f"one {fam['tag']} B={n} f32 forward + "
                       f"backward", top=8)
    finally:
        dc.deform_conv2d = plain
    student.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(17)
    dcn_ms = 0.0
    for (xs, ws, stride, modulated), count in calls.items():
        x = torch.randn(xs, generator=gen).to(DEVICE).requires_grad_()
        Ho, Wo = (xs[1] - 1) // stride + 1, (xs[2] - 1) // stride + 1
        off = (torch.randn(xs[0], Ho, Wo, 18, generator=gen) * 2).to(
            DEVICE).requires_grad_()
        w = (torch.randn(ws, generator=gen) * 0.01).to(DEVICE)
        w.requires_grad_()
        mask = (torch.rand(xs[0], Ho, Wo, 9, generator=gen).to(DEVICE)
                .requires_grad_() if modulated else None)
        ms = device_ms(lambda: plain(x, off, w, stride=stride,
                                     mask=mask).sum().backward(),
                       iters=3, warmup=1)
        dcn_ms += ms * (count // 2)         # profile() ran fwd_bwd twice
    print(f"{fam['tag']}: {sum(calls.values()) // 2} deform_conv2d calls "
          f"in one forward + backward, {len(calls)} shapes; timed alone "
          f"they take {dcn_ms:.3f} device ms of the profiled {busy:.3f} ms "
          f"busy: {dcn_ms / busy:.1%} [{card}]")


def redraw_dyhead_offsets(model):
    """Every DyHead offset conv's kernel 4x lecun-normal from a CPU
    generator (the same on each device): its offsets leave the pixel grid
    by about a pixel and more, and its mask logits spread."""
    from dskd_tpu_torch.models.detector import lecun_

    g = torch.Generator().manual_seed(19)
    with torch.no_grad():
        for blk in model.dyhead.dyhead_blocks:
            w = blk.spatial_conv_offset.weight
            lecun_(w, g)
            w.mul_(4.0)


def check_reppoints(fam, cfg, card, student, batch):
    """The point assignment of the training batch's GT and the refined
    stage's max-IoU assignment on the student's decoded initial boxes
    (computed once, on the card) on the card equal the CPU's exactly."""
    from dskd_tpu_torch.core.max_iou_assigner import max_iou_assign
    from dskd_tpu_torch.models import reppoints as R
    from dskd_tpu_torch.models.gfl_head import cat_levels

    C = cfg.model.num_classes
    lcfg = R.RepPointsLossConfig(num_classes=C)
    with torch.no_grad():
        out = student(batch.images, batch.img_hw)
        centers, strides, counts = R.reppoints_centers(
            [c.shape[1:3] for c in out.head.cls_scores], DEVICE)
        boxes = R._decoded_boxes(cat_levels(out.head.pts_init, 18), centers,
                                 strides, out.moment)
    res = {}
    for dev in (DEVICE, "cpu"):
        b = batch.to(dev)
        gt = (b.gt_bboxes, b.gt_labels, b.gt_valid)
        a_init, pos_i, _ = R.point_assign(centers.to(dev), counts, *gt, C)
        ref = max_iou_assign(boxes.to(dev), *gt, C,
                             pos_iou_thr=lcfg.refine_pos_iou,
                             neg_iou_thr=lcfg.refine_neg_iou,
                             min_pos_iou=0.0, match_low_quality=True)
        res[dev] = [t.cpu() for t in (a_init, ref.assigned_gt, ref.labels,
                                      ref.max_ious)]
    exact = all(torch.equal(a, c) for a, c in zip(res[DEVICE], res["cpu"]))
    a_init, a_ref = res["cpu"][:2]
    print(f"reppoints assignment, card vs CPU on the training batch (B="
          f"{batch.images.shape[0]}, {tuple(batch.images.shape[1:3])}, "
          f"{a_init.shape[1]} cells, GT padded to {batch.gt_valid.shape[1]} "
          f"of which {batch.gt_valid.sum(1).tolist()} valid): point stage "
          f"positives {(a_init >= 0).sum(1).tolist()}; refine stage on the "
          f"card's initial boxes positives {(a_ref >= 0).sum(1).tolist()}, "
          f"ignored {(a_ref == -2).sum(1).tolist()}, largest IoU "
          f"{float(res['cpu'][3].max()):.4f}; equal {exact} [{card}]")
    if not exact or not bool((a_init >= 0).any(1).all()):
        raise AssertionError("reppoints: the card's assignment differs from "
                             "the CPU's (or has no positive)")


def check_dcn(fam, cfg, card, student, teacher, batch):
    """Phase 16's family check: the assignment and the decode against the
    CPU (check_dense; RepPoints' two stages in check_reppoints); NAS-FCOS's
    neck BatchNorms still at their seeded statistics after the steps;
    the deformable convs' share of the device time; ATSS-DyHead's step
    against the CPU once more with its offset convs redrawn."""
    arch = cfg.model.arch
    if arch == "reppoints":
        check_reppoints(fam, cfg, card, student, batch)
        check_dense_decode(fam, cfg, card)
    else:
        check_dense(fam, cfg, card, student, teacher, batch)
    if arch == "nasfcos":
        bufs = {k: v for k, v in student.neck.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}
        moved = [k for k, v in bufs.items() if not torch.equal(
            v, torch.full_like(v, float(k.endswith("running_var"))))]
        print(f"nasfcos: {len(bufs)} neck BatchNorm buffers after the "
              f"steps, {len(moved)} moved from the seeded statistics")
        if moved:
            raise AssertionError(f"nasfcos: neck buffers moved {moved[:6]}")
    else:
        with card_alone():
            dcn_share(fam, cfg, card, student, teacher, batch)
    if fam["tag"] == "atss_dyhead":
        check_family_card_vs_cpu(fam, cfg, card, torch.float32,
                                 hw=DENSE_CMP_HW,
                                 tag="atss_dyhead, offset convs redrawn",
                                 prepare="redraw_dyhead_offsets")


for _key, _desc in (
        ("atss_dyhead", "FPN-256 P3-P7, {} DyHead blocks, ATSS head "
                        "without towers"),
        ("nasfcos", "NAS-FCOS neck P3-P7, 4-conv towers, FCOS head"),
        ("vfnet", "FPN-256 P3-P7, 3-conv towers, star-DCN refine and cls"),
        ("reppoints", "FPN-256 P3-P7, 3-conv towers, DCNs on 9 points")):
    FAMILIES[_key] = dict(
        FAMILIES["atss"], tag=_key, grad_params=DCN_GRAD_PARAMS[_key],
        describe=(lambda m, d=_desc: f"ResNet-{m.depth}, "
                  f"{d.format(m.dyhead_blocks)}"),
        thread_spread_params=(), train_checks=check_dcn)
# DyHead's outputs spread less than an FPN level, and VFNet's star taps
# fall mostly outside the maps at the init: their class logits pass 0.05
# with a class bias of -2 and -3
FAMILIES["atss_dyhead"]["decode_bias"] = -2.0
FAMILIES["vfnet"]["decode_bias"] = -3.0
for _key, _fam in FAMILIES.items():
    _fam["key"] = _key


def check_dcn_families(card):
    """Phase 16: check_deform_conv, then ATSS-DyHead, NAS-FCOS, VFNet and
    RepPoints through check_family at their configs' 800x1344 canvas and
    full width and depth, f32, seeded weights, B=2 with GT padded to the
    config's max_gt, with check_dcn as their own checks. Every port
    kernel's count stays 0 over the phase."""
    from dskd_tpu_torch.utils.config import apply_overrides, load_config

    with summed_counts() as total:
        t0 = time.perf_counter()
        check_deform_conv(card, torch.Generator().manual_seed(16))
        print(f"deform_conv2d: {time.perf_counter() - t0:.1f} s of phase 16")
        for key, config in DCN_CONFIGS.items():
            t0 = time.perf_counter()
            cfg = apply_overrides(load_config(config), list(DCN_SETS))
            check_family(card, cfg.model.arch, config, DCN_SETS, n_train=2,
                         hw=tuple(cfg.data.bucket), incremental=False,
                         family=key)
            print(f"{key}: {time.perf_counter() - t0:.1f} s of phase 16")
    print(f"phase 16: port kernel launches over the phase {total}")
    if any(total.values()):
        raise AssertionError(f"phase 16 launched port kernels: {total}")


# --- TOOD, FSAF, FoveaBox, AutoAssign, FreeAnchor, SABL (phase 17) ----------

HEAD_CONFIGS = {key: os.path.join(ROOT, "configs", f"{name}.py")
                for key, name in (("tood", "tood_r50_1x"),
                                  ("fsaf", "fsaf_r50_1x"),
                                  ("foveabox", "foveabox_r50_1x"),
                                  ("autoassign", "autoassign_r50_1x"),
                                  ("free_anchor",
                                   "retinanet_free_anchor_r50_1x"),
                                  ("sabl_retina", "sabl_retinanet_r50_1x"))}
HEAD_SETS = ()            # the configs as they are (a rehearsal cuts them)
# the head's gradients (the FPN lateral's, held loosely in phase 14, is
# left out); AutoAssign's centre prior belongs to the detector
_TOWERS = ("bbox_head.cls_convs.3.conv.weight",
           "bbox_head.reg_convs.3.conv.weight")
_CONV_OUT = ("bbox_head.conv_cls.weight", "bbox_head.conv_reg.weight")
HEAD_GRAD_PARAMS = {
    "tood": ("bbox_head.tood_cls.weight", "bbox_head.tood_reg.weight",
             "bbox_head.cls_prob_module.2.weight",
             "bbox_head.reg_offset_module.2.weight",
             "bbox_head.cls_decomp.reduction_conv.conv.weight",
             "bbox_head.inter_convs.5.conv.weight"),
    "fsaf": _TOWERS + _CONV_OUT,
    "foveabox": _TOWERS + _CONV_OUT,
    "autoassign": _TOWERS + _CONV_OUT + (
        "bbox_head.conv_objectness.weight", "center_prior_mean",
        "center_prior_sigma"),
    "free_anchor": _TOWERS + _RETINA_OUT,
    "sabl_retina": _TOWERS + ("bbox_head.retina_cls.weight",
                              "bbox_head.retina_bbox_cls.weight",
                              "bbox_head.retina_bbox_reg.weight")}
SIDES_REL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
BOX_PROB_ATOL = 1e-3      # FreeAnchor's P(anchor in A+), card vs CPU
NEG_W_ATOL = 1e-3         # AutoAssign's negative weights, card vs CPU
BUCKET_TOL = dict(rtol=1e-5, atol=1e-4)   # SABL's bucket offsets


def head_outputs(student, batch, device):
    """The student's head outputs of the training batch (computed on the
    card, once) moved to ``device``, and the batch's GT there."""
    with torch.no_grad():
        out = student(batch.images, batch.img_hw)
    head = type(out.head)(*(tuple(t.to(device) for t in f)
                            for f in out.head))
    gt = (batch.gt_bboxes.to(device), batch.gt_labels.to(device),
          batch.gt_valid.to(device))
    return out, head, gt


def check_sample_sides(card, gen):
    """TOOD's per-corner sampling (``_sample_sides``) on the card against
    the CPU at P3's shape (B=2, 100x168) with offsets 2e-3 at most from
    the integers -2..2, as the init's normal(0.001) convs put them, so
    that ``floor`` picks the neighbour: the values and the gradients of
    the corner maps and of the offsets within SIDES_REL_TOL relative L2,
    in f32 and f64, with the count of floors that differ."""
    from dskd_tpu_torch.models.tood import _sample_sides

    B, H, W = 2, 100, 168
    corners = torch.randn(B, H, W, 4, generator=gen) * 20 + 80
    off = (torch.randint(-2, 3, (B, H, W, 8), generator=gen).float()
           + (torch.rand(B, H, W, 8, generator=gen) * 2 - 1) * 2e-3)
    cot = torch.randn(B, H, W, 4, generator=gen)
    for dtype in (torch.float32, torch.float64):
        res = {}
        for dev in (DEVICE, "cpu"):
            # detach: .to() of a CPU tensor in its own dtype is the tensor
            c = corners.to(dev, dtype).detach().requires_grad_()
            o = off.to(dev, dtype).detach().requires_grad_()
            v = _sample_sides(c, o)
            (v * cot.to(dev, dtype)).sum().backward()
            grid = torch.arange(H, dtype=dtype, device=dev)[:, None, None]
            floors = torch.floor(grid + o.detach()[..., 0::2])
            res[dev] = [t.cpu() for t in (v.detach(), c.grad, o.grad,
                                          floors)]
        rels = [rel_l2(g, w) for g, w in zip(res[DEVICE][:3],
                                             res["cpu"][:3])]
        n_floor = int((res[DEVICE][3] != res["cpu"][3]).sum())
        print(f"tood _sample_sides, card vs CPU (B={B}, {H}x{W}, {dtype}, "
              f"offsets within 2e-3 of -2..2): values / corner-map grad / "
              f"offset grad relative L2 "
              f"{' / '.join(f'{r:.3e}' for r in rels)} (tolerance "
              f"{SIDES_REL_TOL[dtype]}); {n_floor} of "
              f"{res['cpu'][3].numel()} row floors differ [{card}]")
        if n_floor or not all(r <= SIDES_REL_TOL[dtype] for r in rels):
            raise AssertionError(f"tood: _sample_sides differs card vs CPU "
                                 f"in {dtype}: {rels}, {n_floor} floors")


def check_tood(fam, cfg, card, student, batch):
    """TOOD's task-aligned positives and labels on the training batch,
    from the card's head outputs, card against CPU: a candidate that only
    one device takes must stand within twice the devices' largest
    alignment difference of its GT's k-th value (or of the 1e-12 floor),
    and a positive that moves to another GT must have its two best IoUs
    that close; then check_sample_sides."""
    from dskd_tpu_torch.models import tood as T
    from dskd_tpu_torch.models.gfl_head import cat_levels

    C = cfg.model.num_classes
    res = {}
    for dev in (DEVICE, "cpu"):
        _, h, gt = head_outputs(student, batch, dev)
        points = T.tood_points([c.shape[1:3] for c in h.cls_scores], dev)[0]
        args = (cat_levels(h.cls_scores, C), cat_levels(h.bbox_preds, 4),
                points, *gt, C)
        cand = T.tal_candidates(*args)
        r = T.task_aligned_assign(*args)
        res[dev] = [t.cpu() for t in (*cand, r.pos, r.labels,
                                      r.assigned_gt)]
    ious, align, kth, is_pos, pos, labels, a = res[DEVICE]
    c_ious, c_align, c_kth, c_is_pos, c_pos, c_labels, c_a = res["cpu"]
    valid = batch.gt_valid.cpu()[:, None].expand_as(align)
    gap = float((align - c_align)[valid].abs().max())
    iou_gap = float((ious - c_ious)[valid].abs().max())
    one_side = is_pos != c_is_pos
    near = (c_align - c_kth.clamp(min=1e-12)).abs() <= 2 * gap
    best2 = torch.where(c_is_pos, c_ious, torch.full_like(c_ious, -1.0)) \
        .topk(2, dim=2).values
    tie = (best2[..., 0] - best2[..., 1]).abs() <= 2 * iou_gap
    moved = (pos != c_pos) | (labels != c_labels) | (c_pos & (a != c_a))
    bad = int((one_side & ~near).sum()) + int(
        (moved & ~(one_side.any(2) | tie)).sum())
    print(f"tood task-aligned assignment, card vs CPU on the training batch "
          f"(B={batch.images.shape[0]}, {tuple(batch.images.shape[1:3])}, "
          f"{pos.shape[1]} points, GT padded to {batch.gt_valid.shape[1]} "
          f"of which {batch.gt_valid.sum(1).tolist()} valid): positives per "
          f"image card {pos.sum(1).tolist()} CPU {c_pos.sum(1).tolist()}, "
          f"candidates per GT above 13: {int((c_is_pos.sum(1) > 13).sum())}"
          f"; {int(one_side.sum())} candidates taken by one device only "
          f"and {int(moved.sum())} points moved, {bad} of them standing "
          f"apart (> 2 x {gap:.3e} alignment, {iou_gap:.3e} IoU) [{card}]")
    if bad or not bool(c_pos.any(1).all()):
        raise AssertionError("tood: the card's task-aligned assignment "
                             "differs from the CPU's (or has no positive)")
    check_sample_sides(card, torch.Generator().manual_seed(17))


def check_free_anchor(fam, cfg, card, student, batch):
    """FreeAnchor's 50-anchor bags of the training batch's GT and its
    P(anchor in A+) from the card's deltas, card against CPU: a bag that
    differs must have its 50th and 51st IoU within twice the devices'
    largest IoU difference; P(anchor in A+) within BOX_PROB_ATOL."""
    from dskd_tpu_torch.models import free_anchor as FA
    from dskd_tpu_torch.models.gfl_head import cat_levels
    from dskd_tpu_torch.models.retinanet import retina_anchors

    C, K = cfg.model.num_classes, FA.PRE_ANCHOR_TOPK
    res = {}
    for dev in (DEVICE, "cpu"):
        _, h, gt = head_outputs(student, batch, dev)
        anchors = retina_anchors([c.shape[1:3] for c in h.cls_scores], dev)
        with torch.no_grad():
            q = FA.bag_quality(anchors, gt[0], gt[2])
            vals, idx = torch.sort(q, dim=2, descending=True, stable=True)
            prob = FA.positive_probs(anchors, cat_levels(h.bbox_preds, 4),
                                     *gt, C)
        res[dev] = [t.cpu() for t in (q, vals[..., :K + 1],
                                      idx[..., :K].sort(2)[0], prob)]
    (q, _, bags, prob), (c_q, c_vals, c_bags, c_prob) = (res[DEVICE],
                                                         res["cpu"])
    gv = batch.gt_valid.cpu()
    gap = float((q - c_q)[gv].abs().max())
    differ = (bags != c_bags).any(2) & gv
    near = (c_vals[..., K - 1] - c_vals[..., K]).abs() <= 2 * gap
    bad = int((differ & ~near).sum())
    ties = int((c_vals[..., K - 1] == c_vals[..., K])[gv].sum())
    err = float((prob - c_prob).abs().max())
    print(f"free_anchor bags, card vs CPU on the training batch (B="
          f"{batch.images.shape[0]}, {q.shape[2]} anchors, GT padded to "
          f"{q.shape[1]} of which {gv.sum(1).tolist()} valid): "
          f"{int(differ.sum())} of {int(gv.sum())} bags differ, {bad} "
          f"standing apart (50th vs 51st IoU > 2 x {gap:.3e}); bags whose "
          f"50th IoU ties the 51st on the CPU: {ties}; "
          f"P(anchor in A+) max abs err {err:.3e} (tolerance "
          f"{BOX_PROB_ATOL}), {int((c_prob > 0).sum())} of "
          f"{c_prob.numel()} entries above 0 [{card}]")
    if bad or not err <= BOX_PROB_ATOL:
        raise AssertionError("free_anchor: the card's bags or P(anchor in "
                             "A+) differ from the CPU's")


def check_sabl(fam, cfg, card, student, batch):
    """SABL's approx-max-IoU assignment of the training batch, card
    against CPU exactly, and its bucket targets: the positives' offsets
    within BUCKET_TOL; a positive whose bucket labels or weights differ
    must have a side whose two nearest buckets, or a bucket's distance
    and 1, stand within twice the devices' largest offset difference."""
    from dskd_tpu_torch.models import sabl_retina as S

    C = cfg.model.num_classes
    res = {}
    for dev in (DEVICE, "cpu"):
        _, h, gt = head_outputs(student, batch, dev)
        squares, approxs = S.sabl_anchors(
            [c.shape[1:3] for c in h.cls_scores], dev)
        with torch.no_grad():
            a, pos, labels, buckets = S.sabl_targets(squares, approxs, *gt,
                                                     C)
        res[dev] = [t.cpu() for t in (a, labels, *buckets)]
    (a, labels, offs, ow, blab, bw), (c_a, c_labels, c_offs, c_ow, c_blab,
                                      c_bw) = res[DEVICE], res["cpu"]
    exact = torch.equal(a, c_a) and torch.equal(labels, c_labels)
    pos = c_a >= 0
    gap = float((offs - c_offs)[pos].abs().max())
    d = c_offs.abs().reshape(*c_offs.shape[:2], 4, S.SIDE)
    two = d.sort(-1)[0][..., :2]
    near = (((two[..., 1] - two[..., 0]) <= 2 * gap).any(-1)
            | ((d - 1).abs() <= 2 * gap).flatten(2).any(-1))
    differ = ((blab != c_blab) | (ow != c_ow) | (bw != c_bw)).any(-1) & pos
    bad = int((differ & ~near).sum())
    ok = torch.allclose(offs[pos], c_offs[pos], **BUCKET_TOL)
    print(f"sabl approx-max-IoU assignment, card vs CPU on the training "
          f"batch (B={batch.images.shape[0]}, {a.shape[1]} positions x 9 "
          f"approxes, GT padded to {batch.gt_valid.shape[1]}): positives "
          f"per image {pos.sum(1).tolist()}, ignored "
          f"{(c_a == -2).sum(1).tolist()}; equal {exact}; bucket offsets of "
          f"the positives max abs err {gap:.3e} (tolerance {BUCKET_TOL}), "
          f"{int(differ.sum())} positives with another bucket label or "
          f"weight, {bad} standing apart [{card}]")
    if not exact or bad or not ok or not bool(pos.any(1).all()):
        raise AssertionError("sabl: the card's assignment or bucket targets "
                             "differ from the CPU's (or have no positive)")


def check_fsaf(fam, cfg, card, student, batch):
    """FSAF's online feature selection of the training batch from the
    card's head outputs, card against CPU: the GTs with a level equal, and
    a GT whose level differs must have its two least candidate losses
    within twice the devices' largest candidate-loss difference."""
    from dskd_tpu_torch.models import fsaf as FS

    lcfg = FS.FSAFLossConfig(num_classes=cfg.model.num_classes)
    res = {}
    for dev in (DEVICE, "cpu"):
        _, h, gt = head_outputs(student, batch, dev)
        cand, sel, has, _ = FS.fsaf_select_levels(h, *gt, lcfg)
        res[dev] = [t.cpu() for t in (cand, sel, has)]
    (cand, sel, has), (c_cand, c_sel, c_has) = res[DEVICE], res["cpu"]
    fin = torch.isfinite(c_cand)
    same_fin = torch.equal(torch.isfinite(cand), fin)
    gap = float((cand - c_cand)[fin].abs().max())
    two = c_cand.sort(0)[0][:2]
    near = (two[1] - two[0]).abs() <= 2 * gap
    differ = (sel != c_sel) & c_has
    bad = int((differ & ~near).sum())
    per_level = [int(((c_sel == lvl) & c_has).sum())
                 for lvl in range(c_cand.shape[0])]
    print(f"fsaf level selection, card vs CPU on the training batch (B="
          f"{batch.images.shape[0]}, GT padded to {c_has.shape[1]}): GTs "
          f"with a level {c_has.sum(1).tolist()}, per level P3-P7 "
          f"{per_level}; levels without an effective cell equal "
          f"{same_fin and torch.equal(has, c_has)}; {int(differ.sum())} GTs "
          f"on another level, {bad} standing apart (> 2 x {gap:.3e}) "
          f"[{card}]")
    if not same_fin or not torch.equal(has, c_has) or bad:
        raise AssertionError("fsaf: the card's level selection differs "
                             "from the CPU's")


def check_foveabox(fam, cfg, card, student, batch):
    """FoveaBox's labels and positives per level of the training batch
    (geometry alone), card against CPU exactly; the positives' log
    targets within HEAD_TOL."""
    from dskd_tpu_torch.models import foveabox as FV
    from dskd_tpu_torch.models.gfl_head import level_sizes

    C = cfg.model.num_classes
    res = {}
    for dev in (DEVICE, "cpu"):
        _, h, gt = head_outputs(student, batch, dev)
        res[dev] = [t.cpu() for t in FV.fovea_targets(h, *gt, C)]
        sizes = level_sizes(h.cls_scores, C)
    (labels, t, pos), (c_labels, c_t, c_pos) = res[DEVICE], res["cpu"]
    exact = torch.equal(labels, c_labels) and torch.equal(pos, c_pos)
    per_level = [int(p.sum()) for p in c_pos.split(sizes, 1)]
    err = float((t - c_t)[c_pos].abs().max())
    print(f"foveabox targets, card vs CPU on the training batch (B="
          f"{batch.images.shape[0]}, GT padded to {batch.gt_valid.shape[1]}"
          f"): positives per level P3-P7 {per_level}; labels and positives "
          f"equal {exact}; log targets max abs err {err:.3e} [{card}]")
    if not exact or not bool(c_pos.any(1).all()):
        raise AssertionError("foveabox: the card's targets differ from the "
                             "CPU's (or an image has no positive)")
    torch.testing.assert_close(t[c_pos], c_t[c_pos], **HEAD_TOL)


def check_autoassign(fam, cfg, card, student, batch):
    """AutoAssign's negative weights of the training batch from the card's
    head outputs, card against CPU within NEG_W_ATOL (the inside masks
    exactly), and the loss's gradients of the centre prior's mean and
    sigma within GRAD_REL_TOL relative L2."""
    from dskd_tpu_torch.core.boxes import bbox_overlaps, distance2bbox
    from dskd_tpu_torch.models import autoassign as AA
    from dskd_tpu_torch.models.gfl_head import cat_levels

    C = cfg.model.num_classes
    res = {}
    for dev in (DEVICE, "cpu"):
        out, h, gt = head_outputs(student, batch, dev)
        points, _ = AA.autoassign_points([c.shape[1:3] for c in
                                          h.cls_scores], dev)
        with torch.no_grad():
            boxes = distance2bbox(points[None], cat_levels(h.bbox_preds, 4))
            inside = AA.inside_gt(points, gt[0], gt[2])
            ious = bbox_overlaps(boxes, gt[0])
            ious = torch.where(gt[2][:, None], ious, torch.zeros_like(ious))
            w_neg = AA.negative_weights(ious, inside, gt[1].long().clamp(
                0, C - 1), C)
        mean, sigma = (p.detach().to(dev).requires_grad_()
                       for p in (out.prior_mean, out.prior_sigma))
        losses = AA.autoassign_loss(h, mean, sigma, *gt,
                                    AA.AutoAssignLossConfig(num_classes=C))
        sum(losses.values()).backward()
        res[dev] = [t.cpu() for t in (inside, w_neg, mean.grad, sigma.grad)]
    (inside, w_neg, gm, gs), (c_inside, c_w, c_gm, c_gs) = (res[DEVICE],
                                                            res["cpu"])
    err = float((w_neg - c_w).abs().max())
    n_moved = int(((w_neg - c_w).abs() > 1e-6).sum())
    rels = [rel_l2(gm, c_gm), rel_l2(gs, c_gs)]
    print(f"autoassign negative weights, card vs CPU on the training batch "
          f"(B={batch.images.shape[0]}, {c_w.shape[1]} points x "
          f"{c_w.shape[2]} classes, GT padded to {c_inside.shape[2]}): "
          f"inside masks equal {torch.equal(inside, c_inside)}, "
          f"{int((c_w < 1).sum())} weights below 1, max abs err {err:.3e} "
          f"(tolerance {NEG_W_ATOL}), {n_moved} moved by > 1e-6; centre "
          f"prior mean / sigma gradient relative L2 {rels[0]:.3e} / "
          f"{rels[1]:.3e} (tolerance {GRAD_REL_TOL}) "
          f"[{card}]")
    if (not torch.equal(inside, c_inside) or not err <= NEG_W_ATOL
            or not all(r <= GRAD_REL_TOL for r in rels)
            or not bool((c_w < 1).any())):
        raise AssertionError("autoassign: the card's negative weights or "
                             "centre prior gradients differ from the CPU's")


HEAD_CHECKS = {"tood": check_tood, "free_anchor": check_free_anchor,
               "sabl_retina": check_sabl, "fsaf": check_fsaf,
               "foveabox": check_foveabox, "autoassign": check_autoassign}


def check_head_family(fam, cfg, card, student, teacher, batch):
    """Phase 17's family check (HEAD_CHECKS): the family's own assignment
    or targets card against CPU, counting what moved."""
    HEAD_CHECKS[fam["key"]](fam, cfg, card, student, batch)


for _key, _desc in (
        ("tood", "FPN-256 P3-P7, 6 inter convs, two task decompositions, "
                 "per-corner offset sampling"),
        ("fsaf", "FPN-256 P3-P7, 4-conv towers, anchor-free distances"),
        ("foveabox", "FPN-256 P3-P7, 4-conv GN towers, log distances"),
        ("autoassign", "FPN-256 P3-P7, 4-conv GN towers, objectness, "
                       "learnable centre prior"),
        ("free_anchor", "RetinaNet head, 9 anchors per position, bag "
                        "losses"),
        ("sabl_retina", "FPN-256 P3-P7, 4-conv towers, 4 x 7 bucket logits "
                        "and offsets")):
    FAMILIES[_key] = dict(
        FAMILIES["atss"], tag=_key, key=_key,
        grad_params=HEAD_GRAD_PARAMS[_key],
        describe=(lambda m, d=_desc: f"ResNet-{m.depth}, {d}"),
        thread_spread_params=(), train_checks=check_head_family)


def check_head_families(card):
    """Phase 17: TOOD, FSAF, FoveaBox, AutoAssign, FreeAnchor and
    SABL-RetinaNet through check_family at their configs' 800x1344 canvas
    and full width and depth, f32, seeded weights, B=2 with GT padded to
    the config's max_gt, with check_head_family as their own checks.
    Every port kernel's count stays 0 over the phase."""
    from dskd_tpu_torch.utils.config import apply_overrides, load_config

    with summed_counts() as total:
        for key, config in HEAD_CONFIGS.items():
            t0 = time.perf_counter()
            cfg = apply_overrides(load_config(config), list(HEAD_SETS))
            check_family(card, cfg.model.arch, config, HEAD_SETS, n_train=2,
                         hw=tuple(cfg.data.bucket), incremental=False,
                         family=key)
            print(f"{key}: {time.perf_counter() - t0:.1f} s of phase 17")
    print(f"phase 17: port kernel launches over the phase {total}")
    if any(total.values()):
        raise AssertionError(f"phase 17 launched port kernels: {total}")


# --- RegNetX, PVT, HRNet, EfficientNet, YOLOX, YOLOv3, CenterNet (phase 18) --

ZOO_CONFIGS = {key: os.path.join(ROOT, "configs", f"{name}.py")
               for key, name in (
                   ("retinanet_regnetx", "retinanet_regnetx_3_2gf_1x"),
                   ("retinanet_pvt", "retinanet_pvt_t_1x"),
                   ("fcos_hrnet", "fcos_hrnetv2p_w18_1x"),
                   ("retinanet_effb3", "retinanet_effb3_1x"),
                   ("yolox", "yolox_s_300e"),
                   ("yolov3", "yolov3_d53_coco"),
                   ("yolov3_mbv2", "yolov3_mobilenetv2_416"),
                   ("centernet", "centernet_r18_140e"))}
ZOO_SETS = ()             # the configs as they are (a rehearsal cuts them)
# each config's training batch (on its config's canvas)
ZOO_TRAIN_B = {"retinanet_regnetx": 2, "retinanet_pvt": 2, "fcos_hrnet": 2,
               "retinanet_effb3": 4, "yolox": 8, "yolov3": 8,
               "yolov3_mbv2": 8, "centernet": 16}
# the smaller canvas of the step and the decode against the CPU (the dense
# configs: DENSE_CMP_HW)
ZOO_CMP_HW = {"yolox": (320, 320), "yolov3": (320, 320),
              "yolov3_mbv2": (320, 320), "centernet": (256, 256)}
ZOO_GRAD_PARAMS = {
    "retinanet_regnetx": _TOWERS + _RETINA_OUT + (
        "backbone.layer3_block0.conv2.weight",),
    "retinanet_pvt": _TOWERS + _RETINA_OUT + (
        "backbone.stage3_block1.attn.kv.weight", "backbone.pos_embed2"),
    "fcos_hrnet": _TOWERS + ("bbox_head.conv_cls.weight",
                             "bbox_head.conv_reg.weight",
                             "neck.reduction_conv.weight",
                             "backbone.stage4_module2.fuse0_3_conv.weight"),
    "retinanet_effb3": _TOWERS + _RETINA_OUT + (
        "neck.fpn_convs.4.conv.weight",
        "backbone.stage6_block0.project_conv.weight"),
    "yolox": ("bbox_head.multi_level_conv_cls.0.weight",
              "bbox_head.multi_level_conv_reg.0.weight",
              "bbox_head.multi_level_conv_obj.1.weight",
              "neck.out_convs.0.conv.weight",
              "backbone.stage4_spp.conv2.conv.weight"),
    "yolov3": ("pred0.weight", "pred2.weight", "head1_conv.weight",
               "backbone.s4b3_2_conv.weight"),
    "yolov3_mbv2": ("pred1.weight", "pred2.weight", "neck3_4_conv.weight",
                    "backbone.stage7_block0.project.weight"),
    "centernet": ("bbox_head.heatmap_out.weight", "bbox_head.wh_out.weight",
                  "neck.deconv2.weight", "backbone.layer4.1.conv2.weight")}
# the gradients whose f32 value the CPU itself decides no closer than
# GRAD_REL_TOL: its spread between 1, 4 and 8 threads
# (tools/torch_zoo_grad_check.py, PERF.md §6) exceeds it, so in f32 they
# are held to THREAD_SPREAD_TOL; the two YOLOv3 backbones' deepest spread
# past even that (2.4e-2), so those configs, like EfficientNet, also run a
# step in f64, where every named gradient is held to F64_GRAD_REL_TOL
ZOO_SPREAD_PARAMS = {
    "retinanet_regnetx": ("backbone.layer3_block0.conv2.weight",),
    "retinanet_pvt": (),
    "fcos_hrnet": (),
    "retinanet_effb3": ("bbox_head.cls_convs.3.conv.weight",
                        "bbox_head.reg_convs.3.conv.weight",
                        "neck.fpn_convs.4.conv.weight",
                        "backbone.stage6_block0.project_conv.weight"),
    "yolox": (),
    "yolov3": ("head1_conv.weight", "backbone.s4b3_2_conv.weight"),
    "yolov3_mbv2": ("neck3_4_conv.weight",
                    "backbone.stage7_block0.project.weight"),
    "centernet": ()}
HEATMAP_ATOL = 1e-6       # CenterNet's gaussian targets, card vs CPU
# SimOTA's IoU with the assigned GT, card vs CPU: each device decodes the
# boxes (exp of the same f32 outputs) and takes the IoUs itself
SIMOTA_IOU_ATOL = 1e-5
ENCODE_TOL = dict(rtol=1e-5, atol=1e-5)   # YOLOv3's encoded targets


def zoo_heads(cfg, out):
    """The head outputs of a YOLOX, YOLOv3 or CenterNet forward, flattened
    per image."""
    arch = cfg.model.arch
    if arch == "yolox":
        return _yolo_heads(cfg, out)
    if arch == "yolov3":
        B = out.preds[0].shape[0]
        return {"preds": torch.cat([p.reshape(B, -1) for p in out.preds], 1)}
    return {k: getattr(out, k).flatten(1) for k in ("heatmap", "wh",
                                                    "offset")}


def zoo_decode_model(cfg, device):
    """A YOLOX, YOLOv3 or CenterNet model whose scores pass its decode's
    threshold: seed 2, the head's convs redrawn lecun-normal from a CPU
    generator (each device gets the same weights), YOLOX's class and
    objectness biases and YOLOv3's ``pred`` biases 0."""
    from dskd_tpu_torch.models.detector import lecun_
    from dskd_tpu_torch.registry import get_family

    spec = get_family(cfg.model.arch)
    model = spec["build"](cfg.model, torch.device(device))
    spec["init_weights"](model, 2)
    head = (model if cfg.model.arch == "yolov3" else model.bbox_head)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, mod in head.named_modules():
            if isinstance(mod, torch.nn.Conv2d) and (
                    cfg.model.arch != "yolov3" or name.startswith("pred")):
                lecun_(mod.weight, g)
                if mod.bias is not None and cfg.model.arch != "centernet":
                    mod.bias.zero_()
    return model.eval()


def zoo_decode(cfg, model, batch):
    """The family's decode at its eval settings on ``batch``, on the model's
    device: (scores (B, N, C), the top-k's scores, positions, classes and
    validity, the detections' positions, classes and validity) on the
    CPU."""
    from dskd_tpu_torch.core.postprocess import filter_scores_and_topk, \
        filter_scores_and_topk_mlvl
    from dskd_tpu_torch.models import centernet, yolov3, yoloy_head

    arch = cfg.model.arch
    with torch.inference_mode():
        out = model(batch.images, batch.img_hw)
        if arch == "yolox":
            cls, _, obj = yoloy_head.flatten_levels(out.head)
            scores = torch.sigmoid(cls) * torch.sigmoid(obj)[..., None]
            top = filter_scores_and_topk(scores, 0.01, 2000)
            det = yoloy_head.yoloy_get_bboxes(out.head, batch.img_hw)
        elif arch == "yolov3":
            _, _, _, _, preds, rows = yolov3._flat(out, batch.images.device)
            obj = torch.sigmoid(preds[..., 4:5])
            obj = torch.where(obj >= 0.005, obj, torch.zeros_like(obj))
            scores = torch.sigmoid(preds[..., 5:]) * obj
            top = filter_scores_and_topk_mlvl(scores, 0.05, 1000, rows)
            det = yolov3.yolov3_get_bboxes(out, batch.img_hw)
        else:
            B, H, W, C = out.heatmap.shape
            scores = torch.sigmoid(out.heatmap)
            det = centernet.centernet_get_bboxes(out, batch.img_hw,
                                                 score_thr=0.05)
            # NMS-free: the top-k are the detections; the scores before
            # the local-maximum suppression, and each cell's largest
            # neighbour, which decides it
            pix = det.keep_qid // C
            return [t.cpu().reshape(B, H * W, C) if t.dim() == 4 else t.cpu()
                    for t in (scores, det.scores, pix, det.labels, det.valid,
                              pix, det.labels, det.valid,
                              neighbour_max(scores))]
    return [t.cpu() for t in (scores, top.scores, top.keep_idxs, top.labels,
                              top.valid, det.keep_qid, det.labels,
                              det.valid)]


def neighbour_max(heat):
    """(B, H, W, C): each cell's largest score among its 8 neighbours (-inf
    outside the map)."""
    H, W = heat.shape[1:3]
    pad = torch.nn.functional.pad(heat.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                  value=float("-inf"))
    return torch.stack([pad[:, :, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                        for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                        if dy or dx]).amax(0).permute(0, 2, 3, 1)


def cpu_zoo_decode(key, cfg, n, hw):
    """zoo_decode of zoo_decode_model on the CPU (a worker's job)."""
    batch = family_batch("cpu", n, hw, FAMILIES[key]["max_gt"](cfg))
    return zoo_decode(cfg, zoo_decode_model(cfg, "cpu"), batch)


def compare_decodes(tag, got, want, card, note):
    """The top-k and detections of zoo_decode on the card (``got``) against
    the CPU's (``want``): every top-k entry whose CPU score stands more than
    twice the devices' largest score difference from its sorted neighbours
    holds the CPU's (position, class) on the card; so does every detection
    that one device alone keeps unless its score stands that close to
    another candidate's. CenterNet's (a ninth output, each cell's largest
    neighbour) also passes over a cell whose local-maximum test
    (centernet.local_maxima) its neighbour decides within that distance.
    Prints what moved."""
    from dskd_tpu_torch.models.centernet import PLATEAU_TOL

    (sc, ts, ti, tl, tv, qid, dl, dv), (c_sc, c_ts, c_ti, c_tl, c_tv, c_qid,
                                        c_dl, c_dv) = got[:8], want[:8]
    gap = float((sc - c_sc).abs().max())

    def plateau(b, q, lb):
        """The local-maximum test of (cell q, class lb) stands within
        2 x gap of its threshold."""
        return len(want) > 8 and abs(float(want[8][b, q, lb] - c_sc[b, q, lb])
                                     - PLATEAU_TOL) <= 2 * gap

    far = apart(c_ts, gap) & c_tv
    n_plateau = 0
    for b, k in far.nonzero().tolist():
        if plateau(b, int(c_ti[b, k]), int(c_tl[b, k])):
            far[b, k] = False
            n_plateau += 1
    same = (ti == c_ti) & (tl == c_tl) & (tv == c_tv)
    cands = c_ts[c_tv]
    moved = bad = 0
    for b in range(c_ts.shape[0]):
        keep = [{(int(q), int(lb)) for q, lb, v in zip(*x) if v}
                for x in ((qid[b], dl[b], dv[b]), (c_qid[b], c_dl[b],
                                                   c_dv[b]))]
        for q, lb in keep[0] ^ keep[1]:
            moved += 1
            s = float(c_sc[b, q, lb])
            if not (bool(((cands - s).abs() <= 2 * gap).sum() > 1)
                    or plateau(b, q, lb)):
                bad += 1
    print(f"{tag} decode, card vs CPU ({note}): {int(c_tv.sum())} top-k "
          f"candidates, {int(far.sum())} stand > 2 x {gap:.3e} (the "
          f"devices' largest score difference) apart and the card holds the "
          f"CPU's (position, class) in {int(same[far].sum())} of them"
          + (f" ({n_plateau} others apart but at a 3x3 near-tie)"
             if len(want) > 8 else "") +
          f"; {int((~same).sum())} of {same.numel()} slots moved; "
          f"detections card {dv.sum(1).tolist()} CPU {c_dv.sum(1).tolist()}, "
          f"{moved} kept by one device only, {bad} of them standing apart "
          f"[{card}]")
    if not far.any() or not bool(same[far].all()) or bad:
        raise AssertionError(f"{tag}: the card's top-k or detections differ "
                             f"from the CPU's")


def check_zoo_decode(fam, cfg, card, n=2):
    hw = fam["cmp_hw"]
    batch = family_batch(DEVICE, n, hw, fam["max_gt"](cfg))
    got = zoo_decode(cfg, zoo_decode_model(cfg, DEVICE), batch)
    want = cpu_result(cpu_zoo_decode, fam["key"], cfg, n, tuple(hw))
    compare_decodes(fam["tag"], got, want, card,
                    f"B={n}, {hw[0]}x{hw[1]}, head convs lecun")


def zoo_targets(cfg, out_sizes, batch):
    """The batch-only targets of YOLOv3 (the grid assignment, negatives
    and encoded targets over the anchors of ``out_sizes``) or CenterNet
    (render_targets on the stride-4 map of ``out_sizes``), on the batch's
    device, returned on the CPU."""
    from dskd_tpu_torch.core.coders import yolo_encode
    from dskd_tpu_torch.models import centernet, yolov3

    dev = batch.images.device
    if cfg.model.arch == "yolov3":
        anchors, strides, cx, cy = yolov3.yolo_priors(out_sizes, dev)
        assigned, neg = yolov3.grid_assign(anchors, strides, cx, cy,
                                           batch.gt_bboxes, batch.gt_valid)
        G = batch.gt_bboxes.shape[1]
        tgt = torch.gather(batch.gt_bboxes, 1, assigned.clamp(0, G - 1)[
            ..., None].expand(-1, -1, 4))
        enc = yolo_encode(anchors[None], tgt, strides[None])
        return [t.cpu() for t in (assigned, neg, enc)]
    hm, wh, off, centers, valid = centernet.render_targets(
        batch.gt_bboxes, batch.gt_labels, batch.gt_valid,
        cfg.model.num_classes, out_sizes[0])
    return [t.cpu() for t in (hm, wh, off, centers, valid)]


def cpu_zoo_targets(key, cfg, n, hw, out_sizes):
    """zoo_targets of the training batch on the CPU (a worker's job)."""
    batch = family_batch("cpu", n, hw, FAMILIES[key]["max_gt"](cfg))
    return zoo_targets(cfg, out_sizes, batch)


def _zoo_out_sizes(arch, hw):
    """The output maps' sizes of YOLOv3 (strides 32, 16, 8) or CenterNet
    (stride 4) on the canvas ``hw``."""
    strides = (32, 16, 8) if arch == "yolov3" else (4,)
    return tuple((-(-hw[0] // s), -(-hw[1] // s)) for s in strides)


def check_yolox(fam, cfg, card, student, batch):
    """YOLOX's SimOTA on the student's head outputs of the training batch
    (computed on the card) on the card and on the CPU: the assignment,
    labels, positives and their counts equal, the IoUs with the assigned
    GT within SIMOTA_IOU_ATOL."""
    from dskd_tpu_torch.core.sim_ota import sim_ota_assign
    from dskd_tpu_torch.models.yoloy_head import (featmap_sizes,
                                                  flatten_levels,
                                                  yoloy_decode, yoloy_priors)

    out, head, gt = head_outputs(student, batch, DEVICE)
    res = {}
    for dev in (DEVICE, "cpu"):
        cls, reg, obj = (t.to(dev) for t in flatten_levels(head))
        priors = yoloy_priors(featmap_sizes(head), dev)
        offset = torch.cat([priors[:, :2] + priors[:, 2:] * 0.5,
                            priors[:, 2:]], -1)
        scores = torch.sigmoid(cls) * torch.sigmoid(obj)[..., None]
        r = sim_ota_assign(scores, offset, yoloy_decode(priors[None], reg),
                           *(t.to(dev) for t in gt), cfg.model.num_classes)
        res[dev] = [t.cpu() for t in r]
    (a, lab, pos, iou, n), (c_a, c_lab, c_pos, c_iou, c_n) = \
        res[DEVICE], res["cpu"]
    equal = all(torch.equal(x, y) for x, y in ((a, c_a), (lab, c_lab),
                                                (pos, c_pos), (n, c_n)))
    iou_err = float((iou - c_iou).abs().max())
    print(f"{fam['tag']} SimOTA, card vs CPU on the card's head outputs "
          f"(B={batch.images.shape[0]}, {c_a.shape[1]} priors): positives "
          f"per image {(c_a >= 0).sum(1).tolist()}, {int((a != c_a).sum())} "
          f"priors moved; assignment, labels and positives equal {equal}, "
          f"IoUs max abs err {iou_err:.3e} (tolerance {SIMOTA_IOU_ATOL}) "
          f"[{card}]")
    if not equal or not iou_err <= SIMOTA_IOU_ATOL or \
            not bool((c_a >= 0).any(1).all()):
        raise AssertionError(f"{fam['tag']}: the card's SimOTA differs from "
                             f"the CPU's (or has no positive)")
    check_zoo_decode(fam, cfg, card)


def check_zoo_targets(fam, cfg, card, student, batch):
    """YOLOv3's grid assignment (equal) and encoded targets (ENCODE_TOL),
    or CenterNet's gaussian heatmaps (HEATMAP_ATOL; the peaks at 1 equal)
    and size, offset and centre targets (equal), of the training batch on
    the card against the CPU's (a worker's job); then the decode."""
    arch = cfg.model.arch
    n, hw = batch.images.shape[0], tuple(batch.images.shape[1:3])
    sizes = _zoo_out_sizes(arch, hw)
    got = zoo_targets(cfg, sizes, batch)
    want = cpu_result(cpu_zoo_targets, fam["key"], cfg, n, hw, sizes)
    if arch == "yolov3":
        (a, neg, enc), (c_a, c_neg, c_enc) = got, want
        pos = c_a >= 0
        err = float((enc - c_enc)[pos].abs().max()) if pos.any() else 0.0
        ok = (torch.equal(a, c_a) and torch.equal(neg, c_neg)
              and torch.allclose(enc[pos], c_enc[pos], **ENCODE_TOL))
        print(f"{fam['tag']} grid assignment, card vs CPU (B={n}, "
              f"{c_a.shape[1]} anchors): positives per image "
              f"{pos.sum(1).tolist()}, negatives {c_neg.sum(1).tolist()}, "
              f"equal {torch.equal(a, c_a) and torch.equal(neg, c_neg)}; "
              f"encoded targets max abs err {err:.3e} (tolerance "
              f"{ENCODE_TOL}) [{card}]")
    else:
        (hm, *rest), (c_hm, *c_rest) = got, want
        err = float((hm - c_hm).abs().max())
        ok = (err <= HEATMAP_ATOL and torch.equal(hm == 1, c_hm == 1)
              and all(torch.equal(x, y) for x, y in zip(rest, c_rest)))
        print(f"{fam['tag']} targets, card vs CPU (B={n}, heatmap "
              f"{tuple(c_hm.shape[1:])}): {int((c_hm == 1).sum())} peaks "
              f"equal {torch.equal(hm == 1, c_hm == 1)}, heatmap max abs err "
              f"{err:.3e} (tolerance {HEATMAP_ATOL}); size, offset and "
              f"centre targets equal "
              f"{all(torch.equal(x, y) for x, y in zip(rest, c_rest))} "
              f"[{card}]")
    if not ok:
        raise AssertionError(f"{fam['tag']}: the card's targets differ from "
                             f"the CPU's")
    check_zoo_decode(fam, cfg, card)


def check_zoo(fam, cfg, card, student, teacher, batch):
    """Phase 18's family check: the dense configs' check_dense (their
    assignment and decode); YOLOX's SimOTA; YOLOv3's and CenterNet's
    targets; the decodes card against CPU."""
    arch = cfg.model.arch
    if arch in ("retinanet", "fcos"):
        check_dense(fam, cfg, card, student, teacher, batch)
    elif arch == "yolox":
        check_yolox(fam, cfg, card, student, batch)
    else:
        check_zoo_targets(fam, cfg, card, student, batch)


for _key, _base, _desc in (
        ("retinanet_regnetx", "retinanet",
         "RegNetX-3.2GF, FPN-256 P3-P7, RetinaNet head"),
        ("retinanet_pvt", "retinanet",
         "PVT-tiny, FPN-256 P3-P7, RetinaNet head"),
        ("fcos_hrnet", "fcos", "HRNetV2p-W18, HRFPN-256, FCOS GN head"),
        ("retinanet_effb3", "retinanet",
         "EfficientNet-B3 (trained BN, drop path 0.2), BN-FPN-256, SepBN "
         "head"),
        ("yolox", "atss", "YOLOX-s CSPDarknet, PAFPN-128, decoupled head"),
        ("yolov3", "atss", "Darknet-53, 3-scale neck, 3 anchors a cell"),
        ("yolov3_mbv2", "atss",
         "MobileNetV2 (LeakyReLU, trained BN), 96-channel neck"),
        ("centernet", "atss", "ResNet-18, 3 deconvs, heatmap head")):
    FAMILIES[_key] = dict(
        FAMILIES[_base], tag=_key, key=_key,
        grad_params=ZOO_GRAD_PARAMS[_key],
        describe=(lambda m, d=_desc: d),
        thread_spread_params=ZOO_SPREAD_PARAMS[_key], train_checks=check_zoo,
        cmp_hw=ZOO_CMP_HW.get(_key, DENSE_CMP_HW))
    if _key in ZOO_CMP_HW:
        FAMILIES[_key]["heads"] = zoo_heads
# the dense configs' decode models: class biases (and EfficientNet's
# class-conv gain: its features at the init spread ~1e-4) that let
# (position, class) pairs pass 0.05, most of them apart
FAMILIES["retinanet_regnetx"]["decode_bias"] = -2.5
FAMILIES["retinanet_pvt"]["decode_bias"] = -3.5
FAMILIES["retinanet_effb3"].update(decode_bias=-2.5, decode_gain=2000.0)
for _key in ("retinanet_effb3", "yolov3", "yolov3_mbv2"):
    FAMILIES[_key]["vs_cpu_dtypes"] = (torch.float32, torch.float64)


def queue_zoo_cpu():
    """Queue phase 18's CPU sides: each config's serving heads and step
    (queue_family_cpu), the decodes and the batch-only targets."""
    from dskd_tpu_torch.utils.config import apply_overrides, load_config

    for key, config in ZOO_CONFIGS.items():
        queue_family_cpu(key, config, ZOO_SETS)
        if key not in ZOO_CMP_HW:
            continue
        fam = FAMILIES[key]
        cfg = apply_overrides(load_config(config), list(ZOO_SETS))
        cpu_queue(cpu_zoo_decode, key, cfg, 2, tuple(fam["cmp_hw"]))
        if cfg.model.arch in ("yolov3", "centernet"):
            hw = tuple(cfg.data.bucket)
            cpu_queue(cpu_zoo_targets, key, cfg, ZOO_TRAIN_B[key], hw,
                      _zoo_out_sizes(cfg.model.arch, hw))


def check_zoo_families(card):
    """Phase 18: RetinaNet on RegNetX-3.2GF, PVT-tiny and EfficientNet-B3,
    FCOS on HRNetV2p-W18 + HRFPN, YOLOX-s, YOLOv3 (Darknet-53 and
    MobileNetV2) and CenterNet (ResNet-18) through check_family at their
    configs' canvases and full width and depth, f32, seeded weights, at
    ZOO_TRAIN_B, with check_zoo as their own checks. Every port kernel's
    count stays 0 over the phase."""
    from dskd_tpu_torch.utils.config import apply_overrides, load_config

    with summed_counts() as total:
        for key, config in ZOO_CONFIGS.items():
            t0 = time.perf_counter()
            cfg = apply_overrides(load_config(config), list(ZOO_SETS))
            check_family(card, cfg.model.arch, config, ZOO_SETS,
                         n_train=ZOO_TRAIN_B[key], hw=tuple(cfg.data.bucket),
                         incremental=False, family=key)
            print(f"{key}: {time.perf_counter() - t0:.1f} s of phase 18")
    print(f"phase 18: port kernel launches over the phase {total}")
    if any(total.values()):
        raise AssertionError(f"phase 18 launched port kernels: {total}")


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

    # phase 8's forgetting A/B: eight host-bound child processes that
    # leave the card idle most of the time, so they run beside phases 3-7,
    # whose checks do not depend on time; phase 8 collects them
    ab = start_ab_seeds()
    print(f"forgetting A/B: {len(AB_SEEDS)} seeds started beside phases 3-7")
    try:
        return check_phases(card, kind, t_start, ab)
    finally:
        stop_ab_seeds(ab)


def check_phases(card, kind, t_start, ab) -> int:
    """Phases 1-18 after the build, then the kernel report and the result
    line; ``ab`` the forgetting A/B's children (start_ab_seeds)."""
    from dskd_tpu_torch.apis.inference import prepare_batch

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

    check_incremental(card)
    t8 = time.perf_counter()
    check_distill_menu(cfg, card, ab)
    print(f"A/B, distill menu and JV: phase 8 took "
          f"{time.perf_counter() - t8:.1f} s")

    with card_alone():           # phase 9 times the card and the host
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
    del state16, step16, teacher16, switch_states

    with cpu_worker():
        t10 = time.perf_counter()
        queue_phase_cpu()
        check_detr(card)
        print(f"detr-il: phase 10 took {time.perf_counter() - t10:.1f} s")
        for phase, arch, config in ((11, "yolof", YOLOF_CONFIG),
                                    (12, "yoloy", YOLOY_CONFIG)):
            t0 = time.perf_counter()
            check_family(card, arch, config)
            print(f"{FAMILIES[arch]['tag']}: phase {phase} took "
                  f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        check_ddetr(card)
        print(f"deformable-detr: phase 13 took "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        check_dense_families(card)
        print(f"dense: phase 14 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        check_variant_families(card)
        print(f"variants: phase 15 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        check_dcn_families(card)
        print(f"dcn: phase 16 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        check_head_families(card)
        print(f"heads: phase 17 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        check_zoo_families(card)
        print(f"zoo: phase 18 took {time.perf_counter() - t0:.1f} s")

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

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
  2. build: compiles the three CUDA kernels from dskd_tpu_torch/csrc, one
     nvcc per source, all started together;
  3. kernels: each kernel against its plain PyTorch twin on the card at the
     flagship's shapes (B=2, H=8, D=32, P=4; the four levels of the 640x640
     serving canvas with Q=8500 encoder and Q=300 decoder queries, and of
     the 640x480 training canvas with Q=6380), f32 and bf16, indices
     outside [0, S) included; and the gradients of ms_deform_attn_core in
     value, locations and attention on the card against the plain twins;
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
  6. times: kernels against twins with CUDA events, the serving slice in
     ms/image, the train step in ms/step and img/s, and profiler tables of
     one serving forward and one bf16 train step.
The last two lines are the kernel report and the result, as JSON.
"""
from __future__ import annotations

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
MSDA_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-3, atol=1e-4)    # one f32 step, card vs CPU
# gradients, card vs CPU: ||g_card - g_cpu|| / ||g_cpu||
GRAD_REL_TOL = 1e-3
MSDA_WEIGHT_STD = 0.02
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


def counters():
    from dskd_tpu_torch.ops.mxu_gather import gather_weighted, \
        gather_weighted_bwd
    from dskd_tpu_torch.ops.pack_kernel import pack_corners
    return {"pack_corners": pack_corners, "gather_weighted": gather_weighted,
            "gather_weighted_bwd": gather_weighted_bwd}


def reset_counts() -> None:
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0


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
    wild = torch.randint(0, 4, flat.shape, generator=gen).to(flat.device)
    flat = torch.where(wild == 0, flat - 10 ** 6,
                       torch.where(wild == 1, flat + S, flat)).to(torch.int32)
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


def check_msda_grads(gen):
    """R1: autograd reaches value, locations and attention through both
    kernels on the card; the gradients match the plain twins (CPU)."""
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
    for name, got, want in zip(("value", "locations", "attention"),
                               grads(DEVICE), grads("cpu")):
        if not got.abs().max() > 0:
            raise AssertionError(f"no gradient reaches {name} on the card")
        torch.testing.assert_close(got, want, **MSDA_GRAD_TOL, msg=name)
        errs[name] = _max_err(got, want)
    return errs


def check_slice(imgs):
    from dskd_tpu_torch.apis.inference import (inference_detector,
                                               init_detector, prepare_batch)

    model, cfg = init_detector(CONFIG, device="cuda", seed=0)
    m = cfg.model
    # one launch of each kernel per level of every MSDA call of a forward
    n_expected = (m.num_encoder_layers + m.num_decoder_layers) * m.num_levels
    reset_counts()
    results = inference_detector(model, cfg, imgs)
    launches = read_counts()
    print(f"serve: launches in one inference_detector call over "
          f"{len(imgs)} images: {launches} (expected {n_expected} of each "
          f"forward kernel, no backward)")
    for name, n in launches.items():
        want = 0 if name == "gather_weighted_bwd" else n_expected
        if n != want:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"{want}")
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
    images, img_hw, _ = prepare_batch(cfg, imgs, torch.device("cuda"))
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

def train_batch(device):
    """bench.py's synthetic batch: B images of the 640x480 canvas, valid
    widths 375-480, 5-29 valid GT of 32 in classes 40-79."""
    from dskd_tpu_torch.data.batch import Batch

    H, W = TRAIN_HW
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


def run_train(cfg, compute_dtype, n_steps, tag):
    """A few full-width steps; checks finite losses, launch counts per step
    and which parameter groups move. Returns (state, step, teacher, batch,
    launches of the whole run)."""
    student, teacher = build_models(cfg, DEVICE)
    state, step, _, _ = train_setup(cfg, student, compute_dtype)
    batch = train_batch(DEVICE)
    m = cfg.model
    per_fwd = (m.num_encoder_layers + m.num_decoder_layers) * m.num_levels
    expected = {"pack_corners": 2 * per_fwd, "gather_weighted": 2 * per_fwd,
                "gather_weighted_bwd": per_fwd}
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


# --- times -------------------------------------------------------------------

def time_kernels(gen):
    from dskd_tpu_torch.ops.msda import corner_index_and_weights
    from dskd_tpu_torch.ops.mxu_gather import gather_weighted, \
        gather_weighted_bwd, gather_weighted_bwd_plain, gather_weighted_plain
    from dskd_tpu_torch.ops.pack_kernel import pack_corners, \
        pack_corners_plain

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for levels, Q, canvas in ((LEVELS, Q_ENC, "640x640"),
                                  (LEVELS, Q_DEC, "640x640"),
                                  (TRAIN_LEVELS, sum(
                                      h * w for h, w in TRAIN_LEVELS),
                                   "640x480")):
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
                             .to("cuda", dtype))
            if canvas == "640x640":
                if Q == Q_ENC:
                    times[f"pack_corners {tag}"] = (
                        cuda_ms(lambda: [pack_corners(*a) for a in slices]),
                        cuda_ms(lambda: [pack_corners_plain(*a)
                                         for a in slices]))
                times[f"gather_weighted {tag} Q={Q}"] = (
                    cuda_ms(lambda: [gather_weighted(t, f, c) for t, (f, c)
                                     in zip(tables, args)]),
                    cuda_ms(lambda: [gather_weighted_plain(t, f, c)
                                     for t, (f, c) in zip(tables, args)],
                            iters=5))
            key = f"gather_weighted_bwd {tag} Q={Q} {canvas}"
            times[key] = (
                cuda_ms(lambda: [gather_weighted_bwd(t, f, c, g) for
                                 t, (f, c), g in zip(tables, args, douts)],
                        iters=10),
                cuda_ms(lambda: [gather_weighted_bwd_plain(t, f, c, g) for
                                 t, (f, c), g in zip(tables, args, douts)],
                        iters=3, warmup=1))
            if canvas == "640x480":
                for lvl, ((h, w), t, (f, c), g) in enumerate(zip(
                        levels, tables, args, douts)):
                    times[f"{key} level {lvl} ({h}x{w}, "
                          f"{t.shape[1]} rows)"] = (
                        cuda_ms(lambda: gather_weighted_bwd(t, f, c, g),
                                iters=10),
                        cuda_ms(lambda: gather_weighted_bwd_plain(t, f, c,
                                                                  g),
                                iters=3, warmup=1))
    return times


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
        images, img_hw, _ = prepare_batch(cfg, imgs, torch.device("cuda"))
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
    """Device time by kernel over one call of ``fn``, and the device's idle
    share of its wall time (one stream: kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels)
    print(f"profile: {what} under the profiler: wall {wall_us / 1e3:.3f} "
          f"ms, device busy {busy / 1e3:.3f} ms, idle share "
          f"{1 - busy / wall_us:.3f}, {sum(e.count for e in kernels)} kernel "
          f"launches of {len(kernels)} kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.self_device_time_total / busy:6.1%} x{e.count:<5d} "
              f"{e.key[:100]}")


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

    from dskd_tpu_torch.apis.inference import prepare_batch
    from dskd_tpu_torch.ops import _build
    from dskd_tpu_torch.ops import mxu_gather, pack_kernel
    t0 = time.perf_counter()
    _build.build(["pack_corners", "gather_weighted", "gather_weighted_bwd"])
    _build.load("pack_corners", pack_kernel._SIGNATURES)
    _build.load("gather_weighted", mxu_gather._SIGNATURES)
    _build.load("gather_weighted_bwd", mxu_gather._BWD_SIGNATURES)
    print(f"build: three kernels in {time.perf_counter() - t0:.2f} s")
    for name, (secs, log) in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build: {name} nvcc {secs:.2f} s; {'; '.join(regs)}")

    gen = torch.Generator().manual_seed(0)
    err = check_kernels(gen)
    print(f"kernels: match their twins on the card (f32 {F32_TOL}, bf16 "
          f"{BF16_TOL}, dtable {DTABLE_TOL} / {DTABLE_BF16_TOL}); max abs "
          f"err {err}")
    gerr = check_msda_grads(gen)
    print(f"kernels: ms_deform_attn_core gradients on the card vs the plain "
          f"twins, max abs err {gerr} (tolerance {MSDA_GRAD_TOL})")

    rng = np.random.RandomState(0)
    shapes = [(480, 640), (427, 640), (640, 512), (512, 683)]
    imgs = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in shapes]
    model, cfg = check_slice(imgs[:3])

    state32, step32, teacher32, batch, launches = run_train(
        cfg, torch.float32, 3, "f32")
    print(f"train f32: launches over the 3 steps {launches}")
    check_train_card_vs_cpu(cfg)
    state16, step16, teacher16, _, _ = run_train(cfg, torch.bfloat16, 3,
                                                 "bf16")

    print(f"times on {card}:")
    ktimes = time_kernels(gen)
    for name, (k_ms, p_ms) in ktimes.items():
        print(f"  {name}: kernel {k_ms:.4f} ms, plain twin {p_ms:.4f} ms "
              f"(B={B})")
    stimes = time_slice(model, cfg, {1: imgs[:1], 4: imgs})
    for bsz, (e2e, fwd) in stimes.items():
        print(f"  serve B={bsz}: inference_detector {e2e:.3f} ms/image, "
              f"model forward {fwd:.3f} ms/image (f32)")
    for tag, (st, sp, tch) in (("f32", (state32, step32, teacher32)),
                               ("bf16", (state16, step16, teacher16))):
        ms, img_s = time_train(st, sp, tch, batch)
        print(f"  train {tag} B={B} {TRAIN_HW[0]}x{TRAIN_HW[1]}: "
              f"{ms:.3f} ms/step, {img_s:.3f} img/s")
    images, img_hw, _ = prepare_batch(cfg, imgs, torch.device(DEVICE))
    with torch.inference_mode():
        profile(lambda: model(images, img_hw),
                f"one B={len(imgs)} serving forward (f32)")
    profile(lambda: step16(state16, batch, teacher16),
            f"one B={B} bf16 train step")

    bwd_key = (f"gather_weighted_bwd f32 Q="
               f"{sum(h * w for h, w in TRAIN_LEVELS)} 640x480")
    report = {"kernels": [
        {"name": "pack_corners", "route": "cuda",
         "source": "dskd_tpu_torch/csrc/pack_corners.cu",
         "replaces": "dskd_tpu/ops/pack_kernel.py:74",
         "launches": launches["pack_corners"],
         "max_abs_err": err["pack_corners"],
         "ms": ktimes["pack_corners f32"][0],
         "plain_ms": ktimes["pack_corners f32"][1]},
        {"name": "gather_weighted", "route": "cuda",
         "source": "dskd_tpu_torch/csrc/gather_weighted.cu",
         "replaces": "dskd_tpu/ops/mxu_gather.py:140",
         "launches": launches["gather_weighted"],
         "max_abs_err": err["gather_weighted"],
         "ms": ktimes[f"gather_weighted f32 Q={Q_ENC}"][0],
         "plain_ms": ktimes[f"gather_weighted f32 Q={Q_ENC}"][1]},
        {"name": "gather_weighted_bwd", "route": "cuda",
         "source": "dskd_tpu_torch/csrc/gather_weighted_bwd.cu",
         "replaces": "dskd_tpu/ops/mxu_gather.py:155",
         "launches": launches["gather_weighted_bwd"],
         "max_abs_err": max(err["dtable"], err["dw"]),
         "ms": ktimes[bwd_key][0], "plain_ms": ktimes[bwd_key][1]}]}
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

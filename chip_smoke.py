#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card and check it.

Run from the repository root, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases; the first failure raises and the script exits non-zero:
  1. device: requires torch.cuda, prints the card's name and power limit,
     turns TF32 off for matmuls and convolutions (every comparison and time
     below is full f32);
  2. build: compiles the two CUDA kernels from dskd_tpu_torch/csrc;
  3. kernels: each kernel against its plain PyTorch twin on the card at the
     flagship's shapes (B=2, the four levels of a 640x640 canvas, H=8, D=32,
     Q=8500 encoder and Q=300 decoder queries), f32 and bf16;
  4. slice: the flagship config with seeded weights through init_detector
     and inference_detector on three synthetic images; every kernel must be
     launched the number of times the design implies, outputs must be finite
     and the head outputs must match the same weights run on the CPU;
  5. times: kernels against twins with CUDA events, and the slice in
     ms/image at B=1 and B=4.
The last two lines are the kernel report and the result, as JSON.
"""
from __future__ import annotations

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
B, HEADS, D, P = 2, 8, 32, 4
Q_ENC, Q_DEC = sum(h * w for h, w in LEVELS), 300
F32_TOL = dict(rtol=1e-5, atol=1e-5)     # summation order only
BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)  # one bf16 rounding of the f32 sum
HEAD_TOL = dict(rtol=1e-3, atol=1e-3)    # whole model, f32, TF32 off


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


def level_inputs(gen, dtype, Q):
    """value (B, 8500, H, D) and per level (locations, attention) with
    locations spilling past the map so the zero-corner gates fire."""
    dev = torch.device("cuda")
    value = torch.randn(B, Q_ENC, HEADS, D, generator=gen).to(dev, dtype)
    per_level = [((torch.rand(B, Q, HEADS, P, 2, generator=gen) * 1.3
                   - 0.15).to(dev),
                  torch.rand(B, Q, HEADS, P, generator=gen).to(dev))
                 for _ in LEVELS]
    return value, per_level


def check_kernels(gen):
    from dskd_tpu_torch.ops.msda import corner_index_and_weights
    from dskd_tpu_torch.ops.mxu_gather import gather_weighted, \
        gather_weighted_plain
    from dskd_tpu_torch.ops.pack_kernel import pack_corners, \
        pack_corners_plain

    err = {"pack_corners": 0.0, "gather_weighted": 0.0,
           "gather_weighted_bf16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for Q in (Q_ENC, Q_DEC):
            value, per_level = level_inputs(gen, dtype, Q)
            start = 0
            for (h, w), (loc, attn) in zip(LEVELS, per_level):
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
                torch.cuda.synchronize()
                tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                torch.testing.assert_close(got.float(), want.float(), **tol)
                key = ("gather_weighted" if dtype == torch.float32
                       else "gather_weighted_bf16")
                err[key] = max(err[key], float((got.float() - want.float())
                                               .abs().max()))
    # the bounds check: rows outside [0, S) contribute zero, unread
    value, per_level = level_inputs(gen, torch.float32, Q_DEC)
    loc, attn = per_level[0]
    h, w = LEVELS[0]
    table = pack_corners(value[:, :h * w], h, w)
    flat, cw = corner_index_and_weights(loc, attn, h, w, torch.float32)
    S = table.shape[1]
    wild = torch.randint(0, 4, flat.shape, generator=gen).to(flat.device)
    flat = torch.where(wild == 0, flat - 10 ** 6,
                       torch.where(wild == 1, flat + S, flat))
    got = gather_weighted(table, flat.to(torch.int32), cw)
    want = gather_weighted_plain(table, flat.to(torch.int32), cw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **F32_TOL)
    return err


def check_slice(imgs):
    from dskd_tpu_torch.apis.inference import (inference_detector,
                                               init_detector, prepare_batch)
    from dskd_tpu_torch.ops.mxu_gather import gather_weighted
    from dskd_tpu_torch.ops.pack_kernel import pack_corners

    model, cfg = init_detector(CONFIG, device="cuda", seed=0)
    m = cfg.model
    # one launch of each kernel per level of every MSDA call of a forward
    n_expected = (m.num_encoder_layers + m.num_decoder_layers) * m.num_levels
    torch.cuda.synchronize()
    pack_corners.launches = 0
    gather_weighted.launches = 0
    results = inference_detector(model, cfg, imgs)
    torch.cuda.synchronize()
    launches = {"pack_corners": pack_corners.launches,
                "gather_weighted": gather_weighted.launches}
    print(f"slice: launches in one inference_detector call over "
          f"{len(imgs)} images: {launches} (expected {n_expected} each)")
    for name, n in launches.items():
        if n != n_expected:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"{n_expected}")
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
    print(f"slice: detections per image {n_det}, all finite")

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
    print(f"slice: card vs CPU head outputs, last layer, max abs err "
          f"{errs} (tolerance {HEAD_TOL})")
    return model, cfg, launches


def time_kernels(gen):
    from dskd_tpu_torch.ops.msda import corner_index_and_weights
    from dskd_tpu_torch.ops.mxu_gather import gather_weighted, \
        gather_weighted_plain
    from dskd_tpu_torch.ops.pack_kernel import pack_corners, \
        pack_corners_plain

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for Q in (Q_ENC, Q_DEC):
            value, per_level = level_inputs(gen, dtype, Q)
            slices, tables, args = [], [], []
            start = 0
            for (h, w), (loc, attn) in zip(LEVELS, per_level):
                v = value[:, start:start + h * w]
                start += h * w
                slices.append((v, h, w))
                tables.append(pack_corners(v, h, w))
                args.append(corner_index_and_weights(loc, attn, h, w, dtype))
            if Q == Q_ENC:
                times[f"pack_corners {tag}"] = (
                    cuda_ms(lambda: [pack_corners(*a) for a in slices]),
                    cuda_ms(lambda: [pack_corners_plain(*a) for a in slices]))
            times[f"gather_weighted {tag} Q={Q}"] = (
                cuda_ms(lambda: [gather_weighted(t, f, c) for t, (f, c)
                                 in zip(tables, args)]),
                cuda_ms(lambda: [gather_weighted_plain(t, f, c) for t, (f, c)
                                 in zip(tables, args)], iters=5))
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


def profile_forward(model, cfg, imgs):
    """Device time by kernel over one forward, and the device's idle share
    of that forward's wall time (one stream: kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    from dskd_tpu_torch.apis.inference import prepare_batch

    images, img_hw, _ = prepare_batch(cfg, imgs, torch.device("cuda"))
    with torch.inference_mode():
        model(images, img_hw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(images, img_hw)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    print(f"profile: one B={len(imgs)} forward under the profiler: wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle "
          f"share {1 - busy / wall_us:.3f}, {sum(e.count for e in kernels)} "
          f"kernel launches of {len(kernels)} kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.self_device_time_total / busy:6.1%} x{e.count:<5d} "
              f"{e.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    card = card_line()
    print(f"card: {card}")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and convolutions: every comparison and "
          "time below is full f32")

    from dskd_tpu_torch.ops import _build
    from dskd_tpu_torch.ops import mxu_gather, pack_kernel
    t0 = time.perf_counter()
    _build.load("pack_corners", pack_kernel._SIGNATURES)
    _build.load("gather_weighted", mxu_gather._SIGNATURES)
    print(f"build: both kernels in {time.perf_counter() - t0:.2f} s")
    for name, (secs, log) in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build: {name} nvcc {secs:.2f} s; {'; '.join(regs)}")

    gen = torch.Generator().manual_seed(0)
    err = check_kernels(gen)
    print(f"kernels: match their twins on the card (f32 {F32_TOL}, bf16 "
          f"{BF16_TOL}); max abs err {err}")

    rng = np.random.RandomState(0)
    shapes = [(480, 640), (427, 640), (640, 512), (512, 683)]
    imgs = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in shapes]
    model, cfg, launches = check_slice(imgs[:3])

    print(f"times on {card}:")
    ktimes = time_kernels(gen)
    for name, (k_ms, p_ms) in ktimes.items():
        print(f"  {name}: kernel {k_ms:.4f} ms, plain twin {p_ms:.4f} ms "
              f"(B={B}, all four levels)")
    stimes = time_slice(model, cfg, {1: imgs[:1], 4: imgs})
    for bsz, (e2e, fwd) in stimes.items():
        print(f"  slice B={bsz}: inference_detector {e2e:.3f} ms/image, "
              f"model forward {fwd:.3f} ms/image (f32)")
    profile_forward(model, cfg, imgs)

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
         "replaces": "dskd_tpu/ops/mxu_gather.py:183",
         "launches": launches["gather_weighted"],
         "max_abs_err": err["gather_weighted"],
         "ms": ktimes[f"gather_weighted f32 Q={Q_ENC}"][0],
         "plain_ms": ktimes[f"gather_weighted f32 Q={Q_ENC}"][1]}]}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Device time of ``deform_conv2d`` and of the parts of its backward, on a
CUDA card, at DyHead's P3 on 800x1344 (B=2, 100x168, 256 -> 256 channels,
DCN v2, offsets N(0, 2 px)).

    python3 tools/torch_deform_conv_parts.py

Prints the card's name and power limit, then device ms (chip_smoke's
``device_ms``; TF32 off) of: the whole forward, the forward + backward;
the corner gather (``F.embedding``, (N, 4, Cin) rows), the corners'
weighted sum as a batched 1 x 4 matmul and as a multiply + sum; the
weights' gradient as a batched 4 x 1 matmul and as a multiply + sum; the
input's gradient as ``index_add_`` (atomics) and as
``aten.embedding_dense_backward`` (sorted segments), each held to the
other within 1e-5 relative L2; the (B Ho Wo, 9 Cin) x (9 Cin, Cout)
matmul and its two backward matmuls.
"""
import os
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from dskd_tpu_torch.ops.deform_conv import deform_conv2d  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("this tool times the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    dev = "cuda"
    g = torch.Generator().manual_seed(0)
    B, H, W, C = 2, 100, 168, 256
    x = torch.randn(B, H, W, C, generator=g).to(dev).requires_grad_()
    off = (torch.randn(B, H, W, 18, generator=g) * 2).to(
        dev).requires_grad_()
    w = (torch.randn(C, C, 3, 3, generator=g) / 48).to(dev).requires_grad_()
    mask = torch.rand(B, H, W, 9, generator=g).to(dev).requires_grad_()
    cot = torch.randn(B, H, W, C, generator=g).to(dev)

    def fwd():
        with torch.no_grad():
            deform_conv2d(x, off, w, mask=mask)

    def fwd_bwd():
        (deform_conv2d(x, off, w, mask=mask) * cot).sum().backward()

    N = B * H * W * 9
    x_flat = x.detach().reshape(-1, C)
    idx = torch.randint(0, B * H * W, (N, 4), generator=g).to(dev)
    wts = torch.rand(N, 4, generator=g).to(dev)
    grad = torch.randn(N, C, generator=g).to(dev)
    rows = F.embedding(idx, x_flat)
    taps = torch.randn(B * H * W, 9 * C, generator=g).to(dev)
    wmat = w.detach().permute(2, 3, 1, 0).reshape(9 * C, C)
    gout = torch.randn(B * H * W, C, generator=g).to(dev)

    def atomics():
        return torch.zeros_like(x_flat).index_add_(
            0, idx.reshape(-1), (wts[..., None] * grad[:, None]).reshape(-1, C))

    def segments():
        return torch.ops.aten.embedding_dense_backward(
            wts[..., None] * grad[:, None], idx, x_flat.shape[0], -1, False)

    a, s = atomics(), segments()
    rel = float((a - s).norm() / s.norm())
    if rel > 1e-5:
        raise AssertionError(f"the two input gradients part by {rel}")
    parts = (
        ("deform_conv2d forward", fwd),
        ("deform_conv2d forward + backward", fwd_bwd),
        ("corner gather F.embedding (N, 4, Cin)", lambda: F.embedding(
            idx, x_flat)),
        ("weighted sum, bmm (N, 1, 4) x (N, 4, Cin)", lambda: torch.bmm(
            wts[:, None], rows)),
        ("weighted sum, multiply + sum", lambda: (rows * wts[..., None]).sum(
            1)),
        ("weights' gradient, bmm (N, 4, Cin) x (N, Cin, 1)",
         lambda: torch.bmm(rows, grad[..., None])),
        ("weights' gradient, multiply + sum", lambda: (
            rows * grad[:, None]).sum(-1)),
        ("input's gradient, index_add_", atomics),
        ("input's gradient, embedding_dense_backward", segments),
        ("taps x weight matmul", lambda: taps @ wmat),
        ("its backward: grad x weight^T", lambda: gout @ wmat.t()),
        ("its backward: taps^T x grad", lambda: taps.t() @ gout))
    print(f"card: {card}; DCN v2 at B=2, {H}x{W}, {C} -> {C}, f32, TF32 "
          f"off; N = {N} taps; the two input gradients agree within "
          f"{rel:.2e} relative L2")
    for name, fn in parts:
        print(f"  {chip_smoke.device_ms(fn, iters=5, warmup=2):9.3f} ms  "
              f"{name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

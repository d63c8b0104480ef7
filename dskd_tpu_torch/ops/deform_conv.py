"""Deformable convolution v1 and v2 (port of dskd_tpu/ops/deform_conv.py
``deform_conv2d`` and ``DeformConv2d``).

mmcv's DCN: each tap (a, b) of output (i, j) samples the input bilinearly
at (i*stride - pad + a*dil + dy, j*stride - pad + b*dil + dx), each of the
four corners zero outside the map; v2 scales each tap by a (sigmoided)
mask; the taps then contract with the weight in one matmul over
(taps x Cin). On the TPU this is an XLA op (no ``pallas_call``), so it is a
plain PyTorch module here too: one gather (``F.embedding``) of the four
corners' rows, their weighted sum (a batched 1 x 4 matmul), and a matmul.

The sample point is the same f32 expression as JAX's and its ``floor``
decides the corners, so at an integral point (every tap at a zero offset:
the zero-initialised offset convs) the fraction is 0 and the offset's
gradient is the slope toward corner (y0 + 1, x0 + 1), as JAX's.

Memory: the taps, (B, Ho, Wo, K, Cin), are the matmul's input and are
saved for its backward once; the corner rows (four times the taps) are
gathered again in the backward instead of being saved (``_CornerSum``
saves the input, the corner indices and their weights), which keeps the
saved set at 310 MB a conv at DyHead's P3 on 800x1344, not 1.5 GB.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

class _CornerSum(torch.autograd.Function):
    """(N, Cin) = sum over the four corners of w[:, c] x_flat[idx[:, c]]:
    x_flat (R, Cin), idx (N, 4) rows of x_flat, w (N, 4). The backward
    gathers the rows again for w's gradient and sums the weighted
    gradients of each row of x_flat."""

    @staticmethod
    def forward(ctx, x_flat, idx, w):
        ctx.save_for_backward(x_flat, idx, w)
        rows = F.embedding(idx, x_flat)                     # (N, 4, Cin)
        return torch.bmm(w[:, None], rows)[:, 0]

    @staticmethod
    def backward(ctx, grad):
        x_flat, idx, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[2]:
            gw = torch.bmm(F.embedding(idx, x_flat), grad[..., None])[..., 0]
        if ctx.needs_input_grad[0]:
            # F.embedding's own backward: sorted segments on the card (1.8
            # against index_add_'s 3.3 ms at DyHead's P3,
            # tools/torch_deform_conv_parts.py), no atomics
            gx = torch.ops.aten.embedding_dense_backward(
                w[..., None] * grad[:, None], idx, x_flat.shape[0], -1,
                False)
        return gx, None, gw


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: int = 1, padding: int = 1, dilation: int = 1,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, H, W, Cin) NHWC; offsets (B, Ho, Wo, 2K), mmcv's interleaved
    (dy, dx) per tap, taps row-major; weight (Cout, Cin, kh, kw), torch's
    layout of JAX's (kh, kw, Cin, Cout); mask (B, Ho, Wo, K), already
    sigmoided (DCN v2). Returns (B, Ho, Wo, Cout)."""
    B, H, W, Cin = x.shape
    Cout, _, kh, kw = weight.shape
    K = kh * kw
    Ho = (H + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    Wo = (W + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    off = offsets.reshape(B, Ho, Wo, K, 2)
    dt, dev = x.dtype, x.device
    ii = torch.arange(Ho, dtype=dt, device=dev)[:, None, None]
    jj = torch.arange(Wo, dtype=dt, device=dev)[None, :, None]
    aa = torch.arange(kh, dtype=dt, device=dev).repeat_interleave(kw)
    bb = torch.arange(kw, dtype=dt, device=dev).repeat(kh)
    # JAX's expression, term for term, so that floor sees the same value
    ys = ii * stride - padding + aa * dilation + off[..., 0]
    xs = jj * stride - padding + bb * dilation + off[..., 1]
    y0, x0 = torch.floor(ys).detach(), torch.floor(xs).detach()
    ty, tx = (ys - y0)[..., None], (xs - x0)[..., None]
    # each corner's (dy, dx) in JAX's order of the four terms: (0, 0),
    # (0, 1), (1, 0), (1, 1) (made on the device: a host tensor's copy
    # would wait for the card)
    corner = torch.arange(4, device=dev)
    dy, dx = (corner // 2).to(dt), (corner % 2).to(dt)
    # (B, Ho, Wo, K, 4): the corners, their bilinear weights and bounds
    yc, xc = y0[..., None] + dy, x0[..., None] + dx
    wgt = (dy * ty + (1 - dy) * (1 - ty)) * (dx * tx + (1 - dx) * (1 - tx))
    inb = (yc >= 0) & (yc < H) & (xc >= 0) & (xc < W)
    wgt = wgt * inb.to(dt)
    if mask is not None:
        wgt = wgt * mask[..., None]
    base = torch.arange(B, device=dev).view(B, 1, 1, 1, 1) * (H * W)
    idx = (base + yc.clamp(0, H - 1).long() * W + xc.clamp(0, W - 1).long())
    taps = _CornerSum.apply(x.reshape(B * H * W, Cin), idx.reshape(-1, 4),
                            wgt.reshape(-1, 4))
    out = taps.view(B * Ho * Wo, K * Cin) @ weight.permute(
        2, 3, 1, 0).reshape(K * Cin, Cout)
    out = out.view(B, Ho, Wo, Cout)
    return out if bias is None else out + bias


class DeformConv(nn.Module):
    """The weight of a deformable conv whose offsets come from elsewhere
    (mmcv's DeformConv2d / ModulatedDeformConv2d without a bias): x and the
    output NCHW, as the port's convs; offsets and mask NHWC, as JAX's."""

    def __init__(self, cin: int, cout: int, device, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight = nn.Parameter(torch.empty(
            cout, cin, kernel_size, kernel_size, device=device))
        nn.init.normal_(self.weight, 0.0, 0.01)

    def forward(self, x, offsets, mask=None):
        y = deform_conv2d(x.permute(0, 2, 3, 1), offsets, self.weight,
                          stride=self.stride, padding=self.padding,
                          dilation=self.dilation, mask=mask)
        return y.permute(0, 3, 1, 2)


class DeformConv2d(DeformConv):
    """A DCN block: ``conv_offset`` predicts the offsets (and, modulated,
    the mask logits) from the input; it starts at zero, so the block starts
    as a plain conv (mmcv's init). The kernel starts he-normal, flax's
    truncated normal. NCHW in and out."""

    def __init__(self, cin: int, cout: int, device, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 modulated: bool = False, use_bias: bool = False):
        super().__init__(cin, cout, device, kernel_size, stride, padding,
                         dilation)
        K = kernel_size * kernel_size
        self.modulated = modulated
        self.conv_offset = nn.Conv2d(
            cin, (3 if modulated else 2) * K, kernel_size, stride=stride,
            padding=padding, dilation=dilation, device=device)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)
        std = math.sqrt(2.0 / (cin * K)) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std)
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if use_bias else None)

    def forward(self, x):
        raw = self.conv_offset(x).permute(0, 2, 3, 1)
        K = raw.shape[-1] // (3 if self.modulated else 2)
        mask = torch.sigmoid(raw[..., 2 * K:]) if self.modulated else None
        y = deform_conv2d(x.permute(0, 2, 3, 1), raw[..., :2 * K],
                          self.weight, self.bias, self.stride, self.padding,
                          self.dilation, mask)
        return y.permute(0, 3, 1, 2)

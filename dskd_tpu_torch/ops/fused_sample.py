"""Fused bilinear sampling of a raw level table, forward and backward (port
of dskd_tpu/ops/fused_sample.py ``fused_msda_sample``: ``_fwd_kernel`` and
``_bwd_kernel``).

``fused_msda_sample(table, idx, weights, level_w)`` computes, with the tap
offsets ``off = (0, 1, W, W + 1)`` of a level W pixels wide,
``out[n, q] = sum_{p, c} weights[n, q, p, c] * table[n, idx[n, q, p] + off_c]``
for table (N, S, D) f32 or bf16, idx (N, Q, P) int32 (the unclipped
top-left corner ``y0 * W + x0``) and weights (N, Q, P, 4) f32. Sums run in
f32; the output has the table's type. A tap whose row lies outside [0, S)
adds nothing (its one-hot column matches no table row on the TPU).

It is differentiable in ``table`` and ``weights`` through
``FusedMsdaSample``: ``dtable`` scatter-adds ``weights * g`` at every tap
in range, and ``dw[n, q, p, c] = <g[n, q], table[n, idx + off_c]>`` for a
tap in range, whatever its weight, else 0. ``dtable`` is summed in f32 and
cast once to the table's type (the TPU kernel sums it in the table's type);
``dw`` is f32. The TPU tile's Q % 128 requirement does not apply.

MSDA calls it in its own layout, table (B, S, H, D) with the head axis in
the middle (a level slice of the value, read in place through its strides),
idx (B, Q, H, P), weights (B, Q, H, P, 4) -> (B, Q, H, D). On CUDA tensors
the forward and the backward launch ``csrc/fused_sample.cu``; on CPU tensors
they run ``fused_msda_sample_plain`` and ``fused_msda_sample_bwd_plain``.
Where D is a multiple of 4 the backward moves 4-element vectors of each tap
and adds them into ``dtable`` with 16-byte vector f32 atomics, so the table,
``g`` and ``dtable`` must then be 16-byte aligned and the table's strides
multiples of 4 elements (the wrapper raises otherwise).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .mxu_gather import check_aligned

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 10 + (ctypes.c_void_p,)
_BWD_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int64,) * 10 + (
    ctypes.c_void_p,)
SIGNATURES = {"fused_sample_f32": _ARGS, "fused_sample_bf16": _ARGS,
              "fused_sample_bwd_f32": _BWD_ARGS,
              "fused_sample_bwd_bf16": _BWD_ARGS}
_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _taps(table: torch.Tensor, idx: torch.Tensor, level_w: int):
    """The rows of the four taps of every point, (B, Q, H, P, 4, D) in the
    table's type; their index into the table flattened to (B*S*H, D); and
    their in-range mask (B, Q, H, P, 4)."""
    B, S, H, _ = table.shape
    off = torch.tensor([0, 1, level_w, level_w + 1], device=idx.device)
    rows = idx.long()[..., None] + off
    valid = (rows >= 0) & (rows < S)
    rows = rows.clamp(0, S - 1)
    bi = torch.arange(B, device=table.device)[:, None, None, None, None]
    hi = torch.arange(H, device=table.device)[None, None, :, None, None]
    return table[bi, rows, hi], (bi * S + rows) * H + hi, valid


def fused_msda_sample_plain(table: torch.Tensor, idx: torch.Tensor,
                            weights: torch.Tensor,
                            level_w: int) -> torch.Tensor:
    """Plain PyTorch version of the forward (MSDA layout), on any device."""
    taps, _, valid = _taps(table, idx, level_w)
    wv = weights.float() * valid
    return (taps.float() * wv[..., None]).sum(dim=(3, 4)).to(table.dtype)


def fused_msda_sample_bwd_plain(table: torch.Tensor, idx: torch.Tensor,
                                weights: torch.Tensor, g: torch.Tensor,
                                level_w: int):
    """Plain PyTorch version of the backward (MSDA layout), on any device:
    ``(dtable in table.dtype, dw f32)`` for the cotangent ``g``
    (B, Q, H, D)."""
    B, S, H, D = table.shape
    taps, dest, valid = _taps(table, idx, level_w)
    g32 = g.to(table.dtype).float()[:, :, :, None, None, :]
    dw = (taps.float() * g32).sum(-1) * valid
    dtable = torch.zeros((B * S * H, D), dtype=torch.float32,
                         device=table.device)
    contrib = (weights.float() * valid)[..., None] * g32
    dtable.index_add_(0, dest.reshape(-1), contrib.reshape(-1, D))
    return dtable.reshape(B, S, H, D).to(table.dtype), dw


def _check(name, table, idx, weights):
    if table.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {table.device}")
    B, S, H, D = table.shape
    if (idx.dim() != 4 or idx.shape[0] != B or idx.shape[2] != H
            or weights.shape != idx.shape + (4,)):
        raise ValueError(f"{name}: shapes table {tuple(table.shape)} idx "
                         f"{tuple(idx.shape)} weights "
                         f"{tuple(weights.shape)}")
    if table.dtype not in _DTYPE_TAG:
        raise TypeError(f"{name}: unsupported dtype {table.dtype}")
    if idx.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError(f"{name}: idx must be int32 and weights float32")
    if table.stride(3) != 1:
        raise ValueError(f"{name}: table rows must be contiguous")
    if not (idx.device == weights.device == table.device):
        raise ValueError(f"{name}: tensors on different devices")
    return B, S, H, D, idx.shape[1], idx.shape[3]


def _fused_sample_cuda(table, idx, weights, level_w):
    B, S, H, D, Q, P = _check("fused_msda_sample", table, idx, weights)
    idx, weights = idx.contiguous(), weights.contiguous()
    out = torch.empty((B, Q, H, D), dtype=table.dtype, device=table.device)
    lib = _build.load("fused_sample", SIGNATURES)
    fn = getattr(lib, f"fused_sample_{_DTYPE_TAG[table.dtype]}")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    _build.check(fn(table.data_ptr(), idx.data_ptr(), weights.data_ptr(),
                    out.data_ptr(), B, Q, H, P, S, level_w, D,
                    table.stride(0), table.stride(1), table.stride(2),
                    stream), "fused_msda_sample")
    fused_msda_sample.launches += 1
    return out


def fused_msda_sample_bwd(table: torch.Tensor, idx: torch.Tensor,
                          weights: torch.Tensor, g: torch.Tensor,
                          level_w: int):
    """``(dtable, dw)`` of ``fused_msda_sample`` (MSDA layout) for the
    cotangent ``g``. Launches ``csrc/fused_sample.cu`` on CUDA tensors and
    runs ``fused_msda_sample_bwd_plain`` on CPU tensors."""
    if table.device.type == "cpu":
        return fused_msda_sample_bwd_plain(table, idx, weights, g, level_w)
    B, S, H, D, Q, P = _check("fused_msda_sample_bwd", table, idx, weights)
    if g.shape != (B, Q, H, D) or g.device != table.device:
        raise ValueError(f"fused_msda_sample_bwd: g {tuple(g.shape)} on "
                         f"{g.device}")
    idx, weights = idx.contiguous(), weights.contiguous()
    g = g.to(table.dtype).contiguous()
    dtable = torch.zeros((B, S, H, D), dtype=torch.float32,
                         device=table.device)
    if D % 4 == 0:                       # the vector kernel
        if any(s % 4 for s in table.stride()[:3]):
            raise ValueError("fused_msda_sample_bwd: table strides must be "
                             "multiples of 4 elements")
        check_aligned("fused_msda_sample_bwd", table=table, g=g,
                      dtable=dtable)
    dw = torch.empty((B, Q, H, P, 4), dtype=torch.float32,
                     device=table.device)
    lib = _build.load("fused_sample", SIGNATURES)
    fn = getattr(lib, f"fused_sample_bwd_{_DTYPE_TAG[table.dtype]}")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    _build.check(fn(table.data_ptr(), idx.data_ptr(), weights.data_ptr(),
                    g.data_ptr(), dtable.data_ptr(), dw.data_ptr(), B, Q, H,
                    P, S, level_w, D, table.stride(0), table.stride(1),
                    table.stride(2), stream), "fused_msda_sample_bwd")
    fused_msda_sample_bwd.launches += 1
    return dtable.to(table.dtype), dw


fused_msda_sample_bwd.launches = 0


class FusedMsdaSample(torch.autograd.Function):
    """``fused_msda_sample`` (MSDA layout) with its backward; the CUDA
    kernels on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, table, idx, weights, level_w):
        ctx.save_for_backward(table, idx, weights)
        ctx.level_w = level_w
        if table.device.type == "cpu":
            return fused_msda_sample_plain(table, idx, weights, level_w)
        return _fused_sample_cuda(table, idx, weights, level_w)

    @staticmethod
    def backward(ctx, g):
        table, idx, weights = ctx.saved_tensors
        dtable, dw = fused_msda_sample_bwd(table, idx, weights, g,
                                           ctx.level_w)
        return dtable, None, dw, None


def fused_msda_sample(table: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor, level_w: int) -> torch.Tensor:
    """Fused four-tap sampling: table (N, S, D), idx (N, Q, P), weights
    (N, Q, P, 4) f32 -> (N, Q, D), or in MSDA's layout table (B, S, H, D),
    idx (B, Q, H, P), weights (B, Q, H, P, 4) -> (B, Q, H, D)."""
    if table.dim() == 3:                             # (N, S, D) layout
        return FusedMsdaSample.apply(table[:, :, None], idx[:, :, None],
                                     weights[:, :, None],
                                     level_w)[:, :, 0]
    return FusedMsdaSample.apply(table, idx, weights, level_w)


fused_msda_sample.launches = 0

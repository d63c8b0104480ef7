"""Fused windowed sampling, forward and backward (port of
dskd_tpu/ops/fused_window.py ``fused_window_sample``: ``fwd_kernel`` and
``bwd_kernel``), and the windowed weighted backward it shares with
ops/window_bwd.py.

``fused_window_sample(table, idx, weights, starts, window, tile_q)`` computes
``out[n, q, c*D:(c+1)*D] = sum_p weights[n, q, p, c]
* table[n, idx[n, q, p], c*D:(c+1)*D]`` for table (N, S, 4D), idx (N, Q, P)
and f32 weights (N, Q, P, 4), where query q lies in tile q // tile_q, whose
window is the table rows ``[starts[t], starts[t] + window)``. Sums run in
f32 and the output has the table's type. The Pallas kernel gave an escaped
row zero and left the caller to fall back to a plain gather; here every row
comes from the table, so the result is ``gather_weighted``'s for any index,
and the CUDA kernels count the escapes (``fused_window_sample.escapes``,
``windowed_weighted_bwd.escapes``; see ops/window.py). An index outside
[0, S) contributes nothing, as in ``gather_weighted``. Q need not be a
multiple of tile_q: the last tile may be partial.

It is differentiable in ``table`` and ``weights`` through
``FusedWindowSample``, whose backward is ``windowed_weighted_bwd``: ``dtable``
sums ``weights * g`` at ``idx`` (in f32, cast once to the table's type; the
TPU kernel summed in the table's type tile by tile) and ``dw[..., p, c]`` is
the dot of chunk c of ``g`` with chunk c of row ``idx[..., p]`` (0 for an
index outside [0, S)), in f32. The JAX package computes this one function in
the (B*H, S, 4D) layout here and in the (B, S, H, 4D) layout in
ops/window_bwd.py; the port's one kernel takes the table's strides. That
function is ``gather_weighted``'s backward, so on the card it is B1''s direct
vector-atomic scatter (``csrc/gather_weighted_bwd.cu``, its windowed entry
point), which keeps the window only in its escape count; the TPU kernel's
per-tile window sums have no counterpart.

MSDA calls it in its own layout, table (B, S, H, 4D) (``pack_corners``'
output, read in place), idx (B, Q, H, P), weights (B, Q, H, P, 4) ->
(B, Q, H, 4D). On CUDA tensors the forward launches
``csrc/window_sample.cu`` and the backward ``csrc/gather_weighted_bwd.cu``
(with ``gather_weighted_bwd``'s checks: the table, ``g`` and ``dtable``
16-byte aligned); on CPU tensors they run ``fused_window_sample_plain`` and
``windowed_weighted_bwd_plain``.
"""
from __future__ import annotations

import torch

from . import _build
from .mxu_gather import _check as _check_weighted
from .mxu_gather import (gather_weighted_bwd_plain, gather_weighted_plain,
                         weighted_bwd_cuda)
from .window import (DTYPE_TAG, SIGNATURES, check_window, escape_counter,
                     starts_tensor)


def fused_window_sample_plain(table: torch.Tensor, idx: torch.Tensor,
                              weights: torch.Tensor, starts, window: int,
                              tile_q: int) -> torch.Tensor:
    """Plain PyTorch version of the forward (MSDA layout), on any device:
    the weighted gather, whatever the window."""
    check_window("fused_window_sample", starts, idx.shape[1], tile_q, window)
    return gather_weighted_plain(table, idx, weights)


def windowed_weighted_bwd_plain(table: torch.Tensor, idx: torch.Tensor,
                                weights: torch.Tensor, g: torch.Tensor,
                                starts, window: int, tile_q: int):
    """Plain PyTorch version of the backward (MSDA layout), on any device:
    ``(dtable in table.dtype, dw in weights.dtype)``."""
    check_window("windowed_weighted_bwd", starts, idx.shape[1], tile_q,
                 window)
    return gather_weighted_bwd_plain(table, idx, weights, g)


def _check(name, table, idx, weights, starts, window, tile_q):
    """gather_weighted's checks (the kernels share its row loads) and the
    window's."""
    B, S, H, D4, Q, P = _check_weighted(name, table, idx, weights)
    starts = check_window(name, starts, Q, tile_q, window)
    return B, S, H, D4, Q, P, starts


def _fused_window_cuda(table, idx, weights, starts, window, tile_q):
    B, S, H, D4, Q, P, starts = _check("fused_window_sample", table, idx,
                                       weights, starts, window, tile_q)
    idx = idx.contiguous()
    weights = weights.to(torch.float32).contiguous()
    out = torch.empty((B, Q, H, D4), dtype=table.dtype, device=table.device)
    lib = _build.load("window_sample", SIGNATURES)
    fn = getattr(lib, f"fused_window_{DTYPE_TAG[table.dtype]}")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    escapes = escape_counter(fused_window_sample, table.device)
    _build.check(fn(table.data_ptr(), idx.data_ptr(), weights.data_ptr(),
                    starts_tensor(starts, table.device).data_ptr(),
                    out.data_ptr(), escapes.data_ptr(), B, Q, H, P, tile_q,
                    window, S, D4, table.stride(0), table.stride(1),
                    table.stride(2), stream), "fused_window_sample")
    fused_window_sample.launches += 1
    return out


def windowed_weighted_bwd(table: torch.Tensor, idx: torch.Tensor,
                          weights: torch.Tensor, g: torch.Tensor, starts,
                          window: int, tile_q: int):
    """``(dtable, dw)`` of ``fused_window_sample`` (MSDA layout) for the
    cotangent ``g`` (B, Q, H, 4D): ``dtable`` in the table's type, ``dw`` in
    the weights' type. Launches ``csrc/gather_weighted_bwd.cu``'s windowed
    entry point on CUDA tensors and runs ``windowed_weighted_bwd_plain`` on
    CPU tensors."""
    if table.device.type == "cpu":
        return windowed_weighted_bwd_plain(table, idx, weights, g, starts,
                                           window, tile_q)
    starts = check_window("windowed_weighted_bwd", starts, idx.shape[1],
                          tile_q, window)
    out = weighted_bwd_cuda(
        "windowed_weighted_bwd", table, idx, weights, g,
        (starts_tensor(starts, table.device), tile_q, window,
         escape_counter(windowed_weighted_bwd, table.device)))
    windowed_weighted_bwd.launches += 1
    return out


windowed_weighted_bwd.launches = 0
windowed_weighted_bwd.escapes = None


class FusedWindowSample(torch.autograd.Function):
    """``fused_window_sample`` (MSDA layout) with its backward; the CUDA
    kernels on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, table, idx, weights, starts, window, tile_q):
        ctx.save_for_backward(table, idx, weights)
        ctx.args = (starts, window, tile_q)
        if table.device.type == "cpu":
            return fused_window_sample_plain(table, idx, weights, starts,
                                             window, tile_q)
        return _fused_window_cuda(table, idx, weights, starts, window,
                                  tile_q)

    @staticmethod
    def backward(ctx, g):
        table, idx, weights = ctx.saved_tensors
        dtable, dw = windowed_weighted_bwd(table, idx, weights, g,
                                           *ctx.args)
        return dtable, None, dw, None, None, None


def fused_window_sample(table: torch.Tensor, idx: torch.Tensor,
                        weights: torch.Tensor, starts, window: int,
                        tile_q: int = 128) -> torch.Tensor:
    """Fused windowed sampling: table (N, S, 4D), idx (N, Q, P), weights
    (N, Q, P, 4) f32 -> (N, Q, 4D), or in MSDA's layout table (B, S, H, 4D),
    idx (B, Q, H, P), weights (B, Q, H, P, 4) -> (B, Q, H, 4D)."""
    if table.dim() == 3:                             # (N, S, 4D) layout
        return FusedWindowSample.apply(table[:, :, None], idx[:, :, None],
                                       weights[:, :, None], starts, window,
                                       tile_q)[:, :, 0]
    return FusedWindowSample.apply(table, idx, weights, starts, window,
                                   tile_q)


fused_window_sample.launches = 0
fused_window_sample.escapes = None

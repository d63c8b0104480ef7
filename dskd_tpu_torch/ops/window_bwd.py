"""Weighted gather with a windowed backward (port of
dskd_tpu/ops/window_bwd.py ``windowed_bwd_sample``: ``bwd_kernel``).

``windowed_bwd_sample(packed, flat, cw, starts, window, tile_q)`` takes MSDA's
layout: the (B, S, H, 4D) table of ``pack_corners``, flat (B, Q, H, P) int32
and f32 cw (B, Q, H, P, 4), and returns (B, Q, H, 4D) in the table's type.
Its forward is the default branch's ``gather_weighted`` (B1's CUDA kernel on
the card): the JAX package keeps its plain forward here (``_plain_sample``)
and swaps only the cotangents. Its backward is ``windowed_weighted_bwd``
(ops/fused_window.py): on the TPU the table cotangent is summed per tile of
``tile_q`` queries inside the tile's window, ``[starts[t], starts[t] +
window)``; on the card it is ``gather_weighted_bwd``'s direct scatter, which
counts the samples outside their tile's window as escapes, so the gradients
are ``gather_weighted``'s for any index.
"""
from __future__ import annotations

import torch

from .fused_window import windowed_weighted_bwd
from .mxu_gather import _gather_weighted_cuda, gather_weighted_plain
from .window import check_window


class WindowedBwdSample(torch.autograd.Function):
    """``gather_weighted``'s forward with the windowed backward; the CUDA
    kernels on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, packed, flat, cw, starts, window, tile_q):
        check_window("windowed_bwd_sample", starts, flat.shape[1], tile_q,
                     window)
        ctx.save_for_backward(packed, flat, cw)
        ctx.args = (starts, window, tile_q)
        if packed.device.type == "cpu":
            return gather_weighted_plain(packed, flat, cw)
        return _gather_weighted_cuda(packed, flat, cw)

    @staticmethod
    def backward(ctx, g):
        packed, flat, cw = ctx.saved_tensors
        dtable, dw = windowed_weighted_bwd(packed, flat, cw, g, *ctx.args)
        return dtable, None, dw, None, None, None


def windowed_bwd_sample(packed: torch.Tensor, flat: torch.Tensor,
                        cw: torch.Tensor, starts, window: int,
                        tile_q: int = 128) -> torch.Tensor:
    """``gather_weighted(packed, flat, cw)`` whose backward sums each
    query tile's table cotangent in its window (see the module
    docstring)."""
    return WindowedBwdSample.apply(packed, flat, cw, starts, window, tile_q)

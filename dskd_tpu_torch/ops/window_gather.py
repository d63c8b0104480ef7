"""Windowed row gather, forward and backward (port of
dskd_tpu/ops/window_gather.py ``window_gather``: ``fwd_kernel`` and
``bwd_kernel``).

``window_gather(table, idx, starts, tile_rows, window)`` computes
``out[n, m] = table[n, idx[n, m]]`` for table (N, S, D) and idx (N, M), where
the rows ``[t * tile_rows, (t + 1) * tile_rows)`` of idx form tile t, whose
window is the table rows ``[starts[t], starts[t] + window)``. The Pallas
kernel returned zero for an index outside its tile's window and left the
caller to fall back to a plain gather; here every row comes from the table
(an escaped one from device memory directly), so the result is the plain
gather's for any index, and the CUDA kernels count the escapes
(``window_gather.escapes``, ``window_gather_bwd.escapes``; see ops/window.py).
An index outside [0, S) gives a zero row and adds nothing, as in
``mxu_gather``. The forward is a copy: bit for bit the one-hot product.

It is differentiable in ``table`` through ``WindowGather``: the backward sums
``g`` into ``dtable`` at ``idx``, in f32, cast once to the table's type (the
TPU kernel summed in the table's type tile by tile). On the TPU the window is
what made that backward's one-hot matmul affordable; on the card its CUDA
kernel is a direct scatter, one warp per (b, q, hd) with its points' rows in
flight and one 16-byte vector f32 atomic per lane and row (so ``g`` must be
16-byte aligned and its row width a multiple of 4), and the window is left
only in the escape count.

MSDA calls it in its own layout, table (B, S, H, D) with the head axis in the
middle (``pack_corners``' output, read in place through its strides) and idx
(B, Q, H, P) -> (B, Q, H, P, D), with ``tile_rows = tile_q * P``: query q
lies in tile q // tile_q. On CUDA tensors the forward and the backward launch
``csrc/window_sample.cu``; on CPU tensors they run ``window_gather_plain``
and ``window_gather_bwd_plain``.
"""
from __future__ import annotations

import torch

from . import _build
from .mxu_gather import (_check_idx, check_aligned, mxu_gather_bwd_plain,
                         mxu_gather_plain)
from .window import (DTYPE_TAG, SIGNATURES, check_window, escape_counter,
                     starts_tensor)


def window_gather_plain(table: torch.Tensor, idx: torch.Tensor, starts,
                        tile_q: int, window: int) -> torch.Tensor:
    """Plain PyTorch version of the forward (MSDA layout), on any device:
    the row gather, whatever the window."""
    check_window("window_gather", starts, idx.shape[1], tile_q, window)
    return mxu_gather_plain(table, idx)


def window_gather_bwd_plain(idx: torch.Tensor, g: torch.Tensor, starts,
                            tile_q: int, window: int,
                            table_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the backward (MSDA layout), on any device:
    an f32 ``index_add_`` of ``g`` into ``dtable``, in ``g``'s type."""
    check_window("window_gather_bwd", starts, idx.shape[1], tile_q, window)
    return mxu_gather_bwd_plain(idx, g, table_rows)


def _window_gather_cuda(table, idx, starts, tile_q, window):
    if table.device.type != "cuda":
        raise ValueError(f"window_gather: unsupported device {table.device}")
    B, S, H, D = table.shape
    _check_idx("window_gather", idx, B, H, table.device)
    if table.dtype not in DTYPE_TAG:
        raise TypeError(f"window_gather: unsupported dtype {table.dtype}")
    if table.stride(3) != 1:
        raise ValueError("window_gather: table rows must be contiguous")
    Q, P = idx.shape[1], idx.shape[3]
    starts = check_window("window_gather", starts, Q, tile_q, window)
    idx = idx.contiguous()
    out = torch.empty((B, Q, H, P, D), dtype=table.dtype, device=table.device)
    lib = _build.load("window_sample", SIGNATURES)
    fn = getattr(lib, f"window_gather_{DTYPE_TAG[table.dtype]}")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    _build.check(fn(table.data_ptr(), idx.data_ptr(),
                    starts_tensor(starts, table.device).data_ptr(),
                    out.data_ptr(),
                    escape_counter(window_gather, table.device).data_ptr(),
                    B, Q, H, P, tile_q, window, S, D, table.stride(0),
                    table.stride(1), table.stride(2), stream),
                 "window_gather")
    window_gather.launches += 1
    return out


def window_gather_bwd(idx: torch.Tensor, g: torch.Tensor, starts,
                      tile_q: int, window: int,
                      table_rows: int) -> torch.Tensor:
    """``dtable`` (B, S, H, D) of ``window_gather`` for the cotangent ``g``
    (B, Q, H, P, D), in ``g``'s type. Launches ``csrc/window_sample.cu`` on
    CUDA tensors and runs ``window_gather_bwd_plain`` on CPU tensors."""
    if g.device.type == "cpu":
        return window_gather_bwd_plain(idx, g, starts, tile_q, window,
                                       table_rows)
    if g.device.type != "cuda":
        raise ValueError(f"window_gather_bwd: unsupported device {g.device}")
    B, Q, H, P, D = g.shape
    _check_idx("window_gather_bwd", idx, B, H, g.device)
    if idx.shape != (B, Q, H, P):
        raise ValueError(f"window_gather_bwd: idx {tuple(idx.shape)}, g "
                         f"{tuple(g.shape)}")
    if g.dtype not in DTYPE_TAG:
        raise TypeError(f"window_gather_bwd: unsupported dtype {g.dtype}")
    if D % 4:
        raise ValueError(f"window_gather_bwd: row width {D} is not a "
                         "multiple of 4 elements")
    starts = check_window("window_gather_bwd", starts, Q, tile_q, window)
    idx, g = idx.contiguous(), g.contiguous()
    dtable = torch.zeros((B, table_rows, H, D), dtype=torch.float32,
                         device=g.device)
    check_aligned("window_gather_bwd", g=g, dtable=dtable)
    lib = _build.load("window_sample", SIGNATURES)
    fn = getattr(lib, f"window_gather_bwd_{DTYPE_TAG[g.dtype]}")
    stream = torch.cuda.current_stream(g.device).cuda_stream
    _build.check(fn(idx.data_ptr(), g.data_ptr(),
                    starts_tensor(starts, g.device).data_ptr(),
                    dtable.data_ptr(),
                    escape_counter(window_gather_bwd, g.device).data_ptr(),
                    B, Q, H, P, tile_q, window, table_rows, D, stream),
                 "window_gather_bwd")
    window_gather_bwd.launches += 1
    return dtable.to(g.dtype)


window_gather_bwd.launches = 0
window_gather_bwd.escapes = None


class WindowGather(torch.autograd.Function):
    """``window_gather`` (MSDA layout) with its backward; the CUDA kernels
    on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, table, idx, starts, tile_q, window):
        ctx.save_for_backward(idx)
        ctx.args = (starts, tile_q, window, table.shape[1], table.dtype)
        if table.device.type == "cpu":
            return window_gather_plain(table, idx, starts, tile_q, window)
        return _window_gather_cuda(table, idx, starts, tile_q, window)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        starts, tile_q, window, rows, dtype = ctx.args
        return (window_gather_bwd(idx, g.to(dtype), starts, tile_q, window,
                                  rows), None, None, None, None)


def window_gather(table: torch.Tensor, idx: torch.Tensor, starts,
                  tile_rows: int, window: int) -> torch.Tensor:
    """Windowed row gather: table (N, S, D), idx (N, M) -> (N, M, D), or in
    MSDA's layout table (B, S, H, D), idx (B, Q, H, P) -> (B, Q, H, P, D).
    ``starts``: one window start per tile of ``tile_rows`` rows of idx (of
    ``tile_rows // P`` queries in MSDA's layout)."""
    if table.dim() == 3:                             # (N, S, D) layout
        return WindowGather.apply(table[:, :, None], idx[:, :, None, None],
                                  starts, tile_rows, window)[:, :, 0, 0]
    P = idx.shape[3]
    if tile_rows % P:
        raise ValueError(f"window_gather: {tile_rows} rows per tile are not "
                         f"whole queries of {P} points")
    return WindowGather.apply(table, idx, starts, tile_rows // P, window)


window_gather.launches = 0
window_gather.escapes = None
